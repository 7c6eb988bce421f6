"""The workload side of the controller <-> workload env contract — the
port's copy of ``JobRuntime`` from ``kubeflow_controller_tpu/workloads/
runtime.py``, with its own copy of the env names (the reference takes them
from ``planner/materialize.py``; the values are the same, so the unchanged
controller wires a torch workload exactly as it wires a JAX one).

Only one process is ported: :meth:`JobRuntime.initialize` returns at once
for a single-process job and raises ``NotImplementedError`` for a gang
(``torch.distributed`` rendezvous is M5, ROADMAP.md).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

ENV_COORDINATOR = "JAX_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "JAX_NUM_PROCESSES"
ENV_PROCESS_ID = "JAX_PROCESS_ID"
ENV_TPU_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"
ENV_TPU_ACCELERATOR = "TPU_ACCELERATOR_TYPE"
ENV_NUM_SLICES = "MEGASCALE_NUM_SLICES"
ENV_SLICE_ID = "MEGASCALE_SLICE_ID"
ENV_SLICE_COORDINATOR = "MEGASCALE_COORDINATOR_ADDRESS"
ENV_MESH = "KCTPU_MESH"
ENV_GANG_WIDTH = "KCTPU_GANG_WIDTH"
ENV_GANG_GENERATION = "KCTPU_GANG_GENERATION"


def _parse_mesh(raw: str) -> Dict[str, int]:
    """$KCTPU_MESH JSON -> {axis: size}; tolerant of absence/garbage (a
    workload outside the controller contract just uses its CLI flags)."""
    if not raw:
        return {}
    try:
        obj = json.loads(raw)
    except ValueError:
        return {}
    if not isinstance(obj, dict):
        return {}
    out: Dict[str, int] = {}
    for k, v in obj.items():
        try:
            out[str(k)] = max(1, int(v))
        except (TypeError, ValueError):
            return {}
    return out


@dataclass
class JobRuntime:
    """Everything a training process learns from its environment (the
    reference's fields, same defaults)."""

    coordinator: str = ""
    num_processes: int = 1
    process_id: int = 0
    accelerator_type: str = ""
    worker_hostnames: List[str] = field(default_factory=list)
    num_slices: int = 1
    slice_id: int = 0
    slice_coordinator: str = ""
    # The controller's mesh-to-slice plan ($KCTPU_MESH): global mesh axes
    # that override the CLI's axis flags; empty = none declared.
    mesh: Dict[str, int] = field(default_factory=dict)
    gang_generation: int = 0
    # The gang's current width ($KCTPU_GANG_WIDTH, else num_processes).
    gang_width: int = 0
    data_dir: str = ""
    model_dir: str = ""
    log_dir: str = ""
    export_dir: str = ""
    _initialized: bool = False

    @staticmethod
    def from_env(env: Optional[Dict[str, str]] = None) -> "JobRuntime":
        e = os.environ if env is None else env
        hostnames = [h for h in e.get(ENV_TPU_WORKER_HOSTNAMES, "").split(",")
                     if h]
        return JobRuntime(
            coordinator=e.get(ENV_COORDINATOR, ""),
            num_processes=int(e.get(ENV_NUM_PROCESSES, "1") or "1"),
            process_id=int(e.get(ENV_PROCESS_ID, "0") or "0"),
            accelerator_type=e.get(ENV_TPU_ACCELERATOR, ""),
            worker_hostnames=hostnames,
            num_slices=int(e.get(ENV_NUM_SLICES, "1") or "1"),
            slice_id=int(e.get(ENV_SLICE_ID, "0") or "0"),
            slice_coordinator=e.get(ENV_SLICE_COORDINATOR, ""),
            mesh=_parse_mesh(e.get(ENV_MESH, "")),
            gang_generation=int(e.get(ENV_GANG_GENERATION, "0") or "0"),
            gang_width=(int(e.get(ENV_GANG_WIDTH, "0") or "0")
                        or int(e.get(ENV_NUM_PROCESSES, "1") or "1")),
            data_dir=e.get("DATA_DIR", ""),
            model_dir=e.get("MODEL_DIR", ""),
            log_dir=e.get("LOG_DIR", ""),
            export_dir=e.get("EXPORT_DIR", ""),
        )

    def initialize(self) -> None:
        """Nothing to join for one process; a gang raises until the
        ``torch.distributed`` rendezvous is ported."""
        if self._initialized or self.num_processes <= 1:
            self._initialized = True
            return
        raise NotImplementedError(
            f"a {self.num_processes}-process gang needs the torch.distributed "
            "rendezvous, not ported yet (ROADMAP.md, M5)")
