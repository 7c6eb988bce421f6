"""The workload side of the controller <-> workload env contract — the
port's copy of ``JobRuntime`` from ``kubeflow_controller_tpu/workloads/
runtime.py``, with its own copy of the env names (the reference takes them
from ``planner/materialize.py``; the values are the same, so the unchanged
controller wires a torch workload exactly as it wires a JAX one).

A gang joins through ``torch.distributed`` where the reference joins
through ``jax.distributed``: :meth:`JobRuntime.initialize` keeps the
reference's readiness drop (process 0), TCP pre-poll (every other
process) and beats, then calls ``init_process_group`` with
``init_method="tcp://<coordinator>"``; the pre-poll and the join are the
reference's trace spans ``runtime/wait_coordinator`` and
``runtime/distributed_initialize``.  Process 0 hosts the TCP store at
the coordinator's address, the role JAX's coordination service plays.  The
backend is ``nccl`` for a CUDA device and ``gloo`` for the CPU, which the
caller must name.  A single process joins nothing, as in the reference.

Where the reference's one process drives every local device of its pod
(``jax.local_devices()``), the port runs one rank a device: a pod's
launcher (``launch.py``) starts L ranks, and each one's runtime carries
``local_devices`` (L, ``$KCTPU_LOCAL_DEVICES``) and ``local_rank``
(``$KCTPU_LOCAL_RANK``).  Such a rank's global rank is ``process_id x L +
local_rank`` and the world ``num_processes x L``; a launched rank always
joins, a one-rank world too.  :func:`process_count` and
:func:`process_index` count pods, as ``jax.process_count`` and
``jax.process_index`` do; :func:`world_size` and :func:`global_rank` count
ranks.
"""

from __future__ import annotations

import json
import math
import os
import socket
import threading
import time
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..device import (
    ENV_LOCAL_DEVICES,
    ENV_LOCAL_RANK,
    DeviceLike,
    resolve_device,
)
from ..obs.phases import PHASE_INIT, PHASE_RENDEZVOUS
from ..obs.trace import span
from .progress import reporter

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
# Node-agent-injected shared dir for the coordinator's readiness drop:
# process 0 drops `<coordinator>.ready` here just before it binds, so the
# other processes stat-poll a file instead of dialing a port that cannot
# answer yet.  Absent outside the single-node fake cluster.
ENV_RENDEZVOUS_DIR = "KCTPU_RENDEZVOUS_DIR"
# Set by a pod's launcher that holds its ranks' TCP store itself
# (``launch.host_store``): every rank, rank 0 too, joins it as a client.
ENV_STORE_HOSTED = "KCTPU_STORE_HOSTED"

# How long a gang may take to form, and then how long a collective may
# wait for a peer (jax.distributed.initialize's default is 300 s too).
JOIN_TIMEOUT_S = 300.0


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


def _ready_filename(coordinator: str, generation: int = 0) -> str:
    base = coordinator.replace("/", "_").replace(":", "_")
    if generation:
        base += f"_g{generation}"
    return base + ".ready"


def world_size() -> int:
    """The ranks of the joined group (one a device), else 1."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def global_rank() -> int:
    """This rank's index in the joined group, else 0."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def local_devices(env: Optional[Dict[str, str]] = None) -> int:
    """The ranks of this process's pod: L for a rank that the pod's
    launcher started, else 1 (the process is its pod's one rank)."""
    e = os.environ if env is None else env
    if e.get(ENV_LOCAL_RANK) is None:
        return 1
    return max(1, int(e.get(ENV_LOCAL_DEVICES, "1") or "1"))


def process_count() -> int:
    """The job's processes (pods) once a group is joined, else 1
    (``jax.process_count``): the world over each pod's local devices."""
    return max(1, world_size() // local_devices())


def process_index() -> int:
    """This rank's pod (``jax.process_index``)."""
    return global_rank() // local_devices()


class HostSetup:
    """Host-side setup on a background thread, overlapped with the
    rendezvous window (setup produces values; nothing orders it against
    the join).

    ``fn`` must stay pure numpy / Python: it runs while the process group
    is forming.  ``overlap=False`` is the serial baseline — ``fn`` runs
    inline at :meth:`result`, after the rendezvous.  The run is a
    ``workload/host_setup`` trace span.
    """

    def __init__(self, fn: Callable[[], Any], overlap: bool = True):
        self._fn = fn
        self._overlap = overlap
        self._value: Any = None
        self._exc: Optional[BaseException] = None
        self._done = False
        self._thread: Optional[threading.Thread] = None
        if overlap:
            self._thread = threading.Thread(
                target=self._run, name="host-setup", daemon=True)
            self._thread.start()

    def _run(self) -> None:
        try:
            with span("workload/host_setup", overlap=self._overlap):
                self._value = self._fn()
        except BaseException as e:  # noqa: BLE001 - re-raised at result()
            self._exc = e
        self._done = True

    def result(self, timeout: Optional[float] = None) -> Any:
        """The setup value; joins the thread (or, serial mode, runs the
        setup now).  Re-raises whatever the setup raised."""
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError("host setup did not finish")
        elif not self._done:
            self._run()
        if self._exc is not None:
            raise self._exc
        return self._value


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

    def __post_init__(self) -> None:
        # This pod's local devices (L), this rank's index among them, and
        # whether the pod's launcher started this rank (such a rank joins
        # even a one-rank world).  Plain attributes, not fields: the
        # fields stay the reference's.
        self.local_devices = 1
        self.local_rank = 0
        self.launched = False
        self.store_hosted = False

    @staticmethod
    def from_env(env: Optional[Dict[str, str]] = None) -> "JobRuntime":
        e = os.environ if env is None else env
        hostnames = [h for h in e.get(ENV_TPU_WORKER_HOSTNAMES, "").split(",")
                     if h]
        rt = JobRuntime(
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
        rt.local_devices = local_devices(e)
        rt.local_rank = int(e.get(ENV_LOCAL_RANK, "0") or "0")
        rt.launched = e.get(ENV_LOCAL_RANK) is not None
        rt.store_hosted = e.get(ENV_STORE_HOSTED) == "1"
        return rt

    @property
    def world_size(self) -> int:
        """Ranks in the job: one a local device of every pod."""
        return self.num_processes * self.local_devices

    @property
    def global_rank(self) -> int:
        return self.process_id * self.local_devices + self.local_rank

    def check_mesh(self) -> None:
        """Raise when the controller's mesh ($KCTPU_MESH) and a pod of more
        than one local device disagree on the world: no smaller (or
        larger) mesh is built in its place."""
        if self.local_devices <= 1 or not self.mesh:
            return
        want = math.prod(self.mesh.values())
        if want != self.world_size:
            raise ValueError(
                f"$KCTPU_MESH {self.mesh} spans {want} devices, but "
                f"{self.num_processes} process(es) x {self.local_devices} "
                f"local devices make {self.world_size}")

    def merge_tf_args(self, job_name: str, task_index: int,
                      worker_hosts: str) -> None:
        """Classic TF-contract fallback: when the env contract is absent
        (direct CLI runs outside the controller), derive the gang from
        ``--worker_hosts/--task_index``.  Worker 0's host doubles as the
        coordinator."""
        if self.num_processes > 1 or job_name == "ps" or task_index < 0:
            return
        hosts = [h for h in worker_hosts.split(",") if h]
        if len(hosts) <= 1:
            return
        self.coordinator = self.coordinator or hosts[0]
        self.num_processes = len(hosts)
        if self.gang_width <= 1:
            self.gang_width = len(hosts)  # runtime width; never spec
        self.process_id = task_index

    def initialize(self, device: DeviceLike = "cuda",
                   timeout_s: float = JOIN_TIMEOUT_S) -> None:
        """Join the job's process group when it has more than one rank, or
        when this process is a rank of its pod's launcher; a single
        process of its own returns at once and starts no group.

        ``device`` is the device this rank trains on (``nccl`` for CUDA,
        ``gloo`` for the CPU); without CUDA it raises unless the CPU is
        named.  A gang that does not form within ``timeout_s`` raises: a
        rank other than 0 waits that long for the coordinator to answer,
        and the join itself waits that long for every rank."""
        if self._initialized or (self.world_size <= 1
                                 and not self.launched):
            self._initialized = True
            return
        dev = resolve_device(device)
        if self._coordinator_addr() is None:
            raise ValueError(f"coordinator {self.coordinator!r} is not "
                             "host:port")
        # First heartbeat of the pod's life: alive and in rendezvous.
        reporter().beat(phase=PHASE_RENDEZVOUS)
        if self.global_rank == 0:
            self._drop_ready_file()
        else:
            with span("runtime/wait_coordinator",
                      coordinator=self.coordinator,
                      process=self.process_id):
                reached = self._wait_coordinator(timeout_s)
            if not reached:
                raise TimeoutError(
                    f"rank {self.global_rank}: coordinator "
                    f"{self.coordinator!r} not reachable within "
                    f"{timeout_s:g} s")
        with span("runtime/distributed_initialize",
                  process=self.process_id,
                  num_processes=self.num_processes):
            self.join_group(dev, timeout_s)
        self._initialized = True
        reporter().beat(phase=PHASE_INIT)  # rendezvous done, setup next

    def join_group(self, device: DeviceLike = "cuda",
                   timeout_s: float = JOIN_TIMEOUT_S) -> str:
        """``init_process_group`` over this runtime's coordinator, world
        and global rank, whatever the size (a one-rank group too); returns
        the backend.  Global rank 0 binds the TCP store at the
        coordinator's address, unless the pod's launcher holds it
        (``$KCTPU_STORE_HOSTED``): then every rank joins as a client.  On CUDA the rank binds its own card:
        ``device``'s index, else its local rank's for a launched rank,
        else the current card."""
        import torch.distributed as dist

        dev = resolve_device(device)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            if dev.index is not None:
                card = dev.index
            elif self.launched:
                card = self.local_rank
            else:
                card = torch.cuda.current_device()
            torch.cuda.set_device(card)
        timeout = timedelta(seconds=timeout_s)
        if self.store_hosted:
            host, port = self._coordinator_addr()
            store = dist.TCPStore(host, port, self.world_size,
                                  is_master=False, timeout=timeout)
            dist.init_process_group(backend, store=store,
                                    world_size=self.world_size,
                                    rank=self.global_rank, timeout=timeout)
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://{self.coordinator}",
                world_size=self.world_size, rank=self.global_rank,
                timeout=timeout)
        return backend

    def shutdown(self) -> None:
        """Leave the process group (``jax.distributed.shutdown``)."""
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        self._initialized = False

    def _ready_path(self) -> str:
        d = os.environ.get(ENV_RENDEZVOUS_DIR, "")
        if not d or not self.coordinator:
            return ""
        return os.path.join(
            d, _ready_filename(self.coordinator, self.gang_generation))

    def _drop_ready_file(self) -> None:
        path = self._ready_path()
        if not path:
            return
        try:
            with open(path, "w") as fh:
                fh.write(str(os.getpid()))
        except OSError:
            pass  # readiness is an optimization, never a requirement

    def _coordinator_addr(self) -> Optional[Tuple[str, int]]:
        host, _, port = self.coordinator.rpartition(":")
        host = host.strip("[]")  # bracketed IPv6 ("[fd00::1]:8476")
        if not host or not port.isdigit():
            return None
        return host, int(port)

    def _wait_coordinator(self, timeout_s: float = 60.0,
                          poll_s: float = 0.005) -> bool:
        """Wait until the coordinator's port answers; True once it does,
        False on timeout or a malformed address.  Two stages, as in the
        reference: stat-poll the readiness drop when the node agent
        provides a shared rendezvous dir (a stat cannot resolve-fail),
        then TCP-poll the port until the listener is up."""
        addr = self._coordinator_addr()
        if addr is None:
            return False
        deadline = time.monotonic() + timeout_s
        ready = self._ready_path()
        if ready:
            while time.monotonic() < deadline and not os.path.exists(ready):
                time.sleep(0.002)
        resolver_backoff = 0.02
        while time.monotonic() < deadline:
            try:
                with socket.create_connection(addr, timeout=poll_s + 0.1):
                    return True
            except socket.gaierror:
                # Name not resolvable yet (service DNS still propagating):
                # back off, starting small.
                time.sleep(resolver_backoff)
                resolver_backoff = min(resolver_backoff * 2, 0.25)
            except OSError:
                time.sleep(poll_s)
        return False

    @property
    def is_chief(self) -> bool:
        """Global rank 0: process 0's first local rank."""
        return self.global_rank == 0
