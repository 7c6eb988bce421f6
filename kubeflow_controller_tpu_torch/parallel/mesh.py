"""Device mesh construction — the port of
``kubeflow_controller_tpu/parallel/mesh.py``.

The canonical axes, their order and ``MeshSpec``'s resolution rule are the
reference's.  ``build_mesh`` returns a ``torch.distributed`` ``DeviceMesh``
over the default process group's world, one device per process (rank r
drives its own card, or its CPU under gloo), and keeps every canonical axis,
size 1 where unused, so model code can always name dp/fsdp/tp/sp/pp/ep.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

# Canonical mesh axis names, outermost first.
AXIS_PIPELINE = "pp"   # pipeline stages
AXIS_DATA = "dp"       # pure data parallelism (replicated params)
AXIS_FSDP = "fsdp"     # data parallelism with sharded params/optimizer
AXIS_EXPERT = "ep"     # expert parallelism for MoE layers
AXIS_SEQUENCE = "sp"   # sequence/context parallelism (ring attention)
AXIS_TENSOR = "tp"     # tensor (megatron-style) parallelism, innermost

AXIS_ORDER = (AXIS_PIPELINE, AXIS_DATA, AXIS_FSDP, AXIS_EXPERT,
              AXIS_SEQUENCE, AXIS_TENSOR)


@dataclass
class MeshSpec:
    """Declarative mesh: axis name -> size.  At most one axis may be -1
    ("absorb all remaining devices")."""

    pp: int = 1
    dp: int = 1
    fsdp: int = -1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def sizes(self) -> Dict[str, int]:
        return {
            AXIS_PIPELINE: self.pp,
            AXIS_DATA: self.dp,
            AXIS_FSDP: self.fsdp,
            AXIS_EXPERT: self.ep,
            AXIS_SEQUENCE: self.sp,
            AXIS_TENSOR: self.tp,
        }

    def resolve(self, n_devices: int) -> Dict[str, int]:
        """Fill the -1 axis so the product equals ``n_devices``."""
        sizes = self.sizes()
        bad = {a: s for a, s in sizes.items() if s != -1 and s < 1}
        if bad:
            raise ValueError(
                f"mesh axis sizes must be >= 1 (or -1 to infer): {bad}")
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} wants {fixed} devices but {n_devices} are "
                f"available")
        return sizes


def mesh_shape_for(n_devices: int, spec: Optional[MeshSpec] = None
                   ) -> Tuple[Tuple[str, int], ...]:
    """Resolved (axis, size) pairs in canonical order, dropping nothing —
    size-1 axes are kept so placements stay valid on any world size."""
    spec = spec or MeshSpec()
    sizes = spec.resolve(n_devices)
    return tuple((a, sizes[a]) for a in AXIS_ORDER)


def build_mesh(spec: Optional[MeshSpec] = None, device_type: str = "cuda"):
    """A ``DeviceMesh`` with every canonical axis over the default process
    group's world (which must be joined: ``JobRuntime.initialize``, or a
    group the caller formed), one device per process.  ``device_type`` is
    ``"cuda"`` (nccl) or ``"cpu"`` (gloo)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs a joined process group "
                           "(JobRuntime.initialize or init_process_group)")
    shape = mesh_shape_for(dist.get_world_size(), spec)
    return init_device_mesh(device_type, tuple(s for _, s in shape),
                            mesh_dim_names=tuple(a for a, _ in shape))


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes over which the global batch is split (dp + fsdp)."""
    return tuple(a for a in (AXIS_DATA, AXIS_FSDP)
                 if a in mesh.mesh_dim_names)


def data_parallel_size(mesh) -> int:
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                     for a in data_axes(mesh))
