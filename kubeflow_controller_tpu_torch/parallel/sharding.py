"""Logical-axis sharding rules — the port of
``kubeflow_controller_tpu/parallel/sharding.py``.

Model code names *logical* axes ("batch", "embed", "mlp", ...); a rule
table maps them onto mesh axes.  The table and the "earlier dim wins" rule
are the reference's; :func:`logical_to_pspec` returns, per tensor dim, the
tuple of mesh axes that shard it (the reference's ``PartitionSpec``
entries, each as a tuple), and :func:`placements_for` turns that into
DTensor placements, one per dim of a ``DeviceMesh``.

A tensor dim sharded over two mesh axes (the vocab over ``("tp",
"fsdp")``) is split in the mesh's order by DTensor (fsdp, then tp), in the
tuple's order by JAX: the local shards differ, the full tensors agree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import torch

from .mesh import AXIS_DATA, AXIS_EXPERT, AXIS_FSDP, AXIS_SEQUENCE, AXIS_TENSOR

# A rule maps one logical axis to a mesh axis, a tuple of mesh axes, or None
# (replicated).
Rule = Tuple[str, Union[str, Tuple[str, ...], None]]
PSpec = Tuple[Tuple[str, ...], ...]


@dataclass(frozen=True)
class ShardingRules:
    rules: Tuple[Rule, ...]

    def mesh_axes(self, logical: Optional[str]):
        if logical is None:
            return None
        for name, axes in self.rules:
            if name == logical:
                return axes
        return None  # unknown logical axis -> replicated


# Default rule table for transformer training: batch split over dp+fsdp,
# params sharded over fsdp (ZeRO-3 style) and tp (megatron style), sequence
# over sp, experts over ep; the vocab over tp and fsdp jointly.
DEFAULT_RULES = ShardingRules(rules=(
    ("batch", (AXIS_DATA, AXIS_FSDP)),
    ("seq", AXIS_SEQUENCE),
    ("embed", AXIS_FSDP),
    ("heads", AXIS_TENSOR),
    ("kv_heads", AXIS_TENSOR),
    ("head_dim", None),
    ("mlp", AXIS_TENSOR),
    ("vocab", (AXIS_TENSOR, AXIS_FSDP)),
    ("expert", AXIS_EXPERT),
    ("layers", None),
))


def logical_to_pspec(logical_axes: Sequence[Optional[str]],
                     rules: ShardingRules = DEFAULT_RULES) -> PSpec:
    """('batch', 'seq', 'embed') -> (('dp', 'fsdp'), ('sp',), ()).

    A mesh axis may shard only one dim of a tensor; when two logical axes
    would claim the same mesh axis, the earlier dim wins and later claims
    drop to replicated."""
    taken: set = set()
    out = []
    for a in logical_axes:
        axes = rules.mesh_axes(a)
        tup = (axes,) if isinstance(axes, str) else tuple(axes or ())
        free = tuple(m for m in tup if m not in taken)
        taken.update(free)
        out.append(free)
    return tuple(out)


def shard_pytree_specs(logical_tree, rules: ShardingRules = DEFAULT_RULES):
    """A nested dict of logical-axis tuples -> the same dict of specs.
    Leaves must be tuples of logical names; a bare string is rejected."""
    if isinstance(logical_tree, dict):
        return {k: shard_pytree_specs(v, rules)
                for k, v in logical_tree.items()}
    if isinstance(logical_tree, str):
        raise TypeError(f"logical axes must be a tuple, got bare string "
                        f"{logical_tree!r} (write ({logical_tree!r},))")
    return logical_to_pspec(logical_tree, rules)


def placements_for(logical_axes: Sequence[Optional[str]], mesh,
                   rules: ShardingRules = DEFAULT_RULES) -> List:
    """DTensor placements of a tensor with ``logical_axes`` on ``mesh``:
    per mesh dim, ``Shard(d)`` for the tensor dim its axis shards, else
    ``Replicate()``.  Mesh axes ``mesh`` does not have stay replicated."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {m: d for d, axes in enumerate(logical_to_pspec(
        logical_axes, rules)) for m in axes}
    return [Shard(dim_of[name]) if name in dim_of else Replicate()
            for name in mesh.mesh_dim_names]


def with_logical_constraint(x, logical_axes,
                            rules: ShardingRules = DEFAULT_RULES):
    """A DTensor redistributed to ``logical_axes``' placements on its mesh;
    a plain tensor as it is (the reference's no-op outside a mesh)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements_for(
        logical_axes, x.device_mesh, rules))


class _GradPlaced(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        ctx.placements = t.placements
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.placements)


def grad_placed(x):
    """A DTensor as it is, whose gradient comes back placed as ``x`` is:
    the identity, whose backward redistributes the gradient to ``x``'s
    placements (a ``Partial`` gradient is summed there).  A parameter
    replicated over a mesh dim and read by activations sharded over it
    (every weight under dp, fsdp and sp: the batch and sequence shards;
    a norm's scale) would otherwise keep a per-shard ``Partial`` gradient,
    and each process's optimizer would step on its own part.  A plain
    tensor is returned as it is."""
    from torch.distributed.tensor import DTensor

    return _GradPlaced.apply(x) if isinstance(x, DTensor) else x
