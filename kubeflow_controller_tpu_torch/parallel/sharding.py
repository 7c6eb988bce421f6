"""Logical-axis sharding rules — the port of
``kubeflow_controller_tpu/parallel/sharding.py``.

Model code names *logical* axes ("batch", "embed", "mlp", ...); a rule
table maps them onto mesh axes.  The table and the "earlier dim wins" rule
are the reference's; :func:`logical_to_pspec` returns, per tensor dim, the
tuple of mesh axes that shard it (the reference's ``PartitionSpec``
entries, each as a tuple), and :func:`placements_for` turns that into
DTensor placements, one per dim of a ``DeviceMesh``.

A tensor dim sharded over two mesh axes (the vocab over ``("tp",
"fsdp")``) is split in the tuple's order, as JAX splits it: tp's chunks
are the major ones, and fsdp splits each of them (DTensor's
``_StridedShard`` on fsdp, the layout FSDP2 with TP uses; DTensor's own
order, the mesh's, would make fsdp the major split).  So ``_w``'s gather
of the embedding table over fsdp is one all-gather over fsdp that leaves
each tp shard its own rows; with fsdp major, DTensor gathers the whole
table over tp and fsdp and slices it again.
"""

from __future__ import annotations

import math
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
    per mesh dim, ``Shard(d)`` for the tensor dim its axis shards
    (``_StridedShard`` where an axis earlier in the rule's tuple comes
    later in the mesh: the module doc), else ``Replicate()``.  Mesh axes ``mesh`` does not have stay replicated,
    and so does a mesh dim of size 1, which splits nothing (a one-row
    pipeline microbatch "sharded" over it could not be reshaped)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    pspec = logical_to_pspec(logical_axes, rules)
    names = list(mesh.mesh_dim_names)
    size = {name: mesh.size(i) for i, name in enumerate(names)}
    dim_of = {m: d for d, axes in enumerate(pspec) for m in axes}
    out = []
    for i, name in enumerate(names):
        if name not in dim_of or size[name] == 1:
            out.append(Replicate())
            continue
        d = dim_of[name]
        axes = [a for a in pspec[d] if size.get(a, 1) > 1]
        # The axes before this one in the tuple split the dim first; those
        # of them that come later in the mesh make this a strided shard.
        split = math.prod(size[a] for a in axes[:axes.index(name)]
                          if names.index(a) > i)
        out.append(Shard(d) if split == 1
                   else _StridedShard(d, split_factor=split))
    return out


def shard_dim(placement) -> Optional[int]:
    """The tensor dim a placement shards (``Shard`` or ``_StridedShard``),
    or None."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    if isinstance(placement, (Shard, _StridedShard)):
        return placement.dim
    return None


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
