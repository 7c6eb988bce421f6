"""Collectives over one mesh axis — the port of
``kubeflow_controller_tpu/parallel/collectives.py``.

The reference's named layer over ``lax`` collectives inside ``shard_map``;
here each runs over a ``DeviceMesh`` dim's process group
(``mesh.get_group(axis)``), on the calling process's local tensor, and
returns a new tensor.  An axis may be a tuple of mesh axes (outer first),
as a reference axis name may: the collective runs over each in turn.
Not differentiable, but for :func:`all_to_all_group` (Ulysses' layout
moves, whose backward is the inverse all-to-all): callers that need a
gradient wrap them.  :func:`permute_group` rotates several tensors in one
``batch_isend_irecv`` and returns before the wait, so that a ring posts
its next block before it computes on the current one.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist

AxisName = Union[str, Sequence[str]]


def _axes(axis: AxisName):
    return (axis,) if isinstance(axis, str) else tuple(axis)


def psum(x: torch.Tensor, axis: AxisName, mesh) -> torch.Tensor:
    out = x.clone()
    for a in _axes(axis):
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.get_group(a))
    return out


def pmean(x: torch.Tensor, axis: AxisName, mesh) -> torch.Tensor:
    return psum(x, axis, mesh) / axis_size(axis, mesh)


def all_gather(x: torch.Tensor, axis: AxisName, mesh, *,
               gather_axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """The shards of every member along ``gather_axis`` (``tiled``:
    concatenated; else stacked on a new ``gather_axis`` dim),
    in member order."""
    if not tiled:
        x = x.unsqueeze(gather_axis)
    for a in reversed(_axes(axis)):     # inner axis first
        group = mesh.get_group(a)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        x = torch.cat(parts, dim=gather_axis)
    return x


def psum_scatter(x: torch.Tensor, axis: AxisName, mesh, *,
                 scatter_axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """reduce_scatter: the sum over the members, of which each keeps its
    chunk along ``scatter_axis`` (``tiled``; else the dim is the member
    count and is dropped)."""
    for a in _axes(axis):               # outer axis first
        group = mesh.get_group(a)
        n = dist.get_world_size(group)
        parts = [p.contiguous() for p in x.chunk(n, dim=scatter_axis)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=group)
        x = out
    return x if tiled else x.squeeze(scatter_axis)


def axis_index(axis: AxisName, mesh) -> int:
    """This process's index along ``axis`` (row-major over a tuple)."""
    idx = 0
    for a in _axes(axis):
        idx = idx * axis_size(a, mesh) + mesh.get_local_rank(a)
    return idx


def axis_size(axis: AxisName, mesh) -> int:
    n = 1
    for a in _axes(axis):
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def ring_permute(x: torch.Tensor, axis: str, mesh, *,
                 shift: int = 1) -> torch.Tensor:
    """Send ``x`` to member ``(i + shift) % n`` of ``axis`` and return what
    member ``(i - shift) % n`` sent (one ``batch_isend_irecv``)."""
    (out,) = permute_group((x,), mesh.get_group(axis), shift=shift).wait()
    return out


class Pending:
    """A rotation posted and not yet waited for: ``wait()`` returns the
    received tensors (on CUDA it orders the current stream after the
    transfer; the host does not block)."""

    def __init__(self, reqs, out):
        self.reqs, self.out = reqs, out

    def wait(self) -> Tuple[torch.Tensor, ...]:
        for req in self.reqs:
            req.wait()
        self.reqs = ()
        return self.out


def permute_group(xs: Sequence[torch.Tensor], group, *,
                  shift: int = 1) -> Pending:
    """Post the rotation of every tensor of ``xs`` to member ``(i + shift)
    % n`` of ``group``, receiving member ``(i - shift) % n``'s, in one
    ``batch_isend_irecv``, and return before the wait (:class:`Pending`):
    the caller runs its work on the current block meanwhile."""
    n = dist.get_world_size(group)
    out = tuple(torch.empty_like(x, memory_format=torch.contiguous_format)
                for x in xs)
    if n == 1:
        return Pending((), tuple(o.copy_(x) for o, x in zip(out, xs)))
    i = dist.get_group_rank(group, dist.get_rank())
    to = dist.get_global_rank(group, (i + shift) % n)
    frm = dist.get_global_rank(group, (i - shift) % n)
    ops = [dist.P2POp(dist.isend, x.contiguous(), to, group) for x in xs]
    ops += [dist.P2POp(dist.irecv, o, frm, group) for o in out]
    return Pending(dist.batch_isend_irecv(ops), out)


def _a2a(x: torch.Tensor, group, split_axis: int,
         concat_axis: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    moved = x.movedim(split_axis, 0)
    inp = moved.reshape(n, moved.shape[0] // n, *moved.shape[1:])
    inp = inp.contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    # out[j] is member j's chunk: back to x's layout, then member-major
    # along concat_axis.
    out = out.movedim(1, split_axis + 1).movedim(0, concat_axis)
    return out.flatten(concat_axis, concat_axis + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = group, split_axis, concat_axis
        return _a2a(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        group, split_axis, concat_axis = ctx.args
        return _a2a(grad, group, concat_axis, split_axis), None, None, None


def all_to_all_group(x: torch.Tensor, group, *, split_axis: int,
                     concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)`` over ``group``: ``x``'s dim
    ``split_axis`` is cut into n chunks, chunk j goes to member j, and the
    chunks received are concatenated along ``concat_axis`` in member
    order.  Differentiable: the backward is the inverse all-to-all."""
    if x.shape[split_axis] % dist.get_world_size(group):
        raise ValueError(f"dim {split_axis} ({x.shape[split_axis]}) does not "
                         f"split into {dist.get_world_size(group)} chunks")
    return _AllToAll.apply(x, group, split_axis, concat_axis)
