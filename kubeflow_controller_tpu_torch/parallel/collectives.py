"""Collectives over one mesh axis — the port of
``kubeflow_controller_tpu/parallel/collectives.py``.

The reference's named layer over ``lax`` collectives inside ``shard_map``;
here each runs over a ``DeviceMesh`` dim's process group
(``mesh.get_group(axis)``), on the calling process's local tensor, and
returns a new tensor.  An axis may be a tuple of mesh axes (outer first),
as a reference axis name may: the collective runs over each in turn.
Not differentiable: callers that need a gradient wrap them.
"""

from __future__ import annotations

from typing import Sequence, Union

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
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    i = dist.get_group_rank(group, dist.get_rank())
    out = torch.empty_like(x)
    if n == 1:
        return out.copy_(x)
    to = dist.get_global_rank(group, (i + shift) % n)
    frm = dist.get_global_rank(group, (i - shift) % n)
    ops = [dist.P2POp(dist.isend, x.contiguous(), to, group),
           dist.P2POp(dist.irecv, out, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out
