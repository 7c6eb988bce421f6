"""Ulysses (all-to-all) sequence parallelism — the port of
``kubeflow_controller_tpu/parallel/ulysses.py``.

Where ring attention keeps the queries at home and rotates K/V blocks
around the ``sp`` ring (``parallel/ring.py``), Ulysses makes two layout
moves: an all-to-all takes the sequence-sharded ``[B, T/n, H, D]`` q/k/v to
head-sharded ``[B, T, H/n, D]``, each device runs ordinary attention over
the whole sequence for its heads, and one more all-to-all takes the output
back to sequence shards.  The heads (after any tp split) must divide by
the sp size.

The layout moves are ``collectives.all_to_all_group`` over a process group
(differentiable: the backward is the inverse move), or, for n virtual
ranks in one process, :func:`all_to_all_lockstep`.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from .collectives import all_to_all_group
from .mesh import AXIS_DATA, AXIS_FSDP, AXIS_SEQUENCE, AXIS_TENSOR
from .ring import attention_reference, axis_group, flash_reason, seq_placements


def default_inner(qg, kg, vg, *, causal: bool, scale: float) -> torch.Tensor:
    """Attention over the gathered sequence: ``flash_attention`` where
    ``flash_reason`` allows (the kernels on CUDA, their plain versions on
    the CPU), else the f32 reference — the reference's default, with the
    kernels' rule in the place of its Mosaic tile rule."""
    if flash_reason(qg, kg, vg) is None:
        from ..ops.attention import flash_attention

        return flash_attention(qg, kg, vg, causal=causal, scale=scale)
    return attention_reference(qg, kg, vg, causal=causal, scale=scale)


def _check_heads(h: int, n: int) -> None:
    if h % n:
        raise ValueError(
            f"Ulysses needs heads ({h} after tp split) divisible by the sp "
            f"axis size ({n})")


def ulysses_attention_local(q, k, v, group, *, causal: bool = True,
                            scale: Optional[float] = None,
                            inner: Optional[Callable] = None
                            ) -> torch.Tensor:
    """One rank's Ulysses attention on its [B, T/n, H, D] shards over the
    process group ``group`` (None: a group of one)."""
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    inner = inner or default_inner
    if group is None:
        return inner(q, k, v, causal=causal, scale=scale)
    _check_heads(q.shape[2], dist.get_world_size(group))
    # seq-sharded -> head-sharded: split the heads n ways, gather the seq.
    to_heads = partial(all_to_all_group, group=group, split_axis=2,
                       concat_axis=1)
    out = inner(to_heads(q), to_heads(k), to_heads(v), causal=causal,
                scale=scale)
    # head-sharded -> seq-sharded: split the seq, gather the heads.
    return all_to_all_group(out, group, split_axis=1, concat_axis=2)


def all_to_all_lockstep(xs: List[torch.Tensor], *, split_axis: int,
                        concat_axis: int) -> List[torch.Tensor]:
    """The tiled all-to-all of n virtual ranks' tensors in one process:
    rank r gets chunk r of every rank's ``split_axis``, concatenated along
    ``concat_axis`` in rank order."""
    n = len(xs)
    parts = [x.chunk(n, dim=split_axis) for x in xs]
    return [torch.cat([parts[i][r] for i in range(n)], dim=concat_axis)
            for r in range(n)]


def ulysses_lockstep(qs, ks, vs, *, causal: bool = True,
                     scale: Optional[float] = None,
                     inner: Optional[Callable] = None) -> List[torch.Tensor]:
    """Ulysses over n virtual ranks' [B, T/n, H, D] shards in one process:
    the same layout moves and inner as :func:`ulysses_attention_local`,
    for one card (which cannot hold an NCCL gang) and the tests."""
    scale = float(qs[0].shape[-1] ** -0.5 if scale is None else scale)
    inner = inner or default_inner
    _check_heads(qs[0].shape[2], len(qs))
    to_heads = partial(all_to_all_lockstep, split_axis=2, concat_axis=1)
    outs = [inner(qg, kg, vg, causal=causal, scale=scale)
            for qg, kg, vg in zip(to_heads(qs), to_heads(ks), to_heads(vs))]
    return all_to_all_lockstep(outs, split_axis=1, concat_axis=2)


def ulysses_attention(q, k, v, mesh=None, *, causal: bool = True,
                      scale: Optional[float] = None,
                      axis_name: str = AXIS_SEQUENCE,
                      batch_axes=(AXIS_DATA, AXIS_FSDP),
                      head_axis: Optional[str] = AXIS_TENSOR,
                      inner: Optional[Callable] = None):
    """Exact attention of DTensors q/k/v of global shape [B, T, H, D] on
    ``mesh`` (default: q's), T sharded over ``axis_name`` — the contract of
    ``ring.ring_attention``, another collective pattern.  ``inner`` is the
    attention run on each head slice over the whole sequence (default:
    :func:`default_inner`)."""
    from torch.distributed.tensor.experimental import local_map

    mesh = mesh if mesh is not None else q.device_mesh
    placements = seq_placements(mesh, axis_name, batch_axes, head_axis)
    q, k, v = (x.redistribute(mesh, placements) for x in (q, k, v))
    fn = local_map(partial(ulysses_attention_local,
                           group=axis_group(mesh, axis_name), causal=causal,
                           scale=scale, inner=inner),
                   out_placements=placements,
                   in_placements=(placements,) * 3, device_mesh=mesh)
    return fn(q, k, v)
