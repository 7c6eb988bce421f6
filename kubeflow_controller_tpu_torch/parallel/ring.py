"""Ring attention and the attention oracle — the port of
``kubeflow_controller_tpu/parallel/ring.py``.

The global sequence is split over the ``sp`` mesh axis: each device keeps
its query block, and the K/V blocks rotate around the ring, one
nearest-neighbour hop a step, while the attention of the blocks seen so far
is folded in.  Layout: ``[B, T, H, D]``, T sharded over ``sp``.

Two inners, as in the reference:

- dense (:func:`ring_dense_schedule`): the running (max, denominator,
  numerator) of every block's f32 scores; the numerics oracle and the
  fallback for shards the kernels cannot take.  Differentiated by autograd
  through the rotations (:class:`_Rotate`, whose backward rotates back).
- flash (:func:`ring_flash_forward`, :func:`ring_flash_backward`): each
  visible block is one ``flash_fwd`` call (``causal`` on the diagonal
  block, off on a past block; a block hidden under the causal mask launches
  nothing but still rotates), and the per-block (out, lse) pairs merge by
  logsumexp.  The backward computes ``delta = rowsum(dO * O)`` once from
  the merged output and calls ``flash_dq``/``flash_dkv`` on each visible
  block with the merged lse; dq adds up in f32 at home, and the f32 dk/dv
  accumulators rotate with their blocks, n rotations, so that each comes
  home.  :class:`_RingFlash` is the reference's ``_ring_flash_bh`` custom
  VJP.  Rank ``idx`` folds ``idx + 1`` blocks of a causal ring (the
  reference's load imbalance).

Each schedule is written once, for one rank, as a generator: it yields the
tensors it rotates, and is sent back a pending rotation whose ``wait()``
returns what the previous rank sent.  It yields the next block's K/V
before it runs the current block's kernels, so the transfer overlaps them;
in the backward the dk/dv accumulators leave after their block's kernels
and are waited for only after the next block's.  Two transports drive the
schedules, with the same per-block code:

- :class:`GroupRing`: over a process group (the mesh's ``sp`` group),
  ``collectives.permute_group`` (one ``batch_isend_irecv`` a rotation):
  the main path, through :func:`ring_attention` or the model's attention.
- :func:`run_lockstep`: n virtual ranks in one process, rank r handed what
  rank r - 1 yielded; for one card, which cannot hold an NCCL gang, and for
  the tests.

The reference's Mosaic rule ``flash_block`` is a TPU choice and is not
ported: the flash inner takes a shard that ``ops/attention.kernel_rule``
accepts (on the CPU, the kernels' plain versions take any shape), else the
dense inner runs (:func:`flash_reason`).
"""

from __future__ import annotations

from functools import partial
from typing import Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from .collectives import Pending, permute_group
from .mesh import AXIS_DATA, AXIS_FSDP, AXIS_SEQUENCE, AXIS_TENSOR

NEG_INF = -1e30

F32 = torch.float32


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Naive O(T²) attention in f32 — the numerics oracle.

    q/k/v: [B, T, H, D] -> [B, T, H, D] in q's dtype.  Scores are the
    products of the inputs accumulated in f32 (the reference's
    ``preferred_element_type``); masked scores are ``NEG_INF``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        hidden = (torch.arange(tq, device=q.device)[:, None]
                  < torch.arange(tk, device=q.device)[None, :])
        s = s.masked_fill(hidden, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def _ops():
    # ops/attention.py imports NEG_INF from here: import it when called.
    from ..ops import attention

    return attention


def flash_reason(q, k, v) -> Optional[str]:
    """Why the flash inner cannot take this shard, or None: on the CPU the
    kernels' plain versions take any shape; elsewhere ``kernel_rule``."""
    if q.device.type == "cpu":
        return None
    return _ops().kernel_rule(q, k, v)


def _block_kind(idx: int, s: int, n: int, causal: bool) -> Optional[bool]:
    """The block rank ``idx`` holds after ``s`` rotations (it started on
    rank ``(idx - s) % n``): the causal flag of its kernel calls (True on
    the diagonal block of a causal ring), or None when the causal mask
    hides it (a future block: no launch)."""
    if s == 0:
        return causal
    if causal and (idx - s) % n > idx:
        return None
    return False


# ---------------------------------------------------------------------------
# Dense inner
# ---------------------------------------------------------------------------

def _block_attend(q, k, v, m, l, o, *, q_start: int, kv_start: int,
                  causal: bool, scale: float):
    """Fold one K/V block into the running (m, l, o) accumulators."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        q_pos = q_start + torch.arange(tq, device=q.device)[:, None]
        kv_pos = kv_start + torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(q_pos < kv_pos, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    correction = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l_new = l * correction + p.sum(dim=-1, keepdim=True)
    o_new = o * correction + torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return m_new, l_new, o_new


def ring_dense_schedule(q, k, v, idx: int, n: int, causal: bool,
                        scale: float) -> Iterator:
    """Rank ``idx``'s dense ring (the reference's
    ``_ring_attention_local``): yields (k, v) before each of the first
    n - 1 blocks, returns the output [B, T, H, D] in q's dtype.  Its
    [B, H, T, T] f32 scores are the reason the flash inner exists."""
    b, t, h, d = q.shape
    m = torch.full((b, h, t, 1), NEG_INF, dtype=F32, device=q.device)
    l = torch.zeros((b, h, t, 1), dtype=F32, device=q.device)
    o = torch.zeros((b, h, t, d), dtype=F32, device=q.device)
    kv = (k, v)
    for s in range(n):
        nxt = (yield kv) if s < n - 1 else None
        m, l, o = _block_attend(q, *kv, m, l, o, q_start=idx * t,
                                kv_start=((idx - s) % n) * t, causal=causal,
                                scale=scale)
        if nxt is not None:
            kv = nxt.wait()
    out = o / torch.clamp_min(l, 1e-30)
    return out.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# Flash inner
# ---------------------------------------------------------------------------

def _rows(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """[B*H, T] per-row statistics -> [B, T, H, 1]."""
    return x.reshape(b, h, -1).transpose(1, 2)[..., None]


def _merge(o, lse, o_b, lse_b):
    """Running logsumexp merge of normalised per-block outputs."""
    b, _, h, _ = o.shape
    lse_new = torch.logaddexp(lse, lse_b)
    w_old = _rows(torch.exp(lse - lse_new), b, h)
    w_new = _rows(torch.exp(lse_b - lse_new), b, h)
    return o * w_old + o_b.float() * w_new, lse_new


def ring_flash_forward(q, k, v, idx: int, n: int, causal: bool,
                       scale: float) -> Iterator:
    """Rank ``idx``'s flash ring forward: yields (k, v) before each of the
    first n - 1 blocks, returns (out [B, T, H, D] in q's dtype, lse
    [B*H, T] f32).  q/k/v contiguous."""
    at = _ops()
    b, t, h, _ = q.shape
    o = torch.zeros(q.shape, dtype=F32, device=q.device)
    lse = torch.full((b * h, t), NEG_INF, dtype=F32, device=q.device)
    kv = (k, v)
    for s in range(n):
        nxt = (yield kv) if s < n - 1 else None
        diag = _block_kind(idx, s, n, causal)
        if diag is not None:
            o_b, lse_b = at.flash_fwd(q, *kv, diag, scale)
            o, lse = _merge(o, lse, o_b, lse_b)
        if nxt is not None:
            kv = nxt.wait()
    return o.to(q.dtype), lse


def ring_flash_backward(q, k, v, out, lse, do, idx: int, n: int,
                        causal: bool, scale: float) -> Iterator:
    """Rank ``idx``'s flash ring backward: returns (dq, dk, dv) in the
    inputs' dtypes.  Each step yields the next (k, v) before the block's
    kernels and the block's f32 (dk, dv) accumulators after them; the
    accumulators received are waited for only after the next block's
    kernels.  n rotations of the accumulators bring each home."""
    at = _ops()
    b, t, h, _ = q.shape
    delta = torch.einsum("bthd,bthd->bht", do.float(), out.float())
    delta = delta.reshape(b * h, t).contiguous()
    dq = torch.zeros(q.shape, dtype=F32, device=q.device)
    kv, acc = (k, v), None
    for s in range(n):
        nxt = (yield kv) if s < n - 1 else None
        diag = _block_kind(idx, s, n, causal)
        if diag is not None:
            dq = dq + at.flash_dq(q, *kv, do, lse, delta, diag, scale).float()
            dk_b, dv_b = at.flash_dkv(q, *kv, do, lse, delta, diag, scale)
        if acc is None:         # step 0: this rank's own block
            dk, dv = dk_b.float(), dv_b.float()
        else:
            dk, dv = acc.wait()
            if diag is not None:
                dk, dv = dk + dk_b.float(), dv + dv_b.float()
        acc = yield (dk, dv)
        if nxt is not None:
            kv = nxt.wait()
    dk, dv = acc.wait()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------

def _drive(schedule: Iterator, post):
    """Run one schedule, ``post`` taking each yielded tuple to a pending
    rotation; returns the schedule's value."""
    try:
        xs = next(schedule)
        while True:
            xs = schedule.send(post(xs))
    except StopIteration as stop:
        return stop.value


class _Rotate(torch.autograd.Function):
    """A differentiable rotation (the dense inner's): the backward sends
    each gradient back to the rank its tensor came from."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return permute_group(xs, group).wait()

    @staticmethod
    def backward(ctx, *grads):
        return (None, *permute_group(grads, ctx.group, shift=-1).wait())


class GroupRing:
    """The process-group transport: rotations over ``group`` (None: a
    ring of one), this process's index ``idx`` in it and its size ``n``."""

    def __init__(self, group=None):
        self.group = group
        self.n = 1 if group is None else dist.get_world_size(group)
        self.idx = (0 if group is None
                    else dist.get_group_rank(group, dist.get_rank()))

    def post(self, xs: Sequence[torch.Tensor]):
        if self.group is None:
            return Pending((), tuple(xs))
        if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
            return Pending((), _Rotate.apply(self.group, *xs))
        return permute_group(xs, self.group)

    def run(self, schedule: Iterator):
        return _drive(schedule, self.post)


def run_lockstep(schedules: List[Iterator]) -> list:
    """Drive one schedule per virtual rank of a ring in one process: at
    each rotation rank r is handed the tensors rank r - 1 yielded (the
    same objects: the schedules never write into what they receive).
    Returns each rank's value."""
    n = len(schedules)
    sends: list = [None] * n
    results: list = [None] * n
    live = [True] * n

    def resume(r, value):
        try:
            sends[r] = schedules[r].send(value)
        except StopIteration as stop:
            results[r], live[r] = stop.value, False

    for r in range(n):
        resume(r, None)
    while any(live):
        if not all(live):
            raise RuntimeError("the virtual ranks rotated out of step")
        received = [sends[(r - 1) % n] for r in range(n)]
        for r in range(n):
            resume(r, Pending((), received[r]))
    return results


# ---------------------------------------------------------------------------
# The differentiable op and the per-shard entry
# ---------------------------------------------------------------------------

class _RingFlash(torch.autograd.Function):
    """The reference's ``_ring_flash_bh`` custom VJP, on ``[B, T, H, D]``
    shards: the forward keeps (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, ring: GroupRing, causal: bool, scale: float):
        q, k, v = (x.contiguous() for x in (q, k, v))
        out, lse = ring.run(ring_flash_forward(q, k, v, ring.idx, ring.n,
                                               causal, scale))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.causal, ctx.scale = ring, causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        ring = ctx.ring
        dq, dk, dv = ring.run(ring_flash_backward(
            q, k, v, out, lse, do.contiguous(), ring.idx, ring.n,
            ctx.causal, ctx.scale))
        return dq, dk, dv, None, None, None


def ring_attention_local(q, k, v, ring: GroupRing, *, causal: bool = True,
                         scale: Optional[float] = None,
                         inner: str = "flash") -> torch.Tensor:
    """One rank's ring attention on its [B, T/n, H, D] shards (the body
    the reference runs under ``shard_map``).  ``inner`` "flash" takes the
    flash inner where :func:`flash_reason` allows, else the dense one."""
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    if inner == "flash" and flash_reason(q, k, v) is None:
        return _RingFlash.apply(q, k, v, ring, causal, scale)
    return ring.run(ring_dense_schedule(q, k, v, ring.idx, ring.n, causal,
                                        scale))


def seq_placements(mesh, axis_name: str = AXIS_SEQUENCE,
                   batch_axes=(AXIS_DATA, AXIS_FSDP),
                   head_axis: Optional[str] = AXIS_TENSOR) -> list:
    """DTensor placements of a [B, T, H, D] tensor on ``mesh``: the batch
    over ``batch_axes``, T over ``axis_name``, the heads over
    ``head_axis``; replicated over the other dims (the reference's
    ``P(batch_axes, axis_name, head_axis, None)``)."""
    from torch.distributed.tensor import Replicate, Shard

    batch = (batch_axes,) if isinstance(batch_axes, str) else tuple(
        batch_axes or ())
    dims = {**{a: 0 for a in batch}, axis_name: 1,
            **({head_axis: 2} if head_axis else {})}
    return [Shard(dims[name]) if name in dims else Replicate()
            for name in mesh.mesh_dim_names]


def axis_group(mesh, axis_name: str):
    """The process group of ``mesh``'s ``axis_name``, or None when the
    mesh lacks the axis or it has size 1."""
    names = mesh.mesh_dim_names
    if axis_name not in names or mesh.size(names.index(axis_name)) == 1:
        return None
    return mesh.get_group(axis_name)


def ring_attention(q, k, v, mesh=None, *, causal: bool = True,
                   scale: Optional[float] = None,
                   axis_name: str = AXIS_SEQUENCE,
                   batch_axes=(AXIS_DATA, AXIS_FSDP),
                   head_axis: Optional[str] = AXIS_TENSOR,
                   inner: str = "flash"):
    """Exact attention of DTensors q/k/v of global shape [B, T, H, D] on
    ``mesh`` (default: q's), placed by :func:`seq_placements` and run per
    shard through ``local_map``; the output is placed as q.  Safe when the
    axis has size 1 (plain attention).  ``inner``: "flash" (default) or
    "dense", as the reference's."""
    from torch.distributed.tensor.experimental import local_map

    mesh = mesh if mesh is not None else q.device_mesh
    placements = seq_placements(mesh, axis_name, batch_axes, head_axis)
    q, k, v = (x.redistribute(mesh, placements) for x in (q, k, v))
    ring = GroupRing(axis_group(mesh, axis_name))
    fn = local_map(partial(ring_attention_local, ring=ring, causal=causal,
                           scale=scale, inner=inner),
                   out_placements=placements,
                   in_placements=(placements,) * 3, device_mesh=mesh)
    return fn(q, k, v)
