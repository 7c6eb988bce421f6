"""Mixture-of-Experts FFN — the port of the single-device paths of
``kubeflow_controller_tpu/models/moe.py``, forward and backward.

Tokens are routed top-k (softmax over the selected k, the Mixtral
convention) and reach their experts through one of three dispatches, as in
the reference:

- ``"einsum"`` (the default): each expert holds ``C = capacity or
  max(1, ceil(T·k/E·capacity_factor))`` slots per sequence, filled in
  routing order; overflow drops (contributes zero).  One-hot dispatch and
  combine tensors ``[B, T, E, C]``, the k axis folded away before the
  one-hot (a token routes to an expert at most once).
- ``"scatter"``: the same capacity rule; tokens scatter into flat
  ``[B, E·C]`` expert buffers and gather back by slot index.  Dropped slots
  aim one row past ``E·C`` and are discarded.
- ``"grouped"``: dropless.  Tokens are laid out by expert into a
  group-aligned row layout (every ``bm``-row tile belongs to one expert),
  run through the grouped-matmul kernels (``ops/grouped_matmul.py``: fused
  gate/up/SwiGLU, then the down-projection) and gathered back, weighted by
  the router probabilities.

The grouped layout is the reference's, sort-free: each slot's rank inside
its expert is the number of earlier slots that went to it (the reference's
exclusive cumsum over the one-hot assignment), expert regions start at
``bm``-aligned padded offsets, tile owners come from ``searchsorted(...,
side="right")`` clamped to E - 1, and pad rows read a sentinel zero row.
On the card one hand-written pass computes the ranks and every map from
them (``ops/moe_layout.py`` → ``csrc/moe_layout.cu``, three launches); on
the CPU its plain version takes the cumsum.  All of it stays on the
device: no host sync per layer.  The two row gathers (dispatch and
combine) are bijections plus the sentinel, so their backward is a gather
through the inverse maps (``_DispatchRows``/``_CombineRows``), never a
scatter-add.

Grouped dispatch on a device other than the CPU obeys the CUDA kernels'
rule (:func:`grouped_kernel_rule`: bf16 activations, D and F multiples of
8); where it fails, the call falls back to ``"einsum"`` with one warning in
the reference's words, which ``--strict-moe-dispatch`` (a warnings filter
on "moe dispatch") turns into an error.  On the CPU the plain versions take
every shape.

Under a mesh (``mesh=``, the model mesh of ``models/llama.py``: dp, fsdp,
ep, sp, tp) every dispatch runs per shard, through two ``local_map``
regions, the analog of the reference's ``shard_map``.  Tokens are sharded
over the batch by dp x fsdp, over the sequence by sp, and replicated over
ep and tp; the expert weights come in gathered over dp and fsdp, their
expert dim sharded over ep and their F dim over tp.  The first region
routes each shard's tokens and returns the router statistics' per-shard
sums, which are summed over dp x fsdp x sp before ``aux_loss`` multiplies
its two means (a mean of per-shard products would be another loss).  The
capacity dispatches count their capacity from the global T and each
token's position in its expert's buffer over the whole (T, k) row of its
sequence, as the reference's auto-SPMD program does: a sequence shard's
positions start after the assignments the lower sp shards of the same
rows made (an exclusive prefix of the per-row counts over the sp group,
:func:`_sp_offsets`), so it drops exactly what one device drops.  The second runs the shard's own E/ep experts on its F/tp
slice: the einsum and scatter dispatches slice their capacity buffers to
those experts; "grouped" is the reference's ``_grouped_ffn_sharded``, the
dropless decomposition whose per-shard layout (:func:`grouped_layout` with
a local expert range) sends every other slot to a sentinel group and whose
gate, up and down ``gmm`` calls skip the tiles past ``valid_tiles``.  Its
output is a ``Partial`` sum over ep and tp, and one redistribution to
``Replicate`` (an all-reduce whose backward passes the gradient through)
closes the layer, where the reference calls ``psum``.

Sigmoid routing (:func:`biased_moe_ffn`, AFMoE's router, the port's own):
each expert's score is sigmoid(logit); the top k of score + an expert
bias (f32, the layer's ``expert_bias`` buffer) are chosen, ties to the
lower expert; their weights are the chosen scores over their sum, times a
route scale.  The weights multiply the experts' outputs.  After the
step's backward has passed the layer, the bias steps by ``bias_rate`` ·
sign(mean count - count) for each expert, the counts being the routing
slots the step's tokens gave it (aux-loss-free balancing): the top-k is an
autograd function (:class:`_BiasedTopK`) whose backward makes the update,
so it runs once a step, after remat's re-run of the layer has routed with
the same bias, and on the device.  The router scores every expert, and
the layer may hold only the first of them (one card's share under
expert parallelism): the held experts run through the ep-shard layout
(:func:`grouped_layout` with ``first_expert`` 0) and the skip kernels, and
the others' slots add nothing, as on the card that holds no exchange.

Differences from the reference (ROADMAP.md, faults queue): the reference's
fallback rule is the TPU tiling grain (D or F not multiples of 128, B·T·k
not a multiple of the dtype's sublane tile), and under a mesh the Mosaic
working set of its single-k kernel (``_single_k_blocks``), rules the port
does not carry.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from functools import partial
from typing import Dict, Optional, Tuple

import torch
from torch.nn import functional as F

from ..obs.trace import in_step_span, step_span
from ..ops.grouped_matmul import gmm, gmm_swiglu
from ..ops.moe_layout import moe_layout
from ..parallel.sharding import grad_placed
from .remat import checkpoint_name

DISPATCHES = ("einsum", "scatter", "grouped")


def router_topk(logits: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., E] router logits -> (probs [..., k], indices [..., k]).

    Ties go to the lower expert index, as ``lax.top_k`` breaks them: a
    stable descending sort keeps equal logits in index order (``topk``
    promises no order).  bf16 router logits on the card make ties
    plausible."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[..., :k], dim=-1), idx[..., :k]


@in_step_span("kctpu.moe.route")
def _route(x: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """Router logits in the activation dtype, then f32 (as the reference
    rounds them), and the top-k choice."""
    logits = (x @ router_w.to(x.dtype)).float()
    probs, idx = router_topk(logits, top_k)
    return logits, probs, idx


class _BiasedTopK(torch.autograd.Function):
    """``(scores, idx)``: ``scores`` [..., E] passed through, and the
    indices [..., k] of the top k of ``scores + bias`` (ties to the lower
    expert, as :func:`router_topk`).  The backward passes the scores'
    gradient through and steps ``bias`` in place by ``rate`` · sign(mean
    count - count) from the counts of the forward's slots."""

    @staticmethod
    def forward(ctx, scores, bias, k: int, rate: float):
        idx = torch.sort(scores + bias, dim=-1, descending=True,
                         stable=True)[1][..., :k]
        flat = idx.reshape(-1)
        counts = torch.zeros_like(bias).index_add_(
            0, flat, torch.ones_like(flat, dtype=bias.dtype))
        ctx.save_for_backward(counts)
        ctx.bias, ctx.rate = bias, rate
        ctx.mark_non_differentiable(idx)
        return scores.clone(), idx

    @staticmethod
    def backward(ctx, d_scores, _):
        (counts,) = ctx.saved_tensors
        with torch.no_grad():
            ctx.bias.add_(torch.sign(counts.mean() - counts), alpha=ctx.rate)
        return d_scores, None, None, None


@in_step_span("kctpu.moe.route")
def _route_sigmoid(x: torch.Tensor, router_w: torch.Tensor,
                   bias: torch.Tensor, top_k: int, route_scale: float,
                   bias_rate: float):
    """Router logits in the activation dtype, then f32; sigmoid scores,
    the biased top-k (:class:`_BiasedTopK`) and the chosen scores
    normalised and scaled: ``(weights [..., k] f32, idx [..., k])``."""
    scores = torch.sigmoid((x @ router_w.to(x.dtype)).float())
    scores, idx = _BiasedTopK.apply(scores, bias, top_k, bias_rate)
    chosen = scores.gather(-1, idx)
    return chosen / (chosen.sum(dim=-1, keepdim=True) + 1e-20) * \
        route_scale, idx


def biased_moe_ffn(x: torch.Tensor, router_w: torch.Tensor,
                   w_gate: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor, bias: torch.Tensor, *,
                   top_k: int, route_scale: float = 1.0,
                   bias_rate: float = 0.0, first_expert: int = 0
                   ) -> torch.Tensor:
    """x [B, T, D] through sigmoid-routed experts: ``router_w`` [D, E]
    scores all E experts, ``w_gate``/``w_up`` [E_h, D, F] and ``w_down``
    [E_h, F, D] are E_h of them from ``first_expert`` (E_h < E: one card's
    share, run through the shard layout and the skip kernels; the other
    experts' slots add nothing).  ``bias`` [E] f32 steps after the
    backward (:class:`_BiasedTopK`).  Dropless, through the grouped
    kernels only: no fallback to a capacity dispatch."""
    why = None if x.device.type == "cpu" else grouped_kernel_rule(x, w_gate)
    if why is not None:
        raise ValueError(f"sigmoid routing runs the grouped kernels, which "
                         f"cannot run under {why}")
    weights, idx = _route_sigmoid(x, router_w, bias, top_k, route_scale,
                                  bias_rate)
    dtype = x.dtype
    share = w_gate.shape[0] < router_w.shape[-1]
    return _grouped_ffn(x, weights, idx, w_gate.to(dtype), w_up.to(dtype),
                        w_down.to(dtype),
                        first_expert=first_expert if share else None)


def grouped_kernel_rule(x: torch.Tensor, w_gate: torch.Tensor
                        ) -> Optional[str]:
    """Why the grouped-matmul CUDA kernels cannot take this MoE call, or
    None when they can: bf16 activations (the weights are cast to them),
    D and F in whole 16-byte chunks."""
    d, f = x.shape[-1], w_gate.shape[-1]
    if x.dtype != torch.bfloat16:
        return f"the CUDA kernels' rule (bf16 operands, got {x.dtype})"
    if d % 8 or f % 8:
        return (f"the CUDA kernels' rule (D and F multiples of 8, got D={d}, "
                f"F={f})")
    return None


_GROUPED_FALLBACK_WARNED: set = set()


def _resolve_dispatch(dispatch: str, x: torch.Tensor,
                      w_gate: torch.Tensor) -> str:
    """The dispatch that runs: ``dispatch``, except that ``"grouped"`` off
    the CPU becomes ``"einsum"`` where :func:`grouped_kernel_rule` refuses,
    with one warning per reason (the reference's text and fallback)."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown dispatch {dispatch!r}")
    if dispatch != "grouped" or x.device.type == "cpu":
        return dispatch
    why = grouped_kernel_rule(x, w_gate)
    if why is None:
        return dispatch
    if why not in _GROUPED_FALLBACK_WARNED:
        # Recorded only once the warning returns: under an "error" filter
        # (--strict-moe-dispatch) every such call raises.
        warnings.warn(f"moe dispatch='grouped' cannot run under {why}; "
                      "falling back to 'einsum'", stacklevel=3)
        _GROUPED_FALLBACK_WARNED.add(why)
    return "einsum"


def _pow2_floor(block_m: int) -> int:
    if block_m < 1:
        raise ValueError(f"block_m must be >= 1, got {block_m}")
    return 1 << (block_m.bit_length() - 1)


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *, top_k: int = 2,
            capacity_factor: float = 1.25, capacity: int = 0,
            dispatch: str = "einsum", block_m: int = 256,
            mesh=None) -> torch.Tensor:
    """Like :func:`moe_ffn_stats` but returns only the output (and, with
    no mesh, skips the router statistics — eager PyTorch would otherwise
    compute what XLA dead-code-eliminates on the reference's serving
    path)."""
    if mesh is not None:
        return moe_ffn_stats(x, router_w, w_gate, w_up, w_down, top_k=top_k,
                             capacity_factor=capacity_factor,
                             capacity=capacity, dispatch=dispatch,
                             block_m=block_m, mesh=mesh)[0]
    dispatch = _resolve_dispatch(dispatch, x, w_gate)
    _, probs, idx = _route(x, router_w, top_k)
    y, _ = _dispatch_ffn(x, probs, idx, w_gate, w_up, w_down, dispatch,
                         capacity_factor, capacity, block_m)
    return y


def moe_ffn_stats(x: torch.Tensor, router_w: torch.Tensor,
                  w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor, *, top_k: int = 2,
                  capacity_factor: float = 1.25, capacity: int = 0,
                  dispatch: str = "einsum", block_m: int = 256, mesh=None):
    """x [B, T, D]; router_w [D, E]; w_gate/w_up [E, D, F]; w_down [E, F, D].

    Returns ``(y [B, T, D], stats)`` with the reference's router stats:
    ``aux_loss`` (Switch load balancing, E * sum_e f_e * P_e), ``z_loss``
    (mean logsumexp(logits)^2) and ``overflow_frac`` (the fraction of
    routing slots the capacity dropped, not differentiable; 0 for the
    dropless grouped dispatch).

    With ``mesh``, x and the weights are DTensors on it (the weights
    gathered over dp and fsdp, as ``models/llama.py:_w`` hands them over)
    and every dispatch runs per shard (:func:`_moe_ffn_mesh`); y and the
    stats come back as DTensors, y replicated over ep and tp."""
    if mesh is not None:
        with torch.no_grad():
            local_w = w_gate.to_local()
        dispatch = _resolve_dispatch(dispatch, x, local_w)
        return _moe_ffn_mesh(x, router_w, w_gate, w_up, w_down, top_k,
                             capacity_factor, capacity, dispatch, block_m)
    dispatch = _resolve_dispatch(dispatch, x, w_gate)
    logits, probs, idx = _route(x, router_w, top_k)
    y, keep = _dispatch_ffn(x, probs, idx, w_gate, w_up, w_down, dispatch,
                            capacity_factor, capacity, block_m)
    return y, _router_stats(logits, idx, keep)


@in_step_span("kctpu.moe.route")
def _router_stats(logits: torch.Tensor, idx: torch.Tensor,
                  keep: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
    n_experts = logits.shape[-1]
    assign = F.one_hot(idx, n_experts).float()                  # [B,T,k,E]
    f = assign.mean(dim=(0, 1, 2))
    p = torch.softmax(logits, dim=-1).mean(dim=(0, 1))
    if keep is None:
        overflow = torch.zeros((), device=logits.device)
    else:
        overflow = (1.0 - keep.sum() / assign.sum().clamp_min(1.0)).detach()
    return {
        "aux_loss": n_experts * torch.sum(f * p),
        "z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "overflow_frac": overflow,
    }


def _dispatch_ffn(x, probs, idx, w_gate, w_up, w_down, dispatch: str,
                  capacity_factor: float, capacity: int, block_m: int):
    """The expert FFN through ``dispatch``: ``(y, keep)``, where ``keep``
    [B, T, k, E] marks the kept (token, slot) assignments of the capacity
    dispatches (None for grouped, which keeps every one)."""
    dtype = x.dtype
    wg, wu, wd = w_gate.to(dtype), w_up.to(dtype), w_down.to(dtype)
    if dispatch == "grouped":
        return _grouped_ffn(x, probs, idx, wg, wu, wd,
                            block_m=_pow2_floor(block_m)), None
    n_experts = wg.shape[0]
    capacity = _capacity(idx.shape[1], idx.shape[2], n_experts,
                         capacity_factor, capacity)
    with step_span("kctpu.moe.dispatch"):
        pos_flat, pos, keep = _capacity_positions(idx, n_experts, capacity)
    if dispatch == "scatter":
        y = _scatter_ffn(x, probs, idx, pos_flat, capacity, wg, wu, wd)
    else:
        y = _einsum_ffn(x, probs, pos, keep, capacity, wg, wu, wd)
    return y, keep


def _capacity(t: int, k: int, n_experts: int, capacity_factor: float,
              capacity: int) -> int:
    """Slots per expert per sequence: ``capacity``, or ``max(1,
    ceil(T·k/E·capacity_factor))``."""
    return capacity or max(1, math.ceil(t * k / n_experts * capacity_factor))


def _capacity_positions(idx: torch.Tensor, n_experts: int, capacity: int,
                        offset: Optional[torch.Tensor] = None):
    """``(pos_flat [B, T·k, E], pos [B, T, k, E], keep [B, T, k, E])``:
    each (token, slot)'s position in its expert's buffer, counted in
    routing order over the flattened (T, k) axis (from ``offset`` [B, E],
    a sequence shard's start, when given), and the assignments that fit
    the capacity."""
    b, t, k = idx.shape
    assign = F.one_hot(idx, n_experts).float()                  # [B,T,k,E]
    flat = assign.reshape(b, t * k, n_experts)
    pos_flat = flat.cumsum(dim=1) - flat                        # exclusive
    if offset is not None:
        pos_flat = pos_flat + offset[:, None, :]
    pos = pos_flat.reshape(b, t, k, n_experts)
    keep = (pos < capacity) * assign                            # drop overflow
    return pos_flat, pos, keep


@in_step_span("kctpu.moe.experts")
def _expert_ffn(xe, w_gate, w_up, w_down) -> torch.Tensor:
    """xe [B, E, C, D] -> [B, E, C, D], each expert's SwiGLU."""
    with checkpoint_name("ffn_gate"):
        gate = torch.einsum("becd,edf->becf", xe, w_gate)
    with checkpoint_name("ffn_up"):
        up = torch.einsum("becd,edf->becf", xe, w_up)
    h = F.silu(gate) * up
    with checkpoint_name("ffn_down"):
        return torch.einsum("becf,efd->becd", h, w_down)


def _einsum_ffn(x, probs, pos, keep, capacity, w_gate, w_up, w_down):
    """One-hot dispatch and combine over [B, T, E, C]."""
    dtype = x.dtype
    with step_span("kctpu.moe.dispatch"):
        keep_e = keep.sum(dim=2)                                # [B,T,E] 0/1
        pos_e = (keep * pos).sum(dim=2).long()                  # [B,T,E]
        pos_oh = F.one_hot(pos_e, capacity).float()             # [B,T,E,C]
        disp = (keep_e[..., None] * pos_oh).to(dtype)
        with checkpoint_name("moe_x"):
            xe = torch.einsum("btec,btd->becd", disp, x)
    ye = _expert_ffn(xe, w_gate, w_up, w_down)
    with step_span("kctpu.moe.combine"):
        prob_e = torch.einsum("btk,btke->bte", probs, keep)
        combine = (prob_e[..., None] * pos_oh).to(dtype)
        with checkpoint_name("moe_y"):
            return torch.einsum("btec,becd->btd", combine, ye)


def _scatter_ffn(x, probs, idx, pos_flat, capacity, w_gate, w_up, w_down,
                 first_expert: int = 0):
    """Tokens scatter into the flat expert buffers, results gather back.
    The weights hold experts ``first_expert ..`` (an ep shard's); slots
    of the other experts are dropped here and read zero."""
    b, t, d = x.shape
    k = idx.shape[-1]
    n_experts = w_gate.shape[0]
    slots = n_experts * capacity
    with step_span("kctpu.moe.dispatch"):
        slot_g = idx.reshape(b, t * k)
        slot_pos = pos_flat.gather(-1, slot_g[..., None])[..., 0].long()
        slot_e = slot_g - first_expert
        slot_keep = ((slot_pos < capacity) & (slot_e >= 0)
                     & (slot_e < n_experts))
        # Flat buffer row e * C + pos; dropped slots aim at the extra row
        # ``slots``, which is cut off.
        target = torch.where(slot_keep, slot_e * capacity + slot_pos, slots)
        rows = target[..., None].expand(b, t * k, d)
        xe = x.new_zeros((b, slots + 1, d)).scatter_add(
            1, rows, x.repeat_interleave(k, dim=1))[:, :slots]
    ye = _expert_ffn(xe.reshape(b, n_experts, capacity, d), w_gate, w_up,
                     w_down).reshape(b, slots, d)
    with step_span("kctpu.moe.combine"):
        y_slot = ye.gather(1, rows.clamp(max=slots - 1))
        y_slot = torch.where(slot_keep[..., None], y_slot, 0)
        return torch.einsum("btk,btkd->btd", probs.to(x.dtype),
                            y_slot.reshape(b, t, k, d))


@dataclass
class GroupedLayout:
    """The group-aligned row layout of one routing batch.

    ``bm`` rows per tile; ``m`` = n_slots + groups * bm rows in all (a
    static upper bound); ``dest[s]`` the layout row of routing slot s;
    ``tile_experts[i]`` the expert owning tile i (int32, clamped to E - 1
    past the last group); ``inv_src[r]`` the token feeding layout row r
    (``n_tok``, the sentinel zero row, for pad rows); ``inv_pos[r]`` the
    slot read back from row r (``n_slots``, the sentinel, for pad rows);
    ``valid_tiles`` ([1] int32, a shard's layout only) the count of real
    tiles, before the sentinel group's."""

    bm: int
    m: int
    dest: torch.Tensor
    tile_experts: torch.Tensor
    inv_src: torch.Tensor
    inv_pos: torch.Tensor
    valid_tiles: Optional[torch.Tensor] = None


def grouped_layout(idx: torch.Tensor, n_experts: int, block_m: int = 256,
                   first_expert: Optional[int] = None) -> GroupedLayout:
    """The reference's sort-free layout for routing indices ``idx``
    [..., k] (``models/moe.py:_grouped_ffn``, steps 1-2).

    With ``first_expert`` it is one ep shard's layout (the body of the
    reference's ``_grouped_ffn_sharded``): experts ``first_expert ..
    first_expert + n_experts - 1`` are local, every other slot goes to a
    sentinel group after theirs, whose rows read the zero row; ``m`` is
    n_slots + (n_experts + 1) * bm, the worst case; and ``valid_tiles``
    is the sentinel group's first tile.  All on the device: the ranks and
    maps come from ``ops/moe_layout.py:moe_layout`` (the kernel on the
    card, the one-hot cumsum on the CPU); ``bm`` and ``m`` are set here."""
    n_slots = idx.numel()
    bm = block_m
    while n_slots % bm:
        bm //= 2
    groups = n_experts + (first_expert is not None)
    dest, tile_experts, inv_src, inv_pos, valid_tiles = moe_layout(
        idx, n_experts, bm, first_expert)
    return GroupedLayout(bm, n_slots + groups * bm, dest, tile_experts,
                         inv_src, inv_pos, valid_tiles)


def _with_zero_row(h: torch.Tensor) -> torch.Tensor:
    return torch.cat([h, h.new_zeros((1, h.shape[1]))], dim=0)


class _DispatchRows(torch.autograd.Function):
    """[n_tok, D] -> [M, D]: row p = h[inv_src[p]] (sentinel -> zero row).
    Backward: dh[t] = sum over t's k slots of dy[slot_dest2d[t, :]], gathers
    through the inverse map (the reference's ``_dispatch_rows`` VJP)."""

    @staticmethod
    def forward(ctx, h, inv_src, slot_dest2d):
        ctx.save_for_backward(slot_dest2d)
        h = _with_zero_row(h)
        with checkpoint_name("moe_x"):
            return h.index_select(0, inv_src)

    @staticmethod
    def backward(ctx, dy):
        (slot_dest2d,) = ctx.saved_tensors
        dh = dy.index_select(0, slot_dest2d[:, 0])
        for j in range(1, slot_dest2d.shape[1]):
            dh = dh + dy.index_select(0, slot_dest2d[:, j])
        return dh, None, None


class _CombineRows(torch.autograd.Function):
    """[M, D] -> [N, D]: slot s reads y_pad[slot_dest[s]].  Backward:
    dy_pad[p] = d[inv_pos[p]] (sentinel -> zero), a gather, since the map is
    a bijection on real rows (the reference's ``_combine_rows`` VJP)."""

    @staticmethod
    def forward(ctx, y_pad, slot_dest, inv_pos):
        ctx.save_for_backward(inv_pos)
        return y_pad.index_select(0, slot_dest)

    @staticmethod
    def backward(ctx, d):
        (inv_pos,) = ctx.saved_tensors
        return _with_zero_row(d).index_select(0, inv_pos), None, None


def _dispatch_rows(h: torch.Tensor, inv_src: torch.Tensor,
                   slot_dest2d: torch.Tensor) -> torch.Tensor:
    return _DispatchRows.apply(h, inv_src, slot_dest2d)


def _combine_rows(y_pad: torch.Tensor, slot_dest: torch.Tensor,
                  inv_pos: torch.Tensor) -> torch.Tensor:
    return _CombineRows.apply(y_pad, slot_dest, inv_pos)


def _grouped_ffn(x, probs, idx, w_gate, w_up, w_down, block_m: int = 256,
                 first_expert: Optional[int] = None) -> torch.Tensor:
    """Dropless expert FFN through the grouped-matmul kernels.  With
    ``first_expert`` the weights are one ep shard's experts and the FFN
    runs on that shard's layout (:func:`grouped_layout`): gate and up as
    two ``gmm`` calls, not ``gmm_swiglu``, since only ``gmm`` skips the
    tiles past ``valid_tiles`` (the reference's ``_grouped_ffn_sharded``),
    and the output holds the local experts' share only."""
    b, t, d = x.shape
    k = idx.shape[-1]
    with step_span("kctpu.moe.dispatch"):
        lay = grouped_layout(idx, w_gate.shape[0], block_m, first_expert)
        x_pad = _dispatch_rows(x.reshape(b * t, d), lay.inv_src,
                               lay.dest.reshape(b * t, k))
    te, bm, vt = lay.tile_experts, lay.bm, lay.valid_tiles
    with step_span("kctpu.moe.experts"):
        if vt is None:
            with checkpoint_name("ffn_up"):
                hh = gmm_swiglu(x_pad, w_gate, w_up, te, bm)
        else:
            with checkpoint_name("ffn_gate"):
                gate = gmm(x_pad, w_gate, te, bm, vt)
            with checkpoint_name("ffn_up"):
                up = gmm(x_pad, w_up, te, bm, vt)
            hh = F.silu(gate) * up
        with checkpoint_name("ffn_down"):
            y_pad = gmm(hh, w_down, te, bm, vt)
    with step_span("kctpu.moe.combine"):
        y_slot = _combine_rows(y_pad, lay.dest, lay.inv_pos)    # [N, D]
        return torch.einsum("btk,btkd->btd", probs.to(x.dtype),
                            y_slot.reshape(b, t, k, d))


# ---------------------------------------------------------------------------
# Under a mesh
# ---------------------------------------------------------------------------

def _moe_ffn_mesh(x, router_w, w_gate, w_up, w_down, top_k: int,
                  capacity_factor: float, capacity: int, dispatch: str,
                  block_m: int):
    """:func:`moe_ffn_stats` on DTensors: x sharded over the batch by the
    mesh dims that split it (dp, fsdp), over the sequence by sp, and
    replicated over the others; the router replicated; the expert weights sharded over the
    mesh dims that split the experts (ep on E, tp on F) and replicated
    over the token dims.

    Gradients are placed by what each shard's share is: a shard's x and
    probs gradients cover its experts only (``Partial`` over ep and tp),
    its weight gradients its tokens only (``Partial`` over dp and fsdp),
    and the output is ``Partial`` over ep and tp until the closing
    redistribution sums it."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    b, t, _ = x.shape
    n_experts = router_w.shape[-1]
    xp = list(x.placements)
    weights = (w_gate, w_up, w_down)
    tok_dims = {i for i, pl in enumerate(xp) if pl != Replicate()}
    w_dims = {i for w in weights for i, pl in enumerate(w.placements)
              if pl != Replicate()}
    seq_dims = [i for i, pl in enumerate(xp) if pl == Shard(1)]
    if (any(pl not in (Shard(0), Shard(1), Replicate()) for pl in xp)
            or len(seq_dims) > 1 or tok_dims & w_dims
            or any(pl != Replicate() for pl in router_w.placements)):
        raise ValueError(
            f"MoE under a mesh takes tokens sharded on the batch and on "
            f"the sequence by one mesh dim ({xp}), expert weights "
            f"replicated where the tokens are split "
            f"({[w.placements for w in weights]}) and a replicated router "
            f"({router_w.placements})")
    # The sp group over which a capacity dispatch's positions continue.
    seq_group = (mesh.get_group(seq_dims[0])
                 if seq_dims and dispatch != "grouped" else None)
    ep_shards, e_first = 1, 0
    for i, pl in enumerate(w_gate.placements):  # mesh order, as DTensor splits
        if pl == Shard(0):
            ep_shards *= mesh.size(i)
            e_first = e_first * mesh.size(i) + mesh.get_local_rank(i)
    if n_experts % ep_shards:
        raise ValueError(f"E={n_experts} not divisible by the {ep_shards} "
                         f"expert shards")

    def over(placements, dims):
        return [Partial() if i in dims else pl
                for i, pl in enumerate(placements)]

    # x feeds both regions, and the second's x gradient is partial over
    # ep and tp: sum it here (the reference's psum of a replicated input's
    # cotangent at its shard_map), so that x's gradient keeps x's
    # placements.
    x = grad_placed(x)
    rep = [Replicate()] * mesh.ndim
    sums = over(rep, tok_dims)
    cap = (0 if dispatch == "grouped" else
           _capacity(t, top_k, n_experts, capacity_factor, capacity))
    route = local_map(
        partial(_route_sums, top_k=top_k, capacity=cap, seq_group=seq_group),
        out_placements=(xp, xp, sums, sums, sums, sums),
        in_placements=(xp, list(router_w.placements)),
        in_grad_placements=(xp, over(router_w.placements, tok_dims)),
        device_mesh=mesh)
    probs, idx, f_sum, p_sum, z_sum, kept = route(x, router_w)

    e_local = n_experts // ep_shards
    wgp, wdp = list(w_gate.placements), list(w_down.placements)
    yp = over(xp, w_dims)
    experts = local_map(
        partial(_experts_local, dispatch=dispatch, n_experts=n_experts,
                first_expert=e_first * e_local, capacity=cap,
                block_m=_pow2_floor(block_m), seq_group=seq_group),
        out_placements=yp,
        in_placements=(xp, xp, xp, wgp, wgp, wdp),
        in_grad_placements=(yp, yp, xp, over(wgp, tok_dims),
                            over(wgp, tok_dims), over(wdp, tok_dims)),
        device_mesh=mesh)
    # The closing sum over ep and tp (the reference's psum).
    y = experts(x, probs, idx, w_gate, w_up, w_down).redistribute(mesh, xp)

    n_tok = b * t
    n_slots = n_tok * top_k
    f = f_sum.redistribute(mesh, rep) / n_slots
    p = p_sum.redistribute(mesh, rep) / n_tok
    stats = {
        "aux_loss": n_experts * torch.sum(f * p),
        "z_loss": z_sum.redistribute(mesh, rep) / n_tok,
        "overflow_frac": (1.0 - kept.redistribute(mesh, rep)
                          / max(n_slots, 1)).detach(),
    }
    return y, stats


def _sp_offsets(idx: torch.Tensor, n_experts: int, group):
    """[B, E]: per sequence row and expert, the assignments that the sp
    shards below this one made (an exclusive prefix over ``group`` of the
    per-row counts; None without a group)."""
    if group is None:
        return None
    import torch.distributed as dist

    counts = F.one_hot(idx, n_experts).float().sum(dim=(1, 2))   # [B, E]
    parts = [torch.empty_like(counts)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, counts.contiguous(), group=group)
    below = parts[:dist.get_group_rank(group, dist.get_rank())]
    return sum(below, torch.zeros_like(counts))


@in_step_span("kctpu.moe.route")
def _route_sums(x, router_w, *, top_k: int, capacity: int, seq_group=None):
    """One shard's routing, and its sums of the router statistics:
    ``(probs, idx, Σ assign [E], Σ softmax [E], Σ lse², Σ keep)`` (keep:
    the assignments within ``capacity``; every one when it is 0; positions
    continued over ``seq_group``'s lower shards)."""
    logits, probs, idx = _route(x, router_w, top_k)
    n_experts = router_w.shape[-1]
    assign = F.one_hot(idx, n_experts).float()
    keep = (_capacity_positions(idx, n_experts, capacity, _sp_offsets(
        idx, n_experts, seq_group))[2] if capacity else assign)
    return (probs, idx, assign.sum(dim=(0, 1, 2)),
            torch.softmax(logits, dim=-1).sum(dim=(0, 1)),
            (torch.logsumexp(logits, dim=-1) ** 2).sum(), keep.sum())


def _experts_local(x, probs, idx, w_gate, w_up, w_down, *, dispatch: str,
                   n_experts: int, first_expert: int, capacity: int,
                   block_m: int, seq_group=None):
    """One shard's expert FFN: its experts ``first_expert ..`` on its F
    slice; the output is its share of y (summed over ep and tp after).  A
    sequence shard's capacity positions continue those of the lower shards
    of ``seq_group``."""
    dtype = x.dtype
    wg, wu, wd = w_gate.to(dtype), w_up.to(dtype), w_down.to(dtype)
    if dispatch == "grouped":
        return _grouped_ffn(x, probs, idx, wg, wu, wd, block_m, first_expert)
    with step_span("kctpu.moe.dispatch"):
        pos_flat, pos, keep = _capacity_positions(
            idx, n_experts, capacity, _sp_offsets(idx, n_experts, seq_group))
    if dispatch == "scatter":
        return _scatter_ffn(x, probs, idx, pos_flat, capacity, wg, wu, wd,
                            first_expert)
    own = slice(first_expert, first_expert + wg.shape[0])
    return _einsum_ffn(x, probs, pos[..., own], keep[..., own], capacity,
                       wg, wu, wd)


def moe_ffn_reference(x, router_w, w_gate, w_up, w_down, *,
                      top_k: int = 2) -> torch.Tensor:
    """Dense oracle: every token through its top-k experts, no capacity
    limit, all experts computed densely."""
    n_experts = router_w.shape[-1]
    logits = torch.einsum("btd,de->bte", x, router_w).float()
    probs, idx = router_topk(logits, top_k)
    gate = torch.einsum("btd,edf->btef", x, w_gate)
    up = torch.einsum("btd,edf->btef", x, w_up)
    h = F.silu(gate) * up
    y_all = torch.einsum("btef,efd->bted", h, w_down)
    sel = torch.einsum("btk,btke->bte", probs,
                       F.one_hot(idx, n_experts).to(probs.dtype))
    return torch.einsum("bte,bted->btd", sel.to(x.dtype), y_all)
