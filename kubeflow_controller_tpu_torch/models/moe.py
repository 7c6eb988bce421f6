"""Mixture-of-Experts FFN, grouped (dropless) dispatch — the port of the
forward of ``kubeflow_controller_tpu/models/moe.py``'s ``"grouped"`` path.

Tokens are routed top-k (softmax over the selected k, the Mixtral
convention), laid out by expert into a group-aligned row layout (every
``bm``-row tile belongs to one expert), run through the grouped-matmul
kernels (``ops/grouped_matmul.py``: fused gate/up/SwiGLU, then the
down-projection) and gathered back, weighted by the router probabilities.

The layout is built exactly as the reference builds it, sort-free: each
slot's rank inside its expert is an exclusive cumsum over the one-hot
assignment, expert regions start at ``bm``-aligned padded offsets, tile
owners come from ``searchsorted(..., side="right")`` clamped to E - 1, and
pad rows read a sentinel zero row.  All of it stays on the device: no host
sync per layer.

Differences from the reference (ROADMAP.md, faults queue):

- the reference falls back to ``"einsum"`` below the TPU tiling grain (D or
  F not multiples of 128, B*T*k not a multiple of the dtype's sublane
  tile); those are Mosaic rules, and the port runs the grouped path at any
  shape;
- ``"einsum"``, ``"scatter"``, the ep-sharded path and the custom VJPs are
  not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
from torch.nn import functional as F

from ..ops.grouped_matmul import gmm, gmm_swiglu

_NOT_PORTED = ("moe dispatch={!r} is not ported yet (ROADMAP.md, module "
               "queue: 'MoE training'); the serving slice runs "
               "dispatch='grouped'")


def router_topk(logits: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., E] router logits -> (probs [..., k], indices [..., k]).

    Ties go to the lower expert index, as ``lax.top_k`` breaks them: a
    stable descending sort keeps equal logits in index order (``topk``
    promises no order).  bf16 router logits on the card make ties
    plausible."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[..., :k], dim=-1), idx[..., :k]


def _route(x: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """Router logits in the activation dtype, then f32 (as the reference
    rounds them), and the top-k choice."""
    logits = torch.einsum("btd,de->bte", x, router_w.to(x.dtype)).float()
    probs, idx = router_topk(logits, top_k)
    return logits, probs, idx


def _check_dispatch(dispatch: str) -> None:
    if dispatch in ("einsum", "scatter"):
        raise NotImplementedError(_NOT_PORTED.format(dispatch))
    if dispatch != "grouped":
        raise ValueError(f"unknown dispatch {dispatch!r}")


def _pow2_floor(block_m: int) -> int:
    if block_m < 1:
        raise ValueError(f"block_m must be >= 1, got {block_m}")
    return 1 << (block_m.bit_length() - 1)


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *, top_k: int = 2,
            dispatch: str = "grouped", block_m: int = 256) -> torch.Tensor:
    """Like :func:`moe_ffn_stats` but returns only the output (and skips
    the router statistics — eager PyTorch would otherwise compute what
    XLA dead-code-eliminates on the reference's serving path)."""
    _check_dispatch(dispatch)
    dtype = x.dtype
    _, probs, idx = _route(x, router_w, top_k)
    return _grouped_ffn(x, probs, idx, w_gate.to(dtype), w_up.to(dtype),
                        w_down.to(dtype), block_m=_pow2_floor(block_m))


def moe_ffn_stats(x: torch.Tensor, router_w: torch.Tensor,
                  w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor, *, top_k: int = 2,
                  capacity_factor: float = 1.25, capacity: int = 0,
                  dispatch: str = "grouped", block_m: int = 256):
    """x [B, T, D]; router_w [D, E]; w_gate/w_up [E, D, F]; w_down [E, F, D].

    Returns ``(y [B, T, D], stats)`` with the reference's router stats:
    ``aux_loss`` (Switch load balancing, E * sum_e f_e * P_e), ``z_loss``
    (mean logsumexp(logits)^2) and ``overflow_frac`` (0: grouped dispatch
    is dropless, so ``capacity_factor``/``capacity`` do not apply).

    ``dispatch`` defaults to ``"grouped"``, the one the port has; the
    reference defaults to ``"einsum"``."""
    _check_dispatch(dispatch)
    dtype = x.dtype
    n_experts = router_w.shape[-1]
    logits, probs, idx = _route(x, router_w, top_k)
    y = _grouped_ffn(x, probs, idx, w_gate.to(dtype), w_up.to(dtype),
                     w_down.to(dtype), block_m=_pow2_floor(block_m))
    assign = F.one_hot(idx, n_experts).float()                  # [B,T,k,E]
    f = assign.mean(dim=(0, 1, 2))
    p = torch.softmax(logits, dim=-1).mean(dim=(0, 1))
    stats: Dict[str, torch.Tensor] = {
        "aux_loss": n_experts * torch.sum(f * p),
        "z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "overflow_frac": torch.zeros((), device=x.device),
    }
    return y, stats


@dataclass
class GroupedLayout:
    """The group-aligned row layout of one routing batch.

    ``bm`` rows per tile; ``m`` = n_slots + E * bm rows in all (a static
    upper bound); ``dest[s]`` the layout row of routing slot s;
    ``tile_experts[i]`` the expert owning tile i (int32, clamped to E - 1
    past the last group); ``inv_src[r]`` the token feeding layout row r
    (``n_tok``, the sentinel zero row, for pad rows)."""

    bm: int
    m: int
    dest: torch.Tensor
    tile_experts: torch.Tensor
    inv_src: torch.Tensor


def grouped_layout(idx: torch.Tensor, n_experts: int,
                   block_m: int = 256) -> GroupedLayout:
    """The reference's sort-free layout for routing indices ``idx``
    [..., k] (``models/moe.py:_grouped_ffn``, steps 1-2)."""
    k = idx.shape[-1]
    n_slots = idx.numel()
    n_tok = n_slots // k
    dev = idx.device
    bm = block_m
    while n_slots % bm:
        bm //= 2
    slot_expert = idx.reshape(n_slots)
    onehot = F.one_hot(slot_expert, n_experts)                  # [N, E]
    pos = onehot.cumsum(dim=0) - onehot                         # exclusive
    rank = pos.gather(1, slot_expert[:, None])[:, 0]
    counts = onehot.sum(dim=0)
    padded = (counts + bm - 1) // bm * bm
    pad_offsets = padded.cumsum(dim=0) - padded
    m = n_slots + n_experts * bm
    dest = pad_offsets[slot_expert] + rank
    ends = pad_offsets + padded
    tile_starts = torch.arange(m // bm, device=dev) * bm
    tile_experts = torch.searchsorted(ends, tile_starts, right=True)
    tile_experts = tile_experts.clamp_(max=n_experts - 1).to(torch.int32)
    inv_src = torch.full((m,), n_tok, dtype=torch.long, device=dev)
    inv_src[dest] = torch.arange(n_slots, device=dev) // k
    return GroupedLayout(bm, m, dest, tile_experts, inv_src)


def _dispatch_rows(h: torch.Tensor, inv_src: torch.Tensor) -> torch.Tensor:
    """[n_tok, D] -> [M, D]: row p = h[inv_src[p]] (sentinel -> zero row)."""
    h_pad = torch.cat([h, h.new_zeros((1, h.shape[1]))], dim=0)
    return h_pad.index_select(0, inv_src)


def _combine_rows(y_pad: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """[M, D] -> [N, D]: slot s reads y_pad[dest[s]]."""
    return y_pad.index_select(0, dest)


def _grouped_ffn(x, probs, idx, w_gate, w_up, w_down,
                 block_m: int = 256) -> torch.Tensor:
    """Dropless expert FFN through the grouped-matmul kernels."""
    b, t, d = x.shape
    k = idx.shape[-1]
    lay = grouped_layout(idx, w_gate.shape[0], block_m)
    x_pad = _dispatch_rows(x.reshape(b * t, d), lay.inv_src)
    hh = gmm_swiglu(x_pad, w_gate, w_up, lay.tile_experts, lay.bm)
    y_pad = gmm(hh, w_down, lay.tile_experts, lay.bm)
    y_slot = _combine_rows(y_pad, lay.dest)                     # [N, D]
    return torch.einsum("btk,btkd->btd", probs.to(x.dtype),
                        y_slot.reshape(b, t, k, d))


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
