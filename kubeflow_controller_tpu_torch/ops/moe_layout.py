"""The MoE layer's grouped row layout: each routing slot's rank inside its
expert, and the maps built from it (``models/moe.py:grouped_layout``).

``moe_layout(idx, n_experts, bm, first_expert=None)`` takes the routing
indices ``idx`` [..., k] (int64) and returns ``(dest, tile_experts,
inv_src, inv_pos, valid_tiles)``: ``dest[s]`` the layout row of slot s
(int64 [N]); ``tile_experts[i]`` the expert owning row tile i (int32
[M / bm], clamped to E - 1 past the last group); ``inv_src[r]`` the token
feeding row r and ``inv_pos[r]`` the slot read back from it (int64 [M];
``n_tok`` and N, the sentinels, on pad rows); ``valid_tiles`` ([1] int32)
the real tiles before a shard's sentinel group, or None.  With
``first_expert``, experts ``first_expert .. first_expert + E - 1`` are
local and every other slot goes to a sentinel group after theirs.  M is
N + G * bm (G = E, or E + 1 with ``first_expert``); ``bm`` must be a
power of two dividing N (the caller halves it, as the reference does).

A slot's rank is the number of earlier slots, in slot order, that went to
its group: the reference's exclusive cumsum over the one-hot assignment.

For CUDA tensors the wrapper launches the hand-written kernel
(``csrc/moe_layout.cu``: count, offsets and place, three launches, no
atomics) or raises: ``idx`` int64, at least one slot, G at most
:data:`MAX_GROUPS`, M below 2**31.  The result equals the plain version's
bit for bit.  Only a tensor that lies on the CPU takes the plain version,
:func:`moe_layout_plain`, the cumsum over the one-hot as the reference
writes it.  ``moe_layout.launches`` counts the layouts built on the card,
one a call: in the benchmark's cells 12 a training step of
``trinitymini-train-b4-t8192`` (6 MoE layers, each in the forward and in
remat's re-run), 4 of ``mixtral8x7b-train-b2-t4096`` (2 layers) and 0 in
the dense Mistral cells.  The kernel replaces no Pallas kernel: the JAX
package leaves its ``jnp.cumsum`` to XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor
from torch.nn import functional as F

from . import _build

MAX_GROUPS = 1024     # the kernel's shared histograms: E (+ 1) at most
RUN = 256             # slots a warp of the kernel counts and places

Layout = Tuple[Tensor, Tensor, Tensor, Tensor, Optional[Tensor]]


def moe_layout_plain(idx: Tensor, n_experts: int, bm: int,
                     first_expert: Optional[int] = None) -> Layout:
    """The layout in plain PyTorch: the reference's sort-free body
    (``models/moe.py:_grouped_ffn``, steps 1-2), the rank an exclusive
    cumsum over the one-hot assignment."""
    k = idx.shape[-1]
    n_slots = idx.numel()
    n_tok = n_slots // k
    dev = idx.device
    slot_expert = idx.reshape(n_slots)
    groups, local = n_experts, None
    if first_expert is not None:
        local = ((slot_expert >= first_expert)
                 & (slot_expert < first_expert + n_experts))
        slot_expert = torch.where(local, slot_expert - first_expert,
                                  n_experts)
        groups += 1
    onehot = F.one_hot(slot_expert, groups)                     # [N, groups]
    pos = onehot.cumsum(dim=0) - onehot                         # exclusive
    rank = pos.gather(1, slot_expert[:, None])[:, 0]
    counts = onehot.sum(dim=0)
    padded = (counts + bm - 1) // bm * bm
    pad_offsets = padded.cumsum(dim=0) - padded
    m = n_slots + groups * bm
    dest = pad_offsets[slot_expert] + rank
    ends = pad_offsets + padded
    tile_starts = torch.arange(m // bm, device=dev) * bm
    tile_experts = torch.searchsorted(ends, tile_starts, right=True)
    tile_experts = tile_experts.clamp_(max=n_experts - 1).to(torch.int32)
    slot_ids = torch.arange(n_slots, device=dev)
    src, valid_tiles = slot_ids // k, None
    if local is not None:
        src = torch.where(local, src, n_tok)
        valid_tiles = (ends[n_experts - 1:n_experts] // bm).to(torch.int32)
    inv_src = torch.full((m,), n_tok, dtype=torch.long, device=dev)
    inv_src[dest] = src
    inv_pos = torch.full((m,), n_slots, dtype=torch.long, device=dev)
    inv_pos[dest] = slot_ids
    return dest, tile_experts, inv_src, inv_pos, valid_tiles


def _check(idx: Tensor, n_experts: int, bm: int,
           first_expert: Optional[int]) -> None:
    """Everything the kernel assumes, checked before any pointer crosses
    into C."""
    groups = n_experts + (first_expert is not None)
    if groups > MAX_GROUPS:
        raise ValueError(f"the layout kernel takes at most {MAX_GROUPS} "
                         f"groups (experts, plus a shard's sentinel "
                         f"group); got {groups}")
    if idx.dtype != torch.int64:
        raise TypeError(f"idx must be int64, got {idx.dtype}")
    n_slots = idx.numel()
    if n_experts < 1 or idx.dim() < 1 or n_slots < 1:
        raise ValueError(f"the layout needs an expert and a slot; got "
                         f"{n_experts} experts, idx {tuple(idx.shape)}")
    if bm <= 0 or bm & (bm - 1) or n_slots % bm:
        raise ValueError(f"bm={bm} must be a power of two dividing the "
                         f"{n_slots} slots")
    if n_slots + groups * bm >= 2 ** 31:
        raise ValueError(f"M = {n_slots} + {groups} * {bm} rows must stay "
                         "below 2**31")


def moe_layout(idx: Tensor, n_experts: int, bm: int,
               first_expert: Optional[int] = None) -> Layout:
    """The grouped layout of ``idx`` (see the module's docstring)."""
    if idx.device.type == "cpu":
        return moe_layout_plain(idx, n_experts, bm, first_expert)
    _check(idx, n_experts, bm, first_expert)
    k, n_slots = idx.shape[-1], idx.numel()
    groups = n_experts + (first_expert is not None)
    m = n_slots + groups * bm
    dev = idx.device
    flat = idx.reshape(n_slots).contiguous()
    units = -(-n_slots // RUN)
    workspace = torch.empty(units * groups + groups, dtype=torch.int32,
                            device=dev)
    dest = torch.empty(n_slots, dtype=torch.long, device=dev)
    tile_experts = torch.empty(m // bm, dtype=torch.int32, device=dev)
    inv_src = torch.empty(m, dtype=torch.long, device=dev)
    inv_pos = torch.empty(m, dtype=torch.long, device=dev)
    valid_tiles = (None if first_expert is None else
                   torch.empty(1, dtype=torch.int32, device=dev))
    lib = _build.library()
    code = lib.lib.kctpu_moe_layout(
        flat.data_ptr(), workspace.data_ptr(), dest.data_ptr(),
        tile_experts.data_ptr(), inv_src.data_ptr(), inv_pos.data_ptr(),
        None if valid_tiles is None else valid_tiles.data_ptr(), n_slots, k,
        n_experts, first_expert or 0, bm, _build.stream(flat))
    lib.check(code, "moe_layout")
    moe_layout.launches += 1
    return dest, tile_experts, inv_src, inv_pos, valid_tiles


moe_layout.launches = 0
