"""Slot-paged KV cache for the serving plane — the port of the paged half
of ``kubeflow_controller_tpu/models/generate.py``.

One physical row pool ``[L, R, kvH, D]`` (R = num_pages * page_size) is
shared by every slot; a host-side page table per slot maps logical
position j of slot b to physical row ``page_table[b, j // page] * page +
j % page``.  Physical page 0 is a scratch page: bucket-padded prefill
positions past the real prompt length write there, so padding never
corrupts another slot's rows.

Differences from the reference that change no value:

- the layer ``lax.scan`` is a Python loop over ``model.layers``;
- the cache is updated IN PLACE (``index_copy_`` / indexed assignment) and
  the same dict is returned, where JAX returns a new functional cache;
- functions take the parameter module (``models.llama.Llama``) where the
  reference takes the pytree.

Not ported yet (ROADMAP.md): ``forward_with_cache``, ``generate``, the
blocked length-masked read ``_cache_attention_blocked`` and int8
``kv_quant``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..device import DeviceLike, resolve_device, torch_dtype
from .llama import Llama, LlamaConfig, LlamaLayer, apply_rope, ffn_block, rmsnorm, rope_freqs

Cache = Dict[str, torch.Tensor]
NEG_INF = -1e30


def init_paged_cache(cfg: LlamaConfig, num_pages: int, page_size: int,
                     device: DeviceLike = "cuda") -> Cache:
    """The physical row pool shared by every slot (page 0 = scratch)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, num_pages * page_size, cfg.n_kv_heads,
             cfg.head_dim)
    dtype = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _apply_rope_rows(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Per-row RoPE: x [B, H, D] with angles [B, D//2] (each batch row at
    its own absolute position — the continuous-batching decode shape)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = torch.cos(angles)[:, None, :]
    sin = torch.sin(angles)[:, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _cache_attention_dense(q: torch.Tensor, kk: torch.Tensor,
                           vv: torch.Tensor, mask: torch.Tensor):
    """Full-S masked read.  q [B,T,H,D]; kk/vv [B,S,H,D] (kv heads already
    repeated).  Scores in f32 (the reference's preferred_element_type),
    V read in f32, output cast back to q's dtype."""
    d = q.shape[-1]
    s = torch.einsum("bthd,bshd->bhts", q.float(), kk.float()) * d ** -0.5
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, vv.float()).to(q.dtype)


def _qkv(x: torch.Tensor, lp: LlamaLayer, cfg: LlamaConfig):
    dtype = x.dtype
    h = rmsnorm(x, lp.attn_norm, cfg.norm_eps)
    q = torch.einsum("btd,dhk->bthk", h, lp.wq.to(dtype))
    k = torch.einsum("btd,dhk->bthk", h, lp.wk.to(dtype))
    v = torch.einsum("btd,dhk->bthk", h, lp.wv.to(dtype))
    return q, k, v


def _finish_layer(x: torch.Tensor, attn: torch.Tensor, lp: LlamaLayer,
                  cfg: LlamaConfig) -> torch.Tensor:
    """Output projection + residual, then the FFN block + residual."""
    x = x + torch.einsum("bthk,hkd->btd", attn, lp.wo.to(x.dtype))
    h = rmsnorm(x, lp.mlp_norm, cfg.norm_eps)
    return x + ffn_block(h, lp, cfg)


def _repeat_kv(t: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """GQA: expand kv heads (axis 2) to query heads."""
    repeats = cfg.n_heads // cfg.n_kv_heads
    return t.repeat_interleave(repeats, dim=2) if repeats > 1 else t


def _last_logits(model: Llama, x: torch.Tensor, plen: int,
                 cfg: LlamaConfig) -> torch.Tensor:
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    last = x[0, plen - 1]
    return (last @ model.lm_head.to(x.dtype)).float()


@torch.no_grad()
def paged_prefill(model: Llama, tokens: torch.Tensor, cache: Cache,
                  rows: torch.Tensor, plen: int,
                  cfg: LlamaConfig) -> Tuple[torch.Tensor, Cache]:
    """Prefill ONE prompt into its slot's pages.

    ``tokens`` [1, T] is the prompt padded to a bucket length T; ``rows``
    [T] maps each prompt position to its physical row (scratch rows for
    positions >= ``plen``, the real length).  Attention is dense causal
    within the prompt — no cache read.  Returns (last real position's
    logits [vocab] f32, the cache, updated in place)."""
    dtype = torch_dtype(cfg.dtype)
    _, t = tokens.shape
    x = model.embed[tokens].to(dtype)
    positions = torch.arange(t, device=tokens.device)
    angles = rope_freqs(cfg, positions)
    mask = (positions[None, :] <= positions[:, None])[None, None, :, :]
    for li, lp in enumerate(model.layers):
        q, k, v = _qkv(x, lp, cfg)
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)  # written pre-rotated
        cache["k"][li].index_copy_(0, rows, k[0].to(cache["k"].dtype))
        cache["v"][li].index_copy_(0, rows, v[0].to(cache["v"].dtype))
        attn = _cache_attention_dense(q, _repeat_kv(k, cfg),
                                      _repeat_kv(v, cfg), mask)
        x = _finish_layer(x, attn, lp, cfg)
    return _last_logits(model, x, plen, cfg), cache


@torch.no_grad()
def copy_cache_rows(cache: Cache, src_rows: torch.Tensor,
                    dst_rows: torch.Tensor) -> Cache:
    """Copy physical rows ``src_rows`` -> ``dst_rows`` in the paged pool,
    in place — the copy-on-write primitive behind cross-request prefix
    sharing.  K rows are written pre-rotated at absolute positions and V
    rows are position-independent, so a row copy is exact for any
    destination page holding the same logical positions."""
    for arr in cache.values():
        arr[:, dst_rows] = arr[:, src_rows]
    return cache


@torch.no_grad()
def paged_extend(model: Llama, tokens: torch.Tensor, cache: Cache,
                 write_rows: torch.Tensor, read_rows: torch.Tensor,
                 start_pos: int, plen: int,
                 cfg: LlamaConfig) -> Tuple[torch.Tensor, Cache]:
    """Prefill ONE prompt's divergent TAIL on top of a shared prefix.

    The slot's first ``start_pos`` positions are already resident in the
    pool.  ``tokens`` [1, T] is the tail padded to a bucket; ``write_rows``
    [T] places tail position j (absolute ``start_pos + j``; scratch row 0
    for padding positions >= ``plen``); ``read_rows`` [S] maps every
    logical position of the slot to its physical row.  Each layer writes
    the tail's K/V first, then attends through ``read_rows`` against
    prefix + tail together.  Returns (last real tail position's logits
    [vocab] f32, the cache, updated in place)."""
    dtype = torch_dtype(cfg.dtype)
    _, t = tokens.shape
    s = read_rows.shape[0]
    x = model.embed[tokens].to(dtype)
    q_pos = start_pos + torch.arange(t, device=tokens.device)
    angles = rope_freqs(cfg, q_pos)
    # Causal over LOGICAL positions: tail position start+j attends to
    # logical positions <= start+j (prefix + the tail up to itself).
    mask = (torch.arange(s, device=tokens.device)[None, :]
            <= q_pos[:, None])[None, None, :, :]
    for li, lp in enumerate(model.layers):
        q, k, v = _qkv(x, lp, cfg)
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
        cache["k"][li].index_copy_(0, write_rows, k[0].to(cache["k"].dtype))
        cache["v"][li].index_copy_(0, write_rows, v[0].to(cache["v"].dtype))
        kk = cache["k"][li][read_rows][None].to(dtype)      # [1,S,kvH,hd]
        vv = cache["v"][li][read_rows][None].to(dtype)
        attn = _cache_attention_dense(q, _repeat_kv(kk, cfg),
                                      _repeat_kv(vv, cfg), mask)
        x = _finish_layer(x, attn, lp, cfg)
    return _last_logits(model, x, plen, cfg), cache


@torch.no_grad()
def paged_decode_step(model: Llama, tokens: torch.Tensor, cache: Cache,
                      positions: torch.Tensor, page_tables: torch.Tensor,
                      cfg: LlamaConfig,
                      page_size: int) -> Tuple[torch.Tensor, Cache]:
    """One decode step for a mixed batch of slots.

    ``tokens`` [B] (last sampled token per slot), ``positions`` [B] (each
    slot's own absolute position), ``page_tables`` [B, P] (physical page
    per logical block; unallocated blocks may point anywhere — the length
    mask never reads past ``positions``).  Idle slots are computed and
    masked by the caller (their page-0 scratch rows are harmless to read
    and write).  Returns (logits [B, vocab] f32, the cache, updated in
    place)."""
    dtype = torch_dtype(cfg.dtype)
    b = tokens.shape[0]
    s = page_tables.shape[1] * page_size
    dev = tokens.device
    x = model.embed[tokens].to(dtype)[:, None, :]             # [B, 1, D]
    angles = rope_freqs(cfg, positions)                       # [B, D//2]
    # Gather map: logical position j of slot b -> physical row.
    read_rows = (page_tables[:, :, None] * page_size
                 + torch.arange(page_size, device=dev)[None, None, :]
                 ).reshape(b, s)
    write_rows = (page_tables.gather(1, (positions // page_size)[:, None])[:, 0]
                  * page_size + positions % page_size)        # [B]
    # Position j of slot b is live iff j <= positions[b].
    live = torch.arange(s, device=dev)[None, :] <= positions[:, None]
    for li, lp in enumerate(model.layers):
        q, k, v = _qkv(x, lp, cfg)
        q = _apply_rope_rows(q[:, 0], angles)[:, None]        # [B,1,H,hd]
        k = _apply_rope_rows(k[:, 0], angles)                 # [B,kvH,hd]
        cache["k"][li].index_copy_(0, write_rows, k.to(cache["k"].dtype))
        cache["v"][li].index_copy_(0, write_rows,
                                   v[:, 0].to(cache["v"].dtype))
        kk = cache["k"][li][read_rows].to(dtype)              # [B,S,kvH,hd]
        vv = cache["v"][li][read_rows].to(dtype)
        attn = _cache_attention_dense(q, _repeat_kv(kk, cfg),
                                      _repeat_kv(vv, cfg),
                                      live[:, None, None, :])
        x = _finish_layer(x, attn, lp, cfg)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    logits = torch.einsum("btd,dv->btv", x, model.lm_head.to(dtype))
    return logits[:, 0].float(), cache
