"""KV-cache decoding for the Llama decoder — the port of
``kubeflow_controller_tpu/models/generate.py``: the contiguous cache of
batch decoding (``init_cache``, ``forward_with_cache``, ``generate``) and
the slot-paged cache of the serving plane.

Contiguous cache: ``[L, B, S, kvH, D]``, every sequence of the batch at one
``start_pos``; K is written pre-rotated.  Two reads:

- blocked, length-masked (when S is a multiple of the block and spans
  more than one): only the ceil((start_pos + T) / block) blocks covering
  the written prefix are read; each block's scores are normalised by its
  own max and the blocks are merged by their maxima, the reference's
  online softmax over blocks.  ``start_pos`` is a Python int here, so the
  trip count is known on the host and the visible blocks of a call are
  folded into one set of launches (no per-block loop); a prefill's query
  positions go in chunks of at most ``SCORE_CHUNK_BYTES`` of scores;
- dense: the full-S masked read (S not a block multiple, or one block).

``kv_quant`` stores K and V as int8 with one f32 scale per (position, kv
head) row, half the bf16 cache's bytes; the scales fold into the scores
per key column and into the weights per value row.  What it costs in
logits on the card: PERF.md (``chip_smoke.py`` phase 19b).

Sharded decode (``mesh=``, the reference's dp/tp decode): the model is
built by ``llama_init(mesh=)`` or ``shard_llama``, the tokens are staged
by the batch over dp and fsdp, q/k/v by the heads over tp, and the cache
is a dict of DTensors placed by :func:`cache_placements` (batch over dp
and fsdp, kv heads over tp, S unsharded).  Each shard writes and reads
its own cache rows inside ``local_map``; the output projection's and
``lm_head``'s partial sums over tp meet as in training.  sp is not a
decode axis: activations and cache are replicated over it.

Slot-paged cache: one physical row pool ``[L, R, kvH, D]`` (R = num_pages
* page_size) is shared by every slot; a host-side page table per slot
maps logical position j of slot b to physical row ``page_table[b, j //
page] * page + j % page``.  Physical page 0 is a scratch page:
bucket-padded prefill positions past the real prompt length write there,
so padding never corrupts another slot's rows.

Differences from the reference that change no value:

- the layer ``lax.scan`` is a Python loop over ``model.layers``, and
  ``generate``'s token scan a Python loop;
- every cache is updated IN PLACE (slice assignment / ``index_copy_``) and
  the same dict is returned, where JAX returns a new functional cache;
- functions take the parameter module (``models.llama.Llama``) where the
  reference takes the pytree.

Sampled decoding draws from a ``torch.Generator``: JAX's PRNG draws cannot
be matched, so it agrees with the reference in rule (temperature, top-k
with ties at the threshold kept, Gumbel-max), not in tokens.  Under a mesh
every process samples the whole batch from its copy of the generator, so
the tokens are those of the run without a mesh.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device, torch_dtype
from ..parallel.sharding import (
    DEFAULT_RULES,
    ShardingRules,
    placements_for,
    with_logical_constraint,
)
from .llama import (
    KV_AXES,
    QKV_AXES,
    Llama,
    LlamaConfig,
    _embed,
    _mm,
    _post_attention,
    _pre_attention,
    _repeat_kv,
    _w,
    apply_rope,
    model_mesh,
    one_card_only,
    rmsnorm,
    rope_tables,
    stage_tokens,
)

Cache = Dict[str, torch.Tensor]
NEG_INF = -1e30

# Logical layout of the contiguous cache; the seq dim stays unsharded
# (decode appends at a moving position).
CACHE_AXES = ("layers", "batch", None, "kv_heads", "head_dim")

# The blocked read's block: a step reads ceil(written / block) blocks, not
# the whole static S.
DECODE_KV_BLOCK = 256

# The [B, T, D] activations' layout; "seq" is replicated in decode
# (:func:`_decode_rules`).
_ACT = ("batch", "seq", None)


def _decode_rules(rules: ShardingRules = DEFAULT_RULES) -> ShardingRules:
    """``rules`` with ``"seq"`` replicated: decode shards no sequence dim,
    so an sp axis splits nothing (the reference's decode constraints name
    none)."""
    return ShardingRules(tuple((name, None if name == "seq" else axes)
                               for name, axes in rules.rules))


def cache_placements(mesh, quantize: bool = False,
                     rules: ShardingRules = DEFAULT_RULES) -> Dict[str, List]:
    """DTensor placements of each cache key on ``mesh``'s model mesh
    (``models.llama.model_mesh``): ``CACHE_AXES`` through ``rules`` (batch
    over dp and fsdp, kv heads over tp), the scales without head_dim.  The
    counterpart of the reference's ``cache_pspecs``."""
    sub = model_mesh(mesh)
    spec = placements_for(CACHE_AXES, sub, rules)
    out = {"k": spec, "v": spec}
    if quantize:
        sspec = placements_for(CACHE_AXES[:-1], sub, rules)
        out.update({"k_scale": sspec, "v_scale": sspec})
    return out


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               quantize: bool = False, device: DeviceLike = "cuda",
               mesh=None, rules: ShardingRules = DEFAULT_RULES) -> Cache:
    """The zeroed contiguous cache: ``k``/``v`` ``[L, B, S, kvH, D]`` in
    ``cfg.dtype``, or with ``quantize`` int8 with f32 ``k_scale``/
    ``v_scale`` ``[L, B, S, kvH]``.  With ``mesh``, DTensors placed by
    :func:`cache_placements`, each process allocating its shard only.
    Serving takes the "llama" block only (``llama.one_card_only``)."""
    one_card_only(cfg, "serving and generation")
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if quantize:
        specs = {"k": (shape, torch.int8), "v": (shape, torch.int8),
                 "k_scale": (shape[:-1], torch.float32),
                 "v_scale": (shape[:-1], torch.float32)}
    else:
        dtype = torch_dtype(cfg.dtype)
        specs = {"k": (shape, dtype), "v": (shape, dtype)}
    if mesh is None:
        return {key: torch.zeros(s, dtype=dt, device=dev)
                for key, (s, dt) in specs.items()}
    from torch.distributed.tensor import DTensor, Shard

    sub = model_mesh(mesh)
    placed = cache_placements(mesh, quantize, rules)
    out = {}
    for key, (s, dt) in specs.items():
        local = list(s)
        for i, pl in enumerate(placed[key]):
            if isinstance(pl, Shard):
                n = sub.size(i)
                if local[pl.dim] % n:
                    raise ValueError(
                        f"cache {key} dim {pl.dim} ({s[pl.dim]}) does not "
                        f"divide over mesh dim {sub.mesh_dim_names[i]} ({n})")
                local[pl.dim] //= n
        out[key] = DTensor.from_local(
            torch.zeros(local, dtype=dt, device=dev), sub, placed[key],
            run_check=False)
    return out


def _quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., D] -> (int8 [..., D], f32 scale [...]): symmetric per row,
    max-abs / 127; ``torch.round`` rounds half to even, as ``jnp.round``."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp_(-127, 127)
    return q.to(torch.int8), scale


def init_paged_cache(cfg: LlamaConfig, num_pages: int, page_size: int,
                     device: DeviceLike = "cuda") -> Cache:
    """The physical row pool shared by every slot (page 0 = scratch)."""
    one_card_only(cfg, "serving and generation")
    dev = resolve_device(device)
    shape = (cfg.n_layers, num_pages * page_size, cfg.n_kv_heads,
             cfg.head_dim)
    dtype = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _cache_attention_dense(q: torch.Tensor, kk: torch.Tensor,
                           vv: torch.Tensor, mask: torch.Tensor):
    """Full-S masked read.  q [B,T,H,D]; kk/vv [B,S,kvH,D], the kv heads
    repeated to q's (GQA).  Scores in f32 (the reference's
    preferred_element_type), V read in f32, output cast back to q's
    dtype."""
    kk, vv = _repeat_kv(q, kk, vv)
    d = q.shape[-1]
    s = torch.einsum("bthd,bshd->bhts", q.float(), kk.float()) * d ** -0.5
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, vv.float()).to(q.dtype)


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
    rope = rope_tables(cfg, positions)
    mask = (positions[None, :] <= positions[:, None])[None, None, :, :]
    for li, lp in enumerate(model.layers):
        q, k, v, gate = _pre_attention(x, lp, cfg, rope)  # k pre-rotated
        cache["k"][li].index_copy_(0, rows, k[0].to(cache["k"].dtype))
        cache["v"][li].index_copy_(0, rows, v[0].to(cache["v"].dtype))
        attn = _cache_attention_dense(q, k, v, mask)
        x, _ = _post_attention(x, attn, gate, lp, cfg)
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
    rope = rope_tables(cfg, q_pos)
    # Causal over LOGICAL positions: tail position start+j attends to
    # logical positions <= start+j (prefix + the tail up to itself).
    mask = (torch.arange(s, device=tokens.device)[None, :]
            <= q_pos[:, None])[None, None, :, :]
    for li, lp in enumerate(model.layers):
        q, k, v, gate = _pre_attention(x, lp, cfg, rope)
        cache["k"][li].index_copy_(0, write_rows, k[0].to(cache["k"].dtype))
        cache["v"][li].index_copy_(0, write_rows, v[0].to(cache["v"].dtype))
        kk = cache["k"][li][read_rows][None].to(dtype)      # [1,S,kvH,hd]
        vv = cache["v"][li][read_rows][None].to(dtype)
        attn = _cache_attention_dense(q, kk, vv, mask)
        x, _ = _post_attention(x, attn, gate, lp, cfg)
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
    rope = rope_tables(cfg, positions)                        # [B, hd] each
    # Gather map: logical position j of slot b -> physical row.
    read_rows = (page_tables[:, :, None] * page_size
                 + torch.arange(page_size, device=dev)[None, None, :]
                 ).reshape(b, s)
    write_rows = (page_tables.gather(1, (positions // page_size)[:, None])[:, 0]
                  * page_size + positions % page_size)        # [B]
    # Position j of slot b is live iff j <= positions[b].
    live = torch.arange(s, device=dev)[None, :] <= positions[:, None]
    for li, lp in enumerate(model.layers):
        q, k, v, gate = _pre_attention(x, lp, cfg, None)
        # Each slot at its own position: the batch is apply_rope's T axis.
        q = apply_rope(q.transpose(0, 1), *rope).transpose(0, 1)  # [B,1,H,hd]
        k = apply_rope(k.transpose(0, 1), *rope)[0]           # [B,kvH,hd]
        cache["k"][li].index_copy_(0, write_rows, k.to(cache["k"].dtype))
        cache["v"][li].index_copy_(0, write_rows,
                                   v[:, 0].to(cache["v"].dtype))
        kk = cache["k"][li][read_rows].to(dtype)              # [B,S,kvH,hd]
        vv = cache["v"][li][read_rows].to(dtype)
        attn = _cache_attention_dense(q, kk, vv, live[:, None, None, :])
        x, _ = _post_attention(x, attn, gate, lp, cfg)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    logits = torch.einsum("btd,dv->btv", x, model.lm_head.to(dtype))
    return logits[:, 0].float(), cache


# ---------------------------------------------------------------------------
# Contiguous cache: forward_with_cache and generate
# ---------------------------------------------------------------------------

def _visible(start_pos: int, t: int, span: int, device) -> torch.Tensor:
    """[T, span] bool: query ``start_pos + i`` sees key position j <= it."""
    q_pos = torch.arange(start_pos, start_pos + t, device=device)
    return torch.arange(span, device=device)[None, :] <= q_pos[:, None]


def _rows_visible(start_pos: int, t: int, span: int, rep: int,
                  device) -> torch.Tensor:
    """:func:`_visible` per score row of the blocked read: [T * rep, span],
    row (i, r) that of query i."""
    return _visible(start_pos, t, span, device).repeat_interleave(rep, 0)


# The most bytes of f32 scores the blocked read holds at once: a prefill
# takes its query positions in chunks under it, so a long prompt's scores
# stay bounded, as the reference's per-block loop keeps them; a decode
# step is one chunk.
SCORE_CHUNK_BYTES = 1 << 28


def _cache_attention_blocked(q: torch.Tensor, kc_all: torch.Tensor,
                             vc_all: torch.Tensor, layer: int,
                             start_pos: int, block: int,
                             k_scale_all: Optional[torch.Tensor] = None,
                             v_scale_all: Optional[torch.Tensor] = None, *,
                             live: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Length-masked read of layer ``layer`` of the full ``[L, B, S, kvH,
    D]`` caches: only the n = ceil((start_pos + T) / block) blocks covering
    the written prefix are read.  Each block's scores are normalised by the
    block's own max, as the reference's online softmax does block by block;
    its running rescale by exp(m_old - m_new) is taken here in one step,
    each block's weights times exp(m_block - m_all), so the n blocks cost
    one set of launches.  As in the reference, an all-masked row's phantom
    weights (NEG_INF is finite, so exp(s - m) is 1 there) are zeroed by
    re-applying the mask.  GQA groups the query heads per kv head (the
    rows of kv head g are its rep heads' queries, [B, kvH, T * rep, D]):
    the repeated cache never exists.

    The query positions go in chunks whose [B, kvH, rows, span] f32 scores
    fit ``SCORE_CHUNK_BYTES``, each chunk reading the blocks its last query
    sees.

    ``k_scale_all``/``v_scale_all`` ([L, B, S, kvH] f32): the cache is
    int8; the scales fold into the scores per key column and into the
    weights per value row.  ``live``: the [T * rep, n * block] row mask
    (:func:`_rows_visible`), when the caller has made it for every
    layer."""
    b, t, h, d = q.shape
    kvh = kc_all.shape[3]
    rep = h // kvh
    span = -(-(start_pos + t) // block) * block
    if live is None:
        live = _rows_visible(start_pos, t, span, rep, q.device)
    # Rows (t, r) of kv head g: [B, kvH, T*rep, D]; K and V read once
    # each into f32 [B, kvH, span, D], the layout both products take.
    qg = (q.float() * d ** -0.5).reshape(b, t, kvh, rep, d).permute(
        0, 2, 1, 3, 4).reshape(b, kvh, t * rep, d)
    kb, vb = (torch.empty((b, kvh, span, d), dtype=torch.float32,
                          device=q.device).copy_(
        c[layer, :, :span].permute(0, 2, 1, 3)) for c in (kc_all, vc_all))
    ks, vs = (None if c is None else c[layer, :, :span].transpose(1, 2)[
        :, :, None] for c in (k_scale_all, v_scale_all))   # [B, kvH, 1, span]
    step = max(1, SCORE_CHUNK_BYTES // (b * kvh * rep * span * 4))
    outs = []
    for i0 in range(0, t, step):
        i1 = min(t, i0 + step)
        n = -(-(start_pos + i1) // block)
        cols, rows = slice(0, n * block), slice(i0 * rep, i1 * rep)
        outs.append(_blocked_rows(
            qg[:, :, rows], kb[:, :, cols], vb[:, :, cols], live[rows, cols],
            n, block, None if ks is None else ks[..., cols],
            None if vs is None else vs[..., cols]))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    return out.reshape(b, kvh, t, rep, d).permute(0, 2, 1, 3, 4).reshape(
        b, t, h, d).to(q.dtype)


def _blocked_rows(qg, kb, vb, live, n, block, ks, vs) -> torch.Tensor:
    """One chunk of :func:`_cache_attention_blocked`: scores of the rows
    ``qg`` [B, kvH, rows, D] against the n blocks of ``kb``/``vb`` [B,
    kvH, n * block, D], each block normalised by its own max and merged by
    the maxima; the f32 output [B, kvH, rows, D]."""
    s = qg @ kb.transpose(-1, -2)                     # [B, kvH, rows, span]
    if ks is not None:
        s.mul_(ks)
    s.masked_fill_(~live, NEG_INF)
    sb = s.unflatten(-1, (n, block))                  # [..., n, block]
    m_b = sb.amax(dim=-1, keepdim=True)
    p = sb.sub_(m_b).exp_().mul_(live.unflatten(-1, (n, block)))
    p.mul_(torch.exp(m_b - m_b.amax(dim=-2, keepdim=True)))
    p = p.flatten(-2)
    denom = p.sum(dim=-1)
    if vs is not None:
        p.mul_(vs)
    return (p @ vb) / denom.clamp_min(1e-30)[..., None]


def _attend(q, k, v, kc, vc, ks=None, vs=None, *, layer: int,
            start_pos: int, rope: Tuple[torch.Tensor, torch.Tensor],
            block: int, mask: torch.Tensor) -> torch.Tensor:
    """One layer's cache write and read, on plain tensors (a shard's,
    under a mesh): RoPE on q and k (``rope``: ``rope_tables``), k and
    v (int8 rows and their scales when ``ks`` is given) written in place
    at [start_pos, start_pos + T), then the blocked read (``block`` > 0)
    or the dense one."""
    q = apply_rope(q, *rope)
    k = apply_rope(k, *rope)                  # written pre-rotated
    rows = slice(start_pos, start_pos + k.shape[1])
    if ks is None:
        kc[layer, :, rows] = k.to(kc.dtype)
        vc[layer, :, rows] = v.to(vc.dtype)
    else:
        kc[layer, :, rows], ks[layer, :, rows] = _quantize_rows(k)
        vc[layer, :, rows], vs[layer, :, rows] = _quantize_rows(v)
    if block:
        return _cache_attention_blocked(q, kc, vc, layer, start_pos, block,
                                        ks, vs, live=mask)
    kk, vv = kc[layer], vc[layer]
    if ks is None:
        kk, vv = kk.to(q.dtype), vv.to(q.dtype)
    else:
        kk = (kk.float() * ks[layer][..., None]).to(q.dtype)
        vv = (vv.float() * vs[layer][..., None]).to(q.dtype)
    return _cache_attention_dense(q, kk, vv, mask)


def _decode_table(model: Llama, cfg: LlamaConfig,
                  rules: ShardingRules) -> torch.Tensor:
    """The embedding table in the activation dtype; under a mesh gathered
    whole (the reference's replicated table), so the per-token lookup
    moves nothing.  ``generate`` makes it once per call."""
    return with_logical_constraint(_w(model.embed, torch_dtype(cfg.dtype)),
                                   (None, None), rules)


def _forward(model: Llama, table: torch.Tensor, tokens: torch.Tensor,
             cache: Cache, start_pos: int, cfg: LlamaConfig,
             kv_block: Optional[int], sub, rules: ShardingRules):
    """:func:`forward_with_cache` on a table made by :func:`_decode_table`
    and, under a mesh, on the model mesh ``sub`` and decode ``rules``."""
    dtype = torch_dtype(cfg.dtype)
    t = tokens.shape[1]
    s = cache["k"].shape[2]
    if start_pos < 0 or start_pos + t > s:
        raise ValueError(f"positions [{start_pos}, {start_pos + t}) do not "
                         f"fit the cache's {s}")
    block = kv_block or DECODE_KV_BLOCK
    blocked = s % block == 0 and s > block
    dev = table.device
    if blocked:
        mask = _rows_visible(start_pos, t,
                             -(-(start_pos + t) // block) * block,
                             cfg.n_heads // cfg.n_kv_heads, dev)
    else:
        mask = _visible(start_pos, t, s, dev)[None, None]
    keys = ("k", "v", "k_scale", "v_scale") if "k_scale" in cache else (
        "k", "v")
    kv = [cache[key] for key in keys]
    attend = partial(_attend, start_pos=start_pos,
                     rope=rope_tables(cfg, torch.arange(
                         start_pos, start_pos + t, device=dev)),
                     block=block if blocked else 0, mask=mask)
    if sub is None:
        x = table[tokens.long()]
    else:
        from torch.distributed.tensor.experimental import local_map

        x = with_logical_constraint(
            _embed(stage_tokens(tokens, sub, rules), table), _ACT, rules)
        qp = placements_for(QKV_AXES, sub, rules)
        kp = placements_for(KV_AXES, sub, rules)
        cp = [list(c.placements) for c in kv]
    for li, lp in enumerate(model.layers):
        q, k, v, gate = _pre_attention(x, lp, cfg, None)
        if sub is None:
            attn = attend(q, k, v, *kv, layer=li)
        else:
            # Per shard: each writes and reads its own batch rows and kv
            # heads, in place on its local cache.
            attn = local_map(partial(attend, layer=li), out_placements=qp,
                             in_placements=(qp, kp, kp, *cp),
                             device_mesh=sub)(
                with_logical_constraint(q, QKV_AXES, rules),
                with_logical_constraint(k, KV_AXES, rules),
                with_logical_constraint(v, KV_AXES, rules), *kv)
        x, _ = _post_attention(x, attn, gate, lp, cfg, rules, sub)
    x = rmsnorm(x, _w(model.final_norm, dtype), cfg.norm_eps)
    logits = _mm(x, _w(model.lm_head, dtype))
    logits = with_logical_constraint(logits, ("batch", "seq", "vocab"), rules)
    return logits.float(), cache


@torch.no_grad()
def forward_with_cache(model: Llama, tokens: torch.Tensor, cache: Cache,
                       start_pos: int, cfg: LlamaConfig,
                       kv_block: Optional[int] = None, mesh=None,
                       rules: ShardingRules = DEFAULT_RULES
                       ) -> Tuple[torch.Tensor, Cache]:
    """tokens [B, T] appended at absolute position ``start_pos`` (a Python
    int).  Returns (logits [B, T, vocab] f32, the cache, updated in place).

    ``kv_block``: the read's block (default ``DECODE_KV_BLOCK``).  When it
    divides the cache length S and S spans more than one block, attention
    reads only the blocks covering [0, start_pos + T); otherwise the dense
    full-S masked read runs.  An int8 cache (``init_cache(quantize=True)``)
    is written as int8 rows and scales.

    With ``mesh`` (a ``build_mesh`` mesh; ``model`` sharded on it, the cache
    made by ``init_cache(mesh=)``) the tokens are staged by
    ``stage_tokens`` and the logits come back as a DTensor, vocab sharded
    over tp."""
    rules = _decode_rules(rules)
    sub = None if mesh is None else model_mesh(mesh)
    return _forward(model, _decode_table(model, cfg, rules), tokens, cache,
                    int(start_pos), cfg, kv_block, sub, rules)


def _sample(logits: torch.Tensor, temperature: float, top_k: Optional[int],
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """[..., vocab] -> token ids: the argmax when ``temperature`` is 0, else
    a Gumbel-max draw from ``generator`` over ``logits / temperature``,
    below the top-k threshold set to NEG_INF (ties at it stay)."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k is not None:
        thresh = torch.sort(logits, dim=-1).values[..., -top_k, None]
        logits = logits.masked_fill(logits < thresh, NEG_INF)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u.clamp_(min=torch.finfo(u.dtype).tiny)
    return (logits - torch.log(-torch.log(u))).argmax(dim=-1)


def _next_tokens(logits: torch.Tensor, temperature: float,
                 top_k: Optional[int], generator, sub,
                 rules: ShardingRules) -> torch.Tensor:
    """The last position's sample, [B].  Under a mesh the whole [B, vocab]
    is gathered first and every process samples all of it from its copy of
    ``generator``: each row draws its own noise, as without a mesh, and
    every process holds the same tokens."""
    last = logits[:, -1]
    if sub is not None:
        last = with_logical_constraint(last, (None, None), rules).to_local()
    return _sample(last, temperature, top_k, generator)


@torch.no_grad()
def generate(model: Llama, prompt: torch.Tensor, cfg: LlamaConfig, *,
             max_new_tokens: int, temperature: float = 0.0,
             top_k: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             kv_block: Optional[int] = None, kv_quant: bool = False,
             mesh=None, rules: ShardingRules = DEFAULT_RULES
             ) -> torch.Tensor:
    """prompt [B, T_p] -> [B, T_p + max_new_tokens] int64 on the model's
    device.  Greedy when ``temperature`` is 0; else sampled (top-k when
    ``top_k``) from ``generator`` (a ``torch.Generator`` on the model's
    device; seed 0 when None).  The reference's steps: the cache length
    T_p + max_new_tokens, rounded up to a block multiple once it exceeds a
    block (so the blocked read runs); the first token sampled from the
    prefill; then max_new_tokens - 1 steps, each forward feeding the next
    sample.  The embedding table is cast (and under a mesh gathered) once,
    outside the token loop.

    ``kv_quant``: the int8 cache (half the bf16 cache's bytes); its logit
    error on the card is in PERF.md (``chip_smoke.py`` phase 19b).  With
    ``mesh`` the model is sharded on it (``llama_init(mesh=)``,
    ``shard_llama``), the cache is placed by :func:`cache_placements`, and
    the tokens returned are the whole batch, equal on every process."""
    if max_new_tokens <= 0:
        return prompt
    dev = model.embed.device
    b, t_p = prompt.shape
    max_len = t_p + max_new_tokens
    block = kv_block or DECODE_KV_BLOCK
    if max_len > block:
        max_len = -(-max_len // block) * block
    rules = _decode_rules(rules)
    sub = None if mesh is None else model_mesh(mesh)
    cache = init_cache(cfg, b, max_len, kv_quant, dev, mesh, rules)
    table = _decode_table(model, cfg, rules)
    if temperature != 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    prompt = prompt.to(dev).long()
    step = partial(_forward, model, table, cfg=cfg, kv_block=kv_block,
                   sub=sub, rules=rules)
    sample = partial(_next_tokens, temperature=temperature, top_k=top_k,
                     generator=generator, sub=sub, rules=rules)
    logits, cache = step(prompt, cache, 0)
    out = [sample(logits)]
    for pos in range(t_p, t_p + max_new_tokens - 1):
        logits, cache = step(out[-1][:, None], cache, pos)
        out.append(sample(logits))
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
