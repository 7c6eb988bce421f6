"""Port parity: the contiguous-cache half of ``models/generate.py``
(``init_cache``, ``_quantize_rows``, the blocked and dense reads,
``forward_with_cache``, ``generate``) against the JAX package's on bridged
weights.

Both configurations of ``test_torch_generate``: the dense
``LlamaConfig.tiny()`` (4 heads over 2 kv heads, f32) and the grouped MoE
config, whose Pallas kernels JAX runs under ``interpret=True`` while the
port takes their plain versions on the CPU.  Parameters are one numpy
init handed to both packages.  Tolerances, absolute, f32 throughout (the
packages sum in different orders): prefill logits 1e-4 and cache rows
1e-5; each decode step's logits 2e-4; the blocked read against the
reference's 1e-5.  int8 rows: equal but for one quantisation step on at
most 0.1% of the entries (k differs from JAX's by ~1e-7, so a value at a
rounding edge may land one step apart); scales within 1e-6 relative.
Sampled decoding is held for determinism only: JAX's PRNG draws cannot be
matched.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_generate import CONFIGS, bridged

from kubeflow_controller_tpu.models.generate import _cache_attention_blocked as jax_blocked_read
from kubeflow_controller_tpu.models.generate import _cache_attention_dense as jax_dense_read
from kubeflow_controller_tpu.models.generate import _quantize_rows as jax_quantize_rows
from kubeflow_controller_tpu.models.generate import forward_with_cache as jax_forward_with_cache
from kubeflow_controller_tpu.models.generate import generate as jax_generate
from kubeflow_controller_tpu.models.generate import init_cache as jax_init_cache
from kubeflow_controller_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from kubeflow_controller_tpu.parallel.sharding import DEFAULT_RULES as JAX_RULES
from kubeflow_controller_tpu_torch import bridge
from kubeflow_controller_tpu_torch.models.llama import llama_forward

# The module by its name: the package exports the function ``generate``.
tgen = importlib.import_module("kubeflow_controller_tpu_torch.models.generate")

torch.set_num_threads(2)

PREFILL_ATOL = 1e-4
STEP_ATOL = 2e-4
CACHE_ATOL = 1e-5
READ_ATOL = 1e-5
SCALE_RTOL = 1e-6
INT8_STEP_SHARE = 1e-3      # entries one int8 step apart, at most

S, BLOCK, PREFIX, STEPS = 16, 4, 6, 5
# Batch 4 keeps B·T·top_k a multiple of 8 at every T, so the reference
# never leaves "grouped" for its capacity-dropping einsum below the TPU's
# sublane grain (the port stays grouped on the CPU at any shape).
B = 4
READS = {"dense": None, "blocked": BLOCK}     # kv_block; S 16 < 256: dense

_jax_fwc = jax.jit(jax_forward_with_cache, static_argnames=("cfg", "kv_block"))
_jax_gen = jax.jit(jax_generate, static_argnames=(
    "cfg", "max_new_tokens", "temperature", "top_k", "kv_block", "kv_quant"))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def setup(request):
    return bridged(CONFIGS[request.param])


def tokens(seed, b, t, vocab):
    return np.random.default_rng(seed).integers(1, vocab, (b, t)).astype(
        np.int32)


def as_np(cache):
    return {k: np.asarray(v) for k, v in cache.items()}


def assert_int8_close(got, want, name):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, (name, diff.max())
    assert np.mean(diff > 0) <= INT8_STEP_SHARE, (name, np.mean(diff > 0))


def assert_cache_close(got, want):
    """Port cache (tensors) against JAX's (numpy): plain rows within
    ``CACHE_ATOL``; int8 rows as stated, scales within ``SCALE_RTOL``."""
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if g.dtype == np.int8:
            assert_int8_close(g, w, key)
        elif key.endswith("_scale"):
            np.testing.assert_allclose(g, w, rtol=SCALE_RTOL, atol=0)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=CACHE_ATOL)


@pytest.mark.parametrize("quantize", [False, True], ids=["plain", "int8"])
def test_init_cache_shapes_and_dtypes_match_jax(setup, quantize):
    jcfg, tcfg, _, _ = setup
    want = jax_init_cache(jcfg, 2, S, quantize=quantize)
    got = tgen.init_cache(tcfg, 2, S, quantize=quantize, device="cpu")
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype), key
        assert not got[key].any(), key


def test_quantize_rows_matches_jax():
    rng = np.random.default_rng(0)
    rows = (rng.standard_normal((3, 64, 16))
            * rng.uniform(1e-3, 2.0, (3, 64, 1))).astype(np.float32)
    # Exact ties (scale 1): half to even on both sides, and a zero row.
    rows[0, 0] = [127, 0.5, 1.5, 2.5, -2.5, -0.5, 3.5, 126.5] + [0] * 8
    rows[0, 1] = 0
    wq, ws = (np.asarray(a) for a in jax_quantize_rows(jnp.asarray(rows)))
    gq, gs = tgen._quantize_rows(torch.from_numpy(rows))
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_allclose(gs.numpy(), ws, rtol=SCALE_RTOL, atol=0)
    assert_int8_close(gq.numpy(), wq, "rows")
    np.testing.assert_array_equal(gq.numpy()[0, :2], wq[0, :2])
    assert list(gq.numpy()[0, 0, :8]) == [127, 0, 2, 2, -2, 0, 4, 126]


# (start_pos, T): a prefill over two blocks, a step mid-block, a step on a
# block's first position, a step filling the last block.
READ_CASES = [(0, 6), (5, 1), (8, 1), (12, 4)]


def read_inputs(seed, start, t, quant):
    """q [2, T, 8, 16] (rep 2 over 4 kv heads), the full [2 layers, 2, S,
    4, 16] caches, and for int8 the caches' int8 rows and f32 scales."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, t, 8, 16)).astype(np.float32)
    shape = (2, 2, S, 4, 16)
    if not quant:
        return q, [rng.standard_normal(shape).astype(np.float32)
                   for _ in range(2)]
    return q, [rng.integers(-127, 128, shape).astype(np.int8),
               rng.integers(-127, 128, shape).astype(np.int8),
               rng.uniform(1e-3, 1e-2, shape[:-1]).astype(np.float32),
               rng.uniform(1e-3, 1e-2, shape[:-1]).astype(np.float32)]


@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("start,t", READ_CASES,
                         ids=[f"start{s}-t{t}" for s, t in READ_CASES])
def test_blocked_read_matches_jax_blocked_read(quant, start, t):
    q, caches = read_inputs(start + 10 * t, start, t, quant)
    k, v, *scales = caches
    want = np.asarray(jax_blocked_read(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1, start, BLOCK,
        JAX_RULES, *(jnp.asarray(s) for s in scales)))
    got = tgen._cache_attention_blocked(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 1,
        start, BLOCK, *(torch.from_numpy(s) for s in scales))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=READ_ATOL)


@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("start,t", [(0, 6), (3, 6), (12, 4)],
                         ids=["start0-t6", "start3-t6", "start12-t4"])
def test_blocked_read_in_query_chunks_matches_jax_blocked_read(
        monkeypatch, quant, start, t):
    """A budget of 2 query positions' scores: the prefill's rows go in
    ceil(T / 2) chunks, each over the blocks its last query sees (one,
    two, ... of them from start 0), and the result is the reference's."""
    spans = []
    real = tgen._blocked_rows

    def chunk(qg, kb, *args):
        spans.append((qg.shape[2], kb.shape[2]))
        return real(qg, kb, *args)

    monkeypatch.setattr(tgen, "_blocked_rows", chunk)
    span = -(-(start + t) // BLOCK) * BLOCK
    # 2 query positions' f32 scores: 2 × B·H·span.
    monkeypatch.setattr(tgen, "SCORE_CHUNK_BYTES", 2 * 2 * 8 * span * 4)
    q, caches = read_inputs(start + 10 * t, start, t, quant)
    k, v, *scales = caches
    want = np.asarray(jax_blocked_read(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1, start, BLOCK,
        JAX_RULES, *(jnp.asarray(s) for s in scales)))
    got = tgen._cache_attention_blocked(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 1,
        start, BLOCK, *(torch.from_numpy(s) for s in scales))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=READ_ATOL)
    # Rows (rep 2 a position) and the blocks each chunk's last query sees.
    assert spans == [(2 * (min(t, i + 2) - i),
                      -(-(start + min(t, i + 2)) // BLOCK) * BLOCK)
                     for i in range(0, t, 2)]


@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
def test_blocked_read_touches_only_the_visible_blocks(quant):
    """Blocks past ceil((start + T) / block) hold NaN: the blocked read
    never sees them; the dense read of the same cache does (the control)."""
    start, t = 5, 1                       # visible: blocks 0-1 (span 8)
    q, caches = read_inputs(3, start, t, quant)
    k, v = (torch.from_numpy(c).float() for c in caches[:2])
    k[:, :, 8:], v[:, :, 8:] = float("nan"), float("nan")
    scales = [torch.from_numpy(s) for s in caches[2:]]
    got = tgen._cache_attention_blocked(torch.from_numpy(q), k, v, 1, start,
                                        BLOCK, *scales)
    assert torch.isfinite(got).all()
    mask = tgen._visible(start, t, S, "cpu")[None, None]
    dense = tgen._cache_attention_dense(
        torch.from_numpy(q), k[1].repeat_interleave(2, dim=2),
        v[1].repeat_interleave(2, dim=2), mask)
    assert torch.isnan(dense).any()
    # And it equals the reference's blocked read of the unpoisoned cache.
    want = np.asarray(jax_blocked_read(
        jnp.asarray(q), *(jnp.asarray(c) for c in caches[:2]), 1, start,
        BLOCK, JAX_RULES, *(jnp.asarray(c) for c in caches[2:])))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=READ_ATOL)


@pytest.mark.parametrize("read", sorted(READS))
def test_prefill_matches_jax(setup, read):
    jcfg, tcfg, params, model = setup
    toks = tokens(1, B, PREFIX, jcfg.vocab_size)
    want, wcache = _jax_fwc(params, jnp.asarray(toks),
                            jax_init_cache(jcfg, B, S), 0, cfg=jcfg,
                            kv_block=READS[read])
    cache = tgen.init_cache(tcfg, B, S, device="cpu")
    got, same = tgen.forward_with_cache(model, torch.from_numpy(toks), cache,
                                        0, tcfg, kv_block=READS[read])
    assert same is cache                  # updated in place
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (B, PREFIX, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=PREFILL_ATOL)
    assert_cache_close(cache, as_np(wcache))
    assert not cache["k"][:, :, PREFIX:].any()    # nothing past the tokens


@pytest.mark.parametrize("read", sorted(READS))
@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
def test_incremental_decode_matches_jax(setup, quant, read):
    """From one JAX prefill (bridged with ``cache_from_jax``), one token at
    a time through both packages: every step's logits and cache."""
    jcfg, tcfg, params, model = setup
    toks = tokens(2, B, PREFIX + STEPS, jcfg.vocab_size)
    kv_block = READS[read]
    _, jcache = _jax_fwc(params, jnp.asarray(toks[:, :PREFIX]),
                         jax_init_cache(jcfg, B, S, quantize=quant), 0,
                         cfg=jcfg, kv_block=kv_block)
    cache = bridge.cache_from_jax(as_np(jcache), "cpu")
    for pos in range(PREFIX, PREFIX + STEPS):
        step = toks[:, pos:pos + 1]
        want, jcache = _jax_fwc(params, jnp.asarray(step), jcache, pos,
                                cfg=jcfg, kv_block=kv_block)
        got, _ = tgen.forward_with_cache(model, torch.from_numpy(step), cache,
                                         pos, tcfg, kv_block=kv_block)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=STEP_ATOL, err_msg=f"position {pos}")
        assert_cache_close(cache, as_np(jcache))


GENERATE_CASES = [(None, False), (BLOCK, False), (None, True), (BLOCK, True)]


@pytest.mark.parametrize("kv_block,kv_quant", GENERATE_CASES,
                         ids=["default", "block4", "default-int8",
                              "block4-int8"])
def test_greedy_generate_matches_jax(setup, kv_block, kv_quant):
    jcfg, tcfg, params, model = setup
    prompt = tokens(3, B, 5, jcfg.vocab_size)
    want = np.asarray(_jax_gen(params, jnp.asarray(prompt), cfg=jcfg,
                               max_new_tokens=6, kv_block=kv_block,
                               kv_quant=kv_quant))
    got = tgen.generate(model, torch.from_numpy(prompt), tcfg,
                        max_new_tokens=6, kv_block=kv_block,
                        kv_quant=kv_quant)
    assert got.dtype == torch.int64 and tuple(got.shape) == (B, 11)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_generate_equals_the_forward_argmax_loop(setup):
    """The port against itself: ``llama_forward`` over the growing
    sequence, argmax at the last position."""
    jcfg, tcfg, _, model = setup
    prompt = torch.from_numpy(tokens(4, B, 5, jcfg.vocab_size)).long()
    got = tgen.generate(model, prompt, tcfg, max_new_tokens=6)
    cur = prompt
    for _ in range(6):
        nxt = llama_forward(model, cur, tcfg)[:, -1].argmax(dim=-1)
        cur = torch.cat([cur, nxt[:, None]], dim=1)
    torch.testing.assert_close(got, cur, rtol=0, atol=0)


def test_sampled_generate_shape_and_determinism(setup):
    jcfg, tcfg, _, model = setup
    prompt = torch.zeros((2, 3), dtype=torch.long)

    def sampled(seed):
        return tgen.generate(model, prompt, tcfg, max_new_tokens=4,
                             temperature=0.8, top_k=20,
                             generator=torch.Generator().manual_seed(seed))

    a, b = sampled(7), sampled(7)
    assert tuple(a.shape) == (2, 7)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ((a >= 0) & (a < jcfg.vocab_size)).all()
    torch.testing.assert_close(a[:, :3], prompt, rtol=0, atol=0)


def test_sample_keeps_ties_at_the_top_k_threshold():
    """The reference's rule: ``logits < thresh`` leaves the vocabulary, so
    every entry equal to the k-th largest stays."""
    logits = torch.tensor([[5.0, 3.0, 3.0, 3.0, -1.0, -2.0]])
    seen = set()
    gen = torch.Generator().manual_seed(0)
    for _ in range(400):
        seen.add(int(tgen._sample(logits, 4.0, 2, gen)))
    assert seen == {0, 1, 2, 3}
    assert int(tgen._sample(logits, 0.0, 2, None)) == 0


def test_generate_with_no_new_tokens_returns_the_prompt(setup):
    _, tcfg, _, model = setup
    prompt = torch.ones((1, 4), dtype=torch.long)
    assert tgen.generate(model, prompt, tcfg, max_new_tokens=0) is prompt


def test_forward_with_cache_refuses_positions_past_the_cache(setup):
    _, tcfg, _, model = setup
    cache = tgen.init_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="fit"):
        tgen.forward_with_cache(model, torch.ones((1, 3), dtype=torch.long),
                                cache, 6, tcfg)


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
def test_cache_from_jax_keeps_keys_dtypes_and_values(quantize):
    jcfg = JaxLlamaConfig.tiny(dtype="bfloat16")
    rng = np.random.default_rng(5)
    cache = {k: np.asarray(v) for k, v in
             jax_init_cache(jcfg, 2, 8, quantize=quantize).items()}
    for key, arr in cache.items():
        if arr.dtype == np.int8:
            cache[key] = rng.integers(-127, 128, arr.shape).astype(np.int8)
        else:
            cache[key] = np.asarray(jnp.asarray(
                rng.standard_normal(arr.shape), arr.dtype))
    got = bridge.cache_from_jax(cache, "cpu")
    assert sorted(got) == sorted(cache)
    for key, arr in cache.items():
        want = torch.from_numpy(arr.astype(np.float32))
        assert str(got[key].dtype).split(".")[-1] == arr.dtype.name, key
        torch.testing.assert_close(got[key].float(), want.float(), rtol=0,
                                   atol=0)
    with pytest.raises(KeyError):
        bridge.cache_from_jax({"k": cache["k"]}, "cpu")
