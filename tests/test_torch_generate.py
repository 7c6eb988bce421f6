"""Port parity: ``kubeflow_controller_tpu_torch.models.generate`` (the paged
KV cache of the serving replica) against the JAX package's
``models/generate.py`` on bridged weights.

One scenario per configuration, run once through each package:

1. ``paged_prefill`` of two prompts into their slots' pages (bucket
   padding goes to scratch page 0);
2. ``copy_cache_rows`` of one page into a fresh page (copy-on-write);
3. ``paged_extend`` of a third prompt's tail over the copied prefix page;
4. ``paged_decode_step`` over all four slots (one idle).

The MoE configuration is the one ``__graft_entry__.py`` drives through the
grouped Pallas kernels (JAX runs them under ``interpret=True``); the dense
one is ``LlamaConfig.tiny()``.  Tolerances: logits within 1e-4 absolute,
cache rows within 1e-5 absolute (f32 throughout; the packages sum in
different orders, nothing else differs).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.models.generate import copy_cache_rows as jax_copy_cache_rows
from kubeflow_controller_tpu.models.generate import init_paged_cache as jax_init_paged_cache
from kubeflow_controller_tpu.models.generate import paged_decode_step as jax_paged_decode_step
from kubeflow_controller_tpu.models.generate import paged_extend as jax_paged_extend
from kubeflow_controller_tpu.models.generate import paged_prefill as jax_paged_prefill
from kubeflow_controller_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from kubeflow_controller_tpu_torch import bridge
from kubeflow_controller_tpu_torch.models.llama import LlamaConfig

# The module by its name: the package exports the function ``generate``.
tgen = importlib.import_module("kubeflow_controller_tpu_torch.models.generate")

torch.set_num_threads(2)

LOGITS_ATOL = 1e-4
CACHE_ATOL = 1e-5

MOE = dict(vocab_size=512, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
           intermediate=256, n_experts=4, moe_top_k=2,
           moe_dispatch="grouped")
CONFIGS = {"moe": MOE, "dense": {}}

PAGE = 8
SLOTS = 4
PAGES_PER_SLOT = 4
NUM_PAGES = 1 + SLOTS * PAGES_PER_SLOT


def numpy_params(cfg, seed=0):
    """The JAX ``llama_init`` pytree (stacked ``[L, ...]`` layers, f32),
    drawn with numpy: scaled normal, norms at one."""
    rng = np.random.default_rng(seed)
    n, d, f, e = cfg.n_layers, cfg.dim, cfg.intermediate, cfg.n_experts
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    resid = 0.02 / (2 * n) ** 0.5

    def norm(shape, scale=0.02):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    if e:
        ffn = {"router": norm((n, d, e)), "w_gate": norm((n, e, d, f)),
               "w_up": norm((n, e, d, f)), "w_down": norm((n, e, f, d), resid)}
    else:
        ffn = {"w_gate": norm((n, d, f)), "w_up": norm((n, d, f)),
               "w_down": norm((n, f, d), resid)}
    ones = np.ones((n, d), np.float32)
    return {
        "embed": norm((cfg.vocab_size, d)),
        "layers": {"attn_norm": ones, "wq": norm((n, d, nh, hd)),
                   "wk": norm((n, d, nkv, hd)), "wv": norm((n, d, nkv, hd)),
                   "wo": norm((n, nh, hd, d), resid), "mlp_norm": ones.copy(),
                   **ffn},
        "final_norm": np.ones((d,), np.float32),
        "lm_head": norm((d, cfg.vocab_size)),
    }


def bridged(overrides):
    """(jax cfg, torch cfg, jax params, port model): one numpy init handed
    to both packages."""
    jcfg = JaxLlamaConfig.tiny(**overrides)
    tcfg = LlamaConfig.tiny(**overrides)
    params = numpy_params(jcfg)
    model = bridge.llama_from_jax(params, tcfg, device="cpu")
    return jcfg, tcfg, jax.tree.map(jnp.asarray, params), model


def rows_for(pages, start, n, bucket):
    """Physical rows of logical positions start..start+n-1 through the
    slot's page list, padded with scratch row 0 up to ``bucket``."""
    rows = np.zeros(bucket, np.int32)
    for j in range(n):
        pos = start + j
        rows[j] = pages[pos // PAGE] * PAGE + pos % PAGE
    return rows


def scenario(step):
    """Drive the four stages through ``step`` (one package's adapter) and
    return {stage: (logits, cache k, cache v)} as numpy."""
    rng = np.random.default_rng(3)
    tables = np.zeros((SLOTS, PAGES_PER_SLOT), np.int32)
    tables[0, :2] = [1, 2]
    tables[1, :1] = [3]
    tables[2, :2] = [4, 5]
    out = {}
    # 1. two prompts, 11 tokens in bucket 16 and 5 tokens in bucket 8.
    p0 = rng.integers(1, 256, 11)
    p1 = rng.integers(1, 256, 5)
    for name, slot, prompt, bucket in (("prefill0", 0, p0, 16),
                                       ("prefill1", 1, p1, 8)):
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :len(prompt)] = prompt
        out[name] = step("prefill", toks,
                         rows_for(tables[slot], 0, len(prompt), bucket),
                         len(prompt))
    # 2. copy-on-write: slot 2 starts from slot 0's first page.
    out["copy"] = step("copy", rows_for([1], 0, PAGE, PAGE),
                       rows_for([4], 0, PAGE, PAGE))
    # 3. slot 2's prompt shares p0's first 8 tokens; extend its 6-token
    #    tail (bucket 8) over the copied page.
    tail = rng.integers(1, 256, 6)
    toks = np.zeros((1, 8), np.int32)
    toks[0, :6] = tail
    read_rows = np.concatenate([pg * PAGE + np.arange(PAGE)
                                for pg in tables[2]]).astype(np.int32)
    out["extend"] = step("extend", toks, rows_for(tables[2], PAGE, 6, 8),
                         read_rows, PAGE, 6)
    # 4. one decode step: slots 0-2 append at their next position, slot 3
    #    is idle (token 0 at position 0 on scratch page 0).
    tokens = np.array(list(rng.integers(1, 256, 3)) + [0], np.int32)
    positions = np.array([11, 5, 14, 0], np.int32)
    out["decode"] = step("decode", tokens, positions, tables)
    return out


_prefill = jax.jit(jax_paged_prefill, static_argnums=(5,))
_extend = jax.jit(jax_paged_extend, static_argnums=(7,))
_decode = jax.jit(jax_paged_decode_step, static_argnums=(5, 6))
_copy = jax.jit(jax_copy_cache_rows)


def jax_step(jcfg, params):
    cache = jax_init_paged_cache(jcfg, NUM_PAGES, PAGE)

    def step(kind, *args):
        nonlocal cache
        a = [jnp.asarray(x) if isinstance(x, np.ndarray) else x
             for x in args]
        logits = None
        if kind == "prefill":
            logits, cache = _prefill(params, a[0], cache, a[1], a[2], jcfg)
        elif kind == "copy":
            cache = _copy(cache, a[0], a[1])
        elif kind == "extend":
            logits, cache = _extend(params, a[0], cache, a[1], a[2], a[3],
                                    a[4], jcfg)
        else:
            logits, cache = _decode(params, a[0], cache, a[1], a[2], jcfg,
                                    PAGE)
        return (None if logits is None else np.asarray(logits),
                np.asarray(cache["k"]), np.asarray(cache["v"]))

    return step


def torch_step(tcfg, model):
    cache = tgen.init_paged_cache(tcfg, NUM_PAGES, PAGE, device="cpu")

    def step(kind, *args):
        a = [torch.from_numpy(x).long() if isinstance(x, np.ndarray) else x
             for x in args]
        logits = None
        if kind == "prefill":
            logits, _ = tgen.paged_prefill(model, a[0], cache, a[1], a[2],
                                           tcfg)
        elif kind == "copy":
            tgen.copy_cache_rows(cache, a[0], a[1])
        elif kind == "extend":
            logits, _ = tgen.paged_extend(model, a[0], cache, a[1], a[2],
                                          a[3], a[4], tcfg)
        else:
            logits, _ = tgen.paged_decode_step(model, a[0], cache, a[1],
                                               a[2], tcfg, PAGE)
        # The port updates the pool in place: snapshot it per stage.
        return (None if logits is None else logits.numpy().copy(),
                cache["k"].numpy().copy(), cache["v"].numpy().copy())

    return step


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def runs(request):
    jcfg, tcfg, params, model = bridged(CONFIGS[request.param])
    return (scenario(jax_step(jcfg, params)),
            scenario(torch_step(tcfg, model)))


def assert_stage(runs, stage):
    want, got = runs[0][stage], runs[1][stage]
    if want[0] is not None:
        assert got[0].shape == want[0].shape
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=LOGITS_ATOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=CACHE_ATOL)


def test_paged_prefill_matches_jax(runs):
    assert_stage(runs, "prefill0")
    assert_stage(runs, "prefill1")
    # Bucket padding wrote only scratch page 0 — slot 1's page 3 holds
    # exactly its 5 real positions.
    k = runs[1]["prefill1"][1]
    assert np.any(k[:, 3 * PAGE:3 * PAGE + 5] != 0)
    assert np.all(k[:, 3 * PAGE + 5:4 * PAGE] == 0)


def test_copy_cache_rows_matches_jax(runs):
    assert_stage(runs, "copy")
    k = runs[1]["copy"][1]
    np.testing.assert_array_equal(k[:, 4 * PAGE:5 * PAGE], k[:, PAGE:2 * PAGE])


def test_paged_extend_matches_jax(runs):
    assert_stage(runs, "extend")


def test_paged_decode_step_matches_jax(runs):
    assert_stage(runs, "decode")
    assert runs[1]["decode"][0].shape[0] == SLOTS


def test_extend_over_shared_prefix_equals_cold_prefill():
    """Extending a tail over a copied prefix page gives the logits a cold
    prefill of the whole prompt gives (the prefix-cache contract), in the
    port alone."""
    _, tcfg, _, model = bridged(MOE)
    rng = np.random.default_rng(9)
    prompt = rng.integers(1, 256, 13)
    cache = tgen.init_paged_cache(tcfg, NUM_PAGES, PAGE, device="cpu")
    toks = np.zeros((1, 16), np.int32)
    toks[0, :13] = prompt
    cold, _ = tgen.paged_prefill(
        model, torch.from_numpy(toks).long(), cache,
        torch.from_numpy(rows_for([1, 2], 0, 13, 16)).long(), 13, tcfg)
    # Share page 1 (positions 0-7) into page 3, extend positions 8-12.
    tgen.copy_cache_rows(cache, torch.arange(PAGE, 2 * PAGE),
                         torch.arange(3 * PAGE, 4 * PAGE))
    tail = np.zeros((1, 8), np.int32)
    tail[0, :5] = prompt[8:]
    read_rows = np.concatenate([pg * PAGE + np.arange(PAGE)
                                for pg in (3, 4, 0, 0)])
    warm, _ = tgen.paged_extend(
        model, torch.from_numpy(tail).long(), cache,
        torch.from_numpy(rows_for([3, 4], PAGE, 5, 8)).long(),
        torch.from_numpy(read_rows).long(), PAGE, 5, tcfg)
    torch.testing.assert_close(warm, cold, rtol=0, atol=1e-5)
