"""Port parity: sharded cached generation (``forward_with_cache(mesh=)``,
``generate(mesh=)``, ``init_cache(mesh=)``) over gloo ranks against the
JAX package's unsharded paths, the counterparts of the reference's
``TestShardedDecode``.

Gloo ranks (subprocesses of ``tests/_torch_mesh_worker.py``, scenario
``generate``) take the model of ``test_torch_generate`` from one numpy
init, sharded by ``shard_llama``: the dense tiny config under (tp 2),
(dp 2, tp 2), (dp 2, fsdp 2, tp 2) over 8 ranks (fsdp gathers each
weight before use) and (sp 2) (sp is not a decode axis: everything is
replicated over it, with no error), and the grouped MoE config under (ep
2), each with a
batch of 4 prompts of 8 tokens (B·T·top_k a multiple of 8: the reference
stays grouped).  The sharded prefill's logits lie within 2e-4 of JAX's
unsharded ``llama_forward`` and its cache rows within 1e-5 of JAX's
``forward_with_cache``; greedy ``generate`` with the default read, with
``kv_block=4`` (the blocked read over S 16) and with the int8 cache
equals JAX's unsharded ``generate`` token for token on every rank; the
cache is a DTensor per key of the reference's cache, placed by
``cache_placements`` (batch over dp, kv heads over tp, S whole).
Sampled ``generate(mesh=)`` (temperature 0.8, top-k 20) on a batch whose
second half repeats its first, so that under dp each prompt has a twin on
the other shard: its tokens equal the unsharded port's from a generator
of the same seed on every rank, and twins draw tokens of their own.
"""

import importlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_ranks import start_ranks, wait_ranks
from test_torch_generate import CONFIGS, numpy_params

from kubeflow_controller_tpu.models.generate import forward_with_cache as jax_forward_with_cache
from kubeflow_controller_tpu.models.generate import generate as jax_generate
from kubeflow_controller_tpu.models.generate import init_cache as jax_init_cache
from kubeflow_controller_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from kubeflow_controller_tpu.models.llama import llama_forward as jax_llama_forward
from kubeflow_controller_tpu_torch import bridge
from kubeflow_controller_tpu_torch.models.llama import LlamaConfig

# The module by its name: the package exports the function ``generate``.
tgen = importlib.import_module("kubeflow_controller_tpu_torch.models.generate")

torch.set_num_threads(2)

PREFILL_ATOL = 2e-4
CACHE_ATOL = 1e-5
B, T_P, NEW, S = 4, 8, 6, 16
RUNS = {"default": {}, "block4": {"kv_block": 4},
        "int8": {"kv_block": 4, "kv_quant": True}}
SAMPLE = {"temperature": 0.8, "top_k": 20, "seed": 11}

# (dp, fsdp, tp, ep, sp, config)
MESHES = [(1, 1, 2, 1, 1, "dense"), (2, 1, 2, 1, 1, "dense"),
          (2, 2, 2, 1, 1, "dense"), (1, 1, 1, 1, 2, "dense"),
          (1, 1, 1, 2, 1, "moe")]
MESH_IDS = ["tp2-dense", "dp2-tp2-dense", "dp2-fsdp2-tp2-dense",
            "sp2-dense", "ep2-moe"]


def port_sampled(config, params, sample):
    """The unsharded port's sampled ``generate`` of ``sample``."""
    cfg = LlamaConfig.tiny(**CONFIGS[config])
    model = bridge.llama_from_jax(params, cfg, device="cpu")
    return tgen.generate(
        model, torch.from_numpy(sample["prompt"]).long(), cfg,
        max_new_tokens=NEW, temperature=sample["temperature"],
        top_k=sample["top_k"],
        generator=torch.Generator().manual_seed(sample["seed"])).numpy()


def jax_reference(jcfg, params, prompt):
    p = jax.tree.map(jnp.asarray, params)
    toks = jnp.asarray(prompt)
    _, cache = jax_forward_with_cache(p, toks, jax_init_cache(jcfg, B, S), 0,
                                      jcfg)
    return {"prefill": np.asarray(jax_llama_forward(p, toks, jcfg)),
            "cache": {k: np.asarray(v) for k, v in cache.items()},
            "tokens": {name: np.asarray(jax_generate(
                p, toks, jcfg, max_new_tokens=NEW, **kw))
                for name, kw in RUNS.items()}}


@pytest.fixture(scope="module", params=MESHES, ids=MESH_IDS)
def runs(request, tmp_path_factory):
    dp, fsdp, tp, ep, sp, config = request.param
    jcfg = JaxLlamaConfig.tiny(**CONFIGS[config])
    params = numpy_params(jcfg)
    prompt = np.random.default_rng(6).integers(
        1, jcfg.vocab_size, (B, T_P)).astype(np.int32)
    tmp = tmp_path_factory.mktemp("generate")
    src = tmp / "params.pkl"
    # Twins: row i + B/2 repeats row i, on the other dp shard.
    sample = dict(SAMPLE, prompt=np.concatenate([prompt[:B // 2]] * 2))
    with open(src, "wb") as fh:
        pickle.dump((params, prompt, sample), fh)
    out = str(tmp / "generate.pt")
    ranks = start_ranks(dp * fsdp * tp * ep * sp, "generate", out,
                        *map(str, (dp, fsdp, tp, ep, sp)), config, str(src))
    want = jax_reference(jcfg, params, prompt)
    want["tokens"]["sampled"] = port_sampled(config, params, sample)
    wait_ranks(ranks, timeout=240)
    return (dp * fsdp, tp, ep), torch.load(out, weights_only=False), want


def test_sharded_prefill_matches_jax_llama_forward(runs):
    _, got, want = runs
    assert got["prefill"].shape == want["prefill"].shape
    np.testing.assert_allclose(got["prefill"], want["prefill"], rtol=0,
                               atol=PREFILL_ATOL)
    assert got["in_place"]


def test_sharded_prefill_writes_jax_cache_rows(runs):
    _, got, want = runs
    assert sorted(got["cache"]) == sorted(want["cache"])
    for key, w in want["cache"].items():
        np.testing.assert_allclose(got["cache"][key], w, rtol=0,
                                   atol=CACHE_ATOL, err_msg=key)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_sharded_greedy_generate_matches_jax(runs, run):
    _, got, want = runs
    assert got["tokens"][run].shape == (B, T_P + NEW)
    np.testing.assert_array_equal(got["tokens"][run], want["tokens"][run])
    for rank in got["ranks"]:
        np.testing.assert_array_equal(rank[run], got["tokens"][run])


def test_sharded_sampled_generate_matches_the_unsharded_port(runs):
    _, got, want = runs
    sampled = got["tokens"]["sampled"]
    assert sampled.shape == (B, T_P + NEW)
    np.testing.assert_array_equal(sampled, want["tokens"]["sampled"])
    for rank in got["ranks"]:
        np.testing.assert_array_equal(rank["sampled"], sampled)
    half = B // 2
    np.testing.assert_array_equal(sampled[:half, :T_P], sampled[half:, :T_P])
    for i in range(half):
        assert (sampled[i, T_P:] != sampled[i + half, T_P:]).any(), (
            f"twin prompts {i} and {i + half} drew the same tokens")


def test_cache_placements_cover_the_cache(runs):
    (data, tp, _), got, _ = runs
    want = got["want_placements"]
    assert set(got["placements"]) <= set(want)
    assert set(want) == {"k", "v", "k_scale", "v_scale"}
    for key, placements in got["placements"].items():
        assert placements == want[key], key
    full = got["cache"]["k"].shape
    assert got["local_shapes"]["k"] == (full[0], full[1] // data, full[2],
                                        full[3] // tp, full[4])
