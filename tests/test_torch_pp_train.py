"""Port parity: the pipeline-parallel model path (``models/llama.py``:
``llama_loss_and_grads_pp``, the 1F1B schedule over the layers as stages,
and ``llama_forward_pp``, GPipe) against the reference's.

One process (two virtual stages, ``Lockstep``), ``LlamaConfig.tiny``
(f32, attention "auto": the plain path on both sides) and, for the MoE,
the widths of ``dryrun_multichip``'s config B2 (dim 128, intermediate
256, 4 experts top-2, so JAX takes its grouped kernels), B 4 x T 32, from
JAX's init, bridged:

- dense at M 2, and the MoE (einsum at capacity factor 0.5, where tokens
  drop, and grouped) at M 1, against ``jax.value_and_grad(llama_loss)``
  (one microbatch: the router penalties are the whole batch's);
- the MoE at M 2 against JAX's own ``llama_loss_and_grads_pp`` under a
  (pp 2) mesh of its host devices (the per-microbatch penalty is an
  approximation of the whole batch's, the same in both).

The limits are the reference's ``tests/test_pipeline.py``: the loss
within 1e-4 relative, every gradient within atol 5e-4 / rtol 5e-3
(measured over the five cases: the loss 2.3e-7 relative, the gradients
4.5e-8 absolute, 8.5e-7 of their max, at most).
``llama_forward_pp`` at M 1 equals ``llama_forward``'s logits and router
stats (the reference's ``test_gpipe_moe_forward_returns_aux``), at M 2
its logits.

The kernels' launches a layer a real microbatch of the 1F1B step, under
remat "full" with attention "flash" (the plain versions counted): equal
to the ``pallas_call``s in the jaxprs of the reference's stage forward
and its ``bwd_one`` (the stage's vjp, re-running the stage) per layer,
and to ``chip_smoke.py``'s ``PP_LAUNCHES_PER_LAYER`` and
``PP_MOE_LAUNCHES_PER_LAYER``, which the card is held to.

Over gloo ranks (``tests/_torch_mesh_worker.py``, scenario ``pp``), each
process building its stage with ``llama_init(mesh=)`` and taking its
shards of the JAX init: (pp 2) dense at M 2, (pp 2, fsdp 2) dense at M 2
and (pp 2, ep 2) grouped at M 1 against ``jax.value_and_grad
(llama_loss)``; the loss equal on every rank, every gradient placed as
its parameter, the embedding's, final norm's and head's gradients equal
on every pp rank, and under ep each rank's skip ``gmm``/``tgmm`` calls 9
and 3 a layer a microbatch (remat off), ``gmm_swiglu`` none.

Under pp with sp (scenario ``pp_sp``, remat "full", attention "flash"),
the same checks over 4 ranks for (pp 2, sp 2) dense at M 2 and the MoE
(grouped, M 1), each with the ring and with Ulysses, and over 2
ranks for two virtual stages in each process (``Lockstep``) over an
(sp 2) group; besides, each rank's flash calls equal
``chip_smoke.pp_sp_launches_per_layer`` of its sp index (the causal
ring's rank idx folds idx + 1 blocks) times its layers and microbatches,
the MoE's grouped calls are all skip forms (12 ``gmm`` and 3 ``tgmm`` a
layer a microbatch), and ``llama_forward_pp``'s logits equal JAX's
``llama_forward``'s.

``llama_pretrain.main`` over gloo ranks (scenario ``main``): ``--pp 2``
over 2 ranks, and ``--pp 2 --sp 2`` over 4 with the ring, and with
Ulysses and the chunked CE; its two steps' losses and the clip's global
norms equal a one-process run's within 1e-5 relative.
"""

import collections
import contextlib
import pickle
import warnings
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core as jcore

import chip_smoke
from kubeflow_controller_tpu.models import llama as jllama
from kubeflow_controller_tpu.parallel import MeshSpec as JaxMeshSpec
from kubeflow_controller_tpu.parallel import build_mesh as jax_build_mesh
from kubeflow_controller_tpu.parallel.compat import set_mesh as jax_set_mesh
from kubeflow_controller_tpu.parallel.pipeline import split_stages as jax_split
from kubeflow_controller_tpu.workloads import data as jax_data
from kubeflow_controller_tpu_torch import bridge
from kubeflow_controller_tpu_torch.models import llama as tllama
from kubeflow_controller_tpu_torch.ops import attention as tat
from kubeflow_controller_tpu_torch.ops import grouped_matmul as tgm
from kubeflow_controller_tpu_torch.workloads import llama_pretrain as tpre
from kubeflow_controller_tpu_torch.workloads import trainer

from _torch_ranks import start_ranks, wait_ranks

LOSS_RTOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 5e-4, 5e-3
MAIN_RTOL = 1e-5
BATCH, SEQ = 4, 32
MOE = dict(vocab_size=512, dim=128, n_heads=8, n_kv_heads=4,
           intermediate=256, n_experts=4, moe_top_k=2)
CONFIGS = {"dense": {}, "einsum": dict(MOE, moe_dispatch="einsum",
                                       capacity_factor=0.5),
           "grouped": dict(MOE, moe_dispatch="grouped")}
KERNELS = {"_fwd_kernel": "flash_fwd", "_dq_kernel": "flash_dq",
           "_dkv_kernel": "flash_dkv", "_gmm2_kernel": "gmm_swiglu",
           "_gmm_kernel": "gmm", "_gmm_single_k_kernel": "gmm",
           "_tgmm_kernel": "tgmm"}
PLAIN = {"flash_fwd": (tat, "flash_fwd_plain"),
         "flash_dq": (tat, "flash_dq_plain"),
         "flash_dkv": (tat, "flash_dkv_plain"),
         "gmm_swiglu": (tgm, "gmm_swiglu_plain"),
         "gmm": (tgm, "gmm_plain"), "tgmm": (tgm, "tgmm_plain")}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_setup(config, **extra):
    jcfg = jllama.LlamaConfig.tiny(max_seq_len=SEQ, **CONFIGS[config],
                                   **extra)
    params = jllama.llama_init(jax.random.PRNGKey(0), jcfg)
    tokens = jax_data.synthetic_tokens(3, BATCH, SEQ, jcfg.vocab_size)
    return jcfg, params, tokens


def jax_loss_grads(jcfg, params, tokens):
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="moe dispatch")
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jllama.llama_loss(p, tokens, jcfg)))(params)
    return float(loss), np_tree(grads)


def jax_pp_loss_grads(jcfg, params, tokens, m):
    mesh = jax_build_mesh(JaxMeshSpec(pp=2, fsdp=1), jax.devices()[:2])
    with jax_set_mesh(mesh), warnings.catch_warnings():
        warnings.filterwarnings("error", message="moe dispatch")
        loss, grads = jax.jit(lambda p, t: jllama.llama_loss_and_grads_pp(
            p, t, jcfg, mesh, n_microbatches=m))(params, tokens)
    return float(loss), np_tree(grads)


def port_names(tree):
    out = {k: tree[k] for k in ("embed", "final_norm", "lm_head")}
    for key, stacked in tree["layers"].items():
        for i, a in enumerate(stacked):
            out[f"layers.{i}.{key}"] = a
    return out


def port_model(config, params, **extra):
    cfg = tllama.LlamaConfig.tiny(max_seq_len=SEQ, **CONFIGS[config],
                                  **extra)
    return cfg, bridge.llama_from_jax(np_tree(params), cfg, device="cpu",
                                      requires_grad=True)


def check(loss, grads, ref_loss, ref_grads):
    assert abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss), (loss,
                                                               ref_loss)
    want = port_names(ref_grads)
    assert set(grads) == set(want)
    for name, ref in want.items():
        np.testing.assert_allclose(np.asarray(grads[name]), ref,
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


CASES = [("dense", 2, "loss"), ("einsum", 1, "loss"), ("grouped", 1, "loss"),
         ("einsum", 2, "pp"), ("grouped", 2, "pp")]


@pytest.mark.parametrize("config,m,against", CASES,
                         ids=[f"{c}-M{m}-{a}" for c, m, a in CASES])
def test_pp_loss_and_grads_match_jax(config, m, against):
    jcfg, params, tokens = jax_setup(config)
    if against == "loss":
        ref_loss, ref_grads = jax_loss_grads(jcfg, params, tokens)
    else:
        ref_loss, ref_grads = jax_pp_loss_grads(jcfg, params, tokens, m)
    cfg, model = port_model(config, params)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="moe dispatch")
        loss, grads = tllama.llama_loss_and_grads_pp(
            model, bridge.tokens_from_jax(tokens, "cpu"), cfg,
            n_microbatches=m, n_stages=2)
    check(float(loss), {n: g.numpy() for n, g in grads.items()}, ref_loss,
          ref_grads)
    if config == "einsum":      # the capacity dropped tokens
        _, aux = jllama.llama_forward(params, tokens, jcfg, return_aux=True)
        assert float(aux["overflow_frac"]) > 0.05


def test_forward_pp_returns_aux():
    jcfg, params, tokens = jax_setup("einsum")
    ref_logits, ref_aux = jllama.llama_forward(params, tokens, jcfg,
                                               return_aux=True)
    cfg, model = port_model("einsum", params)
    toks = bridge.tokens_from_jax(tokens, "cpu")
    with torch.no_grad():
        logits, aux = tllama.llama_forward_pp(
            model, toks, cfg, n_microbatches=1, n_stages=2, return_aux=True)
        logits2 = tllama.llama_forward_pp(model, toks, cfg,
                                          n_microbatches=2, n_stages=2)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=2e-4, rtol=2e-4)
    for k, v in ref_aux.items():
        np.testing.assert_allclose(float(aux[k]), float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    jcfg, params, tokens = jax_setup("dense")
    cfg, model = port_model("dense", params)
    with torch.no_grad():
        logits2 = tllama.llama_forward_pp(
            model, bridge.tokens_from_jax(tokens, "cpu"), cfg,
            n_microbatches=2, n_stages=2)
    np.testing.assert_allclose(logits2.numpy(), np.asarray(
        jllama.llama_forward(params, tokens, jcfg)), atol=2e-4, rtol=2e-4)


# -- launches a layer a microbatch ---------------------------------------------

def _subjaxprs(params):
    for v in params.values():
        for x in v if isinstance(v, (tuple, list)) else (v,):
            if isinstance(x, jcore.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jcore.Jaxpr):
                yield x


def jaxpr_kernel_counts(jaxpr, mult=1, counts=None):
    """Executions of each Pallas kernel in ``jaxpr`` (a scan body times
    its length)."""
    counts = collections.Counter() if counts is None else counts
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            name = eqn.params["jaxpr"].debug_info.func_src_info.split()[0]
            counts[KERNELS[name]] += mult
            continue
        inner = mult * (eqn.params["length"]
                        if eqn.primitive.name == "scan" else 1)
        for sub in _subjaxprs(eqn.params):
            jaxpr_kernel_counts(sub, inner, counts)
    return counts


def reference_stage_counts(config):
    """The reference's stage forward and ``bwd_one`` (the body of its
    ``llama_loss_and_grads_pp`` and ``pipeline_1f1b``) on one stage of one
    layer, traced: their kernels, summed."""
    jcfg, params, tokens = jax_setup(config, attention="flash", remat=True,
                                     remat_policy="full")
    stage = jax.tree.map(lambda a: a[0], jax_split(params["layers"], 2))
    layer = jllama._maybe_remat(jllama._decoder_layer_fn(
        jcfg, jllama.rope_freqs(jcfg, jnp.arange(SEQ)), None,
        jllama.DEFAULT_RULES), jcfg)

    def run_stage(p, x):
        def body(c, lp):
            y, aux = layer(c, lp)
            return y, (jcfg.moe_aux_coef * aux["aux_loss"]
                       + jcfg.moe_z_coef * aux["z_loss"])
        out, pens = jax.lax.scan(body, x, p)
        return out, jnp.sum(pens) / jcfg.n_layers

    def bwd_one(p, x, g):
        _, vjp = jax.vjp(run_stage, p, x)
        return vjp((g, jnp.float32(1)))

    x = jnp.zeros((BATCH // 2, SEQ, jcfg.dim), jnp.float32)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="moe dispatch")
        counts = jaxpr_kernel_counts(jax.make_jaxpr(run_stage)(stage, x).jaxpr)
        jaxpr_kernel_counts(jax.make_jaxpr(bwd_one)(stage, x, x).jaxpr,
                            counts=counts)
    return jcfg, params, tokens, dict(counts)


@pytest.mark.parametrize("config", ["dense", "grouped"])
def test_launches_per_layer_match_the_reference_jaxpr(config):
    jcfg, params, tokens, want = reference_stage_counts(config)
    cfg, model = port_model(config, params, attention="flash", remat=True,
                            remat_policy="full")
    counts = collections.Counter()
    with contextlib.ExitStack() as stack:
        for name, (mod, attr) in PLAIN.items():
            def counted(*args, _real=getattr(mod, attr), _name=name,
                        **kwargs):
                counts[_name] += 1
                return _real(*args, **kwargs)
            stack.enter_context(mock.patch.object(mod, attr, counted))
        tllama.llama_loss_and_grads_pp(
            model, bridge.tokens_from_jax(tokens, "cpu"), cfg,
            n_microbatches=2, n_stages=2)
    per_layer = {k: v / (cfg.n_layers * 2) for k, v in counts.items()}
    assert per_layer == want, (per_layer, want)
    card = (chip_smoke.PP_LAUNCHES_PER_LAYER if config == "dense"
            else chip_smoke.PP_MOE_LAUNCHES_PER_LAYER)
    assert per_layer == card, (per_layer, card)


# -- over gloo ranks -------------------------------------------------------------

# (id, world, scenario and its mesh arguments, config, M): the ``pp``
# scenario over (pp, fsdp, ep); ``pp_sp`` over (pp, sp) with the ring or
# Ulysses (pp ``v2``: two virtual stages in each process, ``Lockstep``,
# over an sp group of the world).
RANKED = [("pp2-dense", 2, ("pp", 2, 1, 1), "dense", 2),
          ("pp2-fsdp2-dense", 4, ("pp", 2, 2, 1), "dense", 2),
          ("pp2-ep2-grouped", 4, ("pp", 2, 1, 2), "grouped", 1),
          ("pp2-sp2-ring-dense", 4, ("pp_sp", 2, 2, "ring"), "dense", 2),
          ("pp2-sp2-ulysses-dense", 4, ("pp_sp", 2, 2, "ulysses"), "dense",
           2),
          ("pp2-sp2-ring-grouped", 4, ("pp_sp", 2, 2, "ring"), "grouped", 1),
          ("pp2-sp2-ulysses-grouped", 4, ("pp_sp", 2, 2, "ulysses"),
           "grouped", 1),
          ("v2-sp2-ring-dense", 2, ("pp_sp", "v2", 2, "ring"), "dense", 2)]


@pytest.mark.parametrize("world,axes,config,m", [r[1:] for r in RANKED],
                         ids=[r[0] for r in RANKED])
def test_pp_over_gloo_ranks_matches_jax(world, axes, config, m, tmp_path):
    jcfg, params, tokens = jax_setup(config)
    src = tmp_path / "params.pkl"
    with open(src, "wb") as fh:
        pickle.dump((np_tree(params), np.asarray(tokens)), fh)
    out = str(tmp_path / "pp.pt")
    scenario, *mesh_args = axes
    ranks = start_ranks(world, scenario, out, *map(str, mesh_args),
                        config, str(m), str(src))
    ref_loss, ref_grads = jax_loss_grads(jcfg, params, tokens)
    wait_ranks(ranks, timeout=240)
    got = torch.load(out, weights_only=False)
    everyone = got["ranks"]
    assert len({r["loss"] for r in everyone}) == 1, everyone
    check(everyone[0]["loss"], got["grads"], ref_loss, ref_grads)
    for r in everyone:
        assert not r["misplaced"], r["misplaced"]
        for name, g in r["shared"].items():
            np.testing.assert_array_equal(g, everyone[0]["shared"][name])
    if config == "grouped" and scenario == "pp":
        for r in everyone:
            assert r["calls"] == {"gmm": 0, "gmm_skip": 9 * m,
                                  "tgmm": 0, "tgmm_skip": 3 * m,
                                  "gmm_swiglu": 0}, r
    if scenario == "pp_sp":
        check_pp_sp(everyone, jcfg, params, tokens, config, m, *mesh_args)


def check_pp_sp(everyone, jcfg, params, tokens, config, m, pp, sp, kind):
    """Each (pp, sp) rank's kernel calls in the 1F1B step, against the
    prediction for its sp index that the card is held to
    (``chip_smoke.pp_sp_launches_per_layer``) times its layers and the
    microbatches, and ``llama_forward_pp``'s logits against
    ``llama_forward``'s."""
    n_stages = int(str(pp).lstrip("v"))
    layers = (jcfg.n_layers if str(pp).startswith("v")
              else jcfg.n_layers // n_stages)
    assert sorted(r["sp_index"] for r in everyone) == sorted(
        list(range(sp)) * (len(everyone) // sp))
    ref_logits = np.asarray(jllama.llama_forward(params, tokens, jcfg))
    for r in everyone:
        want = {k: v * layers * m for k, v in
                chip_smoke.pp_sp_launches_per_layer(kind,
                                                    r["sp_index"]).items()}
        assert r["flash"] == want, (r["rank"], r["flash"], want)
        # The MoE under a mesh runs the per-shard grouped FFN, every gmm
        # and tgmm in its skip form: under remat "full" gate, up and down
        # three times each and the three dlhs gmm, and three tgmm.
        grouped = config == "grouped"
        assert r["calls"] == {"gmm": 0, "gmm_skip": 12 * layers * m * grouped,
                              "tgmm": 0, "tgmm_skip": 3 * layers * m * grouped,
                              "gmm_swiglu": 0}, r["calls"]
        np.testing.assert_allclose(r["logits"], ref_logits, atol=2e-4,
                                   rtol=2e-4, err_msg=f"rank {r['rank']}")


MAIN_ARGS = ("--device", "cpu", "--steps", "2", "--batch-size", "4",
             "--seq-len", "32")


def test_main_pp2_over_two_ranks_equals_one_process(tmp_path, monkeypatch):
    main_over_ranks_equals_one_process(
        2, ("--pp", "2", "--fsdp", "1", "--microbatches", "2"), tmp_path,
        monkeypatch)


@pytest.mark.parametrize("extra", [("--sp-attention", "ring"),
                                   ("--sp-attention", "ulysses",
                                    "--loss-chunks", "2")],
                         ids=["ring", "ulysses-chunked"])
def test_main_pp2_sp2_over_four_ranks_equals_one_process(extra, tmp_path,
                                                         monkeypatch):
    main_over_ranks_equals_one_process(
        4, ("--pp", "2", "--sp", "2", "--fsdp", "1", "--microbatches", "2"),
        tmp_path, monkeypatch, extra)


def main_over_ranks_equals_one_process(world, mesh_args, tmp_path,
                                       monkeypatch, extra=()):
    """``llama_pretrain.main`` with ``mesh_args`` and ``extra`` over
    ``world`` gloo ranks: every rank's two losses and the clip's global
    norms equal a one-process run's (with ``extra``) within
    ``MAIN_RTOL``."""
    out = str(tmp_path / "main")
    ranks = start_ranks(world, "main", out, *MAIN_ARGS, *mesh_args, *extra)
    for var in ("MODEL_DIR", "KCTPU_MESH", "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    norms, runs = [], []
    real_step, real_train = trainer.Optimizer.step, tpre.train

    def step_(self):
        norm = real_step(self)
        norms.append(float(norm))
        return norm

    def train_(*a, **k):
        runs.append(real_train(*a, **k))
        return runs[-1]

    with mock.patch.object(trainer.Optimizer, "step", step_), \
            mock.patch.object(tpre, "train", train_):
        assert tpre.main([*MAIN_ARGS, *extra]) == 0
    wait_ranks(ranks, timeout=240)
    assert norms[0] > 1.0       # the clip scales the first step
    for r in range(world):
        got = torch.load(f"{out}.{r}", weights_only=False)
        for a, b in zip(got["losses"] + got["norms"],
                        runs[0].losses + norms):
            assert abs(a - b) <= MAIN_RTOL * abs(b), (r, got, runs[0].losses,
                                                      norms)
