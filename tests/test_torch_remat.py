"""Port parity: the named remat policies (``models/remat.py``) against
``jax.checkpoint`` with the reference's policies (``_maybe_remat``).

For each policy (``full``, ``dots``, ``ffn``, ``gateup``, ``gateup_attn``,
``moe``), on ``LlamaConfig.tiny`` cut to one layer (f32, attention
"flash": JAX's Pallas
kernels in interpret mode, the port's plain versions) dense, and MoE with
4 experts under the einsum and the grouped dispatch (dim 128,
intermediate 256, so JAX takes its grouped kernels: its einsum fallback
is an error here):

- the loss within 1e-5 relative and every gradient within 1e-4 of its max
  |grad| of ``jax.value_and_grad(llama_loss)`` (the tolerances of
  ``tests/test_torch_train.py``);
- the kernel calls of the step equal to the kernels' ``pallas_call``
  equations in the jaxpr of ``jax.value_and_grad(loss)``, each counted once per
  execution (a scan body times its length): what JAX re-runs in the
  backward under the policy is what the port re-runs.  The port's calls
  are counted at the plain versions the CPU runs; they are the counts
  per layer the chip run is held to (at two layers, twice them).

Negative control: keeping the fused ``gmm_swiglu`` whole (its gate and up
residuals too, which JAX never names) under ``"moe"`` skips its re-run,
and the count no longer equals JAX's.
"""

import collections
import functools
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.extend import core as jcore

from kubeflow_controller_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from kubeflow_controller_tpu.models.llama import llama_init as jax_llama_init
from kubeflow_controller_tpu.models.llama import llama_loss as jax_llama_loss
from kubeflow_controller_tpu.workloads import data as jax_data
from kubeflow_controller_tpu_torch import bridge
from kubeflow_controller_tpu_torch.models import llama as tllama
from kubeflow_controller_tpu_torch.models import remat
from kubeflow_controller_tpu_torch.ops import attention as tat
from kubeflow_controller_tpu_torch.ops import grouped_matmul as tgm

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
SEQ = 64
POLICIES = ("full", "dots", "ffn", "gateup", "gateup_attn", "moe")

CONFIGS = {
    "dense": dict(n_kv_heads=4),
    "moe-einsum": dict(n_experts=4, moe_dispatch="einsum"),
    "moe-grouped": dict(n_experts=4, moe_dispatch="grouped", dim=128,
                        intermediate=256),
}

# The port's kernel (its plain version on the CPU) of each Pallas kernel.
KERNELS = {"_fwd_kernel": "flash_fwd", "_dq_kernel": "flash_dq",
           "_dkv_kernel": "flash_dkv", "_gmm2_kernel": "gmm_swiglu",
           "_gmm_kernel": "gmm", "_gmm_single_k_kernel": "gmm",
           "_tgmm_kernel": "tgmm"}
PLAIN = {"flash_fwd": (tat, "flash_fwd_plain"),
         "flash_dq": (tat, "flash_dq_plain"),
         "flash_dkv": (tat, "flash_dkv_plain"),
         "gmm_swiglu": (tgm, "gmm_swiglu_plain"),
         "gmm": (tgm, "gmm_plain"), "tgmm": (tgm, "tgmm_plain")}


def _subjaxprs(params):
    for v in params.values():
        for x in v if isinstance(v, (tuple, list)) else (v,):
            if isinstance(x, jcore.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jcore.Jaxpr):
                yield x


def jaxpr_kernel_counts(jaxpr, mult=1, counts=None):
    """Executions of each Pallas kernel in ``jaxpr``: a ``pallas_call``
    equation counts once per run of its enclosing scans."""
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


@pytest.fixture
def port_counts(monkeypatch):
    """Counts the calls of the kernels' plain versions."""
    counts = collections.Counter()
    for name, (mod, attr) in PLAIN.items():
        def counted(*args, _real=getattr(mod, attr), _name=name, **kwargs):
            counts[_name] += 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(mod, attr, counted)
    return counts


def jax_config(overrides, policy, n_layers=1):
    return JaxLlamaConfig.tiny(attention="flash", remat=True,
                               remat_policy=policy, n_layers=n_layers,
                               **overrides)


def jax_counts(overrides, policy, n_layers):
    jcfg = jax_config(overrides, policy, n_layers)
    params = jax_llama_init(jax.random.PRNGKey(0), jcfg)
    tokens = jax_data.synthetic_tokens(3, 2, SEQ, jcfg.vocab_size)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="moe dispatch")
        jaxpr = jax.make_jaxpr(jax.grad(
            lambda p: jax_llama_loss(p, tokens, jcfg)))(params).jaxpr
    return jaxpr_kernel_counts(jaxpr)


@functools.lru_cache(maxsize=None)
def jax_step(config, policy):
    """JAX's loss, gradients and kernel counts under ``policy`` for
    ``CONFIGS[config]`` at one layer (computed once per process)."""
    overrides = CONFIGS[config]
    jcfg = jax_config(overrides, policy)
    params = jax_llama_init(jax.random.PRNGKey(0), jcfg)
    tokens = jax_data.synthetic_tokens(3, 2, SEQ, jcfg.vocab_size)

    def loss_fn(p):
        return jax_llama_loss(p, tokens, jcfg)

    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="moe dispatch")
        traced = jax.jit(jax.value_and_grad(loss_fn)).trace(params)
        counts = jaxpr_kernel_counts(traced.jaxpr.jaxpr)
        loss, grads = traced.lower().compile()(params)
    return (jax.tree.map(np.asarray, params), np.asarray(tokens),
            float(loss), jax.tree.map(np.asarray, grads), counts)


def port_step(overrides, policy, params, tokens):
    cfg = tllama.LlamaConfig.tiny(attention="flash", remat=True,
                                  remat_policy=policy, n_layers=1,
                                  **overrides)
    model = bridge.llama_from_jax(params, cfg, device="cpu",
                                  requires_grad=True)
    loss = tllama.llama_loss(model, bridge.tokens_from_jax(tokens, "cpu"),
                             cfg)
    loss.backward()
    return model, float(loss)


def flat_grads(model, grads):
    out = [("embed", model.embed.grad, grads["embed"]),
           ("final_norm", model.final_norm.grad, grads["final_norm"]),
           ("lm_head", model.lm_head.grad, grads["lm_head"])]
    keys = bridge.LAYER_KEYS + (bridge.MOE_KEYS if model.cfg.n_experts
                                else ())
    for key in keys:
        for i, lp in enumerate(model.layers):
            out.append((f"layers/{key}[{i}]", getattr(lp, key).grad,
                        grads["layers"][key][i]))
    return out


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("config", list(CONFIGS))
def test_policy_matches_jax_loss_gradients_and_recompute(config, policy,
                                                         port_counts):
    params, tokens, ref_loss, ref_grads, want = jax_step(config, policy)
    model, loss = port_step(CONFIGS[config], policy, params, tokens)
    assert abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss)
    for name, got, ref in flat_grads(model, ref_grads):
        assert got is not None, name
        err = np.max(np.abs(got.numpy() - ref))
        assert err <= GRAD_RTOL * np.max(np.abs(ref)), (name, err)
    assert dict(port_counts) == dict(want), (dict(port_counts), dict(want))


def test_recompute_counts_per_layer():
    """The counts the chip run holds the card to, per layer per step: the
    flash forward re-runs under every policy (its residuals are never
    named), so does the fused ``gmm_swiglu``; the down ``gmm`` re-runs
    unless ``ffn_down`` is kept.  At two layers (the scan runs its body
    twice) every count doubles."""
    for policy in POLICIES:
        dense = jax_step("dense", policy)[-1]
        grouped = jax_step("moe-grouped", policy)[-1]
        assert dense["flash_fwd"] == 2, (policy, dense)
        assert grouped["gmm_swiglu"] == 2, (policy, grouped)
        down = 1 if policy in ("ffn", "moe") else 2
        assert grouped["gmm"] == down + 3, (policy, grouped)
        assert grouped["tgmm"] == 3, (policy, grouped)
    two = jax_counts(CONFIGS["moe-grouped"], "moe", n_layers=2)
    assert two == {k: 2 * v for k, v in
                   jax_step("moe-grouped", "moe")[-1].items()}, two


def test_keeping_the_fused_kernel_whole_fails_the_count(port_counts,
                                                        monkeypatch):
    """The misplaced tag: ``ffn_up`` keeping all of ``gmm_swiglu`` (gate
    and up too) drops its re-run, one launch a layer fewer than JAX."""
    params, tokens, _, _, want = jax_step("moe-grouped", "moe")
    monkeypatch.setattr(remat, "NEVER_KEPT", frozenset())
    port_step(CONFIGS["moe-grouped"], "moe", params, tokens)
    assert port_counts["gmm_swiglu"] == 1 and want["gmm_swiglu"] == 2
    assert dict(port_counts) != dict(want)


def test_dots_keeps_the_products_the_full_policy_reruns(port_counts):
    """``dots`` keeps every ``aten.mm`` output: its backward runs none of
    the layer's projections again; ``full``'s runs the six whose outputs
    the backward reads (q, k, v, o, gate, up: the recompute stops before
    the down projection, whose output it never reads)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMm(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func is torch.ops.aten.mm.default
            return func(*args, **(kwargs or {}))

    params, tokens = jax_step("dense", "full")[:2]
    forward_mms = {}
    for policy in ("full", "dots"):
        cfg = tllama.LlamaConfig.tiny(attention="flash", remat=True,
                                      remat_policy=policy, n_layers=1,
                                      **CONFIGS["dense"])
        model = bridge.llama_from_jax(params, cfg, device="cpu",
                                      requires_grad=True)
        loss = tllama.llama_loss(model, bridge.tokens_from_jax(tokens, "cpu"),
                                 cfg)
        mode = CountMm()
        with mode:
            loss.backward()
        forward_mms[policy] = mode.n
    # the backward's own products are the same under both policies
    assert forward_mms["full"] - forward_mms["dots"] == 6 * cfg.n_layers
