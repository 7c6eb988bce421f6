"""Port parity: MoE under a dp x fsdp x ep x tp mesh (``models/moe.py``'s
mesh path: the einsum and scatter dispatches per shard, and the ep-sharded
dropless grouped path, the reference's ``_grouped_ffn_sharded``) against
the JAX single-device step.

Gloo ranks (subprocesses of ``tests/_torch_mesh_worker.py``, one thread
each) take one ``llama_loss`` + backward + ``default_optimizer`` step of
``dryrun_multichip``'s config B2 (``LlamaConfig.tiny(vocab_size=512,
dim=128, n_layers=2, n_heads=8, n_kv_heads=4, intermediate=256,
n_experts=4, moe_top_k=2)``, f32, B 4 x T 64) from JAX's init, bridged:

- grouped under (ep 2) with remat "full", (fsdp 2, ep 2) and (dp 2, ep 2,
  tp 2) with remat "moe";
- einsum under (fsdp 2, ep 2) at capacity factor 0.5, where tokens drop,
  and scatter under (ep 2, tp 2) (``tests/test_torch_moe_mesh_dispatch.py``,
  through :func:`run_case`).

Each against JAX's ``value_and_grad`` + optax step on one device: the loss
within 1e-5 relative, every gathered full gradient within 1e-4 of its max
(each gradient placed as its parameter, so that every rank's AdamW update
agrees), ``aux_loss``, ``z_loss`` and ``overflow_frac`` (of
``llama_forward(return_aux=True)``) within 1e-5; and every parameter after
the step within 1e-4 of its max of optax's step (clip 1.0, AdamW) taken
from JAX's init with the ranks' gathered gradients.  (Adam's first update
is lr * g / (|g| + 1e-8): a gradient element near 1e-9, where the f32
summation order of a sharded reduction moves it by tens of percent, moves
its update by several 1e-6, which the check against JAX's own gradients
would read as a fault of the optimizer.)
No fallback warning.  Each rank's per-shard grouped layout (``dest``, the
tile owners, ``valid_tiles``, M and bm, and the shard's first expert)
equals a numpy transcription of the reference body
(``kubeflow_controller_tpu/models/moe.py:_grouped_ffn_sharded``,
l.403-434) exactly.  One FFN call on its own (x [4, 16, 128], E 4, F 256)
equals JAX's own ``moe_ffn_stats`` under the same mesh on its host
devices within 1e-5 of max |y| (the JAX run is held to no fallback too).
The grouped step's kernel calls equal the ``pallas_call``s of the
reference's ``jax.grad`` jaxpr under the JAX mesh: the skip forms of
``gmm`` and ``tgmm`` (a layer: 3 forward ``gmm``, 3 dlhs and 3 ``tgmm``;
under "full" the 3 forward ones again, under "moe" none, since it keeps
gate, up and down) and no ``gmm_swiglu``.
"""

import pickle
import warnings

import jax
import numpy as np
import optax
import pytest
import torch
from jax.extend import core as jcore

from kubeflow_controller_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from kubeflow_controller_tpu.models.llama import llama_forward as jax_llama_forward
from kubeflow_controller_tpu.models.llama import llama_init as jax_llama_init
from kubeflow_controller_tpu.models.llama import llama_loss as jax_llama_loss
from kubeflow_controller_tpu.models.moe import moe_ffn_stats as jax_moe_ffn_stats
from kubeflow_controller_tpu.parallel import MeshSpec as JaxMeshSpec
from kubeflow_controller_tpu.parallel import build_mesh as jax_build_mesh
from kubeflow_controller_tpu.parallel.compat import set_mesh as jax_set_mesh
from kubeflow_controller_tpu.workloads import data as jax_data
from kubeflow_controller_tpu.workloads.trainer import default_optimizer as jax_default_optimizer

from _torch_ranks import start_ranks, wait_ranks

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
STATS_TOL = 1e-5
FFN_RTOL = 1e-5
BATCH, SEQ = 4, 64
MOE = dict(vocab_size=512, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
           intermediate=256, n_experts=4, moe_top_k=2, max_seq_len=SEQ)
DROPPING_CF = 0.5

# (dispatch, (dp, fsdp, ep, tp), remat policy, capacity factor); the
# einsum and scatter cases run from tests/test_torch_moe_mesh_dispatch.py.
CASES = [
    ("grouped", (1, 1, 2, 1), "full", 1.25),
    ("grouped", (1, 2, 2, 1), "none", 1.25),
    ("grouped", (2, 1, 2, 2), "moe", 1.25),
]
DISPATCH_CASES = [
    ("einsum", (1, 2, 2, 1), "none", DROPPING_CF),
    ("scatter", (1, 1, 2, 2), "none", 1.25),
]
SKIP_KERNELS = {"_gmm_single_k_skip_kernel": "gmm_skip",
                "_tgmm_skip_kernel": "tgmm_skip", "_gmm2_kernel": "gmm_swiglu",
                "_gmm_kernel": "gmm", "_gmm_single_k_kernel": "gmm",
                "_tgmm_kernel": "tgmm"}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_names(tree):
    """(port parameter name, array) for a JAX parameter tree."""
    out = {k: tree[k] for k in ("embed", "final_norm", "lm_head")}
    for key, stacked in tree["layers"].items():
        for i, a in enumerate(stacked):
            out[f"layers.{i}.{key}"] = a
    return out


def jax_config(dispatch, policy, cf):
    return JaxLlamaConfig.tiny(remat=policy != "none",
                               remat_policy="full" if policy == "none"
                               else policy, moe_dispatch=dispatch,
                               capacity_factor=cf, **MOE)


def jax_mesh(axes):
    dp, fsdp, ep, tp = axes
    n = dp * fsdp * ep * tp
    return jax_build_mesh(JaxMeshSpec(dp=dp, fsdp=fsdp, ep=ep, tp=tp),
                          jax.devices()[:n])


def ffn_inputs():
    """One FFN call's x, router and expert weights (the shapes of
    ``tests/test_moe.py``'s sharded case, B 4 so dp x fsdp divides it)."""
    ks = jax.random.split(jax.random.PRNGKey(5), 5)
    d, e, f = 128, 4, 256
    return tuple(np.asarray(a) for a in (
        jax.random.normal(ks[0], (BATCH, 16, d)),
        jax.random.normal(ks[1], (d, e)) * 0.1,
        jax.random.normal(ks[2], (e, d, f)) * 0.05,
        jax.random.normal(ks[3], (e, d, f)) * 0.05,
        jax.random.normal(ks[4], (e, f, d)) * 0.05))


def _subjaxprs(params):
    for v in params.values():
        for x in v if isinstance(v, (tuple, list)) else (v,):
            if isinstance(x, jcore.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jcore.Jaxpr):
                yield x


def jaxpr_kernel_counts(jaxpr, mult=1, counts=None):
    """Executions of each grouped Pallas kernel in ``jaxpr`` (a scan body
    times its length; a shard_map body once)."""
    counts = {v: 0 for v in SKIP_KERNELS.values()} if counts is None else counts
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            name = eqn.params["jaxpr"].debug_info.func_src_info.split()[0]
            if name in SKIP_KERNELS:
                counts[SKIP_KERNELS[name]] += mult
            continue
        inner = mult * (eqn.params["length"]
                        if eqn.primitive.name == "scan" else 1)
        for sub in _subjaxprs(eqn.params):
            jaxpr_kernel_counts(sub, inner, counts)
    return counts


def optax_step(params, grads):
    """The parameters after one optax step of ``default_optimizer`` (lr
    3e-4, weight decay 0.1, clip 1.0) from ``params`` with ``grads``."""
    opt = jax_default_optimizer(3e-4, weight_decay=0.1)
    updates, _ = opt.update(grads, opt.init(params), params)
    return np_tree(optax.apply_updates(params, updates))


def jax_tree(named, like):
    """A JAX parameter tree like ``like`` from port parameter names."""
    layers = {key: np.stack([named[f"layers.{i}.{key}"]
                             for i in range(len(stacked))])
              for key, stacked in like["layers"].items()}
    return {**{k: named[k] for k in ("embed", "final_norm", "lm_head")},
            "layers": layers}


def jax_reference(jcfg, params, tokens):
    loss, grads = jax.value_and_grad(
        lambda p: jax_llama_loss(p, tokens, jcfg))(params)
    _, aux = jax_llama_forward(params, tokens, jcfg, return_aux=True)
    return (float(loss), np_tree(grads),
            {k: float(v) for k, v in aux.items()})


def jax_under_mesh(jcfg, params, tokens, axes, ffn, dispatch, cf):
    """JAX's own sharded run under ``axes`` on its host devices: the FFN
    call's (y, stats), and the grouped kernels' calls in the step's
    jaxpr."""
    x, router, wg, wu, wd = ffn
    with jax_set_mesh(jax_mesh(axes)), warnings.catch_warnings():
        warnings.filterwarnings("error", message="moe dispatch")
        y, stats = jax.jit(lambda x: jax_moe_ffn_stats(
            x, router, wg, wu, wd, top_k=2, capacity_factor=cf,
            dispatch=dispatch))(x)
        jaxpr = jax.make_jaxpr(jax.grad(
            lambda p: jax_llama_loss(p, tokens, jcfg)))(params).jaxpr
    return (np.asarray(y), {k: float(v) for k, v in stats.items()},
            jaxpr_kernel_counts(jaxpr))


def reference_layout(idx, first, n_local, block_m):
    """The reference body's per-shard layout (``_grouped_ffn_sharded``,
    l.403-434), transcribed to numpy."""
    k = idx.shape[-1]
    n_slots = idx.size
    bm = block_m
    while n_slots % bm:
        bm //= 2
    slot_g = idx.reshape(n_slots)
    local = (slot_g >= first) & (slot_g < first + n_local)
    slot_e = np.where(local, slot_g - first, n_local)
    onehot = np.eye(n_local + 1, dtype=np.int64)[slot_e]
    pos = np.cumsum(onehot, axis=0) - onehot
    rank = pos[np.arange(n_slots), slot_e]
    counts = onehot.sum(axis=0)
    padded = (counts + bm - 1) // bm * bm
    pad_off = np.cumsum(padded) - padded
    m = n_slots + (n_local + 1) * bm
    dest = pad_off[slot_e] + rank
    ends = pad_off + padded
    te = np.minimum(np.searchsorted(ends, np.arange(m // bm) * bm,
                                    side="right"), n_local - 1)
    assert k and dest.shape == (n_slots,)
    return {"dest": dest, "te": te, "valid_tiles": np.array([ends[n_local - 1]
                                                             // bm]),
            "m": m, "bm": bm}


def check_layouts(ranks, axes):
    ep = axes[2]
    n_local = MOE["n_experts"] // ep
    seen = 0
    for rank in ranks:
        for lay in rank["layouts"]:
            assert lay["first"] == rank["ep_index"] * n_local, lay["first"]
            assert lay["n_local"] == n_local
            want = reference_layout(lay["idx"], lay["first"], n_local, 256)
            assert lay["m"] == want["m"] and lay["bm"] == want["bm"]
            for key in ("dest", "te", "valid_tiles"):
                np.testing.assert_array_equal(lay[key], want[key],
                                              err_msg=key)
            seen += 1
    assert seen == len(ranks) * MOE["n_layers"], seen


def case_ids(cases):
    return [f"{d}-{a}-{p}" for d, a, p, _ in cases]


@pytest.mark.parametrize("dispatch,axes,policy,cf", CASES,
                         ids=case_ids(CASES))
def test_moe_mesh_step_matches_the_jax_single_device_step(
        dispatch, axes, policy, cf, tmp_path):
    run_case(dispatch, axes, policy, cf, tmp_path)


def run_case(dispatch, axes, policy, cf, tmp_path):
    """One case: the ranks' step against JAX's (see the docstring)."""
    jcfg = jax_config(dispatch, policy, cf)
    params = jax_llama_init(jax.random.PRNGKey(0), jcfg)
    tokens = jax_data.synthetic_tokens(3, BATCH, SEQ, jcfg.vocab_size)
    ffn = ffn_inputs()
    src = tmp_path / "params.pkl"
    with open(src, "wb") as fh:
        pickle.dump((np_tree(params), np.asarray(tokens), ffn), fh)
    out = str(tmp_path / "moe.pt")
    ranks = start_ranks(int(np.prod(axes)), "moe", out, *map(str, axes),
                        policy, dispatch, str(cf), str(src))
    loss, grads, aux = jax_reference(jcfg, params, tokens)
    y_ref, stats_ref, counts = jax_under_mesh(jcfg, params, tokens, axes,
                                              ffn, dispatch, cf)
    wait_ranks(ranks, timeout=300)
    got = torch.load(out, weights_only=False)

    assert not got["fell_back"], got["fell_back"]
    assert abs(got["loss"] - loss) <= LOSS_RTOL * abs(loss)
    for key, ref in aux.items():
        assert abs(got["aux"][key] - ref) <= STATS_TOL * max(1.0, abs(ref)), (
            key, got["aux"][key], ref)
    if dispatch == "einsum":
        assert aux["overflow_frac"] > 0.05, aux      # the capacity drops
    assert not got["grads_misplaced"], got["grads_misplaced"]
    after = optax_step(params, jax_tree(got["grads"], params))
    for kind, want in (("grads", grads), ("params", after)):
        want = port_names(want)
        assert got[kind].keys() == want.keys()
        for name, ref in want.items():
            err = np.max(np.abs(got[kind][name] - ref))
            assert err <= GRAD_RTOL * np.max(np.abs(ref)), (kind, name, err)

    err = np.max(np.abs(got["ffn_y"] - y_ref))
    assert err <= FFN_RTOL * np.max(np.abs(y_ref)), err
    for key, ref in stats_ref.items():
        assert abs(got["ffn_stats"][key] - ref) <= STATS_TOL * max(
            1.0, abs(ref)), (key, got["ffn_stats"][key], ref)

    if dispatch == "grouped":
        check_layouts(got["ranks"], axes)
        assert counts["gmm_skip"] and counts["tgmm_skip"], counts
        assert got["calls"] == {"gmm": 0, "gmm_skip": counts["gmm_skip"],
                                "tgmm": 0, "tgmm_skip": counts["tgmm_skip"],
                                "gmm_swiglu": 0}, (got["calls"], counts)
        per_layer = {"full": 9, "moe": 6, "none": 6}[policy]
        assert counts["gmm_skip"] == per_layer * MOE["n_layers"], counts
        assert counts["tgmm_skip"] == 3 * MOE["n_layers"], counts
    else:
        assert all(not r["layouts"] for r in got["ranks"])
        assert not any(got["calls"].values()), got["calls"]
