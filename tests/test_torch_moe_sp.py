"""Port parity: MoE under sequence parallelism (``models/moe.py``'s mesh
path with the tokens sharded over T by sp) against the JAX single-device
step.

Gloo ranks (``tests/_torch_mesh_worker.py``, scenario ``moe_sp``) take,
for each dispatch (grouped, einsum and scatter), one ``llama_loss`` +
backward of ``dryrun_multichip``'s config B2 (``tests/test_torch_moe_mesh.
py``'s widths: dim 128, 2 layers, 4 experts top-2, B 4 x T 64, ring
attention) from JAX's init, bridged, under (sp 2) over 2 ranks and (ep 2,
sp 2) over 4, at capacity factor 0.5: 16 slots an expert a sequence, so
the capacity dispatches drop about half the assignments, and whether one
in the second half of a sequence is kept depends on what the first half
routed.  Each against ``jax.value_and_grad(llama_loss)`` on one device:
the loss within 1e-5 relative, ``aux_loss``, ``z_loss`` and
``overflow_frac`` within 1e-5 (the overflow above 0.05 for einsum and
scatter), every gathered gradient within 1e-4 of its max and placed as
its parameter.

One FFN call on its own (x [4, 16, 128] sharded over T, E 4, F 256, 4
slots an expert a sequence) equals JAX's ``moe_ffn_stats`` on one device
within 1e-5 of max |y|, its stats within 1e-5; the test asserts, from the
routing of that x, that some assignment of the second sequence shard
fits the capacity counted within its shard and not counted over the whole
sequence: a shard that counted its own positions only would keep it, and
could not match.

And ``llama_pretrain.main --experts 4 --sp 2 --moe-dispatch grouped
--strict-moe-dispatch`` over 2 ranks (scenario ``main``): its two steps'
losses and the clip's global norms equal a one-process run's within 1e-5
relative.
"""

import functools
import pickle
import warnings
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.models.llama import llama_forward as jax_llama_forward
from kubeflow_controller_tpu.models.llama import llama_init as jax_llama_init
from kubeflow_controller_tpu.models.llama import llama_loss as jax_llama_loss
from kubeflow_controller_tpu.models.moe import moe_ffn_stats as jax_moe_ffn_stats
from kubeflow_controller_tpu.workloads import data as jax_data
from kubeflow_controller_tpu_torch.models import moe as tmoe
from kubeflow_controller_tpu_torch.workloads import llama_pretrain as tpre
from kubeflow_controller_tpu_torch.workloads import trainer

from _torch_ranks import start_ranks, wait_ranks
import test_torch_moe_mesh as base

CF = base.DROPPING_CF
DISPATCHES = ("grouped", "einsum", "scatter")
MESHES = [("sp2", (1, 2)), ("ep2-sp2", (2, 2))]      # (ep, sp)


@functools.lru_cache(maxsize=None)
def jax_step(dispatch):
    """JAX's one-device loss, gradients and router stats, and its FFN
    call's output and stats, for ``dispatch`` (once a process)."""
    jcfg = base.jax_config(dispatch, "none", CF)
    params = jax_llama_init(jax.random.PRNGKey(0), jcfg)
    tokens = jax_data.synthetic_tokens(3, base.BATCH, base.SEQ,
                                       jcfg.vocab_size)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="moe dispatch")
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jax_llama_loss(p, tokens, jcfg)))(params)
        _, aux = jax.jit(lambda p: jax_llama_forward(
            p, tokens, jcfg, return_aux=True))(params)
        x, router, wg, wu, wd = base.ffn_inputs()
        y, stats = jax.jit(lambda x: jax_moe_ffn_stats(
            x, router, wg, wu, wd, top_k=2, capacity_factor=CF,
            dispatch=dispatch))(x)
    return (base.np_tree(params), np.asarray(tokens), float(loss),
            base.np_tree(grads), {k: float(v) for k, v in aux.items()},
            np.asarray(y), {k: float(v) for k, v in stats.items()})


def test_the_capacity_depends_on_the_other_shard():
    """Some assignment of the second half of a sequence fits 4 slots when
    counted from its shard's start, and not when counted from the
    sequence's (what the first half routed before it)."""
    x, router = (torch.tensor(a) for a in base.ffn_inputs()[:2])
    _, _, idx = tmoe._route(x, router, 2)
    b, t, k = idx.shape
    n_experts = router.shape[-1]
    cap = tmoe._capacity(t, k, n_experts, CF, 0)
    assert cap == 4
    whole = tmoe._capacity_positions(idx, n_experts, cap)[2]
    half = tmoe._capacity_positions(idx[:, t // 2:], n_experts, cap)[2]
    assert (half > whole[:, t // 2:]).any()


@pytest.mark.parametrize("axes", [m[1] for m in MESHES],
                         ids=[m[0] for m in MESHES])
def test_moe_sp_step_matches_the_jax_single_device_step(axes, tmp_path):
    ep, sp = axes
    params, tokens = jax_step("grouped")[:2]
    src = tmp_path / "params.pkl"
    with open(src, "wb") as fh:
        pickle.dump((params, tokens, base.ffn_inputs()), fh)
    out = str(tmp_path / "moe_sp.pt")
    ranks = start_ranks(ep * sp, "moe_sp", out, str(ep), str(sp), str(CF),
                        str(src))
    want = {d: jax_step(d) for d in DISPATCHES}
    wait_ranks(ranks, timeout=300)
    got = torch.load(out, weights_only=False)
    for dispatch in DISPATCHES:
        g = got[dispatch]
        _, _, loss, grads, aux, y, stats = want[dispatch]
        assert "S(1)" in g["x_placements"], g["x_placements"]
        assert abs(g["loss"] - loss) <= base.LOSS_RTOL * abs(loss), (
            dispatch, g["loss"], loss)
        for key, ref in aux.items():
            assert abs(g["aux"][key] - ref) <= base.STATS_TOL * max(
                1.0, abs(ref)), (dispatch, key, g["aux"][key], ref)
        if dispatch != "grouped":
            assert aux["overflow_frac"] > 0.05, aux
        assert not g["misplaced"], (dispatch, g["misplaced"])
        named = base.port_names(grads)
        assert g["grads"].keys() == named.keys()
        for name, ref in named.items():
            err = np.max(np.abs(g["grads"][name] - ref))
            assert err <= base.GRAD_RTOL * np.max(np.abs(ref)), (
                dispatch, name, err)
        err = np.max(np.abs(g["ffn_y"] - y))
        assert err <= base.FFN_RTOL * np.max(np.abs(y)), (dispatch, err)
        for key, ref in stats.items():
            assert abs(g["ffn_stats"][key] - ref) <= base.STATS_TOL * max(
                1.0, abs(ref)), (dispatch, key, g["ffn_stats"][key], ref)


MAIN_ARGS = ("--device", "cpu", "--steps", "2", "--batch-size", "2",
             "--seq-len", "32", "--experts", "4", "--moe-dispatch",
             "grouped", "--strict-moe-dispatch", "--dim", "128",
             "--intermediate", "256")


def test_main_moe_under_sp_over_two_ranks_equals_one_process(tmp_path,
                                                             monkeypatch):
    out = str(tmp_path / "main")
    ranks = start_ranks(2, "main", out, *MAIN_ARGS, "--sp", "2", "--fsdp",
                        "1")
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
            mock.patch.object(tpre, "train", train_), \
            warnings.catch_warnings():
        assert tpre.main(list(MAIN_ARGS)) == 0
    wait_ranks(ranks, timeout=240)
    for r in range(2):
        got = torch.load(f"{out}.{r}", weights_only=False)
        for a, b in zip(got["losses"] + got["norms"],
                        runs[0].losses + norms):
            assert abs(a - b) <= 1e-5 * abs(b), (r, got, runs[0].losses,
                                                 norms)
