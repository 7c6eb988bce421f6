"""Port parity: the pipeline schedules (``parallel/pipeline.py``:
``split_stages``, ``gpipe``, ``pipeline_1f1b``) against the reference's
(``kubeflow_controller_tpu/parallel/pipeline.py``) on a toy stage.

The toy: L = 6 stacked [8, 8] layers, each ``tanh(x @ w)``, split into S
stages (2 and 3); M microbatches (1, 2, 5) of [3, 8]; the loss a squared
error of ``y @ head`` against a target, mean over the microbatches.  The
same seeded numpy arrays go through JAX's schedule (``mesh=None``: the
stage axis under ``vmap``, the hand-offs as ``jnp.roll``) and the port's
over S virtual stages in one process (``Lockstep``):

- ``pipeline_1f1b`` without and with the stage penalty (``stage_aux``: the
  stage returns ``0.01 * mean(y²)``, seeded with 1): the loss within 1e-5
  relative, the stage, head and input gradients within atol 1e-5 / rtol
  1e-4 of JAX's (the reference's own ``tests/test_pipeline.py`` limits;
  measured over every case: loss 2.2e-7 relative, gradients 3.0e-7
  absolute at most);
- ``gpipe`` differentiated through the same loss (and, with
  ``stage_aux``, the sums of ``mean(y²)`` added at 0.01): the outputs,
  the loss and the same gradients within the same limits.

Over gloo ranks (``tests/_torch_mesh_worker.py``, scenario
``pipeline``): the same schedules with one stage a process over the pp
group (``GroupPipe``, one ``batch_isend_irecv`` a step) equal the virtual
stages of rank 0's process bit for bit, at S 2 and 3.  A counting stage
function is called exactly M times forward (grad off) and M times
backward (the re-run) on each stage; at S 1 the schedule is plain
gradient accumulation, one call a microbatch.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.parallel.pipeline import gpipe as jax_gpipe
from kubeflow_controller_tpu.parallel.pipeline import pipeline_1f1b as jax_1f1b
from kubeflow_controller_tpu.parallel.pipeline import split_stages as jax_split
from kubeflow_controller_tpu_torch.models import llama as tllama
from kubeflow_controller_tpu_torch.parallel import pipeline as pl

from _torch_ranks import run_ranks

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
LAYERS, DIM = 6, 8
PEN = 0.01


def toy(M, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((LAYERS, DIM, DIM))
                  * DIM ** -0.5).astype(np.float32),
            "head": rng.standard_normal(DIM).astype(np.float32),
            "x": rng.standard_normal((M, 3, DIM)).astype(np.float32),
            "targets": rng.standard_normal((M, 3)).astype(np.float32)}


# -- the JAX side ------------------------------------------------------------

def jax_stage(stage, xm):
    return jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), xm,
                        stage["w"])[0]


def jax_stage_pen(stage, xm):
    y = jax_stage(stage, xm)
    return y, PEN * jnp.mean(y * y)


def jax_stage_aux(stage, xm):
    y = jax_stage(stage, xm)
    return y, {"sq": jnp.mean(y * y)}


def jax_loss(lp, y, target):
    return jnp.mean((y @ lp["head"] - target) ** 2)


def jax_1f1b_run(t, S, aux):
    stages = jax_split({"w": jnp.asarray(t["w"])}, S)
    loss, gs, gl, gx = jax_1f1b(jax_stage_pen if aux else jax_stage, stages,
                                jnp.asarray(t["x"]), jax_loss,
                                {"head": jnp.asarray(t["head"])},
                                jnp.asarray(t["targets"]), None,
                                stage_aux=aux)
    return (float(loss), np.asarray(gs["w"]).reshape(LAYERS, DIM, DIM),
            np.asarray(gl["head"]), np.asarray(gx))


def jax_gpipe_run(t, S, aux):
    M = t["x"].shape[0]

    def total(w, head, x):
        out = jax_gpipe(jax_stage_aux if aux else jax_stage,
                        jax_split({"w": w}, S), x, None, stage_aux=aux)
        extra = 0.0
        if aux:
            out, sums = out
            extra = PEN * sums["sq"]
        ce = jnp.mean(jax.vmap(lambda y, tg: jax_loss({"head": head}, y, tg))(
            out, jnp.asarray(t["targets"])))
        return ce + extra, out

    (loss, out), grads = jax.value_and_grad(total, argnums=(0, 1, 2),
                                            has_aux=True)(
        jnp.asarray(t["w"]), jnp.asarray(t["head"]), jnp.asarray(t["x"]))
    assert M == out.shape[0]
    return float(loss), *(np.asarray(g) for g in grads), np.asarray(out)


# -- the port's side -----------------------------------------------------------

def port_stage(stage, x):
    for w in stage:
        x = torch.tanh(x @ w)
    return x


def port_stage_pen(stage, x):
    y = port_stage(stage, x)
    return y, PEN * (y * y).mean()


def port_stage_aux(stage, x):
    y = port_stage(stage, x)
    return y, {"sq": (y * y).mean()}


def port_loss(loss_params, y, target):
    return ((y @ loss_params[0] - target) ** 2).mean()


def port_1f1b_run(t, S, aux):
    w = torch.from_numpy(t["w"]).requires_grad_()
    head = torch.from_numpy(t["head"]).requires_grad_()
    loss, gs, gl, gx = pl.pipeline_1f1b(
        port_stage_pen if aux else port_stage, pl.split_stages(w, S),
        torch.from_numpy(t["x"]), port_loss, [head],
        torch.from_numpy(t["targets"]), pl.Lockstep(S), stage_aux=aux)
    return (float(loss), torch.cat([g[0] for g in gs]).numpy(),
            gl[0].numpy(), gx.numpy())


def port_gpipe_run(t, S, aux):
    w = torch.from_numpy(t["w"]).requires_grad_()
    head = torch.from_numpy(t["head"]).requires_grad_()
    x = torch.from_numpy(t["x"]).requires_grad_()
    targets = torch.from_numpy(t["targets"])
    out = pl.gpipe(port_stage_aux if aux else port_stage,
                   pl.split_stages(w, S), x, pl.Lockstep(S), stage_aux=aux)
    extra = 0.0
    if aux:
        out, sums = out
        extra = PEN * sums["sq"]
    M = x.shape[0]
    loss = sum(port_loss([head], out[m], targets[m]) for m in range(M)) / M
    loss = loss + extra
    loss.backward()
    return (float(loss.detach()), w.grad.numpy(), head.grad.numpy(),
            x.grad.numpy(),
            out.detach().numpy())


def close(got, want, what):
    np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                               err_msg=what)


CASES = [(S, M, aux) for S in (2, 3) for M in (1, 2, 5)
         for aux in (False, True)]


@pytest.mark.parametrize("S,M,aux", CASES,
                         ids=[f"S{S}-M{M}-{'aux' if a else 'plain'}"
                              for S, M, a in CASES])
def test_1f1b_matches_jax(S, M, aux):
    t = toy(M)
    want = jax_1f1b_run(t, S, aux)
    got = port_1f1b_run(t, S, aux)
    assert abs(got[0] - want[0]) <= LOSS_RTOL * abs(want[0])
    for g, w, what in zip(got[1:], want[1:], ("stage", "head", "input")):
        close(g, w, what)


@pytest.mark.parametrize("S,M,aux", CASES,
                         ids=[f"S{S}-M{M}-{'aux' if a else 'plain'}"
                              for S, M, a in CASES])
def test_gpipe_matches_jax(S, M, aux):
    t = toy(M)
    want = jax_gpipe_run(t, S, aux)
    got = port_gpipe_run(t, S, aux)
    assert abs(got[0] - want[0]) <= LOSS_RTOL * abs(want[0])
    for g, w, what in zip(got[1:], want[1:],
                          ("stage", "head", "input", "outputs")):
        close(g, w, what)


def test_one_stage_is_gradient_accumulation():
    t = toy(4)
    want = jax_1f1b_run(t, 1, True)
    got = port_1f1b_run(t, 1, True)
    assert abs(got[0] - want[0]) <= LOSS_RTOL * abs(want[0])
    for g, w in zip(got[1:], want[1:]):
        close(g, w, "S1")


def test_split_stages():
    w = torch.arange(12.0).reshape(6, 2)
    parts = pl.split_stages(w, 3)
    assert [p.tolist() for p in parts] == [w[:2].tolist(), w[2:4].tolist(),
                                           w[4:].tolist()]
    assert pl.split_stages(list("abcdef"), 2) == [list("abc"), list("def")]
    assert pl.split_stages({"a": [1, 2], "b": [3, 4]}, 2) == [
        {"a": [1], "b": [3]}, {"a": [2], "b": [4]}]
    with pytest.raises(ValueError, match="not divisible"):
        pl.split_stages([1, 2, 3], 2)
    # A Llama's layers keep their global names in their stage.
    cfg = tllama.LlamaConfig.tiny(n_layers=4)
    model = tllama.Llama(cfg, "meta")
    names = {id(p): n for n, p in model.named_parameters()}
    stage = pl.split_stages(model.layers, 2)[1]
    assert [names[id(p)] for p in pl.stage_parameters(stage)
            if names[id(p)].endswith(".wq")] == []      # no grad: none
    model.requires_grad_(True)
    assert [names[id(p)] for p in pl.stage_parameters(stage)
            if names[id(p)].endswith(".wq")] == ["layers.2.wq",
                                                 "layers.3.wq"]


@pytest.mark.parametrize("S", [1, 3])
def test_each_stage_runs_m_forwards_and_m_backwards(S):
    M = 5
    t = toy(M)
    calls = {}

    def counting(stage, x):
        key = (id(stage), torch.is_grad_enabled())
        calls[key] = calls.get(key, 0) + 1
        return port_stage(stage, x)

    w = torch.from_numpy(t["w"]).requires_grad_()
    head = torch.from_numpy(t["head"]).requires_grad_()
    stages = pl.split_stages(w, S)
    pl.pipeline_1f1b(counting, stages, torch.from_numpy(t["x"]), port_loss,
                     [head], torch.from_numpy(t["targets"]), pl.Lockstep(S))
    if S == 1:      # plain accumulation: one differentiated call each
        assert calls == {(id(stages[0]), True): M}
    else:
        assert calls == {(id(st), grad): M for st in stages
                         for grad in (False, True)}


@pytest.mark.parametrize("S", [2, 3])
def test_group_stages_equal_virtual_stages_bit_for_bit(S, tmp_path):
    t = toy(5)
    src = tmp_path / "toy.pkl"
    with open(src, "wb") as fh:
        pickle.dump(t, fh)
    out = str(tmp_path / "pipe.pt")
    run_ranks(S, "pipeline", out, str(S), str(src))
    got = torch.load(out, weights_only=False)
    local = got["lockstep"]
    for name in ("1f1b", "1f1b_pen"):
        for rank, res in enumerate(got["group"]):
            loss, stage_grads, loss_grads, input_grads = res[name]
            assert torch.equal(loss, local[name][0]), (name, rank)
            for a, b in zip(stage_grads[0], local[name][1][rank]):
                assert torch.equal(a, b), (name, rank)
            if rank == S - 1:
                assert torch.equal(loss_grads[0], local[name][2][0])
            else:
                assert loss_grads is None
            if rank == 0:
                assert torch.equal(input_grads, local[name][3])
            else:
                assert input_grads is None
    w_grads = local["gpipe"][1]     # one a stage
    for rank, res in enumerate(got["group"]):
        loss, grads, head, x, out_ = res["gpipe"]
        assert torch.equal(loss, local["gpipe"][0])
        assert torch.equal(out_, local["gpipe"][4])
        assert torch.equal(head, local["gpipe"][2])
        assert torch.equal(x, local["gpipe"][3])
        (grad,) = grads
        assert torch.equal(grad, w_grads[rank]), rank
