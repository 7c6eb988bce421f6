"""Port parity: the one-program fits (``workloads/trainer.py``'s
``train_scan_dist``, ``OneProgram`` and the device-side clip, and
``workloads/mnist_dist.py``'s default scan fit) against the JAX package's
``train_scan_dist`` on the CPU, where the fit runs eagerly step by step
(on the card it is one CUDA graph: ``chip_smoke.py`` phase 24).

- One process: ``train_scan_dist`` at 30 steps, global batch 100 over
  1024 examples drawn by threefry on the device, eval over 256, lr 5e-3,
  against the reference's on a one-device mesh: the last loss within
  ``STEP_LOSS_ATOL``, the parameters within ``PARAM_ATOL`` (the gang
  tests' limits) and the accuracy equal.
- Two gloo ranks (``mnist_dist.run_worker``, the default fit): the same
  against the reference on a two-device mesh; both ranks' parameters
  bit-equal; one ``all_reduce`` of n_params + 1 floats a step, then one
  of 2 (the eval's counts).
- ``mnist_dist.main``: the default fit prints the reference's lines and
  beats and traces as the reference's ``_timed`` does; ``--step-loop``
  trains as the step loop always has (its losses equal a hand-driven
  ``make_dist_step`` loop over the host-staged columns).
- The clip: the device-side select leaves every gradient bit-equal to the
  host branch it replaced, clipped or not.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.models import mnist as jm
from kubeflow_controller_tpu.parallel import AXIS_DATA, MeshSpec, build_mesh
from kubeflow_controller_tpu.workloads import data as jdata
from kubeflow_controller_tpu.workloads import trainer as jtrainer
from kubeflow_controller_tpu_torch.models import mnist as tm
from kubeflow_controller_tpu_torch.obs import trace as ttrace
from kubeflow_controller_tpu_torch.workloads import data as tdata
from kubeflow_controller_tpu_torch.workloads import mnist_dist, trainer

from _torch_ranks import free_port, gang_env

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
STEP_LOSS_ATOL = 1e-4
PARAM_ATOL = 5e-5
LR = 5e-3
STEPS, BATCH, TRAIN, EVAL = 30, 100, 1024, 256
ARGV = ["--device", "cpu", "--steps", str(STEPS), "--batch-size",
        str(BATCH), "--train-size", str(TRAIN), "--eval-size", str(EVAL),
        "--lr", str(LR)]


def jax_scan_fit(dp: int):
    """The reference's scan fit (its ``_fit_scan`` bodies) over a dp-way
    mesh of CPU devices, built explicitly: params, last loss, accuracy."""
    mesh = build_mesh(MeshSpec(dp=dp, fsdp=1), devices=jax.devices()[:dp])
    opt = jtrainer.default_optimizer(LR)
    params = jm.mlp_init(0)
    opt_state = jtrainer.numpy_opt_state(opt, params)
    means = jdata.mnist_teacher_means()
    spe, local_bs, eval_local = TRAIN // BATCH, BATCH // dp, EVAL // dp

    def local_batches(i):
        x, y = jdata.synthetic_mnist_traced(1, spe * BATCH, means)
        x = x.reshape(spe, BATCH, jm.IMAGE_PIXELS)
        y = y.reshape(spe, BATCH)
        return (jax.lax.dynamic_slice_in_dim(x, i * local_bs, local_bs, 1),
                jax.lax.dynamic_slice_in_dim(y, i * local_bs, local_bs, 1))

    def eval_counts(p, i):
        import jax.numpy as jnp

        ex, ey = jdata.synthetic_mnist_traced(2, dp * eval_local, means)
        ex = jax.lax.dynamic_slice_in_dim(ex, i * eval_local, eval_local, 0)
        ey = jax.lax.dynamic_slice_in_dim(ey, i * eval_local, eval_local, 0)
        correct = jnp.sum(jnp.argmax(jm.mlp_apply(p, ex), axis=-1) == ey)
        return correct, jnp.asarray(eval_local, jnp.float32)

    params, _, loss, acc = jtrainer.train_scan_dist(
        lambda p, b: jm.mlp_loss(p, b[0], b[1]), opt, params, opt_state,
        STEPS, mesh, AXIS_DATA, local_batches, eval_counts,
        examples_per_step=BATCH)
    return jax.tree.map(np.asarray, params), float(loss), float(acc)


@pytest.fixture(scope="module")
def jax_one_device():
    return jax_scan_fit(1)


def port_scan_fit():
    """``trainer.train_scan_dist`` on one process, the bodies of
    ``mnist_dist``'s scan fit."""
    model = tm.MnistMLP(tm.mlp_init(0), "cpu")
    opt = trainer.default_optimizer(model.parameters(), LR)
    means = torch.from_numpy(np.array(tdata.mnist_teacher_means()))
    spe = TRAIN // BATCH

    def local_batches(i):
        assert i == 0
        x, y = tdata.synthetic_mnist_traced(1, spe * BATCH, means, "cpu")
        return x.reshape(spe, BATCH, -1), y.reshape(spe, BATCH)

    def eval_counts(i):
        ex, ey = tdata.synthetic_mnist_traced(2, EVAL, means, "cpu")
        with torch.no_grad():
            return (model(ex).argmax(-1) == ey).sum(), EVAL

    out = trainer.train_scan_dist(lambda a, b: tm.mlp_loss(model, a, b), opt,
                                  STEPS, local_batches, eval_counts,
                                  aot_cache="/unused", examples_per_step=BATCH)
    return model, opt, out


def test_one_process_matches_the_reference_scan(jax_one_device):
    want_params, want_loss, want_acc = jax_one_device
    model, opt, out = port_scan_fit()
    assert out.losses.shape == (STEPS,) and out.loss == out.losses[-1]
    assert abs(float(out.loss) - want_loss) <= STEP_LOSS_ATOL
    assert float(out.metric) == want_acc
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_params[k], rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    # exactly `steps` updates
    assert all(int(s["step"]) == STEPS for s in opt.inner.state.values())


def test_scan_fit_beats_traces_and_counts_as_the_reference(monkeypatch):
    beats, keepalive = [], []

    class Recorder:
        def beat(self, **kw):
            beats.append(kw)

        def start_keepalive(self, *a):
            keepalive.append("start")

        def stop_keepalive(self):
            keepalive.append("stop")

    monkeypatch.setattr(trainer, "reporter", lambda: Recorder())
    steps_total = trainer.REGISTRY.counter("kctpu_trainer_steps_total",
                                           "Training steps completed")
    before = steps_total.value
    with ttrace.TRACER.context(ttrace.TraceContext("t-scan", "root")):
        _, _, out = port_scan_fit()
    (sp,) = [s for s in ttrace.TRACER.spans(prefix="trainer/fit")
             if s.trace_id == "t-scan"]
    assert sp.args == {"steps": STEPS, "aot_cache": "off", "process": 0}
    # On the CPU nothing is captured: no compile span.
    assert not [s for s in ttrace.TRACER.spans(prefix="workload/compile")
                if s.trace_id == "t-scan"]
    assert beats[0] == {"phase": "fit", "compile_source": ""}
    last = beats[-1]
    assert last["step"] == STEPS and last["phase"] == "fit"
    assert last["loss"] == float(out.loss) and last["examples_per_sec"] > 0
    assert keepalive == ["start", "stop"]
    assert steps_total.value - before == STEPS


RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from kubeflow_controller_tpu_torch.workloads import mnist_dist
sizes = []
_all_reduce = dist.all_reduce
def counting(tensor, *args, **kwargs):
    sizes.append(tensor.numel())
    return _all_reduce(tensor, *args, **kwargs)
dist.all_reduce = counting
res = mnist_dist.run_worker(mnist_dist.parse_args(sys.argv[2:]))
np.savez(sys.argv[1], losses=res.losses.numpy(), sizes=np.array(sizes),
         loss=res.loss, acc=res.accuracy, dp=res.dp,
         **{k: v.detach().numpy() for k, v in res.model.state_dict().items()})
"""


def test_two_gloo_ranks_match_the_reference_dp2_scan(tmp_path):
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(tmp_path / f"r{r}.npz"), *ARGV],
        env=gang_env(2, r, port), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    ranks = [dict(np.load(tmp_path / f"r{r}.npz")) for r in range(2)]
    want_params, want_loss, want_acc = jax_scan_fit(2)
    n_params = sum(v.size for v in want_params.values())
    for r in ranks:
        assert int(r["dp"]) == 2
        assert r["sizes"].tolist() == [n_params + 1] * STEPS + [2]
        assert abs(float(r["loss"]) - want_loss) <= STEP_LOSS_ATOL
        assert float(r["acc"]) == want_acc
    for k in want_params:
        assert ranks[0][k].tobytes() == ranks[1][k].tobytes(), k
        np.testing.assert_allclose(ranks[0][k], want_params[k], rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    np.testing.assert_array_equal(ranks[0]["losses"], ranks[1]["losses"])


@pytest.fixture
def no_gang_env(monkeypatch):
    for name in list(os.environ):
        if name.startswith(("KCTPU_", "WORKLOAD_")) or name in (
                "MODEL_DIR", "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID"):
            monkeypatch.delenv(name)


def test_main_runs_the_scan_fit_by_default(no_gang_env, capsys,
                                           jax_one_device):
    _, want_loss, want_acc = jax_one_device
    assert mnist_dist.main(ARGV) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0].startswith("Worker 0/1 on cpu")
    assert lines[1].startswith("Phase times: rendezvous=")
    assert lines[2].startswith("Training elapsed time: ")
    loss, acc = lines[3].removeprefix("Final loss: ").split(
        "; eval accuracy: ")
    assert abs(float(loss) - want_loss) <= STEP_LOSS_ATOL
    assert float(acc) == pytest.approx(want_acc, abs=1e-6)
    # The fit's span holds the scan, not the step loop's stage.
    fits = [s for s in ttrace.TRACER.spans(prefix="workload/fit")]
    assert "step_loop" not in fits[-1].args


def test_step_loop_flag_keeps_the_step_loop(no_gang_env, monkeypatch):
    """``--step-loop`` (and ``$WORKLOAD_STEP_LOOP``) trains on the
    host-staged columns through ``make_dist_step``, one step at a time, as
    the port's only fit did before the scan fit."""
    res = mnist_dist.run_worker(mnist_dist.parse_args(ARGV + ["--step-loop"]))
    x_np, y_np = tdata.synthetic_mnist_np(1, TRAIN)
    spe = TRAIN // BATCH
    idx = (np.arange(spe)[:, None] * BATCH + np.arange(BATCH)[None, :]) \
        % TRAIN
    model = tm.MnistMLP(tm.mlp_init(0), "cpu")
    opt = trainer.default_optimizer(model.parameters(), LR)
    step = trainer.make_dist_step(lambda a, b: tm.mlp_loss(model, a, b), opt)
    xs, ys = torch.from_numpy(x_np[idx]), torch.from_numpy(y_np[idx])
    want = torch.stack([step(xs, ys, t) for t in range(STEPS)])
    assert res.losses.tolist() == want.tolist()
    for a, b in zip(res.model.parameters(), model.parameters()):
        assert torch.equal(a, b)
    assert not mnist_dist.parse_args(ARGV).step_loop
    monkeypatch.setenv("WORKLOAD_STEP_LOOP", "1")
    assert mnist_dist.parse_args(ARGV).step_loop


@pytest.mark.parametrize("scale", [0.01, 1.0, 100.0],
                         ids=["under", "at", "over"])
def test_device_side_clip_is_the_host_branch(scale):
    """``Optimizer.step``'s select gives each gradient the bits the host
    branch ``if norm >= clip: g.div_(norm).mul_(clip)`` gave."""
    gen = torch.Generator().manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(n, generator=gen))
              for n in (7, 33, 1)]
    grads = [torch.randn(p.shape, generator=gen) * scale for p in params]
    for p, g in zip(params, grads):
        p.grad = g.clone()
    opt = trainer.Optimizer(params, lambda ps: torch.optim.SGD(ps, lr=0.0),
                            clip=1.0)
    if scale == 1.0:        # the norm lands on the clip exactly
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        for p, g in zip(params, grads):
            g.div_(norm)
            p.grad = g.clone()
    opt.step()
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    for p, g in zip(params, grads):
        want = g.clone()
        if norm >= 1.0:
            want.div_(norm.to(g.dtype)).mul_(1.0)
        assert torch.equal(p.grad, want)
