"""Port parity: the vision models and TFJobs of
``kubeflow_controller_tpu_torch`` (``models/vision.py``,
``bridge.vision_params_from_jax``, ``workloads/data.py``'s image sets,
``trainer.sgd``/``adam``, ``workloads/flax_mnist.py`` and
``workloads/cifar_allreduce.py``) against the JAX package on the CPU.

- The CNN, ResNet-18 and ResNet-50 (width 8; 28x28x1 and 32x32x3 inputs)
  from one flax ``vision_init``, every BatchNorm scale, bias and running
  statistic redrawn from a numpy seed so that no path hides behind a zero:
  logits, the training loss and the new ``batch_stats`` match flax's in
  f32 within ``REL_TOL``, and every gradient matches flax's in f64 (both
  from the same f32 values; see ``port_errors``) within ``GRAD_TOL``.  Two
  controls must fail the same check: torch's (1, 1) padding in place of
  flax's SAME, and the unbiased batch variance.
- ``synthetic_cifar`` and ``synthetic_mnist_images`` are byte-identical.
- Two steps of ``sgd`` equal ``optax.sgd(momentum=0.9)``, and of ``adam``
  ``optax.adam``.
- Two gloo ranks of ``cifar_allreduce --model resnet18 --width 8``, from
  the reference's init (bridged), track the reference's global-batch run
  (rank 0's and rank 1's rows concatenated, JAX's ``train_scan_stateful``), and two of ``flax_mnist`` its
  single-process run: every step's loss within ``STEP_LOSS_ATOL``.  Each
  ResNet step makes 2 x 20 + 1 collectives.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_controller_tpu.models import vision as jv
from kubeflow_controller_tpu.workloads import data as jdata
from kubeflow_controller_tpu.workloads import trainer as jtrainer
from kubeflow_controller_tpu_torch import bridge
from kubeflow_controller_tpu_torch.models import vision as tv
from kubeflow_controller_tpu_torch.workloads import data as tdata
from kubeflow_controller_tpu_torch.workloads import trainer as ttrainer

from _torch_ranks import free_port

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# f32 logits, loss and statistics, relative: summation order only
# (measured 4.9e-6 on ResNet-18); ResNet-50's 53 BatchNorms over a batch of
# 6 amplify the rounding (measured 6.8e-5 on its logits).
REL_TOL = {"cnn": 1e-5, "resnet18": 1e-5, "resnet50": 2e-4}
# f64 gradients, relative; both losses are taken in f32 from f64 logits,
# as both packages cast the logits (measured 4.0e-8).
GRAD_TOL = 2e-7
STEP_LOSS_ATOL = 1e-4   # as the dist-mnist gang's
BATCH = 6

MODELS = {
    "cnn": (lambda: jv.FlaxMNISTCNN(),
            lambda: tv.FlaxMNISTCNN(device="cpu"), (28, 28, 1)),
    "resnet18": (lambda: jv.resnet18(width=8),
                 lambda: tv.resnet18(width=8, device="cpu"), (32, 32, 3)),
    "resnet50": (lambda: jv.resnet50(width=8),
                 lambda: tv.resnet50(width=8, device="cpu"), (32, 32, 3)),
}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def redraw_bn(variables, seed=0):
    """Every BatchNorm scale and bias redrawn around 1 and 0, the running
    means around 0 and the variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        a = np.asarray(a)
        if name == "scale":
            return 1.0 + 0.3 * rng.standard_normal(a.shape).astype(a.dtype)
        if name == "mean" or (name == "bias" and a.ndim == 1
                              and path[-2].key.startswith("BatchNorm")):
            return 0.2 * rng.standard_normal(a.shape).astype(a.dtype)
        if name == "var":
            return (0.5 + rng.random(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(leaf, variables)


def flax_side(name):
    """flax's logits, loss and new statistics in f32, and its gradients in
    f64 (under ``jax.enable_x64``, from the same f32 values)."""
    make_j, _, shape = MODELS[name]
    model = make_j()
    variables = redraw_bn(np_tree(jv.vision_init(
        model, jax.random.PRNGKey(0), shape)))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((BATCH, *shape)).astype(np.float32)
    y = rng.integers(0, 10, BATCH)
    loss, mut = jv.vision_loss(model, variables, x, y)
    kw = {"mutable": ["batch_stats"]} if "batch_stats" in variables else {}
    logits = model.apply(variables, x, **kw)
    logits = logits[0] if kw else logits
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)

        def loss64(p):
            return jv.vision_loss(model, {**v64, "params": p},
                                  x.astype(np.float64), y)[0]

        grads = np_tree(jax.grad(loss64)(v64["params"]))
    return (variables, x, y, float(loss), np.asarray(logits),
            np_tree(mut.get("batch_stats", {})), grads)


def rel(a, b):
    a = torch.as_tensor(a).detach().double()
    b = torch.as_tensor(np.array(b)).double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def port_errors(name, flax):
    """{what: relative error} of the port against ``flax``'s outputs: the
    logits, the loss and the new statistics of the f32 model, and every
    gradient of the same model in f64 against flax's in f64.  (In f32 a
    ReLU input within rounding of 0 flips its mask in one computation and
    not in the other: one such element in ResNet-18's first stage moves
    that stage's gradients by 1e-2 in either package against its own
    f64 result.)"""
    variables, x, y, loss, logits, stats, grads = flax
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    errs = {}
    for dtype in (torch.float32, torch.float64):
        model = MODELS[name][1]().to(dtype)
        model.load_state_dict(bridge.vision_params_from_jax(variables))
        got_loss, got_stats = tv.vision_loss(model, xt.to(dtype), yt)
        if dtype == torch.float32:
            model.load_state_dict(bridge.vision_params_from_jax(variables))
            with torch.no_grad():
                errs["logits"] = rel(model(xt, train=True), logits)
            errs["loss"] = abs(got_loss.item() - loss) / abs(loss)
            for k, v in bridge.vision_params_from_jax(
                    {"batch_stats": stats}).items():
                errs[f"stats/{k}"] = rel(got_stats[k], v)
            continue
        got_loss.backward()
        params = dict(model.named_parameters())
        for k, v in bridge.vision_params_from_jax({"params": grads}).items():
            errs[f"grad/{k}"] = rel(params[k].grad, v)
    return errs


@pytest.fixture(scope="module")
def flax_outputs():
    return {}


def outputs_for(cache, name):
    if name not in cache:
        cache[name] = flax_side(name)
    return cache[name]


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_flax(name, flax_outputs):
    errs = port_errors(name, outputs_for(flax_outputs, name))
    n_params = len(jax.tree.leaves(outputs_for(flax_outputs, name)[6]))
    assert sum(k.startswith("grad/") for k in errs) == n_params
    for what, tol in (("grad/", GRAD_TOL), ("", REL_TOL[name])):
        part = {k: v for k, v in errs.items()
                if k.startswith("grad/") == (what == "grad/")}
        worst = max(part, key=part.get)
        assert part[worst] <= tol, (worst, part[worst])


def torch_padding(n, k, s):
    return k // 2, k // 2


def unbiased_moments(stats, c):
    mean, var = BIASED(stats, c)
    n = stats[-1]
    return mean, var * n / (n - 1)


BIASED = tv.moments


@pytest.mark.parametrize("control", ["padding-1-1", "unbiased-variance"])
def test_controls_fail_the_check(control, monkeypatch, flax_outputs):
    if control == "padding-1-1":
        monkeypatch.setattr(tv, "same_padding", torch_padding)
    else:
        monkeypatch.setattr(tv, "moments", unbiased_moments)
    errs = port_errors("resnet18", outputs_for(flax_outputs, "resnet18"))
    assert max(errs.values()) > 100 * REL_TOL["resnet18"], max(errs.values())


def test_same_padding_is_flax_s():
    assert tv.same_padding(32, 3, 2) == (0, 1)
    assert tv.same_padding(32, 3, 1) == (1, 1)
    assert tv.same_padding(32, 1, 2) == (0, 0)
    assert tv.same_padding(7, 3, 2) == (1, 1)


@pytest.mark.parametrize("seed", [1, 1000, 2])
def test_image_sets_are_byte_identical(seed):
    for name in ("synthetic_cifar", "synthetic_mnist_images"):
        jx, jy = getattr(jdata, name)(seed, 40)
        tx, ty = getattr(tdata, name)(seed, 40, "cpu")
        assert tx.numpy().tobytes() == np.asarray(jx).tobytes(), name
        assert ty.dtype == torch.int64
        assert ty.numpy().tolist() == np.asarray(jy).tolist(), name


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_optimizer_steps_match_optax(name):
    rng = np.random.default_rng(3)
    p0 = {"a": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal((3,)).astype(np.float32)}
    g = [{k: rng.standard_normal(v.shape).astype(np.float32)
          for k, v in p0.items()} for _ in range(3)]
    opt = (optax.sgd(0.05, momentum=0.9) if name == "sgd"
           else optax.adam(2e-3))
    params, state = jax.tree.map(jnp.asarray, p0), None
    state = opt.init(params)
    for gi in g:
        upd, state = opt.update(jax.tree.map(jnp.asarray, gi), state, params)
        params = optax.apply_updates(params, upd)
    tparams = [torch.nn.Parameter(torch.from_numpy(p0[k].copy()))
               for k in ("a", "b")]
    topt = (ttrainer.sgd(tparams, 0.05) if name == "sgd"
            else ttrainer.adam(tparams, 2e-3))
    for gi in g:
        for p, k in zip(tparams, ("a", "b")):
            p.grad = torch.from_numpy(gi[k])
        topt.step()
    for p, k in zip(tparams, ("a", "b")):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                   rtol=1e-6, atol=1e-7)


# --- two gloo ranks against the reference's global batch --------------------

RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from kubeflow_controller_tpu_torch.models import vision
from kubeflow_controller_tpu_torch.workloads import cifar_allreduce, flax_mnist
# Start from the reference's init, bridged (the port draws its own).
init = {k: torch.from_numpy(v) for k, v in np.load(sys.argv[3]).items()}
vision.vision_init = lambda model, gen: (model.load_state_dict(init), model)[1]
module = {"cifar_allreduce": cifar_allreduce, "flax_mnist": flax_mnist}
calls = []
_all_reduce = dist.all_reduce
def counting(tensor, *args, **kwargs):
    calls.append(tensor.numel())
    return _all_reduce(tensor, *args, **kwargs)
dist.all_reduce = counting
mod = module[sys.argv[2]]
res = mod.run(mod.parse_args(sys.argv[4:]))
np.savez(sys.argv[1], losses=res.losses.numpy(), calls=np.array(calls),
         processes=res.processes, batch=res.batch_size,
         accuracy=res.accuracy)
"""


def run_gloo_gang(tmp_path, module, variables, argv, n=2):
    init = tmp_path / "init.npz"
    np.savez(init, **{k: v.numpy() for k, v in
                      bridge.vision_params_from_jax(np_tree(variables)).items()})
    coord = f"127.0.0.1:{free_port()}"
    procs = []
    for rank in range(n):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("KCTPU_", "JAX_COORDINATOR",
                                    "JAX_NUM_PROC", "JAX_PROCESS"))}
        env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                   JAX_COORDINATOR_ADDRESS=coord, JAX_NUM_PROCESSES=str(n),
                   JAX_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK, str(tmp_path / f"rank{rank}.npz"),
             module, str(init), "--device", "cpu", *argv], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(n)]


def jax_per_step(loss_fn, opt, params, state, xb, yb, stateful):
    """The reference's scan one step per call, so that every step's loss
    is read: ``train_scan_stateful`` (or ``train_scan``) on batch t."""
    losses = []
    opt_state = opt.init(params)
    for t in range(xb.shape[0]):
        batch = (xb[t:t + 1], yb[t:t + 1])
        if stateful:
            params, state, opt_state, loss = jtrainer.train_scan_stateful(
                loss_fn, opt, params, opt_state, state, batch)
        else:
            params, opt_state, loss = jtrainer.train_scan(
                loss_fn, opt, params, opt_state, batch)
        losses.append(float(loss))
    return np.array(losses)


CIFAR = {"steps": 4, "batch": 16, "train": 64, "lr": 0.05}


def test_cifar_allreduce_two_ranks_track_the_global_batch(tmp_path):
    model = jv.resnet18(width=8)
    variables = jv.vision_init(model, jax.random.PRNGKey(0), (32, 32, 3))
    ranks = run_gloo_gang(tmp_path, "cifar_allreduce", variables, [
        "--model", "resnet18", "--width", "8", "--steps",
        str(CIFAR["steps"]), "--batch-size", str(CIFAR["batch"]),
        "--train-size", str(CIFAR["train"]), "--eval-size", "32",
        "--lr", str(CIFAR["lr"])])
    steps, bs, n = CIFAR["steps"], CIFAR["batch"], 2
    # The reference on the global batch: rank 0's rows, then rank 1's.
    parts = [jtrainer.batch_stack(*jdata.synthetic_cifar(1000 + r,
                                                          CIFAR["train"]),
                                  steps, bs // n) for r in range(n)]
    xb = jnp.concatenate([p[0] for p in parts], axis=1)
    yb = jnp.concatenate([p[1] for p in parts], axis=1)

    def loss_fn(p, batch, stats):
        loss, mut = jv.vision_loss(model, {"params": p, "batch_stats": stats},
                                   batch[0], batch[1])
        return loss, mut["batch_stats"]

    want = jax_per_step(loss_fn, optax.sgd(CIFAR["lr"], momentum=0.9),
                        variables["params"], variables["batch_stats"],
                        xb, yb, stateful=True)
    for r in ranks:
        assert int(r["processes"]) == n and int(r["batch"]) == bs
        assert len(r["calls"]) == steps * (2 * 20 + 1)
    np.testing.assert_array_equal(ranks[0]["losses"], ranks[1]["losses"])
    assert ranks[0]["accuracy"] == ranks[1]["accuracy"]
    np.testing.assert_allclose(ranks[0]["losses"], want, rtol=0,
                               atol=STEP_LOSS_ATOL)


def test_flax_mnist_two_ranks_track_the_single_process_run(tmp_path):
    steps, bs, lr = 5, 32, 2e-3
    model = jv.FlaxMNISTCNN()
    variables = jv.vision_init(model, jax.random.PRNGKey(0), (28, 28, 1))
    ranks = run_gloo_gang(tmp_path, "flax_mnist", variables, [
        "--steps", str(steps), "--batch-size", str(bs), "--train-size",
        "256", "--eval-size", "64", "--lr", str(lr)])
    xb, yb = jtrainer.batch_stack(*jdata.synthetic_mnist_images(1, 256),
                                  steps, bs)
    want = jax_per_step(
        lambda p, b: jv.vision_loss(model, {"params": p}, b[0], b[1])[0],
        optax.adam(lr), variables["params"], None, xb, yb, stateful=False)
    for r in ranks:
        assert len(r["calls"]) == steps          # one flat all_reduce a step
    np.testing.assert_array_equal(ranks[0]["losses"], ranks[1]["losses"])
    np.testing.assert_allclose(ranks[0]["losses"], want, rtol=0,
                               atol=STEP_LOSS_ATOL)
