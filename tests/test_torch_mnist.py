"""Port parity: the MNIST models, data and local loop of
``kubeflow_controller_tpu_torch`` (``models/mnist.py``,
``workloads/{data,trainer,mnist_local}.py``, ``bridge.mnist_params_from_jax``)
against the JAX package.

- ``mlp_init``, ``softmax_init``, the teacher templates and
  ``synthetic_mnist_np`` are byte-identical to the reference's.
- ``mlp_loss`` and every gradient against ``jax.value_and_grad`` of the
  reference's, MLP and softmax, from one bridged (perturbed) init.
  Tolerance: loss within 1e-6 relative (measured <= 7.5e-8), each
  gradient within 1e-5 of its max |grad| (measured <= 5.1e-7).
- 30 local steps (batch 64 over 512 examples) from one bridged init
  against the reference's ``make_train_step`` loop over ``batch_stack``:
  each step's loss within 1e-4 absolute (measured <= 6.7e-6) and the final
  parameters within 5e-5 (measured <= 1.7e-6).  Both sides are f32 with
  clip 1.0 + Adam; only the summation order differs.
- ``mnist_local.main`` on the CPU: the sign-off lines, the accuracy target
  (exit 1), and the final save into ``MODEL_DIR``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.models import mnist as jm
from kubeflow_controller_tpu.workloads import data as jdata
from kubeflow_controller_tpu.workloads import trainer as jtrainer
from kubeflow_controller_tpu_torch import bridge
from kubeflow_controller_tpu_torch.models import mnist as tm
from kubeflow_controller_tpu_torch.workloads import data as tdata
from kubeflow_controller_tpu_torch.workloads import mnist_local
from kubeflow_controller_tpu_torch.workloads import trainer as ttrainer

torch.set_num_threads(2)

LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
STEP_LOSS_ATOL = 1e-4
STEP_PARAM_ATOL = 5e-5
LR = 5e-3

MODELS = {
    "mlp": (lambda: jm.mlp_init(0), jm.mlp_apply, tm.MnistMLP),
    "softmax": (lambda: jax.tree.map(np.asarray, jm.softmax_init(
        jax.random.PRNGKey(0))), jm.softmax_apply, tm.MnistSoftmax),
}


def test_inits_are_byte_identical():
    for seed in (0, 1, 7):
        for cfg in (jm.MLPConfig(), jm.MLPConfig(hidden=32)):
            want = jm.mlp_init(seed, cfg)
            got = tm.mlp_init(seed, tm.MLPConfig(hidden=cfg.hidden))
            assert list(got) == list(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert got[k].tobytes() == want[k].tobytes(), (seed, k)
    want = jm.softmax_init(jax.random.PRNGKey(0))
    got = tm.softmax_init(0)
    for k in want:
        assert got[k].tobytes() == np.asarray(want[k]).tobytes()


@pytest.mark.parametrize("seed,n", [(1, 512), (2, 256), (1, 8192), (5, 1)])
def test_synthetic_mnist_is_byte_identical(seed, n):
    assert (tdata.mnist_teacher_means().tobytes()
            == jdata.mnist_teacher_means().tobytes())
    want_x, want_y = jdata.synthetic_mnist_np(seed, n)
    got_x, got_y = tdata.synthetic_mnist_np(seed, n)
    assert got_x.dtype == want_x.dtype and got_y.dtype == want_y.dtype
    assert got_x.tobytes() == want_x.tobytes()
    assert got_y.tobytes() == want_y.tobytes()
    assert not got_x.flags.writeable and not got_y.flags.writeable
    x, y = tdata.synthetic_mnist(seed, n, "cpu")
    assert x.dtype == torch.float32 and y.dtype == torch.int64
    np.testing.assert_array_equal(x.numpy(), want_x)
    np.testing.assert_array_equal(y.numpy(), want_y)


def test_constants_and_seeds_match():
    assert (tm.IMAGE_PIXELS, tm.NUM_CLASSES) == (jm.IMAGE_PIXELS,
                                                 jm.NUM_CLASSES)
    assert (tdata.IMAGE_PIXELS, tdata.NUM_CLASSES) == (jdata.IMAGE_PIXELS,
                                                       jdata.NUM_CLASSES)
    assert tdata._TEACHER_SEED == jdata._TEACHER_SEED
    with pytest.raises(TypeError, match="int"):
        tdata.synthetic_mnist_np(jax.random.PRNGKey(1), 4)


@pytest.mark.parametrize("name", list(MODELS))
def test_loss_and_grads_match_jax(name):
    init, apply_fn, module = MODELS[name]
    rng = np.random.default_rng(3)
    # Perturbed so that softmax's zero init has non-trivial gradients.
    params = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in init().items()}
    x, y = jdata.synthetic_mnist_np(1, 100)
    loss, grads = jax.value_and_grad(lambda p: jm.mlp_loss(
        p, jnp.asarray(x), jnp.asarray(y, jnp.int32), apply_fn=apply_fn))(
        jax.tree.map(jnp.asarray, params))
    model = module(bridge.mnist_params_from_jax(params), "cpu")
    got = tm.mlp_loss(model, *tdata.synthetic_mnist(1, 100, "cpu"))
    got.backward()
    assert abs(float(got.detach()) - float(loss)) <= LOSS_RTOL * abs(float(loss))
    for k, g in grads.items():
        g = np.asarray(g)
        err = np.max(np.abs(getattr(model, k).grad.numpy() - g))
        assert err <= GRAD_RTOL * np.max(np.abs(g)), (k, err)
    acc = float(tm.mlp_accuracy(model, *tdata.synthetic_mnist(2, 256, "cpu")))
    ex, ey = jdata.synthetic_mnist_np(2, 256)
    assert acc == float(jm.mlp_accuracy(jax.tree.map(jnp.asarray, params),
                                        jnp.asarray(ex), jnp.asarray(ey),
                                        apply_fn=apply_fn))


@pytest.mark.parametrize("name", list(MODELS))
def test_local_steps_match_jax_train_step_loop(name):
    init, apply_fn, module = MODELS[name]
    steps, bs, n = 30, 64, 512
    x, y = jdata.synthetic_mnist_np(1, n)
    opt = jtrainer.default_optimizer(LR)
    step = jtrainer.make_train_step(
        lambda p, b: jm.mlp_loss(p, b[0], b[1], apply_fn=apply_fn), opt)
    xs, ys = jtrainer.batch_stack(jnp.asarray(x), jnp.asarray(y, jnp.int32),
                                  steps, bs)
    params = jax.tree.map(jnp.asarray, init())
    state = opt.init(params)
    want = []
    for i in range(steps):
        params, state, loss = step(params, state, (xs[i], ys[i]))
        want.append(float(loss))

    model = module(bridge.mnist_params_from_jax(init()), "cpu")
    topt = ttrainer.default_optimizer(model.parameters(), LR)
    txs, tys = ttrainer.batch_stack(*tdata.synthetic_mnist(1, n, "cpu"),
                                    steps, bs)
    np.testing.assert_array_equal(txs.numpy(), np.asarray(xs))
    got = ttrainer.train_scan(lambda a, b: tm.mlp_loss(model, a, b), topt,
                              txs, tys)
    assert got.shape == (steps,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=STEP_LOSS_ATOL)
    for k, v in params.items():
        np.testing.assert_allclose(getattr(model, k).detach().numpy(),
                                   np.asarray(v), rtol=0,
                                   atol=STEP_PARAM_ATOL)


def test_module_rejects_wrong_params():
    with pytest.raises(KeyError, match="w1"):
        tm.MnistMLP(tm.softmax_init(0), "cpu")
    with pytest.raises(KeyError, match="MNIST"):
        bridge.mnist_params_from_jax({"w1": np.zeros(1)})


def run_local(capsys, *argv):
    rc = mnist_local.main(["--device", "cpu", "--steps", "20",
                           "--train-size", "512", "--eval-size", "256",
                           *argv])
    return rc, capsys.readouterr()


@pytest.mark.parametrize("model", ["mlp", "softmax"])
def test_mnist_local_main_on_the_cpu(capsys, monkeypatch, model):
    monkeypatch.delenv("MODEL_DIR", raising=False)
    rc, out = run_local(capsys, "--model", model)
    assert rc == 0
    assert "Training elapsed time:" in out.out
    loss = float(out.out.split("Final loss: ")[1].split(";")[0])
    acc = float(out.out.split("eval accuracy: ")[1])
    assert np.isfinite(loss) and 0.5 < acc <= 1.0


def test_mnist_local_target_accuracy_fails(capsys, monkeypatch):
    monkeypatch.delenv("MODEL_DIR", raising=False)
    rc, out = run_local(capsys, "--target-accuracy", "2.0")
    assert rc == 1 and "below target" in out.err


def test_mnist_local_saves_into_model_dir(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("MODEL_DIR", str(tmp_path / "model"))
    assert mnist_local.main(["--device", "cpu", "--steps", "3",
                             "--train-size", "128", "--eval-size",
                             "64"]) == 0
    assert (f"Checkpoint saved to {tmp_path / 'model'}"
            in capsys.readouterr().out)
    assert os.listdir(tmp_path / "model") == ["3"]


def test_local_result_matches_train_scan():
    res = mnist_local.train(steps=5, batch_size=32, train_size=128,
                            eval_size=64, device="cpu")
    assert res.losses.shape == (5,) and res.loss == float(res.losses[-1])
    assert 0.0 <= res.accuracy <= 1.0 and res.elapsed_s > 0
