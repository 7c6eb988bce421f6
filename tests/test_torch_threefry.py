"""Port parity: JAX's default PRNG on tensors
(``kubeflow_controller_tpu_torch/utils/threefry.py``) and the on-device
MNIST generator built on it (``workloads/data.py:synthetic_mnist_traced``)
against ``jax.random`` and the JAX package's generator, on the CPU.

- ``PRNGKey``, ``split``, 32-bit ``random_bits``, ``randint(., 0, 10)``
  and ``uniform`` are bit-equal to ``jax.random``'s for seeds 0, 1, 7 and
  2**31 - 1 at shapes (1,), (10,), (1000,) and (37, 784).
- ``normal`` runs XLA's single-precision erfinv (Giles' polynomial, its
  multiply-adds rounded once as XLA fuses them), but with torch's
  ``log1p`` where XLA has its own: it is held to ``NORMAL_ATOL`` (the
  largest difference measured here is 2.4e-7, under 1% of the draws
  differing at all).
- ``synthetic_mnist_traced(1, 8192, means)``: ``y`` equal, ``x`` within
  ``DATA_ATOL`` of the reference's jitted draw (measured 4.8e-7: the
  jitted program fuses further).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.workloads import data as jdata
from kubeflow_controller_tpu_torch.utils import threefry
from kubeflow_controller_tpu_torch.workloads import data as tdata

torch.set_num_threads(1)

SEEDS = [0, 1, 7, 2 ** 31 - 1]
SHAPES = [(1,), (10,), (1000,), (37, 784)]
NORMAL_ATOL = 1e-6
DATA_ATOL = 1e-6


def words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_are_jax_bits(seed):
    jkey = jax.random.PRNGKey(seed)
    key = threefry.prng_key(seed, "cpu")
    np.testing.assert_array_equal(key.numpy(), words(jkey))
    np.testing.assert_array_equal(threefry.split(key).numpy(),
                                  words(jax.random.split(jkey)))
    np.testing.assert_array_equal(threefry.split(key, 5).numpy(),
                                  words(jax.random.split(jkey, 5)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_randint_and_uniform_are_jax_bits(seed, shape):
    jkey = jax.random.PRNGKey(seed)
    key = threefry.prng_key(seed, "cpu")
    np.testing.assert_array_equal(
        threefry.random_bits(key, shape).numpy(),
        words(jax.random.bits(jkey, shape, jnp.uint32)))
    np.testing.assert_array_equal(
        threefry.randint(key, shape, 0, 10).numpy(),
        words(jax.random.randint(jkey, shape, 0, 10)))
    got = threefry.uniform(key, shape).numpy()
    want = np.asarray(jax.random.uniform(jkey, shape))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_its_stated_bound(seed, shape):
    got = threefry.normal(threefry.prng_key(seed, "cpu"), shape).numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_ATOL)


def test_randint_over_wide_spans_matches_jax():
    """The multiply-mod in 16-bit halves: spans past 2**16 and up to
    int32's whole range, negative minimums, and an empty span."""
    jkey, key = jax.random.PRNGKey(3), threefry.prng_key(3, "cpu")
    for lo, hi in ((0, 2 ** 20 + 7), (-5, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1),
                   (4, 4)):
        np.testing.assert_array_equal(
            threefry.randint(key, (500,), lo, hi).numpy(),
            words(jax.random.randint(jkey, (500,), lo, hi)), err_msg=(lo, hi))


def test_uniform_range_and_erfinv_edges():
    jkey, key = jax.random.PRNGKey(11), threefry.prng_key(11, "cpu")
    got = threefry.uniform(key, (300,), -2.5, 4.0).numpy()
    want = np.asarray(jax.random.uniform(jkey, (300,), minval=-2.5,
                                         maxval=4.0))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    edges = threefry.erfinv_f32(torch.tensor([-1.0, 1.0, 0.0]))
    assert edges.tolist() == [-float("inf"), float("inf"), 0.0]


def test_synthetic_mnist_traced_matches_the_reference():
    means = jdata.mnist_teacher_means()
    jx, jy = jax.jit(lambda: jdata.synthetic_mnist_traced(1, 8192, means))()
    x, y = tdata.synthetic_mnist_traced(
        1, 8192, torch.from_numpy(np.array(tdata.mnist_teacher_means())),
        "cpu")
    assert x.shape == (8192, 784) and x.dtype == torch.float32
    assert y.shape == (8192,) and y.dtype == torch.int32
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0,
                               atol=DATA_ATOL)
    # The key is PRNGKey(seed & 0x7FFFFFFF), as the reference's.
    m = torch.from_numpy(np.array(means))
    x1, y1 = tdata.synthetic_mnist_traced(1, 64, m, "cpu")
    x2, y2 = tdata.synthetic_mnist_traced(1 + 2 ** 31, 64, m, "cpu")
    assert torch.equal(x1, x2) and torch.equal(y1, y2)


def test_the_generator_raises_without_cuda_unless_the_cpu_is_named(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        threefry.prng_key(0)
