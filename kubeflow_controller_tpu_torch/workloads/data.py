"""Deterministic synthetic datasets — the port's copy of the MNIST and
CIFAR generators and ``synthetic_tokens`` from
``kubeflow_controller_tpu/workloads/data.py``.

The generators are host-side numpy in both packages, with the same frozen
teacher seed and the same draws, so one seed gives byte-identical data in
either; only the container differs (torch tensors on the caller's device
here).  Seeds are ints: the reference also accepts a JAX PRNG key, which
collapses to its counter word (``PRNGKey(1)`` is seed 1).

:func:`synthetic_mnist_traced` is the other generator of the reference,
the one its one-program fits run on the device: JAX's threefry draws
(``utils/threefry.py``), on the caller's device, with no host sync, so a
CUDA graph can hold it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..utils import threefry
from ..utils.rand import as_seed

IMAGE_PIXELS = 28 * 28
NUM_CLASSES = 10

_TEACHER_SEED = 20180214  # the reference's value, fixed forever

# Per-process memo of the teacher templates and the numpy datasets: every
# entry is read-only, so one object is shared by every fit in a process.
_MEANS_MEMO: dict = {}
_DATASET_MEMO: dict = {}
_DATASET_MEMO_MAX = 16


def _memo_dataset(key, build):
    got = _DATASET_MEMO.get(key)
    if got is None:
        got = _DATASET_MEMO[key] = build()
        if len(_DATASET_MEMO) > _DATASET_MEMO_MAX:  # FIFO bound
            _DATASET_MEMO.pop(next(iter(_DATASET_MEMO)))
    return got


def mnist_teacher_means() -> np.ndarray:
    """The frozen [10, 784] class templates behind every synthetic-MNIST
    draw: low-frequency patterns (7x7 upsampled 4x).  Read-only."""
    got = _MEANS_MEMO.get("means")
    if got is None:
        mix = np.random.default_rng(_TEACHER_SEED)
        coarse = mix.standard_normal((NUM_CLASSES, 7, 7), dtype=np.float32) * 0.12
        got = coarse.repeat(4, axis=1).repeat(4, axis=2).reshape(
            NUM_CLASSES, IMAGE_PIXELS)
        got.setflags(write=False)
        _MEANS_MEMO["means"] = got
    return got


def synthetic_mnist_np(seed: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """n examples of (x [n, 784] f32, y [n] int64) as read-only numpy: a
    frozen 10-component Gaussian mixture, one cluster per digit class.
    Touches no device, so it can run while a process group forms.
    Memoized per (seed, n)."""
    def build():
        means = mnist_teacher_means()
        rng = np.random.default_rng(as_seed(seed))
        y = rng.integers(0, NUM_CLASSES, size=n)
        x = means[y] + rng.standard_normal((n, IMAGE_PIXELS), dtype=np.float32)
        x.setflags(write=False)
        y.setflags(write=False)
        return x, y

    return _memo_dataset(("mnist_np", as_seed(seed), n), build)


def synthetic_mnist(seed: int, n: int, device: DeviceLike = "cuda"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`synthetic_mnist_np` as tensors on ``device``: x [n, 784]
    f32 and y [n] int64 (the reference's y is int32; torch's losses take
    int64 class ids)."""
    dev = resolve_device(device)
    x, y = synthetic_mnist_np(seed, n)
    return (torch.from_numpy(np.array(x)).to(dev),
            torch.from_numpy(np.array(y, dtype=np.int64)).to(dev))


def synthetic_mnist_traced(seed: int, n: int, means: torch.Tensor,
                           device: DeviceLike = "cuda"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's on-device twin of :func:`synthetic_mnist`: the same
    frozen mixture (``means``, the [10, 784] teacher templates as a tensor
    on ``device``, plus unit noise) drawn with JAX's threefry from
    ``PRNGKey(seed & 0x7FFFFFFF)`` split into ``(kx, ky)``: ``y =
    randint(ky, (n,), 0, 10)`` and ``x = means[y] + normal(kx, (n,
    784))``.  x [n, 784] f32 and y [n] int32, as the reference returns
    them.  Every operation runs on ``device`` without a host sync."""
    dev = resolve_device(device)
    kx, ky = threefry.split(threefry.prng_key(as_seed(seed) & 0x7FFFFFFF,
                                              dev))
    y = threefry.randint(ky, (n,), 0, NUM_CLASSES)
    x = means[y] + threefry.normal(kx, (n, IMAGE_PIXELS))
    return x, y.to(torch.int32)


def synthetic_tokens(seed: int, n_seqs: int, seq_len: int, vocab: int,
                     device: DeviceLike = "cuda") -> torch.Tensor:
    """[n_seqs, seq_len] int32 on ``device`` from a frozen first-order
    bigram chain — enough structure that next-token loss drops well below
    log(vocab)."""
    dev = resolve_device(device)
    chain = np.random.default_rng(_TEACHER_SEED + 1)
    # Each token strongly prefers a fixed successor.
    succ = chain.integers(0, vocab, size=vocab)
    rng = np.random.default_rng(as_seed(seed))
    out = np.empty((n_seqs, seq_len), dtype=np.int32)
    out[:, 0] = rng.integers(0, vocab, size=n_seqs)
    flips = rng.random((n_seqs, seq_len)) < 0.1
    noise = rng.integers(0, vocab, size=(n_seqs, seq_len))
    for t in range(1, seq_len):
        out[:, t] = np.where(flips[:, t], noise[:, t], succ[out[:, t - 1]])
    return torch.from_numpy(out).to(dev)


def synthetic_mnist_images_np(seed: int, n: int, scale: float = 0.3
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """n examples of (x [n, 28, 28, 1] f32 NHWC, y [n] int64) as numpy:
    the image variant for conv models (``flax_mnist``), with stronger
    class templates (scale 0.3) than the flat set."""
    mix = np.random.default_rng(_TEACHER_SEED + 3)
    coarse = mix.standard_normal((NUM_CLASSES, 7, 7), dtype=np.float32) * scale
    means = coarse.repeat(4, axis=1).repeat(4, axis=2)
    rng = np.random.default_rng(as_seed(seed))
    y = rng.integers(0, NUM_CLASSES, size=n)
    x = means[y] + rng.standard_normal((n, 28, 28), dtype=np.float32)
    return x[..., None], y.astype(np.int64)


def synthetic_cifar_np(seed: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """n examples of (x [n, 32, 32, 3] f32 NHWC, y [n] int64) as numpy: 10
    frozen low-frequency class templates (8x8 upsampled 4x) plus unit
    Gaussian noise."""
    mix = np.random.default_rng(_TEACHER_SEED + 2)
    coarse = mix.standard_normal((NUM_CLASSES, 8, 8, 3), dtype=np.float32) * 0.35
    templates = coarse.repeat(4, axis=1).repeat(4, axis=2)  # [10,32,32,3]
    rng = np.random.default_rng(as_seed(seed))
    y = rng.integers(0, NUM_CLASSES, size=n)
    x = templates[y] + rng.standard_normal((n, 32, 32, 3), dtype=np.float32)
    return x, y.astype(np.int64)


def synthetic_mnist_images(seed: int, n: int, device: DeviceLike = "cuda",
                           scale: float = 0.3
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`synthetic_mnist_images_np` as tensors on ``device``: x [n,
    28, 28, 1] f32 NHWC and y [n] int64."""
    dev = resolve_device(device)
    x, y = synthetic_mnist_images_np(seed, n, scale)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def synthetic_cifar(seed: int, n: int, device: DeviceLike = "cuda"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`synthetic_cifar_np` as tensors on ``device``: x [n, 32, 32,
    3] f32 NHWC and y [n] int64."""
    dev = resolve_device(device)
    x, y = synthetic_cifar_np(seed, n)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
