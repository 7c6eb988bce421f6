"""MNIST models — the port of ``kubeflow_controller_tpu/models/mnist.py``:
softmax regression and a one-hidden-layer MLP.

The initializers are the reference's, draw for draw: host numpy, so one
seed gives byte-identical parameters in both packages (``mlp_init``'s
truncated normal rejection-resamples the tails exactly as the reference
does).  The parameters then live in an ``nn.Module`` per model
(:class:`MnistSoftmax`, :class:`MnistMLP`) built from those arrays, whose
``forward`` is the reference's apply function; the loss and accuracy are
plain functions of a model and a batch.

Seeds are ints (the reference also takes a JAX PRNG key, whose counter
word is the seed).  Parameter dtypes are numpy's, so ``MLPConfig.dtype``
is ``"float32"`` (the reference's default) or another numpy float type.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..utils.rand import as_seed

IMAGE_PIXELS = 28 * 28
NUM_CLASSES = 10

Params = Dict[str, np.ndarray]


def softmax_init(seed: int = 0, dtype: str = "float32") -> Params:
    """Zero init, as the reference does; ``seed`` is unused."""
    del seed
    return {
        "w": np.zeros((IMAGE_PIXELS, NUM_CLASSES), dtype=dtype),
        "b": np.zeros((NUM_CLASSES,), dtype=dtype),
    }


def softmax_apply(p, x: torch.Tensor) -> torch.Tensor:
    """Logits for a [batch, 784] image batch; ``p`` holds ``w`` and ``b``
    as attributes (a :class:`MnistSoftmax`)."""
    return x @ p.w + p.b


@dataclass(frozen=True)
class MLPConfig:
    hidden: int = 100
    dtype: str = "float32"


def mlp_init(seed: int, cfg: MLPConfig = MLPConfig()) -> Params:
    """Truncated-normal init scaled by 1/sqrt(fan_in), zero biases."""
    rng = np.random.default_rng(as_seed(seed))
    dtype = np.dtype(cfg.dtype)

    def trunc(shape, scale):
        a = rng.standard_normal(size=shape)
        bad = np.abs(a) > 2
        while bad.any():  # rejection-resample the tails, like tf.truncated_normal
            a[bad] = rng.standard_normal(size=int(bad.sum()))
            bad = np.abs(a) > 2
        return (a * scale).astype(np.float32).astype(dtype)

    return {
        "w1": trunc((IMAGE_PIXELS, cfg.hidden), IMAGE_PIXELS ** -0.5),
        "b1": np.zeros((cfg.hidden,), dtype=dtype),
        "w2": trunc((cfg.hidden, NUM_CLASSES), cfg.hidden ** -0.5),
        "b2": np.zeros((NUM_CLASSES,), dtype=dtype),
    }


def mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    """Logits; ``p`` holds ``w1 b1 w2 b2`` as attributes (a
    :class:`MnistMLP`)."""
    h = torch.relu(x @ p.w1 + p.b1)
    return h @ p.w2 + p.b2


class _MnistModel(nn.Module):
    KEYS: tuple = ()

    def __init__(self, params: Mapping[str, Any], device: DeviceLike = "cuda",
                 requires_grad: bool = True):
        super().__init__()
        dev = resolve_device(device)
        if set(params) != set(self.KEYS):
            raise KeyError(f"{type(self).__name__} takes params "
                           f"{sorted(self.KEYS)}, got {sorted(params)}")
        for key in self.KEYS:
            # A copy: the module trains in place, the arrays stay as given.
            value = torch.as_tensor(np.array(params[key])).to(dev)
            self.register_parameter(
                key, nn.Parameter(value, requires_grad=requires_grad))


class MnistSoftmax(_MnistModel):
    """Softmax regression ``x @ w + b`` (parameters ``w``, ``b``)."""

    KEYS = ("w", "b")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return softmax_apply(self, x)


class MnistMLP(_MnistModel):
    """One hidden ReLU layer (parameters ``w1 b1 w2 b2``)."""

    KEYS = ("w1", "b1", "w2", "b2")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self, x)


def mlp_loss(model: nn.Module, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the batch on f32 logits; ``y`` holds
    integer class ids."""
    return F.cross_entropy(model(x).float(), y.long())


def mlp_accuracy(model: nn.Module, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """Fraction of the batch whose arg-max logit is its label."""
    with torch.no_grad():
        return (model(x).argmax(dim=-1) == y).float().mean()
