"""Vision models: the MNIST CNN and the CIFAR ResNets — the port of
``kubeflow_controller_tpu/models/vision.py`` (flax.linen).

The models take NHWC images at their boundary, as flax does; inside,
``x.permute(0, 3, 1, 2)`` gives an NCHW tensor with channels-last strides,
the layout cuDNN's convolutions prefer.  Submodules carry flax's
auto-generated names (``stem``, ``BatchNorm_0``, ``ResNetBlock_3``,
``Conv_1``, ``proj``, ``head``, ...), so ``bridge.vision_params_from_jax``
maps a flax variable tree onto them name for name.  What the port keeps
of flax's arithmetic:

- ``padding="SAME"`` pads ``(k - 1 + (ceil(n / s) - 1) * s + 1 - n)``
  in total, the odd pixel on the high side: a 3x3 stride-2 conv over an
  even input pads (0, 1), not torch's (1, 1);
- ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``: batch moments
  ``mean = E[x]``, ``var = max(E[x^2] - mean^2, 0)``, the running
  statistics updated as ``r = 0.9 r + 0.1 stat`` with the *biased* batch
  variance (torch's own BatchNorm uses the unbiased one and momentum
  0.1, so the port carries its own), ``y = (x - mean) * scale *
  rsqrt(var + eps) + bias``; evaluation (``train=False``) normalises with
  the running statistics;
- inside a process group the batch moments are the global batch's (the
  reference's loss runs on the global batch array): each BatchNorm sums
  ``[sum x, sum x^2, count]`` over the group in one ``all_reduce`` in the
  forward pass, and its hand-written backward (the gradient autograd
  through that collective would give, in the well-conditioned centred
  form) sums ``[sum dy, sum dy * xhat]`` in one more, so a step makes two
  collectives per BatchNorm layer besides the gradients' one;
- the last BatchNorm of each residual block starts at scale 0;
- ``FlaxMNISTCNN`` flattens in NHWC order, as flax's reshape does;
- :func:`vision_init` draws flax's initialisers from a ``torch.Generator``
  on the host: truncated ``lecun_normal`` for conv and dense kernels
  (std ``sqrt(1 / fan_in) / 0.8796``, cut at two std), zero biases,
  BatchNorm scale 1 (0 where flax has ``zeros_init``) and bias 0, running
  mean 0 and variance 1.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device

NUM_CLASSES = 10
BN_MOMENTUM = 0.9       # flax's: the running statistic's share kept
BN_EPS = 1e-5
# flax's truncated_normal variance_scaling divides by the std of a unit
# normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def same_padding(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax's ``padding="SAME"`` along one axis: (low, high)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """``nn.Conv(features, kernel, strides, padding="SAME")`` on NCHW:
    weight ``[out, in, kh, kw]`` (flax's HWIO kernel permuted), optional
    bias."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1,
                 bias: bool = True, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(
            (c_out, c_in, kernel, kernel), device=dev).to(
                memory_format=torch.channels_last))
        self.bias = (nn.Parameter(torch.empty(c_out, device=dev)) if bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        h_lo, h_hi = same_padding(x.shape[2], k, self.stride)
        w_lo, w_hi = same_padding(x.shape[3], k, self.stride)
        if h_lo == h_hi and w_lo == w_hi:
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            (h_lo, w_lo))
        x = F.pad(x, (w_lo, w_hi, h_lo, h_hi))
        return F.conv2d(x, self.weight, self.bias, self.stride)


class Dense(nn.Module):
    """``nn.Dense``: weight ``[out, in]`` (flax's kernel transposed) and a
    bias."""

    def __init__(self, c_in: int, c_out: int, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.weight = nn.Parameter(torch.empty((c_out, c_in), device=dev))
        self.bias = nn.Parameter(torch.empty(c_out, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over N, H, W of
    an NCHW tensor: parameters ``weight`` (flax's ``scale``) and ``bias``,
    buffers ``mean`` and ``var`` (flax's ``batch_stats``)."""

    def __init__(self, channels: int, zero_scale: bool = False,
                 device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.zero_scale = zero_scale
        self.weight = nn.Parameter(torch.empty(channels, device=dev))
        self.bias = nn.Parameter(torch.empty(channels, device=dev))
        self.register_buffer("mean", torch.zeros(channels, device=dev))
        self.register_buffer("var", torch.ones(channels, device=dev))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            return _BatchNormTrain.apply(x, self.weight, self.bias, self.mean,
                                         self.var)
        c = x.shape[1]
        mul = torch.rsqrt(self.var + BN_EPS) * self.weight
        return ((x - self.mean.view(1, c, 1, 1)) * mul.view(1, c, 1, 1)
                + self.bias.view(1, c, 1, 1))


def moments(stats: torch.Tensor, c: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased var) from ``[sum x (c), sum x^2 (c), count]``: flax's
    fast variance ``max(E[x^2] - E[x]^2, 0)``."""
    n = stats[-1:]
    mean = stats[:c] / n
    return mean, torch.clamp_min(stats[c:2 * c] / n - mean * mean, 0.0)


def _group_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the process group when one is joined (one
    collective), else ``t``."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


class _BatchNormTrain(torch.autograd.Function):
    """flax's training-mode BatchNorm over N, H, W of an NCHW tensor, with
    the batch moments over the process group's whole batch.

    Forward: ``[sum x, sum x^2, count]`` in one ``all_reduce``; ``mean =
    E[x]``, ``var = max(E[x^2] - mean^2, 0)`` (flax's fast variance), the
    running statistics updated in place, ``y = (x - mean) * (scale *
    rsqrt(var + eps)) + bias``.  Backward, by hand, in the centred form
    ``dx = scale * rsqrt(var + eps) * (dy - E[dy] - xhat * E[dy * xhat])``
    with ``[sum dy, sum dy * xhat]`` over the group in one more
    ``all_reduce``: the gradient of the sum of every process's loss, as
    autograd through the two collectives would give, without its f32
    cancellation (autograd of ``E[x^2] - E[x]^2`` lost up to 1e-2 of the
    first stage's gradients of a ResNet-18 against flax and against f64).
    The scale and bias gradients are the process's own sums: the step's
    gradient ``all_reduce`` adds them up."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var):
        c = x.shape[1]
        count = torch.full((1,), x.numel() // c, dtype=x.dtype,
                           device=x.device)
        stats = _group_sum(torch.cat([x.sum((0, 2, 3)),
                                      (x * x).sum((0, 2, 3)), count]))
        n = stats[-1:]
        mean, var = moments(stats, c)
        running_mean.copy_(BN_MOMENTUM * running_mean
                           + (1.0 - BN_MOMENTUM) * mean)
        running_var.copy_(BN_MOMENTUM * running_var
                          + (1.0 - BN_MOMENTUM) * var)
        inv = torch.rsqrt(var + BN_EPS)
        ctx.save_for_backward(x, weight, mean, inv, n)
        return ((x - mean.view(1, c, 1, 1)) * (inv * weight).view(1, c, 1, 1)
                + bias.view(1, c, 1, 1))

    @staticmethod
    def backward(ctx, gy):
        x, weight, mean, inv, n = ctx.saved_tensors
        c = x.shape[1]
        xhat = (x - mean.view(1, c, 1, 1)) * inv.view(1, c, 1, 1)
        local = torch.cat([gy.sum((0, 2, 3)), (gy * xhat).sum((0, 2, 3))])
        gbias, gweight = local[:c].clone(), local[c:].clone()
        sums = _group_sum(local) / n
        gx = (weight * inv).view(1, c, 1, 1) * (
            gy - sums[:c].view(1, c, 1, 1) - xhat * sums[c:].view(1, c, 1, 1))
        return gx, gweight, gbias, None, None


class FlaxMNISTCNN(nn.Module):
    """The small convnet for 28x28x1 images — the Flax-MNIST model: per
    feature width a 3x3 conv, ReLU and 2x2 average pool, then Dense(dense),
    ReLU, Dense(10)."""

    def __init__(self, features: Sequence[int] = (32, 64), dense: int = 256,
                 device: DeviceLike = "cuda"):
        super().__init__()
        c, size = 1, 28
        for i, f in enumerate(features):
            self.add_module(f"Conv_{i}", Conv(c, f, 3, device=device))
            c = f
            size //= 2
        self.n_convs = len(features)
        self.Dense_0 = Dense(c * size * size, dense, device)
        self.Dense_1 = Dense(dense, NUM_CLASSES, device)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(self.n_convs):
            x = F.avg_pool2d(F.relu(getattr(self, f"Conv_{i}")(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order
        return self.Dense_1(F.relu(self.Dense_0(x)))


class ResNetBlock(nn.Module):
    """Two 3x3 convs with BatchNorm; a 1x1 ``proj`` conv (and its
    BatchNorm) on the residual when the shape changes."""

    expansion = 1

    def __init__(self, c_in: int, filters: int, stride: int = 1,
                 device: DeviceLike = "cuda"):
        super().__init__()
        self.Conv_0 = Conv(c_in, filters, 3, stride, False, device)
        self.BatchNorm_0 = BatchNorm(filters, device=device)
        self.Conv_1 = Conv(filters, filters, 3, 1, False, device)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True, device=device)
        self.has_proj = stride != 1 or c_in != filters
        if self.has_proj:
            self.proj = Conv(c_in, filters, 1, stride, False, device)
            self.BatchNorm_2 = BatchNorm(filters, device=device)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        residual = (self.BatchNorm_2(self.proj(x), train) if self.has_proj
                    else x)
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    """1x1, 3x3 (strided), 1x1 (x4 filters) convs with BatchNorm; ``proj``
    on the residual when the shape changes."""

    expansion = 4

    def __init__(self, c_in: int, filters: int, stride: int = 1,
                 device: DeviceLike = "cuda"):
        super().__init__()
        out = filters * 4
        self.Conv_0 = Conv(c_in, filters, 1, 1, False, device)
        self.BatchNorm_0 = BatchNorm(filters, device=device)
        self.Conv_1 = Conv(filters, filters, 3, stride, False, device)
        self.BatchNorm_1 = BatchNorm(filters, device=device)
        self.Conv_2 = Conv(filters, out, 1, 1, False, device)
        self.BatchNorm_2 = BatchNorm(out, zero_scale=True, device=device)
        self.has_proj = stride != 1 or c_in != out
        if self.has_proj:
            self.proj = Conv(c_in, out, 1, stride, False, device)
            self.BatchNorm_3 = BatchNorm(out, device=device)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        residual = (self.BatchNorm_3(self.proj(x), train) if self.has_proj
                    else x)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """CIFAR-style ResNet: 3x3 stem, no max-pool, stage ``i`` at width
    ``width * 2**i`` (stride 2 into every stage after the first), global
    average pool, ``head``."""

    def __init__(self, stage_sizes: Sequence[int], block: type,
                 num_classes: int = NUM_CLASSES, width: int = 64,
                 device: DeviceLike = "cuda"):
        super().__init__()
        self.stem = Conv(3, width, 3, 1, False, device)
        self.BatchNorm_0 = BatchNorm(width, device=device)
        self.block_names = []
        c = width
        for stage, size in enumerate(stage_sizes):
            for b in range(size):
                stride = 2 if stage > 0 and b == 0 else 1
                name = f"{block.__name__}_{len(self.block_names)}"
                filters = width * 2 ** stage
                self.add_module(name, block(c, filters, stride, device))
                self.block_names.append(name)
                c = filters * block.expansion
        self.head = Dense(c, num_classes, device)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.BatchNorm_0(self.stem(x), train))
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        return self.head(x.mean(dim=(2, 3)))


def resnet18(**kw) -> ResNet:
    return ResNet((2, 2, 2, 2), ResNetBlock, **kw)


def resnet50(**kw) -> ResNet:
    return ResNet((3, 4, 6, 3), BottleneckBlock, **kw)


def vision_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill ``model``'s parameters and statistics in place with flax's
    initialisers, drawn on the host from ``generator`` (a CPU generator:
    the same seed gives the same model on any device); returns it."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (Conv, Dense)):
                w = torch.empty(mod.weight.shape)
                fan_in = math.prod(w.shape[1:])
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                mod.weight.copy_(w)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.weight.fill_(0.0 if mod.zero_scale else 1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)
    return model


def batch_stats(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's BatchNorm statistics by buffer name (empty without
    BatchNorm)."""
    return dict(model.named_buffers())


def vision_loss(model: nn.Module, x: torch.Tensor, y: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean cross-entropy on f32 logits in training mode; returns ``(loss,
    batch_stats)``, the statistics as this forward left them."""
    logits = model(x, train=True)
    return F.cross_entropy(logits.float(), y.long()), batch_stats(model)


def vision_accuracy(model: nn.Module, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Fraction of ``x`` whose arg-max logit is its label, evaluated with
    the running statistics (``train=False``)."""
    with torch.no_grad():
        return (model(x, train=False).argmax(dim=-1) == y).float().mean()
