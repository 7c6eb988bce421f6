"""AdamW's update with the global-norm clip's scale folded in: one pass
over a parameter tensor.

``adamw_step(p, g, m, v, ...)`` updates the parameter ``p`` and AdamW's
moments ``m`` (``exp_avg``) and ``v`` (``exp_avg_sq``) in place from the
gradient ``g``, which it reads and leaves as it is.  ``grad_scale``, a
pair ``(div, mul)`` of 0-dim f32 device tensors, scales the gradient as
the clip does (``g / div * mul``) inside the same pass.

The arithmetic is torch's ``_multi_tensor_adam`` for AdamW, in f32
whatever the storage type (``csrc/adamw.cu`` sets it out): the decay, the
clip's two roundings, ``lerp`` on m, ``v * b2 + (1 - b2) g²``, and
``p - lr / bc1 * m / (sqrt(v) / sqrt(bc2) + eps)``.  The bias corrections
come from ``step``, the step count after this step, or from
``device_step`` (a capturable group's step tensor, which a CUDA graph
advances).

For CUDA tensors the wrapper launches the hand-written kernel
(``csrc/adamw.cu``) or raises: p, g, m and v contiguous, of one shape and
one dtype, f32 or bf16, on one device.  Only tensors that lie on the CPU
take the plain version, :func:`adamw_step_plain`: the same update in
plain PyTorch.  ``adamw_step.launches`` counts the kernel's launches, one
a parameter tensor.  The kernel replaces no Pallas kernel: the JAX package
leaves optax's update to XLA, which fuses it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from . import _build

DTYPES = (torch.float32, torch.bfloat16)


def adamw_step_plain(p: Tensor, g: Tensor, m: Tensor, v: Tensor, *,
                     lr: float, betas: Tuple[float, float], eps: float,
                     weight_decay: float, step: float,
                     grad_scale: Optional[Tuple[Tensor, Tensor]] = None
                     ) -> None:
    """The kernel's update in plain PyTorch, in the same order, with every
    operation in f32 (a bf16 tensor is computed on an f32 copy and written
    back once)."""
    beta1, beta2 = betas
    pf, gf, mf, vf = (t.float() for t in (p, g, m, v))
    pf.mul_(1 - lr * weight_decay)
    if grad_scale is not None:
        div, mul = grad_scale
        gf = gf / div * mul
    mf.lerp_(gf, 1 - beta1)
    vf.mul_(beta2).addcmul_(gf, gf, value=1 - beta2)
    denom = (vf.sqrt() / (1 - beta2 ** step) ** 0.5).add_(eps)
    pf.addcdiv_(mf, denom, value=-(lr / (1 - beta1 ** step)))
    for t, f in ((p, pf), (m, mf), (v, vf)):
        if f is not t:
            t.copy_(f)


def _check(p: Tensor, g: Tensor, m: Tensor, v: Tensor,
           device_step: Optional[Tensor],
           grad_scale: Optional[Tuple[Tensor, Tensor]]) -> None:
    """Everything the kernel assumes, checked before any pointer crosses
    into C."""
    if p.dtype not in DTYPES:
        raise TypeError(f"the AdamW kernel takes {DTYPES}, got {p.dtype}")
    for name, t in (("g", g), ("m", m), ("v", v)):
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
        if t.dtype != p.dtype:
            raise TypeError(f"{name} must be {p.dtype}, got {t.dtype}")
        if t.shape != p.shape:
            raise ValueError(f"{name} must be {tuple(p.shape)}, got "
                             f"{tuple(t.shape)}")
    if not all(t.is_contiguous() for t in (p, g, m, v)):
        raise ValueError("p, g, m and v must be contiguous")
    scalars = [] if device_step is None else [("device_step", device_step)]
    if grad_scale is not None:
        scalars += [("div", grad_scale[0]), ("mul", grad_scale[1])]
    for name, t in scalars:
        if (t.device != p.device or t.dtype != torch.float32
                or t.numel() != 1):
            raise ValueError(f"{name} must be one f32 value on {p.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def adamw_step(p: Tensor, g: Tensor, m: Tensor, v: Tensor, *, lr: float,
               betas: Tuple[float, float], eps: float, weight_decay: float,
               step: float, device_step: Optional[Tensor] = None,
               grad_scale: Optional[Tuple[Tensor, Tensor]] = None) -> None:
    """One AdamW step of ``p`` in place (and of ``m`` and ``v``); see the
    module's docstring.  ``step`` is the host's step count after this
    step; ``device_step``, when given, is read instead, on the device
    (CUDA tensors only)."""
    if p.device.type == "cpu":
        if device_step is not None:
            raise ValueError("device_step is read by the kernel: CUDA only")
        adamw_step_plain(p, g, m, v, lr=lr, betas=betas, eps=eps,
                         weight_decay=weight_decay, step=step,
                         grad_scale=grad_scale)
        return
    _check(p, g, m, v, device_step, grad_scale)
    if p.numel() == 0:
        return
    div, mul = grad_scale if grad_scale is not None else (None, None)
    lib = _build.library()
    code = lib.lib.kctpu_adamw(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
        int(p.dtype == torch.bfloat16), lr, betas[0], betas[1], eps,
        weight_decay, float(step), _ptr(device_step), _ptr(div), _ptr(mul),
        _build.stream(p))
    lib.check(code, "adamw")
    adamw_step.launches += 1


adamw_step.launches = 0


def _ptr(t: Optional[Tensor]) -> Optional[int]:
    """The device address handed to C (None, C's NULL, for no tensor)."""
    return None if t is None else t.data_ptr()
