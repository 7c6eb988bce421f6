"""Flash attention, forward and backward — the port of
``kubeflow_controller_tpu/ops/attention.py``.

Three hand-written CUDA kernels (``csrc/flash_attention.cu``) take the
places of the three Pallas kernels:

- ``flash_fwd(q, k, v) -> (o, lse)``: blocked online softmax with the causal
  block skip; ports ``_fwd_kernel``.
- ``flash_dq(q, k, v, do, lse, delta) -> dq``: ports ``_dq_kernel``.
- ``flash_dkv(q, k, v, do, lse, delta) -> (dk, dv)``: ports ``_dkv_kernel``.

``flash_attention`` puts them behind a ``torch.autograd.Function``, as the
reference's ``_flash_bh`` custom VJP does: the forward keeps (q, k, v, o,
lse); the backward computes ``delta = rowsum(dO * O)`` in f32 with plain
PyTorch (the reference computes it outside Pallas too), then launches the
dQ and dKV kernels.

Layout: q/k/v/o and their gradients are ``[B, T, H, D]``, the model's
layout, which the kernels read through strides (the reference transposes to
``[B*H, T, D]`` first).  ``lse`` and ``delta`` are ``[B*H, T]`` f32, one
value per row; the reference stores them broadcast over 128 lanes, a Mosaic
tiling rule.

Each wrapper launches its CUDA kernel for CUDA tensors, or raises: the
kernels take contiguous bf16 ``[B, T, H, D]`` with ``D`` 64 or 128 and ``T``
a multiple of ``TILE`` (:func:`kernel_rule`).  Only tensors that lie on the
CPU take the plain versions (``flash_fwd_plain``, ``flash_dq_plain``,
``flash_dkv_plain``): the same functions as straightforward f32 math over
the whole score matrix.  Each wrapper counts its launches in its
``launches`` attribute.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..parallel.ring import NEG_INF
from . import _build

# Rows per kernel tile: T must be a multiple of it.  (The reference's 1024
# blocks and Mosaic's sublane rule are TPU choices, not ported.)
TILE = 64
HEAD_DIMS = (64, 128)


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return float(q.shape[-1] ** -0.5 if scale is None else scale)


# ---------------------------------------------------------------------------
# Plain versions (f32 math over the whole [B, H, T, T] score matrix)
# ---------------------------------------------------------------------------

def _scores(q, k, causal: bool, scale: float) -> torch.Tensor:
    """f32 [B, H, Tq, Tk] scaled scores, masked with NEG_INF."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        mask = (torch.arange(tq, device=q.device)[:, None]
                < torch.arange(tk, device=q.device)[None, :])
        s = s.masked_fill(mask, NEG_INF)
    return s


def _rows(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """[B*H, T] per-row statistics -> [B, H, T, 1]."""
    return x.reshape(b, h, -1)[..., None]


def flash_fwd_plain(q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    """(o [B, T, H, D] in q's dtype, lse [B*H, T] f32)."""
    scale = _scale(q, scale)
    b, t, h, _ = q.shape
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l, v.float())
    lse = (m + torch.log(l)).reshape(b * h, t)
    return o.to(q.dtype), lse


def _p_ds(q, k, v, do, lse, delta, causal, scale):
    """The recomputed probabilities and their gradient, f32 [B, H, T, T]."""
    b, _, h, _ = q.shape
    p = torch.exp(_scores(q, k, causal, scale) - _rows(lse, b, h))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - _rows(delta, b, h))


def flash_dq_plain(q, k, v, do, lse, delta, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """dq [B, T, H, D] in q's dtype: ``scale * ds @ k``."""
    scale = _scale(q, scale)
    _, ds = _p_ds(q, k, v, do, lse, delta, causal, scale)
    return (scale * torch.einsum("bhqk,bkhd->bqhd", ds, k.float())).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, causal: bool = True,
                    scale: Optional[float] = None):
    """(dk, dv) [B, T, H, D]: ``scale * dsᵀ @ q`` and ``pᵀ @ do``."""
    scale = _scale(q, scale)
    p, ds = _p_ds(q, k, v, do, lse, delta, causal, scale)
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def kernel_rule(q, k, v) -> Optional[str]:
    """Why the CUDA kernels cannot take these operands, or None when they
    can: one device, bf16, equal ``[B, T, H, D]`` shapes, ``D`` in
    ``HEAD_DIMS`` and ``T`` a multiple of ``TILE``.  Every shape it accepts
    is one the C entries take: B·H is folded into the grid's x extent, so
    there is no limit on it short of tensors too large to allocate."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        return (f"q/k/v must be equal [B, T, H, D] shapes, got "
                f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        return "q, k and v must be on one device"
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        return f"the kernels take bf16 operands, got {q.dtype}"
    t, d = q.shape[1], q.shape[3]
    if d not in HEAD_DIMS:
        return f"head_dim {d} is not one of {HEAD_DIMS}"
    if t % TILE:
        return f"T={t} is not a multiple of {TILE}"
    return None


def _check(q, k, v, *more) -> None:
    """Everything the CUDA kernels assume, checked before any pointer
    crosses into C.  ``more`` are (name, tensor, dtype, shape) tuples."""
    reason = kernel_rule(q, k, v)
    if reason is not None:
        raise ValueError(f"flash attention kernel: {reason}")
    named = [("q", q, torch.bfloat16, q.shape), ("k", k, torch.bfloat16,
                                                  q.shape),
             ("v", v, torch.bfloat16, q.shape), *more]
    for name, t, dtype, shape in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _stats(q, lse, delta):
    b, t, h, _ = q.shape
    return (("lse", lse, torch.float32, (b * h, t)),
            ("delta", delta, torch.float32, (b * h, t)))


def flash_fwd(q, k, v, causal: bool = True, scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward: (o [B, T, H, D], lse [B*H, T] f32)."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, scale)
    _check(q, k, v)
    b, t, h, d = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    lib = _build.library()
    code = lib.lib.kctpu_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   o.data_ptr(), lse.data_ptr(), b, h, t, d,
                                   scale, int(causal), _build.stream(q))
    lib.check(code, "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def flash_dq(q, k, v, do, lse, delta, causal: bool = True,
             scale: Optional[float] = None) -> torch.Tensor:
    """dq of attention, from the forward's lse and ``delta = rowsum(do*o)``."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, causal, scale)
    _check(q, k, v, ("do", do, q.dtype, q.shape), *_stats(q, lse, delta))
    b, t, h, d = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = _build.library()
    code = lib.lib.kctpu_flash_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  do.data_ptr(), lse.data_ptr(),
                                  delta.data_ptr(), dq.data_ptr(), b, h, t, d,
                                  scale, int(causal), _build.stream(q))
    lib.check(code, "flash_dq")
    flash_dq.launches += 1
    return dq


flash_dq.launches = 0


def flash_dkv(q, k, v, do, lse, delta, causal: bool = True,
              scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of attention, from the same inputs as :func:`flash_dq`."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    _check(q, k, v, ("do", do, q.dtype, q.shape), *_stats(q, lse, delta))
    b, t, h, d = q.shape
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = _build.library()
    code = lib.lib.kctpu_flash_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   do.data_ptr(), lse.data_ptr(),
                                   delta.data_ptr(), dk.data_ptr(),
                                   dv.data_ptr(), b, h, t, d, scale,
                                   int(causal), _build.stream(q))
    lib.check(code, "flash_dkv")
    flash_dkv.launches += 1
    return dk, dv


flash_dkv.launches = 0


# ---------------------------------------------------------------------------
# The differentiable op
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash_bh`` custom VJP, on ``[B, T, H, D]``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        q, k, v = (x.contiguous() for x in (q, k, v))
        o, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        b, t, h, _ = q.shape
        delta = torch.einsum("bthd,bthd->bht", do.float(), o.float())
        delta = delta.reshape(b * h, t).contiguous()
        dq = flash_dq(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v: [B, T, H, D] -> [B, T, H, D].  Differentiable.

    CUDA tensors run the three kernels (and must meet :func:`kernel_rule`);
    CPU tensors run the plain versions at any shape."""
    return _FlashAttention.apply(q, k, v, causal, _scale(q, scale))
