"""Grouped (per-expert) matmuls — the MoE hot path of the serving slice.

The port of the forward of ``kubeflow_controller_tpu/ops/grouped_matmul.py``:

- ``gmm(lhs [M, K], rhs [E, K, N], tile_experts, bm) -> [M, N]``: row tile
  i (``bm`` rows) is multiplied by ``rhs[tile_experts[i]]``.  Ports
  ``_gmm_kernel`` and ``_gmm_single_k_kernel``.
- ``gmm_swiglu(lhs, rhs_g, rhs_u, tile_experts, bm) -> [M, N]``:
  ``silu(lhs @ rhs_g[e]) * (lhs @ rhs_u[e])`` per row tile, fused.  Ports
  ``_gmm2_kernel``.

Each wrapper launches its hand-written CUDA kernel
(``csrc/grouped_matmul.cu``) for CUDA tensors, or raises: the CUDA kernel
takes contiguous bf16 operands and int32 tile ids on one device.  Only a
tensor that lies on the CPU takes the plain PyTorch version
(``gmm_plain``/``gmm_swiglu_plain``), a per-tile matmul with f32
accumulation as the reference's ``gmm_reference`` computes it.  Each
wrapper counts its kernel launches in its ``launches`` attribute.

Forward only: the custom VJPs (and the ``tgmm`` weight-gradient kernels
behind them) and the ``valid_tiles`` compute-skip of the ep-sharded path
come with MoE training (ROADMAP.md).  Until then both wrappers raise
``NotImplementedError`` when grad mode is on and an operand requires
grad, on every device: the CUDA kernels have no backward, and the CPU's
plain versions must not differentiate what the card cannot.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from . import _build


def _tiles(lhs: torch.Tensor, bm: int) -> torch.Tensor:
    m, k = lhs.shape
    return lhs.reshape(m // bm, bm, k)


def _tile_product(lhs, rhs, tile_experts, bm) -> torch.Tensor:
    """f32 [tiles, bm, N]: each tile against its expert's weights."""
    picked = rhs[tile_experts.long()].float()                  # [tiles, K, N]
    return torch.bmm(_tiles(lhs, bm).float(), picked)


def gmm_plain(lhs: torch.Tensor, rhs: torch.Tensor, tile_experts: torch.Tensor,
              bm: int) -> torch.Tensor:
    """Plain version of :func:`gmm`: per-tile matmul, f32 accumulation,
    one rounding to ``lhs.dtype``."""
    m = lhs.shape[0]
    return _tile_product(lhs, rhs, tile_experts, bm).reshape(m, -1).to(
        lhs.dtype)


def gmm_swiglu_plain(lhs: torch.Tensor, rhs_g: torch.Tensor,
                     rhs_u: torch.Tensor, tile_experts: torch.Tensor,
                     bm: int) -> torch.Tensor:
    """Plain version of :func:`gmm_swiglu`: SwiGLU on the f32 products,
    then one rounding to ``lhs.dtype`` (the reference's fused path applies
    silu to f32 accumulators, never to rounded values)."""
    m = lhs.shape[0]
    gate = _tile_product(lhs, rhs_g, tile_experts, bm)
    up = _tile_product(lhs, rhs_u, tile_experts, bm)
    return (F.silu(gate) * up).reshape(m, -1).to(lhs.dtype)


def _check(lhs, weights, tile_experts, bm) -> None:
    """Everything the CUDA kernel assumes, checked before any pointer
    crosses into C."""
    dev = lhs.device
    if lhs.dim() != 2:
        raise ValueError(f"lhs must be [M, K], got {tuple(lhs.shape)}")
    m, k = lhs.shape
    for w in weights:
        if w.dim() != 3 or w.shape[1] != k or w.shape != weights[0].shape:
            raise ValueError(f"rhs must be [E, K={k}, N] (all alike), got "
                             f"{[tuple(x.shape) for x in weights]}")
    n = weights[0].shape[2]
    if bm <= 0 or bm & (bm - 1) or m % bm:
        raise ValueError(f"bm={bm} must be a power of two dividing M={m}")
    if tile_experts.shape != (m // bm,):
        raise ValueError(f"tile_experts must be [M // bm = {m // bm}], got "
                         f"{tuple(tile_experts.shape)}")
    if k % 8 or n % 8:
        raise ValueError(f"K={k} and N={n} must be multiples of 8 (16-byte "
                         "bf16 chunks)")
    for name, t in (("lhs", lhs), *((f"rhs{i}", w)
                                    for i, w in enumerate(weights))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, lhs on {dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bf16 operands; {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if tile_experts.device != dev or tile_experts.dtype != torch.int32:
        raise TypeError("tile_experts must be int32 on the operands' device")
    if not tile_experts.is_contiguous():
        raise ValueError("tile_experts must be contiguous")


def _no_backward(name: str, *operands: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise NotImplementedError(
            f"{name} has no backward yet (ROADMAP.md, M1: the gmm / "
            "gmm_swiglu VJPs and the tgmm kernels); call it under "
            "torch.no_grad() or on operands that do not require grad")


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, tile_experts: torch.Tensor,
        bm: int) -> torch.Tensor:
    """Grouped matmul: ``out[r] = lhs[r] @ rhs[tile_experts[r // bm]]``.

    lhs [M, K], rhs [E, K, N], tile_experts [M // bm] int32 in [0, E);
    every bm-row tile belongs to one expert (``models/moe.py`` builds this
    layout)."""
    _no_backward("gmm", lhs, rhs)
    if lhs.device.type == "cpu":
        return gmm_plain(lhs, rhs, tile_experts, bm)
    _check(lhs, (rhs,), tile_experts, bm)
    m, k = lhs.shape
    n = rhs.shape[2]
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    lib = _build.library()
    code = lib.lib.kctpu_gmm(lhs.data_ptr(), rhs.data_ptr(),
                             tile_experts.data_ptr(), out.data_ptr(),
                             m, k, n, bm, _build.stream(lhs))
    lib.check(code, "gmm")
    gmm.launches += 1
    return out


gmm.launches = 0


def gmm_swiglu(lhs: torch.Tensor, rhs_g: torch.Tensor, rhs_u: torch.Tensor,
               tile_experts: torch.Tensor, bm: int) -> torch.Tensor:
    """Fused grouped SwiGLU: ``silu(lhs @ rhs_g[e]) * (lhs @ rhs_u[e])``
    per row tile, the SwiGLU applied to the f32 products."""
    _no_backward("gmm_swiglu", lhs, rhs_g, rhs_u)
    if lhs.device.type == "cpu":
        return gmm_swiglu_plain(lhs, rhs_g, rhs_u, tile_experts, bm)
    _check(lhs, (rhs_g, rhs_u), tile_experts, bm)
    m, k = lhs.shape
    n = rhs_g.shape[2]
    h = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    lib = _build.library()
    code = lib.lib.kctpu_gmm_swiglu(lhs.data_ptr(), rhs_g.data_ptr(),
                                    rhs_u.data_ptr(), tile_experts.data_ptr(),
                                    h.data_ptr(), m, k, n, bm, _build.stream(lhs))
    lib.check(code, "gmm_swiglu")
    gmm_swiglu.launches += 1
    return h


gmm_swiglu.launches = 0
