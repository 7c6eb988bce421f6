"""Grouped (per-expert) matmuls — the MoE hot path, forward and backward.

The port of ``kubeflow_controller_tpu/ops/grouped_matmul.py``:

- ``gmm(lhs [M, K], rhs [E, K, N], tile_experts, bm, valid_tiles=None)
  -> [M, N]``: row tile i (``bm`` rows) is multiplied by
  ``rhs[tile_experts[i]]``; tiles at or past ``valid_tiles[0]`` write zeros
  (the compute skip of the ep-sharded layout).  Ports ``_gmm_kernel``,
  ``_gmm_single_k_kernel`` and ``_gmm_single_k_skip_kernel``.
  Differentiable, as the reference's custom VJP (``_gmm_bwd``): dlhs is the
  same kernel against ``rhs[e]ᵀ`` (read in place, no transposed copy) with
  the same ``valid_tiles``; drhs is ``tgmm``.
- ``gmm_swiglu(lhs, rhs_g, rhs_u, tile_experts, bm) -> [M, N]``:
  ``silu(lhs @ rhs_g[e]) * (lhs @ rhs_u[e])`` per row tile, fused.  Ports
  ``_gmm2_kernel``.  Differentiable (``_gmm_swiglu_bwd``): when a gradient
  is needed the forward also writes the bf16 gate and up products, and the
  backward takes silu' on them in f32 (plain PyTorch, as the reference's
  XLA code), then two transposed gmms and two tgmms.
- ``tgmm(lhs [M, K], dout [M, N], tile_experts, n_experts, bm,
  valid_tiles=None) -> [E, K, N]``: ``out[e] = Σ_{tiles i of e} lhs_iᵀ ·
  dout_i``; an expert with no counted tile gets zeros.  Ports
  ``_tgmm_kernel`` and ``_tgmm_skip_kernel``.

Each kernel launches from its hand-written CUDA source
(``csrc/grouped_matmul.cu``) for CUDA tensors, or raises: the CUDA kernels
take contiguous, 16-byte-aligned bf16 operands (TMA's base and row-stride
rule) and int32 tile ids on one device.  ``gmm``, ``gmm_swiglu`` and
``tgmm`` each have two designs, picked by :func:`kernel_variant` on ``bm``
alone: ``"wgmma"`` (TMA + ``wgmma``, bm >= 64: training and prefill) for
all three, and below 64 (decode, the small prefill buckets) ``"swapab"``
for ``gmm`` and ``gmm_swiglu`` (TMA + ``wgmma`` with the weights' columns
as wgmma's 64-row M and the tile's rows as its N) and ``"wmma"`` for
``tgmm``.  Only a tensor that lies on the CPU takes
the plain PyTorch version (``gmm_plain``/``gmm_swiglu_plain``/
``tgmm_plain``): f32 products over each expert's run of tiles, one
rounding to the operand dtype, as the reference's kernels round.  ``gmm.launches``, ``gmm_swiglu.launches`` and
``tgmm.launches`` count kernel launches, backward ones included, and
each wrapper's ``launches_by_design`` counts them by design.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch.nn import functional as F

from . import _build

# ---------------------------------------------------------------------------
# Plain versions (f32 products, expert by expert)
# ---------------------------------------------------------------------------


def _runs(tile_experts: torch.Tensor, valid_tiles: Optional[torch.Tensor]
          ) -> List[Tuple[int, int, int]]:
    """(expert, first tile, end tile) of each run of equal consecutive ids
    among the counted tiles (those before ``valid_tiles[0]``, if given)."""
    te = tile_experts.tolist()
    if valid_tiles is not None:
        te = te[:max(0, int(valid_tiles[0]))]
    runs, start = [], 0
    for i in range(1, len(te) + 1):
        if i == len(te) or te[i] != te[start]:
            runs.append((te[start], start, i))
            start = i
    return runs


def _product(lhs, rhs, tile_experts, bm, valid_tiles=None,
             transpose_rhs=False) -> torch.Tensor:
    """f32 [M, N]: each run of tiles against its expert's weights (one
    matmul per run, never a [tiles, K, N] weight gather); uncounted tiles
    are zero."""
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    out = torch.zeros((lhs.shape[0], n), dtype=torch.float32,
                      device=lhs.device)
    for e, t0, t1 in _runs(tile_experts, valid_tiles):
        w = rhs[e].float()
        out[t0 * bm:t1 * bm] = lhs[t0 * bm:t1 * bm].float() @ (
            w.t() if transpose_rhs else w)
    return out


def gmm_plain(lhs: torch.Tensor, rhs: torch.Tensor, tile_experts: torch.Tensor,
              bm: int, valid_tiles: Optional[torch.Tensor] = None,
              transpose_rhs: bool = False) -> torch.Tensor:
    """Plain version of :func:`gmm`'s kernel: f32 products, one rounding
    to ``lhs.dtype``.  ``transpose_rhs``: rhs is ``[E, N, K]`` and each tile
    is multiplied by ``rhs[e]ᵀ``."""
    return _product(lhs, rhs, tile_experts, bm, valid_tiles,
                    transpose_rhs).to(lhs.dtype)


def gmm_swiglu_plain(lhs: torch.Tensor, rhs_g: torch.Tensor,
                     rhs_u: torch.Tensor, tile_experts: torch.Tensor,
                     bm: int, gate_up: bool = False):
    """Plain version of :func:`gmm_swiglu`'s kernel: SwiGLU on the f32
    products, then one rounding to ``lhs.dtype`` (the reference's fused path
    applies silu to f32 accumulators, never to rounded values).  With
    ``gate_up`` returns ``(h, gate, up)``, gate and up rounded once."""
    gate = _product(lhs, rhs_g, tile_experts, bm)
    up = _product(lhs, rhs_u, tile_experts, bm)
    h = (F.silu(gate) * up).to(lhs.dtype)
    if gate_up:
        return h, gate.to(lhs.dtype), up.to(lhs.dtype)
    return h


def tgmm_plain(lhs: torch.Tensor, dout: torch.Tensor,
               tile_experts: torch.Tensor, n_experts: int, bm: int,
               valid_tiles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`tgmm`: one f32 ``lhs_rowsᵀ @ dout_rows``
    per run of an expert's tiles, summed into ``out[e]``, one rounding to
    ``lhs.dtype``; experts with no counted tile stay zero."""
    out = torch.zeros((n_experts, lhs.shape[1], dout.shape[1]),
                      dtype=torch.float32, device=lhs.device)
    for e, t0, t1 in _runs(tile_experts, valid_tiles):
        rows = slice(t0 * bm, t1 * bm)
        out[e] += lhs[rows].float().t() @ dout[rows].float()
    return out.to(lhs.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

WGMMA_MIN_BM = 64


KERNELS = ("gmm", "gmm_swiglu", "tgmm")


def kernel_variant(kernel: str, bm: int) -> str:
    """The CUDA design ``kernel`` (one of :data:`KERNELS`) launches for row
    tiles of ``bm``: ``"wgmma"`` for bm >= 64 (a 64-row wgmma tile never
    straddles two experts, and 64 divides every expert's row range); below
    64, ``"swapab"`` for ``gmm`` and ``gmm_swiglu`` (the tile's rows as
    wgmma's N) and ``"wmma"`` for ``tgmm``."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")
    if bm >= WGMMA_MIN_BM:
        return "wgmma"
    return "wmma" if kernel == "tgmm" else "swapab"


def _check_bf16(dev, named) -> None:
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, lhs on {dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bf16 operands; {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_index(dev, m, k, n, bm, tile_experts, valid_tiles) -> None:
    if bm <= 0 or bm & (bm - 1) or m % bm:
        raise ValueError(f"bm={bm} must be a power of two dividing M={m}")
    if k % 8 or n % 8:
        raise ValueError(f"K={k} and N={n} must be multiples of 8 (16-byte "
                         "bf16 chunks)")
    for name, t, shape in (("tile_experts", tile_experts, (m // bm,)),
                           ("valid_tiles", valid_tiles, (1,))):
        if t is None:
            continue
        if t.device != dev or t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 on the operands' device")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape}")


def _check(lhs, weights, tile_experts, bm, valid_tiles=None,
           transpose_rhs: bool = False) -> None:
    """Everything the gmm kernels assume, checked before any pointer
    crosses into C.  Weights are ``[E, K, N]``, or ``[E, N, K]`` with
    ``transpose_rhs``."""
    if lhs.dim() != 2:
        raise ValueError(f"lhs must be [M, K], got {tuple(lhs.shape)}")
    m, k = lhs.shape
    k_axis = 2 if transpose_rhs else 1
    for w in weights:
        if w.dim() != 3 or w.shape[k_axis] != k or w.shape != weights[0].shape:
            want = "[E, N, K]" if transpose_rhs else "[E, K, N]"
            raise ValueError(f"rhs must be {want} with K={k} (all alike), got "
                             f"{[tuple(x.shape) for x in weights]}")
    n = weights[0].shape[3 - k_axis]
    _check_index(lhs.device, m, k, n, bm, tile_experts, valid_tiles)
    _check_bf16(lhs.device, (("lhs", lhs), *((f"rhs{i}", w)
                                             for i, w in enumerate(weights))))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """The device address handed to C (None, C's NULL, for no tensor)."""
    return None if t is None else t.data_ptr()


def _gmm(lhs: torch.Tensor, rhs: torch.Tensor, tile_experts: torch.Tensor,
         bm: int, valid_tiles: Optional[torch.Tensor] = None,
         transpose_rhs: bool = False) -> torch.Tensor:
    """The gmm kernel (no autograd); counted in ``gmm.launches``."""
    if lhs.device.type == "cpu":
        return gmm_plain(lhs, rhs, tile_experts, bm, valid_tiles,
                         transpose_rhs)
    _check(lhs, (rhs,), tile_experts, bm, valid_tiles, transpose_rhs)
    m, k = lhs.shape
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    lib = _build.library()
    variant = kernel_variant("gmm", bm)
    fn = (lib.lib.kctpu_gmm_wgmma if variant == "wgmma"
          else lib.lib.kctpu_gmm_swapab)
    code = fn(_ptr(lhs), _ptr(rhs), _ptr(tile_experts), _ptr(valid_tiles),
              _ptr(out), m, k, n, bm, rhs.shape[0], int(transpose_rhs),
              _build.stream(lhs))
    lib.check(code, f"gmm ({variant})")
    gmm.launches += 1
    gmm.launches_by_design[variant] += 1
    return out


def _gmm_swiglu(lhs: torch.Tensor, rhs_g: torch.Tensor, rhs_u: torch.Tensor,
                tile_experts: torch.Tensor, bm: int, gate_up: bool = False):
    """The fused SwiGLU kernel (no autograd): h, or ``(h, gate, up)`` with
    ``gate_up``; counted in ``gmm_swiglu.launches``."""
    if lhs.device.type == "cpu":
        return gmm_swiglu_plain(lhs, rhs_g, rhs_u, tile_experts, bm, gate_up)
    _check(lhs, (rhs_g, rhs_u), tile_experts, bm)
    m, k = lhs.shape
    n = rhs_g.shape[2]
    outs = [torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
            for _ in range(3 if gate_up else 1)]
    h, gate, up = outs if gate_up else (outs[0], None, None)
    lib = _build.library()
    variant = kernel_variant("gmm_swiglu", bm)
    fn = (lib.lib.kctpu_gmm_swiglu_wgmma if variant == "wgmma"
          else lib.lib.kctpu_gmm_swiglu_swapab)
    code = fn(_ptr(lhs), _ptr(rhs_g), _ptr(rhs_u), _ptr(tile_experts),
              _ptr(h), _ptr(gate), _ptr(up), m, k, n, bm, rhs_g.shape[0],
              _build.stream(lhs))
    lib.check(code, f"gmm_swiglu ({variant})")
    gmm_swiglu.launches += 1
    gmm_swiglu.launches_by_design[variant] += 1
    return (h, gate, up) if gate_up else h


def tgmm(lhs: torch.Tensor, dout: torch.Tensor, tile_experts: torch.Tensor,
         n_experts: int, bm: int,
         valid_tiles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The weight gradient of :func:`gmm`: ``out[e] = Σ lhs_iᵀ · dout_i``
    over the tiles i of expert e (before ``valid_tiles[0]``, if given),
    ``[E, K, N]`` in ``lhs.dtype``.  ``tile_experts`` is non-decreasing, as
    the grouped layout builds it; tiles past the last group carry E - 1 and
    add into it, as in the reference."""
    if lhs.device.type == "cpu":
        return tgmm_plain(lhs, dout, tile_experts, n_experts, bm, valid_tiles)
    if lhs.dim() != 2 or dout.dim() != 2 or lhs.shape[0] != dout.shape[0]:
        raise ValueError(f"lhs [M, K] and dout [M, N] must share M, got "
                         f"{tuple(lhs.shape)} and {tuple(dout.shape)}")
    m, k = lhs.shape
    n = dout.shape[1]
    if not 0 < n_experts <= 65535:
        raise ValueError(f"n_experts={n_experts} must be in [1, 65535]")
    _check_index(lhs.device, m, k, n, bm, tile_experts, valid_tiles)
    _check_bf16(lhs.device, (("lhs", lhs), ("dout", dout)))
    out = torch.empty((n_experts, k, n), dtype=lhs.dtype, device=lhs.device)
    lib = _build.library()
    variant = kernel_variant("tgmm", bm)
    fn = (lib.lib.kctpu_tgmm_wgmma if variant == "wgmma"
          else lib.lib.kctpu_tgmm)
    code = fn(_ptr(lhs), _ptr(dout), _ptr(tile_experts), _ptr(valid_tiles),
              _ptr(out), m, k, n, bm, n_experts, _build.stream(lhs))
    lib.check(code, f"tgmm ({variant})")
    tgmm.launches += 1
    tgmm.launches_by_design[variant] += 1
    return out


tgmm.launches = 0
tgmm.launches_by_design = {"wgmma": 0, "wmma": 0}


# ---------------------------------------------------------------------------
# The differentiable ops
# ---------------------------------------------------------------------------

class _Gmm(torch.autograd.Function):
    """The reference's ``gmm`` custom VJP (``_gmm_fwd``/``_gmm_bwd``)."""

    @staticmethod
    def forward(ctx, lhs, rhs, tile_experts, bm, valid_tiles):
        ctx.save_for_backward(lhs, rhs, tile_experts, valid_tiles)
        ctx.bm = bm
        return _gmm(lhs, rhs, tile_experts, bm, valid_tiles)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, te, valid_tiles = ctx.saved_tensors
        dout = dout.contiguous()
        dlhs = drhs = None
        # Skipped tiles never touched the operands: the dlhs kernel writes
        # zeros for them through its own skip, and tgmm never adds them.
        if ctx.needs_input_grad[0]:
            dlhs = _gmm(dout, rhs, te, ctx.bm, valid_tiles,
                        transpose_rhs=True).to(lhs.dtype)
        if ctx.needs_input_grad[1]:
            drhs = tgmm(lhs, dout, te, rhs.shape[0], ctx.bm,
                        valid_tiles).to(rhs.dtype)
        return dlhs, drhs, None, None, None


class _GmmSwiglu(torch.autograd.Function):
    """The reference's ``gmm_swiglu`` custom VJP
    (``_gmm_swiglu_fwd``/``_gmm_swiglu_bwd``)."""

    @staticmethod
    def forward(ctx, lhs, rhs_g, rhs_u, tile_experts, bm):
        h, gate, up = _gmm_swiglu(lhs, rhs_g, rhs_u, tile_experts, bm,
                                  gate_up=True)
        ctx.save_for_backward(lhs, rhs_g, rhs_u, tile_experts, gate, up)
        ctx.bm = bm
        return h

    @staticmethod
    def backward(ctx, dh):
        lhs, rhs_g, rhs_u, te, gate, up = ctx.saved_tensors
        bm, dtype = ctx.bm, dh.dtype
        # silu' in f32 on the rounded gate/up/dh, dgate and dup rounded to
        # the operand dtype: the reference's expressions, evaluated in place
        # to hold fewer [M, N] f32 temporaries (on copies: an f32 gate or
        # dh would otherwise be the saved or incoming tensor itself).
        silu = gate.to(torch.float32, copy=True)
        sig = torch.sigmoid(silu)
        silu.mul_(sig)                                  # gate * sigmoid(gate)
        dh32 = dh.to(torch.float32, copy=True)
        dup = (dh32 * silu).to(dtype)
        slope = torch.rsub(sig, 1.0).mul_(silu).add_(sig)  # sig + silu (1 - sig)
        del silu, sig
        dgate = dh32.mul_(up.float()).mul_(slope).to(dtype)
        del dh32, slope
        dlhs = drhs_g = drhs_u = None
        if ctx.needs_input_grad[0]:
            dlhs = (_gmm(dgate, rhs_g, te, bm, transpose_rhs=True)
                    + _gmm(dup, rhs_u, te, bm, transpose_rhs=True)
                    ).to(lhs.dtype)
        if ctx.needs_input_grad[1]:
            drhs_g = tgmm(lhs, dgate, te, rhs_g.shape[0], bm).to(rhs_g.dtype)
        if ctx.needs_input_grad[2]:
            drhs_u = tgmm(lhs, dup, te, rhs_u.shape[0], bm).to(rhs_u.dtype)
        return dlhs, drhs_g, drhs_u, None, None


def _needs_grad(*operands: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in operands)


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, tile_experts: torch.Tensor,
        bm: int, valid_tiles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped matmul: ``out[r] = lhs[r] @ rhs[tile_experts[r // bm]]``.

    lhs [M, K], rhs [E, K, N], tile_experts [M // bm] int32 in [0, E),
    non-decreasing; every bm-row tile belongs to one expert
    (``models/moe.py`` builds this layout).  ``valid_tiles`` ([1] int32,
    optional): tiles at or past it write zeros and take no gradient.
    Differentiable in lhs and rhs."""
    if _needs_grad(lhs, rhs):
        return _Gmm.apply(lhs, rhs, tile_experts, bm, valid_tiles)
    return _gmm(lhs, rhs, tile_experts, bm, valid_tiles)


gmm.launches = 0
gmm.launches_by_design = {"wgmma": 0, "swapab": 0}


def gmm_swiglu(lhs: torch.Tensor, rhs_g: torch.Tensor, rhs_u: torch.Tensor,
               tile_experts: torch.Tensor, bm: int) -> torch.Tensor:
    """Fused grouped SwiGLU: ``silu(lhs @ rhs_g[e]) * (lhs @ rhs_u[e])``
    per row tile, the SwiGLU applied to the f32 products.  Differentiable
    in lhs, rhs_g and rhs_u; without a gradient to take it writes h only."""
    if _needs_grad(lhs, rhs_g, rhs_u):
        return _GmmSwiglu.apply(lhs, rhs_g, rhs_u, tile_experts, bm)
    return _gmm_swiglu(lhs, rhs_g, rhs_u, tile_experts, bm)


gmm_swiglu.launches = 0
gmm_swiglu.launches_by_design = {"wgmma": 0, "swapab": 0}
