"""Operations and bytes of the layers the benchmark times, from their
shapes, and the peaks they are held against.

Every count here is what the layer's mathematics needs for its inputs,
whatever a kernel does again: each input byte read once and each output
byte written once, the score pairs the causal mask (and a window) keeps,
and the rows that tokens really route (no padding).  A kernel that
recomputes, repeats the kv heads or pads rows is measured against the same
work, so a share of the roofline can only rise when a kernel does less
redundant work.  The model's own counts (its matrix parameters, its
attention layers, its experts) come from its architecture module
(``archs/<model_type>.py``).

A call's least time is ``max(flops / peak FLOP/s, bytes / peak bytes/s)``
(:func:`least_seconds`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from . import archs

# Published dense peaks (NVIDIA's data sheet, H100 SXM, bf16 without
# sparsity; HBM3 bandwidth), at the card's full 700 W limit.
PEAKS: Dict[str, Tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),
}

BF16 = 2
F32 = 4


def peaks(device_name: str) -> Tuple[float, float]:
    """(FLOP/s, bytes/s) of the card named ``device_name``; KeyError for a
    card the table does not hold (no share is read against a guess)."""
    return PEAKS[device_name]


def least_seconds(flops: float, nbytes: float, peak: Tuple[float, float]
                  ) -> float:
    return max(flops / peak[0], nbytes / peak[1])


# ---------------------------------------------------------------------------
# Flash attention: q [B, T, H, D]; k, v [B, T, KV, D]; bf16; lse f32.
# One "product" is one [T, D] x [D, T] (or [T, T] x [T, D]) matrix product
# per (batch, head) over the score pairs the mask keeps: T² / 2 a head under
# the causal mask, and under a causal window of W < T keys (``window``)
# T² / 2 - (T - W)² / 2.
# ---------------------------------------------------------------------------

def _product_flops(b: int, t: int, h: int, d: int, causal: bool,
                   window: Optional[int] = None) -> float:
    full = 2.0 * b * h * t * t * d
    if not causal:
        if window is not None:
            raise ValueError("a window is counted under the causal mask")
        return full
    if window is None or window >= t:
        return full / 2
    return (full - 2.0 * b * h * (t - window) ** 2 * d) / 2


def flash_fwd(b: int, t: int, h: int, kv: int, d: int, causal: bool = True,
              window: Optional[int] = None) -> Tuple[float, float]:
    """(FLOPs, bytes) of the forward: S = QKᵀ and O = PV; reads q, k, v,
    writes o and the row statistics."""
    flops = 2 * _product_flops(b, t, h, d, causal, window)
    nbytes = (2 * b * t * h * d + 2 * b * t * kv * d) * BF16 + b * h * t * F32
    return flops, nbytes


def flash_dkv(b: int, t: int, h: int, kv: int, d: int, causal: bool = True,
              window: Optional[int] = None) -> Tuple[float, float]:
    """(FLOPs, bytes) of the backward but for dQ: S recomputed (the forward
    keeps no [T, T] matrix), dP = dO Vᵀ, dV = Pᵀ dO, dK = dSᵀ Q; reads q, k,
    v, do, lse and delta once for the whole backward, writes dk, dv."""
    flops = 4 * _product_flops(b, t, h, d, causal, window)
    nbytes = ((2 * b * t * h * d + 4 * b * t * kv * d) * BF16
              + 2 * b * h * t * F32)
    return flops, nbytes


def flash_dq(b: int, t: int, h: int, kv: int, d: int, causal: bool = True,
             window: Optional[int] = None) -> Tuple[float, float]:
    """(FLOPs, bytes) of dQ = dS K given the dS that :func:`flash_dkv`
    forms: one product, and dq written.  :func:`flash_dkv` plus this is the
    whole backward's need (five products), which a fused backward also
    does."""
    return (_product_flops(b, t, h, d, causal, window),
            b * t * h * d * BF16)


# ---------------------------------------------------------------------------
# The grouped expert FFN: R routed rows (tokens x top-k, no padding), model
# width d, expert width f, E experts touched; bf16 operands and outputs.
# ---------------------------------------------------------------------------

def experts_touched(rows: int, n_experts: int) -> int:
    """Experts that receive rows: all of them once rows outnumber experts
    many times over (the cells route thousands of rows an expert)."""
    return min(rows, n_experts)


def gmm(rows: int, d: int, f: int, experts: int) -> Tuple[float, float]:
    """One grouped product [R, d] x [E, d, f] (or [R, f] x [E, f, d], or
    the transposed-weight products of the backward): reads the rows and the
    touched experts' weights, writes the outputs."""
    flops = 2.0 * rows * d * f
    nbytes = (rows * d + experts * d * f + rows * f) * BF16
    return flops, nbytes


def gmm_swiglu(rows: int, d: int, f: int, experts: int
               ) -> Tuple[float, float]:
    """silu(x Wg) * (x Wu): two products; reads x and both weights, writes
    the SwiGLU output only."""
    flops = 4.0 * rows * d * f
    nbytes = (rows * d + 2 * experts * d * f + rows * f) * BF16
    return flops, nbytes


def tgmm(rows: int, d: int, f: int, experts: int) -> Tuple[float, float]:
    """The weight gradient [E, d, f] = Σ xᵀ dy over each expert's rows:
    reads both row blocks, writes the touched experts' gradients."""
    flops = 2.0 * rows * d * f
    nbytes = (rows * d + rows * f + experts * d * f) * BF16
    return flops, nbytes


# ---------------------------------------------------------------------------
# The training step's model FLOPs (for MFU)
# ---------------------------------------------------------------------------

def matmul_params_per_token(conf: dict) -> int:
    """Parameters in the matrix products each token passes through, as the
    configuration's architecture counts them (``archs/<model_type>.py``)."""
    return archs.of(conf).matmul_params_per_token(conf)


def model_flops_per_token(conf: dict, seq_len: int) -> float:
    """The model FLOPs a token of a ``seq_len`` row costs in a training
    step (forward and backward; recomputation not counted), as the
    configuration's architecture counts them."""
    return archs.of(conf).model_flops_per_token(conf, seq_len)
