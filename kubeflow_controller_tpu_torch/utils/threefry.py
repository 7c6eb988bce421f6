"""JAX's default PRNG on tensors: the port's copy of the threefry2x32
draws that ``jax.random`` makes under JAX 0.9.0 with
``jax_default_prng_impl = "threefry2x32"`` and ``jax_threefry_partitionable
= True`` (JAX's defaults there), so that a generator written against
``jax.random`` draws the same numbers in the port.

- :func:`prng_key` is ``jax.random.PRNGKey(seed)``: the seed's high and low
  32-bit words.
- :func:`split` is ``jax.random.split`` (the fold-like split of the
  partitionable scheme): key ``i`` is the hash of the 64-bit counter ``i``.
- :func:`random_bits` is the 32-bit ``random_bits``: per element, the two
  words of ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))`` over the
  element's flat index ``i``, xored.
- :func:`randint` is ``jax.random.randint`` for int32: two subkeys, higher
  and lower bits, reduced into the span by its multiply-mod.
- :func:`uniform` is ``jax.random.uniform``: 23 mantissa bits under the
  exponent of 1.0, minus 1, scaled into ``[minval, maxval)``.
- :func:`normal` is ``jax.random.normal``: ``sqrt(2) * erfinv(u)`` for ``u``
  uniform in ``[nextafter(-1, 0), 1)``, where ``erfinv`` is XLA's
  single-precision one (Giles' polynomial, :func:`erfinv_f32`).

Everything is exact to the bit but ``normal``: XLA computes the
polynomial's ``log1p`` with its own approximation, torch with the
platform's, so a draw may differ from JAX's in its last bits (the port's
tests state the bound).  Where XLA fuses a multiply and an add into one
rounding (``uniform``'s scaling, the erfinv polynomial), the port rounds
once too, through f64 (:func:`_fma`).

A key is a ``[2]`` int64 tensor of two 32-bit words, on any device.  The
uint32 arithmetic runs in int64 under a ``0xFFFFFFFF`` mask (torch's
``uint32`` lacks most operations), every step is a tensor operation with
no host sync, and nothing keeps state: the draws can be captured in a CUDA
graph.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# Giles' single-precision erfinv coefficients, as XLA's ErfInv32 has them:
# (w < 5, w >= 5), highest degree first.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_SQRT2_F32 = float(np.float32(np.sqrt(2)))
_NEXT_BELOW_ONE = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def prng_key(seed: int, device: DeviceLike = "cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: ``[seed >> 32, seed & 0xFFFFFFFF]``
    (a negative seed as its 64-bit two's complement)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    # Filled on the device, not copied from the host (a copy would sync,
    # and a CUDA graph cannot hold it).
    key = torch.full((2,), seed & MASK, dtype=torch.int64,
                     device=resolve_device(device))
    key[:1].fill_(seed >> 32)
    return key


def _const(value: float, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """A 0-d constant filled on ``device`` (no host copy)."""
    return torch.full((), value, dtype=dtype, device=device)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in f32 with one rounding, as XLA fuses it: the f32
    product is exact in f64, and the f64 sum rounds to f32 (a second
    rounding that can differ from a true fused one only at an f32
    midpoint)."""
    return (a.double() * b.double() + c.double()).float()


def threefry2x32(key: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple:
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x0,
    x1)`` under ``key``, elementwise: two int64 tensors of 32-bit words
    (new tensors; the counters are not changed)."""
    k0, k1 = key[0], key[1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]).bitwise_and_(MASK)
    x1 = (x1 + ks[1]).bitwise_and_(MASK)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            # x1 = rotl(x1, r) ^ x0, in place
            high = x1 << r
            x1.bitwise_right_shift_(32 - r).bitwise_or_(high)
            x1.bitwise_and_(MASK).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(MASK)
    return x0, x1


def _counters(shape: Sequence[int], device: torch.device) -> tuple:
    """The 64-bit flat index of every element of ``shape`` as its (high,
    low) 32-bit words."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=device).reshape(tuple(shape))
    return idx >> 32, idx & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``[num, 2]`` keys."""
    hi, lo = _counters((num,), key.device)
    b0, b1 = threefry2x32(key, hi, lo)
    return torch.stack([b0, b1], dim=1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit ``random_bits(key, 32, shape)`` as int64 in ``[0, 2**32)``."""
    hi, lo = _counters(shape, key.device)
    b0, b1 = threefry2x32(key, hi, lo)
    return b0 ^ b1


def _mulmod32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2**32`` for 32-bit words, in 16-bit halves of ``b`` so
    that no int64 product overflows."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 draws,
    ``minval`` and ``maxval`` in int32's range) as int64."""
    if maxval <= minval:
        return torch.full(tuple(shape), minval, dtype=torch.int64,
                          device=key.device)
    span = (maxval - minval) & MASK
    keys = split(key)
    higher = random_bits(keys[0], shape)
    lower = random_bits(keys[1], shape)
    # 2**32 mod span as XLA computes it, in wrapping uint32 products.
    multiplier = (2 ** 16) % span
    multiplier = ((multiplier * multiplier) & MASK) % span
    offset = (_mulmod32(higher % span, multiplier) + lower % span) & MASK
    offset = offset % span
    # minval + offset in int32, wrapping as XLA's add does.
    return ((minval + offset + 2 ** 31) & MASK) - 2 ** 31


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape)
    one = 0x3F800000                              # 1.0f's bits
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo = _const(minval, torch.float32, key.device)
    hi = _const(maxval, torch.float32, key.device)
    return torch.maximum(lo, _fma(floats, hi - lo, lo))


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's single-precision ``erf_inv`` (Giles' approximation): ``w =
    -log1p(-x * x)``, a degree-8 polynomial in ``w - 2.5`` (``w < 5``) or
    ``sqrt(w) - 3`` by Horner's rule in fused multiply-adds, times ``x``;
    ``±inf`` at ``|x| = 1``."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coefficient(i):
        return torch.where(lt, _const(_ERFINV_LT5[i], x.dtype, x.device),
                           _const(_ERFINV_GE5[i], x.dtype, x.device))

    p = coefficient(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, coefficient(i))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``."""
    u = uniform(key, shape, _NEXT_BELOW_ONE, 1.0)
    return erfinv_f32(u) * _SQRT2_F32
