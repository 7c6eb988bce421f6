"""RMSNorm and rotate-half RoPE, forward and backward, each as one pass over
the rows (``models/llama.py``'s ``rmsnorm`` and ``apply_rope``).

``norm_rope(x, scale, cos, sin, eps)`` normalises the rows of ``x`` (the
last dim, D) and multiplies by the bf16 ``scale`` [D] where ``scale`` is
given, then rotates them by the f32 tables ``cos``/``sin`` [T, D] where
they are given (``x`` then [B, T, H, D]); one half may be off, not both.
It is one dispatcher op, ``kctpu::norm_rope`` (:data:`norm_rope_op`), with
its own backward, so remat re-runs it as one op.

The rounding places are the plain composition's (:func:`norm_rope_plain`,
the port's ``rmsnorm`` then ``apply_rope``): the normalised row in f32,
rounded to bf16, times the scale, rounded again; the rotation in f32 on
that bf16 value, rounded once.  The backward (:func:`norm_rope_bwd_plain`
writes its arithmetic out) rotates the output's gradient back in f32 and
keeps f32 through the norm's gradient, rounding dx once; the scale's
gradient is summed in f32 and rounded once.

Off the CPU, :func:`norm_rope` launches the hand-written kernels
(``csrc/norm_rope.cu``: one launch forward, one backward plus one for the
scale's gradient; no atomics, so the same bits every run) or raises: it
casts the scale to x's dtype (the plain composition's first step), makes a
strided ``x`` contiguous and runs a DTensor's local shard where its rows
are whole; :func:`norm_rule` says what the kernels take.  Only a tensor
that lies on the CPU (:func:`on_card` false) takes the plain versions.
``norm_rope_fwd.launches`` and ``norm_rope_bwd.launches`` count the calls
on the card, one a call.  In the benchmark's cells a training step under
remat "full" launches the forward twice for each norm and rotation of a
layer (the forward and the re-run) plus once for the final norm, and the
backward once each: Mistral's layer has 4 calls (the two sublayer norms,
q's and k's rotation), Trinity-Mini's 6 (four sublayer norms, q's and k's
norm with their rotation on its windowed layers).  The kernels replace no
Pallas kernel: the JAX package leaves the norm and the rotation to XLA.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch import Tensor

from . import _build

THREADS = 256          # a block of the kernels
MAX_WIDTH = 8192       # the widest row a block holds in registers
FWD_WAVES = 8          # blocks an SM, striding over the rows
BWD_WAVES = 4          # fewer in the backward: one ds partial a block


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _rmsnorm(x: Tensor, scale: Tensor, eps: float) -> Tuple[Tensor, Tensor]:
    """(y, rms [..., 1] f32): the norm in f32, cast back, times the scale
    in x's dtype."""
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rms).to(x.dtype) * scale.to(x.dtype), rms


def rmsnorm_plain(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    """RMSNorm as the port wrote it in plain PyTorch."""
    return _rmsnorm(x, scale, eps)[0]


def rope_plain(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """Rotate-half RoPE, x·cos + [-x2, x1]·sin in f32; x: [B, T, H, D],
    cos/sin: [T, D]."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return (xf * cos[None, :, None] + rot * sin[None, :, None]).to(x.dtype)


def norm_rope_plain(x: Tensor, scale: Optional[Tensor] = None,
                    cos: Optional[Tensor] = None, sin: Optional[Tensor] = None,
                    eps: float = 0.0) -> Tuple[Tensor, Tensor]:
    """(y, rstd): :func:`rmsnorm_plain` where ``scale`` is given, then
    :func:`rope_plain` where ``cos``/``sin`` are; rstd the norm's
    1/rms, f32 one a row (empty without the norm)."""
    rstd = x.new_empty(0, dtype=torch.float32)
    if scale is not None:
        x, rms = _rmsnorm(x, scale, eps)
        rstd = rms.reshape(-1)
    if cos is not None:
        x = rope_plain(x, cos, sin)
    return x, rstd


def _rotate_back(g: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """The rotation's transpose (by -θ) of f32 ``g`` [B, T, H, D]."""
    c, s = cos[None, :, None], sin[None, :, None]
    g1, g2 = g.chunk(2, dim=-1)
    c1, c2 = c.chunk(2, dim=-1)
    s1, s2 = s.chunk(2, dim=-1)
    return torch.cat([g1 * c1 + g2 * s2, g2 * c2 - g1 * s1], dim=-1)


def norm_rope_bwd_plain(x: Optional[Tensor], scale: Optional[Tensor],
                        cos: Optional[Tensor], sin: Optional[Tensor],
                        rstd: Optional[Tensor], dy: Tensor
                        ) -> Tuple[Tensor, Optional[Tensor]]:
    """(dx in dy's dtype, dscale in scale's dtype or None): the kernel's
    backward arithmetic, in f32 (f64 for f64 operands).  g = dy rotated
    back; x̂ = x·rstd; dx = rstd·(g·s - x̂·mean(g·s·x̂));
    ds = Σ_rows g·x̂ rounded to x's dtype.  The rotation alone reads
    neither x nor rstd (either may be None)."""
    acc = torch.promote_types(dy.dtype, torch.float32)
    g = dy.to(acc)
    if cos is not None:
        g = _rotate_back(g, cos, sin)
    if scale is None:
        return g.to(dy.dtype), None
    d = x.shape[-1]
    r = rstd.reshape(*x.shape[:-1], 1)
    xhat = x.to(acc) * r
    ds = (g * xhat.to(x.dtype).to(acc)).reshape(-1, d).sum(dim=0)
    gs = g * scale.to(acc)
    m = (gs * xhat).sum(dim=-1, keepdim=True) / d
    dx = r * (gs - xhat * m)
    return dx.to(x.dtype), ds.to(scale.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _dtensor(*ts) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, DTensor) for t in ts)


def on_card(x: Tensor) -> bool:
    """Whether the model hands ``x``'s norm and rotation to :func:`norm_rope`
    (any device but the CPU, whose tensors keep the plain composition)."""
    return x.device.type != "cpu"


def norm_rule(x: Tensor, scale: Optional[Tensor] = None,
              cos: Optional[Tensor] = None,
              sin: Optional[Tensor] = None) -> Optional[str]:
    """Why the kernels cannot take these operands, wherever they lie, or
    None when they can: plain (not DTensor) tensors on one device, 16-byte
    aligned; ``x`` bf16 and contiguous, its last dim D a multiple of 8 up to
    :data:`MAX_WIDTH`, fewer than 2**31 rows; ``scale`` bf16 [D]; ``cos``
    and ``sin`` both or neither, f32 [T, D] with no gradient, ``x`` then
    [B, T, H, D] with D a multiple of 16; the norm or the rotation, or
    both."""
    if scale is None and cos is None:
        return "neither the norm nor the rotation"
    if (cos is None) != (sin is None):
        return "the rotation takes cos and sin together"
    given = [t for t in (x, scale, cos, sin) if t is not None]
    if _dtensor(*given):
        return "a DTensor operand (norm_rope runs its local shard)"
    if any(t.device != x.device for t in given):
        return "the operands are on more than one device"
    if x.dtype != torch.bfloat16:
        return f"x must be bf16, got {x.dtype}"
    if x.dim() < 1 or x.numel() == 0:
        return f"x {tuple(x.shape)} has no rows"
    d = x.shape[-1]
    if d % 8 or d > MAX_WIDTH:
        return f"the row width {d} is not a multiple of 8 up to {MAX_WIDTH}"
    if x.numel() // d >= 2 ** 31:
        return f"{x.numel() // d} rows: the kernels take fewer than 2**31"
    if not x.is_contiguous():
        return "x must be contiguous"
    if any(t.data_ptr() % 16 for t in given):
        return "every operand must be 16-byte aligned"
    if scale is not None and (scale.dtype != torch.bfloat16
                              or tuple(scale.shape) != (d,)
                              or not scale.is_contiguous()):
        return (f"the scale must be contiguous bf16 [{d}], got "
                f"{scale.dtype} {tuple(scale.shape)}")
    if cos is not None:
        if x.dim() != 4 or d % 16:
            return (f"the rotation takes x [B, T, H, D] with D a multiple "
                    f"of 16, got {tuple(x.shape)}")
        want = (x.shape[1], d)
        for name, t in (("cos", cos), ("sin", sin)):
            if (t.dtype != torch.float32 or tuple(t.shape) != want
                    or not t.is_contiguous() or t.requires_grad):
                return (f"{name} must be contiguous f32 {list(want)} with no "
                        f"gradient, got {t.dtype} {tuple(t.shape)}")
    return None


def row_threads(d: int, rope: bool) -> int:
    """Threads a row of width ``d``: the power of two at or above its
    units (8 elements each, a pair of them with the rotation), at most a
    block."""
    units = d // (16 if rope else 8)
    g = 1
    while g < units and g < THREADS:
        g *= 2
    return g


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _blocks(rows: int, g: int, waves: int, device: torch.device) -> int:
    """Blocks a launch: one a group of rows, at most ``waves`` an SM."""
    return min(-(-rows // (THREADS // g)),
               waves * _sm_count(device.index or 0))


def _ptr(t: Optional[Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(x, scale, cos, sin, *more) -> None:
    """Everything the kernels assume, checked before any pointer crosses
    into C.  ``more`` are (name, tensor, dtype, shape) tuples."""
    reason = norm_rule(x, scale, cos, sin)
    if reason is not None:
        raise ValueError(f"norm_rope kernel: {reason}")
    for name, t, dtype, shape in more:
        if t.device != x.device or t.dtype != dtype or \
                tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"norm_rope kernel: {name} must be contiguous "
                             f"{dtype} {tuple(shape)} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _geometry(x: Tensor, rope: bool) -> Tuple[int, int, int, int]:
    """(rows, D, heads, T) of ``x``; heads and T are 1 without the
    rotation."""
    d = x.shape[-1]
    heads, seq = (x.shape[2], x.shape[1]) if rope else (1, 1)
    return x.numel() // d, d, heads, seq


def norm_rope_fwd(x: Tensor, scale: Optional[Tensor], cos: Optional[Tensor],
                  sin: Optional[Tensor], eps: float) -> Tuple[Tensor, Tensor]:
    """(y, rstd): the forward (see the module's docstring)."""
    if x.device.type == "cpu":
        return norm_rope_plain(x, scale, cos, sin, eps)
    _check(x, scale, cos, sin)
    rope = cos is not None
    rows, d, heads, seq = _geometry(x, rope)
    g = row_threads(d, rope)
    y = torch.empty_like(x)
    rstd = torch.empty(rows if scale is not None else 0,
                       dtype=torch.float32, device=x.device)
    lib = _build.library()
    code = lib.lib.kctpu_norm_rope_fwd(
        _ptr(x), _ptr(scale), _ptr(cos), _ptr(sin), _ptr(y),
        _ptr(rstd) if scale is not None else None, rows, d, g,
        _blocks(rows, g, FWD_WAVES, x.device), heads, seq, float(eps),
        _build.stream(x))
    lib.check(code, "norm_rope_fwd")
    norm_rope_fwd.launches += 1
    return y, rstd


norm_rope_fwd.launches = 0


def norm_rope_bwd(x: Optional[Tensor], scale: Optional[Tensor],
                  cos: Optional[Tensor], sin: Optional[Tensor],
                  rstd: Optional[Tensor], dy: Tensor
                  ) -> Tuple[Tensor, Optional[Tensor]]:
    """(dx, dscale or None): the backward of :func:`norm_rope_fwd` from the
    output's gradient ``dy``; ``x`` and ``rstd`` are read with the norm
    only (None without it)."""
    if dy.device.type == "cpu":
        return norm_rope_bwd_plain(x, scale, cos, sin, rstd, dy)
    dy = dy.contiguous()
    rope, norm = cos is not None, scale is not None
    if not norm:
        x = rstd = None
    like = x if norm else dy
    rows, d, heads, seq = _geometry(like, rope)
    _check(like, scale, cos, sin, ("dy", dy, like.dtype, like.shape),
           *((("rstd", rstd, torch.float32, (rows,)),) if norm else ()))
    g = row_threads(d, rope)
    blocks = _blocks(rows, g, BWD_WAVES, dy.device)
    dx = torch.empty_like(dy)
    partial = dscale = None
    if norm:
        partial = torch.empty((blocks, d), dtype=torch.float32,
                              device=dy.device)
        dscale = torch.empty_like(scale)
    lib = _build.library()
    code = lib.lib.kctpu_norm_rope_bwd(
        _ptr(x), _ptr(scale), _ptr(rstd), _ptr(cos), _ptr(sin), _ptr(dy),
        _ptr(dx), _ptr(partial), _ptr(dscale), rows, d, g, blocks, heads,
        seq, _build.stream(dy))
    lib.check(code, "norm_rope_bwd")
    norm_rope_bwd.launches += 1
    return dx, dscale


norm_rope_bwd.launches = 0


# ---------------------------------------------------------------------------
# The differentiable op
# ---------------------------------------------------------------------------

# One dispatcher op with its own backward: remat re-runs it as one op, and
# a policy decides on it as on one.  Every device goes through the
# module-level wrappers (the CPU to the plain versions), so a caller that
# swaps a wrapper swaps the op's too.
@torch.library.custom_op("kctpu::norm_rope", mutates_args=())
def norm_rope_op(x: Tensor, scale: Optional[Tensor], cos: Optional[Tensor],
                 sin: Optional[Tensor], eps: float) -> Tuple[Tensor, Tensor]:
    return norm_rope_fwd(x, scale, cos, sin, eps)


@norm_rope_op.register_fake
def _(x, scale, cos, sin, eps):
    rows = x.numel() // x.shape[-1] if scale is not None else 0
    return torch.empty_like(x), x.new_empty((rows,), dtype=torch.float32)


def _setup_context(ctx, inputs, output):
    # The rotation alone needs neither x nor rstd in its backward.
    x, scale, cos, sin, _ = inputs
    norm = scale is not None
    ctx.save_for_backward(x if norm else None, scale, cos, sin,
                          output[1] if norm else None)


def _backward(ctx, dy, _drstd):
    x, scale, cos, sin, rstd = ctx.saved_tensors
    dx, dscale = norm_rope_bwd(x, scale, cos, sin, rstd, dy)
    return dx, dscale, None, None, None


norm_rope_op.register_autograd(_backward, setup_context=_setup_context)


def norm_rope(x: Tensor, scale: Optional[Tensor] = None,
              cos: Optional[Tensor] = None, sin: Optional[Tensor] = None,
              eps: float = 0.0) -> Tensor:
    """The norm (by ``scale``), then the rotation (by ``cos``/``sin``), in
    one pass each way; differentiable in ``x`` and ``scale``.  The scale is
    cast to x's dtype first, as the plain composition casts it, and a
    strided ``x`` is made contiguous; a DTensor runs on its local shard
    (:func:`_norm_rope_shard`).  What the kernels still cannot take raises
    (:func:`norm_rule`) off the CPU."""
    if _dtensor(x):
        return _norm_rope_shard(x, scale, cos, sin, eps)
    if scale is not None:
        scale = scale.to(x.dtype)
    return norm_rope_op(x.contiguous(), scale, cos, sin, float(eps))[0]


def _norm_rope_shard(x, scale, cos, sin, eps):
    """:func:`norm_rope` of DTensor ``x`` on its local shard, which holds
    whole rows (no mesh dim splits the last dim, none holds partial sums):
    the scale whole on every rank, its gradient the sum of the ranks'
    (partial over each mesh dim that splits x's rows); the tables split
    over T as x is (``models/llama.py:_shard_rope``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, places = x.device_mesh, tuple(x.placements)
    last = x.dim() - 1
    for p in places:
        if p.is_partial() or (p.is_shard() and p.dim in (last, -1)):
            raise ValueError(f"norm_rope: x placed {places} does not hold "
                             f"whole rows on each rank")
    for name, t in (("scale", scale), ("cos", cos), ("sin", sin)):
        if t is not None and (not isinstance(t, DTensor)
                              or t.device_mesh != mesh):
            raise ValueError(f"norm_rope: x is a DTensor on {mesh}, {name} "
                             f"is not one on the same mesh")
    if scale is not None:
        scale = scale.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
            grad_placements=[Partial() if p.is_shard() else Replicate()
                             for p in places])
    if cos is not None:
        want = tuple(Shard(0) if p.is_shard() and p.dim == 1 else Replicate()
                     for p in places)
        for name, t in (("cos", cos), ("sin", sin)):
            if tuple(t.placements) != want:
                raise ValueError(f"norm_rope: {name} placed "
                                 f"{tuple(t.placements)}, x {places}: the "
                                 f"tables must split over T as x does")
        cos, sin = cos.to_local(), sin.to_local()
    y = norm_rope(x.to_local(), scale, cos, sin, eps)
    return DTensor.from_local(y, mesh, places, run_check=False,
                              shape=x.shape, stride=x.stride())
