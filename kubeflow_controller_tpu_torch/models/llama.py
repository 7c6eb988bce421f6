"""Llama decoder — the port of ``kubeflow_controller_tpu/models/llama.py``:
the building blocks the serving slice uses, and the single-device training
forward and loss (``llama_forward``, ``llama_loss``, ``_chunked_ce``).

Parameters live in an ``nn.Module`` tree (``Llama`` -> ``LlamaLayer``)
whose attribute names and per-layer shapes are the JAX pytree's
(``params["layers"]["wq"][i]`` is ``model.layers[i].wq``), so
``bridge.py`` maps one onto the other key by key.  The layer scan becomes
a Python loop over ``model.layers``.

The rounding places follow the reference exactly: ``rmsnorm`` normalises
in f32, casts to the activation dtype, then multiplies by the scale cast
to that dtype; RoPE rotates in f32 and casts back; f32 parameters are cast
to the activation dtype where they are used; logits and the loss are f32.

Parameters are created with ``requires_grad=False`` (the serving default);
training asks for gradients (``Llama(..., requires_grad=True)``).

Not ported yet, and raising ``NotImplementedError`` (ROADMAP.md): a mesh
(multi-device pretrain), the named remat policies other than ``"full"``,
and MoE layers under autograd (M1).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, replace
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device, torch_dtype
from ..ops.attention import TILE, flash_attention, kernel_rule
from ..parallel.ring import attention_reference
from .moe import moe_ffn, moe_ffn_stats


@dataclass(frozen=True)
class LlamaConfig:
    """A copy of the reference's ``LlamaConfig``: same fields, same
    defaults, so one set of keyword arguments builds either package's
    config.  Fields the port does not read yet (``sp_attention``,
    ``capacity_factor`` of the einsum dispatch) are kept for that reason."""

    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    intermediate: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"        # activation dtype
    param_dtype: str = "float32"
    remat: bool = True
    n_experts: int = 0
    moe_top_k: int = 2
    capacity_factor: float = 1.25
    moe_aux_coef: float = 1e-2
    moe_z_coef: float = 1e-3
    moe_dispatch: str = "einsum"
    remat_policy: str = "full"
    loss_chunks: int = 0
    attention: str = "auto"
    sp_attention: str = "ring"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def tiny(**overrides) -> "LlamaConfig":
        """Test-sized config; same code path as the full-size ones."""
        cfg = LlamaConfig(
            vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            intermediate=128, max_seq_len=128, dtype="float32", remat=False,
        )
        return replace(cfg, **overrides)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class LlamaLayer(nn.Module):
    """One decoder layer's parameters, named as the JAX pytree's
    ``params["layers"]`` keys (without the leading layer axis)."""

    def __init__(self, cfg: LlamaConfig, device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        d, hd, nh, nkv = cfg.dim, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        f = cfg.intermediate
        self.attn_norm = _param((d,), dtype, device)
        self.wq = _param((d, nh, hd), dtype, device)
        self.wk = _param((d, nkv, hd), dtype, device)
        self.wv = _param((d, nkv, hd), dtype, device)
        self.wo = _param((nh, hd, d), dtype, device)
        self.mlp_norm = _param((d,), dtype, device)
        if cfg.n_experts:
            e = cfg.n_experts
            self.router = _param((d, e), dtype, device)
            self.w_gate = _param((e, d, f), dtype, device)
            self.w_up = _param((e, d, f), dtype, device)
            self.w_down = _param((e, f, d), dtype, device)
        else:
            self.w_gate = _param((d, f), dtype, device)
            self.w_up = _param((d, f), dtype, device)
            self.w_down = _param((f, d), dtype, device)


class Llama(nn.Module):
    """The parameter tree: ``embed``, ``layers``, ``final_norm``,
    ``lm_head`` — the JAX pytree's top-level keys."""

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = "cuda",
                 requires_grad: bool = False):
        super().__init__()
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.param_dtype)
        self.cfg = cfg
        self.embed = _param((cfg.vocab_size, cfg.dim), dtype, dev)
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, dev, dtype) for _ in range(cfg.n_layers))
        self.final_norm = _param((cfg.dim,), dtype, dev)
        self.lm_head = _param((cfg.dim, cfg.vocab_size), dtype, dev)
        self.requires_grad_(requires_grad)


@torch.no_grad()
def llama_init(cfg: LlamaConfig, generator: torch.Generator,
               device: DeviceLike = "cuda",
               requires_grad: bool = False) -> Llama:
    """Scaled-normal init (0.02; residual projections scaled by depth),
    the shapes of the reference's ``llama_init``.  ``generator`` must live
    on ``device``.  The draws are not JAX's: tests that compare the two
    packages bridge the JAX parameters instead (``bridge.py``)."""
    model = Llama(cfg, device, requires_grad)
    resid_scale = 0.02 / (2 * cfg.n_layers) ** 0.5

    def normal_(p: nn.Parameter, scale: float = 0.02) -> None:
        # Draw in f32 and round once, as the reference casts its f32 draw.
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32) * scale)

    normal_(model.embed)
    for lp in model.layers:
        lp.attn_norm.fill_(1.0)
        lp.mlp_norm.fill_(1.0)
        for p in (lp.wq, lp.wk, lp.wv):
            normal_(p)
        normal_(lp.wo, resid_scale)
        if cfg.n_experts:
            normal_(lp.router)
        normal_(lp.w_gate)
        normal_(lp.w_up)
        normal_(lp.w_down, resid_scale)
    model.final_norm.fill_(1.0)
    normal_(model.lm_head)
    return model


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rms).to(x.dtype) * scale.to(x.dtype)


def rope_freqs(cfg: LlamaConfig, positions: torch.Tensor) -> torch.Tensor:
    """[T, head_dim//2] rotation angles (f32) for absolute ``positions``."""
    exps = torch.arange(0, cfg.head_dim, 2, dtype=torch.float32,
                        device=positions.device) / cfg.head_dim
    inv = 1.0 / torch.pow(cfg.rope_theta, exps)
    return positions[:, None].float() * inv[None, :]


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE; x: [B, T, H, D], angles: [T, D//2]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def ffn_block(h: torch.Tensor, lp: LlamaLayer,
              cfg: LlamaConfig) -> torch.Tensor:
    """SwiGLU FFN or MoE on [B, T, D] activations."""
    if cfg.n_experts:
        return moe_ffn(h, lp.router, lp.w_gate, lp.w_up, lp.w_down,
                       top_k=cfg.moe_top_k, dispatch=cfg.moe_dispatch)
    dtype = h.dtype
    gate = torch.einsum("btd,df->btf", h, lp.w_gate.to(dtype))
    up = torch.einsum("btd,df->btf", h, lp.w_up.to(dtype))
    ff = nn.functional.silu(gate) * up
    return torch.einsum("btf,fd->btd", ff, lp.w_down.to(dtype))


def ffn_block_stats(h: torch.Tensor, lp: LlamaLayer, cfg: LlamaConfig):
    """MoE FFN returning (y, router stats) — see ``moe.moe_ffn_stats``."""
    return moe_ffn_stats(
        h, lp.router, lp.w_gate, lp.w_up, lp.w_down,
        top_k=cfg.moe_top_k, capacity_factor=cfg.capacity_factor,
        dispatch=cfg.moe_dispatch)


# ---------------------------------------------------------------------------
# Attention choice
# ---------------------------------------------------------------------------

# "auto" takes the flash kernels on CUDA from this sequence length up.  The
# reference's gate (TPU and T >= 1024) is a TPU measurement; the value is
# kept until the H100 numbers in PERF.md say where the kernels win.
FLASH_AUTO_MIN_T = 1024

_MESH_NOT_PORTED = ("multi-device pretrain (a mesh) is not ported yet "
                    "(ROADMAP.md, module queue: multi-device pretrain over "
                    "parallel/mesh.py and sharding.py)")

_FLASH_FALLBACK_WARNED: set = set()


def _warn_flash_fallback(t: int, dtype, head_dim: int) -> None:
    """One-time (per shape/dtype) warning when an explicit
    ``attention="flash"`` request degrades to the plain attention path
    because the CUDA kernels do not take the operands (``kernel_rule``):
    the reference warns the same way when no legal flash tile exists."""
    key = (int(t), str(dtype), int(head_dim))
    if key in _FLASH_FALLBACK_WARNED:
        return
    _FLASH_FALLBACK_WARNED.add(key)
    warnings.warn(
        f"attention='flash' requested but the CUDA flash kernels do not take "
        f"T={t} dtype={dtype} head_dim={head_dim} (they take bf16, head_dim "
        f"64 or 128, T a multiple of {TILE}); falling back to the plain "
        f"attention path", stacklevel=3)


def _attention(q, k, v, causal: bool, cfg: Optional[LlamaConfig] = None):
    """The flash kernels where they apply (``_flash_path``), else the f32
    reference attention: the reference's single-device branch (its
    sequence-parallel branches need a mesh, not ported yet)."""
    if cfg is not None and cfg.attention in ("auto", "flash"):
        out = _flash_path(q, k, v, causal, cfg)
        if out is not None:
            return out
    return attention_reference(q, k, v, causal=causal)


def _flash_path(q, k, v, causal: bool, cfg: LlamaConfig):
    """``flash_attention`` when applicable, or None for the plain path.

    "auto" applies it on CUDA at T >= ``FLASH_AUTO_MIN_T``; "flash" forces
    it, and warns when the operands fail the kernels' rule (on the CPU the
    plain versions take any shape)."""
    t = q.shape[1]
    if cfg.attention == "auto" and (q.device.type != "cuda"
                                    or t < FLASH_AUTO_MIN_T):
        return None
    if q.device.type != "cpu" and kernel_rule(q, k, v) is not None:
        if cfg.attention == "flash":
            _warn_flash_fallback(t, q.dtype, q.shape[-1])
        return None
    return flash_attention(q, k, v, causal=causal)


# ---------------------------------------------------------------------------
# Forward and loss
# ---------------------------------------------------------------------------

def _decoder_layer_fn(cfg: LlamaConfig, angles: torch.Tensor):
    """One decoder layer as ``(x, lp) -> (x, aux)`` where ``aux`` is the
    layer's MoE router stats (zeros for dense layers)."""
    dtype = torch_dtype(cfg.dtype)
    repeats = cfg.n_heads // cfg.n_kv_heads

    def layer(x, lp: LlamaLayer):
        h = rmsnorm(x, lp.attn_norm, cfg.norm_eps)
        q = torch.einsum("btd,dhk->bthk", h, lp.wq.to(dtype))
        k = torch.einsum("btd,dhk->bthk", h, lp.wk.to(dtype))
        v = torch.einsum("btd,dhk->bthk", h, lp.wv.to(dtype))
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
        if repeats > 1:  # GQA: expand kv heads to query heads (jnp.repeat)
            k = k.repeat_interleave(repeats, dim=2)
            v = v.repeat_interleave(repeats, dim=2)
        attn = _attention(q, k, v, causal=True, cfg=cfg)
        x = x + torch.einsum("bthk,hkd->btd", attn, lp.wo.to(dtype))

        h = rmsnorm(x, lp.mlp_norm, cfg.norm_eps)
        if cfg.n_experts:
            ff, aux = ffn_block_stats(h, lp, cfg)
        else:
            ff = ffn_block(h, lp, cfg)
            zero = torch.zeros((), device=x.device)
            aux = {"aux_loss": zero, "z_loss": zero, "overflow_frac": zero}
        return x + ff, aux

    return layer


_NAMED_POLICIES = ("dots", "ffn", "gateup", "gateup_attn", "moe")


def _maybe_remat(layer, cfg: LlamaConfig):
    """``remat=False``: the layer as is.  ``"full"``: the layer under
    ``torch.utils.checkpoint`` (non-reentrant), saving only its input; the
    backward recomputes the rest, flash forward included."""
    if not cfg.remat:
        return layer
    if cfg.remat_policy == "full":
        def remat_layer(x, lp):
            return checkpoint(layer, x, lp, use_reentrant=False)
        return remat_layer
    if cfg.remat_policy in _NAMED_POLICIES:
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported yet (ROADMAP.md, "
            f"faults queue); the port has remat=False and 'full'")
    raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; expected "
                     f"one of {sorted(('full',) + _NAMED_POLICIES)}")


def llama_forward(model: Llama, tokens: torch.Tensor, cfg: LlamaConfig,
                  mesh=None, *, return_aux: bool = False,
                  return_hidden: bool = False):
    """tokens [B, T] int -> logits [B, T, vocab] f32.

    With ``return_aux=True`` also returns the MoE router stats averaged
    over layers ({aux_loss, z_loss, overflow_frac}, zeros for dense).
    With ``return_hidden=True`` returns the final-norm hidden states
    [B, T, dim] instead of logits (the chunked loss applies lm_head itself,
    chunk by chunk)."""
    if mesh is not None:
        raise NotImplementedError(_MESH_NOT_PORTED)
    if (cfg.n_experts and torch.is_grad_enabled()
            and any(p.requires_grad for p in model.parameters())):
        raise NotImplementedError(
            "MoE training is not ported yet (ROADMAP.md, M1: the gmm / "
            "gmm_swiglu VJPs and the tgmm kernels)")
    dtype = torch_dtype(cfg.dtype)
    t = tokens.shape[1]
    x = model.embed[tokens.long()].to(dtype)
    angles = rope_freqs(cfg, torch.arange(t, device=tokens.device))
    layer_fn = _maybe_remat(_decoder_layer_fn(cfg, angles), cfg)
    auxes = []
    for lp in model.layers:
        x, aux = layer_fn(x, lp)
        auxes.append(aux)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    if return_hidden:
        out = x
    else:
        out = torch.einsum("btd,dv->btv", x, model.lm_head.to(dtype)).float()
    if return_aux:
        return out, {key: torch.stack([a[key] for a in auxes]).mean()
                     for key in auxes[0]}
    return out


def llama_loss(model: Llama, tokens: torch.Tensor, cfg: LlamaConfig,
               mesh=None) -> torch.Tensor:
    """Next-token cross-entropy, mean over all positions; for MoE configs
    plus the router losses weighted by ``moe_aux_coef``/``moe_z_coef``.
    With ``cfg.loss_chunks > 0`` the CE is computed chunk by chunk without
    materialising the full [B, T, vocab] f32 logits."""
    aux = None
    if cfg.loss_chunks:
        out = llama_forward(model, tokens, cfg, mesh,
                            return_aux=bool(cfg.n_experts), return_hidden=True)
        h, aux = out if cfg.n_experts else (out, None)
        ce = _chunked_ce(h, model.lm_head, tokens, cfg)
    else:
        out = llama_forward(model, tokens, cfg, mesh,
                            return_aux=bool(cfg.n_experts))
        logits, aux = out if cfg.n_experts else (out, None)
        targets = tokens[:, 1:].long()
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        nll = -logp.gather(-1, targets[..., None])
        ce = nll.mean()
    if cfg.n_experts:
        return (ce + cfg.moe_aux_coef * aux["aux_loss"]
                + cfg.moe_z_coef * aux["z_loss"])
    return ce


def _chunked_ce(h: torch.Tensor, lm_head: torch.Tensor, tokens: torch.Tensor,
                cfg: LlamaConfig) -> torch.Tensor:
    """Next-token CE over ``cfg.loss_chunks`` sequence chunks, each under
    ``torch.utils.checkpoint``: the backward recomputes a chunk's logits
    from its saved [B, C, D] hidden slice, so one chunk's logits live at a
    time.  The final position has no next token: its weight is zero,
    matching the dense path's mean over positions [0, T-1)."""
    b, t, _ = h.shape
    n = cfg.loss_chunks
    if t % n:
        raise ValueError(f"seq len {t} not divisible by loss_chunks {n}")
    dtype = h.dtype
    tgt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1).long()
    weight = torch.ones((b, t), dtype=torch.float32, device=h.device)
    weight[:, -1] = 0.0

    def chunk(xc, w, tc, wc):
        logits = torch.einsum("bcd,dv->bcv", xc, w.to(dtype)).float()
        lse = torch.logsumexp(logits, dim=-1)
        t_logit = logits.gather(-1, tc[..., None])[..., 0]
        return torch.sum((lse - t_logit) * wc)

    c = t // n
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        total = total + checkpoint(chunk, h[:, sl], lm_head, tgt[:, sl],
                                   weight[:, sl], use_reentrant=False)
    return total / torch.sum(weight)
