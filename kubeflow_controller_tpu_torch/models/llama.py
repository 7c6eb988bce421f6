"""Llama decoder building blocks — the port of the serving subset of
``kubeflow_controller_tpu/models/llama.py``.

Parameters live in an ``nn.Module`` tree (``Llama`` -> ``LlamaLayer``)
whose attribute names and per-layer shapes are the JAX pytree's
(``params["layers"]["wq"][i]`` is ``model.layers[i].wq``), so
``bridge.py`` maps one onto the other key by key.  The layer scan becomes
a Python loop over ``model.layers`` in ``models/generate.py``.

The rounding places follow the reference exactly: ``rmsnorm`` normalises
in f32, casts to the activation dtype, then multiplies by the scale cast
to that dtype; RoPE rotates in f32 and casts back.

Forward only: the serving slice takes no gradients, so the parameters are
created with ``requires_grad=False``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch
from torch import nn

from ..device import DeviceLike, resolve_device, torch_dtype
from .moe import moe_ffn, moe_ffn_stats


@dataclass(frozen=True)
class LlamaConfig:
    """A copy of the reference's ``LlamaConfig``: same fields, same
    defaults, so one set of keyword arguments builds either package's
    config.  Fields the serving slice does not read (remat, loss chunking,
    attention choice) are kept for that reason."""

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

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.param_dtype)
        self.cfg = cfg
        self.embed = _param((cfg.vocab_size, cfg.dim), dtype, dev)
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, dev, dtype) for _ in range(cfg.n_layers))
        self.final_norm = _param((cfg.dim,), dtype, dev)
        self.lm_head = _param((cfg.dim, cfg.vocab_size), dtype, dev)


@torch.no_grad()
def llama_init(cfg: LlamaConfig, generator: torch.Generator,
               device: DeviceLike = "cuda") -> Llama:
    """Scaled-normal init (0.02; residual projections scaled by depth),
    the shapes of the reference's ``llama_init``.  ``generator`` must live
    on ``device``.  The draws are not JAX's: tests that compare the two
    packages bridge the JAX parameters instead (``bridge.py``)."""
    model = Llama(cfg, device)
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
