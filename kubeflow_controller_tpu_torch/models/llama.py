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

MoE layers train through the same path: their expert FFN is
``models/moe.py`` (``cfg.moe_dispatch``, the grouped kernels' custom
backward; under a mesh, per shard over ep), and ``llama_loss`` adds the
router losses.

Remat: every policy of the reference (``"full"``, ``"dots"``, ``"ffn"``,
``"gateup"``, ``"gateup_attn"``, ``"moe"``) as selective activation
checkpointing (``models/remat.py``); the ``checkpoint_name`` scopes sit
where the reference names its values.  The products with no batch dims
(the projections, the dense FFN, the logits) are 2-D matmuls.
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
from ..parallel.mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_PIPELINE,
    AXIS_SEQUENCE,
    AXIS_TENSOR,
)
from ..parallel.ring import attention_reference
from ..parallel.sharding import (
    DEFAULT_RULES,
    ShardingRules,
    grad_placed,
    placements_for,
    shard_pytree_specs,
    with_logical_constraint,
)
from .moe import moe_ffn, moe_ffn_stats
from .remat import checkpoint_name, remat


@dataclass(frozen=True)
class LlamaConfig:
    """A copy of the reference's ``LlamaConfig``: same fields, same
    defaults, so one set of keyword arguments builds either package's
    config.  Fields the port does not read yet (``sp_attention``) are kept
    for that reason."""

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
               device: DeviceLike = "cuda", requires_grad: bool = False,
               mesh=None, rules: ShardingRules = DEFAULT_RULES) -> Llama:
    """Scaled-normal init (0.02; residual projections scaled by depth),
    the shapes of the reference's ``llama_init``.  ``generator`` must live
    on ``device``.  The draws are not JAX's: tests that compare the two
    packages bridge the JAX parameters instead (``bridge.py``).

    With ``mesh``, the model is built already sharded, one parameter at a
    time (the reference's ``jax.jit(llama_init, out_shardings=...)``): the
    module is made on the ``meta`` device, and each parameter, in the draw
    order above, is drawn whole in f32, split into this process's shard
    with ``shard_llama``'s placements and dropped before the next draw.
    Every process draws the same values from the same seed, so no
    collective runs, and the shards equal ``llama_init`` followed by
    ``shard_llama`` bit for bit, while one full parameter at most is
    alive at a time."""
    resid_scale = 0.02 / (2 * cfg.n_layers) ** 0.5
    if mesh is None:
        model = Llama(cfg, device, requires_grad)

        def normal_(p: nn.Parameter, scale: float = 0.02) -> None:
            # Draw in f32 and round once, as the reference casts its f32
            # draw.
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device, dtype=torch.float32) * scale)

        def ones_(p: nn.Parameter) -> None:
            p.fill_(1.0)
    else:
        model = Llama(cfg, "meta", requires_grad)
        dev = resolve_device(device)
        placed = _placements(model, model_mesh(mesh), rules)

        def _shard(p: nn.Parameter, full: torch.Tensor) -> None:
            module, name, sub, placements = placed[id(p)]
            d = _distribute(full, sub, placements).to(p.dtype)
            setattr(module, name, nn.Parameter(d,
                                               requires_grad=requires_grad))

        def normal_(p: nn.Parameter, scale: float = 0.02) -> None:
            full = torch.randn(p.shape, generator=generator, device=dev,
                               dtype=torch.float32).mul_(scale)
            _shard(p, full)

        def ones_(p: nn.Parameter) -> None:
            _shard(p, torch.ones(p.shape, device=dev, dtype=torch.float32))

    normal_(model.embed)
    for lp in model.layers:
        ones_(lp.attn_norm)
        ones_(lp.mlp_norm)
        for p in (lp.wq, lp.wk, lp.wv):
            normal_(p)
        normal_(lp.wo, resid_scale)
        if cfg.n_experts:
            normal_(lp.router)
        normal_(lp.w_gate)
        normal_(lp.w_up)
        normal_(lp.w_down, resid_scale)
    ones_(model.final_norm)
    normal_(model.lm_head)
    return model


def llama_param_logical_axes(cfg: LlamaConfig) -> dict:
    """Logical axis names per parameter, the reference's tree (layer
    parameters with their leading ``"layers"`` axis)."""
    if cfg.n_experts:
        ffn = {
            "router": ("layers", "embed", None),
            "w_gate": ("layers", "expert", "embed", "mlp"),
            "w_up": ("layers", "expert", "embed", "mlp"),
            "w_down": ("layers", "expert", "mlp", "embed"),
        }
    else:
        ffn = {
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        }
    return {
        # Vocab-parallel table: the indexed dim is sharded, so the lookup
        # is ``F.embedding``'s mask-and-reduce over the vocab shards.
        "embed": ("vocab", None),
        "layers": {
            "attn_norm": ("layers", None),
            "wq": ("layers", "embed", "heads", "head_dim"),
            "wk": ("layers", "embed", "kv_heads", "head_dim"),
            "wv": ("layers", "embed", "kv_heads", "head_dim"),
            "wo": ("layers", "heads", "head_dim", "embed"),
            "mlp_norm": ("layers", None),
            **ffn,
        },
        "final_norm": (None,),
        "lm_head": ("embed", "vocab"),
    }


def llama_param_pspecs(cfg: LlamaConfig, rules: ShardingRules = DEFAULT_RULES):
    return shard_pytree_specs(llama_param_logical_axes(cfg), rules)


# The mesh axes the model shards over; the others must be 1.
MODEL_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_EXPERT, AXIS_TENSOR)
_NOT_PORTED_AXES = (
    (AXIS_SEQUENCE, "sequence parallelism (ring and Ulysses attention) is "
                    "not ported yet (ROADMAP.md, M3)"),
    (AXIS_PIPELINE, "pipeline parallelism is not ported yet (ROADMAP.md, "
                    "M8)"),
)


def model_mesh(mesh):
    """The ``(dp, fsdp, ep, tp)`` part of ``mesh`` (a ``build_mesh``
    mesh), over which parameters and activations are DTensors: those of
    its axes that are above 1, or dp alone on one device.  A size-1 axis
    shards nothing, and each mesh dim multiplies the strategies DTensor's
    sharding propagation weighs for every op.  Raises
    ``NotImplementedError`` for an sp or pp axis above 1, naming its
    ROADMAP module."""
    names = mesh.mesh_dim_names
    for axis, why in _NOT_PORTED_AXES:
        if axis in names and mesh.size(names.index(axis)) > 1:
            raise NotImplementedError(why)
    used = tuple(a for a in MODEL_AXES
                 if a in names and mesh.size(names.index(a)) > 1)
    used = used or MODEL_AXES[:1]
    return mesh if tuple(names) == used else mesh[used]


def _placements(model: Llama, sub, rules: ShardingRules) -> dict:
    """``id(parameter) -> (owner module, attribute, sub, placements)`` for
    every parameter of ``model``, placed by ``llama_param_logical_axes``
    through ``rules`` on the model mesh ``sub``."""
    axes = llama_param_logical_axes(model.cfg)
    owners = [(model, axes)] + [(lp, {k: v[1:] for k, v in
                                      axes["layers"].items()})
                                for lp in model.layers]
    return {id(getattr(module, name)): (module, name, sub,
                                        placements_for(logical, sub, rules))
            for module, table in owners for name, logical in table.items()
            if name != "layers"}


def _distribute(full: torch.Tensor, sub, placements):
    """``distribute_tensor`` of a tensor every process holds alike: each
    keeps its own shard, with no collective (``src_data_rank=None``)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full, sub, placements, src_data_rank=None)


@torch.no_grad()
def shard_llama(model: Llama, mesh, rules: ShardingRules = DEFAULT_RULES
                ) -> Llama:
    """Make every parameter of ``model`` a DTensor on ``mesh``'s ``(dp,
    fsdp, ep, tp)`` dims, placed by ``llama_param_logical_axes`` through
    ``rules`` (the reference's ``out_shardings`` at init): fsdp shards the
    embed dim, tp the heads, the mlp and the vocab, ep the experts; dp
    replicates.  Each process keeps its shards only (rank 0's values, if
    the full tensors differ between processes).  In place; returns
    ``model``.  (``llama_init(mesh=)`` builds the same shards without the
    whole model.)"""
    from torch.distributed.tensor import distribute_tensor

    for module, name, sub, placements in _placements(
            model, model_mesh(mesh), rules).values():
        p = getattr(module, name)
        d = distribute_tensor(p.detach(), sub, placements)
        setattr(module, name, nn.Parameter(d, requires_grad=p.requires_grad))
    return model


def _w(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A parameter as the product uses it, cast to ``dtype``.  A DTensor
    parameter is first gathered over fsdp (and dp): ZeRO-3's all-gather of
    the weight before use, whose backward reduce-scatters the gradient
    over fsdp and all-reduces it over dp; its tp and ep shards stay.  Its
    gradient comes back placed as the parameter is (``grad_placed``)."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(p, DTensor):
        mesh = p.device_mesh
        p = grad_placed(p).redistribute(mesh, [
            Replicate() if name in (AXIS_DATA, AXIS_FSDP) else pl
            for name, pl in zip(mesh.mesh_dim_names, p.placements)])
    return p.to(dtype)


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


def ffn_block(h: torch.Tensor, lp: LlamaLayer, cfg: LlamaConfig,
              rules: ShardingRules = DEFAULT_RULES,
              mesh=None) -> torch.Tensor:
    """SwiGLU FFN or MoE on [B, T, D] activations (DTensors under a
    mesh: tp shards the mlp dim, the down projection's partial sums meet
    in one all-reduce; MoE runs per shard, ``models/moe.py``)."""
    dtype = h.dtype
    if cfg.n_experts:
        return moe_ffn(h, *_moe_weights(lp, dtype), top_k=cfg.moe_top_k,
                       capacity_factor=cfg.capacity_factor,
                       dispatch=cfg.moe_dispatch, mesh=mesh)
    w_gate, w_up = _w(lp.w_gate, dtype), _w(lp.w_up, dtype)
    w_down = _w(lp.w_down, dtype)
    with checkpoint_name("ffn_gate"):
        gate = h @ w_gate
    with checkpoint_name("ffn_up"):
        up = h @ w_up
    ff = nn.functional.silu(gate) * up
    ff = with_logical_constraint(ff, ("batch", "seq", "mlp"), rules)
    with checkpoint_name("ffn_down"):
        out = ff @ w_down
    return with_logical_constraint(out, ("batch", "seq", None), rules)


def ffn_block_stats(h: torch.Tensor, lp: LlamaLayer, cfg: LlamaConfig,
                    mesh=None):
    """MoE FFN returning (y, router stats) — see ``moe.moe_ffn_stats``."""
    return moe_ffn_stats(
        h, *_moe_weights(lp, h.dtype), top_k=cfg.moe_top_k,
        capacity_factor=cfg.capacity_factor, dispatch=cfg.moe_dispatch,
        mesh=mesh)


def _moe_weights(lp: LlamaLayer, dtype: torch.dtype):
    """The router and expert weights as the MoE FFN uses them (``_w``:
    gathered over dp and fsdp, still sharded over ep and tp)."""
    return tuple(_w(p, dtype) for p in (lp.router, lp.w_gate, lp.w_up,
                                        lp.w_down))


# ---------------------------------------------------------------------------
# Attention choice
# ---------------------------------------------------------------------------

# "auto" takes the flash kernels on CUDA from this sequence length up.  The
# reference's gate (TPU and T >= 1024) is a TPU measurement; the value is
# kept until the H100 numbers in PERF.md say where the kernels win.
FLASH_AUTO_MIN_T = 1024

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


QKV_AXES = ("batch", "seq", "heads", "head_dim")
KV_AXES = ("batch", "seq", "kv_heads", "head_dim")


def _attention(q, k, v, causal: bool, cfg: Optional[LlamaConfig] = None,
               mesh=None, rules: ShardingRules = DEFAULT_RULES):
    """The reference's single-device and flash branches: the flash kernels
    where they apply (``_flash_path``), else the f32 reference attention.
    k and v carry the kv heads; GQA repeats them to the query heads.

    Under a mesh (q, k, v DTensors) both run per shard through
    ``local_map``, the analog of the reference's ``shard_map``: dp and fsdp
    shard the batch, tp the heads (q's heads and the kv heads alike, so a
    shard's query heads read its own kv heads: H/tp = repeats * KV/tp).
    An sp axis above 1 (ring or Ulysses attention) raises: M3."""
    if mesh is None:
        return _local_attention(q, k, v, causal=causal, cfg=cfg)
    names = mesh.mesh_dim_names
    if AXIS_SEQUENCE in names and mesh.size(names.index(AXIS_SEQUENCE)) > 1:
        raise NotImplementedError(_NOT_PORTED_AXES[0][1])
    from functools import partial

    from torch.distributed.tensor.experimental import local_map

    q = with_logical_constraint(q, QKV_AXES, rules)
    k = with_logical_constraint(k, KV_AXES, rules)
    v = with_logical_constraint(v, KV_AXES, rules)
    qp, kp = list(q.placements), list(k.placements)  # a list: one output
    fn = local_map(partial(_local_attention, causal=causal, cfg=cfg),
                   out_placements=qp, in_placements=(qp, kp, kp),
                   device_mesh=q.device_mesh)
    return fn(q, k, v)


def _local_attention(q, k, v, *, causal: bool,
                     cfg: Optional[LlamaConfig]) -> torch.Tensor:
    repeats = q.shape[2] // k.shape[2]
    if repeats > 1:  # GQA: expand kv heads to query heads (jnp.repeat)
        k = k.repeat_interleave(repeats, dim=2)
        v = v.repeat_interleave(repeats, dim=2)
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

def _decoder_layer_fn(cfg: LlamaConfig, angles: torch.Tensor, mesh=None,
                      rules: ShardingRules = DEFAULT_RULES):
    """One decoder layer as ``(x, lp) -> (x, aux)`` where ``aux`` is the
    layer's MoE router stats (zeros for dense layers).  Under a mesh x and
    the parameters are DTensors, constrained at the reference's points."""
    dtype = torch_dtype(cfg.dtype)

    def layer(x, lp):
        h = rmsnorm(x, _w(lp.attn_norm, dtype), cfg.norm_eps)
        q = apply_rope(_heads(h, _w(lp.wq, dtype)), angles)
        k = apply_rope(_heads(h, _w(lp.wk, dtype)), angles)
        v = _heads(h, _w(lp.wv, dtype))
        attn = _attention(q, k, v, True, cfg, mesh, rules)
        wo = _w(lp.wo, dtype)
        with checkpoint_name("attn_proj"):
            proj = attn.flatten(2) @ wo.flatten(0, 1)
        x = x + with_logical_constraint(proj, ("batch", "seq", None), rules)

        h = rmsnorm(x, _w(lp.mlp_norm, dtype), cfg.norm_eps)
        if cfg.n_experts:
            ff, aux = ffn_block_stats(h, lp, cfg, mesh)
        else:
            ff = ffn_block(h, lp, cfg, rules)
            zero = torch.zeros((), device=x.device)
            aux = {"aux_loss": zero, "z_loss": zero, "overflow_frac": zero}
        x = with_logical_constraint(x + ff, ("batch", "seq", None), rules)
        return x, aux

    return layer


def _heads(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, T, D] @ [D, H, K] -> [B, T, H, K] as one 2-D product (the
    reference's ``einsum("btd,dhk->bthk")``; a product with no batch dims
    is an ``aten.mm`` in the port, which the ``"dots"`` policy keeps)."""
    return (h @ w.flatten(1)).unflatten(-1, w.shape[1:])


def _maybe_remat(layer, cfg: LlamaConfig):
    """``remat=False``: the layer as is; else the layer under
    ``cfg.remat_policy`` (``models/remat.py``): ``"full"`` keeps only its
    input, the named policies keep what the reference's keep."""
    if not cfg.remat:
        return layer
    return remat(layer, cfg.remat_policy)


def stage_tokens(tokens: torch.Tensor, mesh,
                 rules: ShardingRules = DEFAULT_RULES) -> torch.Tensor:
    """Tokens as the mesh path takes them: a DTensor as it is; a plain
    tensor is the global batch, of which this process keeps its
    ``("batch", "seq")`` shard (every process holds the same tokens, as the
    synthetic data makes them: no collective)."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(tokens, DTensor):
        return tokens
    placements = placements_for(("batch", "seq"), mesh, rules)
    local = tokens
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            local = local.chunk(mesh.size(i), dim=pl.dim)[
                mesh.get_local_rank(i)]
    return DTensor.from_local(local, mesh, placements, run_check=False)


def _embed(tokens, table):
    """The vocab-parallel lookup of DTensor ``tokens`` in a ``table``
    whose vocab dim tp shards: each tp shard looks up the tokens in its
    rows, zero elsewhere, and the shards' sum (a ``Partial`` output) is the
    lookup; the reference's SPMD mask-and-reduce.  (``F.embedding`` on
    DTensors makes the same sum as a mask-partial placement, whose
    backward meets the projections' partial gradients unsupported.)"""
    from functools import partial

    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    start, rows, out, grad = 0, table.shape[0], [], []
    for i, (tok, pl) in enumerate(zip(tokens.placements, table.placements)):
        if isinstance(pl, Shard):     # the vocab dim, chunked in mesh order
            chunk = -(-rows // mesh.size(i))
            start += chunk * mesh.get_local_rank(i)
            rows = chunk
        out.append(Partial() if isinstance(pl, Shard) else tok)
        # A shard's table gradient sums its own batch rows only.
        grad.append(Partial() if isinstance(tok, Shard) else pl)
    return local_map(partial(_embed_rows, start=start), out_placements=out,
                     in_placements=(list(tokens.placements),
                                    list(table.placements)),
                     in_grad_placements=(list(tokens.placements), grad),
                     device_mesh=mesh)(tokens, table)


def _embed_rows(tokens, rows, *, start: int):
    idx = tokens.long() - start
    hit = (idx >= 0) & (idx < rows.shape[0])
    out = nn.functional.embedding(idx.clamp(0, rows.shape[0] - 1), rows)
    return out * hit[..., None].to(out.dtype)


def llama_forward(model: Llama, tokens: torch.Tensor, cfg: LlamaConfig,
                  mesh=None, rules: ShardingRules = DEFAULT_RULES, *,
                  return_aux: bool = False, return_hidden: bool = False):
    """tokens [B, T] int -> logits [B, T, vocab] f32.

    With ``return_aux=True`` also returns the MoE router stats averaged
    over layers ({aux_loss, z_loss, overflow_frac}, zeros for dense).
    With ``return_hidden=True`` returns the final-norm hidden states
    [B, T, dim] instead of logits (the chunked loss applies lm_head itself,
    chunk by chunk).

    With ``mesh`` (a ``build_mesh`` mesh; ``model`` sharded on it by
    :func:`shard_llama` or built on it by ``llama_init(mesh=)``) the
    activations are DTensors on its model mesh (:func:`model_mesh`) and
    the outputs come back as DTensors; ``tokens`` go through
    :func:`stage_tokens`."""
    dtype = torch_dtype(cfg.dtype)
    t = tokens.shape[1]
    angles = rope_freqs(cfg, torch.arange(t, device=tokens.device))
    if mesh is None:
        x = model.embed[tokens.long()].to(dtype)
    else:
        from torch.distributed.tensor import DTensor, Replicate

        mesh = model_mesh(mesh)
        tokens = stage_tokens(tokens, mesh, rules)
        x = _embed(tokens, _w(model.embed, model.embed.dtype))
        x = with_logical_constraint(x.to(dtype), ("batch", "seq", None),
                                    rules)
        angles = DTensor.from_local(angles, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    layer_fn = _maybe_remat(_decoder_layer_fn(cfg, angles, mesh, rules), cfg)
    auxes = []
    for lp in model.layers:
        x, aux = layer_fn(x, lp)
        auxes.append(aux)
    x = rmsnorm(x, _w(model.final_norm, dtype), cfg.norm_eps)
    if return_hidden:
        out = x
    else:
        out = x @ _w(model.lm_head, dtype)
        out = with_logical_constraint(out, ("batch", "seq", "vocab"),
                                      rules).float()
    if return_aux:
        return out, {key: torch.stack([a[key] for a in auxes]).mean()
                     for key in auxes[0]}
    return out


def _vocab_whole(logits: torch.Tensor, rules: ShardingRules
                 ) -> torch.Tensor:
    """Logits with the vocab dim gathered (a DTensor's tp shards), so the
    softmax runs over whole rows; the batch stays sharded."""
    return with_logical_constraint(logits, ("batch", "seq", None), rules)


def llama_loss(model: Llama, tokens: torch.Tensor, cfg: LlamaConfig,
               mesh=None, rules: ShardingRules = DEFAULT_RULES
               ) -> torch.Tensor:
    """Next-token cross-entropy, mean over all positions; for MoE configs
    plus the router losses weighted by ``moe_aux_coef``/``moe_z_coef``.
    With ``cfg.loss_chunks > 0`` the CE is computed chunk by chunk without
    materialising the full [B, T, vocab] f32 logits.  Under ``mesh`` the
    loss is a replicated DTensor scalar: the mean over the global batch."""
    aux = None
    if mesh is not None:
        tokens = stage_tokens(tokens, model_mesh(mesh), rules)
    if cfg.loss_chunks:
        out = llama_forward(model, tokens, cfg, mesh, rules,
                            return_aux=bool(cfg.n_experts), return_hidden=True)
        h, aux = out if cfg.n_experts else (out, None)
        ce = _chunked_ce(h, model.lm_head, tokens, cfg, rules)
    else:
        out = llama_forward(model, tokens, cfg, mesh, rules,
                            return_aux=bool(cfg.n_experts))
        logits, aux = out if cfg.n_experts else (out, None)
        targets = tokens[:, 1:].long()
        logp = torch.log_softmax(_vocab_whole(logits, rules)[:, :-1], dim=-1)
        nll = -logp.gather(-1, targets[..., None])
        ce = with_logical_constraint(nll.mean(), (), rules)
    if cfg.n_experts:
        return (ce + cfg.moe_aux_coef * aux["aux_loss"]
                + cfg.moe_z_coef * aux["z_loss"])
    return ce


def _chunked_ce(h: torch.Tensor, lm_head: torch.Tensor, tokens: torch.Tensor,
                cfg: LlamaConfig,
                rules: ShardingRules = DEFAULT_RULES) -> torch.Tensor:
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
    w = _w(lm_head, dtype)
    tgt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1).long()
    ones = torch.ones_like(tgt, dtype=torch.float32)
    weight = torch.cat([ones[:, :-1], torch.zeros_like(ones[:, -1:])], dim=1)

    def chunk(xc, w, tc, wc):
        xc = with_logical_constraint(xc, ("batch", None, None), rules)
        logits = (xc @ w).float()
        logits = with_logical_constraint(logits, ("batch", None, "vocab"),
                                         rules)
        logits = _vocab_whole(logits, rules)
        lse = torch.logsumexp(logits, dim=-1)
        t_logit = logits.gather(-1, tc[..., None])[..., 0]
        return torch.sum((lse - t_logit) * wc)

    c = t // n
    total = None
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        part = checkpoint(chunk, h[:, sl], w, tgt[:, sl], weight[:, sl],
                          use_reentrant=False)
        total = part if total is None else total + part
    return with_logical_constraint(total / torch.sum(weight), (), rules)
