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
On the card the norm and RoPE run as one hand-written pass each way
(``ops/norm_rope.py``) with the same rounding places; only the order of
the norm's sum differs.

Parameters are created with ``requires_grad=False`` (the serving default);
training asks for gradients (``Llama(..., requires_grad=True)``).

MoE layers train through the same path: their expert FFN is
``models/moe.py`` (``cfg.moe_dispatch``, the grouped kernels' custom
backward; under a mesh, per shard over ep), and ``llama_loss`` adds the
router losses.

Sequence parallelism: under a mesh with an ``sp`` axis above 1 the
activations are sharded over T, each shard's RoPE angles are those of its
own positions, attention is ring or Ulysses (``cfg.sp_attention``,
``parallel/ring.py``, ``parallel/ulysses.py``) per shard, and the loss's
shifted targets are built from the global tokens before they are staged,
so each shard's cross-entropy is local.

Pipeline parallelism: under a mesh with a ``pp`` axis above 1 each
process builds and runs one stage's layers (``llama_init(mesh=)``, the
layers under their global index), the embedding, final norm and head
replicated over pp as the reference places them; ``llama_forward_pp``
(GPipe) and ``llama_loss_and_grads_pp`` (1F1B) run the layers as stages
over the pp group, or over virtual stages in one process
(``parallel/pipeline.py``).

Remat: every policy of the reference (``"full"``, ``"dots"``, ``"ffn"``,
``"gateup"``, ``"gateup_attn"``, ``"moe"``) as selective activation
checkpointing (``models/remat.py``); the ``checkpoint_name`` scopes sit
where the reference names its values.  The products with no batch dims
(the projections, the dense FFN, the logits) are 2-D matmuls.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device, torch_dtype
from ..obs.trace import in_step_span, step_span
from ..ops.attention import TILE, flash_attention, kernel_rule
from ..ops import norm_rope as nr
from ..parallel.mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_PIPELINE,
    AXIS_SEQUENCE,
    AXIS_TENSOR,
)
from ..parallel.ring import (
    GroupRing,
    attention_reference,
    flash_reason,
    ring_attention_local,
)
from ..parallel.sharding import (
    DEFAULT_RULES,
    ShardingRules,
    grad_placed,
    placements_for,
    shard_pytree_specs,
    with_logical_constraint,
)
from ..parallel.ulysses import ulysses_attention_local
from .moe import biased_moe_ffn, moe_ffn, moe_ffn_stats
from .remat import checkpoint_name, remat


BLOCKS = ("llama", "afmoe")


@dataclass(frozen=True)
class LlamaConfig:
    """The reference's ``LlamaConfig`` fields, with the same defaults, so one
    set of those keyword arguments builds either package's config; then
    fields of the port's own (after ``sp_attention``), whose defaults leave
    a config as the reference's fields make it:

    - ``block``: the layer's equations.  "llama": pre-norm, RoPE on every
      layer.  "afmoe" (AFMoE, Trinity): the embedding scaled by
      sqrt(dim); per-head RMSNorm of q and k; a sigmoid gate (``a @
      attn_gate``) on the attention output; RoPE on the windowed layers
      only; an RMSNorm after each sublayer as well as before it; and a MoE
      layer routes by sigmoid score: the top k of sigmoid(logits) + an
      expert bias, the weights the chosen scores normalised and times
      ``route_scale``, the bias stepped by ``bias_rate`` after each step's
      backward (aux-loss-free balancing, no router loss;
      ``models/moe.py:biased_moe_ffn``).  "llama" routes by softmax
      (Mixtral).
    - ``head_width``: the head width, 0 for ``dim // n_heads``
      (:attr:`head_dim` reads the width in use).
    - ``window``, ``global_every``: a causal window of ``window`` keys on
      every layer but each ``global_every``-th (layers ``global_every - 1,
      2 global_every - 1, ...``); 0: no window / every layer windowed.
    - ``dense_layers``: in a MoE config, the leading layers that keep the
      dense FFN (``intermediate`` wide).
    - ``expert_intermediate``: the routed and shared experts' width, 0 for
      ``intermediate``; ``shared_experts`` ("afmoe" only): shared experts
      beside the routed ones (one SwiGLU ``shared_experts`` times as wide).
    - ``experts_held`` ("afmoe" only): the experts this card holds, the
      first of ``n_experts`` that the router scores (0: all of them).

    The pp, sp and mesh paths and serving take none of the port's own
    fields but ``head_width`` (:func:`one_card_only`)."""

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
    block: str = "llama"
    head_width: int = 0
    window: int = 0
    global_every: int = 0
    dense_layers: int = 0
    expert_intermediate: int = 0
    shared_experts: int = 0
    route_scale: float = 1.0
    bias_rate: float = 0.0
    experts_held: int = 0

    def __post_init__(self):
        if self.block not in BLOCKS:
            raise ValueError(f"unknown block {self.block!r}; one of {BLOCKS}")
        if not 0 <= self.experts_held <= self.n_experts:
            raise ValueError(f"experts_held {self.experts_held} is not "
                             f"within n_experts {self.n_experts}")
        if self.block == "afmoe" and self.n_experts and \
                self.moe_dispatch != "grouped":
            raise ValueError("the afmoe block's sigmoid routing runs the "
                             f"grouped dispatch, not {self.moe_dispatch!r}")
        if self.block == "llama":
            for name in ("shared_experts", "experts_held"):
                if getattr(self, name):
                    raise ValueError(
                        f"the llama block takes no {name} "
                        f"({name}={getattr(self, name)!r}): only the afmoe "
                        "block's sigmoid routing does")

    @property
    def head_dim(self) -> int:
        return self.head_width or self.dim // self.n_heads

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
    """Layer ``index``'s parameters, named as the JAX pytree's
    ``params["layers"]`` keys (without the leading layer axis), then the
    port's own, and what the layer is, decided here from the block and
    ``index``: the forward reads these, never the block.  ``window``: its
    causal window (None: global); ``rope``: q and k are rotated;
    ``qk_norm``: q/k norms (``q_norm``, ``k_norm`` [head_dim]);
    ``gated``: an output gate (``attn_gate`` [D, H, head_dim]);
    ``post_norm``: norms after each sublayer (``post_attn_norm``,
    ``post_mlp_norm``); ``moe``: it routes; ``biased``: by sigmoid score
    and ``expert_bias`` [n_experts] f32, a buffer (else by softmax);
    ``shared``: a shared expert (``shared_gate``, ``shared_up``,
    ``shared_down``); ``stats``: it reports the softmax router's stats to
    the loss (zeros where dense)."""

    def __init__(self, cfg: LlamaConfig, device: torch.device,
                 dtype: torch.dtype, index: int = 0):
        super().__init__()
        d, hd, nh, nkv = cfg.dim, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        f = cfg.intermediate
        g = cfg.global_every
        afmoe = cfg.block == "afmoe"
        global_layer = bool(g) and index % g == g - 1
        self.window = None if global_layer or not cfg.window else cfg.window
        self.rope = not afmoe or self.window is not None
        self.qk_norm = self.gated = self.post_norm = afmoe
        self.moe = bool(cfg.n_experts) and index >= cfg.dense_layers
        self.biased = self.moe and afmoe
        self.shared = self.moe and bool(cfg.shared_experts)
        self.stats = not afmoe
        self.attn_norm = _param((d,), dtype, device)
        self.wq = _param((d, nh, hd), dtype, device)
        self.wk = _param((d, nkv, hd), dtype, device)
        self.wv = _param((d, nkv, hd), dtype, device)
        self.wo = _param((nh, hd, d), dtype, device)
        self.mlp_norm = _param((d,), dtype, device)
        if self.qk_norm:
            self.q_norm = _param((hd,), dtype, device)
            self.k_norm = _param((hd,), dtype, device)
        if self.gated:
            self.attn_gate = _param((d, nh, hd), dtype, device)
        if self.post_norm:
            self.post_attn_norm = _param((d,), dtype, device)
            self.post_mlp_norm = _param((d,), dtype, device)
        if self.moe:
            e = cfg.experts_held or cfg.n_experts
            f = cfg.expert_intermediate or f
            self.router = _param((d, cfg.n_experts), dtype, device)
            self.w_gate = _param((e, d, f), dtype, device)
            self.w_up = _param((e, d, f), dtype, device)
            self.w_down = _param((e, f, d), dtype, device)
            if self.shared:
                fs = f * cfg.shared_experts
                self.shared_gate = _param((d, fs), dtype, device)
                self.shared_up = _param((d, fs), dtype, device)
                self.shared_down = _param((fs, d), dtype, device)
            if self.biased:
                self.register_buffer("expert_bias", torch.zeros(
                    cfg.n_experts, dtype=torch.float32, device=device))
        else:
            self.w_gate = _param((d, f), dtype, device)
            self.w_up = _param((d, f), dtype, device)
            self.w_down = _param((f, d), dtype, device)


class StageLayers(nn.Module):
    """One pipeline stage's layers, each under its global index (so
    ``layers.4.wq`` names the same parameter with or without pp); iterates
    like a list."""

    def __init__(self, layers: dict):
        super().__init__()
        for i, layer in layers.items():
            self.add_module(str(i), layer)

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self) -> int:
        return len(self._modules)


class Llama(nn.Module):
    """The parameter tree: ``embed``, ``layers``, ``final_norm``,
    ``lm_head`` — the JAX pytree's top-level keys.  ``layers``: the global
    indices of the layers this process holds (a pipeline stage's,
    :class:`StageLayers`), or all of them.  ``embed_scale``: the factor
    on the embedding, sqrt(dim) in an "afmoe" block, else None."""

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = "cuda",
                 requires_grad: bool = False, layers=None):
        super().__init__()
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.param_dtype)
        self.cfg = cfg
        self.embed_scale = (math.sqrt(cfg.dim) if cfg.block == "afmoe"
                            else None)
        self.embed = _param((cfg.vocab_size, cfg.dim), dtype, dev)
        if layers is None:
            self.layers = nn.ModuleList(
                LlamaLayer(cfg, dev, dtype, i) for i in range(cfg.n_layers))
        else:
            self.layers = StageLayers({i: LlamaLayer(cfg, dev, dtype, i)
                                       for i in layers})
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
    alive at a time.  On a mesh with a pp axis above 1 the module holds
    this process's stage's layers only (:func:`stage_layers`); the other
    layers' values are drawn and dropped, so that every stage draws what
    the whole model would.  A layer's own leaves come after those (norms
    one, the gate and shared expert 0.02, the shared down projection by
    depth); an expert bias starts at zero."""
    resid_scale = 0.02 / (2 * cfg.n_layers) ** 0.5
    if mesh is None:
        model = Llama(cfg, device, requires_grad)
        layers = list(model.layers)

        def normal_(p: nn.Parameter, scale: float = 0.02) -> None:
            # Draw in f32 and round once, as the reference casts its f32
            # draw.
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device, dtype=torch.float32) * scale)

        def ones_(p: nn.Parameter) -> None:
            p.fill_(1.0)
    else:
        one_card_only(cfg, "the sharded init")
        own = stage_layers(cfg, mesh)
        model = Llama(cfg, "meta", requires_grad, layers=own)
        dev = resolve_device(device)
        placed = _placements(model, model_mesh(mesh), rules)
        # Every layer in draw order; another stage's on the meta device,
        # whose draws are made and dropped.
        layers = (list(model.layers) if own is None else [
            model.layers.get_submodule(str(i)) if i in own
            else LlamaLayer(cfg, torch.device("meta"),
                            torch_dtype(cfg.param_dtype), i)
            for i in range(cfg.n_layers)])

        def _shard(p: nn.Parameter, full: torch.Tensor) -> None:
            if id(p) not in placed:     # another stage's layer
                return
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
    for lp in layers:
        ones_(lp.attn_norm)
        ones_(lp.mlp_norm)
        for p in (lp.wq, lp.wk, lp.wv):
            normal_(p)
        normal_(lp.wo, resid_scale)
        if lp.moe:
            normal_(lp.router)
        normal_(lp.w_gate)
        normal_(lp.w_up)
        normal_(lp.w_down, resid_scale)
        if lp.qk_norm:
            ones_(lp.q_norm)
            ones_(lp.k_norm)
        if lp.post_norm:
            ones_(lp.post_attn_norm)
            ones_(lp.post_mlp_norm)
        if lp.gated:
            normal_(lp.attn_gate)
        if lp.shared:
            normal_(lp.shared_gate)
            normal_(lp.shared_up)
            normal_(lp.shared_down, resid_scale)
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


# The mesh axes a stage shards over (pp runs the layers as stages).
MODEL_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_EXPERT, AXIS_SEQUENCE, AXIS_TENSOR)


def _axis_size(mesh, axis: str) -> int:
    """The extent of ``mesh``'s ``axis`` (1 without a mesh or the axis)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def model_mesh(mesh):
    """The ``(dp, fsdp, ep, sp, tp)`` part of ``mesh`` (a ``build_mesh``
    mesh), over which parameters and activations are DTensors: those of
    its axes that are above 1, or dp alone on one device.  A size-1 axis
    shards nothing, and each mesh dim multiplies the strategies DTensor's
    sharding propagation weighs for every op.  pp is left out: under a pp
    axis above 1 this is the sub-mesh of this process's stage."""
    names = mesh.mesh_dim_names
    used = tuple(a for a in MODEL_AXES
                 if a in names and mesh.size(names.index(a)) > 1)
    used = used or MODEL_AXES[:1]
    return mesh if tuple(names) == used else mesh[used]


def pp_size(mesh) -> int:
    """The extent of ``mesh``'s pp axis (1 without a mesh or the axis)."""
    return _axis_size(mesh, AXIS_PIPELINE)


def pp_group(mesh):
    """The process group of ``mesh``'s pp axis (None at pp 1)."""
    return mesh.get_group(AXIS_PIPELINE) if pp_size(mesh) > 1 else None


def pp_stage(mesh) -> int:
    """This process's pipeline stage: its index along pp (0 at pp 1)."""
    return mesh.get_local_rank(AXIS_PIPELINE) if pp_size(mesh) > 1 else 0


def stage_layers(cfg: LlamaConfig, mesh) -> Optional[range]:
    """The global indices of the layers this process's stage holds on
    ``mesh`` (contiguous, ``n_layers / pp`` of them), or None at pp 1."""
    pp = pp_size(mesh)
    if pp == 1:
        return None
    if cfg.n_layers % pp:
        raise ValueError(f"pp {pp} does not divide n_layers {cfg.n_layers}")
    k = cfg.n_layers // pp
    return range(pp_stage(mesh) * k, (pp_stage(mesh) + 1) * k)


def _refuse_pp(mesh) -> None:
    """The non-pipelined forward and loss take no pp axis above 1."""
    if pp_size(mesh) > 1:
        raise ValueError("a mesh with pp > 1 runs the layers as pipeline "
                         "stages: call llama_forward_pp or "
                         "llama_loss_and_grads_pp")


# The port's own fields that only the single-card training path takes, with
# the values that leave a config as the reference's fields make it (the
# block's ``shared_experts`` and ``experts_held`` come with the block).
ONE_CARD_FIELDS = (("block", "llama"), ("window", 0), ("dense_layers", 0))


def one_card_only(cfg: LlamaConfig, path: str) -> None:
    """Refuse, naming the field, a config that ``path`` (the pp, sp or
    mesh paths, serving) does not take: one with any of
    :data:`ONE_CARD_FIELDS` set."""
    for name, plain in ONE_CARD_FIELDS:
        if getattr(cfg, name) != plain:
            raise ValueError(f"{path} does not take {name}="
                             f"{getattr(cfg, name)!r}: only the single-card "
                             "training path (llama_loss without a mesh) "
                             "does")


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

    one_card_only(model.cfg, "shard_llama")
    for module, name, sub, placements in _placements(
            model, model_mesh(mesh), rules).values():
        p = getattr(module, name)
        d = distribute_tensor(p.detach(), sub, placements)
        setattr(module, name, nn.Parameter(d, requires_grad=p.requires_grad))
    return model


def _sp_size(mesh) -> int:
    """The extent of ``mesh``'s sp axis (1 without a mesh or the axis)."""
    return _axis_size(mesh, AXIS_SEQUENCE)


@in_step_span("kctpu.cast")
def _w(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A parameter as the product uses it, cast to ``dtype``.  A DTensor
    parameter is first gathered over fsdp (and dp): ZeRO-3's all-gather of
    the weight before use, whose backward reduce-scatters the gradient
    over fsdp and all-reduces it over dp; its tp and ep shards stay.  Its
    gradient comes back placed as the parameter is (``grad_placed``: the
    sums over the batch and sequence shards that read it, dp, fsdp and
    sp)."""
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

@in_step_span("kctpu.norm")
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float,
            rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            ) -> torch.Tensor:
    """RMSNorm over the last dim, then with ``rope`` (cos, sin) RoPE as
    :func:`apply_rope` rotates: off the CPU one pass of
    ``ops/norm_rope.py``'s kernel (:func:`~..ops.norm_rope.norm_rope`, which
    raises for what it cannot take), on the CPU the plain composition."""
    cos, sin = rope if rope is not None else (None, None)
    if nr.on_card(x):
        return nr.norm_rope(x, scale, cos, sin, eps)
    x = nr.rmsnorm_plain(x, scale, eps)
    return x if rope is None else apply_rope(x, cos, sin)


def rope_freqs(cfg: LlamaConfig, positions: torch.Tensor) -> torch.Tensor:
    """[T, head_dim//2] rotation angles (f32) for absolute ``positions``."""
    exps = torch.arange(0, cfg.head_dim, 2, dtype=torch.float32,
                        device=positions.device) / cfg.head_dim
    inv = 1.0 / torch.pow(cfg.rope_theta, exps)
    return positions[:, None].float() * inv[None, :]


@in_step_span("kctpu.rope")
def rope_tables(cfg: LlamaConfig, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the RoPE angles of ``positions``, each [T, head_dim]
    f32 (the half-dim angles twice): made once a forward, for every
    layer's :func:`apply_rope`."""
    angles = rope_freqs(cfg, positions)
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


@in_step_span("kctpu.rope")
def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE, x·cos + [-x2, x1]·sin in f32; x: [B, T, H, D],
    cos/sin: [T, D] (:func:`rope_tables`): off the CPU
    ``ops/norm_rope.py``'s kernel with the norm off, on the CPU the plain
    rotation."""
    if nr.on_card(x):
        return nr.norm_rope(x, None, cos, sin)
    return nr.rope_plain(x, cos, sin)


@in_step_span("kctpu.ffn")
def ffn_block(h: torch.Tensor, lp: LlamaLayer, cfg: LlamaConfig,
              rules: ShardingRules = DEFAULT_RULES,
              mesh=None) -> torch.Tensor:
    """SwiGLU FFN or MoE on [B, T, D] activations (DTensors under a
    mesh: tp shards the mlp dim, the down projection's partial sums meet
    in one all-reduce; MoE runs per shard, ``models/moe.py``).  A MoE
    layer routes as it was built: by sigmoid score and expert bias
    (:func:`moe.biased_moe_ffn`, on the experts this card holds) or by
    softmax (:func:`moe.moe_ffn`); its shared expert, where it holds one,
    is added."""
    dtype = h.dtype
    if not lp.moe:
        return _swiglu(h, lp.w_gate, lp.w_up, lp.w_down, rules)
    if lp.biased:
        y = biased_moe_ffn(h, *_moe_weights(lp, dtype),
                           _expert_bias(lp, h.device), top_k=cfg.moe_top_k,
                           route_scale=cfg.route_scale,
                           bias_rate=cfg.bias_rate)
    else:
        y = moe_ffn(h, *_moe_weights(lp, dtype), top_k=cfg.moe_top_k,
                    capacity_factor=cfg.capacity_factor,
                    dispatch=cfg.moe_dispatch, mesh=mesh)
    if lp.shared:
        y = _swiglu(h, lp.shared_gate, lp.shared_up, lp.shared_down,
                    rules) + y
    return y


def _swiglu(h: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, rules: ShardingRules) -> torch.Tensor:
    """The dense SwiGLU FFN ``(silu(h Wg) * (h Wu)) Wd`` through ``_mm``."""
    dtype = h.dtype
    w_gate, w_up = _w(w_gate, dtype), _w(w_up, dtype)
    w_down = _w(w_down, dtype)
    with checkpoint_name("ffn_gate"):
        gate = _mm(h, w_gate)
    with checkpoint_name("ffn_up"):
        up = _mm(h, w_up)
    ff = nn.functional.silu(gate) * up
    ff = with_logical_constraint(ff, ("batch", "seq", "mlp"), rules)
    with checkpoint_name("ffn_down"):
        out = _mm(ff, w_down)
    return with_logical_constraint(out, ("batch", "seq", None), rules)


@in_step_span("kctpu.ffn")
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


def _expert_bias(lp: LlamaLayer, device: torch.device) -> torch.Tensor:
    """The layer's expert bias.  A model built on the meta device whose
    parameters are set afterwards (as the benchmark builds it) has none
    yet: its bias starts at zero here, on ``device``."""
    if lp.expert_bias.is_meta:
        lp.expert_bias = torch.zeros_like(lp.expert_bias, device=device)
    return lp.expert_bias


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


@in_step_span("kctpu.attention")
def _attention(q, k, v, causal: bool, cfg: Optional[LlamaConfig] = None,
               mesh=None, rules: ShardingRules = DEFAULT_RULES,
               window: Optional[int] = None):
    """The reference's single-device and flash branches: the flash kernels
    where they apply (``_flash_path``), else the f32 reference attention.
    k and v carry the kv heads; GQA repeats them to the query heads.

    Under a mesh (q, k, v DTensors) both run per shard through
    ``local_map``, the analog of the reference's ``shard_map``: dp and fsdp
    shard the batch, tp the heads (q's heads and the kv heads alike, so a
    shard's query heads read its own kv heads: H/tp = repeats * KV/tp).
    An sp axis above 1 shards T, and each shard runs ring or Ulysses
    attention over the mesh's sp group (:func:`_sp_attention`).

    ``window``: a causal window of that many keys (single card only)."""
    if mesh is None:
        return _local_attention(q, k, v, causal=causal, cfg=cfg,
                                window=window)
    from functools import partial

    from torch.distributed.tensor.experimental import local_map

    q = with_logical_constraint(q, QKV_AXES, rules)
    k = with_logical_constraint(k, KV_AXES, rules)
    v = with_logical_constraint(v, KV_AXES, rules)
    qp, kp = list(q.placements), list(k.placements)  # a list: one output
    sub = q.device_mesh
    body = _local_attention
    if _sp_size(sub) > 1:
        body = partial(_sp_attention, group=sub.get_group(AXIS_SEQUENCE))
    fn = local_map(partial(body, causal=causal, cfg=cfg),
                   out_placements=qp, in_placements=(qp, kp, kp),
                   device_mesh=sub)
    return fn(q, k, v)


def _repeat_kv(q, k, v):
    repeats = q.shape[2] // k.shape[2]
    if repeats > 1:  # GQA: expand kv heads to query heads (jnp.repeat)
        k = k.repeat_interleave(repeats, dim=2)
        v = v.repeat_interleave(repeats, dim=2)
    return k, v


def _sp_attention(q, k, v, *, group, causal: bool,
                  cfg: Optional[LlamaConfig]) -> torch.Tensor:
    """One shard's sequence-parallel attention, as the reference's
    ``_attention`` takes it: the kv heads repeated first (Ulysses splits
    the heads n ways); Ulysses' inner follows ``cfg.attention`` as
    :func:`_local_attention` does, and the ring always folds with the
    flash inner, which takes a shard the kernels take
    (``ring.flash_reason``) and the dense inner otherwise, with the
    fallback warning under ``attention="flash"``."""
    k, v = _repeat_kv(q, k, v)
    if cfg is not None and cfg.sp_attention == "ulysses":
        def inner(qg, kg, vg, *, causal, scale):
            return _local_attention(qg, kg, vg, causal=causal, cfg=cfg)
        return ulysses_attention_local(q, k, v, group, causal=causal,
                                       inner=inner)
    if (cfg is not None and cfg.attention == "flash"
            and flash_reason(q, k, v) is not None):
        _warn_flash_fallback(q.shape[1], q.dtype, q.shape[-1])
    return ring_attention_local(q, k, v, GroupRing(group), causal=causal)


def _local_attention(q, k, v, *, causal: bool,
                     cfg: Optional[LlamaConfig],
                     window: Optional[int] = None) -> torch.Tensor:
    k, v = _repeat_kv(q, k, v)
    if cfg is not None and cfg.attention in ("auto", "flash"):
        out = _flash_path(q, k, v, causal, cfg, window)
        if out is not None:
            return out
    return attention_reference(q, k, v, causal=causal, window=window)


def _flash_path(q, k, v, causal: bool, cfg: LlamaConfig,
                window: Optional[int] = None):
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
    return flash_attention(q, k, v, causal=causal, window=window)


# ---------------------------------------------------------------------------
# Forward and loss
# ---------------------------------------------------------------------------

def _decoder_layer_fn(cfg: LlamaConfig,
                      rope: Tuple[torch.Tensor, torch.Tensor], mesh=None,
                      rules: ShardingRules = DEFAULT_RULES):
    """One decoder layer as ``(x, lp) -> (x, aux)``, :func:`_pre_attention`
    (RoPE where the layer takes it), :func:`_attention` (the layer's
    window) and :func:`_post_attention`; with the "afmoe" block's parts
    in brackets (``portbench/archs/afmoe.py`` writes out its equations):

        a = norm(x); q, k, v, [g] = a Wq, a Wk, a Wv, [a Wg]
        [q, k = norm_q(q), norm_k(k) per head]; RoPE on q, k [if windowed]
        x = x + [norm_post]((attention(q, k, v) [* sigmoid(g)]) Wo)
        x = x + [norm_post_mlp](FFN(norm_mlp(x)))

    ``aux`` is the layer's router stats (zeros for dense layers; empty
    where no router loss is trained).  Under a mesh x and the parameters
    are DTensors, constrained at the reference's points."""

    @in_step_span("kctpu.layer")
    def layer(x, lp):
        q, k, v, gate = _pre_attention(x, lp, cfg, rope)
        attn = _attention(q, k, v, True, cfg, mesh, rules, lp.window)
        return _post_attention(x, attn, gate, lp, cfg, rules, mesh,
                               stats=True)

    return layer


def _pre_attention(x: torch.Tensor, lp: LlamaLayer, cfg: LlamaConfig,
                   rope: Optional[Tuple[torch.Tensor, torch.Tensor]]):
    """``(q, k, v, gate)`` from [B, T, D] ``x``: the norm; q's
    projection, its norm and RoPE (by ``rope``, :func:`rope_tables`),
    each where the layer takes it, then k's, v's; the gate's projection
    (else None).  q/k/v are [B, T, heads, head_dim], DTensors under a
    mesh.  ``rope`` None: unrotated, for decoding's own positions."""
    dtype, eps = x.dtype, cfg.norm_eps
    h = rmsnorm(x, _w(lp.attn_norm, dtype), eps)

    def heads(w, norm):
        t = _heads(h, _w(w, dtype))
        rot = rope if lp.rope else None
        if lp.qk_norm:
            return rmsnorm(t, _w(getattr(lp, norm), dtype), eps, rot)
        return apply_rope(t, *rot) if rot is not None else t

    q, k = heads(lp.wq, "q_norm"), heads(lp.wk, "k_norm")
    v = _heads(h, _w(lp.wv, dtype))
    gate = _mm(h, _w(lp.attn_gate, dtype).flatten(1)) if lp.gated else None
    return q, k, v, gate


def _post_attention(x: torch.Tensor, attn: torch.Tensor,
                    gate: Optional[torch.Tensor], lp: LlamaLayer,
                    cfg: LlamaConfig, rules: ShardingRules = DEFAULT_RULES,
                    mesh=None, *, stats: bool = False):
    """``(x, aux)`` from the residual ``x`` and ``attn`` [B, T, H,
    head_dim]: the gate, the output projection, its norm, the residual;
    the MLP norm, the FFN, its norm, the residual (gate and sublayer norms
    where the layer has them).  Under a mesh the partial sums over tp meet
    in the constraints.  ``aux``: with ``stats`` (training), the router's
    stats of a layer that reports them (``lp.stats``, zeros where dense),
    else empty."""
    dtype, eps = x.dtype, cfg.norm_eps
    if lp.gated:
        attn = attn.flatten(2)
        with step_span("kctpu.attention"):
            attn = attn * torch.sigmoid(gate)
    wo = _w(lp.wo, dtype)
    with checkpoint_name("attn_proj"):    # and the flatten's copy, if any
        proj = _mm(attn.flatten(2), wo.flatten(0, 1))
    proj = with_logical_constraint(proj, ("batch", "seq", None), rules)
    if lp.post_norm:
        proj = rmsnorm(proj, _w(lp.post_attn_norm, dtype), eps)
    x = x + proj

    h = rmsnorm(x, _w(lp.mlp_norm, dtype), eps)
    aux = {}
    if stats and lp.stats and lp.moe:
        ff, aux = ffn_block_stats(h, lp, cfg, mesh)
    else:
        ff = ffn_block(h, lp, cfg, rules, mesh)
        if stats and lp.stats:
            zero = torch.zeros((), device=x.device)
            aux = {"aux_loss": zero, "z_loss": zero, "overflow_frac": zero}
    if lp.post_norm:
        ff = rmsnorm(ff, _w(lp.post_mlp_norm, dtype), eps)
    return with_logical_constraint(x + ff, ("batch", "seq", None), rules), aux


def _heads(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, T, D] @ [D, H, K] -> [B, T, H, K] as one 2-D product (the
    reference's ``einsum("btd,dhk->bthk")``; a product with no batch dims
    is an ``aten.mm`` in the port, which the ``"dots"`` policy keeps)."""
    return _mm(h, w.flatten(1)).unflatten(-1, w.shape[1:])


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` as one 2-D product (``aten.mm``), but for a
    DTensor ``x`` sharded on a leading dim that a dim of size above 1
    comes before (the sequence under sp, with the batch sharded over a
    data axis or a batch of several rows): folding them into mm's rows
    needs a redistribution that DTensor refuses on some torch versions
    (2.11 refuses both forms), so the product runs batched over dim 0
    (``aten.bmm``, ``w`` broadcast; the "dots" policy keeps only
    ``aten.mm``)."""
    from torch.distributed.tensor import DTensor, Shard

    lead = {pl.dim for pl in getattr(x, "placements", ())
            if isinstance(pl, Shard) and pl.dim < x.ndim - 1}
    if not isinstance(x, DTensor) or not any(
            d >= 1 and math.prod(x.shape[:d]) > 1 for d in lead):
        return x @ w
    # Dims 1 .. -2 fold into one: its outermost (the sequence) is sharded.
    # ``torch.bmm``, not ``matmul``: matmul folds a broadcast batch back
    # into mm's rows.
    x3 = x.flatten(1, -2)
    out = torch.bmm(x3, w.unsqueeze(0).expand(x3.shape[0], *w.shape))
    return out.unflatten(1, x.shape[1:-1])


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
    if mesh is not None:
        _refuse_pp(mesh)
        one_card_only(cfg, "the mesh path")
        mesh = model_mesh(mesh)
        tokens = stage_tokens(tokens, mesh, rules)
    x = _lookup(model.embed, tokens, dtype, rules)
    if model.embed_scale:
        with step_span("kctpu.embed"):
            x = x * model.embed_scale
    rope = _rope(cfg, tokens.shape[1], mesh, x.device)
    layer_fn = _maybe_remat(_decoder_layer_fn(cfg, rope, mesh, rules), cfg)
    auxes = []
    for lp in model.layers:
        x, aux = layer_fn(x, lp)
        auxes.append(aux)
    x = rmsnorm(x, _w(model.final_norm, dtype), cfg.norm_eps)
    if return_hidden:
        out = x
    else:
        with step_span("kctpu.head"):
            out = with_logical_constraint(_mm(x, _w(model.lm_head, dtype)),
                                          ("batch", "seq", "vocab"), rules)
        with step_span("kctpu.loss"):
            out = out.float()
    if return_aux:
        with step_span("kctpu.loss"):
            return out, {key: torch.stack([a[key] for a in auxes]).mean()
                         for key in auxes[0]}
    return out


@in_step_span("kctpu.embed")
def _lookup(table, tokens, dtype, rules: ShardingRules):
    """The embedding of ``tokens`` in ``table``, in ``dtype``: a gather,
    or for staged (DTensor) tokens the vocab-parallel :func:`_embed` of
    the table as ``_w`` hands it over."""
    from torch.distributed.tensor import DTensor

    if not isinstance(tokens, DTensor):
        return table[tokens.long()].to(dtype)
    x = _embed(tokens, _w(table, table.dtype))
    return with_logical_constraint(x.to(dtype), ("batch", "seq", None), rules)


@in_step_span("kctpu.rope")
def _rope(cfg: LlamaConfig, t: int, mesh, device):
    """The RoPE tables of positions [0, t): plain without ``mesh``, else
    as :func:`_shard_rope` places them."""
    if mesh is None:
        return rope_tables(cfg, torch.arange(t, device=device))
    return _shard_rope(cfg, t, mesh, device)


def _shard_rope(cfg: LlamaConfig, t: int, mesh, device):
    """The RoPE tables (:func:`rope_tables`) as DTensors on ``mesh``:
    sharded over T by sp, each shard the tables of its own positions (from
    its offset), and replicated over every other dim."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    sp = _sp_size(mesh)
    if t % sp:
        raise ValueError(f"seq len {t} does not divide by sp {sp}")
    lo = (t // sp) * (mesh.get_local_rank(AXIS_SEQUENCE) if sp > 1 else 0)
    placements = [Shard(0) if name == AXIS_SEQUENCE else Replicate()
                  for name in mesh.mesh_dim_names]
    return tuple(DTensor.from_local(table, mesh, placements, run_check=False)
                 for table in rope_tables(cfg, torch.arange(
                     lo, lo + t // sp, device=device)))


def _vocab_whole(logits: torch.Tensor, rules: ShardingRules
                 ) -> torch.Tensor:
    """Logits with the vocab dim gathered (a DTensor's tp shards), so the
    softmax runs over whole rows; the batch stays sharded."""
    return with_logical_constraint(logits, ("batch", "seq", None), rules)


def router_losses(model: Llama) -> bool:
    """Whether the model trains the router's balancing and z losses: a
    layer routed by softmax does (``stats``); sigmoid routing balances by
    its expert bias."""
    return any(lp.moe and lp.stats for lp in model.layers)


def llama_loss(model: Llama, tokens: torch.Tensor, cfg: LlamaConfig,
               mesh=None, rules: ShardingRules = DEFAULT_RULES
               ) -> torch.Tensor:
    """Next-token cross-entropy, mean over all positions; for a model
    routed by softmax plus the router losses weighted by
    ``moe_aux_coef``/``moe_z_coef`` (:func:`router_losses`).
    With ``cfg.loss_chunks > 0`` the CE is computed chunk by chunk without
    materialising the full [B, T, vocab] f32 logits.  Under ``mesh`` the
    loss is a replicated DTensor scalar: the mean over the global batch.

    Under an sp axis above 1 the shifted targets and the zero weight of
    the last global position are built from the global tokens (gathered
    first if they come staged) and staged as ``("batch", "seq")``, so each
    shard's CE is local: slicing seq-sharded logits at ``[:, :-1]`` would
    gather the whole [B, T, vocab] f32 logits on every process."""
    aux, targets = None, None
    stats = router_losses(model)
    if mesh is not None:
        _refuse_pp(mesh)
        one_card_only(cfg, "the mesh path")
        sub = model_mesh(mesh)
        if _sp_size(sub) > 1:
            with step_span("kctpu.loss"):
                targets = _staged_targets(tokens, sub, rules)
        tokens = stage_tokens(tokens, sub, rules)
    if cfg.loss_chunks:
        out = llama_forward(model, tokens, cfg, mesh, rules,
                            return_aux=stats, return_hidden=True)
        h, aux = out if stats else (out, None)
        ce = _chunked_ce(h, model.lm_head, tokens, cfg, rules, targets)
    else:
        out = llama_forward(model, tokens, cfg, mesh, rules,
                            return_aux=stats)
        logits, aux = out if stats else (out, None)
        ce = _dense_ce(logits, tokens, rules, targets)
    if stats:
        with step_span("kctpu.loss"):
            return (ce + cfg.moe_aux_coef * aux["aux_loss"]
                    + cfg.moe_z_coef * aux["z_loss"])
    return ce


@in_step_span("kctpu.loss")
def _dense_ce(logits: torch.Tensor, tokens: torch.Tensor,
              rules: ShardingRules, targets=None) -> torch.Tensor:
    """Next-token CE of whole ``logits`` [B, T, vocab] f32: the mean over
    positions [0, T - 1), or with ``targets`` (:func:`_staged_targets`,
    under sp) the weighted mean of each shard's own positions."""
    logp = torch.log_softmax(_vocab_whole(logits, rules), dim=-1)
    if targets is None:
        nll = -logp[:, :-1].gather(-1, tokens[:, 1:].long()[..., None])
        ce = nll.mean()
    else:
        tgt, weight = targets
        nll = -logp.gather(-1, tgt[..., None])[..., 0]
        ce = torch.sum(nll * weight) / torch.sum(weight)
    return with_logical_constraint(ce, (), rules)


def _shifted(tokens: torch.Tensor):
    """(targets, weight) [B, T]: each position's next token, and weight 1
    but 0 at the final position, which has none."""
    tgt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1).long()
    ones = torch.ones_like(tgt, dtype=torch.float32)
    weight = torch.cat([ones[:, :-1], torch.zeros_like(ones[:, -1:])], dim=1)
    return tgt, weight


def _staged_targets(tokens, mesh, rules: ShardingRules):
    """:func:`_shifted` of the global tokens, each staged as ``("batch",
    "seq")`` on ``mesh`` (every process holds the global tokens, or gathers
    staged ones)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tokens, DTensor):
        tokens = tokens.full_tensor()
    return tuple(stage_tokens(x, mesh, rules) for x in _shifted(tokens))


@in_step_span("kctpu.loss")
def _chunked_ce(h: torch.Tensor, lm_head: torch.Tensor, tokens: torch.Tensor,
                cfg: LlamaConfig, rules: ShardingRules = DEFAULT_RULES,
                targets=None) -> torch.Tensor:
    """Next-token CE over ``cfg.loss_chunks`` sequence chunks, each under
    ``torch.utils.checkpoint``: the backward recomputes a chunk's logits
    from its saved [B, C, D] hidden slice, so one chunk's logits live at a
    time.  The final position has no next token: its weight is zero,
    matching the dense path's mean over positions [0, T-1).

    ``targets``: (targets, weight) staged by :func:`_staged_targets` when
    sp shards T; then each shard chunks its own slice ([B, sp, T/sp]
    views, the shards on dim 1), and T/sp must divide by the chunks.
    Each chunk opens the head's and the loss's spans again, so that its
    re-run in the backward is theirs."""
    b, t, _ = h.shape
    n = cfg.loss_chunks
    sp = 1 if targets is None else _sp_size(h.device_mesh)
    if (t // sp) % n:
        raise ValueError(f"seq len {t} (over sp {sp}) not divisible by "
                         f"loss_chunks {n}")
    dtype = h.dtype
    w = _w(lm_head, dtype)
    tgt, weight = _shifted(tokens) if targets is None else targets
    lead = ("batch",)
    if sp > 1:
        h, tgt, weight = (x.unflatten(1, (sp, t // sp))
                          for x in (h, tgt, weight))
        lead = ("batch", "seq")

    @in_step_span("kctpu.loss")
    def chunk(xc, w, tc, wc):
        with step_span("kctpu.head"):
            xc = with_logical_constraint(xc, (*lead, None, None), rules)
            logits = _mm(xc, w)
        logits = with_logical_constraint(logits.float(),
                                         (*lead, None, "vocab"), rules)
        # The vocab dim gathered, so the softmax runs over whole rows.
        logits = with_logical_constraint(logits, (*lead, None, None), rules)
        lse = torch.logsumexp(logits, dim=-1)
        t_logit = logits.gather(-1, tc[..., None])[..., 0]
        return torch.sum((lse - t_logit) * wc)

    c = t // sp // n
    total = None
    for i in range(n):
        sl = (slice(None),) * len(lead) + (slice(i * c, (i + 1) * c),)
        part = checkpoint(chunk, h[sl], w, tgt[sl], weight[sl],
                          use_reentrant=False)
        total = part if total is None else total + part
    return with_logical_constraint(total / torch.sum(weight), (), rules)


# ---------------------------------------------------------------------------
# Pipeline parallelism
# ---------------------------------------------------------------------------

def _pipeline(model: Llama, cfg: LlamaConfig, mesh, n_stages):
    """``(transport, stages, sub)``: over ``mesh``'s pp group with this
    process's stage (the model holds its layers), or ``n_stages``
    (default 1) virtual stages in one process, each ``n_layers / S``
    layers; ``sub`` the stage's model mesh (None without a mesh).  The
    stage body runs attention per shard on ``sub``, where the reference
    passes ``mesh=None`` inside its pp-manual region: under an sp axis
    above 1, ring or Ulysses attention over the stage's own sp group
    (:func:`_sp_attention`), where the reference's XLA gathers T; each
    rank keeps and hands off its T/sp shard of every activation."""
    one_card_only(cfg, "the pipeline")
    from ..parallel.pipeline import GroupPipe, Lockstep, split_stages

    sub = None if mesh is None else model_mesh(mesh)
    layers = list(model.layers)
    if pp_size(mesh) > 1:
        dev = model.embed.device
        return GroupPipe(pp_group(mesh), dev), [layers], sub
    n = n_stages or 1
    return Lockstep(n), split_stages(layers, n), sub


def _stage_fn(cfg: LlamaConfig, rope, sub, rules: ShardingRules,
              extra: str):
    """The stage body: the stage's layers through ``_decoder_layer_fn``
    (remat per layer), returning the output and with ``extra`` "stats" the
    router stats' sums (a dict, for ``llama_forward_pp``), with "penalty"
    (for a MoE config) the stage's router penalty, ``Σ (aux_coef · aux +
    z_coef · z) / n_layers`` (the reference's)."""
    layer_fn = _maybe_remat(_decoder_layer_fn(cfg, rope, sub, rules), cfg)

    def stage_fn(stage, x):
        auxes = []
        for lp in stage:
            x, aux = layer_fn(x, lp)
            auxes.append(aux)
        if not extra:
            return x
        with step_span("kctpu.loss"):
            if extra == "stats":
                return x, {k: sum((a[k] for a in auxes[1:]), auxes[0][k])
                           for k in auxes[0]}
            pens = [cfg.moe_aux_coef * a["aux_loss"]
                    + cfg.moe_z_coef * a["z_loss"] for a in auxes]
            return x, sum(pens[1:], pens[0]) / cfg.n_layers

    return stage_fn


def _microbatches(model: Llama, tokens: torch.Tensor, cfg: LlamaConfig,
                  sub, n_microbatches: int, embed: bool, rules):
    """``(tokens_m, x_m)``: the global batch's M microbatches of rows (each
    staged on ``sub``: under sp each process holds its T/sp columns) and
    their embeddings (``embed``; else tensors shaped alike, and placed as
    the hand-offs are, for a stage that only needs their shape)."""
    from torch.distributed.tensor import DTensor

    b, t = tokens.shape
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible by {n_microbatches} "
                         f"microbatches")
    dtype = torch_dtype(cfg.dtype)
    toks = list(tokens.long().chunk(n_microbatches, dim=0))
    if sub is not None:
        toks = [stage_tokens(tm, sub, rules) for tm in toks]
    if embed:
        return toks, [_lookup(model.embed, tm, dtype, rules) for tm in toks]
    if sub is None:
        like = torch.empty((*toks[0].shape, cfg.dim), dtype=dtype,
                           device=tokens.device)
    else:
        local = toks[0].to_local()
        like = DTensor.from_local(
            torch.empty((*local.shape, cfg.dim), dtype=dtype,
                        device=local.device), sub,
            placements_for(("batch", "seq", None), sub, rules),
            run_check=False)
    return toks, [like] * n_microbatches


def llama_forward_pp(model: Llama, tokens: torch.Tensor, cfg: LlamaConfig,
                     mesh=None, *, n_microbatches: int = 2,
                     n_stages: Optional[int] = None,
                     rules: ShardingRules = DEFAULT_RULES,
                     return_aux: bool = False):
    """Pipeline-parallel forward: the layers as pp stages, the batch as
    ``n_microbatches`` microbatches streaming GPipe-style
    (``parallel/pipeline.py:gpipe``), then the final norm and head:
    logits [B, T, vocab] f32 on every stage's process.

    Over ``mesh``'s pp group when it has a pp axis above 1 (``model``
    built by ``llama_init(mesh=)``: this process's stage), else over
    ``n_stages`` virtual stages in one process.  ``return_aux``: also the
    MoE router stats summed over the stages' layers and the microbatches,
    over ``n_layers × M`` (zeros for dense), as ``llama_forward``'s."""
    from ..parallel.pipeline import gpipe

    transport, stages, sub = _pipeline(model, cfg, mesh, n_stages)
    _, micro = _microbatches(model, tokens, cfg, sub, n_microbatches, True,
                             rules)
    rope = _rope(cfg, tokens.shape[1], sub, tokens.device)
    out = gpipe(_stage_fn(cfg, rope, sub, rules,
                          "stats" if return_aux else ""),
                stages, micro, transport, stage_aux=return_aux)
    out, sums = out if return_aux else (out, None)
    x = torch.cat(list(out), dim=0)
    dtype = torch_dtype(cfg.dtype)
    x = rmsnorm(x, _w(model.final_norm, dtype), cfg.norm_eps)
    with step_span("kctpu.head"):
        logits = with_logical_constraint(_mm(x, _w(model.lm_head, dtype)),
                                         ("batch", "seq", "vocab"), rules)
    with step_span("kctpu.loss"):
        logits = logits.float()
    if return_aux:
        denom = cfg.n_layers * n_microbatches
        return logits, {k: v / denom for k, v in sums.items()}
    return logits


def _microbatch_ce(cfg: LlamaConfig, rules: ShardingRules):
    """The last stage's loss: final norm, head and the next-token CE over
    positions [0, T - 1) of one microbatch (chunked with
    ``cfg.loss_chunks``: the same value).  Its aux is ``(tokens_m,
    targets_m)``: the targets staged by :func:`_staged_targets` from the
    microbatch's global tokens under sp (each shard's CE local, as in
    ``llama_loss``), else None."""
    dtype = torch_dtype(cfg.dtype)

    def loss_fn(loss_params, y, aux_m):
        final_norm, lm_head = loss_params
        tokens_m, targets = aux_m
        h = rmsnorm(y, _w(final_norm, dtype), cfg.norm_eps)
        if cfg.loss_chunks:
            ce = _chunked_ce(h, lm_head, tokens_m, cfg, rules, targets)
        else:
            with step_span("kctpu.head"):
                logits = with_logical_constraint(
                    _mm(h, _w(lm_head, dtype)), ("batch", "seq", "vocab"),
                    rules)
            with step_span("kctpu.loss"):
                logits = logits.float()
            ce = _dense_ce(logits, tokens_m, rules, targets)
        # A replicated DTensor scalar as a plain one (``to_local`` is
        # differentiable): the schedule adds it to plain sums.
        return ce.to_local() if hasattr(ce, "to_local") else ce

    return loss_fn


def llama_loss_and_grads_pp(model: Llama, tokens: torch.Tensor,
                            cfg: LlamaConfig, mesh=None, *,
                            n_microbatches: int = 2,
                            n_stages: Optional[int] = None,
                            rules: ShardingRules = DEFAULT_RULES):
    """The loss and every parameter's gradient under the 1F1B schedule
    (``parallel/pipeline.py:pipeline_1f1b``): each gradient is added to
    the parameter's ``.grad``, as ``llama_loss(...).backward()`` would.
    Returns ``(loss, grads)``: the mean loss, a plain f32 scalar equal on
    every process, and ``{name: parameter.grad}``.

    The stages, their transport and the mesh as :func:`llama_forward_pp`
    takes them.  For MoE configs each stage adds its router penalty
    (``Σ (aux_coef · aux + z_coef · z) / n_layers``), per microbatch, as
    the reference's does.  The embedding's gradient is an ``index_add`` of
    stage 0's input cotangents (under a mesh, the lookup's own backward);
    the embedding, final norm and head are replicated over pp, and their
    gradients, made on stage 0 and on the last stage, are broadcast over
    the pp group, so every copy steps alike.  Under an sp axis above 1 the
    last stage's CE takes each microbatch's targets staged from its global
    tokens (as ``llama_loss`` does): the same loss as ``llama_loss`` on the
    whole batch, each shard's positions local."""
    from ..parallel.pipeline import pipeline_1f1b

    transport, stages, sub = _pipeline(model, cfg, mesh, n_stages)
    first, last = 0 in transport.stages, transport.n - 1 in transport.stages
    with torch.no_grad():
        toks, micro = _microbatches(model, tokens, cfg, sub, n_microbatches,
                                    first, rules)
    targets = [None] * n_microbatches
    if last and _sp_size(sub) > 1:
        targets = [_staged_targets(tm, sub, rules)
                   for tm in tokens.long().chunk(n_microbatches, dim=0)]
    rope = _rope(cfg, tokens.shape[1], sub, tokens.device)
    loss_params = [model.final_norm, model.lm_head]
    loss, stage_grads, loss_grads, input_grads = pipeline_1f1b(
        _stage_fn(cfg, rope, sub, rules,
                  "penalty" if cfg.n_experts else ""), stages, micro,
        _microbatch_ce(cfg, rules), loss_params, list(zip(toks, targets)),
        transport, stage_aux=bool(cfg.n_experts))

    def add(p, g):
        p.grad = g if p.grad is None else p.grad + g

    from ..parallel.pipeline import stage_parameters

    for stage, grads in zip(stages, stage_grads):
        for p, g in zip(stage_parameters(stage), grads):
            add(p, g)
    if first:
        gembed = _embed_grad(model, toks, input_grads, sub, cfg, rules)
    else:
        gembed = torch.zeros_like(model.embed)
    if not last:
        loss_grads = [torch.zeros_like(p) for p in loss_params]
    gembed = transport.broadcast(gembed, 0)
    loss_grads = transport.broadcast(loss_grads, transport.n - 1)
    add(model.embed, gembed)
    for p, g in zip(loss_params, loss_grads):
        add(p, g)
    return loss, {n: p.grad for n, p in model.named_parameters()}


def _embed_grad(model: Llama, toks, input_grads, sub, cfg: LlamaConfig,
                rules) -> torch.Tensor:
    """The embedding's gradient from stage 0's (scaled) input cotangents:
    an ``index_add`` at the token ids, or under a mesh the backward of the
    staged lookup (the vocab-parallel ``_embed``), whose gradient comes
    back placed as the table."""
    table = model.embed
    if sub is None:
        g = torch.stack(list(input_grads)) if not isinstance(
            input_grads, torch.Tensor) else input_grads
        ids = torch.cat(toks, dim=0).reshape(-1)
        return torch.zeros_like(table).index_add_(
            0, ids, g.reshape(ids.numel(), -1).to(table.dtype))
    leaf = table.detach().requires_grad_()
    with torch.enable_grad():
        xs = [_lookup(leaf, tm, torch_dtype(cfg.dtype), rules) for tm in toks]
        (g,) = torch.autograd.grad(xs, [leaf], list(input_grads))
    return g
