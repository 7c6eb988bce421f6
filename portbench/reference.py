"""The plain reference: the configuration's training steps written out in
plain PyTorch, from the published architecture.

It imports nothing of the program and takes nothing the program made: it
draws the weights again from the seed (``weights.make_flat``), is handed
the same token batches, and computes, as the configuration states them:

- the decoder (Mistral-7B / Mixtral-8x7B): token embedding; per layer
  RMSNorm, q/k/v projections, rotate-half RoPE, causal attention with the
  kv heads repeated to the query heads (GQA), the output projection, a
  second RMSNorm and the SwiGLU FFN, or for a MoE layer the router, its
  top-k (softmax over the chosen logits, ties to the lower expert) and
  every routed (token, expert) pair through that expert's SwiGLU, with no
  capacity limit; the final RMSNorm, the head and next-token
  cross-entropy, plus the router's load-balancing and z losses where the
  configuration trains them;
- parameters in float32, activations in bfloat16 (norms, RoPE and
  softmaxes in float32), matrix products in bfloat16 with float32
  accumulation (cuBLAS's reduced-precision reductions off, TF32 off);
- each step: the loss, its gradients, the clip by global norm, then AdamW
  with decoupled weight decay, by hand.

Attention is ``F.scaled_dot_product_attention``: torch's own kernel, not
the program's, and the only way a [T, T] score matrix at T 32768 fits.
Each layer is recomputed in the backward (``torch.utils.checkpoint``) so
that the reference fits the card beside its optimizer state.

The controls, each the same steps one precision below what the
configuration states (the configuration's ``control`` lists its own):

- ``precision="fp8"``: the operands of every forward matrix product
  rounded to float8 e4m3 (one scale a tensor, its absolute maximum over
  448), a step below the bfloat16 activations;
- ``precision="fp8_experts"``: the same for the expert FFN's products
  alone (the grouped kernels' work), the router and the rest in bfloat16;
- ``precision="bf16_state"``: the parameters, their gradients and AdamW's
  moments kept in bfloat16, a step below the float32 state.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import weights

FP8_MAX = 448.0
PRECISIONS = ("bf16", "fp8", "fp8_experts", "bf16_state")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (its absmax / 448);
    the gradient passes straight through."""
    with torch.no_grad():
        scale = x.abs().amax().float().clamp_min(1e-30) / FP8_MAX
        q = ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale
             ).to(x.dtype)
    return x + (q - x).detach()


class _Math:
    """The arithmetic the configuration states."""

    def __init__(self, conf: dict, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        self.act = DTYPES[conf["port"]["dtype"]]
        self.fp8 = precision == "fp8"
        self.fp8_experts = precision in ("fp8", "fp8_experts")
        self.eps = conf["rms_norm_eps"]

    def lin(self, x: torch.Tensor, w: torch.Tensor,
            expert: bool = False) -> torch.Tensor:
        """x [..., K] @ w [K, N], w cast to the activation dtype; ``expert``
        marks an expert FFN's product."""
        w = w.to(self.act)
        if self.fp8_experts if expert else self.fp8:
            x, w = _fake_fp8(x), _fake_fp8(w)
        return x @ w

    def norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return y.to(self.act) * w.to(self.act)


def _rope_tables(conf: dict, t: int, device):
    d, h = conf["hidden_size"], conf["num_attention_heads"]
    hd = conf.get("head_dim") or d // h
    inv = 1.0 / conf["rope_theta"] ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd)
    ang = torch.arange(t, dtype=torch.float32, device=device)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos(), ang.sin()


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate-half RoPE of x [B, T, H, D] in float32."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return (xf * cos[:, None] + rot * sin[:, None]).to(x.dtype)


def _attention(q, k, v):
    """Causal attention, q [B, T, H, D], k/v [B, T, KV, D] -> [B, T, H·D];
    query head j reads kv head j // (H / KV)."""
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), is_causal=True)
    return o.transpose(1, 2).flatten(2)


def _moe(m: _Math, h, router, w_gate, w_up, w_down, top_k: int):
    """The routed SwiGLU experts of h [B, T, d] -> (y, aux, z)."""
    b, t, d = h.shape
    hf = h.reshape(b * t, d)
    logits = m.lin(hf, router).float()                       # [N, E]
    n_exp = logits.shape[-1]
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    probs = torch.softmax(vals, dim=-1)
    out = torch.zeros((b * t, d), dtype=torch.float32, device=h.device)
    for e in range(n_exp):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = hf[tok]
        ye = m.lin(F.silu(m.lin(xe, w_gate[e], True))
                   * m.lin(xe, w_up[e], True), w_down[e], True)
        out = out.index_add(0, tok, ye.float() * probs[tok, slot, None])
    frac = F.one_hot(idx, n_exp).float().mean(dim=(0, 1))
    share = torch.softmax(logits, dim=-1).mean(dim=0)
    aux = n_exp * torch.sum(frac * share)
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return out.to(h.dtype).view(b, t, d), aux, z


def _layer(conf: dict, m: _Math, cos, sin):
    d, h = conf["hidden_size"], conf["num_attention_heads"]
    kv = conf["num_key_value_heads"]
    hd = conf.get("head_dim") or d // h
    moe = bool(conf.get("num_local_experts", 0))

    def run(x, attn_norm, wq, wk, wv, wo, mlp_norm, *ffn):
        b, t, _ = x.shape
        a = m.norm(x, attn_norm)
        q = _rope(m.lin(a, wq.flatten(1)).view(b, t, h, hd), cos, sin)
        k = _rope(m.lin(a, wk.flatten(1)).view(b, t, kv, hd), cos, sin)
        v = m.lin(a, wv.flatten(1)).view(b, t, kv, hd)
        x = x + m.lin(_attention(q, k, v), wo.flatten(0, 1))
        a = m.norm(x, mlp_norm)
        if moe:
            y, aux, z = _moe(m, a, *ffn, top_k=conf["num_experts_per_tok"])
        else:
            w_gate, w_up, w_down = ffn
            y = m.lin(F.silu(m.lin(a, w_gate)) * m.lin(a, w_up), w_down)
            aux = z = torch.zeros((), device=x.device)
        return x + y, aux, z

    return run


LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm")
DENSE_KEYS = ("w_gate", "w_up", "w_down")
MOE_KEYS = ("router", "w_gate", "w_up", "w_down")


def loss(conf: dict, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
         precision: str = "bf16") -> torch.Tensor:
    """The training objective on ``tokens`` [B, T]."""
    m = _Math(conf, precision)
    t = tokens.shape[1]
    cos, sin = _rope_tables(conf, t, tokens.device)
    run = _layer(conf, m, cos, sin)
    ffn = MOE_KEYS if conf.get("num_local_experts", 0) else DENSE_KEYS
    x = params["embed"][tokens.long()].to(m.act)
    auxes, zs = [], []
    for i in range(conf["num_hidden_layers"]):
        lp = [params[f"layers.{i}.{k}"] for k in LAYER_KEYS + ffn]
        x, aux, z = checkpoint(run, x, *lp, use_reentrant=False)
        auxes.append(aux)
        zs.append(z)
    x = m.norm(x, params["final_norm"])
    logits = m.lin(x, params["lm_head"]).float()
    ce = F.cross_entropy(logits[:, :-1].flatten(0, 1),
                         tokens[:, 1:].flatten().long())
    tr = conf["training"]
    if conf.get("num_local_experts", 0):
        ce = (ce + tr["router_aux_loss_coef"] * torch.stack(auxes).mean()
              + tr["router_z_loss_coef"] * torch.stack(zs).mean())
    return ce


@contextlib.contextmanager
def _strict_matmuls():
    """float32 accumulation in every product while the reference runs."""
    cuda = torch.backends.cuda.matmul
    saved = (cuda.allow_tf32, cuda.allow_bf16_reduced_precision_reduction,
             torch.backends.cudnn.allow_tf32)
    cuda.allow_tf32 = False
    cuda.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (cuda.allow_tf32, cuda.allow_bf16_reduced_precision_reduction,
         torch.backends.cudnn.allow_tf32) = saved


def train(conf: dict, seed: int, batches: List[torch.Tensor], device,
          precision: str = "bf16") -> dict:
    """``len(batches)`` training steps from the seed's initial weights:
    ``{"losses": [...], "grad_norms": {leaf: ‖g‖ after the clip, step 1},
    "embed_rows": [‖g‖ of each embedding row that batch 0 reads, in token
    order, step 1], "change_norms": {leaf: ‖p - p₀‖ after the last step},
    "seconds"}``."""
    t0 = time.perf_counter()
    tr = conf["training"]
    lr, wd, clip = tr["lr"], tr["weight_decay"], tr["clip_norm"]
    b1, b2, eps = tr["beta1"], tr["beta2"], tr["eps"]
    lay = weights.layout(conf)
    flat = weights.make_flat(lay, seed, device)
    if precision == "bf16_state":
        flat = flat.to(torch.bfloat16)
    params = {k: v.requires_grad_() for k, v in lay.views(flat).items()}
    names = list(params)
    m1 = {k: torch.zeros_like(p) for k, p in params.items()}
    m2 = {k: torch.zeros_like(p) for k, p in params.items()}
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    embed_rows: List[float] = []
    ids = torch.unique(batches[0].long())
    with _strict_matmuls():
        for step, tokens in enumerate(batches, start=1):
            value = loss(conf, params, tokens, precision)
            value.backward()
            losses.append(float(value.detach()))
            with torch.no_grad():
                grads = {k: params[k].grad for k in names}
                norms = torch.stack([
                    torch.linalg.vector_norm(g, dtype=torch.float32)
                    for g in grads.values()])
                total = torch.linalg.vector_norm(norms)
                if clip and float(total) >= clip:
                    for g in grads.values():
                        g.div_(total).mul_(clip)
                if step == 1:
                    grad_norms = {k: float(torch.linalg.vector_norm(
                        g, dtype=torch.float32)) for k, g in grads.items()}
                    embed_rows = torch.linalg.vector_norm(
                        grads["embed"][ids].float(), dim=1).tolist()
                c1, c2 = 1 - b1 ** step, 1 - b2 ** step
                for k in names:
                    p, g = params[k], grads[k]
                    p.mul_(1 - lr * wd)
                    m1[k].mul_(b1).add_(g, alpha=1 - b1)
                    m2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (m2[k] / c2).sqrt_().add_(eps)
                    p.addcdiv_(m1[k], denom, value=-lr / c1)
                    p.grad = None
    change = weights.change_norms(lay, seed, {k: p.detach()
                                              for k, p in params.items()})
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return {"losses": losses, "grad_norms": grad_norms,
            "embed_rows": embed_rows, "change_norms": change,
            "seconds": time.perf_counter() - t0}
