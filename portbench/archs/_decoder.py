"""The decoder of Mistral-7B and Mixtral-8x7B, which ``archs/mistral.py``
and ``archs/mixtral.py`` take whole: a dense layer, or a MoE layer where
the configuration has ``num_local_experts``.

The reference (``loss``) computes, as the configuration states it: token
embedding; per layer RMSNorm, q/k/v projections, rotate-half RoPE, causal
attention over every earlier position (``sliding_window`` null) with the
kv heads repeated to the query heads (GQA), the output projection, a
second RMSNorm and the SwiGLU FFN, or for a MoE layer the router, its
top-k (softmax over the chosen logits, ties to the lower expert) and
every routed (token, expert) pair through that expert's SwiGLU, with no
capacity limit; the final RMSNorm, the head and next-token cross-entropy,
plus the router's load-balancing and z losses where the configuration
trains them.

Attention is ``F.scaled_dot_product_attention``: torch's own kernel, not
the program's, and the only way a [T, T] score matrix at T 32768 fits.
Each layer is recomputed in the backward (``torch.utils.checkpoint``) so
that the reference fits the card beside its optimizer state.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import Math

INIT_STD = 0.02


def _head_dim(conf: dict) -> int:
    return conf.get("head_dim") or conf["hidden_size"] // \
        conf["num_attention_heads"]


def leaves(conf: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """Scaled as the port's ``llama_init`` scales them: 0.02, the residual
    projections 0.02 / sqrt(2 L), the norms' scales set to one."""
    d, v = conf["hidden_size"], conf["vocab_size"]
    h, kv = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = _head_dim(conf)
    f, n_layers = conf["intermediate_size"], conf["num_hidden_layers"]
    e = conf.get("num_local_experts", 0)
    resid = INIT_STD / math.sqrt(2 * n_layers)
    spec: List[Tuple[str, Tuple[int, ...], float]] = [
        ("embed", (v, d), INIT_STD)]
    for i in range(n_layers):
        p = f"layers.{i}."
        spec += [(p + "attn_norm", (d,), 0.0),
                 (p + "wq", (d, h, hd), INIT_STD),
                 (p + "wk", (d, kv, hd), INIT_STD),
                 (p + "wv", (d, kv, hd), INIT_STD),
                 (p + "wo", (h, hd, d), resid),
                 (p + "mlp_norm", (d,), 0.0)]
        if e:
            spec += [(p + "router", (d, e), INIT_STD),
                     (p + "w_gate", (e, d, f), INIT_STD),
                     (p + "w_up", (e, d, f), INIT_STD),
                     (p + "w_down", (e, f, d), resid)]
        else:
            spec += [(p + "w_gate", (d, f), INIT_STD),
                     (p + "w_up", (d, f), INIT_STD),
                     (p + "w_down", (f, d), resid)]
    spec += [("final_norm", (d,), 0.0), ("lm_head", (d, v), INIT_STD)]
    return spec


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------

def rope_tables(conf: dict, t: int, device):
    hd = _head_dim(conf)
    inv = 1.0 / conf["rope_theta"] ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd)
    ang = torch.arange(t, dtype=torch.float32, device=device)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos(), ang.sin()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
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


def _moe(m: Math, h, router, w_gate, w_up, w_down, top_k: int):
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


def _layer(conf: dict, m: Math, cos, sin):
    h, kv = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = _head_dim(conf)
    moe = bool(conf.get("num_local_experts", 0))

    def run(x, attn_norm, wq, wk, wv, wo, mlp_norm, *ffn):
        b, t, _ = x.shape
        a = m.norm(x, attn_norm)
        q = rope(m.lin(a, wq.flatten(1)).view(b, t, h, hd), cos, sin)
        k = rope(m.lin(a, wk.flatten(1)).view(b, t, kv, hd), cos, sin)
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
         precision: str) -> torch.Tensor:
    m = Math(conf, precision)
    t = tokens.shape[1]
    cos, sin = rope_tables(conf, t, tokens.device)
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


# ---------------------------------------------------------------------------
# The work the readers charge
# ---------------------------------------------------------------------------

def matmul_params_per_token(conf: dict) -> int:
    """Parameters in the matrix products each token passes through: the
    attention projections, the FFN (for a MoE layer the router and top-k of
    the experts), and the output head; the embedding lookup is not a
    product."""
    d = conf["hidden_size"]
    h, kv = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = _head_dim(conf)
    f = conf["intermediate_size"]
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    experts = conf.get("num_local_experts", 0)
    if experts:
        ffn = conf["num_experts_per_tok"] * 3 * d * f + d * experts
    else:
        ffn = 3 * d * f
    return conf["num_hidden_layers"] * (attn + ffn) + d * conf["vocab_size"]


def model_flops_per_token(conf: dict, seq_len: int) -> float:
    """6 x the matrix parameters a token uses (forward and backward), plus
    causal attention's 6 · L · T · (H · head_dim); recomputation is not
    counted."""
    h = conf["num_attention_heads"]
    attn = 6.0 * conf["num_hidden_layers"] * seq_len * h * _head_dim(conf)
    return 6.0 * matmul_params_per_token(conf) + attn


def attention_layers(conf: dict
                     ) -> List[Tuple[int, int, int, Optional[int]]]:
    """Every layer alike: the query heads, the kv heads, no window."""
    return [(conf["num_attention_heads"], conf["num_key_value_heads"],
             _head_dim(conf), None)] * conf["num_hidden_layers"]


def expert_ffn(conf: dict) -> Optional[Tuple[int, int, int, int]]:
    """The experts, top-k, model width and expert width of a MoE layer;
    None for the dense decoder."""
    experts = conf.get("num_local_experts", 0)
    if not experts:
        return None
    return (experts, conf["num_experts_per_tok"], conf["hidden_size"],
            conf["intermediate_size"])


PORT_KEYS = {"vocab_size": "vocab_size", "dim": "hidden_size",
             "n_layers": "num_hidden_layers", "n_heads": "num_attention_heads",
             "n_kv_heads": "num_key_value_heads",
             "intermediate": "intermediate_size",
             "max_seq_len": "max_position_embeddings",
             "rope_theta": "rope_theta", "norm_eps": "rms_norm_eps"}


def port_keys(conf: dict) -> List[Tuple[str, object]]:
    """The port's ``LlamaConfig`` keys against the published ones; the
    port's head width is ``dim // n_heads``, which has to be the published
    ``head_dim``; a MoE layer's routing as the configuration trains it."""
    pairs = [(mine, conf[published]) for mine, published in PORT_KEYS.items()]
    pairs.append(("head_dim", conf.get(
        "head_dim", conf["hidden_size"] // conf["num_attention_heads"])))
    if conf.get("num_local_experts"):
        tr = conf["training"]
        pairs += [("n_experts", conf["num_local_experts"]),
                  ("moe_top_k", conf["num_experts_per_tok"]),
                  ("moe_aux_coef", conf["router_aux_loss_coef"]),
                  ("moe_aux_coef", tr["router_aux_loss_coef"]),
                  ("moe_z_coef", tr["router_z_loss_coef"]),
                  ("moe_dispatch", "grouped")]
    return pairs
