"""AFMoE (``model_type`` "afmoe", arcee-ai's Trinity-Mini): a decoder of
sliding-window and global attention layers with gated, QK-normed heads,
two leading dense layers and then sigmoid-routed experts beside a shared
expert.

The equations (``config``: from the published ``config.json``, each
number and switch under its key there; ``modeling code``: from the
family's modeling code, transformers' ``AfmoeForCausalLM``, which no copy
here could be checked against; ``DeepSeek-V3``: its aux-loss-free
balancing).  Notation: d ``hidden_size``, H ``num_attention_heads``, KV
``num_key_value_heads``, hd ``head_dim``, W ``sliding_window``, ε
``rms_norm_eps``; RMSNorm(x; g) = x · rsqrt(mean(x²) + ε) · g, in f32 and
rounded as ``reference.Math.norm`` rounds it.

1. x₀ = E[t] · √d (``mup_enabled``: config; the scale: modeling code).
2. Layer ℓ is sliding where ``layer_types[ℓ]`` says "sliding_attention"
   (every layer but each ``global_attn_every_n_layers``-th: config), else
   global.  Each layer:
   - a = RMSNorm(x; g_in) (modeling code: four norms a layer);
   - q = a Wq [H, hd], k = a Wk [KV, hd], v = a Wv [KV, hd], the gate
     g = a Wg [H · hd] (sizes: config; the gate: modeling code);
   - q ← RMSNorm over hd per head (g_q [hd]), k the same (g_k)
     (modeling code);
   - sliding layers only: rotate-half RoPE on q and k over all hd dims,
     θ ``rope_theta`` (θ: config; sliding layers only: modeling code);
   - o = softmax(q kᵀ / √hd + mask) v, query head j reading kv head
     j // (H / KV); causal, and on a sliding layer query i sees key j
     where i - W < j <= i (W: config);
   - o ← o ⊙ sigmoid(g) (modeling code);
   - x ← x + RMSNorm(o Wo; g_post_attn) (modeling code);
   - b = RMSNorm(x; g_pre_mlp) (modeling code);
   - the first ``num_dense_layers`` layers: m = SwiGLU(b), width
     ``intermediate_size`` (config);
   - the others: s = sigmoid(b Wr) in f32 over every routed expert, from
     logits in the activation dtype (``score_func``: config); the top
     ``num_experts_per_tok`` of s + β, β the layer's f32 expert bias (zero
     at the start), ties to the lower expert; w_e = ``route_scale`` ·
     s_e / (Σ_top s + 1e-20) (``route_norm``, ``route_scale``, no group
     limit as ``n_group`` 1: config); m = SwiGLU_shared(b) + Σ_{e in top,
     e held} w_e · SwiGLU_e(b), widths ``moe_intermediate_size`` and
     ``num_shared_experts`` of it (config), the weights on the experts'
     outputs (modeling code);
   - x ← x + RMSNorm(m; g_post_mlp) (modeling code).
3. RMSNorm(x; g_final), the untied head (``tie_word_embeddings`` false:
   config), next-token cross-entropy; no auxiliary or z loss.
4. After each step, each MoE layer: n_e the routing slots the step's
   tokens gave expert e (every routed expert, held or not), β_e ← β_e +
   ``load_balance_coeff`` · sign(mean(n) - n_e) (DeepSeek-V3's
   aux-loss-free balancing, the coefficient its rate: config).  One card's
   counts: a deployment would sum them over its data-parallel ranks.

One card's share (the configuration's ``deployment``): ``num_experts`` is
the experts held, the first of the ``published`` count, which the router
scores; the experts not held add nothing, here as in the program.

The reference (``loss``) keeps β from call to call in ``params`` under
keys that are not leaves (``reference.train`` steps the leaf names it took
before the first call): each call after the first applies item 4 from the
previous call's counts, and each layer records its counts again when the
backward re-runs it.  Attention is ``F.scaled_dot_product_attention``,
sliding layers with their mask on the memory-efficient backend on the
card (never the math backend: [T, T] scores); every layer and every
chunk of the loss recomputed in the backward, so that the reference fits
beside its optimizer state.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.archs import _decoder
from portbench.reference import Math

INIT_STD = 0.02
CE_CHUNKS = 16                  # the reference's loss, in sequence chunks
ATTN_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "q_norm",
             "k_norm", "attn_gate", "post_attn_norm", "post_mlp_norm")
DENSE_KEYS = ("w_gate", "w_up", "w_down")
MOE_KEYS = ("router", "w_gate", "w_up", "w_down", "shared_gate",
            "shared_up", "shared_down")


def _check(conf: dict) -> None:
    """The switches the equations take as published."""
    want = {"score_func": "sigmoid", "route_norm": True, "n_group": 1,
            "topk_group": 1, "mup_enabled": True,
            "tie_word_embeddings": False}
    for key, value in want.items():
        if conf[key] != value:
            raise ValueError(f"afmoe: {key} {conf[key]!r} is not {value!r}")
    n = conf["global_attn_every_n_layers"]
    for i in range(conf["num_hidden_layers"]):
        kind = "full_attention" if i % n == n - 1 else "sliding_attention"
        if conf["layer_types"][i] != kind:
            raise ValueError(f"afmoe: layer_types[{i}] is not {kind}")


def routed_experts(conf: dict) -> int:
    """The experts the router scores: the published count."""
    return conf["published"].get("num_experts", conf["num_experts"])


def _window(conf: dict, i: int) -> Optional[int]:
    sliding = conf["layer_types"][i] == "sliding_attention"
    return conf["sliding_window"] if sliding else None


def _moe(conf: dict, i: int) -> bool:
    return i >= conf["num_dense_layers"]


def leaves(conf: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """In the port's module-tree order, scaled as its ``llama_init`` scales
    them: 0.02, the residual projections (wo, each w_down, shared_down)
    0.02 / sqrt(2 L), norms one."""
    _check(conf)
    d, v = conf["hidden_size"], conf["vocab_size"]
    h, kv, hd = (conf["num_attention_heads"], conf["num_key_value_heads"],
                 conf["head_dim"])
    n_layers = conf["num_hidden_layers"]
    e, fe = conf["num_experts"], conf["moe_intermediate_size"]
    fs = fe * conf["num_shared_experts"]
    f = conf["intermediate_size"]
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
                 (p + "mlp_norm", (d,), 0.0),
                 (p + "q_norm", (hd,), 0.0),
                 (p + "k_norm", (hd,), 0.0),
                 (p + "attn_gate", (d, h, hd), INIT_STD),
                 (p + "post_attn_norm", (d,), 0.0),
                 (p + "post_mlp_norm", (d,), 0.0)]
        if _moe(conf, i):
            spec += [(p + "router", (d, routed_experts(conf)), INIT_STD),
                     (p + "w_gate", (e, d, fe), INIT_STD),
                     (p + "w_up", (e, d, fe), INIT_STD),
                     (p + "w_down", (e, fe, d), resid),
                     (p + "shared_gate", (d, fs), INIT_STD),
                     (p + "shared_up", (d, fs), INIT_STD),
                     (p + "shared_down", (fs, d), resid)]
        else:
            spec += [(p + "w_gate", (d, f), INIT_STD),
                     (p + "w_up", (d, f), INIT_STD),
                     (p + "w_down", (f, d), resid)]
    spec += [("final_norm", (d,), 0.0), ("lm_head", (d, v), INIT_STD)]
    return spec


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------

def _attention(q, k, v, window: Optional[int]):
    """q [B, T, H, D], k/v [B, T, KV, D] -> [B, T, H·D]: causal, within
    ``window`` keys where given."""
    rep = q.shape[2] // k.shape[2]
    q, k, v = (z.transpose(1, 2) for z in (
        q, k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)))
    if window is None:
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    else:
        pos = torch.arange(q.shape[2], device=q.device)
        ahead = pos[:, None] - pos[None, :]
        keep = (ahead >= 0) & (ahead < window)
        if q.is_cuda:
            from torch.nn.attention import SDPBackend, sdpa_kernel

            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                o = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        else:
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
    return o.transpose(1, 2).flatten(2)


def _swiglu(m: Math, x, w_gate, w_up, w_down, expert: bool = False):
    return m.lin(F.silu(m.lin(x, w_gate, expert)) * m.lin(x, w_up, expert),
                 w_down, expert)


def _routed(conf: dict, m: Math, b, router, w_gate, w_up, w_down, bias,
            record):
    """The held experts' share of the routed FFN of b [B, T, d] (f32
    [N, d]); ``record`` gets the slots' counts by expert."""
    n, d = b.shape[0] * b.shape[1], b.shape[2]
    bf = b.reshape(n, d)
    scores = torch.sigmoid(m.lin(bf, router).float())           # [N, E]
    k = conf["num_experts_per_tok"]
    idx = torch.sort(scores + bias, dim=-1, descending=True,
                     stable=True)[1][:, :k]
    record(torch.bincount(idx.flatten(), minlength=scores.shape[1]).float())
    chosen = scores.gather(1, idx)
    w = chosen / (chosen.sum(dim=-1, keepdim=True) + 1e-20) * \
        conf["route_scale"]
    out = torch.zeros((n, d), dtype=torch.float32, device=b.device)
    for e in range(w_gate.shape[0]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            ye = _swiglu(m, bf[tok], w_gate[e], w_up[e], w_down[e], True)
            out = out.index_add(0, tok, ye.float() * w[tok, slot, None])
    return out


def _layer(conf: dict, m: Math, cos, sin, i: int, bias, record):
    h, kv, hd = (conf["num_attention_heads"], conf["num_key_value_heads"],
                 conf["head_dim"])
    window = _window(conf, i)
    moe = _moe(conf, i)

    def run(x, attn_norm, wq, wk, wv, wo, mlp_norm, q_norm, k_norm,
            attn_gate, post_attn_norm, post_mlp_norm, *ffn):
        bb, t, _ = x.shape
        a = m.norm(x, attn_norm)
        q = m.norm(m.lin(a, wq.flatten(1)).view(bb, t, h, hd), q_norm)
        k = m.norm(m.lin(a, wk.flatten(1)).view(bb, t, kv, hd), k_norm)
        v = m.lin(a, wv.flatten(1)).view(bb, t, kv, hd)
        g = m.lin(a, attn_gate.flatten(1))
        if window is not None:
            q, k = _decoder.rope(q, cos, sin), _decoder.rope(k, cos, sin)
        o = _attention(q, k, v, window) * torch.sigmoid(g)
        x = x + m.norm(m.lin(o, wo.flatten(0, 1)), post_attn_norm)
        b = m.norm(x, mlp_norm)
        if moe:
            router, w_gate, w_up, w_down, sg, su, sd = ffn
            y = _swiglu(m, b, sg, su, sd) + _routed(
                conf, m, b, router, w_gate, w_up, w_down, bias,
                record).to(m.act).view(b.shape)
        else:
            y = _swiglu(m, b, *ffn)
        return x + m.norm(y, post_mlp_norm)

    return run


def _bias(conf: dict, params: Dict[str, torch.Tensor], i: int, device):
    """Layer ``i``'s expert bias, kept in ``params`` across calls; each
    call after the first steps it from the previous call's counts
    (item 4)."""
    key, counts = f"_afmoe.bias.{i}", params.get(f"_afmoe.counts.{i}")
    if key not in params:
        params[key] = torch.zeros(routed_experts(conf), dtype=torch.float32,
                                  device=device)
    if counts is not None:
        params[key] += conf["load_balance_coeff"] * torch.sign(
            counts.mean() - counts)
        del params[f"_afmoe.counts.{i}"]
    return params[key]


def loss(conf: dict, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
         precision: str) -> torch.Tensor:
    m = Math(conf, precision)
    b, t = tokens.shape
    d = conf["hidden_size"]
    cos, sin = _decoder.rope_tables(conf, t, tokens.device)
    x = params["embed"][tokens.long()].to(m.act) * math.sqrt(d)
    for i in range(conf["num_hidden_layers"]):
        keys = ATTN_KEYS + (MOE_KEYS if _moe(conf, i) else DENSE_KEYS)
        lp = [params[f"layers.{i}.{k}"] for k in keys]
        bias = _bias(conf, params, i, tokens.device) if _moe(conf, i) \
            else None

        def record(counts, i=i):
            params[f"_afmoe.counts.{i}"] = counts

        x = checkpoint(_layer(conf, m, cos, sin, i, bias, record), x, *lp,
                       use_reentrant=False)
    x = m.norm(x, params["final_norm"])
    tgt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1).long()
    weight = torch.ones_like(tgt, dtype=torch.float32)
    weight[:, -1] = 0.0

    def chunk(xc, w, tc, wc):
        logits = m.lin(xc, w).float()
        return torch.sum(F.cross_entropy(logits.flatten(0, 1), tc.flatten(),
                                         reduction="none") * wc.flatten())

    c = -(-t // CE_CHUNKS)
    total = sum(checkpoint(chunk, x[:, j:j + c], params["lm_head"],
                           tgt[:, j:j + c], weight[:, j:j + c],
                           use_reentrant=False) for j in range(0, t, c))
    return total / weight.sum()


# ---------------------------------------------------------------------------
# The work the readers charge
# ---------------------------------------------------------------------------

def experts_per_token(conf: dict) -> int:
    """The routed pairs a token sends to the held experts, on average:
    top-k times the held share of the router's experts."""
    return conf["num_experts_per_tok"] * conf["num_experts"] // \
        routed_experts(conf)


def matmul_params_per_token(conf: dict) -> int:
    """Parameters in the matrix products each token passes through: q, k,
    v, the gate and o; the dense FFN, or the router, the shared expert and
    the held experts a token reaches on average; the output head."""
    d = conf["hidden_size"]
    h, kv, hd = (conf["num_attention_heads"], conf["num_key_value_heads"],
                 conf["head_dim"])
    attn = 3 * d * h * hd + 2 * d * kv * hd
    fe = conf["moe_intermediate_size"]
    total = conf["hidden_size"] * conf["vocab_size"]
    for i in range(conf["num_hidden_layers"]):
        if _moe(conf, i):
            ffn = (d * routed_experts(conf)
                   + 3 * d * fe * conf["num_shared_experts"]
                   + 3 * d * fe * experts_per_token(conf))
        else:
            ffn = 3 * d * conf["intermediate_size"]
        total += attn + ffn
    return total


def model_flops_per_token(conf: dict, seq_len: int) -> float:
    """6 x the matrix parameters a token uses, plus each layer's attention
    over the score pairs its mask keeps (T² / 2 causal, T² / 2 - (T -
    W)² / 2 within a window), 12 · H · hd a pair, over T; recomputation
    not counted."""
    pairs = 0.0
    for h, _, hd, w in attention_layers(conf):
        w = min(w or seq_len, seq_len)
        pairs += 12.0 * h * hd * (seq_len ** 2 - (seq_len - w) ** 2) / 2
    return 6.0 * matmul_params_per_token(conf) + pairs / seq_len


def attention_layers(conf: dict
                     ) -> List[Tuple[int, int, int, Optional[int]]]:
    """The query heads, kv heads, head width and window of each layer."""
    return [(conf["num_attention_heads"], conf["num_key_value_heads"],
             conf["head_dim"], _window(conf, i))
            for i in range(conf["num_hidden_layers"])]


def expert_ffn(conf: dict) -> Optional[Tuple[int, int, int, int]]:
    """The held experts, the routed pairs a token sends to them on average
    (:func:`experts_per_token`: 8 x 64 / 128 = 4 for one card's share of
    Trinity-Mini), the model width and the expert width; the shared
    expert runs through the library's GEMMs, not the grouped kernels."""
    return (conf["num_experts"], experts_per_token(conf),
            conf["hidden_size"], conf["moe_intermediate_size"])


PORT_KEYS = {"vocab_size": "vocab_size", "dim": "hidden_size",
             "n_layers": "num_hidden_layers",
             "n_heads": "num_attention_heads",
             "n_kv_heads": "num_key_value_heads",
             "head_width": "head_dim", "intermediate": "intermediate_size",
             "max_seq_len": "max_position_embeddings",
             "rope_theta": "rope_theta", "norm_eps": "rms_norm_eps",
             "window": "sliding_window",
             "global_every": "global_attn_every_n_layers",
             "dense_layers": "num_dense_layers",
             "expert_intermediate": "moe_intermediate_size",
             "shared_experts": "num_shared_experts",
             "experts_held": "num_experts",
             "moe_top_k": "num_experts_per_tok",
             "route_scale": "route_scale",
             "bias_rate": "load_balance_coeff"}


def port_keys(conf: dict) -> List[Tuple[str, object]]:
    """The port's ``LlamaConfig`` keys against the published ones: the
    "afmoe" block (its MoE layers route by sigmoid score, the published
    ``score_func`` that :func:`_check` requires), the head width as
    ``head_width``, the router over every routed expert, dropless grouped
    dispatch and no router loss."""
    _check(conf)
    pairs = [(mine, conf[published]) for mine, published in PORT_KEYS.items()]
    return pairs + [("block", "afmoe"), ("n_experts", routed_experts(conf)),
                    ("moe_dispatch", "grouped"), ("moe_aux_coef", 0.0),
                    ("moe_z_coef", 0.0)]
