"""The attention oracle of ``kubeflow_controller_tpu/parallel/ring.py``.

Only ``attention_reference`` and ``NEG_INF`` are ported here: the f32
O(T²) attention that every flash path (the CUDA kernels of
``ops/attention.py``, their plain versions) is held against, for values and,
through autograd, gradients.  Ring and Ulysses sequence parallelism come
later (ROADMAP.md, M3).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Naive O(T²) attention in f32 — the numerics oracle.

    q/k/v: [B, T, H, D] -> [B, T, H, D] in q's dtype.  Scores are the
    products of the inputs accumulated in f32 (the reference's
    ``preferred_element_type``); masked scores are ``NEG_INF``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        hidden = (torch.arange(tq, device=q.device)[:, None]
                  < torch.arange(tk, device=q.device)[None, :])
        s = s.masked_fill(hidden, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)
