"""The plain reference: the configuration's training steps written out in
plain PyTorch, from the published architecture.

It imports nothing of the program and takes nothing the program made: it
draws the weights again from the seed (``weights.make_flat``), is handed
the same token batches, and computes, as the configuration states them:

- the model's objective, as its architecture module writes it
  (``archs/<model_type>.py``'s ``loss``: the decoder of Mistral-7B and
  Mixtral-8x7B is ``archs/_decoder.py``), in the arithmetic below;
- parameters in float32, activations in bfloat16 (norms, RoPE and
  softmaxes in float32), matrix products in bfloat16 with float32
  accumulation (cuBLAS's reduced-precision reductions off, TF32 off);
- each step: the loss, its gradients, the clip by global norm, then AdamW
  with decoupled weight decay, by hand.

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

from . import archs, weights

FP8_MAX = 448.0
PRECISIONS = ("bf16", "fp8", "fp8_experts", "bf16_state")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (its absmax / 448);
    the gradient passes straight through."""
    with torch.no_grad():
        scale = x.abs().amax().float().clamp_min(1e-30) / FP8_MAX
        q = ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale
             ).to(x.dtype)
    return x + (q - x).detach()


class Math:
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
            x, w = fake_fp8(x), fake_fp8(w)
        return x @ w

    def norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return y.to(self.act) * w.to(self.act)


def loss(conf: dict, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
         precision: str = "bf16") -> torch.Tensor:
    """The training objective on ``tokens`` [B, T], as the configuration's
    architecture (``archs/<model_type>.py``) writes it."""
    return archs.of(conf).loss(conf, params, tokens, precision)


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
