"""The training optimizer — the port of ``default_optimizer`` from
``kubeflow_controller_tpu/workloads/trainer.py``.

The reference chains ``optax.clip_by_global_norm(clip)`` and
``optax.adamw(lr, weight_decay=...)`` (``optax.adam`` without decay).  The
port keeps optax's arithmetic:

- clipping as ``clip_by_global_norm`` does it: the global norm is the
  square root of the sum of squares over every gradient; when it is at or
  above ``clip`` each gradient becomes ``(g / norm) * clip``, otherwise it
  is left alone (``clip_grad_norm_`` would add 1e-6 to the norm);
- AdamW with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, ``eps_root``
  0) and decoupled decay on every parameter: ``torch.optim.AdamW`` makes
  the same update, ``p -= lr * (m̂ / (sqrt(v̂) + eps) + wd * p)``.

Gradients are clipped in place.  The rest of the reference's trainer (the
MNIST loops, the flat all-reduce) is M5 (ROADMAP.md).
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch


class Optimizer:
    """``default_optimizer``'s chain over a fixed list of parameters:
    :meth:`step` clips their ``.grad`` and applies AdamW."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float, *,
                 clip: Optional[float] = 1.0, weight_decay: float = 0.0):
        self.params: List[torch.nn.Parameter] = list(params)
        self.clip = clip
        self.adamw = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=weight_decay)

    def step(self) -> Optional[torch.Tensor]:
        """Clip every ``.grad`` by the global norm, then the AdamW update;
        returns the norm before clipping (None without clipping)."""
        norm = None
        if self.clip:
            grads = [p.grad for p in self.params if p.grad is not None]
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in grads]))
            if norm >= self.clip:  # one host sync per step
                for g in grads:
                    g.div_(norm.to(g.dtype)).mul_(self.clip)
        self.adamw.step()
        return norm

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)


def default_optimizer(params: Iterable[torch.nn.Parameter], lr: float, *,
                      clip: Optional[float] = 1.0,
                      weight_decay: float = 0.0) -> Optimizer:
    """Clip by global norm (when ``clip``), then AdamW (Adam when
    ``weight_decay`` is 0, as ``optax.adam`` equals ``adamw`` without
    decay)."""
    return Optimizer(params, lr, clip=clip, weight_decay=weight_decay)
