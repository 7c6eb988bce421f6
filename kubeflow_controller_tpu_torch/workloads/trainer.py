"""The training optimizer and the MNIST training loops — the port of
``default_optimizer``, ``batch_stack``, ``train_scan``, ``make_dist_step``
and ``train_step_loop_dist`` from ``kubeflow_controller_tpu/workloads/
trainer.py``.

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

Gradients are clipped in place.

The loops run eagerly, one step per batch: :func:`train_scan` is the
counterpart of the reference's one-program scan, and :func:`make_dist_step`
keeps its collective shape — every gradient and the loss ride ONE flat f32
``all_reduce`` per step.  Not ported: ``record_step_telemetry`` (the obs
metrics registry, ROADMAP.md M7) and the checkpoint/resume hooks of the
step loop (M5b).
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, List, Optional, Tuple

import torch

from ..obs.phases import PHASE_FIT
from .progress import reporter

# Beats after a run's first step come at most this often (each reads the
# loss: one host sync).
BEAT_INTERVAL_S = 0.25


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


def batch_stack(x: torch.Tensor, y: torch.Tensor, steps: int,
                batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[n, ...] data -> ([steps, bs, ...], [steps, bs]) cycling over n."""
    n = x.shape[0]
    ar = torch.arange(steps, device=x.device)[:, None] * batch_size
    idx = (ar + torch.arange(batch_size, device=x.device)[None, :]) % n
    return x[idx], y[idx]


def train_scan(loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
               optimizer: Optimizer, xs: torch.Tensor,
               ys: torch.Tensor) -> torch.Tensor:
    """Train one step per stacked batch ``(xs[i], ys[i])``: ``loss_fn`` ->
    backward -> ``optimizer.step()``.  Returns the per-step losses
    ``[steps]``, detached, on the batches' device."""
    losses = []
    for xb, yb in zip(xs, ys):
        optimizer.zero_grad()
        loss = loss_fn(xb, yb)
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
    return torch.stack(losses)


def make_dist_step(loss_fn: Callable[[torch.Tensor, torch.Tensor],
                                     torch.Tensor],
                   optimizer: Optimizer) -> Callable:
    """One data-parallel train step over the default process group.

    ``step(x_all, y_all, t) -> loss``: ``x_all``/``y_all`` are this
    process's columns of every stacked batch (``[n_steps, local_bs,
    ...]``); the step trains on batch ``t % n_steps``.  Every gradient and
    the local loss are flattened into one f32 buffer, summed by ONE
    ``all_reduce`` and divided by the world size; the gradients become
    views of the mean and the optimizer (clip, then Adam) steps.  The
    returned loss is the global mean.  With no process group (one
    process) the collective is skipped, as a psum over one member is."""
    import torch.distributed as dist

    params = optimizer.params

    def step(x_all: torch.Tensor, y_all: torch.Tensor,
             t: int) -> torch.Tensor:
        i = t % x_all.shape[0]
        optimizer.zero_grad()
        loss = loss_fn(x_all[i], y_all[i])
        loss.backward()
        flat = torch.cat([p.grad.reshape(-1).float() for p in params]
                         + [loss.detach().reshape(1).float()])
        world = 1
        if dist.is_initialized():
            dist.all_reduce(flat, op=dist.ReduceOp.SUM)
            world = dist.get_world_size()
        flat.div_(world)
        offset = 0
        for p in params:
            n = p.numel()
            p.grad = flat[offset:offset + n].view_as(p).to(p.dtype)
            offset += n
        optimizer.step()
        return flat[-1].clone()

    return step


def train_step_loop_dist(step: Callable, x_all: torch.Tensor,
                         y_all: torch.Tensor, steps: int,
                         examples_per_step: int = 0,
                         compile_source: str = "") -> torch.Tensor:
    """Drive a :func:`make_dist_step` step for ``steps`` steps with real
    per-step progress: the first step beats at once (``step=1``, its
    loss, ``phase="fit"``, ``compile_source`` and its throughput), later
    steps at most every ``BEAT_INTERVAL_S``, and a final beat closes the
    run.  Returns the
    per-step losses ``[steps]``."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    rep = reporter()
    t0 = time.perf_counter()
    losses = [step(x_all, y_all, 0)]
    first = float(losses[0])
    first_s = time.perf_counter() - t0
    rep.beat(step=1, loss=first, phase=PHASE_FIT,
             compile_source=compile_source,
             examples_per_sec=(examples_per_step / first_s
                               if first_s > 0 and examples_per_step
                               else None))
    next_beat = time.perf_counter() + BEAT_INTERVAL_S
    for t in range(1, steps):
        losses.append(step(x_all, y_all, t))
        now = time.perf_counter()
        if now >= next_beat:
            next_beat = now + BEAT_INTERVAL_S
            rep.beat(step=t + 1, loss=float(losses[-1]),
                     examples_per_sec=((t + 1) * examples_per_step
                                       / (now - t0)
                                       if examples_per_step else None))
    out = torch.stack(losses)
    final = float(out[-1])
    dur = time.perf_counter() - t0
    rep.beat(step=steps, loss=final, phase=PHASE_FIT,
             examples_per_sec=(steps * examples_per_step / dur
                               if dur > 0 and examples_per_step else None))
    return out
