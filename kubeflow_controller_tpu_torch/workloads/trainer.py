"""The training optimizers and loops — the port of ``default_optimizer``,
``optax.sgd``/``optax.adam``, ``batch_stack``, ``train_scan``,
``train_scan_stateful``, ``make_dist_step`` and ``train_step_loop_dist``
from ``kubeflow_controller_tpu/workloads/trainer.py``.

The reference chains ``optax.clip_by_global_norm(clip)`` and
``optax.adamw(lr, weight_decay=...)`` (``optax.adam`` without decay).  The
port keeps optax's arithmetic:

- clipping as ``clip_by_global_norm`` does it: the global norm is the
  square root of the sum of squares over every gradient; when it is at or
  above ``clip`` each gradient becomes ``(g / norm) * clip``, otherwise it
  is left alone (``clip_grad_norm_`` would add 1e-6 to the norm).  A
  DTensor gradient (a sharded model) counts whole: its norm is taken over
  every shard, so each process clips by the same global norm; under
  pipeline parallelism (:meth:`Optimizer.over_stages`) each stage's sum of
  squares is added over the pp group, a parameter that every stage holds
  (the embedding, final norm and head) counted on stage 0 only;
- AdamW with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, ``eps_root``
  0) and decoupled decay on every parameter: ``torch.optim.AdamW`` makes
  the same update, ``p -= lr * (m̂ / (sqrt(v̂) + eps) + wd * p)``;
- :func:`adam` is ``optax.adam(lr)`` (no clipping, no decay) and
  :func:`sgd` is ``optax.sgd(lr, momentum)``: optax's trace ``m = g +
  momentum * m``, ``p -= lr * m`` is ``torch.optim.SGD`` with dampening 0.

Gradients are clipped in place.

The loops run eagerly, one step per batch: :func:`train_scan` and
:func:`train_scan_stateful` are the counterparts of the reference's
one-program scans, and :func:`make_dist_step` keeps its collective shape —
every gradient and the loss ride ONE flat f32 ``all_reduce`` per step (the
scans too, inside a process group).  :func:`train_step_loop_dist` resumes
from a restored step and saves every ``checkpoint_every`` steps.  Not
ported: ``record_step_telemetry`` (the obs metrics registry, ROADMAP.md
M7).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, List, Optional, Tuple

import torch

from ..obs.phases import PHASE_FIT
from .progress import reporter

# Beats after a run's first step come at most this often (each reads the
# loss: one host sync).
BEAT_INTERVAL_S = 0.25


@dataclass
class FitResult:
    """What a data-parallel vision main (``flax_mnist``,
    ``cifar_allreduce``) trained and measured."""

    losses: torch.Tensor       # [steps], global means, on the device
    loss: float                # the last step's
    accuracy: float            # on the whole (replicated) eval set
    elapsed_s: float           # batch staging + training, ending in a sync
    process: int
    processes: int
    dp: int                    # data-parallel width (one device a process)
    batch_size: int            # global, after rounding to dp
    model: torch.nn.Module
    saved_to: str = ""         # MODEL_DIR, if this process saved there


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's value over the whole mesh (a norm of a sharded gradient
    is the norm of the whole gradient); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _local(x: torch.Tensor) -> torch.Tensor:
    """This process's shard of a DTensor (in place updates of it update the
    DTensor); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


class Optimizer:
    """A ``torch.optim`` optimizer (``inner``) over a fixed list of
    parameters, with optax's ``clip_by_global_norm`` in front when
    ``clip`` is set: :meth:`step` clips their ``.grad``, then steps."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 make: Callable[[List[torch.nn.Parameter]],
                                torch.optim.Optimizer], *,
                 clip: Optional[float] = None):
        self.params: List[torch.nn.Parameter] = list(params)
        self.clip = clip
        self.inner = make(self.params)
        self.group = None           # the pp group the clip's norm spans
        self.counted: Optional[set] = None

    def over_stages(self, group, shared: Iterable[torch.nn.Parameter],
                    first: bool) -> "Optimizer":
        """Clip by the norm over every pipeline stage: each process's sum
        of squares is all-gathered over ``group`` (the pp group) and added
        in stage order.  ``shared`` (the parameters every stage holds) is
        counted only where ``first`` (stage 0).  Returns self."""
        skip = set() if first else {id(p) for p in shared}
        self.group = group
        self.counted = {id(p) for p in self.params if id(p) not in skip}
        return self

    def _norm(self, params) -> torch.Tensor:
        norms = [_whole(torch.linalg.vector_norm(p.grad.float()))
                 for p in params]
        if self.group is None:
            return torch.linalg.vector_norm(torch.stack(norms))
        import torch.distributed as dist

        local = sum((n.square() for n, p in zip(norms, params)
                     if id(p) in self.counted),
                    torch.zeros((), device=norms[0].device))
        parts = [torch.empty_like(local)
                 for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(parts, local, group=self.group)
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total.sqrt()

    def step(self) -> Optional[torch.Tensor]:
        """Clip every ``.grad`` by the global norm (when ``clip``), then the
        inner update; returns the norm before clipping (None without
        clipping)."""
        norm = None
        if self.clip:
            with_grad = [p for p in self.params if p.grad is not None]
            grads = [p.grad for p in with_grad]
            norm = self._norm(with_grad)
            if norm >= self.clip:  # one host sync per step
                for g in grads:
                    g = _local(g)
                    g.div_(norm.to(g.dtype)).mul_(self.clip)
        self.inner.step()
        return norm

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)


def default_optimizer(params: Iterable[torch.nn.Parameter], lr: float, *,
                      clip: Optional[float] = 1.0,
                      weight_decay: float = 0.0) -> Optimizer:
    """Clip by global norm (when ``clip``), then AdamW (Adam when
    ``weight_decay`` is 0, as ``optax.adam`` equals ``adamw`` without
    decay)."""
    return Optimizer(params, lambda ps: torch.optim.AdamW(
        ps, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay),
        clip=clip)


def adam(params: Iterable[torch.nn.Parameter], lr: float) -> Optimizer:
    """``optax.adam(lr)``: Adam, b1 0.9, b2 0.999, eps 1e-8, no clipping."""
    return Optimizer(params, lambda ps: torch.optim.Adam(
        ps, lr=lr, betas=(0.9, 0.999), eps=1e-8))


def sgd(params: Iterable[torch.nn.Parameter], lr: float,
        momentum: float = 0.9) -> Optimizer:
    """``optax.sgd(lr, momentum)``: heavy-ball momentum, no dampening, no
    Nesterov, no clipping."""
    return Optimizer(params, lambda ps: torch.optim.SGD(
        ps, lr=lr, momentum=momentum, dampening=0.0))


def batch_stack(x: torch.Tensor, y: torch.Tensor, steps: int,
                batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[n, ...] data -> ([steps, bs, ...], [steps, bs]) cycling over n."""
    n = x.shape[0]
    ar = torch.arange(steps, device=x.device)[:, None] * batch_size
    idx = (ar + torch.arange(batch_size, device=x.device)[None, :]) % n
    return x[idx], y[idx]


def _mean_over_group(params: List[torch.nn.Parameter],
                     loss: torch.Tensor) -> torch.Tensor:
    """Every ``.grad`` and the loss flattened into one f32 buffer, summed by
    ONE ``all_reduce`` over the default group when one is joined and
    divided by its size; the gradients become views of the mean.  Returns
    the mean loss."""
    import torch.distributed as dist

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
    return flat[-1].clone()


def train_scan_stateful(
        loss_fn: Callable[[torch.Tensor, torch.Tensor, Any],
                          Tuple[torch.Tensor, Any]],
        optimizer: Optimizer, state: Any, xs: torch.Tensor,
        ys: torch.Tensor) -> Tuple[Any, torch.Tensor]:
    """Train one step per stacked batch ``(xs[i], ys[i])``:
    ``loss_fn(xb, yb, state) -> (loss, new_state)`` threads model state
    such as BatchNorm's running statistics from step to step, then backward
    and ``optimizer.step()``.  Inside a process group each process holds
    its rows of every global batch, and the gradients and the loss are
    averaged over the group in one flat ``all_reduce`` a step, as in
    :func:`make_dist_step` (``loss_fn`` is the mean over the process's
    rows, so the average is the global batch's mean).  Returns
    ``(state, losses)``: the last state and the per-step (global) losses
    ``[steps]``, detached, on the batches' device."""
    losses = []
    for xb, yb in zip(xs, ys):
        optimizer.zero_grad()
        loss, state = loss_fn(xb, yb, state)
        loss.backward()
        losses.append(_mean_over_group(optimizer.params, loss))
        optimizer.step()
    return state, torch.stack(losses)


def train_scan(loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
               optimizer: Optimizer, xs: torch.Tensor,
               ys: torch.Tensor) -> torch.Tensor:
    """:func:`train_scan_stateful` without state.  Returns the per-step
    losses ``[steps]``."""
    return train_scan_stateful(lambda xb, yb, st: (loss_fn(xb, yb), st),
                               optimizer, None, xs, ys)[1]


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
    params = optimizer.params

    def step(x_all: torch.Tensor, y_all: torch.Tensor,
             t: int) -> torch.Tensor:
        i = t % x_all.shape[0]
        optimizer.zero_grad()
        loss = loss_fn(x_all[i], y_all[i])
        loss.backward()
        loss = _mean_over_group(params, loss)
        optimizer.step()
        return loss

    return step


def train_step_loop_dist(step: Callable, x_all: torch.Tensor,
                         y_all: torch.Tensor, steps: int,
                         examples_per_step: int = 0,
                         compile_source: str = "", start_step: int = 0,
                         checkpoint_every: int = 0,
                         checkpoint_fn: Optional[Callable[[int], None]] = None
                         ) -> torch.Tensor:
    """Drive a :func:`make_dist_step` step from ``start_step`` to ``steps``
    with real per-step progress: the first step beats at once
    (``step=start_step + 1``, its loss, ``phase="fit"``,
    ``compile_source``, its throughput, and ``resumed_from_step`` when
    resuming), later steps at most every ``BEAT_INTERVAL_S``, and a final
    beat closes the run.

    Recovery hooks: ``start_step`` > 0 resumes a restored run (a restore
    at or past the finish line re-runs the last step, so the run keeps a
    loss and a final beat); ``checkpoint_fn(done_steps)`` runs after every
    ``checkpoint_every`` completed steps, except the first step run and the
    last (as in the reference; callers pass an
    async ``CheckpointManager.save``, so the write overlaps the next
    steps).  Returns the per-step losses of the steps run,
    ``[steps - start_step]``."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    start_step = max(0, min(start_step, steps - 1))
    run_steps = steps - start_step
    rep = reporter()

    t0 = time.perf_counter()
    losses = [step(x_all, y_all, start_step)]
    first = float(losses[0])
    first_s = time.perf_counter() - t0
    rep.beat(step=start_step + 1, loss=first, phase=PHASE_FIT,
             compile_source=compile_source,
             resumed_from_step=start_step if start_step else None,
             examples_per_sec=(examples_per_step / first_s
                               if first_s > 0 and examples_per_step
                               else None))
    next_beat = time.perf_counter() + BEAT_INTERVAL_S
    for t in range(start_step + 1, steps):
        losses.append(step(x_all, y_all, t))
        done = t + 1
        if (checkpoint_fn is not None and checkpoint_every > 0
                and done % checkpoint_every == 0 and done < steps):
            checkpoint_fn(done)
        now = time.perf_counter()
        if now >= next_beat:
            next_beat = now + BEAT_INTERVAL_S
            rep.beat(step=done, loss=float(losses[-1]),
                     examples_per_sec=((done - start_step)
                                       * examples_per_step / (now - t0)
                                       if examples_per_step else None))
    out = torch.stack(losses)
    final = float(out[-1])
    dur = time.perf_counter() - t0
    rep.beat(step=steps, loss=final, phase=PHASE_FIT,
             examples_per_sec=(run_steps * examples_per_step / dur
                               if dur > 0 and examples_per_step else None))
    return out
