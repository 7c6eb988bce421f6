"""The training optimizers and loops — the port of ``default_optimizer``,
``optax.sgd``/``optax.adam``, ``batch_stack``, ``train_scan``,
``train_scan_stateful``, ``train_scan_dist``, ``make_dist_step`` and
``train_step_loop_dist`` from
``kubeflow_controller_tpu/workloads/trainer.py``.

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

The clip's scale is chosen by a select on the device: the step never
waits for the host, so a CUDA graph can hold it.  :func:`default_optimizer`
builds :class:`FusedAdamW`: on CUDA parameters the clip hands its scale to
the one-pass AdamW kernel (``ops/adamw.py``), which applies it in
registers and leaves ``.grad`` unclipped; every other inner optimizer, and
every CPU run, clips ``.grad`` in place and then steps.

The reference's scans (:func:`train_scan`, :func:`train_scan_stateful`,
:func:`train_scan_dist`) are each one compiled program; the port's are
each one CUDA graph on the card, captured once and replayed once
(:class:`OneProgram`), and run eagerly step by step on the CPU.
:func:`make_dist_step` keeps the reference's collective shape — every
gradient and the loss ride ONE flat f32 ``all_reduce`` per step (the scans
too, inside a process group).  :func:`train_scan_dist` emits the
reference's ``trainer/fit`` span, beats and telemetry around its one
program, and its capture is the fit's ``workload/compile``; the
reference's ``train_scan`` emits no span and no telemetry, and neither
does the port's.  :func:`train_step_loop_dist` drives one step at a time
(the reference's ``--step-loop`` fit): it resumes from a restored step and
saves every ``checkpoint_every`` steps, inside the ``workload/first_step``
and ``workload/fit`` spans, and publishes :func:`record_step_telemetry`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import (Any, Callable, Iterable, List, NamedTuple,
                    Optional, Tuple)

import torch

from ..obs.metrics import REGISTRY
from ..obs.phases import PHASE_FIT
from ..obs.trace import span, step_span
from ..ops.adamw import adamw_step
from .progress import reporter
from .runtime import process_index

# Beats after a run's first step come at most this often (each reads the
# loss: one host sync).
BEAT_INTERVAL_S = 0.25


def record_step_telemetry(steps: int, duration_s: float,
                          examples_per_step: int = 0,
                          registry=None) -> None:
    """Publish a training run's step time and throughput on the metrics
    registry, as the reference does: one observation of the run's mean
    step time and of its wall time, cumulative step and example counters,
    and an examples-per-second gauge."""
    reg = registry or REGISTRY
    if steps <= 0 or duration_s < 0:
        return
    reg.histogram(
        "kctpu_trainer_step_duration_seconds",
        "Mean per-step train time of a completed run (one observation per run)",
    ).observe(duration_s / steps)
    reg.histogram(
        "kctpu_trainer_fit_duration_seconds",
        "Whole-run compiled-train-program wall time",
    ).observe(duration_s)
    reg.counter("kctpu_trainer_steps_total",
                "Training steps completed").inc(steps)
    if examples_per_step > 0:
        reg.counter("kctpu_trainer_examples_total",
                    "Training examples consumed").inc(steps * examples_per_step)
        if duration_s > 0:
            reg.gauge("kctpu_trainer_examples_per_second",
                      "Throughput of the most recent completed run").set(
                steps * examples_per_step / duration_s)


@dataclass
class FitResult:
    """What a data-parallel vision main (``flax_mnist``,
    ``cifar_allreduce``) trained and measured."""

    losses: torch.Tensor       # [steps], global means, on the device
    loss: float                # the last step's
    accuracy: float            # on the whole (replicated) eval set
    elapsed_s: float           # batch staging + training, ending in a sync
    process: int               # the pod (jax.process_index)
    processes: int
    dp: int                    # data-parallel width (one device a rank)
    batch_size: int            # global, after rounding to dp
    model: torch.nn.Module
    saved_to: str = ""         # MODEL_DIR, if this process saved there
    local_rank: int = 0        # the rank among its pod's local devices


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


GradScale = Tuple[torch.Tensor, torch.Tensor]


class FusedAdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` whose step, for parameters on CUDA, is one
    launch of the one-pass AdamW kernel a parameter tensor
    (``ops/adamw.py``), with the clip's ``grad_scale = (div, mul)``, when
    given, applied to each gradient in registers: ``.grad`` is read and
    left unclipped.  The ``param_groups``, the ``state[p]`` keys (``step``,
    ``exp_avg``, ``exp_avg_sq``) and the ``state_dict`` are AdamW's, so a
    checkpoint loads into either class.  A capturable group keeps its step
    count on the device, where the kernel reads it, so a CUDA graph can
    hold the step.  A DTensor steps its local shard (the update is
    elementwise).  CPU parameters take AdamW's own step, and no
    ``grad_scale``.  Raises on amsgrad, maximize and differentiable groups
    of CUDA parameters."""

    @torch.no_grad()
    def step(self, closure=None, grad_scale: Optional[GradScale] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        on_card = [p.device.type == "cuda" for group in self.param_groups
                   for p in group["params"] if p.grad is not None]
        if not any(on_card):
            if grad_scale is not None:
                raise ValueError("grad_scale is taken for CUDA parameters")
            super().step()
            return loss
        if not all(on_card):
            raise ValueError("FusedAdamW steps CUDA or CPU parameters, not "
                             "both")
        for group in self.param_groups:
            self._step_group(group, grad_scale)
        return loss

    def _step_group(self, group: dict,
                    grad_scale: Optional[GradScale]) -> None:
        for key in ("amsgrad", "maximize", "differentiable"):
            if group[key]:
                raise ValueError(f"FusedAdamW does not take {key}=True")
        capturable = group["capturable"]
        if not capturable and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a step inside a CUDA graph needs capturable "
                               "groups")
        params = [p for p in group["params"] if p.grad is not None]
        if not params:
            return
        states = [self._state(p, capturable) for p in params]
        torch._foreach_add_([st["step"] for st in states], 1)
        for p, st in zip(params, states):
            adamw_step(_local(p), _local(p.grad), _local(st["exp_avg"]),
                       _local(st["exp_avg_sq"]), lr=group["lr"],
                       betas=group["betas"], eps=group["eps"],
                       weight_decay=group["weight_decay"],
                       step=0.0 if capturable else float(st["step"]),
                       device_step=st["step"] if capturable else None,
                       grad_scale=grad_scale)

    def _state(self, p: torch.Tensor, capturable: bool) -> dict:
        """``state[p]``, made as AdamW makes it on a first step."""
        state = self.state[p]
        if not state:
            state["step"] = (
                torch.zeros((), dtype=torch.float32, device=p.device)
                if capturable else torch.tensor(0.0, dtype=torch.float32))
            state["exp_avg"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
        return state


class Optimizer:
    """A ``torch.optim`` optimizer (``inner``) over a fixed list of
    parameters, with optax's ``clip_by_global_norm`` in front when
    ``clip`` is set: :meth:`step` clips their ``.grad``, then steps.  When
    ``inner`` is a :class:`FusedAdamW` on CUDA parameters the clip's scale
    goes to its step instead, and ``.grad`` is left unclipped."""

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
        """Clip by the global norm (when ``clip``), then the inner update;
        returns the norm before clipping (None without clipping).  The
        clip runs under the ``kctpu.clip`` span, both under
        ``kctpu.optimizer``.  With a :class:`FusedAdamW` on CUDA
        parameters the clip computes the norm and its scale, and the
        update applies the scale: ``.grad`` is left as the backward made
        it."""
        norm = scale = None
        with step_span("kctpu.optimizer"):
            if self.clip:
                with step_span("kctpu.clip"):
                    norm, scale = self._clip()
            if scale is None:
                self.inner.step()
            else:
                self.inner.step(grad_scale=scale)
        return norm

    def _clip(self) -> Tuple[torch.Tensor, Optional[GradScale]]:
        """The norm, and the scale ``(div, mul)`` for a :class:`FusedAdamW`
        on CUDA parameters to apply (None: ``.grad`` clipped here)."""
        with_grad = [p for p in self.params if p.grad is not None]
        grads = [p.grad for p in with_grad]
        norm = self._norm(with_grad)
        # (g / norm) * clip where the norm reaches the clip, else g / 1 * 1
        # (exactly g): chosen on the device, so the step never waits for
        # the host and a CUDA graph can hold it.
        hit = norm >= self.clip
        div = torch.where(hit, norm, 1.0)
        mul = torch.where(hit, self.clip, 1.0)
        if (isinstance(self.inner, FusedAdamW)
                and all(g.device.type == "cuda" for g in grads)):
            return norm, (div, mul)
        for g in grads:
            g = _local(g)
            g.div_(div.to(g.dtype)).mul_(mul.to(g.dtype))
        return norm, None

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)


def default_optimizer(params: Iterable[torch.nn.Parameter], lr: float, *,
                      clip: Optional[float] = 1.0,
                      weight_decay: float = 0.0) -> Optimizer:
    """Clip by global norm (when ``clip``), then AdamW (Adam when
    ``weight_decay`` is 0, as ``optax.adam`` equals ``adamw`` without
    decay): :class:`FusedAdamW`, one kernel pass a parameter tensor on
    CUDA with the clip's scale folded in."""
    return Optimizer(params, lambda ps: FusedAdamW(
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


def _group_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed in place over the default group by one ``all_reduce``
    when one is joined (a sum over one member is the value)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def _tensors(tree: Any) -> List[torch.Tensor]:
    """The tensors of a (nested) dict, list or tuple, or the tensor."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in _tensors(item)]
    return []


def _make_capturable(optimizer: Optimizer) -> None:
    """Let ``optimizer`` step inside a CUDA graph: its inner optimizer's
    groups turn ``capturable`` (Adam and AdamW then keep their step count
    on the device and compute the bias corrections there; SGD has nothing
    on the host), and step counts made on the host move to the device."""
    for group in optimizer.inner.param_groups:
        if "capturable" in group:
            group["capturable"] = True
    for p, state in optimizer.inner.state.items():
        step = state.get("step")
        if isinstance(step, torch.Tensor) and step.device != p.device:
            state["step"] = step.to(p.device, torch.float32)


class OneProgram:
    """A whole fit as one program, the counterpart of the reference's one
    jitted scan.

    On CUDA, :meth:`compile` captures ``body()`` once into a
    ``torch.cuda.CUDAGraph`` and :meth:`run` replays it once (one launch),
    then waits for it; the outputs are the tensors ``body`` returned at
    capture, which the replay fills.  Before the capture, on the capture's
    stream, ``warm()`` creates what a capture cannot (the cuBLAS and cuDNN
    handles and workspaces, the NCCL communicator: one collective), and
    every tensor in ``keep`` (the parameters, the model's state) is
    copied back afterwards into its own storage, so the warm-up trains
    nothing and the graph updates the same tensors.  ``optimizer`` is made
    capturable (:func:`_make_capturable`); a state it creates at its first
    step is created inside the graph, so the fit takes exactly its steps.
    A capture or a replay that fails raises: nothing falls back to the
    eager loop on the card.

    On the CPU (named by the caller) there is no graph: :meth:`compile`
    does nothing and :meth:`run` runs ``body()`` eagerly, step by step."""

    def __init__(self, body: Callable[[], Any], device: torch.device, *,
                 warm: Optional[Callable[[], None]] = None,
                 keep: Iterable[torch.Tensor] = (),
                 optimizer: Optional[Optimizer] = None):
        self.body = body
        self.device = torch.device(device)
        self.warm = warm
        self.keep = list(keep)
        self.optimizer = optimizer
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Any = None

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def compile(self) -> float:
        """Capture the fit (on CUDA); returns the seconds it took, warm-up
        and graph instantiation included (0 on the CPU)."""
        if not self.on_card:
            return 0.0
        t0 = time.perf_counter()
        if self.optimizer is not None:
            _make_capturable(self.optimizer)
        with torch.cuda.device(self.device):
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            saved = [t.detach().clone() for t in self.keep]
            with torch.cuda.stream(stream):
                if self.warm is not None:
                    self.warm()
                with torch.no_grad():
                    for t, s in zip(self.keep, saved):
                        t.copy_(s)
            torch.cuda.current_stream().wait_stream(stream)
            del saved
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                self.out = self.body()
            self.graph = graph
        return time.perf_counter() - t0

    def run(self) -> Any:
        """The fit: the graph's one replay, waited for (on CUDA), or
        ``body()`` (on the CPU).  Returns the fit's outputs."""
        if not self.on_card:
            self.out = self.body()
            return self.out
        if self.graph is None:
            raise RuntimeError("OneProgram.run before compile")
        with torch.cuda.device(self.device):
            self.graph.replay()
            torch.cuda.current_stream().synchronize()
        return self.out


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
    rows, so the average is the global batch's mean).  On CUDA the whole
    loop is one CUDA graph, captured once and replayed once
    (:class:`OneProgram`; the state's tensors and the parameters are kept
    through the warm-up); on the CPU it runs eagerly.  Returns ``(state,
    losses)``: the last state and the per-step (global) losses
    ``[steps]``, detached, on the batches' device."""
    def body():
        st = state
        losses = []
        for xb, yb in zip(xs, ys):
            optimizer.zero_grad()
            loss, st = loss_fn(xb, yb, st)
            loss.backward()
            losses.append(_mean_over_group(optimizer.params, loss))
            optimizer.step()
        return st, torch.stack(losses)

    def warm():
        optimizer.zero_grad()
        loss, _ = loss_fn(xs[0], ys[0], state)
        loss.backward()
        _mean_over_group(optimizer.params, loss)
        optimizer.zero_grad()

    prog = OneProgram(body, xs.device, warm=warm,
                      keep=list(optimizer.params) + _tensors(state),
                      optimizer=optimizer)
    prog.compile()
    return prog.run()


def train_scan(loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
               optimizer: Optimizer, xs: torch.Tensor,
               ys: torch.Tensor) -> torch.Tensor:
    """:func:`train_scan_stateful` without state.  Returns the per-step
    losses ``[steps]``."""
    return train_scan_stateful(lambda xb, yb, st: (loss_fn(xb, yb), st),
                               optimizer, None, xs, ys)[1]


class ScanFit(NamedTuple):
    """What :func:`train_scan_dist` returns: the reference's ``(last_loss[,
    metric])`` and the per-step losses, tensors on the device."""

    loss: torch.Tensor                 # the last step's global mean
    metric: Optional[torch.Tensor]     # sum(num) / sum(den), or None
    losses: torch.Tensor               # [steps], global means


def _as_f32(x, device: torch.device) -> torch.Tensor:
    """``x`` as an f32 tensor on ``device``; a number is filled there (a
    host copy would sync inside a capture)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def train_scan_dist(
        loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
        optimizer: Optimizer, steps: int,
        local_batches_fn: Callable[[int], Tuple[torch.Tensor, torch.Tensor]],
        eval_counts_fn: Optional[Callable[[int], Tuple[Any, Any]]] = None,
        aot_cache: Optional[str] = None,
        examples_per_step: int = 0) -> ScanFit:
    """Data-parallel training as ONE program with ONE collective a step —
    the port of the reference's ``train_scan_dist``, over the default
    process group, one rank a device (no group: one process, and no
    collective runs, as a psum over one member does).

    - ``local_batches_fn(rank) -> (xs, ys)`` builds this rank's columns of
      every global batch on the device, ``[steps_per_epoch, local_bs,
      ...]``; step ``t`` trains on batch ``t % steps_per_epoch``.
    - Every gradient and the loss ride ONE flat f32 ``all_reduce`` a step,
      divided by the world size (:func:`make_dist_step`).
    - ``eval_counts_fn(rank) -> (num, den)`` is this rank's share of a
      global ratio (correct and example counts); the pair rides one more
      ``all_reduce`` and the ratio is the returned metric.

    On CUDA the whole fit — the batches' generation, every step and the
    eval — is one CUDA graph (:class:`OneProgram`).  The capture is the
    fit's compile: it runs inside the reporter's ``compiling()`` window
    and a ``workload/compile`` span (``what="fit"``, ``source="compiled"``)
    and is observed by ``compile_cache.observe_compile``.  A CUDA graph
    cannot be written to disk, so ``aot_cache`` is accepted and nothing is
    stored there: the ``trainer/fit`` span reads ``aot_cache="off"``.  On
    the CPU the same body runs eagerly, step by step, with no compile.

    The run itself mirrors the reference's: a ``phase="fit"`` beat with
    the compile source, a keepalive while the program runs, the
    ``trainer/fit`` span (``steps``, ``aot_cache``, ``process``),
    :func:`record_step_telemetry`, and a final beat at ``step=steps`` with
    the loss and the throughput."""
    import torch.distributed as dist

    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    del aot_cache  # a CUDA graph is not serialisable
    rank = dist.get_rank() if dist.is_initialized() else 0
    params = optimizer.params
    device = params[0].device
    step = make_dist_step(loss_fn, optimizer)

    def body():
        xs, ys = local_batches_fn(rank)
        losses = torch.stack([step(xs, ys, t) for t in range(steps)])
        metric = None
        if eval_counts_fn is not None:
            num, den = eval_counts_fn(rank)
            nd = _group_sum(torch.stack([_as_f32(num, device),
                                         _as_f32(den, device)]))
            metric = nd[0] / nd[1]
        return ScanFit(losses[-1], metric, losses)

    def warm():
        xs, ys = local_batches_fn(rank)
        optimizer.zero_grad()
        loss = loss_fn(xs[0], ys[0])
        loss.backward()
        _mean_over_group(params, loss)
        optimizer.zero_grad()

    prog = OneProgram(body, device, warm=warm, keep=params,
                      optimizer=optimizer)
    rep = reporter()
    source = ""
    if prog.on_card:
        from .compile_cache import observe_compile

        with rep.compiling(), span("workload/compile", what="fit") as sp:
            seconds = prog.compile()
            source = sp.args["source"] = "compiled"
            sp.args["seconds"] = round(seconds, 4)
        observe_compile(source, seconds)

    rep.beat(phase=PHASE_FIT, compile_source=source)
    rep.start_keepalive()
    try:
        with span("trainer/fit", steps=steps, aot_cache="off") as sp_fit:
            out = prog.run()
            sp_fit.args["process"] = process_index()
    finally:
        rep.stop_keepalive()
    dur = sp_fit.dur or 0.0
    record_step_telemetry(steps, dur, examples_per_step)
    rep.beat(step=steps, loss=float(out.loss), phase=PHASE_FIT,
             examples_per_sec=(steps * examples_per_step / dur
                               if dur > 0 and examples_per_step else None))
    return out


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
    steps).  The first step is the ``workload/first_step`` span and the
    rest the ``workload/fit`` span, each ending in the loss's host sync;
    their sum is the run's :func:`record_step_telemetry`.  Returns the
    per-step losses of the steps run, ``[steps - start_step]``."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    start_step = max(0, min(start_step, steps - 1))
    run_steps = steps - start_step
    rep = reporter()

    t0 = time.perf_counter()
    with span("workload/first_step", start_step=start_step) as sp_first:
        losses = [step(x_all, y_all, start_step)]
        first = float(losses[0])
        sp_first.args["process"] = process_index()
    first_s = time.perf_counter() - t0
    rep.beat(step=start_step + 1, loss=first, phase=PHASE_FIT,
             compile_source=compile_source,
             resumed_from_step=start_step if start_step else None,
             examples_per_sec=(examples_per_step / first_s
                               if first_s > 0 and examples_per_step
                               else None))
    next_beat = time.perf_counter() + BEAT_INTERVAL_S
    with span("workload/fit", steps=steps, start_step=start_step) as sp_fit:
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
    dur = sp_first.dur + sp_fit.dur
    record_step_telemetry(run_steps, dur, examples_per_step)
    rep.beat(step=steps, loss=final, phase=PHASE_FIT,
             examples_per_sec=(run_steps * examples_per_step / dur
                               if dur > 0 and examples_per_step else None))
    return out
