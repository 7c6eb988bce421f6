"""Pipeline parallelism over the ``pp`` mesh axis — the port of
``kubeflow_controller_tpu/parallel/pipeline.py``: :func:`split_stages`,
:func:`gpipe` and the 1F1B schedule :func:`pipeline_1f1b`.

The layer stack is split into S contiguous stages.  The reference writes
the schedule as one SPMD program: a ``vmap`` over the stage axis computes
every stage's current microbatch, and two ``jnp.roll``s hand activations up
one stage and cotangents down one stage, which XLA lowers to collective
permutes over pp.  The port writes each stage's schedule once, as a
generator over the steps: at every step it yields a :class:`Handoff` (its
output for the stage above, its input cotangent for the stage below, and
which of the two it wants back) and is sent what its neighbours handed it.
Two transports drive the same per-stage code, as ``parallel/ring.py``'s do
for the ring:

- :class:`GroupPipe`: one stage a process, over the mesh's pp process
  group, each step's sends and receives in one ``batch_isend_irecv``; a
  DTensor activation (the stage's own sub-mesh: dp, fsdp, ep, sp, tp)
  travels as its local shard and is re-wrapped with the same placements,
  since the stage sub-meshes are congruent and rank (s, c) talks to (s ±
  1, c): under sp, each rank hands its T/sp shard to the rank of the
  same sp index on the next stage.  A stage step's own collectives (the
  ring's rotations, Ulysses' all-to-alls, on the stage's sp group) run
  between hand-offs, every rank of a stage in the same order.
- :class:`Lockstep`: S virtual stages in one process, stepped together;
  for one card, and for the tests, which hold it bit-identical to the
  process group.

Differences from the reference (ROADMAP.md §3): a bubble step (a stage
whose microbatch index is outside [0, M)) launches nothing and hands off
nothing, where the reference computes it on garbage and masks the result;
a stage's output is handed only to the stage above (no wrap-around).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from .ring import _drive


def split_stages(layers: Any, n_stages: int) -> list:
    """``layers`` (a sequence, a tensor stacked on dim 0, or a dict of
    those) -> ``n_stages`` contiguous stages of ``L // n_stages`` layers.
    A module keeps its own name, so a stage's layers keep their global
    index (``layers.4.wq`` is in stage 1 of 2 at 8 layers)."""
    if isinstance(layers, dict):
        per = {k: split_stages(v, n_stages) for k, v in layers.items()}
        return [{k: v[s] for k, v in per.items()} for s in range(n_stages)]
    n = len(layers)
    if n % n_stages:
        raise ValueError(f"{n} layers not divisible by {n_stages} stages")
    k = n // n_stages
    if isinstance(layers, torch.Tensor):
        return list(layers.unflatten(0, (n_stages, k)))
    return [list(layers[s * k:(s + 1) * k]) for s in range(n_stages)]


def stage_parameters(stage: Any) -> List[torch.Tensor]:
    """The tensors of ``stage`` that require a gradient, in order: a
    module's parameters, or the tensors of a list, tuple or dict."""
    if isinstance(stage, torch.nn.Module):
        found = list(stage.parameters())
    elif isinstance(stage, torch.Tensor):
        found = [stage]
    else:
        found = []
        values = stage.values() if isinstance(stage, dict) else stage
        for v in values:
            found += stage_parameters(v)
    out, seen = [], set()
    for p in found:
        if p.requires_grad and id(p) not in seen:
            seen.add(id(p))
            out.append(p)
    return out


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------

@dataclass
class Handoff:
    """What one stage hands off at the end of a step: ``up``, its output,
    for the stage above; ``down``, its input's cotangent, for the stage
    below; ``from_below``/``from_above``, a tensor shaped as the
    activation (or cotangent) it wants from the stage below (above) for
    its next step, or None."""

    up: Optional[torch.Tensor] = None
    down: Optional[torch.Tensor] = None
    from_below: Optional[torch.Tensor] = None
    from_above: Optional[torch.Tensor] = None


def _local(x: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def placed_as(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` with ``like``'s placements (a DTensor gradient can come back
    ``Partial`` or sharded otherwise); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor) and list(x.placements) != list(like.placements):
        return x.redistribute(like.device_mesh, like.placements)
    return x


def _wrap_like(local: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    if not isinstance(like, DTensor):
        return local
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


class Lockstep:
    """S virtual stages in one process: at every step stage s is handed
    what stage s - 1 yielded as ``up`` and stage s + 1 as ``down`` (the
    same objects)."""

    def __init__(self, n_stages: int):
        self.n = n_stages
        self.stages = tuple(range(n_stages))

    def run(self, schedules: List[Iterator]) -> list:
        n = len(schedules)
        pending: list = [None] * n
        results: list = [None] * n
        live = [True] * n

        def resume(s, value):
            try:
                pending[s] = schedules[s].send(value)
            except StopIteration as stop:
                results[s], live[s] = stop.value, False

        for s in range(n):
            resume(s, None)
        while any(live):
            if not all(live):
                raise RuntimeError("the virtual stages stepped out of line")
            got = []
            for s, h in enumerate(pending):
                below = pending[s - 1].up if s > 0 else None
                above = pending[s + 1].down if s + 1 < n else None
                if ((h.from_below is None) != (below is None)
                        or (h.from_above is None) != (above is None)):
                    raise RuntimeError(f"stage {s}'s hand-off does not "
                                       f"match its neighbours'")
                got.append((below, above))
            for s in range(n):
                resume(s, got[s])
        return results

    def total(self, values: List[torch.Tensor]) -> torch.Tensor:
        """The sum of the stages' ``values`` in stage order."""
        out = values[0]
        for v in values[1:]:
            out = out + v
        return out

    def broadcast(self, x, src: int):
        return x


class GroupPipe:
    """One stage a process over ``group`` (the mesh's pp group): this
    process runs stage ``idx`` of ``n``.  ``device`` holds the one-off
    all-reduce that forms the group's communicator before the first
    point-to-point batch, which not every stage joins."""

    def __init__(self, group, device):
        self.group = group
        self.n = dist.get_world_size(group)
        self.idx = dist.get_group_rank(group, dist.get_rank())
        self.stages = (self.idx,)
        self.device = torch.device(device)
        self._formed = False

    def _peer(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)

    def exchange(self, h: Handoff):
        if not self._formed:
            dist.all_reduce(torch.zeros(1, device=self.device),
                            group=self.group)
            self._formed = True
        s, ops, bufs = self.idx, [], []
        for x, to in ((h.up, s + 1), (h.down, s - 1)):
            if x is not None:
                ops.append(dist.P2POp(dist.isend, _local(x).contiguous(),
                                      self._peer(to), self.group))
        for like, frm in ((h.from_below, s - 1), (h.from_above, s + 1)):
            buf = None
            if like is not None:
                buf = torch.empty_like(_local(like),
                                       memory_format=torch.contiguous_format)
                ops.append(dist.P2POp(dist.irecv, buf, self._peer(frm),
                                      self.group))
            bufs.append(buf)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return tuple(None if buf is None else _wrap_like(buf, like)
                     for buf, like in zip(bufs, (h.from_below, h.from_above)))

    def run(self, schedules: List[Iterator]) -> list:
        (schedule,) = schedules
        return [_drive(schedule, self.exchange)]

    def total(self, values: List[torch.Tensor]) -> torch.Tensor:
        """The sum over every stage's value in stage order (gathered, so
        each process adds the same numbers in the same order as
        :class:`Lockstep` does)."""
        (v,) = values
        local = _local(v).detach()
        parts = [torch.empty_like(local) for _ in range(self.n)]
        dist.all_gather(parts, local.contiguous(), group=self.group)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def broadcast(self, x, src: int):
        """``x`` as stage ``src`` holds it (a tensor, a list of tensors or
        None on the other stages, shaped as ``x`` is on ``src``)."""
        if isinstance(x, (list, tuple)):
            return type(x)(self.broadcast(v, src) for v in x)
        local = _local(x).contiguous()
        dist.broadcast(local, self._peer(src), group=self.group)
        return _wrap_like(local, x)


# ---------------------------------------------------------------------------
# The stage calls
# ---------------------------------------------------------------------------

def _value(x: torch.Tensor) -> torch.Tensor:
    """A scalar's value as a plain f32 tensor (a replicated DTensor's
    local one), off the graph."""
    return _local(x).detach().float()


def _call(stage_fn, stage, x, stage_aux: bool):
    out = stage_fn(stage, x)
    return out if stage_aux else (out, None)


def _cot_like(g, v):
    """The cotangent ``g`` of an extra ``v`` (ones when None), a DTensor
    placed as ``v`` when ``v`` is one."""
    from torch.distributed.tensor import DTensor

    if g is None:
        return torch.ones_like(v)
    if isinstance(v, DTensor) and not isinstance(g, DTensor):
        return DTensor.from_local(g.to(v.dtype), v.device_mesh, v.placements,
                                  run_check=False)
    return g


def _vjp(stage_fn, stage, params, x, cots, stage_aux: bool, acc: list):
    """Re-run the stage on its saved input and pull ``cots`` (the output's
    cotangent, and the extras': a dict like them, or None for ones) back:
    each parameter's gradient is added to ``acc`` (in place of None the
    first time); returns the input's, placed as the input."""
    xg = x.detach().requires_grad_()
    with torch.enable_grad():
        y, aux = _call(stage_fn, stage, xg, stage_aux)
        outs, grads_out = [y], [placed_as(cots[0], y)]
        if aux is not None:
            leaves = aux if isinstance(aux, dict) else {"": aux}
            for k, v in leaves.items():
                if v.requires_grad:
                    outs.append(v)
                    grads_out.append(_cot_like(
                        cots[1][k] if isinstance(cots[1], dict) else None,
                        v))
        got = torch.autograd.grad(outs, [*params, xg], grads_out,
                                  allow_unused=True)
    for i, g in enumerate(got[:-1]):
        if g is not None:
            acc[i] = g if acc[i] is None else acc[i] + g
    gx = got[-1]
    return torch.zeros_like(x) if gx is None else placed_as(gx, x)


def _add_tree(acc, new):
    if new is None:
        return acc
    if isinstance(new, dict):
        new = {k: _value(v) for k, v in new.items()}
        return new if acc is None else {k: acc[k] + new[k] for k in acc}
    new = _value(new)
    return new if acc is None else acc + new


def _listed(microbatches):
    return (list(microbatches.unbind(0))
            if isinstance(microbatches, torch.Tensor) else list(microbatches))


def _restack(like, items):
    return torch.stack(items) if isinstance(like, torch.Tensor) else items


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------

def _gpipe_forward(s: int, S: int, M: int, stage_fn, stage, feed: list,
                   stage_aux: bool):
    """Stage s of the forward: microbatch t - s at step t."""
    saved, outs, aux, act = {}, [None] * M, None, None
    like = feed[0]
    for t in range(M + S - 1):
        m, y = t - s, None
        if 0 <= m < M:
            x = feed[m] if s == 0 else act
            saved[m] = x
            y, extra = _call(stage_fn, stage, x, stage_aux)
            aux = _add_tree(aux, extra)
            if s == S - 1:
                outs[m], y = y, None
        want = like if s > 0 and 0 <= t + 1 - s < M else None
        act, _ = yield Handoff(up=y, from_below=want)
    return saved, outs, aux


def _gpipe_backward(s: int, S: int, M: int, stage_fn, stage, params,
                    saved: dict, g_out: list, g_aux, stage_aux: bool):
    """Stage s of the backward, the forward's mirror: microbatch t - (S -
    1 - s) at step t, re-run from its saved input."""
    acc, gfeed, cot = [None] * len(params), [None] * M, None
    like = saved[0]
    for t in range(M + S - 1):
        m, gx = t - (S - 1 - s), None
        if 0 <= m < M:
            g = g_out[m] if s == S - 1 else cot
            gx = _vjp(stage_fn, stage, params, saved.pop(m), (g, g_aux),
                      stage_aux, acc)
            if s == 0:
                gfeed[m], gx = gx, None
        want = (like if s < S - 1 and 0 <= t + 1 - (S - 1 - s) < M
                else None)
        _, cot = yield Handoff(down=gx, from_above=want)
    return acc, gfeed


class _GPipe(torch.autograd.Function):
    """The schedule's custom backward: the forward keeps each stage's
    inputs; the backward runs the schedule in reverse, re-running each
    stage on its input, handing cotangents down, and broadcasts the input
    gradients from stage 0 (the last stage's outputs were broadcast in the
    forward), so that every stage's caller sees the whole pipeline."""

    @staticmethod
    def forward(ctx, run, *args):
        M = run["M"]
        feed = list(args[:M])
        transport, stages = run["transport"], run["stages"]
        S = transport.n
        res = transport.run([
            _gpipe_forward(s, S, M, run["stage_fn"], stages[i], feed,
                           run["stage_aux"])
            for i, s in enumerate(transport.stages)])
        last = S - 1
        outs = (res[-1][1] if last in transport.stages
                else [torch.empty_like(feed[0]) for _ in range(M)])
        outs = transport.broadcast(outs, last)
        aux = None
        if run["stage_aux"]:
            keys = run["aux_keys"] = sorted(res[0][2])
            aux = [transport.total([r[2][k] for r in res]) for k in keys]
        ctx.run, ctx.saved = run, [r[0] for r in res]
        return (*outs, *(aux or ()))

    @staticmethod
    def backward(ctx, *grads):
        run = ctx.run
        M, transport, stages = run["M"], run["transport"], run["stages"]
        S = transport.n
        g_out = list(grads[:M])
        g_aux = ({k: g for k, g in zip(run["aux_keys"], grads[M:])}
                 if run["stage_aux"] else None)
        res = transport.run([
            _gpipe_backward(s, S, M, run["stage_fn"], stages[i],
                            run["params"][i], ctx.saved[i], g_out, g_aux,
                            run["stage_aux"])
            for i, s in enumerate(transport.stages)])
        gfeed = (res[0][1] if 0 in transport.stages
                 else [torch.zeros_like(g) for g in g_out])
        gfeed = transport.broadcast(gfeed, 0)
        gparams = []
        for (acc, _), params in zip(res, run["params"]):
            gparams += [torch.zeros_like(p) if g is None else g
                        for g, p in zip(acc, params)]
        return (None, *gfeed, *gparams)


def gpipe(stage_fn: Callable, stages: Sequence, microbatches, transport, *,
          stage_aux: bool = False):
    """Run ``stage_fn(stage, x) -> y`` as a GPipe pipeline over
    ``transport`` (:class:`Lockstep` or :class:`GroupPipe`).

    ``stages``: the stages this process runs, in ``transport.stages``
    order (all S of them on a :class:`Lockstep`, one on a
    :class:`GroupPipe`); their parameters are :func:`stage_parameters`.
    ``microbatches``: [M, ...] (or a list of M tensors) fed to stage 0;
    another process may pass tensors shaped alike.  Returns the last
    stage's M outputs, stacked as the input came, on every stage's
    process.  With ``stage_aux`` the stage returns ``(y, aux)``, ``aux`` a
    dict of scalars, and the result is ``(outputs, sums)``, the sums over
    every stage and real microbatch.

    Differentiable: the backward (:class:`_GPipe`) re-runs each stage from
    its saved input, so the stage parameters' gradients, the inputs' and
    the sums' flow as ``torch.autograd`` would give them."""
    feed = _listed(microbatches)
    params = [stage_parameters(st) for st in stages]
    run = {"M": len(feed), "transport": transport, "stages": list(stages),
           "stage_fn": stage_fn, "stage_aux": stage_aux, "params": params}
    out = _GPipe.apply(run, *feed, *[p for ps in params for p in ps])
    out = out if isinstance(out, tuple) else (out,)
    ys = _restack(microbatches, list(out[:len(feed)]))
    if stage_aux:
        return ys, dict(zip(run["aux_keys"], out[len(feed):]))
    return ys


# ---------------------------------------------------------------------------
# 1F1B
# ---------------------------------------------------------------------------

def _stage_1f1b(s: int, S: int, M: int, stage_fn, stage, params,
                feed: list, loss_step, stage_aux: bool):
    """Stage s of the 1F1B schedule (the reference's, step for step): at
    step t it forwards microbatch t - s and backwards t - (2S - 2 - s);
    only the inputs between the two are kept (at most 2(S - 1 - s) + 1).
    The last stage computes the loss and its seed in the step that
    forwards the microbatch, and backwards it in the same step."""
    like = feed[0]
    saved, acc = {}, [None] * len(params)
    loss = torch.zeros((), dtype=torch.float32, device=_local(like).device)
    gfeed, act, cot, seed = [None] * M, None, None, None
    for t in range(M + 2 * S - 2):
        m_f, y = t - s, None
        if 0 <= m_f < M:
            x = feed[m_f] if s == 0 else act
            saved[m_f] = x
            with torch.no_grad():
                y, pen = _call(stage_fn, stage, x, stage_aux)
            if pen is not None:
                loss = loss + _value(pen)
            if s == S - 1:
                l, seed = loss_step(y, m_f)
                loss, y = loss + l, None
        m_b, gx = t - (2 * S - 2 - s), None
        if 0 <= m_b < M:
            g = seed if s == S - 1 else cot
            gx = _vjp(stage_fn, stage, params, saved.pop(m_b), (g, None),
                      stage_aux, acc)
            if s == 0:
                gfeed[m_b], gx = gx, None
        want_below = like if s > 0 and 0 <= t + 1 - s < M else None
        want_above = (like if s < S - 1
                      and 0 <= t + 1 - (2 * S - 2 - s) < M else None)
        act, cot = yield Handoff(y, gx, want_below, want_above)
    return loss, acc, gfeed


def _accumulate(stage_fn, stage, params, feed, loss_params, loss_fn,
                loss_aux, stage_aux: bool):
    """The one-stage path: plain gradient accumulation, each microbatch's
    stage and loss differentiated together (the reference's S == 1
    branch)."""
    M = len(feed)
    acc, lacc, gfeed = [None] * len(params), [None] * len(loss_params), []
    loss = torch.zeros((), dtype=torch.float32,
                       device=_local(feed[0]).device)
    for m in range(M):
        xg = feed[m].detach().requires_grad_()
        with torch.enable_grad():
            y, pen = _call(stage_fn, stage, xg, stage_aux)
            total = loss_fn(loss_params, y, loss_aux[m])
            if pen is not None:
                total = total + pen
            got = torch.autograd.grad(total, [*params, *loss_params, xg],
                                      allow_unused=True)
        loss = loss + _value(total)
        for buf, gs in ((acc, got[:len(params)]),
                        (lacc, got[len(params):-1])):
            for i, g in enumerate(gs):
                if g is not None:
                    buf[i] = g if buf[i] is None else buf[i] + g
        gfeed.append(placed_as(got[-1], feed[m]))
    return loss, acc, lacc, gfeed


def pipeline_1f1b(stage_fn: Callable, stages: Sequence, microbatches,
                  loss_fn: Callable, loss_params: Sequence[torch.Tensor],
                  loss_aux, transport, *, stage_aux: bool = False):
    """The 1F1B schedule: one stage forward and one stage backward a step
    per stage, gradients accumulated over the microbatches.

    ``stage_fn(stage, x) -> y`` (``y`` shaped as ``x``; with ``stage_aux``
    ``(y, penalty)``, a scalar already in loss units whose gradient is
    seeded with 1); ``stages`` as :func:`gpipe` takes them; ``microbatches``
    [M, ...] (or M tensors) into stage 0; ``loss_fn(loss_params, y_m,
    loss_aux[m]) -> scalar`` on the last stage's output of microbatch m.

    The stage backward re-runs the stage forward from its saved input (the
    reference's ``bwd_one``: per-stage rematerialisation), so only stage
    inputs are kept, at most 2(S - 1 - s) + 1 on stage s, and each
    backward's graph is freed before the next step.  Gradients are added
    in microbatch order and scaled by 1/M.  One stage is plain gradient
    accumulation.

    Returns ``(loss, stage_grads, loss_grads, input_grads)``: the mean
    loss (penalties included) on every process; for each of this process's
    stages, its parameters' gradients (:func:`stage_parameters` order);
    the ``loss_params``' gradients where this process runs the last stage
    (else None); the M input gradients, stacked as the input came, where
    it runs stage 0 (else None)."""
    feed = _listed(microbatches)
    M, S = len(feed), transport.n
    params = [stage_parameters(st) for st in stages]
    loss_params = list(loss_params)
    scale = 1.0 / M

    def finish(acc, like):
        return [torch.zeros_like(p) if g is None else g * scale
                for g, p in zip(acc, like)]

    if S == 1:
        loss, acc, lacc, gfeed = _accumulate(
            stage_fn, stages[0], params[0], feed, loss_params, loss_fn,
            loss_aux, stage_aux)
        return (loss * scale, [finish(acc, params[0])],
                [(g.float() * scale).to(p.dtype) if g is not None else
                 torch.zeros_like(p) for g, p in zip(lacc, loss_params)],
                _restack(microbatches, [g * scale for g in gfeed]))

    lacc = [None] * len(loss_params)

    def loss_step(y, m):
        yg = y.detach().requires_grad_()
        with torch.enable_grad():
            value = loss_fn(loss_params, yg, loss_aux[m])
            got = torch.autograd.grad(value, [*loss_params, yg],
                                      allow_unused=True)
        for i, g in enumerate(got[:-1]):
            if g is not None:
                lacc[i] = g.float() if lacc[i] is None else lacc[i] + g.float()
        return _value(value), placed_as(got[-1], y)

    res = transport.run([
        _stage_1f1b(s, S, M, stage_fn, stages[i], params[i], feed,
                    loss_step, stage_aux)
        for i, s in enumerate(transport.stages)])
    loss = transport.total([r[0] for r in res]) * scale
    stage_grads = [finish(r[1], ps) for r, ps in zip(res, params)]
    loss_grads = None
    if S - 1 in transport.stages:
        loss_grads = [torch.zeros_like(p) if g is None
                      else (g * scale).to(p.dtype)
                      for g, p in zip(lacc, loss_params)]
    input_grads = None
    if 0 in transport.stages:
        input_grads = _restack(microbatches,
                               [g * scale for g in res[0][2]])
    return loss, stage_grads, loss_grads, input_grads
