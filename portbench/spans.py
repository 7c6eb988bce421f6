"""Device time by the port's step spans: which part of the model launched
each kernel of the traced steps, and in which pass.

The port opens a ``torch.profiler`` range around each part of its training
step while a profiler records (``kubeflow_controller_tpu_torch/obs/
trace.py:step_span``: ``kctpu.attention``, ``kctpu.ffn``, ``kctpu.cast``,
...).  From the profiler's raw events (``kineto_results``, as ``trace.py``
reads them) each kernel inside the ``portbench.step`` ranges is put down to
one span and one pass, through the runtime call that launched it (the same
correlation id), its time and its thread:

- a ``kctpu.*`` span open on that thread then, opened inside a backward
  node (``autograd::engine::evaluate_function``) also open there: the
  innermost such span, pass ``remat`` (the layer re-run by remat);
- else, inside a backward node: pass ``backward``, owned by the innermost
  span that was open, on the forward's thread, when the forward op that
  made the node began (the node's ``sequence_nr`` and ``fwd_thread_id``);
- else the innermost span open: pass ``optimizer`` under
  ``kctpu.optimizer``, else ``forward``;
- else unattributed.

Each idle gap of the device of 3 us or more is labelled with the innermost
span open, on any thread, at its middle.  The GPU spans of user ranges are
never kernels, and copies and memsets count as busy but not as kernels.

    python3 -m portbench.spans --workload NAME --seed N

runs a cell's warm-up and traced steps as ``run.py --trace 1`` does (no
window, no reference) and prints one JSON line: the trace's readings,
:data:`METRICS` read from the spans, the split by pass, the elementwise
kernels' time by owning span and the labelled gaps.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import trace

PREFIX = "kctpu."
NODE = "autograd::engine::evaluate_function"
OPTIMIZER = "kctpu.optimizer"
PASSES = ("forward", "remat", "backward", "optimizer")
MIN_GAP_US = 3.0

# Each metric: the spans whose kernels it sums over every pass, or with
# None every span in the passes named.
METRICS: Dict[str, Tuple[Optional[Tuple[str, ...]], Tuple[str, ...]]] = {
    "attention_ms": (("kctpu.attention",), PASSES),
    "ffn_ms": (("kctpu.ffn", "kctpu.moe.experts"), PASSES),
    "moe_route_ms": (("kctpu.moe.route", "kctpu.moe.dispatch",
                      "kctpu.moe.combine"), PASSES),
    "norm_rope_ms": (("kctpu.norm", "kctpu.rope"), PASSES),
    "cast_ms": (("kctpu.cast",), PASSES),
    "loss_ms": (("kctpu.loss",), PASSES),
    "clip_ms": (("kctpu.clip",), PASSES),
    "remat_ms": (None, ("remat",)),
}
# The rest of the step, so that the parts add up to its kernel time:
# AdamW (the optimizer's own kernels) and everything the spans above do
# not name (the projections and residual adds of ``kctpu.layer``, the
# embedding, the head).
ADAMW = (OPTIMIZER,)


@dataclass
class Range:
    """A host event: an operator or a range, on a profiler thread."""
    name: str
    start: float      # us
    end: float
    thread: int
    seq: int = -1     # the autograd sequence number, -1 for none
    fwd_thread: int = 0


@dataclass
class Kernel:
    name: str
    start: float      # us, the device's time in the trace's clock
    end: float
    launch: float     # us, the launching call's time on the host
    thread: int       # the launching call's thread


@dataclass
class SpanTimes:
    """The traced steps' kernel time by (span, pass, kernel group)."""
    steps: int
    kernel_us: float
    us: Dict[Tuple[str, str, str], float]
    unattributed_us: float
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def ms(self, spans: Optional[Iterable[str]],
           passes: Sequence[str] = PASSES) -> Optional[float]:
        """Device ms a step of the kernels that ``spans`` (every span with
        None) own in ``passes``; None where they launched nothing."""
        want = None if spans is None else set(spans)
        us = sum(v for (s, p, _), v in self.us.items()
                 if p in passes and (want is None or s in want))
        return us / 1e3 / self.steps if us else None

    def metric(self, name: str) -> Optional[float]:
        return self.ms(*METRICS[name])

    @property
    def coverage(self) -> float:
        """The share of the kernel time that a span owns."""
        return 1.0 - self.unattributed_us / self.kernel_us

    def pass_ms(self) -> Dict[str, float]:
        return {p: self.ms(None, (p,)) or 0.0 for p in PASSES}

    def by_span_pass(self) -> Dict[str, Dict[str, float]]:
        """Device ms a step by owning span, then by pass."""
        out: Dict[str, Dict[str, float]] = defaultdict(dict)
        for s in self.by_span():
            for p in PASSES:
                ms = self.ms((s,), (p,))
                if ms:
                    out[s][p] = ms
        return dict(out)

    def by_span(self, group: Optional[str] = None,
                passes: Sequence[str] = PASSES) -> Dict[str, float]:
        """Device ms a step by owning span, largest first, of the kernels
        of ``group`` (``trace.GROUPS``; every one with None)."""
        out: Dict[str, float] = defaultdict(float)
        for (s, p, g), v in self.us.items():
            if p in passes and group in (None, g):
                out[s] += v / 1e3 / self.steps
        return dict(sorted(out.items(), key=lambda x: -x[1]))

    def parts(self) -> Dict[str, float]:
        """The step's kernel ms a step in parts that add up to it: the
        metrics but ``remat_ms``, AdamW, the rest of the spans and the
        unattributed."""
        named = {s for name, (spans, _) in METRICS.items() if spans
                 for s in spans} | set(ADAMW)
        out = {name: self.metric(name) or 0.0
               for name, (spans, _) in METRICS.items() if spans}
        out["adamw_ms"] = self.ms(ADAMW) or 0.0
        out["rest_ms"] = sum(v for s, v in self.by_span().items()
                             if s not in named)
        out["unattributed_ms"] = self.unattributed_us / 1e3 / self.steps
        return out


def _innermost(ranges: List[Range], times: Sequence[float]) -> List[int]:
    """For each time, the index in ``ranges`` (nested ranges of one
    thread) of the innermost one open then, or -1."""
    order = sorted(range(len(ranges)),
                   key=lambda i: (ranges[i].start, -ranges[i].end))
    out = [-1] * len(times)
    stack: List[int] = []
    k = 0
    for j in sorted(range(len(times)), key=lambda j: times[j]):
        t = times[j]
        while k < len(order) and ranges[order[k]].start <= t:
            i = order[k]
            while stack and ranges[stack[-1]].end <= ranges[i].start:
                stack.pop()
            stack.append(i)
            k += 1
        while stack and ranges[stack[-1]].end <= t:
            stack.pop()
        out[j] = stack[-1] if stack else -1
    return out


class _Threads:
    """Ranges of one kind by thread, asked which is innermost at times."""

    def __init__(self, ranges: Iterable[Range]):
        self.by: Dict[int, List[Range]] = defaultdict(list)
        for r in ranges:
            self.by[r.thread].append(r)

    def at(self, queries: List[Tuple[int, float]]) -> List[Optional[Range]]:
        """The innermost range open at each (thread, time)."""
        out: List[Optional[Range]] = [None] * len(queries)
        per: Dict[int, List[int]] = defaultdict(list)
        for j, (th, _) in enumerate(queries):
            per[th].append(j)
        for th, js in per.items():
            ranges = self.by.get(th, [])
            found = _innermost(ranges, [queries[j][1] for j in js])
            for j, i in zip(js, found):
                out[j] = ranges[i] if i >= 0 else None
        return out


def _forward_starts(host: List[Range], nodes: _Threads
                    ) -> Dict[Tuple[int, int], float]:
    """(thread, sequence number) -> the start of the forward op that made
    the backward node of that number: the latest op of the number outside
    any backward node (an op takes the number the next node will get, and
    the number moves on when a node is made)."""
    wanted = {(n.fwd_thread, n.seq) for rs in nodes.by.values() for n in rs
              if n.seq >= 0}
    cands = [r for r in host if r.seq >= 0 and (r.thread, r.seq) in wanted
             and not r.name.startswith(NODE)]
    inside = nodes.at([(r.thread, r.start) for r in cands])
    out: Dict[Tuple[int, int], float] = {}
    for r, node in zip(cands, inside):
        key = (r.thread, r.seq)
        if node is None and r.start > out.get(key, -1.0):
            out[key] = r.start
    return out


def attribute(kernels: List[Kernel], host: List[Range], steps: int,
              busy: Optional[List[trace.Op]] = None, top: int = 10
              ) -> Optional[SpanTimes]:
    """:class:`SpanTimes` of the kernels inside the ``portbench.step``
    ranges of ``host``, the idle gaps found between the ``busy`` device
    ops (kernels, copies and memsets; the kernels when None); None
    without a step range or a kernel."""
    step_ranges = [r for r in host if r.name == trace.STEP_RANGE]
    if not step_ranges or not kernels:
        return None
    lo = min(r.start for r in step_ranges)
    hi = max(r.end for r in step_ranges)
    inside = [k for k in kernels if k.end > lo and k.start < hi]
    if not inside:
        return None
    spans = _Threads(r for r in host if r.name.startswith(PREFIX))
    nodes = _Threads(r for r in host if r.name.startswith(NODE))
    opt = _Threads(r for r in host if r.name == OPTIMIZER)
    queries = [(k.thread, k.launch) for k in inside]
    span_at, node_at, opt_at = (spans.at(queries), nodes.at(queries),
                                opt.at(queries))
    fwd = _forward_starts(host, nodes)
    # The backward kernels' owners: the span open at their forward op.
    links = {(n.fwd_thread, fwd[(n.fwd_thread, n.seq)])
             for n in node_at if n is not None
             and (n.fwd_thread, n.seq) in fwd}
    links = list(links)
    owner_at = dict(zip(links, spans.at(links)))
    us: Dict[Tuple[str, str, str], float] = defaultdict(float)
    unattributed = 0.0
    for k, s, n, o in zip(inside, span_at, node_at, opt_at):
        dur = k.end - k.start
        owner, pass_ = None, ""
        if n is not None and s is not None and s.start >= n.start:
            owner, pass_ = s, "remat"
        elif n is not None:
            t0 = fwd.get((n.fwd_thread, n.seq))
            owner = (None if t0 is None
                     else owner_at.get((n.fwd_thread, t0)))
            pass_ = "backward"
        elif s is not None:
            owner, pass_ = s, "optimizer" if o is not None else "forward"
        if owner is None:
            unattributed += dur
        else:
            us[(owner.name, pass_, trace.group_of(k.name))] += dur
    return SpanTimes(steps, sum(k.end - k.start for k in inside), dict(us),
                     unattributed,
                     _gaps(kernels if busy is None else busy, spans, lo, hi,
                           top))


def _gaps(busy: List, spans: _Threads, lo: float, hi: float, top: int
          ) -> List[Tuple[str, float]]:
    """Seconds of idle gaps of ``MIN_GAP_US`` and more, by the innermost
    span open at their middle on any thread, largest first."""
    covered = trace._union([trace.Op(o.name, o.start, o.end) for o in busy],
                           lo, hi)
    edges = [lo] + [x for span in covered for x in span] + [hi]
    holes = [(a, b) for a, b in zip(edges[::2], edges[1::2])
             if b - a >= MIN_GAP_US]
    mids = [(a + b) / 2 for a, b in holes]
    best: List[Optional[Range]] = [None] * len(holes)
    for th in spans.by:
        for j, r in enumerate(spans.at([(th, t) for t in mids])):
            if r is not None and (best[j] is None or r.start > best[j].start):
                best[j] = r
    out: Dict[str, float] = defaultdict(float)
    for (a, b), r in zip(holes, best):
        out[r.name if r is not None else "no span"] += (b - a) / 1e6
    return sorted(out.items(), key=lambda x: -x[1])[:top]


def _range(e) -> Range:
    return Range(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3,
                 e.start_thread_id(), e.sequence_nr(), e.fwd_thread_id())


def host_ranges(prof) -> List[Range]:
    """Every CPU-side event of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    return [_range(e) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU]


def from_profiler(prof, steps: int) -> Optional[SpanTimes]:
    """:func:`attribute` of a finished ``torch.profiler.profile`` of device
    ops: each kernel launched by the runtime call of its correlation id,
    on that call's thread."""
    from torch.autograd import DeviceType

    host, calls, device = [], {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            host.append(_range(e))
            if e.correlation_id() and e.name().startswith("cu"):
                calls[e.correlation_id()] = host[-1]
        elif not e.is_user_annotation():
            device.append((trace.Op(e.name(), e.start_ns() / 1e3,
                                    e.end_ns() / 1e3), e.correlation_id()))
    kernels = [Kernel(op.name, op.start, op.end, calls[c].start,
                      calls[c].thread)
               for op, c in device if trace.is_kernel(op.name) and c in calls]
    return attribute(kernels, host, steps, [op for op, _ in device])


def traced(prog, batches, first: int, steps: int, dev):
    """``steps`` steps under the profiler, as ``run.py``'s traced run
    takes them (which keeps its profile to itself): (``trace.Reduced``,
    :class:`SpanTimes`, non-finite losses)."""
    import math

    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    n, bad = batches.shape[0], 0
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)
    with profile(activities=acts) as prof:
        for k in range(first, first + steps):
            with record_function(trace.STEP_RANGE):
                bad += not math.isfinite(prog.step(batches[k % n],
                                                   spans=True))
    return trace.from_profiler(prof, steps), from_profiler(prof, steps), bad


def report(reduced, st: Optional[SpanTimes]) -> dict:
    """What a traced run's spans read, beside the trace's own readings."""
    r = reduced
    out = {"steps": r.steps, "launches_per_step": r.launches / r.steps,
           "busy_ms_per_step": r.busy_s * 1e3 / r.steps,
           "window_ms_per_step": r.window_s * 1e3 / r.steps,
           "idle_share": 100.0 * (1.0 - r.busy_s / r.window_s),
           "elementwise_ms": r.group_us["other"] / 1e3 / r.steps,
           "optimizer_ms": r.optimizer_us / 1e3 / r.steps}
    if st is None:
        return out
    out.update({
        "kernel_ms_per_step": st.kernel_us / 1e3 / st.steps,
        "coverage": st.coverage,
        "metrics": {m: st.metric(m) for m in METRICS},
        "parts": st.parts(),
        "passes_ms": st.pass_ms(),
        "elementwise_by_span": st.by_span(
            "other", ("forward", "remat", "backward")),
        "by_span": st.by_span_pass(),
        "gaps": st.gaps})
    return out


def main(argv=None) -> int:
    import os

    from . import run

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    cell = run.load_cell(args.workload)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(run.CACHE / sub)
    import torch

    if not torch.cuda.is_available():
        print("portbench.spans: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    mix = cell.mix
    prog, batches, _, _ = run.prepare(cell.conf, mix, args.seed, dev)
    first = mix["checked_steps"] + mix["warmup_steps"]
    for k in range(first):
        prog.step(batches[k % batches.shape[0]])
    reduced, st, bad = traced(prog, batches, first, mix["trace_steps"], dev)
    if reduced is None:
        print("portbench.spans: the trace holds no device op",
              file=sys.stderr)
        return 4
    out = {"workload": args.workload, "seed": args.seed,
           "card": run._card(dev), "failed": bad, **report(reduced, st)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
