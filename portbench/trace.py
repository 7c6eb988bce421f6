"""From a ``torch.profiler`` trace of the traced steps to what the
per-layer readers read: device time by kernel group, the optimizer's
device time, kernel launches, the device's busy time and idle gaps.

The kernel groups follow ``chip_smoke.py``'s ``KERNEL_GROUPS``, copied
here so that the yardstick cannot move with the program: the three flash
kernels, the three grouped-matmul kernels, library GEMMs (cuBLAS,
CUTLASS, nvjet names), gather/scatter/index/sort kernels, and everything
else.  Kernels launched from inside the ``portbench.optimizer`` host range
(the clip and AdamW) are the optimizer's, whatever their names: the
profiler's correlation id ties each device operation to the runtime call
that launched it, and that call's time on the host lies inside the range.
The GPU spans of user annotations are never counted as device work.

The profiler's raw events are read (``kineto_results``), as its chrome
trace holds them; its ``events()`` list drops some device operations.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

GROUPS: Tuple[Tuple[str, str], ...] = (
    ("flash_fwd", r"\bflash_fwd_(wgmma_)?kernel"),
    ("flash_dq", r"\bflash_dq_(wgmma_)?kernel"),
    ("flash_dkv", r"\bflash_dkv_(wgmma_)?kernel"),
    ("tgmm", r"\btgmm_(wgmma_)?kernel"),
    ("gmm_swiglu", r"\bgmm_swapab_kernel<\d+, true|\bgmm_swiglu_wgmma_kernel"),
    ("gmm", r"\bgmm_(wgmma_|swapab_)?kernel"),
    ("gemm", r"gemm|cutlass|xmma|nvjet|cublas|sm90_"),
    ("index", r"index|gather|scatter|[Ss]ort|scan|searchsorted"),
    ("other", r""),
)
_COMPILED = [(g, re.compile(p)) for g, p in GROUPS]
OPTIMIZER_RANGE = "portbench.optimizer"
STEP_RANGE = "portbench.step"
LABELLED_GAPS = 200     # the longest idle gaps, each named by the host


def group_of(name: str) -> str:
    return next(g for g, rx in _COMPILED if rx.search(name))


def is_kernel(name: str) -> bool:
    """A launched kernel, not a copy or a memset."""
    return not name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


@dataclass
class Op:
    name: str
    start: float      # us, the trace's clock
    end: float
    launch: float = float("nan")   # a device op's launch on the host, us


@dataclass
class Reduced:
    """One traced window, reduced."""
    steps: int
    window_s: float
    busy_s: float
    launches: int
    group_us: Dict[str, float]
    optimizer_us: float
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def _union(ops: List[Op], lo: float, hi: float) -> List[Tuple[float, float]]:
    spans: List[Tuple[float, float]] = []
    for op in sorted(ops, key=lambda o: o.start):
        a, b = max(op.start, lo), min(op.end, hi)
        if a >= b:
            continue
        if spans and a <= spans[-1][1]:
            spans[-1] = (spans[-1][0], max(spans[-1][1], b))
        else:
            spans.append((a, b))
    return spans


class _Host:
    """The host's operators and ranges, for asking what was open at a
    time."""

    def __init__(self, host: List[Op]):
        self.ops = host
        self.start = np.array([o.start for o in host], dtype=np.float64)
        self.end = np.array([o.end for o in host], dtype=np.float64)

    def label(self, t: float) -> str:
        """The benchmark's range open at ``t`` and the innermost operator
        open then (a runtime call such as a launch or a sync left out)."""
        open_ = [self.ops[i] for i in np.flatnonzero(
            (self.start <= t) & (self.end > t))]
        ranges = [o for o in open_ if o.name.startswith("portbench.")
                  and o.name != STEP_RANGE]
        inner = [o for o in open_ if not o.name.startswith(("portbench.",
                                                            "cuda", "cu"))]
        parts = [max(ranges, key=lambda o: o.start).name if ranges
                 else "between steps"]
        if inner:
            parts.append(max(inner, key=lambda o: o.start).name)
        return "/".join(parts)


def reduce(device: List[Op], host: List[Op], steps: int, top: int = 10
           ) -> Optional[Reduced]:
    """``device``: kernels, copies and memsets, each with its launch time;
    ``host``: CPU operators and ranges (the step ranges and the optimizer's
    among them).  None when the trace holds no step range or no device
    op."""
    step_ranges = [o for o in host if o.name == STEP_RANGE]
    if not step_ranges or not device:
        return None
    lo = min(o.start for o in step_ranges)
    hi = max(o.end for o in step_ranges)
    inside = [o for o in device if o.end > lo and o.start < hi]
    busy = _union(inside, lo, hi)
    opt = [o for o in host if o.name == OPTIMIZER_RANGE]
    group_us: Dict[str, float] = {g: 0.0 for g, _ in GROUPS}
    by_name: Dict[str, float] = {}
    opt_us = 0.0
    for op in inside:
        if is_kernel(op.name):
            dur = op.end - op.start
            by_name[op.name] = by_name.get(op.name, 0.0) + dur
            if any(r.start <= op.launch < r.end for r in opt):
                opt_us += dur
            else:
                group_us[group_of(op.name)] += dur
    edges = [lo] + [x for span in busy for x in span] + [hi]
    holes = sorted(((b - a, a) for a, b in zip(edges[::2], edges[1::2])
                    if b > a), reverse=True)
    where = _Host(host)
    gaps: Dict[str, float] = {}
    for i, (us, a) in enumerate(holes):
        label = (where.label(a + us / 2) if i < LABELLED_GAPS
                 else f"gaps under {holes[LABELLED_GAPS - 1][0]:.0f} us")
        gaps[label] = gaps.get(label, 0.0) + us / 1e6
    return Reduced(
        steps=steps, window_s=(hi - lo) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        launches=sum(1 for o in inside if is_kernel(o.name)),
        group_us=group_us, optimizer_us=opt_us,
        device_ops=sorted(((n[:120], us / 1e6) for n, us in by_name.items()),
                          key=lambda x: -x[1])[:top],
        idle_gaps=sorted(gaps.items(), key=lambda x: -x[1])[:top])


def from_profiler(prof, steps: int) -> Optional[Reduced]:
    """:func:`reduce` of a finished ``torch.profiler.profile``: device
    operations (not the GPU spans of user ranges), each with the host
    time of the runtime call of the same correlation id; every CPU-side
    event as host."""
    from torch.autograd import DeviceType

    device, host, launches = [], [], {}
    for e in prof.profiler.kineto_results.events():
        op = Op(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
        if e.device_type() == DeviceType.CPU:
            host.append(op)
            if e.correlation_id() and op.name.startswith("cu"):
                launches[e.correlation_id()] = op.start
        elif not e.is_user_annotation():
            device.append((op, e.correlation_id()))
    for op, corr in device:
        op.launch = launches.get(corr, float("nan"))
    return reduce([op for op, _ in device], host, steps)
