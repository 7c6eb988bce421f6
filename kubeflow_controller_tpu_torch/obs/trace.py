"""Causal span tracer with Chrome ``trace_event`` export — the port's copy
of the part of ``kubeflow_controller_tpu/obs/trace.py`` that workload
processes use, with the reference's env names, id scheme and event
format, so the unchanged controller merges a torch job's dumps into its
own timeline (``merge_trace_dir`` there).

Every span carries ``trace_id`` / ``span_id`` / ``parent_id``; parenting
is id-based (a thread-local stack of live spans).  A :class:`TraceContext`
crosses process boundaries as one string (``trace:span:flags``): the
planner injects it into every replica as ``$KCTPU_TRACE_CONTEXT``, and a
span recorded with no enclosing local span parents to it, so the
workload's spans join the job's causal tree.  The trace id of a job is
derived from its uid (:meth:`TraceContext.for_job`), as the reference
derives it.

Sampling is head-based per trace id (``$KCTPU_TRACE_SAMPLE``, default
1.0): a pure function of the id, so every process keeps or drops the same
traces.

A rank that its pod's launcher started stamps its global rank
(``$KCTPU_RANK``) on every span as ``rank``, and dumps its own file.

A workload dumps its spans to ``$KCTPU_TRACE_DIR/trace-<pid>-<nonce>.json``
with :func:`dump_to_env_dir` at the end of its ``main`` (a process that
leaves through ``os._exit`` skips ``atexit``), and at exit otherwise.  The
merge, the causal-tree walk and the timeline render are the controller's
and are not copied.
"""

from __future__ import annotations

import atexit
import hashlib
import json
import os
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

TRACE_DIR_ENV = "KCTPU_TRACE_DIR"
#: Cross-process causal context (``TraceContext.encode()`` string),
#: stamped on pods by the planner and injected by the kubelet.
TRACE_CONTEXT_ENV = "KCTPU_TRACE_CONTEXT"
#: Head-based sampling rate in [0, 1]; default 1.0 (keep everything).
TRACE_SAMPLE_ENV = "KCTPU_TRACE_SAMPLE"
#: A rank's global rank, set by its pod's launcher
#: (``workloads/launch.py``); every span of such a rank carries it as
#: ``rank``.
RANK_ENV = "KCTPU_RANK"


def _hash16(text: str) -> str:
    return hashlib.sha1(text.encode()).hexdigest()[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def sample_rate(env: Optional[Dict[str, str]] = None) -> float:
    """The configured head-sampling rate, clamped to [0, 1]."""
    e = os.environ if env is None else env
    try:
        rate = float(e.get(TRACE_SAMPLE_ENV, "") or 1.0)
    except ValueError:
        return 1.0
    return min(1.0, max(0.0, rate))


def trace_sampled(trace_id: str, rate: Optional[float] = None) -> bool:
    """Deterministic head-based keep/drop for a trace id: a pure function
    of the id, so every process makes the same decision and a sampled
    trace is never partial."""
    if rate is None:
        rate = sample_rate()
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    try:
        bucket = int(trace_id[:8] or "0", 16) % 1000000
    except ValueError:
        bucket = 0
    return bucket < rate * 1000000


@dataclass(frozen=True)
class TraceContext:
    """Which trace, and which span new work should parent to.  Encodes as
    ``trace_id:span_id:flags``."""

    trace_id: str
    span_id: str = ""
    sampled: bool = True

    def encode(self) -> str:
        return f"{self.trace_id}:{self.span_id}:{'01' if self.sampled else '00'}"

    @staticmethod
    def decode(value: str) -> Optional["TraceContext"]:
        """Parse an encoded context (None on any damage: a torn value
        never fails the workload)."""
        if not value:
            return None
        parts = value.strip().split(":")
        if len(parts) < 2 or not parts[0]:
            return None
        sampled = parts[2] != "00" if len(parts) > 2 else True
        return TraceContext(trace_id=parts[0], span_id=parts[1],
                            sampled=sampled)

    @staticmethod
    def for_job(uid: str, rate: Optional[float] = None) -> "TraceContext":
        """The job's canonical context, derived from its uid: trace id,
        root span id and the head-sampling decision."""
        trace_id = _hash16(f"kctpu-trace:{uid}")
        return TraceContext(
            trace_id=trace_id,
            span_id=_hash16(f"kctpu-root:{uid}"),
            sampled=trace_sampled(trace_id, rate),
        )

    def child(self, span_id: str) -> "TraceContext":
        """The context a downstream hop should parent under."""
        return TraceContext(self.trace_id, span_id, self.sampled)


def context_from_env(env: Optional[Dict[str, str]] = None) -> Optional[TraceContext]:
    e = os.environ if env is None else env
    return TraceContext.decode(e.get(TRACE_CONTEXT_ENV, ""))


_PROCESS_CTX: Optional[TraceContext] = None
_PROCESS_CTX_LOADED = False
_PROCESS_CTX_LOCK = threading.Lock()


def process_context() -> Optional[TraceContext]:
    """The context this whole process runs under
    (``$KCTPU_TRACE_CONTEXT``), parsed once."""
    global _PROCESS_CTX, _PROCESS_CTX_LOADED
    if not _PROCESS_CTX_LOADED:
        with _PROCESS_CTX_LOCK:
            if not _PROCESS_CTX_LOADED:
                _PROCESS_CTX = context_from_env()
                _PROCESS_CTX_LOADED = True
    return _PROCESS_CTX


def _rank_args(args: Dict[str, Any]) -> Dict[str, Any]:
    """``args``, with this process's global rank first when its pod's
    launcher started it (``$KCTPU_RANK``)."""
    raw = os.environ.get(RANK_ENV, "")
    return {"rank": int(raw), **args} if raw.isdigit() else args


@dataclass
class Span:
    """One completed (or in-flight, inside ``with``) span."""

    name: str
    ts: float = 0.0            # wall-clock start, seconds since epoch
    dur: float = 0.0           # seconds (perf_counter delta)
    pid: int = 0
    tid: int = 0
    parent: str = ""           # enclosing span's NAME (display only)
    args: Dict[str, Any] = field(default_factory=dict)
    trace_id: str = ""         # causal identity ("" = context-less span)
    span_id: str = ""
    parent_id: str = ""        # causal parent (id-based, unambiguous)

    def to_event(self) -> Dict[str, Any]:
        """Chrome trace_event "complete" (ph=X) event, microseconds; the
        causal ids ride as ``args`` keys."""
        ev = {
            "name": self.name,
            "ph": "X",
            "ts": self.ts * 1e6,
            "dur": self.dur * 1e6,
            "pid": self.pid,
            "tid": self.tid,
            "cat": self.name.split("/", 1)[0],
        }
        args = dict(self.args)
        if self.parent:
            args["parent"] = self.parent
        if self.trace_id:
            args["trace_id"] = self.trace_id
        if self.span_id:
            args["span_id"] = self.span_id
        if self.parent_id:
            args["parent_id"] = self.parent_id
        if args:
            ev["args"] = args
        return ev


class Tracer:
    def __init__(self, capacity: int = 8192):
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=capacity)
        self._local = threading.local()

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    # -- causal context ------------------------------------------------------

    def current_context(self) -> Optional[TraceContext]:
        """The active context: a thread-local one (``with tracer.context``)
        wins over the process-level env context."""
        ctx = getattr(self._local, "ctx", None)
        return ctx if ctx is not None else process_context()

    @contextmanager
    def context(self, ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
        """Attach spans recorded in this block (this thread) to ``ctx``.
        ``None`` is a no-op passthrough."""
        prev = getattr(self._local, "ctx", None)
        self._local.ctx = ctx if ctx is not None else prev
        try:
            yield ctx
        finally:
            self._local.ctx = prev

    @contextmanager
    def span(self, name: str, **args) -> Iterator[Span]:
        """Record a span around the ``with`` body.  Yields the Span; its
        ``dur`` is final after the block exits, and attributes can be added
        to ``span.args`` inside the block."""
        stack = self._stack()
        ctx = self.current_context()
        sp = Span(name=name, ts=time.time(), pid=os.getpid(),
                  tid=threading.get_ident(),
                  parent=stack[-1].name if stack else "",
                  args=_rank_args(args), span_id=new_span_id())
        if ctx is not None:
            sp.trace_id = ctx.trace_id
            # Parent to the nearest enclosing span of the same trace, else
            # to the propagated remote span: the cross-process edge.
            for enclosing in reversed(stack):
                if enclosing.trace_id == ctx.trace_id:
                    sp.parent_id = enclosing.span_id
                    break
            else:
                sp.parent_id = ctx.span_id
        elif stack:
            sp.parent_id = stack[-1].span_id
            sp.trace_id = stack[-1].trace_id
        stack.append(sp)
        t0 = time.perf_counter()
        try:
            yield sp
        finally:
            sp.dur = time.perf_counter() - t0
            stack.pop()
            # Sampling drops only context spans; context-less spans always
            # record.
            if ctx is None or ctx.sampled:
                with self._lock:
                    self._spans.append(sp)

    def add_span(self, name: str, ts: float, dur: float, *,
                 ctx: Optional[TraceContext] = None, parent_id: str = "",
                 span_id: str = "", **args) -> Optional[Span]:
        """Record an already-timed span.  Returns None (recording nothing)
        for an unsampled context."""
        if ctx is not None and not ctx.sampled:
            return None
        sp = Span(name=name, ts=ts, dur=max(0.0, dur), pid=os.getpid(),
                  tid=threading.get_ident(), args=_rank_args(args),
                  span_id=span_id or new_span_id(), parent_id=parent_id)
        if ctx is not None:
            sp.trace_id = ctx.trace_id
            # Default the causal edge to the context's root, unless this
            # is the root span itself (no self-edge).
            if not parent_id and sp.span_id != ctx.span_id:
                sp.parent_id = ctx.span_id
        with self._lock:
            self._spans.append(sp)
        return sp

    # -- queries -------------------------------------------------------------

    def spans(self, prefix: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if prefix is not None:
            out = [s for s in out if s.name.startswith(prefix)]
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    # -- export --------------------------------------------------------------

    def chrome_trace(self) -> Dict[str, Any]:
        return {
            "traceEvents": [s.to_event() for s in self.spans()],
            "displayTimeUnit": "ms",
        }

    def dump(self, path: str) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(self.chrome_trace(), fh)
        os.replace(tmp, path)


#: Process-global default tracer.
TRACER = Tracer()


@contextmanager
def span(name: str, **args) -> Iterator[Span]:
    """``with trace.span("workload/fit", steps=n): ...`` on the global
    tracer."""
    with TRACER.span(name, **args) as sp:
        yield sp


@contextmanager
def context(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """``with trace.context(ctx): ...`` on the global tracer."""
    with TRACER.context(ctx) as c:
        yield c


def add_span(name: str, ts: float, dur: float, *,
             ctx: Optional[TraceContext] = None, parent_id: str = "",
             span_id: str = "", **args) -> Optional[Span]:
    return TRACER.add_span(name, ts, dur, ctx=ctx, parent_id=parent_id,
                           span_id=span_id, **args)


def current_context() -> Optional[TraceContext]:
    """The global tracer's active context (thread-local, falling back to
    the process context from ``$KCTPU_TRACE_CONTEXT``)."""
    return TRACER.current_context()


def dump_to_env_dir(tracer: Optional[Tracer] = None) -> Optional[str]:
    """Dump the tracer to ``$KCTPU_TRACE_DIR`` (a file of its own per
    call); None when the env var is unset or nothing was traced."""
    # `is None`, not `or`: an empty Tracer is falsy.
    t = TRACER if tracer is None else tracer
    d = os.environ.get(TRACE_DIR_ENV, "")
    if not d or len(t) == 0:
        return None
    try:
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"trace-{os.getpid()}-{uuid.uuid4().hex[:8]}.json")
        t.dump(path)
        return path
    except OSError:
        return None  # tracing never fails the workload


def _atexit_dump() -> None:  # pragma: no cover - runs in subprocesses
    try:
        dump_to_env_dir()
    except Exception:
        pass


atexit.register(_atexit_dump)
