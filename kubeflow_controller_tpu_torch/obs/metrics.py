"""Prometheus-style instruments and text exposition — the port's copy of
the part of ``kubeflow_controller_tpu/obs/metrics.py`` that workload
processes use: :class:`Counter`, :class:`Gauge`, :class:`Histogram`, the
process registry (:data:`REGISTRY`, get-or-create by name), the series
budget and :meth:`Registry.render`, the text exposition format (version
0.0.4) with the reference's escaping and number format, so a torch
workload's page reads as a JAX one's.

Not copied: scrape-time collectors, quantiles from buckets and the
exposition validator, which are the controller's.
"""

from __future__ import annotations

import math
import re
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Latency-shaped default buckets: 1 ms .. 60 s.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# Cardinality budget: the most labeled series one instrument may hold.  A
# new series past the budget is dropped (scrapes keep working) and counted
# in kctpu_metric_series_dropped_total{metric}; existing series keep
# updating.
DEFAULT_SERIES_BUDGET = 4096


def _series_dropped_counter() -> "Counter":
    """The overflow counter (one labeled series per instrument)."""
    return REGISTRY.counter(
        "kctpu_metric_series_dropped_total",
        "Label series dropped because an instrument hit its series budget "
        "(cardinality control at scale)", ("metric",))


def escape_label_value(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def escape_help(h: str) -> str:
    return str(h).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


@dataclass
class Sample:
    """One exposition line: ``name+suffix{labels} value``."""

    suffix: str
    labels: Dict[str, str]
    value: float


@dataclass
class Family:
    """One metric family: the unit of HELP/TYPE plus its samples."""

    name: str
    typ: str  # counter | gauge | histogram
    help: str
    samples: List[Sample] = field(default_factory=list)

    def render(self) -> str:
        out = [f"# HELP {self.name} {escape_help(self.help)}",
               f"# TYPE {self.name} {self.typ}"]
        for s in self.samples:
            label_str = ""
            if s.labels:
                inner = ",".join(
                    f'{k}="{escape_label_value(v)}"' for k, v in s.labels.items())
                label_str = "{" + inner + "}"
            out.append(f"{self.name}{s.suffix}{label_str} {_fmt(s.value)}")
        return "\n".join(out)


class _Instrument:
    typ = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 max_series: Optional[int] = None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._max_series = (DEFAULT_SERIES_BUDGET if max_series is None
                            else max_series)
        self._lock = threading.Lock()

    def _admit(self, table: Dict, key: Tuple[str, ...]) -> bool:
        """Series-budget check (caller holds ``self._lock``): an existing
        key always updates; a new key is admitted only under budget."""
        return key in table or len(table) < self._max_series

    def _note_drop(self) -> None:
        """Count one budget-dropped series (called with no lock held)."""
        if self.name == "kctpu_metric_series_dropped_total":
            return
        _series_dropped_counter().labels(self.name).inc()

    def _key(self, labelvalues: Sequence[str], kv: Dict[str, str]) -> Tuple[str, ...]:
        if kv:
            if labelvalues:
                raise ValueError("pass label values positionally or by name, not both")
            if set(kv) != set(self.labelnames):
                raise ValueError(
                    f"{self.name}: labels {sorted(kv)} != declared {list(self.labelnames)}")
            labelvalues = [kv[ln] for ln in self.labelnames]
        if len(labelvalues) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: got {len(labelvalues)} label values for "
                f"{len(self.labelnames)} labels {list(self.labelnames)}")
        return tuple(str(v) for v in labelvalues)

    def _labels_dict(self, key: Tuple[str, ...]) -> Dict[str, str]:
        return dict(zip(self.labelnames, key))

    def collect(self) -> Family:  # pragma: no cover - overridden
        raise NotImplementedError


class _BoundCounter:
    def __init__(self, parent: "Counter", key: Tuple[str, ...]):
        self._parent = parent
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        self._parent._inc(self._key, amount)

    @property
    def value(self) -> float:
        with self._parent._lock:
            return self._parent._values.get(self._key, 0.0)


class Counter(_Instrument):
    """Monotonically increasing value; negative increments raise."""

    typ = "counter"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 max_series: Optional[int] = None):
        super().__init__(name, help, labelnames, max_series)
        self._values: Dict[Tuple[str, ...], float] = {}
        if not self.labelnames:
            self._values[()] = 0.0

    def labels(self, *labelvalues, **kv) -> _BoundCounter:
        return _BoundCounter(self, self._key(labelvalues, kv))

    def inc(self, amount: float = 1.0) -> None:
        self._inc(self._key((), {}), amount)

    def _inc(self, key: Tuple[str, ...], amount: float) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {amount})")
        with self._lock:
            if self._admit(self._values, key):
                self._values[key] = self._values.get(key, 0.0) + amount
                return
        self._note_drop()

    @property
    def value(self) -> float:
        with self._lock:
            return self._values.get((), 0.0)

    def collect(self) -> Family:
        with self._lock:
            items = sorted(self._values.items())
        return Family(self.name, self.typ, self.help, [
            Sample("", self._labels_dict(k), v) for k, v in items])


class _BoundGauge:
    def __init__(self, parent: "Gauge", key: Tuple[str, ...]):
        self._parent = parent
        self._key = key

    def set(self, v: float) -> None:
        self._parent._set(self._key, v)

    def inc(self, amount: float = 1.0) -> None:
        self._parent._add(self._key, amount)

    def dec(self, amount: float = 1.0) -> None:
        self._parent._add(self._key, -amount)

    @property
    def value(self) -> float:
        with self._parent._lock:
            return self._parent._values.get(self._key, 0.0)


class Gauge(_Instrument):
    """Settable value."""

    typ = "gauge"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 max_series: Optional[int] = None):
        super().__init__(name, help, labelnames, max_series)
        self._values: Dict[Tuple[str, ...], float] = {}
        if not self.labelnames:
            self._values[()] = 0.0

    def labels(self, *labelvalues, **kv) -> _BoundGauge:
        return _BoundGauge(self, self._key(labelvalues, kv))

    def set(self, v: float) -> None:
        self._set((), v)

    def inc(self, amount: float = 1.0) -> None:
        self._add((), amount)

    def dec(self, amount: float = 1.0) -> None:
        self._add((), -amount)

    def _set(self, key: Tuple[str, ...], v: float) -> None:
        with self._lock:
            if self._admit(self._values, key):
                self._values[key] = float(v)
                return
        self._note_drop()

    def _add(self, key: Tuple[str, ...], amount: float) -> None:
        with self._lock:
            if self._admit(self._values, key):
                self._values[key] = self._values.get(key, 0.0) + amount
                return
        self._note_drop()

    @property
    def value(self) -> float:
        return _BoundGauge(self, ()).value

    def collect(self) -> Family:
        with self._lock:
            items = sorted(self._values.items())
        return Family(self.name, self.typ, self.help, [
            Sample("", self._labels_dict(k), v) for k, v in items])


class _HistState:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bucket (non-cumulative) counts
        self.sum = 0.0
        self.count = 0


class _BoundHistogram:
    def __init__(self, parent: "Histogram", key: Tuple[str, ...]):
        self._parent = parent
        self._key = key

    def observe(self, v: float) -> None:
        self._parent._observe(self._key, v)

    @property
    def count(self) -> int:
        with self._parent._lock:
            st = self._parent._states.get(self._key)
            return st.count if st else 0

    @property
    def sum(self) -> float:
        with self._parent._lock:
            st = self._parent._states.get(self._key)
            return st.sum if st else 0.0


class Histogram(_Instrument):
    """Cumulative-bucket histogram (``le`` upper bounds, +Inf implicit)."""

    typ = "histogram"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 max_series: Optional[int] = None):
        super().__init__(name, help, labelnames, max_series)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError(f"{name}: need at least one bucket")
        if math.isinf(bs[-1]):
            bs = bs[:-1]  # +Inf is implicit
        self.buckets = tuple(bs)
        self._states: Dict[Tuple[str, ...], _HistState] = {}
        if not self.labelnames:
            self._states[()] = _HistState(len(self.buckets) + 1)

    def labels(self, *labelvalues, **kv) -> _BoundHistogram:
        return _BoundHistogram(self, self._key(labelvalues, kv))

    def observe(self, v: float) -> None:
        self._observe(self._key((), {}), v)

    def _observe(self, key: Tuple[str, ...], v: float) -> None:
        v = float(v)
        i = len(self.buckets)  # +Inf slot
        for j, b in enumerate(self.buckets):
            if v <= b:
                i = j
                break
        with self._lock:
            st = self._states.get(key)
            if st is None and self._admit(self._states, key):
                st = self._states[key] = _HistState(len(self.buckets) + 1)
            if st is not None:
                st.counts[i] += 1
                st.sum += v
                st.count += 1
                return
        self._note_drop()

    @property
    def count(self) -> int:
        return _BoundHistogram(self, ()).count

    @property
    def sum(self) -> float:
        return _BoundHistogram(self, ()).sum

    def collect(self) -> Family:
        with self._lock:
            snap = {k: (list(st.counts), st.sum, st.count)
                    for k, st in sorted(self._states.items())}
        samples = []
        for k, (counts, total, count) in snap.items():
            base = self._labels_dict(k)
            acc = 0
            for b, c in zip(self.buckets, counts):
                acc += c
                samples.append(Sample("_bucket", {**base, "le": _fmt(b)}, acc))
            samples.append(Sample("_bucket", {**base, "le": "+Inf"}, count))
            samples.append(Sample("_sum", base, total))
            samples.append(Sample("_count", base, count))
        return Family(self.name, self.typ, self.help, samples)


class Registry:
    """Named instruments, rendered as one page."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Instrument] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name} already registered as "
                        f"{type(existing).__name__}{existing.labelnames}")
                return existing
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str,
                labelnames: Sequence[str] = (),
                max_series: Optional[int] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames,
                                   max_series=max_series)

    def gauge(self, name: str, help: str,
              labelnames: Sequence[str] = (),
              max_series: Optional[int] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames,
                                   max_series=max_series)

    def histogram(self, name: str, help: str, labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  max_series: Optional[int] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets, max_series=max_series)

    def families(self) -> List[Family]:
        with self._lock:
            metrics = list(self._metrics.values())
        return sorted((m.collect() for m in metrics), key=lambda f: f.name)

    def render(self) -> str:
        return "\n".join(f.render() for f in self.families()) + "\n"


#: Process-global default registry.
REGISTRY = Registry()
