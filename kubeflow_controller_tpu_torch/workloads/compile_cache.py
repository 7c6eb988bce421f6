"""The port's compile bookkeeping — the part of
``kubeflow_controller_tpu/workloads/compile_cache.py`` that it needs.

The reference compiles its step program ahead of time (``aot_compile``)
and tells the controller whether that compile was paid (``"compiled"``)
or came from its cache (``"cache-hit"``).  The port compiles twice over:
the ``nvcc`` build of ``csrc/`` (``ops/_build.py``), whose content-keyed
library in ``build/`` is its cache, and on the card the capture of a
one-program fit's CUDA graph (``trainer.train_scan_dist``), always
``"compiled"``: a CUDA graph cannot be written to disk.  The workloads that launch the kernels (``llama_pretrain``,
``serve``) run that build up front through :func:`build_kernels`, which
emits the reference's ``workload/compile`` trace span and compile metrics
(:func:`observe_compile`) around it.

Not ported: the XLA persistent cache and the serialized-executable layer,
which have no meaning for a library built by ``nvcc`` or for a CUDA
graph.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..obs.metrics import REGISTRY
from ..obs.trace import span
from ..ops import _build
from .progress import ProgressReporter, reporter


def _metrics():
    hist = REGISTRY.histogram(
        "kctpu_compile_seconds",
        "Wall time to produce a runnable executable, by source "
        "(compiled = trace+lower+XLA; cache-hit = deserialized)",
        ("source",))
    hits = REGISTRY.counter(
        "kctpu_compile_cache_hits_total",
        "Serialized-executable cache hits (compile pipeline skipped)")
    misses = REGISTRY.counter(
        "kctpu_compile_cache_misses_total",
        "Serialized-executable cache misses (full compile paid)")
    return hist, hits, misses


def observe_compile(source: str, seconds: float) -> None:
    """Record one executable acquisition on the metrics registry (the
    reference's names, types and help texts)."""
    hist, hits, misses = _metrics()
    hist.labels(source).observe(seconds)
    (hits if source == "cache-hit" else misses).inc()


def build_kernels(device: torch.device,
                  rep: Optional[ProgressReporter] = None) -> str:
    """On CUDA, build (or load) the kernel library inside
    ``rep.compiling()`` (``phase="compile"``, kept fresh while ``nvcc``
    runs) and a ``workload/compile`` span (``what="kernels"``, its
    ``source`` and ``seconds``), observe it with :func:`observe_compile`
    and return its compile source, ``"compiled"`` or ``"cache-hit"``.
    The window leaves ``phase="compile"`` behind: the caller's next beat
    names its own phase and carries this source.  Elsewhere the kernels'
    plain versions run, so nothing is built, beaten, traced or counted and
    the source is ``""``.  ``rep`` defaults to the process's reporter; a
    failed build raises."""
    if device.type != "cuda":
        return ""
    rep = rep or reporter()
    t0 = time.perf_counter()
    with rep.compiling(), span("workload/compile", what="kernels") as sp:
        source = _build.library().compile_source
        seconds = time.perf_counter() - t0
        sp.args["source"] = source
        sp.args["seconds"] = round(seconds, 4)
    observe_compile(source, seconds)
    return source
