"""The port's compile bookkeeping — the part of
``kubeflow_controller_tpu/workloads/compile_cache.py`` that it needs.

The reference compiles its step program ahead of time (``aot_compile``)
and tells the controller whether that compile was paid (``"compiled"``)
or came from its cache (``"cache-hit"``).  Eager PyTorch compiles no step
program; the port's one compile is the ``nvcc`` build of ``csrc/``
(``ops/_build.py``), whose content-keyed library in ``build/`` is its
cache.  The workloads that launch the kernels (``llama_pretrain``,
``serve``) run that build up front through :func:`build_kernels`.

Not ported: the XLA persistent cache, the serialized-executable layer and
the compile metrics (``kctpu_compile_cache_*_total``, ROADMAP.md M7).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import _build
from .progress import ProgressReporter, reporter


def build_kernels(device: torch.device,
                  rep: Optional[ProgressReporter] = None) -> str:
    """On CUDA, build (or load) the kernel library inside
    ``rep.compiling()`` (``phase="compile"``, kept fresh while ``nvcc``
    runs) and return its compile source, ``"compiled"`` or
    ``"cache-hit"``.  The window leaves ``phase="compile"`` behind: the
    caller's next beat names its own phase and carries this source.
    Elsewhere the kernels' plain versions run, so nothing is built or
    beaten and the source is ``""``.  ``rep`` defaults to the process's
    reporter; a failed build raises."""
    if device.type != "cuda":
        return ""
    rep = rep or reporter()
    with rep.compiling():
        return _build.library().compile_source
