"""Workload-side heartbeat publisher — the port's copy of the part of
``kubeflow_controller_tpu/workloads/progress.py`` that the serve and
training entry points use.

Heartbeats ``{step, examplesPerSec, loss, phase, <serving gauges>}`` flow
over one of two transports, chosen from the environment the node agent
injects: REST (``KCTPU_PROGRESS_URL``: PUT to the pod's ``progress``
subresource) or a file drop (``KCTPU_PROGRESS_DIR``: one atomic JSON file
per pod).  Both are best-effort: a lost beat never fails the workload.
A pod whose launcher runs several ranks (``launch.py``) beats from local
rank 0 alone.

:meth:`ProgressReporter.compiling` covers the port's one compile, the
``nvcc`` build of the CUDA kernels (``compile_cache.build_kernels``): it
beats ``phase="compile"`` and keeps the beat fresh from a keepalive thread
while the build runs; the caller beats its next phase.  The first beat
that carries a step (``step >= 1``) closes the job's causal timeline with
a ``workload/first_step`` span under the current trace context
(``$KCTPU_TRACE_CONTEXT``), as the reference's does.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

from ..device import ENV_LOCAL_RANK
from ..obs import trace
from ..obs.phases import PHASE_COMPILE

ENV_POD_NAMESPACE = "KCTPU_POD_NAMESPACE"
ENV_POD_NAME = "KCTPU_POD_NAME"
ENV_PROGRESS_DIR = "KCTPU_PROGRESS_DIR"
ENV_PROGRESS_URL = "KCTPU_PROGRESS_URL"


def drop_filename(namespace: str, name: str) -> str:
    """The file-drop name for a pod (flat dir, '/' is not filename-safe)."""
    return f"{namespace}__{name}.json"


def camel(name: str) -> str:
    """snake_case -> camelCase (``ttft_ms`` -> ``ttftMs``)."""
    parts = name.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


@dataclass
class ProgressReporter:
    """Publishes heartbeats for ONE pod; fields merge across beats so a
    phase-only beat keeps the last reported step/rate/loss."""

    namespace: str = ""
    name: str = ""
    url: str = ""       # API server base URL (REST transport)
    drop_dir: str = ""  # file-drop directory (fallback transport)
    _last: Dict[str, object] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _keepalive: Optional[threading.Thread] = None
    _stop: Optional[threading.Event] = None

    @staticmethod
    def from_env(env: Optional[Dict[str, str]] = None) -> "ProgressReporter":
        """The pod's reporter; a disabled one in a rank of the pod's
        launcher other than local rank 0 (the controller reads one beat
        stream a pod, keyed by the pod's name)."""
        e = os.environ if env is None else env
        if e.get(ENV_LOCAL_RANK, "0") != "0":
            return ProgressReporter()
        return ProgressReporter(
            namespace=e.get(ENV_POD_NAMESPACE, "default") or "default",
            name=e.get(ENV_POD_NAME, ""),
            url=e.get(ENV_PROGRESS_URL, "").rstrip("/"),
            drop_dir=e.get(ENV_PROGRESS_DIR, ""),
        )

    @property
    def enabled(self) -> bool:
        return bool(self.name and (self.url or self.drop_dir))

    def beat(self, step: Optional[int] = None,
             examples_per_sec: Optional[float] = None,
             loss: Optional[float] = None,
             phase: Optional[str] = None,
             compile_source: Optional[str] = None,
             resumed_from_step: Optional[int] = None,
             serving: Optional[Dict] = None) -> None:
        """Publish one heartbeat; None fields carry the previous value.
        ``resumed_from_step`` (``resumedFromStep``) is the checkpoint step a
        restarted replica resumed from: sticky, like every field, so any
        later beat lets the recovery plane count the lost steps.
        ``serving`` carries the serving-plane gauges
        (``ServeStats.as_beat``), published under camelCase keys."""
        if not self.enabled:
            return
        first_step = False
        with self._lock:
            if step is not None:
                if int(step) >= 1 and self._last.get("step", 0) < 1:
                    first_step = True
                self._last["step"] = int(step)
            if examples_per_sec is not None:
                self._last["examplesPerSec"] = float(examples_per_sec)
            if loss is not None:
                self._last["loss"] = float(loss)
            if phase is not None:
                self._last["phase"] = phase
            if compile_source is not None:
                self._last["compileSource"] = compile_source
            if resumed_from_step is not None:
                self._last["resumedFromStep"] = int(resumed_from_step)
            for snake, value in (serving or {}).items():
                self._last[camel(snake)] = value
            body = dict(self._last)
        if first_step:
            # The terminal leg of the job's causal timeline: the first step
            # done in this workload process.
            ctx = trace.TRACER.current_context()
            if ctx is not None:
                trace.add_span("workload/first_step", time.time(), 0.0,
                               ctx=ctx, pod=self.name,
                               namespace=self.namespace,
                               step=int(body.get("step", 1)))
        self._publish(body)

    @contextmanager
    def compiling(self, interval_s: float = 2.0) -> Iterator[
            "ProgressReporter"]:
        """A (possibly long) compile: beats ``phase="compile"`` and keeps
        the beat fresh with a keepalive for the duration.  The controller's
        frozen-step deadline holds while a replica reports "compile"; the
        caller beats the next phase itself once the compile is done."""
        self.beat(phase=PHASE_COMPILE)
        nested = self._keepalive is not None
        if not nested:
            self.start_keepalive(interval_s)
        try:
            yield self
        finally:
            if not nested:
                self.stop_keepalive()

    def start_keepalive(self, interval_s: float = 2.0) -> None:
        """Re-publish the last beat every ``interval_s`` on a daemon
        thread."""
        if not self.enabled or self._keepalive is not None:
            return
        stop = self._stop = threading.Event()

        def loop():
            while not stop.wait(interval_s):
                with self._lock:
                    body = dict(self._last)
                self._publish(body)

        self._keepalive = threading.Thread(
            target=loop, name="progress-keepalive", daemon=True)
        self._keepalive.start()

    def stop_keepalive(self) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._keepalive is not None:
            self._keepalive.join(timeout=5.0)
        self._keepalive = None
        self._stop = None

    def _publish(self, body: Dict) -> None:
        try:
            if self.url:
                self._publish_rest(body)
            elif self.drop_dir:
                self._publish_drop(body)
        except Exception:  # noqa: BLE001 — beats never break the workload
            pass

    def _publish_rest(self, body: Dict) -> None:
        import urllib.request

        req = urllib.request.Request(
            f"{self.url}/api/v1/namespaces/{self.namespace}/pods/"
            f"{self.name}/progress",
            data=json.dumps(body).encode(), method="PUT",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=5.0):
            pass

    def _publish_drop(self, body: Dict) -> None:
        # Atomic tmp+rename so the ingesting kubelet never reads a torn
        # write; mtime is the liveness signal, so rewrite even when the
        # payload is unchanged.
        path = os.path.join(self.drop_dir,
                            drop_filename(self.namespace, self.name))
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(body, fh)
        os.replace(tmp, path)


_REPORTER: Optional[ProgressReporter] = None
_REPORTER_LOCK = threading.Lock()


def reporter() -> ProgressReporter:
    """The process-global reporter, built from the env once (a pod process
    reports for exactly one pod)."""
    global _REPORTER
    with _REPORTER_LOCK:
        if _REPORTER is None:
            _REPORTER = ProgressReporter.from_env()
        return _REPORTER
