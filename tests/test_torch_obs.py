"""Port parity: the workload traces and metrics (``kubeflow_controller_
tpu_torch/obs/trace.py`` and ``obs/metrics.py``, and the workloads' hooks)
against the JAX package's, which the controller reads.

- ``TraceContext`` encode/decode, ``for_job``, the sampling decision and
  ``Span.to_event`` give the reference's values, byte for byte.
- A port workload process (dist-mnist over 2 gloo ranks, its step loop
  and its default scan fit, and ``mnist_local``) under
  ``$KCTPU_TRACE_CONTEXT``/``$KCTPU_TRACE_DIR`` dumps spans that the JAX
  package's ``merge_trace_dir`` merges with the controller's root span
  into one connected tree (no orphans, one trace id), and the multiset of
  (span name, parent's name) equals that of the JAX workload's run under
  the same env, except ``workload/compile`` (the reference's XLA compile
  of the step; the port compiles only on the card, where the scan fit's
  CUDA graph capture is its compile).
- The port's serve replica (the ``ServeEngine`` behind its JSON-lines
  front end, a subprocess), routed to by the JAX package's gateway: every
  request is ``gw/route`` -> ``serve/request`` -> ``serve/queue_wait``,
  ``serve/prefill`` and ``serve/decode``, one connected tree.
- After a CPU fit (the dist-mnist step loop, one process) and a kernel
  build, the port's exposition holds the reference's ``# HELP`` and
  ``# TYPE`` lines for every ``kctpu_trainer_*`` and ``kctpu_compile_*``
  family, and passes the reference's ``validate_exposition``.
"""

import collections
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from kubeflow_controller_tpu.gateway import Gateway, GatewayConfig
from kubeflow_controller_tpu.gateway.gateway import tcp_replica
from kubeflow_controller_tpu.obs import metrics as jmetrics
from kubeflow_controller_tpu.obs import trace as jtrace
from kubeflow_controller_tpu.obs.metrics import validate_exposition
from kubeflow_controller_tpu.workloads.serve import Request
from kubeflow_controller_tpu_torch.obs import metrics as tmetrics
from kubeflow_controller_tpu_torch.obs import trace as ttrace
from kubeflow_controller_tpu_torch.workloads import (
    compile_cache,
    mnist_dist,
    trainer,
)

from _torch_ranks import free_port

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--steps", "5", "--train-size", "1024", "--eval-size", "256"]


# -- context and event format -------------------------------------------------

@pytest.mark.parametrize("uid", ["uid-1", "9f1c-job", ""])
@pytest.mark.parametrize("rate", [None, 0.0, 0.5, 1.0])
def test_trace_context_matches_the_reference(uid, rate):
    want = jtrace.TraceContext.for_job(uid, rate)
    got = ttrace.TraceContext.for_job(uid, rate)
    assert (got.trace_id, got.span_id, got.sampled) == (
        want.trace_id, want.span_id, want.sampled)
    assert got.encode() == want.encode()
    assert got.child("abc").encode() == want.child("abc").encode()
    for text in (want.encode(), "t:s", "t:s:00", "", ":s", "garbage"):
        a = jtrace.TraceContext.decode(text)
        b = ttrace.TraceContext.decode(text)
        assert (a is None) == (b is None), text
        if a is not None:
            assert (a.trace_id, a.span_id, a.sampled) == (
                b.trace_id, b.span_id, b.sampled)


def test_sample_rate_and_event_format_match_the_reference():
    for value in ("", "0.25", "7", "-1", "x"):
        env = {jtrace.TRACE_SAMPLE_ENV: value}
        assert ttrace.sample_rate(env) == jtrace.sample_rate(env)
    assert (ttrace.TRACE_DIR_ENV, ttrace.TRACE_CONTEXT_ENV,
            ttrace.TRACE_SAMPLE_ENV) == (jtrace.TRACE_DIR_ENV,
                                         jtrace.TRACE_CONTEXT_ENV,
                                         jtrace.TRACE_SAMPLE_ENV)
    fields = dict(name="workload/fit", ts=1700000000.123, dur=0.25, pid=7,
                  tid=9, parent="workload/init", args={"steps": 5},
                  trace_id="t", span_id="s", parent_id="p")
    assert (json.dumps(ttrace.Span(**fields).to_event())
            == json.dumps(jtrace.Span(**fields).to_event()))
    bare = dict(name="x", ts=1.0, dur=0.0, pid=1, tid=2)
    assert ttrace.Span(**bare).to_event() == jtrace.Span(**bare).to_event()


# -- a workload's dump in the controller's merge ------------------------------

def run_workload(module, n, trace_dir, ctx, *args):
    """``module`` on ``n`` processes (a gang when n > 1) under the job's
    trace context and a beat drop; every process must exit 0."""
    port = free_port()
    beats = trace_dir.parent / (trace_dir.name + "-beats")
    beats.mkdir(exist_ok=True)
    procs = []
    for rank in range(n):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("KCTPU_", "JAX_COORDINATOR",
                                    "JAX_NUM_PROC", "JAX_PROCESS",
                                    "MODEL_DIR"))}
        env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                   JAX_PLATFORMS="cpu", KCTPU_TRACE_CONTEXT=ctx.encode(),
                   KCTPU_TRACE_DIR=str(trace_dir),
                   KCTPU_POD_NAME=f"pod-{rank}",
                   KCTPU_PROGRESS_DIR=str(beats))
        if n > 1:
            env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *args], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]


def merged_pairs(trace_dir, ctx):
    """The dump merged by the controller's ``merge_trace_dir`` with the
    job's root span: its events, and the multiset of (name, parent's
    name)."""
    root = jtrace.Tracer()
    root.add_span("job/submit", time.time(), 0.01, ctx=ctx,
                  span_id=ctx.span_id)
    evs = jtrace.merge_trace_dir(str(trace_dir), tracer=root)["traceEvents"]
    names = {jtrace.event_ids(e)[1]: e["name"] for e in evs}
    pairs = collections.Counter(
        (e["name"], names.get(jtrace.event_ids(e)[2], ""))
        for e in evs if e["name"] != "job/submit")
    return evs, pairs


@pytest.mark.parametrize("workload,n,jax_args,port_args", [
    ("mnist_dist", 2, ["--platform", "cpu", "--step-loop"],
     ["--device", "cpu", "--step-loop"]),
    ("mnist_local", 1, ["--platform", "cpu"], ["--device", "cpu"]),
    ("mnist_dist", 2, ["--platform", "cpu"], ["--device", "cpu"]),
])
def test_workload_dump_joins_the_job_tree_as_the_reference(
        tmp_path, workload, n, jax_args, port_args):
    ctx = jtrace.TraceContext.for_job(f"uid-{workload}")
    runs = {}
    for pkg, args in (("kubeflow_controller_tpu", jax_args),
                      ("kubeflow_controller_tpu_torch", port_args)):
        trace_dir = tmp_path / pkg
        run_workload(f"{pkg}.workloads.{workload}", n, trace_dir, ctx,
                     *args, *SMALL)
        runs[pkg] = merged_pairs(trace_dir, ctx)
    evs, got = runs["kubeflow_controller_tpu_torch"]
    assert jtrace.orphan_events(evs) == []
    assert {jtrace.event_ids(e)[0] for e in evs} == {ctx.trace_id}
    assert len({e["pid"] for e in evs}) == n + 1
    _, want = runs["kubeflow_controller_tpu"]
    want = collections.Counter({k: v for k, v in want.items()
                                if k[0] != "workload/compile"})
    assert got == want
    assert sum(got.values()) >= (10 if n > 1 else 1)


# -- gw/route -> serve/request ------------------------------------------------

def test_gateway_route_parents_the_port_serve_request(tmp_path):
    ctx = jtrace.TraceContext(trace_id="t-front-door", span_id="root-span")
    env = {k: v for k, v in os.environ.items() if not k.startswith("KCTPU_")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               KCTPU_TRACE_CONTEXT=ctx.encode(),
               KCTPU_TRACE_DIR=str(tmp_path))
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_controller_tpu_torch.workloads.serve",
         "--synthetic", "--port", "0", "--slots", "2"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    gw = None
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on"), (line, proc.stderr.read())
        port = int(line.split()[2].split(":")[1])
        jtrace.TRACER.clear()
        with jtrace.TRACER.context(ctx):
            gw = Gateway(GatewayConfig())
        gw.register(tcp_replica("r0", "127.0.0.1", port,
                                gauges=lambda: {"slots_total": 2}))
        gw.start()
        reqs = [Request(id=f"q{i}", tokens=[1, 2, 3 + i], max_new_tokens=3)
                for i in range(4)]
        for r in reqs:
            gw.route(r)
        for r in reqs:
            assert r.done.wait(30), r.id
            assert not r.error and len(r.output) == 3, (r.id, r.error)
        deadline = time.monotonic() + 10
        while (len(jtrace.TRACER.spans(prefix="gw/route")) < len(reqs)
               and time.monotonic() < deadline):
            time.sleep(0.01)
    finally:
        if gw is not None:
            gw.stop()
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err[-3000:]
    evs = jtrace.merge_trace_dir(str(tmp_path), tracer=jtrace.TRACER)[
        "traceEvents"]
    jtrace.TRACER.clear()
    evs = [e for e in evs if jtrace.event_ids(e)[0] == ctx.trace_id]
    roots, children = jtrace.causal_tree(evs)
    routes = [e for e in roots if e["name"] == "gw/route"]
    assert len(routes) == len(reqs)
    assert all(jtrace.event_ids(e)[2] == ctx.span_id for e in routes)
    for route in routes:
        (req,) = children[jtrace.event_ids(route)[1]]
        assert req["name"] == "serve/request"
        assert req["pid"] == proc.pid != route["pid"]
        kids = children[jtrace.event_ids(req)[1]]
        assert [k["name"] for k in kids] == [
            "serve/queue_wait", "serve/prefill", "serve/decode"]
    assert len(evs) == 5 * len(reqs)


# -- the metrics page ---------------------------------------------------------

def families(text, prefixes):
    return sorted(ln for ln in text.splitlines()
                  if ln.startswith(("# HELP ", "# TYPE "))
                  and ln.split()[2].startswith(prefixes))


def test_metrics_exposition_matches_the_reference(monkeypatch, tmp_path):
    from kubeflow_controller_tpu.workloads import mnist_dist as jmnist_dist

    for k in list(os.environ):
        if k.startswith(("KCTPU_", "JAX_COORDINATOR", "JAX_NUM_PROC",
                         "JAX_PROCESS", "MODEL_DIR", "WORKLOAD_")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("KCTPU_COMPILE_CACHE", str(tmp_path / "xla"))
    # Both registries are process-global, and other tests register on
    # them (some with empty help): give each side one only this test
    # fills.  The reference's workloads look theirs up at call time; the
    # port's modules bound theirs at import.
    monkeypatch.setattr(jmetrics, "REGISTRY", jmetrics.Registry())
    port_registry = tmetrics.Registry()
    for module in (tmetrics, compile_cache, trainer):
        monkeypatch.setattr(module, "REGISTRY", port_registry)
    steps = port_registry.counter("kctpu_trainer_steps_total",
                                  "Training steps completed")
    before = steps.value
    res = mnist_dist.run_worker(mnist_dist.parse_args(
        ["--device", "cpu", *SMALL]))
    assert steps.value - before == 5 and res.processes == 1

    class Built:
        compile_source = "cache-hit"

    monkeypatch.setattr(compile_cache._build, "library", lambda: Built())
    with ttrace.TRACER.context(ttrace.TraceContext("t-build", "root")):
        assert compile_cache.build_kernels(torch.device("cuda")) == "cache-hit"
    (sp,) = [s for s in ttrace.TRACER.spans(prefix="workload/compile")
             if s.trace_id == "t-build"]
    assert sp.args["source"] == "cache-hit" and sp.parent_id == "root"

    assert jmnist_dist.main(["--platform", "cpu", "--step-loop",
                             "--aot-cache", str(tmp_path / "aot"),
                             *SMALL]) == 0
    prefixes = ("kctpu_trainer_", "kctpu_compile_")
    port_page = port_registry.render()
    want = families(jmetrics.REGISTRY.render(), prefixes)
    assert len(want) == 2 * 8
    assert families(port_page, prefixes) == want
    assert validate_exposition(port_page) == []
