"""Port parity: the port's serving replica (``ServeEngine`` over
``LlamaBackend(device="cpu")``) against the JAX package's, on the same
weights, the engine's own contracts on the synthetic backend, and the
reference's serving oracles (``tests/test_serving.py::TestPagedCache``)
against the port's own contiguous-cache ``generate``: the paged pool and
the engine are greedy-exact to it (dense tiny config, f32).

The model is the grouped-dispatch MoE config of ``test_torch_generate``
(the JAX side runs its grouped Pallas kernels under ``interpret=True``);
both engines get one numpy init of the JAX parameter pytree, the port's
through ``bridge.llama_from_jax``.  Greedy decoding: the tokens must be
identical, under continuous batching and with the prefix cache on.
"""

import json
import os
import random
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from _torch_ranks import free_port
from test_torch_generate import MOE, numpy_params

import kubeflow_controller_tpu.models.llama as jax_llama
from kubeflow_controller_tpu.workloads import serve as jax_serve
from kubeflow_controller_tpu_torch import bridge
from kubeflow_controller_tpu_torch.models.generate import (
    generate,
    init_paged_cache,
    paged_decode_step,
    paged_prefill,
)
from kubeflow_controller_tpu_torch.models.llama import LlamaConfig, llama_init
from kubeflow_controller_tpu_torch.workloads import progress
from kubeflow_controller_tpu_torch.workloads.serve import (
    REFUSED_DRAINING,
    REFUSED_OVERLOADED,
    SUBMIT_OK,
    LlamaBackend,
    Request,
    ServeConfig,
    ServeEngine,
    SyntheticBackend,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
ENGINE = dict(slots=4, page_size=8, max_len=64, prefill_buckets=(16, 32),
              stats_window_s=2.0)
NEW_TOKENS = 4

# Mixed prompt lengths.  "p0" fills two pages; "p1" shares p0's first page
# and diverges inside its second (copy-on-write); "p2" extends all of p0.
BASE = [11, 23, 5, 42, 77, 102, 9, 61, 88, 14, 3, 250]
PROMPTS = {
    "p0": BASE + [33, 71, 6, 120],
    "p1": BASE[:10] + [200, 201, 202, 203],
    "p2": BASE + [33, 71, 6, 120, 7, 8, 9],
    "short": [4, 8, 15],
    "m9": [int(t) for t in random.Random(1).choices(range(1, 500), k=9)],
    "m20": [int(t) for t in random.Random(2).choices(range(1, 500), k=20)],
    "m27": [int(t) for t in random.Random(3).choices(range(1, 500), k=27)],
    "m31": [int(t) for t in random.Random(4).choices(range(1, 500), k=31)],
}


def run_engine(engine, sequential):
    """Submit every prompt (all at once, or each after the previous one
    finished) and return {id: greedy tokens}."""
    engine.start()
    try:
        assert engine.wait_ready(120)
        reqs = []
        for rid, toks in PROMPTS.items():
            r = Request(id=rid, tokens=list(toks), max_new_tokens=NEW_TOKENS)
            assert engine.submit(r)
            reqs.append(r)
            if sequential:
                assert r.done.wait(120), rid
        for r in reqs:
            assert r.done.wait(120), r.id
            assert not r.error, (r.id, r.error)
        return {r.id: [int(t) for t in r.output] for r in reqs}
    finally:
        engine.stop()


@pytest.fixture(scope="module")
def weights():
    cfg = LlamaConfig.tiny(**MOE)
    return cfg, numpy_params(cfg)


@pytest.fixture(scope="module")
def jax_tokens(weights):
    """The JAX engine's greedy tokens (continuous batching, no prefix
    cache) on the numpy weights."""
    _, params = weights
    jparams = jax.tree.map(jnp.asarray, params)
    jcfg = jax_llama.LlamaConfig.tiny(**MOE)
    with pytest.MonkeyPatch.context() as mp:
        # LlamaBackend.load draws its own init: hand it the shared one.
        mp.setattr(jax_llama, "llama_init", lambda key, cfg: jparams)
        engine = jax_serve.ServeEngine(jax_serve.LlamaBackend(jcfg),
                                       jax_serve.ServeConfig(**ENGINE))
        return run_engine(engine, sequential=False)


def port_engine(weights, **overrides):
    cfg, params = weights
    backend = LlamaBackend(cfg, device="cpu",
                           params=bridge.llama_from_jax(params, cfg, "cpu"))
    return ServeEngine(backend, ServeConfig(**ENGINE, **overrides))


def test_continuous_batching_tokens_equal_jax(weights, jax_tokens):
    engine = port_engine(weights)
    got = run_engine(engine, sequential=False)
    assert got == jax_tokens
    st = engine.stats()
    assert st.completed == len(PROMPTS) and st.dropped == 0
    # Eager PyTorch compiles nothing; the count is of distinct buckets.
    assert st.prefill_compiles == len(ENGINE["prefill_buckets"])


def test_prefix_cache_tail_extend_tokens_equal_cold_prefill(weights,
                                                            jax_tokens):
    """Sequential admission with the prefix cache on: p1 and p2 reuse p0's
    retained pages (p1 through a copy-on-write page) and prefill only
    their tails — token-identical to the cold prefills of the JAX engine."""
    engine = port_engine(weights, prefix_cache=True)
    got = run_engine(engine, sequential=True)
    assert got == jax_tokens
    st = engine.stats()
    assert st.prefix_hits >= 2 and st.cow_copies >= 1
    assert st.prefix_reused_tokens >= 8 + 16


# ---------------------------------------------------------------------------
# The paged pool and the engine against the port's generate()
# ---------------------------------------------------------------------------

def tiny_model():
    cfg = LlamaConfig.tiny()
    return cfg, llama_init(cfg, torch.Generator().manual_seed(0), "cpu")


def generate_oracle(model, cfg, prompt, new_tokens):
    out = generate(model, torch.tensor([prompt]), cfg,
                   max_new_tokens=new_tokens)
    return [int(t) for t in out[0, len(prompt):]]


def test_paged_decode_of_staggered_slots_matches_generate():
    """Two slots of different prompt lengths, prefilled into their pages
    and decoded together through ``paged_decode_step``, reproduce the
    contiguous-cache ``generate`` token for token (greedy)."""
    cfg, model = tiny_model()
    page, new_tokens = 8, 6
    cache = init_paged_cache(cfg, num_pages=17, page_size=page, device="cpu")
    prompts = [[7, 3, 9, 11, 2], [5, 1, 4, 1, 5, 9, 2, 6, 5]]
    # Slot 0 owns pages 1..8, slot 1 pages 9..16.
    tables = torch.stack([torch.arange(1, 9), torch.arange(9, 17)])
    outs, positions = [[], []], []
    for b, prompt in enumerate(prompts):
        plen, bucket = len(prompt), 16
        toks = torch.zeros((1, bucket), dtype=torch.long)
        toks[0, :plen] = torch.tensor(prompt)
        rows = torch.zeros(bucket, dtype=torch.long)
        for j in range(plen):
            rows[j] = tables[b, j // page] * page + j % page
        logits, _ = paged_prefill(model, toks, cache, rows, plen, cfg)
        outs[b].append(int(logits.argmax()))
        positions.append(plen)
    for _ in range(new_tokens - 1):
        logits, _ = paged_decode_step(
            model, torch.tensor([o[-1] for o in outs]), cache,
            torch.tensor(positions), tables, cfg, page)
        for b, tok in enumerate(logits.argmax(dim=-1).tolist()):
            outs[b].append(tok)
            positions[b] += 1
    for b, prompt in enumerate(prompts):
        assert outs[b] == generate_oracle(model, cfg, prompt, new_tokens), b


def test_engine_matches_generate_oracle():
    """The whole engine (admission, paging, bucketing) gives each of 7
    concurrent requests the tokens of ``generate``."""
    cfg, model = tiny_model()
    eng = mk_engine(slots=3, page_size=8, max_len=64,
                    backend=LlamaBackend(cfg, device="cpu", params=model))
    rng = random.Random(23)
    reqs = [Request(id=str(i),
                    tokens=[rng.randrange(1, 250)
                            for _ in range(rng.randrange(2, 20))],
                    max_new_tokens=5) for i in range(7)]
    for r in reqs:
        assert eng.submit(r)
    for r in reqs:
        assert r.done.wait(120), r.id
        assert not r.error, (r.id, r.error)
    eng.stop()
    for r in reqs:
        assert r.output == generate_oracle(model, cfg, r.tokens, 5), r.id


# ---------------------------------------------------------------------------
# Engine contracts on the synthetic backend
# ---------------------------------------------------------------------------

def mk_engine(slots=4, page_size=8, max_len=64, backend=None, **kw):
    eng = ServeEngine(
        backend or SyntheticBackend(),
        ServeConfig(slots=slots, page_size=page_size, max_len=max_len,
                    prefill_buckets=(8, 16, 32), stats_window_s=2.0, **kw))
    eng.start()
    assert eng.wait_ready(30)
    return eng


def test_admission_all_requests_complete_exact_lengths():
    eng = mk_engine()
    rng = random.Random(3)
    reqs = [Request(id=str(i), tokens=[1 + i % 40] * rng.randrange(1, 30),
                    max_new_tokens=rng.randrange(1, 10))
            for i in range(25)]
    for r in reqs:
        assert eng.submit(r)
    for r in reqs:
        assert r.done.wait(30), r.id
        assert len(r.output) == r.max_new_tokens
    st = eng.stats()
    assert st.completed == 25 and st.dropped == 0
    assert st.slots_used == 0 and st.queue_depth == 0
    with eng._lock:
        assert sorted(eng._free_pages) == list(range(1, 4 * 8 + 1))
    eng.stop()


def test_drain_stops_intake_finishes_inflight():
    eng = mk_engine(slots=2, backend=SyntheticBackend(step_s=0.005))
    inflight = [Request(id=f"in-{i}", tokens=[1, 2], max_new_tokens=20)
                for i in range(2)]
    queued = [Request(id=f"q-{i}", tokens=[1], max_new_tokens=4)
              for i in range(3)]
    for r in inflight + queued:
        eng.submit(r)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and eng.stats().slots_used < 2:
        time.sleep(0.005)
    handed_back = eng.drain()
    assert {r.id for r in handed_back} <= {r.id for r in queued}
    late = Request(id="late", tokens=[1], max_new_tokens=1)
    res = eng.submit(late)
    assert not res and res.reason == "draining"
    assert not late.done.is_set()
    for r in inflight:
        assert r.done.wait(30), r.id
        assert len(r.output) == r.max_new_tokens and not r.error
    assert eng._drained.wait(10)
    assert eng.stats().phase == "drain"
    eng.stop()


def test_overload_refusal_at_max_queue():
    assert SUBMIT_OK and not REFUSED_DRAINING and not REFUSED_OVERLOADED
    eng = ServeEngine(SyntheticBackend(), ServeConfig(
        slots=1, page_size=8, max_len=32, prefill_buckets=(8, 16),
        max_queue=2, stats_window_s=2.0))
    reqs = [Request(id=str(i), tokens=[1], max_new_tokens=1)
            for i in range(3)]
    assert eng.submit(reqs[0]) and eng.submit(reqs[1])
    res = eng.submit(reqs[2])
    assert not res and res.reason == "overloaded"
    assert not reqs[2].done.is_set() and not reqs[2].error
    eng.stop()


def test_synthetic_engine_agrees_with_jax_engine():
    """The copied engine takes the reference's decisions: the same traffic
    on the same synthetic backend gives the same tokens and step count."""
    def drive(engine_cls, backend_cls, config_cls, request_cls):
        eng = engine_cls(backend_cls(), config_cls(
            slots=3, page_size=8, max_len=64, prefill_buckets=(8, 16, 32),
            prefix_cache=True, stats_window_s=2.0))
        eng.start()
        assert eng.wait_ready(30)
        rng = random.Random(7)
        outs = {}
        for i in range(12):
            r = request_cls(id=str(i), tokens=[5] * rng.randrange(1, 40),
                            max_new_tokens=rng.randrange(1, 6))
            assert eng.submit(r)
            assert r.done.wait(30)
            outs[r.id] = list(r.output)
        st = eng.stats()
        eng.stop()
        return outs, (st.prefix_hits, st.prefix_reused_tokens, st.cow_copies)

    ours = drive(ServeEngine, SyntheticBackend, ServeConfig, Request)
    theirs = drive(jax_serve.ServeEngine, jax_serve.SyntheticBackend,
                   jax_serve.ServeConfig, jax_serve.Request)
    assert ours == theirs
    assert ours[1][0] > 0


def test_progress_drop_file_carries_serving_gauges(tmp_path):
    rep = progress.ProgressReporter(namespace="ns", name="pod-0",
                                    drop_dir=str(tmp_path))
    rep.beat(step=3, phase="serving", serving={"ttft_ms": 1.5,
                                               "queue_depth": 2})
    rep.beat(phase="drain")
    body = json.loads((tmp_path / "ns__pod-0.json").read_text())
    assert body == {"step": 3, "phase": "drain", "ttftMs": 1.5,
                    "queueDepth": 2}


def test_main_sigterm_drains_and_exits_zero():
    """``python -m kubeflow_controller_tpu_torch.workloads.serve``: serves
    JSON lines, and SIGTERM finishes the in-flight request, then exits 0."""
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_controller_tpu_torch.workloads.serve",
         "--synthetic", "--port", str(port), "--slots", "2"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    try:
        deadline = time.monotonic() + 60
        sock = None
        while sock is None and time.monotonic() < deadline:
            try:
                sock = socket.create_connection(("127.0.0.1", port),
                                                timeout=0.2)
            except OSError:
                time.sleep(0.1)
        assert sock is not None, "server never listened"
        f = sock.makefile("rwb")
        f.write(json.dumps({"id": "r1", "prompt": [1, 2, 3],
                            "max_new": 4}).encode() + b"\n")
        f.flush()
        resp = json.loads(f.readline())
        assert resp["id"] == "r1" and len(resp["tokens"]) == 4
        f.write(json.dumps({"id": "r2", "prompt": [5],
                            "max_new": 50}).encode() + b"\n")
        f.flush()
        time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        resp2 = json.loads(f.readline())
        assert resp2["id"] == "r2"
        assert len(resp2["tokens"]) == 50 and not resp2["error"]
        sock.close()
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
