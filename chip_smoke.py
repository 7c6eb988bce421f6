#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card: build its kernels, hold each
against its plain version at the serving path's real shapes, then serve a
few requests through the continuous-batching replica at Mixtral-8x7B's
published widths (8 of its 32 layers), and check what comes out.

    python3 chip_smoke.py [--seed N]      # one card

Phases, in order (any failure raises and exits non-zero):

1. build: ``nvcc`` compiles ``kubeflow_controller_tpu_torch/csrc/*.cu`` for
   sm_90a; prints the build seconds and ptxas' register/spill lines.
2. kernels: ``gmm_swiglu`` and ``gmm`` at the decode layout (8 slots x
   top-2 = 16 routed rows, M = 144, bm = 16) and the prefill layout (a
   128-token bucket: 256 rows, M = 2304, bm = 256), bf16, against the plain
   versions computed in f32 on the same inputs.  Only the rows the combine
   reads are compared (tiles past the last group hold garbage in the
   reference too).  Tolerance: max |kernel - plain| <= 2e-2 * max |plain|
   (bf16 output, one rounding).  Prints each kernel's ms, the plain
   version's ms, a per-expert ``torch.matmul`` loop's ms (``library_ms``, a
   yardstick the port never calls) and the bound (bytes or FLOPs).
3. serve: ``LlamaBackend`` under a ``ServeEngine`` (8 slots, max_len 256,
   buckets 16/32/64/128) answers 8 requests of 12-120 prompt tokens and 16
   new tokens each.  The launch counters are zeroed just before and read
   just after; both kernels must have launched.  Then one prefill's logits,
   kernel path against plain path on the card: max |diff| <= 5e-2 * max
   |plain| (bf16 activations through 8 layers; each layer rounds twice in
   the expert FFN alone).
4. profile: ``torch.profiler`` over decode steps and a 128-token prefill
   of the same backend: wall ms, device-busy ms, idle share and kernel
   time by group (PERF.md section 5).
5. The ``kernels`` JSON line, the card's name and power limit, and the
   contract line ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from unittest import mock

import numpy as np
import torch

from kubeflow_controller_tpu_torch.models import moe
from kubeflow_controller_tpu_torch.models.generate import init_paged_cache, paged_prefill
from kubeflow_controller_tpu_torch.models.llama import LlamaConfig
from kubeflow_controller_tpu_torch.ops import _build
from kubeflow_controller_tpu_torch.ops import grouped_matmul as gm
from kubeflow_controller_tpu_torch.workloads.serve import (
    LlamaBackend,
    Request,
    ServeConfig,
    ServeEngine,
)

# H100 SXM published peaks (dense bf16, HBM3), at the full 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

KERNEL_REL_TOL = 2e-2
LOGITS_REL_TOL = 5e-2
SOURCE = "kubeflow_controller_tpu_torch/csrc/grouped_matmul.cu"
REF_FILE = "kubeflow_controller_tpu/ops/grouped_matmul.py"


def mixtral_8x7b(n_layers: int = 8) -> LlamaConfig:
    """mistralai/Mixtral-8x7B-v0.1 config.json widths; depth cut to
    ``n_layers`` of 32 (all 32 are ~93 GB in bf16, over the card's 80)."""
    return LlamaConfig(
        vocab_size=32000, dim=4096, n_layers=n_layers, n_heads=32,
        n_kv_heads=8, intermediate=14336, max_seq_len=32768,
        rope_theta=1e6, norm_eps=1e-5, dtype="bfloat16",
        param_dtype="bfloat16", remat=False, n_experts=8, moe_top_k=2,
        moe_dispatch="grouped")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------

def build_phase():
    lib = _build.library()
    print(f"build: {lib.build_seconds:.3f} s -> {lib.path.name}", flush=True)
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    return lib


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def layout_case(cfg: LlamaConfig, n_tok: int, gen: torch.Generator, dev):
    """The grouped layout of ``n_tok`` random tokens under a random
    router, the lhs the FFN kernels see, and the host-side group sizes."""
    logits = torch.randn((1, n_tok, cfg.n_experts), generator=gen,
                         device=dev)
    _, idx = moe.router_topk(logits, cfg.moe_top_k)
    lay = moe.grouped_layout(idx, cfg.n_experts, 256)
    x = (torch.randn((n_tok, cfg.dim), generator=gen, device=dev)
         ).to(torch.bfloat16)
    x_pad = moe._dispatch_rows(x, lay.inv_src)
    counts = np.bincount(idx.reshape(-1).cpu().numpy(),
                         minlength=cfg.n_experts)
    return lay, x_pad, counts


def groups(counts, bm):
    """(expert, first row, row count) of every non-empty expert group."""
    out, off = [], 0
    for e, c in enumerate(counts):
        if c:
            out.append((e, off, int(c)))
        off += -(-int(c) // bm) * bm
    return out


def check_rel(name, got, ref, rows, tol):
    got = got.index_select(0, rows).float()
    ref = ref.index_select(0, rows).float()
    assert torch.isfinite(got).all(), f"{name}: non-finite kernel output"
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"  {name}: max_abs_err {err:.6g} (max |plain| {scale:.6g}, "
          f"rel {err / scale:.3g}, tol {tol})", flush=True)
    assert err <= tol * scale, f"{name}: kernel disagrees with plain version"
    return err


def kernel_phase(cfg: LlamaConfig, dev, seed: int):
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, f, e = cfg.dim, cfg.intermediate, cfg.n_experts

    def w(shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02
                ).to(torch.bfloat16)

    wg, wu, wd = w((e, d, f)), w((e, d, f)), w((e, f, d))
    results = {}
    for shape, n_tok, iters in (("decode", 8, 20), ("prefill", 128, 10)):
        lay, x_pad, counts = layout_case(cfg, n_tok, gen, dev)
        bm, te, rows = lay.bm, lay.tile_experts, lay.dest
        n_rows, used = int(counts.sum()), int((counts > 0).sum())
        grp = groups(counts, bm)
        print(f"{shape}: M={lay.m} bm={bm} routed rows={n_rows} "
              f"experts touched={used}", flush=True)

        h = gm.gmm_swiglu(x_pad, wg, wu, te, bm)
        torch.cuda.synchronize()
        ref_h = gm.gmm_swiglu_plain(x_pad.float(), wg.float(), wu.float(),
                                    te, bm)
        err_h = check_rel(f"gmm_swiglu[{shape}]", h, ref_h, rows,
                          KERNEL_REL_TOL)
        del ref_h
        y = gm.gmm(h, wd, te, bm)
        torch.cuda.synchronize()
        ref_y = gm.gmm_plain(h.float(), wd.float(), te, bm)
        err_y = check_rel(f"gmm[{shape}]", y, ref_y, rows, KERNEL_REL_TOL)
        del ref_y

        def lib_swiglu():
            for ex, r0, c in grp:
                xe = x_pad[r0:r0 + c]
                torch.nn.functional.silu(xe @ wg[ex]) * (xe @ wu[ex])

        def lib_down():
            for ex, r0, c in grp:
                h[r0:r0 + c] @ wd[ex]

        sw_bytes = 2 * (n_rows * d + 2 * used * d * f + n_rows * f)
        dn_bytes = 2 * (n_rows * f + used * f * d + n_rows * d)
        sw_flops = 2 * 2 * n_rows * d * f
        dn_flops = 2 * n_rows * f * d
        for name, fn, plain, lib_fn, nbytes, flops, err in (
            ("gmm_swiglu", lambda: gm.gmm_swiglu(x_pad, wg, wu, te, bm),
             lambda: gm.gmm_swiglu_plain(x_pad, wg, wu, te, bm), lib_swiglu,
             sw_bytes, sw_flops, err_h),
            ("gmm", lambda: gm.gmm(h, wd, te, bm),
             lambda: gm.gmm_plain(h, wd, te, bm), lib_down,
             dn_bytes, dn_flops, err_y),
        ):
            b_ms, b_by = bound(nbytes, flops)
            rec = {
                "ms": time_ms(fn, iters),
                "plain_ms": time_ms(plain, 3, warmup=1),
                "library_ms": time_ms(lib_fn, iters),
                "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                "M": lay.m, "bm": bm, "routed_rows": n_rows,
                "experts_touched": used,
            }
            results.setdefault(name, {})[shape] = rec
            print(f"  {name}[{shape}]: {rec['ms']:.4f} ms kernel, "
                  f"{rec['plain_ms']:.4f} ms plain, {rec['library_ms']:.4f} "
                  f"ms library, bound {b_ms:.4f} ms ({b_by})", flush=True)
        del h, y, x_pad
    del wg, wu, wd
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Phase 3: serve through the replica
# ---------------------------------------------------------------------------

@contextmanager
def plain_grouped_matmuls():
    """Route the MoE FFN through the plain versions (comparison only)."""
    with mock.patch.object(moe, "gmm", gm.gmm_plain), \
            mock.patch.object(moe, "gmm_swiglu", gm.gmm_swiglu_plain):
        yield


def serve_phase(cfg: LlamaConfig, dev, seed: int):
    scfg = ServeConfig(slots=8, page_size=16, max_len=256,
                       prefill_buckets=(16, 32, 64, 128))
    backend = LlamaBackend(cfg, seed=seed, device=dev)
    rng = np.random.default_rng(seed)
    lens = [120, 12] + [int(n) for n in rng.integers(12, 121, 6)]
    reqs = [Request(id=f"r{i}",
                    tokens=[int(t) for t in rng.integers(1, cfg.vocab_size, n)],
                    max_new_tokens=16) for i, n in enumerate(lens)]

    torch.cuda.reset_peak_memory_stats()
    gm.gmm.launches = 0
    gm.gmm_swiglu.launches = 0
    t0 = time.perf_counter()
    engine = ServeEngine(backend, scfg)
    engine.start()
    assert engine.wait_ready(900), "engine never became ready"
    t_ready = time.perf_counter()
    for r in reqs:
        assert engine.submit(r), r.id
    for r in reqs:
        assert r.done.wait(900), f"{r.id} never finished"
    t_done = time.perf_counter()
    engine.drain()
    assert engine._drained.wait(60)
    st = engine.stats()
    engine.stop()
    launches = {"gmm": gm.gmm.launches, "gmm_swiglu": gm.gmm_swiglu.launches}

    for r in reqs:
        assert not r.error, (r.id, r.error)
        assert len(r.output) == 16, (r.id, len(r.output))
        assert all(0 <= t < cfg.vocab_size for t in r.output), r.id
    assert launches["gmm"] > 0 and launches["gmm_swiglu"] > 0, launches
    n_out = sum(len(r.output) for r in reqs)
    out = {
        "load_and_warmup_s": t_ready - t0,
        "ttft_p50_ms": statistics.median(r.ttft_s for r in reqs) * 1e3,
        "decode_ms_per_step_p50": st.itl_ms,
        "tokens_per_s": n_out / (t_done - t_ready),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "decode_steps": st.step, "prefill_buckets_seen": st.prefill_compiles,
        "prompt_lens": lens,
    }
    print("serve: " + json.dumps(out), flush=True)

    # One prefill's logits, kernel path against plain path, on the card.
    model = backend.model
    plen, bucket = 100, 128
    toks = torch.zeros((1, bucket), dtype=torch.long, device=dev)
    toks[0, :plen] = torch.as_tensor(reqs[0].tokens[:plen], device=dev)
    rows = torch.zeros(bucket, dtype=torch.long, device=dev)
    rows[:plen] = scfg.page_size + torch.arange(plen, device=dev)
    num_pages = 1 + bucket // scfg.page_size
    lk, _ = paged_prefill(model, toks, init_paged_cache(
        cfg, num_pages, scfg.page_size, dev), rows, plen, cfg)
    with plain_grouped_matmuls():
        lp, _ = paged_prefill(model, toks, init_paged_cache(
            cfg, num_pages, scfg.page_size, dev), rows, plen, cfg)
    assert lk.shape == (cfg.vocab_size,) and torch.isfinite(lk).all()
    err = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    out_l = {"logits_max_abs_err": err, "logits_max_abs": scale,
             "argmax_equal": bool(lk.argmax() == lp.argmax()),
             "tol": LOGITS_REL_TOL}
    print("prefill logits kernel vs plain: " + json.dumps(out_l), flush=True)
    assert err <= LOGITS_REL_TOL * scale, "prefill logits disagree"
    return launches, backend, scfg


# ---------------------------------------------------------------------------
# Phase 4: where a decode step's and a prefill's device time goes
# ---------------------------------------------------------------------------

KERNEL_GROUPS = (
    ("gmm_swiglu", lambda n: "gmm_kernel" in n and "true>" in n),
    ("gmm", lambda n: "gmm_kernel" in n),
    ("library gemm", lambda n: any(w in n for w in (
        "gemm", "cutlass", "xmma", "nvjet", "cublas", "sm90_"))),
    ("gather/scatter", lambda n: any(w in n for w in ("index", "gather",
                                                       "scatter"))),
    ("softmax/reduce", lambda n: "softmax" in n or "reduce" in n.lower()),
    ("elementwise/copy", lambda n: True),
)


def profile_phase(backend, scfg, steps: int = 5):
    """torch.profiler over ``steps`` decode steps of the full slot batch
    (every slot live at position 100) and over prefills of one 128-token
    prompt, through the backend the engine served with: wall ms per call,
    device-busy ms (the sum of kernel times on the one stream), the idle
    share, and kernel time by group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ps, pps = scfg.page_size, scfg.pages_per_slot()
    tables = (1 + np.arange(scfg.slots)[:, None] * pps
              + np.arange(pps)[None, :]).astype(np.int32)
    tokens = np.arange(1, scfg.slots + 1, dtype=np.int32)
    positions = np.full(scfg.slots, 100, np.int32)
    prompt = np.arange(1, 129, dtype=np.int32)[None]
    rows = (tables[0, np.arange(128) // ps] * ps
            + np.arange(128) % ps).astype(np.int32)
    calls = (("decode", lambda: backend.decode(tokens, positions, tables),
              steps),
             ("prefill", lambda: backend.prefill(prompt, rows, 128), 2))
    for name, fn, n in calls:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        by_group = {g: 0.0 for g, _ in KERNEL_GROUPS}
        for e in kernels:
            group = next(g for g, match in KERNEL_GROUPS if match(e.key))
            by_group[group] += e.self_device_time_total / 1e3 / n
        busy_ms = sum(by_group.values())
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        print(f"profile[{name}]: " + json.dumps({
            "calls": n, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms if kernels else None,
            "kernel_launches": sum(e.count for e in kernels) / n,
            "ms_by_group": by_group,
            "top": [[e.key[:90], e.count // n,
                     e.self_device_time_total / 1e3 / n] for e in top],
        }), flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def kernels_line(results, launches):
    replaces = {
        "gmm": (f"{REF_FILE}:132 (_gmm_single_k_kernel, decode); "
                f"{REF_FILE}:78 (_gmm_kernel, prefill)"),
        "gmm_swiglu": f"{REF_FILE}:227 (_gmm2_kernel)",
    }
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")
    entries = []
    for name in ("gmm_swiglu", "gmm"):
        dec, pre = results[name]["decode"], results[name]["prefill"]
        entries.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": max(dec["max_abs_err"], pre["max_abs_err"]),
            **{k: dec[k] for k in keys if k != "max_abs_err"},
            "shape": "decode",
            "prefill": pre,
        })
    return json.dumps({"kernels": entries})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    cfg = mixtral_8x7b()
    build_phase()
    results = kernel_phase(cfg, dev, args.seed)
    launches, backend, scfg = serve_phase(cfg, dev, args.seed)
    profile_phase(backend, scfg)
    print(kernels_line(results, launches))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
