#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card: build its kernels, hold each
against its plain version at its path's real shapes, serve a few requests
through the continuous-batching replica at Mixtral-8x7B's published widths
(8 of its 32 layers), train the dense Llama-2-7B (8 of its 32 layers) and
the Mixtral-8x7B-width MoE (2 of its 32 layers) for a few steps, and check
what comes out.

    python3 chip_smoke.py [--seed N]     # one card

Phases, in order (any failure raises and exits non-zero):

1. build: ``nvcc`` compiles ``kubeflow_controller_tpu_torch/csrc/*.cu`` for
   sm_90a, one process per source, all at once; prints the build seconds
   and ptxas' register/spill lines.
2. gmm kernels: ``gmm_swiglu`` and ``gmm`` at the decode layout (8 slots x
   top-2 = 16 routed rows, M = 144, bm = 16) and the prefill layout (a
   128-token bucket: 256 rows, M = 2304, bm = 256), bf16, against the plain
   versions computed in f32 on the same inputs.  Only the rows the combine
   reads are compared (tiles past the last group hold garbage in the
   reference too).  Tolerance: max |kernel - plain| <= 2e-2 * max |plain|
   (bf16 output, one rounding).  Prints each kernel's ms, the plain
   version's ms, a per-expert ``torch.matmul`` loop's ms (``library_ms``, a
   yardstick the port never calls) and the bound (bytes or FLOPs).
3. MoE training kernels at the layout of B 2 x T 4096 (16384 routed rows,
   M 18432, bm 256), every operand row nonzero (pad rows and the clamped
   tail included): ``gmm_swiglu`` writing h, gate and up; the down ``gmm``
   and both transposed-rhs dlhs ``gmm`` shapes (2e-2 of max |plain|, every
   row); ``tgmm`` at the gate/up ([M, 4096] x [M, 14336] -> [8, 4096,
   14336]) and down shapes against ``tgmm_plain`` in f32, each expert's
   block within ||kernel - plain|| / ||plain|| <= 1e-2; a negative control
   (the kernel's own block of the expert of tile 0 less its last tile's
   contribution) must fail that check; an expert no token picks must come
   out exactly zero.  Then ``gmm`` and ``tgmm`` under ``valid_tiles`` on a
   worst-case per-shard layout (2 local experts plus the sentinel group,
   about half the tiles real): rows past ``valid_tiles`` exactly 0.  Each
   with ms, plain ms, ``library_ms`` (per-expert ``torch.matmul`` loops over
   the real rows) and the bound over the routed rows.
4. flash kernels: ``flash_fwd``, ``flash_dq`` and ``flash_dkv`` at the
   pretrain shape (B 4, H 32, T 4096, D 128, causal, bf16) against their
   plain versions (f32 math, full-precision f32 matmuls) on the same
   inputs, eight heads at a time.  Each row is compared on its own (a
   query row of o and dq, a key row of dk and dv): ||kernel - plain|| /
   ||plain|| <= 1e-2 in every row (p and ds are rounded to bf16 before
   their products, and the outputs to bf16: each a relative 2^-8 at most),
   the denominator floored at 1e-2 of the RMS row norm (causal dq row 0 is
   zero up to rounding); lse within 1e-3 absolute.  Negative controls:
   the same check must reject the kernels' own dk/dv with every key row
   from 1500 on zeroed, and their o with every query row from 1024 on
   scaled by 0.7.  Also non-causal and head_dim 64 at a small shape.
   Prints each kernel's ms, its plain version's ms on the same inputs (16
   calls of 8 heads: its f32 scores are 512 MB a call), the bound at H100
   SXM peaks, and ``torch.nn.functional.scaled_dot_product_attention``'s
   fwd, bwd alone (dq, dk and dv in one call) and fwd+bwd ms (a yardstick
   the port never calls); then the kernels' fwd+bwd against the plain
   attention path at T = 1024/2048/4096 (B 1, H 32).
5. serve: ``LlamaBackend`` under a ``ServeEngine`` (8 slots, max_len 256,
   buckets 16/32/64/128) answers 8 requests of 12-120 prompt tokens and 16
   new tokens each.  The gmm launch counters are zeroed just before and
   read just after; both kernels must have launched.  Then one prefill's
   logits, kernel path against plain path on the card: max |diff| <= 5e-2 *
   max |plain| (bf16 activations through 8 layers; each layer rounds twice
   in the expert FFN alone).
6. profile: ``torch.profiler`` over decode steps and a 128-token prefill
   of the same backend: wall ms, device-busy ms, idle share and kernel
   time by group (PERF.md section 5).
7. train check: Llama-2-7B widths at 2 layers, B 1, T 1024, one seed: the
   loss and every parameter gradient of the kernel path against the same
   step with the flash wrappers swapped for their plain versions.  Loss
   within 1e-2 relative; each gradient's ||g_kernel - g_plain|| /
   ||g_plain|| <= 5e-2.
8. train: ``llama_pretrain.train`` (the loop ``llama_pretrain.main`` runs)
   on ``LlamaConfig.llama2_7b()`` cut to 8 of 32 layers, remat "full",
   attention "auto", B 4 x T 4096 synthetic tokens, 5 steps of AdamW (lr
   3e-4, weight decay 0.1, clip 1.0).  The flash launch counters are zeroed
   just before and read just after: flash_fwd must have launched 2 x 8 x 5
   times (forward and remat recompute), flash_dq and flash_dkv 8 x 5.
   Every loss finite, the last below the first.  Prints step ms p50,
   tokens/s, peak memory, then steps 6 and 7 of the same loop (same
   optimizer state and tokens), the seventh under the profiler (kernel
   time by group, idle share).
9. MoE train check: ``mixtral_8x7b_train(1)``, B 1, T 1024: as phase 7,
   with ``gmm``, ``gmm_swiglu`` and ``tgmm`` (forward and backward) swapped
   for their plain versions; the same limits.
10. MoE train: ``llama_pretrain.train`` on ``mixtral_8x7b_train(2)`` (f32
   parameters, bf16 activations, remat "full", attention "auto", grouped
   dispatch), B 2 x T 4096, 5 steps as phase 8.  Launch counts exact: per
   layer per step ``gmm_swiglu`` 2 (forward, recompute), ``gmm`` 5 (down
   forward and recompute, down dlhs, the two SwiGLU dlhs), ``tgmm`` 3,
   ``flash_fwd`` 2, ``flash_dq`` and ``flash_dkv`` 1.  Peak memory under 80
   GB; the profiled seventh step as in phase 8.
11. entry point: ``llama_pretrain.main`` on the card's default device,
   ``--preset tiny --steps 2``, then with ``--experts 4 --moe-dispatch
   einsum``.
12. The card's name and power limit, the ``kernels`` JSON line (launches
   from phase 10, the slice's main path; each path's own counts beside
   them), and the contract line ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from dataclasses import replace
from unittest import mock

import numpy as np
import torch

from kubeflow_controller_tpu_torch.models import moe
from kubeflow_controller_tpu_torch.models.generate import init_paged_cache, paged_prefill
from kubeflow_controller_tpu_torch.models.llama import LlamaConfig, llama_init, llama_loss
from kubeflow_controller_tpu_torch.ops import _build
from kubeflow_controller_tpu_torch.ops import attention as at
from kubeflow_controller_tpu_torch.ops import grouped_matmul as gm
from kubeflow_controller_tpu_torch.parallel.ring import attention_reference
from kubeflow_controller_tpu_torch.workloads import llama_pretrain
from kubeflow_controller_tpu_torch.workloads.data import synthetic_tokens
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
FLASH_SOURCE = "kubeflow_controller_tpu_torch/csrc/flash_attention.cu"
FLASH_REF = "kubeflow_controller_tpu/ops/attention.py"
FLASH_ROW_TOL = 1e-2               # per row: ||kernel - plain|| / ||plain||
ROW_FLOOR = 1e-2                   # of the RMS row norm, the denominator's floor
FLASH_OUTS = ("o", "dq", "dk", "dv")
LSE_ATOL = 1e-3
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_RTOL = 5e-2
FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
FLASH_SHAPE = (4, 4096, 32, 128)    # the pretrain shape: B, T, H, D
PLAIN_HEADS = 8                     # heads per plain-version call
SWEEP_T = (1024, 2048, 4096)
CHECK_SEQ = 1024                    # the card-side training check's T
TGMM_REL_TOL = 1e-2                 # per expert: ||kernel - plain|| / ||plain||
TGMM_SOURCE_LINES = (f"{REF_FILE}:338 (_tgmm_kernel); "
                     f"{REF_FILE}:364 (_tgmm_skip_kernel)")
GROUPED_KERNELS = ("gmm_swiglu", "gmm", "tgmm")
MOE_TRAIN = {"layers": 2, "batch": 2, "seq_len": 4096}
MOE_CHECK = {"layers": 1, "batch": 1, "seq_len": 1024}
# Kernel launches per layer per step of the MoE train path under remat
# "full" (forward, and the recompute in the backward).
MOE_LAUNCHES_PER_LAYER = {"gmm_swiglu": 2, "gmm": 5, "tgmm": 3,
                          "flash_fwd": 2, "flash_dq": 1, "flash_dkv": 1}


def mixtral_8x7b(n_layers: int = 8) -> LlamaConfig:
    """mistralai/Mixtral-8x7B-v0.1 config.json widths; depth cut to
    ``n_layers`` of 32 (all 32 are ~93 GB in bf16, over the card's 80)."""
    return LlamaConfig(
        vocab_size=32000, dim=4096, n_layers=n_layers, n_heads=32,
        n_kv_heads=8, intermediate=14336, max_seq_len=32768,
        rope_theta=1e6, norm_eps=1e-5, dtype="bfloat16",
        param_dtype="bfloat16", remat=False, n_experts=8, moe_top_k=2,
        moe_dispatch="grouped")


def mixtral_8x7b_train(n_layers: int = 2) -> LlamaConfig:
    """Mixtral-8x7B widths (``mixtral_8x7b``) set for training as the
    reference trains: f32 parameters, bf16 activations, remat "full",
    attention "auto" (the flash kernels at T >= 1024), grouped dispatch.
    Depth cut to ``n_layers`` of 32: each layer is ~1.451 B parameters, 16 B
    each as f32 parameter, gradient and two AdamW moments, so two layers
    plus embed and lm_head (~3.16 B) hold ~50.6 GB of training state."""
    return replace(mixtral_8x7b(n_layers), param_dtype="float32", remat=True,
                   remat_policy="full", attention="auto")


def llama2_7b(n_layers: int = 8) -> LlamaConfig:
    """meta-llama/Llama-2-7b widths (``LlamaConfig.llama2_7b()``: vocab
    32000, dim 4096, 32 heads, 32 kv heads, intermediate 11008, rope theta
    1e4, bf16 activations, f32 parameters, remat "full", attention "auto");
    depth cut to ``n_layers`` of 32 (32 layers' f32 parameters, gradients
    and AdamW moments are ~108 GB, over the card's 80)."""
    return replace(LlamaConfig.llama2_7b(), n_layers=n_layers)


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

def routed_layout(cfg: LlamaConfig, n_tok: int, gen: torch.Generator, dev,
                  empty=None):
    """The grouped layout of ``n_tok`` tokens under a random router that
    never picks expert ``empty`` (if given), and the per-expert slot
    counts."""
    logits = torch.randn((1, n_tok, cfg.n_experts), generator=gen,
                         device=dev)
    if empty is not None:
        logits[..., empty] = -1e9
    _, idx = moe.router_topk(logits, cfg.moe_top_k)
    lay = moe.grouped_layout(idx, cfg.n_experts, 256)
    counts = np.bincount(idx.reshape(-1).cpu().numpy(),
                         minlength=cfg.n_experts)
    return lay, counts


def layout_case(cfg: LlamaConfig, n_tok: int, gen: torch.Generator, dev):
    """The grouped layout of ``n_tok`` random tokens under a random
    router, the lhs the FFN kernels see, and the host-side group sizes."""
    lay, counts = routed_layout(cfg, n_tok, gen, dev)
    x = (torch.randn((n_tok, cfg.dim), generator=gen, device=dev)
         ).to(torch.bfloat16)
    x_pad = moe._dispatch_rows(x, lay.inv_src, lay.dest.reshape(n_tok, -1))
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


def timed(fn, plain, library, nbytes, flops, err, iters=5, plain_iters=1,
          **extra):
    """Kernel, plain and library ms on the same inputs, and the bound."""
    b_ms, b_by = bound(nbytes, flops)
    return {"ms": time_ms(fn, iters),
            "plain_ms": time_ms(plain, plain_iters, warmup=1),
            "library_ms": time_ms(library, iters), "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err, **extra}


def print_times(name, shape, rec):
    print(f"  {name}[{shape}]: {rec['ms']:.4f} ms kernel, "
          f"{rec['plain_ms']:.4f} ms plain, {rec['library_ms']:.4f} ms "
          f"library, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})",
          flush=True)


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
            rec = timed(fn, plain, lib_fn, nbytes, flops, err, iters=iters,
                        plain_iters=3, M=lay.m, bm=bm, routed_rows=n_rows,
                        experts_touched=used)
            results.setdefault(name, {})[shape] = rec
            print_times(name, shape, rec)
        del h, y, x_pad
    del wg, wu, wd
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Phase 3: the MoE training kernels at the training layout
# ---------------------------------------------------------------------------

def shard_layout(n_slots: int, n_local: int, gen: torch.Generator, dev):
    """A worst-case per-shard layout of the ep-sharded path (the
    reference's ``_grouped_ffn_sharded``): a row for every routing slot,
    ``n_local`` local experts plus a sentinel group that takes the
    non-local half of the slots, tile owners clamped to ``n_local - 1``,
    and ``valid_tiles`` the sentinel group's first tile.  Returns
    (tile_experts, valid_tiles, M, bm, local slot counts)."""
    local = torch.rand((n_slots,), generator=gen, device=dev) < 0.5
    expert = torch.randint(0, n_local, (n_slots,), generator=gen, device=dev)
    slot_e = torch.where(local, expert, n_local)
    lay = moe.grouped_layout(slot_e[:, None], n_local + 1, 256)
    counts = np.bincount(slot_e.cpu().numpy(), minlength=n_local + 1)
    real_tiles = sum(-(-int(c) // lay.bm) for c in counts[:n_local])
    te = lay.tile_experts.clamp(max=n_local - 1)
    vt = torch.tensor([real_tiles], dtype=torch.int32, device=dev)
    return te, vt, lay.m, lay.bm, counts[:n_local]


def expert_rel_errs(got, ref):
    """Per expert block: ||got[e] - ref[e]|| / ||ref[e]|| (0 where both are
    zero, inf where only ref is)."""
    errs = []
    for e in range(ref.shape[0]):
        diff = (got[e].float() - ref[e]).norm().item()
        norm = ref[e].norm().item()
        errs.append(diff / norm if norm else (0.0 if diff == 0 else math.inf))
    return errs


def tgmm_check(name, lhs, dout, te, n_experts, bm, valid_tiles=None,
               empty=(), control=False):
    """tgmm against tgmm_plain (f32) on the same inputs, expert by expert
    within ``TGMM_REL_TOL``; experts in ``empty`` must be exact zeros.  The
    negative control (``control``) removes the last tile's contribution
    from the kernel's own block of the expert owning tile 0, and the check
    must reject it."""
    got = gm.tgmm(lhs, dout, te, n_experts, bm, valid_tiles)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all(), f"{name}: non-finite kernel output"
    ref = gm.tgmm_plain(lhs.float(), dout.float(), te, n_experts, bm,
                        valid_tiles)
    rel = expert_rel_errs(got, ref)
    out = {"max_expert_rel": max(rel), "expert_rel": rel,
           "max_abs_err": max((got[e].float() - ref[e]).abs().max().item()
                              for e in range(n_experts)),
           "tol": TGMM_REL_TOL}
    if empty:
        out["empty_experts_exact_zero"] = {
            int(e): not got[e].any().item() for e in empty}
    if control:
        te_np = te.cpu().numpy()
        e0 = int(te_np[0])
        last = int(np.nonzero(te_np == e0)[0].max())
        rows = slice(last * bm, (last + 1) * bm)
        bad = got[e0].float() - lhs[rows].float().t() @ dout[rows].float()
        out["control"] = {"expert": e0, "tile": last, "rel": (
            (bad - ref[e0]).norm() / ref[e0].norm()).item()}
    del ref
    print(f"  {name}: " + json.dumps(out), flush=True)
    assert out["max_expert_rel"] <= TGMM_REL_TOL, f"{name}: kernel disagrees"
    assert all(out.get("empty_experts_exact_zero", {}).values()), (
        f"{name}: an expert with no tile is not exactly zero")
    if control:
        assert out["control"]["rel"] > TGMM_REL_TOL, (
            f"{name}: the check passed a tile-short expert block")
    return got, out


def moe_kernel_phase(cfg: LlamaConfig, dev, seed: int, batch: int = 2,
                     seq_len: int = 4096):
    """The grouped-matmul kernels as the MoE train step launches them, at
    the layout of B ``batch`` x T ``seq_len`` tokens (top-2: 16384 routed
    rows, M 18432, bm 256 at B 2 x T 4096): gmm_swiglu with gate and up,
    the down gmm, both transposed-rhs dlhs gmms, tgmm at the gate/up and
    down shapes, and gmm and tgmm under ``valid_tiles`` on a per-shard
    layout.  Every row of every operand is nonzero (pad rows and the
    clamped tail included, which add into expert E - 1 in the reference
    too)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    d, f, e = cfg.dim, cfg.intermediate, cfg.n_experts

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(torch.bfloat16)

    n_tok = batch * seq_len
    lay, counts = routed_layout(cfg, n_tok, gen, dev)
    m, bm, te = lay.m, lay.bm, lay.tile_experts
    n_rows, used = int(counts.sum()), int((counts > 0).sum())
    grp = groups(counts, bm)
    layout = {"M": m, "bm": bm, "routed_rows": n_rows, "tiles": m // bm,
              "experts_touched": used}
    print(f"moe train layout (B{batch} x T{seq_len}): " + json.dumps(layout),
          flush=True)
    x, g, dy = rnd(m, d), rnd(m, f), rnd(m, d)
    wg, wu, wd = (rnd(e, d, f, scale=0.02), rnd(e, d, f, scale=0.02),
                  rnd(e, f, d, scale=0.02))
    rows = torch.arange(m, device=dev)
    res = {name: {} for name in GROUPED_KERNELS}

    # Forward: gmm_swiglu with gate and up, then the down gmm.
    h, gate, up = gm._gmm_swiglu(x, wg, wu, te, bm, gate_up=True)
    torch.cuda.synchronize()
    ref = gm.gmm_swiglu_plain(x.float(), wg.float(), wu.float(), te, bm,
                              gate_up=True)
    err = max(check_rel(f"gmm_swiglu[train].{k}", got, r, rows,
                        KERNEL_REL_TOL)
              for k, got, r in zip(("h", "gate", "up"), (h, gate, up), ref))
    del ref, gate, up

    def lib_swiglu():
        for ex, r0, c in grp:
            xe = x[r0:r0 + c]
            ge, ue = xe @ wg[ex], xe @ wu[ex]
            torch.nn.functional.silu(ge) * ue

    res["gmm_swiglu"]["train"] = timed(
        lambda: gm._gmm_swiglu(x, wg, wu, te, bm, gate_up=True),
        lambda: gm.gmm_swiglu_plain(x, wg, wu, te, bm, gate_up=True),
        lib_swiglu, 2 * (n_rows * d + 2 * used * d * f + 3 * n_rows * f),
        2 * 2 * n_rows * d * f, err, **layout, writes="h, gate, up")

    # The down gmm and the two dlhs gmms against rhs^T.
    def gmm_case(name, lhs, w, trans, n_in, n_out, lib):
        out = gm._gmm(lhs, w, te, bm, transpose_rhs=trans)
        torch.cuda.synchronize()
        ref = gm.gmm_plain(lhs.float(), w.float(), te, bm,
                           transpose_rhs=trans)
        err = check_rel(f"gmm[{name}]", out, ref, rows, KERNEL_REL_TOL)
        del ref, out
        res["gmm"][name] = timed(
            lambda: gm._gmm(lhs, w, te, bm, transpose_rhs=trans),
            lambda: gm.gmm_plain(lhs, w, te, bm, transpose_rhs=trans), lib,
            2 * (n_rows * n_in + used * n_in * n_out + n_rows * n_out),
            2 * n_rows * n_in * n_out, err, **layout,
            rhs="[E, N, K] read as rhs^T" if trans else "[E, K, N]")

    def lib_loop(lhs, w, trans):
        def run():
            for ex, r0, c in grp:
                lhs[r0:r0 + c] @ (w[ex].t() if trans else w[ex])
        return run

    gmm_case("train", h, wd, False, f, d, lib_loop(h, wd, False))
    gmm_case("dlhs_gate_up", g, wg, True, f, d, lib_loop(g, wg, True))
    gmm_case("dlhs_down", dy, wd, True, d, f, lib_loop(dy, wd, True))

    # tgmm at the gate/up shape (with the negative control) and at the down
    # shape; its library yardstick is one matmul per expert's real rows.
    def lib_tgmm(lhs, dout):
        def run():
            for _, r0, c in grp:
                torch.matmul(lhs[r0:r0 + c].t(), dout[r0:r0 + c])
        return run

    for name, lhs, dout, k_, n_ in (("gate_up", x, g, d, f),
                                    ("down", h, dy, f, d)):
        out, chk = tgmm_check(f"tgmm[{name}]", lhs, dout, te, e, bm,
                              control=name == "gate_up")
        del out
        res["tgmm"][name] = timed(
            lambda: gm.tgmm(lhs, dout, te, e, bm),
            lambda: gm.tgmm_plain(lhs, dout, te, e, bm), lib_tgmm(lhs, dout),
            2 * (n_rows * k_ + n_rows * n_ + e * k_ * n_),
            2 * n_rows * k_ * n_, chk["max_abs_err"], **layout,
            max_expert_rel=chk["max_expert_rel"],
            control_rel=chk.get("control", {}).get("rel"))
    del h, g, dy

    # An expert that no token picks: its block must be exactly zero.
    lay0, counts0 = routed_layout(cfg, n_tok, gen, dev, empty=3)
    assert counts0[3] == 0
    x0, g0 = rnd(lay0.m, d), rnd(lay0.m, f)
    out, chk = tgmm_check("tgmm[gate_up, expert 3 unrouted]", x0, g0,
                          lay0.tile_experts, e, lay0.bm, empty=(3,))
    res["tgmm"]["empty_expert"] = {
        "max_expert_rel": chk["max_expert_rel"],
        "exact_zero": chk["empty_experts_exact_zero"][3]}
    del out, x0, g0

    # The compute skip on a worst-case per-shard layout: 2 local experts
    # plus the sentinel group, about half the tiles real.
    te_s, vt, m_s, bm_s, counts_s = shard_layout(n_tok * cfg.moe_top_k, 2,
                                                 gen, dev)
    n_real = int(vt.item())
    rows_l = int(counts_s.sum())
    skip = {"M": m_s, "bm": bm_s, "tiles": m_s // bm_s, "valid_tiles": n_real,
            "local_rows": rows_l}
    print("shard layout: " + json.dumps(skip), flush=True)
    xs, gs = rnd(m_s, d), rnd(m_s, f)
    w2 = wg[:2]
    ys = gm.gmm(xs, w2, te_s, bm_s, vt)
    torch.cuda.synchronize()
    skipped_zero = not ys[n_real * bm_s:].any().item()
    ref = gm.gmm_plain(xs.float(), w2.float(), te_s, bm_s, vt)
    err = check_rel("gmm[skip]", ys, ref,
                    torch.arange(n_real * bm_s, device=dev), KERNEL_REL_TOL)
    print(f"  gmm[skip]: rows past valid_tiles exactly 0: {skipped_zero}",
          flush=True)
    assert skipped_zero, "gmm wrote nonzero rows past valid_tiles"
    del ys, ref
    grp_s = groups(counts_s, bm_s)
    res["gmm"]["skip"] = timed(
        lambda: gm.gmm(xs, w2, te_s, bm_s, vt),
        lambda: gm.gmm_plain(xs, w2, te_s, bm_s, vt),
        lambda: [xs[r0:r0 + c] @ w2[ex] for ex, r0, c in grp_s],
        2 * (rows_l * d + 2 * d * f + rows_l * f), 2 * rows_l * d * f, err,
        **skip, rows_past_valid_tiles_zero=skipped_zero)
    out, chk = tgmm_check("tgmm[skip]", xs, gs, te_s, 2, bm_s, vt)
    del out
    res["tgmm"]["skip"] = timed(
        lambda: gm.tgmm(xs, gs, te_s, 2, bm_s, vt),
        lambda: gm.tgmm_plain(xs, gs, te_s, 2, bm_s, vt),
        lambda: [torch.matmul(xs[r0:r0 + c].t(), gs[r0:r0 + c])
                 for _, r0, c in grp_s],
        2 * (rows_l * d + rows_l * f + 2 * d * f), 2 * rows_l * d * f,
        chk["max_abs_err"], **skip, max_expert_rel=chk["max_expert_rel"])
    for name, recs in res.items():
        for shape, rec in recs.items():
            if "ms" in rec:
                print_times(name, shape, rec)
    del x, xs, gs, wg, wu, wd, w2
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phase 4: flash attention kernels against their plain versions
# ---------------------------------------------------------------------------

def flash_bounds(b, h, t, d):
    """(bytes, FLOPs) each kernel must move and do at least, causal: each
    input read once, each output written once; the products over the
    t(t+1)/2 visible (query, key) pairs."""
    pairs = b * h * t * (t + 1) / 2
    tile = b * h * t * d * 2            # one bf16 [B, T, H, D] tensor
    row = b * h * t * 4                 # one f32 [B*H, T] statistic
    return {"flash_fwd": (4 * tile + row, 2 * 2 * d * pairs),
            "flash_dq": (5 * tile + 2 * row, 3 * 2 * d * pairs),
            "flash_dkv": (6 * tile + 2 * row, 4 * 2 * d * pairs)}


def flash_run(q, k, v, do, causal=True):
    """The three kernels as the backward chains them."""
    o, lse = at.flash_fwd(q, k, v, causal)
    delta = torch.einsum("bthd,bthd->bht", do.float(), o.float()).reshape(
        -1, q.shape[1]).contiguous()
    dq = at.flash_dq(q, k, v, do, lse, delta, causal)
    dk, dv = at.flash_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    return {"o": o, "lse": lse, "delta": delta, "dq": dq, "dk": dk, "dv": dv}


def row_rel_err(got, ref):
    """Per row (the last axis is head_dim): ||got - ref|| / ||ref||, the
    denominator floored at ``ROW_FLOOR`` x the RMS row norm of ``ref``."""
    got, ref = got.float(), ref.float()
    norm = ref.norm(dim=-1)
    floor = ROW_FLOOR * norm.square().mean().sqrt()
    return (got - ref).norm(dim=-1) / torch.maximum(norm, floor)


def whole_rel_err(got, ref) -> float:
    """max |got - ref| / max |ref| over the whole tensor."""
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max()).item()


def negative_controls(got, ref):
    """The check's readings on deliberately wrong outputs made from the
    kernels' own: dk and dv with every key row from 1500 on zeroed, o with
    every query row from 1024 on scaled by 0.7.  Each must fail."""
    faults = {}
    for key in ("dk", "dv"):
        bad = got[key].clone()
        bad[:, 1500:] = 0
        faults[f"{key} rows >= 1500 zeroed"] = (bad, ref[key])
    bad = got["o"].clone()
    bad[:, 1024:] *= 0.7
    faults["o rows >= 1024 x 0.7"] = (bad, ref["o"])
    readings = {name: {"max_row_rel": row_rel_err(g, r).max().item(),
                       "whole_tensor_rel": whole_rel_err(g, r)}
                for name, (g, r) in faults.items()}
    print("  negative controls (must fail): " + json.dumps(readings),
          flush=True)
    for name, reading in readings.items():
        assert reading["max_row_rel"] > FLASH_ROW_TOL, (
            f"the flash check passed a wrong output: {name}")


def flash_check(name, q, k, v, do, causal=True, chunk=8, controls=False):
    """Kernels against plain versions on the same inputs (lse and delta
    are the kernels', as in training), ``chunk`` heads at a time to bound
    the plain versions' f32 [B, H, T, T] scores.  Every query row of o and
    dq and every key row of dk and dv must agree within ``FLASH_ROW_TOL``
    (:func:`row_rel_err`).  Returns (max abs errors, max row errors)."""
    b, _, h, _ = q.shape
    out = flash_run(q, k, v, do, causal)
    err = {key: 0.0 for key in ("lse", *FLASH_OUTS)}
    rel = {key: 0.0 for key in FLASH_OUTS}
    worst = {}
    for bi in range(b):
        for h0 in range(0, h, chunk):
            sl = (slice(bi, bi + 1), slice(None), slice(h0, h0 + chunk))
            rows = slice(bi * h + h0, bi * h + h0 + chunk)
            qs, ks, vs, dos = (x[sl] for x in (q, k, v, do))
            lse, delta = out["lse"][rows], out["delta"][rows]
            o_p, lse_p = at.flash_fwd_plain(qs, ks, vs, causal)
            ref = {"o": o_p, "lse": lse_p,
                   "dq": at.flash_dq_plain(qs, ks, vs, dos, lse, delta,
                                           causal)}
            ref["dk"], ref["dv"] = at.flash_dkv_plain(qs, ks, vs, dos, lse,
                                                      delta, causal)
            got = {key: out[key][rows] if key == "lse" else out[key][sl]
                   for key in ref}
            for key, r in ref.items():
                g = got[key]
                assert torch.isfinite(g).all(), f"{name}: {key} not finite"
                err[key] = max(err[key],
                               (g.float() - r.float()).abs().max().item())
                if key == "lse":
                    continue
                rr = row_rel_err(g, r)              # [1, T, heads]
                i = int(rr.argmax())
                if rr.flatten()[i].item() > rel[key]:
                    rel[key] = rr.flatten()[i].item()
                    worst[key] = {"b": bi, "t": i // rr.shape[2],
                                  "h": h0 + i % rr.shape[2]}
            if controls and bi == 0 and h0 == 0:
                negative_controls(got, ref)
    print(f"  {name}: " + json.dumps({
        "max_row_rel": rel, "worst_row": worst, "max_abs_err": err,
        "tol": {"row_rel": FLASH_ROW_TOL, "row_floor": ROW_FLOOR,
                "lse_abs": LSE_ATOL}}), flush=True)
    for key in FLASH_OUTS:
        assert rel[key] <= FLASH_ROW_TOL, f"{name}: {key} disagrees"
    assert err["lse"] <= LSE_ATOL, f"{name}: lse disagrees"
    return err, rel


def fwd_bwd(attn, q, k, v, do):
    """One forward and backward of ``attn`` (gradients to q, k, v)."""
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

    def run():
        out = attn(qg, kg, vg)
        torch.autograd.grad(out, (qg, kg, vg), do)
    return run


def flash_phase(dev, seed: int):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(b, t, h, d):
        return torch.randn((b, t, h, d), generator=gen, device=dev).to(
            torch.bfloat16)

    b, t, h, d = FLASH_SHAPE
    q, k, v, do = (rnd(b, t, h, d) for _ in range(4))
    print(f"flash: B={b} T={t} H={h} D={d} causal bf16", flush=True)
    err, rel = flash_check("flash[pretrain]", q, k, v, do, chunk=PLAIN_HEADS,
                           controls=True)
    for name, shape, causal in (("flash[full,d128]", (1, 512, 2, 128), False),
                                ("flash[causal,d64]", (1, 512, 4, 64), True)):
        flash_check(name, *(rnd(*shape) for _ in range(4)), causal=causal)

    out = flash_run(q, k, v, do)
    lse, delta = out["lse"], out["delta"]
    del out
    kernel_fns = {
        "flash_fwd": lambda: at.flash_fwd(q, k, v),
        "flash_dq": lambda: at.flash_dq(q, k, v, do, lse, delta),
        "flash_dkv": lambda: at.flash_dkv(q, k, v, do, lse, delta),
    }
    ms = {name: time_ms(fn, 10) for name, fn in kernel_fns.items()}

    # The plain versions on the same inputs, PLAIN_HEADS heads a call.
    parts = [(*(x[bi:bi + 1, :, h0:h0 + PLAIN_HEADS] for x in (q, k, v, do)),
              lse[bi * h + h0:bi * h + h0 + PLAIN_HEADS],
              delta[bi * h + h0:bi * h + h0 + PLAIN_HEADS])
             for bi in range(b) for h0 in range(0, h, PLAIN_HEADS)]

    def plain_over_parts(fn, n_args):
        def run():
            for part in parts:
                fn(*part[:n_args])
        return run

    plain_ms = {name: time_ms(plain_over_parts(fn, n), 2, warmup=1)
                for name, fn, n in (("flash_fwd", at.flash_fwd_plain, 3),
                                    ("flash_dq", at.flash_dq_plain, 6),
                                    ("flash_dkv", at.flash_dkv_plain, 6))}

    # Library yardstick: SDPA on contiguous [B, H, T, D] copies (its own
    # layout): fwd, bwd alone (one call gives dq, dk and dv), fwd+bwd.
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))

    def sdpa(a, bb, c):
        return torch.nn.functional.scaled_dot_product_attention(
            a, bb, c, is_causal=True)

    sdpa_fwd = time_ms(lambda: sdpa(qt, kt, vt), 10)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    o_sdpa = sdpa(qg, kg, vg)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(
        o_sdpa, (qg, kg, vg), dot, retain_graph=True), 10)
    del o_sdpa, qg, kg, vg
    sdpa_fwd_bwd = time_ms(fwd_bwd(sdpa, qt, kt, vt, dot), 5)
    flash_fwd_bwd = time_ms(fwd_bwd(at.flash_attention, q, k, v, do), 5)

    bounds = flash_bounds(b, h, t, d)
    results = {}
    for name in FLASH_KERNELS:
        b_ms, b_by = bound(*bounds[name])
        keys = {"flash_fwd": ("o",), "flash_dq": ("dq",),
                "flash_dkv": ("dk", "dv")}[name]
        results[name] = {
            "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": sdpa_fwd if name == "flash_fwd" else None,
            "max_abs_err": max(err[key] for key in keys),
            "max_row_rel_err": max(rel[key] for key in keys),
            "shape": f"B{b} T{t} H{h} D{d} causal",
            "plain_calls": f"{len(parts)} x B1 H{PLAIN_HEADS}",
            "GFLOP": bounds[name][1] / 1e9,
        }
        print(f"  {name}: {ms[name]:.4f} ms kernel ({bounds[name][1] / 1e9:.1f}"
              f" GFLOP, bound {b_ms:.4f} ms by {b_by}), {plain_ms[name]:.4f} "
              f"ms plain ({len(parts)} calls)", flush=True)
    for name in ("flash_dq", "flash_dkv"):
        results[name]["sdpa_bwd_dq_dk_dv_ms"] = sdpa_bwd
    sdpa_line = {"sdpa_fwd_ms": sdpa_fwd, "sdpa_bwd_ms": sdpa_bwd,
                 "sdpa_fwd_bwd_ms": sdpa_fwd_bwd,
                 "flash_fwd_bwd_ms": flash_fwd_bwd}
    print("  library (SDPA, timed only): " + json.dumps(sdpa_line),
          flush=True)
    del q, k, v, do, qt, kt, vt, dot, parts, lse, delta
    torch.cuda.empty_cache()

    # Kernel fwd+bwd against the plain attention path (attention_reference
    # under autograd, what the model runs below the "auto" gate), in turns.
    sweep = []
    for t_ in SWEEP_T:
        q, k, v, do = (rnd(1, t_, h, d) for _ in range(4))
        plain = fwd_bwd(attention_reference, q, k, v, do)
        kern = fwd_bwd(at.flash_attention, q, k, v, do)
        p1, k1, k2, p2 = (time_ms(plain, 3), time_ms(kern, 5),
                          time_ms(kern, 5), time_ms(plain, 3))
        sweep.append({"T": t_, "kernel_ms": (k1 + k2) / 2,
                      "plain_ms": (p1 + p2) / 2, "turns": [p1, k1, k2, p2]})
        del q, k, v, do
        torch.cuda.empty_cache()
    print(f"  fwd+bwd sweep (B1 H{h} D{d} causal): " + json.dumps(sweep),
          flush=True)
    return results


# ---------------------------------------------------------------------------
# Phase 5: serve through the replica
# ---------------------------------------------------------------------------

SERVE_CONFIG = ServeConfig(slots=8, page_size=16, max_len=256,
                           prefill_buckets=(16, 32, 64, 128))


def serve_requests(cfg: LlamaConfig, seed: int):
    """The serve phase's 8 requests (12-120 prompt tokens) from ``seed``."""
    rng = np.random.default_rng(seed)
    lens = [120, 12] + [int(n) for n in rng.integers(12, 121, 6)]
    return [Request(id=f"r{i}",
                    tokens=[int(t) for t in rng.integers(1, cfg.vocab_size, n)],
                    max_new_tokens=16) for i, n in enumerate(lens)]


def prefill_logits(model, cfg: LlamaConfig, prompt, dev,
                   page_size: int = SERVE_CONFIG.page_size) -> torch.Tensor:
    """The last-position logits of one paged prefill of the first 100
    tokens of ``prompt`` in the 128-token bucket, on a fresh cache."""
    plen, bucket = 100, 128
    toks = torch.zeros((1, bucket), dtype=torch.long, device=dev)
    toks[0, :plen] = torch.as_tensor(prompt[:plen], device=dev)
    rows = torch.zeros(bucket, dtype=torch.long, device=dev)
    rows[:plen] = page_size + torch.arange(plen, device=dev)
    cache = init_paged_cache(cfg, 1 + bucket // page_size, page_size, dev)
    return paged_prefill(model, toks, cache, rows, plen, cfg)[0]


def serve_phase(cfg: LlamaConfig, dev, seed: int):
    scfg = SERVE_CONFIG
    backend = LlamaBackend(cfg, seed=seed, device=dev)
    reqs = serve_requests(cfg, seed)
    lens = [len(r.tokens) for r in reqs]

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
    lk = prefill_logits(backend.model, cfg, reqs[0].tokens, dev)
    with plain_grouped_kernels():
        lp = prefill_logits(backend.model, cfg, reqs[0].tokens, dev)
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
# Phase 6: where a decode step's and a prefill's device time goes
# ---------------------------------------------------------------------------

KERNEL_GROUPS = (
    ("flash_fwd", lambda n: "flash_fwd_kernel" in n),
    ("flash_dq", lambda n: "flash_dq_kernel" in n),
    ("flash_dkv", lambda n: "flash_dkv_kernel" in n),
    ("tgmm", lambda n: "tgmm_kernel" in n),
    # gmm_kernel<BM, BN, WARPS_M, WARPS_N, SWIGLU, TRANS>
    ("gmm_swiglu", lambda n: re.search(r"gmm_kernel<\d+, \d+, \d+, \d+, "
                                       r"true", n) is not None),
    ("gmm", lambda n: "gmm_kernel" in n),
    ("library gemm", lambda n: any(w in n for w in (
        "gemm", "cutlass", "xmma", "nvjet", "cublas", "sm90_"))),
    ("gather/scatter", lambda n: any(w in n for w in ("index", "gather",
                                                       "scatter"))),
    ("softmax/reduce", lambda n: "softmax" in n or "reduce" in n.lower()),
    ("optimizer (foreach)", lambda n: "multi_tensor" in n
     or "foreach" in n.lower()),
    ("elementwise/copy", lambda n: True),
)


def profile_calls(name, fn, n):
    """torch.profiler over ``n`` calls of ``fn`` (after one unprofiled
    call): wall ms per call, device-busy ms (the sum of kernel times on the
    one stream), the idle share, and kernel time by group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    # Device events, without the GPU spans of user annotations (AdamW's
    # "Optimizer.step#AdamW.step"), which would count its kernels twice.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
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


def profile_phase(backend, scfg, steps: int = 5):
    """Decode steps of the full slot batch (every slot live at position
    100) and prefills of one 128-token prompt, through the backend the
    engine served with."""
    ps, pps = scfg.page_size, scfg.pages_per_slot()
    tables = (1 + np.arange(scfg.slots)[:, None] * pps
              + np.arange(pps)[None, :]).astype(np.int32)
    tokens = np.arange(1, scfg.slots + 1, dtype=np.int32)
    positions = np.full(scfg.slots, 100, np.int32)
    prompt = np.arange(1, 129, dtype=np.int32)[None]
    rows = (tables[0, np.arange(128) // ps] * ps
            + np.arange(128) % ps).astype(np.int32)
    profile_calls("decode", lambda: backend.decode(tokens, positions, tables),
                  steps)
    profile_calls("prefill", lambda: backend.prefill(prompt, rows, 128), 2)


# ---------------------------------------------------------------------------
# Phases 7 and 9: one training step, kernel path against plain path
# ---------------------------------------------------------------------------

@contextmanager
def plain_flash():
    """Route flash attention through the plain versions (comparison only)."""
    with mock.patch.object(at, "flash_fwd", at.flash_fwd_plain), \
            mock.patch.object(at, "flash_dq", at.flash_dq_plain), \
            mock.patch.object(at, "flash_dkv", at.flash_dkv_plain):
        yield


def train_check(label: str, cfg: LlamaConfig, dev, seed: int, plain,
                counters, batch: int = 1, seq_len: int = CHECK_SEQ):
    """One loss and backward of ``cfg`` through the kernels and again with
    ``plain()`` swapping them for their plain versions, from one init and
    one batch: the loss within ``TRAIN_LOSS_RTOL`` relative, every
    parameter gradient within ``TRAIN_GRAD_RTOL`` relative norm.  The
    launch ``counters`` must move on the kernel side and stay on the
    plain side."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = llama_init(cfg, gen, dev, requires_grad=True)
    tokens = synthetic_tokens(seed, batch, seq_len, cfg.vocab_size, dev)
    runs = {}
    for side in ("kernel", "plain"):
        before = [c.launches for c in counters]
        with contextlib.nullcontext() if side == "kernel" else plain():
            loss = llama_loss(model, tokens, cfg)
            loss.backward()
        moved = [c.launches - b for c, b in zip(counters, before)]
        if side == "kernel":
            assert all(moved), f"kernel path not taken: {moved}"
        else:
            assert not any(moved), f"plain path launched kernels: {moved}"
        runs[side] = (loss.item(), {n: p.grad.float().clone()
                                    for n, p in model.named_parameters()})
        model.zero_grad(set_to_none=True)
    (lk, gk), (lp, gp) = runs["kernel"], runs["plain"]
    assert np.isfinite(lk) and np.isfinite(lp)
    rel = {n: ((gk[n] - gp[n]).norm() / gp[n].norm()).item() for n in gp}
    worst = max(rel, key=rel.get)
    out = {"loss_kernel": lk, "loss_plain": lp,
           "loss_rel_err": abs(lk - lp) / abs(lp),
           "grad_rel_err_max": rel[worst], "grad_rel_err_worst": worst,
           "grad_rel_err": rel, "tol": {"loss": TRAIN_LOSS_RTOL,
                                        "grad": TRAIN_GRAD_RTOL}}
    print(f"{label} ({cfg.n_layers} layers, B{batch} T{seq_len}) kernel vs "
          f"plain: " + json.dumps(out), flush=True)
    assert abs(lk - lp) <= TRAIN_LOSS_RTOL * abs(lp), "losses disagree"
    assert rel[worst] <= TRAIN_GRAD_RTOL, f"gradient {worst} disagrees"
    del model, runs, gk, gp
    gc.collect()
    torch.cuda.empty_cache()


@contextmanager
def plain_grouped_kernels():
    """Route the grouped-matmul kernels, forward and backward, through their
    plain versions (comparison only)."""
    with mock.patch.object(gm, "_gmm", gm.gmm_plain), \
            mock.patch.object(gm, "_gmm_swiglu", gm.gmm_swiglu_plain), \
            mock.patch.object(gm, "tgmm", gm.tgmm_plain):
        yield


def train_check_phase(dev, seed: int):
    train_check("train check", llama2_7b(n_layers=2), dev, seed, plain_flash,
                (at.flash_fwd,))


def moe_train_check_phase(cfg: LlamaConfig, dev, seed: int,
                          batch: int = MOE_CHECK["batch"],
                          seq_len: int = MOE_CHECK["seq_len"]):
    train_check("moe train check", cfg, dev, seed, plain_grouped_kernels,
                (gm.gmm, gm.gmm_swiglu, gm.tgmm), batch, seq_len)


# ---------------------------------------------------------------------------
# Phases 8 and 10: pretrain steps through the loop llama_pretrain.main runs
# ---------------------------------------------------------------------------

def train_run(label: str, cfg: LlamaConfig, dev, seed: int, steps: int,
              batch: int, seq_len: int, want: dict):
    """``llama_pretrain.train`` of ``cfg`` for ``steps`` AdamW steps (lr
    3e-4, weight decay 0.1, clip 1.0) with the launch counters of ``want``
    zeroed just before and read just after: each must equal its ``want``.
    Every loss finite, the last below the first.  Then steps ``steps + 1``
    and ``steps + 2`` of the same loop (same optimizer state and tokens),
    the second under the profiler.  Returns the launches."""
    counters = {name: (getattr(at, name) if name.startswith("flash")
                       else getattr(gm, name)) for name in want}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    res = llama_pretrain.train(cfg, steps=steps, batch_size=batch,
                               seq_len=seq_len, lr=3e-4, device=dev,
                               seed=seed)
    launches = {name: c.launches for name, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    p50 = statistics.median(res.step_s)
    out = {"layers": cfg.n_layers, "batch": batch, "seq_len": seq_len,
           "steps": steps, "losses": res.losses,
           "step_ms": [x * 1e3 for x in res.step_s], "step_ms_p50": p50 * 1e3,
           "tokens_per_s_p50": batch * seq_len / p50,
           "tokens_per_s_run": res.tokens_per_s,
           "peak_mem_gb": peak_gb, "launches": launches,
           "params": sum(p.numel() for p in res.model.parameters())}
    print(f"{label}: " + json.dumps(out), flush=True)
    assert launches == want, (launches, want)
    assert all(np.isfinite(x) for x in res.losses), res.losses
    assert res.losses[-1] < res.losses[0], res.losses
    assert peak_gb < 80, f"peak {peak_gb} GB"

    more = iter(range(steps, steps + 2))
    profile_calls(f"{label} step", lambda: res.step(next(more)), 1)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def train_phase(dev, seed: int, steps: int = 5, batch: int = 4,
                seq_len: int = 4096):
    """The dense Llama-2-7B-width model at 8 layers: flash_fwd twice per
    layer per step (forward and remat recompute), dq and dkv once."""
    cfg = llama2_7b(n_layers=8)
    want = {name: n * cfg.n_layers * steps for name, n in (
        ("flash_fwd", 2), ("flash_dq", 1), ("flash_dkv", 1))}
    return train_run("train", cfg, dev, seed, steps, batch, seq_len, want)


def moe_train_phase(cfg: LlamaConfig, dev, seed: int, steps: int = 5,
                    batch: int = MOE_TRAIN["batch"],
                    seq_len: int = MOE_TRAIN["seq_len"]):
    """The Mixtral-width MoE model: ``MOE_LAUNCHES_PER_LAYER`` launches per
    layer per step of each grouped-matmul and flash kernel."""
    want = {name: n * cfg.n_layers * steps
            for name, n in MOE_LAUNCHES_PER_LAYER.items()}
    return train_run("moe train", cfg, dev, seed, steps, batch, seq_len, want)


def entry_phase():
    """The CLI as a user calls it: no --device, so CUDA by default; dense,
    then MoE (the tiny preset is f32, so einsum as asked)."""
    for argv in (["--preset", "tiny", "--steps", "2"],
                 ["--preset", "tiny", "--experts", "4", "--moe-dispatch",
                  "einsum", "--steps", "2"]):
        t0 = time.perf_counter()
        rc = llama_pretrain.main(argv)
        assert rc == 0, rc
        print(f"entry point: llama_pretrain.main {' '.join(argv)}, rc {rc}, "
              f"{time.perf_counter() - t0:.3f} s", flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def kernels_line(results, flash, paths):
    """One entry per kernel; ``launches`` is the MoE train run's (this
    slice's main path, which launches all six) and the grouped kernels'
    top-level times are at its layout; ``launches_by_path`` gives each
    path's own run."""
    replaces = {
        "gmm": (f"{REF_FILE}:132 (_gmm_single_k_kernel, decode); "
                f"{REF_FILE}:78 (_gmm_kernel, prefill); "
                f"{REF_FILE}:138 (_gmm_single_k_skip_kernel)"),
        "gmm_swiglu": f"{REF_FILE}:227 (_gmm2_kernel)",
        "tgmm": TGMM_SOURCE_LINES,
        "flash_fwd": f"{FLASH_REF}:62 (_fwd_kernel)",
        "flash_dq": f"{FLASH_REF}:174 (_dq_kernel)",
        "flash_dkv": f"{FLASH_REF}:208 (_dkv_kernel)",
    }
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")
    main_path = paths["moe_train"]

    def common(name, source):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces[name], "launches": main_path[name],
                "launches_by_path": {p: n[name] for p, n in paths.items()
                                     if name in n}}

    entries = []
    # The top-level numbers are at the main path's shape; the other shapes
    # (decode, prefill, dlhs, skip, ...) sit beside them under their names.
    for name, main_shape in (("gmm_swiglu", "train"), ("gmm", "train"),
                             ("tgmm", "gate_up")):
        shapes = results[name]
        entries.append({
            **common(name, SOURCE),
            **{k: shapes[main_shape][k] for k in keys},
            "max_abs_err": max(r["max_abs_err"] for r in shapes.values()
                               if "max_abs_err" in r),
            "shape": main_shape,
            **{shape: rec for shape, rec in shapes.items()
               if shape != main_shape},
        })
    for name in FLASH_KERNELS:
        entries.append({**common(name, FLASH_SOURCE), **flash[name]})
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
    for name, recs in moe_kernel_phase(cfg, dev, args.seed,
                                       MOE_TRAIN["batch"],
                                       MOE_TRAIN["seq_len"]).items():
        results.setdefault(name, {}).update(recs)
    flash = flash_phase(dev, args.seed)
    paths = {}
    paths["serve"], backend, scfg = serve_phase(cfg, dev, args.seed)
    profile_phase(backend, scfg)
    del backend
    gc.collect()
    torch.cuda.empty_cache()
    train_check_phase(dev, args.seed)
    paths["dense_train"] = train_phase(dev, args.seed)
    moe_train_check_phase(mixtral_8x7b_train(MOE_CHECK["layers"]), dev,
                          args.seed)
    paths["moe_train"] = moe_train_phase(
        mixtral_8x7b_train(MOE_TRAIN["layers"]), dev, args.seed)
    entry_phase()
    print(card_line())
    print(kernels_line(results, flash, paths))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
