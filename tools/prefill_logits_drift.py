#!/usr/bin/env python3
"""Measure the noise floor of ``chip_smoke.py``'s serve prefill check.

That check takes one prefill at Mixtral-8x7B widths (8 of 32 layers,
bf16, a 100-token prompt in the 128-token bucket) layer by layer: the
plain path's input to each layer's expert FFN goes through the
grouped-matmul kernels and through their plain versions, and each layer
must agree within max |kernel - plain| <= 2e-2 * max |plain|.  This script
takes the same prefill (``chip_smoke.prefill_logits``, same model init and
prompt per seed) on one CUDA card through four forms of the grouped
forward (``gmm`` and ``gmm_swiglu``):

  kernel          this checkout's CUDA kernels, run twice (``kernel_again``
                  must be bit-identical: the rest of the forward is
                  deterministic)
  plain           this checkout's plain versions: one f32 matmul per run of
                  an expert's tiles, one rounding to bf16
  plain_per_tile  the per-tile plain form: each bm-row tile against a
                  gathered f32 copy of its expert's weights (``torch.bmm``),
                  one rounding to bf16
  kernel_ref      with ``--ref-source``: the CUDA kernels compiled from
                  another ``grouped_matmul.cu``, through its
                  ``kctpu_gmm_wgmma`` / ``kctpu_gmm_swiglu_wgmma`` (the
                  prefill's bm is 256)

For each seed it prints one JSON line.  ``per_layer``: for each pair
(a, b), max |ffn_a - ffn_b| / max |ffn_b| in each layer, on the plain
path's inputs (``chip_smoke.layer_rel_errs``); "plain vs plain_per_tile"
is the check's noise floor, which must sit at most half of its limit.
``logits``: the same ratio of the 8-layer logits and whether the argmaxes
agree.  ``first_gmm_swiglu``/``first_gmm``: the forms on the inputs of the
first call of the kernel run, with the number of elements that differ and
the worst elementwise |a - b| / |b|.

    python3 tools/prefill_logits_drift.py [--seeds 0,1,2,3] \\
        [--ref-source path/to/grouped_matmul.cu]
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import json
import sys
import tempfile
from pathlib import Path
from unittest import mock

import torch
from torch.nn import functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from kubeflow_controller_tpu_torch.models.llama import llama_init  # noqa: E402
from kubeflow_controller_tpu_torch.ops import _build  # noqa: E402
from kubeflow_controller_tpu_torch.ops import grouped_matmul as gm  # noqa: E402

LOGIT_PAIRS = (("kernel", "plain"), ("kernel", "plain_per_tile"),
               ("plain", "plain_per_tile"), ("kernel_again", "kernel"),
               ("kernel_ref", "kernel"))


def gmm_per_tile(lhs, rhs, tile_experts, bm, valid_tiles=None,
                 transpose_rhs=False):
    assert valid_tiles is None and not transpose_rhs
    m, k = lhs.shape
    tiles = lhs.reshape(m // bm, bm, k).float()
    return torch.bmm(tiles, rhs[tile_experts.long()].float()).reshape(
        m, -1).to(lhs.dtype)


def gmm_swiglu_per_tile(lhs, rhs_g, rhs_u, tile_experts, bm, gate_up=False):
    assert not gate_up
    m, k = lhs.shape
    tiles = lhs.reshape(m // bm, bm, k).float()
    te = tile_experts.long()
    gate = torch.bmm(tiles, rhs_g[te].float())
    up = torch.bmm(tiles, rhs_u[te].float())
    return (F.silu(gate) * up).reshape(m, -1).to(lhs.dtype)


def load_ref(source: Path, workdir: Path):
    """Compile ``source`` alone into a shared library and return gmm /
    gmm_swiglu wrappers over its wgmma entries (bm >= 64)."""
    so = workdir / "libkctpu_gmm_ref.so"
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                      str(source), "-o", str(so)]])
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kctpu_gmm_wgmma.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.kctpu_gmm_swiglu_wgmma.argtypes = [p] * 7 + [i] * 5 + [p]
    lib.kctpu_gmm_wgmma.restype = lib.kctpu_gmm_swiglu_wgmma.restype = i

    def run(what, code):
        if code:
            raise RuntimeError(f"reference {what} failed: CUDA error {code}")

    def out_like(lhs, n):
        return torch.empty((lhs.shape[0], n), dtype=lhs.dtype,
                           device=lhs.device)

    def gmm_ref(lhs, rhs, te, bm, valid_tiles=None, transpose_rhs=False):
        assert valid_tiles is None and not transpose_rhs
        assert bm >= gm.WGMMA_MIN_BM, bm
        gm._check(lhs, (rhs,), te, bm)
        (m, k), n = lhs.shape, rhs.shape[2]
        out = out_like(lhs, n)
        run("gmm", lib.kctpu_gmm_wgmma(
            lhs.data_ptr(), rhs.data_ptr(), te.data_ptr(), None,
            out.data_ptr(), m, k, n, bm, rhs.shape[0], 0,
            _build.stream(lhs)))
        return out

    def gmm_swiglu_ref(lhs, rhs_g, rhs_u, te, bm, gate_up=False):
        assert not gate_up
        assert bm >= gm.WGMMA_MIN_BM, bm
        gm._check(lhs, (rhs_g, rhs_u), te, bm)
        (m, k), n = lhs.shape, rhs_g.shape[2]
        h = out_like(lhs, n)
        run("gmm_swiglu", lib.kctpu_gmm_swiglu_wgmma(
            lhs.data_ptr(), rhs_g.data_ptr(), rhs_u.data_ptr(), te.data_ptr(),
            h.data_ptr(), None, None, m, k, n, bm, rhs_g.shape[0],
            _build.stream(lhs)))
        return h

    return gmm_ref, gmm_swiglu_ref


@contextlib.contextmanager
def routed(gmm_fn, gmm_swiglu_fn):
    with mock.patch.object(gm, "_gmm", gmm_fn), \
            mock.patch.object(gm, "_gmm_swiglu", gmm_swiglu_fn):
        yield


@contextlib.contextmanager
def first_calls(record):
    """Keep the arguments of the first gmm and gmm_swiglu call."""
    real_gmm, real_swiglu = gm._gmm, gm._gmm_swiglu

    def gmm_rec(*a, **kw):
        record.setdefault("gmm", a)
        return real_gmm(*a, **kw)

    def swiglu_rec(*a, **kw):
        record.setdefault("gmm_swiglu", a)
        return real_swiglu(*a, **kw)

    with routed(gmm_rec, swiglu_rec):
        yield


rel = cs.rel_max


def call_diff(a: torch.Tensor, b: torch.Tensor) -> dict:
    a, b = a.float(), b.float()
    nz = b != 0
    return {"rel": rel(a, b), "n_differ": int((a != b).sum()),
            "n": b.numel(),
            "worst_elem_rel": ((a - b).abs()[nz] / b.abs()[nz]).max().item()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--ref-source", type=Path, default=None,
                    help="another grouped_matmul.cu (same C interface)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prefill_logits_drift: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cfg = cs.mixtral_8x7b()
    print(cs.card_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        forms = {"kernel": (gm._gmm, gm._gmm_swiglu),
                 "kernel_again": (gm._gmm, gm._gmm_swiglu),
                 "plain": (gm.gmm_plain, gm.gmm_swiglu_plain),
                 "plain_per_tile": (gmm_per_tile, gmm_swiglu_per_tile)}
        if args.ref_source is not None:
            forms["kernel_ref"] = load_ref(args.ref_source, Path(tmp))
        for seed in (int(s) for s in args.seeds.split(",")):
            gen = torch.Generator(device=dev).manual_seed(seed)
            model = llama_init(cfg, gen, dev)
            prompt = cs.serve_requests(cfg, seed)[0].tokens
            first, logits = {}, {}
            for name, fns in forms.items():
                with routed(*fns), (first_calls(first) if name == "kernel"
                                    else contextlib.nullcontext()):
                    logits[name] = cs.prefill_logits(model, cfg, prompt, dev)
            calls, _ = cs.ffn_layer_inputs(model, cfg, prompt, dev)
            pairs = [(a, b) for a, b in LOGIT_PAIRS if a in forms]
            per_layer = {f"{a} vs {b}": cs.layer_rel_errs(
                calls, lambda a=a: routed(*forms[a]),
                lambda b=b: routed(*forms[b])) for a, b in pairs}
            floor = max(per_layer["plain vs plain_per_tile"])
            out = {"seed": seed, "per_layer_limit": cs.LAYER_REL_TOL,
                   "floor": floor,
                   "floor_at_most_half_the_limit":
                       floor <= cs.LAYER_REL_TOL / 2,
                   "per_layer": per_layer, "logits": {
                       f"{a} vs {b}": {"rel": rel(logits[a], logits[b]),
                                       "argmax_equal": bool(
                                           logits[a].argmax()
                                           == logits[b].argmax())}
                       for a, b in pairs}}
            for call, idx in (("gmm_swiglu", 1), ("gmm", 0)):
                outs = {name: fns[idx](*first[call])
                        for name, fns in forms.items()}
                out[f"first_{call}"] = {
                    f"{a} vs {b}": call_diff(outs[a], outs[b])
                    for a, b in pairs}
            print(json.dumps(out), flush=True)
            del model, first, logits, outs, calls
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
