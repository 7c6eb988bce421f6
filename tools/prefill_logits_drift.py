#!/usr/bin/env python3
"""Attribute the gap that ``chip_smoke.py``'s serve prefill check reads.

That check takes one prefill's logits at Mixtral-8x7B widths (8 of 32
layers, bf16, a 100-token prompt in the 128-token bucket) through the
grouped-matmul kernels and through their plain versions, and requires
max |kernel - plain| <= 5e-2 * max |plain|.  This script takes the same
logits (``chip_smoke.prefill_logits``, same model init and prompt per seed)
on one CUDA card through four forms of the grouped forward (``gmm`` and
``gmm_swiglu``):

  kernel          this checkout's CUDA kernels, run twice (``kernel_again``
                  must be bit-identical: the rest of the forward is
                  deterministic)
  plain           this checkout's plain versions: one f32 matmul per run of
                  an expert's tiles, one rounding to bf16
  plain_per_tile  the per-tile plain form: each bm-row tile against a
                  gathered f32 copy of its expert's weights (``torch.bmm``),
                  one rounding to bf16
  kernel_ref      with ``--ref-source``: the CUDA kernels compiled from
                  another ``grouped_matmul.cu`` whose C interface is the
                  h-only one (no valid_tiles, gate/up or transposed read)

It also takes the inputs of the first ``gmm_swiglu`` and the first ``gmm``
call of the kernel run and compares the four forms on them directly.  For
each seed it prints one JSON line: for each pair (a, b) of logits, max
|a - b| / max |b| beside the check's limit and whether the argmaxes agree;
for the single calls, the same ratio, the number of elements that differ
and the worst elementwise |a - b| / |b|.

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
    gmm_swiglu wrappers over its h-only C interface."""
    so = workdir / "libkctpu_gmm_ref.so"
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                      str(source), "-o", str(so)]])
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kctpu_gmm.argtypes = [p] * 4 + [i] * 4 + [p]
    lib.kctpu_gmm_swiglu.argtypes = [p] * 5 + [i] * 4 + [p]
    lib.kctpu_gmm.restype = lib.kctpu_gmm_swiglu.restype = i

    def launch(fn, lhs, weights, te, bm):
        gm._check(lhs, weights, te, bm)
        m, k = lhs.shape
        out = torch.empty((m, weights[0].shape[2]), dtype=lhs.dtype,
                          device=lhs.device)
        code = fn(lhs.data_ptr(), *(w.data_ptr() for w in weights),
                  te.data_ptr(), out.data_ptr(), m, k, out.shape[1], bm,
                  _build.stream(lhs))
        if code:
            raise RuntimeError(f"reference kernel failed: CUDA error {code}")
        return out

    def gmm_ref(lhs, rhs, te, bm, valid_tiles=None, transpose_rhs=False):
        assert valid_tiles is None and not transpose_rhs
        return launch(lib.kctpu_gmm, lhs, (rhs,), te, bm)

    def gmm_swiglu_ref(lhs, rhs_g, rhs_u, te, bm, gate_up=False):
        assert not gate_up
        return launch(lib.kctpu_gmm_swiglu, lhs, (rhs_g, rhs_u), te, bm)

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


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item() / (
        b.float().abs().max().item())


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
                    help="a grouped_matmul.cu with the h-only C interface")
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
            out = {"seed": seed, "limit": cs.LOGITS_REL_TOL, "logits": {
                f"{a} vs {b}": {"rel": rel(logits[a], logits[b]),
                                "argmax_equal": bool(logits[a].argmax()
                                                     == logits[b].argmax())}
                for a, b in LOGIT_PAIRS if a in logits}}
            for call, idx in (("gmm_swiglu", 1), ("gmm", 0)):
                outs = {name: fns[idx](*first[call])
                        for name, fns in forms.items()}
                out[f"first_{call}"] = {
                    f"{a} vs {b}": call_diff(outs[a], outs[b])
                    for a, b in LOGIT_PAIRS if a in outs}
            print(json.dumps(out), flush=True)
            del model, first, logits, outs
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
