#!/usr/bin/env python3
"""Time variants of the swap-AB decode kernels against each other on one card.

Each variant is ``csrc/grouped_matmul.cu`` with a few lines replaced
(``VARIANTS``), compiled alone with ``_build.NVCC_FLAGS`` into a library
of its own and loaded with ``ctypes``; the grouped wrappers run through
it (``_build._LIBRARY``).  Each variant first passes ``chip_smoke.py``'s
ragged checks and, at the layouts below, ``gmm_swiglu`` and ``gmm``
against their plain versions (2e-2 of max on the rows the combine reads).
Then both kernels are timed at each layout, the variants in turns (order
forward, reversed, forward, reversed; 20 calls each), beside the
per-expert ``torch.matmul`` loop.  The layouts are ``chip_smoke.py``'s
(same seed, same draws): decode (8 tokens, bm 16), decode with expert
E - 1 routed and unrouted, and the 16-token prefill bucket (bm 32).

    python3 tools/swapab_variants.py [--variants final,no_merge,...]

Prints the card line, each variant's swap-AB kernels' ptxas registers
and spills, and one JSON line per (layout, kernel): ms per variant, the
library loop's ms, and TB/s over the weights of the experts read (those
touched, and E - 1 where the clamped tail tiles read it).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from kubeflow_controller_tpu_torch.ops import _build  # noqa: E402
from kubeflow_controller_tpu_torch.ops import grouped_matmul as gm  # noqa: E402

_NO_MERGE = ("return launch_swapab<64, false, TRANS>(",
             "return launch_swapab_tiles<false, TRANS>(")
_SWIGLU = "return launch_swapab_tiles<true, false>("
_NC = ("constexpr int SA_NC = 2;", "constexpr int SA_NC = 1;")
_BUDGETS = (("constexpr int SA_GMM_BUDGET = 72 * 1024;",
             "constexpr int SA_GMM_BUDGET = 40 * 1024;"),
            ("constexpr int SA_SWIGLU_BUDGET = 102 * 1024;",
             "constexpr int SA_SWIGLU_BUDGET = 72 * 1024;"))
# name: the (old, new) line replacements that make it.
VARIANTS = {
    "final": (),
    # gmm one tile a block at every bm, as gmm_swiglu.
    "no_merge": (_NO_MERGE,),
    # gmm_swiglu takes up to 64 / bm tiles of a run too (wgmma N 64).
    "swiglu_merge": ((_SWIGLU, "return (bm < 8 ? launch_swapab_tiles<true, "
                      "false> : launch_swapab<64, true, false>)("),),
    # 64-column blocks, one weight box a matrix a stage, rings of 40 and
    # 72 KB (5-6 and 3 blocks an SM).
    "cols64": (_NC, *_BUDGETS),
    # both: the swap-AB kernel as first written.
    "cols64_no_merge": (_NC, *_BUDGETS, _NO_MERGE),
}
CALLS = 20


def build(names):
    """{name: KernelLibrary} of the variants, compiled in parallel."""
    text = (_build.CSRC_DIR / "grouped_matmul.cu").read_text()
    tmp = Path(tempfile.mkdtemp())
    procs = {}
    for name in names:
        src = text
        for old, new in VARIANTS[name]:
            assert src.count(old) == 1, (name, old)
            src = src.replace(old, new)
        path = tmp / f"{name}.cu"
        path.write_text(src)
        so = tmp / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
             "-shared", str(path), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: build failed\n{log}")
        regs = {k: v for k, v in cs.ptxas_report(log).items()
                if "swapab" in k}
        print(f"{name}: ptxas " + json.dumps(regs), flush=True)
        assert all(r[1] == 0 and r[2] == 0 for r in regs.values()), name
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in _build._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
        libs[name] = _build.KernelLibrary(lib, so, 0.0, log, _build.COMPILED)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    names = ap.parse_args(argv).variants.split(",")
    if not torch.cuda.is_available():
        print("swapab_variants: needs a CUDA card", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    libs = build(names)
    dev = torch.device("cuda", 0)
    for name, lib in libs.items():
        _build._LIBRARY = lib
        print(f"{name}: ragged checks", flush=True)
        cs.ragged_phase(dev, 0)

    cfg = cs.mixtral_8x7b()
    d, f, e = cfg.dim, cfg.intermediate, cfg.n_experts
    gen = torch.Generator(device=dev).manual_seed(0)

    def w(shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02
                ).to(torch.bfloat16)

    wg, wu, wd = w((e, d, f)), w((e, d, f)), w((e, f, d))
    for shape, n_tok, empty, picked in (
            ("decode", 8, None, None),
            ("decode_last_expert_routed", 8, None, e - 1),
            ("decode_last_expert_unrouted", 8, e - 1, None),
            ("prefill_16", 16, None, None)):
        lay, x, counts = cs.layout_case(cfg, n_tok, gen, dev, empty, picked)
        bm, te, rows = lay.bm, lay.tile_experts, lay.dest
        used = int((counts > 0).sum())
        tail = lay.m // bm - sum(-(-int(c) // bm) for c in counts)
        read = used + int(bool(tail) and not counts[e - 1])
        grp = cs.groups(counts, bm)
        ref_h = gm.gmm_swiglu_plain(x.float(), wg.float(), wu.float(), te,
                                    bm)
        h = ref_h.to(torch.bfloat16)
        ref_y = gm.gmm_plain(h.float(), wd.float(), te, bm)
        for name, lib in libs.items():
            _build._LIBRARY = lib
            cs.check_rel(f"{name} gmm_swiglu[{shape}]",
                         gm._gmm_swiglu(x, wg, wu, te, bm), ref_h, rows,
                         cs.KERNEL_REL_TOL)
            cs.check_rel(f"{name} gmm[{shape}]", gm._gmm(h, wd, te, bm),
                         ref_y, rows, cs.KERNEL_REL_TOL)
        del ref_h, ref_y

        def lib_swiglu():
            for ex, r0, c in grp:
                xe = x[r0:r0 + c]
                torch.nn.functional.silu(xe @ wg[ex]) * (xe @ wu[ex])

        def lib_down():
            for ex, r0, c in grp:
                h[r0:r0 + c] @ wd[ex]

        for kernel, fn, lib_fn, expert_bytes in (
                ("gmm_swiglu", lambda: gm._gmm_swiglu(x, wg, wu, te, bm),
                 lib_swiglu, 2 * d * f * 2),
                ("gmm", lambda: gm._gmm(h, wd, te, bm), lib_down, d * f * 2)):
            times = {n: [] for n in libs}
            lib_times = []
            for order in (names, names[::-1], names, names[::-1]):
                lib_times.append(cs.time_ms(lib_fn, CALLS))
                for n in order:
                    _build._LIBRARY = libs[n]
                    times[n].append(cs.time_ms(fn, CALLS))
            ms = {n: sum(t) / len(t) for n, t in times.items()}
            print(json.dumps({
                "layout": shape, "kernel": kernel, "bm": bm,
                "experts_touched": used, "clamped_tail_tiles": tail,
                "experts_read": read, "library_ms": sum(lib_times) / 4,
                "ms": ms, "spread_ms": {n: max(t) - min(t)
                                        for n, t in times.items()},
                "TBps_over_experts_read": {
                    n: read * expert_bytes / m / 1e9 for n, m in ms.items()},
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
