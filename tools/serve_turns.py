#!/usr/bin/env python3
"""Serve ``chip_smoke.py``'s requests from two checkouts in turns, on one card.

The serve phase's host-set numbers (decode gap p50, TTFT p50, tokens/s)
move with the machine (PERF.md section 2), so two versions are compared
only within one call, in turns.  Each run is a process of its own,
started in one checkout's root, so it imports that checkout's package and
builds that checkout's kernels; it runs that checkout's
``chip_smoke.serve_phase`` (Mixtral-8x7B widths, 8 layers, 8 requests, the
per-layer check after the timed part) and this script keeps its
``serve:`` line.  Per round the order is other, this, this, other.

    python3 tools/serve_turns.py --other path/to/other/checkout [--rounds 1]

Prints the card line, one JSON line per run and the medians per checkout.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
CHILD = ("import torch, chip_smoke as cs; "
         "cs.serve_phase(cs.mixtral_8x7b(), torch.device('cuda', 0), 0)")
KEYS = ("decode_ms_per_step_p50", "ttft_p50_ms", "tokens_per_s")


def serve(root: Path) -> dict:
    """One serve phase in ``root``: its ``serve:`` line, parsed."""
    res = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                         capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise RuntimeError(f"serve in {root} failed:\n{res.stdout[-4000:]}"
                           f"\n{res.stderr[-4000:]}")
    line = next(x for x in res.stdout.splitlines() if x.startswith("serve: "))
    return json.loads(line[len("serve: "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True)
    print(card.stdout.strip().splitlines()[0], flush=True)
    roots = {"other": args.other.resolve(), "this": HERE}
    runs = {"other": [], "this": []}
    for _ in range(args.rounds):
        for name in ("other", "this", "this", "other"):
            out = serve(roots[name])
            runs[name].append(out)
            print(json.dumps({"checkout": name, **{k: out[k] for k in KEYS}}),
                  flush=True)
    print(json.dumps({name: {k: statistics.median(r[k] for r in rs)
                             for k in KEYS} for name, rs in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
