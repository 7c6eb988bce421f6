"""The readings that the limits of ``limits/<workload>.json`` are set
from, on the chip at the cell's own size:

    python3 -m portbench.calibrate --workload NAME --seeds 12 --first 1000 \\
        [--control 3] [--also fp8] [--faults 3] [--out FILE]

For each seed the program's checked steps (as a run drives them, but with
no window) against the plain reference; on the first ``--control`` seeds
each of the configuration's controls (``reference.py``), and each
precision named by ``--also``, against the reference; on
the first ``--faults`` seeds each planted fault (``faults.py``) against the
reference.  One JSON line a reading, to standard output and to ``--out``.
The limits follow from these readings by the rule in ``check.py``'s module
docstring; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import check, faults, reference, run


def _program(cell: run.Cell, seed: int, dev) -> dict:
    prog, batches, lay, _ = run.prepare(cell.conf, cell.mix, seed, dev)
    mine, _ = run.checked_steps(prog, batches, lay, seed,
                                cell.mix["checked_steps"])
    del prog
    run.free(dev)
    return mine


def _gaps(mine: dict, ref: dict) -> dict:
    """``check.gaps``: by step and by leaf, the rows' as quantiles."""
    gaps = check.gaps(mine, ref)
    rows = sorted(gaps.pop("embed_rows"))
    gaps["embed_rows_q"] = [rows[int(q * (len(rows) - 1))]
                            for q in (0.25, 0.5, 0.75, 0.9, 1.0)]
    return gaps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first", type=int, default=1000)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--also", action="append", default=[],
                   choices=reference.PRECISIONS[1:])
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    cell = run.load_cell(args.workload)
    dev = torch.device("cuda")
    out = open(args.out, "a") if args.out else None

    def emit(rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    n = cell.mix["checked_steps"]
    precisions = cell.conf["control"] + args.also
    for i in range(args.seeds):
        seed = args.first + i
        t = time.perf_counter()
        mine = _program(cell, seed, dev)
        batches = list(run.token_batches(cell.conf, cell.mix, seed,
                                         dev)[:n])
        ref = reference.train(cell.conf, seed, batches, dev)
        run.free(dev)
        emit({"workload": args.workload, "seed": seed, "kind": "program",
              **check.readings(mine, ref),
              "gaps": _gaps(mine, ref),
              "losses": mine["losses"],
              "ref_losses": ref["losses"], "ref_s": ref["seconds"],
              "seconds": time.perf_counter() - t})
        for precision in precisions if i < args.control else ():
            ctl = reference.train(cell.conf, seed, batches, dev,
                                  precision=precision)
            run.free(dev)
            emit({"workload": args.workload, "seed": seed,
                  "kind": "control", "precision": precision,
                  **check.readings(ctl, ref),
                  "gaps": _gaps(ctl, ref),
                  "losses": ctl["losses"]})
        if i < args.faults:
            for name in ("half_batch", "grad_altered"):
                with faults.planted(name):
                    bad = _program(cell, seed, dev)
                emit({"workload": args.workload, "seed": seed,
                      "kind": name, **check.readings(bad, ref),
                      "gaps": _gaps(bad, ref),
                      "losses": bad["losses"]})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
