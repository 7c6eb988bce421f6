#!/usr/bin/env python3
"""The pretrain over N cards of one host, under several meshes, against
one card.

Each run is ``llama_pretrain.main``, one process a card (``--device
cuda:<rank>``) joined into one nccl gang through the env the controller
gives a Worker pod (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID``) and the mesh flags.  The one-card run is the same
command with no gang.

- dense (default): Llama-2-7B widths cut to 8 layers (``--preset llama2-7b
  --n-layers 8``), global batch 8 x T 4096, 3 steps; meshes dp,fsdp,tp.
- ``--experts 8``: the MoE at Mixtral-8x7B widths cut to 2 layers
  (``--preset mixtral-8x7b --n-layers 2 --experts 8 --top-k 2
  --moe-dispatch grouped --strict-moe-dispatch``), global batch 2 x T
  4096, 3 steps; meshes dp,fsdp,ep,tp (default (ep 4) and (fsdp 2, ep
  2)), so each card runs the ep-sharded grouped path on its experts,
  while the one card runs the unsharded one.

    python3 tools/mesh_cards.py [--cards 4] [--meshes 1,4,1 2,2,1 ...]
    python3 tools/mesh_cards.py --experts 8 [--meshes 1,1,4,1 1,2,2,1]

Prints the card line, then one JSON line per run: the mesh, every rank's
exit code, rank 0's per-step losses and their largest relative
difference from the one-card run's, step ms (rank 0's clock; each step
ends in a device sync) and their p50, peak memory per rank and, for the
MoE, each rank's ``valid_tiles`` per layer on the first step (its real
tiles of the layout's M / bm).  Exits non-zero if a run fails or a rank's
losses differ from rank 0's.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ARGV = ["--preset", "llama2-7b", "--n-layers", "8", "--batch-size", "8",
        "--seq-len", "4096", "--steps", "3"]
MESHES = ("1,4,1", "2,2,1", "1,2,2", "1,1,4")
MOE_ARGV = ["--preset", "mixtral-8x7b", "--n-layers", "2", "--top-k", "2",
            "--moe-dispatch", "grouped", "--strict-moe-dispatch",
            "--batch-size", "2", "--seq-len", "4096", "--steps", "3"]
MOE_MESHES = ("1,1,4,1", "1,2,2,1")
AXES = ("dp", "fsdp", "tp")
MOE_AXES = ("dp", "fsdp", "ep", "tp")


def child(argv) -> int:
    """One rank: ``llama_pretrain.main(argv)`` with its ``train`` result
    kept, printed as a ``RESULT`` JSON line, with the ``valid_tiles`` of
    the grouped layouts of its first step."""
    from unittest import mock

    import torch

    from kubeflow_controller_tpu_torch.models import moe
    from kubeflow_controller_tpu_torch.workloads import llama_pretrain

    runs, layouts = [], []
    real = llama_pretrain.train
    real_layout = moe.grouped_layout

    def recording(*args, **kwargs):
        runs.append(real(*args, **kwargs))
        return runs[-1]

    def layout(*args, **kwargs):
        lay = real_layout(*args, **kwargs)
        layouts.append((lay.m, lay.bm, lay.valid_tiles))
        return lay

    with mock.patch.object(llama_pretrain, "train", recording), \
            mock.patch.object(moe, "grouped_layout", layout):
        rc = llama_pretrain.main(argv)
    res = runs[0]
    layers = int(argv[argv.index("--n-layers") + 1])
    print("RESULT " + json.dumps({
        "rc": rc, "losses": res.losses,
        "step_ms": [x * 1e3 for x in res.step_s],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "layouts": [{"M": m, "tiles": m // bm, "valid_tiles":
                     None if vt is None else int(vt.item())}
                    for m, bm, vt in layouts[:layers]]}),
        flush=True)
    return rc


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(argv, ranks: int, mesh_args, timeout: float) -> list:
    """``ranks`` processes of this script's child; their RESULT records
    (None for a rank that printed none) and exit codes."""
    port = free_port()
    procs = []
    for r in range(ranks):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("KCTPU_", "JAX_", "MODEL_DIR"))}
        env["PYTHONPATH"] = str(HERE)
        if ranks > 1:
            env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       JAX_NUM_PROCESSES=str(ranks), JAX_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--child", *argv, *mesh_args,
             "--device", f"cuda:{r}"], cwd=HERE, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, stderr = p.communicate()
        rec = next((json.loads(x[len("RESULT "):]) for x in
                    stdout.splitlines() if x.startswith("RESULT ")), None)
        if rec is None or p.returncode:
            print(f"rank failed (exit {p.returncode}):\n{stdout[-3000:]}\n"
                  f"{stderr[-3000:]}", file=sys.stderr, flush=True)
        out.append((p.returncode, rec))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--meshes", nargs="*", default=None,
                    help="dp,fsdp,tp per run, dp,fsdp,ep,tp with "
                         "--experts (their product: --cards)")
    ap.add_argument("--experts", type=int, default=0,
                    help="train the Mixtral-width MoE with this many "
                         "experts (0: the dense model)")
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--child", nargs=argparse.REMAINDER,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        return child(args.child)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(card[0], f"x {len(card)}", flush=True)
    if args.experts:
        argv, axes = MOE_ARGV + ["--experts", str(args.experts)], MOE_AXES
        meshes = args.meshes or list(MOE_MESHES)
    else:
        argv, axes, meshes = ARGV, AXES, args.meshes or list(MESHES)
    [(rc, one)] = run(argv, 1, [], args.timeout)
    failed = rc != 0
    if one is not None:
        print(json.dumps({"mesh": "one card", **one}), flush=True)
    for spec in meshes:
        sizes = dict(zip(axes, (int(x) for x in spec.split(","))))
        if len(sizes) != len(axes) or math.prod(sizes.values()) != args.cards:
            raise SystemExit(f"mesh {spec} is not {','.join(axes)} over "
                             f"{args.cards} cards")
        res = run(argv, args.cards,
                  [a for k, v in sizes.items() for a in (f"--{k}", str(v))],
                  args.timeout)
        rcs = [rc for rc, _ in res]
        recs = [rec for _, rec in res]
        rec0 = recs[0] or {}
        losses = rec0.get("losses", [])
        rel = ([abs(a - b) / abs(b) for a, b in zip(losses, one["losses"])]
               if one and losses else None)
        agree = all(r is not None and r["losses"] == losses for r in recs)
        steps = rec0.get("step_ms", [])
        print(json.dumps({
            "mesh": sizes, "rcs": rcs,
            "losses": losses, "losses_one_card": one and one["losses"],
            "loss_rel_diff_max": max(rel) if rel else None,
            "ranks_agree": agree, "step_ms": steps,
            "step_ms_p50": statistics.median(steps) if steps else None,
            "peak_mem_gb": [r and r["peak_mem_gb"] for r in recs],
            "valid_tiles_by_rank": [r and [x["valid_tiles"]
                                           for x in r["layouts"]]
                                    for r in recs],
            "layout_tiles": (rec0.get("layouts") or [{}])[0].get("tiles")}),
            flush=True)
        failed |= any(rcs) or not agree
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
