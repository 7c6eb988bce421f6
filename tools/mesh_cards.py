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
- ``--sp``: sequence parallelism at ``examples/jobs/llama-sp.yaml``'s
  length, Llama-2-7B widths cut to 8 layers, global batch 1 x T 32768, 3
  steps; meshes fsdp,sp,attention (default (sp 4) ring, (sp 4) Ulysses and
  (fsdp 2, sp 2) ring, where fsdp makes the global batch 2), each against
  one card at the same global batch.

- ``--generate``: cached generation (``models/generate.py:generate``,
  greedy, the blocked read) on Llama-2-7B at all 32 layers with bf16
  parameters, B 8, a 2048-token prompt and 64 new tokens; meshes dp,tp
  (default (tp 4) and (dp 2, tp 2)), each process building its shards
  with ``llama_init(mesh=)``, against one card.  Each run's prefill
  logits (``forward_with_cache`` at position 0; every 64th position and
  the last, gathered) with f32 activations must lie within 1e-3 of max of
  one card's, and every rank's tokens must equal rank 0's.  The bf16
  prefill's logits are compared too, and printed: tp sums bf16 partial
  products that one card accumulates in f32, and 32 random-weight layers
  amplify that rounding (to 6% of max on an H100, PERF.md), so that
  check would gate on rounding, not on the sharding.  The agreement with one
  card's tokens,
  prefill ms, ms per token (p50 of the 63 steps, CUDA events around each
  forward) and peak GB a card are printed.  ``--preset tiny --device-type
  cpu`` rehearses it over gloo ranks on the CPU.

    python3 tools/mesh_cards.py [--cards 4] [--meshes 1,4,1 2,2,1 ...]
    python3 tools/mesh_cards.py --experts 8 [--meshes 1,1,4,1 1,2,2,1]
    python3 tools/mesh_cards.py --sp [--meshes 1,4,ring 1,4,ulysses ...]
    python3 tools/mesh_cards.py --generate [--meshes 1,4 2,2]
    python3 tools/mesh_cards.py --pp
    python3 tools/mesh_cards.py --sp --experts 8 [--meshes 2,2]
    python3 tools/mesh_cards.py --fake-pg [--device-type cpu]

- ``--pp``: pipeline parallelism (1F1B, ``llama_pretrain --pp S
  --microbatches M``).  Llama-2-7B widths at 8 layers, global batch 8 x T
  4096, 3 steps, under (pp 4) M 8 and (pp 2, fsdp 2) M 4 (a one-row
  microbatch cannot split over fsdp 2), each against one card's non-pp
  run at the same batch (losses within ``PP_LOSS_RTOL``, every rank's
  equal to rank 0's, each rank's flash launches those of its stage's
  layers: 3 forward, 1 dq and 1 dkv a layer a microbatch); then (pp 4) at
  all 32 layers, M 8, the run no one card holds, with one more step
  profiled on every rank (``torch.profiler``: the step's wall ms, the
  device's compute-busy ms without the nccl kernels, its idle share
  beside the 1F1B bubble (2S - 2) / (M + 2S - 2)); then config B3, (pp
  2, ep 2) on the Mixtral-width MoE, 2 layers, M 2, each rank's skip
  launches of ``gmm`` and ``tgmm`` against 12 and 3 a layer a
  microbatch.
- ``--sp --experts 8``: MoE under sequence parallelism, the Mixtral-width
  MoE at 2 layers, B 1 x T 8192, grouped, under (ep 2, sp 2) (``ep,sp``
  meshes) against one card: losses within ``PP_LOSS_RTOL``, ranks equal.
- ``--fake-pg``: each pp mesh's first and last rank alone under torch's
  fake process group (collectives do nothing, DTensor's propagation runs
  in full) at tiny widths in bf16: a one-card check that this torch
  propagates every op of the stage step, before the 4-card call.

Prints the card line, then one JSON line per run: the mesh, every rank's
exit code, rank 0's per-step losses and their largest relative
difference from the one-card run's, step ms (rank 0's clock; each step
ends in a device sync) and their p50, peak memory per rank and, for the
MoE, each rank's ``valid_tiles`` per layer on the first step (its real
tiles of the layout's M / bm), and, under ``--sp``, every rank's losses and
flash launches beside those its sp index predicts (a causal ring's rank
idx runs (idx + 1) x 2 forward blocks a layer a step under remat "full",
and idx + 1 of each backward kernel; Ulysses 2 and 1).  Exits non-zero if
a run fails, a rank's losses differ from rank 0's or, under ``--sp``, a
launch count differs from the prediction.
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
SP_ARGV = ["--preset", "llama2-7b", "--n-layers", "8", "--seq-len", "32768",
           "--steps", "3"]
SP_MESHES = ("1,4,ring", "1,4,ulysses", "2,2,ring")
FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
GEN_MESHES = ("1,4", "2,2")             # dp,tp
GEN_BATCH, GEN_PROMPT, GEN_NEW = 8, 2048, 64
GEN_LOGITS_EVERY = 64       # prefill positions kept: every 64th and the last
# Their f32 logits against one card's: the sharded sums only reorder f32
# products, which moves them by ~2e-5 of max on an H100.
GEN_LOGITS_REL_TOL = 1e-3
PP_RUNS = (("pp4", ["--pp", "4", "--fsdp", "1", "--microbatches", "8"]),
           ("pp2_fsdp2", ["--pp", "2", "--fsdp", "2", "--microbatches",
                          "4"]))
PP32_ARGV = ["--preset", "llama2-7b", "--n-layers", "32", "--batch-size",
             "8", "--seq-len", "4096", "--steps", "3"]
PP32_RUN = ["--pp", "4", "--fsdp", "1", "--microbatches", "8",
            "--profile-step"]
B3_RUN = ["--experts", "8", "--pp", "2", "--ep", "2", "--fsdp", "1",
          "--microbatches", "2"]
PP_LOSS_RTOL = 1e-3
# Launches a layer a microbatch of a 1F1B step under remat "full" (the
# stage forward, its re-run, the layer's recompute; chip_smoke.py).
PP_FLASH_PER_LAYER = {"flash_fwd": 3, "flash_dq": 1, "flash_dkv": 1}
PP_SKIP_PER_LAYER = {"gmm": 12, "tgmm": 3}
MOE_SP_ARGV = ["--preset", "mixtral-8x7b", "--n-layers", "2", "--top-k",
               "2", "--moe-dispatch", "grouped", "--strict-moe-dispatch",
               "--batch-size", "1", "--seq-len", "8192", "--steps", "3"]
MOE_SP_MESHES = ("2,2",)                # ep,sp
FAKE_MESHES = (("pp4", 4, 1, (0, 3)), ("pp2_fsdp2", 2, 2, (0, 3)))


def child(argv) -> int:
    """One rank: ``llama_pretrain.main(argv)`` with its ``train`` result
    kept, printed as a ``RESULT`` JSON line, with the ``valid_tiles`` of
    the grouped layouts of its first step."""
    from unittest import mock

    import torch

    from kubeflow_controller_tpu_torch.models import moe
    from kubeflow_controller_tpu_torch.ops import attention
    from kubeflow_controller_tpu_torch.workloads import llama_pretrain

    from kubeflow_controller_tpu_torch.ops import grouped_matmul as gm

    runs, layouts, profiles = [], [], []
    real = llama_pretrain.train
    real_layout = moe.grouped_layout
    profile_step = "--profile-step" in argv
    argv = [a for a in argv if a != "--profile-step"]

    def recording(*args, **kwargs):
        runs.append(real(*args, **kwargs))
        if profile_step:    # one more step, before main leaves the gang
            res = runs[-1]
            profiles.append(profiled(lambda: res.step(
                res.start_step + len(res.losses))))
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
        "flash_launches": {name: getattr(attention, name).launches
                           for name in FLASH_KERNELS},
        "grouped_launches": {"gmm": gm.gmm.launches,
                             "gmm_skip": gm.gmm.skip_launches,
                             "gmm_swiglu": gm.gmm_swiglu.launches,
                             "tgmm": gm.tgmm.launches,
                             "tgmm_skip": gm.tgmm.skip_launches},
        "profile": profiles[0] if profiles else None,
        "layouts": [{"M": m, "tiles": m // bm, "valid_tiles":
                     None if vt is None else int(vt.item())}
                    for m, bm, vt in layouts[:layers]]}),
        flush=True)
    return rc


def profiled(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall ms (ending
    in a device sync), the device's compute-busy ms (every kernel but
    nccl's, which wait on the device for their peer), nccl's ms, and the
    compute idle share."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    nccl = sum(e.self_device_time_total for e in kernels
               if "nccl" in e.key.lower()) / 1e3
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 - nccl
    return {"wall_ms": wall, "compute_busy_ms": busy, "nccl_ms": nccl,
            "compute_idle_share": 1 - busy / wall if kernels else None}


def fake_child(argv) -> int:
    """One rank of a pp mesh alone under torch's fake process group:
    ``PP FSDP RANK DEVICE_TYPE``; two steps of the tiny model in bf16."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from kubeflow_controller_tpu_torch.models.llama import LlamaConfig
    from kubeflow_controller_tpu_torch.parallel.mesh import (
        MeshSpec,
        build_mesh,
    )
    from kubeflow_controller_tpu_torch.workloads import llama_pretrain

    pp, fsdp, rank, device_type = argv
    pp, fsdp, rank = int(pp), int(fsdp), int(rank)
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=pp * fsdp)
    mesh = build_mesh(MeshSpec(pp=pp, fsdp=fsdp), device_type)
    cfg = LlamaConfig.tiny(n_layers=4, dtype="bfloat16", attention="flash")
    device = "cuda:0" if device_type == "cuda" else "cpu"
    res = llama_pretrain.train(cfg, steps=2, batch_size=8, seq_len=64,
                               device=device, mesh=mesh, microbatches=4)
    print("RESULT " + json.dumps({"rc": 0, "losses": res.losses}),
          flush=True)
    dist.destroy_process_group()
    return 0


def fake_main(args) -> int:
    """Each ``FAKE_MESHES`` rank alone under the fake process group."""
    failed = False
    for label, pp, fsdp, ranks in FAKE_MESHES:
        for rank in ranks:
            [(rc, rec)] = run([str(pp), str(fsdp), str(rank),
                               args.device_type], 1, [], args.timeout,
                              args.device_type, mode="--fake-child")
            print(json.dumps({"fake_pg": label, "rank": rank, "rc": rc,
                              "losses": rec and rec["losses"]}), flush=True)
            failed |= rc != 0
    return 1 if failed else 0


def generate_child(argv) -> int:
    """One rank of a ``--generate`` run: ``--dp D --tp T --device DEV
    --preset P --logits PATH``.  Joins the gang its env names (none for
    one process), builds the model (sharded on the (dp, tp) mesh in a
    gang), writes the sampled prefill logits to PATH (rank 0) and prints
    its ``RESULT``: new tokens, prefill ms, ms per token, peak GB."""
    from dataclasses import replace

    import torch

    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from kubeflow_controller_tpu_torch.models.llama import (
        LlamaConfig,
        llama_init,
    )
    from kubeflow_controller_tpu_torch.parallel.mesh import (
        MeshSpec,
        build_mesh,
    )
    from kubeflow_controller_tpu_torch.workloads.data import synthetic_tokens
    from kubeflow_controller_tpu_torch.workloads.runtime import JobRuntime

    ap = argparse.ArgumentParser()
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--preset", default="llama2-7b")
    ap.add_argument("--logits", required=True)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if args.preset == "tiny":
        cfg = LlamaConfig.tiny(dtype="bfloat16", param_dtype="bfloat16",
                               n_kv_heads=4)
        batch, t_p, new = 4, 24, 6
    else:
        cfg = cs.llama2_7b_decode(32)
        batch, t_p, new = GEN_BATCH, GEN_PROMPT, GEN_NEW
    cfg = replace(cfg, max_seq_len=t_p + new)
    rt = JobRuntime.from_env()
    rt.initialize(dev, timeout_s=300)
    mesh = None
    if rt.num_processes > 1:
        mesh = build_mesh(MeshSpec(dp=args.dp, fsdp=1, tp=args.tp),
                          dev.type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = llama_init(cfg, gen, dev, mesh=mesh)
    prompt = synthetic_tokens(0, batch, t_p, cfg.vocab_size, dev)
    gm = cs.gen_mod
    s = -(-(t_p + new) // gm.DECODE_KV_BLOCK) * gm.DECODE_KV_BLOCK
    keep = list(range(0, t_p, GEN_LOGITS_EVERY)) + [t_p - 1]
    sampled = {}
    for dtype in ("float32", cfg.dtype):
        run_cfg = replace(cfg, dtype=dtype)
        cache = gm.init_cache(run_cfg, batch, max(s, t_p + new), device=dev,
                              mesh=mesh)
        logits = gm.forward_with_cache(model, prompt, cache, 0, run_cfg,
                                       mesh=mesh)[0]
        if mesh is not None:
            logits = logits.full_tensor()
        sampled[dtype] = logits[:, keep].cpu()
        del cache, logits
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if rt.process_id == 0:
        torch.save(sampled, args.logits)
    timed = (cs.timed_generate if dev.type == "cuda" else
             lambda *a, **k: (gm.generate(*a, **k), None))
    out, rec = timed(model, prompt, cfg, max_new_tokens=new, mesh=mesh)
    print("RESULT " + json.dumps({
        "rc": 0, "tokens": out[:, t_p:].tolist(),
        **({} if rec is None else {
            k: rec[k] for k in ("prefill_ms", "ms_per_token_p50",
                                "host_ms_per_token_p50", "peak_gb",
                                "cache_gb")})}), flush=True)
    rt.shutdown()
    return 0


def generate_main(args) -> int:
    """The ``--generate`` runs, each against one card (the sampled logits
    pass through a temporary directory)."""
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="mesh_generate_"))
    try:
        return generate_runs(args, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def generate_runs(args, tmp: Path) -> int:
    import torch

    flags = ["--generate-child", "--preset", args.preset]

    def launch(ranks, mesh_args, name):
        path = tmp / f"logits_{name}.pt"
        res = run(flags + mesh_args + ["--logits", str(path)], ranks, [],
                  args.timeout, args.device_type)
        logits = torch.load(path) if path.exists() else None
        return res, logits

    [(rc, one)], one_logits = launch(1, [], "one")
    failed = rc != 0 or one is None
    if one is not None:
        print(json.dumps({"mesh": "one card",
                          **{k: v for k, v in one.items()
                             if k != "tokens"}}), flush=True)
    for spec in args.meshes or list(GEN_MESHES):
        dp, tp = (int(x) for x in spec.split(","))
        if dp * tp != args.cards:
            raise SystemExit(f"mesh {spec} is not dp,tp over {args.cards} "
                             f"cards")
        res, logits = launch(args.cards, ["--dp", str(dp), "--tp", str(tp)],
                             f"dp{dp}_tp{tp}")
        rcs = [rc for rc, _ in res]
        recs = [rec or {} for _, rec in res]
        toks = [r.get("tokens") for r in recs]
        rel = ({dtype: ((logits[dtype] - one_logits[dtype]).abs().max()
                        / one_logits[dtype].abs().max()).item()
                for dtype in one_logits}
               if logits is not None and one_logits is not None else None)
        agree = None
        if one is not None and toks[0] is not None:
            a, b = torch.tensor(toks[0]), torch.tensor(one["tokens"])
            agree = {"equal_share": (a == b).float().mean().item(),
                     "leading_equal_by_seq": [
                         int((row == 0).nonzero()[0]) if (row == 0).any()
                         else row.numel() for row in (a == b).int()]}
        ranks_agree = all(t is not None and t == toks[0] for t in toks)
        print(json.dumps({
            "mesh": {"dp": dp, "tp": tp}, "rcs": rcs,
            "prefill_logits_rel": rel, "tol_float32": GEN_LOGITS_REL_TOL,
            "ranks_agree": ranks_agree, "tokens_vs_one_card": agree,
            **{k: recs[0].get(k) for k in (
                "prefill_ms", "ms_per_token_p50", "host_ms_per_token_p50")},
            "peak_gb": [r.get("peak_gb") for r in recs],
            **({f"{k}_one_card": one.get(k) for k in (
                "prefill_ms", "ms_per_token_p50", "host_ms_per_token_p50",
                "peak_gb")} if one else {})}), flush=True)
        failed |= (any(rcs) or not ranks_agree or rel is None
                   or rel["float32"] > GEN_LOGITS_REL_TOL)
    return 1 if failed else 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(argv, ranks: int, mesh_args, timeout: float,
        device_type: str = "cuda", mode: str = "") -> list:
    """``ranks`` processes of this script's child (``mode``: its flag, by
    default ``--child``, or ``--generate-child`` as ``argv`` starts); their
    RESULT records (None for a rank that printed none) and exit codes."""
    port = free_port()
    procs = []
    for r in range(ranks):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("KCTPU_", "JAX_", "MODEL_DIR"))}
        env["PYTHONPATH"] = str(HERE)
        if ranks > 1:
            env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       JAX_NUM_PROCESSES=str(ranks), JAX_PROCESS_ID=str(r))
        if device_type == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        child = ([] if argv[:1] == ["--generate-child"]
                 else [mode or "--child"])
        device = f"cuda:{r}" if device_type == "cuda" else "cpu"
        tail = [] if mode else ["--device", device]
        procs.append(subprocess.Popen(
            [sys.executable, __file__, *child, *argv, *mesh_args, *tail],
            cwd=HERE, env=env,
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
    ap.add_argument("--sp", action="store_true",
                    help="sequence parallelism at T 32768: meshes "
                         "fsdp,sp,ring|ulysses")
    ap.add_argument("--experts", type=int, default=0,
                    help="train the Mixtral-width MoE with this many "
                         "experts (0: the dense model)")
    ap.add_argument("--generate", action="store_true",
                    help="cached generation, Llama-2-7B at 32 layers: "
                         "meshes dp,tp")
    ap.add_argument("--pp", action="store_true",
                    help="pipeline parallelism: (pp 4), (pp 2, fsdp 2) at 8 "
                         "layers, (pp 4) at 32, config B3")
    ap.add_argument("--fake-pg", action="store_true",
                    help="each pp mesh's first and last rank alone under "
                         "the fake process group")
    ap.add_argument("--preset", default="llama2-7b",
                    help="--generate's model: llama2-7b, or tiny for a "
                         "rehearsal")
    ap.add_argument("--device-type", default="cuda",
                    help="--generate on cuda cards, or cpu (gloo) for a "
                         "rehearsal")
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--child", nargs=argparse.REMAINDER,
                    help=argparse.SUPPRESS)
    ap.add_argument("--generate-child", nargs=argparse.REMAINDER,
                    help=argparse.SUPPRESS)
    ap.add_argument("--fake-child", nargs=argparse.REMAINDER,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        return child(args.child)
    if args.fake_child is not None:
        return fake_child(args.fake_child)
    if args.fake_pg:
        return fake_main(args)
    if args.generate_child is not None:
        return generate_child(args.generate_child)
    if args.generate and args.device_type == "cpu":
        return generate_main(args)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(card[0], f"x {len(card)}", flush=True)
    if args.pp:
        return pp_main(args)
    if args.sp and args.experts:
        return moe_sp_main(args)
    if args.sp:
        return sp_main(args)
    if args.generate:
        return generate_main(args)
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


def arg(argv, flag: str) -> int:
    return int(argv[argv.index(flag) + 1])


def compare(label, one, res, extra=None) -> bool:
    """Print one run against the one-card run; whether it failed (a rank's
    exit code, losses off the one card's by more than ``PP_LOSS_RTOL``, a
    rank's losses off rank 0's)."""
    rcs = [rc for rc, _ in res]
    recs = [rec or {} for _, rec in res]
    losses = recs[0].get("losses", [])
    rel = (max((abs(a - b) / abs(b) for a, b in zip(losses, one["losses"])),
               default=None) if one and losses else None)
    agree = all(r.get("losses") == losses for r in recs)
    steps = recs[0].get("step_ms", [])
    print(json.dumps({
        "run": label, "rcs": rcs, "losses": losses,
        "losses_one_card": one and one["losses"], "loss_rel_diff_max": rel,
        "tol": PP_LOSS_RTOL, "ranks_agree": agree, "step_ms": steps,
        "step_ms_p50": statistics.median(steps) if steps else None,
        "step_ms_p50_one_card": one and statistics.median(one["step_ms"]),
        "peak_mem_gb": [r.get("peak_mem_gb") for r in recs],
        "peak_mem_gb_one_card": one and one["peak_mem_gb"],
        **(extra or {})}), flush=True)
    return (any(rcs) or not agree or (one is not None and (
        rel is None or rel > PP_LOSS_RTOL)))


def pp_main(args) -> int:
    """The ``--pp`` runs (see the docstring)."""
    [(rc, one)] = run(ARGV, 1, [], args.timeout)
    failed = rc != 0
    if one is not None:
        print(json.dumps({"run": "one card", **one}), flush=True)
    layers, steps = arg(ARGV, "--n-layers"), arg(ARGV, "--steps")
    for label, extra in PP_RUNS:
        res = run(ARGV, args.cards, extra, args.timeout)
        S, M = arg(extra, "--pp"), arg(extra, "--microbatches")
        want = {k: v * (layers // S) * M * steps
                for k, v in PP_FLASH_PER_LAYER.items()}
        got = [(rec or {}).get("flash_launches") for _, rec in res]
        failed |= compare(label, one, res, {
            "flash_launches_by_rank": got,
            "flash_launches_predicted": want,
            "bubble_share": (2 * S - 2) / (M + 2 * S - 2)})
        failed |= any(g != want for g in got)
    res = run(PP32_ARGV, args.cards, PP32_RUN, args.timeout)
    S, M = arg(PP32_RUN, "--pp"), arg(PP32_RUN, "--microbatches")
    failed |= compare("pp4_32_layers", None, res, {
        "profile_by_rank": [(rec or {}).get("profile") for _, rec in res],
        "bubble_share": (2 * S - 2) / (M + 2 * S - 2)})
    moe_argv = MOE_ARGV + B3_RUN
    res = run(moe_argv, args.cards, [], args.timeout)
    M = arg(B3_RUN, "--microbatches")
    per_stage = arg(MOE_ARGV, "--n-layers") // arg(B3_RUN, "--pp")
    want = {f"{k}_skip": v * per_stage * M * arg(MOE_ARGV, "--steps")
            for k, v in PP_SKIP_PER_LAYER.items()}
    got = [(rec or {}).get("grouped_launches") for _, rec in res]
    failed |= compare("b3_pp2_ep2", None, res, {
        "grouped_launches_by_rank": got, "skip_predicted": want})
    failed |= any(g is None or any(g[k] != v for k, v in want.items())
                  or g["gmm_swiglu"] for g in got)
    return 1 if failed else 0


def moe_sp_main(args) -> int:
    """``--sp --experts E``: MoE under (ep, sp) against one card."""
    argv = MOE_SP_ARGV + ["--experts", str(args.experts)]
    [(rc, one)] = run(argv, 1, [], args.timeout)
    failed = rc != 0
    if one is not None:
        print(json.dumps({"run": "one card", **one}), flush=True)
    for spec in args.meshes or list(MOE_SP_MESHES):
        ep, sp = (int(x) for x in spec.split(","))
        if ep * sp != args.cards:
            raise SystemExit(f"mesh {spec} is not ep,sp over {args.cards} "
                             f"cards")
        res = run(argv, args.cards, ["--ep", str(ep), "--sp", str(sp),
                                     "--fsdp", "1"], args.timeout)
        failed |= compare(f"ep{ep}_sp{sp}", one, res, {
            "valid_tiles_by_rank": [(rec or {}).get("layouts")
                                    for _, rec in res]})
    return 1 if failed else 0


def sp_launches(attention: str, idx: int, layers: int, steps: int) -> dict:
    """The flash launches of sp rank ``idx`` over the run (remat "full",
    causal): the ring's rank idx folds idx + 1 blocks, twice forward (the
    forward and its re-run); Ulysses runs one call over its heads."""
    blocks = idx + 1 if attention == "ring" else 1
    return {"flash_fwd": 2 * blocks * layers * steps,
            "flash_dq": blocks * layers * steps,
            "flash_dkv": blocks * layers * steps}


def sp_main(args) -> int:
    """The ``--sp`` runs, each against one card at its global batch."""
    layers = int(SP_ARGV[SP_ARGV.index("--n-layers") + 1])
    steps = int(SP_ARGV[SP_ARGV.index("--steps") + 1])
    one_card, failed = {}, False
    for spec in args.meshes or list(SP_MESHES):
        fsdp, sp, attention = spec.split(",")
        fsdp, sp = int(fsdp), int(sp)
        if fsdp * sp != args.cards or attention not in ("ring", "ulysses"):
            raise SystemExit(f"mesh {spec} is not fsdp,sp,ring|ulysses over "
                             f"{args.cards} cards")
        batch = fsdp        # the global batch rounds up to the fsdp extent
        argv = SP_ARGV + ["--batch-size", str(batch)]
        if batch not in one_card:
            [(rc, one)] = run(argv, 1, [], args.timeout)
            failed |= rc != 0
            one_card[batch] = one
            if one is not None:
                print(json.dumps({"mesh": "one card", "batch": batch,
                                  **one}), flush=True)
        one = one_card[batch]
        res = run(argv, args.cards, ["--fsdp", str(fsdp), "--sp", str(sp),
                                     "--sp-attention", attention],
                  args.timeout)
        rcs = [rc for rc, _ in res]
        recs = [rec or {} for _, rec in res]
        losses = recs[0].get("losses", [])
        rel = [max((abs(a - b) / abs(b) for a, b in
                    zip(r.get("losses", []), one["losses"])), default=None)
               if one else None for r in recs]
        want = [sp_launches(attention, rank % sp, layers, steps)
                for rank in range(args.cards)]
        got = [r.get("flash_launches") for r in recs]
        steps_ms = recs[0].get("step_ms", [])
        print(json.dumps({
            "mesh": {"fsdp": fsdp, "sp": sp}, "sp_attention": attention,
            "batch": batch, "rcs": rcs,
            "losses_by_rank": [r.get("losses") for r in recs],
            "losses_one_card": one and one["losses"],
            "loss_rel_diff_max_by_rank": rel,
            "ranks_agree": all(r.get("losses") == losses for r in recs),
            "step_ms": steps_ms,
            "step_ms_p50": statistics.median(steps_ms) if steps_ms else None,
            "step_ms_p50_one_card": one and statistics.median(
                one["step_ms"]),
            "peak_mem_gb": [r.get("peak_mem_gb") for r in recs],
            "peak_mem_gb_one_card": one and one["peak_mem_gb"],
            "flash_launches_by_rank": got,
            "flash_launches_predicted": want}), flush=True)
        failed |= (any(rcs) or got != want
                   or any(r.get("losses") != losses for r in recs))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
