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
    python3 tools/mesh_cards.py --pp --sp [--experts 8]
    python3 tools/mesh_cards.py --sp --experts 8 [--meshes 2,2]
    python3 tools/mesh_cards.py --fake-pg [--device-type cpu]
    python3 tools/mesh_cards.py --dryrun [--device-type cpu]
    python3 tools/mesh_cards.py --fake-pg --dryrun [--device-type cpu]
    python3 tools/mesh_cards.py --pods [--inventory] [--profile] [--device-type cpu]
    python3 tools/mesh_cards.py --pods --carve [--device-type cpu]

- ``--pods``: TPU-typed pods that run one rank a card through the pod's
  launcher (``workloads/launch.py``), their cards bound by the port's
  inventory, each run held against the rank-a-process gang of the same
  mesh in the same call.  The host is ``topology.discover_host`` (printed
  on a ``host`` line); a ``GPUInventory`` of ``carve(host, n)`` admits
  each job's stand-in pods (``chip_smoke.gang_pods``) and sets each pod's
  ``CUDA_VISIBLE_DEVICES`` to its slice's card UUIDs.  A pod is ``python
  -m kubeflow_controller_tpu_torch.workloads.llama_pretrain --device cuda
  --report`` with the env the controller gives it (``chip_smoke.pod_env``)
  and the one the inventory set; a rank of the gang is the same command
  with ``--device cuda:<rank>`` and the Worker env.  Both sides run with
  cuBLAS's deterministic workspace.  (a) one ``h100-4`` pod (carve 4),
  (sp 4) ring: ``examples/jobs/llama-sp.yaml``'s flags on one host,
  Llama-2-7B widths at 8 layers, B 1 x T 32768, 3 steps; (b) two
  ``h100-2`` pods (carve 2) under (pp 2, fsdp 2), M 4, 8 layers, B 8 x T
  4096, 3 steps, ``$KCTPU_MESH`` as the controller plans it:
  ``examples/jobs/llama-pp.yaml``'s layout, one stage a pod.  Each rank's
  losses must be bit-identical to the gang's rank of the same global
  rank, every rank must sit on a card of its own, the one the inventory
  gave its local rank (the cards' UUIDs), and each rank's flash launches
  must equal the gang's and the prediction (the ring's rank idx (idx +
  1) x 2, idx + 1, idx + 1 a layer a step; a stage's 3, 1, 1 a layer a
  microbatch).  Prints step ms p50, peak GB a card and the first step's
  end after the spawn beside the gang's.  With ``--device-type cpu``, a
  rehearsal: a declared 4-card host, the tiny preset over gloo, pods of
  ``$KCTPU_LOCAL_DEVICES`` ranks, cards and launches not checked.
- ``--pods --inventory``: also (c), two one-pod ``h100-2`` jobs bound at
  once by one inventory of the host (carve 2), each at ``chip_smoke``'s
  phase 23 flags (Llama-2-7B widths, 2 layers, T 4096), run alone on its
  cards and then both at once: each job's losses at once bit-identical
  to its own alone, four distinct cards, each rank on its bound card,
  flash launches 2, 1 and 1 a layer a step a rank; a third ``h100-2``
  gang offered while both hold the host must wait, and take the first
  job's cards once it is released.
- ``--pods --profile``: also (b) once more with ``--profile-dir`` on
  both sides, and each rank's last step read from its trace: the window
  of its last step's ms that ends at its last ``cudaDeviceSynchronize``,
  and in it the device's compute ms (every kernel, copy and set but
  nccl's), nccl's ms and the ms the device ran nothing.
- ``--pods --carve``: the carve question alone, on (b)'s mesh: (pp 2,
  fsdp 2), M 4, 8 layers, B 8 x T 4096, ``CARVE_STEPS`` steps, as one
  ``h100-4`` pod (carve 4) and as two ``h100-2`` pods (carve 2), the
  sides run in turn in ``CARVE_ORDER`` (A B B A A B, so a drift of the
  host over the call falls on both).  A run's step ms is the largest
  rank's p50 of its steps past the first; printed are two pods' median
  run over one pod's, and two pods over one pod in each neighbouring
  pair of runs of the two sides.  Every run's losses must
  be bit-identical rank by rank to the first run's, each rank on its
  bound card, flash launches as (b)'s.

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
- ``--pp --sp``: pipeline parallelism under sequence parallelism, 1F1B
  with ring or Ulysses attention over each stage's own sp group.
  Llama-2-7B widths at 8 layers (4 a stage), B 4 x T 32768, M 4, under
  (pp 2, sp 2) with the ring and with Ulysses, both sides with the
  chunked CE (``--loss-chunks 8``), each against one card at the same
  batch.  ``--pp --sp --experts 8``: the Mixtral-width MoE, 2 layers (1
  a stage), grouped, B 2 x T 8192, under (pp 2, sp 2) with the ring at
  M 2 and at M 1 and with Ulysses at M 1, each against one card; M 2
  also against one card on 2 virtual stages at M 2 (``train(pp=2)``):
  the router penalty is each microbatch's, as the reference's, so at M
  > 1 the pipelined loss is not the one-card step's.  Limits: losses within ``PP_LOSS_RTOL``,
  every rank's equal to rank 0's, each rank's launches those of its sp
  index (flash: the causal ring's rank idx 3(idx + 1), idx + 1 and idx +
  1 a layer a microbatch, Ulysses 3, 1 and 1; the MoE's skip ``gmm`` and
  ``tgmm`` 12 and 3).
  Each run profiles one more step on every rank (compute against nccl,
  the compute idle share by stage beside the bubble (2S - 2) / (M + 2S -
  2)).
- ``--sp --experts 8``: MoE under sequence parallelism, the Mixtral-width
  MoE at 2 layers, B 1 x T 8192, grouped, under (ep 2, sp 2) (``ep,sp``
  meshes) against one card: losses within ``PP_LOSS_RTOL``, ranks equal.
- ``--fake-pg``: each pp mesh's first and last rank alone under torch's
  fake process group (collectives do nothing, DTensor's propagation runs
  in full) at tiny widths in bf16: a one-card check that this torch
  propagates every op of the stage step, before the 4-card call.
- ``--dryrun``: ``graft_entry.dryrun_multichip(cards)``, every parallel
  configuration of ``graft_entry``'s dry run (A, B, B2, B3, C, E, D) over an
  nccl gang of the cards (gloo ranks with ``--device-type cpu``), two
  steps each; one JSON line a configuration: its mesh, each rank's first-
  and second-step ms and losses, and each rank's skip launches of ``gmm``
  and ``tgmm`` (B2 and B3 fail without them on the cards).  With
  ``--fake-pg``, every configuration at 4 and at 8 ranks (the 3-D
  meshes), as the first and the last rank alone under the fake process
  group, each step held to the dry run's guard, then A with ``_w``
  gathering tp too, which the guard must refuse: a one-card check that
  this torch propagates and places them all, and that the guard sees
  its gathers, before the 4-card call.

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
# --pp --sp: examples/jobs/llama-sp.yaml's T at 8 layers, B 4, and the
# chunked CE on both sides (one card's unchunked [4, 32768, 32000] f32
# logits, their log-softmax and gradient take ~50 GB beside ~38 GB of
# state and activations).
PP_SP_ARGV = ["--preset", "llama2-7b", "--n-layers", "8", "--batch-size",
              "4", "--seq-len", "32768", "--steps", "3", "--loss-chunks",
              "8"]
PP_SP_RUNS = tuple(
    (f"pp2_sp2_{kind}", kind, ["--pp", "2", "--sp", "2", "--sp-attention",
                               kind, "--fsdp", "1", "--microbatches", "4",
                               "--profile-step"])
    for kind in ("ring", "ulysses"))
PP_SP_MOE_ARGV = ["--preset", "mixtral-8x7b", "--n-layers", "2", "--top-k",
                  "2", "--moe-dispatch", "grouped", "--strict-moe-dispatch",
                  "--batch-size", "2", "--seq-len", "8192", "--steps", "3"]
PP_SP_MOE_RUNS = tuple(
    (label, kind, ["--pp", "2", "--sp", "2", "--sp-attention", kind,
                   "--fsdp", "1", "--microbatches", m, *profile])
    for label, kind, m, profile in (
        ("moe_pp2_sp2_ring", "ring", "2", ["--profile-step"]),
        ("moe_pp2_sp2_ring_m1", "ring", "1", []),
        ("moe_pp2_sp2_ulysses_m1", "ulysses", "1", [])))
# The MoE's router penalty is each microbatch's (as the reference's), a
# loss of its own at M > 1: one card computes the same on virtual stages.
PP_SP_MOE_VIRTUAL = ["--microbatches", "2", "--virtual-pp", "2"]


def child(argv) -> int:
    """One rank: ``llama_pretrain.main(argv)`` with its ``train`` result
    kept, printed as a ``RESULT`` JSON line, with the ``valid_tiles`` of
    the grouped layouts of its first step.  ``--profile-step``: one more
    step, profiled; ``--virtual-pp S``: one process trains S virtual
    stages (``train(pp=S)``), which ``main`` takes only from a mesh."""
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
    virtual_pp = 0      # --virtual-pp S: train on S virtual stages
    if "--virtual-pp" in argv:
        i = argv.index("--virtual-pp")
        virtual_pp, argv = int(argv[i + 1]), argv[:i] + argv[i + 2:]

    def recording(*args, **kwargs):
        if virtual_pp:
            kwargs["pp"] = virtual_pp
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


# (ranks, rank, control): every configuration of the dry run for that many
# ranks as that rank; the control runs config A with _w gathering every
# mesh dim, tp too, which the guard must refuse.
DRYRUN_FAKE = ((4, 0, ""), (4, 3, ""), (8, 0, ""), (8, 7, ""),
               (8, 0, "control"))


def fake_dryrun_child(argv) -> int:
    """``N RANK DEVICE_TYPE [control]``: each configuration of the dry run
    for N ranks, one step, as rank RANK alone under the fake process
    group, each held to the guard; with ``control``, config A with ``_w``
    gathering every mesh dim, which the guard must refuse.  Collectives
    do nothing there, so a received buffer holds whatever it held: a NaN
    loss is reported and tolerated, any other failure is not."""
    from unittest import mock

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from kubeflow_controller_tpu_torch import graft_entry
    from kubeflow_controller_tpu_torch.models import llama

    n, rank, device_type, *control = argv
    n, rank = int(n), int(rank)
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    device = torch.device("cuda:0" if device_type == "cuda" else "cpu")
    configs = graft_entry._configs(n, device)
    if control:
        def w_everything(p, dtype):
            if isinstance(p, DTensor):
                p = llama.grad_placed(p).redistribute(
                    p.device_mesh, [Replicate()] * p.device_mesh.ndim)
            return p.to(dtype)

        (_, label, cfg, sizes, kind, _), = [c for c in configs
                                            if c[0] == "A"]
        with mock.patch.object(llama, "_w", w_everything):
            try:
                graft_entry.dryrun_step(cfg, sizes, kind, device=device)
                tripped = ""
            except AssertionError as e:
                tripped = str(e)
        print("RESULT " + json.dumps({"rc": 0, "control_tripped":
                                      tripped[:300]}), flush=True)
        return 0 if "gathered whole over tp" in tripped else 1
    status = {}
    for letter, label, cfg, sizes, kind, _ in configs:
        try:
            if kind == "decode":
                graft_entry._decode(cfg, sizes, device)
            else:
                graft_entry.dryrun_step(cfg, sizes, kind, device=device)
            status[letter] = "ok"
        except Exception as e:  # noqa: BLE001 - reported, then judged
            status[letter] = f"{type(e).__name__}: {str(e)[:300]}"
    print("RESULT " + json.dumps({"rc": 0, "configs": status}), flush=True)
    dist.destroy_process_group()
    return 0 if all(v in ("ok", "AssertionError: loss is NaN")
                    for v in status.values()) else 1


def fake_dryrun_main(args) -> int:
    failed = False
    for n, rank, control in DRYRUN_FAKE:
        [(rc, rec)] = run([str(n), str(rank), args.device_type,
                           *([control] if control else [])], 1,
                          [], args.timeout, args.device_type,
                          mode="--fake-dryrun-child")
        print(json.dumps({"fake_pg_dryrun": n, "rank": rank,
                          "control": bool(control), "rc": rc,
                          **(rec or {})}), flush=True)
        failed |= rc != 0
    return 1 if failed else 0


def dryrun_main(args) -> int:
    """``graft_entry``'s dry run over the cards, two steps a
    configuration."""
    sys.path.insert(0, str(HERE))
    from kubeflow_controller_tpu_torch import graft_entry

    ranks = graft_entry.dryrun_multichip(args.cards, args.device_type,
                                         steps=2, timeout_s=args.timeout)
    for i, first in enumerate(ranks[0]):
        recs = [rank[i] for rank in ranks]
        print(json.dumps({
            "dryrun": first["label"], "config": first["config"],
            "mesh": first["mesh"],
            "first_step_ms": [r["ms"][0] for r in recs],
            "second_step_ms": [r["ms"][1] if len(r["ms"]) > 1 else None
                               for r in recs],
            "losses": [r.get("losses") for r in recs],
            "gmm_skip": [r.get("gmm_skip") for r in recs],
            "tgmm_skip": [r.get("tgmm_skip") for r in recs]}), flush=True)
    return 0


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


POD_RUNS = (
    {"label": "a_one_pod_sp4_ring", "job": "llama-sp", "cards": 4,
     "pods": 1, "mesh": None,
     "argv": ["--preset", "llama2-7b", "--n-layers", "8", "--batch-size",
              "1", "--seq-len", "32768", "--steps", "3"],
     "mesh_argv": ["--sp", "4", "--sp-attention", "ring", "--fsdp", "-1"]},
    {"label": "b_two_pods_pp2_fsdp2", "job": "llama-pp", "cards": 2,
     "pods": 2, "mesh": {"dp": 1, "fsdp": 2, "pp": 2},
     "argv": ["--preset", "llama2-7b", "--n-layers", "8", "--batch-size",
              "8", "--seq-len", "4096", "--steps", "3"],
     "mesh_argv": ["--pp", "2", "--fsdp", "2", "--microbatches", "4"]},
)
POD_REHEARSAL_ARGV = ["--preset", "tiny", "--batch-size", "8", "--seq-len",
                      "64", "--steps", "2"]
# --carve: (b)'s mesh as one pod of 4 cards or two of 2, run in turn.
CARVE_SIDES = {"one_pod": (4, 1), "two_pods": (2, 2)}      # cards, pods
CARVE_ORDER = ("one_pod", "two_pods", "two_pods", "one_pod", "one_pod",
               "two_pods")
CARVE_STEPS = 10
# --inventory: two one-pod jobs of this many cards each, at once.
INVENTORY_JOBS = ("inv-x", "inv-y")
INVENTORY_CARDS = 2
PRETRAIN = "kubeflow_controller_tpu_torch.workloads.llama_pretrain"
DETERMINISTIC = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}


def pod_launches(run: dict, rank: int) -> dict:
    """The flash launches ``run`` predicts for global rank ``rank``."""
    argv = run["argv"] + run["mesh_argv"]
    layers, steps = arg(argv, "--n-layers"), arg(argv, "--steps")
    if "--sp" in argv:
        return sp_launches("ring", rank % arg(argv, "--sp"), layers, steps)
    S, M = arg(argv, "--pp"), arg(argv, "--microbatches")
    return {k: v * (layers // S) * M * steps
            for k, v in PP_FLASH_PER_LAYER.items()}


def spawn_reports(cmds, timeout: float) -> tuple:
    """Run ``(argv, env)`` processes at once; their exit codes, each one's
    ``Report`` records by global rank, the spawn's wall clock."""
    sys.path.insert(0, str(HERE))
    import time

    import chip_smoke as cs

    t0 = time.time()
    procs = [subprocess.Popen(argv, cwd=HERE, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv, env in cmds]
    rcs, recs = [], []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        rcs.append(p.returncode)
        recs.append(cs.reports(out + "\n" + err))
        if p.returncode:
            print(f"process failed (exit {p.returncode}):\n{out[-3000:]}\n"
                  f"{err[-3000:]}", file=sys.stderr, flush=True)
    return rcs, recs, t0


def pod_side(label, rcs, by_process, t0) -> dict:
    recs = sorted((r for rs in by_process for r in rs),
                  key=lambda r: r["rank"])
    steps = recs[0]["step_ms"] if recs else []
    return {"side": label, "rcs": rcs,
            "ranks": [{k: r[k] for k in ("rank", "process", "local_rank",
                                         "device", "card", "backend",
                                         "losses", "step_ms", "peak_mem_gb",
                                         "launches")} for r in recs],
            "step_ms_p50": statistics.median(steps) if steps else None,
            "peak_mem_gb_max": max((r["peak_mem_gb"] or 0 for r in recs),
                                   default=None),
            "first_step_s": max((r["first_step_unix"] - t0 for r in recs),
                                default=None)}


def pods_host(cpu: bool):
    """This host's cards (``topology.discover_host``), or for the CPU
    rehearsal a declared host of 4 cards in one NVLink domain."""
    from kubeflow_controller_tpu_torch.cluster import topology

    if cpu:
        return topology.GPUHost(
            "rehearsal", "h100", tuple(
                topology.GPUCard(i, f"GPU-rehearsal-{i}", f"0:{i}")
                for i in range(4)), ((0, 1, 2, 3),))
    return topology.discover_host(socket.gethostname())


def bound_pods(inventory, job: str, pods: int, accel: str, port: int,
               mesh=None, cpu: bool = False) -> list:
    """The env of each pod of a TPU-typed job of ``pods`` slices of
    ``accel``, admitted by ``inventory`` (which sets the pod's
    ``CUDA_VISIBLE_DEVICES``): ``chip_smoke.pod_env`` and the env the
    inventory set on the pod, as the node agent merges them."""
    import chip_smoke as cs
    from kubeflow_controller_tpu_torch.cluster import gpu

    stand_ins = cs.gang_pods(job, pods, accel)
    if not cs.admit(inventory, stand_ins):
        raise RuntimeError(f"{job}: no {pods} free {accel} slices")
    out = []
    for i, pod in enumerate(stand_ins):
        env = {**cs.pod_env(job, i, pods, accel, port, mesh),
               **cs.container_env(pod), **DETERMINISTIC}
        if cpu:
            env.update(KCTPU_LOCAL_DEVICES=str(gpu.slice_cards(accel)),
                       OMP_NUM_THREADS="1")
        out.append(env)
    return out


def cards_as_bound(by_process, envs) -> bool:
    """Each rank of each pod sits on the card the inventory gave its
    local rank: the ``l``-th UUID of its pod's ``CUDA_VISIBLE_DEVICES``."""
    for recs, env in zip(by_process, envs):
        bound = env["CUDA_VISIBLE_DEVICES"].lower().split(",")
        if len(recs) != len(bound) or any(
                r["card"].split()[0].lower() != bound[r["local_rank"]]
                for r in recs):
            return False
    return True


def step_profile(trace_path: Path, step_ms: float) -> dict:
    """The last step of a ``--profile-dir`` trace: the window of
    ``step_ms`` that ends with the last ``cudaDeviceSynchronize`` (each
    step ends in one), and in it the device's compute ms (kernels, copies
    and sets but nccl's), nccl's ms (which wait on the device for their
    peer), the ms the device ran nothing, and the compute idle share."""
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    syncs = [e["ts"] + e["dur"] for e in events
             if e.get("name") == "cudaDeviceSynchronize"]
    device = [e for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    if not syncs or not device:
        return {"wall_ms": step_ms, "device": None}
    hi = max(syncs)
    lo = hi - step_ms * 1e3
    spans = sorted((max(lo, e["ts"]), min(hi, e["ts"] + e["dur"]),
                    "nccl" in e["name"].lower()) for e in device
                   if e["ts"] < hi and e["ts"] + e["dur"] > lo)
    nccl = sum(b - a for a, b, is_nccl in spans if is_nccl) / 1e3
    compute = sum(b - a for a, b, is_nccl in spans if not is_nccl) / 1e3
    busy, end = 0.0, lo
    for a, b, _ in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"wall_ms": step_ms, "compute_ms": compute, "nccl_ms": nccl,
            "idle_ms": step_ms - busy / 1e3,
            "compute_idle_share": 1 - compute / step_ms,
            "device_ops": len(spans)}


def pods_run(run_: dict, host, args, profile: bool = False) -> bool:
    """One ``--pods`` run: the rank-a-process gang, then the pods the
    inventory bound, on the same cards; prints one JSON line, returns
    whether every check held.  ``profile``: both sides trace the loop
    (``--profile-dir``) and each rank's last step is broken down."""
    import tempfile

    from kubeflow_controller_tpu_torch.cluster import gpu

    cpu = args.device_type == "cpu"
    argv = (POD_REHEARSAL_ARGV if cpu else run_["argv"]) + \
        run_["mesh_argv"] + ["--report"]
    world = run_["pods"] * run_["cards"]
    tmp = tempfile.TemporaryDirectory(prefix="pods-profile-")
    prof = Path(tmp.name)
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("KCTPU_", "JAX_", "MODEL_DIR"))}
    base.update(PYTHONPATH=str(HERE), **DETERMINISTIC)
    if cpu:
        base["OMP_NUM_THREADS"] = "1"
    port = free_port()
    gang = [([sys.executable, "-m", PRETRAIN, *argv, "--device",
              "cpu" if cpu else f"cuda:{r}",
              *(["--profile-dir", str(prof / "gang" / f"rank-{r}")]
                if profile else [])],
             {**base, "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
              "JAX_NUM_PROCESSES": str(world), "JAX_PROCESS_ID": str(r)})
            for r in range(world)]
    ranks = pod_side("rank_a_process", *spawn_reports(gang, args.timeout))
    inventory = gpu.GPUInventory(gpu.carve(host, run_["cards"]))
    envs = bound_pods(inventory, run_["job"], run_["pods"],
                      f"{host.family}-{run_['cards']}", free_port(),
                      run_["mesh"], cpu)
    cmds = [([sys.executable, "-m", PRETRAIN, *argv, "--device",
              "cpu" if cpu else "cuda",
              *(["--profile-dir", str(prof / "pods")] if profile else [])],
             env) for env in envs]
    rcs, by_process, t0 = spawn_reports(cmds, args.timeout)
    launched = pod_side("pods", rcs, by_process, t0)
    a, b = ranks["ranks"], launched["ranks"]
    same = (len(a) == len(b) == world
            and all(x["losses"] == y["losses"] for x, y in zip(a, b)))
    distinct = cpu or len({r["card"] for r in b}) == world
    bound = cpu or cards_as_bound(by_process, envs)
    want = [pod_launches(run_, r) for r in range(world)]
    flash = [{k: r["launches"][k] for k in FLASH_KERNELS} for r in b]
    exact = (flash == [{k: r["launches"][k] for k in FLASH_KERNELS}
                       for r in a] and (cpu or flash == want))
    ms = (launched["step_ms_p50"] / ranks["step_ms_p50"]
          if launched["step_ms_p50"] and ranks["step_ms_p50"] else None)
    rec = {
        "pods": run_["label"] + ("_profiled" if profile else ""),
        "slices": [inventory.placement_of(f"{run_['job']}-")],
        "visible_devices": [env["CUDA_VISIBLE_DEVICES"] for env in envs],
        "world": world, "argv": argv, "losses_bit_identical": same,
        "cards_distinct": distinct, "cards_as_bound": bound,
        "launches_exact": exact,
        "flash_launches_predicted": None if cpu else want,
        "step_ms_p50_pods_over_ranks": ms,
        "first_step_s_pods_minus_ranks": (
            launched["first_step_s"] - ranks["first_step_s"]
            if launched["first_step_s"] is not None
            and ranks["first_step_s"] is not None else None),
        "rank_a_process": ranks, "launched": launched}
    if profile:
        rec["last_step_profile"] = {
            side: [step_profile(prof / sub / f"rank-{r['rank']}" /
                                "trace.json", r["step_ms"][-1])
                   for r in recs["ranks"]]
            for side, sub, recs in (("rank_a_process", "gang", ranks),
                                    ("pods", "pods", launched))}
    tmp.cleanup()
    print(json.dumps(rec), flush=True)
    return not (any(ranks["rcs"]) or any(launched["rcs"]) or not same
                or not distinct or not bound or not exact)


def inventory_run(host, args) -> bool:
    """``--inventory``: two one-pod jobs of ``INVENTORY_CARDS`` cards bound
    at once by one inventory of this host, each run alone on its cards,
    then both at once; a third job's gang waits until one is released.
    Prints one JSON line, returns whether every check held."""
    import chip_smoke as cs
    from kubeflow_controller_tpu_torch.cluster import gpu

    cpu = args.device_type == "cpu"
    argv = (POD_REHEARSAL_ARGV if cpu else cs.POD_ARGV) + ["--report"]
    inventory = gpu.GPUInventory(gpu.carve(host, INVENTORY_CARDS))
    accel = f"{host.family}-{INVENTORY_CARDS}"
    envs = {job: bound_pods(inventory, job, 1, accel, free_port(),
                            cpu=cpu)[0]
            for job in INVENTORY_JOBS}
    third = cs.gang_pods("inv-z", 1, accel)
    held = not cs.admit(inventory, third)
    cmd = [sys.executable, "-m", PRETRAIN, *argv, "--device",
           "cpu" if cpu else "cuda"]
    alone = {job: pod_side(job, *spawn_reports([(cmd, envs[job])],
                                               args.timeout))
             for job in INVENTORY_JOBS}
    rcs, by_process, t0 = spawn_reports(
        [(cmd, envs[job]) for job in INVENTORY_JOBS], args.timeout)
    both = {job: pod_side(job, [rc], [recs], t0)
            for job, rc, recs in zip(INVENTORY_JOBS, rcs, by_process)}
    inventory.release_gang(f"{INVENTORY_JOBS[0]}-")
    admitted_after = cs.admit(inventory, third)
    cards = [r["card"] for recs in by_process for r in recs]
    layers = arg(argv, "--n-layers") if "--n-layers" in argv else 0
    steps = arg(argv, "--steps")
    want = {"flash_fwd": 2 * layers * steps, "flash_dq": layers * steps,
            "flash_dkv": layers * steps}
    same = all(
        [r["losses"] for r in alone[j]["ranks"]]
        == [r["losses"] for r in both[j]["ranks"]]
        and len(both[j]["ranks"]) == INVENTORY_CARDS
        for j in INVENTORY_JOBS)
    distinct = cpu or len(set(cards)) == len(INVENTORY_JOBS) * \
        INVENTORY_CARDS
    bound = cpu or cards_as_bound(by_process, list(envs.values()))
    exact = cpu or all({k: r["launches"][k] for k in FLASH_KERNELS} == want
                       for j in INVENTORY_JOBS for r in both[j]["ranks"])
    third_cards = cs.container_env(third[0])["CUDA_VISIBLE_DEVICES"]
    rec = {
        "inventory": "c_two_jobs_one_host", "argv": argv,
        "visible_devices": {j: e["CUDA_VISIBLE_DEVICES"]
                            for j, e in envs.items()},
        "third_held_while_both_bound": held,
        "third_admitted_after_release": admitted_after,
        "third_took_the_released_cards": (
            third_cards == envs[INVENTORY_JOBS[0]]["CUDA_VISIBLE_DEVICES"]),
        "losses_bit_identical_to_alone": same, "cards_distinct": distinct,
        "cards_as_bound": bound, "launches_exact": exact,
        "flash_launches_predicted": None if cpu else want,
        "step_ms_p50_at_once_over_alone": {
            j: (both[j]["step_ms_p50"] / alone[j]["step_ms_p50"]
                if both[j]["step_ms_p50"] and alone[j]["step_ms_p50"]
                else None) for j in INVENTORY_JOBS},
        "alone": alone, "at_once": both}
    print(json.dumps(rec), flush=True)
    return not (any(rcs) or any(rc for s in alone.values() for rc in s["rcs"])
                or not held or not admitted_after
                or not rec["third_took_the_released_cards"] or not same
                or not distinct or not bound or not exact)


def carve_run(host, args) -> bool:
    """``--carve``: (b)'s mesh as one pod of 4 cards and as two pods of 2,
    in ``CARVE_ORDER``.  Prints one JSON line a run and one of the
    comparison; returns whether every check held."""
    from kubeflow_controller_tpu_torch.cluster import gpu

    cpu = args.device_type == "cpu"
    base = POD_REHEARSAL_ARGV if cpu else POD_RUNS[1]["argv"]
    steps = base.index("--steps") + 1
    run_ = {**POD_RUNS[1], "argv": base[:steps] + [str(CARVE_STEPS)]
            + base[steps + 1:]}
    argv = run_["argv"] + run_["mesh_argv"] + ["--report"]
    world = 4
    want = None if cpu else [pod_launches(run_, r) for r in range(world)]
    runs, ok, first = [], True, None
    for label in CARVE_ORDER:
        cards, pods = CARVE_SIDES[label]
        inventory = gpu.GPUInventory(gpu.carve(host, cards))
        envs = bound_pods(inventory, run_["job"], pods,
                          f"{host.family}-{cards}", free_port(),
                          run_["mesh"], cpu)
        cmds = [([sys.executable, "-m", PRETRAIN, *argv, "--device",
                  "cpu" if cpu else "cuda"], env) for env in envs]
        rcs, by_process, t0 = spawn_reports(cmds, args.timeout)
        side = pod_side(label, rcs, by_process, t0)
        ranks = side["ranks"]
        losses = [r["losses"] for r in ranks]
        first = losses if first is None else first
        rec = {
            "carve": label, "visible_devices": [e["CUDA_VISIBLE_DEVICES"]
                                                for e in envs],
            "rcs": rcs,
            "step_ms_p50_past_first": [
                statistics.median(r["step_ms"][1:]) for r in ranks],
            "first_step_s": side["first_step_s"],
            "peak_mem_gb_max": side["peak_mem_gb_max"],
            "losses_bit_identical_to_first_run": (
                len(ranks) == world and losses == first),
            "cards_distinct": cpu or len({r["card"] for r in ranks}) == world,
            "cards_as_bound": cpu or cards_as_bound(by_process, envs),
            "launches_exact": cpu or [
                {k: r["launches"][k] for k in FLASH_KERNELS}
                for r in ranks] == want}
        print(json.dumps(rec), flush=True)
        ok &= not any(rcs) and all(rec[k] for k in (
            "losses_bit_identical_to_first_run", "cards_distinct",
            "cards_as_bound", "launches_exact"))
        runs.append(rec)
    for r in runs:
        r["ms"] = max(r["step_ms_p50_past_first"])
    ms = {label: [r["ms"] for r in runs if r["carve"] == label]
          for label in CARVE_SIDES}
    print(json.dumps({
        "carve_compare": "two_pods_over_one_pod", "argv": argv,
        "step_ms_by_run": ms,
        "ratio_of_medians": (statistics.median(ms["two_pods"])
                             / statistics.median(ms["one_pod"])),
        "ratios_of_neighbours": [
            (b["ms"] / a["ms"]) if b["carve"] == "two_pods"
            else (a["ms"] / b["ms"])
            for a, b in zip(runs, runs[1:]) if a["carve"] != b["carve"]],
        "all_checks": ok}), flush=True)
    return ok


def pods_main(args) -> int:
    """The ``--pods`` runs, ``--inventory``'s and ``--profile``'s (see the
    docstring)."""
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    host = pods_host(args.device_type == "cpu")
    print("host " + json.dumps(
        {"name": host.name, "family": host.family,
         "cards": [[c.index, c.uuid, c.pci_bus_id] for c in host.cards],
         "nvlink_domains": [list(d) for d in host.nvlink_domains],
         **({} if args.device_type == "cpu" else {"card": cs.card_line()})}),
        flush=True)
    if args.carve:
        return 0 if carve_run(host, args) else 1
    ok = all([pods_run(run_, host, args) for run_ in POD_RUNS])
    if args.inventory:
        ok &= inventory_run(host, args)
    if args.profile:
        ok &= pods_run(POD_RUNS[1], host, args, profile=True)
    return 0 if ok else 1


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
                         "layers, (pp 4) at 32, config B3; with --sp, "
                         "(pp 2, sp 2) ring and Ulysses at T 32768 (with "
                         "--experts, the MoE at T 8192)")
    ap.add_argument("--fake-pg", action="store_true",
                    help="each pp mesh's first and last rank alone under "
                         "the fake process group")
    ap.add_argument("--dryrun", action="store_true",
                    help="graft_entry's dry run over the "
                         "cards; with --fake-pg, every config at 4 and 8 "
                         "ranks under the fake process group")
    ap.add_argument("--pods", action="store_true",
                    help="TPU-typed pods through the pod's launcher, one "
                         "rank a card, their cards bound by the inventory, "
                         "against the rank-a-process gang")
    ap.add_argument("--inventory", action="store_true",
                    help="with --pods: two one-pod h100-2 jobs bound at "
                         "once on this host, run alone and together")
    ap.add_argument("--profile", action="store_true",
                    help="with --pods: run (b) again with every rank's "
                         "last step profiled on both sides")
    ap.add_argument("--carve", action="store_true",
                    help="with --pods: only (b)'s mesh, as one h100-4 pod "
                         "and as two h100-2 pods, run in turn")
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
    ap.add_argument("--fake-dryrun-child", nargs=argparse.REMAINDER,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        return child(args.child)
    if args.fake_child is not None:
        return fake_child(args.fake_child)
    if args.fake_dryrun_child is not None:
        return fake_dryrun_child(args.fake_dryrun_child)
    if args.fake_pg and args.dryrun:
        return fake_dryrun_main(args)
    if args.fake_pg:
        return fake_main(args)
    if args.dryrun and args.device_type == "cpu":
        return dryrun_main(args)
    if args.generate_child is not None:
        return generate_child(args.generate_child)
    if args.generate and args.device_type == "cpu":
        return generate_main(args)
    if args.pods and args.device_type == "cpu":
        return pods_main(args)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(card[0], f"x {len(card)}", flush=True)
    if args.dryrun:
        return dryrun_main(args)
    if args.pods:
        return pods_main(args)
    if args.pp and args.sp:
        return pp_sp_main(args)
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


def idle_by_stage(res, sp: int) -> list:
    """Each stage's ranks' compute idle shares in the profiled step."""
    shares = [((rec or {}).get("profile") or {}).get("compute_idle_share")
              for _, rec in res]
    return [shares[s * sp:(s + 1) * sp] for s in range(len(shares) // sp)]


def pp_sp_main(args) -> int:
    """The ``--pp --sp`` runs (see the docstring): the dense model, or with
    ``--experts`` the MoE."""
    sys.path.insert(0, str(HERE))
    from chip_smoke import pp_sp_launches_per_layer

    moe = bool(args.experts)
    argv = (PP_SP_MOE_ARGV + ["--experts", str(args.experts)] if moe
            else PP_SP_ARGV)
    [(rc, one)] = run(argv, 1, [], args.timeout)
    failed = rc != 0
    if one is not None:
        print(json.dumps({"run": "one card", "argv": argv, **one}),
              flush=True)
    virtual = None
    if moe:
        [(rc, virtual)] = run(argv, 1, PP_SP_MOE_VIRTUAL, args.timeout)
        failed |= rc != 0 or virtual is None
        if virtual is not None:
            print(json.dumps({"run": "one card, virtual stages",
                              "extra": PP_SP_MOE_VIRTUAL, **virtual}),
                  flush=True)
    for label, kind, extra in PP_SP_MOE_RUNS if moe else PP_SP_RUNS:
        res = run(argv, args.cards, extra, args.timeout)
        S, sp = arg(extra, "--pp"), arg(extra, "--sp")
        M = arg(extra, "--microbatches")
        steps = arg(argv, "--steps") + ("--profile-step" in extra)
        per_stage = arg(argv, "--n-layers") // S
        want = [{k: v * per_stage * M * steps for k, v in
                 pp_sp_launches_per_layer(kind, rank % sp).items()}
                for rank in range(args.cards)]
        got = [(rec or {}).get("flash_launches") for _, rec in res]
        grouped = [(rec or {}).get("grouped_launches") for _, rec in res]
        skip = {f"{k}_skip": v * per_stage * M * steps
                for k, v in PP_SKIP_PER_LAYER.items()}
        extra_rec = {}
        if moe:
            extra_rec = {"grouped_launches_by_rank": grouped,
                         "skip_predicted": skip}
            failed |= any(g is None or g["gmm_swiglu"]
                          or any(g[k] != v for k, v in skip.items())
                          for g in grouped)
        if moe and M > 1:
            # Against the same loss on one card (virtual stages, M alike).
            losses = (res[0][1] or {}).get("losses", [])
            rel = (max((abs(a - b) / abs(b) for a, b in
                        zip(losses, virtual["losses"])), default=None)
                   if virtual and losses else None)
            extra_rec.update(losses_one_card_virtual_stages=virtual and
                             virtual["losses"],
                             loss_rel_diff_max_vs_virtual_stages=rel)
            failed |= rel is None or rel > PP_LOSS_RTOL
        failed |= compare(label, one, res, {
            **extra_rec,
            "flash_launches_by_rank": got,
            "flash_launches_predicted": want,
            "profile_by_rank": [(rec or {}).get("profile")
                                for _, rec in res],
            "compute_idle_share_by_stage": idle_by_stage(res, sp),
            "bubble_share": (2 * S - 2) / (M + 2 * S - 2)})
        failed |= got != want
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
