"""Llama pretrain driver — the port of
``kubeflow_controller_tpu/workloads/llama_pretrain.py``.

    python -m kubeflow_controller_tpu_torch.workloads.llama_pretrain \\
        [--preset tiny|llama2-7b|mixtral-8x7b] [--steps N]
        [--device cuda|cpu] ...

Same flags as the reference (``--device``, default ``cuda``, takes the
place of ``--platform``) and the same closing lines ("Training elapsed
time", "Final loss ...; throughput ... tokens/s").  Each step is
``llama_loss`` -> backward -> clip by global norm -> AdamW, on synthetic
bigram tokens (``data.synthetic_tokens``, seed 1: the reference's
``PRNGKey(1)``).  The loop itself is :func:`train`, which takes a
``LlamaConfig``, so a caller can drive it at a cut depth.

Checkpoint/resume (``MODEL_DIR``, as in the reference): :func:`train`
restores the latest readable step of the model and its optimizer and
prints "Resumed from step S in <dir>", then runs steps ``S .. S + steps -
1`` (batch ``i`` is still taken by ``i``, so the data does not restart),
saves asynchronously after every ``--checkpoint-every`` steps, and makes
the final step durable before it returns.

Progress beats (``KCTPU_PROGRESS_*``, as the trainer's loop beats them):
``phase="restore"`` while a checkpoint loads; on CUDA ``phase="compile"``
while the kernels build (``compile_cache.build_kernels``); then
``phase="fit"`` with the step, loss and sequences/s after the first step,
at most every ``BEAT_INTERVAL_S`` after that and once at the end, the
first carrying ``compile_source`` and, on a resume, ``resumed_from_step``.

MoE: ``--experts E`` (with ``--top-k`` and ``--moe-dispatch``
einsum|scatter|grouped) trains a mixture-of-experts model; "grouped" runs
the dropless grouped-matmul CUDA kernels forward and backward, and falls
back to "einsum" with a warning where they cannot take the operands (the
tiny preset is f32); ``--strict-moe-dispatch`` makes that fallback an
error.  On the CPU every dispatch runs as asked, through the kernels' plain
versions.  ``--preset mixtral-8x7b`` (the port's own, beside the
reference's two) takes Mixtral-8x7B's published widths with f32
parameters and bf16 activations; with ``--n-layers`` it fits a card.

A gang and a mesh (as in the reference): ``JobRuntime.initialize`` joins
the job's gang (``JAX_*`` env from the controller; gloo for ``--device
cpu``, nccl on CUDA, one device a process), and when a process group
exists (that gang, or a group the caller formed) the model trains on a
``DeviceMesh`` of the ``--dp``/``--fsdp``/``--tp`` flags, which the
controller's ``$KCTPU_MESH`` overrides: parameters are DTensors, built
already sharded one at a time (``llama_init(mesh=)``: fsdp shards the
embed dim and is gathered before each use, tp shards heads, mlp and vocab,
ep the experts, dp and sp replicate), the global batch is rounded to the
data parallel size and each process stages its own ``("batch", "seq")``
shard.  MoE runs per shard under the mesh (``--ep``; "grouped" takes the
ep-sharded dropless path, ``models/moe.py``).  ``--sp N`` shards the
sequence N ways (T must divide by N, and on CUDA by N x 64 for the flash
kernels; else the dense inner) and ``--sp-attention`` takes ring or
Ulysses attention (``models/llama.py``).  Each process prints "Mesh:
{...} over N devices, process i/n".

MoE under ``--sp`` routes each sequence shard's tokens; the capacity
dispatches count positions over the whole sequence (``models/moe.py``).

Pipeline parallelism (as in the reference): ``--pp S --microbatches M``
trains the layers as S stages under the 1F1B schedule
(``models/llama.py:llama_loss_and_grads_pp``), one stage a process over the
mesh's pp group, the other axes sharding within each stage; pp must divide
the layers, and the global batch is rounded to ``dp_size x M``.
:func:`train` also takes ``pp`` without a group, as virtual stages in one
process (one card).  The clip's norm spans every stage.  With ``--sp``
too, each stage runs ring or Ulysses attention (``--sp-attention``) over
its own sp group, and every rank keeps and hands off its T/sp shard of
the activations.

Without a group, an axis above 1 asks for more devices than the one there
is, and raises ``ValueError`` as the reference's mesh does.

A pod of several local devices (``launch.py``: ``$KCTPU_LOCAL_DEVICES``, or
``--device cuda`` under the controller's contract on a host of several
cards) runs one rank a device, as the reference's pod drives every
``jax.devices()`` entry: ``main`` starts the pod's ranks, each rank trains
on its own card over the world of every pod's devices, and local rank 0
prints the pod's one mesh line, "Mesh: {...} over W devices, process
i/n"; each rank prints its "Rank g/W" line and its losses.  ``--report``
prints one ``Report: {...}`` JSON line a rank (its losses, step ms, peak
memory, first step's end, kernel launches and card), which the card
tools read.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import warnings
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from ..device import DeviceLike, rank_device, resolve_device
from ..models.llama import (
    Llama,
    LlamaConfig,
    llama_init,
    llama_loss,
    llama_loss_and_grads_pp,
    model_mesh,
    pp_group,
    pp_size,
    pp_stage,
    shard_llama,
)
from ..parallel.mesh import MeshSpec, build_mesh, data_parallel_size
from ..obs.phases import PHASE_FIT, PHASE_RESTORE
from .checkpoint import CheckpointManager
from .compile_cache import build_kernels
from .data import synthetic_tokens
from .launch import launch_pod
from .progress import reporter
from .runtime import JobRuntime, global_rank, world_size
from .trainer import BEAT_INTERVAL_S, default_optimizer


@dataclass
class TrainResult:
    losses: List[float]        # per step
    step_s: List[float]        # per step, wall, ending in a device sync
    elapsed_s: float
    tokens_per_s: float
    model: Llama
    # Step i of the same loop (same optimizer state, same token rows), for
    # a caller that runs further steps, e.g. under a profiler.
    step: Callable[[int], float]
    start_step: int = 0        # the checkpoint step resumed from (0: none)
    # The run's checkpoint manager (timings in .events) and the line that
    # says where the final step is.
    checkpoint: Optional[CheckpointManager] = None
    checkpoint_note: str = ""
    first_step_unix: float = 0.0   # wall clock at the first step's end


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(cfg: LlamaConfig, *, steps: int, batch_size: int, seq_len: int,
          lr: float = 3e-4, device: DeviceLike = "cuda", seed: int = 0,
          model: Optional[Llama] = None,
          profile_dir: str = "", model_dir: str = "",
          checkpoint_every: int = 0, mesh=None, pp: int = 1,
          microbatches: int = 4) -> TrainResult:
    """``steps`` optimizer steps of ``cfg`` from ``llama_init`` (seeded
    with ``seed``) or from ``model`` (trained in place), the reference's
    loop: ``default_optimizer(lr, weight_decay=0.1)`` (clip 1.0), and batch
    i is rows ``[(i * bs) % (N - bs + 1), ... + bs)`` of ``N = max(64, 2 *
    bs)`` synthetic sequences of seed 1.

    With ``model_dir``, the latest readable checkpoint there is restored
    first (model and optimizer; the loop runs steps ``S .. S + steps -
    1``), step ``i + 1`` is saved asynchronously after step ``i`` whenever
    ``checkpoint_every`` divides it, and the final step ``S + steps`` is
    durable when this returns.  Beats progress as the module docstring
    says.

    With ``mesh`` (a ``build_mesh`` mesh) the model is built sharded on it
    one parameter at a time (``llama_init(mesh=)``; a given ``model`` is
    sharded whole by ``shard_llama``), the batch is rounded down to a
    multiple of the data parallel size (at least one row a shard), each
    process stages its own shard of every batch (in ``llama_loss``, which
    builds the shifted targets from the global batch first when sp shards
    T), and the losses are the global batch's.

    Pipeline parallelism: on a mesh with a pp axis above 1 each process
    builds and trains its own stage (``pp`` is the mesh's); without one,
    ``pp`` above 1 runs that many virtual stages in this process.  Each
    step is ``llama_loss_and_grads_pp`` over ``microbatches`` microbatches
    (the batch rounded to a multiple of the data parallel size times
    them), then the clip over every stage's gradients and AdamW."""
    dev = resolve_device(device)
    rep = reporter()
    if pp_size(mesh) > 1:
        if model is not None:
            raise ValueError("under a pp mesh each process builds its own "
                             "stage: pass no model")
        pp = pp_size(mesh)
    if model is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = llama_init(cfg, gen, dev, requires_grad=True, mesh=mesh)
    elif mesh is not None:
        shard_llama(model, mesh)
    if pp > 1 and cfg.n_layers % pp:
        raise ValueError(f"pp {pp} does not divide n_layers {cfg.n_layers}")
    full_mesh = mesh
    if mesh is not None:
        mesh = model_mesh(mesh)
    opt = default_optimizer(model.parameters(), lr, weight_decay=0.1)
    if pp_size(full_mesh) > 1:
        opt.over_stages(pp_group(full_mesh),
                        [model.embed, model.final_norm, model.lm_head],
                        pp_stage(full_mesh) == 0)
    start_step, ckpt = 0, None
    if model_dir:
        ckpt = CheckpointManager(model_dir)
        if ckpt.latest_step() is not None:
            rep.beat(phase=PHASE_RESTORE)
            _, _, start_step = ckpt.restore(model, opt)
            print(f"Resumed from step {start_step} in {model_dir}",
                  flush=True)
    unit = 1 if mesh is None else data_parallel_size(mesh)
    if pp > 1:
        unit *= microbatches
    bs = max(unit, batch_size - batch_size % unit)
    tokens_all = synthetic_tokens(1, max(64, 2 * bs), seq_len,
                                  cfg.vocab_size, dev)

    def step(i: int) -> float:
        lo = (i * bs) % max(1, tokens_all.shape[0] - bs + 1)
        tokens = tokens_all[lo:lo + bs]
        if pp > 1:
            loss, _ = llama_loss_and_grads_pp(
                model, tokens, cfg, full_mesh, n_microbatches=microbatches,
                n_stages=pp)
        else:
            loss = llama_loss(model, tokens, cfg, mesh)
            loss.backward()
            if mesh is not None:
                loss = loss.to_local()      # replicated: the global mean
        opt.step()
        opt.zero_grad()
        return float(loss.detach())

    prof = contextlib.nullcontext()
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else []))
    # The port's compile, up front: the kernels' build (a cache hit when
    # this content was built before); no step, no build.
    compile_source = build_kernels(dev, rep) if steps > 0 else ""
    losses, step_s = [], []
    first_step_unix = 0.0
    next_beat = 0.0
    with prof:
        _sync(dev)
        start = time.perf_counter()
        for i in range(start_step, start_step + steps):
            t0 = time.perf_counter()
            losses.append(step(i))
            if ckpt and checkpoint_every and (i + 1) % checkpoint_every == 0:
                ckpt.save(i + 1, model, opt, wait=False)  # overlaps step i+1
            _sync(dev)
            now = time.perf_counter()
            step_s.append(now - t0)
            first_step_unix = first_step_unix or time.time()
            if now >= next_beat or i + 1 == start_step + steps:
                next_beat = now + BEAT_INTERVAL_S
                rep.beat(step=i + 1, loss=losses[-1], phase=PHASE_FIT,
                         compile_source=compile_source,
                         resumed_from_step=start_step or None,
                         examples_per_sec=(i + 1 - start_step) * bs
                         / (now - start))
        elapsed = time.perf_counter() - start
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        print(f"Profile trace written to {profile_dir}")
    note = ""
    if ckpt:
        # Durability barrier: the in-loop save of the final step (issued
        # this run) is waited for; a final step already on disk is left;
        # anything else is saved now.
        final = start_step + steps
        ckpt.wait()
        if steps > 0 and checkpoint_every and final % checkpoint_every == 0:
            note = f"Checkpoint saved to {model_dir}"
        elif ckpt.latest_step() == final:
            note = f"Checkpoint for step {final} already in {model_dir}"
        else:
            ckpt.save(final, model, opt)
            note = f"Checkpoint saved to {model_dir}"
    return TrainResult(losses, step_s, elapsed,
                       steps * bs * seq_len / max(elapsed, 1e-9), model, step,
                       start_step, ckpt, note, first_step_unix)


def mixtral_8x7b() -> LlamaConfig:
    """mistralai/Mixtral-8x7B-v0.1's config.json widths (32 layers, 8
    experts, top-2), trained as the reference trains: f32 parameters, bf16
    activations, remat "full", attention "auto"."""
    return dataclasses.replace(
        LlamaConfig.llama2_7b(), vocab_size=32000, dim=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, intermediate=14336, max_seq_len=32768,
        rope_theta=1e6, norm_eps=1e-5, n_experts=8, moe_top_k=2)


PRESETS = {"tiny": None, "llama2-7b": LlamaConfig.llama2_7b,
           "mixtral-8x7b": mixtral_8x7b}


def card_id(dev: torch.device) -> str:
    """The card's UUID (``nvidia-smi -L``'s ``GPU-...``) and PCI bus id,
    else the device."""
    if dev.type != "cuda":
        return str(dev)
    props = torch.cuda.get_device_properties(dev)
    pci = ":".join(f"{getattr(props, k, 0):02x}" for k in (
        "pci_domain_id", "pci_bus_id", "pci_device_id"))
    return f"GPU-{getattr(props, 'uuid', '')} pci {pci}"


def report(rt: JobRuntime, res: TrainResult, dev: torch.device,
           card: str) -> dict:
    """This rank's run: who and where it is, its exact losses, step ms,
    peak memory, the wall clock at its first step's end, and the kernel
    launches of the process (each wrapper's counter)."""
    import torch.distributed as dist

    from ..ops import attention, grouped_matmul as gm

    return {
        "rank": global_rank(), "world": world_size(),
        "process": rt.process_id, "processes": rt.num_processes,
        "local_rank": rt.local_rank, "local_devices": rt.local_devices,
        "launched": rt.launched, "device": str(dev), "card": card,
        "backend": dist.get_backend() if dist.is_initialized() else "",
        "losses": res.losses, "step_ms": [x * 1e3 for x in res.step_s],
        "first_step_unix": res.first_step_unix,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None),
        "launches": {
            **{k: getattr(attention, k).launches
               for k in ("flash_fwd", "flash_dq", "flash_dkv")},
            "gmm": gm.gmm.launches, "gmm_skip": gm.gmm.skip_launches,
            "gmm_swiglu": gm.gmm_swiglu.launches, "tgmm": gm.tgmm.launches,
            "tgmm_skip": gm.tgmm.skip_launches}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="llama pretrain")
    # The classic TF contract the controller hands Worker replicas; a gang
    # outside the controller can come from --worker_hosts/--task_index.
    p.add_argument("--job_name", default="")
    p.add_argument("--task_index", type=int, default=-1)
    p.add_argument("--worker_hosts", default="")
    p.add_argument("--ps_hosts", default="")
    p.add_argument("--preset", choices=list(PRESETS), default="tiny")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=8,
                   help="global batch (sequences)")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--fsdp", type=int, default=-1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline stages (1F1B over the mesh's pp axis)")
    p.add_argument("--microbatches", type=int, default=4,
                   help="pipeline microbatches per step when --pp > 1")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel mesh extent")
    p.add_argument("--experts", type=int, default=0,
                   help="MoE expert count (0 = dense FFN)")
    p.add_argument("--top-k", type=int, default=2, help="MoE router top-k")
    p.add_argument("--moe-dispatch", choices=["einsum", "scatter", "grouped"],
                   default="einsum",
                   help="MoE routing implementation; 'grouped' = dropless "
                        "grouped-matmul CUDA kernels (falls back to einsum, "
                        "with a warning, for operands they do not take: not "
                        "bf16, or dims not multiples of 8)")
    p.add_argument("--strict-moe-dispatch", action="store_true",
                   help="fail instead of falling back when --moe-dispatch "
                        "cannot run (installed as a warnings filter on "
                        "'moe dispatch')")
    p.add_argument("--n-layers", type=int, default=0,
                   help="cut the preset to this many layers (0 = the "
                        "preset's): Llama-2-7B widths on one card")
    p.add_argument("--dim", type=int, default=0,
                   help="model dim override for the tiny preset (0 = preset "
                        "default)")
    p.add_argument("--intermediate", type=int, default=0,
                   help="FFN intermediate override for the tiny preset")
    p.add_argument("--sp-attention", choices=["ring", "ulysses"],
                   default="ring",
                   help="sequence-parallel attention schedule when --sp > 1")
    p.add_argument("--remat-policy", default="",
                   choices=["", "full", "dots", "ffn", "gateup", "gateup_attn",
                            "moe"],
                   help="rematerialization policy override; empty = config "
                        "default (the port has 'full')")
    p.add_argument("--loss-chunks", type=int, default=0,
                   help="chunked cross-entropy over N sequence chunks "
                        "(0 = dense logits)")
    p.add_argument("--attention", default="",
                   choices=["", "auto", "flash", "xla"],
                   help="attention implementation override; empty = config "
                        "default (the CUDA flash kernels at T >= 1024)")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace of the training loop "
                        "here (trace.json); 'auto' = LOG_DIR/trace when "
                        "LOG_DIR is plumbed")
    p.add_argument("--device", default="cuda",
                   help="torch device (raises without CUDA unless 'cpu' is "
                        "named); 'cuda' in a pod of several cards runs one "
                        "rank a card")
    p.add_argument("--report", action="store_true",
                   help="print one 'Report: {...}' JSON line a rank")
    args = p.parse_args(argv)

    rt = JobRuntime.from_env()
    rt.merge_tf_args(args.job_name, args.task_index, args.worker_hosts)
    code = launch_pod(__spec__.name, argv, args.device, rt)
    if code is not None:
        return code     # the pod's ranks ran
    dev = rank_device(args.device)
    rt.check_mesh()

    # Mesh axes: the flags, or the controller's plan ($KCTPU_MESH, for the
    # gang's current width) where there is one, as in the reference.
    axes = {"dp": args.dp, "fsdp": args.fsdp, "tp": args.tp,
            "sp": args.sp, "pp": args.pp, "ep": args.ep}
    if rt.mesh:
        axes.update({k: v for k, v in rt.mesh.items() if k in axes})
    if args.strict_moe_dispatch:
        warnings.filterwarnings("error", message="moe dispatch")

    tiny_overrides = {"max_seq_len": args.seq_len}
    if args.dim:
        tiny_overrides.update(dim=args.dim,
                              n_heads=max(4, args.dim // 16),
                              n_kv_heads=max(2, args.dim // 32))
    if args.intermediate:
        tiny_overrides["intermediate"] = args.intermediate
    cfg = (PRESETS[args.preset]() if PRESETS[args.preset]
           else LlamaConfig.tiny(**tiny_overrides))
    overrides = {}
    if args.sp_attention != cfg.sp_attention:
        overrides["sp_attention"] = args.sp_attention
    if args.experts:
        overrides.update(n_experts=args.experts, moe_top_k=args.top_k,
                         moe_dispatch=args.moe_dispatch)
    if args.remat_policy:
        overrides.update(remat=True, remat_policy=args.remat_policy)
    if args.n_layers:
        overrides["n_layers"] = args.n_layers
    if args.loss_chunks:
        overrides["loss_chunks"] = args.loss_chunks
    if args.attention:
        overrides["attention"] = args.attention
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    pp = axes["pp"]
    if pp > 1 and cfg.n_layers % pp:
        p.error(f"pp {pp} does not divide n_layers {cfg.n_layers}")
    import torch.distributed as dist

    joined = not dist.is_initialized()
    rt.initialize(dev)
    joined = joined and dist.is_initialized()
    spec = MeshSpec(dp=axes["dp"], fsdp=axes["fsdp"], tp=axes["tp"],
                    sp=axes["sp"], pp=axes["pp"], ep=axes["ep"])
    if dist.is_initialized():
        mesh = build_mesh(spec, dev.type)
    else:
        spec.resolve(1)     # one device: an axis above 1 raises here
        mesh = None

    profile_dir = args.profile_dir
    if profile_dir == "auto":
        profile_dir = os.path.join(rt.log_dir, "trace") if rt.log_dir else ""
    if profile_dir and rt.launched:     # a pod's ranks share its argv
        profile_dir = os.path.join(profile_dir, f"rank-{rt.global_rank}")
    res = train(cfg, steps=args.steps, batch_size=args.batch_size,
                seq_len=args.seq_len, lr=args.lr, device=dev,
                profile_dir=profile_dir, model_dir=rt.model_dir,
                checkpoint_every=args.checkpoint_every, mesh=mesh,
                microbatches=args.microbatches)
    loss = res.losses[-1] if res.losses else float("nan")
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    if mesh is not None and rt.local_rank == 0:
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        print(f"Mesh: {shape} over {dist.get_world_size()} devices, "
              f"process {rt.process_id}/{rt.num_processes}")
    print(f"Device: {dev} ({name}), process "
          f"{rt.process_id}/{rt.num_processes}")
    card = card_id(dev)
    if rt.launched:
        print(f"Rank {rt.global_rank}/{rt.world_size}: local "
              f"{rt.local_rank}/{rt.local_devices} on {dev} ({card}), "
              f"{dist.get_backend()}")
    if args.report:
        print("Report: " + json.dumps(report(rt, res, dev, card)),
              flush=True)
    print(f"Training elapsed time: {res.elapsed_s:f} s")
    print(f"Final loss: {loss:f}; throughput: {res.tokens_per_s:.0f} "
          f"tokens/s")
    if res.checkpoint_note:
        print(res.checkpoint_note)
    if joined:
        rt.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
