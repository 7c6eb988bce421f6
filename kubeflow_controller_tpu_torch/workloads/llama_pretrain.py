"""Llama pretrain driver — the port of
``kubeflow_controller_tpu/workloads/llama_pretrain.py`` on one device.

    python -m kubeflow_controller_tpu_torch.workloads.llama_pretrain \\
        [--preset tiny|llama2-7b] [--steps N] [--device cuda|cpu] ...

Same flags as the reference (``--device``, default ``cuda``, takes the
place of ``--platform``) and the same closing lines ("Training elapsed
time", "Final loss ...; throughput ... tokens/s").  Each step is
``llama_loss`` -> backward -> clip by global norm -> AdamW, on synthetic
bigram tokens (``data.synthetic_tokens``, seed 1: the reference's
``PRNGKey(1)``).  The loop itself is :func:`train`, which takes a
``LlamaConfig``, so a caller can drive it at a cut depth.

MoE: ``--experts E`` (with ``--top-k`` and ``--moe-dispatch``
einsum|scatter|grouped) trains a mixture-of-experts model; "grouped" runs
the dropless grouped-matmul CUDA kernels forward and backward, and falls
back to "einsum" with a warning where they cannot take the operands (the
tiny preset is f32); ``--strict-moe-dispatch`` makes that fallback an
error.  On the CPU every dispatch runs as asked, through the kernels' plain
versions.

Not ported yet, and raising ``NotImplementedError`` (ROADMAP.md): any mesh
axis other than 1 (``--fsdp -1`` is 1 on one device) and ``--pp > 1``
(multi-device pretrain), a multi-process gang, and checkpointing
(``MODEL_DIR``, ``--checkpoint-every``; M5).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
import warnings
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..models.llama import Llama, LlamaConfig, llama_init, llama_loss
from .data import synthetic_tokens
from .runtime import JobRuntime
from .trainer import default_optimizer


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


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(cfg: LlamaConfig, *, steps: int, batch_size: int, seq_len: int,
          lr: float = 3e-4, device: DeviceLike = "cuda", seed: int = 0,
          model: Optional[Llama] = None,
          profile_dir: str = "") -> TrainResult:
    """``steps`` optimizer steps of ``cfg`` from ``llama_init`` (seeded
    with ``seed``) or from ``model`` (trained in place), the reference's
    loop: ``default_optimizer(lr, weight_decay=0.1)`` (clip 1.0), and batch
    i is rows ``[(i * bs) % (N - bs + 1), ... + bs)`` of ``N = max(64, 2 *
    bs)`` synthetic sequences of seed 1."""
    dev = resolve_device(device)
    if model is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = llama_init(cfg, gen, dev, requires_grad=True)
    opt = default_optimizer(model.parameters(), lr, weight_decay=0.1)
    bs = max(1, batch_size)
    tokens_all = synthetic_tokens(1, max(64, 2 * bs), seq_len,
                                  cfg.vocab_size, dev)

    def step(i: int) -> float:
        lo = (i * bs) % max(1, tokens_all.shape[0] - bs + 1)
        loss = llama_loss(model, tokens_all[lo:lo + bs], cfg)
        loss.backward()
        opt.step()
        opt.zero_grad()
        return float(loss.detach())

    prof = contextlib.nullcontext()
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else []))
    losses, step_s = [], []
    with prof:
        _sync(dev)
        start = time.perf_counter()
        for i in range(steps):
            t0 = time.perf_counter()
            losses.append(step(i))
            _sync(dev)
            step_s.append(time.perf_counter() - t0)
        elapsed = time.perf_counter() - start
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        print(f"Profile trace written to {profile_dir}")
    return TrainResult(losses, step_s, elapsed,
                       steps * bs * seq_len / max(elapsed, 1e-9), model, step)


_MESH_NOT_PORTED = ("mesh axes {}: multi-device pretrain is not ported yet "
                    "(ROADMAP.md, module queue: multi-device pretrain); the "
                    "port trains on one device")
_CKPT_NOT_PORTED = ("checkpointing (MODEL_DIR / --checkpoint-every) is not "
                    "ported yet (ROADMAP.md, M5)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="llama pretrain")
    p.add_argument("--preset", choices=["tiny", "llama2-7b"], default="tiny")
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
                   help="pipeline stages (> 1 is not ported yet)")
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
                        "named)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    rt = JobRuntime.from_env()
    rt.initialize()

    if args.strict_moe_dispatch:
        warnings.filterwarnings("error", message="moe dispatch")

    tiny_overrides = {"max_seq_len": args.seq_len}
    if args.dim:
        tiny_overrides.update(dim=args.dim,
                              n_heads=max(4, args.dim // 16),
                              n_kv_heads=max(2, args.dim // 32))
    if args.intermediate:
        tiny_overrides["intermediate"] = args.intermediate
    cfg = (LlamaConfig.llama2_7b() if args.preset == "llama2-7b"
           else LlamaConfig.tiny(**tiny_overrides))
    overrides = {}
    if args.sp_attention != cfg.sp_attention:
        overrides["sp_attention"] = args.sp_attention
    if args.experts:
        overrides.update(n_experts=args.experts, moe_top_k=args.top_k,
                         moe_dispatch=args.moe_dispatch)
    if args.remat_policy:
        overrides.update(remat=True, remat_policy=args.remat_policy)
    if args.loss_chunks:
        overrides["loss_chunks"] = args.loss_chunks
    if args.attention:
        overrides["attention"] = args.attention
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    # The controller's mesh plan ($KCTPU_MESH) overrides the axis flags, as
    # in the reference; on one device every axis must be 1.
    axes = {"dp": args.dp, "fsdp": args.fsdp, "tp": args.tp,
            "sp": args.sp, "pp": args.pp, "ep": args.ep}
    if rt.mesh:
        axes.update({k: v for k, v in rt.mesh.items() if k in axes})
    sharded = {k: v for k, v in axes.items()
               if v != 1 and not (k == "fsdp" and v == -1)}
    if sharded:
        raise NotImplementedError(_MESH_NOT_PORTED.format(sharded))
    if rt.model_dir or args.checkpoint_every:
        raise NotImplementedError(_CKPT_NOT_PORTED)

    profile_dir = args.profile_dir
    if profile_dir == "auto":
        profile_dir = os.path.join(rt.log_dir, "trace") if rt.log_dir else ""
    res = train(cfg, steps=args.steps, batch_size=args.batch_size,
                seq_len=args.seq_len, lr=args.lr, device=dev,
                profile_dir=profile_dir)
    loss = res.losses[-1] if res.losses else float("nan")
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"Device: {dev} ({name}), process "
          f"{rt.process_id}/{rt.num_processes}")
    print(f"Training elapsed time: {res.elapsed_s:f} s")
    print(f"Final loss: {loss:f}; throughput: {res.tokens_per_s:.0f} "
          f"tokens/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
