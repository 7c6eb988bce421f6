"""Flax-MNIST on the TPU replica type — the port of
``kubeflow_controller_tpu/workloads/flax_mnist.py`` (BASELINE.json
configs[3], data-parallel Flax-MNIST).  The module keeps the reference's
name, so a manifest maps one to one onto it.

    python -m kubeflow_controller_tpu_torch.workloads.flax_mnist \\
        [--steps N] [--batch-size B] [--device cuda|cpu] ...

Same flags and lines as the reference (``--device``, default ``cuda``,
takes the place of ``--platform``).  The process joins its gang from the
controller's env contract (``JobRuntime.initialize``: gloo on the CPU,
nccl on CUDA) and trains ``FlaxMNISTCNN`` data-parallel, one device a
process: every process draws the same seed-1 images, stacks the global
batches (``batch_stack``) and trains on its rows ``[r * bs / n, (r + 1) *
bs / n)`` of each, the gradients and the loss averaged in one
``all_reduce`` a step (``trainer.train_scan``: one CUDA graph on the
card), with ``optax.adam(lr)``'s
update (``trainer.adam``).  The global batch is rounded down to a multiple
of the width.  With ``MODEL_DIR`` set the chief saves the trained model
and optimizer there as step ``--steps``.

A pod of several local devices (``launch.py``) runs one rank a device:
dp spans every rank, each global batch splits first by pod and then by
local rank (rank ``process x L + local rank`` takes its rows, as the
reference shards a process's share over its local devices), and local
rank 0 prints the pod's "Process i/n on W devices" line.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..device import rank_device


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="flax MNIST on TPU replicas")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=64, help="global batch")
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--train-size", type=int, default=4096)
    p.add_argument("--eval-size", type=int, default=1024)
    p.add_argument("--target-accuracy", type=float, default=0.0)
    p.add_argument("--device", default="cuda",
                   help="torch device (raises without CUDA unless 'cpu' is "
                        "named)")
    return p.parse_args(argv)


def run(args: argparse.Namespace):
    """The whole run of one process: join, fit, eval, the chief's save,
    then leave the gang together.  Returns a ``trainer.FitResult``."""
    import torch

    from ..models import vision as v
    from .checkpoint import CheckpointManager
    from .data import synthetic_mnist_images
    from .runtime import JobRuntime, global_rank, world_size
    from .trainer import FitResult, adam, batch_stack, train_scan

    dev = rank_device(args.device)
    rt = JobRuntime.from_env()
    joined = not torch.distributed.is_initialized()
    rt.initialize(dev)
    joined = joined and torch.distributed.is_initialized()
    dp, rank = world_size(), global_rank()
    bs = max(dp, args.batch_size - args.batch_size % dp)
    rows = bs // dp

    x, y = synthetic_mnist_images(1, args.train_size, dev)
    ex, ey = synthetic_mnist_images(2, args.eval_size, dev)
    model = v.vision_init(v.FlaxMNISTCNN(device=dev),
                          torch.Generator().manual_seed(0))
    opt = adam(model.parameters(), args.lr)

    start = time.time()
    xs, ys = batch_stack(x, y, args.steps, bs)
    cols = slice(rank * rows, (rank + 1) * rows)
    losses = train_scan(lambda xb, yb: v.vision_loss(model, xb, yb)[0], opt,
                        xs[:, cols], ys[:, cols])
    loss = float(losses[-1])
    elapsed = time.time() - start
    acc = float(v.vision_accuracy(model, ex, ey))
    saved_to = ""
    if rt.model_dir and rt.is_chief:
        CheckpointManager(rt.model_dir).save(args.steps, model, opt)
        saved_to = rt.model_dir
    if dp > 1 or joined:
        torch.distributed.barrier()  # the chief's save is in place
        rt.shutdown()
    return FitResult(losses, loss, acc, elapsed, rt.process_id,
                     rt.num_processes, dp, bs, model, saved_to,
                     rt.local_rank)


def main(argv=None) -> int:
    from .launch import launch_pod

    args = parse_args(argv)
    code = launch_pod(__spec__.name, argv, args.device)
    if code is not None:
        return code     # the pod's ranks ran
    res = run(args)
    if res.local_rank == 0:
        print(f"Process {res.process}/{res.processes} on {res.dp} devices "
              f"(dp={res.dp})")
    print(f"Training elapsed time: {res.elapsed_s:f} s")
    print(f"Final loss: {res.loss:f}; eval accuracy: {res.accuracy:f}")
    if res.saved_to:
        print(f"Checkpoint saved to {res.saved_to}")
    if args.target_accuracy and res.accuracy < args.target_accuracy:
        print(f"accuracy {res.accuracy} below target {args.target_accuracy}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
