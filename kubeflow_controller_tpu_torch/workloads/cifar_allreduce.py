"""All-reduce CIFAR ResNet — the port of
``kubeflow_controller_tpu/workloads/cifar_allreduce.py``, the no-PS
multi-worker workload (BASELINE.json configs[2]: a 4-worker all-reduce
ResNet-50/CIFAR TFJob, MultiWorkerMirrored, no PS).

    python -m kubeflow_controller_tpu_torch.workloads.cifar_allreduce \\
        [--model resnet18|resnet50|cnn] [--width W] [--device cuda|cpu] ...

Same flags and lines as the reference (``--device``, default ``cuda``,
takes the place of ``--platform``).  A worker-only gang forms from the
controller's env contract or from the TF-contract args
(``rt.merge_tf_args``; no ``--ps_hosts`` needed), one device a process.
Worker ``r`` draws ``synthetic_cifar(1000 + r)`` and feeds ``bs / n`` rows
of it a step; the gang trains one model with SGD (momentum 0.9,
``optax.sgd``'s update), the BatchNorm moments over the global batch (one
``all_reduce`` per BatchNorm layer forward and one backward,
``models/vision.py``) and the gradients and the loss in one flat
``all_reduce`` a step (``trainer.train_scan_stateful``: one CUDA graph on
the card, the collectives inside it): ResNet-18 makes
2 x 20 + 1 = 41 collectives a step, ResNet-50 2 x 53 + 1 = 107, the CNN
1.  The printed loss is the global batch's; accuracy is on the eval set
every worker holds whole, with the running statistics.  ``--model cnn``
trains ``FlaxMNISTCNN`` on the 28x28 centre of the first channel.

A pod of several local devices (``launch.py``) runs one rank a device, dp
over every rank: the pod's process index picks the seed and the pod's
``bs / pods`` rows a step, which its ranks split by local rank, as the
reference shards a process's share over its local devices; local rank 0
prints the pod's "Worker i/n" line.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..device import rank_device


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="all-reduce CIFAR")
    p.add_argument("--job_name", default="")
    p.add_argument("--task_index", type=int, default=-1)
    p.add_argument("--worker_hosts", default="")
    p.add_argument("--ps_hosts", default="")
    p.add_argument("--model", choices=["resnet18", "resnet50", "cnn"],
                   default="resnet18")
    p.add_argument("--width", type=int, default=16,
                   help="stem width; 16 = classic CIFAR ResNet, 64 = "
                        "ImageNet-style")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=32, help="global batch")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--train-size", type=int, default=2048)
    p.add_argument("--eval-size", type=int, default=512)
    p.add_argument("--target-accuracy", type=float, default=0.0)
    p.add_argument("--device", default="cuda",
                   help="torch device (raises without CUDA unless 'cpu' is "
                        "named)")
    return p.parse_args(argv)


def build_model(name: str, width: int, device):
    """The ``--model`` choice, uninitialised, on ``device``."""
    from ..models import vision as v

    if name == "cnn":
        return v.FlaxMNISTCNN(device=device)
    if name == "resnet50":
        return v.resnet50(width=width, device=device)
    return v.resnet18(width=width, device=device)


def run(args: argparse.Namespace):
    """One worker's whole run: join, fit, eval, then leave the gang
    together.  Returns a ``trainer.FitResult``."""
    import torch

    from ..models import vision as v
    from .data import synthetic_cifar
    from .runtime import JobRuntime, process_count, process_index, world_size
    from .trainer import FitResult, batch_stack, sgd, train_scan_stateful

    dev = rank_device(args.device)
    rt = JobRuntime.from_env()
    rt.merge_tf_args(args.job_name, args.task_index, args.worker_hosts)
    joined = not torch.distributed.is_initialized()
    rt.initialize(dev)
    joined = joined and torch.distributed.is_initialized()
    pc, proc, dp = process_count(), process_index(), world_size()
    bs = max(dp, args.batch_size - args.batch_size % dp)
    rows = bs // dp      # this rank's, of its pod's bs / pc

    x, y = synthetic_cifar(1000 + proc, args.train_size, dev)
    ex, ey = synthetic_cifar(2, args.eval_size, dev)
    if args.model == "cnn":
        x = x[:, 2:-2, 2:-2, :1]  # 28x28x1 slice keeps the CNN tiny
        ex = ex[:, 2:-2, 2:-2, :1]
    model = v.vision_init(build_model(args.model, args.width, dev),
                          torch.Generator().manual_seed(0))
    opt = sgd(model.parameters(), args.lr, momentum=0.9)

    start = time.time()
    xs, ys = batch_stack(x, y, args.steps, bs // pc)
    cols = slice(rt.local_rank * rows, (rt.local_rank + 1) * rows)
    xs, ys = xs[:, cols], ys[:, cols]
    _, losses = train_scan_stateful(
        lambda xb, yb, st: v.vision_loss(model, xb, yb), opt,
        v.batch_stats(model), xs, ys)
    loss = float(losses[-1])
    elapsed = time.time() - start
    acc = float(v.vision_accuracy(model, ex, ey))
    if dp > 1 or joined:
        torch.distributed.barrier()
        rt.shutdown()
    return FitResult(losses, loss, acc, elapsed, proc, pc, dp, bs, model,
                     local_rank=rt.local_rank)


def main(argv=None) -> int:
    from .launch import launch_pod
    from .runtime import JobRuntime

    args = parse_args(argv)
    rt = JobRuntime.from_env()
    rt.merge_tf_args(args.job_name, args.task_index, args.worker_hosts)
    code = launch_pod(__spec__.name, argv, args.device, rt)
    if code is not None:
        return code     # the pod's ranks ran
    res = run(args)
    if res.local_rank == 0:
        print(f"Worker {res.process}/{res.processes} ({args.model}) on "
              f"{res.dp}-way mesh")
    print(f"Training elapsed time: {res.elapsed_s:f} s")
    print(f"Final loss: {res.loss:f}; eval accuracy: {res.accuracy:f}")
    if args.target_accuracy and res.accuracy < args.target_accuracy:
        print(f"accuracy {res.accuracy} below target {args.target_accuracy}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
