"""Single-process MNIST — the port of
``kubeflow_controller_tpu/workloads/mnist_local.py``, the Local replica
workload.

    python -m kubeflow_controller_tpu_torch.workloads.mnist_local \\
        [--model mlp|softmax] [--steps N] [--device cuda|cpu] ...

Same flags as the reference (``--device``, default ``cuda``, takes the
place of ``--platform``) and the same sign-off lines ("Training elapsed
time", "Final loss ...; eval accuracy ...").  The model trains one step
per stacked batch (``trainer.train_scan``: one CUDA graph on the card,
eagerly on the CPU), on the synthetic mixture
(train seed 1, eval seed 2, init seed 0: the reference's ``PRNGKey``
counters).  ``--target-accuracy`` makes a lower final accuracy exit 1.
With ``MODEL_DIR`` set the trained model and optimizer are saved there as
step ``--steps`` (``checkpoint.CheckpointManager``), as in the reference.
Under a job's trace context (``$KCTPU_TRACE_CONTEXT``) the run is one
``workload/train`` span, dumped to ``$KCTPU_TRACE_DIR``, as the
reference's is.
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass

import torch

from ..device import DeviceLike, resolve_device
from ..models import mnist as m
from ..obs import trace
from .checkpoint import CheckpointManager
from .data import synthetic_mnist
from .runtime import JobRuntime
from .trainer import Optimizer, batch_stack, default_optimizer, train_scan


@dataclass
class LocalResult:
    losses: torch.Tensor       # [steps], on the device
    loss: float                # the last step's
    accuracy: float            # on the eval set
    elapsed_s: float           # batch staging + training, ending in a sync
    model: torch.nn.Module     # the trained model
    optimizer: Optimizer       # and its optimizer
    started: float = 0.0       # wall clock (s since the epoch) at its start


def train(model: str = "mlp", steps: int = 200, batch_size: int = 100,
          lr: float = 5e-3, train_size: int = 8192, eval_size: int = 2048,
          device: DeviceLike = "cuda") -> LocalResult:
    """The reference's local fit: ``steps`` Adam steps (clip 1.0) over
    batches cycling through ``train_size`` examples, then eval."""
    dev = resolve_device(device)
    x, y = synthetic_mnist(1, train_size, dev)
    ex, ey = synthetic_mnist(2, eval_size, dev)
    if model == "softmax":
        net = m.MnistSoftmax(m.softmax_init(0), dev)
    else:
        net = m.MnistMLP(m.mlp_init(0), dev)
    opt = default_optimizer(net.parameters(), lr)

    start = time.time()
    xs, ys = batch_stack(x, y, steps, batch_size)
    losses = train_scan(lambda xb, yb: m.mlp_loss(net, xb, yb), opt, xs, ys)
    loss = float(losses[-1])
    elapsed = time.time() - start
    acc = float(m.mlp_accuracy(net, ex, ey))
    return LocalResult(losses, loss, acc, elapsed, net, opt, start)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="local MNIST")
    p.add_argument("--model", choices=["softmax", "mlp"], default="mlp")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--eval-size", type=int, default=2048)
    p.add_argument("--train-size", type=int, default=8192)
    p.add_argument("--target-accuracy", type=float, default=0.0,
                   help="exit non-zero if final accuracy is below this")
    p.add_argument("--device", default="cuda",
                   help="torch device (raises without CUDA unless 'cpu' is "
                        "named)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    rt = JobRuntime.from_env()
    res = train(args.model, args.steps, args.batch_size, args.lr,
                args.train_size, args.eval_size, dev)
    # Join the job's causal trace: one span for the whole run, dumped
    # explicitly (a process that leaves through os._exit skips atexit).
    trace.add_span("workload/train", res.started, res.elapsed_s,
                   ctx=trace.current_context(), steps=args.steps)
    trace.dump_to_env_dir()
    print(f"Training elapsed time: {res.elapsed_s:f} s")
    print(f"Final loss: {res.loss:f}; eval accuracy: {res.accuracy:f}")
    if rt.model_dir:
        CheckpointManager(rt.model_dir).save(args.steps, res.model,
                                             res.optimizer)
        print(f"Checkpoint saved to {rt.model_dir}")
    if args.target_accuracy and res.accuracy < args.target_accuracy:
        print(f"accuracy {res.accuracy} below target {args.target_accuracy}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
