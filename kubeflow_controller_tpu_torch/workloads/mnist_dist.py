"""Distributed MNIST — the port of
``kubeflow_controller_tpu/workloads/mnist_dist.py``, the Worker replica
workload of a classic PS/Worker TFJob.

    python -m kubeflow_controller_tpu_torch.workloads.mnist_dist \\
        [--steps N] [--batch-size B] [--device cuda|cpu] ...

Roles, from the TF-contract args the planner injects:

- ``ps`` parks until SIGTERM or SIGINT and exits 0, the analog of
  ``server.join()``: its data plane rides the workers' all-reduce.
- a worker builds its :class:`JobRuntime` from the env (or from
  ``--worker_hosts``/``--task_index``), starts the gang guard, runs its
  numpy host setup on a thread overlapped with the rendezvous (serially
  under ``--no-overlap``), joins the process group (gloo on the CPU, nccl
  on CUDA), trains one shared model with one flat all-reduce per step and
  evaluates.  Each rank takes its columns ``[r·bs/W, (r+1)·bs/W)`` of
  every global batch; the global batch is rounded down to a multiple of
  the data-parallel width W.
- a worker pod of several local devices (``launch.py``) runs one rank a
  device: W is every pod's devices, rank r = process x L + local rank (the
  batch splits by pod, then by local rank), the gang guard and the beats
  are local rank 0's, and local rank 0 prints the pod's "Worker i/n" line.

Two fit shapes, as in the reference:

- **scan** (the default): the whole fit is one program a worker
  (``trainer.train_scan_dist``): the data drawn on the device from JAX's
  threefry (``data.synthetic_mnist_traced``: the train set seed 1, each
  rank its columns of every batch; the eval set seed 2, each rank its
  rows), the steps with their one flat ``all_reduce`` each, and the
  sharded eval with one more.  On the card it is one CUDA graph, captured
  once (the fit's ``workload/compile``) and replayed once, inside the
  reference's ``trainer/fit`` span.  With ``MODEL_DIR`` it only saves its
  final step and never restores, as the reference's scan fit.
  ``--aot-cache`` is accepted and nothing is written there: a CUDA graph
  cannot be serialised (``trainer/fit`` reads ``aot_cache="off"``).
- **step loop** (``--step-loop`` or ``$WORKLOAD_STEP_LOOP``): the numpy
  data staged from the host (``synthetic_mnist_np``) and one
  ``trainer.make_dist_step`` step driven at a time with progress beats.

Checkpoint/resume in the step loop (``MODEL_DIR``), as in the reference's:
the latest readable step is restored before the first beat, which reads
``phase="restore"`` — or ``"reshard"`` when the width marker says the
checkpoints were written by a gang of another width than this one
(``rt.gang_width``) — and every later beat carries ``resumedFromStep``;
``--checkpoint-every N`` saves asynchronously every N steps, the saves
are waited for before the sign-off, and the final step is saved (process
0 writes, ``checkpoint.CheckpointManager``).

The step loop compiles nothing, so it has no ``workload/compile`` span
under its fit, where the reference's step loop has one.  The phases are
the reference's trace spans, ``workload/rendezvous``, ``workload/init``
and ``workload/fit`` (with ``trainer/fit`` inside it in the scan fit, and
``workload/stage`` and, on a resume, ``workload/restore`` in the step
loop), and the "Phase times" line reads them; the spans are dumped to
``$KCTPU_TRACE_DIR`` before the sign-off.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict

from ..obs.trace import dump_to_env_dir


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="distributed MNIST")
    # TF-contract args injected by the planner (planner/materialize.py
    # tf_cluster_args).
    p.add_argument("--job_name", default="")
    p.add_argument("--task_index", type=int, default=-1)
    p.add_argument("--worker_hosts", default="")
    p.add_argument("--ps_hosts", default="")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=100, help="global batch")
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--train-size", type=int, default=8192)
    p.add_argument("--eval-size", type=int, default=2048)
    p.add_argument("--target-accuracy", type=float, default=0.0)
    p.add_argument("--device", default="cuda",
                   help="torch device (raises without CUDA unless 'cpu' is "
                        "named)")
    p.add_argument("--aot-cache",
                   default=os.environ.get("WORKLOAD_AOT_CACHE", ""),
                   help="accepted; nothing is written there (the scan fit's "
                        "CUDA graph cannot be serialised)")
    p.add_argument("--step-loop", action="store_true",
                   default=bool(os.environ.get("WORKLOAD_STEP_LOOP")),
                   help="per-step loop on host-staged data (real per-step "
                        "progress beats, restore and periodic saves) "
                        "instead of the one-program scan fit")
    p.add_argument("--checkpoint-every", type=int,
                   default=int(os.environ.get("KCTPU_CHECKPOINT_EVERY", "0")
                               or "0"),
                   help="step-loop mode: async checkpoint every N steps "
                        "into MODEL_DIR (0 = only the final save)")
    p.add_argument("--step-sleep", type=float,
                   default=float(os.environ.get("KCTPU_STEP_SLEEP", "0")
                                 or "0"),
                   help="step-loop mode: host-side sleep per step "
                        "(seconds): stretches the fit window so fault "
                        "benches can kill mid-fit")
    p.add_argument("--no-overlap", action="store_true",
                   default=bool(os.environ.get("KCTPU_NO_OVERLAP")),
                   help="serial baseline: run host setup after rendezvous "
                        "instead of overlapping the two")
    return p.parse_args(argv)


@dataclass
class DistResult:
    losses: Any                # torch.Tensor [steps], global means, on device
    loss: float                # the last step's
    accuracy: float            # on the whole eval set
    process: int               # the pod (jax.process_index)
    processes: int
    dp: int                    # data-parallel width (one device a rank)
    batch_size: int            # global, after rounding to dp
    times: Dict[str, float]    # rendezvous, init, fit, total (s)
    device: str
    model: Any                 # the trained MnistMLP
    start_step: int = 0        # the checkpoint step resumed from (0: none)
    saved_to: str = ""         # MODEL_DIR, if this process saved there
    local_rank: int = 0        # the rank among its pod's local devices


def run_worker(args: argparse.Namespace) -> DistResult:
    """A worker's whole run: rendezvous, fit (the one-program scan fit, or
    the step loop under ``--step-loop``), eval, then leave the gang
    together.  (torch is imported here, so a parked PS never loads it.)"""
    import torch.distributed as dist

    from ..device import rank_device
    from ..models import mnist as m
    from ..obs.trace import span
    from ..recovery.rendezvous import guard_from_env
    from . import data as d
    from .checkpoint import CheckpointManager, is_writer
    from .runtime import (
        HostSetup,
        JobRuntime,
        global_rank,
        process_count,
        process_index,
        world_size,
    )

    t_start = time.perf_counter()
    dev = rank_device(args.device)
    rt = JobRuntime.from_env()
    rt.merge_tf_args(args.job_name, args.task_index, args.worker_hosts)

    # Recovery plane (opt-in via $KCTPU_GANG_MONITOR): started before the
    # rendezvous so a peer that dies inside the join is detected too.
    guard = guard_from_env(rt)
    if guard is not None:
        guard.start()

    def host_setup():
        params = m.mlp_init(0)  # same seed -> same init everywhere
        if not args.step_loop:
            return params, None, None      # the scan fit draws on device
        return (params, d.synthetic_mnist_np(1, args.train_size),
                d.synthetic_mnist_np(2, args.eval_size))

    setup = HostSetup(host_setup, overlap=not args.no_overlap)

    with span("workload/rendezvous", task_index=args.task_index) as sp_rdv:
        rt.initialize(dev)

    # Ranks for the data split and the collectives; the pod for the spans
    # and the sign-off, as jax.process_index() in the reference.
    pc, proc = world_size(), global_rank()
    pod, pods = process_index(), process_count()
    with span("workload/init", process=pod) as sp_init:
        # One device per process.  Round the global batch down to a
        # multiple of the data-parallel width (the reference's batch 100
        # over 8 devices -> 96 per step).
        dp = pc
        bs = max(dp, args.batch_size - args.batch_size % dp)
        spe = max(1, args.train_size // bs)  # steps per epoch
        eval_local = max(1, args.eval_size // dp)

    fit = _fit_step_loop if args.step_loop else _fit_scan
    fit_out = fit(args, rt, setup, dev, dp, proc, pod, bs, spe, eval_local)
    losses, loss, acc, sp_fit, model, opt, start_step, mgr = fit_out
    saved_to = ""
    if rt.model_dir:
        mgr = mgr or CheckpointManager(rt.model_dir)
        # The final step (unless a resume at the finish line already has
        # it), while the group still names the one writer.
        if mgr.latest_step() != args.steps:
            mgr.save(args.steps, model, opt)
        saved_to = rt.model_dir if is_writer() else ""
    times = {"rendezvous": sp_rdv.dur, "init": sp_init.dur,
             "fit": sp_fit.dur, "total": time.perf_counter() - t_start}

    if guard is not None:
        # The done marker BEFORE the exit barrier, so a fast peer's
        # silence is never mistaken for death.
        guard.mark_done()
    if pc > 1 or rt.launched:
        # Leave together: process 0 hosts the store, and an early exit
        # would fail a peer still finishing its eval.
        try:
            dist.barrier()
        except RuntimeError:
            pass  # best effort; exit skew is rare
        rt.shutdown()
    return DistResult(losses, loss, acc, pod, pods, dp, bs, times, str(dev),
                      model, start_step, saved_to, rt.local_rank)


def _fit_scan(args, rt, setup, dev, dp, proc, pod, bs, spe, eval_local):
    """The one-program fit (the reference's default): the batches drawn on
    the device from threefry (``synthetic_mnist_traced``: the train set is
    ``spe * bs`` examples of seed 1, each rank taking its columns of every
    batch; the eval set ``dp * eval_local`` examples of seed 2, each rank
    its rows), the ``steps``-long loop with its one flat ``all_reduce`` a
    step and the sharded eval, as ``trainer.train_scan_dist``: one CUDA
    graph on the card.  No restore: with ``MODEL_DIR`` the fit only saves
    its final step, as the reference's scan fit does."""
    import numpy as np
    import torch

    from ..models import mnist as m
    from ..obs.trace import span
    from . import data as d
    from .trainer import default_optimizer, train_scan_dist

    local_bs = bs // dp
    with span("workload/fit", process=pod, steps=args.steps) as sp_fit:
        params, _, _ = setup.result()
        model = m.MnistMLP(params, dev)
        opt = default_optimizer(model.parameters(), args.lr)
        # The templates go to the device before the fit: a host copy
        # inside a capture would sync.
        means = torch.from_numpy(np.array(d.mnist_teacher_means())).to(dev)

        def local_batches(i):
            x, y = d.synthetic_mnist_traced(1, spe * bs, means, dev)
            cols = slice(i * local_bs, (i + 1) * local_bs)
            return (x.reshape(spe, bs, m.IMAGE_PIXELS)[:, cols],
                    y.reshape(spe, bs)[:, cols])

        def eval_counts(i):
            ex, ey = d.synthetic_mnist_traced(2, dp * eval_local, means, dev)
            rows = slice(i * eval_local, (i + 1) * eval_local)
            with torch.no_grad():
                hits = model(ex[rows]).argmax(dim=-1) == ey[rows]
            return hits.sum(), eval_local

        out = train_scan_dist(lambda xb, yb: m.mlp_loss(model, xb, yb), opt,
                              args.steps, local_batches, eval_counts,
                              aot_cache=args.aot_cache,
                              examples_per_step=bs)
        loss, acc = float(out.loss), float(out.metric)
    return out.losses, loss, acc, sp_fit, model, opt, 0, None


def _fit_step_loop(args, rt, setup, dev, dp, proc, pod, bs, spe,
                   eval_local):
    """The step loop (``--step-loop``): host-staged data, a restore from
    ``MODEL_DIR``, ``--checkpoint-every`` saves and ``--step-sleep``, one
    ``make_dist_step`` step driven at a time."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..models import mnist as m
    from ..obs.phases import PHASE_RESHARD, PHASE_RESTORE
    from ..obs.trace import span
    from .checkpoint import CheckpointManager
    from .progress import reporter
    from .trainer import (
        default_optimizer,
        make_dist_step,
        train_step_loop_dist,
    )

    del eval_local
    pc = dp
    with span("workload/fit", process=pod, steps=args.steps,
              step_loop=True) as sp_fit:
        params, (x_np, y_np), (ex_np, ey_np) = setup.result()
        with span("workload/stage", process=pod):
            # Stack the epoch's batches [spe, bs] and keep this process's
            # columns of every batch.
            idx = (np.arange(spe)[:, None] * bs + np.arange(bs)[None, :]) \
                % x_np.shape[0]
            rows = bs // pc
            idx = idx[:, proc * rows:(proc + 1) * rows]
            x_all = torch.from_numpy(x_np[idx]).to(dev)
            y_all = torch.from_numpy(y_np[idx]).to(dev)
            model = m.MnistMLP(params, dev)
        opt = default_optimizer(model.parameters(), args.lr)
        step = make_dist_step(lambda xb, yb: m.mlp_loss(model, xb, yb), opt)
        if args.step_sleep > 0:
            def step(x, y, t, _inner=step, _zz=args.step_sleep):
                time.sleep(_zz)
                return _inner(x, y, t)

        # Checkpoint-resume: restore the latest readable step BEFORE the
        # first beat, so a replacement replica resumes where the gang's
        # checkpoints left off and the progress plane reads the backward
        # jump as a resume.
        start_step, mgr, ck_fn = 0, None, None
        if rt.model_dir:
            mgr = CheckpointManager(rt.model_dir)
            # The width that wrote these checkpoints (the marker) against
            # this generation's (the runtime env): a restore at another
            # width is a re-shard, and the beats say so.
            prev_width = mgr.read_width()
            phase = (PHASE_RESHARD
                     if prev_width is not None and prev_width != rt.gang_width
                     else PHASE_RESTORE)
            if mgr.latest_step() is not None:
                reporter().beat(phase=phase)
                with span("workload/restore", process=pod,
                          reshard=(phase == PHASE_RESHARD)) as sp_r:
                    _, _, start_step = mgr.restore(model, opt)
                    sp_r.args["step"] = start_step
                start_step = min(start_step, args.steps)
                reporter().beat(step=start_step, phase=phase,
                                resumed_from_step=start_step)
            if pc > 1:
                dist.barrier()  # every process has read the old marker
            if proc == 0:
                mgr.write_width(rt.gang_width)
            if args.checkpoint_every > 0:
                def ck_fn(done, _mgr=mgr):
                    _mgr.save(done, model, opt, wait=False)

        losses = train_step_loop_dist(step, x_all, y_all, args.steps,
                                      examples_per_step=bs,
                                      compile_source="",
                                      start_step=start_step,
                                      checkpoint_every=args.checkpoint_every,
                                      checkpoint_fn=ck_fn)
        if mgr is not None:
            mgr.wait()  # in-flight async saves
        ex = torch.from_numpy(np.array(ex_np)).to(dev)
        ey = torch.from_numpy(np.array(ey_np)).to(dev)
        acc = float(m.mlp_accuracy(model, ex, ey))
    return (losses, float(losses[-1]), acc, sp_fit, model, opt, start_step,
            mgr)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.job_name == "ps":
        # The PS data plane rides the workers' all-reduce; park until the
        # gang is torn down, like server.join().  sigwait only catches
        # blocked signals; unblocked, SIGTERM would exit 143 instead of 0.
        park = {signal.SIGTERM, signal.SIGINT}
        signal.pthread_sigmask(signal.SIG_BLOCK, park)
        signal.sigwait(park)
        return 0

    from .launch import launch_pod
    from .runtime import JobRuntime

    rt = JobRuntime.from_env()
    rt.merge_tf_args(args.job_name, args.task_index, args.worker_hosts)
    code = launch_pod(__spec__.name, argv, args.device, rt)
    if code is not None:
        return code     # the pod's ranks ran
    res = run_worker(args)
    t = res.times
    if res.local_rank == 0:
        print(f"Worker {res.process}/{res.processes} on {res.device} "
              f"(dp={res.dp}, global batch {res.batch_size})")
    print(f"Phase times: rendezvous={t['rendezvous']:.3f}s "
          f"init={t['init']:.3f}s fit={t['fit']:.3f}s "
          f"total={t['total']:.3f}s")
    print(f"Training elapsed time: {t['fit']:f} s")
    print(f"Final loss: {res.loss:f}; eval accuracy: {res.accuracy:f}")
    # Explicit span dump: a process that leaves through os._exit skips
    # atexit.
    dump_to_env_dir()
    if res.saved_to:
        print(f"Checkpoint saved to {res.saved_to}")
    if args.target_accuracy and res.accuracy < args.target_accuracy:
        print(f"accuracy {res.accuracy} below target {args.target_accuracy}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
