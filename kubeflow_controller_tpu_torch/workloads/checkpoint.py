"""Checkpoint/resume through ``torch.distributed.checkpoint`` (DCP) — the
port of ``kubeflow_controller_tpu/workloads/checkpoint.py``.

The controller plumbs the job's ``modelDir`` into the pod env as
``MODEL_DIR``; a training main saves its model and optimizer there, and a
replacement replica at the same index restores the latest step and
resumes instead of starting over.

Layout: ``<dir>/<step>/`` holds one DCP save of ``{"model": ...,
"optim": ...}`` — the model's ``state_dict`` (buffers such as BatchNorm's
running statistics included) and the optimizer's state, both keyed by
parameter name (``torch.distributed.checkpoint.state_dict``), so a fresh
optimizer, which has no state yet, can load one.  A step is written under
a hidden temporary name and renamed into place once complete, so
``latest_step()`` and ``restore()`` never see a half-written step.  The
newest ``keep`` steps are kept.

A replicated state (data parallel, one model a process) is written by
process 0 alone (``no_dist``) and read by every process.  A sharded state
(a model whose parameters are DTensors: ``models.llama.shard_llama``) is
saved collectively: every process writes its own shards into the step's
temporary directory, process 0 renames it into place, and every process
waits at a barrier until it is there; a restore loads each process's shards
back into the sharded model and optimizer.  The collectives of a sharded
save or restore run over a gloo group of their own, so an async save's
writer thread never shares a communicator with training.
``is_writer()`` then decides only who writes the gang-width marker.  The
format is DCP's, not Orbax's: neither package reads the other's
checkpoints (ROADMAP.md §3).
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch

logger = logging.getLogger("kubeflow_controller_tpu_torch.checkpoint")


def torch_optimizer(optimizer: Any) -> torch.optim.Optimizer:
    """The ``torch.optim.Optimizer`` behind ``optimizer`` (the trainer's
    :class:`~.trainer.Optimizer` wraps one as ``.inner``)."""
    return getattr(optimizer, "inner", optimizer)


def is_writer() -> bool:
    """Whether this process writes checkpoints: process 0 of a group, or a
    process with no group."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def is_sharded(tree: Any) -> bool:
    """Whether a state-dict tree holds a DTensor (a sharded model)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        return True
    if isinstance(tree, dict):
        return any(is_sharded(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(is_sharded(v) for v in tree)
    return False


def _to_cpu(tree: Any) -> Any:
    """A deep copy of a state-dict tree with every tensor copied to the
    host: the snapshot an async save writes while training goes on."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def dir_bytes(path: str) -> int:
    """The bytes of the files under ``path``."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


class CheckpointManager:
    """Saves and restores ``(model, optimizer)`` under ``directory``,
    one subdirectory per step.  ``events`` records each save (``step``,
    ``blocking_s``: the time ``save`` held the caller, ``total_s``: until
    the step was in place, ``bytes``) and each restore (``step``,
    ``seconds``, ``bytes``)."""

    WIDTH_MARKER = "gang_width"

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: Optional[Future] = None
        self._group = None        # the sharded saves' gloo group
        self.events: List[Dict[str, Any]] = []

    # -- save ---------------------------------------------------------------

    def save(self, step: int, model: torch.nn.Module, optimizer: Any,
             wait: bool = True) -> None:
        """Save ``model`` and ``optimizer`` as step ``step``.  Durable by
        default (returns once the step is in place).  ``wait=False`` is for
        saves inside the training loop: the state is copied to the host
        before this returns (parameters and optimizer moments change in
        place at the next step), and the copy is written on a background
        thread while training goes on; call :meth:`wait` (or make a final
        ``wait=True`` save) before declaring success, or a failed write
        goes unnoticed.  A save waits for the one before it.  A replicated
        state is written by process 0 of a group, and the others return at
        once; a sharded one by every process, each calling ``save``.  A
        step that already exists raises ``FileExistsError``."""
        self.wait()
        t0 = time.perf_counter()
        state = self._live_state(model, optimizer)
        group = self._sharded_group(state)
        if group is None and not is_writer():
            return
        if os.path.exists(self._step_dir(step)):
            raise FileExistsError(f"checkpoint step {step} already exists "
                                  f"under {self.directory}")
        event = {"kind": "save", "step": step, "async": not wait}
        self.events.append(event)
        if wait:
            self._write(step, state, event, t0, group)
            event["blocking_s"] = event["total_s"]
            return
        state = _to_cpu(state)
        event["blocking_s"] = time.perf_counter() - t0
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="checkpoint")
        self._pending = self._pool.submit(self._write, step, state, event, t0,
                                          group)

    def wait(self) -> None:
        """Block until the in-flight async save is in place; re-raise what
        it raised."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def _sharded_group(self, state: Dict[str, Any]):
        """The gloo group of this manager's collective saves and restores
        for a sharded ``state`` (made at the first, by every process), or
        None for a replicated one."""
        import torch.distributed as dist

        if not (dist.is_initialized() and is_sharded(state)):
            return None
        if self._group is None:
            self._group = dist.new_group(backend="gloo")
        return self._group

    def _write(self, step: int, state: Dict[str, Any], event: Dict[str, Any],
               t0: float, group=None) -> None:
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp

        final = self._step_dir(step)
        if group is None:
            tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            dcp.save(state, checkpoint_id=tmp, no_dist=True)
            os.replace(tmp, final)
        else:
            # One temporary directory for every process's shards.
            tmp = os.path.join(self.directory, f".tmp-{step}")
            if is_writer():
                shutil.rmtree(tmp, ignore_errors=True)
            dist.barrier(group=group)
            dcp.save(state, checkpoint_id=tmp, process_group=group)
            if is_writer():
                os.replace(tmp, final)
            dist.barrier(group=group)   # in place for every process
        event["total_s"] = time.perf_counter() - t0
        event["bytes"] = dir_bytes(final)
        if self.keep > 0 and is_writer():
            for old in self.all_steps()[:-self.keep]:
                self._drop_step(old)

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> List[int]:
        """Every complete step, oldest first."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, model: torch.nn.Module, optimizer: Any
                ) -> Tuple[torch.nn.Module, Any, int]:
        """Load the latest *readable* step into ``model`` and ``optimizer``
        in place (on whatever device they live); returns ``(model,
        optimizer, step)``.  Raises ``FileNotFoundError`` when there is no
        step.

        A step that fails to load (a kill can tear files in ways the
        rename does not guard: a truncated write, a damaged disk) is
        deleted, with one warning, and the step before it is tried, so a
        resuming replica loses one interval instead of crash-looping on the
        same bad read; the last step's error propagates when nothing older
        is left."""
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.state_dict import set_state_dict

        self.wait()
        steps = self.all_steps()[::-1]
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        opt = torch_optimizer(optimizer)
        if not opt.state:
            # A fresh optimizer's state is created from zero gradients;
            # stale ones would leave it uncreated, and unloaded.
            opt.zero_grad(set_to_none=True)
        for i, step in enumerate(steps):
            t0 = time.perf_counter()
            state = self._live_state(model, optimizer)
            group = self._sharded_group(state)
            try:
                if group is None:
                    dcp.load(state, checkpoint_id=self._step_dir(step),
                             no_dist=True)
                else:   # every process its own shards; DCP fails all alike
                    dcp.load(state, checkpoint_id=self._step_dir(step),
                             process_group=group)
            except (Exception, dcp.CheckpointException) as e:  # noqa: BLE001
                # A torn or corrupt step (DCP's own exception is a
                # BaseException).
                if i + 1 >= len(steps):
                    raise  # nothing older to fall back to
                logger.warning(
                    "checkpoint step %d under %s is unreadable (%s); "
                    "deleting it and falling back to step %d",
                    step, self.directory, e, steps[i + 1])
                if group is not None:
                    import torch.distributed as dist

                    dist.barrier(group=group)   # every process has read
                if group is None or is_writer():
                    self._drop_step(step)
                continue
            set_state_dict(model, opt, model_state_dict=state["model"],
                           optim_state_dict=state["optim"])
            self.events.append({
                "kind": "restore", "step": step,
                "seconds": time.perf_counter() - t0,
                "bytes": dir_bytes(self._step_dir(step))})
            return model, optimizer, step

    @staticmethod
    def _live_state(model: torch.nn.Module, optimizer: Any
                    ) -> Dict[str, Any]:
        """``{"model", "optim"}`` state dicts keyed by parameter name; the
        tensors are the live ones.  ``get_state_dict`` creates a fresh
        optimizer's state by a zero-learning-rate step on zero gradients,
        which moves no parameter but counts a step (and, under L2 weight
        decay, fills the moments); that state is set back to the zeros the
        first real step finds, so a save before the first step stores
        Adam's count as 0 and a resume from it is a fresh run."""
        from torch.distributed.checkpoint.state_dict import get_state_dict

        opt = torch_optimizer(optimizer)
        fresh = not opt.state
        msd, osd = get_state_dict(model, opt)
        if fresh:
            for st in [*opt.state.values(), *osd["state"].values()]:
                for k, v in st.items():
                    if isinstance(v, torch.Tensor):
                        v.zero_()
                    elif isinstance(v, (int, float)):
                        st[k] = type(v)(0)
        return {"model": msd, "optim": osd}

    # -- elastic width marker -------------------------------------------

    def read_width(self) -> Optional[int]:
        """The gang width that wrote the checkpoints here (None = never
        recorded).  A restore under a different runtime width is a
        re-shard, beaten as ``phase="reshard"``."""
        try:
            with open(os.path.join(self.directory, self.WIDTH_MARKER)) as fh:
                text = fh.read().strip()
        except FileNotFoundError:
            return None
        return int(text) or None

    def write_width(self, width: int) -> None:
        """Record the writing gang's width (process 0; atomic tmp + rename,
        so a kill mid-write never leaves a torn marker)."""
        path = os.path.join(self.directory, self.WIDTH_MARKER)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(str(width))
        os.replace(tmp, path)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _drop_step(self, step: int) -> None:
        """Remove a step so no later resume trips over it again."""
        shutil.rmtree(self._step_dir(step), ignore_errors=True)
