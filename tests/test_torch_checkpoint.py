"""Checkpoint/resume of ``kubeflow_controller_tpu_torch``
(``workloads/checkpoint.py`` on ``torch.distributed.checkpoint``), the port
of ``tests/test_recovery.py``'s ``TestCheckpointResume`` on the port's
MNIST dist step, and the resume paths of the training mains.

- Killed at step 7 with saves every 5, restored (step 5) and resumed to 12:
  the final parameters and Adam state are bit-identical to the
  uninterrupted run's.
- A corrupt newest step falls back one interval, with one warning, and is
  deleted; with nothing readable restore raises.
- An async save followed by more training restores the saved step bit
  for bit (the save snapshots before it returns); Adam's ``step`` count
  comes back, and a save before the first step stores it as 0.
- The width marker: one process writes, a two-rank gloo gang resumes and
  beats ``phase="reshard"`` with ``resumedFromStep``; the same width beats
  ``"restore"``.
- ``llama_pretrain.main`` with ``MODEL_DIR`` resumes ("Resumed from step"),
  and the resumed run's losses continue the first run's to equal an
  uninterrupted run of the summed steps, also from a ``--steps 0`` save;
  ``mnist_local`` and
  ``mnist_dist`` save to ``MODEL_DIR``.
"""

import copy
import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.distributed.checkpoint import CheckpointException

from kubeflow_controller_tpu_torch.models import mnist as m
from kubeflow_controller_tpu_torch.workloads import data as d
from kubeflow_controller_tpu_torch.workloads import llama_pretrain as tpre
from kubeflow_controller_tpu_torch.workloads import mnist_dist, mnist_local
from kubeflow_controller_tpu_torch.workloads.checkpoint import (
    CheckpointManager,
)
from kubeflow_controller_tpu_torch.workloads.trainer import (
    default_optimizer,
    make_dist_step,
    train_step_loop_dist,
)

from _torch_ranks import free_port

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
BS, SPE = 16, 4


def fresh():
    """A fresh MLP, its optimizer (clip + Adam, lr 5e-3) and dist step."""
    model = m.MnistMLP(m.mlp_init(0), "cpu")
    opt = default_optimizer(model.parameters(), 5e-3)
    step = make_dist_step(lambda xb, yb: m.mlp_loss(model, xb, yb), opt)
    return model, opt, step


def batches():
    x, y = d.synthetic_mnist(1, 64, "cpu")
    idx = ((torch.arange(SPE)[:, None] * BS + torch.arange(BS)[None, :])
           % x.shape[0])
    return x[idx], y[idx]


def state_of(model, opt):
    """Parameters and optimizer state, copied."""
    return (copy.deepcopy(model.state_dict()),
            copy.deepcopy(opt.inner.state_dict()["state"]))


def assert_same_state(a, b):
    (pa, sa), (pb, sb) = a, b
    assert pa.keys() == pb.keys() and sa.keys() == sb.keys()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


def test_kill_resume_matches_uninterrupted(tmp_path):
    x_all, y_all = batches()
    steps, every, kill_at = 12, 5, 7
    model, opt, step = fresh()
    want = train_step_loop_dist(step, x_all, y_all, steps)

    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    model, opt, step = fresh()
    train_step_loop_dist(
        step, x_all, y_all, kill_at, checkpoint_every=every,
        checkpoint_fn=lambda s: mgr.save(s, model, opt, wait=False))
    mgr.wait()
    # The process dies at step 7; the replacement restores step 5...
    model2, opt2, step2 = fresh()
    _, _, start = CheckpointManager(str(tmp_path / "ckpt")).restore(
        model2, opt2)
    assert start == 5 and kill_at - start <= every
    # ...and resumes to the end: bit-identical to the uninterrupted run.
    got = train_step_loop_dist(step2, x_all, y_all, steps, start_step=start)
    assert got.shape == (steps - start,)
    assert torch.equal(got, want[start:])
    uninterrupted = fresh()
    train_step_loop_dist(uninterrupted[2], x_all, y_all, steps)
    assert_same_state(state_of(model2, opt2),
                      state_of(uninterrupted[0], uninterrupted[1]))


def test_corrupt_latest_falls_back_to_previous_step(tmp_path, caplog):
    x_all, y_all = batches()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    model, opt, step = fresh()
    train_step_loop_dist(
        step, x_all, y_all, 11, checkpoint_every=5,
        checkpoint_fn=lambda s: mgr.save(s, model, opt, wait=True))
    assert mgr.all_steps() == [5, 10]
    root = tmp_path / "ckpt" / "10"
    for dirpath, _, files in os.walk(root):  # a torn write
        for fn in files:
            Path(dirpath, fn).write_bytes(b"corrupt")
    model2, opt2, _ = fresh()
    with caplog.at_level(logging.WARNING):
        _, _, start = CheckpointManager(str(tmp_path / "ckpt")).restore(
            model2, opt2)
    assert start == 5                   # fell back one interval
    assert not root.exists()            # deleted, not retried
    warned = [r for r in caplog.records
              if r.name == "kubeflow_controller_tpu_torch.checkpoint"]
    assert len(warned) == 1 and "step 10" in warned[0].getMessage()


def test_restore_raises_when_nothing_readable(tmp_path):
    model, opt, _ = fresh()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(model, opt)
    # One step, and it is unreadable: its own error, nothing to fall to.
    mgr = CheckpointManager(str(tmp_path / "one"))
    mgr.save(1, model, opt)
    for f in (tmp_path / "one" / "1").iterdir():
        f.write_bytes(b"corrupt")
    with pytest.raises(CheckpointException):
        mgr.restore(*fresh()[:2])
    assert mgr.all_steps() == [1]       # the last step is left in place


def test_async_save_snapshots_before_training_on(tmp_path):
    x_all, y_all = batches()
    model, opt, step = fresh()
    for t in range(5):
        step(x_all, y_all, t)
    at5 = state_of(model, opt)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(5, model, opt, wait=False)
    for t in range(5, 9):               # parameters and moments move
        step(x_all, y_all, t)
    mgr.wait()
    assert not torch.equal(model.w1, at5[0]["w1"])
    model2, opt2, _ = fresh()
    _, _, start = mgr.restore(model2, opt2)
    assert start == 5
    assert_same_state(state_of(model2, opt2), at5)
    assert mgr.events[0]["async"] and mgr.events[0]["bytes"] > 0
    assert mgr.events[-1]["kind"] == "restore"


def test_adam_step_count_survives_the_restore(tmp_path):
    x_all, y_all = batches()
    model, opt, step = fresh()
    for t in range(3):
        step(x_all, y_all, t)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, model, opt)
    model2, opt2, _ = fresh()
    assert not opt2.inner.state             # fresh: no state yet
    mgr.restore(model2, opt2)
    steps = [float(s["step"]) for s in opt2.inner.state.values()]
    assert steps == [3.0] * 4
    assert opt2.inner.param_groups[0]["lr"] == 5e-3


def test_a_save_before_the_first_step_stores_a_fresh_optimizer(tmp_path):
    """A step-0 save stores Adam's count 0 and zero moments (the state the
    first real step finds), and leaves the live optimizer so: its first
    step then equals a fresh optimizer's, bit for bit."""
    x_all, y_all = batches()
    model, opt, step = fresh()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(0, model, opt)
    model2, opt2, _ = fresh()
    mgr.restore(model2, opt2)
    for o in (opt, opt2):
        for st in o.inner.state.values():
            assert float(st["step"]) == 0.0
            assert not st["exp_avg"].any() and not st["exp_avg_sq"].any()
    model3, opt3, step3 = fresh()
    step(x_all, y_all, 0)
    step3(x_all, y_all, 0)
    assert_same_state(state_of(model, opt), state_of(model3, opt3))


def test_keep_three_and_existing_step(tmp_path):
    model, opt, _ = fresh()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    for s in range(1, 6):
        mgr.save(s, model, opt, wait=s % 2 == 0)
    mgr.wait()
    assert mgr.all_steps() == [3, 4, 5] and mgr.latest_step() == 5
    assert not [n for n in os.listdir(tmp_path / "ckpt") if "tmp" in n]
    with pytest.raises(FileExistsError):
        mgr.save(5, model, opt)


def test_width_marker_is_atomic_and_read_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.read_width() is None
    mgr.write_width(4)
    assert mgr.read_width() == 4
    assert os.listdir(tmp_path) == ["gang_width"]


# --- the width marker across a gang -----------------------------------------

RECORDING_RANK = r"""
import json, sys
import torch
torch.set_num_threads(1)
from kubeflow_controller_tpu_torch.workloads import mnist_dist, progress
log = sys.argv[1]
publish = progress.ProgressReporter._publish
def recording(self, body):
    with open(log, "a") as fh:
        fh.write(json.dumps(body) + "\n")
    publish(self, body)
progress.ProgressReporter._publish = recording
sys.exit(mnist_dist.main(sys.argv[2:]))
"""

# The step loop: the fit that restores (and re-shards) from MODEL_DIR.
GANG_ARGV = ["--device", "cpu", "--batch-size", "32", "--train-size", "256",
             "--eval-size", "64", "--step-loop"]


def run_ranks(tmp_path, tag, n, steps, model_dir):
    """``mnist_dist.main`` as ``n`` gloo ranks (or one process with no
    group), each recording its beats; returns [(stdout, beats)]."""
    coord = f"127.0.0.1:{free_port()}"
    procs = []
    for rank in range(n):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("KCTPU_", "JAX_COORDINATOR",
                                    "JAX_NUM_PROC", "JAX_PROCESS"))}
        env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                   MODEL_DIR=str(model_dir), KCTPU_POD_NAME=f"{tag}-{rank}",
                   KCTPU_PROGRESS_DIR=str(tmp_path))
        if n > 1:
            env.update(JAX_COORDINATOR_ADDRESS=coord,
                       JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(rank))
        log = tmp_path / f"{tag}-{rank}.beats"
        procs.append((log, subprocess.Popen(
            [sys.executable, "-c", RECORDING_RANK, str(log), *GANG_ARGV,
             "--steps", str(steps)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    out = []
    try:
        for log, p in procs:
            stdout, stderr = p.communicate(timeout=120)
            assert p.returncode == 0, stderr
            out.append((stdout, [json.loads(ln) for ln in
                                 log.read_text().splitlines()]))
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_resume_at_another_width_beats_reshard(tmp_path):
    ckpt = tmp_path / "model"
    (out, beats), = run_ranks(tmp_path, "one", 1, 6, ckpt)
    assert "Checkpoint saved to" in out
    assert not any("resumedFromStep" in b for b in beats)
    mgr = CheckpointManager(str(ckpt))
    assert mgr.latest_step() == 6 and mgr.read_width() == 1
    ranks = run_ranks(tmp_path, "two", 2, 9, ckpt)
    for rank, (out, beats) in enumerate(ranks):
        phases = [b.get("phase") for b in beats]
        assert "reshard" in phases and "restore" not in phases, phases
        first_fit = next(b for b in beats if b.get("phase") == "fit")
        assert first_fit["step"] == 7 and first_fit["resumedFromStep"] == 6
        assert beats[-1]["step"] == 9 and beats[-1]["resumedFromStep"] == 6
        assert ("Checkpoint saved to" in out) == (rank == 0)
    assert mgr.read_width() == 2 and mgr.latest_step() == 9
    # The same width again: a plain restore.
    ranks = run_ranks(tmp_path, "again", 2, 10, ckpt)
    for _, beats in ranks:
        phases = [b.get("phase") for b in beats]
        assert "restore" in phases and "reshard" not in phases, phases


# --- the mains --------------------------------------------------------------

@pytest.fixture
def clean_env(monkeypatch):
    for name in list(os.environ):
        if name.startswith("KCTPU_") or name in (
                "MODEL_DIR", "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID"):
            monkeypatch.delenv(name)


LLAMA_ARGV = ["--device", "cpu", "--batch-size", "2", "--seq-len", "32",
              "--dim", "64", "--intermediate", "128"]


def test_llama_pretrain_main_resumes_from_model_dir(tmp_path, monkeypatch,
                                                    capsys, clean_env):
    runs = []
    train = tpre.train

    def recording(*args, **kwargs):
        runs.append(train(*args, **kwargs))
        return runs[-1]

    monkeypatch.setattr(tpre, "train", recording)
    assert tpre.main([*LLAMA_ARGV, "--steps", "5"]) == 0
    monkeypatch.setenv("MODEL_DIR", str(tmp_path / "ck"))
    assert tpre.main([*LLAMA_ARGV, "--steps", "3",
                      "--checkpoint-every", "2"]) == 0
    first = capsys.readouterr().out
    assert "Resumed from step" not in first
    assert f"Checkpoint saved to {tmp_path / 'ck'}" in first
    assert CheckpointManager(str(tmp_path / "ck")).all_steps() == [2, 3]
    assert tpre.main([*LLAMA_ARGV, "--steps", "2"]) == 0
    second = capsys.readouterr().out
    assert f"Resumed from step 3 in {tmp_path / 'ck'}" in second
    full, a, b = runs
    assert b.start_step == 3 and len(b.losses) == 2
    assert a.losses + b.losses == full.losses
    for p, q in zip(full.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 5
    # --steps 0 on a resume: the final step is already there.
    assert tpre.main([*LLAMA_ARGV, "--steps", "0"]) == 0
    assert "Checkpoint for step 5 already in" in capsys.readouterr().out


def test_llama_pretrain_resume_from_a_step0_save_is_a_fresh_run(
        tmp_path, monkeypatch, capsys, clean_env):
    """``--steps 0`` with ``MODEL_DIR`` saves step 0; a resume from it runs
    N steps bit-identical to an uninterrupted N-step run (Adam's count
    starts at 0, as after the reference's step-0 save)."""
    runs = []
    train = tpre.train

    def recording(*args, **kwargs):
        runs.append(train(*args, **kwargs))
        return runs[-1]

    monkeypatch.setattr(tpre, "train", recording)
    assert tpre.main([*LLAMA_ARGV, "--steps", "3"]) == 0
    monkeypatch.setenv("MODEL_DIR", str(tmp_path / "ck"))
    assert tpre.main([*LLAMA_ARGV, "--steps", "0"]) == 0
    assert f"Checkpoint saved to {tmp_path / 'ck'}" in capsys.readouterr().out
    assert CheckpointManager(str(tmp_path / "ck")).all_steps() == [0]
    assert tpre.main([*LLAMA_ARGV, "--steps", "3"]) == 0
    assert (f"Resumed from step 0 in {tmp_path / 'ck'}"
            in capsys.readouterr().out)
    full, _, resumed = runs
    assert resumed.start_step == 0 and resumed.losses == full.losses
    for p, q in zip(full.model.parameters(), resumed.model.parameters()):
        assert torch.equal(p, q)


def test_mnist_local_saves_to_model_dir(tmp_path, monkeypatch, capsys,
                                        clean_env):
    monkeypatch.setenv("MODEL_DIR", str(tmp_path / "ck"))
    assert mnist_local.main(["--device", "cpu", "--steps", "4",
                             "--train-size", "256", "--eval-size",
                             "64"]) == 0
    assert "Checkpoint saved to" in capsys.readouterr().out
    model = m.MnistMLP(m.mlp_init(1), "cpu")
    opt = default_optimizer(model.parameters(), 5e-3)
    _, _, step = CheckpointManager(str(tmp_path / "ck")).restore(model, opt)
    res = mnist_local.train(steps=4, train_size=256, eval_size=64,
                            device="cpu")
    assert step == 4
    for k, v in res.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_mnist_dist_scan_fit_saves_its_final_step_only(tmp_path, monkeypatch,
                                                       capsys, clean_env):
    """The default (scan) fit, as the reference's: ``MODEL_DIR`` gets the
    final step and nothing else (``--checkpoint-every`` is the step
    loop's), and a second run restores nothing: it trains from the init
    and saves its own final step."""
    monkeypatch.setenv("MODEL_DIR", str(tmp_path / "ck"))
    argv = ["--device", "cpu", "--batch-size", "32", "--train-size", "256",
            "--eval-size", "64", "--checkpoint-every", "3"]
    assert mnist_dist.main([*argv, "--steps", "7"]) == 0
    assert "Checkpoint saved to" in capsys.readouterr().out
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.all_steps() == [7] and mgr.read_width() is None
    again = mnist_dist.run_worker(mnist_dist.parse_args(
        [*argv, "--steps", "10"]))
    monkeypatch.delenv("MODEL_DIR")
    whole = mnist_dist.run_worker(mnist_dist.parse_args(
        [*argv, "--steps", "10"]))
    assert again.start_step == 0 and again.losses.shape == (10,)
    assert torch.equal(again.losses, whole.losses)
    assert mgr.all_steps() == [7, 10]
    model = m.MnistMLP(m.mlp_init(0), "cpu")
    opt = default_optimizer(model.parameters(), 5e-3)
    _, _, step = mgr.restore(model, opt)
    assert step == 10
    for k, v in whole.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


@pytest.mark.parametrize("every", [0, 3], ids=["final", "every-3"])
def test_mnist_dist_checkpoints_and_resumes(tmp_path, monkeypatch, capsys,
                                            clean_env, every):
    monkeypatch.setenv("MODEL_DIR", str(tmp_path / "ck"))
    argv = ["--device", "cpu", "--batch-size", "32", "--train-size", "256",
            "--eval-size", "64", "--checkpoint-every", str(every),
            "--step-loop"]
    assert mnist_dist.main([*argv, "--steps", "7"]) == 0
    assert "Checkpoint saved to" in capsys.readouterr().out
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.all_steps() == ([3, 6, 7] if every else [7])
    resumed = mnist_dist.run_worker(mnist_dist.parse_args(
        [*argv, "--steps", "10"]))
    monkeypatch.delenv("MODEL_DIR")
    whole = mnist_dist.run_worker(mnist_dist.parse_args(
        [*argv, "--steps", "10"]))
    assert resumed.start_step == 7 and resumed.losses.shape == (3,)
    assert torch.equal(resumed.losses, whole.losses[7:])
    assert mgr.latest_step() == 10
