"""Port parity: the gang runtime and dist-mnist of
``kubeflow_controller_tpu_torch`` (``workloads/runtime.py``,
``recovery/rendezvous.py``, ``workloads/trainer.py``'s dist step and loop,
``workloads/mnist_dist.py``) against the JAX package.

- Two gloo ranks (subprocesses, one thread each, on a free local port) run
  ``mnist_dist.run_worker`` for 30 steps (global batch 100 over 1024
  examples, lr 5e-3).  Against the reference's ``make_dist_step`` +
  ``train_step_loop_dist`` over an in-process ``dp=2`` CPU mesh (the
  conftest's virtual devices) from the same init and the same columns:
  each step's loss within 1e-4 absolute (measured 4.8e-6) and the final
  parameters within 5e-5 (measured 9.2e-7); both ranks end bit-identical;
  exactly one ``all_reduce`` per step, of every gradient plus the loss.
- ``merge_tf_args``, ``_ready_filename``, ``HostSetup``,
  ``generation_from_env``, ``guard_from_env`` and ``GangGuard.check_peers``
  agree with the reference over tables of inputs.
- A non-zero rank waits for the coordinator's readiness drop, then for
  its port; a gang that never forms raises within its timeout, at either
  rank; without CUDA a gang's ``initialize`` raises unless the CPU is
  named.
- ``mnist_dist``: a PS parks and exits 0 on SIGTERM; one process trains
  with no group and the same losses under ``--no-overlap``; ``MODEL_DIR``
  saves the final step (and every ``--checkpoint-every`` steps) with the
  width marker.
"""

import dataclasses
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.models import mnist as jm
from kubeflow_controller_tpu.parallel import AXIS_DATA, MeshSpec, build_mesh
from kubeflow_controller_tpu.recovery import rendezvous as jrdv
from kubeflow_controller_tpu.workloads import data as jdata
from kubeflow_controller_tpu.workloads import runtime as jruntime
from kubeflow_controller_tpu.workloads import trainer as jtrainer
from kubeflow_controller_tpu_torch.recovery import rendezvous as trdv
from kubeflow_controller_tpu_torch.workloads import mnist_dist
from kubeflow_controller_tpu_torch.workloads import runtime as truntime

from _torch_ranks import free_port

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
STEP_LOSS_ATOL = 1e-4
PARAM_ATOL = 5e-5
LR = 5e-3
GANG = {"steps": 30, "batch": 100, "train": 1024, "eval": 256}


def subprocess_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("KCTPU_", "JAX_COORDINATOR", "JAX_NUM_PROC",
                                "JAX_PROCESS"))}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", **extra)
    return env


# --- the env contract -------------------------------------------------------

MERGE_CASES = [
    ({}, "worker", 1, "h0:2222,h1:2222,h2:2222"),
    ({}, "worker", 0, "h0:2222,h1:2222"),
    ({}, "ps", 0, "h0:2222,h1:2222"),
    ({}, "worker", -1, "h0:2222,h1:2222"),
    ({}, "worker", 0, "h0:2222"),
    ({}, "worker", 0, ""),
    ({}, "worker", 2, "h0:1,,h1:1,h2:1"),
    ({"JAX_COORDINATOR_ADDRESS": "c:9"}, "worker", 1, "h0:1,h1:1"),
    ({"JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "3"}, "worker", 1,
     "h0:1,h1:1"),
    ({"KCTPU_GANG_WIDTH": "5"}, "worker", 1, "h0:1,h1:1"),
]


@pytest.mark.parametrize("env,job,task,hosts", MERGE_CASES)
def test_merge_tf_args_matches_jax(env, job, task, hosts):
    want = jruntime.JobRuntime.from_env(env)
    got = truntime.JobRuntime.from_env(env)
    want.merge_tf_args(job, task, hosts)
    got.merge_tf_args(job, task, hosts)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_ready_filename_and_env_names_match_jax():
    for coord in ("127.0.0.1:1234", "svc.example:2222", "[fd00::1]:8476",
                  "a/b:1", ""):
        for gen in (0, 1, 17):
            assert (truntime._ready_filename(coord, gen)
                    == jruntime._ready_filename(coord, gen))
    assert truntime.ENV_RENDEZVOUS_DIR == jruntime.ENV_RENDEZVOUS_DIR
    assert truntime.ENV_GANG_GENERATION == jruntime.ENV_GANG_GENERATION
    assert trdv.EXIT_REJOIN == jrdv.EXIT_REJOIN
    assert trdv.ENV_GANG_MONITOR == jrdv.ENV_GANG_MONITOR
    assert trdv.ENV_GANG_GENERATION == jrdv.ENV_GANG_GENERATION


@pytest.mark.parametrize("module", [truntime, jruntime],
                         ids=["port", "jax"])
def test_host_setup(module):
    gate = threading.Event()
    ran = []

    def fn():
        ran.append(threading.current_thread().name)
        gate.wait(5)
        return 41 + 1

    bg = module.HostSetup(fn)           # overlapped: running already
    deadline = time.monotonic() + 5
    while not ran and time.monotonic() < deadline:
        time.sleep(0.001)
    assert ran == ["host-setup"]
    gate.set()
    assert bg.result(timeout=5) == 42
    serial = module.HostSetup(fn, overlap=False)
    assert ran == ["host-setup"]        # nothing runs before result()
    assert serial.result() == 42 and ran[-1] == threading.current_thread().name

    def boom():
        raise ValueError("setup failed")

    for overlap in (True, False):
        with pytest.raises(ValueError, match="setup failed"):
            module.HostSetup(boom, overlap=overlap).result(timeout=5)


# --- the gang guard ---------------------------------------------------------

@pytest.mark.parametrize("env", [
    {}, {"KCTPU_GANG_GENERATION": "3"}, {"KCTPU_GANG_GENERATION": "x"},
    {"KCTPU_GANG_GENERATION": ""}])
def test_generation_from_env_matches_jax(env):
    assert trdv.generation_from_env(env) == jrdv.generation_from_env(env)


@pytest.mark.parametrize("env,procs", [
    ({}, 2),
    ({"KCTPU_GANG_MONITOR": "1"}, 2),
    ({"KCTPU_GANG_MONITOR": "1", "KCTPU_RENDEZVOUS_DIR": "/r"}, 1),
    ({"KCTPU_GANG_MONITOR": "1", "KCTPU_RENDEZVOUS_DIR": "/r"}, 2),
    ({"KCTPU_GANG_MONITOR": "1", "KCTPU_RENDEZVOUS_DIR": "/r",
      "KCTPU_GANG_NAME": "ns/job", "KCTPU_GANG_MONITOR_TIMEOUT": "2.5"}, 3),
    ({"KCTPU_GANG_MONITOR": "1", "KCTPU_RENDEZVOUS_DIR": "/r",
      "KCTPU_GANG_MONITOR_TIMEOUT": "soon"}, 2),
])
def test_guard_from_env_matches_jax(env, procs):
    rt_env = {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:9",
              "JAX_NUM_PROCESSES": str(procs), "JAX_PROCESS_ID": "1",
              "KCTPU_GANG_GENERATION": "2"}
    want = jrdv.guard_from_env(jruntime.JobRuntime.from_env(rt_env), env)
    got = trdv.guard_from_env(truntime.JobRuntime.from_env(rt_env), env)
    assert (got is None) == (want is None)
    if want is not None:
        fields = ("directory", "gang", "member", "peers", "generation",
                  "interval_s", "timeout_s", "startup_grace_s")
        assert ({f: getattr(got, f) for f in fields}
                == {f: getattr(want, f) for f in fields})
        assert got.alive_file(0) == want.alive_file(0)
        assert got.done_file(2) == want.done_file(2)


def test_gang_guard_check_peers_matches_jax(tmp_path):
    def guards(**kw):
        return [mod.GangGuard(str(tmp_path), "ns/job", 0, 3, generation=1,
                              on_broken=lambda m: None, **kw)
                for mod in (trdv, jrdv)]

    def verdicts(gs):
        return [g.check_peers() for g in gs]

    port, ref = guards(startup_grace_s=60.0)
    for g in (port, ref):
        g._t0 = time.monotonic()
    assert verdicts((port, ref)) == [None, None]       # peers not seen yet
    for j in (1, 2):
        Path(port.alive_file(j)).touch()
    assert verdicts((port, ref)) == [None, None]       # fresh heartbeats
    stale = time.time() - 60
    os.utime(port.alive_file(2), (stale, stale))
    assert verdicts((port, ref)) == [2, 2]             # member 2 went stale
    Path(port.done_file(2)).touch()
    assert verdicts((port, ref)) == [None, None]       # ...but finished
    os.remove(port.alive_file(1))
    assert verdicts((port, ref)) == [1, 1]             # seen, then vanished
    late = guards(startup_grace_s=0.0)
    assert verdicts(late) == [1, 1]                    # grace over, never seen


def test_gang_guard_start_touches_and_mark_done_stops(tmp_path):
    g = trdv.GangGuard(str(tmp_path), "g", 1, 2, interval_s=0.01,
                       on_broken=lambda m: None)
    g.start()
    assert os.path.exists(g.alive_file(1))
    g.mark_done()
    assert os.path.exists(g.done_file(1)) and g._thread is None


# --- rendezvous -------------------------------------------------------------

@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")


def test_gang_initialize_raises_without_cuda_unless_cpu_named(no_cuda):
    rt = truntime.JobRuntime(coordinator="127.0.0.1:1", num_processes=2,
                             process_id=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.initialize()
    assert not rt._initialized
    one = truntime.JobRuntime()
    one.initialize()                    # one process: nothing to join
    assert one._initialized


def test_coordinator_drops_the_ready_file_jax_names(tmp_path, monkeypatch):
    monkeypatch.setenv("KCTPU_RENDEZVOUS_DIR", str(tmp_path))
    rt = truntime.JobRuntime(coordinator="svc.example:2222", num_processes=2,
                             gang_generation=3)
    rt._drop_ready_file()
    assert os.listdir(tmp_path) == [jruntime._ready_filename(
        "svc.example:2222", 3)]


def test_worker_waits_for_the_drop_then_the_port(tmp_path, monkeypatch):
    monkeypatch.setenv("KCTPU_RENDEZVOUS_DIR", str(tmp_path))
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{srv.getsockname()[1]}"
    chief = truntime.JobRuntime(coordinator=coord, num_processes=2)
    worker = truntime.JobRuntime(coordinator=coord, num_processes=2,
                                 process_id=1)
    try:
        # The port listens at once, but the worker must first see the drop.
        srv.listen(1)
        timer = threading.Timer(0.4, chief._drop_ready_file)
        timer.start()
        t0 = time.monotonic()
        assert worker._wait_coordinator(timeout_s=10.0)
        assert 0.35 <= time.monotonic() - t0 < 5.0
        timer.join()
    finally:
        srv.close()
    # Drop present, port not yet listening: waits for the listener.
    srv = socket.socket()
    srv.bind(("127.0.0.1", int(coord.rsplit(":", 1)[1])))
    try:
        timer = threading.Timer(0.4, srv.listen, (1,))
        timer.start()
        t0 = time.monotonic()
        assert worker._wait_coordinator(timeout_s=10.0)
        assert 0.35 <= time.monotonic() - t0 < 5.0
        timer.join()
    finally:
        srv.close()
    assert not truntime.JobRuntime(coordinator="nonsense", num_processes=2,
                                   process_id=1)._wait_coordinator(5.0)


NEVER_FORMS = r"""
import sys, time
from kubeflow_controller_tpu_torch.workloads.runtime import JobRuntime
port, timeout = int(sys.argv[1]), float(sys.argv[2])
for pid in (1, 0):
    rt = JobRuntime(coordinator=f"127.0.0.1:{port}", num_processes=2,
                    process_id=pid)
    t0 = time.monotonic()
    try:
        rt.initialize("cpu", timeout_s=timeout)
        print(pid, "joined", flush=True)
    except Exception as e:
        print(pid, type(e).__name__, round(time.monotonic() - t0, 3),
              flush=True)
"""


def test_gang_that_never_forms_fails_within_its_timeout():
    """Rank 1 alone finds no coordinator; rank 0 alone waits for a peer
    that never comes.  Each raises within ``timeout_s`` (+ the store's
    one-second poll)."""
    timeout = 2.0
    res = subprocess.run(
        [sys.executable, "-c", NEVER_FORMS, str(free_port()), str(timeout)],
        env=subprocess_env(), capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    lines = [ln.split() for ln in res.stdout.strip().splitlines()]
    assert [ln[0] for ln in lines] == ["1", "0"], res.stdout
    assert lines[0][1] == "TimeoutError"
    assert lines[1][1] == "DistStoreError"
    for ln in lines:
        assert float(ln[2]) < timeout + 3.0, res.stdout


# --- dist-mnist: two gloo ranks against the reference's dp=2 mesh ------------

RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from kubeflow_controller_tpu_torch.workloads import mnist_dist
sizes = []
_all_reduce = dist.all_reduce
def counting(tensor, *args, **kwargs):
    sizes.append(tensor.numel())
    return _all_reduce(tensor, *args, **kwargs)
dist.all_reduce = counting
res = mnist_dist.run_worker(mnist_dist.parse_args(sys.argv[2:]))
np.savez(sys.argv[1], losses=res.losses.numpy(), sizes=np.array(sizes),
         processes=res.processes, batch=res.batch_size,
         **{k: v.detach().numpy() for k, v in res.model.state_dict().items()})
"""


def gang_argv():
    """The step loop's flags: this gang is held against the reference's
    step loop (the scan fit's gang: ``test_torch_scan_fit.py``)."""
    return ["--device", "cpu", "--steps", str(GANG["steps"]),
            "--batch-size", str(GANG["batch"]),
            "--train-size", str(GANG["train"]),
            "--eval-size", str(GANG["eval"]), "--lr", str(LR), "--step-loop"]


def run_gloo_gang(tmp_path, n=2):
    coord = f"127.0.0.1:{free_port()}"
    procs = []
    for rank in range(n):
        env = subprocess_env(JAX_COORDINATOR_ADDRESS=coord,
                             JAX_NUM_PROCESSES=str(n),
                             JAX_PROCESS_ID=str(rank),
                             KCTPU_RENDEZVOUS_DIR=str(tmp_path))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK, str(tmp_path / f"rank{rank}.npz"),
             *gang_argv()], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(n)]


def jax_dist_reference():
    """The reference's step-loop fit over a dp=2 mesh of two CPU devices:
    its per-step losses (global means) and final params."""
    steps, bs, n = GANG["steps"], GANG["batch"], GANG["train"]
    mesh = build_mesh(MeshSpec(dp=2, fsdp=1), devices=jax.devices()[:2])
    opt = jtrainer.default_optimizer(LR)
    step = jtrainer.make_dist_step(lambda p, b: jm.mlp_loss(p, b[0], b[1]),
                                   opt, mesh, AXIS_DATA, donate=False)
    x, y = jdata.synthetic_mnist_np(1, n)
    spe = n // bs
    idx = (np.arange(spe)[:, None] * bs + np.arange(bs)[None, :]) % n
    x_all, y_all = jtrainer.global_batches(
        mesh, AXIS_DATA, (x[idx], y[idx].astype(np.int32)), bs)
    params = jtrainer.replicate_pytree(mesh, jm.mlp_init(0))
    state = jtrainer.replicate_pytree(
        mesh, jtrainer.numpy_opt_state(opt, jm.mlp_init(0)))
    losses = []

    def recording(*args):
        out = step(*args)
        losses.append(out[2])
        return out

    params, _, _ = jtrainer.train_step_loop_dist(
        recording, params, state, x_all, y_all, steps, examples_per_step=bs)
    return (np.array([float(v) for v in losses]),
            jax.tree.map(np.asarray, params))


def test_two_gloo_ranks_match_jax_dp2_mesh(tmp_path):
    ranks = run_gloo_gang(tmp_path)
    want_losses, want_params = jax_dist_reference()
    n_params = sum(v.size for v in want_params.values())
    for r in ranks:
        assert int(r["processes"]) == 2 and int(r["batch"]) == GANG["batch"]
        # One collective a step, carrying every gradient and the loss.
        assert r["sizes"].tolist() == [n_params + 1] * GANG["steps"]
    for k in want_params:
        assert ranks[0][k].tobytes() == ranks[1][k].tobytes(), k
    np.testing.assert_array_equal(ranks[0]["losses"], ranks[1]["losses"])
    np.testing.assert_allclose(ranks[0]["losses"], want_losses, rtol=0,
                               atol=STEP_LOSS_ATOL)
    for k, v in want_params.items():
        np.testing.assert_allclose(ranks[0][k], v, rtol=0, atol=PARAM_ATOL)


# --- mnist_dist as one process ----------------------------------------------

@pytest.fixture
def no_gang_env(monkeypatch):
    for name in list(os.environ):
        if name.startswith("KCTPU_") or name in (
                "MODEL_DIR", "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID"):
            monkeypatch.delenv(name)


def test_one_process_trains_without_a_group(no_gang_env, capsys):
    """The step loop (``--step-loop``) in one process: no group, the same
    losses under ``--no-overlap``."""
    one_process_without_a_group(capsys, ["--step-loop"])


def test_one_process_scan_fit_without_a_group(no_gang_env, capsys):
    """The default scan fit in one process, likewise."""
    one_process_without_a_group(capsys, [])


def one_process_without_a_group(capsys, fit):
    argv = ["--device", "cpu", "--steps", "12", "--batch-size", "64",
            "--train-size", "256", "--eval-size", "128", *fit]
    assert mnist_dist.main(argv) == 0
    out = capsys.readouterr().out
    assert "Worker 0/1 on cpu" in out and "Phase times: rendezvous=" in out
    assert "Training elapsed time:" in out
    overlap = mnist_dist.run_worker(mnist_dist.parse_args(argv))
    serial = mnist_dist.run_worker(mnist_dist.parse_args(
        argv + ["--no-overlap", "--aot-cache", "/unused"]))
    assert not torch.distributed.is_initialized()
    assert overlap.processes == 1 and overlap.losses.shape == (12,)
    assert overlap.losses.tolist() == serial.losses.tolist()
    assert overlap.accuracy == serial.accuracy
    assert mnist_dist.main(argv + ["--target-accuracy", "2.0"]) == 1


@pytest.mark.parametrize("argv", [[], ["--checkpoint-every", "5"]],
                         ids=["model-dir", "checkpoint-every"])
def test_mnist_dist_checkpoints_into_model_dir(no_gang_env, monkeypatch,
                                               tmp_path, capsys, argv):
    """``MODEL_DIR`` (with or without ``--checkpoint-every``) saves, and
    ``--checkpoint-every`` alone, with no ``MODEL_DIR``, saves nothing, as
    in the reference."""
    small = ["--device", "cpu", "--steps", "11", "--batch-size", "32",
             "--train-size", "256", "--eval-size", "64", "--step-loop",
             *argv]
    assert mnist_dist.main(small) == 0
    assert "Checkpoint saved" not in capsys.readouterr().out
    monkeypatch.setenv("MODEL_DIR", str(tmp_path / "model"))
    assert mnist_dist.main(small) == 0
    assert (f"Checkpoint saved to {tmp_path / 'model'}"
            in capsys.readouterr().out)
    steps = sorted(int(n) for n in os.listdir(tmp_path / "model")
                   if n.isdigit())
    assert steps == ([5, 10, 11] if argv else [11])
    assert (tmp_path / "model" / "gang_width").read_text() == "1"


def test_mnist_dist_scan_fit_checkpoints_into_model_dir(no_gang_env,
                                                        monkeypatch, tmp_path,
                                                        capsys):
    """The default scan fit saves only its final step into ``MODEL_DIR``
    (``--checkpoint-every`` is the step loop's) and writes no width
    marker, as the reference's scan fit; without ``MODEL_DIR`` nothing."""
    small = ["--device", "cpu", "--steps", "11", "--batch-size", "32",
             "--train-size", "256", "--eval-size", "64",
             "--checkpoint-every", "5"]
    assert mnist_dist.main(small) == 0
    assert "Checkpoint saved" not in capsys.readouterr().out
    monkeypatch.setenv("MODEL_DIR", str(tmp_path / "model"))
    assert mnist_dist.main(small) == 0
    assert (f"Checkpoint saved to {tmp_path / 'model'}"
            in capsys.readouterr().out)
    steps = sorted(int(n) for n in os.listdir(tmp_path / "model")
                   if n.isdigit())
    assert steps == [11]
    assert not (tmp_path / "model" / "gang_width").exists()


def in_sigwait(pid: int) -> bool:
    """Whether ``pid`` sleeps in ``sigwait`` (Linux /proc)."""
    try:
        return "sigtimedwait" in Path(f"/proc/{pid}/wchan").read_text()
    except OSError:
        return False


def test_ps_parks_until_sigterm_and_exits_zero():
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_controller_tpu_torch.workloads."
         "mnist_dist", "--job_name=ps", "--task_index=0"],
        env=subprocess_env(), cwd=REPO)
    try:
        deadline = time.monotonic() + 60
        while not in_sigwait(proc.pid):
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
