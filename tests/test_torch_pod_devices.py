"""A TPU-typed pod trains on every local device of its host, one rank a
device (``kubeflow_controller_tpu_torch/workloads/launch.py``), under the
unchanged controller, as the reference's one process drives every
``jax.devices()`` entry of its pod.

- (i) Units: the env ``materialize.make_pod`` gives the pods of a
  ``llama-sp``-shaped job (``h100-4``, ``chipsPerHost`` 4, one slice) and a
  ``llama-pp``-shaped one (two slices), with 4 visible cards: L is 4, each
  rank's global rank is ``process x 4 + local rank`` of a world of pods x 4
  and its device ``cuda:<local rank>``; ``$KCTPU_LOCAL_DEVICES`` wins; a
  ``$KCTPU_MESH`` that is not pods x L raises, as does asking for more
  cards than are visible, and a card slice's pod (``h100-<n>``) that does
  not see exactly its n cards; every existing caller (a card named by
  index, the CPU, no contract) stays its own one rank.
- (ii) One TPU pod of 4 local gloo devices under the ``Controller``,
  ``FakeKubelet(execute=True)`` and a ``TPUInventory`` of ``h100-*`` slices:
  ``llama_pretrain --sp 2 --fsdp 2`` (tiny) reaches ``Succeeded`` and prints
  one mesh line, whose device count and axes above 1 equal the line the
  reference's ``llama_pretrain`` prints for the same flags over 4 forced
  host devices; its final loss is a one-process port run's within 1e-5
  relative.
- (iii) The MoE under ep 4 in one pod (``--experts 4 --ep 4 --moe-dispatch
  grouped --strict-moe-dispatch``), checkpointing every step.
- (iv) Two pods x 2 devices under ``--pp 2 --fsdp 2 --checkpoint-every 1``;
  a second job over the same ``modelDir`` resumes past the first one's
  last step.
- (v) ``flax_mnist`` in one pod x 2 devices (the ``tpu.yaml`` shape): dp 2,
  the pod's one "Process 0/1 on 2 devices" line, the one-process loss.
- (vi) A pod whose local rank 1 exits 1 fails its job (restart policy
  ``Never``); local rank 0, left waiting at a barrier, is stopped.
- (vii) SIGTERM or SIGKILL to a pod's process leaves no rank alive.
- A pod's ranks write ``--profile-dir``'s traces each to a dir of its own.
"""

import ast
import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from kubeflow_controller_tpu.api.tfjob import TFJob, TFJobPhase
from kubeflow_controller_tpu.cluster import (
    Cluster,
    FakeKubelet,
    PhasePolicy,
    TPUInventory,
    TPUSlice,
)
from kubeflow_controller_tpu.controller import Controller
from kubeflow_controller_tpu.planner import materialize
from kubeflow_controller_tpu.utils import serde
from kubeflow_controller_tpu_torch import device as tdevice
from kubeflow_controller_tpu_torch.obs import trace
from kubeflow_controller_tpu_torch.recovery import rendezvous
from kubeflow_controller_tpu_torch.workloads import flax_mnist as tflax
from kubeflow_controller_tpu_torch.workloads import launch
from kubeflow_controller_tpu_torch.workloads import llama_pretrain as tpre
from kubeflow_controller_tpu_torch.workloads import progress, runtime
from kubeflow_controller_tpu_torch.workloads.checkpoint import CheckpointManager
from kubeflow_controller_tpu_torch.workloads.runtime import JobRuntime

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
POD_RANK = Path(__file__).resolve().parent / "_torch_pod_rank.py"
DEADLINE_S = 150.0
PRETRAIN = "kubeflow_controller_tpu_torch.workloads.llama_pretrain"
TINY = ("--preset", "tiny", "--device", "cpu", "--steps", "2")
SP = ("--sp", "2", "--fsdp", "2")
MOE = ("--dim", "128", "--intermediate", "256", "--experts", "4",
       "--top-k", "2", "--moe-dispatch", "grouped", "--strict-moe-dispatch")
PP = ("--preset", "tiny", "--device", "cpu", "--batch-size", "4",
      "--seq-len", "64", "--pp", "2", "--microbatches", "2", "--fsdp", "2",
      "--checkpoint-every", "1")
MNIST = ("--device", "cpu", "--steps", "5", "--batch-size", "16",
         "--train-size", "256", "--eval-size", "128")
ENV_VARS = ("MODEL_DIR", "KCTPU_MESH", "KCTPU_LOCAL_DEVICES",
            "KCTPU_LOCAL_RANK", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
            "JAX_COORDINATOR_ADDRESS", "TPU_ACCELERATOR_TYPE")


def manifest(name, command, accel="h100-4", chips=4, slices=1, local=None,
             model_dir="", mesh=None):
    """A TPU-typed TFJob of ``slices`` one-host slices of ``chips`` cards
    (``acceleratorType`` outside the TPU families, so the controller takes
    it as written), its pods running ``command`` with
    ``$KCTPU_LOCAL_DEVICES`` (and the forced host device count) ``local``."""
    env = [{"name": "OMP_NUM_THREADS", "value": "1"}]
    if local:
        env += [{"name": "KCTPU_LOCAL_DEVICES", "value": str(local)},
                {"name": "XLA_FLAGS", "value":
                 f"--xla_force_host_platform_device_count={local}"}]
    tpu = {"acceleratorType": accel, "chipsPerHost": chips,
           "numSlices": slices}
    if mesh:
        tpu["mesh"] = mesh
    spec = {"tfReplicaSpecs": [{
        "replicas": slices, "tfReplicaType": "TPU", "tpu": tpu,
        "template": {"spec": {"restartPolicy": "Never", "containers": [{
            "name": "pytorch", "image": "local", "workingDir": str(REPO),
            "command": list(command), "env": env}]}}}]}
    if model_dir:
        spec["modelDir"] = model_dir
    return serde.from_dict(TFJob, {
        "apiVersion": "kubeflow.caicloud.io/v1alpha1", "kind": "TFJob",
        "metadata": {"name": name, "namespace": "default"}, "spec": spec})


def module(name, *args):
    return [sys.executable, "-m", name, *args]


@pytest.fixture(scope="module")
def rig():
    cluster = Cluster()
    inventory = TPUInventory(
        [TPUSlice(f"node-{i}", "h100-4", num_hosts=1, chips_per_host=4)
         for i in range(2)]
        + [TPUSlice(f"node-{i}", "h100-2", num_hosts=1, chips_per_host=2)
           for i in range(2, 5)])
    kubelet = FakeKubelet(cluster, policy=PhasePolicy(), inventory=inventory,
                          execute=True)
    ctrl = Controller(cluster, inventory=inventory, resync_period_s=0.5)
    kubelet.start()
    ctrl.run(threadiness=2)
    yield cluster, kubelet
    ctrl.stop()
    kubelet.stop()


def run_job(rig, job, want=TFJobPhase.SUCCEEDED):
    """Create ``job``, wait for its end; the phase must be ``want``.
    Returns its pods' logs (stdout then stderr), by pod name."""
    cluster, kubelet = rig
    name = job.metadata.name
    cluster.tfjobs.create(job)
    deadline = time.monotonic() + DEADLINE_S
    while time.monotonic() < deadline:
        got = cluster.tfjobs.get("default", name)
        if got.status.phase in (TFJobPhase.SUCCEEDED, TFJobPhase.FAILED):
            break
        time.sleep(0.1)
    pods = sorted((p for p in cluster.pods.list("default")
                   if p.metadata.labels.get("tf_job_name") == name),
                  key=lambda p: p.metadata.name)
    logs = {p.metadata.name: kubelet.logs("default", p.metadata.name)
            .decode(errors="replace") for p in pods}
    assert got.status.phase == want, (got.status.phase, got.status.reason,
                                      logs)
    return logs


def final_losses(out):
    return [float(x) for x in re.findall(r"Final loss: ([0-9.eE+-]+)", out)]


def mesh_lines(out):
    return re.findall(r"^Mesh: (\{.*\}) over (\d+) devices, process "
                      r"(\d+)/(\d+)$", out, re.M)


def above_one(shape: str) -> dict:
    return {k: v for k, v in ast.literal_eval(shape).items() if v > 1}


def one_process(monkeypatch, capsys, main, args):
    """``main(args)`` in this process, outside any pod: its final loss."""
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    assert main(list(args)) == 0
    return final_losses(capsys.readouterr().out)[-1]


# ---------------------------------------------------------------------------
# (i) units
# ---------------------------------------------------------------------------

def pod_envs(slices, mesh=None):
    """The env of each pod ``make_pod`` builds for a TPU job of ``slices``
    ``h100-4`` slices (``chipsPerHost`` 4)."""
    job = manifest("units", module(PRETRAIN, *TINY), slices=slices,
                   mesh=mesh)
    spec = job.spec.tf_replica_specs[0]
    return [{e.name: e.value for e in
             materialize.make_pod(job, spec, i).spec.containers[0].env}
            for i in range(slices)]


@pytest.fixture
def four_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)


@pytest.mark.parametrize("slices", [1, 2], ids=["llama-sp", "llama-pp"])
def test_pod_ranks_world_and_devices(four_cards, slices):
    envs = pod_envs(slices)
    for pid, env in enumerate(envs):
        assert env["TPU_ACCELERATOR_TYPE"] == "h100-4"
        assert launch.pod_devices("cuda", env) == 4
        ranks = launch.rank_envs(env, 4, JobRuntime.from_env(env), 4321)
        for local, renv in enumerate(ranks):
            rt = JobRuntime.from_env(renv)
            assert (rt.process_id, rt.num_processes) == (pid, slices)
            assert rt.launched and rt.local_rank == local
            assert rt.global_rank == pid * 4 + local
            assert rt.world_size == slices * 4
            assert renv["KCTPU_RANK"] == str(rt.global_rank)
            assert runtime.local_devices(renv) == 4
            assert tdevice.rank_device("cuda", renv) == torch.device(
                "cuda", local)
            assert launch.pod_devices("cuda", renv) == 0   # a rank
            if slices == 1:     # the one-process pod's store: loopback
                assert renv["JAX_COORDINATOR_ADDRESS"].startswith(
                    "127.0.0.1:")
            else:
                assert (renv["JAX_COORDINATOR_ADDRESS"]
                        == env["JAX_COORDINATOR_ADDRESS"])
        with pytest.raises(ValueError, match="local rank"):
            tdevice.rank_device("cuda:1", ranks[0])


def test_local_devices_env_wins_and_cards_are_checked(four_cards):
    [env] = pod_envs(1)
    assert launch.pod_devices("cuda", {**env, "KCTPU_LOCAL_DEVICES": "2"}) \
        == 2
    assert launch.pod_devices("cpu", {"KCTPU_LOCAL_DEVICES": "3"}) == 3
    with pytest.raises(RuntimeError, match="8 cards"):
        launch.pod_devices("cuda", {**env, "KCTPU_LOCAL_DEVICES": "8"})
    with pytest.raises(ValueError, match="names one card"):
        launch.pod_devices("cuda:0", {**env, "KCTPU_LOCAL_DEVICES": "4"})
    with pytest.raises(RuntimeError, match="no card"):
        tdevice.rank_device("cuda", {"KCTPU_LOCAL_RANK": "4"})


def test_mesh_product_must_be_pods_times_local_devices(four_cards):
    [env] = pod_envs(1, mesh={"sp": 4})
    assert json.loads(env["KCTPU_MESH"]) == {"dp": 1, "sp": 4}
    rt = JobRuntime.from_env(env)
    rt.local_devices = 4
    rt.check_mesh()
    rt.local_devices = 2
    with pytest.raises(ValueError, match="spans 4 devices"):
        rt.check_mesh()
    renv = launch.rank_envs({**env, "KCTPU_LOCAL_DEVICES": "2"}, 2, rt,
                            4321)[1]
    with pytest.raises(ValueError, match="spans 4 devices"):
        JobRuntime.from_env(renv).check_mesh()
    one = JobRuntime.from_env({**env, "KCTPU_MESH": json.dumps({"sp": 8})})
    one.check_mesh()        # one rank a process: build_mesh judges it


@pytest.mark.parametrize("accel,cards,want", [
    ("h100-2", 2, 2), ("h100-2", 4, "gives the pod 2 cards, but 4"),
    ("h100-4", 2, "gives the pod 4 cards, but 2"), ("v5e-8", 4, 4)],
    ids=["exact", "all_cards_of_the_host", "too_few", "tpu_family"])
def test_a_card_slice_pod_sees_exactly_its_cards(monkeypatch, accel, cards,
                                                  want):
    """A pod of an ``h100-<n>`` slice on ``cuda`` must see its n cards
    (the inventory's ``CUDA_VISIBLE_DEVICES``), never every card of its
    host; a TPU family's count is the slice's, not the pod's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    [env] = pod_envs(1)
    env["TPU_ACCELERATOR_TYPE"] = accel
    if isinstance(want, str):
        for e in (env, {**env, "KCTPU_LOCAL_DEVICES": "1"}):
            with pytest.raises(RuntimeError, match=want):
                launch.pod_devices("cuda", e)
    else:
        assert launch.pod_devices("cuda", env) == want
    assert launch.pod_devices("cuda:0", env) == 0     # names its card
    assert launch.pod_devices("cpu", env) == 0


def worker_pod_env(replicas=2):
    job = serde.from_dict(TFJob, {
        "apiVersion": "kubeflow.caicloud.io/v1alpha1", "kind": "TFJob",
        "metadata": {"name": "workers", "namespace": "default"},
        "spec": {"tfReplicaSpecs": [{
            "replicas": replicas, "tfReplicaType": "Worker",
            "template": {"spec": {"containers": [{
                "name": "pytorch", "image": "local",
                "command": module(PRETRAIN, *TINY)}]}}}]}})
    spec = job.spec.tf_replica_specs[0]
    pod = materialize.make_pod(job, spec, 1)
    return {e.name: e.value for e in pod.spec.containers[0].env}


@pytest.mark.parametrize("caller", [
    "chip_smoke_in_process", "mesh_cards_rank", "dryrun_multichip_rank",
    "worker_pod_cpu", "cuda_outside_contract"])
def test_existing_callers_stay_one_rank_a_process(four_cards, caller):
    gang = {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1234",
            "JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "2"}
    env, device = {
        "chip_smoke_in_process": ({}, "cuda:0"),
        "mesh_cards_rank": (gang, "cuda:2"),
        "dryrun_multichip_rank": (gang, "cpu"),
        "worker_pod_cpu": (worker_pod_env(), "cpu"),
        "cuda_outside_contract": ({}, "cuda"),
    }[caller]
    assert launch.pod_devices(device, env) == 0
    rt = JobRuntime.from_env(env)
    assert not rt.launched and rt.local_devices == 1
    assert rt.world_size == rt.num_processes
    assert rt.global_rank == rt.process_id
    assert runtime.local_devices(env) == 1
    assert tdevice.rank_device(device, env) == torch.device(device)


@pytest.mark.parametrize("local", ["0", "1"])
def test_pod_members_beat_guard_and_trace_as_the_pod(monkeypatch, local):
    """One beat stream and one guard a pod (local rank 0's); every rank's
    spans carry its global rank."""
    [env] = pod_envs(1)
    renv = {**env, "KCTPU_LOCAL_DEVICES": "2", "KCTPU_LOCAL_RANK": local,
            "KCTPU_RANK": str(4 + int(local)), "KCTPU_POD_NAME": "p",
            "KCTPU_PROGRESS_DIR": "/nonexistent",
            "KCTPU_GANG_MONITOR": "1", "KCTPU_RENDEZVOUS_DIR": "/tmp",
            "JAX_NUM_PROCESSES": "3", "JAX_PROCESS_ID": "2"}
    assert progress.ProgressReporter.from_env(renv).enabled == (local == "0")
    rt = JobRuntime.from_env(renv)
    guard = rendezvous.guard_from_env(rt, renv)
    assert (guard is not None) == (local == "0")
    if guard is not None:
        assert (guard.member, guard.peers) == (2, 3)  # the pod, of pods
    monkeypatch.setenv("KCTPU_RANK", renv["KCTPU_RANK"])
    tracer = trace.Tracer()
    with tracer.span("workload/fit", process=2):
        pass
    [sp] = tracer.spans()
    assert sp.args == {"rank": 4 + int(local), "process": 2}


# ---------------------------------------------------------------------------
# (ii)-(v) pods under the controller
# ---------------------------------------------------------------------------

def reference_mesh(*flags):
    """The reference's llama_pretrain over 4 forced host devices: starts
    it, returns a callable that waits for its mesh line."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    for var in ENV_VARS:
        env.pop(var, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_controller_tpu.workloads."
         "llama_pretrain", "--platform", "cpu", "--preset", "tiny",
         "--steps", "2", *flags], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def wait():
        out, err = proc.communicate(timeout=DEADLINE_S)
        assert proc.returncode == 0, err[-3000:]
        [line] = mesh_lines(out)
        return line
    return wait


def pod_vs_one_process(rig, monkeypatch, capsys, name, flags, one_flags,
                       accel, chips, model_dir=""):
    """The one-pod job of ``chips`` local devices running
    ``llama_pretrain`` with ``flags``, against the reference's mesh line
    for ``flags`` and a one-process port run of ``one_flags``."""
    ref = reference_mesh(*flags)
    job = manifest(name, module(PRETRAIN, *TINY, *flags), accel=accel,
                   chips=chips, local=chips, model_dir=model_dir)
    one = one_process(monkeypatch, capsys, tpre.main, TINY + one_flags)
    [out] = run_job(rig, job).values()
    [line] = mesh_lines(out)
    ref_line = ref()
    assert line[1:] == (str(chips), "0", "1"), line
    assert line[1] == ref_line[1]
    assert above_one(line[0]) == above_one(ref_line[0]), (line, ref_line)
    losses = final_losses(out)
    assert len(losses) == chips, out       # every rank's sign-off
    assert len(set(losses)) == 1, losses
    assert abs(losses[0] - one) <= 1e-5 * abs(one), (losses, one)
    for r in range(1, chips):
        assert f"[rank {r}] Rank {r}/{chips}: local {r}/{chips} on cpu" \
            in out, out
    return out


def test_one_pod_of_four_devices_trains_the_reference_mesh(
        rig, monkeypatch, capsys):
    pod_vs_one_process(rig, monkeypatch, capsys, "pod-sp", SP, (),
                       "h100-4", 4)


def test_one_pod_moe_under_ep4(rig, monkeypatch, capsys, tmp_path):
    model_dir = str(tmp_path / "moe")
    pod_vs_one_process(rig, monkeypatch, capsys, "pod-moe",
                       MOE + ("--ep", "4", "--fsdp", "1",
                              "--checkpoint-every", "1"), MOE,
                       "h100-4", 4, model_dir=model_dir)
    assert CheckpointManager(model_dir).latest_step() == 2


def test_two_pods_pp_resume(rig, tmp_path):
    model_dir = str(tmp_path / "pp")
    for name, steps, want in (("pods-pp", "3", 3),
                              ("pods-pp-resume", "2", 5)):
        job = manifest(name, module(PRETRAIN, *PP, "--steps", steps),
                       accel="h100-2", chips=2, slices=2, local=2,
                       model_dir=model_dir)
        logs = run_job(rig, job)
        assert len(logs) == 2
        lines = sorted(line for out in logs.values()
                       for line in mesh_lines(out))
        assert [line[1:] for line in lines] == [("4", "0", "2"),
                                                ("4", "1", "2")], logs
        assert all(above_one(line[0]) == {"pp": 2, "fsdp": 2}
                   for line in lines)
        assert len({x for out in logs.values()
                    for x in final_losses(out)}) == 1, logs
        assert CheckpointManager(model_dir).latest_step() == want
    assert all("Resumed from step 3" in out for out in logs.values()), logs


def test_flax_mnist_pod_of_two_devices(rig, monkeypatch, capsys):
    one = one_process(monkeypatch, capsys, tflax.main, MNIST)
    job = manifest("pod-flax", module(
        "kubeflow_controller_tpu_torch.workloads.flax_mnist", *MNIST),
        accel="h100-2", chips=2, local=2)
    [out] = run_job(rig, job).values()
    assert out.count("Process 0/1 on 2 devices (dp=2)") == 1, out
    assert "on 1 devices" not in out
    losses = final_losses(out)
    assert len(losses) == 2 and len(set(losses)) == 1, out
    assert abs(losses[0] - one) <= 1e-5 * abs(one), (losses, one)


def test_pod_ranks_profile_into_their_own_dirs(tmp_path):
    """A pod's ranks share its argv: each writes ``--profile-dir``'s trace
    under ``rank-<global rank>``."""
    env = {k: v for k, v in os.environ.items() if k not in ENV_VARS}
    env.update(KCTPU_LOCAL_DEVICES="2", OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO))
    res = subprocess.run(module(PRETRAIN, *TINY, "--fsdp", "2",
                                "--profile-dir", str(tmp_path)),
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=DEADLINE_S)
    assert res.returncode == 0, res.stderr[-3000:]
    assert sorted(p.relative_to(tmp_path).as_posix()
                  for p in tmp_path.rglob("*.json")) == [
        "rank-0/trace.json", "rank-1/trace.json"]


# ---------------------------------------------------------------------------
# (vi), (vii) the launcher's exit rule and signals
# ---------------------------------------------------------------------------

def test_failing_local_rank_fails_the_job(rig):
    job = manifest("pod-fail", [sys.executable, str(POD_RANK),
                                "--fail-rank", "1"],
                   accel="h100-2", chips=2, local=2)
    [out] = run_job(rig, job, TFJobPhase.FAILED).values()
    assert "joined 0/2" in out and "[rank 1] joined 1/2" in out, out
    cluster, _ = rig
    pods = [p for p in cluster.pods.list("default")
            if p.metadata.labels.get("tf_job_name") == "pod-fail"]
    assert [p.status.phase for p in pods] == ["Failed"]
    assert "exit 1" in pods[0].status.reason, pods[0].status.reason


def children_of(pid):
    """Live (not zombie) processes whose parent is ``pid``."""
    out = []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid and fields[0] != "Z":
            out.append(int(stat.parent.name))
    return out


def alive(pid):
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1] \
            .split()[0]
    except OSError:
        return False
    return state != "Z"


@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGKILL],
                         ids=["SIGTERM", "SIGKILL"])
def test_signal_to_the_pod_leaves_no_rank(sig):
    env = {k: v for k, v in os.environ.items() if k not in ENV_VARS}
    env.update(KCTPU_LOCAL_DEVICES="2", OMP_NUM_THREADS="1")
    pod = subprocess.Popen([sys.executable, str(POD_RANK), "--sleep", "120"],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.DEVNULL, text=True)
    try:
        assert "joined 0/2" in pod.stdout.readline()
        deadline = time.monotonic() + 30
        while len(children_of(pod.pid)) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        ranks = children_of(pod.pid)
        assert len(ranks) == 2, ranks
        pod.send_signal(sig)
        code = pod.wait(timeout=30)
        assert code == -sig if sig == signal.SIGKILL else code == 128 + sig
        deadline = time.monotonic() + 20
        while any(alive(r) for r in ranks) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not [r for r in ranks if alive(r)]
    finally:
        if pod.poll() is None:
            pod.kill()
            pod.wait()
