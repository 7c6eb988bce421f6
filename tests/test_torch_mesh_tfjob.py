"""End to end: the port's multi-process Llama pretrain under a mesh.

- A TFJob with 2 Workers (restart policy OnFailure, ``OMP_NUM_THREADS=1``)
  whose containers run ``python -m kubeflow_controller_tpu_torch.workloads.
  llama_pretrain --preset tiny --fsdp 2 --device cpu --steps 2`` under the
  unchanged ``Controller`` and ``FakeKubelet(execute=True)`` (the rig of
  ``tests/test_torch_tfjob.py``): the workers join one gloo group from the
  gang env, shard one model over fsdp 2 and reach ``Succeeded`` within
  120 s; both print the mesh line and the same final loss, which equals a
  one-process run's within 1e-5 relative.
- The same 2-Worker TFJob training the MoE (``--experts 8 --ep 2
  --moe-dispatch grouped --strict-moe-dispatch``): each worker holds 4 of
  the 8 experts and runs the ep-sharded grouped path; both reach
  ``Succeeded``, print the ep-2 mesh line and the final loss of one
  process within 1e-5 relative.
- The same 2-Worker TFJob under sequence parallelism (``--sp 2 --fsdp 1``,
  ring attention: the CPU mirror of ``examples/jobs/llama-sp.yaml``): each
  worker holds half of every sequence; both reach ``Succeeded``, print the
  sp-2 mesh line and the final loss of one process within 1e-5 relative.
- The same 2-Worker TFJob under pipeline parallelism, with the flags of
  ``examples/jobs/llama-pp.yaml`` (``--pp 2 --microbatches 8 --fsdp -1
  --checkpoint-every 100``): each worker holds one of the two layers and
  runs the 1F1B schedule over the pp group; both reach ``Succeeded``,
  print the pp-2 mesh line and the final loss of one process within 1e-5
  relative.
- A 4-Worker TFJob under pp with sp (``--pp 2 --sp 2 --microbatches 2
  --fsdp 1``): each worker holds one stage's layer and half of every
  sequence, running ring attention over its stage's sp group inside the
  1F1B schedule; all four reach ``Succeeded``, print the (pp 2, sp 2)
  mesh line and the final loss of one process within 1e-5 relative.
- A sharded kill-and-resume (the pattern of
  ``tests/test_torch_checkpoint.py``): two gloo ranks under fsdp 2 train 2
  steps with ``MODEL_DIR`` (saving step 2 collectively, each rank its own
  shards), run a third step and are killed (SIGKILL); two fresh ranks
  resume from step 2 to step 4.  Every loss and the final parameters are
  bit-identical to an uninterrupted 4-step run's.  The same under pp 2
  (each rank saving its own stage's layers and optimizer state, the
  embedding and head once).
"""

import os
import signal
import sys
import time

import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.api.tfjob import TFJob, TFJobPhase
from kubeflow_controller_tpu.cluster import Cluster, FakeKubelet, PhasePolicy
from kubeflow_controller_tpu.controller import Controller
from kubeflow_controller_tpu.utils import serde
from kubeflow_controller_tpu_torch.workloads import llama_pretrain as tpre
from kubeflow_controller_tpu_torch.workloads.checkpoint import CheckpointManager

from _torch_ranks import run_ranks, start_ranks, wait_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 120.0
ARGS = ("--preset", "tiny", "--fsdp", "2", "--device", "cpu", "--steps", "2")


ONE = ("--preset", "tiny", "--device", "cpu", "--steps", "2")
MOE_ONE = ONE + ("--experts", "8", "--moe-dispatch", "grouped",
                 "--strict-moe-dispatch")
MOE_ARGS = MOE_ONE + ("--ep", "2", "--fsdp", "1")
SP_ARGS = ONE + ("--sp", "2", "--fsdp", "1")
PP_ARGS = ONE + ("--pp", "2", "--microbatches", "8", "--fsdp", "-1",
                 "--checkpoint-every", "100")
PP_SP_ARGS = ONE + ("--pp", "2", "--sp", "2", "--microbatches", "2",
                    "--fsdp", "1")


def llama_job(name, args=ARGS, replicas=2):
    container = {"name": "pytorch", "image": "llama", "workingDir": REPO,
                 "command": [sys.executable, "-m",
                             "kubeflow_controller_tpu_torch.workloads."
                             "llama_pretrain", *args],
                 "env": [{"name": "OMP_NUM_THREADS", "value": "1"}]}
    return serde.from_dict(TFJob, {
        "apiVersion": "kubeflow.caicloud.io/v1alpha1", "kind": "TFJob",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {"tfReplicaSpecs": [{
            "replicas": replicas, "tfReplicaType": "Worker",
            "template": {"spec": {"restartPolicy": "OnFailure",
                                  "containers": [container]}}}]}})


@pytest.fixture
def rig():
    cluster = Cluster()
    kubelet = FakeKubelet(cluster, policy=PhasePolicy(), execute=True)
    ctrl = Controller(cluster, resync_period_s=0.5)
    kubelet.start()
    ctrl.run(threadiness=2)
    yield cluster, kubelet
    ctrl.stop()
    kubelet.stop()


def wait_terminal(cluster, name, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        job = cluster.tfjobs.get("default", name)
        if job.status.phase in (TFJobPhase.SUCCEEDED, TFJobPhase.FAILED):
            return job
        time.sleep(0.1)
    return cluster.tfjobs.get("default", name)


def final_loss(out):
    return float(out.split("Final loss: ")[1].split(";")[0])


def test_two_worker_fsdp_pretrain_job_succeeds(rig, capsys, monkeypatch):
    run_two_worker_job(rig, capsys, monkeypatch, "torch-llama-fsdp", ARGS,
                       ONE, "'fsdp': 2, 'ep': 1, 'sp': 1, 'tp': 1}")


def test_two_worker_ep_moe_pretrain_job_succeeds(rig, capsys, monkeypatch):
    run_two_worker_job(rig, capsys, monkeypatch, "torch-llama-moe-ep",
                       MOE_ARGS, MOE_ONE,
                       "'fsdp': 1, 'ep': 2, 'sp': 1, 'tp': 1}")


def test_two_worker_sp_pretrain_job_succeeds(rig, capsys, monkeypatch):
    run_two_worker_job(rig, capsys, monkeypatch, "torch-llama-sp", SP_ARGS,
                       ONE, "'fsdp': 1, 'ep': 1, 'sp': 2, 'tp': 1}")


def test_two_worker_pp_pretrain_job_succeeds(rig, capsys, monkeypatch):
    run_two_worker_job(rig, capsys, monkeypatch, "torch-llama-pp", PP_ARGS,
                       ONE, "{'pp': 2, 'dp': 1, 'fsdp': 1, 'ep': 1, 'sp': 1, "
                       "'tp': 1}")


def test_four_worker_pp_sp_pretrain_job_succeeds(rig, capsys, monkeypatch):
    run_two_worker_job(rig, capsys, monkeypatch, "torch-llama-pp-sp",
                       PP_SP_ARGS, ONE, "{'pp': 2, 'dp': 1, 'fsdp': 1, "
                       "'ep': 1, 'sp': 2, 'tp': 1}", replicas=4)


def run_two_worker_job(rig, capsys, monkeypatch, name, args, one_args,
                       mesh_line, replicas=2):
    """The TFJob of ``replicas`` Workers (2 by default) running
    ``llama_pretrain`` with ``args`` under the controller, against one
    process of ``one_args``."""
    cluster, kubelet = rig
    cluster.tfjobs.create(llama_job(name, args, replicas))
    # The one-process run the workers' loss is held to, while they train.
    for var in ("MODEL_DIR", "KCTPU_MESH", "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    assert tpre.main(list(one_args)) == 0
    one = final_loss(capsys.readouterr().out)
    job = wait_terminal(cluster, name, DEADLINE_S)
    pods = sorted((p for p in cluster.pods.list("default")
                   if p.metadata.labels.get("job_type") == "Worker"),
                  key=lambda p: p.metadata.name)
    logs = {p.metadata.name: kubelet.logs("default", p.metadata.name)
            .decode(errors="replace") for p in pods}
    assert job.status.phase == TFJobPhase.SUCCEEDED, (job.status.reason,
                                                      logs)
    assert len(pods) == replicas
    for p in pods:
        env = {e.name: e.value for e in p.spec.containers[0].env}
        assert env["JAX_NUM_PROCESSES"] == str(replicas)
        out = logs[p.metadata.name]
        assert (f"{mesh_line} over {replicas} devices, "
                f"process {env['JAX_PROCESS_ID']}/{replicas}") in out, out
    finals = {final_loss(out) for out in logs.values()}
    assert len(finals) == 1, finals
    assert abs(finals.pop() - one) <= 1e-5 * abs(one)


def wait_for(proc, text, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if text in line:
            return
        if not line and proc.poll() is not None:
            raise AssertionError(f"exited {proc.returncode}: "
                                 f"{proc.stderr.read()[-3000:]}")
    raise AssertionError(f"no {text!r} within {timeout} s")


def test_sharded_kill_and_resume_is_bit_identical(tmp_path):
    kill_and_resume("train", tmp_path)


def test_pp_kill_and_resume_is_bit_identical(tmp_path):
    kill_and_resume("train_pp", tmp_path)


def kill_and_resume(scenario, tmp_path):
    """Two ranks of ``scenario`` killed after saving step 2 and resumed to
    step 4, against 4 uninterrupted steps."""
    whole, first, second = (str(tmp_path / n) for n in ("whole", "first",
                                                         "second"))
    model_dir = str(tmp_path / "ckpt")
    uninterrupted = start_ranks(2, scenario, whole, "4")
    procs = start_ranks(2, scenario, first, "2", model_dir, "hang")
    try:
        for p in procs:
            wait_for(p, "past the checkpoint", 150)
    finally:
        for p in procs:
            p.send_signal(signal.SIGKILL)
            p.wait()
    wait_ranks(uninterrupted)
    assert CheckpointManager(model_dir).all_steps() == [2]
    shards = sorted(f for f in os.listdir(os.path.join(model_dir, "2"))
                    if f.endswith(".distcp"))
    assert len(shards) == 2, shards      # each rank wrote its own

    run_ranks(2, scenario, second, "2", model_dir)
    w, a, b = (torch.load(x, weights_only=False) for x in (whole, first,
                                                           second))
    assert a["start"] == 0 and b["start"] == 2
    assert a["losses"] + b["losses"] == w["losses"], (a["losses"],
                                                      b["losses"],
                                                      w["losses"])
    for name, ref in w["params"].items():
        np.testing.assert_array_equal(b["params"][name], ref, err_msg=name)
    assert CheckpointManager(model_dir).all_steps() == [2, 4]
