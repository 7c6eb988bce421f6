"""End to end: checkpoint recovery and the vision TFJobs of the PyTorch
port under the unchanged ``Controller`` and ``FakeKubelet(execute=True)``
(the rig of ``tests/test_execute_e2e.py``: two single-host v5e-4 slices,
so a failed slice leaves a spare).  Every container runs a module of
``kubeflow_controller_tpu_torch.workloads`` with ``--device cpu`` and
``OMP_NUM_THREADS=1``.

- The analog of ``test_slice_failure_resumes_from_checkpoint``: a
  TPU-typed TFJob with a ``modelDir`` trains the port's tiny
  ``llama_pretrain`` with ``--checkpoint-every 1``; once a checkpoint is
  on disk the whole slice is failed (``kubelet.fail_slice``).  The
  controller replaces the gang at index 0 on the spare slice, the
  replacement prints "Resumed from step", the job reaches ``Succeeded``,
  and the final checkpoint step is past ``--steps`` (a fresh start would
  end at exactly ``--steps``).
- A worker-only ``cifar_allreduce --model cnn`` job with 2 Workers (no PS,
  no ``--ps_hosts``) reaches ``Succeeded``; both workers sign off with
  the same loss.
- A TPU-typed ``flax_mnist`` job with a ``modelDir`` reaches
  ``Succeeded``, and its checkpoint restores into a fresh model.
"""

import os
import sys
import time

import torch

from kubeflow_controller_tpu.api.core import Container, EnvVar, PodTemplateSpec
from kubeflow_controller_tpu.api.meta import ObjectMeta
from kubeflow_controller_tpu.api.tfjob import (
    ReplicaType,
    TFJob,
    TFJobPhase,
    TFReplicaSpec,
    TPUSpec,
)
from kubeflow_controller_tpu.cluster import (
    Cluster,
    FakeKubelet,
    PhasePolicy,
    TPUInventory,
    TPUSlice,
)
from kubeflow_controller_tpu.controller import Controller
from kubeflow_controller_tpu_torch.models import vision
from kubeflow_controller_tpu_torch.workloads.checkpoint import (
    CheckpointManager,
)
from kubeflow_controller_tpu_torch.workloads.trainer import adam

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_job(name, module, *args, typ=ReplicaType.TPU, replicas=1,
             restart="OnFailure", model_dir=""):
    job = TFJob(metadata=ObjectMeta(name=name, namespace="default"))
    if model_dir:
        job.spec.model_dir = model_dir
    c = Container(name="pytorch", image="local", working_dir=REPO,
                  command=[sys.executable, "-m",
                           f"kubeflow_controller_tpu_torch.workloads.{module}",
                           "--device", "cpu", *args])
    c.env.append(EnvVar(name="OMP_NUM_THREADS", value="1"))
    t = PodTemplateSpec()
    t.spec.containers.append(c)
    t.spec.restart_policy = restart
    spec = TFReplicaSpec(replicas=replicas, tf_replica_type=typ, template=t)
    if typ == ReplicaType.TPU:
        spec.tpu = TPUSpec(accelerator_type="v5e-4", chips_per_host=4)
    job.spec.tf_replica_specs.append(spec)
    return job


@pytest.fixture
def rig():
    cluster = Cluster()
    inventory = TPUInventory([TPUSlice("slice-0", "v5e-4", num_hosts=1),
                              TPUSlice("slice-1", "v5e-4", num_hosts=1)])
    kubelet = FakeKubelet(cluster, policy=PhasePolicy(), inventory=inventory,
                          execute=True)
    ctrl = Controller(cluster, inventory=inventory, resync_period_s=0.5)
    kubelet.start()
    ctrl.run(threadiness=2)
    yield cluster, kubelet
    ctrl.stop()
    kubelet.stop()


def wait_phase(cluster, name, phase, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        job = cluster.tfjobs.get("default", name)
        if job.status.phase == phase:
            return job
        assert job.status.phase != TFJobPhase.FAILED, job.status.reason
        time.sleep(0.1)
    raise AssertionError(f"{name}: {job.status.phase} ({job.status.reason})")


def pod_logs(cluster, kubelet):
    return {p.metadata.name: kubelet.logs("default", p.metadata.name)
            .decode(errors="replace")
            for p in cluster.pods.list("default")}


LLAMA = ("--batch-size", "2", "--seq-len", "32", "--dim", "64",
         "--intermediate", "128")


def test_slice_failure_resumes_from_checkpoint(rig, tmp_path):
    cluster, kubelet = rig
    model_dir = str(tmp_path / "resume-ck")
    steps = 150
    cluster.tfjobs.create(port_job(
        "torch-resume", "llama_pretrain", "--steps", str(steps), *LLAMA,
        "--checkpoint-every", "1", model_dir=model_dir))
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if (os.path.isdir(model_dir)
                and (CheckpointManager(model_dir).latest_step() or 0) >= 1):
            break
        time.sleep(0.05)
    first = CheckpointManager(model_dir).latest_step()
    assert first is not None and first < steps, first
    first_pods = {p.metadata.name for p in cluster.pods.list("default")}
    assert kubelet.fail_slice("slice-0"), "fail_slice found no bound gang"

    wait_phase(cluster, "torch-resume", TFJobPhase.SUCCEEDED, 120.0)
    pods = cluster.pods.list("default")
    replacement = [p for p in pods if p.metadata.name not in first_pods]
    assert replacement and replacement[0].metadata.labels.get("index") == "0"
    assert kubelet.inventory.slices["slice-0"].healthy is False
    final = CheckpointManager(model_dir).latest_step()
    assert final is not None and final > steps, (
        f"final step {final} <= {steps}: the replacement started over")
    logs = pod_logs(cluster, kubelet)
    resumed = [t for t in logs.values() if "Resumed from step" in t]
    assert resumed, logs
    assert f"in {model_dir}" in resumed[0] and "Final loss:" in resumed[0]


def test_worker_only_cifar_allreduce_job(rig):
    cluster, kubelet = rig
    cluster.tfjobs.create(port_job(
        "torch-allreduce", "cifar_allreduce", "--model", "cnn", "--steps",
        "4", "--batch-size", "16", "--train-size", "128", "--eval-size",
        "64", typ=ReplicaType.WORKER, replicas=2))
    wait_phase(cluster, "torch-allreduce", TFJobPhase.SUCCEEDED, 90.0)
    pods = [p for p in cluster.pods.list("default")
            if p.metadata.labels.get("job_type") == "Worker"]
    assert len(pods) == 2
    logs = pod_logs(cluster, kubelet)
    for p in pods:
        args = p.spec.containers[0].args
        assert any(a.startswith("--worker_hosts=") for a in args)
        assert not any(a.startswith("--ps_hosts=") for a in args)
        assert "(cnn) on 2-way mesh" in logs[p.metadata.name]
    finals = {logs[p.metadata.name].split("Final loss: ")[1].splitlines()[0]
              for p in pods}
    assert len(finals) == 1, finals


def test_flax_mnist_job_saves_a_checkpoint_that_restores(rig, tmp_path):
    cluster, kubelet = rig
    model_dir = str(tmp_path / "flax-ck")
    cluster.tfjobs.create(port_job(
        "torch-flax-mnist", "flax_mnist", "--steps", "6", "--batch-size",
        "32", "--train-size", "256", "--eval-size", "64",
        model_dir=model_dir))
    wait_phase(cluster, "torch-flax-mnist", TFJobPhase.SUCCEEDED, 90.0)
    logs = "".join(pod_logs(cluster, kubelet).values())
    assert f"Checkpoint saved to {model_dir}" in logs, logs
    model = vision.FlaxMNISTCNN(device="cpu")
    opt = adam(model.parameters(), 2e-3)
    _, _, step = CheckpointManager(model_dir).restore(model, opt)
    assert step == 6
    assert all(float(s["step"]) == 6.0 for s in opt.inner.state.values())
    assert all(torch.isfinite(p).all() for p in model.parameters())
