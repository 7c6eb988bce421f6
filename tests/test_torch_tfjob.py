"""End to end: a dist-mnist TFJob whose Worker pods run the PyTorch port.

The job has the shape of ``examples/jobs/dist.yaml`` (a PS replica set and
a Worker replica set, restart policy OnFailure), cut to 1 PS + 2 Workers
and 30 steps, with ``OMP_NUM_THREADS=1`` in the container env.  Every
container runs ``python -m kubeflow_controller_tpu_torch.workloads.
mnist_dist --device cpu``.  It runs under the unchanged ``Controller`` and
``FakeKubelet(execute=True)`` (the rig of ``tests/test_execute_e2e.py``):
the planner hands the workers the TF-contract args and the gang env, the
kubelet maps the coordinator's service name to a local port, the two
workers join one gloo group and train one model, the PS parks, and the job
must reach ``Succeeded`` within 60 s.  A second job, whose workers demand
an accuracy of 2.0 (restart policy Never, so no gang replacement), must
reach ``Failed``.
"""

import os
import sys
import time

import pytest

from kubeflow_controller_tpu.api.tfjob import TFJob, TFJobPhase
from kubeflow_controller_tpu.cluster import Cluster, FakeKubelet, PhasePolicy
from kubeflow_controller_tpu.controller import Controller
from kubeflow_controller_tpu.utils import serde

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 60.0


def dist_mnist_job(name, *worker_args, restart="OnFailure"):
    def container(*extra):
        return {"name": "pytorch", "image": "dist", "workingDir": REPO,
                "command": [sys.executable, "-m",
                            "kubeflow_controller_tpu_torch.workloads."
                            "mnist_dist", "--device", "cpu", *extra],
                "env": [{"name": "OMP_NUM_THREADS", "value": "1"}]}

    def replicas(n, typ, restart_policy, *extra):
        return {"replicas": n, "tfReplicaType": typ, "template": {"spec": {
            "restartPolicy": restart_policy,
            "containers": [container(*extra)]}}}

    return serde.from_dict(TFJob, {
        "apiVersion": "kubeflow.caicloud.io/v1alpha1", "kind": "TFJob",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {"tfReplicaSpecs": [
            replicas(1, "PS", "OnFailure"),
            replicas(2, "Worker", restart, "--steps", "30", "--train-size",
                     "1024", "--eval-size", "256", *worker_args)]}})


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


def workers(cluster):
    return sorted((p for p in cluster.pods.list("default")
                   if p.metadata.labels.get("job_type") == "Worker"),
                  key=lambda p: p.metadata.name)


def test_dist_mnist_job_on_the_port_succeeds(rig):
    cluster, kubelet = rig
    t0 = time.monotonic()
    cluster.tfjobs.create(dist_mnist_job("torch-dist-mnist"))
    job = wait_terminal(cluster, "torch-dist-mnist", DEADLINE_S)
    took = time.monotonic() - t0
    pods = workers(cluster)
    logs = {p.metadata.name: kubelet.logs("default", p.metadata.name)
            .decode(errors="replace") for p in pods}
    assert job.status.phase == TFJobPhase.SUCCEEDED, (job.status.reason,
                                                      logs)
    assert took < DEADLINE_S
    assert len(pods) == 2
    seen = set()
    for p in pods:
        c = p.spec.containers[0]
        assert any(a.startswith("--worker_hosts=") for a in c.args)
        env = {e.name: e.value for e in c.env}
        assert env["JAX_COORDINATOR_ADDRESS"]
        assert env["JAX_NUM_PROCESSES"] == "2"
        seen.add(env["JAX_PROCESS_ID"])
        out = logs[p.metadata.name]
        assert f"Worker {env['JAX_PROCESS_ID']}/2 on cpu" in out, out
        assert "Final loss:" in out
    assert seen == {"0", "1"}
    # One model: both workers sign off with the same loss and accuracy.
    finals = {out.split("Final loss: ")[1].splitlines()[0]
              for out in logs.values()}
    assert len(finals) == 1, finals


def test_dist_mnist_job_below_target_accuracy_fails(rig):
    cluster, _ = rig
    cluster.tfjobs.create(dist_mnist_job(
        "torch-dist-mnist-fail", "--target-accuracy", "2.0",
        restart="Never"))
    job = wait_terminal(cluster, "torch-dist-mnist-fail", DEADLINE_S)
    assert job.status.phase == TFJobPhase.FAILED, job.status.reason
    assert "below target" in job.status.reason, job.status.reason
