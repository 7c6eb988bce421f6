"""TFJobs of card slices under the unchanged controller, their cards given
by the port's inventory (``kubeflow_controller_tpu_torch/cluster/gpu.py``).

The rig is the reference's ``Controller`` and ``FakeKubelet(execute=True)``
over a ``GPUInventory`` of one declared 4-card host (one NVLink domain)
carved into two ``h100-2`` slices, once bare and once behind the
reference's ``GangScheduler``.  Each pod runs ``--device cpu`` ranks over
gloo (``$KCTPU_LOCAL_DEVICES`` 2); the cards it was given are the UUIDs in
its ``$CUDA_VISIBLE_DEVICES``, which the CPU's torch ignores, so the cards
are read, not used.

- A two-pod ``h100-2`` job whose pods print what they were given
  (``tests/_torch_card_probe.py``): each pod reads its own slice's two
  UUIDs, disjoint across the pods, and each fsdp pair of the controller's
  ``$KCTPU_MESH`` (pp 2 x fsdp 2) lies inside one pod's cards, while pp
  crosses the pods: the reference's mesh-to-slice plan holds once a slice
  is one NVLink domain.  The tiny ``llama_pretrain --pp 2 --fsdp 2``
  reaches ``Succeeded`` on the same rig.
- A second job stays ``Pending`` while the first holds both slices, then
  runs.
- ``fail_slice`` fails exactly the pods on that slice.
"""

import json
import sys
import time
from pathlib import Path

import pytest

from kubeflow_controller_tpu.api.tfjob import TFJobPhase
from kubeflow_controller_tpu.cluster import Cluster, FakeKubelet, PhasePolicy
from kubeflow_controller_tpu.controller import Controller
from kubeflow_controller_tpu.scheduler import GangScheduler, SchedulerPolicy
from kubeflow_controller_tpu_torch.cluster import gpu, topology

from test_torch_pod_devices import (
    PP,
    PRETRAIN,
    above_one,
    manifest,
    mesh_lines,
    module,
    run_job,
)

PROBE = Path(__file__).resolve().parent / "_torch_card_probe.py"
MESH = {"pp": 2, "fsdp": 2}
WAIT_S = 60.0
HOST = topology.GPUHost(
    "node-0", "h100", tuple(topology.GPUCard(i, f"GPU-node-0-card-{i}",
                                             f"00000000:{0x18 + i:02X}:00.0")
                            for i in range(4)), ((0, 1, 2, 3),))


@pytest.fixture(params=["bare", "gang_scheduler"])
def rig(request):
    inventory = gpu.GPUInventory(gpu.carve(HOST, 2))
    front = (inventory if request.param == "bare"
             else GangScheduler(inventory, SchedulerPolicy()))
    cluster = Cluster()
    kubelet = FakeKubelet(cluster, policy=PhasePolicy(), inventory=front,
                          execute=True)
    ctrl = Controller(cluster, inventory=front, resync_period_s=0.5)
    kubelet.start()
    ctrl.run(threadiness=2)
    yield cluster, kubelet, inventory
    ctrl.stop()
    kubelet.stop()


def probe_job(name, slices, sleep=0.0):
    return manifest(name, [sys.executable, str(PROBE), "--sleep", str(sleep)],
                    accel="h100-2", chips=2, slices=slices, local=2,
                    mesh=MESH if slices == 2 else None)


def probes(logs):
    """The probe lines of every pod's log (rank 0's bare, the others
    behind their ``[rank g]`` prefix), by pod name."""
    return {pod: [json.loads(line.split("probe ", 1)[1])
                  for line in out.splitlines() if "probe {" in line]
            for pod, out in logs.items()}


def pods_of(cluster, job):
    return sorted((p for p in cluster.pods.list("default")
                   if p.metadata.labels.get("tf_job_name") == job),
                  key=lambda p: p.metadata.name)


def wait_for(cond, what):
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def running(cluster, job, n):
    pods = pods_of(cluster, job)
    return len(pods) == n and all(p.status.phase == "Running" for p in pods)


def slice_cards():
    return [s.cards for s in gpu.carve(HOST, 2)]


def test_each_pod_runs_on_its_own_slice_cards(rig):
    cluster, kubelet, inventory = rig
    logs = run_job((cluster, kubelet), probe_job("cards", 2))
    lines = probes(logs)
    assert sorted(len(v) for v in lines.values()) == [2, 2], logs
    by_pod = {pod: {r["visible"] for r in recs}
              for pod, recs in lines.items()}
    assert all(len(v) == 1 for v in by_pod.values()), by_pod
    seen = sorted(tuple(v.pop().split(",")) for v in by_pod.values())
    assert seen == sorted(slice_cards()), seen     # disjoint: one slice each
    ranks = {r["rank"]: r for recs in lines.values() for r in recs}
    assert sorted(ranks) == [0, 1, 2, 3]
    for r in ranks.values():
        assert r["card"] == r["visible"].split(",")[r["local_rank"]]
        fsdp = r["groups"]["fsdp"]
        assert {ranks[g]["process"] for g in fsdp} == {r["process"]}, r
        assert {ranks[g]["card"] for g in fsdp} == set(
            r["visible"].split(",")), r
        assert len({ranks[g]["process"] for g in r["groups"]["pp"]}) == 2
    # The pretrain over the same plan: pp across the pods, fsdp inside.
    job = manifest("pretrain", module(PRETRAIN, *PP, "--steps", "2"),
                   accel="h100-2", chips=2, slices=2, local=2, mesh=MESH)
    logs = run_job((cluster, kubelet), job)
    got = sorted(line for out in logs.values() for line in mesh_lines(out))
    assert [line[1:] for line in got] == [("4", "0", "2"), ("4", "1", "2")]
    assert all(above_one(line[0]) == MESH for line in got)
    assert inventory.free_slice_count("h100-2") == 2   # released at the end


def test_a_second_job_waits_for_the_slices(rig):
    cluster, kubelet, inventory = rig
    cluster.tfjobs.create(probe_job("holder", 2, sleep=10.0))
    wait_for(lambda: running(cluster, "holder", 2), "the holder's pods")
    assert inventory.free_slice_count("h100-2") == 0
    cluster.tfjobs.create(probe_job("waiter", 1))
    wait_for(lambda: len(pods_of(cluster, "waiter")) == 1, "the waiter's pod")
    time.sleep(1.0)
    [waiting] = pods_of(cluster, "waiter")
    assert waiting.status.phase == "Pending"
    assert running(cluster, "holder", 2)
    wait_for(lambda: cluster.tfjobs.get("default", "waiter").status.phase
             == TFJobPhase.SUCCEEDED, "the waiter to succeed")
    assert cluster.tfjobs.get("default", "holder").status.phase == \
        TFJobPhase.SUCCEEDED
    [out] = probes({"w": kubelet.logs("default", waiting.metadata.name)
                    .decode(errors="replace")}).values()
    assert {r["visible"] for r in out} <= {",".join(c)
                                           for c in slice_cards()}


def test_fail_slice_fails_exactly_that_slices_pods(rig):
    cluster, kubelet, inventory = rig
    for name in ("left", "right"):
        cluster.tfjobs.create(probe_job(name, 1, sleep=120.0))
    for name in ("left", "right"):
        wait_for(lambda: running(cluster, name, 1), f"{name}'s pod")
    [left] = pods_of(cluster, "left")
    gang = left.metadata.annotations[gpu.ANNOTATION_GANG_NAME]
    slice_name = inventory.gang_slice(gang)
    assert kubelet.fail_slice(slice_name) == [left.metadata.name]
    [right] = pods_of(cluster, "right")
    assert right.status.phase == "Running"
    assert not inventory.slices[slice_name].healthy
    assert inventory.free_slice_count("h100-2") == 0
    for name in ("left", "right"):
        cluster.tfjobs.delete("default", name)
    wait_for(lambda: not pods_of(cluster, "right"), "right's pod to go")
