"""The ports where the port's ranks meet, with no window between a probe
and a bind that another process group's connection could take
(``workloads/launch.py``, ``graft_entry.py``).

- A one-process pod's launcher opens the ranks' TCP store itself, as
  master on a port the kernel picks, before the first rank spawns: every
  rank receives that port and the flag to join as a client, and the store
  answers while the ranks run; it is closed once they exit.
- ``launch.free_port`` (the one copy of the rule; the tests' helpers use
  it) draws below the kernel's ephemeral range, and the dry run's rank 0
  binds such a port.
"""

import io
import socket
from datetime import timedelta
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from kubeflow_controller_tpu_torch import graft_entry
from kubeflow_controller_tpu_torch.workloads import launch
from kubeflow_controller_tpu_torch.workloads.runtime import (
    ENV_COORDINATOR,
    ENV_STORE_HOSTED,
    JobRuntime,
)

import _torch_ranks

EPHEMERAL = Path("/proc/sys/net/ipv4/ip_local_port_range")


def ephemeral_low() -> int:
    return int(EPHEMERAL.read_text().split()[0]) if EPHEMERAL.exists() \
        else 32768


class Exited:
    """A spawned rank that has already exited 0."""

    def __init__(self):
        self.returncode = 0
        self.stdout = io.BytesIO(b"")

    def poll(self):
        return 0

    def wait(self, timeout=None):
        return 0

    def send_signal(self, sig):
        pass

    def kill(self):
        pass


def test_launcher_store_is_bound_before_the_ranks_spawn(monkeypatch):
    stores, spawned = [], []
    real_store = launch.host_store

    def recording_store(*args, **kwargs):
        stores.append(real_store(*args, **kwargs))
        return stores[-1]

    def spawn(cmd, env, **kwargs):
        host, _, port = env[ENV_COORDINATOR].rpartition(":")
        # The store answers as the rank starts: a client joins, writes
        # and reads back through it.
        client = dist.TCPStore(host, int(port), is_master=False,
                               timeout=timedelta(seconds=10))
        client.set(f"rank-{env['KCTPU_LOCAL_RANK']}", "up")
        spawned.append((int(port), env[ENV_STORE_HOSTED],
                        client.get(f"rank-{env['KCTPU_LOCAL_RANK']}")))
        return Exited()

    monkeypatch.setattr(launch, "host_store", recording_store)
    monkeypatch.setattr(launch.subprocess, "Popen", spawn)
    rt = JobRuntime()                       # one process: its own store
    assert launch.run_pod(["rank"], {"PATH": "/bin"}, 3, rt) == 0
    (store,) = stores
    assert spawned == [(store.port, "1", b"up")] * 3
    # Rank 0 too joins as a client: the runtime reads the flag.
    renv = launch.rank_envs({}, 2, rt, store.port)[0]
    joined = JobRuntime.from_env(renv)
    assert joined.store_hosted and joined.launched
    assert joined.coordinator == f"127.0.0.1:{store.port}"


def test_pod_of_several_processes_keeps_the_controllers_coordinator(
        monkeypatch):
    envs = []
    monkeypatch.setattr(launch, "run_ranks",
                        lambda cmd, es: envs.extend(es) or 0)
    monkeypatch.setattr(launch, "host_store", lambda *a, **k: pytest.fail(
        "a pod of a multi-process gang opened a store"))
    rt = JobRuntime(coordinator="pod-0.svc:8476", num_processes=2,
                    process_id=1)
    assert launch.run_pod(["rank"], {ENV_COORDINATOR: rt.coordinator}, 2,
                          rt) == 0
    assert [e[ENV_COORDINATOR] for e in envs] == ["pod-0.svc:8476"] * 2
    assert not any(ENV_STORE_HOSTED in e for e in envs)


def test_hosted_ranks_form_a_group_through_the_launchers_store():
    """Two threads stand for the two ranks of a one-process pod: both
    join the launcher's store as clients and form a gloo group."""
    import threading

    store = launch.host_store(timeout_s=30)
    rt = JobRuntime()
    renvs = launch.rank_envs({}, 2, rt, store.port)
    got = {}

    def rank(r):
        client = JobRuntime.from_env(renvs[r])
        host, port = client._coordinator_addr()
        s = dist.TCPStore(host, port, client.world_size, is_master=False,
                          timeout=timedelta(seconds=30))
        pg = dist.ProcessGroupGloo(dist.PrefixStore("g", s), r, 2)
        t = torch.tensor([float(r + 1)])
        pg.allreduce([t]).wait()
        got[r] = t.item()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert got == {0: 3.0, 1: 3.0}


def test_free_port_lies_below_the_ephemeral_range():
    low = ephemeral_low()
    for _ in range(50):
        port = launch.free_port()
        assert 10000 <= port < low
        with socket.socket() as s:
            s.bind(("127.0.0.1", port))     # still free
    assert _torch_ranks.free_port is launch.free_port


def test_dry_run_rank_zero_binds_a_port_below_the_ephemeral_range(
        monkeypatch):
    envs = []

    def spawn(argv, env, **kwargs):
        envs.append(env)
        proc = Exited()
        proc.returncode = 1                 # every rank "fails" at once
        proc.poll = lambda: 1
        return proc

    monkeypatch.setattr(graft_entry.subprocess, "Popen", spawn)
    with pytest.raises(RuntimeError, match="failed"):
        graft_entry.dryrun_multichip(2, "cpu", timeout_s=5)
    ports = {int(e["JAX_COORDINATOR_ADDRESS"].rpartition(":")[2])
             for e in envs}
    assert len(envs) == 2 and len(ports) == 1
    assert 10000 <= ports.pop() < ephemeral_low()
