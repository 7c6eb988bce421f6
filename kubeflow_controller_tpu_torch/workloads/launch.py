"""The pod's launcher: one rank a local device.

The reference drives every local device of a pod from its one process
(``jax.distributed.initialize`` once a pod, then a mesh over
``jax.devices()``: ``kubeflow_controller_tpu/workloads/runtime.py``).  The
port runs one process a device, so a pod of L local devices runs L ranks:
the pod's process, the one the node agent starts, spawns L fresh
interpreters of the same module and argv, each with its local rank in the
env, and trains in none of them itself.

L (:func:`pod_devices`):

- ``$KCTPU_LOCAL_DEVICES`` where it is set (the port's counterpart of the
  reference rig's forced host device count);
- else, for ``cuda`` with no index under the controller's contract
  (``JAX_NUM_PROCESSES`` or ``TPU_ACCELERATOR_TYPE`` in the env), the
  visible cards;
- else none: the process is its own one rank, as is every caller that
  names its card (``--device cuda:<r>``), names the CPU, or runs outside
  the contract.

A pod asking for more cards than it sees raises, as does a mesh
(``$KCTPU_MESH``) that is not the pods times L, and, on ``cuda`` with no
index, a pod of a card slice (``$TPU_ACCELERATOR_TYPE`` ``<family>-<n>``
outside the TPU families, ``cluster/gpu.py``) that does not see exactly
its n cards: no pod trains silently on every card of its host.  Each
rank's env adds ``$KCTPU_LOCAL_RANK``, ``$KCTPU_LOCAL_DEVICES`` (L),
``$KCTPU_RANK`` (its global rank, which its trace spans carry) and the
launcher's pid; the ranks of a one-process pod meet at a TCP store on
the loopback that the launcher holds open (:func:`host_store`) from
before the first rank spawns until the last one exits.

- The ranks are spawned, never forked (an executed pod may be forked from
  a zygote that imported JAX, and a process that touched CUDA cannot fork
  CUDA children), and the launcher never initialises CUDA.
- A rank's non-zero exit stops the others and is the pod's exit code.
- SIGTERM and SIGINT to the pod reach every rank; a rank dies with its
  launcher (``PR_SET_PDEATHSIG``) and leaves at once if the launcher is
  gone before it starts (:func:`bind_to_launcher`).
- Local rank 0's stdout and stderr are the pod's; the other ranks' lines go
  to the pod's stderr, each prefixed ``[rank <global rank>]``.
"""

from __future__ import annotations

import ctypes
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
from datetime import timedelta
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence

import torch

from ..cluster.gpu import slice_cards
from ..cluster.topology import ENV_VISIBLE_DEVICES
from ..device import ENV_LOCAL_DEVICES, ENV_LOCAL_RANK, DeviceLike, resolve_device
from ..obs.trace import RANK_ENV
from .runtime import (
    ENV_COORDINATOR,
    ENV_NUM_PROCESSES,
    ENV_STORE_HOSTED,
    ENV_TPU_ACCELERATOR,
    JOIN_TIMEOUT_S,
    JobRuntime,
)

ENV_LAUNCHER_PID = "KCTPU_LAUNCHER_PID"
# Seconds the other ranks get to leave after a stop before SIGKILL.
STOP_GRACE_S = 10.0
POLL_S = 0.05
PR_SET_PDEATHSIG = 1
# The directory that holds the port's package, first on the ranks' path.
PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])
EPHEMERAL = Path("/proc/sys/net/ipv4/ip_local_port_range")


def check_slice_cards(env: Mapping[str, str]) -> None:
    """A pod of a card slice must see exactly the slice's cards."""
    accel = env.get(ENV_TPU_ACCELERATOR, "")
    want = slice_cards(accel)
    seen = torch.cuda.device_count()
    if want and seen != want:
        raise RuntimeError(
            f"${ENV_TPU_ACCELERATOR}={accel} gives the pod {want} cards, "
            f"but {seen} are visible (${ENV_VISIBLE_DEVICES}="
            f"{env.get(ENV_VISIBLE_DEVICES, '<unset>')!r}): the inventory "
            "sets the slice's cards")


def pod_devices(device: DeviceLike = "cuda",
                env: Optional[Mapping[str, str]] = None) -> int:
    """L for this process as its pod's launcher, or 0 when it is a rank
    of its own (see the module docstring).  Raises without CUDA unless
    the CPU is named, when the pod asks for cards it does not see, and
    when a card slice's pod does not see its slice's cards."""
    e = os.environ if env is None else env
    dev = resolve_device(device)
    if e.get(ENV_LOCAL_RANK) is not None:
        return 0
    raw = e.get(ENV_LOCAL_DEVICES, "")
    if dev.type == "cuda" and dev.index is None:
        check_slice_cards(e)
    if not raw:
        contract = e.get(ENV_NUM_PROCESSES) or e.get(ENV_TPU_ACCELERATOR)
        if dev.type != "cuda" or dev.index is not None or not contract:
            return 0
        return torch.cuda.device_count()
    n = int(raw)
    if n < 1:
        raise ValueError(f"${ENV_LOCAL_DEVICES}={raw!r}: want >= 1")
    if dev.type == "cuda":
        if dev.index is not None:
            raise ValueError(f"device {str(dev)!r} names one card, but the "
                             f"pod has {n} local devices: pass 'cuda'")
        seen = torch.cuda.device_count()
        if seen < n:
            raise RuntimeError(f"${ENV_LOCAL_DEVICES}={n} asks for {n} "
                               f"cards, but {seen} are visible")
    return n


def free_port() -> int:
    """A loopback port that binds now, drawn below the kernel's ephemeral
    range, for a caller whose rank 0 binds it later.  The connections of
    other process groups on the host take their local ports from that
    range, and one of them could take a port found free there before rank
    0 binds it (EADDRINUSE)."""
    low = 32768
    if EPHEMERAL.exists():
        low = int(EPHEMERAL.read_text().split()[0])
    rng = random.Random()
    for _ in range(100):
        port = rng.randrange(10000, low)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def host_store(timeout_s: float = JOIN_TIMEOUT_S):
    """The TCP store a one-process pod's ranks meet at: opened here, by
    the launcher, as master on a port the kernel picks (port 0), so no
    port is free between a probe and a bind.  The ranks join it as
    clients (``$KCTPU_STORE_HOSTED``); it lives until they exit."""
    import torch.distributed as dist

    return dist.TCPStore("127.0.0.1", 0, is_master=True,
                         wait_for_workers=False,
                         timeout=timedelta(seconds=timeout_s))


def rank_envs(env: Mapping[str, str], n: int, rt: JobRuntime,
              store_port: Optional[int]) -> List[Dict[str, str]]:
    """The env of each of the pod's ``n`` ranks: ``env`` with the local
    rank, L, the global rank, the launcher's pid and the package first on
    ``PYTHONPATH``; a one-process pod's coordinator moves to the
    launcher's store on the loopback (``store_port``, which the ranks join
    as clients; None for a pod of a multi-process gang, whose ranks meet
    at the controller's coordinator)."""
    base = dict(env)
    base.update({ENV_LOCAL_DEVICES: str(n),
                 ENV_LAUNCHER_PID: str(os.getpid()),
                 "PYTHONPATH": os.pathsep.join(
                     [PACKAGE_ROOT] + ([base["PYTHONPATH"]]
                                       if base.get("PYTHONPATH") else []))})
    if rt.num_processes <= 1:
        if store_port is None:
            raise ValueError("a one-process pod's ranks meet at its "
                             "launcher's store: pass its port")
        base[ENV_COORDINATOR] = f"127.0.0.1:{store_port}"
        base[ENV_STORE_HOSTED] = "1"
    return [{**base, ENV_LOCAL_RANK: str(r),
             RANK_ENV: str(rt.process_id * n + r)} for r in range(n)]


def bind_to_launcher(env: Optional[Mapping[str, str]] = None) -> None:
    """In a launched rank: die with the launcher (``PR_SET_PDEATHSIG``),
    and leave now if it is already gone."""
    e = os.environ if env is None else env
    if sys.platform.startswith("linux"):
        try:
            libc = ctypes.CDLL(None, use_errno=True)
            libc.prctl(PR_SET_PDEATHSIG, int(signal.SIGKILL), 0, 0, 0)
        except (OSError, AttributeError):
            pass
    parent = int(e.get(ENV_LAUNCHER_PID, "0") or "0")
    if parent and os.getppid() != parent:
        raise SystemExit(f"local rank {e.get(ENV_LOCAL_RANK)}: the pod's "
                         f"launcher {parent} is gone")


def _exit_code(code: int) -> int:
    return 128 - code if code < 0 else code


def _pump(stream, label: str) -> None:
    """Copy a rank's output to the pod's stderr, line by line, prefixed."""
    prefix = f"[rank {label}] ".encode()
    for line in iter(stream.readline, b""):
        try:
            os.write(2, prefix + line)
        except OSError:
            pass
    stream.close()


def _stop(procs: List[subprocess.Popen], sig: int = signal.SIGTERM) -> None:
    """``sig`` to every live rank, then SIGKILL after ``STOP_GRACE_S``."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(sig)
    deadline = time.monotonic() + STOP_GRACE_S
    for p in procs:
        try:
            p.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def run_ranks(cmd: Sequence[str], envs: Sequence[Mapping[str, str]]) -> int:
    """Spawn ``cmd`` once an env, wait, and return the pod's exit code:
    0 when every rank exits 0, else the first non-zero exit seen (a
    signal's 128 + its number), the other ranks stopped."""
    procs: List[subprocess.Popen] = []
    pumps: List[threading.Thread] = []
    stopped: List[int] = []

    def on_signal(signum, _frame):
        stopped.append(signum)
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    handlers = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            handlers[sig] = signal.signal(sig, on_signal)
    sys.stdout.flush()
    sys.stderr.flush()
    try:
        for env in envs:
            if stopped:
                break
            quiet = env[ENV_LOCAL_RANK] != "0"
            p = subprocess.Popen(
                list(cmd), env=dict(env),
                stdout=subprocess.PIPE if quiet else None,
                stderr=subprocess.STDOUT if quiet else None)
            procs.append(p)
            if quiet:
                t = threading.Thread(target=_pump,
                                     args=(p.stdout, env[RANK_ENV]),
                                     name=f"rank-{env[RANK_ENV]}-output",
                                     daemon=True)
                t.start()
                pumps.append(t)
        while not stopped:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                _stop(procs)
                return _exit_code(bad[0])
            if len(procs) == len(envs) and all(c == 0 for c in codes):
                return 0
            time.sleep(POLL_S)
        _stop(procs, stopped[0])
        return 128 + stopped[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for t in pumps:
            t.join(5.0)
        for sig, old in handlers.items():
            signal.signal(sig, old)


def launch_pod(module: str, argv: Optional[Sequence[str]],
               device: DeviceLike = "cuda",
               rt: Optional[JobRuntime] = None) -> Optional[int]:
    """A workload main's first step: in a pod of L local devices, run its
    L ranks (``python -m module argv``, ``argv`` defaulting to
    ``sys.argv[1:]``) and return the pod's exit code; in a rank, or in a
    process that is its own rank, return None, and the caller trains.
    ``rt`` is the caller's runtime (after ``merge_tf_args``), else the
    env's."""
    if os.environ.get(ENV_LOCAL_RANK) is not None:
        resolve_device(device)
        bind_to_launcher()
        return None
    n = pod_devices(device)
    if not n:
        return None
    rt = JobRuntime.from_env() if rt is None else rt
    rt.local_devices = n
    rt.check_mesh()
    cmd = [sys.executable, "-m", module,
           *(sys.argv[1:] if argv is None else argv)]
    return run_pod(cmd, os.environ, n, rt)


def run_pod(cmd: Sequence[str], env: Mapping[str, str], n: int,
            rt: JobRuntime) -> int:
    """Run the pod's ``n`` ranks of ``cmd`` (:func:`run_ranks` over
    :func:`rank_envs`); a one-process pod's ranks meet at the store this
    launcher holds (:func:`host_store`), opened before the first rank
    spawns and closed after the last one exits."""
    store = host_store() if rt.num_processes <= 1 else None
    try:
        return run_ranks(cmd, rank_envs(
            env, n, rt, store.port if store is not None else None))
    finally:
        del store
