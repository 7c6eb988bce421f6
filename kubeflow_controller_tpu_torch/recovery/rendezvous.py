"""Gang re-rendezvous, workload half — the port's copy of
``GangGuard`` and ``guard_from_env`` from
``kubeflow_controller_tpu/recovery/rendezvous.py``, with the same exit
code, env names and file layout, so the unchanged controller and kubelet
treat a torch gang member exactly as a JAX one.

A gang that loses a member does not fail cleanly: the survivors block in
the next collective while the controller sees N-1 Running pods.  Each
member therefore runs a :class:`GangGuard`: a heartbeat file per member in
the node-shared rendezvous dir plus a monitor thread that watches the
peers' files.  A peer whose heartbeat goes stale without a clean ``.done``
marker means the gang is torn, and the survivor exits with
``EXIT_REJOIN``: its pod fails with ``GangBroken`` and the controller
replaces the whole gang under a bumped gang generation.

The default handler dumps the process's trace spans to
``$KCTPU_TRACE_DIR`` before it exits, as the reference's does
(``os._exit`` skips the exit-time dump).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional

from ..obs import trace

logger = logging.getLogger("kubeflow_controller_tpu_torch.recovery")

# Exit code a gang member uses for cooperative tear-down on peer loss: the
# kubelet maps it to a Failed pod with reason "GangBroken" (never an
# in-place restart — the gang is replaced as a unit).
EXIT_REJOIN = 64

# Opt-in env for the workload-side guard (set by the chaos bench and by
# deployments that want survivor self-detection; the fake kubelet notices
# a SIGKILLed process immediately, so in-process runs work without it).
ENV_GANG_MONITOR = "KCTPU_GANG_MONITOR"
# Controller-bumped gang generation (annotation + env, stamped by the
# planner; see planner/materialize.py ENV_GANG_GENERATION).
ENV_GANG_GENERATION = "KCTPU_GANG_GENERATION"


def generation_from_env(env=None) -> int:
    e = os.environ if env is None else env
    try:
        return int(e.get(ENV_GANG_GENERATION, "0") or "0")
    except ValueError:
        return 0


class GangGuard:
    """Per-member gang liveness: writes this member's heartbeat file and
    watches the peers'.

    File layout under ``directory`` (generation-scoped so a replacement
    gang never reads the dead generation's files):

    - ``<gang>-g<gen>-m<i>.alive`` — touched every ``interval_s``; mtime is
      the liveness signal;
    - ``<gang>-g<gen>-m<i>.done``  — dropped by a member that finished
      CLEANLY, written *before* the end-of-job barrier so a fast peer's
      exit is never mistaken for death.

    A peer is declared dead when its heartbeat has been seen at least once
    and then goes stale past ``timeout_s`` (never-seen peers get
    ``startup_grace_s`` — they may still be in image pull / rendezvous).
    ``on_broken(member_index)`` runs once, from the monitor thread; the
    default handler logs and ``os._exit(EXIT_REJOIN)`` — see module doc for
    why exiting (not rejoining in-process) is the correct tear-down.
    """

    def __init__(self, directory: str, gang: str, member: int, peers: int,
                 generation: int = 0, interval_s: float = 0.5,
                 timeout_s: float = 5.0, startup_grace_s: float = 120.0,
                 on_broken: Optional[Callable[[int], None]] = None):
        self.directory = directory
        self.gang = gang
        self.member = member
        self.peers = peers
        self.generation = generation
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.startup_grace_s = startup_grace_s
        self._on_broken = on_broken or self._default_on_broken
        self._seen: dict = {}  # member index -> last observed mtime
        self._stop = threading.Event()
        self._fired = False
        self._thread: Optional[threading.Thread] = None
        self._t0 = 0.0

    # -- file naming ---------------------------------------------------------

    def _base(self, member: int) -> str:
        safe = self.gang.replace("/", "_").replace(":", "_")
        return os.path.join(self.directory,
                            f"{safe}-g{self.generation}-m{member}")

    def alive_file(self, member: int) -> str:
        return self._base(member) + ".alive"

    def done_file(self, member: int) -> str:
        return self._base(member) + ".done"

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "GangGuard":
        if self._thread is not None:
            return self
        self._t0 = time.monotonic()
        self._touch()
        self._thread = threading.Thread(target=self._loop,
                                        name="gang-guard", daemon=True)
        self._thread.start()
        return self

    def mark_done(self) -> None:
        """Clean completion: write the done marker (peers will not treat the
        heartbeat going silent as death) and stop monitoring."""
        try:
            with open(self.done_file(self.member), "w") as fh:
                fh.write(str(os.getpid()))
        except OSError:
            pass
        self.stop()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.interval_s * 4 + 1.0)
        self._thread = None

    # -- internals -----------------------------------------------------------

    def _touch(self) -> None:
        path = self.alive_file(self.member)
        try:
            with open(path, "a"):
                pass
            os.utime(path, None)
        except OSError:
            pass  # liveness publishing is best-effort, like heartbeats

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._touch()
            dead = self.check_peers()
            if dead is not None and not self._fired:
                self._fired = True
                try:
                    self._on_broken(dead)
                finally:
                    return

    def check_peers(self) -> Optional[int]:
        """One observation pass; returns a dead peer's index or None."""
        now = time.time()
        for j in range(self.peers):
            if j == self.member:
                continue
            if os.path.exists(self.done_file(j)):
                continue  # finished cleanly: silence is not death
            try:
                mtime = os.path.getmtime(self.alive_file(j))
            except OSError:
                # Never seen: startup grace (rendezvous barriers mean the
                # fit cannot have started without this peer anyway).
                if (self._seen.get(j) is None
                        and time.monotonic() - self._t0
                        < self.startup_grace_s):
                    continue
                if self._seen.get(j) is None:
                    return j  # grace expired and never appeared
                return j      # file vanished after being seen
            self._seen[j] = mtime
            if now - mtime > self.timeout_s:
                return j
        return None

    def _default_on_broken(self, member: int) -> None:
        logger.warning(
            "gang %s generation %d: member %d heartbeat lost — tearing down "
            "for re-rendezvous (exit %d); the controller replaces the gang",
            self.gang, self.generation, member,
            EXIT_REJOIN)
        # Flush what the process can flush: the pod fails with GangBroken
        # and the controller replaces the whole gang.
        try:
            trace.dump_to_env_dir()
        except Exception:  # noqa: BLE001
            pass
        os._exit(EXIT_REJOIN)


def guard_from_env(rt, env=None) -> Optional[GangGuard]:
    """Build (but do not start) the workload-side guard from the node-agent
    env contract: enabled when ``KCTPU_GANG_MONITOR`` is set, the job is
    multi-process, and a shared rendezvous dir exists.  ``rt`` is the
    :class:`workloads.runtime.JobRuntime`.  The guard is the pod's (the
    controller's gang is pods): in a pod whose launcher runs several ranks
    (``workloads/launch.py``), local rank 0 alone runs it, as member
    ``process_id`` of ``num_processes``; its tear-down exit stops the
    pod's other ranks."""
    e = os.environ if env is None else env
    if not e.get(ENV_GANG_MONITOR):
        return None
    d = e.get("KCTPU_RENDEZVOUS_DIR", "")
    if not d or rt.num_processes <= 1 or rt.local_rank != 0:
        return None
    gang = e.get("KCTPU_GANG_NAME", "") or rt.coordinator or "gang"
    try:
        timeout_s = float(e.get("KCTPU_GANG_MONITOR_TIMEOUT", "5.0"))
    except ValueError:
        timeout_s = 5.0
    return GangGuard(d, gang, rt.process_id, rt.num_processes,
                     generation=rt.gang_generation, timeout_s=timeout_s)
