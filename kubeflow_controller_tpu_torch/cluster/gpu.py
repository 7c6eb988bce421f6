"""The port's slice inventory: gangs bound to named cards of a host.

The port's counterpart of the reference's ``cluster/tpu.py``.  There a
``TPUSlice`` is an abstract name, and on GKE the TPU device plugin gives
each pod of a bound slice that slice's chips.  Here a :class:`GPUSlice` is
a fixed set of cards inside one NVLink domain of one host
(:func:`carve`), and :class:`GPUInventory` does both jobs:

- the gang bookkeeping of the reference's ``TPUInventory``, with the same
  methods and the same answers (all-or-nothing admission, adjacency-scored
  placement, elastic release and growth, the two-scan idle reaper, the
  slice as the failure domain), so the unchanged controller, kubelet,
  elastic engine and gang scheduler drive it as they drive the reference;
- the device plugin's: each member pod of a bound gang gets
  ``$CUDA_VISIBLE_DEVICES`` set to the UUIDs of the cards of its slice
  (``gang.slice_names[<its slice-index annotation>]``) through its
  container's ``set_env``, on every path by which a pod reaches an
  inventory: :meth:`~GPUInventory.offer` (the kubelet's gate),
  :meth:`~GPUInventory.bind_gang` and :meth:`~GPUInventory.note_gang_pod`
  (the gang scheduler's admission and refresh) and
  :meth:`~GPUInventory.pod_started` (the kubelet's call on the object it
  then executes).  A pod that is not its gang's member on a bound slice
  gets an empty list: no pod falls back to every card of the host.

A slice's ``pod_id`` is its host's name, so the reference's adjacency
("fewest DCN domains") reads as "fewest hosts".  A slice of more than one
host needs an NVLink domain across hosts, which no host here has: a
``GPUSlice`` of several hosts raises, and a gang of more pods than slices
(several hosts a slice) is held, as the reference holds a gang that no
slice fits.

The port imports nothing of the JAX package, so the contract strings it
reads are copies of the reference's (``api/labels.py``, ``api/core.py``),
held equal to them by the tests.
"""

from __future__ import annotations

import logging
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from .topology import ENV_VISIBLE_DEVICES, GPUHost

logger = logging.getLogger("kubeflow_controller_tpu_torch.inventory")

DOMAIN = "kubeflow.caicloud.io"
ANNOTATION_GANG_NAME = f"{DOMAIN}/gang-name"
ANNOTATION_GANG_SIZE = f"{DOMAIN}/gang-size"
ANNOTATION_ACCELERATOR = f"{DOMAIN}/accelerator-type"
ANNOTATION_NUM_SLICES = f"{DOMAIN}/num-slices"
ANNOTATION_SLICE_INDEX = f"{DOMAIN}/slice-index"
# The chip resource the controller puts on every TPU-typed pod.
RESOURCE_TPU = "google.com/tpu"
_CARD_SLICE = re.compile(r"^[a-z]+\d+[a-z]*-(\d+)$")
# The TPU families' "<family>-<chips of the slice>" (api/tfjob.py).
_TPU_ACCELERATOR = re.compile(r"^v(\d+)(p|e|lite)?-(\d+)$")


def slice_cards(accelerator_type: str) -> int:
    """n of a card slice's ``<family>-<n>`` (``h100-2``: 2), else 0: a
    TPU family's ``v5e-8`` counts the chips of several hosts."""
    m = _CARD_SLICE.match(accelerator_type)
    if m is None or _TPU_ACCELERATOR.match(accelerator_type):
        return 0
    return int(m.group(1))


@dataclass
class GPUSlice:
    """``TPUSlice``'s fields, plus the host and its cards' UUIDs."""
    name: str
    accelerator_type: str = ""          # "<family>-<len(cards)>"
    num_hosts: int = 1
    chips_per_host: int = 0             # len(cards)
    bound_gang: str = ""
    healthy: bool = True
    bound_at: float = 0.0
    pod_id: str = ""                    # the host's name
    pod_pos: int = 0
    host: str = ""
    cards: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.num_hosts != 1:
            raise ValueError(f"slice {self.name!r}: {self.num_hosts} hosts; "
                             "a slice is one NVLink domain of one host")
        self.cards = tuple(self.cards)
        self.chips_per_host = self.chips_per_host or len(self.cards)


def dcn_domain(s: GPUSlice) -> str:
    """The slice's adjacency domain: its host (its own name without one)."""
    return s.pod_id or s.name


def adjacency_score(n_slices: int, n_domains: int) -> float:
    """1.0 when the gang sits on one host, 0.0 when every slice is on
    its own; linear in the number of crossings."""
    if n_slices <= 1:
        return 1.0
    return (n_slices - n_domains) / (n_slices - 1)


def carve(host: GPUHost, cards_per_slice: int) -> List[GPUSlice]:
    """Each NVLink domain of ``host`` cut into slices of
    ``cards_per_slice`` consecutive cards, ``<family>-<n>`` each.  Raises
    where a domain is not a multiple of ``cards_per_slice``.  A carve is
    fixed, as a TPU slice is."""
    if cards_per_slice < 1:
        raise ValueError(f"cards_per_slice {cards_per_slice}: want >= 1")
    accel = f"{host.family}-{cards_per_slice}"
    out: List[GPUSlice] = []
    for domain in host.nvlink_domains:
        if len(domain) % cards_per_slice:
            raise ValueError(
                f"host {host.name!r}: NVLink domain {list(domain)} of "
                f"{len(domain)} cards is not a multiple of {cards_per_slice}")
        for pos in range(0, len(domain), cards_per_slice):
            out.append(GPUSlice(
                f"{host.name}/{accel}/{len(out)}", accel, pod_id=host.name,
                pod_pos=len(out), host=host.name,
                cards=tuple(host.card(i).uuid
                            for i in domain[pos:pos + cards_per_slice])))
    return out


@dataclass
class _Gang:
    name: str
    size: int
    accelerator_type: str
    num_slices: int = 1
    pods: Dict[str, object] = field(default_factory=dict)  # "ns/name" -> pod
    slice_names: List[str] = field(default_factory=list)
    wide: bool = False      # more pods than slices: never bound

    @property
    def slice_name(self) -> str:
        return self.slice_names[0] if self.slice_names else ""


def _key(pod) -> str:
    return f"{pod.metadata.namespace}/{pod.metadata.name}"


class GPUInventory:
    """Tracks card slices and gangs; admits gangs all-or-nothing and gives
    each member pod its slice's cards."""

    def __init__(self, slices: Optional[List[GPUSlice]] = None):
        self._lock = threading.Lock()
        self.slices: Dict[str, GPUSlice] = {s.name: s for s in (slices or [])}
        # Accelerator type -> free healthy slices, kept on every change:
        # the "is there capacity" polls must not scan the table.
        self._free_counts: Dict[str, int] = {}
        for s in self.slices.values():
            if s.healthy and not s.bound_gang:
                self._free_counts[s.accelerator_type] = (
                    self._free_counts.get(s.accelerator_type, 0) + 1)
        self._gangs: Dict[str, _Gang] = {}
        self._idle_candidates: set = set()
        # Gangs of more pods than slices, logged once each.
        self._held_wide: set = set()
        self._version = 0
        self._busy_s = 0.0

    @property
    def version(self) -> int:
        return self._version

    def add_slice(self, s: GPUSlice) -> None:
        with self._lock:
            old = self.slices.get(s.name)
            if old is not None and old.healthy and not old.bound_gang:
                self._free_counts[old.accelerator_type] -= 1
            self.slices[s.name] = s
            if s.healthy and not s.bound_gang:
                self._free_counts[s.accelerator_type] = (
                    self._free_counts.get(s.accelerator_type, 0) + 1)
            self._version += 1

    # -- the device plugin ---------------------------------------------------

    def _cards_locked(self, gang_name: str, slice_index: int) -> Tuple[str, ...]:
        g = self._gangs.get(gang_name)
        if g is None or not 0 <= slice_index < len(g.slice_names):
            raise KeyError(f"gang {gang_name!r} has no bound slice "
                           f"{slice_index}")
        return self.slices[g.slice_names[slice_index]].cards

    def cards_of(self, gang_name: str, slice_index: int = 0) -> List[str]:
        """The card UUIDs of the gang's bound slice ``slice_index``."""
        with self._lock:
            return list(self._cards_locked(gang_name, slice_index))

    def _stamp_locked(self, pod) -> None:
        """Set the pod's ``$CUDA_VISIBLE_DEVICES`` to its slice's cards, or
        to none when it is no member of a bound slice."""
        ann = pod.metadata.annotations
        cards: Tuple[str, ...] = ()
        try:
            cards = self._cards_locked(
                ann.get(ANNOTATION_GANG_NAME, ""),
                int(ann.get(ANNOTATION_SLICE_INDEX, "0") or "0"))
        except KeyError:
            pass
        for c in pod.spec.containers:
            c.set_env(ENV_VISIBLE_DEVICES, ",".join(cards))

    def _stamp_gang_locked(self, g: _Gang) -> None:
        for pod in g.pods.values():
            self._stamp_locked(pod)

    def pod_started(self, pod) -> None:
        """The kubelet's call on the pod object it is about to run: its
        cards, stamped once more on that very object."""
        with self._lock:
            self._stamp_locked(pod)

    # -- admission -----------------------------------------------------------

    def _wide_locked(self, gang_name: str, size: int, n_slices: int) -> bool:
        """True when the gang has more pods than slices: each slice would
        span hosts, which no card slice does, so no slice fits it and the
        gang is held (logged once)."""
        if size <= n_slices:
            return False
        if gang_name not in self._held_wide:
            self._held_wide.add(gang_name)
            logger.warning(
                "gang %r held: %d pods on %d slices needs slices of several "
                "hosts; a card slice is one host's NVLink domain",
                gang_name, size, n_slices)
        return True

    def offer(self, pod) -> bool:
        """Offer a pod for scheduling.  True iff its gang is (now) admitted
        onto its slices, and then the pod carries its cards.  A pod with
        no gang is admitted alone iff a slice is free, and bound to none."""
        ann = pod.metadata.annotations
        gang_name = ann.get(ANNOTATION_GANG_NAME, "")
        accel = ann.get(ANNOTATION_ACCELERATOR, "")
        with self._lock:
            if not gang_name:
                self._stamp_locked(pod)
                return self._find_free_slices(accel, 1) is not None
            size = int(ann.get(ANNOTATION_GANG_SIZE, "1"))
            n_slices = int(ann.get(ANNOTATION_NUM_SLICES, "1") or "1")
            gang = self._gangs.setdefault(
                gang_name, _Gang(gang_name, size, accel, num_slices=n_slices))
            gang.pods[_key(pod)] = pod
            gang.size = size
            gang.wide = self._wide_locked(gang_name, size, n_slices)
            if gang.wide:
                return False
            if gang.slice_names:
                if n_slices > len(gang.slice_names):
                    extra = self._find_free_slices(
                        accel, n_slices - len(gang.slice_names),
                        prefer_domains=self._gang_domains_locked(gang))
                    if extra is None:
                        return False
                    self._bind_locked(gang, extra)
                    gang.num_slices = len(gang.slice_names)
                self._stamp_locked(pod)
                return True
            if len(gang.pods) < gang.size:
                return False
            found = self._find_free_slices(accel, gang.num_slices)
            if found is None:
                return False
            self._bind_locked(gang, found)
            self._stamp_gang_locked(gang)
            return True

    def _bind_locked(self, gang: _Gang, found: List[GPUSlice]) -> None:
        now = time.time()
        for sl in found:
            sl.bound_gang = gang.name
            sl.bound_at = now
            self._free_counts[sl.accelerator_type] -= 1
        gang.slice_names = gang.slice_names + [sl.name for sl in found]
        self._version += 1

    def _unbind_locked(self, sl: GPUSlice) -> None:
        if sl.bound_at:
            self._busy_s += max(0.0, time.time() - sl.bound_at)
        if sl.bound_gang and sl.healthy:
            self._free_counts[sl.accelerator_type] = (
                self._free_counts.get(sl.accelerator_type, 0) + 1)
        sl.bound_gang = ""
        sl.bound_at = 0.0
        self._version += 1

    def bind_gang(self, gang_name: str, accelerator_type: str,
                  n_slices: int = 1, size: int = 0,
                  pods: Optional[Dict[str, object]] = None
                  ) -> Optional[List[str]]:
        """Atomically bind ``n_slices`` free healthy slices to the gang, or
        None if fewer exist; ``pods`` join the member map and get their
        cards.  A gang of more pods than slices is held: None."""
        with self._lock:
            if self._wide_locked(gang_name, size or len(pods or ()) or 1,
                                 n_slices):
                return None
            found = self._find_free_slices(accelerator_type, n_slices)
            if found is None:
                return None
            gang = self._gangs.setdefault(
                gang_name,
                _Gang(gang_name, size or (len(pods) if pods else 1),
                      accelerator_type, num_slices=n_slices))
            if pods:
                gang.pods.update(pods)
            self._bind_locked(gang, found)
            self._stamp_gang_locked(gang)
            return list(gang.slice_names)

    def note_gang_pod(self, gang_name: str, pod) -> None:
        """Record a member pod on an already-bound gang, with its cards."""
        with self._lock:
            g = self._gangs.get(gang_name)
            if g is not None:
                g.pods[_key(pod)] = pod
                self._stamp_locked(pod)

    def release_slices(self, gang_name: str, n_release: int) -> List[str]:
        """Unbind ``n_release`` of the gang's slices, breaking the fewest
        hosts and never the coordinator's (bind position 0); returns their
        names.  At least one slice stays.  The pods on the kept slices keep
        their cards."""
        with self._lock:
            g = self._gangs.get(gang_name)
            if g is None or n_release <= 0:
                return []
            n_release = min(n_release, max(0, len(g.slice_names) - 1))
            if n_release <= 0:
                return []
            names = list(g.slice_names)
            keep_n = len(names) - n_release

            def dom_of(pos: int) -> str:
                sl = self.slices.get(names[pos])
                return dcn_domain(sl) if sl is not None else names[pos]
            coord_dom = dom_of(0)
            groups: Dict[str, List[int]] = {}
            for pos in range(1, len(names)):
                groups.setdefault(dom_of(pos), []).append(pos)
            ordered = sorted(
                groups.items(),
                key=lambda kv: (kv[0] != coord_dom, -len(kv[1])))
            kept = {0}
            for _dom, positions in ordered:
                for pos in positions:
                    if len(kept) == keep_n:
                        break
                    kept.add(pos)
                if len(kept) == keep_n:
                    break
            released = [names[pos] for pos in range(len(names))
                        if pos not in kept]
            g.slice_names = [names[pos] for pos in sorted(kept)]
            g.num_slices = keep_n
            for name in released:
                sl = self.slices.get(name)
                if sl is not None:
                    self._unbind_locked(sl)
            return released

    def grow_gang(self, gang_name: str, accelerator_type: str,
                  n_extra: int) -> Optional[List[str]]:
        """Bind ``n_extra`` more free slices to an admitted gang, all or
        nothing; the new slice names, or None when capacity is short."""
        with self._lock:
            g = self._gangs.get(gang_name)
            if g is None or n_extra <= 0 or g.wide:
                return None
            found = self._find_free_slices(
                accelerator_type, n_extra,
                prefer_domains=self._gang_domains_locked(g))
            if found is None:
                return None
            self._bind_locked(g, found)
            g.num_slices = len(g.slice_names)
            return [sl.name for sl in found]

    def _gang_domains_locked(self, g: _Gang) -> List[str]:
        out: List[str] = []
        for name in g.slice_names:
            sl = self.slices.get(name)
            dom = dcn_domain(sl) if sl is not None else name
            if dom not in out:
                out.append(dom)
        return out

    def placement_of(self, gang_name: str) -> Optional[Dict[str, object]]:
        """The reference's placement (slices, domains, score) plus the hosts
        and each slice's cards, in bind order."""
        with self._lock:
            g = self._gangs.get(gang_name)
            if g is None or not g.slice_names:
                return None
            domains = self._gang_domains_locked(g)
            bound = [self.slices[n] for n in g.slice_names]
            hosts: List[str] = []
            for sl in bound:
                if sl.host not in hosts:
                    hosts.append(sl.host)
            return {
                "slices": list(g.slice_names),
                "domains": domains,
                "score": round(
                    adjacency_score(len(g.slice_names), len(domains)), 4),
                "hosts": hosts,
                "cards": [list(sl.cards) for sl in bound],
            }

    def has_free_slice(self, accelerator_type: str = "") -> bool:
        return self.free_slice_count(accelerator_type) > 0

    def free_slice_count(self, accelerator_type: str = "") -> int:
        with self._lock:
            if accelerator_type:
                return self._free_counts.get(accelerator_type, 0)
            return sum(self._free_counts.values())

    def gang_on_slice(self, slice_name: str) -> str:
        with self._lock:
            sl = self.slices.get(slice_name)
            return sl.bound_gang if sl else ""

    def busy_seconds(self) -> float:
        """Slice-busy seconds of every binding, finished and in flight."""
        now = time.time()
        with self._lock:
            return self._busy_s + sum(
                max(0.0, now - s.bound_at)
                for s in self.slices.values() if s.bound_gang and s.bound_at)

    def utilization_now(self) -> float:
        """The bound share of the healthy slices."""
        with self._lock:
            healthy = [s for s in self.slices.values() if s.healthy]
            if not healthy:
                return 0.0
            return sum(1 for s in healthy if s.bound_gang) / len(healthy)

    def _find_free_slices(self, accelerator_type: str, n: int,
                          prefer_domains: Iterable[str] = (),
                          ) -> Optional[List[GPUSlice]]:
        """n free healthy slices of the type spanning the fewest hosts
        (largest free group first, ``prefer_domains`` ahead; ties in table
        order), or None if fewer exist."""
        free = [s for s in self.slices.values()
                if not s.bound_gang and s.healthy
                and (not accelerator_type
                     or s.accelerator_type == accelerator_type)]
        if len(free) < n:
            return None
        prefer = set(prefer_domains)
        groups: Dict[str, List[GPUSlice]] = {}
        for s in free:
            groups.setdefault(dcn_domain(s), []).append(s)
        ordered = sorted(
            groups.items(),
            key=lambda kv: (kv[0] not in prefer, -len(kv[1])))
        out: List[GPUSlice] = []
        for _dom, members in ordered:
            for s in members:
                out.append(s)
                if len(out) == n:
                    return out
        return None

    def gang_slice(self, gang_name: str) -> str:
        with self._lock:
            g = self._gangs.get(gang_name)
            return g.slice_name if g else ""

    def gang_slices(self, gang_name: str) -> List[str]:
        with self._lock:
            g = self._gangs.get(gang_name)
            return list(g.slice_names) if g else []

    def release_gang(self, gang_name: str) -> None:
        """Free every slice the gang holds, and its cards."""
        with self._lock:
            g = self._gangs.pop(gang_name, None)
            for name in (g.slice_names if g else []):
                if name in self.slices:
                    self._unbind_locked(self.slices[name])

    def release_idle_gangs(self, active_pod_keys) -> List[str]:
        """Release every gang none of whose pods ("namespace/name") is
        active, once it has been idle in two consecutive calls."""
        active = set(active_pod_keys)
        with self._lock:
            idle = {name for name, g in self._gangs.items()
                    if not (set(g.pods) & active)}
            confirmed = list(idle & self._idle_candidates)
            self._idle_candidates = idle - set(confirmed)
        for name in confirmed:
            self.release_gang(name)
        return confirmed

    def fail_slice(self, slice_name: str) -> List[str]:
        """A whole-slice failure: the slice never admits again (its cards
        are withheld), and the gang bound to it is evicted from all its
        slices.  Returns the "namespace/name" keys of the gang's pods."""
        with self._lock:
            sl = self.slices.get(slice_name)
            if sl is None:
                return []
            if sl.healthy and not sl.bound_gang:
                self._free_counts[sl.accelerator_type] -= 1
            sl.healthy = False
            self._version += 1
            if not sl.bound_gang:
                return []
            g = self._gangs.pop(sl.bound_gang, None)
            for name in (g.slice_names if g else [sl.name]):
                if name in self.slices:
                    self._unbind_locked(self.slices[name])
            return list(g.pods.keys()) if g else []
