"""The port's card inventory (``kubeflow_controller_tpu_torch/cluster``)
against the reference's slice inventory (``cluster/tpu.py``).

- The differential test: ``TPUInventory`` and ``GPUInventory`` hold the
  same slices (one ``GPUSlice`` per ``TPUSlice``: same name, accelerator
  string and domain) and go through the same seeded sequences of
  ``offer``, ``bind_gang``, ``grow_gang``, ``release_slices``,
  ``fail_slice``, ``release_idle_gangs`` and ``release_gang`` over
  stand-in pods with ``_wire_tpu_pod``'s annotations.  Every return value
  and every view (free counts, version, placement, bound gangs) must be
  equal after every operation.  In the "wide" mix two of the gangs have
  two pods a slice (a slice of two hosts, as ``numHosts: 2`` gives): the
  port holds them, and the reference holds them too, its pods asking for
  a two-host slice that neither side has.
- The cards, checked on the same sequences: each admitted pod carries
  exactly its slice's UUIDs, no UUID belongs to two live gangs, a
  released slice's cards come back and a failed slice's stay withheld,
  and an elastic release or growth leaves each surviving pod's cards as
  they were.
- ``parse_topo`` on the matrix an H100 host's ``nvidia-smi topo -p2p n``
  printed and on matrices of NVLink pairs, quads and none; ``discover_host`` matching the
  visible cards to ``nvidia-smi``'s list by UUID; ``carve``'s refusals;
  the copied contract strings against the reference's.
"""

import copy
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke as cs
from kubeflow_controller_tpu.api import core, labels
from kubeflow_controller_tpu.api import tfjob as api_tfjob
from kubeflow_controller_tpu.cluster.tpu import TPUInventory, TPUSlice
from kubeflow_controller_tpu.planner import materialize
from kubeflow_controller_tpu.scheduler import GangScheduler, SchedulerPolicy
from kubeflow_controller_tpu_torch.cluster import gpu, topology

from test_torch_pod_devices import manifest, module

VISIBLE = topology.ENV_VISIBLE_DEVICES
SEEDS = range(10)
OPS = 120
# The operations of a sequence and their weights: a failed slice never
# comes back, so failures are rare enough to leave capacity to contend for.
OP_WEIGHTS = {"offer": 5, "bind": 2, "grow": 2, "release_slices": 2,
              "fail": 0.5, "idle": 1, "release": 1.5}

# ``nvidia-smi topo -p2p n`` on a host of 4 x NVIDIA H100 80GB HBM3
# (700 W; 18 NVLinks a card, every pair joined over NVLink) whose GPU
# stack runs in a user-space kernel: ``topo -m`` printed "Failed to run
# topology matrix" there, having no PCIe common ancestor to read.
H100_TOPO = """\
 \t\x1b[4mGPU0\tGPU1\tGPU2\tGPU3\t\x1b[0m
 GPU0\tX\tOK\tOK\tOK\t
 GPU1\tOK\tX\tOK\tOK\t
 GPU2\tOK\tOK\tX\tOK\t
 GPU3\tOK\tOK\tOK\tX\t

Legend:

  X    = Self
  OK   = Status Ok
  CNS  = Chipset not supported
  GNS  = GPU not supported
  TNS  = Topology not supported
  NS   = Not supported
  U    = Unknown
"""

# ``topo -p2p n`` on a PCIe host: no pair joined by NVLink.
PCIE_P2P = """\
 \tGPU0\tGPU1\t
 GPU0\tX\tNS\t
 GPU1\tNS\tX\t
"""

# Two NVLink pairs, as ``topo -p2p n`` prints them.
PAIRS_P2P = """\
 \tGPU0\tGPU1\tGPU2\tGPU3\t
 GPU0\tX\tOK\tNS\tNS\t
 GPU1\tOK\tX\tNS\tNS\t
 GPU2\tNS\tNS\tX\tOK\t
 GPU3\tNS\tNS\tOK\tX\t
"""

# One card alone.
ONE_P2P = """\
 \tGPU0\t
 GPU0\tX\t
"""


def p2p(n, joined):
    """``topo -p2p n``'s matrix of ``n`` cards, ``OK`` for the pairs in
    ``joined`` and an unsupported status for the rest."""
    head = " \t" + "".join(f"GPU{j}\t" for j in range(n))
    rows = [f" GPU{i}\t" + "".join(
        "X\t" if i == j else "OK\t" if {i, j} in joined else
        ("NS\t", "CNS\t", "TNS\t", "GNS\t", "U\t")[(i + j) % 5]
        for j in range(n)) for i in range(n)]
    return "\n".join([head, *rows, "", "Legend:", "", "  OK   = Status Ok"])


# Eight cards in two NVLink quads, joined as rings 0-1-2-3 and 4-5-6-7.
QUADS_P2P = p2p(8, [{i, (i + 1) % 4} for i in range(4)]
                + [{4 + i, 4 + (i + 1) % 4} for i in range(4)])


def host(domains, name="h0"):
    n = sum(len(d) for d in domains)
    return topology.GPUHost(name, "h100", tuple(
        topology.GPUCard(i, f"GPU-{name}-{i}", f"00000000:{i:02X}:00.0")
        for i in range(n)), tuple(tuple(d) for d in domains))


# ---------------------------------------------------------------------------
# Contract, topology, carve
# ---------------------------------------------------------------------------

def test_contract_strings_equal_the_reference():
    for name in ("ANNOTATION_GANG_NAME", "ANNOTATION_GANG_SIZE",
                 "ANNOTATION_ACCELERATOR", "ANNOTATION_NUM_SLICES",
                 "ANNOTATION_SLICE_INDEX"):
        assert getattr(gpu, name) == getattr(labels, name), name
    assert gpu.RESOURCE_TPU == core.RESOURCE_TPU
    assert gpu._TPU_ACCELERATOR.pattern == api_tfjob._ACCEL_RE.pattern


def test_stand_in_pods_carry_wire_tpu_pod_annotations():
    """``chip_smoke.gang_pods`` stands in for ``make_pod``'s TPU pods."""
    job = manifest("standin", module("x"), accel="h100-2", chips=2,
                   slices=2)
    spec = job.spec.tf_replica_specs[0]
    keys = (gpu.ANNOTATION_GANG_SIZE, gpu.ANNOTATION_ACCELERATOR,
            gpu.ANNOTATION_NUM_SLICES, gpu.ANNOTATION_SLICE_INDEX)
    for i, stand_in in enumerate(cs.gang_pods("standin", 2, "h100-2")):
        pod = materialize.make_pod(job, spec, i)
        assert {k: stand_in.metadata.annotations[k] for k in keys} == \
            {k: pod.metadata.annotations[k] for k in keys}
        for side in (stand_in, pod):
            assert side.spec.containers[0].resources.requests[
                gpu.RESOURCE_TPU] == "2"
        assert stand_in.metadata.annotations[gpu.ANNOTATION_GANG_NAME] == \
            pod.metadata.annotations[gpu.ANNOTATION_GANG_NAME]


@pytest.mark.parametrize("text,want", [
    (H100_TOPO, ((0, 1, 2, 3),)),
    (QUADS_P2P, ((0, 1, 2, 3), (4, 5, 6, 7))),
    (ONE_P2P, ((0,),)),
    (p2p(4, []), ((0,), (1,), (2,), (3,))),
    (PCIE_P2P, ((0,), (1,))),
    (PAIRS_P2P, ((0, 1), (2, 3))),
], ids=["h100x4_p2p", "quads_p2p", "one_p2p", "no_nvlink_p2p", "pcie_p2p",
        "pairs_p2p"])
def test_parse_topo(text, want):
    assert topology.parse_topo(text) == want


def test_parse_topo_refuses_text_without_a_matrix():
    with pytest.raises(ValueError, match="no GPU matrix"):
        topology.parse_topo("No devices were found\n")


def test_parse_topo_refuses_a_column_that_is_no_card():
    text = PAIRS_P2P.replace("\tGPU3\t\n", "\tCPU\t\n", 1)
    with pytest.raises(ValueError, match="not its columns"):
        topology.parse_topo(text)


@pytest.mark.parametrize("name,family", [
    ("NVIDIA H100 80GB HBM3", "h100"), ("NVIDIA H100 PCIe", "h100"),
    ("NVIDIA A100-SXM4-80GB", "a100"), ("NVIDIA H200", "h200")])
def test_card_family(name, family):
    assert topology.card_family(name) == family


def fake_cards(monkeypatch, physical, visible):
    """A host whose ``nvidia-smi`` lists ``physical`` cards of two NVLink
    pairs and whose process sees the cards of ``visible`` (their indices
    on the host), in that order; torch gives each card's UUID bare."""
    uuids = [f"GPU-{i:08x}-aaaa-bbbb-cccc-{i:012x}" for i in range(physical)]
    rows = "\n".join(f"{i}, {u}, "
                     "NVIDIA H100 80GB HBM3" for i, u in enumerate(uuids))
    calls = []

    def smi(*args):
        calls.append(args)
        return PAIRS_P2P if args == ("topo", "-p2p", "n") else rows
    monkeypatch.setattr(topology, "_smi", smi)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: len(visible))
    monkeypatch.setattr(
        torch.cuda, "get_device_properties", lambda i: SimpleNamespace(
            name="NVIDIA H100 80GB HBM3", uuid=uuids[visible[i]][4:],
            pci_domain_id=0, pci_bus_id=0x18 + visible[i], pci_device_id=0))
    return uuids, calls


@pytest.mark.parametrize("visible,domains", [
    ((0, 1, 2, 3), ((0, 1), (2, 3))), ((2, 3), ((2, 3),)),
    ((1, 2), ((1,), (2,))), ((3,), ((3,),))],
    ids=["all", "one_pair", "across_pairs", "one"])
def test_discover_host_matches_visible_cards_by_uuid(monkeypatch, visible,
                                                     domains):
    uuids, calls = fake_cards(monkeypatch, 4, visible)
    h = topology.discover_host("node-a")
    assert (h.name, h.family) == ("node-a", "h100")
    assert [c.index for c in h.cards] == list(visible)
    assert [c.uuid for c in h.cards] == [uuids[i] for i in visible]
    assert h.cards[0].pci_bus_id == f"00:{0x18 + visible[0]:02x}:00"
    assert h.nvlink_domains == domains
    # One visible card is a domain of its own: no matrix is read.
    assert (("topo", "-p2p", "n") in calls) == (len(visible) > 1)


def test_discover_host_refuses_an_unlisted_card(monkeypatch):
    fake_cards(monkeypatch, 4, (0, 1))
    monkeypatch.setattr(
        torch.cuda, "get_device_properties", lambda i: SimpleNamespace(
            name="NVIDIA H100 80GB HBM3", uuid="ffffffff-0000"))
    with pytest.raises(RuntimeError, match="not in nvidia-smi's list"):
        topology.discover_host("node-a")


def test_discover_host_needs_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        topology.discover_host("node-a")
    with pytest.raises(ValueError, match="reads CUDA cards"):
        topology.discover_host("node-a", device="cpu")


def test_carve_cuts_each_domain_into_fixed_slices():
    h = host([(0, 1, 2, 3), (4, 5)])
    slices = gpu.carve(h, 2)
    assert [s.cards for s in slices] == [
        ("GPU-h0-0", "GPU-h0-1"), ("GPU-h0-2", "GPU-h0-3"),
        ("GPU-h0-4", "GPU-h0-5")]
    assert {(s.accelerator_type, s.num_hosts, s.chips_per_host, s.pod_id,
             s.host) for s in slices} == {("h100-2", 1, 2, "h0", "h0")}
    assert len({s.name for s in slices}) == 3
    assert [len(s.cards) for s in gpu.carve(h, 1)] == [1] * 6


@pytest.mark.parametrize("domains,n,match", [
    ([(0, 1, 2, 3), (4, 5)], 4, "not a multiple of 4"),
    ([(0, 1, 2)], 2, "not a multiple of 2"),
    ([(0, 1), (2, 3)], 4, "not a multiple of 4"),
    ([(0, 1)], 0, "want >= 1")], ids=["mixed", "odd", "pairs", "zero"])
def test_carve_refuses(domains, n, match):
    with pytest.raises(ValueError, match=match):
        gpu.carve(host(domains), n)


def two_host_pods(name, accel="h100-2", slices=1):
    """The controller's pods of a job of ``slices`` slices of two hosts
    each (``numHosts: 2``), which the TFJob API accepts."""
    job = manifest(name, module("x"), accel=accel,
                   chips=gpu.slice_cards(accel), slices=slices)
    spec = job.spec.tf_replica_specs[0]
    spec.tpu.num_hosts, spec.replicas = 2, 2 * slices
    assert api_tfjob.validate_tfjob(job) is None
    return named([materialize.make_pod(job, spec, i)
                  for i in range(2 * slices)])


def named(pods):
    """The pods with the names the cluster gives ``generate_name``."""
    for i, p in enumerate(pods):
        p.metadata.name = f"{p.metadata.generate_name}{i}"
    return pods


def test_a_slice_is_one_host(caplog):
    """A ``GPUSlice`` of two hosts raises; a gang of two pods a slice is
    held, as the reference holds a gang that no slice fits: ``offer``
    False, ``bind_gang`` and ``grow_gang`` None, its reason logged once."""
    with pytest.raises(ValueError, match="one host"):
        gpu.GPUSlice("s", "h100-8", num_hosts=2, cards=("a",) * 8)
    inv = gpu.GPUInventory(gpu.carve(host([(0, 1, 2, 3)]), 4))
    a, b = two_host_pods("wide", "h100-4")
    with caplog.at_level("WARNING", "kubeflow_controller_tpu_torch"):
        assert not inv.offer(a) and not inv.offer(b) and not inv.offer(a)
        assert inv.bind_gang("wide-", "h100-4", 1, size=2) is None
        assert inv.bind_gang("wide-", "h100-4", 1, pods={
            _key(p): p for p in (a, b)}) is None
        assert inv.grow_gang("wide-", "h100-4", 1) is None
    assert [r.getMessage() for r in caplog.records] == [
        "gang 'wide-' held: 2 pods on 1 slices needs slices of several "
        "hosts; a card slice is one host's NVLink domain"]
    assert cards_of_pod(a) is None and cards_of_pod(b) is None
    assert inv.free_slice_count() == 1 and inv.version == 0
    assert inv.gang_slices("wide-") == [] and inv.placement_of("wide-") is None
    # Held, not broken: the host still admits a gang that fits.
    [c] = cs.gang_pods("fits", 1, "h100-4")
    assert inv.offer(c) and cards_of_pod(c) == ",".join(
        f"GPU-h0-{i}" for i in range(4))
    assert inv.release_idle_gangs([]) == [] and \
        sorted(inv.release_idle_gangs([])) == ["fits-", "wide-"]


def _key(pod):
    return f"{pod.metadata.namespace}/{pod.metadata.name}"


def test_the_gang_scheduler_passes_a_held_two_host_gang():
    """Behind the reference's ``GangScheduler``, a two-host gang queued
    ahead of a gang that fits is held, and the one that fits is admitted
    past it with its cards; the pass goes on working on later offers."""
    inv = gpu.GPUInventory(gpu.carve(host([(0, 1, 2, 3)]), 2))
    sched = GangScheduler(inv, SchedulerPolicy())
    wide = two_host_pods("wide")
    assert [sched.offer(p) for p in wide] == [False, False]
    [fits] = make_pods("fits", 1)
    assert sched.offer(fits)
    assert inv.gang_slices("fits-") == ["h0/h100-2/0"]
    assert cards_of_pod(fits) == "GPU-h0-0,GPU-h0-1"
    assert [sched.offer(p) for p in wide] == [False, False]
    [after] = make_pods("after", 1)
    assert sched.offer(after) and cards_of_pod(after) == "GPU-h0-2,GPU-h0-3"
    assert all(cards_of_pod(p) is None for p in wide)
    assert inv.free_slice_count("h100-2") == 0
    assert inv.gang_slices("wide-") == []


def make_pods(name, slices, accel="h100-2"):
    """The controller's pods of a job of ``slices`` one-host slices."""
    job = manifest(name, module("x"), accel=accel,
                   chips=gpu.slice_cards(accel), slices=slices)
    spec = job.spec.tf_replica_specs[0]
    return named([materialize.make_pod(job, spec, i) for i in range(slices)])


# ---------------------------------------------------------------------------
# The differential test
# ---------------------------------------------------------------------------

class Scenario:
    """The same slices on both sides and the stand-in pods of each gang,
    one object a side per pod."""

    def __init__(self, seed, mix):
        self.rng = np.random.default_rng(seed)
        tpu_slices, gpu_slices = [], []
        for h in range(4):
            for pos in range(int(self.rng.integers(2, 5))):
                accel = ("h100-2", "h100-4")[int(self.rng.integers(2))]
                n = int(accel.split("-")[1])
                dom = f"host-{h}" if self.rng.random() < 0.85 else ""
                name = f"s{len(tpu_slices)}"
                tpu_slices.append(TPUSlice(name, accel, num_hosts=1,
                                           chips_per_host=n, pod_id=dom,
                                           pod_pos=pos))
                gpu_slices.append(gpu.GPUSlice(
                    name, accel, pod_id=dom, pod_pos=pos, host=dom or name,
                    cards=tuple(f"GPU-{name}-{c}" for c in range(n))))
        self.ref = TPUInventory(tpu_slices)
        self.gpu = gpu.GPUInventory(gpu_slices)
        self.gangs = {}
        for g in range(6):
            self.gangs[f"g{g}-"] = {
                "accel": ("h100-2", "h100-4")[int(self.rng.integers(2))],
                "width": int(self.rng.integers(1, 4)), "gen": 0,
                "hosts": 2 if mix == "wide" and g >= 4 else 1}
        self.pods = {}      # key -> (reference pod, port pod)
        for name in self.gangs:
            self.regenerate(name)

    def regenerate(self, gang):
        """A new generation of the gang's pods at its current width: one
        pod a slice, or for a gang of two hosts a slice two, whose
        reference pods ask for a two-host slice (``ref_accel``)."""
        g = self.gangs[gang]
        g["gen"] += 1
        hosts = g["hosts"]
        for i, p in enumerate(cs.gang_pods(gang[:-1], g["width"] * hosts,
                                           g["accel"])):
            ann = p.metadata.annotations
            ann[gpu.ANNOTATION_NUM_SLICES] = str(g["width"])
            ann[gpu.ANNOTATION_SLICE_INDEX] = str(i // hosts)
            ref = copy.deepcopy(p)
            ref.metadata.annotations[gpu.ANNOTATION_ACCELERATOR] = \
                self.ref_accel(gang)
            self.pods[f"default/{p.metadata.name}"] = (ref, p)

    def ref_accel(self, gang):
        """The reference's name of the gang's slice: a two-host slice
        is one that neither side holds."""
        g = self.gangs[gang]
        return g["accel"] + ("" if g["hosts"] == 1 else f"x{g['hosts']}")

    def members(self, gang):
        n = self.gangs[gang]["width"] * self.gangs[gang]["hosts"]
        return [f"default/{gang[:-1]}-tpu-{i}" for i in range(n)]


def views(inv, sc):
    return {
        "version": inv.version,
        "free": {a: inv.free_slice_count(a) for a in ("", "h100-2", "h100-4")},
        "util": inv.utilization_now(),
        "on": {s: inv.gang_on_slice(s) for s in sorted(inv.slices)},
        "gangs": {g: (inv.gang_slice(g), inv.gang_slices(g),
                      None if inv.placement_of(g) is None else
                      {k: inv.placement_of(g)[k]
                       for k in ("slices", "domains", "score")})
                  for g in sc.gangs},
        "healthy": {s: sl.healthy for s, sl in sorted(inv.slices.items())},
    }


def cards_of_pod(pod):
    return next((e.value for e in pod.spec.containers[0].env
                 if e.name == VISIBLE), None)


def check_cards(sc, admitted):
    """Every live gang's cards are its slices' and no card is two gangs';
    each admitted pod carries its slice's cards."""
    inv = sc.gpu
    owner = {}
    for gang in sc.gangs:
        for i, name in enumerate(inv.gang_slices(gang)):
            cards = inv.cards_of(gang, i)
            assert cards == list(inv.slices[name].cards)
            for c in cards:
                assert owner.setdefault(c, gang) == gang, (c, owner[c], gang)
    for key in admitted:
        pod = sc.pods[key][1]
        ann = pod.metadata.annotations
        gang = ann[gpu.ANNOTATION_GANG_NAME]
        idx = int(ann[gpu.ANNOTATION_SLICE_INDEX])
        names = inv.gang_slices(gang)
        want = ",".join(inv.slices[names[idx]].cards) if idx < len(names) \
            else ""
        assert cards_of_pod(pod) == want, (key, cards_of_pod(pod), want)
    placement = {g: inv.placement_of(g) for g in sc.gangs}
    for g, p in placement.items():
        if p is not None:
            assert p["cards"] == [list(inv.slices[s].cards)
                                  for s in p["slices"]]
            assert p["hosts"] == list(dict.fromkeys(
                inv.slices[s].host for s in p["slices"]))


def step(sc, op):
    """One operation on both sides: their return values, and the keys of
    the port's pods that it admitted."""
    rng = sc.rng
    gang = f"g{int(rng.integers(len(sc.gangs)))}-"
    g = sc.gangs[gang]
    if op == "offer":
        if rng.random() < 0.15:         # a wider or narrower generation
            g["width"] = int(rng.integers(1, 4))
            sc.regenerate(gang)
        key = sc.members(gang)[int(rng.integers(len(sc.members(gang))))]
        ref_pod, pod = sc.pods[key]
        got = sc.ref.offer(ref_pod), sc.gpu.offer(pod)
        return got, [key] if got[1] else []
    if op == "bind":
        n = int(rng.integers(1, 4))
        size = n * g["hosts"]
        keys = sc.members(gang)[:size]
        got = (sc.ref.bind_gang(gang, sc.ref_accel(gang), n, size=size, pods={
            k: sc.pods[k][0] for k in keys}),
            sc.gpu.bind_gang(gang, g["accel"], n, size=size, pods={
                k: sc.pods[k][1] for k in keys}))
        return got, keys if got[1] else []
    if op == "grow":
        n = int(rng.integers(1, 3))
        return (sc.ref.grow_gang(gang, sc.ref_accel(gang), n),
                sc.gpu.grow_gang(gang, g["accel"], n)), []
    if op == "release_slices":
        n = int(rng.integers(0, 3))
        return (sc.ref.release_slices(gang, n),
                sc.gpu.release_slices(gang, n)), []
    if op == "fail":
        names = sorted(sc.ref.slices) + ["no-such-slice"]
        name = names[int(rng.integers(len(names)))]
        return (sc.ref.fail_slice(name), sc.gpu.fail_slice(name)), []
    if op == "idle":
        keys = sorted(sc.pods)
        active = [k for k in keys if rng.random() < 0.3]
        return (sc.ref.release_idle_gangs(active),
                sc.gpu.release_idle_gangs(active)), []
    assert op == "release"
    return (sc.ref.release_gang(gang), sc.gpu.release_gang(gang)), []


def sequence(seed, mix):
    """The operations of one seeded sequence, drawn from ``OP_WEIGHTS``."""
    sc = Scenario(seed, mix)
    names = list(OP_WEIGHTS)
    weights = np.array(list(OP_WEIGHTS.values()))
    for _ in range(OPS):
        yield sc, names[int(sc.rng.choice(len(names),
                                          p=weights / weights.sum()))]


def test_the_sequences_reach_every_outcome():
    """Across the seeds, every operation both succeeds and is refused
    (``release_gang`` returns nothing)."""
    seen = set()
    for seed in SEEDS:
        for sc, op in sequence(seed, "narrow"):
            (_, out), _ = step(sc, op)
            seen.add((op, bool(out)))
    assert seen == {(op, ok) for op in OP_WEIGHTS for ok in (False, True)
                    if op != "release" or not ok}, seen


@pytest.mark.parametrize("mix", ["narrow", "wide"])
@pytest.mark.parametrize("seed", SEEDS)
def test_gpu_inventory_equals_the_reference(seed, mix):
    seen = set()
    for sc, op in sequence(seed, mix):
        before = {k: (cards_of_pod(p), p) for k, (_, p) in sc.pods.items()}
        bound_before = {g: set(sc.gpu.gang_slices(g)) for g in sc.gangs}
        (ref_out, gpu_out), admitted = step(sc, op)
        seen.add((op, bool(gpu_out)))
        assert gpu_out == ref_out, (op, gpu_out, ref_out)
        assert views(sc.gpu, sc) == views(sc.ref, sc), op
        check_cards(sc, admitted)
        if op in ("release_slices", "grow"):
            # Surviving pods keep their cards: nothing restamps them.
            for k, (cards, pod) in before.items():
                assert cards_of_pod(pod) == cards, k
        if op == "release_slices" and gpu_out:
            for name in gpu_out:
                sl = sc.gpu.slices[name]
                assert sl.bound_gang == "" and sl.healthy
        if op == "fail" and gpu_out:
            failed = [n for n, s in sc.gpu.slices.items() if not s.healthy]
            assert all(sc.gpu.gang_on_slice(n) == "" for n in failed)
        if op == "release":
            assert all(sc.gpu.slices[n].bound_gang == ""
                       for g, names in bound_before.items()
                       for n in names if not sc.gpu.gang_slices(g))
        for gang, g in sc.gangs.items():
            if g["hosts"] > 1:      # held: never bound, never given cards
                assert sc.gpu.gang_slices(gang) == []
                assert all(cards_of_pod(sc.pods[k][1]) is None
                           for k in sc.members(gang))
    # Each sequence reaches admissions and refusals alike.
    assert ("offer", True) in seen and ("offer", False) in seen


def test_a_pod_that_is_no_bound_member_gets_no_card():
    inv = gpu.GPUInventory(gpu.carve(host([(0, 1)]), 2))
    [loner] = cs.gang_pods("loner", 1, "h100-2")
    loner.metadata.annotations.pop(gpu.ANNOTATION_GANG_NAME)
    assert inv.offer(loner)                 # admitted alone, bound to none
    assert cards_of_pod(loner) == ""
    [a, b] = cs.gang_pods("pair", 2, "h100-2")
    assert not inv.offer(a)                 # the gang is not complete
    assert cards_of_pod(a) is None
    assert not inv.offer(b)                 # one slice for two
    inv.pod_started(a)
    assert cards_of_pod(a) == ""
    with pytest.raises(KeyError, match="no bound slice"):
        inv.cards_of("pair-", 0)


def test_cards_follow_the_kubelet_and_the_scheduler_paths():
    """``offer`` stamps every member when the last completes the gang,
    ``note_gang_pod`` and ``pod_started`` stamp the object they are given,
    and ``release_gang`` then ``fail_slice`` free and withhold the cards."""
    h = host([(0, 1, 2, 3)])
    inv = gpu.GPUInventory(gpu.carve(h, 2))
    a, b = cs.gang_pods("job", 2, "h100-2")
    assert not inv.offer(a) and inv.offer(b)
    assert [cards_of_pod(a), cards_of_pod(b)] == [
        "GPU-h0-0,GPU-h0-1", "GPU-h0-2,GPU-h0-3"]
    replacement = cs.gang_pods("job", 2, "h100-2")[1]
    inv.note_gang_pod("job-", replacement)
    assert cards_of_pod(replacement) == "GPU-h0-2,GPU-h0-3"
    started = cs.gang_pods("job", 2, "h100-2")[0]
    inv.pod_started(started)
    assert cards_of_pod(started) == "GPU-h0-0,GPU-h0-1"
    assert re.fullmatch(r"GPU-h0-\d,GPU-h0-\d", cards_of_pod(started))
    inv.release_gang("job-")
    assert inv.free_slice_count("h100-2") == 2
    [c] = cs.gang_pods("next", 1, "h100-2")
    assert inv.offer(c) and cards_of_pod(c) == "GPU-h0-0,GPU-h0-1"
    assert inv.fail_slice(inv.gang_slice("next-")) == ["default/next-tpu-0"]
    assert inv.free_slice_count("h100-2") == 1
    [d, e] = cs.gang_pods("late", 2, "h100-2")
    assert not inv.offer(d) and not inv.offer(e)    # one healthy slice
