"""A host's cards and the NVLink domains that join them.

The reference's slice is an abstract name (``cluster/tpu.py``): on GKE the
TPU device plugin hands each pod of a bound slice that slice's chips.  The
port runs on real cards, so its slice is a fixed set of named cards inside
one NVLink domain of one host (``cluster/gpu.py``), and this module says
which cards a host has and how they are joined:

- :func:`parse_topo` reads the card matrix ``nvidia-smi topo -p2p n``
  prints (``OK`` where two cards can reach each other over NVLink): cards
  so joined, directly or through other cards, form one domain; a card
  with no NVLink is a domain of its own.
- :func:`discover_host` builds a :class:`GPUHost` of the cards this process
  sees (``$CUDA_VISIBLE_DEVICES``), matched by UUID against the physical
  cards ``nvidia-smi`` lists, with the domains of ``topo -p2p n``
  restricted to them.  It raises without CUDA and never guesses a
  topology.  (``topo -m`` needs each pair's PCIe common ancestor, which a
  host whose GPU stack runs in a user-space kernel may not give: there
  it prints no matrix, while ``topo -p2p n`` does.)

A card is named by its UUID (``GPU-...``), which ``$CUDA_VISIBLE_DEVICES``
accepts: a child's ``$CUDA_VISIBLE_DEVICES`` counts the physical cards, so
a local index would land on another card.
"""

from __future__ import annotations

import re
import subprocess
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device

ENV_VISIBLE_DEVICES = "CUDA_VISIBLE_DEVICES"
NVIDIA_SMI_TIMEOUT_S = 60
_ANSI = re.compile(r"\x1b\[[0-9;]*m")
_GPU_COLUMN = re.compile(r"^GPU(\d+)$")
# A card's family is the first word of its name of letters then digits:
# "NVIDIA H100 80GB HBM3" is an "h100".
_FAMILY = re.compile(r"^[A-Za-z]+\d+[A-Za-z]*$")


@dataclass(frozen=True)
class GPUCard:
    index: int          # nvidia-smi's index of the physical card
    uuid: str           # "GPU-...": what $CUDA_VISIBLE_DEVICES is given
    pci_bus_id: str     # CUDA's "domain:bus:device", as card_id prints it


@dataclass(frozen=True)
class GPUHost:
    name: str
    family: str                                     # "h100"
    cards: Tuple[GPUCard, ...]
    nvlink_domains: Tuple[Tuple[int, ...], ...]     # card indices

    def card(self, index: int) -> GPUCard:
        for c in self.cards:
            if c.index == index:
                return c
        raise KeyError(f"host {self.name!r} has no card {index}")


def card_family(name: str) -> str:
    """``"h100"`` from ``"NVIDIA H100 80GB HBM3"``."""
    for word in re.split(r"[\s-]+", name):
        if word.upper() not in ("NVIDIA", "TESLA") and _FAMILY.match(word):
            return word.lower()
    raise ValueError(f"no card family in the card name {name!r}")


def parse_topo(text: str) -> Tuple[Tuple[int, ...], ...]:
    """The NVLink domains of the card matrix ``nvidia-smi topo -p2p n``
    printed: each a tuple of card indices (ascending), ordered by their
    first card.  Raises on text with no card matrix."""
    header: Optional[List[str]] = None
    links: Dict[int, List[str]] = {}
    for line in text.splitlines():
        words = _ANSI.sub("", line).split()
        m = _GPU_COLUMN.match(words[0]) if words else None
        if header is None:
            header = words if m else None
        elif m:
            links[int(m.group(1))] = words[1:1 + len(header)]
        elif links:
            break           # the legend follows the matrix
    if not header or not links:
        raise ValueError("no GPU matrix in the nvidia-smi topo text")
    gpus = [int(m.group(1)) if m else -1
            for m in map(_GPU_COLUMN.match, header)]
    if sorted(links) != sorted(gpus):
        raise ValueError(f"topo matrix rows {sorted(links)} are not its "
                         f"columns {sorted(gpus)}")
    parent = {g: g for g in gpus}

    def root(g: int) -> int:
        while parent[g] != g:
            parent[g] = parent[parent[g]]
            g = parent[g]
        return g

    for g, row in links.items():
        for col, cell in zip(gpus, row):
            if cell == "OK":
                a, b = root(g), root(col)
                parent[max(a, b)] = min(a, b)
    domains: Dict[int, List[int]] = {}
    for g in sorted(gpus):
        domains.setdefault(root(g), []).append(g)
    return tuple(tuple(d) for d in sorted(domains.values()))


def restrict(domains: Sequence[Sequence[int]],
             indices: Sequence[int]) -> Tuple[Tuple[int, ...], ...]:
    """``domains`` cut to the cards in ``indices``; empty ones dropped."""
    keep = set(indices)
    return tuple(t for t in (tuple(i for i in d if i in keep)
                             for d in domains) if t)


def _smi(*args: str) -> str:
    return subprocess.run(["nvidia-smi", *args], capture_output=True,
                          text=True, timeout=NVIDIA_SMI_TIMEOUT_S,
                          check=True).stdout


def _uuid(raw) -> str:
    """``GPU-<hex>`` from nvidia-smi's ``GPU-...`` or torch's bare UUID."""
    s = str(raw).strip()
    return "GPU-" + (s[4:] if s.upper().startswith("GPU-") else s).lower()


def discover_host(name: str, device: DeviceLike = "cuda") -> GPUHost:
    """The cards this process sees, their family and their NVLink domains:
    each visible card's UUID and PCI address from
    ``torch.cuda.get_device_properties``, its index on the host from
    ``nvidia-smi``'s list (matched by UUID), and the domains from
    ``nvidia-smi topo -p2p n`` (one visible card is a domain of its own).
    Raises without CUDA, when a visible card is not in ``nvidia-smi``'s
    list, and when the cards are of two families."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"discover_host reads CUDA cards, not {str(dev)!r}")
    smi = {}
    for line in _smi("--query-gpu=index,uuid,name",
                     "--format=csv,noheader").splitlines():
        if line.strip():
            index, uuid, card_name = (x.strip() for x in line.split(",", 2))
            smi[_uuid(uuid)] = (int(index), card_name)
    cards, families = [], set()
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        uuid = _uuid(getattr(props, "uuid", ""))
        if uuid not in smi:
            raise RuntimeError(f"visible card {i} ({props.name}, {uuid}) "
                               f"is not in nvidia-smi's list")
        index, card_name = smi[uuid]
        pci = ":".join(f"{getattr(props, k, 0):02x}" for k in (
            "pci_domain_id", "pci_bus_id", "pci_device_id"))
        cards.append(GPUCard(index, uuid, pci))
        families.add(card_family(card_name))
    if not cards:
        raise RuntimeError("no visible CUDA card")
    if len(families) != 1:
        raise RuntimeError(f"cards of several families: {sorted(families)}")
    indices = [c.index for c in cards]
    domains = ((indices[0],),) if len(cards) == 1 else restrict(
        parse_topo(_smi("topo", "-p2p", "n")), indices)
    return GPUHost(name, families.pop(), tuple(cards), domains)
