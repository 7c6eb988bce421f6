"""The benchmark's weights: every parameter of a configuration in one flat
float32 buffer on the device, drawn from the run's seed.

The buffer is cut into chunks of ``CHUNK`` values; chunk ``i`` is one
``normal_`` call of a ``torch.Generator`` on the device seeded from
``(seed, i)``, so a few large calls make the weights, and any chunk's
initial values can be drawn again alone (:func:`initial_chunk`), which is
how a parameter's change is measured without keeping a copy.  Each leaf
is then scaled by the scale its architecture gives it (a norm's, 0.0, set
to one).

Leaves are named and shaped as the port's module tree names them (the
reference takes the same names), in the tree's order, as the
configuration's architecture lists them (``archs/<model_type>.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import torch

from . import archs
from .tokens import seed_words

CHUNK = 1 << 28          # values a draw (1 GiB of float32)


@dataclass(frozen=True)
class Leaf:
    name: str
    shape: Tuple[int, ...]
    offset: int
    scale: float          # 0.0: a norm's scale, set to one

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


@dataclass(frozen=True)
class Layout:
    leaves: Tuple[Leaf, ...]
    total: int

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Each leaf as a view of ``flat``."""
        return {lf.name: flat[lf.offset:lf.offset + lf.numel].view(lf.shape)
                for lf in self.leaves}

    def chunks(self) -> int:
        return -(-self.total // CHUNK)


def layout(conf: dict) -> Layout:
    """The leaves of ``conf`` as its architecture lists them
    (``archs/<model_type>.py``'s ``leaves``), laid end to end."""
    leaves, off = [], 0
    for name, shape, scale in archs.of(conf).leaves(conf):
        leaves.append(Leaf(name, tuple(shape), off, scale))
        off += math.prod(shape)
    if "embed" not in {lf.name for lf in leaves}:
        raise ValueError(f"{conf['model_type']}: no leaf 'embed' among the "
                         "leaves (the check reads its rows)")
    return Layout(tuple(leaves), off)


def _spans(lay: Layout, lo: int, hi: int) -> Iterator[Tuple[Leaf, int, int]]:
    """(leaf, start, end) of each leaf's part of the flat range [lo, hi)."""
    for lf in lay.leaves:
        a, b = max(lo, lf.offset), min(hi, lf.offset + lf.numel)
        if a < b:
            yield lf, a, b


def _init_(lay: Layout, buf: torch.Tensor, lo: int, seed: int, i: int
           ) -> None:
    """Draw chunk ``i`` into ``buf`` (the flat range starting at ``lo``)
    and scale it leaf by leaf."""
    gen = torch.Generator(device=buf.device)
    gen.manual_seed(seed_words(seed, "weights", i))
    buf.normal_(generator=gen)
    for lf, a, b in _spans(lay, lo, lo + buf.numel()):
        part = buf[a - lo:b - lo]
        if lf.scale:
            part.mul_(lf.scale)
        else:
            part.fill_(1.0)


def make_flat(lay: Layout, seed: int, device) -> torch.Tensor:
    """Every parameter's initial value, [total] float32 on ``device``."""
    flat = torch.empty(lay.total, dtype=torch.float32, device=device)
    for i in range(lay.chunks()):
        lo = i * CHUNK
        _init_(lay, flat[lo:lo + CHUNK], lo, seed, i)
    return flat


def initial_chunk(lay: Layout, seed: int, i: int, device) -> torch.Tensor:
    """Chunk ``i`` of :func:`make_flat`'s buffer, drawn again alone."""
    lo = i * CHUNK
    buf = torch.empty(min(CHUNK, lay.total - lo), dtype=torch.float32,
                      device=device)
    _init_(lay, buf, lo, seed, i)
    return buf


@torch.no_grad()
def change_norms(lay: Layout, seed: int, leaves: Dict[str, torch.Tensor]
                 ) -> Dict[str, float]:
    """Each leaf's distance from its initial value, ``‖p - p₀‖₂``, where
    ``leaves`` holds the current values by name (any layout in memory);
    the initial values are drawn again a chunk at a time."""
    sq = {lf.name: torch.zeros((), dtype=torch.float64,
                               device=leaves[lf.name].device)
          for lf in lay.leaves}
    for i in range(lay.chunks()):
        lo = i * CHUNK
        first = None
        for lf, a, b in _spans(lay, lo, min(lo + CHUNK, lay.total)):
            if first is None:
                first = initial_chunk(lay, seed, i, leaves[lf.name].device)
            now = leaves[lf.name].reshape(-1)[a - lf.offset:b - lf.offset]
            diff = now.float() - first[a - lo:b - lo]
            sq[lf.name] += torch.linalg.vector_norm(diff).double() ** 2
        del first
    return {k: math.sqrt(float(v)) for k, v in sq.items()}
