"""The comparison that decides ``correct`` for a training cell.

The program's first steps and the reference's are compared on four
numbers, each a gap relative to the reference:

- ``loss``: the largest ``|L - L_ref| / |L_ref|`` over the checked steps;
- ``grad``: the worst leaf's ``|‖g‖ - ‖g_ref‖|`` for the gradient as the
  optimizer got it at step 1 (after the clip), over the reference's norm
  of that leaf or of the median leaf, whichever is larger;
- ``embed_rows``: the median, over the embedding rows that the first
  batch's tokens read, of the gap of the row's norm in that gradient,
  ``|‖g_row‖ - ‖g_ref,row‖| / ‖g_ref,row‖`` (rows under a thousandth of the
  median row's reference norm, such as a token seen only in the last
  position, left out).  Every token's backward reaches its row, so the
  rows see the whole stack's rounding, while a token that near-tied
  router logits send to another expert moves only its own rows, which
  the median leaves out;
- ``change``: the same as ``grad`` for each leaf's change ``‖p - p₀‖``
  after the checked steps.  Leaves whose step-1 gradient in the reference
  is under a thousandth of the median leaf's move by round-off alone and
  are left out.

A reading that is not a finite number fails.  Each number has its limit in
``limits/<workload>.json``, set from ``calibrate.py``'s readings on the
chip: the lower reading is the largest of the program's sound runs, the
upper the least of the controls' (the configuration's ``control`` lists
one for each precision it states; each counts where it reads three times
the lower or more) and the planted faults' (ten times; a state left
unchanged reads 1 on ``change``), and the limit is lower^0.3 x upper^0.7
to two digits.  A
null limit is a number with no upper reading, which the cell does not
compare (its readings are in PERF.md).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional

import torch

NUMBERS = ("loss", "grad", "embed_rows", "change")
QUIET_GRAD = 1e-3


def embed_ids(tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows that ``tokens`` read, each once, in order."""
    return torch.unique(tokens.long())


def _leaf_gaps(mine: Dict[str, float], ref: Dict[str, float],
               leaves: Iterable[str]) -> Dict[str, float]:
    leaves = list(leaves)
    floor = statistics.median(ref[k] for k in leaves)
    return {k: abs(mine[k] - ref[k]) / max(ref[k], floor) for k in leaves}


def gaps(mine: dict, ref: dict) -> dict:
    """Every gap behind :func:`readings`: the loss's by step, the first
    gradient's and the change's by leaf."""
    if len(mine["losses"]) != len(ref["losses"]):
        raise ValueError("the program and the reference checked different "
                         "numbers of steps")
    grads = ref["grad_norms"]
    floor = statistics.median(grads.values())
    moving = [k for k, v in grads.items() if v >= QUIET_GRAD * floor]
    rows = ref["embed_rows"]
    row_floor = QUIET_GRAD * statistics.median(rows)
    return {"loss": [abs(a - b) / abs(b) for a, b in zip(mine["losses"],
                                                         ref["losses"])],
            "grad": _leaf_gaps(mine["grad_norms"], grads, grads),
            "embed_rows": [abs(a - b) / b for a, b in
                           zip(mine["embed_rows"], rows) if b >= row_floor],
            "change": _leaf_gaps(mine["change_norms"], ref["change_norms"],
                                 moving)}


def _worst(xs: Iterable[float]) -> float:
    xs = list(xs)
    return max(xs) if all(map(math.isfinite, xs)) else math.inf


def readings(mine: dict, ref: dict) -> Dict[str, float]:
    """The gaps of the program's numbers ``mine`` against the reference's
    ``ref`` (each ``{"losses", "grad_norms", "embed_rows",
    "change_norms"}``)."""
    g = gaps(mine, ref)
    rows = g["embed_rows"]
    return {"loss": _worst(g["loss"]), "grad": _worst(g["grad"].values()),
            "embed_rows": (statistics.median(rows)
                           if all(map(math.isfinite, rows)) else math.inf),
            "change": _worst(g["change"].values())}


def verdict(read: Dict[str, float], limits: Dict[str, Optional[float]]
            ) -> bool:
    """True when every compared reading is finite and within its limit."""
    return all(math.isfinite(read[k]) and read[k] <= limits[k]
               for k in NUMBERS if limits[k] is not None)
