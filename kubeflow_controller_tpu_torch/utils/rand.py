"""Seed coercion for the host-side (numpy) initializers and data
generators — the port's copy of ``kubeflow_controller_tpu/utils/rand.py``.

The reference also accepts a JAX PRNG key, which collapses to its counter
word (``PRNGKey(1)`` is seed 1); the port takes int seeds only.
"""

from __future__ import annotations

import numpy as np


def as_seed(seed) -> int:
    """``seed`` as a Python int; raises for anything but an integer."""
    if isinstance(seed, (int, np.integer)):
        return int(seed)
    raise TypeError(f"seed must be an int, got {type(seed).__name__}")
