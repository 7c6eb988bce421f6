"""Deterministic synthetic token streams — the port's copy of
``synthetic_tokens`` from ``kubeflow_controller_tpu/workloads/data.py``.

The generator is host-side numpy in both packages, with the same frozen
teacher seed and the same draws, so one seed gives byte-identical tokens
in either; only the container differs (a torch tensor on the caller's
device here).  Seeds are ints: the reference also accepts a JAX PRNG key,
which collapses to its counter word (``PRNGKey(1)`` is seed 1).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

_TEACHER_SEED = 20180214  # the reference's value, fixed forever


def _as_seed(seed) -> int:
    """The int path of the reference's ``utils/rand.py:as_seed``."""
    if isinstance(seed, (int, np.integer)):
        return int(seed)
    raise TypeError(f"seed must be an int, got {type(seed).__name__}")


def synthetic_tokens(seed: int, n_seqs: int, seq_len: int, vocab: int,
                     device: DeviceLike = "cuda") -> torch.Tensor:
    """[n_seqs, seq_len] int32 on ``device`` from a frozen first-order
    bigram chain — enough structure that next-token loss drops well below
    log(vocab)."""
    dev = resolve_device(device)
    chain = np.random.default_rng(_TEACHER_SEED + 1)
    # Each token strongly prefers a fixed successor.
    succ = chain.integers(0, vocab, size=vocab)
    rng = np.random.default_rng(_as_seed(seed))
    out = np.empty((n_seqs, seq_len), dtype=np.int32)
    out[:, 0] = rng.integers(0, vocab, size=n_seqs)
    flips = rng.random((n_seqs, seq_len)) < 0.1
    noise = rng.integers(0, vocab, size=(n_seqs, seq_len))
    for t in range(1, seq_len):
        out[:, t] = np.where(flips[:, t], noise[:, t], succ[out[:, t - 1]])
    return torch.from_numpy(out).to(dev)
