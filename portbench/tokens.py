"""The benchmark's token generator: a frozen copy of the port's
``data.synthetic_tokens`` bigram chain, drawn from the run's seed.

Every token strongly prefers one fixed successor (the chain's table is
frozen), and one in ten is drawn at random, so next-token loss can fall
well below log(vocab).  The seed picks the first tokens and the noise; the
same seed gives the same batches, and both the program and the reference
are handed them.
"""

from __future__ import annotations

import hashlib

import numpy as np

_CHAIN_SEED = 20180214 + 1   # the successor table, fixed forever
FLIP = 0.1


def seed_words(seed: int, *salt: object) -> int:
    """A non-negative 63-bit integer from any whole ``seed`` (negative or
    past 64 bits too) and a salt."""
    text = ":".join(str(x) for x in (seed, *salt)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def bigram_batches(seed: int, vocab: int, batch: int, seq_len: int,
                   n_batches: int) -> np.ndarray:
    """[n_batches, batch, seq_len] int32: ``n_batches * batch`` rows of the
    chain, each row its own draw."""
    succ = np.random.default_rng(_CHAIN_SEED).integers(0, vocab, size=vocab)
    rng = np.random.default_rng(seed_words(seed, "tokens"))
    rows = n_batches * batch
    out = np.empty((rows, seq_len), dtype=np.int32)
    out[:, 0] = rng.integers(0, vocab, size=rows)
    flips = rng.random((rows, seq_len)) < FLIP
    noise = rng.integers(0, vocab, size=(rows, seq_len))
    for t in range(1, seq_len):
        out[:, t] = np.where(flips[:, t], noise[:, t], succ[out[:, t - 1]])
    return out.reshape(n_batches, batch, seq_len)
