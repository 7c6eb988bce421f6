"""The seeded inputs: token batches and weights."""

import numpy as np
import pytest
import torch

from portbench import tokens, weights

from ._tiny import TINY

CONF = dict(TINY, model_type="mistral", num_hidden_layers=2)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 40, -3])
def test_tokens_repeat_from_the_seed(seed):
    a = tokens.bigram_batches(seed, 256, 2, 64, 3)
    b = tokens.bigram_batches(seed, 256, 2, 64, 3)
    assert a.shape == (3, 2, 64) and a.dtype == np.int32
    assert (a == b).all()
    assert not (a == tokens.bigram_batches(seed + 1, 256, 2, 64, 3)).all()
    assert a.min() >= 0 and a.max() < 256


def test_tokens_follow_the_chain():
    a = tokens.bigram_batches(1, 1000, 4, 512, 2).reshape(-1, 512)
    succ = np.random.default_rng(tokens._CHAIN_SEED).integers(0, 1000, 1000)
    follow = (a[:, 1:] == succ[a[:, :-1]]).mean()
    assert 0.88 < follow < 0.93           # one in ten drawn at random


def test_rows_all_differ():
    a = tokens.bigram_batches(5, 32000, 2, 128, 4).reshape(-1, 128)
    assert len({r.tobytes() for r in a}) == len(a)


def test_weights_repeat_and_scale(monkeypatch):
    monkeypatch.setattr(weights, "CHUNK", 1000)   # many chunks
    lay = weights.layout(CONF)
    flat = weights.make_flat(lay, 11, "cpu")
    assert torch.equal(flat, weights.make_flat(lay, 11, "cpu"))
    assert not torch.equal(flat, weights.make_flat(lay, 12, "cpu"))
    views = lay.views(flat)
    assert torch.equal(views["layers.1.mlp_norm"], torch.ones(64))
    assert views["embed"].std().item() == pytest.approx(0.02, rel=0.05)
    assert views["layers.0.wo"].std().item() == pytest.approx(
        0.02 / 2, rel=0.1)
    for i in range(lay.chunks()):
        chunk = weights.initial_chunk(lay, 11, i, "cpu")
        assert torch.equal(chunk, flat[i * 1000:(i + 1) * 1000])
    assert all(v == 0 for v in
               weights.change_norms(lay, 11, views).values())
    views["lm_head"][0, :4] += torch.tensor([3.0, 0, 0, 4.0])
    moved = weights.change_norms(lay, 11, views)
    assert moved["lm_head"] == pytest.approx(5.0)
    assert sum(v > 0 for v in moved.values()) == 1
