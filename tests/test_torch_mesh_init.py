"""The sharded init (``models/llama.py:llama_init(mesh=)``), which
``llama_pretrain.train(mesh=)`` runs: the model is built on the ``meta``
device and each parameter is drawn whole, split into this process's shard
and dropped before the next draw (the reference's ``jax.jit(llama_init,
out_shardings=...)``).

Over gloo ranks (``tests/_torch_mesh_worker.py``, scenario ``init``):

- every local shard equals ``llama_init`` followed by ``shard_llama`` from
  the same seed, bit for bit, with the same placements, dense under fsdp 2
  and MoE under (fsdp 2, ep 2) and (ep 2, tp 2);
- under fsdp 2, the bytes of the tensors that ``train(mesh=)`` makes while
  it initialises (storages counted alive until a weakref on each reports
  it freed, by a ``TorchDispatchMode``) peak at most one full parameter
  (and a few 0-dim temporaries) above what the trained model keeps (its
  shards and tokens); the whole-model init
  followed by ``shard_llama`` peaks at every full parameter above it, so
  the bound tells the two apart.
"""

import pytest
import torch

from _torch_ranks import run_ranks

torch.set_num_threads(1)

SCALAR_BYTES = 64
CASES = [((1, 2, 1, 1), 0), ((1, 2, 2, 1), 4), ((1, 1, 2, 2), 4)]


@pytest.mark.parametrize("axes,experts", CASES,
                         ids=[f"{a}-E{e}" for a, e in CASES])
def test_sharded_init_is_one_parameter_at_a_time_and_bit_identical(
        axes, experts, tmp_path):
    out = str(tmp_path / "init.pt")
    n = axes[0] * axes[1] * axes[2] * axes[3]
    run_ranks(n, "init", out, *map(str, axes), str(experts), timeout=240)
    got = torch.load(out, weights_only=False)
    assert got["same"] and all(got["same"].values()), got["same"]
    if axes == (1, 2, 1, 1):
        # one full parameter, and 0-dim temporaries (SCALAR_BYTES)
        assert got["transient"] <= got["largest_param"] + SCALAR_BYTES, got
        assert got["transient_whole"] > 2 * got["largest_param"], got
        # the whole-model init holds every full parameter at once
        assert got["transient_whole"] >= got["all_params"] // 2, got
