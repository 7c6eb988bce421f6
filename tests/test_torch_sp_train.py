"""Port parity: the dense pretrain step under sequence parallelism (an
``sp`` mesh axis: ring or Ulysses attention per shard, RoPE at each shard's
offset, the shifted targets staged with the tokens; ``models/llama.py``)
against the JAX single-device step.

Gloo ranks (``tests/_torch_mesh_worker.py``, scenario ``step``) take one
``llama_loss`` + backward + ``default_optimizer`` step of
``LlamaConfig.tiny`` (f32; 4 heads, 2 kv heads, batch 4 x T 64; attention
"flash": the kernels' plain versions per shard) from JAX's init, under
(sp 2) ring with remat "full" (the ring re-runs in the backward, with its
rotations), (sp 2) Ulysses with no remat, and (fsdp 2, sp 2) ring with
remat "dots" and the chunked CE (4 chunks within each shard) over 4
ranks.  The limits of ``tests/test_torch_mesh_train.py``:
the loss within 1e-5 relative, every gathered gradient, every gradient
after the clip and every parameter after the step within 1e-4 of its max
of JAX's, the clip's global norm within 1e-5 relative, and every gradient
placed as its parameter (none left ``Partial`` over sp).  The flash
forward ran on each shard's T/sp rows (ring) or on the whole T for H/sp
heads (Ulysses).
"""

import dataclasses
import pickle

import jax
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.models.llama import llama_init as jax_llama_init
from kubeflow_controller_tpu.workloads import data as jax_data
from kubeflow_controller_tpu_torch import bridge

from _torch_ranks import start_ranks, wait_ranks
from test_torch_mesh_train import (
    BATCH,
    GRAD_RTOL,
    LOSS_RTOL,
    SEQ,
    jax_config,
    jax_reference,
    np_tree,
    port_names,
)


# (id, (dp, fsdp, tp), sp, sp_attention, remat policy, loss chunks)
RUNS = (("sp2-ring", (1, 1, 1), 2, "ring", "full", 0),
        ("sp2-ulysses", (1, 1, 1), 2, "ulysses", "none", 0),
        ("fsdp2-sp2-ring", (1, 2, 1), 2, "ring", "dots", 4))


@pytest.mark.parametrize("axes,sp,attention,policy,chunks",
                         [r[1:] for r in RUNS], ids=[r[0] for r in RUNS])
def test_sp_step_matches_the_jax_single_device_step(axes, sp, attention,
                                                    policy, chunks,
                                                    tmp_path):
    jcfg = dataclasses.replace(jax_config(policy), loss_chunks=chunks)
    params = jax_llama_init(jax.random.PRNGKey(0), jcfg)
    tokens = jax_data.synthetic_tokens(3, BATCH, SEQ, jcfg.vocab_size)
    src = tmp_path / "params.pkl"
    with open(src, "wb") as fh:
        pickle.dump((np_tree(params), np.asarray(tokens)), fh)
    out = str(tmp_path / "step.pt")
    dp, fsdp, tp = axes
    ranks = start_ranks(dp * fsdp * tp * sp, "step", out, *map(str, axes),
                        policy, str(src), str(sp), attention, str(chunks))
    loss, grads, after, norm = jax_reference(jcfg, params, tokens)
    wait_ranks(ranks, timeout=240)
    got = torch.load(out, weights_only=False)

    assert abs(got["loss"] - loss) <= LOSS_RTOL * abs(loss)
    assert not got["grads_misplaced"], got["grads_misplaced"]
    assert abs(got["norm"] - norm) <= LOSS_RTOL * norm
    assert norm > 1.0      # the clip scales every shard by 1 / norm
    clipped = jax.tree.map(lambda g: g / norm, grads)
    for kind, want in (("grads", grads), ("clipped", clipped),
                       ("params", after)):
        want = port_names(want)
        assert got[kind].keys() == want.keys()
        for name, ref in want.items():
            err = np.max(np.abs(got[kind][name] - ref))
            assert err <= GRAD_RTOL * np.max(np.abs(ref)), (kind, name, err)

    cfg = bridge.LlamaConfig.tiny()
    b = BATCH // (dp * fsdp)
    local = ((b, SEQ // sp, cfg.n_heads, cfg.head_dim) if attention == "ring"
             else (b, SEQ, cfg.n_heads // sp, cfg.head_dim))
    assert got["flash_shapes"] and set(got["flash_shapes"]) == {local}

