"""Port parity: the dense pretrain step under a dp x fsdp x tp mesh
(DTensor parameters and activations, ``models/llama.py``'s mesh path,
``workloads/trainer.py``'s clip over sharded gradients) against the JAX
single-device step.

Gloo ranks (subprocesses of ``tests/_torch_mesh_worker.py``) take one
``llama_loss`` + backward + ``default_optimizer`` (clip 1.0, AdamW, weight
decay 0.1) step of ``LlamaConfig.tiny`` (f32; 4 heads, 2 kv heads, vocab
256, batch 4 x T 64; attention "flash": the kernels' plain versions per
shard) from JAX's init, under (dp, fsdp, tp) = (1, 2, 1), (1, 1, 2) with
remat "dots" and (2, 2, 2) with remat "gateup_attn" (the dp x fsdp x tp of
``dryrun_multichip``'s config A, without its sp axis).  The loss within
1e-5 relative, every gathered full gradient and every parameter after the
step within 1e-4 of its max of JAX's ``value_and_grad`` + optax step; the
global gradient norm the clip read within 1e-5 relative of optax's, every
gradient placed as its parameter (a norm's replicated scale too, whose
per-shard sum would otherwise stay ``Partial`` and step each process's
AdamW on its own part), and
every gradient after the clip (the norm is 1.7) within 1e-4 of JAX's
divided by it.

Per shard: the flash forward ran on each process's batch and heads only
(``local_map``), and under fsdp every all-gather moved a parameter's
shard: fsdp gathers weights, never activations.
"""

import pickle

import jax
import numpy as np
import optax
import pytest
import torch

from kubeflow_controller_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from kubeflow_controller_tpu.models.llama import llama_init as jax_llama_init
from kubeflow_controller_tpu.models.llama import llama_loss as jax_llama_loss
from kubeflow_controller_tpu.workloads import data as jax_data
from kubeflow_controller_tpu.workloads.trainer import default_optimizer as jax_default_optimizer
from kubeflow_controller_tpu_torch import bridge

from _torch_ranks import start_ranks, wait_ranks

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
BATCH, SEQ = 4, 64

MESHES = [((1, 2, 1), "none"), ((1, 1, 2), "dots"),
          ((2, 2, 2), "gateup_attn")]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_config(policy):
    return JaxLlamaConfig.tiny(attention="flash", max_seq_len=SEQ,
                               remat=policy != "none",
                               remat_policy="full" if policy == "none"
                               else policy)


def jax_reference(jcfg, params, tokens):
    """JAX's loss, gradients, parameters after one optax step and the
    global norm the clip reads."""
    loss, grads = jax.value_and_grad(
        lambda p: jax_llama_loss(p, tokens, jcfg))(params)
    opt = jax_default_optimizer(3e-4, weight_decay=0.1)
    updates, _ = opt.update(grads, opt.init(params), params)
    after = optax.apply_updates(params, updates)
    return (float(loss), np_tree(grads), np_tree(after),
            float(optax.global_norm(grads)))


def port_names(tree):
    """(port parameter name, array) for a JAX parameter tree."""
    out = {k: tree[k] for k in ("embed", "final_norm", "lm_head")}
    for key, stacked in tree["layers"].items():
        for i, a in enumerate(stacked):
            out[f"layers.{i}.{key}"] = a
    return out


@pytest.mark.parametrize("axes,policy", MESHES,
                         ids=[f"{a}-{p}" for a, p in MESHES])
def test_mesh_step_matches_the_jax_single_device_step(axes, policy,
                                                      tmp_path):
    jcfg = jax_config(policy)
    params = jax_llama_init(jax.random.PRNGKey(0), jcfg)
    tokens = jax_data.synthetic_tokens(3, BATCH, SEQ, jcfg.vocab_size)
    src = tmp_path / "params.pkl"
    with open(src, "wb") as fh:
        pickle.dump((np_tree(params), np.asarray(tokens)), fh)
    out = str(tmp_path / "step.pt")
    dp, fsdp, tp = axes
    ranks = start_ranks(dp * fsdp * tp, "step", out, *map(str, axes),
                        policy, str(src))
    loss, grads, after, norm = jax_reference(jcfg, params, tokens)
    wait_ranks(ranks, timeout=240)
    got = torch.load(out, weights_only=False)

    assert abs(got["loss"] - loss) <= LOSS_RTOL * abs(loss)
    # every gradient placed as its parameter (the norms' scales too), so
    # that every process's AdamW steps on the whole gradient
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
    local = (BATCH // (dp * fsdp), SEQ, cfg.n_heads // tp, cfg.head_dim)
    assert got["flash_shapes"] and set(got["flash_shapes"]) == {local}
    if tp == 1:
        assert got["gathered"], "fsdp gathered nothing"
        assert set(got["gathered"]) <= got["shards"], (
            set(got["gathered"]) - got["shards"])
