"""Port parity: ring attention (``parallel/ring.py``) over gloo ranks on the
``sp`` axis against the JAX package's ``ring_attention`` and
``attention_reference``.

Gloo ranks (subprocesses of ``tests/_torch_mesh_worker.py``, scenario
``seqpar``) run ``ring_attention`` over sp 2 and sp 4 on global q/k/v
[4, 32, 4, 16] f32 made with numpy from a seed, causal and not, with the
flash inner (the kernels' plain versions on the CPU) and the dense inner,
then its backward with a fixed cotangent.  JAX runs its ``ring_attention``
(flash inner, Pallas in interpret mode) under its own ``MeshSpec(fsdp=2,
sp=4)`` CPU mesh and ``attention_reference`` on the same arrays.

- values within 2e-5 and q/k/v gradients within 5e-5 (absolute and
  relative, as ``tests/test_parallel.py`` holds JAX's ring) of both;
- the flash inner's calls per rank: a causal ring's rank idx folds idx + 1
  blocks (forward, dq and dkv alike), a non-causal one n;
- the same schedules over virtual ranks in one process (``run_lockstep``)
  give the gloo ranks' outputs and gradients to the bit;
- bf16 shards of T/sp 8 or 16 with D 64, under the kernels' rule
  (``kernel_rule`` standing in for the card): the dense inner runs (no flash
  call) and agrees with the oracle within 3e-2 (``tests/test_parallel.py``'s
  unaligned-shard case).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.parallel import MeshSpec, build_mesh, ring_attention
from kubeflow_controller_tpu.parallel.compat import set_mesh
from kubeflow_controller_tpu.parallel.ring import attention_reference

from _torch_ranks import start_ranks, wait_ranks


VALUE_TOL = 2e-5
GRAD_TOL = 5e-5
BF16_TOL = 3e-2
SHAPE = (4, 32, 4, 16)
BF16_SHAPE = (2, 32, 2, 64)
WORLDS = (2, 4)
CAUSAL = (True, False)
INNERS = ("flash", "dense")
KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    arrays = {n: rng.standard_normal(SHAPE, dtype=np.float32)
              for n in ("q", "k", "v", "do")}
    for n in ("q", "k", "v", "do"):
        arrays[f"{n}_bf16"] = rng.standard_normal(BF16_SHAPE,
                                                  dtype=np.float32)
    return arrays


def jax_vjp(fn, arrays, suffix=""):
    """fn's output and its q/k/v cotangents for ``do``, as numpy."""
    q, k, v, do = (jnp.asarray(arrays[n + suffix]) for n in ("q", "k", "v",
                                                             "do"))
    out, vjp = jax.vjp(fn, q, k, v)
    return np.asarray(out), [np.asarray(g) for g in vjp(do)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    arrays = inputs()
    src = tmp / "inputs.npz"
    np.savez(src, **arrays)
    ranks = {w: start_ranks(w, "seqpar", str(tmp / f"ring{w}.pt"), "ring",
                            str(w), "1", str(src)) for w in WORLDS}
    mesh = build_mesh(MeshSpec(fsdp=2, sp=4, tp=1))
    jax_ring, oracle = {}, {}
    for causal in CAUSAL:
        with set_mesh(mesh):
            jax_ring[causal] = jax_vjp(
                lambda q, k, v: ring_attention(q, k, v, mesh, causal=causal,
                                               inner="flash"), arrays)
        oracle[causal] = jax_vjp(
            lambda q, k, v: attention_reference(q, k, v, causal=causal),
            arrays)
    bf16 = {n: jnp.asarray(arrays[f"{n}_bf16"]).astype(jnp.bfloat16)
            for n in "qkv"}
    bf16_oracle = {c: np.asarray(attention_reference(
        bf16["q"], bf16["k"], bf16["v"], causal=c), np.float32)
        for c in CAUSAL}
    port = {}
    for w, procs in ranks.items():
        wait_ranks(procs, timeout=240)
        port[w] = torch.load(tmp / f"ring{w}.pt", weights_only=False)
    return {"port": port, "jax": jax_ring, "oracle": oracle,
            "bf16_oracle": bf16_oracle}


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("world,causal,inner", [
    (w, c, i) for w in WORLDS for c in CAUSAL for i in INNERS])
def test_ring_matches_jax_and_the_oracle(runs, world, causal, inner):
    got = runs["port"][world][(causal, inner)]
    for ref in (runs["jax"][causal], runs["oracle"][causal]):
        close(got["out"].numpy(), ref[0], VALUE_TOL)
        for g, want in zip(got["grads"], ref[1]):
            close(g.numpy(), want, GRAD_TOL)


@pytest.mark.parametrize("world,causal", [(w, c) for w in WORLDS
                                          for c in CAUSAL])
def test_flash_inner_calls_per_rank(runs, world, causal):
    """Rank idx of a causal ring folds idx + 1 blocks and launches nothing
    for a hidden one; a non-causal ring folds all n."""
    for inner in INNERS:
        for rank in runs["port"][world][(causal, inner)]["ranks"]:
            idx = rank["sp_index"]
            want = 0 if inner == "dense" else (idx + 1 if causal else world)
            assert rank["calls"] == dict.fromkeys(KERNELS, want), rank


@pytest.mark.parametrize("world,causal", [(w, c) for w in WORLDS
                                          for c in CAUSAL])
def test_lockstep_transport_equals_the_gloo_ranks(runs, world, causal):
    gloo = runs["port"][world][(causal, "flash")]
    virtual = runs["port"][world][("lockstep", causal)]
    assert torch.equal(virtual["out"], gloo["out"])
    for a, b in zip(virtual["grads"], gloo["grads"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("world,causal", [(w, c) for w in WORLDS
                                          for c in CAUSAL])
def test_unaligned_shard_takes_the_dense_inner(runs, world, causal):
    got = runs["port"][world][("fallback", causal)]
    assert got["out"].dtype == torch.bfloat16
    assert all(r["calls"] == dict.fromkeys(KERNELS, 0)
               for r in got["ranks"]), got["ranks"]
    close(got["out"].float().numpy(), runs["bf16_oracle"][causal], BF16_TOL)
