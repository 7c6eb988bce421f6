"""Port parity: Ulysses attention (``parallel/ulysses.py``) over gloo ranks
against the JAX package's ``ulysses_attention`` and ``attention_reference``.

Gloo ranks (``tests/_torch_mesh_worker.py``, scenario ``seqpar``) run
``ulysses_attention`` on global q/k/v [4, 32, 4, 16] f32 made with numpy
from a seed, over sp 2 (2 ranks), sp 4 (4 ranks) and sp 2 x tp 2 (4 ranks:
the heads split over tp first, ``tests/test_parallel.py``'s tp case),
causal and not, with the default inner (``flash_attention``: the kernels'
plain versions on the CPU) and the f32 reference as the inner, then the
backward with a fixed cotangent.  JAX runs its ``ulysses_attention`` under
``MeshSpec(fsdp=2, sp=4)`` and ``MeshSpec(dp=2, sp=2, tp=2)``.

- values within 2e-5 and q/k/v gradients within 5e-5 of JAX's (same sp
  extent) and of ``attention_reference``;
- one flash forward, dq and dkv call per rank with the default inner,
  none with the reference inner;
- on an sp-only mesh, the same layout moves over virtual ranks in one
  process (``ulysses_lockstep``) give the gloo ranks' values to the bit;
- heads that do not divide by sp raise the reference's ``ValueError``.
"""

import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.parallel import MeshSpec, build_mesh, ulysses_attention
from kubeflow_controller_tpu.parallel.compat import set_mesh
from kubeflow_controller_tpu.parallel.ring import attention_reference
from kubeflow_controller_tpu_torch.parallel import ulysses as tulysses

from _torch_ranks import start_ranks, wait_ranks
from test_torch_ring import GRAD_TOL, KERNELS, VALUE_TOL, close, inputs, jax_vjp


# (name, world, sp, tp, the JAX mesh of the same sp extent)
MESHES = (("sp2", 2, 2, 1, dict(fsdp=4, sp=2)),
          ("sp4", 4, 4, 1, dict(fsdp=2, sp=4)),
          ("sp2-tp2", 4, 2, 2, dict(dp=2, sp=2, tp=2)))
CAUSAL = (True, False)
INNERS = ("flash", "dense")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ulysses")
    arrays = inputs()
    src = tmp / "inputs.npz"
    np.savez(src, **arrays)
    ranks = {name: start_ranks(world, "seqpar", str(tmp / f"{name}.pt"),
                               "ulysses", str(sp), str(tp), str(src))
             for name, world, sp, tp, _ in MESHES}
    ref = {}
    for name, _, _, _, spec in MESHES:
        mesh = build_mesh(MeshSpec(**spec))
        for causal in CAUSAL:
            with set_mesh(mesh):
                ref[(name, causal)] = jax_vjp(
                    lambda q, k, v: ulysses_attention(q, k, v, mesh,
                                                      causal=causal), arrays)
    oracle = {c: jax_vjp(lambda q, k, v: attention_reference(q, k, v,
                                                             causal=c),
                         arrays) for c in CAUSAL}
    port = {}
    for name, procs in ranks.items():
        wait_ranks(procs, timeout=240)
        port[name] = torch.load(tmp / f"{name}.pt", weights_only=False)
    return {"port": port, "jax": ref, "oracle": oracle}


@pytest.mark.parametrize("mesh,causal,inner", [
    (m[0], c, i) for m in MESHES for c in CAUSAL for i in INNERS])
def test_ulysses_matches_jax_and_the_oracle(runs, mesh, causal, inner):
    got = runs["port"][mesh][(causal, inner)]
    for ref in (runs["jax"][(mesh, causal)], runs["oracle"][causal]):
        close(got["out"].numpy(), ref[0], VALUE_TOL)
        for g, want in zip(got["grads"], ref[1]):
            close(g.numpy(), want, GRAD_TOL)


@pytest.mark.parametrize("mesh,causal", [(m[0], c) for m in MESHES
                                         for c in CAUSAL])
def test_flash_inner_calls_per_rank(runs, mesh, causal):
    for inner, want in (("flash", 1), ("dense", 0)):
        for rank in runs["port"][mesh][(causal, inner)]["ranks"]:
            assert rank["calls"] == dict.fromkeys(KERNELS, want), rank


@pytest.mark.parametrize("mesh,causal", [(m[0], c) for m in MESHES[:2]
                                         for c in CAUSAL])
def test_lockstep_layout_moves_equal_the_gloo_ranks(runs, mesh, causal):
    gloo = runs["port"][mesh][(causal, "flash")]
    virtual = runs["port"][mesh][("lockstep", causal)]
    assert torch.equal(virtual["out"], gloo["out"])
    for a, b in zip(virtual["grads"], gloo["grads"]):
        assert torch.equal(a, b)


def test_heads_that_do_not_divide_raise():
    x = [torch.zeros((1, 4, 3, 16)) for _ in range(2)]
    with pytest.raises(ValueError, match="divisible by the sp"):
        tulysses.ulysses_lockstep(x, x, x)
