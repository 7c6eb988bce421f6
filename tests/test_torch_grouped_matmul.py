"""Port parity: ``kubeflow_controller_tpu_torch.ops.grouped_matmul`` against
the JAX package's grouped-matmul Pallas kernels.

Off-TPU the JAX kernels run under ``interpret=True``, so each case below
reaches the same Pallas kernel the serving path reaches at full width:
``_gmm_single_k_kernel`` when K fits one block (decode's down-projection),
``_gmm_kernel`` with its K loop when ``_single_k_blocks`` returns None
(prefill's down-projection), and ``_gmm2_kernel`` for the fused SwiGLU.
On the CPU the port's wrappers take their plain PyTorch versions (the CUDA
kernels themselves are held against those plain versions on the card by
``chip_smoke.py``).

Tolerance: f32 inputs; max |port - jax| <= 1e-5 * max |jax| (the two sum
the K products in different orders, nothing else differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.ops.grouped_matmul import (
    _gmm2_blocks,
    _single_k_blocks,
)
from kubeflow_controller_tpu.ops.grouped_matmul import gmm as jax_gmm
from kubeflow_controller_tpu.ops.grouped_matmul import gmm_swiglu as jax_gmm_swiglu
from kubeflow_controller_tpu_torch.ops import grouped_matmul as tgm

torch.set_num_threads(2)

REL_TOL = 1e-5


def assert_close_rel(got, ref, rel=REL_TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref))
    assert err <= rel * np.max(np.abs(ref)), (err, np.max(np.abs(ref)))


def make_case(seed, m, k, n, n_experts, bm, tile_experts=None):
    rng = np.random.default_rng(seed)
    lhs = rng.standard_normal((m, k)).astype(np.float32)
    rhs_g = (rng.standard_normal((n_experts, k, n)) * 0.1).astype(np.float32)
    rhs_u = (rng.standard_normal((n_experts, k, n)) * 0.1).astype(np.float32)
    if tile_experts is None:
        tile_experts = np.sort(rng.integers(0, n_experts, m // bm))
    te = np.asarray(tile_experts, np.int32)
    assert te.shape == (m // bm,)
    return lhs, rhs_g, rhs_u, te


# (name, M, K, N, E, bm, tile_experts or None)
CASES = [
    # K fits one block: JAX runs _gmm_single_k_kernel and _gmm2_kernel.
    ("single_k", 64, 128, 256, 4, 8, None),
    # Uneven groups, expert 1 owns no rows, expert 3 owns half the tiles.
    ("uneven_empty_expert", 64, 128, 256, 4, 8, [0, 0, 2, 3, 3, 3, 3, 3]),
    # bm 256, K 6144 in f32: the single-k working set exceeds the VMEM
    # budget, so JAX runs _gmm_kernel with its K loop (and the unfused
    # two-gmm SwiGLU).
    ("k_loop", 512, 6144, 128, 2, 256, [0, 1]),
]


@pytest.fixture(params=CASES, ids=[c[0] for c in CASES])
def case(request):
    name, m, k, n, e, bm, te = request.param
    return (name, bm) + make_case(7, m, k, n, e, bm, te)


def test_cases_reach_the_intended_pallas_kernels():
    """Guards the case list: the JAX block choices really pick the
    single-k kernel for the small shapes and the K-loop kernel for the
    large one, in f32."""
    assert _single_k_blocks(64, 128, 256, 8, 1408, 4) is not None
    assert _gmm2_blocks(64, 128, 256, 8, 1408, 4) is not None
    assert _single_k_blocks(512, 6144, 128, 256, 1408, 4) is None
    assert _gmm2_blocks(512, 6144, 128, 256, 1408, 4) is None


def test_gmm_matches_jax(case):
    _, bm, lhs, rhs, _, te = case
    ref = jax_gmm(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(te), None,
                  bm)
    got = tgm.gmm(torch.from_numpy(lhs), torch.from_numpy(rhs),
                  torch.from_numpy(te), bm)
    assert got.dtype == torch.float32
    assert_close_rel(got.numpy(), ref)


def test_gmm_swiglu_matches_jax(case):
    _, bm, lhs, rhs_g, rhs_u, te = case
    ref = jax_gmm_swiglu(jnp.asarray(lhs), jnp.asarray(rhs_g),
                         jnp.asarray(rhs_u), jnp.asarray(te), bm)
    got = tgm.gmm_swiglu(torch.from_numpy(lhs), torch.from_numpy(rhs_g),
                         torch.from_numpy(rhs_u), torch.from_numpy(te), bm)
    assert_close_rel(got.numpy(), ref)


def test_plain_matches_per_tile_numpy_loop(case):
    """The plain versions against the obvious loop over tiles (f64)."""
    _, bm, lhs, rhs_g, rhs_u, te = case
    g = np.concatenate([lhs[i * bm:(i + 1) * bm].astype(np.float64)
                        @ rhs_g[e] for i, e in enumerate(te)])
    u = np.concatenate([lhs[i * bm:(i + 1) * bm].astype(np.float64)
                        @ rhs_u[e] for i, e in enumerate(te)])
    args = (torch.from_numpy(lhs), torch.from_numpy(rhs_g),
            torch.from_numpy(rhs_u), torch.from_numpy(te))
    assert_close_rel(tgm.gmm_plain(args[0], args[1], args[3], bm).numpy(), g)
    h = g / (1.0 + np.exp(-g)) * u
    assert_close_rel(tgm.gmm_swiglu_plain(*args, bm).numpy(), h)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    lhs, rhs_g, rhs_u, te = make_case(1, 32, 16, 24, 2, 8, [0, 0, 1, 1])
    before = (tgm.gmm.launches, tgm.gmm_swiglu.launches)
    args = [torch.from_numpy(a) for a in (lhs, rhs_g, rhs_u, te)]
    torch.testing.assert_close(tgm.gmm(args[0], args[1], args[3], 8),
                               tgm.gmm_plain(args[0], args[1], args[3], 8),
                               rtol=0, atol=0)
    torch.testing.assert_close(tgm.gmm_swiglu(*args, 8),
                               tgm.gmm_swiglu_plain(*args, 8), rtol=0, atol=0)
    assert (tgm.gmm.launches, tgm.gmm_swiglu.launches) == before


def test_plain_swiglu_rounds_once_after_f32_silu():
    """bf16 inputs: h is silu(gate_f32) * up_f32 rounded once to bf16, not
    silu applied to bf16-rounded products (the fused JAX kernel's order)."""
    lhs, rhs_g, rhs_u, te = make_case(3, 32, 64, 32, 2, 16, [0, 1])
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (lhs, rhs_g, rhs_u)]
    tet = torch.from_numpy(te)
    got = tgm.gmm_swiglu_plain(*bf, tet, 16)
    assert got.dtype == torch.bfloat16
    g = tgm.gmm_plain(bf[0].float(), bf[1].float(), tet, 16)
    u = tgm.gmm_plain(bf[0].float(), bf[2].float(), tet, 16)
    want = (torch.nn.functional.silu(g) * u).to(torch.bfloat16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("what,mutate,exc", [
    ("f32 operand", lambda a: a.update(lhs=a["lhs"].float()), TypeError),
    ("non-contiguous lhs", lambda a: a.update(lhs=a["lhs"].t().contiguous().t()),
     ValueError),
    ("bm not a power of two", lambda a: a.update(bm=24), ValueError),
    ("bm not dividing M", lambda a: a.update(bm=64), ValueError),
    ("tile_experts int64", lambda a: a.update(te=a["te"].long()), TypeError),
    ("tile_experts wrong length", lambda a: a.update(te=a["te"][:1]),
     ValueError),
    ("K not a multiple of 8", lambda a: a.update(
        lhs=a["lhs"][:, :12].contiguous(), rhs=a["rhs"][:, :12].contiguous()),
     ValueError),
    ("rhs K mismatch", lambda a: a.update(rhs=a["rhs"][:, :8].contiguous()),
     ValueError),
])
def test_kernel_argument_checks(what, mutate, exc):
    """What the CUDA wrappers check before a pointer crosses into C (run
    here on CPU tensors; on the card a failing check raises the same)."""
    args = {"lhs": torch.zeros((32, 16), dtype=torch.bfloat16),
            "rhs": torch.zeros((2, 16, 24), dtype=torch.bfloat16),
            "te": torch.zeros((2,), dtype=torch.int32), "bm": 16}
    tgm._check(args["lhs"], (args["rhs"],), args["te"], args["bm"])
    mutate(args)
    with pytest.raises(exc):
        tgm._check(args["lhs"], (args["rhs"],), args["te"], args["bm"])
