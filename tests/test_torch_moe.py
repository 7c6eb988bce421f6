"""Port parity: ``kubeflow_controller_tpu_torch.models.moe`` (grouped
dispatch) against the JAX package's ``moe_ffn_stats(dispatch="grouped")``
and ``moe_ffn_reference``.

The JAX side runs its Pallas kernels under ``interpret=True`` (D and F
multiples of 128, B*T*k a multiple of the f32 sublane tile, so it takes
the grouped path, not its einsum fallback).  The layout check captures
what JAX's ``_grouped_ffn`` hands its kernels (``tile_experts``) and its
combine (the destination rows) by wrapping those two callees.

Tolerance: f32; max |port - jax| <= 1e-5 * max |jax|.  Layout indices
must be equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubeflow_controller_tpu.models.moe as jax_moe
import kubeflow_controller_tpu.ops.grouped_matmul as jax_gm
from kubeflow_controller_tpu_torch.models import moe

torch.set_num_threads(2)

REL_TOL = 1e-5


def assert_close_rel(got, ref, rel=REL_TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref))
    assert err <= rel * np.max(np.abs(ref)), (err, np.max(np.abs(ref)))


def weights(seed, d=128, e=4, f=256, router_scale=0.1):
    rng = np.random.default_rng(seed)
    return (
        (rng.standard_normal((d, e)) * router_scale).astype(np.float32),
        (rng.standard_normal((e, d, f)) * 0.05).astype(np.float32),
        (rng.standard_normal((e, d, f)) * 0.05).astype(np.float32),
        (rng.standard_normal((e, f, d)) * 0.05).astype(np.float32),
    )


def activations(seed, b=2, t=16, d=128):
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(
        np.float32)


def capture_jax_layout(monkeypatch, x, w, block_m):
    """Run JAX's grouped path and return (y, tile_experts, dest)."""
    seen = {}
    orig_swiglu, orig_combine = jax_gm.gmm_swiglu, jax_moe._combine_rows

    def swiglu_spy(lhs, rhs_g, rhs_u, tile_experts, bm=256, bn=1408):
        seen["tile_experts"] = np.asarray(tile_experts)
        seen["bm"] = bm
        return orig_swiglu(lhs, rhs_g, rhs_u, tile_experts, bm, bn)

    def combine_spy(y_pad, slot_dest, inv_pos):
        seen["dest"] = np.asarray(slot_dest)
        return orig_combine(y_pad, slot_dest, inv_pos)

    monkeypatch.setattr(jax_gm, "gmm_swiglu", swiglu_spy)
    monkeypatch.setattr(jax_moe, "_combine_rows", combine_spy)
    y, _ = jax_moe.moe_ffn_stats(jnp.asarray(x), *map(jnp.asarray, w),
                                 top_k=2, dispatch="grouped", block_m=block_m)
    return np.asarray(y), seen


# (name, weight seed, router scale, block_m): "collapsed" pushes every
# token onto two experts, so the others own no rows at all.
LAYOUTS = [
    ("random_bm256", 0, 0.1, 256),
    ("random_bm8", 1, 0.1, 8),
    ("collapsed", 2, None, 256),
]


@pytest.fixture(params=LAYOUTS, ids=[c[0] for c in LAYOUTS])
def routed(request):
    _, seed, scale, block_m = request.param
    w = list(weights(seed, router_scale=scale or 0.1))
    x = activations(seed + 10)
    if scale is None:
        x = np.abs(x)                       # positive inputs, and
        w[0] = np.zeros_like(w[0])          # a router that always
        w[0][:, 1] = 5.0                    # ranks expert 1 first,
        w[0][:, 3] = 4.0                    # expert 3 second
    return x, tuple(w), block_m


def test_layout_equals_jax_exactly(routed, monkeypatch):
    x, w, block_m = routed
    _, seen = capture_jax_layout(monkeypatch, x, w, block_m)
    xt = torch.from_numpy(x)
    _, _, idx = moe._route(xt, torch.from_numpy(w[0]), 2)
    lay = moe.grouped_layout(idx, w[0].shape[1], block_m)
    assert lay.bm == seen["bm"]
    np.testing.assert_array_equal(lay.tile_experts.numpy(),
                                  seen["tile_experts"])
    assert lay.tile_experts.dtype == torch.int32
    np.testing.assert_array_equal(lay.dest.numpy(), seen["dest"])


def test_grouped_ffn_matches_jax_grouped_and_reference(routed, monkeypatch):
    x, w, block_m = routed
    y_jax, _ = capture_jax_layout(monkeypatch, x, w, block_m)
    wt = [torch.from_numpy(a) for a in w]
    y, stats = moe.moe_ffn_stats(torch.from_numpy(x), *wt, top_k=2,
                                 dispatch="grouped", block_m=block_m)
    assert_close_rel(y.numpy(), y_jax)
    ref_jax = jax_moe.moe_ffn_reference(jnp.asarray(x),
                                        *map(jnp.asarray, w), top_k=2)
    assert_close_rel(y.numpy(), ref_jax)
    assert_close_rel(moe.moe_ffn_reference(torch.from_numpy(x), *wt,
                                           top_k=2).numpy(), ref_jax)
    assert float(stats["overflow_frac"]) == 0.0


def test_router_stats_match_jax():
    w = weights(4)
    x = activations(5)
    _, s_jax = jax_moe.moe_ffn_stats(jnp.asarray(x), *map(jnp.asarray, w),
                                     top_k=2, dispatch="grouped")
    _, s = moe.moe_ffn_stats(torch.from_numpy(x),
                             *[torch.from_numpy(a) for a in w], top_k=2,
                             dispatch="grouped")
    for key in ("aux_loss", "z_loss", "overflow_frac"):
        np.testing.assert_allclose(float(s[key]), float(s_jax[key]),
                                   rtol=1e-5, atol=1e-7)


def test_moe_ffn_equals_stats_output():
    w = [torch.from_numpy(a) for a in weights(6)]
    x = torch.from_numpy(activations(7))
    y, _ = moe.moe_ffn_stats(x, *w, top_k=2, dispatch="grouped")
    torch.testing.assert_close(moe.moe_ffn(x, *w, top_k=2), y, rtol=0, atol=0)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_router_topk_ties_take_lower_index_like_lax_top_k(k):
    logits = np.array([[0.5, 2.0, 2.0, -1.0, 2.0, 0.5],
                       [1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
                       [3.0, -2.0, 3.0, 3.0, 0.0, 3.0]], np.float32)
    vals, idx_jax = jax.lax.top_k(jnp.asarray(logits), k)
    probs, idx = moe.router_topk(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_jax))
    np.testing.assert_allclose(probs.numpy(),
                               np.asarray(jax.nn.softmax(vals, axis=-1)),
                               rtol=1e-6)


def test_below_tpu_grain_port_stays_grouped_and_dropless():
    """D=16 is below the TPU tiling grain: JAX falls back to its einsum
    dispatch there, the port keeps the grouped path (a Mosaic rule, not a
    semantic one) and still equals the dropless dense oracle."""
    w = [torch.from_numpy(a) for a in weights(8, d=16, e=4, f=32)]
    x = torch.from_numpy(activations(9, b=1, t=5, d=16))   # 10 slots: bm 2
    y = moe.moe_ffn(x, *w, top_k=2)
    ref = moe.moe_ffn_reference(x, *w, top_k=2)
    assert_close_rel(y.numpy(), ref.numpy())
    ref_jax = jax_moe.moe_ffn_reference(jnp.asarray(x.numpy()),
                                        *[jnp.asarray(a.numpy()) for a in w],
                                        top_k=2)
    assert_close_rel(y.numpy(), ref_jax)


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_unported_dispatches_raise_not_implemented(dispatch):
    w = [torch.from_numpy(a) for a in weights(0)]
    x = torch.from_numpy(activations(1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        moe.moe_ffn_stats(x, *w, dispatch=dispatch)
    with pytest.raises(NotImplementedError):
        moe.moe_ffn(x, *w, dispatch=dispatch)


def test_unknown_dispatch_raises_value_error():
    w = [torch.from_numpy(a) for a in weights(0)]
    with pytest.raises(ValueError):
        moe.moe_ffn(torch.from_numpy(activations(1)), *w, dispatch="sort")


def test_block_m_rounds_down_to_power_of_two():
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, 4, (2, 16, 2)))
    assert moe.grouped_layout(idx, 4, moe._pow2_floor(300)).bm == 64
    assert moe.grouped_layout(idx, 4, 256).bm == 64     # 64 slots
    with pytest.raises(ValueError):
        moe._pow2_floor(0)
