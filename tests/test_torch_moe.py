"""Port parity: ``kubeflow_controller_tpu_torch.models.moe`` against the
JAX package's ``moe_ffn_stats`` (dispatches "einsum", "scatter" and
"grouped"; values, router stats and gradients) and ``moe_ffn_reference``.

The JAX side runs its Pallas kernels under ``interpret=True`` (D and F
multiples of 128, B*T*k a multiple of the f32 sublane tile, so it takes
the grouped path, not its einsum fallback; the gradient cases turn that
fallback's warning into an error to prove it).  The layout check captures
what JAX's ``_grouped_ffn`` hands its kernels (``tile_experts``) and its
combine (the destination rows) by wrapping those two callees.  On the same
routings the layout's plain version (``ops/moe_layout.py``) equals a stable
sort of the slots, unsharded and as a first and a middle shard.

Tolerance: f32; max |port - jax| <= 1e-5 * max |jax|, for values and
gradients.  Layout indices must be equal exactly.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubeflow_controller_tpu.models.moe as jax_moe
import kubeflow_controller_tpu.ops.grouped_matmul as jax_gm
from kubeflow_controller_tpu_torch.models import moe
from kubeflow_controller_tpu_torch.ops import moe_layout as ml
from test_torch_moe_layout import FIELDS, assert_same, sorted_layout

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


@pytest.mark.parametrize("held,first", [(4, None), (2, 0), (2, 1)],
                         ids=["unsharded", "first_shard", "middle_shard"])
def test_plain_layout_is_the_sorted_layout(routed, held, first):
    """The plain version (the reference's one-hot cumsum, which the CPU
    runs) against a stable sort of the slots, on the reference's routings,
    unsharded and as a first and a middle shard of two experts; and
    ``grouped_layout`` hands it on unchanged."""
    x, w, block_m = routed
    _, _, idx = moe._route(torch.from_numpy(x), torch.from_numpy(w[0]), 2)
    lay = moe.grouped_layout(idx, held, block_m, first)
    want = sorted_layout(idx.numpy(), held, lay.bm, first)
    plain = ml.moe_layout_plain(idx, held, lay.bm, first)
    assert_same(plain, want, dtypes=False)
    assert_same([getattr(lay, f) for f in FIELDS], plain)
    assert lay.m == idx.numel() + (held + (first is not None)) * lay.bm


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
    torch.testing.assert_close(moe.moe_ffn(x, *w, top_k=2, dispatch="grouped"),
                               y, rtol=0, atol=0)


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


AUX_COEF, Z_COEF = 1e-2, 1e-3


def jax_value_and_grad(x, w, **kw):
    """(y, stats, grads of x and the four weights) of the reference, the
    scalar being sum(y * g) plus the router losses; the grouped dispatch's
    einsum fallback is an error here."""
    g = np.random.default_rng(99).standard_normal(x.shape).astype(np.float32)

    def loss(xx, *ws):
        y, st = jax_moe.moe_ffn_stats(xx, *ws, top_k=2, **kw)
        total = (jnp.sum(y * g) + AUX_COEF * st["aux_loss"]
                 + Z_COEF * st["z_loss"])
        return total, (y, st)

    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="moe dispatch")
        (_, (y, st)), grads = jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
                jnp.asarray(x), *map(jnp.asarray, w))
    return np.asarray(y), {k: float(v) for k, v in st.items()}, grads, g


# (dispatch, capacity): capacity 0 is the default rule (C = 10 here);
# capacity 3 of the ~8 slots each expert is sent makes the capacity
# dispatches drop more (overflow_frac > 0 is compared either way).
GRAD_CASES = [("einsum", 0), ("einsum", 3), ("scatter", 0), ("scatter", 3),
              ("grouped", 0)]


@pytest.mark.parametrize("dispatch,capacity", GRAD_CASES,
                         ids=[f"{d}-c{c}" for d, c in GRAD_CASES])
def test_moe_ffn_stats_values_and_gradients_match_jax(dispatch, capacity):
    w = weights(20)
    x = activations(21)
    y_ref, st_ref, grads_ref, g = jax_value_and_grad(
        x, w, dispatch=dispatch, capacity=capacity)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, *w)]
    y, st = moe.moe_ffn_stats(*ts, top_k=2, dispatch=dispatch,
                              capacity=capacity)
    (torch.sum(y * torch.from_numpy(g)) + AUX_COEF * st["aux_loss"]
     + Z_COEF * st["z_loss"]).backward()
    assert_close_rel(y.detach().numpy(), y_ref)
    for key in ("aux_loss", "z_loss", "overflow_frac"):
        np.testing.assert_allclose(float(st[key].detach()), st_ref[key],
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    if capacity:
        assert st_ref["overflow_frac"] > 0
    for name, t, ref in zip(("x", "router", "w_gate", "w_up", "w_down"), ts,
                            grads_ref):
        assert_close_rel(t.grad.numpy(), np.asarray(ref))


def test_default_dispatch_is_einsum_like_the_reference():
    w = [torch.from_numpy(a) for a in weights(22)]
    x = torch.from_numpy(activations(23))
    y, st = moe.moe_ffn_stats(x, *w, capacity=3)
    y_e, _ = moe.moe_ffn_stats(x, *w, capacity=3, dispatch="einsum")
    torch.testing.assert_close(y, y_e, rtol=0, atol=0)
    assert float(st["overflow_frac"]) > 0
    torch.testing.assert_close(moe.moe_ffn(x, *w, capacity=3), y, rtol=0,
                               atol=0)


def test_grouped_request_the_kernels_cannot_take_falls_back_to_einsum():
    """Off the CPU, grouped dispatch obeys the CUDA kernels' rule (bf16, D
    and F multiples of 8): otherwise it warns once, in the reference's
    words, and runs "einsum"; under the strict filter it raises every time.
    The meta device stands in for CUDA."""
    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, device="meta", dtype=dtype)

    moe._GROUPED_FALLBACK_WARNED.clear()
    x32, wg = meta(1, 8, 16), meta(4, 16, 32)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="moe dispatch")
        for _ in range(2):
            with pytest.raises(UserWarning, match="moe dispatch='grouped'"):
                moe._resolve_dispatch("grouped", x32, wg)
    with pytest.warns(UserWarning, match=r"cannot run under .*bf16.*falling "
                      r"back to 'einsum'"):
        assert moe._resolve_dispatch("grouped", x32, wg) == "einsum"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert moe._resolve_dispatch("grouped", x32, wg) == "einsum"
        xb = meta(1, 8, 16, dtype=torch.bfloat16)
        assert moe._resolve_dispatch("grouped", xb, wg) == "grouped"
        assert moe._resolve_dispatch("einsum", x32, wg) == "einsum"
        cpu = torch.zeros((1, 8, 16))
        assert moe._resolve_dispatch("grouped", cpu, wg) == "grouped"
    with pytest.warns(UserWarning, match="multiples of 8"):
        assert moe._resolve_dispatch(
            "grouped", meta(1, 8, 12, dtype=torch.bfloat16),
            meta(4, 12, 32)) == "einsum"


def test_unknown_dispatch_raises_value_error():
    w = [torch.from_numpy(a) for a in weights(0)]
    with pytest.raises(ValueError):
        moe.moe_ffn(torch.from_numpy(activations(1)), *w, dispatch="sort")
    with pytest.raises(ValueError):
        moe.moe_ffn_stats(torch.from_numpy(activations(1)), *w,
                          dispatch="sort")


def test_layout_inverse_maps_undo_dest():
    """``inv_src``/``inv_pos`` invert ``dest`` on real rows and point pad
    rows at the sentinels, so the dispatch and combine backward are
    gathers."""
    idx = torch.from_numpy(np.random.default_rng(3).integers(0, 4, (2, 8, 2)))
    lay = moe.grouped_layout(idx, 4, 8)
    n_slots = idx.numel()
    assert torch.equal(lay.inv_pos[lay.dest], torch.arange(n_slots))
    assert torch.equal(lay.inv_src[lay.dest], torch.arange(n_slots) // 2)
    pad = torch.ones(lay.m, dtype=torch.bool)
    pad[lay.dest] = False
    assert (lay.inv_pos[pad] == n_slots).all()
    assert (lay.inv_src[pad] == n_slots // 2).all()


def test_block_m_rounds_down_to_power_of_two():
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, 4, (2, 16, 2)))
    assert moe.grouped_layout(idx, 4, moe._pow2_floor(300)).bm == 64
    assert moe.grouped_layout(idx, 4, 256).bm == 64     # 64 slots
    with pytest.raises(ValueError):
        moe._pow2_floor(0)
