"""Port parity: ``kubeflow_controller_tpu_torch.ops.grouped_matmul`` against
the JAX package's grouped-matmul Pallas kernels, forward and backward.

Off-TPU the JAX kernels run under ``interpret=True``, so each case below
reaches the same Pallas kernel the serving path reaches at full width:
``_gmm_single_k_kernel`` when K fits one block (decode's down-projection),
``_gmm_kernel`` with its K loop when ``_single_k_blocks`` returns None
(prefill's down-projection), and ``_gmm2_kernel`` for the fused SwiGLU.
The backward cases hold the port's autograd against ``jax.vjp`` of the
reference's custom VJPs (``_gmm_bwd``, ``_gmm_swiglu_bwd``), which reach
``_tgmm_kernel``, and with ``valid_tiles`` ``_gmm_single_k_skip_kernel``
and ``_tgmm_skip_kernel``; ``tgmm`` is also held against ``_tgmm_impl``
directly.  On the CPU the port's wrappers take their plain PyTorch versions
(the CUDA kernels themselves are held against those plain versions on the
card by ``chip_smoke.py``).

The decode-size cases hold the plain versions, which the swap-AB kernels
(bm < 64) are held to on the card, against the JAX kernels on the port's
own grouped layouts of 4-16 tokens at bm 8-32, and against the
reference's ``gmm_reference`` at bm 4; the clamped tiles past the last
group read the zero sentinel row and must come out exactly 0.

Tolerance: f32 inputs; max |port - jax| <= 1e-5 * max |jax| (the two sum
the products in different orders, nothing else differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.ops.grouped_matmul import (
    _gmm2_blocks,
    _single_k_blocks,
    _tgmm_impl,
)
from kubeflow_controller_tpu.ops.grouped_matmul import gmm as jax_gmm
from kubeflow_controller_tpu.ops.grouped_matmul import gmm_reference
from kubeflow_controller_tpu.ops.grouped_matmul import gmm_swiglu as jax_gmm_swiglu
from kubeflow_controller_tpu_torch.models import moe as tmoe
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
    counters = (tgm.gmm, tgm.gmm_swiglu, tgm.tgmm)
    before = [f.launches for f in counters]
    args = [torch.from_numpy(a) for a in (lhs, rhs_g, rhs_u, te)]
    torch.testing.assert_close(tgm.gmm(args[0], args[1], args[3], 8),
                               tgm.gmm_plain(args[0], args[1], args[3], 8),
                               rtol=0, atol=0)
    torch.testing.assert_close(tgm.gmm_swiglu(*args, 8),
                               tgm.gmm_swiglu_plain(*args, 8), rtol=0, atol=0)
    dout = torch.ones((32, 24))
    torch.testing.assert_close(tgm.tgmm(args[0], dout, args[3], 2, 8),
                               tgm.tgmm_plain(args[0], dout, args[3], 2, 8),
                               rtol=0, atol=0)
    lhs_g = args[0].clone().requires_grad_()
    tgm.gmm_swiglu(lhs_g, *args[1:], 8).sum().backward()
    assert lhs_g.grad is not None
    assert [f.launches for f in counters] == before


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
    ("transposed rhs not [E, N, K]", lambda a: a.update(trans=True),
     ValueError),
    ("valid_tiles int64", lambda a: a.update(vt=a["vt"].long()), TypeError),
    ("valid_tiles two values", lambda a: a.update(
        vt=torch.zeros((2,), dtype=torch.int32)), ValueError),
    # TMA reads from 16-byte-aligned base addresses only.
    ("lhs not 16-byte aligned", lambda a: a.update(
        lhs=torch.zeros(32 * 16 + 8, dtype=torch.bfloat16)[1:513].view(32, 16)),
     ValueError),
])
def test_kernel_argument_checks(what, mutate, exc):
    """What the CUDA wrappers check before a pointer crosses into C (run
    here on CPU tensors; on the card a failing check raises the same)."""
    args = {"lhs": torch.zeros((32, 16), dtype=torch.bfloat16),
            "rhs": torch.zeros((2, 16, 24), dtype=torch.bfloat16),
            "te": torch.zeros((2,), dtype=torch.int32), "bm": 16,
            "vt": torch.ones((1,), dtype=torch.int32), "trans": False}

    def check():
        tgm._check(args["lhs"], (args["rhs"],), args["te"], args["bm"],
                   args["vt"], transpose_rhs=args["trans"])

    check()
    tgm._check(args["lhs"], (args["rhs"].transpose(1, 2).contiguous(),),
               args["te"], args["bm"], transpose_rhs=True)
    mutate(args)
    with pytest.raises(exc):
        check()


# ---------------------------------------------------------------------------
# Backward: the custom VJPs and tgmm
# ---------------------------------------------------------------------------

def torch_vjp(fn, inputs, dout):
    """(output, grads of every input) of ``fn`` under the port's
    autograd, cotangent ``dout``."""
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = fn(*ts)
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def cotangent(seed, m, n):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)


def test_gmm_vjp_matches_jax(case):
    """dlhs (gmm against rhsᵀ) and drhs (tgmm) of the port's autograd
    against ``jax.vjp`` of the reference's custom-VJP ``gmm``."""
    _, bm, lhs, rhs, _, te = case
    dout = cotangent(11, lhs.shape[0], rhs.shape[2])
    y, vjp = jax.vjp(lambda a, b: jax_gmm(a, b, jnp.asarray(te), None, bm),
                     jnp.asarray(lhs), jnp.asarray(rhs))
    refs = vjp(jnp.asarray(dout))
    got, grads = torch_vjp(
        lambda a, b: tgm.gmm(a, b, torch.from_numpy(te), bm), (lhs, rhs),
        dout)
    assert_close_rel(got, y)
    for g, r in zip(grads, refs):
        assert_close_rel(g, r)


# The compute skip exists only on the reference's single-k path.
SKIP_CASES = [c for c in CASES if c[0] != "k_loop"]


@pytest.mark.parametrize("name", [c[0] for c in SKIP_CASES])
def test_gmm_vjp_with_valid_tiles_matches_jax(name):
    """``valid_tiles``: tiles at or past it read zero forward, and take no
    part in dlhs (zero rows) or drhs (``_gmm_single_k_skip_kernel`` and
    ``_tgmm_skip_kernel`` in the reference)."""
    _, m, k, n, e, bm, te = next(c for c in SKIP_CASES if c[0] == name)
    lhs, rhs, _, te = make_case(7, m, k, n, e, bm, te)
    vt = np.array([len(te) // 2 + 1], np.int32)
    dout = cotangent(12, m, n)
    y, vjp = jax.vjp(
        lambda a, b: jax_gmm(a, b, jnp.asarray(te), jnp.asarray(vt), bm),
        jnp.asarray(lhs), jnp.asarray(rhs))
    refs = vjp(jnp.asarray(dout))
    got, grads = torch_vjp(
        lambda a, b: tgm.gmm(a, b, torch.from_numpy(te), bm,
                             torch.from_numpy(vt)), (lhs, rhs), dout)
    assert_close_rel(got, y)
    for g, r in zip(grads, refs):
        assert_close_rel(g, r)
    assert not got[vt[0] * bm:].any() and not grads[0][vt[0] * bm:].any()


def test_gmm_swiglu_vjp_matches_jax(case):
    """dlhs and both weight gradients of the fused SwiGLU against the
    reference's ``_gmm_swiglu_bwd`` (silu' on gate/up, two gmms against
    the transposed weights, two tgmms)."""
    _, bm, lhs, rhs_g, rhs_u, te = case
    dout = cotangent(13, lhs.shape[0], rhs_g.shape[2])
    y, vjp = jax.vjp(
        lambda a, b, c: jax_gmm_swiglu(a, b, c, jnp.asarray(te), bm),
        *map(jnp.asarray, (lhs, rhs_g, rhs_u)))
    refs = vjp(jnp.asarray(dout))
    got, grads = torch_vjp(
        lambda a, b, c: tgm.gmm_swiglu(a, b, c, torch.from_numpy(te), bm),
        (lhs, rhs_g, rhs_u), dout)
    assert_close_rel(got, y)
    for g, r in zip(grads, refs):
        assert_close_rel(g, r)


@pytest.mark.parametrize("skip", [False, True], ids=["all", "valid_tiles"])
def test_tgmm_matches_jax_tgmm_impl(case, skip):
    """``tgmm`` against the reference's ``_tgmm_impl`` (``_tgmm_kernel``,
    or ``_tgmm_skip_kernel`` under ``valid_tiles``), empty experts included
    (``uneven_empty_expert``: expert 1 owns no tile)."""
    _, bm, lhs, rhs, _, te = case
    e = rhs.shape[0]
    dout = cotangent(14, lhs.shape[0], rhs.shape[2])
    vt = np.array([len(te) // 2 + 1], np.int32) if skip else None
    ref = _tgmm_impl(jnp.asarray(lhs), jnp.asarray(dout), jnp.asarray(te), e,
                     bm, 1408, 1408,
                     None if vt is None else jnp.asarray(vt))
    got = tgm.tgmm(torch.from_numpy(lhs), torch.from_numpy(dout),
                   torch.from_numpy(te), e, bm,
                   None if vt is None else torch.from_numpy(vt))
    assert_close_rel(got.numpy(), ref)
    counted = te if vt is None else te[:vt[0]]
    for ex in sorted(set(range(e)) - set(counted.tolist())):
        assert not got[ex].any(), f"expert {ex} owns no counted tile"


def real_layout(seed, n_tok, n_experts, k=2, bm=8, empty=1):
    """A grouped layout as ``models/moe.py`` builds it, from a routing that
    never picks expert ``empty``, with nonzero data in every row (pad rows
    and the clamped tail included)."""
    rng = np.random.default_rng(seed)
    choices = [x for x in range(n_experts) if x != empty]
    idx = np.stack([rng.permutation(choices)[:k] for _ in range(n_tok)])
    lay = tmoe.grouped_layout(torch.from_numpy(idx)[None], n_experts, bm)
    return lay, rng


def test_tgmm_on_a_real_layout_adds_the_clamped_tail_into_the_last_expert():
    """Tiles past the last group carry E - 1 and add into it (the
    reference's semantics, right on real data only because those rows are
    zero there); an expert that owns no tile gets exact zeros."""
    e, bm, k_dim, n_dim = 4, 8, 16, 24
    lay, rng = real_layout(3, 20, e, bm=bm)
    te = lay.tile_experts.numpy()
    assert 1 not in te and te[-1] == e - 1
    lhs = rng.standard_normal((lay.m, k_dim)).astype(np.float32)
    dout = rng.standard_normal((lay.m, n_dim)).astype(np.float32)
    got = tgm.tgmm(torch.from_numpy(lhs), torch.from_numpy(dout),
                   lay.tile_experts, e, bm).numpy()
    ref = np.asarray(_tgmm_impl(jnp.asarray(lhs), jnp.asarray(dout),
                                jnp.asarray(te), e, bm, 1408, 1408))
    assert_close_rel(got, ref)
    assert not got[1].any()
    last = lhs.astype(np.float64)[te.repeat(bm) == e - 1]
    want = last.T @ dout.astype(np.float64)[te.repeat(bm) == e - 1]
    assert_close_rel(got[e - 1], want)


def test_valid_tiles_plain_semantics_against_numpy():
    """The plain versions under ``valid_tiles`` against the obvious loops:
    gmm rows of skipped tiles read exactly 0, tgmm leaves them out, and
    an expert whose only tiles are skipped gets zeros."""
    lhs, rhs, _, te = make_case(5, 48, 16, 24, 3, 8, [0, 0, 1, 1, 2, 2])
    vt = torch.tensor([3], dtype=torch.int32)
    args = [torch.from_numpy(a) for a in (lhs, rhs, te)]
    y = tgm.gmm_plain(*args, 8, vt).numpy()
    want = np.concatenate([lhs[i * 8:(i + 1) * 8] @ rhs[x] if i < 3
                           else np.zeros((8, 24), np.float32)
                           for i, x in enumerate(te)])
    assert_close_rel(y, want)
    assert not y[24:].any()
    dout = cotangent(15, 48, 24)
    g = tgm.tgmm(args[0], torch.from_numpy(dout), args[2], 3, 8, vt).numpy()
    assert_close_rel(g[0], lhs[:16].T @ dout[:16])
    assert_close_rel(g[1], lhs[16:24].T @ dout[16:24])
    assert not g[2].any()
    yt = tgm.gmm_plain(torch.from_numpy(dout), args[1], args[2], 8, vt,
                       transpose_rhs=True).numpy()
    assert_close_rel(yt[:24], np.concatenate(
        [dout[i * 8:(i + 1) * 8] @ rhs[x].T for i, x in enumerate(te[:3])]))


# ---------------------------------------------------------------------------
# Decode-size layouts (bm < 64): what the swap-AB kernels are held to
# ---------------------------------------------------------------------------

# (tokens, bm) of the port's grouped layouts at top-2 (2 x tokens routing
# slots; bm divides them): decode and the small prefill buckets.
DECODE_LAYOUTS = [(4, 8), (8, 8), (8, 16), (16, 8), (16, 16), (16, 32)]


def decode_case(seed, n_tok, bm, k=128, n=256, n_experts=8):
    """The layout ``models/moe.py`` builds for ``n_tok`` tokens under a
    random top-2 router, its dispatched lhs (pad rows and the clamped tail
    read the zero sentinel row), f32 weights, and the first row past the
    last group."""
    rng = np.random.default_rng(seed)
    idx = np.argsort(-rng.standard_normal((n_tok, n_experts)), axis=1)[:, :2]
    lay = tmoe.grouped_layout(torch.from_numpy(idx)[None], n_experts, bm)
    assert lay.bm == bm
    x = torch.from_numpy(rng.standard_normal((n_tok, k)).astype(np.float32))
    x_pad = tmoe._dispatch_rows(x, lay.inv_src,
                                lay.dest.reshape(n_tok, 2)).numpy()
    w_g, w_u = ((rng.standard_normal((n_experts, k, n)) * 0.1).astype(
        np.float32) for _ in range(2))
    counts = np.bincount(idx.reshape(-1), minlength=n_experts)
    groups_end = int(sum(-(-c // bm) * bm for c in counts))
    assert groups_end < lay.m, "the layout has a clamped tail"
    return lay, x_pad, w_g, w_u, groups_end


def check_decode_layout(lay, got, ref, groups_end):
    """Port and reference agree on every row the combine reads, and the
    clamped tiles past the last group are exactly 0 in both."""
    rows = lay.dest.numpy()
    assert_close_rel(got[rows], np.asarray(ref)[rows])
    assert not got[groups_end:].any()
    assert not np.asarray(ref)[groups_end:].any()


@pytest.mark.parametrize("n_tok,bm", DECODE_LAYOUTS)
def test_gmm_plain_matches_jax_on_decode_layouts(n_tok, bm):
    lay, x_pad, w, _, end = decode_case(21, n_tok, bm)
    te = lay.tile_experts.numpy()
    ref = jax_gmm(jnp.asarray(x_pad), jnp.asarray(w), jnp.asarray(te), None,
                  bm)
    got = tgm.gmm_plain(torch.from_numpy(x_pad), torch.from_numpy(w),
                        lay.tile_experts, bm).numpy()
    check_decode_layout(lay, got, ref, end)


@pytest.mark.parametrize("n_tok,bm", DECODE_LAYOUTS)
def test_gmm_swiglu_plain_matches_jax_on_decode_layouts(n_tok, bm):
    lay, x_pad, w_g, w_u, end = decode_case(22, n_tok, bm)
    te = lay.tile_experts.numpy()
    ref = jax_gmm_swiglu(jnp.asarray(x_pad), jnp.asarray(w_g),
                         jnp.asarray(w_u), jnp.asarray(te), bm)
    got = tgm.gmm_swiglu_plain(torch.from_numpy(x_pad), torch.from_numpy(w_g),
                               torch.from_numpy(w_u), lay.tile_experts,
                               bm).numpy()
    check_decode_layout(lay, got, ref, end)


@pytest.mark.parametrize("n_tok", [4, 8, 16])
def test_plain_matches_gmm_reference_at_bm_4(n_tok):
    """bm 4, below a TPU tile's 8 sublanes (and below the swap-AB kernel's
    8-row wgmma N): the plain versions against the reference's dense
    oracle ``gmm_reference``, and against the JAX kernels, which interpret
    mode runs at this bm."""
    lay, x_pad, w_g, w_u, end = decode_case(23, n_tok, 4)
    args = [jnp.asarray(a) for a in (x_pad, w_g, w_u,
                                     lay.tile_experts.numpy())]
    gate = gmm_reference(args[0], args[1], args[3], 4)
    up = gmm_reference(args[0], args[2], args[3], 4)
    ref_h = jax.nn.silu(gate) * up
    t = [torch.from_numpy(a) for a in (x_pad, w_g, w_u)]
    got = tgm.gmm_plain(t[0], t[1], lay.tile_experts, 4).numpy()
    got_h = tgm.gmm_swiglu_plain(*t, lay.tile_experts, 4).numpy()
    for g, ref in ((got, gate), (got, jax_gmm(args[0], args[1], args[3],
                                              None, 4)),
                   (got_h, ref_h), (got_h, jax_gmm_swiglu(*args, 4))):
        check_decode_layout(lay, g, ref, end)


def test_without_a_gradient_the_swiglu_kernel_writes_h_only(monkeypatch):
    """The serving path (no gradient) asks the kernel for h alone; a
    gradient makes the forward keep gate and up for the backward."""
    lhs, rhs_g, rhs_u, te = make_case(2, 32, 16, 24, 2, 8, [0, 0, 1, 1])
    asked = []
    real = tgm.gmm_swiglu_plain

    def spy(*a, **kw):
        asked.append(a[5] if len(a) > 5 else kw.get("gate_up", False))
        return real(*a, **kw)

    monkeypatch.setattr(tgm, "gmm_swiglu_plain", spy)
    args = [torch.from_numpy(a) for a in (lhs, rhs_g, rhs_u, te)]
    with torch.no_grad():
        tgm.gmm_swiglu(args[0].requires_grad_(), *args[1:], 8)
    tgm.gmm_swiglu(*args, 8)
    assert asked == [False, True]
