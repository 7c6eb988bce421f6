"""The fused RMSNorm and RoPE (``ops/norm_rope.py``) on the CPU: its plain
versions, its rule, the arguments its wrappers hand the C entries, and the
calls a training step makes of it.  The kernels themselves are held
against the plain versions on the card by ``chip_smoke.py``'s
``norm_rope_phase``.

- ``norm_rope_plain`` is the port's ``rmsnorm`` then ``apply_rope``, as
  they were written before the kernel, bit for bit, with either half off;
- ``norm_rope_bwd_plain`` is autograd's gradient of that forward in f64,
  for x and the scale; the rotation alone's is autograd's in bf16 bit for
  bit;
- ``norm_rule`` takes contiguous bf16 operands and refuses DTensors,
  strided views, f32 scales and odd widths; off the CPU the model hands
  every norm and rotation to ``norm_rope``, which casts an f32 scale and
  makes a strided view contiguous for the kernels and raises for what
  they still cannot take, and the wrappers hand the C entries the
  pointers, sizes and row mapping they should; the rotation alone saves
  neither x nor rstd for its backward;
- a mesh step (fsdp, tp, sp) routed as on a card runs each DTensor's
  local shard through ``norm_rope`` and matches JAX's step;
- a tiny dense model and a tiny Trinity-Mini-pattern model (windowed and
  global layers) make the predicted number of fused calls a step under
  remat "full", with the forward's loss bit for bit that of the plain
  composition and the gradients within bf16 rounding of it;
- the kernels' names fall in the benchmark's "other" group (read by
  ``elementwise_ms``) and ``chip_smoke.py``'s elementwise group, and
  ``chip_smoke.ptxas_report`` names each instantiation;
- on a card (marked ``card``; they skip here), the kernels against the
  plain versions at phase 29's shapes, as ``chip_smoke.norm_rope_case``
  holds them.
"""

import sys
from pathlib import Path

import pytest
import torch

from kubeflow_controller_tpu_torch.models import llama as tllama
from kubeflow_controller_tpu_torch.ops import _build
from kubeflow_controller_tpu_torch.ops import norm_rope as nr
from portbench import trace

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

EPS = 1e-5
BF16 = torch.bfloat16


def old_rmsnorm(x, scale, eps):
    """``models/llama.py:rmsnorm`` as written before the kernel."""
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rms).to(x.dtype) * scale.to(x.dtype)


def old_apply_rope(x, cos, sin):
    """``models/llama.py:apply_rope`` as written before the kernel."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return (xf * cos[None, :, None] + rot * sin[None, :, None]).to(x.dtype)


def tables(t, d, dtype=torch.float32, theta=1e4):
    """cos and sin [t, d] as ``rope_tables`` makes them."""
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64) / d)
    ang = torch.arange(t, dtype=torch.float64)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos().to(dtype), ang.sin().to(dtype)


def operands(shape, dtype=BF16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=gen, dtype=torch.float64) * 3).to(dtype)
    scale = (1 + torch.randn(shape[-1], generator=gen,
                             dtype=torch.float64) / 4).to(dtype)
    dy = torch.randn(shape, generator=gen, dtype=torch.float64).to(dtype)
    return x, scale, dy


HALVES = [(True, False), (False, True), (True, True)]
SHAPES = [(2, 5, 3, 32), (1, 7, 4, 16), (3, 4, 1, 64)]


@pytest.mark.parametrize("norm,rope", HALVES,
                         ids=["norm", "rope", "norm+rope"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_is_the_old_composition_bit_for_bit(norm, rope, shape):
    x, scale, _ = operands(shape)
    cos, sin = tables(shape[1], shape[-1])
    want = x
    if norm:
        want = old_rmsnorm(want, scale, EPS)
    if rope:
        want = old_apply_rope(want, cos, sin)
    y, rstd = nr.norm_rope_plain(x, scale if norm else None,
                                 cos if rope else None,
                                 sin if rope else None, EPS)
    assert y.dtype == BF16 and torch.equal(y, want)
    if norm:
        xf = x.float()
        assert torch.equal(rstd, torch.rsqrt(
            (xf * xf).mean(dim=-1) + EPS).reshape(-1))
    else:
        assert rstd.numel() == 0
    # On the CPU the model's building blocks are the old code.
    got = tllama.rmsnorm(x, scale, EPS, (cos, sin) if rope else None) \
        if norm else tllama.apply_rope(x, cos, sin)
    assert torch.equal(got, want)


def f64_forward(x, scale, cos, sin, eps):
    """The norm and the rotation in f64 with no rounding between."""
    y = x
    if scale is not None:
        y = y * torch.rsqrt((y * y).mean(dim=-1, keepdim=True) + eps) * scale
    if cos is not None:
        y1, y2 = y.chunk(2, dim=-1)
        y = (y * cos[None, :, None]
             + torch.cat([-y2, y1], dim=-1) * sin[None, :, None])
    return y


@pytest.mark.parametrize("norm,rope", HALVES,
                         ids=["norm", "rope", "norm+rope"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_is_autograd_in_f64(norm, rope, shape):
    f64 = torch.float64
    x, scale, dy = operands(shape, f64, seed=1)
    cos, sin = tables(shape[1], shape[-1], f64)
    x.requires_grad_()
    scale.requires_grad_()
    s = scale if norm else None
    c, sn = (cos, sin) if rope else (None, None)
    f64_forward(x, s, c, sn, EPS).backward(dy)
    rstd = torch.rsqrt((x.detach() ** 2).mean(dim=-1) + EPS).reshape(-1)
    dx, ds = nr.norm_rope_bwd_plain(x.detach(), None if s is None else
                                    scale.detach(), c, sn, rstd, dy)
    torch.testing.assert_close(dx, x.grad, rtol=1e-12, atol=1e-12)
    if norm:
        torch.testing.assert_close(ds, scale.grad, rtol=1e-12, atol=1e-12)
    else:
        assert ds is None


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_the_rotation_backward_is_autograds_bit_for_bit(shape):
    x, _, dy = operands(shape, seed=2)
    cos, sin = tables(shape[1], shape[-1])
    x.requires_grad_()
    old_apply_rope(x, cos, sin).backward(dy)
    dx, ds = nr.norm_rope_bwd_plain(x.detach(), None, cos, sin,
                                    x.new_empty(0, dtype=torch.float32), dy)
    assert ds is None and torch.equal(dx, x.grad)


@pytest.mark.parametrize("norm,rope", HALVES,
                         ids=["norm", "rope", "norm+rope"])
def test_the_op_on_the_cpu_is_the_plain_pair(norm, rope):
    shape = (2, 6, 3, 32)
    x, scale, dy = operands(shape, seed=3)
    cos, sin = tables(shape[1], shape[-1])
    s = scale.clone().requires_grad_() if norm else None
    c, sn = (cos, sin) if rope else (None, None)
    x.requires_grad_()
    y = nr.norm_rope(x, s, c, sn, EPS)
    want, rstd = nr.norm_rope_plain(x.detach(), s, c, sn, EPS)
    assert torch.equal(y, want)
    y.backward(dy)
    dx, ds = nr.norm_rope_bwd_plain(x.detach(), s, c, sn, rstd, dy)
    assert torch.equal(x.grad, dx)
    if norm:
        assert torch.equal(s.grad, ds)


# ---------------------------------------------------------------------------
# The rule and the C entries' arguments
# ---------------------------------------------------------------------------

def meta(*shape, dtype=BF16):
    """A tensor on no real device: it takes the kernel path (only CPU
    tensors take the plain versions) with no memory behind it."""
    return torch.empty(shape, dtype=dtype, device="meta")


def meta_tables(t, d):
    return meta(t, d, dtype=torch.float32), meta(t, d, dtype=torch.float32)


def test_the_rule_takes_contiguous_bf16_operands_off_the_cpu():
    x, scale = meta(2, 8, 4, 128), meta(128)
    cos, sin = meta_tables(8, 128)
    assert nr.norm_rule(x, scale) is None
    assert nr.norm_rule(x, None, cos, sin) is None
    assert nr.norm_rule(x, scale, cos, sin) is None
    assert nr.norm_rule(meta(4, 16, 4096), meta(4096)) is None
    assert nr.norm_rule(meta(3, 8192), meta(8192)) is None
    # The rule reads the operands only; the device decides the route.
    cpu = torch.zeros(2, 8, 4, 128, dtype=BF16)
    assert nr.norm_rule(cpu, torch.ones(128, dtype=BF16)) is None
    assert nr.on_card(x) and not nr.on_card(cpu)


@pytest.mark.parametrize("case", [
    "strided", "f32 scale", "f32 x", "width 12", "width 8200",
    "rope width 24", "rope on 3-D", "f32 tables wrong T", "bf16 tables",
    "cos alone", "nothing"])
def test_the_rule_refuses_what_the_kernels_do_not_take(case):
    x, scale = meta(2, 8, 4, 128), meta(128)
    cos, sin = meta_tables(8, 128)
    args = {
        "strided": (meta(2, 4, 8, 128).transpose(1, 2), scale),
        "f32 scale": (x, meta(128, dtype=torch.float32)),
        "f32 x": (meta(2, 8, 4, 128, dtype=torch.float32), scale),
        "width 12": (meta(4, 12), meta(12)),
        "width 8200": (meta(4, 8200), meta(8200)),
        "rope width 24": (meta(1, 8, 2, 24), None, *meta_tables(8, 24)),
        "rope on 3-D": (meta(8, 4, 128), None, cos, sin),
        "f32 tables wrong T": (x, None, *meta_tables(16, 128)),
        "bf16 tables": (x, None, meta(8, 128), meta(8, 128)),
        "cos alone": (x, scale, cos, None),
        "nothing": (x, None, None, None),
    }[case]
    assert nr.norm_rule(*args) is not None


@pytest.fixture
def gloo_free_mesh():
    """A one-rank mesh on the CPU under torch's fake process group (no
    collectives run), torn down after."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        pytest.skip("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1,))
    finally:
        dist.destroy_process_group()


def test_the_rule_refuses_dtensors(gloo_free_mesh):
    from torch.distributed.tensor import DTensor, Replicate

    x = torch.zeros(2, 8, 4, 128, dtype=BF16)
    scale = torch.ones(128, dtype=BF16)
    dx = DTensor.from_local(x, gloo_free_mesh, [Replicate()])
    ds = DTensor.from_local(scale, gloo_free_mesh, [Replicate()])
    assert nr.norm_rule(x, scale) is None
    for args in ((dx, scale), (x, ds), (dx, ds)):
        assert "DTensor" in nr.norm_rule(*args)


class RecordingLibrary:
    """Stands in for the kernel library: records each C call (name and
    arguments) and reports success."""

    def __init__(self):
        self.calls = []
        calls = self.calls

        class Lib:
            def __getattr__(self, name):
                def entry(*args):
                    calls.append((name, args))
                    return 0
                return entry

        self.lib = Lib()

    def check(self, code, what):
        assert code == 0, what


SMS = 132


@pytest.fixture
def recorder(monkeypatch):
    rec = RecordingLibrary()
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(_build, "stream", lambda t: 7)
    monkeypatch.setattr(nr, "_sm_count", lambda index: SMS)
    return rec


@pytest.fixture
def addresses(monkeypatch):
    """Gives every tensor handed to C a distinct fake address (meta
    tensors all report 0); returns the address of a tensor (None for
    None)."""
    seen = {}

    def fake(t):
        if t is None:
            return None
        return 0x10000 * (1 + seen.setdefault(id(t), len(seen)))

    monkeypatch.setattr(nr, "_ptr", fake)
    return fake


# (shape, norm, rope, row threads): D's q and k, its hidden rows, A's
# hidden rows and rotations, and small rows.
ENTRY_CASES = [
    ((4, 8192, 32, 128), True, True, 8),
    ((4, 8192, 4, 128), True, True, 8),
    ((4, 8192, 2048), True, False, 256),
    ((4, 4096, 4096), True, False, 256),
    ((4, 4096, 32, 128), False, True, 8),
    ((4, 4096, 8, 128), False, True, 8),
    ((2, 8, 2, 32), True, False, 4),
    ((3, 8192), True, False, 256),
    ((5, 24), True, False, 4),
]


@pytest.mark.parametrize("shape,norm,rope,g", ENTRY_CASES, ids=str)
def test_the_forward_hands_c_its_operands_and_mapping(
        recorder, addresses, shape, norm, rope, g):
    x, scale = meta(*shape), meta(shape[-1]) if norm else None
    cos, sin = meta_tables(shape[1], shape[-1]) if rope else (None, None)
    d, rows = shape[-1], 1
    for n in shape[:-1]:
        rows *= n
    assert nr.row_threads(d, rope) == g
    before = nr.norm_rope_fwd.launches
    y, rstd = nr.norm_rope_fwd(x, scale, cos, sin, EPS)
    assert nr.norm_rope_fwd.launches == before + 1
    assert y.shape == x.shape and y.dtype == BF16
    assert rstd.shape == ((rows,) if norm else (0,))
    assert rstd.dtype == torch.float32
    [(name, args)] = recorder.calls
    assert name == "kctpu_norm_rope_fwd"
    assert len(args) == len(_build._SIGNATURES[name][0]) == 14
    blocks = min(-(-rows // (nr.THREADS // g)), nr.FWD_WAVES * SMS)
    heads, seq = (shape[2], shape[1]) if rope else (1, 1)
    assert args == (*map(addresses, (x, scale, cos, sin, y)),
                    addresses(rstd) if norm else None, rows, d, g, blocks,
                    heads, seq, EPS, 7)


@pytest.mark.parametrize("shape,norm,rope,g", ENTRY_CASES, ids=str)
def test_the_backward_hands_c_its_operands_and_mapping(
        recorder, addresses, shape, norm, rope, g):
    x, scale = meta(*shape), meta(shape[-1]) if norm else None
    cos, sin = meta_tables(shape[1], shape[-1]) if rope else (None, None)
    d = shape[-1]
    rows = x.numel() // d
    rstd = meta(rows if norm else 0, dtype=torch.float32)
    dy = meta(*shape)
    before = nr.norm_rope_bwd.launches
    dx, ds = nr.norm_rope_bwd(x, scale, cos, sin, rstd, dy)
    assert nr.norm_rope_bwd.launches == before + 1
    assert dx.shape == x.shape and dx.dtype == BF16
    assert (ds is None) == (not norm)
    [(name, args)] = recorder.calls
    assert name == "kctpu_norm_rope_bwd"
    assert len(args) == len(_build._SIGNATURES[name][0]) == 16
    blocks = min(-(-rows // (nr.THREADS // g)), nr.BWD_WAVES * SMS)
    heads, seq = (shape[2], shape[1]) if rope else (1, 1)
    partial = args[7]
    assert (partial is None) == (not norm)
    assert args[:7] == (addresses(x) if norm else None, addresses(scale),
                        addresses(rstd) if norm else None,
                        *map(addresses, (cos, sin, dy, dx)))
    assert args[8:] == (addresses(ds), rows, d, g, blocks, heads, seq, 7)


def test_the_model_hands_norm_rope_what_the_rule_takes(monkeypatch):
    calls = []

    def record(x, scale=None, cos=None, sin=None, eps=0.0):
        calls.append((x, scale, cos, sin, eps))
        return torch.empty_like(x)

    monkeypatch.setattr(nr, "norm_rope", record)
    x, h, scale = meta(2, 8, 4, 128), meta(2, 8, 512), meta(128)
    cos, sin = meta_tables(8, 128)
    tllama.rmsnorm(h, meta(512), EPS)
    tllama.rmsnorm(x, scale, EPS, (cos, sin))
    tllama.apply_rope(x, cos, sin)
    assert [(c[0].shape, c[1] is None, c[2] is cos, c[4]) for c in calls] == [
        ((2, 8, 512), False, False, EPS), ((2, 8, 4, 128), False, True, EPS),
        ((2, 8, 4, 128), True, True, 0.0)]
    calls.clear()
    # Off the CPU nothing keeps the plain composition: an f32 scale, a
    # strided view and a width the kernels refuse all reach norm_rope,
    # which prepares the first two and raises for the third.
    monkeypatch.setattr(nr, "rmsnorm_plain", None)
    monkeypatch.setattr(nr, "rope_plain", None)
    tllama.rmsnorm(h, meta(512, dtype=torch.float32), EPS)
    tllama.apply_rope(meta(2, 4, 8, 128).transpose(1, 2), cos, sin)
    tllama.rmsnorm(meta(2, 8, 12), meta(12), EPS)
    assert [tuple(c[0].shape) for c in calls] == [
        (2, 8, 512), (2, 8, 4, 128), (2, 8, 12)]


@pytest.fixture
def kernel_op(monkeypatch):
    """The op's kernel entry for meta tensors (whose dispatch would take
    the op's fake): ``norm_rope`` calls the wrapper as a card would."""
    monkeypatch.setattr(nr, "norm_rope_op",
                        lambda *args: nr.norm_rope_fwd(*args))


def test_an_f32_scale_and_a_strided_view_reach_the_kernel(
        recorder, addresses, kernel_op):
    h = meta(2, 8, 512)
    tllama.rmsnorm(h, meta(512, dtype=torch.float32), EPS)
    x = meta(2, 4, 8, 128).transpose(1, 2)
    cos, sin = meta_tables(8, 128)
    tllama.apply_rope(x, cos, sin)
    tllama.rmsnorm(x, meta(128, dtype=torch.float32), EPS, (cos, sin))
    assert [name for name, _ in recorder.calls] == ["kctpu_norm_rope_fwd"] * 3
    for _, args in recorder.calls:
        assert args[0] is not None and args[6:8] in ((16 * 512 // 512, 512),
                                                     (64, 128))


@pytest.mark.parametrize("case", ["f32 x", "width 12", "width 8200",
                                  "rope width 24", "f32 tables wrong T"])
def test_the_card_raises_for_what_the_kernels_cannot_take(
        recorder, kernel_op, case):
    cos, sin = meta_tables(8, 128)
    call = {
        "f32 x": lambda: tllama.rmsnorm(
            meta(2, 8, 64, dtype=torch.float32), meta(64), EPS),
        "width 12": lambda: tllama.rmsnorm(meta(2, 8, 12), meta(12), EPS),
        "width 8200": lambda: tllama.rmsnorm(meta(4, 8200), meta(8200), EPS),
        "rope width 24": lambda: tllama.apply_rope(
            meta(1, 8, 2, 24), *meta_tables(8, 24)),
        "f32 tables wrong T": lambda: tllama.apply_rope(
            meta(2, 8, 4, 128), *meta_tables(16, 128)),
    }[case]
    with pytest.raises(ValueError, match="norm_rope kernel"):
        call()
    assert recorder.calls == []


@pytest.mark.parametrize("norm", [False, True], ids=["rope", "norm+rope"])
def test_the_rotation_alone_saves_no_activation(norm):
    x, scale, _ = operands((2, 6, 3, 32), seed=4)
    cos, sin = tables(6, 32)
    x.requires_grad_()
    s = scale.clone().requires_grad_() if norm else None
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        nr.norm_rope(x, s, cos, sin, EPS)
    want = [(6, 32), (6, 32)]                    # cos and sin
    if norm:
        want = [(2, 6, 3, 32), (32,)] + want + [(36,)]   # x, scale, rstd
    assert saved == want


# ---------------------------------------------------------------------------
# A mesh step routed as on a card
# ---------------------------------------------------------------------------

# (id, (dp, fsdp, tp), sp, sp_attention, remat policy): the batch split
# (fsdp), the heads split (tp: q and k Shard(2)), the sequence split (sp:
# x Shard(1), the tables Shard(0)).
MESH_RUNS = (("fsdp2", (1, 2, 1), 1, "ring", "none"),
             ("tp2", (1, 1, 2), 1, "ring", "dots"),
             ("sp2-ring", (1, 1, 1), 2, "ring", "full"))


@pytest.mark.parametrize("axes,sp,attention,policy",
                         [r[1:] for r in MESH_RUNS],
                         ids=[r[0] for r in MESH_RUNS])
def test_a_mesh_step_routed_as_on_the_card_is_the_jax_step(
        axes, sp, attention, policy, tmp_path):
    import pickle

    import jax
    import numpy as np
    from kubeflow_controller_tpu.models.llama import \
        llama_init as jax_llama_init
    from kubeflow_controller_tpu.workloads import data as jax_data

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from _torch_ranks import start_ranks, wait_ranks
    from test_torch_mesh_train import (BATCH, GRAD_RTOL, LOSS_RTOL, SEQ,
                                       jax_config, jax_reference, np_tree,
                                       port_names)

    jcfg = jax_config(policy)
    params = jax_llama_init(jax.random.PRNGKey(0), jcfg)
    tokens = jax_data.synthetic_tokens(3, BATCH, SEQ, jcfg.vocab_size)
    src = tmp_path / "params.pkl"
    with open(src, "wb") as fh:
        pickle.dump((np_tree(params), np.asarray(tokens)), fh)
    out = str(tmp_path / "step.pt")
    dp, fsdp, tp = axes
    ranks = start_ranks(dp * fsdp * tp * sp, "step_norms", out,
                        *map(str, axes), policy, str(src), str(sp), attention)
    loss, grads, after, norm = jax_reference(jcfg, params, tokens)
    wait_ranks(ranks, timeout=240)
    got = torch.load(out, weights_only=False)

    # Each layer's two sublayer norms and q's and k's rotation, twice
    # under remat (the forward and its re-run), and the final norm.
    layers = jcfg.n_layers
    calls = got["norm_shard_calls"]
    assert len(calls) == (2 if policy != "none" else 1) * 4 * layers + 1
    split = {"fsdp2": "Shard(dim=0)", "tp2": "Shard(dim=2)",
             "sp2-ring": "Shard(dim=1)"}[next(
                 r[0] for r in MESH_RUNS if r[1:] == (axes, sp, attention,
                                                      policy))]
    assert any(split in placed for placed, _ in calls), calls
    assert abs(got["loss"] - loss) <= LOSS_RTOL * abs(loss)
    assert not got["grads_misplaced"], got["grads_misplaced"]
    assert abs(got["norm"] - norm) <= LOSS_RTOL * norm
    for kind, want in (("grads", grads), ("params", after)):
        want = port_names(want)
        assert got[kind].keys() == want.keys()
        for name, ref in want.items():
            err = np.max(np.abs(got[kind][name] - ref))
            assert err <= GRAD_RTOL * np.max(np.abs(ref)), (kind, name, err)


# ---------------------------------------------------------------------------
# The calls a training step makes
# ---------------------------------------------------------------------------

DENSE = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
             intermediate=96, max_seq_len=64, dtype="bfloat16",
             param_dtype="float32", remat=True, remat_policy="full")
# Trinity-Mini's pattern: windowed layers rotate, every fourth is global
# (no rotation); q/k norms and sublayer norms on every layer.
AFMOE = dict(DENSE, n_layers=4, n_heads=4, n_kv_heads=2, head_width=32,
             block="afmoe", window=12, global_every=4, dense_layers=1,
             n_experts=8, experts_held=4, moe_top_k=2, expert_intermediate=32,
             shared_experts=1, route_scale=2.826, bias_rate=0.05,
             moe_dispatch="grouped", moe_aux_coef=0.0, moe_z_coef=0.0,
             loss_chunks=2)
# (config, forward calls, backward calls, rotating forward calls) a step:
# each call of a layer runs twice under remat "full" (the forward and the
# re-run) and once backward; the final norm once each way.  Dense: 4 a
# layer (two sublayer norms, q's and k's rotation), 2 of them rotating.
# Trinity-Mini: 6 a layer (four sublayer norms, q's and k's norms), q's
# and k's rotating on the 3 windowed layers of 4.
STEPS = {"dense": (DENSE, 2 * 4 * 2 + 1, 4 * 2 + 1, 2 * 2 * 2),
         "afmoe": (AFMOE, 2 * 6 * 4 + 1, 6 * 4 + 1, 2 * 2 * 3)}
# The forced path differs from the plain one in the backward only: f32
# from the output's gradient to dx, where autograd rounds to bf16 at each
# of the plain chain's casts.  The largest leaf gap reads 2.6e-3 (dense)
# and 9.1e-3 (Trinity-Mini pattern, layer 0's wk), a few bf16 steps
# (2**-8 = 3.9e-3); both paths lie equally far from the gradients of the
# same model in f32 (worst leaf 9.7e-3 and 7.7e-2 either way), so the gap
# is rounding, not arithmetic.  2e-2 leaves twice the larger reading.
GRAD_RTOL = 2e-2


def train_step(cfg, seed=0):
    model = tllama.llama_init(cfg, torch.Generator().manual_seed(seed),
                              "cpu", requires_grad=True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(seed + 1))
    loss = tllama.llama_loss(model, tokens, cfg)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("name", sorted(STEPS))
def test_a_step_makes_the_predicted_fused_calls(monkeypatch, name):
    conf, fwd, bwd, rot = STEPS[name]
    cfg = tllama.LlamaConfig(**conf)
    torch.manual_seed(0)
    plain_loss, plain_grads = train_step(cfg)

    counts = {"fwd": 0, "bwd": 0, "rope": 0}
    real_fwd, real_bwd = nr.norm_rope_fwd, nr.norm_rope_bwd

    def fwd_spy(x, scale, cos, sin, eps):
        counts["fwd"] += 1
        counts["rope"] += cos is not None
        return real_fwd(x, scale, cos, sin, eps)

    def bwd_spy(*args):
        counts["bwd"] += 1
        return real_bwd(*args)

    # Route the CPU's tensors as the card's: the op's CPU kernel is the
    # plain pair, so the calls are counted where the card would launch.
    monkeypatch.setattr(nr, "on_card", lambda x: True)
    monkeypatch.setattr(nr, "norm_rope_fwd", fwd_spy)
    monkeypatch.setattr(nr, "norm_rope_bwd", bwd_spy)
    torch.manual_seed(0)
    loss, grads = train_step(cfg)
    assert counts == {"fwd": fwd, "bwd": bwd, "rope": rot}
    assert torch.equal(loss, plain_loss)
    for n, g in grads.items():
        gap = float((g - plain_grads[n]).norm()
                    / plain_grads[n].norm().clamp_min(1e-30))
        assert gap < GRAD_RTOL, (n, gap)


def test_generation_hands_the_card_only_what_it_takes(monkeypatch):
    """``generate`` and a paged decode step at scattered positions (the
    batch as the rotation's T axis, one table row a slot), routed as on a
    card: every call's operands are ones the kernels take, and the tokens
    and logits are the plain composition's."""
    import importlib

    tgen = importlib.import_module(
        "kubeflow_controller_tpu_torch.models.generate")
    cfg = tllama.LlamaConfig(**dict(DENSE, remat=False))
    model = tllama.llama_init(cfg, torch.Generator().manual_seed(5), "cpu")
    gen = torch.Generator().manual_seed(6)
    prompt = torch.randint(0, cfg.vocab_size, (3, 5), generator=gen)
    last = torch.randint(0, cfg.vocab_size, (3,), generator=gen)
    positions = torch.tensor([3, 9, 17])
    tables_ = torch.tensor([[1, 2, 3], [4, 5, 6], [7, 1, 2]])

    def run():
        tokens = tgen.generate(model, prompt, cfg, max_new_tokens=4)
        cache = tgen.init_paged_cache(cfg, 8, 8, device="cpu")
        logits, _ = tgen.paged_decode_step(model, last, cache, positions,
                                           tables_, cfg, 8)
        return tokens, logits

    plain = run()
    seen, real = [], nr.norm_rope_fwd

    def fwd_spy(x, scale, cos, sin, eps):
        seen.append((tuple(x.shape), nr.norm_rule(x, scale, cos, sin)))
        return real(x, scale, cos, sin, eps)

    monkeypatch.setattr(nr, "on_card", lambda x: True)
    monkeypatch.setattr(nr, "norm_rope_fwd", fwd_spy)
    routed = run()
    assert torch.equal(routed[0], plain[0])
    assert torch.equal(routed[1], plain[1])
    assert [r for _, r in seen if r is not None] == []
    # decode's transposed q and k: [1, B, H, D] against [B, D] tables
    assert (1, 3, cfg.n_heads, cfg.head_dim) in [sh for sh, _ in seen]
    assert (1, 3, cfg.n_kv_heads, cfg.head_dim) in [sh for sh, _ in seen]


# ---------------------------------------------------------------------------
# The kernels' names
# ---------------------------------------------------------------------------

PROFILED = [
    "void (anonymous namespace)::norm_rope_fwd_kernel<true, true, 1>("
    "__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, float "
    "const*, __nv_bfloat16*, float*, long long, int, float, int, int, int, "
    "float)",
    "void (anonymous namespace)::norm_rope_bwd_kernel<true, false, 2>("
    "__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, float "
    "const*, float const*, __nv_bfloat16 const*, __nv_bfloat16*, float*, "
    "long long, int, float, int, int, int)",
    "(anonymous namespace)::norm_scale_grad_kernel(float const*, int, int, "
    "__nv_bfloat16*)",
]


@pytest.mark.parametrize("name", PROFILED, ids=["fwd", "bwd", "scale_grad"])
def test_the_kernels_are_read_as_elementwise_work(name):
    assert trace.group_of(name) == "other"
    group = next(g for g, match in chip_smoke.KERNEL_GROUPS if match(name))
    assert group == "elementwise/copy"


def test_ptxas_report_names_the_norm_rope_kernels():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__559b89cf_"
        "12_norm_rope_cu_2721ee6d20norm_rope_fwd_kernelILb1ELb1ELi1EEEvPK13"
        "__nv_bfloat16S3_PKfS5_PS1_Pfxifiiif' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 90 registers, used 1 barriers, 32 bytes smem",
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__559b89cf_"
        "12_norm_rope_cu_2721ee6d22norm_scale_grad_kernelEPKfiiP13__nv_bfloat"
        "16' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers, used 1 barriers, 1056 bytes smem",
    ])
    assert chip_smoke.ptxas_report(log) == {
        "norm_rope_fwd_kernel<1, 1, 1>": [90, 0, 0],
        "norm_scale_grad_kernel": [32, 0, 0]}


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the norm_rope kernels run only "
                    "there")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("case", chip_smoke.NORM_ROPE_EDGES
                         + chip_smoke.NORM_ROPE_CASES, ids=lambda c: c[0])
def test_the_kernels_are_the_plain_versions_on_the_card(cuda, case):
    name, shape, norm, rope = case
    gen = torch.Generator(device=cuda).manual_seed(29)
    chip_smoke.norm_rope_case(name, shape, norm, rope, gen, cuda, False)
    torch.cuda.empty_cache()
