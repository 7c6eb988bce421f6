"""The MoE layer's grouped layout (``ops/moe_layout.py``,
``csrc/moe_layout.cu``), which ``models/moe.py:grouped_layout`` builds.

On the CPU:

- the wrapper takes the plain version for CPU tensors, launches nothing
  and leaves its counter alone;
- the plain version is a stable sort of the slots by group (an oracle
  written without a cumsum), unsharded, as a first shard and as a middle
  shard, at ragged sizes (the layouts of the reference's routings:
  ``tests/test_torch_moe.py``);
- the wrapper hands C the sizes it was given, allocates what the module's
  docstring says, counts one layout a call, and refuses what the kernel
  does not take (more than ``MAX_GROUPS`` groups, other index types, a
  ``bm`` that does not divide the slots) before any launch.

On the card (marker ``card``; they skip without CUDA; run them there with
``python3 -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_moe_layout.py``): the kernel equals the plain version
element by element on ``dest``, ``tile_experts``, ``inv_src``,
``inv_pos`` and ``valid_tiles`` at Mixtral-8x7B's layout (16,384 slots, 8
experts, bm 256), at one card's share of Trinity-Mini (B 4 x T 8192, top 8
of 128 from a seeded sigmoid routing, 64 held, from expert 0 and from
expert 64), on a 16-slot decode layout, with every slot on one expert and
experts without a slot, at slot counts that no unit of the kernel divides,
and at ``MAX_GROUPS``; two calls give the same bits.
"""

import numpy as np
import pytest
import torch

from kubeflow_controller_tpu_torch.models import moe
from kubeflow_controller_tpu_torch.ops import _build
from kubeflow_controller_tpu_torch.ops import moe_layout as ml
from test_torch_afmoe import _Recorder

FIELDS = ("dest", "tile_experts", "inv_src", "inv_pos", "valid_tiles")


def sorted_layout(idx: np.ndarray, n_experts: int, bm: int, first=None):
    """The layout from a stable sort of the slots by group: a slot's rank
    is its place among its group's slots in sorted order; a tile's owner
    the group whose padded rows hold its first row."""
    k = idx.shape[-1]
    flat = idx.reshape(-1)
    n = flat.size
    n_tok = n // k
    groups = n_experts + (first is not None)
    g = flat if first is None else np.where(
        (flat >= first) & (flat < first + n_experts), flat - first,
        n_experts)
    counts = np.bincount(g, minlength=groups)
    order = np.argsort(g, kind="stable")
    place = np.empty(n, np.int64)
    place[order] = np.arange(n)
    rank = place - (np.cumsum(counts) - counts)[g]
    padded = -(-counts // bm) * bm
    off = np.concatenate([[0], np.cumsum(padded)[:-1]])
    m = n + groups * bm
    dest = off[g] + rank
    inv_src = np.full(m, n_tok)
    inv_pos = np.full(m, n)
    inv_src[dest] = np.where(g < n_experts, np.arange(n) // k, n_tok)
    inv_pos[dest] = np.arange(n)
    owner = np.full(m // bm, n_experts - 1)
    for e in range(groups):
        tiles = slice(off[e] // bm, (off[e] + padded[e]) // bm)
        owner[tiles] = min(e, n_experts - 1)
    valid = (None if first is None else
             np.array([(off[n_experts - 1] + padded[n_experts - 1]) // bm]))
    return dest, owner, inv_src, inv_pos, valid


def assert_same(got, want, dtypes=True):
    for name, a, b in zip(FIELDS, got, want):
        if b is None:
            assert a is None, name
            continue
        a = a.cpu() if isinstance(a, torch.Tensor) else torch.from_numpy(a)
        b = b.cpu() if isinstance(b, torch.Tensor) else torch.from_numpy(b)
        if dtypes:
            assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


def halved(n_slots, bm):
    while n_slots % bm:
        bm //= 2
    return bm


# (shape of idx, experts routed over, experts held, first held, bm)
CPU_CASES = [
    ((2, 16, 2), 4, 4, None, 256),
    ((2, 16, 2), 4, 2, 0, 8),
    ((2, 16, 2), 4, 2, 1, 8),
    ((1, 75, 4), 16, 8, 4, 256),
    ((3, 67, 1), 5, 5, None, 16),
    ((1, 16, 8), 128, 64, 64, 16),
]


@pytest.mark.parametrize("shape,routed,held,first,bm", CPU_CASES)
def test_plain_version_is_a_stable_sort_of_the_slots(shape, routed, held,
                                                     first, bm):
    idx = np.random.default_rng(sum(shape) + routed).integers(0, routed,
                                                              shape)
    bm = halved(idx.size, bm)
    got = ml.moe_layout_plain(torch.from_numpy(idx), held, bm, first)
    assert_same(got, sorted_layout(idx, held, bm, first), dtypes=False)
    assert [t.dtype for t in got[:4]] == [torch.long, torch.int32,
                                          torch.long, torch.long]
    if first is not None:
        assert got[4].dtype == torch.int32 and got[4].shape == (1,)


def test_cpu_takes_the_plain_version_and_launches_nothing(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was asked for on the CPU")

    monkeypatch.setattr(_build, "library", refuse)
    idx = torch.from_numpy(np.random.default_rng(1).integers(0, 8,
                                                             (2, 32, 2)))
    before = ml.moe_layout.launches
    for held, first in ((8, None), (4, 2)):
        assert_same(ml.moe_layout(idx, held, 16, first),
                    ml.moe_layout_plain(idx, held, 16, first))
        lay = moe.grouped_layout(idx, held, 256, first)
        assert (lay.bm, lay.m) == (128, 128 + (held + (first is not None))
                                   * 128)
        assert_same([getattr(lay, f) for f in FIELDS],
                    ml.moe_layout_plain(idx, held, 128, first))
    assert ml.moe_layout.launches == before


@pytest.mark.parametrize("first", [None, 0, 64])
def test_the_wrapper_hands_c_the_layout(monkeypatch, first):
    rec = _Recorder()
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(_build, "stream", lambda t: 7)
    idx = torch.empty(4, 8192, 8, dtype=torch.long, device="meta")
    before = ml.moe_layout.launches
    dest, te, inv_src, inv_pos, vt = ml.moe_layout(idx, 64, 256, first)
    assert ml.moe_layout.launches == before + 1
    (name, args), = rec.calls
    assert name == "kctpu_moe_layout"
    assert len(args) == len(_build._SIGNATURES[name][0])
    n, groups = 4 * 8192 * 8, 64 + (first is not None)
    m = n + groups * 256
    assert args[7:] == (n, 8, 64, first or 0, 256, 7)
    assert (args[6] is None) == (first is None)
    assert dest.shape == (n,) and dest.dtype == torch.long
    assert te.shape == (m // 256,) and te.dtype == torch.int32
    assert inv_src.shape == inv_pos.shape == (m,)
    assert inv_src.dtype == inv_pos.dtype == torch.long
    assert (vt is None) == (first is None)


@pytest.mark.parametrize("n_experts,first", [(ml.MAX_GROUPS + 1, None),
                                             (ml.MAX_GROUPS, 0),
                                             (4096, 512)])
def test_the_wrapper_refuses_more_groups_than_the_kernel_holds(
        monkeypatch, n_experts, first):
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("launched"))
    idx = torch.empty(2, 64, 2, dtype=torch.long, device="meta")
    before = ml.moe_layout.launches
    with pytest.raises(ValueError, match=f"at most {ml.MAX_GROUPS} groups"):
        ml.moe_layout(idx, n_experts, 256, first)
    assert ml.moe_layout.launches == before


def test_the_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("launched"))
    idx = torch.empty(2, 64, 2, dtype=torch.long, device="meta")
    with pytest.raises(TypeError, match="int64"):
        ml.moe_layout(idx.int(), 8, 256)
    with pytest.raises(ValueError, match="power of two dividing"):
        ml.moe_layout(idx, 8, 512)
    with pytest.raises(ValueError, match="power of two dividing"):
        ml.moe_layout(idx, 8, 24)
    with pytest.raises(ValueError, match="a slot"):
        ml.moe_layout(idx[:, :0], 8, 1)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the layout kernel runs only there")
    return torch.device("cuda", 0)


def _kernel_is_plain(idx, n_experts, bm, first=None):
    """The kernel's layout against the plain version's, element by
    element and dtype by dtype, and a second launch against the first."""
    bm = halved(idx.numel(), bm)
    before = ml.moe_layout.launches
    got = ml.moe_layout(idx, n_experts, bm, first)
    again = ml.moe_layout(idx, n_experts, bm, first)
    torch.cuda.synchronize()
    assert ml.moe_layout.launches == before + 2
    assert_same(got, ml.moe_layout_plain(idx, n_experts, bm, first))
    assert_same(again, got)
    return got


def _uniform(cuda, shape, high, seed):
    gen = torch.Generator(cuda).manual_seed(seed)
    return torch.randint(0, high, shape, generator=gen, device=cuda)


@pytest.mark.card
def test_kernel_at_mixtral_layout(cuda):
    gen = torch.Generator(cuda).manual_seed(0)
    logits = torch.randn(2, 4096, 8, generator=gen, device=cuda)
    idx = moe.router_topk(logits, 2)[1]
    _kernel_is_plain(idx, 8, 256)


@pytest.mark.card
@pytest.mark.parametrize("first", [0, 64])
def test_kernel_at_trinity_mini_share(cuda, first):
    gen = torch.Generator(cuda).manual_seed(1)
    x = torch.randn(4, 8192, 2048, generator=gen, device=cuda).to(
        torch.bfloat16)
    router = (torch.randn(2048, 128, generator=gen, device=cuda) * 0.02
              ).to(torch.bfloat16)
    with torch.no_grad():
        _, idx = moe._route_sigmoid(x, router, torch.zeros(128, device=cuda),
                                    8, 2.826, 0.0)
    _kernel_is_plain(idx, 64, 256, first)


@pytest.mark.card
@pytest.mark.parametrize("first", [None, 4])
def test_kernel_at_a_decode_layout(cuda, first):
    _kernel_is_plain(_uniform(cuda, (8, 1, 2), 8, 2), 4 if first else 8, 16,
                     first)


@pytest.mark.card
@pytest.mark.parametrize("first", [None, 0, 3])
def test_kernel_with_every_slot_on_one_expert(cuda, first):
    idx = torch.full((3, 1000, 2), 3, dtype=torch.long, device=cuda)
    _kernel_is_plain(idx, 8, 256, first)


@pytest.mark.card
@pytest.mark.parametrize("first", [None, 16])
def test_kernel_with_experts_left_empty(cuda, first):
    idx = _uniform(cuda, (2, 2048, 4), 8, 3) * 4 + 16     # every 4th expert
    _kernel_is_plain(idx, 48 if first is None else 16, 256, first)


@pytest.mark.card
@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 7, 3), (1, 255, 1),
                                   (1, 257, 1), (3, 683, 8), (1, 2049, 2),
                                   (5, 4099, 4)])
def test_kernel_at_slot_counts_no_unit_divides(cuda, shape):
    idx = _uniform(cuda, shape, 16, sum(shape))
    _kernel_is_plain(idx, 16, 256)
    _kernel_is_plain(idx, 8, 256, 8)


@pytest.mark.card
@pytest.mark.parametrize("n_experts,first", [(ml.MAX_GROUPS, None),
                                             (ml.MAX_GROUPS - 1, 1)])
def test_kernel_at_the_group_limit(cuda, n_experts, first):
    idx = _uniform(cuda, (2, 3000, 8), ml.MAX_GROUPS + 1, 5)
    if first is None:
        idx = idx.clamp_(max=n_experts - 1)
    _kernel_is_plain(idx, n_experts, 64, first)
