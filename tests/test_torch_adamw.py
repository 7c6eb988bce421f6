"""The one-pass AdamW update (``ops/adamw.py``, ``csrc/adamw.cu``) and
``trainer.FusedAdamW``, which ``default_optimizer`` builds.

On the CPU:

- ``adamw_step_plain`` with the clip's scale, hit and not hit, follows the
  in-place clip plus ``torch.optim.AdamW`` over three steps at weight
  decay 0.1;
- ``Optimizer.step`` with ``default_optimizer`` on CPU parameters gives
  the bits the in-place clip plus ``torch.optim.AdamW`` gave;
- a ``FusedAdamW`` state dict loads into ``torch.optim.AdamW`` and back.

On the card (marker ``card``; they skip without CUDA; run them there with
``python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_adamw.py``,
since ``conftest.py`` imports JAX, which the card's host does not have):

- the kernel against ``adamw_step_plain`` at ragged sizes (1, 7, 4097), a
  misaligned view, a norm's scale (4096) and one of Mixtral-8x7B's expert
  tensors ([8, 4096, 14336]), f32 and bf16: p's update (p - p0), m and v,
  at draws whose update is many steps of p's storage type, so that a
  kernel which leaves p unchanged fails;
- two runs of the kernel bit-identical;
- a step captured in a CUDA graph with capturable groups against the same
  steps run eagerly;
- one ``default_optimizer`` step of a tiny Llama: one launch a parameter
  tensor and no foreach kernel.
"""

import copy
import math

import pytest
import torch

from kubeflow_controller_tpu_torch.models import llama
from kubeflow_controller_tpu_torch.ops import adamw
from kubeflow_controller_tpu_torch.workloads import trainer

LR, BETAS, EPS, WD = 3e-4, (0.9, 0.999), 1e-8, 0.1
HYPER = dict(lr=LR, betas=BETAS, eps=EPS, weight_decay=WD)
SHAPES = [(7,), (33, 5), (4097,), (1,)]

# The plain update against torch's AdamW on the CPU.  The two run the same
# f32 operations, but not always in one order (torch's single-tensor
# ``addcmul_`` rounds (1 - b2) g before g², the kernel's order and the
# foreach chain's g² first), and a compiler may contract a product and a
# sum into one fma: a few roundings of each value, never more.
PLAIN_RTOL = 4 * torch.finfo(torch.float32).eps


def _params(seed=0, shapes=SHAPES):
    gen = torch.Generator().manual_seed(seed)
    return [torch.nn.Parameter(torch.randn(s, generator=gen)) for s in shapes]


def _grads(params, step, scale):
    gen = torch.Generator().manual_seed(100 + step)
    return [torch.randn(p.shape, generator=gen) * scale for p in params]


def _clip_scale(grads, clip=1.0):
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    hit = norm >= clip
    return bool(hit), (torch.where(hit, norm, 1.0),
                       torch.where(hit, clip, 1.0))


def _assert_near(got, want, rtol):
    """Every element within ``rtol`` of the largest magnitude of ``want``."""
    scale = float(want.abs().max()) or 1.0
    err = float((got.float() - want.float()).abs().max())
    assert err <= rtol * scale, (err, rtol * scale)


@pytest.mark.parametrize("grad_scale,hit", [(3.0, True), (0.01, False)])
def test_plain_is_the_inplace_clip_then_torch_adamw(grad_scale, hit):
    ref = _params()
    mine = [p.detach().clone() for p in ref]
    ms = [torch.zeros_like(p) for p in mine]
    vs = [torch.zeros_like(p) for p in mine]
    torch_opt = torch.optim.AdamW(ref, **HYPER)
    for step in (1, 2, 3):
        grads = _grads(ref, step, grad_scale)
        got_hit, (div, mul) = _clip_scale(grads)
        assert got_hit == hit
        for p, g in zip(ref, grads):
            p.grad = g.clone().div_(div).mul_(mul)
        torch_opt.step()
        for p, g, m, v in zip(mine, grads, ms, vs):
            adamw.adamw_step_plain(p, g, m, v, **HYPER, step=step,
                                   grad_scale=(div, mul))
    for p, mp, m, v in zip(ref, mine, ms, vs):
        state = torch_opt.state[p]
        _assert_near(mp, p.detach(), PLAIN_RTOL)
        _assert_near(m, state["exp_avg"], PLAIN_RTOL)
        _assert_near(v, state["exp_avg_sq"], PLAIN_RTOL)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    p, g = torch.randn(4097), torch.randn(4097)
    m, v = torch.randn(4097) * 0.1, torch.rand(4097) * 0.01
    want = [t.clone() for t in (p, m, v)]
    before = adamw.adamw_step.launches
    adamw.adamw_step(p, g, m, v, **HYPER, step=3)
    adamw.adamw_step_plain(*want[:1], g, *want[1:], **HYPER, step=3)
    assert adamw.adamw_step.launches == before
    for got, w in zip((p, m, v), want):
        assert torch.equal(got, w)
    with pytest.raises(ValueError, match="CUDA only"):
        adamw.adamw_step(p, g, m, v, **HYPER, step=4,
                         device_step=torch.tensor(4.0))


@pytest.mark.parametrize("grad_scale", [3.0, 0.01])
def test_optimizer_step_on_the_cpu_is_the_inplace_clip_and_adamw(grad_scale):
    fused_params, plain_params = _params(1), _params(1)
    fused = trainer.default_optimizer(fused_params, LR, weight_decay=WD)
    plain = trainer.Optimizer(
        plain_params, lambda ps: torch.optim.AdamW(ps, **HYPER), clip=1.0)
    assert isinstance(fused.inner, trainer.FusedAdamW)
    for step in (1, 2, 3):
        grads = _grads(fused_params, step, grad_scale)
        for opt in (fused, plain):
            for p, g in zip(opt.params, grads):
                p.grad = g.clone()
            opt.step()
        for a, b in zip(fused_params, plain_params):
            assert torch.equal(a.grad, b.grad)    # clipped in place on both
            assert torch.equal(a, b)
    for a, b in zip(fused.inner.state.values(), plain.inner.state.values()):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_fused_state_dict_loads_into_torch_adamw_and_back():
    params = _params(2)
    fused = trainer.FusedAdamW(params, **HYPER)
    for step in (1, 2):
        for p, g in zip(params, _grads(params, step, 1.0)):
            p.grad = g
        fused.step()
    saved = copy.deepcopy(fused.state_dict())
    plain = torch.optim.AdamW(params, lr=1.0)
    plain.load_state_dict(saved)
    again = trainer.FusedAdamW(params, lr=1.0)
    again.load_state_dict(copy.deepcopy(plain.state_dict()))
    for opt in (plain, again):
        got = opt.state_dict()
        assert got["param_groups"] == saved["param_groups"]
        for i, st in saved["state"].items():
            assert got["state"][i].keys() == st.keys()
            assert all(torch.equal(got["state"][i][k], st[k]) for k in st)
    # Each steps on from the restored state as AdamW would.
    for p, g in zip(params, _grads(params, 3, 1.0)):
        p.grad = g
    before = [p.detach().clone() for p in params]
    again.step()
    after = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p, b in zip(params, before):
            p.copy_(b)
    plain.step()
    for a, p in zip(after, params):
        assert torch.equal(a, p.detach())


def test_fused_adamw_refuses_a_grad_scale_on_the_cpu():
    params = _params(3)
    opt = trainer.FusedAdamW(params, **HYPER)
    for p in params:
        p.grad = torch.ones_like(p)
    with pytest.raises(ValueError, match="CUDA"):
        opt.step(grad_scale=(torch.tensor(2.0), torch.tensor(1.0)))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the AdamW kernel runs only there")
    return torch.device("cuda", 0)


# Kernel against plain on the card, both f32 in registers: the compiler may
# contract the kernel's products and sums into fmas where the plain version
# rounds in between, a few roundings of each value.  bf16 storage: each
# value is rounded once at its store, so such a difference may tip it by
# one bf16 step (2^-8 of the value).
CARD_RTOL = {torch.float32: 8 * torch.finfo(torch.float32).eps,
             torch.bfloat16: 2.0 ** -7}
# The learning rate of the kernel checks: the update is ~lr a step, which
# at bf16 must be many steps of the largest p (|p| < 0.1: 2^-11 ~ 5e-4).
CARD_LR = {torch.float32: LR, torch.bfloat16: 1e-2}


def _ulp(x: float, dtype) -> float:
    """One step of ``dtype`` at the magnitude ``x``."""
    return torch.finfo(dtype).eps * 2.0 ** math.floor(math.log2(x))


def _assert_update_near(got, want, p0):
    """The updates ``got - p0`` and ``want - p0`` within one step of the
    storage type at the largest |p| (each side rounds its new p once at
    its store, so the two may round to neighbours) plus a few f32
    roundings of the largest update (the update is f32 in registers on
    both sides); the f32 subtractions add at most half an f32 step of the
    largest update, inside the bound.  Where p has more than one element,
    the largest update must be more than 4 steps of the storage type, so
    that a kernel leaving p unchanged fails (a single element's update
    may fall near 0 by its draw)."""
    biggest = max(float(t.abs().max()) for t in (p0, got, want))
    step = _ulp(biggest, got.dtype)
    upd_want = want.float() - p0.float()
    most = float(upd_want.abs().max())
    err = float((got.float() - p0.float() - upd_want).abs().max())
    if p0.numel() > 1:
        assert most > 4 * step, (most, step)
    bound = step + CARD_RTOL[torch.float32] * most
    assert err <= bound, (err, bound)


def _state(shape, dtype, dev, seed, offset=0):
    """(p, g, m, v) on ``dev``, ``offset`` elements into their storage."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = int(torch.Size(shape).numel())

    def draw(scale, positive=False):
        x = torch.randn(n + offset, generator=gen, device=dev) * scale
        x = x.abs() if positive else x
        return x.to(dtype)[offset:].view(shape)

    return draw(0.02), draw(1.0), draw(1e-2), draw(1e-4, positive=True)


def _check_kernel(shape, dtype, dev, scale, offset=0, step=3):
    p, g, m, v = _state(shape, dtype, dev, seed=7, offset=offset)
    p0 = p.clone()
    want = [t.clone() for t in (p, m, v)]
    grad_scale = None
    if scale:
        grad_scale = (torch.tensor(scale, device=dev),
                      torch.tensor(1.0, device=dev))
    hyper = dict(HYPER, lr=CARD_LR[dtype])
    before = adamw.adamw_step.launches
    adamw.adamw_step(p, g, m, v, **hyper, step=step, grad_scale=grad_scale)
    adamw.adamw_step_plain(want[0], g, want[1], want[2], **hyper, step=step,
                           grad_scale=grad_scale)
    torch.cuda.synchronize()
    assert adamw.adamw_step.launches == before + 1
    rtol = CARD_RTOL[dtype]
    _assert_update_near(p, want[0], p0)
    _assert_near(m, want[1], rtol)
    _assert_near(v, want[2], rtol)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", [((1,), 0), ((7,), 0),
                                          ((4097,), 0), ((4097,), 1),
                                          ((4096,), 0)])
@pytest.mark.parametrize("scale", [None, 37.5])
def test_kernel_is_the_plain_version(cuda, dtype, shape, offset, scale):
    _check_kernel(shape, dtype, cuda, scale, offset)


@pytest.mark.card
def test_kernel_on_a_mixtral_expert_tensor(cuda):
    _check_kernel((8, 4096, 14336), torch.float32, cuda, 12.25)
    torch.cuda.empty_cache()


@pytest.mark.card
def test_kernel_is_bit_identical_across_runs(cuda):
    runs = []
    for _ in range(2):
        p, g, m, v = _state((3, 1000003), torch.float32, cuda, seed=11)
        for step in (1, 2, 3):
            adamw.adamw_step(p, g, m, v, **HYPER, step=step)
        runs.append((p, m, v))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _tiny_model(dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return llama.llama_init(llama.LlamaConfig.tiny(), gen, dev,
                            requires_grad=True)


@pytest.mark.card
def test_a_captured_capturable_step_is_the_eager_one(cuda):
    """Three clipped steps replayed from one CUDA graph (capturable groups:
    the step count and the bias corrections on the device) against the
    same three steps run eagerly, capturable too: the same kernels on the
    same values, so the same bits; and against host-counted steps, whose
    bias corrections the host forms, to f32 rounding."""
    params = {}
    for side in ("graph", "eager", "host"):
        model = _tiny_model(cuda, seed=3)
        params[side] = list(model.parameters())
    grads = [[torch.randn(p.shape, device=cuda) * s for p in params["graph"]]
             for s in (4.0, 0.001, 4.0)]
    opts = {side: trainer.default_optimizer(ps, LR, weight_decay=WD)
            for side, ps in params.items()}
    for side in ("graph", "eager"):
        for group in opts[side].inner.param_groups:
            group["capturable"] = True
    # Eager steps, the first of them making each side's state.
    for side in ("eager", "host"):
        for gs in grads:
            for p, g in zip(params[side], gs):
                p.grad = g.clone()
            opts[side].step()
    # The graph reads its gradients by address: fixed tensors, refilled.
    static = [g.clone() for g in grads[0]]
    for p, s in zip(params["graph"], static):
        p.grad = s
    opts["graph"].step()            # makes the state outside the graph
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=stream):
        opts["graph"].step()
    for gs in grads[1:]:
        for s, g in zip(static, gs):
            s.copy_(g)
        graph.replay()
    torch.cuda.synchronize()
    steps = {float(st["step"]) for st in opts["graph"].inner.state.values()}
    assert steps == {3.0}
    for a, b, c in zip(params["graph"], params["eager"], params["host"]):
        assert torch.equal(a, b)
        _assert_near(a.detach(), c.detach(), CARD_RTOL[torch.float32])
    for sa, sb in zip(opts["graph"].inner.state.values(),
                      opts["eager"].inner.state.values()):
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])


@pytest.mark.card
def test_default_optimizer_launches_the_kernel_and_no_foreach(cuda):
    cfg = llama.LlamaConfig.tiny()
    model = _tiny_model(cuda, seed=5)
    opt = trainer.default_optimizer(model.parameters(), LR, weight_decay=WD)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(5))
    llama.llama_loss(model, tokens, cfg).backward()
    grads = [p.grad.clone() for p in model.parameters()]
    before = adamw.adamw_step.launches
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        opt.step()
        torch.cuda.synchronize()
    launches = adamw.adamw_step.launches - before
    n_tensors = len(list(model.parameters()))
    assert launches == n_tensors                # one a parameter tensor
    kernels = [e.name() for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert any("adamw_kernel" in k for k in kernels), kernels
    assert not any("multi_tensor_apply" in k for k in kernels), kernels
    # The fused path leaves .grad as the backward made it.
    for p, g in zip(model.parameters(), grads):
        assert torch.equal(p.grad, g)
