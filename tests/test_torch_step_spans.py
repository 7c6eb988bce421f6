"""The port's step spans (``obs/trace.py:step_span``) in a training step,
and ``portbench/spans.py``'s attribution of the step's work to them.

On ``LlamaConfig.tiny`` (attention "flash": the kernels' plain versions),
dense and with 4 experts on the grouped dispatch, under remat "full" and
one named policy, and an "afmoe" block (a dense then a MoE layer, a
windowed then a global one, sigmoid routing over 8 experts with 4 held
and a shared expert) under "full", steps of
``llama_pretrain.train_step``:

- under ``torch.profiler`` every span opens, in the forward and again in
  the remat re-run;
- ``portbench/spans.py`` over the CPU profile, each leaf aten op standing
  in for a kernel, puts every op of the steps down to a span and a pass,
  with a non-empty remat pass;
- with no profiler, no ``record_function`` is entered;
- the profiler changes no loss, gradient, parameter or kernel call.
"""

import collections
import contextlib
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from kubeflow_controller_tpu_torch.models import llama as tllama
from kubeflow_controller_tpu_torch.obs import trace as ttrace
from kubeflow_controller_tpu_torch.ops import attention as tat
from kubeflow_controller_tpu_torch.ops import grouped_matmul as tgm
from kubeflow_controller_tpu_torch.workloads.llama_pretrain import train_step
from kubeflow_controller_tpu_torch.workloads.trainer import default_optimizer
from portbench import spans, trace

torch.set_num_threads(2)

SEQ = 64
DENSE = ("kctpu.step", "kctpu.embed", "kctpu.layer", "kctpu.norm",
         "kctpu.rope", "kctpu.attention", "kctpu.ffn", "kctpu.cast",
         "kctpu.head", "kctpu.loss", "kctpu.optimizer", "kctpu.clip")
MOE = DENSE + ("kctpu.moe.route", "kctpu.moe.dispatch",
               "kctpu.moe.experts", "kctpu.moe.combine")
CASES = {
    "dense-full": (dict(), "full"),
    "dense-dots": (dict(), "dots"),
    "moe-full": (dict(n_experts=4, moe_dispatch="grouped"), "full"),
    "moe-moe": (dict(n_experts=4, moe_dispatch="grouped"), "moe"),
    "afmoe-full": (dict(block="afmoe", head_width=32, window=16,
                        global_every=2, dense_layers=1, n_experts=8,
                        experts_held=4, moe_top_k=2, moe_dispatch="grouped",
                        expert_intermediate=32, shared_experts=1,
                        route_scale=2.826,
                        bias_rate=1e-3), "full"),
}
# The re-run of a layer under each policy: every span of the layer opens
# again (a policy keeps some outputs, never a span).
REMAT = ("kctpu.layer", "kctpu.norm", "kctpu.rope", "kctpu.attention",
         "kctpu.ffn", "kctpu.cast")
# Plain versions of the kernels, counted as the CPU runs them.
PLAIN = {"flash_fwd": (tat, "flash_fwd_plain"),
         "flash_dq": (tat, "flash_dq_plain"),
         "flash_dkv": (tat, "flash_dkv_plain"),
         "gmm_swiglu": (tgm, "gmm_swiglu_plain"),
         "gmm": (tgm, "gmm_plain"), "tgmm": (tgm, "tgmm_plain")}
# Ops that make a view or allocate: no kernel on a card.
NO_KERNEL = frozenset({"aten::detach", "aten::view", "aten::as_strided",
                       "aten::empty", "aten::empty_strided", "aten::t",
                       "aten::transpose", "aten::expand", "aten::alias",
                       "aten::resolve_conj", "aten::resolve_neg",
                       "aten::unsqueeze", "aten::slice", "aten::select",
                       "aten::permute", "aten::_reshape_alias",
                       "aten::_unsafe_view", "aten::lift_fresh"})


def _setup(case):
    overrides, policy = CASES[case]
    cfg = tllama.LlamaConfig.tiny(attention="flash", remat=True,
                                  remat_policy=policy, **overrides)
    model = tllama.llama_init(cfg, torch.Generator().manual_seed(0), "cpu",
                              requires_grad=True)
    opt = default_optimizer(model.parameters(), 1e-3, weight_decay=0.1)
    tokens = torch.randint(0, cfg.vocab_size, (2, SEQ),
                           generator=torch.Generator().manual_seed(1))
    return cfg, model, opt, tokens


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the calls of the kernels' plain versions."""
    counts = collections.Counter()
    for name, (mod, attr) in PLAIN.items():
        def counted(*args, _real=getattr(mod, attr), _name=name, **kwargs):
            counts[_name] += 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(mod, attr, counted)
    return counts


def _profiled_steps(case, steps=2):
    cfg, model, opt, tokens = _setup(case)
    train_step(model, opt, tokens, cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(steps):
            with record_function(trace.STEP_RANGE):
                train_step(model, opt, tokens, cfg)
    return spans.host_ranges(prof)


def _leaf_ops(host):
    """Each op with no op inside it on its thread, views and allocations
    left out, as a kernel launched at its start."""
    by = collections.defaultdict(list)
    for r in host:
        if (r.name.startswith(("aten::", "kctpu::"))
                and r.name not in NO_KERNEL):
            by[r.thread].append(r)
    out = []
    for th, ops in by.items():
        ops.sort(key=lambda r: (r.start, -r.end))
        for r, nxt in zip(ops, ops[1:] + [None]):
            if nxt is None or nxt.start >= r.end:
                out.append(spans.Kernel(r.name, r.start, r.end, r.start,
                                        th))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_every_op_of_the_step_has_a_span_and_a_pass(case):
    host = _profiled_steps(case)
    want = MOE if "moe" in case else DENSE
    assert set(want) <= {r.name for r in host}
    kernels = _leaf_ops(host)
    st = spans.attribute(kernels, host, steps=2)
    lo = min(r.start for r in host if r.name == trace.STEP_RANGE)
    assert st is not None
    assert st.kernel_us == pytest.approx(
        sum(k.end - k.start for k in kernels if k.start >= lo))
    assert st.unattributed_us == 0 and st.coverage == 1.0
    passes = st.pass_ms()
    assert all(passes[p] > 0 for p in spans.PASSES), passes
    owned = collections.defaultdict(set)
    for (span, pass_, _), us in st.us.items():
        owned[pass_].add(span)
    assert set(REMAT) <= owned["remat"], owned["remat"]
    assert set(REMAT) <= owned["forward"], owned["forward"]
    assert owned["optimizer"] == {"kctpu.optimizer", "kctpu.clip"}
    assert "kctpu.embed" in owned["backward"]
    if "moe" in case:
        for s in ("kctpu.moe.experts", "kctpu.moe.dispatch",
                  "kctpu.moe.combine"):
            assert s in owned["remat"] and s in owned["backward"], s
        assert st.metric("moe_route_ms") > 0
    parts = st.parts()
    assert sum(parts.values()) == pytest.approx(
        st.kernel_us / 1e3 / st.steps)
    assert st.metric("remat_ms") == pytest.approx(passes["remat"])


def test_no_profiler_enters_no_record_function(monkeypatch):
    entered = collections.Counter()
    real = torch.profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered[self.name] += 1
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    cfg, model, opt, tokens = _setup("moe-full")
    train_step(model, opt, tokens, cfg)
    assert not entered
    # The control: under a profiler the same step enters every span.
    with profile(activities=[ProfilerActivity.CPU]):
        train_step(model, opt, tokens, cfg)
    assert set(MOE) <= set(entered)
    assert ttrace.step_span("kctpu.x") is ttrace.step_span("kctpu.y")


@pytest.mark.parametrize("case", list(CASES))
def test_the_profiler_changes_no_bit(case, plain_calls):
    results = []
    for on in (False, True):
        plain_calls.clear()
        cfg, model, opt, tokens = _setup(case)
        with (profile(activities=[ProfilerActivity.CPU]) if on
              else contextlib.nullcontext()):
            loss = tllama.llama_loss(model, tokens, cfg)
            loss.backward()
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            opt.step()
        results.append((loss.detach(), grads,
                        {n: p.detach().clone()
                         for n, p in model.named_parameters()},
                        dict(plain_calls)))
    (l0, g0, p0, c0), (l1, g1, p1, c1) = results
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
        assert torch.equal(p0[n], p1[n]), n
    assert c0 == c1 and c0["flash_fwd"] == 2 * 2     # forward and re-run


def test_train_step_is_the_train_loop_step():
    cfg = dataclasses.replace(_setup("dense-full")[0], remat=False)
    from kubeflow_controller_tpu_torch.workloads import llama_pretrain

    res = llama_pretrain.train(cfg, steps=2, batch_size=2, seq_len=SEQ,
                               device="cpu", seed=0)
    model = tllama.llama_init(cfg, torch.Generator().manual_seed(0), "cpu",
                              requires_grad=True)
    opt = default_optimizer(model.parameters(), 3e-4, weight_decay=0.1)
    from kubeflow_controller_tpu_torch.workloads.data import synthetic_tokens

    rows = synthetic_tokens(1, 64, SEQ, cfg.vocab_size, "cpu")
    losses = [train_step(model, opt, rows[lo:lo + 2], cfg)
              for lo in (0, 2)]
    assert losses == res.losses
