"""The span attribution (``spans.py``) on a trace written by hand: one step
of a checkpointed layer, its forward on the main thread, its backward and
remat re-run on the autograd thread, the clip inside the optimizer, and
idle gaps of the device."""

import pytest

from portbench import spans, trace
from portbench.spans import Kernel, Range

MAIN, AUTOGRAD = 1, 7
NODE = spans.NODE + ": "

# name, start, end, thread, sequence number, forward thread
HOST = [
    (trace.STEP_RANGE, 0, 1000, MAIN),
    ("portbench.forward", 0, 300, MAIN),
    ("kctpu.embed", 2, 8, MAIN),
    ("aten::index", 3, 7, MAIN, 4),
    ("kctpu.layer", 10, 200, MAIN),
    ("kctpu.norm", 20, 60, MAIN),
    ("aten::mul", 30, 50, MAIN, 5),
    ("kctpu.attention", 100, 180, MAIN),
    ("aten::repeat_interleave", 102, 106, MAIN),   # no grad: no node
    ("kctpu::flash_fwd", 110, 170, MAIN, 6),
    ("kctpu.loss", 210, 290, MAIN),
    ("aten::log_softmax", 220, 280, MAIN, 7),
    ("portbench.backward", 300, 600, MAIN),
    (NODE + "LogSoftmaxBackward0", 310, 340, AUTOGRAD, 7, MAIN),
    (NODE + "FlashFwdBackward", 350, 500, AUTOGRAD, 6, MAIN),
    # the layer re-run by remat, inside the node that unpacked it
    ("kctpu.layer", 355, 450, AUTOGRAD),
    ("kctpu.norm", 360, 380, AUTOGRAD),
    ("aten::mul", 362, 378, AUTOGRAD, 40),
    ("kctpu.attention", 390, 440, AUTOGRAD),
    (NODE + "MulBackward0", 510, 540, AUTOGRAD, 5, MAIN),
    (NODE + "IndexBackward0", 545, 590, AUTOGRAD, 4, MAIN),
    (trace.OPTIMIZER_RANGE, 600, 700, MAIN),
    ("kctpu.optimizer", 605, 695, MAIN),
    ("kctpu.clip", 610, 640, MAIN),
    ("portbench.sync", 700, 1000, MAIN),
]

# name, device start, end, launch, thread; and (span, pass) expected
KERNELS = [
    ("gather", 5, 15, 4, MAIN, ("kctpu.embed", "forward")),
    ("mul_f32", 30, 40, 35, MAIN, ("kctpu.norm", "forward")),
    ("nvjet_gemm", 40, 100, 70, MAIN, ("kctpu.layer", "forward")),
    ("copy", 105, 115, 104, MAIN, ("kctpu.attention", "forward")),
    ("flash_fwd_wgmma_kernel", 120, 200, 115, MAIN,
     ("kctpu.attention", "forward")),
    ("log_softmax", 220, 260, 230, MAIN, ("kctpu.loss", "forward")),
    ("log_softmax_bwd", 320, 340, 315, AUTOGRAD, ("kctpu.loss", "backward")),
    ("mul_f32", 365, 375, 364, AUTOGRAD, ("kctpu.norm", "remat")),
    ("flash_fwd_wgmma_kernel", 400, 440, 395, AUTOGRAD,
     ("kctpu.attention", "remat")),
    ("nvjet_gemm", 441, 460, 441, AUTOGRAD, ("kctpu.layer", "remat")),
    ("flash_dq_wgmma_kernel", 470, 500, 460, AUTOGRAD,
     ("kctpu.attention", "backward")),
    ("mul_bwd", 520, 530, 515, AUTOGRAD, ("kctpu.norm", "backward")),
    ("index_put", 550, 580, 550, AUTOGRAD, ("kctpu.embed", "backward")),
    ("norm_reduce", 620, 630, 615, MAIN, ("kctpu.clip", "optimizer")),
    ("multi_tensor_apply_kernel<Adam>", 650, 690, 650, MAIN,
     ("kctpu.optimizer", "optimizer")),
    ("fill", 800, 805, 710, MAIN, None),
]


def _host():
    out = []
    for h in HOST:
        name, a, b, th = h[:4]
        seq = h[4] if len(h) > 4 else -1
        fwd = h[5] if len(h) > 5 else 0
        out.append(Range(name, a, b, th, seq, fwd))
    return out


def _kernels():
    return [Kernel(n, a, b, launch, th) for n, a, b, launch, th, _ in KERNELS]


def _attributed():
    return spans.attribute(_kernels(), _host(), steps=1)


def test_each_kernel_lands_on_its_span_and_pass():
    st = _attributed()
    want = {}
    for n, a, b, _, _, owner in KERNELS:
        if owner is not None:
            key = (*owner, trace.group_of(n))
            want[key] = want.get(key, 0.0) + (b - a)
    assert st.us == pytest.approx(want)
    assert st.unattributed_us == 5
    assert st.kernel_us == sum(b - a for _, a, b, *_ in KERNELS)
    assert st.coverage == pytest.approx(1 - 5 / st.kernel_us)


def test_metrics_and_parts():
    st = _attributed()
    assert st.metric("attention_ms") == pytest.approx((10 + 80 + 40 + 30)
                                                      / 1e3)
    assert st.metric("norm_rope_ms") == pytest.approx((10 + 10 + 10) / 1e3)
    assert st.metric("loss_ms") == pytest.approx(60 / 1e3)
    assert st.metric("clip_ms") == pytest.approx(10 / 1e3)
    assert st.metric("remat_ms") == pytest.approx((10 + 40 + 19) / 1e3)
    assert st.metric("cast_ms") is None and st.metric("ffn_ms") is None
    parts = st.parts()
    assert parts["adamw_ms"] == pytest.approx(0.04)
    assert parts["rest_ms"] == pytest.approx((10 + 60 + 19 + 30) / 1e3)
    assert sum(parts.values()) == pytest.approx(st.kernel_us / 1e3)
    assert st.pass_ms() == pytest.approx({
        "forward": 0.21, "remat": 0.069, "backward": 0.09,
        "optimizer": 0.05})
    assert st.by_span_pass()["kctpu.attention"] == pytest.approx({
        "forward": 0.09, "remat": 0.04, "backward": 0.03})


def test_gaps_are_labelled_by_the_span_open():
    gaps = dict(_attributed().gaps)
    # Each by the span open at its middle: 0..5 the embedding's, 15..30 the
    # norm's (inside the layer), 100..105 and 115..120 attention's,
    # 200..220 the loss's, 375..400 the re-run layer's (on the autograd
    # thread), 630..650 the optimizer's after the clip; the rest (between
    # the forward's end and the re-run, between the backward's nodes,
    # after the optimizer) in no span.  The 1 us gap at 440..441 is too
    # short to count.
    assert gaps == pytest.approx({
        "kctpu.embed": 5e-6, "kctpu.norm": 15e-6, "kctpu.attention": 10e-6,
        "kctpu.loss": 20e-6, "kctpu.layer": 25e-6,
        "kctpu.optimizer": 20e-6,
        "no span": (60 + 25 + 10 + 20 + 20 + 40 + 110 + 195) * 1e-6})


def test_the_trace_readings_are_those_without_the_spans():
    dev = [trace.Op(n, a, b, launch) for n, a, b, launch, _, _ in KERNELS]
    host = [trace.Op(r.name, r.start, r.end) for r in _host()]
    bare = [o for o in host if not o.name.startswith(spans.PREFIX)]
    got, want = (trace.reduce(dev, h, steps=1) for h in (host, bare))
    # Every number the readers read; the breakdown's gap labels may name a
    # span where the innermost op open was one.
    for k in ("steps", "window_s", "busy_s", "launches", "group_us",
              "optimizer_us", "device_ops"):
        assert getattr(got, k) == getattr(want, k), k


def test_nothing_to_attribute():
    assert spans.attribute([], _host(), steps=1) is None
    assert spans.attribute(_kernels(), [r for r in _host()
                                        if r.name != trace.STEP_RANGE],
                           steps=1) is None
    # A trace with no span (the program before the spans): nothing owned.
    bare = [r for r in _host() if not r.name.startswith(spans.PREFIX)]
    st = spans.attribute(_kernels(), bare, steps=1)
    assert st.us == {} and st.coverage == 0
    assert all(st.metric(m) is None for m in spans.METRICS)
