"""The trace reduction and the per-layer readers on a trace written by
hand: two steps of a few kernels, the optimizer's launched inside its
range, and idle gaps the host explains."""

import pytest

from portbench import roofline, run, trace
from portbench.trace import Op

FLASH = "void (anonymous namespace)::flash_fwd_wgmma_kernel<128>(x)"
DKV = "void (anonymous namespace)::flash_dkv_wgmma_kernel<128>(x)"
DQ = "void (anonymous namespace)::flash_dq_wgmma_kernel<128>(x)"
GEMM = "nvjet_tst_192x192_64x3_1x2_h_bz_coopB_NNN"
ADAM = "void at::native::multi_tensor_apply_kernel<Adam>(x)"
COPY = "void at::native::unrolled_elementwise_kernel<copy>(x)"
GATHER = "void at::native::vectorized_gather_kernel<16, long>(x)"


def _step(t0):
    """One step from t0 (us): host ranges and the device ops."""
    host = [Op(trace.STEP_RANGE, t0, t0 + 1000),
            Op("portbench.forward", t0, t0 + 300),
            Op("portbench.backward", t0 + 300, t0 + 600),
            Op(trace.OPTIMIZER_RANGE, t0 + 600, t0 + 700),
            Op("aten::_foreach_add_", t0 + 610, t0 + 690),
            Op("portbench.sync", t0 + 700, t0 + 1000)]
    dev = [Op(GATHER, t0 + 10, t0 + 20, launch=t0 + 5),
           Op(GEMM, t0 + 20, t0 + 220, launch=t0 + 15),
           Op(FLASH, t0 + 220, t0 + 300, launch=t0 + 100),
           # a 100 us gap while the host is in the backward
           Op(DQ, t0 + 400, t0 + 450, launch=t0 + 390),
           Op(DKV, t0 + 450, t0 + 550, launch=t0 + 391),
           Op("Memset (Device)", t0 + 550, t0 + 560, launch=t0 + 392),
           Op(COPY, t0 + 560, t0 + 600, launch=t0 + 393),
           Op(ADAM, t0 + 600, t0 + 900, launch=t0 + 620),
           Op(COPY, t0 + 900, t0 + 950, launch=t0 + 650)]
    return host, dev


def _reduced():
    h1, d1 = _step(0.0)
    h2, d2 = _step(1000.0)
    return trace.reduce(d1 + d2, h1 + h2, steps=2)


def test_reduce_counts_busy_groups_and_the_optimizer():
    r = _reduced()
    assert r.window_s == pytest.approx(2000e-6)
    # busy: 10..300, 400..950 per step (the memset counts as busy)
    assert r.busy_s == pytest.approx(2 * (290 + 550) * 1e-6)
    assert r.launches == 2 * 8          # the memset is not a launch
    assert r.optimizer_us == pytest.approx(2 * (300 + 50))
    assert r.group_us["gemm"] == pytest.approx(400)
    assert r.group_us["flash_fwd"] == pytest.approx(160)
    assert r.group_us["index"] == pytest.approx(20)
    assert r.group_us["other"] == pytest.approx(80)   # the copy outside
    labels = dict(r.idle_gaps)
    assert labels["portbench.backward"] == pytest.approx(200e-6)
    # 950..1010 spans the steps' boundary: one gap, in the first sync
    assert labels["portbench.sync"] == pytest.approx(110e-6)
    assert labels["portbench.forward"] == pytest.approx(10e-6)
    assert r.device_ops[0] == (ADAM[:120], pytest.approx(600e-6))


def test_reduce_needs_a_step_range():
    _, dev = _step(0.0)
    assert trace.reduce(dev, [], steps=1) is None


def _ctx(conf_name, traffic, launches):
    import json

    conf = json.loads((run.BENCH / "configs" / f"{conf_name}.json")
                      .read_text())
    mix = json.loads((run.BENCH / "mixes" / f"{traffic}.json").read_text())
    return run.Ctx(conf, mix, 1, "NVIDIA H100 80GB HBM3", _reduced(),
                   launches, 40e9)


def test_readers():
    launches = {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2, "gmm": 0,
                "gmm_swiglu": 0, "tgmm": 0}
    ctx = _ctx("mistral-7b-l8", "train-b4-t4096", launches)
    read = {m: run.reader(m)(ctx) for m in (
        "mfu", "launches_per_step", "gemm_ms", "elementwise_ms",
        "optimizer_ms", "idle_share", "peak_mem_gb", "flash_roofline",
        "gmm_roofline", "moe_dispatch_ms")}
    assert read["launches_per_step"] == 8
    assert read["gemm_ms"] == pytest.approx(0.2)
    assert read["elementwise_ms"] == pytest.approx(0.04)
    assert read["optimizer_ms"] == pytest.approx(0.35)
    assert read["idle_share"] == pytest.approx(100 * (1 - 1680 / 2000))
    assert read["peak_mem_gb"] == 40
    assert read["gmm_roofline"] is None and read["moe_dispatch_ms"] is None
    peak = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    shape = (4, 4096, 32, 8, 128)
    least = 2 * sum(roofline.least_seconds(*f(*shape), peak) for f in (
        roofline.flash_fwd, roofline.flash_dq, roofline.flash_dkv))
    assert read["flash_roofline"] == pytest.approx(
        100 * least / ((160 + 100 + 200) * 1e-6))
    flops = roofline.model_flops_per_token(ctx.conf, 4096) * 4 * 4096 * 2
    assert read["mfu"] == pytest.approx(100 * flops / (2000e-6 * peak[0]))


def test_grouped_readers():
    launches = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0, "gmm": 10,
                "gmm_swiglu": 4, "tgmm": 6}
    ctx = _ctx("mixtral-8x7b-l2", "train-b2-t4096", launches)
    ctx.reduced.group_us.update(gmm=10 * 2900.0, gmm_swiglu=4 * 6330.0,
                                tgmm=6 * 3080.0)
    peak = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    rows = 2 * 4096 * 2
    least = sum(n * roofline.least_seconds(*f(rows, 4096, 14336, 8), peak)
                for n, f in ((10, roofline.gmm), (4, roofline.gmm_swiglu),
                             (6, roofline.tgmm)))
    got = run.reader("gmm_roofline")(ctx)
    assert got == pytest.approx(100 * least / ((29000 + 25320 + 18480) * 1e-6))
    assert 60 < got < 70
    assert run.reader("moe_dispatch_ms")(ctx) == pytest.approx(0.01)
