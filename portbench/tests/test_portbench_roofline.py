"""The roofline and MFU counts against hand-worked values at the
published widths."""

import json

import pytest

from portbench import roofline, run

PEAK = roofline.PEAKS["NVIDIA H100 80GB HBM3"]


def _conf(name):
    return json.loads((run.BENCH / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("config,seq_len,gflop", [
    ("mistral-7b-l8", 4096, 12.08),      # 6 x 1.879 G + 6 x 8 x 4096 x 4096
    ("mixtral-8x7b-l2", 4096, 5.72),     # 6 x 0.920 G + 6 x 2 x 4096 x 4096
    ("mistral-7b-l8", 32768, 17.7),      # 6 x 1.879 G + 6 x 8 x 32768 x 4096
])
def test_model_flops_per_token(config, seq_len, gflop):
    got = roofline.model_flops_per_token(_conf(config), seq_len) / 1e9
    assert got == pytest.approx(gflop, abs=0.01 if gflop < 17 else 0.05)


def test_matmul_parameters():
    # Mistral's layer: 41.94 M attention + 176.16 M FFN = 218.1 M.
    conf = dict(_conf("mistral-7b-l8"), num_hidden_layers=1, vocab_size=0)
    assert roofline.matmul_params_per_token(conf) == 218_103_808


def test_causal_attention_forward_at_full_context():
    flops, _ = roofline.flash_fwd(1, 32768, 32, 8, 128)
    assert flops / 1e12 == pytest.approx(8.8, abs=0.01)


def test_flash_least_times_at_the_table_shape():
    # PERF.md's kernel table: B4 T4096 H32 D128 causal, bound 0.5560 ms.
    shape = (4, 4096, 32, 8, 128)
    fwd = roofline.least_seconds(*roofline.flash_fwd(*shape), PEAK)
    assert fwd * 1e3 == pytest.approx(0.5560, abs=5e-4)
    bwd = sum(roofline.least_seconds(*f(*shape), PEAK)
              for f in (roofline.flash_dq, roofline.flash_dkv))
    assert bwd == pytest.approx(2.5 * fwd, rel=1e-3)   # five products


def test_grouped_least_times_at_the_table_shape():
    # M 18432 in the table; the benchmark's B cell routes 2 x 4096 x 2 rows.
    rows, d, f = 18432, 4096, 14336
    one = roofline.least_seconds(*roofline.gmm(rows, d, f, 8), PEAK)
    assert one * 1e3 == pytest.approx(2.1886, abs=1e-3)
    rows = 2 * 4096 * 2
    assert roofline.least_seconds(*roofline.gmm(rows, d, f, 8), PEAK) * 1e3 \
        == pytest.approx(1.9455, abs=1e-3)
    assert roofline.least_seconds(*roofline.gmm_swiglu(rows, d, f, 8),
                                  PEAK) * 1e3 == pytest.approx(3.8911, abs=1e-3)
    assert roofline.least_seconds(*roofline.tgmm(rows, d, f, 8), PEAK) \
        == pytest.approx(one * 16384 / 18432, rel=1e-3)


def test_bytes_bound_a_small_call():
    flops, nbytes = roofline.gmm(16, 4096, 14336, 8)
    t = roofline.least_seconds(flops, nbytes, PEAK)
    assert t == pytest.approx(nbytes / PEAK[1])
