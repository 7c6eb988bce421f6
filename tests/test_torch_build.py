"""The port's kernel build and kernel choice, checked on the CPU (no
``nvcc``, no card; the kernels themselves are held against their plain
versions on the card by ``chip_smoke.py``):

- ``grouped_matmul.kernel_variant``: the rule on the kernel and ``bm``
  that picks the CUDA design ``gmm``, ``gmm_swiglu`` and ``tgmm`` launch
  (wgmma for bm >= 64; below, swap-AB for ``gmm`` and ``gmm_swiglu`` and
  WMMA for ``tgmm``), and the C entry point each wrapper calls under it,
  with exactly the pointers, sizes, expert count and flags it should;
- ``attention.kernel_rule`` and the arguments ``flash_fwd``, ``flash_dq``
  and ``flash_dkv`` hand their C entry points at every shape the rule
  accepts, B·H past 65535 included;
- ``_build._SIGNATURES`` against the ``extern "C"`` functions of
  ``csrc/*.cu``: the same names with the same number of parameters;
- ``_build._content_key`` over every file under ``csrc/``, headers
  included, so an edited header never loads a stale build;
- the build's compile beats: ``compile_cache.build_kernels`` beats
  ``phase="compile"`` and returns "compiled" or "cache-hit", and
  ``llama_pretrain`` beats ``phase="fit"`` with that source after the
  build and up to its last step;
- ``chip_smoke.py``'s kernel-name rules: the profile's kernel groups, the
  HGMMA count read from ``cuobjdump -sass`` and the registers and spills
  read from ptxas; and phase 19's readings: the generated tokens two runs
  agree on, and the share of tokens whose routing two runs differ on.
"""

import json
import os
import re
import shutil
import sys
from pathlib import Path

import pytest

import torch

from kubeflow_controller_tpu_torch.ops import _build
from kubeflow_controller_tpu_torch.ops import attention as tat
from kubeflow_controller_tpu_torch.ops import grouped_matmul as tgm
from kubeflow_controller_tpu_torch.workloads import compile_cache, progress

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("kernel", tgm.KERNELS)
def test_kernel_variant_over_1_to_512(kernel):
    wgmma = [bm for bm in range(1, 513)
             if tgm.kernel_variant(kernel, bm) == "wgmma"]
    assert wgmma == list(range(64, 513))
    below = "wmma" if kernel == "tgmm" else "swapab"
    assert {tgm.kernel_variant(kernel, bm) for bm in range(1, 64)} == {below}


def test_kernel_variant_refuses_an_unknown_kernel():
    with pytest.raises(ValueError):
        tgm.kernel_variant("gmm2", 16)


def test_the_wmma_gmm_kernel_is_gone():
    """Only tgmm keeps a WMMA form below bm 64; gmm and gmm_swiglu launch
    the swap-AB kernel there."""
    src = (_build.CSRC_DIR / "grouped_matmul.cu").read_text()
    assert re.search(r"\bgmm_kernel\b", src) is None
    assert "int launch(" not in src and "type_traits" not in src
    assert "gmm_swapab_kernel" in src and "tgmm_kernel" in src


def extern_c_functions():
    """{name: parameter count} of every function defined in the
    ``extern "C"`` blocks of ``csrc/*.cu``."""
    found = {}
    for src in _build.sources():
        text = src.read_text()
        blocks = re.findall(r'extern "C" \{\n(.*?)\n\}  // extern "C"', text,
                            re.S)
        assert blocks, f"{src.name}: no extern \"C\" block"
        for block in blocks:
            for m in re.finditer(
                    r"^(?:int|const char\*) (kctpu_\w+)\(([^)]*)\)", block,
                    re.M):
                found[m.group(1)] = len([p for p in m.group(2).split(",")
                                         if p.strip()])
    return found


def test_every_c_entry_point_has_a_signature_of_its_arity_and_back():
    defined = extern_c_functions()
    declared = {name: len(argtypes)
                for name, (argtypes, _) in _build._SIGNATURES.items()}
    assert defined == declared
    assert {"kctpu_gmm_wgmma", "kctpu_gmm_swiglu_wgmma",
            "kctpu_tgmm_wgmma", "kctpu_gmm_swapab",
            "kctpu_gmm_swiglu_swapab", "kctpu_tgmm"} <= set(defined)
    assert not {"kctpu_gmm", "kctpu_gmm_swiglu"} & set(defined)


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", copy)
    return copy


def key():
    return _build._content_key(_build.key_files())


@pytest.mark.parametrize("edit", ["header", "source", "new header"])
def test_content_key_changes_with_any_csrc_file(csrc_copy, edit):
    header = csrc_copy / "hopper.cuh"
    assert header in _build.key_files() and header not in _build.sources()
    before = key()
    if edit == "header":
        header.write_text(header.read_text() + "\n// edited\n")
    elif edit == "source":
        src = csrc_copy / "grouped_matmul.cu"
        src.write_text(src.read_text() + "\n// edited\n")
    else:
        (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert key() != before


PROFILE_NAMES = {
    "void (anonymous namespace)::tgmm_kernel<64, 128, 2, 4>(__nv_bfloat16 "
    "const*, __nv_bfloat16": "tgmm",
    "void (anonymous namespace)::tgmm_wgmma_kernel(CUtensorMap_st, "
    "CUtensorMap_st, int const*": "tgmm",
    "void (anonymous namespace)::gmm_wgmma_kernel<2, false>(CUtensorMap_st, "
    "CUtensorMap_st": "gmm",
    "void (anonymous namespace)::gmm_wgmma_kernel<1, true>(CUtensorMap_st":
    "gmm",
    "void (anonymous namespace)::gmm_swapab_kernel<64, false, false>("
    "CUtensorMap_st, CUtensorMap_st": "gmm",
    "void (anonymous namespace)::gmm_swapab_kernel<8, false, true>("
    "CUtensorMap_st": "gmm",
    "void (anonymous namespace)::gmm_swapab_kernel<64, false, true>("
    "CUtensorMap_st": "gmm",
    "void (anonymous namespace)::gmm_swapab_kernel<16, true, false>("
    "CUtensorMap_st, CUtensorMap_st": "gmm_swiglu",
    "void (anonymous namespace)::gmm_swapab_kernel<8, true, false>("
    "CUtensorMap_st": "gmm_swiglu",
    "void (anonymous namespace)::flash_fwd_kernel<128>(__nv_bfloat16":
    "flash_fwd",
    "void (anonymous namespace)::gmm_swiglu_wgmma_kernel<2>(CUtensorMap_st, "
    "CUtensorMap_st, CUtensorMap_st": "gmm_swiglu",
    "void (anonymous namespace)::gmm_swiglu_wgmma_kernel<1>(CUtensorMap_st":
    "gmm_swiglu",
    "void (anonymous namespace)::gmm_swapab_kernel<32, true, false>("
    "CUtensorMap_st": "gmm_swiglu",
    "void (anonymous namespace)::flash_fwd_wgmma_kernel<128>(CUtensorMap_st, "
    "CUtensorMap_st": "flash_fwd",
    "void (anonymous namespace)::flash_fwd_wgmma_kernel<64>(CUtensorMap_st":
    "flash_fwd",
    "void (anonymous namespace)::flash_dq_kernel<128>(__nv_bfloat16 const*":
    "flash_dq",
    "void (anonymous namespace)::flash_dkv_kernel<64>(__nv_bfloat16 const*":
    "flash_dkv",
    "void (anonymous namespace)::flash_dq_wgmma_kernel<128>(CUtensorMap_st, "
    "CUtensorMap_st": "flash_dq",
    "void (anonymous namespace)::flash_dq_wgmma_kernel<64>(CUtensorMap_st":
    "flash_dq",
    "void (anonymous namespace)::flash_dkv_wgmma_kernel<128>(CUtensorMap_st, "
    "CUtensorMap_st": "flash_dkv",
    "void (anonymous namespace)::flash_dkv_wgmma_kernel<64>(CUtensorMap_st":
    "flash_dkv",
    "nvjet_tst_320x128_64x3_1x2_h_bz_coopB_NNT": "library gemm",
}


def test_ptxas_report_names_each_kernel_with_its_template_arguments():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__b6fd4908_"
        "18_flash_attention_cu_765555e422flash_dkv_wgmma_kernelILi128EEEv14CU"
        "tensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_iifi' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN51_GLOBAL__N__b6fd4908_18"
        "_flash_attention_cu_765555e422flash_dkv_wgmma_kernelILi128EEEv14CU",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__032e5cd9_"
        "17_grouped_matmul_cu_79caf09717gmm_swapab_kernelILi16ELb1ELb0EEEv14C"
        "UtensorMap_stS1_S1_PKiS3_P13__nv_bfloat16S5_S5_iiii' for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 40 registers, used 2 barriers",
        "ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__032e5cd9_"
        "17_grouped_matmul_cu_79caf09717tgmm_wgmma_kernelE14CUtensorMap_stS1_"
        "PKi' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 154 registers, used 16 barriers",
    ])
    assert chip_smoke.ptxas_report(log) == {
        "flash_dkv_wgmma_kernel<128>": [168, 0, 0],
        "gmm_swapab_kernel<16, 1, 0>": [40, 4, 8],
        "tgmm_wgmma_kernel": [154, 0, 0]}


@pytest.mark.parametrize("name", PROFILE_NAMES)
def test_profile_groups_file_each_kernel(name):
    group = next(g for g, match in chip_smoke.KERNEL_GROUPS if match(name))
    assert group == PROFILE_NAMES[name]


def test_generate_phase_readings():
    a = torch.tensor([[1, 2, 3, 4, 5], [1, 2, 3, 4, 5]])
    b = torch.tensor([[1, 2, 3, 4, 5], [1, 2, 9, 4, 9]])
    agree = chip_smoke.token_agreement(a, b, 2)
    assert agree["leading_equal_by_seq"] == [3, 0]
    assert agree["equal_share"] == pytest.approx(4 / 6)
    # top-2 sets: the order within a token's pair does not count.
    ra = torch.tensor([[[0, 1], [2, 3], [4, 5], [6, 7]]])
    rb = torch.tensor([[[1, 0], [2, 3], [4, 6], [6, 7]]])
    assert chip_smoke.routing_flips(ra, rb) == pytest.approx(0.25)
    assert chip_smoke.routing_flips(ra, ra) == 0.0


def test_hgmma_count_reads_cuobjdump_sections():
    sass = "\n".join([
        "\tcode for sm_90a",
        "\t\tFunction : _ZN12_GLOBAL__N_116gmm_wgmma_kernelILi2ELb0EEEv14CU",
        "        /*0a10*/  HGMMA.64x256x16.F32.BF16 R24, gdesc[UR4], R24 ;",
        "        /*0a20*/  HGMMA.64x256x16.F32.BF16 R24, gdesc[UR8], R24 ;",
        "\t\tFunction : _ZN12_GLOBAL__N_117tgmm_wgmma_kernelE14CUtensorMap_st",
        "        /*0b10*/  HGMMA.64x256x16.F32.BF16 R24, gdesc[UR4], R24 ;",
        "\t\tFunction : _ZN12_GLOBAL__N_111tgmm_kernelILi64ELi128ELi2ELi4EEEv",
        "        /*0c10*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
        "\t\tFunction : _ZN12_GLOBAL__N_117gmm_swapab_kernelILi64ELb0ELb0EEEv",
        "        /*0c20*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;",
        "        /*0c30*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24 ;",
        "\t\tFunction : _ZN12_GLOBAL__N_117gmm_swapab_kernelILi8ELb1ELb0EEEv1",
        "        /*0c40*/  HGMMA.64x8x16.F32.BF16 R24, gdesc[UR4], R24 ;",
        "\t\tFunction : _ZN12_GLOBAL__N_123gmm_swiglu_wgmma_kernelILi2EEEv14C",
        "        /*0e10*/  HGMMA.64x256x16.F32.BF16 R24, gdesc[UR4], R24 ;",
        "\t\tFunction : _ZN12_GLOBAL__N_123gmm_swiglu_wgmma_kernelILi1EEEv14C",
        "        /*0e20*/  HGMMA.64x256x16.F32.BF16 R24, gdesc[UR4], R24 ;",
        "        /*0e30*/  HGMMA.64x256x16.F32.BF16 R24, gdesc[UR8], R24 ;",
        "\t\tFunction : _ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelILi128EEEv14",
        "        /*0d10*/  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24 ;",
        "        /*0d20*/  HGMMA.64x128x16.F32.BF16 R88, R152, gdesc[UR8], R88 ;",
        "\t\tFunction : _ZN51_GLOBAL__N__b6fd4908_18_flash_attention_cu_765555e"
        "421flash_dq_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P1",
        "        /*0f10*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;",
        "        /*0f20*/  HGMMA.64x64x16.F32.BF16 R56, gdesc[UR8], R56 ;",
        "        /*0f30*/  HGMMA.64x128x16.F32.BF16 R88, R152, gdesc[UR12], R88 ;",
        "\t\tFunction : _ZN51_GLOBAL__N__b6fd4908_18_flash_attention_cu_765555e"
        "421flash_dq_wgmma_kernelILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13",
        "        /*0f40*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;",
        "\t\tFunction : _ZN51_GLOBAL__N__b6fd4908_18_flash_attention_cu_765555e"
        "422flash_dkv_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_S1_PKfS3_",
        "        /*1010*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;",
        "        /*1020*/  HGMMA.64x128x16.F32.BF16 R88, R152, gdesc[UR8], R88 ;",
    ])
    assert chip_smoke.hgmma_counts(sass) == {
        "gmm_wgmma_kernel": [2], "tgmm_wgmma_kernel": [1],
        "tgmm_kernel": [0], "gmm_swapab_kernel": [2, 1],
        "gmm_swiglu_wgmma_kernel": [1, 2], "flash_fwd_wgmma_kernel": [2],
        "flash_dq_wgmma_kernel": [3, 1], "flash_dkv_wgmma_kernel": [2]}
    assert set(chip_smoke.hgmma_counts(sass)) == set(
        chip_smoke.WGMMA_KERNELS + chip_smoke.WMMA_KERNELS)


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


@pytest.fixture
def recorder(monkeypatch):
    rec = RecordingLibrary()
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(_build, "stream", lambda t: 7)
    return rec


def meta(*shape, dtype=torch.bfloat16):
    """A tensor on no real device: it takes the kernel path (only CPU
    tensors take the plain versions) with no memory behind it."""
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture
def addresses(monkeypatch):
    """Gives every tensor the grouped wrappers hand to C a distinct fake
    address (meta tensors all report 0), so a test can check that each
    pointer argument is the tensor it should be.  Returns the address of
    a tensor (None for None)."""
    seen = {}

    def fake(t):
        if t is None:
            return None
        return 0x10000 * (1 + seen.setdefault(id(t), len(seen)))

    monkeypatch.setattr(tgm, "_ptr", fake)
    return fake


BMS = [1, 2, 4, 8, 16, 32, 64, 128, 256]


@pytest.mark.parametrize("bm", BMS)
@pytest.mark.parametrize("gate_up", [False, True])
def test_gmm_swiglu_calls_the_wgmma_entry_exactly_from_bm_64(
        recorder, addresses, bm, gate_up):
    e, k, n, tiles = 3, 40, 24, 4
    m = tiles * bm
    lhs, rhs_g, rhs_u = meta(m, k), meta(e, k, n), meta(e, k, n)
    te = meta(tiles, dtype=torch.int32)
    before = tgm.gmm_swiglu.launches
    designs = dict(tgm.gmm_swiglu.launches_by_design)
    out = tgm._gmm_swiglu(lhs, rhs_g, rhs_u, te, bm, gate_up=gate_up)
    assert tgm.gmm_swiglu.launches == before + 1
    designs[tgm.kernel_variant("gmm_swiglu", bm)] += 1
    assert tgm.gmm_swiglu.launches_by_design == designs
    outs = out if gate_up else (out,)
    assert [tuple(t.shape) for t in outs] == [(m, n)] * len(outs)
    h, gate, up = outs if gate_up else (out, None, None)
    [(name, args)] = recorder.calls
    assert name == ("kctpu_gmm_swiglu_wgmma" if bm >= 64
                    else "kctpu_gmm_swiglu_swapab")
    assert len(args) == len(_build._SIGNATURES[name][0]) == 13
    # gate and up pointers are passed (as NULL without gate_up)
    assert args == (*map(addresses, (lhs, rhs_g, rhs_u, te, h, gate, up)),
                    m, k, n, bm, e, 7)
    assert (args[5] is None, args[6] is None) == (not gate_up, not gate_up)


@pytest.mark.parametrize("bm", BMS)
@pytest.mark.parametrize("trans", [False, True], ids=["rhs", "rhs^T"])
@pytest.mark.parametrize("skip", [False, True], ids=["all", "valid_tiles"])
def test_gmm_calls_the_swapab_entry_below_bm_64_and_wgmma_from_it(
        recorder, addresses, bm, trans, skip):
    """Both rhs layouts, with and without valid_tiles: the swap-AB entry
    below bm 64, the wgmma one from 64, with exactly the operands' and the
    output's pointers, M, K, N, bm, the expert count and the transpose
    flag."""
    e, k, n, tiles = 3, 40, 24, 4
    m = tiles * bm
    lhs = meta(m, k)
    rhs = meta(e, n, k) if trans else meta(e, k, n)
    te = meta(tiles, dtype=torch.int32)
    vt = meta(1, dtype=torch.int32) if skip else None
    before = tgm.gmm.launches
    designs = dict(tgm.gmm.launches_by_design)
    out = tgm._gmm(lhs, rhs, te, bm, vt, transpose_rhs=trans)
    assert tgm.gmm.launches == before + 1
    designs[tgm.kernel_variant("gmm", bm)] += 1
    assert tgm.gmm.launches_by_design == designs
    assert tuple(out.shape) == (m, n)
    [(name, args)] = recorder.calls
    assert name == ("kctpu_gmm_wgmma" if bm >= 64 else "kctpu_gmm_swapab")
    assert len(args) == len(_build._SIGNATURES[name][0]) == 12
    assert args == (*map(addresses, (lhs, rhs, te, vt, out)), m, k, n, bm, e,
                    int(trans), 7)
    assert (args[3] is None) == (not skip)


@pytest.mark.parametrize("bm", BMS)
@pytest.mark.parametrize("skip", [False, True], ids=["all", "valid_tiles"])
def test_tgmm_keeps_the_wmma_entry_below_bm_64(recorder, addresses, bm,
                                               skip):
    e, k, n, tiles = 3, 40, 24, 4
    m = tiles * bm
    lhs, dout = meta(m, k), meta(m, n)
    te = meta(tiles, dtype=torch.int32)
    vt = meta(1, dtype=torch.int32) if skip else None
    before = tgm.tgmm.launches
    designs = dict(tgm.tgmm.launches_by_design)
    out = tgm.tgmm(lhs, dout, te, e, bm, vt)
    assert tgm.tgmm.launches == before + 1
    designs[tgm.kernel_variant("tgmm", bm)] += 1
    assert tgm.tgmm.launches_by_design == designs
    assert tuple(out.shape) == (e, k, n)
    [(name, args)] = recorder.calls
    assert name == ("kctpu_tgmm_wgmma" if bm >= 64 else "kctpu_tgmm")
    assert len(args) == len(_build._SIGNATURES[name][0]) == 11
    assert args == (*map(addresses, (lhs, dout, te, vt, out)), m, k, n, bm, e,
                    7)


FLASH_SHAPES = [(1, 64, 1, 64), (2, 128, 2, 64), (1, 192, 3, 128),
                (2, 320, 2, 128), (1, 4096, 4, 128)]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_passes_the_same_arguments_at_every_accepted_shape(
        recorder, shape, causal):
    b, t, h, d = shape
    q, k, v = meta(*shape), meta(*shape), meta(*shape)
    assert tat.kernel_rule(q, k, v) is None
    before = tat.flash_fwd.launches
    o, lse = tat.flash_fwd(q, k, v, causal)
    assert tat.flash_fwd.launches == before + 1
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    assert lse.shape == (b * h, t) and lse.dtype == torch.float32
    [(name, args)] = recorder.calls
    assert name == "kctpu_flash_fwd"
    assert len(args) == 12
    assert args[5:] == (b, h, t, d, d ** -0.5, int(causal), 7)


def stats(b, t, h):
    return meta(b * h, t, dtype=torch.float32), meta(b * h, t,
                                                      dtype=torch.float32)


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_dq_passes_the_same_arguments_at_every_accepted_shape(
        recorder, shape, causal):
    b, t, h, d = shape
    q, k, v, do = (meta(*shape) for _ in range(4))
    before = tat.flash_dq.launches
    dq = tat.flash_dq(q, k, v, do, *stats(b, t, h), causal)
    assert tat.flash_dq.launches == before + 1
    assert dq.shape == q.shape and dq.dtype == torch.bfloat16
    [(name, args)] = recorder.calls
    assert name == "kctpu_flash_dq"
    assert len(args) == len(_build._SIGNATURES[name][0]) == 14
    assert args[7:] == (b, h, t, d, d ** -0.5, int(causal), 7)


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_dkv_passes_the_same_arguments_at_every_accepted_shape(
        recorder, shape, causal):
    b, t, h, d = shape
    q, k, v, do = (meta(*shape) for _ in range(4))
    before = tat.flash_dkv.launches
    dk, dv = tat.flash_dkv(q, k, v, do, *stats(b, t, h), causal)
    assert tat.flash_dkv.launches == before + 1
    assert dk.shape == dv.shape == q.shape
    assert dk.dtype == dv.dtype == torch.bfloat16
    [(name, args)] = recorder.calls
    assert name == "kctpu_flash_dkv"
    assert len(args) == len(_build._SIGNATURES[name][0]) == 15
    assert args[8:] == (b, h, t, d, d ** -0.5, int(causal), 7)


# B·H at and past 65536, which the C entries once refused (B·H was the
# grid's y extent): kernel_rule accepts them and every wrapper hands them
# to C unchanged.
MANY_HEADS = [(1024, 64, 64, 64), (1024, 64, 66, 128)]


@pytest.mark.parametrize("shape", MANY_HEADS)
def test_kernel_rule_and_wrappers_take_b_times_h_past_65535(recorder, shape):
    b, t, h, d = shape
    assert b * h in (65536, 67584)
    q, k, v, do = (meta(*shape) for _ in range(4))
    assert tat.kernel_rule(q, k, v) is None
    o, lse = tat.flash_fwd(q, k, v)
    assert lse.shape == (b * h, t)
    tat.flash_dq(q, k, v, do, *stats(b, t, h))
    tat.flash_dkv(q, k, v, do, *stats(b, t, h))
    assert [name for name, _ in recorder.calls] == [
        "kctpu_flash_fwd", "kctpu_flash_dq", "kctpu_flash_dkv"]
    fwd, dq, dkv = (args for _, args in recorder.calls)
    assert fwd[5:9] == dq[7:11] == dkv[8:12] == (b, h, t, d)


def test_flash_c_entries_no_longer_refuse_many_heads():
    src = (_build.CSRC_DIR / "flash_attention.cu").read_text()
    bad_args = re.search(r"bool bad_args\(.*?\n}\n", src, re.S).group(0)
    assert "65535" not in bad_args and "B * H" not in bad_args
    assert "blockIdx.y" not in src and "gridDim.y" not in src


@pytest.mark.parametrize("t", [32, 64, 96, 128, 192, 320, 4096])
@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
def test_kernel_rule_takes_head_dim_64_or_128_and_t_a_multiple_of_64(t, d):
    q = meta(2, t, 3, d)
    reason = tat.kernel_rule(q, q, q)
    assert (reason is None) == (d in (64, 128) and t % 64 == 0), reason
    assert tat.TILE == 64 and tat.HEAD_DIMS == (64, 128)


# --- the build's compile beats ----------------------------------------------

@pytest.fixture
def stand_in_nvcc(tmp_path, monkeypatch):
    """nvcc and the loader stood in for (the CPU host has neither), under a
    fresh ``build/``; yields the library's path and the nvcc commands."""
    from unittest import mock

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    commands = []

    def run_all(cmds):
        commands.extend(cmds)
        for c in cmds:
            Path(c[c.index("-o") + 1]).write_bytes(b"")
        return ""

    monkeypatch.setattr(_build, "_run_all", run_all)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: mock.MagicMock())
    monkeypatch.setattr(_build, "_LIBRARY", None)
    yield tmp_path / "build" / f"libkctpu_kernels_{key()}.so", commands


@pytest.mark.parametrize("present", [False, True],
                         ids=["compiled", "cache-hit"])
def test_build_beats_compile_then_its_source(present, tmp_path,
                                             stand_in_nvcc):
    """``build_kernels`` builds inside the reporter's compile window (one
    beat, ``phase="compile"``, and the keepalive stopped after) and returns
    the library's source for the caller's next beat: "compiled" when nvcc
    ran, "cache-hit" when the content-keyed library was already in
    ``build/``.  The kernel layer beats nothing itself, and a CPU device
    builds nothing."""
    lib_path, commands = stand_in_nvcc
    if present:
        lib_path.parent.mkdir()
        lib_path.write_bytes(b"")
    rep = chip_smoke.RecordingReporter(name="pod", drop_dir=str(tmp_path))
    assert compile_cache.build_kernels(torch.device("cpu"), rep) == ""
    assert rep.beats == [] and _build._LIBRARY is None
    rep.beat(phase="init")
    want = "cache-hit" if present else "compiled"
    assert compile_cache.build_kernels(torch.device("cuda"), rep) == want
    lib = _build.library()                      # built once, beats nothing
    assert lib.compile_source == want and lib_path.exists()
    assert bool(commands) != present            # nvcc ran iff absent
    assert rep.beats == [{"phase": "init"}, {"phase": "compile"}]
    assert rep._keepalive is None               # the keepalive stopped


def test_pretrain_beats_fit_after_the_build(tmp_path, monkeypatch,
                                            stand_in_nvcc):
    """The compile window does not outlive the build: ``llama_pretrain``
    beats ``phase="fit"`` after its first step, with the build's source,
    and keeps beating to its last step, so the heartbeat the controller
    reads after the build is fresh and names the training phase.  A resume
    beats "restore" first and ``resumedFromStep`` with its steps.  The
    CPU builds nothing, so the build is asked for as on CUDA."""
    from kubeflow_controller_tpu_torch.workloads import llama_pretrain as tpre

    for name in list(os.environ):
        if name.startswith("KCTPU_") or name == "MODEL_DIR":
            monkeypatch.delenv(name)
    monkeypatch.setattr(tpre, "build_kernels", lambda dev, rep=None:
                        compile_cache.build_kernels(torch.device("cuda"), rep))
    drops = tmp_path / "drops"
    drops.mkdir()
    rep = chip_smoke.RecordingReporter(name="pod-0", drop_dir=str(drops))
    monkeypatch.setattr(progress, "_REPORTER", rep)
    monkeypatch.setenv("MODEL_DIR", str(tmp_path / "ck"))
    argv = ["--device", "cpu", "--batch-size", "2", "--seq-len", "32",
            "--dim", "64", "--intermediate", "128", "--steps", "2"]
    drop = drops / progress.drop_filename(rep.namespace, rep.name)
    for run, first in ((0, ["compile"]), (1, ["restore", "compile"])):
        rep.beats.clear()
        assert tpre.main(argv) == 0
        phases = [b["phase"] for b in rep.beats]
        assert phases == [*first, "fit", "fit"], rep.beats
        assert [b["step"] for b in rep.beats[len(first):]] == [
            2 * run + 1, 2 * run + 2]
        assert rep.beats[len(first)]["compile_source"] == "compiled"
        assert rep._keepalive is None
        heartbeat = json.loads(drop.read_text())
        assert heartbeat["phase"] == "fit" and heartbeat["step"] == 2 * run + 2
        assert heartbeat["compileSource"] == "compiled"
    assert heartbeat["resumedFromStep"] == 2
