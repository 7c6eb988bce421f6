"""The port's kernel build and kernel choice, checked on the CPU (no
``nvcc``, no card; the kernels themselves are held against their plain
versions on the card by ``chip_smoke.py``):

- ``grouped_matmul.kernel_variant``: the one rule on ``bm`` that picks the
  CUDA design ``gmm`` and ``tgmm`` launch (wgmma for bm >= 64, WMMA below);
- ``_build._SIGNATURES`` against the ``extern "C"`` functions of
  ``csrc/*.cu``: the same names with the same number of parameters;
- ``_build._content_key`` over every file under ``csrc/``, headers
  included, so an edited header never loads a stale build;
- ``chip_smoke.py``'s kernel-name rules: the profile's kernel groups and
  the HGMMA count read from ``cuobjdump -sass``.
"""

import re
import shutil
import sys
from pathlib import Path

import pytest

from kubeflow_controller_tpu_torch.ops import _build
from kubeflow_controller_tpu_torch.ops import grouped_matmul as tgm

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def test_kernel_variant_over_1_to_512():
    wgmma = [bm for bm in range(1, 513) if tgm.kernel_variant(bm) == "wgmma"]
    assert wgmma == list(range(64, 513))
    assert {tgm.kernel_variant(bm) for bm in range(1, 64)} == {"wmma"}


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
    assert {"kctpu_gmm_wgmma", "kctpu_tgmm_wgmma"} <= set(defined)


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
    "void (anonymous namespace)::gmm_kernel<16, 128, 1, 4, false, true>("
    "__nv_bfloat16 const*": "gmm",
    "void (anonymous namespace)::gmm_kernel<64, 128, 2, 4, true, false>("
    "__nv_bfloat16 const*": "gmm_swiglu",
    "void (anonymous namespace)::flash_fwd_kernel<128>(__nv_bfloat16":
    "flash_fwd",
    "nvjet_tst_320x128_64x3_1x2_h_bz_coopB_NNT": "library gemm",
}


@pytest.mark.parametrize("name", PROFILE_NAMES)
def test_profile_groups_file_each_kernel(name):
    group = next(g for g, match in chip_smoke.KERNEL_GROUPS if match(name))
    assert group == PROFILE_NAMES[name]


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
        "\t\tFunction : _ZN12_GLOBAL__N_110gmm_kernelILi16ELi128ELi1ELi4ELb0E",
        "\t\tFunction : _ZN12_GLOBAL__N_116flash_fwd_kernelILi128EEEvPK",
        "        /*0d10*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;",
    ])
    assert chip_smoke.hgmma_counts(sass) == {
        "gmm_wgmma_kernel": [2], "tgmm_wgmma_kernel": [1],
        "tgmm_kernel": [0], "gmm_kernel": [0]}
