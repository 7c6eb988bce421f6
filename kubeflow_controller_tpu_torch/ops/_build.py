"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

At first use, every ``csrc/*.cu`` is compiled for ``sm_90a`` — one
``nvcc`` process per source, all started together — and linked into one
shared library with a plain C interface.  The library lands in
``build/`` inside this package (listed in ``.gitignore``) under a name
keyed by the content hash of every file under ``csrc/`` (headers such as
``hopper.cuh`` included), so an edited source or header never loads a
stale build and a rebuilt checkout reuses nothing it should not.

The library records where it came from (``compile_source``):
``"compiled"`` when ``nvcc`` ran, ``"cache-hit"`` when the library of the
same content was already in ``build/``.  The workloads run the build
inside their progress reporter's compile window
(``workloads/compile_cache.py``) and beat that source.

A build failure raises with the compiler's output.  Nothing here runs at
import time: the CPU tests import every module of the port on hosts that
have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

import torch

CACHE_HIT = "cache-hit"   # the build's output was already there
COMPILED = "compiled"     # nvcc ran

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              *ARCH_FLAGS]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their signatures (pointers and the stream as void*,
# sizes and flags as int, scales as float; the return value is a
# cudaError_t code).
_SIGNATURES = {
    # lhs, rhs, tile_experts, valid_tiles (or NULL), out, M, K, N, bm,
    # n_experts, transpose_rhs, stream
    "kctpu_gmm_swapab": ([_P] * 5 + [_I] * 6 + [_P], _I),
    # the same arguments as kctpu_gmm_swapab
    "kctpu_gmm_wgmma": ([_P] * 5 + [_I] * 6 + [_P], _I),
    # lhs, rhs_g, rhs_u, tile_experts, h, gate (or NULL), up (or NULL), M, K,
    # N, bm, n_experts, stream
    "kctpu_gmm_swiglu_swapab": ([_P] * 7 + [_I] * 5 + [_P], _I),
    # the same arguments as kctpu_gmm_swiglu_swapab
    "kctpu_gmm_swiglu_wgmma": ([_P] * 7 + [_I] * 5 + [_P], _I),
    # lhs, dout, tile_experts, valid_tiles (or NULL), out, M, K, N, bm,
    # n_experts, stream
    "kctpu_tgmm": ([_P] * 5 + [_I] * 5 + [_P], _I),
    # the same arguments as kctpu_tgmm
    "kctpu_tgmm_wgmma": ([_P] * 5 + [_I] * 5 + [_P], _I),
    # q, k, v, o, lse, B, H, T, D, scale, causal, stream
    "kctpu_flash_fwd": ([_P] * 5 + [_I] * 4 + [_F, _I, _P], _I),
    # q, k, v, do, lse, delta, dq, B, H, T, D, scale, causal, stream
    "kctpu_flash_dq": ([_P] * 7 + [_I] * 4 + [_F, _I, _P], _I),
    # q, k, v, do, lse, delta, dk, dv, B, H, T, D, scale, causal, stream
    "kctpu_flash_dkv": ([_P] * 8 + [_I] * 4 + [_F, _I, _P], _I),
    "kctpu_error_string": ([_I], ctypes.c_char_p),
}


class KernelLibrary:
    """The loaded shared library plus what its build printed."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float,
                 log: str, compile_source: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self.compile_source = compile_source   # "compiled" | "cache-hit"

    def check(self, code: int, what: str) -> None:
        """Raise if a C entry point returned a CUDA error code."""
        if code != 0:
            msg = self.lib.kctpu_error_string(code).decode()
            raise RuntimeError(f"{what} launch failed: CUDA error {code} "
                               f"({msg})")


_LOCK = threading.Lock()
_LIBRARY: Optional[KernelLibrary] = None


def sources() -> List[Path]:
    """The translation units: one object each."""
    return sorted(CSRC_DIR.glob("*.cu"))


def key_files() -> List[Path]:
    """Every file the build reads: the sources and what they include."""
    return sorted(p for p in CSRC_DIR.iterdir() if p.is_file())


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA kernels "
                           "are built from source at first use")
    return found


def _content_key(files: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in files:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> str:
    """Run the commands in parallel; raise with the output of any that
    failed, else return their combined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [(c, o) for c, p, o in zip(cmds, procs, outs) if p.returncode]
    if failed:
        detail = "\n".join(f"$ {' '.join(c)}\n{o}" for c, o in failed)
        raise RuntimeError(f"kernel build failed:\n{detail}")
    return "".join(outs)


def build() -> KernelLibrary:
    """Compile (unless a build of the same content exists) and load."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    lib_path = BUILD_DIR / f"libkctpu_kernels_{_content_key(key_files())}.so"
    t0 = time.perf_counter()
    log = ""
    source = CACHE_HIT if lib_path.exists() else COMPILED
    if source == COMPILED:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [Path(tmp) / f"{s.stem}.o" for s in srcs]
            log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                            for s, o in zip(srcs, objs)])
            staged = Path(tmp) / lib_path.name
            log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o",
                              str(staged), *map(str, objs)]])
            os.replace(staged, lib_path)
    build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return KernelLibrary(lib, lib_path, build_seconds, log, source)


def stream(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device: every
    kernel launches there."""
    return torch.cuda.current_stream(t.device).cuda_stream


def library() -> KernelLibrary:
    """The process's kernel library, built and loaded on first call."""
    global _LIBRARY
    with _LOCK:
        if _LIBRARY is None:
            _LIBRARY = build()
        return _LIBRARY
