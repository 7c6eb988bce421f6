#!/usr/bin/env python3
"""Compile ``tools/setmaxnreg_probe.cu`` with the port's nvcc flags and
report, per probe kernel, what ptxas says: registers, spill bytes, and any
warning or "Potential Performance Loss" note that names it.  Nothing runs
on the card; it needs ``nvcc`` (the CUDA toolkit), so run it where the
kernels are built:

    python3 tools/setmaxnreg_probe.py

Prints one JSON line per kernel and a verdict line: whether the consumers
of a 384-thread block compile to the registers ``setmaxnreg`` grants
(no spills at ~200 live values) or to the launch ceiling of 168.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from kubeflow_controller_tpu_torch.ops import _build  # noqa: E402

SOURCE = Path(__file__).resolve().with_suffix(".cu")
KERNELS = ("probe_else_384", "probe_return_384", "probe_plain_384",
           "probe_plain_288", "probe_wait_384ILb1ELb0E",
           "probe_wait_384ILb0ELb0E", "probe_wait_384ILb0ELb1E")


def parse(log: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads", "notes"}} from
    ptxas -v output (the mangled name of each entry contains its own)."""
    out = {k: {"registers": None, "spill_stores": None, "spill_loads": None,
               "notes": []} for k in KERNELS}
    current = None
    for line in log.splitlines():
        named = [k for k in KERNELS if k in line]
        if "Compiling entry function" in line and named:
            current = named[0]
            continue
        for k in named:
            if "Compiling entry" not in line and "Function properties" not in line:
                out[k]["notes"].append(line.strip())
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[current]["spill_stores"] = int(m.group(1))
            out[current]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m.group(1))
        if "warning" in line.lower() and not named:
            out[current]["notes"].append(line.strip())
    return out


def main() -> int:
    nvcc = _build._nvcc()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-c",
               str(SOURCE), "-o", str(Path(tmp) / "probe.o")]
        res = subprocess.run(cmd, capture_output=True, text=True)
    log = res.stdout + res.stderr
    print(log)
    if res.returncode:
        print(f"nvcc failed with {res.returncode}", file=sys.stderr)
        return res.returncode
    report = parse(log)
    for name, rec in report.items():
        print("probe: " + json.dumps({"kernel": name, **rec}))
    honoured = all(report[k]["spill_stores"] == 0 and not any(
        "C7508" in n for n in report[k]["notes"])
        for k in ("probe_else_384", "probe_return_384"))
    print("verdict: " + json.dumps({
        "setmaxnreg_honoured_else": report["probe_else_384"]["spill_stores"]
        == 0,
        "setmaxnreg_honoured_return": report["probe_return_384"][
            "spill_stores"] == 0,
        "ceiling_168_spills": report["probe_plain_384"]["spill_stores"],
        "ceiling_224_spills": report["probe_plain_288"]["spill_stores"],
        "waits_cxx_trap_spills": report["probe_wait_384ILb1ELb0E"][
            "spill_stores"],
        "waits_ptx_block_spills": report["probe_wait_384ILb0ELb0E"][
            "spill_stores"],
        "waits_ptx_block_syncthreads_spills": report[
            "probe_wait_384ILb0ELb1E"]["spill_stores"],
        "honoured": honoured}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
