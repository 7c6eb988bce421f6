"""Run one cell of the benchmark once:

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (``configs/<name>.json``) and a
traffic mix (``mixes/<traffic>.json``); its limits are
``limits/<workload>.json`` and each per-layer metric is read by
``metrics/<metric>.py``.

Set-up makes the weights and the token batches from the seed, builds the
port's model and optimizer on them and drives the mix's checked steps and
warm-up steps through the timed step.  Then, with ``--trace 0``, steps run
back to back for ``--seconds`` (the window) and the cell's end-to-end
metrics are printed; with ``--trace 1`` the mix's traced steps run under
``torch.profiler`` and the cell's per-layer metrics are printed.  After
the window the device's peak memory is read, the program's state is freed
and the plain reference follows the checked steps from the same seed:
``correct`` is the comparison of the two (``check.py``).

Standard output ends with a line of what the run measured on the side
(the card, its power limit and clocks, the set-up broken down, one step's
kernel launches) and then the result as one JSON object; standard error
ends with each compared number beside its limit.  Without the CUDA devices
the cell asks for, or with JAX loaded, the run prints no result and exits
with another code than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from importlib import util as import_util  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

from . import archs  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / ".portbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "kubeflow_controller_tpu")


def forbidden_modules() -> List[str]:
    """JAX and the JAX package among the loaded modules, by top-level
    name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Cell:
    workload: dict
    conf: dict
    mix: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` and its files, all
    under ``root``; the configuration records the benchmark directory it
    came from, whose ``archs/`` holds its architecture."""
    bench_dir = root / BENCH.relative_to(ROOT)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                       f"{sorted(cells)}")
    cell = cells[name]
    if cell["chips"] != 1:
        # One process drives one card; a cell over several cards needs a
        # runner that starts a rank a card.
        raise ValueError(f"{name}: the harness runs a cell on one card, not "
                         f"{cell['chips']}")
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    conf = json.loads((root / config["file"]).read_text())
    conf[archs.BENCH_KEY] = str(bench_dir)
    return Cell(
        workload=cell,
        conf=conf,
        mix=json.loads((bench_dir / "mixes" / f"{cell['traffic']}.json")
                       .read_text()),
        limits=json.loads((bench_dir / "limits" / f"{name}.json")
                          .read_text()),
        end_to_end=[m for m in bench["end_to_end"]
                    if name in m.get("workloads", [name])],
        per_layer=[m for m in bench["per_layer"]
                   if name in m.get("workloads", [name])])


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = import_util.spec_from_file_location(f"portbench_metric_{metric}",
                                               path)
    mod = import_util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

@dataclass
class Ctx:
    """What a per-layer reader reads: the configuration and mix, the
    reduced trace of ``steps`` traced steps, the launch counters' growth
    over them, the process's peak device memory and the traced steps'
    device time by the port's ``kctpu.*`` spans."""
    conf: dict
    mix: dict
    chips: int
    device_name: str
    reduced: object            # trace.Reduced
    launches: Dict[str, int]
    peak_bytes: int
    spans: object = None       # spans.SpanTimes

    @property
    def tokens_per_step(self) -> int:
        return self.mix["batch"] * self.mix["seq_len"]


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prepare(conf: dict, mix: dict, seed: int, dev):
    """(program, token batches [P, B, T] on ``dev``, weight layout, set-up
    marks): the port's model and optimizer on the seed's weights."""
    import torch

    from . import program, weights

    marks = {}
    t = time.perf_counter()
    torch.zeros(1, device=dev)
    _sync(dev)
    marks["device_init_s"] = time.perf_counter() - t
    t = time.perf_counter()
    source = program.build_kernels(dev)
    marks["kernels_s"] = time.perf_counter() - t
    marks["kernels_source"] = source
    t = time.perf_counter()
    lay = weights.layout(conf)
    flat = weights.make_flat(lay, seed, dev)
    _sync(dev)
    marks["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    prog = program.Program(conf, flat)
    _sync(dev)
    marks["model_s"] = time.perf_counter() - t
    t = time.perf_counter()
    batches = token_batches(conf, mix, seed, dev)
    marks["tokens_s"] = time.perf_counter() - t
    return prog, batches, lay, marks


def token_batches(conf: dict, mix: dict, seed: int, dev):
    """The seed's pool of token batches, [P, B, T] int32 on ``dev``."""
    import torch

    from . import tokens

    return torch.from_numpy(tokens.bigram_batches(
        seed, conf["vocab_size"], mix["batch"], mix["seq_len"],
        mix["pool_batches"])).to(dev)


def checked_steps(prog, batches, lay, seed: int, n: int
                  ) -> Tuple[dict, Dict[str, int]]:
    """The first ``n`` steps, on batches 0 .. n - 1, and what the check
    compares: their losses, the step-1 gradient's norm by leaf and by row
    of the embedding that batch 0 reads, and each leaf's change after step
    n; with the launches of step 2 (or 1)."""
    from . import check, program, weights

    losses, one, grads, rows = [], {}, {}, []
    for i in range(n):
        before = program.launch_counts()
        losses.append(prog.step(batches[i]))
        if i == 0:
            grads = prog.first_grad_norms()
            rows = prog.first_embed_rows(check.embed_ids(batches[0]))
        if i <= 1:
            after = program.launch_counts()
            one = {k: after[k] - before[k] for k in after}
    change = weights.change_norms(lay, seed, prog.leaves())
    return ({"losses": losses, "grad_norms": grads, "embed_rows": rows,
             "change_norms": change}, one)


def free(dev) -> None:
    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def _window(prog, batches, first: int, seconds: float, dev):
    """Steps back to back from batch ``first`` until ``seconds`` have
    passed: (each step's seconds, the window's seconds, non-finite
    losses)."""
    n = batches.shape[0]
    times, bad, k = [], 0, first
    _sync(dev)
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        bad += not math.isfinite(prog.step(batches[k % n]))
        b = time.perf_counter()
        times.append(b - a)
        k += 1
        if b - t0 >= seconds:
            return times, b - t0, bad


def _traced(prog, batches, first: int, steps: int, dev):
    """``steps`` steps under the profiler: (the reduced trace, the launch
    counters' growth, non-finite losses, the device time by span)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import program, spans, trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    n, bad = batches.shape[0], 0
    before = program.launch_counts()
    _sync(dev)
    with profile(activities=acts) as prof:
        for k in range(first, first + steps):
            with record_function(trace.STEP_RANGE):
                bad += not math.isfinite(prog.step(batches[k % n],
                                                   spans=True))
    after = program.launch_counts()
    return (trace.from_profiler(prof, steps),
            {k: after[k] - before[k] for k in after}, bad,
            spans.from_profiler(prof, steps))


def _percentile(xs: List[float], q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(xs), q))


def _per_layer(cell: Cell, ctx: Ctx) -> Dict[str, dict]:
    """The cell's per-layer metrics that their readers find."""
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", imports_s: float = 0.0
             ) -> Tuple[dict, dict]:
    """One run: (the result object, the side line's object)."""
    import torch

    from . import check, reference

    dev = torch.device(device)
    mix, conf = cell.mix, cell.conf
    chips = cell.workload["chips"]
    prog, batches, lay, marks = prepare(conf, mix, seed, dev)
    marks = {"imports_s": imports_s, **marks}
    t = time.perf_counter()
    mine, one_step = checked_steps(prog, batches, lay, seed,
                                   mix["checked_steps"])
    marks["checked_steps_s"] = time.perf_counter() - t
    first = mix["checked_steps"]
    t = time.perf_counter()
    for k in range(first, first + mix["warmup_steps"]):
        prog.step(batches[k % batches.shape[0]])
    marks["warmup_s"] = time.perf_counter() - t
    first += mix["warmup_steps"]
    setup_s = marks["setup_s"] = time.perf_counter() - T_START
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    extra: Dict[str, object] = {}
    side_window: Dict[str, float] = {}
    if trace:
        reduced, launches, bad, span_times = _traced(
            prog, batches, first, mix["trace_steps"], dev)
        attempted = mix["trace_steps"]
    else:
        times, window_s, bad = _window(prog, batches, first, seconds, dev)
        attempted = len(times)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if not trace:
        side_window = {"steps": attempted, "seconds": window_s,
                       "step_ms_p50": _percentile(times, 50) * 1e3}
        values = {"tokens_per_s": attempted * mix["batch"] * mix["seq_len"]
                  / window_s,
                  "step_ms_p95": _percentile(times, 95) * 1e3,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    elif reduced is None:       # no device op: nothing to read
        metrics = {}
    else:
        metrics = _per_layer(cell, Ctx(conf, mix, chips, kind, reduced,
                                       launches, peak, span_times))
        extra = {"busy_s": reduced.busy_s, "window_s": reduced.window_s}
    del prog
    free(dev)
    ref = reference.train(conf, seed, [batches[i] for i in
                                       range(mix["checked_steps"])], dev)
    read = check.readings(mine, ref)
    result = {
        "correct": check.verdict(read, cell.limits) and bad == 0,
        "attempted": attempted, "failed": bad, "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": kind, "count": chips, "memory_peak_bytes": peak,
                   **extra}}
    if extra:
        result["breakdown"] = {
            "device_ops": [list(x) for x in reduced.device_ops],
            "idle_gaps": [list(x) for x in reduced.idle_gaps]}
    result["check"] = {k: {"value": read[k], "limit": cell.limits[k]}
                       for k in check.NUMBERS
                       if cell.limits[k] is not None}
    side = {"card": _card(dev), "setup": marks,
            "launches_one_step": one_step, "window": side_window,
            "reference_s": ref["seconds"],
            "program_losses": mine["losses"],
            "reference_losses": ref["losses"]}
    return result, side


def _card(dev) -> Optional[str]:
    """The card's name, power limit and clocks, as ``nvidia-smi`` reads
    them."""
    if dev.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,clocks.mem,temperature.gpu",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"
    return out.stdout.strip() or out.stderr.strip()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    # Every build and kernel cache at a fixed path inside the checkout.
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)
    os.environ.pop("KCTPU_PROGRESS_URL", None)
    import torch

    from . import program  # noqa: F401  (the port, timed as an import)

    imports_s = time.perf_counter() - T_START
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    result, side = run_cell(cell, args.seed, args.seconds,
                            bool(args.trace), imports_s=imports_s)
    found = forbidden_modules()
    if found:
        print(f"portbench: JAX modules loaded: {found}", file=sys.stderr)
        return 4
    print("portbench: " + json.dumps(side), flush=True)
    print(json.dumps(result), flush=True)
    for k, v in result["check"].items():
        print(f"check {k}: {v['value']:.6g} (limit {v['limit']:.6g})",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
