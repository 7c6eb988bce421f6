"""Every file the benchmark finds by name is there and loads: the cells of
``BENCHMARK.json``, their configurations, mixes, limits and per-layer
readers; and each configuration's port keys are its published keys, as
its architecture (``archs/<model_type>.py``) pairs them."""

import json
import math
import re

import pytest

from portbench import archs, check, reference, run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for cell in CELLS:
        reported = [m for m in e2e.values()
                    if cell in m.get("workloads", [cell])]
        assert "setup_s" in [m["name"] for m in reported]
        assert len(reported) >= 2


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    c = run.load_cell(cell)
    assert c.conf["control"]
    assert set(c.conf["control"]) <= set(reference.PRECISIONS[1:])
    assert set(c.limits) == set(check.NUMBERS)
    assert any(v is not None for v in c.limits.values())
    assert set(c.mix) == {"why", "batch", "seq_len", "pool_batches",
                          "checked_steps", "warmup_steps", "trace_steps"}
    assert c.mix["pool_batches"] > c.mix["checked_steps"] + \
        c.mix["warmup_steps"]
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(run.reader(m["name"]))
        assert m["moves"] in [e["name"] for e in c.end_to_end]


def test_a_cell_on_several_cards_is_refused(tmp_path):
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"][0]["chips"] = 4
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError, match="one card"):
        run.load_cell(CELLS[0], tmp_path)


def test_per_layer_metrics_have_readers_and_one_layer_name():
    layers = {}
    for m in BENCH["per_layer"]:
        assert (run.BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert set(m["workloads"]) <= set(CELLS)
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) == {"training step", "model", "MoE", "optimizer",
                           "kernels", "device"}


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_is_its_published_keys(config):
    conf = json.loads((run.ROOT / config["file"]).read_text())
    assert conf["source"] == config["source"]
    assert conf["reduced"] == config["reduced"]
    assert set(conf["published"]) == set(config["reduced"])
    # The port's head width is its ``head_dim`` or, without one,
    # ``dim // n_heads`` (``LlamaConfig.head_dim``).
    port = {"head_dim": conf["port"]["dim"] // conf["port"]["n_heads"],
            **conf["port"]}
    for mine, published in archs.of(conf).port_keys(conf):
        assert port[mine] == published, mine
    assert port["dtype"] == "bfloat16" and port["param_dtype"] == "float32"
    assert math.isclose(conf["training"]["lr"], 3e-4)
