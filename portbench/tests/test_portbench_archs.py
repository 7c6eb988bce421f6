"""The architecture modules (``archs/<model_type>.py``): Mistral's and
Mixtral's give the harness exactly what it computed before they were
modules (``archs_goldens.json``, recorded from the harness of that time:
the layouts at the published sizes, the reference's steps at the tiny
size on the CPU, the readers on one synthetic traced window a cell); a
model of a new ``model_type`` reaches the harness as new files only; an
unknown ``model_type`` names the file it looked for."""

import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from portbench import archs, reference, roofline, run, trace, weights

from ._tiny import tiny_cell

GOLDENS = json.loads((Path(__file__).parent / "archs_goldens.json")
                     .read_text())
BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CPU = torch.device("cpu")
H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_layout_is_unchanged(config):
    conf = json.loads((run.ROOT / config["file"]).read_text())
    lay = weights.layout(conf)
    want = GOLDENS["layouts"][config["name"]]
    assert (len(lay.leaves), lay.total, lay.chunks()) == (
        len(want["leaves"]), want["total"], want["chunks"])
    assert [[lf.name, list(lf.shape), lf.offset, lf.scale]
            for lf in lay.leaves] == want["leaves"]


@pytest.mark.parametrize("name", sorted(GOLDENS["reference"]["cells"]))
def test_reference_steps_are_unchanged(name):
    seed = GOLDENS["reference"]["seed"]
    want = GOLDENS["reference"]["cells"][name]
    cell = tiny_cell(name)
    n = cell.mix["checked_steps"]
    batches = list(run.token_batches(cell.conf, cell.mix, seed, CPU)[:n])
    assert sorted(want) == sorted(["bf16"] + cell.conf["control"])
    for precision, numbers in want.items():
        got = reference.train(cell.conf, seed, batches, CPU,
                              precision=precision)
        got.pop("seconds")
        assert got == numbers, precision


def _ctx(rec: dict) -> run.Ctx:
    cell = run.load_cell(rec["workload"])
    red = trace.Reduced(steps=rec["steps"], window_s=rec["window_s"],
                        busy_s=rec["busy_s"], launches=rec["launches_total"],
                        group_us=dict(rec["group_us"]),
                        optimizer_us=rec["optimizer_us"])
    return run.Ctx(cell.conf, cell.mix, 1, H100, red, dict(rec["launches"]),
                   40e9)


@pytest.mark.parametrize("rec", GOLDENS["readers"],
                         ids=[r["workload"] for r in GOLDENS["readers"]])
def test_readers_are_unchanged(rec):
    ctx = _ctx(rec)
    assert {m: run.reader(m)(ctx) for m in rec["expected"]} == \
        rec["expected"]


# ---------------------------------------------------------------------------
# A new architecture as new files only
# ---------------------------------------------------------------------------

TOY_ARCH = '''
"""A made-up decoder: the shared decoder's dense layers with a causal
window of ``sliding_window`` keys on the odd layers, and a learnt scale on
the embedding (``embed_scale``, one leaf more)."""

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.archs import _decoder
from portbench.reference import Math

KEYS = _decoder.LAYER_KEYS + _decoder.DENSE_KEYS


def _window(conf, i):
    return conf["sliding_window"] if i % 2 else None


def leaves(conf):
    return [("embed_scale", (conf["hidden_size"],), 0.0)] + \\
        _decoder.leaves(conf)


def attention_layers(conf):
    h, kv, hd, _ = _decoder.attention_layers(conf)[0]
    return [(h, kv, hd, _window(conf, i))
            for i in range(conf["num_hidden_layers"])]


def expert_ffn(conf):
    return None


def matmul_params_per_token(conf):
    return _decoder.matmul_params_per_token(conf)


def model_flops_per_token(conf, seq_len):
    pairs = 0.0
    for h, _, hd, w in attention_layers(conf):
        w = min(w or seq_len, seq_len)
        pairs += 12.0 * h * hd * (seq_len ** 2 - (seq_len - w) ** 2) / 2
    return 6.0 * matmul_params_per_token(conf) + pairs / seq_len


def port_keys(conf):
    return _decoder.port_keys(conf)


def loss(conf, params, tokens, precision):
    m = Math(conf, precision)
    b, t = tokens.shape
    h, kv, hd, _ = attention_layers(conf)[0]
    cos, sin = _decoder.rope_tables(conf, t, tokens.device)
    pos = torch.arange(t, device=tokens.device)

    def layer(window):
        keep = pos[None, :] <= pos[:, None]
        if window:
            keep = keep & (pos[:, None] - pos[None, :] < window)

        def run(x, attn_norm, wq, wk, wv, wo, mlp_norm, w_gate, w_up,
                w_down):
            a = m.norm(x, attn_norm)
            q = _decoder.rope(m.lin(a, wq.flatten(1)).view(b, t, h, hd),
                              cos, sin)
            k = _decoder.rope(m.lin(a, wk.flatten(1)).view(b, t, kv, hd),
                              cos, sin)
            v = m.lin(a, wv.flatten(1)).view(b, t, kv, hd)
            k, v = (z.repeat_interleave(h // kv, dim=2) for z in (k, v))
            o = F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=keep)
            x = x + m.lin(o.transpose(1, 2).flatten(2), wo.flatten(0, 1))
            a = m.norm(x, mlp_norm)
            return x + m.lin(F.silu(m.lin(a, w_gate)) * m.lin(a, w_up),
                             w_down)

        return run

    x = m.norm(params["embed"][tokens.long()].to(m.act),
               params["embed_scale"])
    for i in range(conf["num_hidden_layers"]):
        lp = [params[f"layers.{i}.{k}"] for k in KEYS]
        x = checkpoint(layer(_window(conf, i)), x, *lp, use_reentrant=False)
    logits = m.lin(m.norm(x, params["final_norm"]), params["lm_head"]).float()
    return F.cross_entropy(logits[:, :-1].flatten(0, 1),
                           tokens[:, 1:].flatten().long())
'''

TOY_CONF = {
    "source": "made up for the tests", "model_type": "toywindow",
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 4,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "vocab_size": 256, "max_position_embeddings": 64, "rope_theta": 1e4,
    "rms_norm_eps": 1e-5, "sliding_window": 16, "reduced": [],
    "published": {}, "control": ["fp8"],
    "training": {"lr": 3e-3, "weight_decay": 0.1, "clip_norm": 1.0,
                 "beta1": 0.9, "beta2": 0.999, "eps": 1e-8},
    "port": {"dtype": "bfloat16"}}
TOY_MIX = {"why": "made up", "batch": 2, "seq_len": 64, "pool_batches": 6,
           "checked_steps": 3, "warmup_steps": 1, "trace_steps": 1}


@pytest.fixture
def toy_tree(tmp_path):
    """A copy of the benchmark's files with one model added as new files:
    its configuration, its architecture module, a mix and limits."""
    shutil.copytree(run.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({
        "name": "toy-l4", "source": "made up",
        "file": "portbench/configs/toy-l4.json", "reduced": [],
        "why": "a windowed decoder"})
    bench["workloads"].append({
        "name": "toy-train", "config": "toy-l4", "traffic": "toy-mix",
        "chips": 1, "why": "a windowed decoder's steps"})
    for m in bench["per_layer"]:
        if m["name"] in ("mfu", "flash_roofline", "gmm_roofline"):
            m["workloads"].append("toy-train")
    files = {"BENCHMARK.json": bench,
             "portbench/configs/toy-l4.json": TOY_CONF,
             "portbench/mixes/toy-mix.json": TOY_MIX,
             "portbench/limits/toy-train.json": {
                 "loss": None, "grad": 1e-2, "embed_rows": 1e-2,
                 "change": 1e-2}}
    for rel, data in files.items():
        (tmp_path / rel).write_text(json.dumps(data))
    (tmp_path / "portbench/archs/toywindow.py").write_text(TOY_ARCH)
    return tmp_path


def test_a_new_architecture_is_new_files_only(toy_tree):
    with pytest.raises(FileNotFoundError):
        archs.load("toywindow")            # not in the benchmark itself
    cell = run.load_cell("toy-train", toy_tree)
    assert [m["name"] for m in cell.per_layer] == [
        "mfu", "flash_roofline", "gmm_roofline"]
    conf, mix = cell.conf, cell.mix

    lay = weights.layout(conf)
    names = [lf.name for lf in lay.leaves]
    assert names[0] == "embed_scale" and "embed" in names
    assert len(names) == 1 + len(weights.layout(
        dict(conf, model_type="mistral")).leaves)

    n = mix["checked_steps"]
    batches = list(run.token_batches(conf, mix, 5, CPU)[:n])
    ref = reference.train(conf, 5, batches, CPU)
    assert ref["losses"][2] < ref["losses"][0]
    assert ref["grad_norms"]["embed_scale"] > 0
    assert ref["change_norms"]["embed_scale"] > 0

    # The window changes the reference: the same model without it.
    full = reference.train(dict(conf, sliding_window=None), 5, batches, CPU)
    assert full["losses"][0] != ref["losses"][0]

    # Two launches of each flash kernel over the four layers, two of them
    # windowed: each launch charged the mean of a windowed and a full
    # layer's least time.
    launches = {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2, "gmm": 4}
    group_us = {g: 0.0 for g, _ in trace.GROUPS}
    group_us.update(flash_fwd=10.0, flash_dq=10.0, flash_dkv=10.0, gmm=10.0)
    red = trace.Reduced(steps=1, window_s=1e-3, busy_s=9e-4, launches=8,
                        group_us=group_us, optimizer_us=0.0)
    ctx = run.Ctx(conf, mix, 1, H100, red, launches, 1e9)
    read = {m["name"]: run.reader(m["name"])(ctx) for m in cell.per_layer}
    peak = roofline.PEAKS[H100]
    shape = (2, 64, 4, 2, 16)
    least = sum(2 * (roofline.least_seconds(*f(*shape), peak)
                     + roofline.least_seconds(*f(*shape, window=16), peak))
                / 2 for f in (roofline.flash_fwd, roofline.flash_dq,
                              roofline.flash_dkv))
    assert read["flash_roofline"] == pytest.approx(100 * least / 30e-6)
    assert read["gmm_roofline"] is None     # no experts in this model
    toy = archs.of(conf)
    flops = toy.model_flops_per_token(conf, 64) * 2 * 64
    assert read["mfu"] == pytest.approx(100 * flops / (1e-3 * peak[0]))
    assert flops < roofline.model_flops_per_token(
        dict(conf, model_type="mistral"), 64) * 2 * 64


def test_a_window_counts_the_pairs_it_keeps():
    # B 2, T 64, H 4, D 16, W 16: a head keeps 64²/2 - 48²/2 = 896 score
    # pairs; a product is 2 x 2 x 4 x 896 x 16 = 229,376 FLOPs, the forward
    # two products.
    assert roofline.flash_fwd(2, 64, 4, 2, 16, window=16)[0] == 458_752
    assert roofline.flash_dq(2, 64, 4, 2, 16, window=16)[0] == 229_376
    assert roofline.flash_dkv(2, 64, 4, 2, 16, window=16)[0] == 917_504
    causal = roofline.flash_fwd(2, 64, 4, 2, 16)
    assert causal[0] == 1_048_576
    for w in (64, 100):
        assert roofline.flash_fwd(2, 64, 4, 2, 16, window=w) == causal
    assert roofline.flash_fwd(2, 64, 4, 2, 16, window=16)[1] == causal[1]
    with pytest.raises(ValueError):
        roofline.flash_fwd(2, 64, 4, 2, 16, causal=False, window=16)


def test_an_unknown_model_type_names_the_file(tmp_path):
    with pytest.raises(FileNotFoundError, match=r"archs/no_such_model\.py"):
        archs.load("no_such_model")
    conf = dict(json.loads((run.BENCH / "configs" / "mistral-7b-l8.json")
                           .read_text()), model_type="no_such_model")
    with pytest.raises(FileNotFoundError, match=r"no_such_model\.py"):
        weights.layout(conf)
    conf[archs.BENCH_KEY] = str(tmp_path)
    with pytest.raises(FileNotFoundError, match=re.escape(
            str(tmp_path / "archs" / "no_such_model.py"))):
        roofline.model_flops_per_token(conf, 64)
    with pytest.raises(FileNotFoundError, match=r"_decoder\.py"):
        archs.load("_decoder")             # shared code, not a model
