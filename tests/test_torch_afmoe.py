"""The "afmoe" block (Trinity-Mini's AFMoE) on the port's single-card
training path, held to the benchmark's plain reference
(``portbench/archs/afmoe.py``) on the CPU at a tiny size, in float32:

- the loss and every leaf's gradient over 3 steps, the expert bias
  stepping between them as the reference steps it;
- one card's share of the experts: the two halves' routed outputs plus
  the shared expert, counted once, are the uncut layer's;
- the flash kernels' plain versions under a causal window against a masked
  softmax, forward and gradients, and the window as the kernel wrappers
  hand it to C; on a card (``card`` tests: ``python3 -m pytest
  --noconftest -p no:cacheprovider -m card tests/test_torch_afmoe.py``)
  the windowed kernels against the plain versions, at Trinity-Mini's
  shape too;
- the Mistral and Mixtral configurations build the leaves and the loss
  they built before the block existed;
- the paths that do not take the block refuse it by name, and the
  "llama" block refuses the fields of the block's share.
"""

import copy
import importlib
import json
import math
import types

import pytest
import torch
import torch.nn.functional as F

from kubeflow_controller_tpu_torch.models import llama as tllama
from kubeflow_controller_tpu_torch.models import moe as tmoe
from kubeflow_controller_tpu_torch.ops import _build
from kubeflow_controller_tpu_torch.ops import attention as tat
from kubeflow_controller_tpu_torch.workloads import llama_pretrain
from portbench import archs, check, program, reference, run, weights
from portbench.archs import _decoder

# The module, which the package's ``generate`` function shadows.
tgen = importlib.import_module("kubeflow_controller_tpu_torch.models.generate")
torch.set_num_threads(2)

CELL = "trinitymini-train-b4-t8192"
SEED = 2 ** 31 + 777
# The tiny size: 4 layers (1 dense; sliding, sliding, sliding, global), a
# window of 12 under T 32, 8 routed experts of which 4 are held, top 2, a
# shared expert, a head width (32) that is not dim / heads (16).  The bias
# rate is larger than the published one so that 3 steps move routing.
TINY = {"hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 32, "intermediate_size": 96,
        "moe_intermediate_size": 32, "num_hidden_layers": 4,
        "num_dense_layers": 1, "num_experts": 4, "num_experts_per_tok": 2,
        "sliding_window": 12, "vocab_size": 256,
        "max_position_embeddings": 64, "load_balance_coeff": 0.05}
PORT = {"vocab_size": 256, "dim": 64, "n_layers": 4, "n_heads": 4,
        "n_kv_heads": 2, "head_width": 32, "intermediate": 96,
        "max_seq_len": 64, "window": 12, "dense_layers": 1, "n_experts": 8,
        "experts_held": 4, "moe_top_k": 2, "expert_intermediate": 32,
        "bias_rate": 0.05, "loss_chunks": 2, "dtype": "float32"}
MIX = {"batch": 2, "seq_len": 32, "pool_batches": 6, "checked_steps": 3,
       "warmup_steps": 1, "trace_steps": 1}
# float32 on both sides: the products, softmaxes and sums differ in their
# order only, a few ulps a value, so 1e-5 of a loss and 1e-4 of a leaf's
# gradient norm leave a hundredfold room; a program that drops the window,
# the gate or the bias step reads far above (checked below).
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# The cell's comparison at this size, in float32.
LIMITS = {"loss": 1e-5, "grad": 1e-4, "embed_rows": 1e-4, "change": 1e-4}
CPU = torch.device("cpu")


def tiny_cell() -> run.Cell:
    cell = copy.deepcopy(run.load_cell(CELL))
    cell.conf.update(TINY)
    cell.conf["published"]["num_experts"] = 8
    cell.conf["port"].update(PORT)
    cell.mix.update(MIX)
    cell.limits = dict(LIMITS)
    return cell


def _program(conf):
    lay = weights.layout(conf)
    flat = weights.make_flat(lay, SEED, CPU)
    ref = {k: v.clone().requires_grad_()
           for k, v in lay.views(flat.clone()).items()}
    return program.Program(conf, flat), ref


def _tokens(conf, n=3):
    return run.token_batches(conf, MIX, SEED, CPU)[:n]


def _gap(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def test_port_follows_the_reference_over_three_steps():
    cell = tiny_cell()
    conf = cell.conf
    prog, ref = _program(conf)
    model, cfg = prog.model, prog.cfg
    afmoe = archs.of(conf)
    moe_layers = [i for i, lp in enumerate(model.layers) if lp.moe]
    assert moe_layers == [1, 2, 3]
    assert [lp.window for lp in model.layers] == [12, 12, 12, None]
    lr = 0.05
    biased = False
    for step, tokens in enumerate(_tokens(conf)):
        loss = tllama.llama_loss(model, tokens, cfg)
        loss.backward()
        ref_loss = afmoe.loss(conf, ref, tokens, "bf16")
        ref_loss.backward()
        assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()),
                                                     rel=LOSS_RTOL)
        for name, p in prog.params.items():
            assert _gap(p.grad, ref[name].grad) <= GRAD_RTOL, (step, name)
        for i in moe_layers:
            # The port stepped its bias in the backward; the reference
            # steps it at its next call, from the counts it recorded.
            counts = ref[f"_afmoe.counts.{i}"]
            want = ref[f"_afmoe.bias.{i}"] + PORT["bias_rate"] * torch.sign(
                counts.mean() - counts)
            assert torch.equal(model.layers[i].expert_bias, want), (step, i)
            assert counts.sum() == MIX["batch"] * MIX["seq_len"] * 2
            biased |= bool(want.any())
        with torch.no_grad():
            for name, p in prog.params.items():
                p -= lr * p.grad
                ref[name] -= lr * ref[name].grad
                p.grad = ref[name].grad = None
    assert biased


def test_the_cell_at_a_tiny_size_is_correct():
    res, side = run.run_cell(tiny_cell(), SEED, 0.2, False, "cpu")
    assert res["correct"], res["check"]
    assert side["program_losses"][2] < side["program_losses"][0]


def test_a_program_without_the_window_is_caught():
    cell = tiny_cell()
    mine, _ = _checked(cell, window=0)
    batches = list(_tokens(cell.conf))
    ref = reference.train(cell.conf, SEED, batches, CPU)
    assert not check.verdict(check.readings(mine, ref), cell.limits)


def _checked(cell, **port):
    conf = copy.deepcopy(cell.conf)
    conf["port"].update(port)
    prog, _ = _program(conf)
    lay = weights.layout(conf)
    return run.checked_steps(prog, _tokens(conf), lay, SEED, 3)


def test_the_shares_add_up_to_the_uncut_layer():
    conf = tiny_cell().conf
    conf = dict(conf, num_experts=8)
    m = reference.Math(conf, "bf16")
    g = torch.Generator().manual_seed(5)
    d, f, e, k = 64, 32, 8, 2

    def rnd(*shape, scale=0.1):
        return torch.randn(shape, generator=g) * scale

    x = rnd(2, 16, d, scale=1.0)
    router, wg, wu, wd = rnd(d, e), rnd(e, d, f), rnd(e, d, f), rnd(e, f, d)
    sg, su, sd = rnd(d, f), rnd(d, f), rnd(f, d)
    bias = rnd(e, scale=0.05)
    halves = sum(tmoe.biased_moe_ffn(
        x, router, wg[lo:lo + 4], wu[lo:lo + 4], wd[lo:lo + 4], bias,
        top_k=k, route_scale=conf["route_scale"], first_expert=lo)
        for lo in (0, 4))
    shared = F.silu(x @ sg) * (x @ su) @ sd
    mod = archs.of(conf)
    whole = mod._routed(conf, m, x, router, wg, wu, wd, bias,
                        lambda counts: None).view(x.shape)
    whole = whole + mod._swiglu(m, x, sg, su, sd)
    assert _gap(halves + shared, whole) <= 1e-6
    # Each half alone is not the layer.
    one = tmoe.biased_moe_ffn(x, router, wg[:4], wu[:4], wd[:4], bias,
                              top_k=k, route_scale=conf["route_scale"])
    assert _gap(one + shared, whole) > 0.1


# ---------------------------------------------------------------------------
# The window in the flash kernels' plain versions and wrappers
# ---------------------------------------------------------------------------

B, T, H, D = 2, 96, 2, 16


def _masked_attention(q, k, v, window):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    pos = torch.arange(q.shape[1])
    ahead = pos[:, None] - pos[None, :]
    s = s.masked_fill((ahead < 0) | (ahead >= window), float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


@pytest.mark.parametrize("window", [37, T, T + 10, 1])
def test_plain_flash_takes_a_window(window):
    g = torch.Generator().manual_seed(window)
    q, k, v, do = (torch.randn(B, T, H, D, generator=g) for _ in range(4))
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    want = _masked_attention(qg, kg, vg, window)
    dq_w, dk_w, dv_w = torch.autograd.grad(want, (qg, kg, vg), do)
    o, lse = tat.flash_fwd_plain(q, k, v, window=window)
    delta = torch.einsum("bthd,bthd->bht", do, o).reshape(B * H, T)
    dq = tat.flash_dq_plain(q, k, v, do, lse, delta, window=window)
    dk, dv = tat.flash_dkv_plain(q, k, v, do, lse, delta, window=window)
    # W 1: each row sees itself alone, so dk is zero and only an absolute
    # tolerance compares it.
    for got, ref in ((o, want), (dq, dq_w), (dk, dk_w), (dv, dv_w)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    if window >= T:                          # no narrower than causal
        assert torch.equal(o, tat.flash_fwd_plain(q, k, v)[0])
    else:
        assert _gap(o, tat.flash_fwd_plain(q, k, v)[0]) > 1e-3
    # The differentiable op on the CPU, the same.
    o2 = tat.flash_attention(qg, kg, vg, window=window)
    assert _gap(o2, want) <= 1e-5
    grads = torch.autograd.grad(o2, (qg, kg, vg), do)
    for got, ref in zip(grads, (dq_w, dk_w, dv_w)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels run only there")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("shape,window", [
    ((4, 8192, 32, 128), 2048),      # Trinity-Mini's sliding layers
    ((1, 512, 2, 128), 100),         # W not a multiple of a tile
    ((2, 320, 2, 128), 64),          # T = 64 (mod 128)
    ((1, 512, 4, 64), 2),            # each row sees itself and one more
    ((1, 192, 3, 64), 130)])
def test_windowed_kernels_are_the_plain_versions(cuda, shape, window):
    import chip_smoke

    gen = torch.Generator(device=cuda).manual_seed(window)
    q, k, v, do = (torch.randn(shape, generator=gen, device=cuda).to(
        torch.bfloat16) for _ in range(4))
    before = [fn.skip_launches for fn in (tat.flash_fwd, tat.flash_dq,
                                          tat.flash_dkv)]
    chip_smoke.flash_check(f"window {window}", q, k, v, do, window=window)
    assert [fn.skip_launches for fn in (tat.flash_fwd, tat.flash_dq,
                                        tat.flash_dkv)] == [
        n + 1 for n in before]
    torch.cuda.empty_cache()


@pytest.mark.card
def test_a_window_past_t_is_the_causal_call(cuda):
    import chip_smoke

    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn((1, 256, 2, 128), generator=gen,
                               device=cuda).to(torch.bfloat16)
                   for _ in range(4))
    wide = chip_smoke.flash_run(q, k, v, do, window=300)
    causal = chip_smoke.flash_run(q, k, v, do)
    for key in ("o", "lse", "dq", "dk", "dv"):
        assert torch.equal(wide[key], causal[key]), key


class _Recorder:
    def __init__(self):
        self.calls = []
        calls = self.calls

        class Lib:
            def __getattr__(self, name):
                return lambda *args: calls.append((name, args)) or 0

        self.lib = Lib()

    def check(self, code, what):
        assert code == 0, what


@pytest.mark.parametrize("window,passed", [(2048, 2048), (100, 100),
                                           (8192, 0), (None, 0)])
def test_the_wrappers_hand_the_window_to_c(monkeypatch, window, passed):
    rec = _Recorder()
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(_build, "stream", lambda t: 7)
    b, t, h, d = 1, 8192, 2, 128
    q, k, v, do = (torch.empty(b, t, h, d, dtype=torch.bfloat16,
                               device="meta") for _ in range(4))
    lse, delta = (torch.empty(b * h, t, device="meta") for _ in range(2))
    fns = (tat.flash_fwd, tat.flash_dq, tat.flash_dkv)
    before = [(fn.launches, fn.skip_launches) for fn in fns]
    tat.flash_fwd(q, k, v, window=window)
    tat.flash_dq(q, k, v, do, lse, delta, window=window)
    tat.flash_dkv(q, k, v, do, lse, delta, window=window)
    assert [name for name, _ in rec.calls] == [
        "kctpu_flash_fwd", "kctpu_flash_dq", "kctpu_flash_dkv"]
    for (name, args) in rec.calls:
        assert len(args) == len(_build._SIGNATURES[name][0])
        assert args[-3:] == (1, passed, 7), name
    after = [(fn.launches, fn.skip_launches) for fn in fns]
    assert after == [(n + 1, s + bool(passed)) for n, s in before]
    assert {f"{fn.__name__}_skip" for fn in fns} <= set(
        program.launch_counts())


def test_a_window_is_causal_and_at_least_one_key():
    q = torch.zeros(1, 64, 1, 16)
    with pytest.raises(ValueError, match="causal"):
        tat.flash_fwd_plain(q, q, q, causal=False, window=8)
    with pytest.raises(ValueError, match="at least one key"):
        tat.flash_attention(q, q, q, window=0)


# ---------------------------------------------------------------------------
# The configurations that were there, and the paths that refuse the block
# ---------------------------------------------------------------------------

# Computed by the port before the "afmoe" block was added (f32, remat
# "full", chunked loss, seed 3, tokens of seed 4): each tiny decoder's loss
# and its gradient's global norm.
BEFORE = {"mistral": (dict(n_kv_heads=2), 5.55836296081543,
                      1.661980747043223),
          "mixtral": (dict(n_kv_heads=2, n_experts=4, moe_top_k=2,
                           moe_dispatch="grouped", moe_aux_coef=0.02,
                           moe_z_coef=0.0), 5.572152137756348,
                      1.5890410437698688)}


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_mistral_and_mixtral_keep_their_loss(name):
    overrides, loss_before, grad_before = BEFORE[name]
    cfg = tllama.LlamaConfig.tiny(remat=True, loss_chunks=2, **overrides)
    model = tllama.llama_init(cfg, torch.Generator().manual_seed(3), "cpu",
                              requires_grad=True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(4))
    loss = tllama.llama_loss(model, tokens, cfg)
    loss.backward()
    grad = math.sqrt(sum(float(p.grad.double().norm()) ** 2
                         for p in model.parameters()))
    assert float(loss) == pytest.approx(loss_before, rel=1e-6)
    assert grad == pytest.approx(grad_before, rel=1e-6)
    assert not [n for n, _ in model.named_buffers()]


@pytest.mark.parametrize("config", ["mistral-7b-l8", "mixtral-8x7b-l2",
                                    "trinity-mini-l8-e64"])
def test_a_configuration_builds_its_leaves(config):
    conf = json.loads((run.BENCH / "configs" / f"{config}.json").read_text())
    model = tllama.Llama(tllama.LlamaConfig(**conf["port"]), "meta")
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    want = {n: tuple(s) for n, s, _ in archs.of(conf).leaves(conf)}
    assert got == want
    if conf["model_type"] != "afmoe":
        assert archs.of(conf).leaves is _decoder.leaves
        assert not [n for n, _ in model.named_buffers()]


def _afmoe_cfg(**overrides):
    return tllama.LlamaConfig(**dict(tiny_cell().conf["port"], **overrides))


def test_the_other_paths_refuse_the_block_by_name():
    cfg = _afmoe_cfg()
    model = tllama.Llama(cfg, "cpu")
    tokens = torch.zeros(2, 32, dtype=torch.long)
    mesh = types.SimpleNamespace(mesh_dim_names=("dp",))
    with pytest.raises(ValueError, match="block='afmoe'"):
        tllama.llama_loss(model, tokens, cfg, mesh=mesh)
    with pytest.raises(ValueError, match="block='afmoe'"):
        tllama.llama_forward_pp(model, tokens, cfg, n_stages=2)
    with pytest.raises(ValueError, match="block='afmoe'"):
        tgen.init_cache(cfg, 1, 32, device="cpu")
    with pytest.raises(ValueError, match="window=12"):
        tgen.init_paged_cache(tllama.LlamaConfig.tiny(window=12), 4, 8,
                              device="cpu")


@pytest.mark.parametrize("field,value", [("shared_experts", 1),
                                         ("experts_held", 2)])
def test_the_llama_block_refuses_the_share_fields(field, value):
    # The softmax router's FFN would build a shared expert no forward
    # reads, or route over experts the layer does not hold.
    with pytest.raises(ValueError, match=f"{field}={value}"):
        tllama.LlamaConfig.tiny(n_experts=4, **{field: value})


def test_llama_pretrain_trains_the_block():
    cfg = _afmoe_cfg(remat=True)
    res = llama_pretrain.train(cfg, steps=2, batch_size=2, seq_len=32,
                               device="cpu", seed=0)
    assert len(res.losses) == 2 and all(map(math.isfinite, res.losses))
