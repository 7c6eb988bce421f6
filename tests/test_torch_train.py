"""Port parity: the single-device pretrain path of
``kubeflow_controller_tpu_torch`` (``models/llama.py`` forward and loss,
``workloads/{data,trainer,runtime,llama_pretrain}.py``) against the JAX
package, from JAX parameters bridged into the port.

- ``llama_loss`` and every parameter gradient against
  ``jax.value_and_grad(llama_loss)`` on ``LlamaConfig.tiny`` (f32), dense
  and GQA, across attention "flash" (JAX: the Pallas kernels under
  ``interpret=True``; port: the flash op's plain versions) and "xla", remat
  on and off, dense and chunked (``loss_chunks=4``) loss; and MoE (4
  experts, router included) under the grouped dispatch (dim 128,
  intermediate 256, so JAX takes its grouped Pallas path: its einsum
  fallback is an error here) and einsum, remat off and "full".
  Tolerance: loss within 1e-5 relative, each gradient within 1e-4 of its
  max |grad|.
- one ``default_optimizer`` step against optax on the same gradients,
  clipping on and off: parameters within 1e-6.
- ``synthetic_tokens`` byte-equal across the packages.
- three steps of the pretrain loop from one bridged init, dense and MoE
  (grouped): each step's loss within 1e-4 of the JAX loop's.
- the CLI on the CPU (dense, and MoE under the strict grouped dispatch),
  and what it refuses: pp (M8), MoE under sp (M3b); without a group, a
  mesh wider than one device (``--sp 2`` too).
- what is not ported yet raises, naming its module: a pp axis, MoE under
  sp; a dense model under an sp mesh takes ring or Ulysses attention.
"""

import contextlib
import dataclasses
import warnings
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_controller_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from kubeflow_controller_tpu.models.llama import llama_init as jax_llama_init
from kubeflow_controller_tpu.models.llama import llama_loss as jax_llama_loss
from kubeflow_controller_tpu.workloads import data as jax_data
from kubeflow_controller_tpu.workloads.runtime import JobRuntime as JaxJobRuntime
from kubeflow_controller_tpu.workloads.trainer import default_optimizer as jax_default_optimizer
from kubeflow_controller_tpu_torch import bridge
from kubeflow_controller_tpu_torch.models import llama as tllama
from kubeflow_controller_tpu_torch.workloads import data as tdata
from kubeflow_controller_tpu_torch.workloads import llama_pretrain as tpre
from kubeflow_controller_tpu_torch.workloads import runtime as truntime
from kubeflow_controller_tpu_torch.workloads import trainer as ttrainer

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
SEQ = 64


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def flat_grads(model, jax_grads):
    """(name, port grad, JAX grad) for every parameter of the port."""
    out = [("embed", model.embed.grad, jax_grads["embed"]),
           ("final_norm", model.final_norm.grad, jax_grads["final_norm"]),
           ("lm_head", model.lm_head.grad, jax_grads["lm_head"])]
    keys = bridge.LAYER_KEYS + (bridge.MOE_KEYS if model.cfg.n_experts
                                else ())
    for key in keys:
        for i, lp in enumerate(model.layers):
            out.append((f"layers/{key}[{i}]", getattr(lp, key).grad,
                        jax_grads["layers"][key][i]))
    return out


# Widths at which the JAX grouped path runs its kernels (D and F multiples
# of 128), not its einsum fallback.
MOE_WIDTHS = dict(dim=128, intermediate=256)

# (id, config overrides) — dense is n_kv_heads = n_heads; GQA is tiny's 2.
CASES = [
    ("dense-xla", dict(n_kv_heads=4, attention="xla")),
    ("dense-flash-remat-chunks", dict(n_kv_heads=4, attention="flash",
                                      remat=True, loss_chunks=4)),
    ("gqa-flash", dict(attention="flash")),
    ("gqa-xla-remat-chunks", dict(attention="xla", remat=True,
                                  loss_chunks=4)),
    ("gqa-flash-remat", dict(attention="flash", remat=True)),
    ("moe-grouped", dict(n_experts=4, moe_dispatch="grouped", **MOE_WIDTHS)),
    ("moe-grouped-remat", dict(n_experts=4, moe_dispatch="grouped",
                               remat=True, **MOE_WIDTHS)),
    ("moe-einsum", dict(n_experts=4, moe_dispatch="einsum")),
    ("moe-einsum-remat", dict(n_experts=4, moe_dispatch="einsum",
                              remat=True)),
]


@pytest.mark.parametrize("overrides", [c[1] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_loss_and_every_gradient_match_jax(overrides):
    jcfg = JaxLlamaConfig.tiny(**overrides)
    cfg = tllama.LlamaConfig.tiny(**overrides)
    params = jax_llama_init(jax.random.PRNGKey(0), jcfg)
    tokens = jax_data.synthetic_tokens(3, 2, SEQ, jcfg.vocab_size)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="moe dispatch")
        ref_loss, ref_grads = jax.value_and_grad(jax_llama_loss)(
            params, tokens, jcfg)
    ref_grads = numpy_tree(ref_grads)

    model = bridge.llama_from_jax(numpy_tree(params), cfg, device="cpu",
                                  requires_grad=True)
    loss = tllama.llama_loss(model, bridge.tokens_from_jax(tokens, "cpu"),
                             cfg)
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= LOSS_RTOL * abs(
        float(ref_loss))
    for name, got, ref in flat_grads(model, ref_grads):
        assert got is not None, name
        err = np.max(np.abs(got.numpy() - ref))
        assert err <= GRAD_RTOL * np.max(np.abs(ref)), (name, err)


def test_forward_aux_and_hidden_match_the_loss_path():
    """``return_hidden`` gives the final-norm states the logits come from,
    and ``return_aux`` the dense layers' zero router stats."""
    cfg = tllama.LlamaConfig.tiny()
    params = numpy_tree(jax_llama_init(jax.random.PRNGKey(1),
                                       JaxLlamaConfig.tiny()))
    model = bridge.llama_from_jax(params, cfg, device="cpu")
    tokens = tdata.synthetic_tokens(5, 2, 32, cfg.vocab_size, "cpu")
    with torch.no_grad():
        logits, aux = tllama.llama_forward(model, tokens, cfg,
                                           return_aux=True)
        hidden = tllama.llama_forward(model, tokens, cfg, return_hidden=True)
    assert logits.dtype == torch.float32
    assert logits.shape == (2, 32, cfg.vocab_size)
    torch.testing.assert_close(hidden @ model.lm_head, logits)
    assert {k: float(v) for k, v in aux.items()} == {
        "aux_loss": 0.0, "z_loss": 0.0, "overflow_frac": 0.0}


@pytest.mark.parametrize("grad_scale", [0.01, 10.0],
                         ids=["under-clip", "clipped"])
def test_one_optimizer_step_matches_optax(grad_scale):
    rng = np.random.default_rng(0)
    shapes = {"a": (8, 16), "b": (16,), "c": (4, 4, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = {k: (rng.standard_normal(s) * grad_scale).astype(np.float32)
             for k, s in shapes.items()}
    norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                       for g in grads.values()))
    assert (norm >= 1.0) == (grad_scale > 1)

    opt = jax_default_optimizer(3e-4, weight_decay=0.1)
    state = opt.init(params)
    updates, _ = opt.update(grads, state, params)
    want = numpy_tree(optax.apply_updates(params, updates))

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    topt = ttrainer.default_optimizer(tparams.values(), 3e-4,
                                      weight_decay=0.1)
    for k, p in tparams.items():
        p.grad = torch.from_numpy(grads[k].copy())
    got_norm = topt.step()
    assert abs(float(got_norm) - norm) <= 1e-5 * norm
    for k, p in tparams.items():
        assert np.max(np.abs(p.detach().numpy() - want[k])) <= 1e-6, k


@pytest.mark.parametrize("seed", [1, 7])
def test_synthetic_tokens_are_byte_equal(seed):
    want = np.asarray(jax_data.synthetic_tokens(
        jax.random.PRNGKey(seed), 16, 96, 300))
    got = tdata.synthetic_tokens(seed, 16, 96, 300, device="cpu")
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert got.numpy().tobytes() == want.tobytes()
    with pytest.raises(TypeError):
        tdata.synthetic_tokens(jax.random.PRNGKey(seed), 1, 2, 3, "cpu")


def test_pretrain_loop_losses_match_the_jax_loop():
    """Three steps of the reference's ``llama_pretrain`` loop (jit'd
    value_and_grad -> default_optimizer -> apply_updates, tokens from
    ``synthetic_tokens(PRNGKey(1), ...)``) and of the port's ``train`` from
    the same bridged init."""
    check_pretrain_loop({})


def test_moe_pretrain_loop_losses_match_the_jax_loop():
    """The same three steps for a 4-expert model under the grouped
    dispatch (JAX: its grouped Pallas path, the fallback an error)."""
    check_pretrain_loop(dict(n_experts=4, moe_dispatch="grouped",
                             **MOE_WIDTHS))


def check_pretrain_loop(overrides):
    steps, bs, lr = 3, 4, 3e-4
    jcfg = JaxLlamaConfig.tiny(max_seq_len=SEQ, **overrides)
    params = jax_llama_init(jax.random.PRNGKey(0), jcfg)
    opt = jax_default_optimizer(lr, weight_decay=0.1)
    state = opt.init(params)

    @jax.jit
    def step_fn(p, s, tokens):
        loss, grads = jax.value_and_grad(jax_llama_loss)(p, tokens, jcfg)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    cfg = tllama.LlamaConfig.tiny(max_seq_len=SEQ, **overrides)
    model = bridge.llama_from_jax(numpy_tree(params), cfg, device="cpu",
                                  requires_grad=True)
    tokens_all = jax_data.synthetic_tokens(jax.random.PRNGKey(1),
                                           max(64, 2 * bs), SEQ,
                                           jcfg.vocab_size)
    want = []
    p = params
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="moe dispatch")
        for i in range(steps):
            lo = (i * bs) % max(1, tokens_all.shape[0] - bs + 1)
            p, state, loss = step_fn(p, state, tokens_all[lo:lo + bs])
            want.append(float(loss))

    res = tpre.train(cfg, steps=steps, batch_size=bs, seq_len=SEQ, lr=lr,
                     device="cpu", model=model)
    assert len(res.losses) == steps
    assert np.max(np.abs(np.array(res.losses) - want)) <= 1e-4, (
        res.losses, want)


def test_train_step_continues_the_loop():
    """``TrainResult.step(i)`` is step i of the same loop (same optimizer
    state, same token rows): two steps and then ``step(2)`` give the third
    loss of a three-step run."""
    cfg = tllama.LlamaConfig.tiny(max_seq_len=32)
    kw = dict(batch_size=2, seq_len=32, device="cpu", seed=3)
    three = tpre.train(cfg, steps=3, **kw)
    two = tpre.train(cfg, steps=2, **kw)
    assert two.losses == three.losses[:2]
    assert two.step(2) == pytest.approx(three.losses[2], rel=0, abs=1e-6)


def test_main_runs_on_the_cpu(capsys, tmp_path, monkeypatch):
    monkeypatch.delenv("MODEL_DIR", raising=False)
    monkeypatch.delenv("KCTPU_MESH", raising=False)
    assert tpre.main(["--device", "cpu", "--steps", "2", "--batch-size", "2",
                      "--seq-len", "32", "--fsdp", "-1", "--profile-dir",
                      str(tmp_path / "trace")]) == 0
    out = capsys.readouterr().out
    assert "Training elapsed time:" in out
    assert "Final loss:" in out and "tokens/s" in out
    assert (tmp_path / "trace" / "trace.json").is_file()


def test_main_trains_moe_on_the_cpu(capsys, monkeypatch):
    """``--experts`` with the strict grouped dispatch: on the CPU it runs
    grouped (the plain versions), and the strict filter finds no
    fallback to refuse."""
    monkeypatch.delenv("MODEL_DIR", raising=False)
    monkeypatch.delenv("KCTPU_MESH", raising=False)
    with warnings.catch_warnings():
        assert tpre.main(["--device", "cpu", "--experts", "4",
                          "--moe-dispatch", "grouped",
                          "--strict-moe-dispatch", "--dim", "128",
                          "--intermediate", "256", "--steps", "2",
                          "--batch-size", "2", "--seq-len", "32"]) == 0
    out = capsys.readouterr().out
    loss = float(out.split("Final loss: ")[1].split(";")[0])
    assert np.isfinite(loss)


@pytest.mark.parametrize("argv,env,error,match", [
    (["--sp", "2"], {}, ValueError, "devices"),
    (["--pp", "2"], {}, ValueError, "devices"),
    ([], {"KCTPU_MESH": '{"sp": 2}'}, ValueError, "devices"),
    (["--experts", "4", "--sp", "2"], {}, ValueError, "devices"),
], ids=["sp", "pp", "env-mesh-sp", "sp-experts"])
def test_main_refuses_what_is_not_ported(argv, env, error, match,
                                         monkeypatch):
    """``--sp``, ``--pp`` and MoE under ``--sp`` train now (over gloo
    ranks: tests/test_torch_sp_train.py, tests/test_torch_pp_train.py,
    tests/test_torch_moe_sp.py, tests/test_torch_mesh_tfjob.py), so
    without a group each asks for more devices than the one there is, from
    the flag or from $KCTPU_MESH, and raises the reference's mesh error;
    so does pp with sp (M8c: tests/test_torch_pp_train.py).  What is
    still refused before any join: a pp that does not divide the layers
    (the reference's parser error)."""
    for name in ("MODEL_DIR", "KCTPU_MESH", "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    with pytest.raises(error, match=match):
        tpre.main(["--device", "cpu", "--steps", "1", *argv])
    if argv == ["--pp", "2"]:
        with pytest.raises(ValueError, match="devices"):
            tpre.main(["--device", "cpu", "--steps", "1", "--pp", "2",
                       "--sp", "2"])
        with pytest.raises(SystemExit):
            tpre.main(["--device", "cpu", "--steps", "1", "--pp", "3"])


@pytest.mark.parametrize("argv", [["--tp", "2"], ["--fsdp", "2"],
                                  ["--dp", "2", "--fsdp", "1"]],
                         ids=["tp", "fsdp", "dp"])
def test_main_without_a_group_has_one_device(argv, monkeypatch):
    """With no gang and no group there is one device: a mesh axis above 1
    raises the reference's mesh error."""
    for name in ("MODEL_DIR", "KCTPU_MESH", "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="devices"):
        tpre.main(["--device", "cpu", "--steps", "1", *argv])


def test_runtime_from_env_matches_jax():
    env = {"JAX_COORDINATOR_ADDRESS": "h0:1234", "JAX_NUM_PROCESSES": "4",
           "JAX_PROCESS_ID": "2", "TPU_ACCELERATOR_TYPE": "v5p-32",
           "TPU_WORKER_HOSTNAMES": "h0,h1,,h2", "MEGASCALE_NUM_SLICES": "2",
           "MEGASCALE_SLICE_ID": "1",
           "MEGASCALE_COORDINATOR_ADDRESS": "h2:1",
           "KCTPU_MESH": '{"dp": 2, "fsdp": "4"}',
           "KCTPU_GANG_GENERATION": "3", "MODEL_DIR": "/m", "LOG_DIR": "/l",
           "DATA_DIR": "/d", "EXPORT_DIR": "/e"}
    for e in (env, {}, {"KCTPU_MESH": "not json", "KCTPU_GANG_WIDTH": "5"}):
        want = dataclasses.asdict(JaxJobRuntime.from_env(e))
        got = dataclasses.asdict(truntime.JobRuntime.from_env(e))
        assert got == want
    one = truntime.JobRuntime.from_env({})
    one.initialize()
    # A gang now joins (tests/test_torch_gang.py); one whose coordinator
    # is not host:port raises before any wait.
    bad = dataclasses.replace(truntime.JobRuntime.from_env(env),
                              coordinator="nonsense")
    with pytest.raises(ValueError, match="host:port"):
        bad.initialize("cpu")


class FakeMesh:
    """Names and sizes: all the not-ported checks read, before any
    DTensor is made."""

    mesh_dim_names = ("pp", "dp", "fsdp", "ep", "sp", "tp")

    def __init__(self, **sizes):
        self.sizes = [sizes.get(a, 1) for a in self.mesh_dim_names]

    def size(self, i):
        return self.sizes[i]


@contextlib.contextmanager
def fake_world(n: int):
    """A process group of ``n`` ranks in this process whose collectives do
    nothing (torch's fake backend): enough for meshes and DTensors."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def sp_attention_taken(sp_attention: str):
    """The local attention ``_attention`` runs under a 2-rank sp mesh: the
    body the model calls, spied on, with its ring or group."""
    from torch.distributed.tensor import DTensor

    from kubeflow_controller_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from kubeflow_controller_tpu_torch.parallel.ring import GroupRing
    from kubeflow_controller_tpu_torch.parallel.sharding import placements_for

    cfg = tllama.LlamaConfig.tiny(sp_attention=sp_attention)
    taken = []

    def spy(name):
        def body(q, k, v, transport, **kwargs):
            taken.append((name, transport))
            return q
        return body

    with fake_world(2):
        sub = tllama.model_mesh(build_mesh(MeshSpec(fsdp=1, sp=2), "cpu"))
        q, k = (DTensor.from_local(torch.zeros((1, 8, h, 16)), sub,
                                   placements_for(tllama.QKV_AXES, sub),
                                   run_check=False) for h in (4, 2))
        with mock.patch.object(tllama, "ring_attention_local",
                               spy("ring")), \
                mock.patch.object(tllama, "ulysses_attention_local",
                                  spy("ulysses")):
            out = tllama._attention(q, k, k, True, cfg, mesh=sub)
        assert out.shape == (1, 16, 4, 16)
        assert sub.mesh_dim_names == ("sp",)
        [(name, transport)] = taken
        if name == "ring":
            assert isinstance(transport, GroupRing)
            assert (transport.n, transport.idx) == (2, 0)
        else:
            assert transport is sub.get_group("sp")
    return name


@pytest.mark.parametrize("axis,module", [("sp", "M3"), ("pp", "M8")])
def test_not_ported_paths_raise(axis, module):
    """What each path refuses: a pp axis above 1 through ``llama_forward``
    or ``llama_loss`` raises, pointing to the pipelined calls (M8); pp
    with an sp axis above 1 runs (M8c, MoE included:
    tests/test_torch_pp_train.py) and refuses, as without pp, a sequence
    that sp does not divide, before any stage runs; a policy no one
    defines is a ValueError.  A dense model under sp takes ring or Ulysses attention, as
    ``cfg.sp_attention`` says.  (The named remat policies,
    dp/fsdp/ep/sp/tp/pp and MoE under a mesh run:
    tests/test_torch_remat.py, tests/test_torch_mesh_train.py,
    tests/test_torch_sp_train.py, tests/test_torch_moe_mesh.py,
    tests/test_torch_pp_train.py.)"""
    from kubeflow_controller_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    cfg = tllama.LlamaConfig.tiny(n_experts=4 if axis == "sp" else 0)
    model = tllama.Llama(cfg, device="cpu", requires_grad=True)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    if axis == "pp":
        for fn in (tllama.llama_forward, tllama.llama_loss):
            with pytest.raises(ValueError, match="llama_forward_pp"):
                fn(model, tokens, cfg, mesh=FakeMesh(pp=2))
    with fake_world(4):
        mesh = build_mesh(MeshSpec(pp=2, fsdp=1, sp=2), "cpu")
        stage = tllama.llama_init(cfg, torch.Generator().manual_seed(0),
                                  "cpu", requires_grad=True, mesh=mesh)
        with pytest.raises(ValueError, match="does not divide by sp 2"):
            tllama.llama_loss_and_grads_pp(
                stage, torch.zeros((2, 7), dtype=torch.long), cfg, mesh)
    if axis == "sp":
        assert sp_attention_taken("ring") == "ring"
        assert sp_attention_taken("ulysses") == "ulysses"
    with pytest.raises(ValueError, match="unknown remat_policy"):
        tllama.llama_loss(model, tokens, dataclasses.replace(
            cfg, remat=True, remat_policy="nope"))


def test_flash_request_the_kernels_cannot_take_warns_once():
    """On a non-CPU device the flash path obeys the kernels' rule: f32 (or
    T off the tile) under attention='flash' warns once and takes the plain
    path; 'auto' stays quiet.  The meta device stands in for CUDA."""
    q = torch.empty((1, 100, 4, 16), device="meta")
    flash = tllama.LlamaConfig.tiny(attention="flash")
    tllama._FLASH_FALLBACK_WARNED.clear()
    with pytest.warns(UserWarning, match="falling back"):
        assert tllama._flash_path(q, q, q, True, flash) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tllama._flash_path(q, q, q, True, flash) is None
        auto = tllama.LlamaConfig.tiny(attention="auto")
        assert tllama._flash_path(q, q, q, True, auto) is None


def test_auto_takes_the_plain_path_on_the_cpu():
    q = torch.randn((1, 2048, 2, 8))
    auto = tllama.LlamaConfig.tiny(attention="auto")
    assert tllama._flash_path(q, q, q, True, auto) is None
    flash = tllama.LlamaConfig.tiny(attention="flash")
    assert tllama._flash_path(q[:, :64], q[:, :64], q[:, :64], True,
                              flash) is not None


def test_tokens_from_jax():
    arr = jnp.arange(12, dtype=jnp.int32).reshape(3, 4)
    t = bridge.tokens_from_jax(arr, "cpu")
    assert t.dtype == torch.int64 and t.tolist() == np.asarray(arr).tolist()
    with pytest.raises(ValueError):
        bridge.tokens_from_jax(np.zeros((2, 2), np.float32), "cpu")
