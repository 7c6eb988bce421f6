"""Port parity: the graft-entry hooks (``kubeflow_controller_tpu_torch/
graft_entry.py``) against the root ``__graft_entry__.py``.

- ``entry(device="cpu")``'s forward on the JAX flagship init (bridged)
  equals ``__graft_entry__.entry()``'s jitted forward within 1e-5 (f32).
- ``dryrun_multichip(4, device="cpu")`` runs every configuration over 4
  gloo ranks and prints the reference's seven ``dryrun[...] OK`` lines and
  its closing line; at 8 ranks configs A and E run on their 3-D meshes,
  each within 150 s.
- ``dryrun_step`` over 4 gloo ranks (``tests/_torch_mesh_worker.py``,
  scenario ``dryrun``) on the JAX init and tokens gives the JAX package's
  one-device ``llama_loss``: A, C and E within 2e-5 relative, B2 (the
  grouped MoE) within 1e-4.
- The guard's controls (scenario ``dryrun_control``) trip it: ``_w``
  gathering tp as well, and a gradient moved off its parameter's
  placements.
- Without CUDA, ``entry()`` and ``dryrun_multichip()`` raise.
"""

import pickle
import re

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from kubeflow_controller_tpu.models import LlamaConfig as JaxLlamaConfig
from kubeflow_controller_tpu.models.llama import llama_init as jax_llama_init
from kubeflow_controller_tpu.models.llama import llama_loss as jax_llama_loss
from kubeflow_controller_tpu_torch import bridge, graft_entry

from _torch_ranks import start_ranks, wait_ranks

torch.set_num_threads(2)

LABELS = ["dense", "pipeline", "moe-grouped", "pp-moe-grouped", "1f1b",
          "multislice", "decode"]
LOSS_RTOL = {"A": 2e-5, "C": 2e-5, "E": 2e-5, "B2": 1e-4}


def jax_cfg(letter):
    """The reference's config of ``letter`` (``__graft_entry__.py``)."""
    if letter == "B2":
        return JaxLlamaConfig.tiny(
            vocab_size=512, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
            intermediate=256, n_experts=4, moe_top_k=2, remat=False,
            moe_dispatch="grouped")
    return jax_entry._flagship_cfg()


def test_entry_forward_matches_the_reference():
    fn, (model, tokens) = graft_entry.entry(device="cpu")
    assert tokens.dtype == torch.int64 and tuple(tokens.shape) == (2, 64)
    assert not tokens.any()
    jfn, (params, jtokens) = jax_entry.entry()
    want = np.asarray(jax.jit(jfn)(params, jtokens))
    bridged = bridge.llama_from_jax(jax.tree.map(np.asarray, params),
                                    graft_entry._flagship_cfg(), "cpu")
    with torch.no_grad():
        got = fn(bridged, tokens).numpy()
        own = fn(model, tokens)
    assert got.shape == want.shape == (2, 64, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert own.dtype == torch.float32 and torch.isfinite(own).all()


def ok_lines(text):
    return re.findall(r"^dryrun\[([a-z0-9-]+)\] OK: mesh (\{.*?\})", text,
                      flags=re.M)


def test_dryrun_multichip_four_gloo_ranks(capsys):
    records = graft_entry.dryrun_multichip(4, device="cpu", timeout_s=300)
    out = capsys.readouterr().out
    assert [label for label, _ in ok_lines(out)] == LABELS
    assert "dryrun_multichip OK:" in out
    # Every rank ran every config, and the B2/B3 launch lines are there.
    assert [[r["label"] for r in rank] for rank in records] == [LABELS] * 4
    for label in ("moe-grouped", "pp-moe-grouped"):
        for rank in range(4):
            assert f"dryrun[{label}] rank {rank}: skip launches" in out
    # Ranks agree on every loss.
    for conf in range(len(LABELS) - 1):
        assert len({rank[conf]["loss"] for rank in records}) == 1


@pytest.mark.parametrize("letter,label", [("A", "dense"),
                                          ("E", "multislice")])
def test_dryrun_3d_mesh_at_eight_ranks(capsys, letter, label):
    graft_entry.dryrun_multichip(8, device="cpu", configs=[letter],
                                 timeout_s=150)
    (got,) = ok_lines(capsys.readouterr().out)
    assert got[0] == label
    sizes = eval(got[1])  # noqa: S307 - the dict the rank printed
    assert sum(v > 1 for v in sizes.values()) == 3, sizes


def jax_inputs(letter, n=4):
    """The JAX package's init (PRNGKey 0) and tokens (PRNGKey 1) for
    ``letter``'s batch at ``n`` ranks, and its one-device loss."""
    cfg = jax_cfg(letter)
    _, _, _, sizes, kind, _ = next(
        c for c in graft_entry._configs(n, torch.device("cpu"))
        if c[0] == letter)
    micro = {"pipeline": 2, "1f1b": 4}.get(kind, 1)
    batch = max(4, sizes["dp"] * sizes["fsdp"] * 2)
    assert batch % (sizes["dp"] * sizes["fsdp"] * micro) == 0
    seq = max(64, 2 * sizes["sp"])
    params = jax_llama_init(jax.random.PRNGKey(0), cfg)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (batch, seq), 0,
                                cfg.vocab_size)
    loss = float(jax_llama_loss(params, tokens, cfg))
    return (jax.tree.map(np.asarray, params), np.asarray(tokens)), loss


def test_dryrun_step_losses_match_jax(tmp_path):
    inputs, want = {}, {}
    for letter in LOSS_RTOL:
        inputs[letter], want[letter] = jax_inputs(letter)
    with open(tmp_path / "in.pkl", "wb") as fh:
        pickle.dump(inputs, fh)
    out = tmp_path / "out.pt"
    wait_ranks(start_ranks(4, "dryrun", str(out), str(tmp_path / "in.pkl")),
               timeout=240)
    got = torch.load(out, weights_only=False)
    for letter, rtol in LOSS_RTOL.items():
        assert abs(got[letter] - want[letter]) <= rtol * abs(want[letter]), (
            letter, got[letter], want[letter])


def test_guard_controls_trip_it(tmp_path):
    out = tmp_path / "out.pt"
    wait_ranks(start_ranks(4, "dryrun_control", str(out)), timeout=150)
    caught = torch.load(out, weights_only=False)
    assert "gathered whole over tp" in caught["gather"], caught
    assert "gradient placed" in caught["placement"], caught


def test_guard_refuses_an_unattributed_gather():
    """Gathers over dp and fsdp pass, and so does an activation's over
    tp; a parameter's gather whose group is not a mesh dim cannot be
    checked, and fails."""

    class Fake:
        def named_parameters(self):
            return []

    assert graft_entry.guard_violations(Fake(), [
        ("dp", (4, 4), "w"), ("fsdp", (4, 4), "w"),
        ("tp", (4, 4), None), (None, (4,), None)]) == []
    bad = graft_entry.guard_violations(Fake(), [(None, (4,), "w")])
    assert bad and "not a mesh dim" in bad[0]


def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")


def test_cuda_is_the_default_and_raises_without_it():
    no_cuda()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.main([])
