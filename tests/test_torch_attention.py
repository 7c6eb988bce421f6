"""Port parity: ``kubeflow_controller_tpu_torch.ops.attention`` against the
JAX package's flash attention (its Pallas kernels under ``interpret=True``)
and against ``attention_reference``.

The JAX side runs ``block_q = block_k = 32`` at T = 128, so the forward and
both backward kernels walk several blocks and take the causal block skip.
On the CPU the port's wrappers run their plain versions (the CUDA kernels
are held against those on the card by ``chip_smoke.py``).

Tolerances (f32 inputs; the packages sum in different orders, nothing else
differs): values and lse within 2e-5 absolute, dQ/dK/dV within 5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.ops.attention import _fwd as jax_fwd
from kubeflow_controller_tpu.ops.attention import flash_attention as jax_flash_attention
from kubeflow_controller_tpu.parallel.ring import attention_reference as jax_attention_reference
from kubeflow_controller_tpu_torch.ops import attention as tat
from kubeflow_controller_tpu_torch.parallel.ring import NEG_INF, attention_reference

torch.set_num_threads(2)

B, T, H, D = 2, 128, 4, 32
BLOCK = 32
VALUE_ATOL = 2e-5
GRAD_ATOL = 5e-5


def inputs(seed=0, b=B, t=T, h=H, d=D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(4)]                               # q, k, v, do


def assert_close(got, ref, atol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.max(np.abs(got - ref))
    assert err <= atol, err


def port_value_and_grads(fn, q, k, v, do):
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_matches_jax_pallas_interpret(causal):
    q, k, v, do = inputs()

    def jax_fn(q, k, v):
        return jax_flash_attention(q, k, v, causal=causal, block_q=BLOCK,
                                   block_k=BLOCK, interpret=True)

    ref, vjp = jax.vjp(jax_fn, *map(jnp.asarray, (q, k, v)))
    ref_grads = vjp(jnp.asarray(do))
    out, grads = port_value_and_grads(
        lambda a, b, c: tat.flash_attention(a, b, c, causal=causal),
        q, k, v, do)
    assert_close(out, ref, VALUE_ATOL)
    for g, r in zip(grads, ref_grads):
        assert_close(g, r, GRAD_ATOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_lse_matches_jax_fwd_kernel(causal):
    q, k, v, _ = inputs(1)

    def to_bh(x):
        return jnp.transpose(jnp.asarray(x), (0, 2, 1, 3)).reshape(B * H, T, D)

    o_ref, lse_ref = jax_fwd(to_bh(q), to_bh(k), to_bh(v), causal=causal,
                             scale=D ** -0.5, block_q=BLOCK, block_k=BLOCK,
                             interpret=True)
    o, lse = tat.flash_fwd(*map(torch.from_numpy, (q, k, v)), causal)
    assert lse.shape == (B * H, T) and lse.dtype == torch.float32
    assert_close(lse.numpy(), np.asarray(lse_ref)[..., 0], VALUE_ATOL)
    assert_close(o.numpy(), np.asarray(o_ref).reshape(B, H, T, D)
                 .transpose(0, 2, 1, 3), VALUE_ATOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_versions_match_autograd_of_attention_reference(causal):
    q, k, v, do = inputs(2)
    ref, ref_grads = port_value_and_grads(
        lambda a, b, c: attention_reference(a, b, c, causal=causal),
        q, k, v, do)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    o, lse = tat.flash_fwd_plain(qt, kt, vt, causal)
    assert_close(o.numpy(), ref, 1e-5)
    s = torch.einsum("bqhd,bkhd->bhqk", qt, kt) * D ** -0.5
    if causal:
        s = s.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), NEG_INF)
    assert_close(lse.numpy(), torch.logsumexp(s, -1).reshape(B * H, T), 1e-5)
    delta = torch.einsum("bthd,bthd->bht", dot, o).reshape(B * H, T)
    dq = tat.flash_dq_plain(qt, kt, vt, dot, lse, delta, causal)
    dk, dv = tat.flash_dkv_plain(qt, kt, vt, dot, lse, delta, causal)
    for g, r in zip((dq, dk, dv), ref_grads):
        assert_close(g.numpy(), r, GRAD_ATOL)


def test_attention_reference_matches_jax():
    q, k, v, _ = inputs(3, t=48)
    for causal in (True, False):
        ref = jax_attention_reference(*map(jnp.asarray, (q, k, v)),
                                      causal=causal)
        got = attention_reference(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal)
        assert_close(got.numpy(), ref, VALUE_ATOL)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    q, k, v, do = map(torch.from_numpy, inputs(4, t=64))
    before = (tat.flash_fwd.launches, tat.flash_dq.launches,
              tat.flash_dkv.launches)
    o, lse = tat.flash_fwd(q, k, v)
    o_p, lse_p = tat.flash_fwd_plain(q, k, v)
    torch.testing.assert_close(o, o_p, rtol=0, atol=0)
    torch.testing.assert_close(lse, lse_p, rtol=0, atol=0)
    delta = torch.einsum("bthd,bthd->bht", do, o).reshape(-1, 64)
    torch.testing.assert_close(tat.flash_dq(q, k, v, do, lse, delta),
                               tat.flash_dq_plain(q, k, v, do, lse, delta),
                               rtol=0, atol=0)
    for g, p in zip(tat.flash_dkv(q, k, v, do, lse, delta),
                    tat.flash_dkv_plain(q, k, v, do, lse, delta)):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
    assert (tat.flash_fwd.launches, tat.flash_dq.launches,
            tat.flash_dkv.launches) == before


def bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("what,mutate,exc", [
    ("f32 operands", lambda a: a.update(q=a["q"].float(), k=a["k"].float(),
                                        v=a["v"].float()), ValueError),
    ("head_dim 32", lambda a: a.update(**{n: bf16(1, 64, 2, 32)
                                          for n in "qkv"}), ValueError),
    ("T not a multiple of 64", lambda a: a.update(**{n: bf16(1, 96, 2, 64)
                                                     for n in "qkv"}),
     ValueError),
    ("k shape differs", lambda a: a.update(k=bf16(1, 128, 1, 64)), ValueError),
    ("non-contiguous q", lambda a: a.update(
        q=bf16(1, 2, 128, 64).transpose(1, 2)), ValueError),
    ("lse f64", lambda a: a.update(lse=a["lse"].double()), TypeError),
    ("delta wrong shape", lambda a: a.update(delta=a["delta"][:, :64]),
     ValueError),
    ("do f32", lambda a: a.update(do=a["do"].float()), TypeError),
])
def test_kernel_argument_checks(what, mutate, exc):
    """What the CUDA wrappers check before a pointer crosses into C (run
    here on CPU tensors; on the card a failing check raises the same)."""
    args = {"q": bf16(1, 128, 2, 64), "k": bf16(1, 128, 2, 64),
            "v": bf16(1, 128, 2, 64), "do": bf16(1, 128, 2, 64),
            "lse": torch.zeros((2, 128)), "delta": torch.zeros((2, 128))}

    def check():
        q = args["q"]
        tat._check(q, args["k"], args["v"],
                   ("do", args["do"], torch.bfloat16, q.shape),
                   *tat._stats(q, args["lse"], args["delta"]))

    check()
    assert tat.kernel_rule(args["q"], args["k"], args["v"]) is None
    mutate(args)
    with pytest.raises(exc):
        check()


def test_kernel_rule_reasons():
    ok = bf16(2, 128, 4, 128)
    assert tat.kernel_rule(ok, ok, ok) is None
    assert "bf16" in tat.kernel_rule(ok.float(), ok.float(), ok.float())
    odd = bf16(2, 100, 4, 128)
    assert "multiple of 64" in tat.kernel_rule(odd, odd, odd)
    small = bf16(2, 128, 4, 16)
    assert "head_dim 16" in tat.kernel_rule(small, small, small)
