"""Port parity: the mesh, the sharding rules and the collectives of
``kubeflow_controller_tpu_torch/parallel/`` against the JAX package's.

- ``MeshSpec.resolve`` and ``mesh_shape_for`` give the reference's sizes,
  and raise its errors, over a table of specs and device counts.
- ``logical_to_pspec`` gives the reference's ``PartitionSpec`` (each entry
  as a tuple of mesh axes) for every parameter of
  ``llama_param_logical_axes`` (dense and MoE) and for the activation
  tuples; ``llama_param_pspecs`` is the reference's tree.
- ``placements_for`` and ``with_logical_constraint`` on a one-rank CPU
  mesh; ``build_mesh`` keeps every canonical axis.
- The collectives (``psum``, ``pmean``, ``all_gather``, ``psum_scatter``,
  ``axis_index``, ``axis_size``, ``ring_permute``) over 2 and 4 gloo ranks
  (subprocesses) against numpy.
"""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from kubeflow_controller_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from kubeflow_controller_tpu.models.llama import (
    llama_param_logical_axes as jax_logical_axes,
)
from kubeflow_controller_tpu.models.llama import (
    llama_param_pspecs as jax_param_pspecs,
)
from kubeflow_controller_tpu.parallel import mesh as jmesh
from kubeflow_controller_tpu.parallel import sharding as jsharding
from kubeflow_controller_tpu_torch.models import llama as tllama
from kubeflow_controller_tpu_torch.parallel import mesh as tmesh
from kubeflow_controller_tpu_torch.parallel import sharding as tsharding

from _torch_ranks import run_ranks

torch.set_num_threads(1)

SPECS = [
    (dict(), 8), (dict(), 1), (dict(dp=2, fsdp=2, tp=2), 8),
    (dict(dp=2, fsdp=-1, tp=2), 16), (dict(fsdp=1, tp=-1), 4),
    (dict(pp=2, dp=1, fsdp=-1, sp=2), 8), (dict(ep=4, fsdp=-1), 8),
    # errors
    (dict(dp=0), 4), (dict(fsdp=-1, tp=-1), 4), (dict(dp=3), 8),
    (dict(dp=2, fsdp=2, tp=2), 4), (dict(dp=-2), 4),
]


@pytest.mark.parametrize("kwargs,n", SPECS)
def test_mesh_spec_resolves_like_jax(kwargs, n):
    def run(mod):
        try:
            return (mod.MeshSpec(**kwargs).resolve(n),
                    mod.mesh_shape_for(n, mod.MeshSpec(**kwargs)))
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(tmesh) == run(jmesh)


def test_axis_names_match_jax():
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    assert tmesh.mesh_shape_for(4) == jmesh.mesh_shape_for(4)


def as_tuples(pspec):
    return tuple(() if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in pspec)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


ACTIVATIONS = [("batch", "seq", None), ("batch", "seq", "heads", "head_dim"),
               ("batch", "seq", "kv_heads", "head_dim"),
               ("batch", "seq", "mlp"), ("batch", "seq", "vocab"),
               ("batch", None, None), ("batch", None, "vocab"),
               ("batch", "seq"), ("batch", "expert", None, None), (),
               ("embed", "vocab"), ("vocab", None), ("mystery", "embed")]


@pytest.mark.parametrize("n_experts", [0, 4], ids=["dense", "moe"])
def test_param_pspecs_match_jax(n_experts):
    jcfg = JaxLlamaConfig.tiny(n_experts=n_experts)
    cfg = tllama.LlamaConfig.tiny(n_experts=n_experts)
    assert tllama.llama_param_logical_axes(cfg) == jax_logical_axes(jcfg)
    want = dict(leaves(jax_param_pspecs(jcfg)))
    got = dict(leaves(tllama.llama_param_pspecs(cfg)))
    assert got.keys() == want.keys()
    for name, spec in want.items():
        assert isinstance(spec, PartitionSpec)
        assert got[name] == as_tuples(spec), name


@pytest.mark.parametrize("axes", ACTIVATIONS, ids=str)
def test_activation_pspecs_match_jax(axes):
    want = jsharding.logical_to_pspec(axes)
    assert tsharding.logical_to_pspec(axes) == as_tuples(want)
    assert tsharding.DEFAULT_RULES.rules == jsharding.DEFAULT_RULES.rules


def test_bare_string_leaf_is_rejected():
    with pytest.raises(TypeError, match="bare string"):
        tsharding.shard_pytree_specs({"w": "embed"})


class FakeMesh:
    mesh_dim_names = ("dp", "fsdp", "tp")

    def __init__(self, sizes=(2, 2, 2)):
        self.sizes = sizes

    def size(self, i):
        return self.sizes[i]


def test_placements_for():
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    m = FakeMesh()
    assert tsharding.placements_for(("batch", "seq", None), m) == [
        Shard(0), Shard(0), Replicate()]
    assert tsharding.placements_for(("embed", "heads", "head_dim"), m) == [
        Replicate(), Shard(0), Shard(1)]
    # the vocab over tp and fsdp: the same dim on both mesh dims, split by
    # tp first (the rule's order, JAX's): fsdp's shard is strided
    assert tsharding.placements_for(("vocab", None), m) == [
        Replicate(), _StridedShard(0, split_factor=2), Shard(0)]
    assert tsharding.placements_for(("embed", "vocab"), m) == [
        Replicate(), Shard(0), Shard(1)]
    assert tsharding.placements_for((), m) == [Replicate()] * 3
    # A mesh dim of size 1 splits nothing: it replicates.
    assert tsharding.placements_for(("batch", "seq", None),
                                    FakeMesh((1, 2, 2))) == [
        Replicate(), Shard(0), Replicate()]


def test_constraint_is_a_noop_outside_a_mesh():
    x = torch.randn(2, 3)
    assert tsharding.with_logical_constraint(x, ("batch", None)) is x


def test_build_mesh_keeps_every_axis_on_one_rank():
    import torch.distributed as dist

    from _torch_ranks import free_port

    with pytest.raises(RuntimeError, match="process group"):
        tmesh.build_mesh(device_type="cpu")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = tmesh.build_mesh(tmesh.MeshSpec(), "cpu")
        assert mesh.mesh_dim_names == tmesh.AXIS_ORDER
        assert tuple(mesh.shape) == (1,) * 6
        assert tmesh.data_axes(mesh) == ("dp", "fsdp")
        assert tmesh.data_parallel_size(mesh) == 1
        # The model mesh keeps the model axes above 1: dp alone here.
        assert tllama.model_mesh(mesh).mesh_dim_names == tllama.MODEL_AXES[:1]
    finally:
        dist.destroy_process_group()


def expected(world):
    """What each rank of the worker's (dp, tp) = (world/2, 2) mesh gets;
    rank = dp_i * 2 + tp_i."""
    xs = [np.arange(24, dtype=np.float32).reshape(4, 6) + 100 * r
          for r in range(world)]
    dp = world // 2
    out = []
    for r in range(world):
        d, t = divmod(r, 2)
        tp_peers = [xs[d * 2 + j] for j in range(2)]
        dp_peers = [xs[i * 2 + t] for i in range(dp)]
        total = sum(xs)
        out.append({
            "psum_tp": sum(tp_peers),
            "psum_all": total,
            "pmean_dp": sum(dp_peers) / dp,
            "gather_tp": np.concatenate(tp_peers, axis=1),
            "gather_all": np.stack(xs),
            "scatter_tp": np.split(sum(tp_peers), 2)[t],
            "scatter_all": np.split(total, world)[r],
            "ring_tp": xs[d * 2 + (t - 1) % 2],
            "ring_dp_back": xs[((d + 1) % dp) * 2 + t],
            "index": (d, t, r),
            "size": (dp, world),
        })
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_over_gloo_ranks_match_numpy(world, tmp_path):
    out = str(tmp_path / "coll")
    run_ranks(world, "collectives", out, timeout=120)
    for r, want in enumerate(expected(world)):
        got = torch.load(f"{out}.{r}", weights_only=False)
        assert got.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, tuple):
                assert tuple(got[k]) == v, (r, k)
            else:
                np.testing.assert_array_equal(got[k], v, err_msg=f"{r} {k}")


@pytest.fixture
def one_rank_mesh():
    import torch.distributed as dist

    from _torch_ranks import free_port

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        yield tmesh.build_mesh(tmesh.MeshSpec(), "cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("overrides", [
    dict(attention="xla", loss_chunks=2),
    dict(attention="flash", remat=True, remat_policy="ffn"),
], ids=["xla-chunked", "flash-ffn"])
def test_one_rank_mesh_loss_and_grads_equal_no_mesh(one_rank_mesh,
                                                     overrides):
    """The mesh path on a 1x1x1 mesh (DTensor everywhere, nothing moves)
    gives the plain path's loss and gradients: the chunked CE, the plain
    attention per shard and a named policy under DTensor."""
    from torch.distributed.tensor import DTensor

    cfg = tllama.LlamaConfig.tiny(max_seq_len=32, **overrides)
    gen = torch.Generator().manual_seed(0)
    plain = tllama.llama_init(cfg, gen, "cpu", requires_grad=True)
    sharded = tllama.llama_init(cfg, torch.Generator().manual_seed(0), "cpu",
                                requires_grad=True)
    tllama.shard_llama(sharded, one_rank_mesh)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(1))
    want = tllama.llama_loss(plain, tokens, cfg)
    want.backward()
    got = tllama.llama_loss(sharded, tokens, cfg, one_rank_mesh)
    assert isinstance(got, DTensor)
    got.backward()
    torch.testing.assert_close(got.full_tensor(), want, rtol=1e-6, atol=0)
    for (name, p), q in zip(plain.named_parameters(), sharded.parameters()):
        torch.testing.assert_close(q.grad.full_tensor(), p.grad, rtol=1e-5,
                                   atol=1e-7, msg=name)
