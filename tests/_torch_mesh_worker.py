"""One gloo rank of the port's mesh tests (``tests/test_torch_mesh*.py``).

    python tests/_torch_mesh_worker.py SCENARIO OUT [ARGS...]

Joins the gang its ``JAX_*`` env names (``JobRuntime.initialize("cpu")``)
and runs SCENARIO; rank 0 (every rank for ``collectives``) writes its
results to OUT (``OUT.<rank>`` for ``collectives``) with ``torch.save``:

- ``collectives``: ``parallel/collectives.py`` over a (dp, tp) mesh.
- ``step DP FSDP TP POLICY PARAMS``: one loss, backward and AdamW step of
  the JAX-initialised model in PARAMS (a pickle of numpy arrays and the
  tokens) sharded on a (DP, FSDP, TP) mesh; the full gradients (before
  and after the clip) and parameters, the shapes the flash forward ran
  at, and the all-gathers over fsdp.
- ``train STEPS [MODEL_DIR [hang]]``: ``llama_pretrain.train`` of the tiny
  model under fsdp; with ``hang``, one more step after the run and then a
  wait to be killed.
- ``moe DP FSDP EP TP POLICY DISPATCH CF PARAMS``: one step of the
  JAX-initialised MoE model in PARAMS (with the tokens and one FFN call's
  inputs) on a (DP, FSDP, EP, TP) mesh: the loss, the router stats, the
  full gradients and parameters, the FFN call's output and stats, the
  kernels' plain-version calls (the skip forms apart), the fallback
  warnings, and every rank's per-shard grouped layouts.
- ``init DP FSDP EP TP EXPERTS``: ``llama_init(mesh=)`` against
  ``llama_init`` + ``shard_llama`` from one seed (every local shard), and
  the live bytes of the tensors ``llama_pretrain.train(mesh=)`` makes while
  it initialises, against those of the whole-model init.
"""

import pickle
import sys
import time
from unittest import mock

import torch
import torch.distributed as dist

torch.set_num_threads(1)

from kubeflow_controller_tpu_torch import bridge  # noqa: E402
from kubeflow_controller_tpu_torch.models import llama  # noqa: E402
from kubeflow_controller_tpu_torch.ops import attention  # noqa: E402
from kubeflow_controller_tpu_torch.parallel import collectives as C  # noqa: E402
from kubeflow_controller_tpu_torch.parallel.mesh import (  # noqa: E402
    MeshSpec,
    build_mesh,
)
from kubeflow_controller_tpu_torch.workloads import llama_pretrain  # noqa: E402
from kubeflow_controller_tpu_torch.workloads.runtime import JobRuntime  # noqa: E402
from kubeflow_controller_tpu_torch.workloads.trainer import (  # noqa: E402
    default_optimizer,
)

TINY = dict(max_seq_len=64)


def collectives(out: str) -> None:
    world = dist.get_world_size()
    mesh = build_mesh(MeshSpec(dp=world // 2, fsdp=1, tp=2), "cpu")
    rank = dist.get_rank()
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6) + 100 * rank
    res = {
        "psum_tp": C.psum(x, "tp", mesh),
        "psum_all": C.psum(x, ("dp", "tp"), mesh),
        "pmean_dp": C.pmean(x, "dp", mesh),
        "gather_tp": C.all_gather(x, "tp", mesh, gather_axis=1),
        "gather_all": C.all_gather(x, ("dp", "tp"), mesh, tiled=False),
        "scatter_tp": C.psum_scatter(x, "tp", mesh),
        "scatter_all": C.psum_scatter(x, ("dp", "tp"), mesh,
                                      scatter_axis=0),
        "ring_tp": C.ring_permute(x, "tp", mesh),
        "ring_dp_back": C.ring_permute(x, "dp", mesh, shift=-1),
        "index": (C.axis_index("dp", mesh), C.axis_index("tp", mesh),
                  C.axis_index(("dp", "tp"), mesh)),
        "size": (C.axis_size("dp", mesh), C.axis_size(("dp", "tp"), mesh)),
    }
    torch.save({k: v.numpy() if isinstance(v, torch.Tensor) else v
                for k, v in res.items()}, f"{out}.{rank}")


def step(out: str, dp: str, fsdp: str, tp: str, policy: str,
         params_path: str) -> None:
    with open(params_path, "rb") as fh:
        params, tokens = pickle.load(fh)
    mesh = build_mesh(MeshSpec(dp=int(dp), fsdp=int(fsdp), tp=int(tp)),
                      "cpu")
    cfg = llama.LlamaConfig.tiny(attention="flash", remat=policy != "none",
                                 remat_policy=("full" if policy == "none"
                                               else policy), **TINY)
    model = bridge.llama_from_jax(params, cfg, device="cpu",
                                  requires_grad=True)
    llama.shard_llama(model, mesh)
    shards = {tuple(p.to_local().shape) for p in model.parameters()}
    flash_shapes, gathered = [], []
    real_fwd = attention.flash_fwd_plain

    def fwd(q, *args, **kwargs):
        flash_shapes.append(tuple(q.shape))
        return real_fwd(q, *args, **kwargs)

    import contextlib

    import torch.distributed._functional_collectives as funcol

    def recorded(real):
        def gather(t, *args, **kwargs):
            gathered.append(tuple(t.shape))
            return real(t, *args, **kwargs)
        return gather

    opt = default_optimizer(model.parameters(), 3e-4, weight_decay=0.1)
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(attention, "flash_fwd_plain",
                                              fwd))
        for name in ("all_gather_tensor", "all_gather_single"):
            if hasattr(funcol, name):   # DTensor's S -> R, by version
                stack.enter_context(mock.patch.object(
                    funcol, name, recorded(getattr(funcol, name))))
        loss = llama.llama_loss(model, bridge.tokens_from_jax(tokens, "cpu"),
                                cfg, mesh)
        loss.backward()
    # Copies: a replicated gradient's full tensor is its local one, which
    # the clip scales in place.
    grads = {n: p.grad.full_tensor().numpy().copy()
             for n, p in model.named_parameters()}
    misplaced = [n for n, p in model.named_parameters()
                 if p.grad.placements != p.placements]
    norm = opt.step()
    clipped = {n: p.grad.full_tensor().numpy()
               for n, p in model.named_parameters()}
    after = {n: p.full_tensor().detach().numpy()
             for n, p in model.named_parameters()}
    value = float(loss.to_local())
    if dist.get_rank() == 0:
        torch.save({"loss": value, "grads": grads, "clipped": clipped,
                    "params": after, "grads_misplaced": misplaced,
                    "norm": float(norm), "flash_shapes": flash_shapes,
                    "gathered": gathered, "shards": shards}, out)


def train(out: str, steps: str, model_dir: str = "", hang: str = "") -> None:
    mesh = build_mesh(MeshSpec(fsdp=-1), "cpu")
    cfg = llama.LlamaConfig.tiny(max_seq_len=32)
    res = llama_pretrain.train(cfg, steps=int(steps), batch_size=2,
                               seq_len=32, device="cpu", seed=0,
                               model_dir=model_dir, checkpoint_every=2,
                               mesh=mesh)
    params = {n: p.full_tensor().detach().numpy()
              for n, p in res.model.named_parameters()}
    if dist.get_rank() == 0:
        torch.save({"losses": res.losses, "start": res.start_step,
                    "params": params}, out)
    if hang:
        res.step(res.start_step + int(steps))   # a step past the save
        print("past the checkpoint", flush=True)
        time.sleep(600)                          # until killed


MOE = dict(vocab_size=512, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
           intermediate=256, n_experts=4, moe_top_k=2, max_seq_len=64)


def moe_config(policy: str, dispatch: str, cf: str):
    return llama.LlamaConfig.tiny(
        remat=policy != "none", remat_policy=("full" if policy == "none"
                                              else policy),
        moe_dispatch=dispatch, capacity_factor=float(cf), **MOE)


def moe(out: str, dp: str, fsdp: str, ep: str, tp: str, policy: str,
        dispatch: str, cf: str, params_path: str) -> None:
    import warnings

    from torch.distributed.tensor import DTensor

    from kubeflow_controller_tpu_torch.models import moe as tmoe
    from kubeflow_controller_tpu_torch.ops import grouped_matmul as gm
    from kubeflow_controller_tpu_torch.parallel.sharding import (
        placements_for,
    )

    with open(params_path, "rb") as fh:
        params, tokens, ffn = pickle.load(fh)
    mesh = build_mesh(MeshSpec(dp=int(dp), fsdp=int(fsdp), ep=int(ep),
                               tp=int(tp)), "cpu")
    sub = llama.model_mesh(mesh)
    cfg = moe_config(policy, dispatch, cf)
    model = bridge.llama_from_jax(params, cfg, device="cpu",
                                  requires_grad=True)
    llama.shard_llama(model, mesh)
    tokens = bridge.tokens_from_jax(tokens, "cpu")

    layouts, calls = [], {"gmm": 0, "gmm_skip": 0, "tgmm": 0,
                          "tgmm_skip": 0, "gmm_swiglu": 0}
    real_layout = tmoe.grouped_layout

    def layout(idx, n_experts, block_m=256, first_expert=None):
        lay = real_layout(idx, n_experts, block_m, first_expert)
        layouts.append({"idx": idx.numpy().copy(), "n_local": n_experts,
                        "first": first_expert, "bm": lay.bm, "m": lay.m,
                        "dest": lay.dest.numpy().copy(),
                        "te": lay.tile_experts.numpy().copy(),
                        "valid_tiles": None if lay.valid_tiles is None
                        else lay.valid_tiles.numpy().copy()})
        return lay

    def counted(name, real):
        def plain(*args, **kwargs):
            skip = len(args) > 4 and args[4] is not None
            if name == "tgmm":
                skip = len(args) > 5 and args[5] is not None
            skip = skip or kwargs.get("valid_tiles") is not None
            calls[name + ("_skip" if skip else "")] += 1
            return real(*args, **kwargs)
        return plain

    patches = [mock.patch.object(tmoe, "grouped_layout", layout)]
    patches += [mock.patch.object(gm, f"{name}_plain",
                                  counted(name, getattr(gm, f"{name}_plain")))
                for name in ("gmm", "tgmm")]

    def swiglu(*args, _real=gm.gmm_swiglu_plain, **kwargs):
        calls["gmm_swiglu"] += 1
        return _real(*args, **kwargs)

    patches.append(mock.patch.object(gm, "gmm_swiglu_plain", swiglu))
    import contextlib

    opt = default_optimizer(model.parameters(), 3e-4, weight_decay=0.1)
    with warnings.catch_warnings(record=True) as caught, \
            contextlib.ExitStack() as stack:
        warnings.simplefilter("always")
        for p in patches:
            stack.enter_context(p)
        with torch.no_grad():
            _, aux = llama.llama_forward(model, tokens, cfg, mesh,
                                         return_aux=True)
        aux = {k: float(v.full_tensor()) for k, v in aux.items()}
        fwd_layouts = len(layouts)
        for k in calls:
            calls[k] = 0
        loss = llama.llama_loss(model, tokens, cfg, mesh)
        loss.backward()
        step_calls = dict(calls)

        # One FFN call on its own: x staged by batch shard, the weights as
        # _w hands them over (gathered over dp and fsdp).
        x, router, wg, wu, wd = (torch.from_numpy(a) for a in ffn)
        xd = llama.stage_tokens(x, sub)
        y, stats = tmoe.moe_ffn_stats(
            xd, DTensor.from_local(router, sub, placements_for((), sub),
                                   run_check=False),
            *(llama._distribute(w, sub, placements_for(axes, sub))
              for w, axes in ((wg, ("expert", None, "mlp")),
                              (wu, ("expert", None, "mlp")),
                              (wd, ("expert", "mlp", None)))),
            top_k=2, capacity_factor=float(cf), dispatch=dispatch, mesh=sub)
    # Copies: a replicated DTensor's full tensor is its local one, which
    # the clip scales in place.
    grads = {n: p.grad.full_tensor().numpy().copy()
             for n, p in model.named_parameters()}
    misplaced = [(n, p.placements, p.grad.placements)
                 for n, p in model.named_parameters()
                 if p.grad.placements != p.placements]
    opt.step()
    after = {n: p.full_tensor().detach().numpy().copy()
             for n, p in model.named_parameters()}
    ffn_y = y.full_tensor().detach().numpy()
    ffn_stats = {k: float(v.full_tensor()) for k, v in stats.items()}
    fell_back = [str(w.message) for w in caught
                 if "falling back" in str(w.message)]
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, {
        "rank": dist.get_rank(), "layouts": layouts[:fwd_layouts],
        "ep_index": (sub.get_local_rank("ep")
                     if "ep" in sub.mesh_dim_names else 0)})
    if dist.get_rank() == 0:
        torch.save({"loss": float(loss.to_local()), "aux": aux,
                    "grads": grads, "grads_misplaced": misplaced, "params": after, "calls": step_calls,
                    "fell_back": fell_back, "ranks": everyone,
                    "ffn_y": ffn_y, "ffn_stats": ffn_stats}, out)


def init(out: str, dp: str, fsdp: str, ep: str, tp: str,
         experts: str) -> None:
    """The sharded init against the whole-model one, and its live bytes."""
    import weakref

    from torch.utils._python_dispatch import TorchDispatchMode

    class LiveBytes(TorchDispatchMode):
        """The bytes of the storages that ops make, alive until the
        storage is freed (a weakref's finalizer on it drops it), after
        every op."""

        def __init__(self):
            super().__init__()
            self.live, self.history = {}, []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                # Plain tensors only: a DTensor's bytes are its local
                # tensor's, which the ops inside it made.
                if type(t) is torch.Tensor and t.device.type == "cpu":
                    st = t.untyped_storage()
                    key = st.data_ptr()
                    if key and key not in self.live:
                        self.live[key] = st.nbytes()
                        weakref.finalize(st, self.live.pop, key, 0)
            self.history.append(dict(self.live))
            return out

    mesh = build_mesh(MeshSpec(dp=int(dp), fsdp=int(fsdp), ep=int(ep),
                               tp=int(tp)), "cpu")
    cfg = llama.LlamaConfig.tiny(max_seq_len=32, n_experts=int(experts))
    gen = torch.Generator().manual_seed(7)
    sharded = llama.llama_init(cfg, gen, "cpu", requires_grad=True,
                               mesh=mesh)
    gen = torch.Generator().manual_seed(7)
    whole = llama.shard_llama(llama.llama_init(cfg, gen, "cpu",
                                               requires_grad=True), mesh)
    a, b = dict(sharded.named_parameters()), dict(whole.named_parameters())
    same = {n: (a[n].placements == b[n].placements
                and a[n].requires_grad == b[n].requires_grad
                and torch.equal(a[n].to_local(), b[n].to_local()))
            for n in b}

    def transient(build):
        """The most bytes, after any op of ``build``, in storages other
        than those the trained model's parameters and its tokens keep."""
        mode = LiveBytes()
        with mode:
            res = build()
        kept = {p.to_local().untyped_storage().data_ptr()
                for p in res.model.parameters()}
        kept.add(res.step.__closure__ and next(
            c.cell_contents.untyped_storage().data_ptr()
            for c in res.step.__closure__
            if type(c.cell_contents) is torch.Tensor))
        return max(sum(n for k, n in live.items() if k not in kept)
                   for live in mode.history), res

    def sharded_train():
        return llama_pretrain.train(cfg, steps=0, batch_size=2, seq_len=32,
                                    device="cpu", seed=0, mesh=mesh)

    def whole_train():
        g = torch.Generator().manual_seed(0)
        model = llama.llama_init(cfg, g, "cpu", requires_grad=True)
        return llama_pretrain.train(cfg, steps=0, batch_size=2, seq_len=32,
                                    device="cpu", model=model, mesh=mesh)

    sharded_bytes, res = transient(sharded_train)
    whole_bytes, _ = transient(whole_train)
    full = {n: p.numel() * p.element_size()
            for n, p in res.model.named_parameters()}
    if dist.get_rank() == 0:
        torch.save({"same": same, "transient": sharded_bytes,
                    "transient_whole": whole_bytes,
                    "largest_param": max(full.values()),
                    "all_params": sum(full.values())}, out)


def main(argv) -> int:
    rt = JobRuntime.from_env()
    rt.initialize("cpu", timeout_s=120)
    scenario, out, *rest = argv
    {"collectives": collectives, "step": step, "train": train, "moe": moe,
     "init": init}[scenario](out, *rest)
    rt.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
