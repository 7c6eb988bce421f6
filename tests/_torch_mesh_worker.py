"""One gloo rank of the port's mesh tests (``tests/test_torch_mesh*.py``).

    python tests/_torch_mesh_worker.py SCENARIO OUT [ARGS...]

Joins the gang its ``JAX_*`` env names (``JobRuntime.initialize("cpu")``)
and runs SCENARIO; rank 0 (every rank for ``collectives``) writes its
results to OUT (``OUT.<rank>`` for ``collectives``) with ``torch.save``:

- ``collectives``: ``parallel/collectives.py`` over a (dp, tp) mesh.
- ``step DP FSDP TP POLICY PARAMS [SP SP_ATTENTION [LOSS_CHUNKS]]``: one
  loss, backward and AdamW step of the JAX-initialised model in PARAMS (a
  pickle of numpy arrays and the tokens) sharded on a (DP, FSDP, TP)
  mesh, or (DP, FSDP, SP, TP) with ring or Ulysses attention (and the
  chunked CE); the full gradients (before and after the clip) and
  parameters, the shapes the flash forward ran at, and the all-gathers
  over fsdp.
- ``train STEPS [MODEL_DIR [hang]]``: ``llama_pretrain.train`` of the tiny
  model under fsdp; with ``hang``, one more step after the run and then a
  wait to be killed.
- ``moe DP FSDP EP TP POLICY DISPATCH CF PARAMS``: one step of the
  JAX-initialised MoE model in PARAMS (with the tokens and one FFN call's
  inputs) on a (DP, FSDP, EP, TP) mesh: the loss, the router stats, the
  full gradients and parameters, the FFN call's output and stats, the
  kernels' plain-version calls (the skip forms apart), the fallback
  warnings, and every rank's per-shard grouped layouts.
- ``seqpar KIND SP TP INPUTS``: ring (KIND ``ring``) or Ulysses
  (``ulysses``) attention of the global q/k/v in INPUTS (an ``.npz``, with
  the cotangent ``do`` and a bf16 set ``*_bf16``) on a (fsdp, sp, tp) mesh
  of the world, causal and not, flash and dense inner: the full outputs
  and q/k/v gradients, every rank's plain-version calls of the flash
  kernels; on an sp-only mesh, the same schedules over virtual ranks in
  rank 0's process (``run_lockstep``, ``ulysses_lockstep``); for the ring,
  the bf16 set with the kernels' rule applied to the shards (T/sp under
  ``TILE``: the dense inner).
- ``generate DP FSDP TP EP SP CONFIG PARAMS``: cached generation of the
  JAX-initialised model in PARAMS (with the prompt) sharded on a (DP,
  FSDP, EP, SP, TP) mesh (sp shards nothing in decode), CONFIG ``dense``
  or ``moe``: the prefill's logits and cache
  through ``forward_with_cache(mesh=)``, the cache's placements and local
  shapes beside ``cache_placements``, and greedy ``generate(mesh=)`` with
  the default read, ``kv_block`` 4 and the int8 cache, then a sampled one
  (PARAMS' prompt, temperature, top-k and generator seed), every rank's
  tokens.
- ``pipeline S TOY``: the toy pipeline in TOY (a pickle of the stacked
  layer weights, the loss head, the microbatches and targets) over the
  world's S ranks as pp stages (``GroupPipe``): ``pipeline_1f1b``, with
  and without the stage penalty, and ``gpipe`` differentiated through a
  loss; rank 0 then runs the same over S virtual stages in its process
  (``Lockstep``) and writes both.
- ``pp PP FSDP EP CONFIG M PARAMS``: ``llama_loss_and_grads_pp`` of the
  JAX-initialised model in PARAMS (with the tokens), CONFIG ``dense``,
  ``einsum`` or ``grouped`` (the ``moe`` scenario's widths), on a (PP,
  FSDP, EP) mesh, each process building its stage with
  ``llama_init(mesh=)`` and taking its shards of PARAMS: the loss on every
  rank, every gradient gathered whole (each stage's own), the gradients
  left off their parameters' placements, the replicated gradients of every
  pp rank, and each rank's grouped plain-version calls by kind.
- ``pp_sp PP SP KIND CONFIG M PARAMS``: ``pp`` on a (PP, SP) mesh with
  KIND (``ring`` or ``ulysses``) attention under remat "full" (PP ``v2``:
  two virtual stages in each process over an (SP) mesh of the world);
  also each rank's sp index, its flash kernels' plain-version calls and
  ``llama_forward_pp``'s full logits.
- ``dryrun PARAMS``: ``graft_entry.dryrun_step`` of each configuration
  in PARAMS (a pickle of ``{letter: (params, tokens)}``, the JAX package's
  init and tokens) on its mesh for the world's size: rank 0 writes each
  loss.
- ``dryrun_control``: config A of ``graft_entry`` twice with the guard's
  controls, each of which must trip it: ``_w`` gathering every mesh dim
  (tp too), and a gradient moved off its parameter's placements; rank 0
  writes each guard message.
- ``main ARGS...``: ``llama_pretrain.main(ARGS)`` with every clip's
  global norm recorded: each rank's losses and norms.
- ``train_pp STEPS [MODEL_DIR [hang]]``: ``train`` as ``train`` does, on a
  (pp 2) mesh with 2 microbatches; every rank's full parameters, merged
  by name.
- ``moe_sp EP SP CF PARAMS``: for each dispatch (grouped, einsum,
  scatter), one ``llama_loss`` + backward of the JAX-initialised MoE in
  PARAMS (with the tokens and one FFN call's inputs) on an (EP, SP) mesh,
  and that FFN call on its own with x sharded over the sequence: the loss,
  the router stats, the full gradients, the misplaced ones, the FFN's
  output and stats.
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
         params_path: str, sp: str = "1", sp_attention: str = "ring",
         loss_chunks: str = "0") -> None:
    with open(params_path, "rb") as fh:
        params, tokens = pickle.load(fh)
    mesh = build_mesh(MeshSpec(dp=int(dp), fsdp=int(fsdp), tp=int(tp),
                               sp=int(sp)), "cpu")
    cfg = llama.LlamaConfig.tiny(attention="flash", remat=policy != "none",
                                 remat_policy=("full" if policy == "none"
                                               else policy),
                                 sp_attention=sp_attention,
                                 loss_chunks=int(loss_chunks), **TINY)
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


GENERATE_CONFIGS = {"dense": {}, "moe": dict(MOE, moe_dispatch="grouped")}
GENERATE_RUNS = {"default": {}, "block4": {"kv_block": 4},
                 "int8": {"kv_block": 4, "kv_quant": True}}
GENERATE_CACHE_LEN = 16


def generate(out: str, dp: str, fsdp: str, tp: str, ep: str, sp: str,
             config: str, params_path: str) -> None:
    import importlib

    tgen = importlib.import_module(
        "kubeflow_controller_tpu_torch.models.generate")
    with open(params_path, "rb") as fh:
        params, prompt, sample = pickle.load(fh)
    mesh = build_mesh(MeshSpec(dp=int(dp), fsdp=int(fsdp), ep=int(ep),
                               sp=int(sp), tp=int(tp)), "cpu")
    cfg = llama.LlamaConfig.tiny(**GENERATE_CONFIGS[config])
    model = llama.shard_llama(
        bridge.llama_from_jax(params, cfg, device="cpu"), mesh)
    prompt = torch.from_numpy(prompt).long()
    cache = tgen.init_cache(cfg, prompt.shape[0], GENERATE_CACHE_LEN,
                            device="cpu", mesh=mesh)
    logits, same = tgen.forward_with_cache(model, prompt, cache, 0, cfg,
                                           mesh=mesh)
    res = {"prefill": logits.full_tensor().numpy(),
           "in_place": same is cache,
           "cache": {k: v.full_tensor().numpy() for k, v in cache.items()},
           "placements": {k: list(v.placements) for k, v in cache.items()},
           "want_placements": {
               k: list(v) for k, v in
               tgen.cache_placements(mesh, quantize=True).items()},
           "local_shapes": {k: tuple(v.to_local().shape)
                            for k, v in cache.items()}}
    tokens = {name: tgen.generate(model, prompt, cfg, max_new_tokens=6,
                                  mesh=mesh, **kw).numpy()
              for name, kw in GENERATE_RUNS.items()}
    tokens["sampled"] = tgen.generate(
        model, torch.from_numpy(sample["prompt"]).long(), cfg,
        max_new_tokens=6, temperature=sample["temperature"],
        top_k=sample["top_k"], mesh=mesh,
        generator=torch.Generator().manual_seed(sample["seed"])).numpy()
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, tokens)
    if dist.get_rank() == 0:
        torch.save({**res, "tokens": tokens, "ranks": everyone}, out)


PLAIN_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def counting_plain(calls: dict):
    """Patches counting each flash kernel's plain-version calls."""
    def counted(name, real):
        def plain(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        return plain
    return [mock.patch.object(attention, f"{name}_plain",
                              counted(name, getattr(attention,
                                                    f"{name}_plain")))
            for name in PLAIN_KERNELS]


def seqpar(out: str, kind: str, sp: str, tp: str, inputs: str) -> None:
    import contextlib

    import numpy as np
    from torch.distributed.tensor import distribute_tensor

    from kubeflow_controller_tpu_torch.parallel import ring, ulysses

    sp, tp = int(sp), int(tp)
    world = dist.get_world_size()
    mesh = build_mesh(MeshSpec(fsdp=world // (sp * tp), sp=sp, tp=tp), "cpu")
    # The dims above 1 only: DTensor's propagation weighs every mesh dim.
    mesh = mesh[tuple(a for a in ("fsdp", "sp", "tp")
                      if mesh.size(mesh.mesh_dim_names.index(a)) > 1)]
    placements = ring.seq_placements(mesh)
    arrays = dict(np.load(inputs))
    full = {k: torch.from_numpy(v) for k, v in arrays.items()
            if not k.endswith("_bf16")}

    def attend(q, k, v, causal, inner):
        if kind == "ring":
            return ring.ring_attention(q, k, v, mesh, causal=causal,
                                       inner=inner)
        return ulysses.ulysses_attention(
            q, k, v, mesh, causal=causal,
            inner=None if inner == "flash" else ring.attention_reference)

    def run(tensors, causal, inner):
        qkv = [distribute_tensor(tensors[n], mesh, placements)
               .requires_grad_() for n in "qkv"]
        calls = dict.fromkeys(PLAIN_KERNELS, 0)
        with contextlib.ExitStack() as stack:
            for patch in counting_plain(calls):
                stack.enter_context(patch)
            o = attend(*qkv, causal, inner)
            o.backward(distribute_tensor(tensors["do"].to(o.dtype), mesh,
                                         placements))
        everyone = [None] * world
        dist.all_gather_object(everyone, {
            "rank": dist.get_rank(), "calls": calls,
            "sp_index": mesh.get_local_rank("sp")})
        return {"out": o.full_tensor().detach(),
                "grads": [x.grad.full_tensor() for x in qkv],
                "ranks": everyone}

    res = {}
    for causal in (True, False):
        for inner in ("flash", "dense"):
            res[(causal, inner)] = run(full, causal, inner)
    if kind == "ring":
        bf16 = {k[:-len("_bf16")]: torch.from_numpy(v).to(torch.bfloat16)
                for k, v in arrays.items() if k.endswith("_bf16")}
        for causal in (True, False):
            with mock.patch.object(ring, "flash_reason",
                                   lambda q, k, v: attention.kernel_rule(
                                       q, k, v)):
                res[("fallback", causal)] = run(bf16, causal, "flash")
    if world == sp and dist.get_rank() == 0:
        for causal in (True, False):
            res[("lockstep", causal)] = lockstep(kind, full, sp, causal)
    if dist.get_rank() == 0:
        torch.save(res, out)


def lockstep(kind: str, full: dict, n: int, causal: bool) -> dict:
    """The flash inner over n virtual ranks in this process."""
    from kubeflow_controller_tpu_torch.parallel import ring, ulysses

    parts = {k: [c.contiguous() for c in full[k].chunk(n, dim=1)]
             for k in ("q", "k", "v", "do")}
    scale = full["q"].shape[-1] ** -0.5
    if kind == "ring":
        fwd = ring.run_lockstep([ring.ring_flash_forward(
            parts["q"][r], parts["k"][r], parts["v"][r], r, n, causal, scale)
            for r in range(n)])
        bwd = ring.run_lockstep([ring.ring_flash_backward(
            parts["q"][r], parts["k"][r], parts["v"][r], *fwd[r],
            parts["do"][r], r, n, causal, scale) for r in range(n)])
        return {"out": torch.cat([o for o, _ in fwd], dim=1),
                "grads": [torch.cat([g[i] for g in bwd], dim=1)
                          for i in range(3)]}
    leaves = {k: [c.detach().requires_grad_() for c in parts[k]]
              for k in "qkv"}
    outs = ulysses.ulysses_lockstep(leaves["q"], leaves["k"], leaves["v"],
                                    causal=causal)
    torch.autograd.backward(outs, parts["do"])
    return {"out": torch.cat(outs, dim=1).detach(),
            "grads": [torch.cat([x.grad for x in leaves[k]], dim=1)
                      for k in "qkv"]}


def toy_stage(stage, x):
    """The toy pipeline's stage: tanh(x @ w) over its layers."""
    for w in stage:
        x = torch.tanh(x @ w)
    return x


def toy_stage_pen(stage, x):
    y = toy_stage(stage, x)
    return y, 0.01 * (y * y).mean()


def toy_loss(loss_params, y, target):
    return ((y @ loss_params[0] - target) ** 2).mean()


def toy_run(transport, stages, toy: dict) -> dict:
    """1F1B without and with the penalty, and gpipe through the loss; the
    results of this process's stages."""
    from kubeflow_controller_tpu_torch.parallel import pipeline as pl

    head = torch.from_numpy(toy["head"]).requires_grad_()
    x = torch.from_numpy(toy["x"])
    targets = torch.from_numpy(toy["targets"])
    res = {}
    for name, fn, aux in (("1f1b", toy_stage, False),
                          ("1f1b_pen", toy_stage_pen, True)):
        res[name] = pl.pipeline_1f1b(fn, stages, x, toy_loss, [head],
                                     targets, transport, stage_aux=aux)
    xg = x.clone().requires_grad_()
    out = pl.gpipe(toy_stage, stages, xg, transport)
    loss = sum(toy_loss([head], out[m], targets[m])
               for m in range(x.shape[0])) / x.shape[0]
    grads = torch.autograd.grad(loss, [*stages, head, xg])
    res["gpipe"] = (loss.detach(), grads[:len(stages)], grads[-2],
                    grads[-1], out.detach())
    return res


def pipeline(out: str, n: str, toy_path: str) -> None:
    from kubeflow_controller_tpu_torch.parallel import pipeline as pl

    n = int(n)
    with open(toy_path, "rb") as fh:
        toy = pickle.load(fh)
    mesh = build_mesh(MeshSpec(pp=n, fsdp=1), "cpu")
    w = torch.from_numpy(toy["w"]).requires_grad_()
    stages = pl.split_stages(w, n)
    rank = dist.get_rank()
    res = toy_run(pl.GroupPipe(mesh.get_group("pp"), "cpu"),
                  [stages[rank]], toy)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, res)
    if rank == 0:
        w = torch.from_numpy(toy["w"]).requires_grad_()
        local = toy_run(pl.Lockstep(n), pl.split_stages(w, n), toy)
        torch.save({"group": everyone, "lockstep": local}, out)


def _load_stage(model, params: dict) -> None:
    """Each parameter of ``model`` (a stage's, sharded) set to its shard
    of the full array of the same name in ``params``."""
    from torch.distributed.tensor import DTensor

    with torch.no_grad():
        for name, p in model.named_parameters():
            full = torch.from_numpy(params[name])
            if isinstance(p, DTensor):
                full = llama._distribute(full, p.device_mesh,
                                         p.placements).to_local()
                p.to_local().copy_(full)
            else:
                p.copy_(full)


def _port_names(tree) -> dict:
    out = {k: tree[k] for k in ("embed", "final_norm", "lm_head")}
    for key, stacked in tree["layers"].items():
        for i, a in enumerate(stacked):
            out[f"layers.{i}.{key}"] = a
    return out


PP_CONFIGS = {"dense": {}, "einsum": dict(MOE, moe_dispatch="einsum"),
              "grouped": dict(MOE, moe_dispatch="grouped")}


def counting_grouped(calls: dict):
    """Patches counting the grouped kernels' plain-version calls by kind,
    the skip forms (``valid_tiles`` given) apart."""
    from kubeflow_controller_tpu_torch.ops import grouped_matmul as gm

    def counted(name, real):
        def plain(*args, **kwargs):
            at = 4 if name == "gmm" else 5
            skip = (len(args) > at and args[at] is not None) or (
                kwargs.get("valid_tiles") is not None)
            calls[name + ("_skip" if skip else "")] += 1
            return real(*args, **kwargs)
        return plain

    def swiglu(*args, _real=gm.gmm_swiglu_plain, **kwargs):
        calls["gmm_swiglu"] += 1
        return _real(*args, **kwargs)

    return [mock.patch.object(gm, f"{name}_plain",
                              counted(name, getattr(gm, f"{name}_plain")))
            for name in ("gmm", "tgmm")] + [
        mock.patch.object(gm, "gmm_swiglu_plain", swiglu)]


def _pp_run(out: str, mesh, cfg, m: int, params_path: str,
            n_stages=None, forward: bool = False) -> None:
    """``llama_loss_and_grads_pp`` (and with ``forward``
    ``llama_forward_pp``) of the JAX-initialised model in PARAMS on
    ``mesh``, each process building its stage with ``llama_init(mesh=)``;
    rank 0 writes every rank's record and the merged gradients."""
    import contextlib

    with open(params_path, "rb") as fh:
        params, tokens = pickle.load(fh)
    model = llama.llama_init(cfg, torch.Generator().manual_seed(0), "cpu",
                             requires_grad=True, mesh=mesh)
    _load_stage(model, _port_names(params))
    tokens = torch.from_numpy(tokens).long()
    calls = {"gmm": 0, "gmm_skip": 0, "tgmm": 0, "tgmm_skip": 0,
             "gmm_swiglu": 0}
    flash = dict.fromkeys(PLAIN_KERNELS, 0)
    with contextlib.ExitStack() as stack:
        for patch in counting_grouped(calls) + counting_plain(flash):
            stack.enter_context(patch)
        loss, grads = llama.llama_loss_and_grads_pp(
            model, tokens, cfg, mesh, n_microbatches=m, n_stages=n_stages)
    logits = None
    if forward:
        with torch.no_grad():
            logits = llama.llama_forward_pp(
                model, tokens, cfg, mesh, n_microbatches=m,
                n_stages=n_stages).full_tensor().numpy()
    full = {n: g.full_tensor().numpy() for n, g in grads.items()}
    shared = {n: full[n] for n in ("embed", "final_norm", "lm_head")}
    misplaced = [n for n, p in model.named_parameters()
                 if p.grad.placements != p.placements]
    names = mesh.mesh_dim_names
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, {
        "rank": dist.get_rank(), "loss": float(loss), "grads": full,
        "shared": shared, "misplaced": misplaced, "calls": dict(calls),
        "flash": flash, "stage": llama.pp_stage(mesh),
        "sp_index": mesh.get_local_rank("sp") if "sp" in names else 0,
        "logits": logits})
    if dist.get_rank() == 0:
        merged = {}
        for r in everyone:
            merged.update(r["grads"])
        torch.save({"grads": merged, "ranks": everyone}, out)


def pp(out: str, pp_: str, fsdp: str, ep: str, config: str, m: str,
       params_path: str) -> None:
    mesh = build_mesh(MeshSpec(pp=int(pp_), fsdp=int(fsdp), ep=int(ep)),
                      "cpu")
    cfg = llama.LlamaConfig.tiny(attention="flash", **PP_CONFIGS[config])
    _pp_run(out, mesh, cfg, int(m), params_path)


def pp_sp(out: str, pp_: str, sp: str, kind: str, config: str, m: str,
          params_path: str) -> None:
    """``pp`` on a (PP, SP) mesh (or, with PP ``v<S>``, S virtual stages
    in each process over an (SP) mesh of the world) with KIND attention,
    remat "full": also the flash kernels' plain-version calls and
    ``llama_forward_pp``'s logits."""
    virtual = pp_.startswith("v")
    n = int(pp_.lstrip("v"))
    mesh = build_mesh(MeshSpec(pp=1 if virtual else n, fsdp=1, sp=int(sp)),
                      "cpu")
    cfg = llama.LlamaConfig.tiny(attention="flash", remat=True,
                                 remat_policy="full", sp_attention=kind,
                                 **PP_CONFIGS[config])
    _pp_run(out, mesh, cfg, int(m), params_path,
            n_stages=n if virtual else None, forward=True)


def main_run(out: str, *args: str) -> None:
    from kubeflow_controller_tpu_torch.workloads import trainer

    norms, runs = [], []
    real_step, real_train = trainer.Optimizer.step, llama_pretrain.train

    def step_(self):
        norm = real_step(self)
        norms.append(float(norm))
        return norm

    def train_(*a, **k):
        runs.append(real_train(*a, **k))
        return runs[-1]

    with mock.patch.object(trainer.Optimizer, "step", step_), \
            mock.patch.object(llama_pretrain, "train", train_):
        llama_pretrain.main(list(args))
    # main has left the gang: the result goes to a file a rank.
    torch.save({"losses": runs[0].losses, "norms": norms},
               f"{out}.{JobRuntime.from_env().process_id}")


def train_pp(out: str, steps: str, model_dir: str = "",
             hang: str = "") -> None:
    mesh = build_mesh(MeshSpec(pp=2, fsdp=-1), "cpu")
    cfg = llama.LlamaConfig.tiny(max_seq_len=32)
    res = llama_pretrain.train(cfg, steps=int(steps), batch_size=2,
                               seq_len=32, device="cpu", seed=0,
                               model_dir=model_dir, checkpoint_every=2,
                               mesh=mesh, microbatches=2)
    params = {n: p.full_tensor().detach().numpy()
              for n, p in res.model.named_parameters()}
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, params)
    if dist.get_rank() == 0:
        merged = {}
        for r in everyone:
            merged.update(r)
        torch.save({"losses": res.losses, "start": res.start_step,
                    "params": merged}, out)
    if hang:
        res.step(res.start_step + int(steps))   # a step past the save
        print("past the checkpoint", flush=True)
        time.sleep(600)                          # until killed


def moe_sp(out: str, ep: str, sp: str, cf: str, params_path: str) -> None:
    from torch.distributed.tensor import DTensor

    from kubeflow_controller_tpu_torch.models import moe as tmoe
    from kubeflow_controller_tpu_torch.parallel.sharding import (
        placements_for,
    )

    with open(params_path, "rb") as fh:
        params, tokens, ffn = pickle.load(fh)
    mesh = build_mesh(MeshSpec(fsdp=1, ep=int(ep), sp=int(sp)), "cpu")
    sub = llama.model_mesh(mesh)
    tokens = bridge.tokens_from_jax(tokens, "cpu")
    res = {}
    for dispatch in ("grouped", "einsum", "scatter"):
        cfg = moe_config("none", dispatch, cf)
        model = llama.shard_llama(bridge.llama_from_jax(
            params, cfg, device="cpu", requires_grad=True), mesh)
        with torch.no_grad():
            _, aux = llama.llama_forward(model, tokens, cfg, mesh,
                                         return_aux=True)
        loss = llama.llama_loss(model, tokens, cfg, mesh)
        loss.backward()
        x, router, wg, wu, wd = (torch.from_numpy(a) for a in ffn)
        y, stats = tmoe.moe_ffn_stats(
            llama.stage_tokens(x, sub), DTensor.from_local(
                router, sub, placements_for((), sub), run_check=False),
            *(llama._distribute(w, sub, placements_for(axes, sub))
              for w, axes in ((wg, ("expert", None, "mlp")),
                              (wu, ("expert", None, "mlp")),
                              (wd, ("expert", "mlp", None)))),
            top_k=2, capacity_factor=float(cf), dispatch=dispatch, mesh=sub)
        res[dispatch] = {
            "loss": float(loss.to_local()),
            "aux": {k: float(v.full_tensor()) for k, v in aux.items()},
            "grads": {n: p.grad.full_tensor().numpy()
                      for n, p in model.named_parameters()},
            "misplaced": [n for n, p in model.named_parameters()
                          if p.grad.placements != p.placements],
            "ffn_y": y.full_tensor().detach().numpy(),
            "ffn_stats": {k: float(v.full_tensor())
                          for k, v in stats.items()},
            "x_placements": [str(pl) for pl in
                             llama.stage_tokens(x, sub).placements]}
    if dist.get_rank() == 0:
        torch.save(res, out)


def _dryrun_config(letter: str):
    from kubeflow_controller_tpu_torch import graft_entry

    for conf in graft_entry._configs(dist.get_world_size(),
                                     torch.device("cpu")):
        if conf[0] == letter:
            return conf
    raise KeyError(letter)


def dryrun(out: str, params_path: str) -> None:
    from kubeflow_controller_tpu_torch import graft_entry

    with open(params_path, "rb") as fh:
        inputs = pickle.load(fh)
    losses = {}
    for letter, (params, tokens) in inputs.items():
        _, _, cfg, sizes, kind, _ = _dryrun_config(letter)
        res = graft_entry.dryrun_step(cfg, sizes, kind, params, tokens,
                                      device="cpu")
        losses[letter] = res.loss
    if dist.get_rank() == 0:
        torch.save(losses, out)


def dryrun_control(out: str) -> None:
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from kubeflow_controller_tpu_torch import graft_entry
    from kubeflow_controller_tpu_torch.workloads import trainer

    _, _, cfg, sizes, kind, _ = _dryrun_config("A")
    caught = {}

    def w_everything(p, dtype):
        if isinstance(p, DTensor):
            p = llama.grad_placed(p).redistribute(
                p.device_mesh, [Replicate()] * p.device_mesh.ndim)
        return p.to(dtype)

    real_step = trainer.Optimizer.step

    def misplace(self):
        norm = real_step(self)
        for p in self.params:
            if (isinstance(p, DTensor) and p.grad is not None
                    and any(isinstance(pl, Shard) for pl in p.placements)):
                mesh = p.grad.device_mesh
                p.grad = p.grad.redistribute(mesh, [Replicate()] * mesh.ndim)
                break
        return norm

    for name, target, attr, fake in (
            ("gather", llama, "_w", w_everything),
            ("placement", trainer.Optimizer, "step", misplace)):
        with mock.patch.object(target, attr, fake):
            try:
                graft_entry.dryrun_step(cfg, sizes, kind, device="cpu")
            except AssertionError as e:
                caught[name] = str(e)
    if dist.get_rank() == 0:
        torch.save(caught, out)


def main(argv) -> int:
    rt = JobRuntime.from_env()
    scenario, out, *rest = argv
    if scenario == "main":      # main joins and leaves the gang itself
        main_run(out, *rest)
        return 0
    rt.initialize("cpu", timeout_s=120)
    {"collectives": collectives, "step": step, "train": train, "moe": moe,
     "init": init, "seqpar": seqpar, "generate": generate,
     "pipeline": pipeline, "pp": pp, "pp_sp": pp_sp, "train_pp": train_pp,
     "moe_sp": moe_sp, "dryrun": dryrun,
     "dryrun_control": dryrun_control}[scenario](out, *rest)
    rt.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
