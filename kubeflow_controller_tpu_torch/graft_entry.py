"""Graft-entry hooks — the port of the root ``__graft_entry__.py``: a
forward of the flagship model, and a dry run of one training step of
every parallel configuration over an n-device mesh.

``entry(device="cuda")`` returns ``(fn, (model, tokens))``: ``fn`` is
``llama_forward`` at the flagship widths (Llama-2 decoder, vocab 512, dim
128, 2 layers, 8/4 heads, FFN 256, remat on), ``model`` its ``llama_init``
from a seeded generator and ``tokens`` zeros ``[2, 64]``.

``dryrun_multichip(n, device="cuda")`` starts n ranks of this module
(``--rank-child``), one device a rank: gloo over the CPU, or nccl with one
card a rank on ``"cuda"``.  Each rank joins through ``JobRuntime`` and the
controller's env contract (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) and runs the reference's
configurations in its order, each one full training step (loss, backward,
clip and AdamW at lr 1e-3) on its own mesh (:func:`dryrun_step`):

- A ``dense``: dp/fsdp/sp/tp, ring attention on sp;
- B ``pipeline``: the MoE (4 experts, top-2, einsum) under pp/ep/tp, the
  loss the CE of ``llama_forward_pp``'s logits (GPipe, 2 microbatches);
- B2 ``moe-grouped``: the same MoE on the grouped dispatch under ep/tp/dp;
- B3 ``pp-moe-grouped``: B2's MoE under the 1F1B schedule over pp/ep/tp;
- C ``1f1b``: dense under the 1F1B schedule over pp/tp/dp;
- E ``multislice``: dp across the 2 slices of the ``MEGASCALE_*`` env
  (``JobRuntime.from_env``), tp and fsdp within a slice;
- D ``decode``: ``generate`` under tp/dp, 4 new tokens.

B, B3 and C are skipped when pp does not divide the layers, E when n is
odd, as in the reference.  A "falling back" warning in B2 or B3 fails the
run; on the cards the MoE configs run with bf16 activations (the grouped
kernels take bf16 only) and each rank must have launched the skip forms
of ``gmm`` and ``tgmm``.  On the CPU they stay f32, so the losses can be
held against the JAX package's.  For the pipeline configurations the
batch is rounded up to a multiple of the data-parallel size times the
microbatches (the same batch as the reference's at n = 4).

In place of the reference's "no involuntary full rematerialization"
assertion, each step passes a guard (:func:`guard_violations`): every
gradient is placed as its parameter, and no parameter sharded over tp or
ep is all-gathered whole over those axes (the gathers are recorded at
``torch.distributed._functional_collectives``, through which DTensor
gathers, each attributed to the parameter whose redistribution made
it).  The gathers the model makes by design pass: ``_w``'s over dp and
fsdp, the activations' (the CE's logits over tp among them), and the
decode table in D.

Rank 0 prints the reference's lines, ``dryrun[<label>] OK: mesh {...},
batch BxT, loss x``, then one closing line; every rank prints its skip
launches in B2 and B3.  A failure on any rank fails the call.

    python -m kubeflow_controller_tpu_torch.graft_entry [--device cpu]
    python -c "from kubeflow_controller_tpu_torch.graft_entry import \\
        dryrun_multichip; dryrun_multichip(4, device='cpu')"
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models.llama import LlamaConfig, llama_forward, llama_init
from .workloads.launch import free_port

AXES = ("pp", "dp", "fsdp", "ep", "sp", "tp")
# The mesh axes no parameter may be gathered whole over.
GUARDED_AXES = ("tp", "ep")
LR = 1e-3
DEFAULT_TIMEOUT_S = 600.0


def _flagship_cfg() -> LlamaConfig:
    return LlamaConfig.tiny(
        vocab_size=512, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
        intermediate=256, max_seq_len=128, remat=True)


def _moe_cfg(dispatch: str, dtype: str) -> LlamaConfig:
    return LlamaConfig.tiny(
        vocab_size=512, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
        intermediate=256, n_experts=4, moe_top_k=2, remat=False,
        moe_dispatch=dispatch, dtype=dtype)


def entry(device: DeviceLike = "cuda"):
    """-> (fn, (model, tokens)): the flagship forward and its inputs on
    ``device`` (raises without CUDA unless ``"cpu"`` is named)."""
    dev = resolve_device(device)
    cfg = _flagship_cfg()
    model = llama_init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.zeros((2, 64), dtype=torch.int64, device=dev)

    def fn(model, tokens):
        return llama_forward(model, tokens, cfg)

    return fn, (model, tokens)


def _assign_axes(n: int, names) -> Dict[str, int]:
    """Give each named axis a factor of 2 while n allows; remainder -> fsdp."""
    sizes = {a: 1 for a in AXES}
    rem = n
    for a in names:
        if rem % 2 == 0:
            sizes[a], rem = 2, rem // 2
    sizes["fsdp"] *= rem
    return sizes


# ---------------------------------------------------------------------------
# The guard
# ---------------------------------------------------------------------------

Gather = Tuple[Optional[str], Tuple[int, ...], Optional[str]]


@contextlib.contextmanager
def gather_log(model: torch.nn.Module) -> Iterator[List[Gather]]:
    """Record every all-gather made through
    ``torch.distributed._functional_collectives`` (DTensor's Shard ->
    Replicate) while the block runs: ``(mesh dim name, output shape,
    parameter)``.  The dim name is None where the group is not a ``(mesh,
    dim)`` pair; the parameter is the name of the parameter of ``model``
    whose DTensor redistribution made the gather (its local tensor went
    into DTensor's ``redistribute_local_tensor``), else None (an
    activation's or a gradient's)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _api, _dispatch, _redistribute

    owners = {p.to_local().data_ptr(): name
              for name, p in model.named_parameters()
              if isinstance(p, DTensor) and p.to_local().numel()}
    log: List[Gather] = []
    redistributing: List[Optional[str]] = []

    def gathered(real):
        def gather(*args, **kwargs):
            out = real(*args, **kwargs)
            group = kwargs.get("group", args[2] if len(args) > 2 else None)
            dim = None
            if (isinstance(group, tuple) and len(group) == 2
                    and hasattr(group[0], "mesh_dim_names")):
                mesh, d = group
                dim = mesh.mesh_dim_names[d] if isinstance(d, int) else d
            log.append((dim, tuple(out.shape),
                        redistributing[-1] if redistributing else None))
            return out
        return gather

    def redistributed(real):
        def redistribute(local_tensor, *args, **kwargs):
            redistributing.append(owners.get(local_tensor.data_ptr()))
            try:
                return real(local_tensor, *args, **kwargs)
            finally:
                redistributing.pop()
        return redistribute

    # Each name where this torch has it (the redistribution's is imported
    # by name into the modules that call it).
    patches = [(funcol, n, gathered) for n in ("all_gather_tensor",
                                               "all_gather_single")]
    patches += [(m, "redistribute_local_tensor", redistributed)
                for m in (_api, _dispatch, _redistribute)]
    patches = [(m, n, getattr(m, n), wrap) for m, n, wrap in patches
               if hasattr(m, n)]
    for m, n, fn, wrap in patches:
        setattr(m, n, wrap(fn))
    try:
        yield log
    finally:
        for m, n, fn, _ in patches:
            setattr(m, n, fn)


def _watched_shapes(model: torch.nn.Module
                    ) -> Dict[str, Tuple[Tuple[int, ...], ...]]:
    """Parameter name -> the shapes a gather of it over tp or ep must not
    produce, for every parameter sharded over tp or ep: its full shape,
    and its shape with only the tp/ep shards gathered (a gather over tp
    or ep made before the fsdp one)."""
    from torch.distributed.tensor import DTensor

    from .parallel.sharding import shard_dim

    watched = {}
    for name, p in model.named_parameters():
        if not isinstance(p, DTensor):
            continue
        mesh = p.device_mesh
        shards = [(mesh.mesh_dim_names[i], shard_dim(pl), mesh.size(i))
                  for i, pl in enumerate(p.placements)
                  if shard_dim(pl) is not None]
        if not any(axis in GUARDED_AXES for axis, _, _ in shards):
            continue
        other = list(p.shape)
        for axis, dim, size in shards:
            if axis not in GUARDED_AXES:
                other[dim] //= size
        watched[name] = (tuple(p.shape), tuple(other))
    return watched


def guard_violations(model: torch.nn.Module, log: Sequence[Gather], *,
                     allowed: Sequence[str] = ()) -> List[str]:
    """What the port's guard refuses in one step of ``model`` (a DTensor
    model after its backward), given the step's :func:`gather_log`: a
    gradient placed otherwise than its parameter; in a parameter's
    redistribution, a gather over a group that is not a mesh dim (it could
    not be checked), and a gather over tp or ep that makes the parameter
    whole (or whole but for its fsdp shards).  ``allowed`` names the
    parameters whose whole gather is by design."""
    from torch.distributed.tensor import DTensor

    bad = [f"{name}: gradient placed {tuple(p.grad.placements)}, "
           f"parameter {tuple(p.placements)}"
           for name, p in model.named_parameters()
           if isinstance(p, DTensor) and p.grad is not None
           and tuple(p.grad.placements) != tuple(p.placements)]
    watched = _watched_shapes(model)
    for dim, shape, owner in log:
        if owner is None or owner in allowed:
            continue
        if dim is None:
            bad.append(f"{owner}: an all-gather of {shape} over a group "
                       "that is not a mesh dim: the guard cannot check it")
        elif dim in GUARDED_AXES and shape in watched.get(owner, ()):
            bad.append(f"{owner} gathered whole over {dim} (output {shape})")
    return bad


# ---------------------------------------------------------------------------
# One configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepResult:
    """What :func:`dryrun_step` ran and measured on this rank."""

    mesh: Dict[str, int]
    batch: int
    seq: int
    losses: List[float]        # per step, before its update
    step_ms: List[float]       # per step, ending in a device sync
    gathers: List[Gather]
    gmm_skip: int = 0          # skip-form kernel launches (CUDA)
    tgmm_skip: int = 0

    @property
    def loss(self) -> float:
        return self.losses[0]


def _load(model: torch.nn.Module, params) -> None:
    """Set each parameter of ``model`` (this process's shards or stage) to
    its shard of the JAX pytree ``params`` (numpy leaves, the reference's
    stacked layers)."""
    from torch.distributed.tensor import DTensor

    from .models.llama import _distribute

    flat = {k: params[k] for k in ("embed", "final_norm", "lm_head")}
    for key, stacked in params["layers"].items():
        for i, a in enumerate(stacked):
            flat[f"layers.{i}.{key}"] = a
    with torch.no_grad():
        for name, p in model.named_parameters():
            full = torch.from_numpy(np.asarray(flat[name])).to(p.dtype)
            if isinstance(p, DTensor):
                full = _distribute(full.to(p.to_local().device),
                                   p.device_mesh, p.placements).to_local()
                p.to_local().copy_(full)
            else:
                p.copy_(full)


def _pipeline_ce(logits, tokens, sub):
    """The reference's CE of ``llama_forward_pp``'s logits: mean over
    [B, T - 1] of -log softmax at the next token."""
    from .models.llama import _vocab_whole, stage_tokens
    from .parallel.sharding import DEFAULT_RULES, with_logical_constraint

    if sub is not None:
        tokens = stage_tokens(tokens, sub)
        logits = _vocab_whole(logits, DEFAULT_RULES)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp[:, :-1].gather(-1, tokens[:, 1:, None])
    ce = nll.mean()
    if sub is not None:
        ce = with_logical_constraint(ce, (), DEFAULT_RULES).to_local()
    return ce


def dryrun_step(cfg: LlamaConfig, sizes: Dict[str, int], kind: str,
                params=None, tokens=None, *, device: DeviceLike = "cuda",
                steps: int = 1) -> StepResult:
    """``steps`` training steps of ``cfg`` (each loss, backward, clip 1.0
    and AdamW at lr 1e-3) on a mesh of ``sizes`` over the joined process
    group, every step held to the guard (:func:`guard_violations`, which
    raises ``AssertionError``).  ``kind``: ``"dense"`` (``llama_loss``),
    ``"pipeline"`` (the CE of ``llama_forward_pp``'s logits, 2
    microbatches) or ``"1f1b"`` (``llama_loss_and_grads_pp``, 4
    microbatches).  The model is ``llama_init`` of seed 0 on the mesh, or
    holds ``params`` (the JAX package's pytree, numpy leaves); the batch
    is ``tokens`` (``[B, T]``, every rank alike), else ``B = max(4, 2 ·
    dp · fsdp)`` (rounded up to dp · fsdp · microbatches for the pipeline
    kinds) and ``T = max(64, 2 · sp)`` tokens of seed 1."""
    import torch.distributed as dist

    from .models.llama import (
        llama_forward_pp,
        llama_loss,
        llama_loss_and_grads_pp,
        model_mesh,
        pp_group,
        pp_size,
        pp_stage,
    )
    from .ops import grouped_matmul as gm
    from .parallel.mesh import MeshSpec, build_mesh
    from .workloads.trainer import default_optimizer

    dev = resolve_device(device)
    assert cfg.n_heads % sizes["tp"] == 0, (
        f"n_heads {cfg.n_heads} not divisible by tp {sizes['tp']}")
    assert cfg.dim % sizes["fsdp"] == 0, (
        f"dim {cfg.dim} not divisible by fsdp {sizes['fsdp']}")
    mesh = build_mesh(MeshSpec(**sizes), dev.type)
    sub = model_mesh(mesh)
    model = llama_init(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                       requires_grad=True, mesh=mesh)
    if params is not None:
        _load(model, params)
    opt = default_optimizer(model.parameters(), LR)
    if pp_size(mesh) > 1:
        opt.over_stages(pp_group(mesh),
                        [model.embed, model.final_norm, model.lm_head],
                        pp_stage(mesh) == 0)
    micro = {"pipeline": 2, "1f1b": 4}.get(kind, 1)
    if tokens is None:
        batch = max(4, sizes["dp"] * sizes["fsdp"] * 2)
        unit = sizes["dp"] * sizes["fsdp"] * micro
        batch = -(-batch // unit) * unit
        seq = max(64, 2 * sizes["sp"])
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=gen)
    tokens = torch.as_tensor(np.asarray(tokens)).long().to(dev)

    def loss_and_grads():
        if kind == "1f1b":
            loss, _ = llama_loss_and_grads_pp(model, tokens, cfg, mesh,
                                              n_microbatches=micro)
            return loss
        if kind == "pipeline":
            logits = llama_forward_pp(model, tokens, cfg, mesh,
                                      n_microbatches=micro)
            loss = _pipeline_ce(logits, tokens, sub)
        elif kind == "dense":
            loss = llama_loss(model, tokens, cfg, mesh)
        else:
            raise ValueError(f"unknown kind {kind!r}")
        loss.backward()
        return loss.to_local() if hasattr(loss, "to_local") else loss

    gm.gmm.skip_launches = gm.tgmm.skip_launches = 0
    losses, step_ms, gathers = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        with gather_log(model) as log:
            loss = loss_and_grads()
            opt.step()
        value = float(loss.detach())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        bad = guard_violations(model, log)
        assert not bad, "dry-run guard: " + "; ".join(bad)
        assert value == value, "loss is NaN"
        opt.zero_grad()
        losses.append(value)
        gathers += log
    dist.barrier()
    return StepResult(dict(zip(mesh.mesh_dim_names, mesh.shape)),
                      tokens.shape[0], tokens.shape[1], losses, step_ms,
                      gathers, gm.gmm.skip_launches, gm.tgmm.skip_launches)


# ---------------------------------------------------------------------------
# Every configuration, on one rank
# ---------------------------------------------------------------------------

def _configs(n: int, dev: torch.device):
    """``(letter, label, cfg, sizes, kind, fallback_fatal)`` in the
    reference's order, skipping where it skips; D (decode) last, with kind
    ``"decode"``."""
    from .workloads.runtime import ENV_NUM_SLICES, ENV_SLICE_ID, JobRuntime

    moe_dtype = "bfloat16" if dev.type == "cuda" else "float32"
    flagship = _flagship_cfg()
    out = [("A", "dense", flagship, _assign_axes(n, ("tp", "sp", "dp")),
            "dense", False)]
    sizes_b = _assign_axes(n, ("pp", "ep", "tp"))
    if flagship.n_layers % sizes_b["pp"] == 0:
        out.append(("B", "pipeline", _moe_cfg("einsum", moe_dtype), sizes_b,
                    "pipeline", False))
    out.append(("B2", "moe-grouped", _moe_cfg("grouped", moe_dtype),
                _assign_axes(n, ("ep", "tp", "dp")), "dense", True))
    if flagship.n_layers % sizes_b["pp"] == 0:
        out.append(("B3", "pp-moe-grouped", _moe_cfg("grouped", moe_dtype),
                    sizes_b, "1f1b", True))
    sizes_c = _assign_axes(n, ("pp", "tp", "dp"))
    if flagship.n_layers % sizes_c["pp"] == 0:
        out.append(("C", "1f1b", flagship, sizes_c, "1f1b", False))
    rt = JobRuntime.from_env({ENV_NUM_SLICES: "2", ENV_SLICE_ID: "0"})
    assert rt.num_slices == 2 and rt.slice_id == 0
    if n % rt.num_slices == 0:
        sizes_e = {a: 1 for a in AXES}
        sizes_e["dp"] = rt.num_slices             # across slices
        per_slice = n // rt.num_slices            # within a slice
        sizes_e["tp"] = 2 if per_slice % 2 == 0 else 1
        sizes_e["fsdp"] = per_slice // sizes_e["tp"]
        out.append(("E", "multislice", flagship, sizes_e, "dense", False))
    out.append(("D", "decode", flagship, _assign_axes(n, ("tp", "dp")),
                "decode", False))
    return out


def _decode(cfg: LlamaConfig, sizes: Dict[str, int], dev: torch.device):
    """Config D: ``generate`` of 4 tokens from a ``[max(4, 2 · dp), 8]``
    prompt under a tp/dp mesh, under the guard (the decode table's whole
    gather is by design); -> (mesh shape, output shape, ms)."""
    from .models.generate import generate
    from .parallel.mesh import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec(**sizes), dev.type)
    model = llama_init(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                       mesh=mesh)
    prompt = torch.zeros((max(4, 2 * sizes["dp"]), 8), dtype=torch.int64,
                         device=dev)
    t0 = time.perf_counter()
    with gather_log(model) as log:
        out = generate(model, prompt, cfg, max_new_tokens=4, mesh=mesh)
    ms = (time.perf_counter() - t0) * 1e3
    bad = guard_violations(model, log, allowed=("embed",))
    assert not bad, "dry-run guard: " + "; ".join(bad)
    assert tuple(out.shape) == (prompt.shape[0], 12), tuple(out.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape)), tuple(out.shape), ms


def run_configs(n: int, dev: torch.device, steps: int = 1,
                only: Optional[Sequence[str]] = None) -> List[dict]:
    """Every configuration (or the letters in ``only``) on this rank of
    an n-rank group; rank 0 prints the OK lines, every rank its skip
    launches in the fallback-fatal configs.  Returns one record a
    configuration."""
    import torch.distributed as dist

    rank = dist.get_rank()
    records = []
    saw_tp_gather = False
    for letter, label, cfg, sizes, kind, fatal in _configs(n, dev):
        if only and letter not in only:
            continue
        if kind == "decode":
            shape, out_shape, ms = _decode(cfg, sizes, dev)
            if rank == 0:
                print(f"dryrun[decode] OK: mesh {shape}, generated "
                      f"{out_shape}", flush=True)
            records.append({"config": letter, "label": label,
                            "mesh": shape, "ms": [ms]})
            continue
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = dryrun_step(cfg, sizes, kind, device=dev, steps=steps)
        fell_back = [str(w.message) for w in caught
                     if "falling back" in str(w.message)]
        if fatal:
            assert not fell_back, (
                f"dryrun[{label}]: grouped dispatch fell back: {fell_back}")
            print(f"dryrun[{label}] rank {rank}: skip launches gmm "
                  f"{res.gmm_skip}, tgmm {res.tgmm_skip}", flush=True)
            if dev.type == "cuda":
                assert res.gmm_skip > 0 and res.tgmm_skip > 0, (
                    f"dryrun[{label}] rank {rank}: the grouped kernels' "
                    f"skip forms were not launched ({res.gmm_skip}, "
                    f"{res.tgmm_skip})")
        saw_tp_gather |= any(d == "tp" for d, _, _ in res.gathers)
        if rank == 0:
            print(f"dryrun[{label}] OK: mesh {res.mesh}, batch "
                  f"{res.batch}x{res.seq}, loss {res.loss:.4f}", flush=True)
        records.append({"config": letter, "label": label, "mesh": res.mesh,
                        "loss": res.loss, "losses": res.losses,
                        "ms": res.step_ms, "gmm_skip": res.gmm_skip,
                        "tgmm_skip": res.tgmm_skip})
    # The guard's own probe: a tp axis above 1 gathers the CE's logits over
    # tp, so a run that recorded no gather over tp recorded nothing.
    if n > 1 and not only:
        assert saw_tp_gather, (
            "the gather log saw no all-gather over tp: the guard cannot be "
            "trusted on this torch")
    if rank == 0 and not only:
        print("dryrun_multichip OK: dp/fsdp/sp/tp (dense+ring), pp/ep/tp "
              "(pipeline+MoE), ep/tp/dp dropless-grouped MoE "
              "(fallback-fatal), pp x ep dropless-grouped MoE under 1F1B "
              "(fallback-fatal), pp 1F1B, multislice (MEGASCALE "
              "dp-across-slices), and sharded decode all ran one step "
              "with every gradient placed as its parameter and no tp/ep "
              "parameter gathered whole", flush=True)
    return records


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def dryrun_multichip(n_devices: int, device: str = "cuda", *,
                     steps: int = 1, configs: Optional[Sequence[str]] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> List[dict]:
    """Run every configuration (or the letters in ``configs``) over
    ``n_devices`` ranks of this module, ``steps`` steps each, and print
    their lines (rank 0's first).  ``device``: ``"cuda"`` (nccl, one card a
    rank; raises with fewer cards than ranks, or without CUDA) or
    ``"cpu"`` (gloo, one thread a rank).  Raises if any rank fails or
    outlasts ``timeout_s``.  Returns each rank's records (:func:`run_configs`),
    by rank."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs "
                           f"{n_devices} cards, found "
                           f"{torch.cuda.device_count()}")
    root = str(Path(__file__).resolve().parent.parent)
    # Rank 0 binds the store's port itself, so the port is drawn below
    # the ephemeral range (see free_port).
    port = free_port()
    argv = [sys.executable, "-m", "kubeflow_controller_tpu_torch.graft_entry",
            "--rank-child", "--n", str(n_devices), "--device", dev.type,
            "--steps", str(steps)]
    if configs:
        argv += ["--configs", ",".join(configs)]
    with contextlib.ExitStack() as stack:
        outs = [(stack.enter_context(tempfile.TemporaryFile("w+")),
                 stack.enter_context(tempfile.TemporaryFile("w+")))
                for _ in range(n_devices)]
        procs = []
        for r, (out, err) in enumerate(outs):
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith(("JAX_COORDINATOR", "JAX_NUM_PROC",
                                        "JAX_PROCESS"))}
            env.update(PYTHONPATH=os.pathsep.join(
                filter(None, [root, env.get("PYTHONPATH")])),
                JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                JAX_NUM_PROCESSES=str(n_devices), JAX_PROCESS_ID=str(r))
            if dev.type == "cpu":
                env["OMP_NUM_THREADS"] = "1"
            procs.append(subprocess.Popen(argv, env=env, stdout=out,
                                          stderr=err, text=True))
        # Wait for every rank; a rank that fails ends the call (its peers
        # would wait in a collective until the timeout).
        deadline = time.monotonic() + timeout_s
        try:
            while (any(p.poll() is None for p in procs)
                   and not any(p.returncode for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for out, err in outs:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
    records, failed = [], []
    for r, (p, (out, err)) in enumerate(zip(procs, texts)):
        lines = out.splitlines()
        done = p.returncode == 0 and lines and lines[-1].startswith("{")
        print("\n".join(lines[:-1] if done else lines), flush=True)
        if done:
            records.append(json.loads(lines[-1])["records"])
        else:
            failed.append(f"rank {r} exited {p.returncode}:\n{err[-4000:]}")
    if failed:
        # A rank killed here (-9) shows after the rank that failed first.
        failed.sort(key=lambda f: " exited -9:" in f)
        raise RuntimeError(f"dryrun_multichip({n_devices}) failed "
                           f"(timeout {timeout_s:g} s): " + failed[0])
    return records


def _rank_child(n: int, device: str, steps: int,
                only: Optional[Sequence[str]]) -> int:
    import torch.distributed as dist

    from .workloads.runtime import JobRuntime

    rt = JobRuntime.from_env()
    dev = resolve_device(device if device == "cpu"
                         else f"cuda:{rt.process_id}")
    if dev.type == "cpu":
        torch.set_num_threads(1)
    rt.initialize(dev)
    if not dist.is_initialized():      # one rank: a group of its own
        rt.join_group(dev)
    try:
        records = run_configs(n, dev, steps, only)
    finally:
        rt.shutdown()
    print(json.dumps({"rank": rt.process_id, "records": records}),
          flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="graft-entry hooks")
    p.add_argument("--device", default="cuda",
                   help="torch device (raises without CUDA unless 'cpu' is "
                        "named)")
    p.add_argument("--rank-child", action="store_true",
                   help="run as one rank of dryrun_multichip")
    p.add_argument("--n", type=int, default=1)
    p.add_argument("--steps", type=int, default=1)
    p.add_argument("--configs", default="")
    args = p.parse_args(argv)
    if args.rank_child:
        return _rank_child(args.n, args.device, args.steps,
                           [c for c in args.configs.split(",") if c])
    fn, fargs = entry(args.device)
    with torch.no_grad():
        out = fn(*fargs)
    print("entry forward:", tuple(out.shape), out.dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
