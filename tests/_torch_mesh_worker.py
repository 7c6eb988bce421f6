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
    grads = {n: p.grad.full_tensor().numpy()
             for n, p in model.named_parameters()}
    norm = opt.step()
    clipped = {n: p.grad.full_tensor().numpy()
               for n, p in model.named_parameters()}
    after = {n: p.full_tensor().detach().numpy()
             for n, p in model.named_parameters()}
    value = float(loss.to_local())
    if dist.get_rank() == 0:
        torch.save({"loss": value, "grads": grads, "clipped": clipped,
                    "params": after,
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


def main(argv) -> int:
    rt = JobRuntime.from_env()
    rt.initialize("cpu", timeout_s=120)
    scenario, out, *rest = argv
    {"collectives": collectives, "step": step, "train": train}[scenario](
        out, *rest)
    rt.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
