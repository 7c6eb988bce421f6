"""The system under test: the port's training step, driven on the
benchmark's weights and tokens.

The step is the calls that ``llama_pretrain.train``'s step makes, in its
order: ``llama_loss`` on the batch, ``.backward()``, the optimizer of
``trainer.default_optimizer`` (the clip by global norm, then AdamW),
``zero_grad``, the loss read back, and a device sync.  ``train`` itself
takes no batch from its caller, so the benchmark drives these calls.

The port's ``Llama`` is built on the meta device and each parameter is
set to a view of the benchmark's flat weight buffer (``weights.py``), so
the model holds exactly the weights the seed drew, with no copy.
"""

from __future__ import annotations

import importlib
import pkgutil
from contextlib import nullcontext
from typing import Dict, List

import torch
from torch import nn

from kubeflow_controller_tpu_torch import ops
from kubeflow_controller_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    llama_loss,
)
from kubeflow_controller_tpu_torch.workloads.compile_cache import (
    build_kernels,
)
from kubeflow_controller_tpu_torch.workloads.trainer import default_optimizer

from . import weights

__all__ = ["Program", "build_kernels", "launch_counts"]


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch counters (process totals): each
    function of a module of ``kubeflow_controller_tpu_torch.ops`` that
    counts its launches in ``launches``, under its name, and those that
    skip tiles in ``skip_launches``, under ``<name>_skip``."""
    counts: Dict[str, int] = {}
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{info.name}")
        for name, fn in vars(mod).items():
            if getattr(fn, "__module__", None) != mod.__name__ or \
                    not isinstance(getattr(fn, "launches", None), int):
                continue
            counts[name] = fn.launches
            if isinstance(getattr(fn, "skip_launches", None), int):
                counts[f"{name}_skip"] = fn.skip_launches
    return counts


class Program:
    """The port's model and optimizer on the weights in ``flat``."""

    def __init__(self, conf: dict, flat: torch.Tensor):
        self.cfg = LlamaConfig(**conf["port"])
        self.device = flat.device
        lay = weights.layout(conf)
        model = Llama(self.cfg, "meta", requires_grad=True)
        views = lay.views(flat)
        names = sorted(n for n, _ in model.named_parameters())
        if names != sorted(views):
            raise ValueError("the port's parameters are not the "
                             f"configuration's leaves: {names[:4]}...")
        for name, view in views.items():
            owner, _, attr = name.rpartition(".")
            module = model.get_submodule(owner) if owner else model
            if tuple(getattr(module, attr).shape) != tuple(view.shape):
                raise ValueError(f"{name}: the port's shape "
                                 f"{tuple(getattr(module, attr).shape)} is "
                                 f"not {tuple(view.shape)}")
            setattr(module, attr, nn.Parameter(view, requires_grad=True))
        self.model = model
        self.params = dict(model.named_parameters())
        tr = conf["training"]
        self.beta1 = tr["beta1"]
        self.opt = default_optimizer(model.parameters(), tr["lr"],
                                     clip=tr["clip_norm"],
                                     weight_decay=tr["weight_decay"])

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, tokens: torch.Tensor, spans: bool = False) -> float:
        """One training step on ``tokens`` [B, T]; returns its loss.  With
        ``spans`` each call into a layer runs under a profiler range
        (``portbench.forward``, ``.backward``, ``.optimizer``,
        ``.zero_grad``, ``.sync``) that the traced run reads."""
        def span(name: str):
            if not spans:
                return nullcontext()
            return torch.profiler.record_function(f"portbench.{name}")

        with span("forward"):
            loss = llama_loss(self.model, tokens, self.cfg)
        with span("backward"):
            loss.backward()
        with span("optimizer"):
            self.opt.step()
        with span("zero_grad"):
            self.opt.zero_grad()
        with span("sync"):
            value = float(loss.detach())
            self._sync()
        return value

    @torch.no_grad()
    def first_grad_norms(self) -> Dict[str, float]:
        """Each leaf's gradient as the optimizer got it at its first step
        (after the clip), worked out from AdamW's state: the first moment
        after one step is ``(1 - β1) · g`` (zero where it holds none)."""
        state = self.opt.inner.state
        return {name: float(torch.linalg.vector_norm(
                    state[p]["exp_avg"].float()) / (1 - self.beta1))
                if "exp_avg" in state.get(p, {}) else 0.0
                for name, p in self.params.items()}

    @torch.no_grad()
    def first_embed_rows(self, ids: torch.Tensor) -> List[float]:
        """The norm of each embedding row ``ids`` of the gradient as the
        optimizer got it at its first step, from AdamW's state as
        :meth:`first_grad_norms` reads it (zero with no state)."""
        state = self.opt.inner.state.get(self.params["embed"], {})
        if "exp_avg" not in state:
            return [0.0] * ids.numel()
        rows = state["exp_avg"][ids].float()
        return (torch.linalg.vector_norm(rows, dim=1)
                / (1 - self.beta1)).tolist()

    def leaves(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach() for k, p in self.params.items()}
