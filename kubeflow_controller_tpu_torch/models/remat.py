"""The named remat policies — the port of ``_maybe_remat`` in
``kubeflow_controller_tpu/models/llama.py`` and of ``ckpt_marker`` in its
``models/moe.py``, as PyTorch selective activation checkpointing.

A layer runs under ``torch.utils.checkpoint.checkpoint`` (non-reentrant).
``"full"`` keeps only the layer's input and re-runs the rest in the
backward.  The named policies keep some outputs and re-run the rest, the
way ``jax.checkpoint(layer, policy=...)`` does:

- ``"dots"`` (``dots_with_no_batch_dims_saveable``): the outputs of the
  products with no batch dims.  The port writes every such product (the
  q/k/v/o projections, the dense FFN, the router) as a 2-D ``aten.mm``,
  so the policy keeps ``aten.mm``/``aten.addmm`` outputs; batched products
  (``aten.bmm``: the attention scores, the MoE einsums) re-run, as do the
  kernels, which JAX's policy does not count as dots either.
- ``"ffn"``, ``"gateup"``, ``"gateup_attn"``, ``"moe"``
  (``save_only_these_names``): the outputs of the ops run inside a
  :func:`checkpoint_name` scope whose name the policy lists.  The scopes
  sit where the reference calls ``checkpoint_name``, each around the one
  op that makes the named value (casts and layout changes stay outside).

A policy decides per dispatched op, in the forward and again in the
recompute; a scope is set by the code that runs, so both decide alike.
The kernels are dispatcher ops (``kctpu::flash_fwd``, ``kctpu::gmm``,
``kctpu::gmm_swiglu``), so a kept kernel is not launched again.

One exception keeps the port's recompute equal to JAX's:
``kctpu::gmm_swiglu`` is never kept.  The reference names its output h
(``ffn_up``), but its custom VJP's residuals, the gate and up products,
carry no name, so JAX re-runs the fused kernel in the backward under every
policy (2 launches a layer, as under ``"full"``).  A dispatcher op's
outputs are kept all or none, and keeping h alone would still re-run it.
``tests/test_torch_remat.py`` holds the kernels' launches per policy equal
to the ``pallas_call`` count of ``jax.grad``'s jaxpr.
"""

from __future__ import annotations

import contextlib
import contextvars
from functools import partial
from typing import Callable, FrozenSet, Iterator, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..ops import grouped_matmul  # noqa: F401  (registers kctpu::gmm_swiglu)

# The names each policy keeps ("dots" keeps by op, "full" keeps nothing
# but the layer's input).
POLICIES = {
    "full": None,
    "dots": None,
    "ffn": frozenset({"ffn_gate", "ffn_up", "ffn_down"}),
    "gateup": frozenset({"ffn_gate", "ffn_up"}),
    "gateup_attn": frozenset({"ffn_gate", "ffn_up", "attn_proj"}),
    "moe": frozenset({"ffn_gate", "ffn_up", "ffn_down", "moe_x", "moe_y",
                      "attn_proj"}),
}

NO_BATCH_PRODUCTS = frozenset({torch.ops.aten.mm.default,
                               torch.ops.aten.addmm.default})
NEVER_KEPT = frozenset({torch.ops.kctpu.gmm_swiglu.default})

_SCOPE: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "kctpu_checkpoint_name", default=None)


@contextlib.contextmanager
def checkpoint_name(name: str) -> Iterator[None]:
    """Name the outputs of the ops run inside (``jax.ad_checkpoint.
    checkpoint_name`` on the value they make)."""
    token = _SCOPE.set(name)
    try:
        yield
    finally:
        _SCOPE.reset(token)


def _decide(names: Optional[FrozenSet[str]], ctx, op, *args,
            **kwargs) -> CheckpointPolicy:
    if names is None:
        keep = op in NO_BATCH_PRODUCTS
    else:
        keep = _SCOPE.get() in names and op not in NEVER_KEPT
    return (CheckpointPolicy.MUST_SAVE if keep
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn: Callable, policy: str) -> Callable:
    """``fn`` under ``torch.utils.checkpoint`` with ``policy`` (a key of
    :data:`POLICIES`)."""
    if policy not in POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; expected one of "
                         f"{sorted(POLICIES)}")
    if policy == "full":
        return partial(checkpoint, fn, use_reentrant=False)
    context_fn = partial(create_selective_checkpoint_contexts,
                         partial(_decide, POLICIES[policy]))
    return partial(checkpoint, fn, use_reentrant=False,
                   context_fn=context_fn)
