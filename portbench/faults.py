"""Faults planted under the timed path, for the checks that the comparison
catches them: the calibration on the chip reads each one's gaps at the
cell's size, and the CPU tests see ``correct`` come out false.

- ``unchanged``: the optimizer's step returns and leaves the state as it
  was (no parameter moves);
- ``half_batch``: the loss over half the batch's rows (half the positions
  of a one-row batch), the mean taken over the rest;
- ``grad_altered``: an answer altered where it is produced: the output
  head gets twice its gradient from the backward.

A one-card cell has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
from typing import Iterator
from unittest import mock

from kubeflow_controller_tpu_torch.workloads import trainer

from . import program

FAULTS = ("unchanged", "half_batch", "grad_altered")


def _half(tokens):
    if tokens.shape[0] >= 2:
        return tokens[:tokens.shape[0] // 2]
    return tokens[:, :tokens.shape[1] // 2]


@contextlib.contextmanager
def planted(name: str) -> Iterator[None]:
    real = program.llama_loss
    if name == "unchanged":
        patch = mock.patch.object(trainer.Optimizer, "step",
                                  lambda self: None)
    elif name == "half_batch":
        patch = mock.patch.object(
            program, "llama_loss",
            lambda model, tokens, cfg: real(model, _half(tokens), cfg))
    elif name == "grad_altered":
        def doubled(model, tokens, cfg):
            p = model.lm_head
            if not getattr(p, "_portbench_fault", False):
                p.register_hook(lambda g: 2 * g)
                p._portbench_fault = True
            return real(model, tokens, cfg)
        patch = mock.patch.object(program, "llama_loss", doubled)
    else:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    with patch:
        yield
