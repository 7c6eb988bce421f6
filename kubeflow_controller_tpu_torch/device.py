"""Device resolution and dtype names — with no CPU fallback.

Every entry point of the port takes ``device`` (default ``"cuda"``) and
resolves it here.  A CUDA request on a host without CUDA raises: the port
never carries on on the CPU unless the caller asked for the CPU by name.

A rank that its pod's launcher started (``workloads/launch.py``) trains on
its own device: :func:`rank_device` binds ``cuda`` (no index) to
``cuda:<local rank>`` among the pod's visible cards.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Union

import torch

DeviceLike = Union[str, torch.device]

# The pod's local device count (the port's counterpart of the reference's
# forced host device count; the launcher also hands it to its ranks), and
# a launched rank's index among them.
ENV_LOCAL_DEVICES = "KCTPU_LOCAL_DEVICES"
ENV_LOCAL_RANK = "KCTPU_LOCAL_RANK"

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU")
    return dev


def rank_device(device: DeviceLike = "cuda",
                env: Optional[Mapping[str, str]] = None) -> torch.device:
    """:func:`resolve_device`, with a launched rank's ``cuda`` bound to its
    own card, ``cuda:<local rank>``.  Such a rank may not name another
    card, and a local rank past the visible cards raises: no rank falls
    back to a card another rank holds."""
    dev = resolve_device(device)
    e = os.environ if env is None else env
    raw = e.get(ENV_LOCAL_RANK)
    if raw is None or dev.type != "cuda":
        return dev
    if dev.index is not None:
        raise ValueError(f"device {str(dev)!r}: a rank of a pod's launcher "
                         "takes its card from its local rank; pass 'cuda'")
    rank, seen = int(raw), torch.cuda.device_count()
    if rank >= seen:
        raise RuntimeError(f"local rank {rank} has no card: {seen} visible")
    return torch.device("cuda", rank)


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """The config's dtype name (``"bfloat16"``, ``"float32"``, ...) as a
    ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None
