"""Device resolution and dtype names — with no CPU fallback.

Every entry point of the port takes ``device`` (default ``"cuda"``) and
resolves it here.  A CUDA request on a host without CUDA raises: the port
never carries on on the CPU unless the caller asked for the CPU by name.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]

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
