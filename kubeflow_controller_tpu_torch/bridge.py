"""JAX parameter pytree -> the port's module tree.

Takes the reference's ``llama_init`` pytree, converted leaf by leaf to
numpy (``jax.tree.map(np.asarray, params)``; bf16 leaves arrive as
``ml_dtypes`` bfloat16 arrays), with its stacked ``[L, ...]`` layer
layout, and copies it into a ``models.llama.Llama``: layer i of the
stacked array becomes ``model.layers[i]``'s parameter of the same name.
Both the MoE keys (``router``, ``w_gate``, ``w_up``, ``w_down`` with an
expert axis) and the dense ones are covered.  The tests use this so that
both packages compute the same function; ``requires_grad=True`` makes the
bridged model trainable, so its gradients can be held against
``jax.grad``.  ``tokens_from_jax`` carries a ``[B, T]`` token array across,
``mnist_params_from_jax`` the MNIST models' flat parameter dicts,
``vision_params_from_jax`` a flax vision model's variables, and
``cache_from_jax`` a contiguous KV cache (plain or int8) mid-sequence.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models.llama import Llama, LlamaConfig
from .models.mnist import MnistMLP, MnistSoftmax

LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
              "w_up", "w_down")
MOE_KEYS = ("router",)


def _to_tensor(a: Any) -> torch.Tensor:
    arr = np.array(a)       # a writable copy: JAX hands out read-only views
    if arr.dtype.name == "bfloat16":
        # numpy has no bf16; widening to f32 is exact, and the copy into
        # the bf16 parameter rounds nothing.
        arr = arr.astype(np.float32)
    return torch.from_numpy(arr)


def _copy(dst: torch.nn.Parameter, src: Any, name: str) -> None:
    t = _to_tensor(src)
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: JAX shape {tuple(t.shape)} != port shape "
                         f"{tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(t)


def llama_from_jax(params: Mapping[str, Any], cfg: LlamaConfig,
                   device: DeviceLike = "cuda",
                   requires_grad: bool = False) -> Llama:
    """A ``Llama`` on ``device`` holding the values of the JAX pytree
    ``params`` (numpy leaves), in ``cfg.param_dtype``; its parameters
    require grad when asked."""
    model = Llama(cfg, device, requires_grad)
    layers = params["layers"]
    keys = LAYER_KEYS + (MOE_KEYS if cfg.n_experts else ())
    missing = [k for k in keys if k not in layers]
    if missing:
        raise KeyError(f"JAX params lack layer keys {missing}")
    _copy(model.embed, params["embed"], "embed")
    for key in keys:
        stacked = np.asarray(layers[key])
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(f"layers/{key}: {stacked.shape[0]} layers, "
                             f"config has {cfg.n_layers}")
        for i, lp in enumerate(model.layers):
            _copy(getattr(lp, key), stacked[i], f"layers/{key}[{i}]")
    _copy(model.final_norm, params["final_norm"], "final_norm")
    _copy(model.lm_head, params["lm_head"], "lm_head")
    return model


def tokens_from_jax(tokens: Any, device: DeviceLike = "cuda") -> torch.Tensor:
    """A JAX (or numpy) ``[B, T]`` integer token array as an int64 tensor
    on ``device``, values unchanged."""
    arr = np.array(tokens)
    if arr.ndim != 2 or arr.dtype.kind not in "iu":
        raise ValueError(f"tokens must be a [B, T] integer array, got "
                         f"{arr.dtype} {arr.shape}")
    return torch.from_numpy(arr.astype(np.int64)).to(resolve_device(device))


CACHE_KEYS = (("k", "v"), ("k", "v", "k_scale", "v_scale"))


def cache_from_jax(cache: Mapping[str, Any],
                   device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """The reference's ``init_cache`` dict (``k``/``v``, and for the int8
    cache ``k_scale``/``v_scale``; numpy or JAX leaves) as the port's
    cache on ``device``: the same keys, shapes, dtypes and values, so both
    packages can decode on from one mid-sequence cache."""
    if tuple(sorted(cache)) not in tuple(tuple(sorted(k))
                                         for k in CACHE_KEYS):
        raise KeyError(f"not a KV cache: {sorted(cache)}")
    dev = resolve_device(device)
    out = {}
    for key, a in cache.items():
        arr = np.array(a)
        t = _to_tensor(arr)
        if arr.dtype.name == "bfloat16":
            t = t.to(torch.bfloat16)    # exact: the values came from bf16
        out[key] = t.to(dev)
    return out


def mnist_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's MNIST params (``w1 b1 w2 b2`` for the MLP, ``w b``
    for softmax regression; numpy or JAX leaves) as the port's module
    state: CPU tensors under the same names, which ``MnistMLP`` /
    ``MnistSoftmax`` take as params and ``load_state_dict`` takes too."""
    keys = set(params)
    if keys not in (set(MnistMLP.KEYS), set(MnistSoftmax.KEYS)):
        raise KeyError(f"not MNIST params: {sorted(keys)}")
    return {k: _to_tensor(v) for k, v in params.items()}


# flax leaf name -> the port module's state-dict name, per collection.
_VISION_LEAVES = {("params", "kernel"): "weight", ("params", "bias"): "bias",
                  ("params", "scale"): "weight",
                  ("batch_stats", "mean"): "mean",
                  ("batch_stats", "var"): "var"}


def vision_params_from_jax(variables: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """A flax vision model's variables (``{"params": ..., "batch_stats":
    ...}`` from ``models/vision.py``, numpy or JAX leaves) as the state
    dict of the port's model of the same shape (``models/vision.py``),
    which ``load_state_dict`` takes: the flax module path becomes the
    module path (``ResNetBlock_3/Conv_0`` -> ``ResNetBlock_3.Conv_0``),
    conv kernels go HWIO -> OIHW, dense kernels ``[in, out]`` -> ``[out,
    in]``, ``scale`` -> ``weight``, and ``batch_stats``' ``mean``/``var``
    -> the BatchNorm buffers."""
    out: Dict[str, torch.Tensor] = {}

    def walk(coll: str, tree: Mapping[str, Any], path: tuple) -> None:
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(coll, value, path + (key,))
                continue
            name = _VISION_LEAVES.get((coll, key))
            if name is None:
                raise KeyError(f"{coll}/{'/'.join(path + (key,))}: not a "
                               "vision-model leaf")
            t = _to_tensor(value)
            if key == "kernel":
                t = (t.permute(3, 2, 0, 1) if t.ndim == 4 else t.t())
            out[".".join(path + (name,))] = t.contiguous()

    for coll, tree in variables.items():
        walk(coll, tree, ())
    return out
