"""Models of the port: the Llama decoder (dense or MoE) and its paged-KV
serving path.

- ``llama`` — ``LlamaConfig``, the parameter module tree, ``llama_init``,
  the building blocks (``rmsnorm``, RoPE, ``ffn_block``) and the training
  forward and loss (``llama_forward``, ``llama_loss``), on one device or
  sharded on a mesh (``shard_llama``); the pipeline-parallel forward and
  loss-and-gradients (``llama_forward_pp``, GPipe, and
  ``llama_loss_and_grads_pp``, 1F1B), over a pp group or virtual stages.
- ``remat`` — the named remat policies as selective checkpointing.
- ``moe`` — router and the expert dispatches: ``einsum`` and ``scatter``
  (capacity-dropping) and ``grouped`` (dropless, the CUDA kernels).
- ``generate`` — cached generation: the contiguous cache (plain or int8
  ``kv_quant``) with its blocked and dense reads, ``forward_with_cache``
  and ``generate``, on one device or dp/tp-sharded on a mesh; and the
  slot-paged cache of the serving replica (prefill, tail extend, decode
  step, row copy).
- ``mnist`` — the MNIST softmax regression and MLP; ``vision`` — the
  Flax-MNIST CNN and the CIFAR ResNets (flax's padding, BatchNorm and
  initialisers).
"""

from .generate import forward_with_cache, generate, init_cache
from .llama import (
    Llama,
    LlamaConfig,
    LlamaLayer,
    llama_forward_pp,
    llama_init,
    llama_loss_and_grads_pp,
)

__all__ = ["Llama", "LlamaConfig", "LlamaLayer", "forward_with_cache",
           "generate", "init_cache", "llama_forward_pp", "llama_init",
           "llama_loss_and_grads_pp"]
