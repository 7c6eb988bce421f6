"""Models of the port: the Llama decoder (dense or MoE) and its paged-KV
serving path.

- ``llama`` — ``LlamaConfig``, the parameter module tree, ``llama_init``,
  the building blocks (``rmsnorm``, RoPE, ``ffn_block``) and the training
  forward and loss (``llama_forward``, ``llama_loss``), on one device or
  sharded on a mesh (``shard_llama``).
- ``remat`` — the named remat policies as selective checkpointing.
- ``moe`` — router and the expert dispatches: ``einsum`` and ``scatter``
  (capacity-dropping) and ``grouped`` (dropless, the CUDA kernels).
- ``generate`` — the slot-paged KV cache: prefill, tail extend, decode
  step, row copy.
- ``mnist`` — the MNIST softmax regression and MLP; ``vision`` — the
  Flax-MNIST CNN and the CIFAR ResNets (flax's padding, BatchNorm and
  initialisers).
"""

from .llama import Llama, LlamaConfig, LlamaLayer, llama_init

__all__ = ["Llama", "LlamaConfig", "LlamaLayer", "llama_init"]
