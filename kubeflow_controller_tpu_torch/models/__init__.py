"""Models of the port: the Llama decoder (dense or MoE) and its paged-KV
serving path.

- ``llama`` — ``LlamaConfig``, the parameter module tree, ``llama_init``,
  the building blocks (``rmsnorm``, RoPE, ``ffn_block``) and the training
  forward and loss (``llama_forward``, ``llama_loss``).
- ``moe`` — router and the grouped (dropless) expert dispatch.
- ``generate`` — the slot-paged KV cache: prefill, tail extend, decode
  step, row copy.
"""

from .llama import Llama, LlamaConfig, LlamaLayer, llama_init

__all__ = ["Llama", "LlamaConfig", "LlamaLayer", "llama_init"]
