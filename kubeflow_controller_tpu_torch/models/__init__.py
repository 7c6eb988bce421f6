"""Models of the port: the Llama decoder (dense or MoE) and its paged-KV
serving path.

- ``llama`` — ``LlamaConfig``, the parameter module tree, ``llama_init``
  and the building blocks (``rmsnorm``, RoPE, ``ffn_block``).
- ``moe`` — router and the grouped (dropless) expert dispatch.
- ``generate`` — the slot-paged KV cache: prefill, tail extend, decode
  step, row copy.
"""

from .llama import Llama, LlamaConfig, LlamaLayer, llama_init

__all__ = ["Llama", "LlamaConfig", "LlamaLayer", "llama_init"]
