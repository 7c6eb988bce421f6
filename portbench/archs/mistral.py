"""Mistral (``model_type`` "mistral", Mistral-7B-v0.3): the dense
decoder of ``_decoder.py``."""

from portbench.archs._decoder import (  # noqa: F401
    attention_layers,
    expert_ffn,
    leaves,
    loss,
    matmul_params_per_token,
    model_flops_per_token,
    port_keys,
)
