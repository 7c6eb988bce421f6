"""Mixtral (``model_type`` "mixtral", Mixtral-8x7B-v0.1): the decoder of
``_decoder.py`` with its routed experts (``num_local_experts``, top
``num_experts_per_tok``) in every layer."""

from portbench.archs._decoder import (  # noqa: F401
    attention_layers,
    expert_ffn,
    leaves,
    loss,
    matmul_params_per_token,
    model_flops_per_token,
    port_keys,
)
