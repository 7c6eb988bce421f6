"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

- ``grouped_matmul`` — ``gmm``, ``gmm_swiglu`` and the weight-gradient
  ``tgmm`` (CUDA C++, ``csrc/grouped_matmul.cu``), the MoE expert FFN,
  ``gmm`` and ``gmm_swiglu`` differentiable.
- ``attention`` — ``flash_fwd``, ``flash_dq`` and ``flash_dkv`` (CUDA C++,
  ``csrc/flash_attention.cu``) behind the differentiable
  ``flash_attention``.
- ``adamw`` — ``adamw_step``, AdamW's update with the clip's scale folded
  in, one pass a parameter tensor (CUDA C++, ``csrc/adamw.cu``), which
  ``workloads/trainer.py:FusedAdamW`` launches.
- ``moe_layout`` — the MoE layer's grouped row layout, each routing slot's
  rank inside its expert and the maps built from it (CUDA C++,
  ``csrc/moe_layout.cu``), which ``models/moe.py:grouped_layout`` calls.
- ``norm_rope`` — RMSNorm and rotate-half RoPE, each or both in one pass
  over the rows, forward and backward (CUDA C++, ``csrc/norm_rope.cu``),
  behind the differentiable ``kctpu::norm_rope`` op that
  ``models/llama.py``'s ``rmsnorm`` and ``apply_rope`` call.
- ``_build`` — compiles ``csrc/*.cu`` with ``nvcc`` at first use and loads
  the result with ``ctypes``.

A wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""
