"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

- ``grouped_matmul`` — ``gmm`` and ``gmm_swiglu`` (CUDA C++,
  ``csrc/grouped_matmul.cu``), the MoE expert FFN.
- ``attention`` — ``flash_fwd``, ``flash_dq`` and ``flash_dkv`` (CUDA C++,
  ``csrc/flash_attention.cu``) behind the differentiable
  ``flash_attention``.
- ``_build`` — compiles ``csrc/*.cu`` with ``nvcc`` at first use and loads
  the result with ``ctypes``.

A wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""
