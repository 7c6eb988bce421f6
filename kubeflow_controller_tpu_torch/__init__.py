"""kubeflow_controller_tpu_torch — the PyTorch/CUDA port of the JAX workloads.

``kubeflow_controller_tpu`` stays the reference; this package grows beside
it, one slice at a time, and imports nothing from it (it keeps its own
copies of the few JAX-free modules it needs).  Every entry point takes an
explicit ``device`` that defaults to ``"cuda"`` and raises when CUDA is
absent, so nothing silently runs on the CPU; the tests pass
``device="cpu"``.

Layer map of the ported slices (the continuous-batching serving replica
over a grouped-dispatch MoE Llama; the single-device Llama pretrain; the
gang runtime and dist-mnist):

- ``device``      — device resolution (no fallback) and dtype names
- ``bridge``      — JAX parameter pytrees (numpy) -> the port's modules
- ``models/``     — ``llama`` (config, blocks, module tree, init, training
                    forward and loss), ``moe`` (router + grouped dispatch),
                    ``generate`` (paged KV cache), ``mnist`` (softmax
                    regression and the MLP)
- ``ops/``        — hand-written Hopper kernels with plain PyTorch versions
                    beside them (grouped matmuls, flash attention), and the
                    ``nvcc`` build that loads them
- ``csrc/``       — the CUDA C++ sources (sm_90a)
- ``parallel/``   — the attention oracle (``ring.attention_reference``)
- ``recovery/``   — the workload half of gang re-rendezvous (``GangGuard``)
- ``utils/``      — seed coercion
- ``obs/``, ``workloads/`` — phase names, progress beats, the serve engine,
                    the pretrain and MNIST drivers with their data, loops,
                    optimizer and runtime (the controller's env contract
                    and the ``torch.distributed`` gang join)
"""

__version__ = "0.1.0"
