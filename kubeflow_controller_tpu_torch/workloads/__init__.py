"""Runnable workloads of the port.

- ``serve`` — the continuous-batching inference replica
  (``python -m kubeflow_controller_tpu_torch.workloads.serve``).
- ``progress`` — heartbeat publisher for the serve and training entry
  points.
- ``llama_pretrain`` — the Llama pretrain, on one device or over a gang
  and a dp x fsdp x tp mesh
  (``python -m kubeflow_controller_tpu_torch.workloads.llama_pretrain``),
  with ``data`` (synthetic tokens), ``trainer`` (clip + AdamW) and
  ``runtime`` (the controller's env contract).
- ``mnist_local`` / ``mnist_dist`` — the Local and Worker MNIST workloads
  (``python -m kubeflow_controller_tpu_torch.workloads.mnist_dist``), with
  ``data`` (synthetic MNIST), ``trainer`` (the local loop, the one-
  all-reduce dist step and its per-step loop) and ``runtime`` (the gang
  join over ``torch.distributed``).
- ``flax_mnist`` / ``cifar_allreduce`` — the data-parallel vision TFJobs
  (``python -m kubeflow_controller_tpu_torch.workloads.cifar_allreduce``):
  the Flax-MNIST CNN with Adam and the CIFAR ResNets with SGD, BatchNorm
  over the global batch (``models/vision.py``).
- ``checkpoint`` — ``MODEL_DIR`` saves and restores on
  ``torch.distributed.checkpoint``, with which every training main
  resumes a replacement replica; ``compile_cache`` — the kernel build up
  front, inside the reporter's compile window.
"""
