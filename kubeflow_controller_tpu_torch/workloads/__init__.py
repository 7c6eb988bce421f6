"""Runnable workloads of the port.

- ``serve`` — the continuous-batching inference replica
  (``python -m kubeflow_controller_tpu_torch.workloads.serve``).
- ``progress`` — heartbeat publisher for the serve entry point.
- ``llama_pretrain`` — the single-device Llama pretrain
  (``python -m kubeflow_controller_tpu_torch.workloads.llama_pretrain``),
  with ``data`` (synthetic tokens), ``trainer`` (clip + AdamW) and
  ``runtime`` (the controller's env contract).
"""
