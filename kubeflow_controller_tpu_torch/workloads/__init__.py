"""Runnable workloads of the port.

- ``serve`` — the continuous-batching inference replica
  (``python -m kubeflow_controller_tpu_torch.workloads.serve``).
- ``progress`` — heartbeat publisher for the serve entry point.
"""
