"""The benchmark of ``kubeflow_controller_tpu_torch``, the PyTorch and CUDA
port: training steps of public models on the port's path, timed on the
card, checked against a plain PyTorch reference.  ``run.py`` runs one cell
of ``BENCHMARK.json``."""
