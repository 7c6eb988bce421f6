"""Launch N gloo ranks of ``tests/_torch_mesh_worker.py`` as subprocesses
(one thread each, a free local port), the pattern of
``tests/test_torch_gang.py``.  Shared by the mesh tests."""

import os
import subprocess
import sys
from pathlib import Path

# A local port drawn below the kernel's ephemeral range, for a gang whose
# rank 0 binds it: the port's one copy of the rule.
from kubeflow_controller_tpu_torch.workloads.launch import free_port  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "_torch_mesh_worker.py"


def gang_env(world: int, rank: int, port: int, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("KCTPU_", "JAX_COORDINATOR", "JAX_NUM_PROC",
                                "JAX_PROCESS", "MODEL_DIR"))}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
               JAX_NUM_PROCESSES=str(world), JAX_PROCESS_ID=str(rank),
               **extra)
    return env


def start_ranks(world: int, *args: str, **env):
    port = free_port()
    return [subprocess.Popen([sys.executable, str(WORKER), *args],
                             env=gang_env(world, r, port, **env),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
            for r in range(world)]


def run_ranks(world: int, *args: str, timeout: float = 150.0) -> None:
    """Run the worker on ``world`` ranks; every rank must exit 0."""
    wait_ranks(start_ranks(world, *args), timeout)


def wait_ranks(procs, timeout: float = 150.0) -> None:
    """Wait for started ranks; every rank must exit 0."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, err[-3000:]) for r, (p, (_, err))
           in enumerate(zip(procs, outs)) if p.returncode]
    assert not bad, bad
