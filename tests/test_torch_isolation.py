"""The port stands alone and never falls back to the CPU.

- Importing every module of ``kubeflow_controller_tpu_torch`` and
  ``chip_smoke.py`` in a fresh interpreter loads no ``jax``, ``flax``,
  ``optax`` or ``orbax`` and no module of the JAX package (whose name is a prefix of the port's: the check is
  on the exact name and the exact ``kubeflow_controller_tpu.`` prefix).
  No source file of the port imports them lazily either.
- Without CUDA, every entry point called without ``device="cpu"`` raises,
  and ``chip_smoke.py`` exits non-zero without printing a result, as it
  does in a directory that holds nothing else of the repo.
"""

import ast
import importlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import kubeflow_controller_tpu_torch as port
from kubeflow_controller_tpu_torch import bridge, device, graft_entry
from kubeflow_controller_tpu_torch.cluster import topology
from kubeflow_controller_tpu_torch.models import llama, mnist, vision
from kubeflow_controller_tpu_torch.workloads import (
    cifar_allreduce,
    data,
    flax_mnist,
    llama_pretrain,
    mnist_dist,
    mnist_local,
    runtime,
    serve,
)

# The module by its name: the package exports the function ``generate``.
generate = importlib.import_module("kubeflow_controller_tpu_torch.models.generate")

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PKG = Path(port.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "kubeflow_controller_tpu")


# The modules of each slice, which the checks below must reach.
SLICE_MODULES = ("workloads.serve", "ops.grouped_matmul", "ops.attention",
                 "parallel.ring", "workloads.data", "workloads.trainer",
                 "workloads.runtime", "workloads.llama_pretrain",
                 "models.mnist", "recovery.rendezvous", "utils.rand",
                 "workloads.mnist_local", "workloads.mnist_dist",
                 "workloads.checkpoint", "workloads.compile_cache",
                 "models.vision", "workloads.flax_mnist",
                 "workloads.cifar_allreduce", "models.remat",
                 "parallel.mesh", "parallel.sharding",
                 "parallel.collectives", "parallel.ulysses",
                 "models.generate", "graft_entry", "obs.trace",
                 "obs.metrics", "workloads.launch", "cluster.topology",
                 "cluster.gpu", "utils.threefry")


def forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def module_name(path: Path) -> str:
    parts = (PKG.name,) + path.relative_to(PKG).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def port_sources():
    return (sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
            + sorted((REPO / "tools").glob("*.py")))


def test_forbidden_matches_exact_names_only():
    assert forbidden("jax") and forbidden("jax.numpy") and forbidden("jaxlib")
    assert forbidden("flax.linen") and forbidden("optax")
    assert forbidden("orbax.checkpoint") and not forbidden("flaxen")
    assert forbidden("kubeflow_controller_tpu")
    assert forbidden("kubeflow_controller_tpu.models.llama")
    assert not forbidden("kubeflow_controller_tpu_torch")
    assert not forbidden("kubeflow_controller_tpu_torch.models.llama")


def test_importing_the_port_and_chip_smoke_loads_no_jax():
    modules = sorted(module_name(p) for p in PKG.rglob("*.py"))
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    for name in SLICE_MODULES:
        assert f"kubeflow_controller_tpu_torch.{name}" in loaded, name
    assert "chip_smoke" in loaded
    assert [m for m in loaded if forbidden(m)] == []


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_imports_jax_or_the_jax_package(path):
    """Covers imports inside functions too, which importing never runs."""
    tree = ast.parse(path.read_text(), str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert [n for n in names if forbidden(n)] == []


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")


def tiny():
    return llama.LlamaConfig.tiny()


@pytest.mark.parametrize("entry", [
    lambda: device.resolve_device(),
    lambda: llama.Llama(tiny()),
    lambda: llama.llama_init(tiny(), torch.Generator()),
    lambda: generate.init_paged_cache(tiny(), 3, 8),
    lambda: generate.init_cache(tiny(), 1, 8),
    lambda: bridge.llama_from_jax({}, tiny()),
    lambda: serve.LlamaBackend(tiny()),
    lambda: serve.main(["--port", "0"]),
    lambda: bridge.tokens_from_jax(np.zeros((1, 2), np.int32)),
    lambda: data.synthetic_tokens(1, 2, 8, 16),
    lambda: llama_pretrain.train(tiny(), steps=1, batch_size=1, seq_len=8),
    lambda: llama_pretrain.main(["--steps", "1"]),
    lambda: data.synthetic_mnist(1, 4),
    lambda: mnist.MnistMLP(mnist.mlp_init(0)),
    lambda: mnist_local.train(steps=1),
    lambda: mnist_local.main(["--steps", "1"]),
    lambda: mnist_dist.main(["--steps", "1"]),
    lambda: runtime.JobRuntime(coordinator="127.0.0.1:1", num_processes=2,
                               process_id=1).initialize(),
    lambda: data.synthetic_cifar(1, 4),
    lambda: data.synthetic_mnist_images(1, 4),
    lambda: vision.FlaxMNISTCNN(),
    lambda: vision.resnet18(width=8),
    lambda: vision.resnet50(width=8),
    lambda: flax_mnist.main(["--steps", "1"]),
    lambda: cifar_allreduce.main(["--steps", "1"]),
    lambda: graft_entry.entry(),
    lambda: graft_entry.dryrun_multichip(2),
    lambda: topology.discover_host("node-0"),
], ids=["resolve_device", "Llama", "llama_init", "init_paged_cache",
        "init_cache",
        "llama_from_jax", "LlamaBackend", "serve.main", "tokens_from_jax",
        "synthetic_tokens", "llama_pretrain.train", "llama_pretrain.main",
        "synthetic_mnist", "MnistMLP", "mnist_local.train",
        "mnist_local.main", "mnist_dist.main", "JobRuntime.initialize",
        "synthetic_cifar", "synthetic_mnist_images", "FlaxMNISTCNN",
        "resnet18", "resnet50", "flax_mnist.main", "cifar_allreduce.main",
        "graft_entry.entry", "graft_entry.dryrun_multichip",
        "discover_host"])
def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, entry):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_pod_launcher_raises_without_cuda_and_starts_no_child(no_cuda):
    """In a fresh interpreter, a pod of 2 local devices on the default
    device: the launcher raises before it spawns a rank."""
    code = (
        "import json, subprocess\n"
        "from unittest import mock\n"
        "from kubeflow_controller_tpu_torch.workloads import launch\n"
        "spawned = []\n"
        "def popen(*a, **k):\n"
        "    spawned.append(a)\n"
        "    raise AssertionError('spawned a rank')\n"
        "with mock.patch.object(subprocess, 'Popen', popen):\n"
        "    try:\n"
        "        launch.launch_pod('kubeflow_controller_tpu_torch.workloads."
        "llama_pretrain', ['--steps', '1'])\n"
        "        raised = ''\n"
        "    except RuntimeError as e:\n"
        "        raised = str(e)\n"
        "print(json.dumps({'raised': raised, 'spawned': len(spawned)}))\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("KCTPU_", "JAX_"))}
    env.update(KCTPU_LOCAL_DEVICES="2", JAX_NUM_PROCESSES="1",
               TPU_ACCELERATOR_TYPE="h100-2")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert "device='cpu'" in out["raised"], out
    assert out["spawned"] == 0


def test_cpu_must_be_asked_for_by_name(no_cuda):
    assert device.resolve_device("cpu") == torch.device("cpu")
    cache = generate.init_paged_cache(tiny(), 3, 8, device="cpu")
    assert cache["k"].device.type == "cpu"
    assert device.torch_dtype("bfloat16") is torch.bfloat16
    with pytest.raises(ValueError):
        device.torch_dtype("bf16")


def test_bridge_rejects_a_shape_mismatch():
    cfg = tiny()
    model = llama.Llama(cfg, device="cpu")
    params = {"embed": np.zeros((cfg.vocab_size, cfg.dim), np.float32),
              "layers": {k: np.zeros((cfg.n_layers,)
                                     + tuple(getattr(model.layers[0], k).shape),
                                     np.float32)
                         for k in bridge.LAYER_KEYS},
              "final_norm": np.zeros((cfg.dim,), np.float32),
              "lm_head": np.zeros((cfg.dim, cfg.vocab_size), np.float32)}
    bridge.llama_from_jax(params, cfg, device="cpu")
    params["layers"]["wq"] = params["layers"]["wq"][:, :, :1]
    with pytest.raises(ValueError, match="wq"):
        bridge.llama_from_jax(params, cfg, device="cpu")


def run_chip_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_cuda(no_cuda):
    res = run_chip_smoke(REPO)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = run_chip_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
