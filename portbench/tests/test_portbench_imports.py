"""Nothing the harness runs loads JAX or the JAX package (by whole
top-level module name), and the plain reference imports nothing of the
port."""

import ast
import subprocess
import sys

from portbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "kubeflow_controller_tpu"}

SCRIPT = """
import sys
from portbench import calibrate, faults, run
from portbench.tests._tiny import tiny_cell
for m in run.load_cell("mixtral8x7b-train-b2-t4096").per_layer:
    run.reader(m["name"])
run.run_cell(tiny_cell("mixtral8x7b-train-b2-t4096"), 3, 0.1, True, "cpu")
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def test_harness_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert "kubeflow_controller_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name, 0) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield (node.module, node.level)
            yield from ((f"{node.module}.{a.name}", node.level)
                        for a in node.names)
        elif isinstance(node, ast.ImportFrom):   # from . import name
            yield from ((a.name, node.level) for a in node.names)


def _path(name):
    """The file of the benchmark's module ``name`` (dotted, below
    ``portbench``)."""
    path = run.BENCH.joinpath(*name.split("."))
    return path / "__init__.py" if path.is_dir() else path.with_suffix(".py")


def _own(name, module, level):
    """The benchmark's module that ``module`` names, imported from its
    module ``name``; None for another package's."""
    if level:
        package = name.split(".")
        if not _path(name).name == "__init__.py":
            package = package[:-1]
        return ".".join(package[:len(package) - level + 1] + [module])
    if module.startswith("portbench."):
        return module[len("portbench."):]
    return None


def test_reference_imports_nothing_of_the_port():
    """The reference and every architecture module (whose ``loss`` it
    runs), through every module of the benchmark they import."""
    arch_modules = {f"archs.{p.stem}" for p in (run.BENCH / "archs")
                    .glob("*.py") if p.stem != "__init__"}
    seen, todo = set(), ["reference", *sorted(arch_modules)]
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        for module, level in _imports(_path(name)):
            own = _own(name, module, level)
            if own is not None:     # portbench's own: follow it
                if _path(own).is_file():
                    todo.append(own)
                continue
            top = module.split(".")[0]
            assert top not in FORBIDDEN | {"kubeflow_controller_tpu_torch"}, \
                (name, module)
    assert seen >= {"reference", "weights", "tokens", "archs",
                    "archs._decoder", "archs.mistral", "archs.mixtral"}
