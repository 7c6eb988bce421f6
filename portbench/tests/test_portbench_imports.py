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
        elif isinstance(node, ast.ImportFrom):   # from . import name
            yield from ((a.name, node.level) for a in node.names)


def test_reference_imports_nothing_of_the_port():
    seen, todo = set(), ["reference"]
    while todo:
        name = todo.pop()
        seen.add(name)
        for module, level in _imports(run.BENCH / f"{name}.py"):
            if level:       # portbench's own: follow it
                if module not in seen:
                    todo.append(module)
                continue
            top = module.split(".")[0]
            assert top not in FORBIDDEN | {"kubeflow_controller_tpu_torch"}, \
                (name, module)
    assert seen == {"reference", "weights", "tokens"}
