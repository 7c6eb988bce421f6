"""Each model's architecture, found by its configuration's ``model_type``:
the file ``configs/<name>.json`` names ``archs/<model_type>.py``, whose
functions each take the configuration (the file's keys):

- ``leaves(conf)``: ``[(name, shape, init scale)]`` of every parameter, in
  the port's module-tree order, ``embed`` ``[vocab, d]`` among them (the
  check reads its rows); a scale of 0.0 is a norm's, set to one;
- ``loss(conf, params, tokens, precision)``: the training objective on
  ``tokens`` [B, T], in plain PyTorch with ``reference.Math``'s arithmetic,
  importing nothing of the port;
- ``matmul_params_per_token(conf)``, ``model_flops_per_token(conf,
  seq_len)``: the model FLOPs that ``mfu`` reads;
- ``attention_layers(conf)``: one ``(heads, kv heads, head dim, window or
  None)`` a layer, the work ``flash_roofline`` charges;
- ``expert_ffn(conf)``: ``(experts, experts per token, model width, expert
  width)`` of the routed FFN, or None, the work ``gmm_roofline`` charges;
- ``port_keys(conf)``: ``(port key, published value)`` pairs that the
  configuration's ``port`` block holds; ``head_dim`` is the port's head
  width, ``dim // n_heads`` where ``port`` gives none.

A new model is new files (its configuration, ``archs/<model_type>.py``, a
mix, limits, readers) and no edit elsewhere.  A module whose name starts
with ``_`` is code the architectures share, never a ``model_type``.
"""

from __future__ import annotations

import functools
from importlib import util as import_util
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parent.parent
# Set by ``run.load_cell``: the benchmark directory the configuration came
# from, whose ``archs/`` holds its module (without it, this one's).
BENCH_KEY = "_bench"


@functools.lru_cache(maxsize=None)
def load(model_type: str, bench: Path = BENCH) -> ModuleType:
    """``bench/archs/<model_type>.py``; FileNotFoundError naming that file
    where there is none."""
    path = Path(bench) / "archs" / f"{model_type}.py"
    if model_type.startswith("_") or not path.is_file():
        raise FileNotFoundError(f"no architecture for model_type "
                                f"{model_type!r}: {path} is not there")
    spec = import_util.spec_from_file_location(
        f"portbench_arch_{model_type}", path)
    mod = import_util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def of(conf: dict) -> ModuleType:
    """The architecture module of the configuration ``conf``."""
    return load(conf["model_type"], Path(conf.get(BENCH_KEY, BENCH)))
