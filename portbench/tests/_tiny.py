"""Tiny copies of the benchmark's cells for the CPU tests: each
configuration's widths shrunk, the same keys and code paths."""

from __future__ import annotations

import copy

from portbench import run

TINY = {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 256,
        "num_hidden_layers": 2, "max_position_embeddings": 128}
PORT = {"dim": 64, "intermediate": 128, "n_heads": 4, "n_kv_heads": 2,
        "vocab_size": 256, "n_layers": 2, "max_seq_len": 128}
# Wider experts and longer rows, so that float8 in the experts' products
# shows above the program's rounding at this size, as it does at the
# published widths.
MOE_INTERMEDIATE = 512
MOE_SEQ_LEN = 512
MIX = {"batch": 2, "seq_len": 64, "pool_batches": 6, "checked_steps": 3,
       "warmup_steps": 1, "trace_steps": 1}

# The limits at this size, set by the cells' rule (check.py; PERF.md) from
# readings on the CPU over seeds 0-9 and 2**31 + 12345 (controls and
# faults on 0-2): lower^0.3 x upper^0.7.  mistral-7b-l8: program loss <=
# 2.34e-5, grad <= 1.08e-3, embed_rows <= 4.11e-4, change <= 1.13e-3; fp8
# control >= 1.52e-4, 7.03e-3, 4.23e-3, 2.13e-3; half batch >= 2.05e-3,
# 5.84e-2, 0.395, 0.163.  mixtral-8x7b-l2: program <= 2.51e-5, 1.50e-3,
# 3.43e-4, 1.83e-3; fp8-experts control >= 6.71e-5, 3.11e-3, 1.26e-3,
# 1.20e-3; bf16-state control >= 1.31e-3, 2.23e-4, 3.88e-4, 0.122; half
# batch >= 2.50e-3, 5.95e-2, 0.592, 9.59e-2.  The altered gradient reads
# >= 0.336 on grad and a state left unchanged 1 on grad, embed_rows and
# change, in both.
LIMITS = {"mistral-7b-l8": {"loss": 8.7e-5, "grad": 4.0e-3,
                            "embed_rows": 2.1e-3, "change": 3.7e-2},
          "mixtral-8x7b-l2": {"loss": 4.0e-4, "grad": 2.0e-2,
                              "embed_rows": 8.5e-4, "change": 2.9e-2}}


def tiny_cell(name: str) -> run.Cell:
    """The cell ``name`` of ``BENCHMARK.json`` at the tiny size (an MoE
    configuration keeps 4 experts, top-2, of width ``MOE_INTERMEDIATE``,
    on rows of ``MOE_SEQ_LEN`` tokens), with the limits of that size."""
    cell = copy.deepcopy(run.load_cell(name))
    cell.conf.update(TINY)
    cell.conf["port"].update(PORT)
    cell.mix.update(MIX)
    if cell.conf.get("num_local_experts"):
        cell.conf["num_local_experts"] = cell.conf["port"]["n_experts"] = 4
        cell.conf["intermediate_size"] = cell.conf["port"]["intermediate"] = \
            MOE_INTERMEDIATE
        cell.conf["max_position_embeddings"] = MOE_SEQ_LEN
        cell.conf["port"]["max_seq_len"] = cell.mix["seq_len"] = MOE_SEQ_LEN
    cell.limits = dict(LIMITS[cell.workload["config"]])
    return cell
