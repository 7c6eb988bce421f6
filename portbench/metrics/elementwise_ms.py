"""elementwise_ms (ms): device ms a step in every kernel outside the named
groups (flash, grouped matmuls, library GEMMs, gather/scatter/index/sort)
and outside the optimizer: norms, RoPE, casts, copies, the GQA repeats,
SwiGLU, the cross-entropy's softmax."""


def read(ctx):
    us = ctx.reduced.group_us["other"]
    return us / 1e3 / ctx.reduced.steps if us else None
