"""gemm_ms (ms): device ms a step in library GEMMs (cuBLAS, CUTLASS and
nvjet kernels), outside the optimizer."""


def read(ctx):
    us = ctx.reduced.group_us["gemm"]
    return us / 1e3 / ctx.reduced.steps if us else None
