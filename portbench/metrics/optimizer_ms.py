"""optimizer_ms (ms): device ms a step in the kernels launched under the
optimizer's step: the clip by global norm and AdamW."""


def read(ctx):
    us = ctx.reduced.optimizer_us
    return us / 1e3 / ctx.reduced.steps if us else None
