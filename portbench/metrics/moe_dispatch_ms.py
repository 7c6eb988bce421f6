"""moe_dispatch_ms (ms): device ms a step in gather, scatter, index and
sort kernels outside the optimizer, in a step that runs the grouped
expert kernels: the MoE's routing, dispatch and combine (with the
embedding's and the loss's own gathers, a small part)."""


def read(ctx):
    if not ctx.launches.get("gmm_swiglu"):
        return None
    us = ctx.reduced.group_us["index"]
    return us / 1e3 / ctx.reduced.steps if us else None
