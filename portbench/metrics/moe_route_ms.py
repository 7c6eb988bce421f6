"""moe_route_ms (ms): device ms a step of the kernels that the port's
``kctpu.moe.route``, ``kctpu.moe.dispatch`` and ``kctpu.moe.combine``
spans own, in every pass: the router's product and scores, the biased
top-k, its counts and the bias update, the share's grouped layout, the
row dispatch and the weighted combine (``portbench/spans.py``); None where
the traced run has no spans or the spans launched nothing."""


def read(ctx):
    return None if ctx.spans is None else ctx.spans.metric("moe_route_ms")
