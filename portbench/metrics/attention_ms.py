"""attention_ms (ms): device ms a step of the kernels that the port's
``kctpu.attention`` span owns, in every pass (forward, remat re-run,
backward): windowed and global flash, the GQA repeats and, in the "afmoe"
block, the output gate's sigmoid-multiply (``portbench/spans.py``); None
where the traced run has no spans or the span launched nothing."""


def read(ctx):
    return None if ctx.spans is None else ctx.spans.metric("attention_ms")
