"""peak_mem_gb (GB): ``torch.cuda.max_memory_allocated`` of the process,
read after the traced steps, in 1e9 bytes."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes else None
