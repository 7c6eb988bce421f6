"""idle_share (%): the share of the traced window in which no operation
ran on the device."""


def read(ctx):
    r = ctx.reduced
    return 100.0 * (1.0 - r.busy_s / r.window_s)
