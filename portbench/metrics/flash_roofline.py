"""flash_roofline (%): the flash kernels' least time over their device
time.  Each launch the wrappers counted in the traced steps is charged the
least time of its call's work at the layer's shapes (``roofline.flash_*``:
q at the query heads, k and v at the kv heads, causal), at the card's
peaks; the sum is divided by the device time of the flash kernels."""

from portbench import roofline

KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def read(ctx):
    dev_us = sum(ctx.reduced.group_us[k] for k in KERNELS)
    if not dev_us or not any(ctx.launches.get(k) for k in KERNELS):
        return None
    c = ctx.conf
    h = c["num_attention_heads"]
    shape = (ctx.mix["batch"], ctx.mix["seq_len"], h,
             c["num_key_value_heads"], c.get("head_dim")
             or c["hidden_size"] // h)
    peak = roofline.peaks(ctx.device_name)
    least = sum(ctx.launches[k] * roofline.least_seconds(
        *getattr(roofline, k)(*shape), peak) for k in KERNELS)
    return 100.0 * least / (dev_us / 1e6)
