"""flash_roofline (%): the flash kernels' least time over their device
time.  Each launch the wrappers counted in the traced steps is charged the
least time of its call's work (``roofline.flash_*``: q at the query heads,
k and v at the kv heads, causal, within the layer's window), at the card's
peaks, averaged over the attention layers that the configuration's
architecture lists (``attention_layers``), since every layer launches
alike; the sum is divided by the device time of the flash kernels."""

from collections import Counter

from portbench import archs, roofline

KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def read(ctx):
    dev_us = sum(ctx.reduced.group_us[k] for k in KERNELS)
    if not dev_us or not any(ctx.launches.get(k) for k in KERNELS):
        return None
    layers = archs.of(ctx.conf).attention_layers(ctx.conf)
    b, t = ctx.mix["batch"], ctx.mix["seq_len"]
    peak = roofline.peaks(ctx.device_name)

    def mean_least(kernel):
        count = getattr(roofline, kernel)
        return sum(n / len(layers) * roofline.least_seconds(
            *count(b, t, h, kv, d, window=w), peak)
            for (h, kv, d, w), n in Counter(layers).items())

    least = sum(ctx.launches[k] * mean_least(k) for k in KERNELS)
    return 100.0 * least / (dev_us / 1e6)
