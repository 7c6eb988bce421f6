"""gmm_roofline (%): the grouped-matmul kernels' least time over their
device time.  Each ``gmm``, ``gmm_swiglu`` and ``tgmm`` launch the
wrappers counted in the traced steps is charged the least time of its
call's work at the expert layer's shapes (``roofline.gmm*``: the routed
rows batch x T x top-k without padding, the model and expert widths, the
experts touched, as the configuration's architecture gives them in
``expert_ffn``), at the card's peaks; the sum is divided by the device
time of the grouped kernels."""

from portbench import archs, roofline

KERNELS = ("gmm", "gmm_swiglu", "tgmm")


def read(ctx):
    dev_us = sum(ctx.reduced.group_us[k] for k in KERNELS)
    if not dev_us or not any(ctx.launches.get(k) for k in KERNELS):
        return None
    ffn = archs.of(ctx.conf).expert_ffn(ctx.conf)
    if ffn is None:
        return None
    experts, top_k, d, f = ffn
    rows = ctx.mix["batch"] * ctx.mix["seq_len"] * top_k
    shape = (rows, d, f, roofline.experts_touched(rows, experts))
    peak = roofline.peaks(ctx.device_name)
    least = sum(ctx.launches[k] * roofline.least_seconds(
        *getattr(roofline, k)(*shape), peak) for k in KERNELS)
    return 100.0 * least / (dev_us / 1e6)
