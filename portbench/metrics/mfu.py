"""mfu (%): the traced steps' model FLOPs over their time at the cards'
peak: each token's FLOPs as the configuration's architecture counts them
(``roofline.model_flops_per_token``; for the decoders 6 x the matrix
parameters each token uses plus causal attention; recomputation not
counted), over the traced window x the bf16 peak x the cards."""

from portbench import roofline


def read(ctx):
    r = ctx.reduced
    flops = (roofline.model_flops_per_token(ctx.conf, ctx.mix["seq_len"])
             * ctx.tokens_per_step * r.steps)
    peak = roofline.peaks(ctx.device_name)[0] * ctx.chips
    return 100.0 * flops / (r.window_s * peak)
