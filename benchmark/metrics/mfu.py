"""mfu.<serve|train>: the model FLOPs of the traced window's forwards
(counted on the plain network; a train step is three forwards) over the
window's seconds at the chip's bf16 peak, in percent."""

from portbench.roofline import PEAK_BF16


def read(ctx, name):
    if ctx.trace is None or ctx.trace.window_s <= 0 or not ctx.model_flops:
        return None
    return 100.0 * ctx.model_flops / (ctx.trace.window_s * PEAK_BF16)
