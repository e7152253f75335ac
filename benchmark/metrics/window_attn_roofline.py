"""window_attn_roofline.<serve_sw>: B4, the hand-written shifted-window
attention (``ops/kernels/window_attn.py``, ``csrc/window_attn.cu``), against
its roofline over the traced window's forwards.

The work is counted on the reference's attention core
(``reference/swin_unetr.py`` ``AttentionCore``) at the forward's shape on
the meta device: per call of ``[B·windows, heads, n, d]`` the products'
``4·n²·d`` FLOPs a window and head at the bf16 peak, the softmax's ``n²``
exponentials at the H100 SXM's special-function rate (3.9e12/s, as
FlashAttention-3, Shah et al. 2024, gives it), and q, k, v and the output
moved once in bf16; a call's least time is the largest of the three. The
window's launches of ``window_attn`` must equal the forwards times the
calls, else the share is not read. ``kernelshare.roofline_share`` takes two
terms, so this reader sums its own."""

from portbench.model import module_calls
from portbench.roofline import PEAK_BF16, PEAK_BYTES
from reference import swin_unetr

#: the device kernel of csrc/window_attn.cu
KERNELS = ("window_attn_kernel",)
#: exponentials a second of one H100 SXM (16 an SM a clock, 132 SMs, 1.83 GHz)
PEAK_EXP = 3.9e12


def select(m) -> bool:
    return isinstance(m, swin_unetr.AttentionCore)


def work(inp):
    """(exponentials, FLOPs, bytes) of one call on q ``[B·windows, heads, n, d]``."""
    bw, heads, n, d = inp
    pairs = bw * heads * n * n
    return float(pairs), 4.0 * pairs * d, 2.0 * 4 * bw * heads * n * d


def least_seconds(calls) -> float:
    total = 0.0
    for _, inp, _ in calls:
        exps, flops, nbytes = work(inp)
        total += max(exps / PEAK_EXP, flops / PEAK_BF16, nbytes / PEAK_BYTES)
    return total


def read(ctx, name):
    if ctx.trace is None:
        return None
    calls = module_calls(ctx.network, ctx.forward_shape, ctx.with_deep, select)
    if not calls:
        return None
    launches = ctx.launches.get("window_attn", 0)
    if launches != ctx.forwards * len(calls):
        ctx.run.note(f"window_attn: {launches} launches against {ctx.forwards} forwards x "
                     f"{len(calls)} calls: the share is not read")
        return None
    seconds = ctx.trace.kernel_seconds(lambda n: any(k in n for k in KERNELS))
    if seconds <= 0:
        return None
    least = least_seconds(calls)
    ctx.run.note(f"window_attn: {launches} launches, {seconds:.6f} s on the card, "
                 f"{1e3 * seconds / ctx.forwards:.4f} ms a forward against a bound of "
                 f"{1e3 * least:.4f}")
    return 100.0 * ctx.forwards * least / seconds
