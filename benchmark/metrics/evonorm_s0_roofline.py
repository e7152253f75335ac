"""evonorm_s0_roofline.<serve|train>: the hand-written EvoNorm-S0
(``ops/kernels/evonorm.py``, ``csrc/evonorm_s0.cu``) against its roofline
(fp32 arithmetic, activations read and written once), over the traced
window's forwards."""

from portbench.kernelshare import roofline_share
from portbench.roofline import PEAK_FP32, evonorm_s0_work
from reference import nets

#: the device kernels of csrc/evonorm_s0.cu
KERNELS = ("evonorm_stats", "evonorm_apply")


def select(m) -> bool:
    return isinstance(m, nets.EvoNormS0)


def work(inp, out, config):
    b, c, d, h, w = inp
    itemsize = 2 if config["precision"]["activations"] == "bfloat16" else 4
    ops, nbytes = evonorm_s0_work((b, d, h, w, c), itemsize)
    return ops, PEAK_FP32, nbytes


def read(ctx, name):
    return roofline_share(ctx, KERNELS, "evonorm", select, work)
