"""conv3x3x3_roofline.<serve|train>: the hand-written stride-1 3×3×3
convolution (``ops/kernels/conv3d.py``, ``csrc/conv3x3x3.cu``) against its
roofline, over the traced window's forwards."""

from portbench.kernelshare import roofline_share
from portbench.roofline import PEAK_BF16, PEAK_FP32, conv3x3x3_work
from reference import nets

#: the device kernels of csrc/conv3x3x3.cu
KERNELS = ("conv3x3x3_bf16_wgmma", "conv3x3x3_splitk_reduce", "conv3x3x3_f32_fma")


def select(m) -> bool:
    return (isinstance(m, nets.Conv) and m.kernel_size == (3, 3, 3) and m.stride == (1, 1, 1)
            and m.dilation == (1, 1, 1) and m.padding == (1, 1, 1) and m.groups == 1)


def work(inp, out, config):
    bf16 = config["precision"]["activations"] == "bfloat16"
    b, cin, d, h, w = inp
    ops, nbytes = conv3x3x3_work((b, d, h, w, cin, out[1]), 2 if bf16 else 4)
    return ops, PEAK_BF16 if bf16 else PEAK_FP32, nbytes


def read(ctx, name):
    return roofline_share(ctx, KERNELS, "conv3d", select, work)
