"""The chip's peaks and the work of the kernels' calls, copied from
``chip_smoke.py`` (``PEAK_BF16``, ``PEAK_FP32``, ``PEAK_BYTES``,
``EVONORM_OPS``, ``bound`` and the operation and byte counts of
``check_conv`` and ``check_evonorm``) so that later changes to that script
do not move the yardstick.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense, at its 700 W
limit; a card set to a lower power limit reaches less, so every run prints
the limit beside them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

PEAK_BF16 = 989e12          # bf16 tensor cores, FLOP/s
PEAK_FP32 = 67e12           # fp32 CUDA cores, FLOP/s
PEAK_BYTES = 3.35e12        # HBM3, bytes/s
# EvoNorm operations per element: x − mean, square, two adds (statistics);
# exp, add, reciprocal (sigmoid), three multiplies and an add (output)
EVONORM_OPS = 11


def bound(ops: float, peak_ops: float, nbytes: float) -> Tuple[float, str]:
    """(the least seconds, what bounds them) of work of ``ops`` operations at
    ``peak_ops`` and ``nbytes`` bytes at the memory peak."""
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def conv3x3x3_work(shape: Sequence[int], itemsize: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of a stride-1 SAME 3×3×3 convolution of input
    ``[B, D, H, W, C_in]`` to ``C_out`` channels, ``shape`` =
    (B, D, H, W, C_in, C_out): each input, weight and output element moved
    once, an fp32 bias."""
    b, d, h, w, cin, cout = shape
    m = b * d * h * w
    return 2.0 * m * cout * 27 * cin, itemsize * (m * cin + m * cout + 27 * cin * cout) + 4.0 * cout


def evonorm_s0_work(shape: Sequence[int], itemsize: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of EvoNorm-S0 on ``[B, D, H, W, C]``: the input
    read once, the output written once, fp32 γ and β."""
    b, d, h, w, c = shape
    m = b * d * h * w
    return EVONORM_OPS * m * c, 2.0 * itemsize * m * c + 8.0 * c
