"""Core 3D layers of the served model: NCDHW modules whose activations live
in ``torch.channels_last_3d`` memory (physically the JAX package's
``[B, D, H, W, C]``).

Precision follows the JAX package's explicit casts rather than autocast:
parameters stay fp32 and each layer casts its weights to the activation
dtype (``brats21_tpu/models/layers.py:266,269``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.conv3d import conv3x3x3

def to_kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """NCDHW → the kernels' contiguous ``[B, D, H, W, C]``; free for a
    channels_last_3d tensor, a copy otherwise."""
    y = x.permute(0, 2, 3, 4, 1)
    return y if y.is_contiguous() else y.contiguous()


def from_kernel_layout(y: torch.Tensor) -> torch.Tensor:
    """``[B, D, H, W, C]`` → an NCDHW view in channels_last_3d memory."""
    return y.permute(0, 4, 1, 2, 3)


class Conv3d(nn.Conv3d):
    """3D convolution with torch-style symmetric padding d·(k−1)/2
    (``layers.py:279-305``); ``weight``/``bias`` keep nn.Conv3d's names and
    init, so reference checkpoints load as they are.

    Stride 1, one group and a bias, as every conv of the served model. The
    case the JAX package hands to its Pallas kernel (k=3, dilation 1, hence
    pad 1; ``layers.py:258-261``) goes to the hand-written
    :func:`conv3x3x3`; every other conv is ``F.conv3d``, as the JAX package
    leaves those to XLA."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 dilation: int = 1):
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=dilation * (kernel_size - 1) // 2,
                         dilation=dilation)

    @property
    def uses_kernel(self) -> bool:
        return self.kernel_size == (3, 3, 3) and self.dilation == (1, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        if self.uses_kernel:
            y = conv3x3x3(to_kernel_layout(x), w.permute(2, 3, 4, 1, 0).contiguous(),
                          self.bias.float())
            return from_kernel_layout(y)
        return F.conv3d(x, w, self.bias.to(x.dtype), padding=self.padding,
                        dilation=self.dilation)


def max_avg_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """MONAI MaxAvgPool: concat(maxpool, avgpool) on channels — the
    channel-doubling downsample of EquiUnetASSPEvo (equiunet2021.py:261)."""
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        # PyTorch's CPU avg_pool3d has no bf16 kernel: pool in fp32, as the
        # CUDA kernel accumulates anyway, and round once
        avg = F.avg_pool3d(x.float(), window).to(x.dtype)
    else:
        avg = F.avg_pool3d(x, window)
    return torch.cat([F.max_pool3d(x, window), avg], dim=1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[B, C, D, H, W] → [B, C]."""
    return x.mean(dim=(2, 3, 4))


def upsample(x: torch.Tensor, scale_factor: int = 2) -> torch.Tensor:
    """Trilinear ×scale with ``align_corners=True`` (torch nn.Upsample
    semantics, equiunet2020.py:351,439)."""
    return F.interpolate(x, scale_factor=scale_factor, mode="trilinear",
                         align_corners=True)


class Dropout(nn.Module):
    """Element-wise dropout that is a no-op at rate 0 and in eval mode."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        return F.dropout(x, self.rate, training=True)
