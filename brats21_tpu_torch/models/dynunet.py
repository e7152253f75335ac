"""DynUNet, the nnU-Net layout of the model zoo (``--model nnunet``).

Port of ``brats21_tpu/models/dynunet.py`` (MONAI DynUNet inside the
reference's WrapperDynUNet, unet_family.py:503-523, configured by
definer.py:61-67): six levels of filters 32·2^i capped at 320, 3³ kernels,
strides (1, 2, 2, 2, 2, 2), leaky-relu, transposed-conv ups, deep
supervision over three heads upsampled (nearest) to full resolution. Every
key sits under the wrapper's ``net.`` prefix with MONAI's names
(``import_torch.py:367-413``): ``input_block``, ``downsamples.{0-3}``,
``bottleneck``, ``upsamples.{j}.{transp_conv,conv_block}``,
``output_block``, ``deep_supervision_heads.{k}``; a block is MONAI's
UnetBasicBlock (``conv1.conv``, ``norm1``, ``conv2.conv``, ``norm2``).

Its stride-1 3³ convs (17 a forward, the 640-channel concatenation of the
deepest decoder included) run the hand-written conv kernel; the five
strided convs ``F.conv3d``. Five stride-2 levels need every spatial size a
multiple of 32, as in the JAX package, whose skip concatenation fails
otherwise: serve it with ``--eval_bucket 32`` (or sliding windows).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .extra import Convolution, norm_or_identity
from .layers import ConvTranspose3d, upsample_nearest


class UnetBasicBlock(nn.Module):
    """Two conv(no bias) → norm → leaky-relu layers, the first optionally
    strided (``dynunet.py:20-49``)."""

    def __init__(self, cin: int, ch: int, stride: int = 1, norm: Optional[str] = "instance"):
        super().__init__()
        self.conv1 = Convolution(cin, ch, stride=stride, bias=False)
        self.norm1 = norm_or_identity(norm, ch)
        self.conv2 = Convolution(ch, ch, bias=False)
        self.norm2 = norm_or_identity(norm, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.norm1(self.conv1(x)), 0.01)
        return F.leaky_relu(self.norm2(self.conv2(x)), 0.01)


class _TranspConv(nn.Module):
    """MONAI's conv-only transposed Convolution (child ``conv``), 2³/s2,
    no bias."""

    def __init__(self, cin: int, ch: int):
        super().__init__()
        self.conv = ConvTranspose3d(cin, ch, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UnetUpBlock(nn.Module):
    def __init__(self, cin: int, ch: int, norm: Optional[str]):
        super().__init__()
        self.transp_conv = _TranspConv(cin, ch)
        self.conv_block = UnetBasicBlock(2 * ch, ch, 1, norm)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=1))


class UnetOutBlock(nn.Module):
    def __init__(self, cin: int, num_classes: int):
        super().__init__()
        self.conv = Convolution(cin, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class _DynUNetNet(nn.Module):
    def __init__(self, num_classes: int, norm: Optional[str], deep_supr_num: int,
                 levels: int, in_channels: int):
        super().__init__()
        filters = [min(32 * 2 ** i, 320) for i in range(levels)]
        self.levels, self.deep_supr_num = levels, deep_supr_num
        self.input_block = UnetBasicBlock(in_channels, filters[0], 1, norm)
        self.downsamples = nn.ModuleList(
            [UnetBasicBlock(filters[i - 1], filters[i], 2, norm) for i in range(1, levels - 1)])
        self.bottleneck = UnetBasicBlock(filters[-2], filters[-1], 2, norm)
        self.upsamples = nn.ModuleList(
            [UnetUpBlock(filters[i + 1], filters[i], norm) for i in range(levels - 2, -1, -1)])
        self.output_block = UnetOutBlock(filters[0], num_classes)
        self.deep_supervision_heads = nn.ModuleList(
            [UnetOutBlock(filters[j], num_classes) for j in range(1, 1 + deep_supr_num)])


class DynUNet(nn.Module):
    """The reference's WrapperDynUNet around MONAI DynUNet
    (``dynunet.py:52-93``). ``forward(x)`` returns ``(main, [deep1, deep2,
    deep3])``, the deep heads nearest-upsampled ×2, ×4, ×8;
    ``forward(x, with_deep=False)`` returns ``(main, [])``. Z-sharded, the
    slabs are cut at multiples of 32, its five stride-2 levels."""

    spatial_factor = 32

    def __init__(self, num_classes: int = 3, norm: Optional[str] = "instance",
                 deep_supr_num: int = 3, levels: int = 6, in_channels: int = 4):
        super().__init__()
        self.net = _DynUNetNet(num_classes, norm, deep_supr_num, levels, in_channels)

    def forward(self, x: torch.Tensor,
                with_deep: bool = True) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        net = self.net
        step = 2 ** (net.levels - 1)
        if any(s % step for s in x.shape[2:]):
            raise ValueError(f"nnunet needs every spatial size a multiple of {step} (its "
                             f"{net.levels - 1} stride-2 levels), got {tuple(x.shape[2:])}: "
                             f"serve it with --eval_bucket {step} or sliding windows")
        y = net.input_block(x)
        skips = [y]
        for down in net.downsamples:
            y = down(y)
            skips.append(y)
        y = net.bottleneck(y)
        feats = []
        for j, i in enumerate(range(net.levels - 2, -1, -1)):
            y = net.upsamples[j](y, skips[i])
            feats.append((i, y))
        main = net.output_block(feats[-1][1])
        if not with_deep:
            return main, []
        deeps = []
        for j in range(2, 2 + net.deep_supr_num):
            level, feat = feats[-j]
            deeps.append(upsample_nearest(net.deep_supervision_heads[j - 2](feat), 2 ** level))
        return main, deeps
