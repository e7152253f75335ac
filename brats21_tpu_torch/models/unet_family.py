"""The generic 3D U-Net family (reference networks/unet_family.py, after
LeeJunHyun): UnetFamily (``modified_unet``), R2Unet, AttUnet and R2AttUnet.

Port of ``brats21_tpu/models/unet_family.py``. Attribute names and the
Sequential indices are the reference's, so ``state_dict()`` keys equal a
published ``best_model.pth``'s (reconstructed in
``brats21_tpu/utils/import_torch.py:222-278``): ``ConvBlock.conv`` is
[conv, norm, act, conv, norm, act] (without a norm [conv, act, conv,
act]), ``UpConv.up`` is [Upsample, conv, norm, act], a RecurrentBlock's
``conv`` is [conv, norm, act], the recurrent models name their blocks
``RRCNNn``/``Up_RRCNNn``, and the attention gates are Sequential(conv1x1,
BatchNorm3d) whatever the model's norm. Upsampling is nearest, torch
``nn.Upsample``'s default. The convs keep their bias even before a norm.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from .layers import (Act, BatchNorm, Conv3d, UpsampleNearest, get_norm_layer,
                     kaiming_normal_fan_out, max_pool3d, upsample_nearest)


def _conv(cin: int, cout: int, k: int = 3) -> Conv3d:
    return Conv3d(cin, cout, k, kernel_init=kaiming_normal_fan_out)


def _conv_norm_act(cin: int, cout: int, norm: Optional[str], act: str) -> List[nn.Module]:
    norm_ctor = get_norm_layer(norm)
    return [_conv(cin, cout)] + ([norm_ctor(cout)] if norm_ctor else []) + [Act(act)]


class ConvBlock(nn.Module):
    """(conv3 → norm → act) ×2 (unet_family.py:13-35)."""

    def __init__(self, ch_in: int, ch_out: int, norm: Optional[str] = "group",
                 act: str = "relu"):
        super().__init__()
        self.conv = nn.Sequential(*_conv_norm_act(ch_in, ch_out, norm, act),
                                  *_conv_norm_act(ch_out, ch_out, norm, act))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UpConv(nn.Module):
    """nearest ×2 upsample → conv3 → norm → act (unet_family.py:38-57)."""

    def __init__(self, ch_in: int, ch_out: int, norm: Optional[str] = "group",
                 act: str = "relu"):
        super().__init__()
        self.up = nn.Sequential(UpsampleNearest(2),
                                *_conv_norm_act(ch_in, ch_out, norm, act))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up(x)


class RecurrentBlock(nn.Module):
    """t-step recurrent conv (unet_family.py:60-86): ``x1 = conv(x)``, then
    ``x1 = conv(x + x1)`` t times with the same weights, so one 3³ conv runs
    1 + t times a forward and its gradients add up over them."""

    def __init__(self, ch_out: int, norm: Optional[str] = "group", act: str = "relu",
                 t: int = 2):
        super().__init__()
        self.t = t
        self.conv = nn.Sequential(*_conv_norm_act(ch_out, ch_out, norm, act))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv(x)
        for _ in range(self.t):
            x1 = self.conv(x + x1)
        return x1


class RRCNNBlock(nn.Module):
    """1×1 conv → two recurrent blocks → residual (unet_family.py:89-101)."""

    def __init__(self, ch_in: int, ch_out: int, norm: Optional[str] = "group",
                 act: str = "relu", t: int = 2):
        super().__init__()
        self.RCNN = nn.Sequential(RecurrentBlock(ch_out, norm, act, t),
                                  RecurrentBlock(ch_out, norm, act, t))
        self.Conv_1x1 = _conv(ch_in, ch_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_1x1(x)
        return x + self.RCNN(x)


class AttentionBlock(nn.Module):
    """Additive attention gate (unet_family.py:104-131). Its BatchNorms are
    ``frozen``: the JAX package always calls the gate with
    ``use_running_average=True`` (``unet_family.py:107-124``, called
    without ``train``), so in training too they normalise by, and never
    move, their running statistics; the reference trains them in batch
    mode. As in the JAX package, each BatchNorm returns fp32, so
    ``x · psi`` and what follows run in fp32."""

    def __init__(self, f_g: int, f_l: int, f_int: int, act: str = "relu"):
        super().__init__()
        self.W_g = nn.Sequential(_conv(f_g, f_int, 1), BatchNorm(f_int, frozen=True))
        self.W_x = nn.Sequential(_conv(f_l, f_int, 1), BatchNorm(f_int, frozen=True))
        self.psi = nn.Sequential(_conv(f_int, 1, 1), BatchNorm(1, frozen=True), nn.Sigmoid())
        self.act = Act(act)

    def forward(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        psi = self.act(self.W_g(g) + self.W_x(x))
        return x * self.psi(psi)


class UnetFamily(nn.Module):
    """The family's skeleton (unet_family.py:134-217; ``modified_unet``):
    four encoder blocks on max-pool downsampling, three up-convs each
    followed by a decoder block on the skip's concatenation (behind an
    attention gate in the attention models), a 1×1 head and three deep
    heads, nearest-upsampled: ``(d1, [h2, h3, h4])``.
    ``forward(x, with_deep=False)`` skips the deep heads."""

    attention = False
    recurrent = False
    #: Z-sharded, the slabs are cut at multiples of its three pools' 8
    spatial_factor = 8

    def __init__(self, features: Sequence[int], num_classes: int = 3,
                 norm: Optional[str] = "group", act: str = "relu",
                 deep_supervision: bool = True, t: int = 2, in_channels: int = 4):
        super().__init__()
        f = list(features)
        self.deep_supervision = deep_supervision
        if self.recurrent:
            def block(cin, cout):
                return RRCNNBlock(cin, cout, norm, act, t)
            enc, dec = "RRCNN{}", "Up_RRCNN{}"
        else:
            def block(cin, cout):
                return ConvBlock(cin, cout, norm, act)
            enc, dec = "Conv{}", "Up_conv{}"
        self.enc_names = [enc.format(i) for i in range(1, 5)]
        self.dec_names = [dec.format(i) for i in (4, 3, 2)]
        for name, cin, cout in zip(self.enc_names, [in_channels] + f[:3], f):
            setattr(self, name, block(cin, cout))
        for i, name, cin, cout in zip((4, 3, 2), self.dec_names, f[3:0:-1], f[2::-1]):
            setattr(self, f"Up{i}", UpConv(cin, cout, norm, act))
            setattr(self, name, block(2 * cout, cout))
        if self.attention:
            self.Att4 = AttentionBlock(f[2], f[2], f[1], act)
            self.Att3 = AttentionBlock(f[1], f[1], f[0], act)
            self.Att2 = AttentionBlock(f[0], f[0], max(f[0] // 2, 1), act)
        self.Conv_1x1 = _conv(f[0], num_classes, 1)
        if deep_supervision:
            self.outconv4 = _conv(f[3], num_classes, 1)
            self.outconv3 = _conv(f[2], num_classes, 1)
            self.outconv2 = _conv(f[1], num_classes, 1)

    def forward(self, x: torch.Tensor, with_deep: bool = True):
        e1, e2, e3, e4 = (getattr(self, n) for n in self.enc_names)
        x1 = e1(x)
        x2 = e2(max_pool3d(x1))
        x3 = e3(max_pool3d(x2))
        x4 = e4(max_pool3d(x3))
        ups = []
        d = x4
        for i, name, skip in zip((4, 3, 2), self.dec_names, (x3, x2, x1)):
            up = getattr(self, f"Up{i}")(d)
            if self.attention:
                skip = getattr(self, f"Att{i}")(up, skip)
            d = getattr(self, name)(torch.cat([skip, up], dim=1))
            ups.append(d)
        d1 = self.Conv_1x1(d)
        if not self.deep_supervision:
            return d1
        if not with_deep:
            return d1, []
        d4_up, d3_up = ups[0], ups[1]
        return d1, [upsample_nearest(self.outconv2(d3_up), 2),
                    upsample_nearest(self.outconv3(d4_up), 4),
                    upsample_nearest(self.outconv4(x4), 8)]


class R2Unet(UnetFamily):
    """Recurrent-residual U-Net (unet_family.py:220-308)."""
    recurrent = True


class AttUnet(UnetFamily):
    """Attention U-Net (unet_family.py:311-402)."""
    attention = True


class R2AttUnet(UnetFamily):
    """Recurrent-residual attention U-Net (unet_family.py:405-500)."""
    attention = True
    recurrent = True
