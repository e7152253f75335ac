"""The BraTS-2020 line of 3D U-Nets: Unet, EquiUnet (Model 1, "U-Net V1"),
AttEquiUnet, their CBAM gates, the RefUnet refinement net and the
deep-supervision head.

Port of ``brats21_tpu/models/equiunet.py`` (reference
networks/equiunet2020.py, cited per class). Attribute names are the
reference's, so ``state_dict()`` keys equal a published ``best_model.pth``'s
(reconstructed in ``brats21_tpu/utils/import_torch.py:112-133,186-214``):
``encoderN.ConvBnRelu{1,2}.{conv,bn}``, ``bottom_2.{conv,bn}`` (AttEquiUnet:
``bottom_2.0``/``bottom_2.1``), ``…CBAM.ChannelGate.mlp.{1,3}``,
``…CBAM.SpatialGate.spatial.{conv,bn}``, ``outconv``, ``deep_*.0`` and
``refunet.{conv0,hx1-5,d4-1,conv_d0}``. Every 3×3×3 conv with stride 1
and dilation 1 runs the hand-written conv kernel (:class:`Conv3d`); the
dilated ``bottom`` convs, the 7³ spatial gates and the 1×1 heads run
``F.conv3d``. The JAX package's ``remat`` flag (a TPU memory device) has no
counterpart.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (Conv3d, Dropout, Upsample, get_act, get_norm_layer, global_avg_pool,
                     global_max_pool, kaiming_normal_fan_out, max_pool3d,
                     resize_trilinear, upsample)

ModelOutput = Union[torch.Tensor, list, Tuple[Union[torch.Tensor, list], List[torch.Tensor]]]


class ConvBnRelu(nn.Module):
    """conv3x3 → norm → act → dropout (equiunet2020.py:51-75); without a
    norm the conv keeps its bias (:70)."""

    def __init__(self, in_channels: int, features: int, act: str = "relu",
                 norm: Optional[str] = "group", dilation: int = 1, dropout: float = 0.0):
        super().__init__()
        norm_ctor = get_norm_layer(norm)
        self.conv = Conv3d(in_channels, features, 3, dilation=dilation,
                           use_bias=norm_ctor is None, kernel_init=kaiming_normal_fan_out)
        self.bn = norm_ctor(features) if norm_ctor is not None else None
        self.act = get_act(act)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return self.dropout(self.act(x))


class UBlock(nn.Module):
    """Two stacked ConvBnRelu (equiunet2020.py:105-123)."""

    def __init__(self, in_channels: int, midplanes: int, outplanes: int,
                 act: str = "relu", norm: Optional[str] = "group",
                 dilation: Tuple[int, int] = (1, 1), dropout: float = 0.0):
        super().__init__()
        self.ConvBnRelu1 = ConvBnRelu(in_channels, midplanes, act, norm, dilation[0], dropout)
        self.ConvBnRelu2 = ConvBnRelu(midplanes, outplanes, act, norm, dilation[1], dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvBnRelu2(self.ConvBnRelu1(x))


class ChannelGate(nn.Module):
    """CBAM channel attention (equiunet2020.py:171-201): one MLP on the
    global average- and max-pooled features, summed, sigmoid gate. The
    reference's ``mlp`` is Sequential(Flatten, Linear, ReLU, Linear), keys
    ``mlp.1``/``mlp.3``; the hidden width is ``max(C // 16, 1)``."""

    def __init__(self, channels: int, reduction_ratio: int = 16):
        super().__init__()
        hidden = max(channels // reduction_ratio, 1)
        self.mlp = nn.Sequential(nn.Flatten(), nn.Linear(channels, hidden), nn.ReLU(),
                                 nn.Linear(hidden, channels))
        for lin in (self.mlp[1], self.mlp[3]):
            kaiming_normal_fan_out(lin.weight.data)
            nn.init.zeros_(lin.bias)

    def _mlp(self, v: torch.Tensor) -> torch.Tensor:
        fc1, fc2 = self.mlp[1], self.mlp[3]
        h = F.relu(F.linear(v, fc1.weight.to(v.dtype), fc1.bias.to(v.dtype)))
        return F.linear(h, fc2.weight.to(v.dtype), fc2.bias.to(v.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        att = self._mlp(global_avg_pool(x)) + self._mlp(global_max_pool(x))
        return x * torch.sigmoid(att)[:, :, None, None, None]


class BasicConv(nn.Module):
    """The spatial gate's 7³ conv (no bias) and its norm over one channel
    (equiunet2020.py:147-162): GroupNorm there has ``min(8, 1)`` = one
    group."""

    def __init__(self, norm: Optional[str] = "group"):
        super().__init__()
        self.conv = Conv3d(2, 1, 7, use_bias=False, kernel_init=kaiming_normal_fan_out)
        norm_ctor = get_norm_layer(norm)
        self.bn = norm_ctor(1) if norm_ctor is not None else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if self.bn is not None:
            y = self.bn(y)
        return F.relu(y)


class SpatialGate(nn.Module):
    """CBAM spatial attention (equiunet2020.py:210-221): the channel max
    and mean → 7³ conv → norm → relu → sigmoid gate."""

    def __init__(self, norm: Optional[str] = "group"):
        super().__init__()
        self.spatial = BasicConv(norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        compress = torch.cat([x.amax(dim=1, keepdim=True), x.mean(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.spatial(compress))


class CBAM(nn.Module):
    """Channel then spatial gates (equiunet2020.py:224-235)."""

    def __init__(self, channels: int, reduction_ratio: int = 16,
                 norm: Optional[str] = "group"):
        super().__init__()
        self.ChannelGate = ChannelGate(channels, reduction_ratio)
        self.SpatialGate = SpatialGate(norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.SpatialGate(self.ChannelGate(x))


class UBlockCbam(nn.Module):
    """UBlock followed by CBAM (equiunet2020.py:238-249)."""

    def __init__(self, in_channels: int, midplanes: int, outplanes: int,
                 act: str = "relu", norm: Optional[str] = "group",
                 dilation: Tuple[int, int] = (1, 1), dropout: float = 0.0):
        super().__init__()
        self.UBlock = UBlock(in_channels, midplanes, outplanes, act, norm, dilation, dropout)
        self.CBAM = CBAM(outplanes, norm=norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.CBAM(self.UBlock(x))


class RefUnet(nn.Module):
    """Refinement U-Net adding a residual correction to the logits
    (equiunet2020.py:252-309): four ceil-mode max-pool encoders, decoders
    on trilinear resizes to each skip's exact shape (``_up_match``,
    ``equiunet.py:179``)."""

    def __init__(self, in_ch: int, inc_ch: int, act: str = "relu",
                 norm: Optional[str] = "group", dropout: float = 0.0):
        super().__init__()
        self.conv0 = Conv3d(in_ch, inc_ch, 3, kernel_init=kaiming_normal_fan_out)
        for name in ("hx1", "hx2", "hx3", "hx4", "hx5"):
            setattr(self, name, ConvBnRelu(inc_ch, inc_ch, act, norm, 1, dropout))
        for name in ("d4", "d3", "d2", "d1"):
            setattr(self, name, ConvBnRelu(2 * inc_ch, inc_ch, act, norm, 1, dropout))
        self.conv_d0 = Conv3d(inc_ch, in_ch, 3, kernel_init=kaiming_normal_fan_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hx1 = self.hx1(self.conv0(x))
        hx2 = self.hx2(max_pool3d(hx1, ceil_mode=True))
        hx3 = self.hx3(max_pool3d(hx2, ceil_mode=True))
        hx4 = self.hx4(max_pool3d(hx3, ceil_mode=True))
        hx5 = self.hx5(max_pool3d(hx4, ceil_mode=True))
        d4 = self.d4(torch.cat([_up_match(hx5, hx4), hx4], dim=1))
        d3 = self.d3(torch.cat([_up_match(d4, hx3), hx3], dim=1))
        d2 = self.d2(torch.cat([_up_match(d3, hx2), hx2], dim=1))
        d1 = self.d1(torch.cat([_up_match(d2, hx1), hx1], dim=1))
        return x + self.conv_d0(d1)


def _up_match(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """×2 trilinear (align_corners) resize to ``ref``'s spatial shape
    (ceil-mode pooling can overshoot an odd size by one)."""
    return resize_trilinear(x, ref.shape[2:])


class DeepHead(nn.Sequential):
    """conv1x1 → ×scale trilinear upsample (align_corners, torch
    nn.Upsample's in equiunet2020.py:443-458); the reference's Sequential
    puts the conv at key ``.0``."""

    def __init__(self, in_channels: int, num_classes: int, scale: int,
                 kernel_init=None):
        super().__init__(
            Conv3d(in_channels, num_classes, 1, kernel_init=kernel_init),
            Upsample(scale, align_corners=True))


class _Unet2020(nn.Module):
    """The skeleton shared by Unet, EquiUnet and AttEquiUnet
    (equiunet2020.py:312-561): four encoders with max-pool downsampling,
    a dilated ``bottom`` and the ``bottom_2`` bridge, three decoders on
    trilinear ×2 upsampling, a 1×1 ``outconv`` and, with deep supervision,
    four heads (``deep_bottom``, ``deep_bottom2``, ``deep3``, ``deep2``).

    ``forward(x)`` returns ``(logits, [4 deep heads])`` with deep
    supervision on (``([refined, logits], deeps)`` with the refinement);
    ``forward(x, with_deep=False)`` skips the deep heads for callers that
    read the main head only."""

    def _heads(self, f: List[int], out_width: int, num_classes: int,
               deep_supervision: bool) -> None:
        self.deep_supervision = deep_supervision
        self.refunet: Optional[RefUnet] = None
        self.outconv = Conv3d(out_width, num_classes, 1, kernel_init=kaiming_normal_fan_out)
        if deep_supervision:
            self.deep_bottom = DeepHead(f[3], num_classes, 8, kaiming_normal_fan_out)
            self.deep_bottom2 = DeepHead(f[2], num_classes, 8, kaiming_normal_fan_out)
            self.deep3 = DeepHead(f[1], num_classes, 4, kaiming_normal_fan_out)
            self.deep2 = DeepHead(f[0], num_classes, 2, kaiming_normal_fan_out)

    def forward(self, x: torch.Tensor, with_deep: bool = True) -> ModelOutput:
        down1 = self.encoder1(x)
        down2 = self.encoder2(max_pool3d(down1))
        down3 = self.encoder3(max_pool3d(down2))
        down4 = self.encoder4(max_pool3d(down3))
        bottom = self.bottom(down4)
        bottom_2 = self.bottom_2(torch.cat([down4, bottom], dim=1))
        up3 = self.decoder3(torch.cat([down3, upsample(bottom_2)], dim=1))
        up2 = self.decoder2(torch.cat([down2, upsample(up3)], dim=1))
        up1 = self.decoder1(torch.cat([down1, upsample(up2)], dim=1))
        out = self.outconv(up1)
        if self.refunet is not None:
            out = [self.refunet(out), out]
        if not self.deep_supervision:
            return out
        deeps = [self.deep_bottom(bottom), self.deep_bottom2(bottom_2),
                 self.deep3(up3), self.deep2(up2)] if with_deep else []
        return out, deeps


class Unet(_Unet2020):
    """"Almost the most basic U-net" (equiunet2020.py:312-405): encoders
    with halved mid-widths, decoders narrowing to ``f[0] // 2``."""

    def __init__(self, features: Sequence[int], num_classes: int = 3, act: str = "relu",
                 norm: Optional[str] = "group", deep_supervision: bool = False,
                 dropout: float = 0.0, in_channels: int = 4):
        f = list(features)
        super().__init__()
        kw = dict(act=act, norm=norm, dropout=dropout)
        self.encoder1 = UBlock(in_channels, f[0] // 2, f[0], **kw)
        self.encoder2 = UBlock(f[0], f[1] // 2, f[1], **kw)
        self.encoder3 = UBlock(f[1], f[2] // 2, f[2], **kw)
        self.encoder4 = UBlock(f[2], f[3] // 2, f[3], **kw)
        self.bottom = UBlock(f[3], f[3], f[3], dilation=(2, 2), **kw)
        self.bottom_2 = ConvBnRelu(2 * f[3], f[2], act, norm, dropout=dropout)
        self.decoder3 = UBlock(2 * f[2], f[2], f[1], **kw)
        self.decoder2 = UBlock(2 * f[1], f[1], f[0], **kw)
        self.decoder1 = UBlock(2 * f[0], f[0], f[0] // 2, **kw)
        self._heads(f, f[0] // 2, num_classes, deep_supervision)

class EquiUnet(_Unet2020):
    """EquiUnet, equal widths per level (equiunet2020.py:408-500): Model 1,
    "U-Net V1" of README.md:103. ``refinement`` adds a RefUnet on the
    logits (:460-463)."""

    def __init__(self, features: Sequence[int], num_classes: int = 3, act: str = "relu",
                 norm: Optional[str] = "group", deep_supervision: bool = False,
                 dropout: float = 0.0, refinement: bool = False, in_channels: int = 4):
        f = list(features)
        super().__init__()
        kw = dict(act=act, norm=norm, dropout=dropout)
        self.encoder1 = UBlock(in_channels, f[0], f[0], **kw)
        self.encoder2 = UBlock(f[0], f[1], f[1], **kw)
        self.encoder3 = UBlock(f[1], f[2], f[2], **kw)
        self.encoder4 = UBlock(f[2], f[3], f[3], **kw)
        self.bottom = UBlock(f[3], f[3], f[3], dilation=(2, 2), **kw)
        self.bottom_2 = ConvBnRelu(2 * f[3], f[2], act, norm, dropout=dropout)
        self.decoder3 = UBlock(2 * f[2], f[2], f[1], **kw)
        self.decoder2 = UBlock(2 * f[1], f[1], f[0], **kw)
        self.decoder1 = UBlock(2 * f[0], f[0], f[0], **kw)
        self._heads(f, f[0], num_classes, deep_supervision)
        if refinement:
            self.refunet = RefUnet(num_classes, f[0], act, norm, dropout)


class AttEquiUnet(_Unet2020):
    """EquiUnet with CBAM-gated encoders and bottom (equiunet2020.py:503-561);
    the reference's ``bottom_2`` is Sequential(ConvBnRelu, CBAM), keys
    ``bottom_2.0``/``bottom_2.1``."""

    def __init__(self, features: Sequence[int], num_classes: int = 3, act: str = "relu",
                 norm: Optional[str] = "group", deep_supervision: bool = False,
                 dropout: float = 0.0, in_channels: int = 4):
        f = list(features)
        super().__init__()
        kw = dict(act=act, norm=norm, dropout=dropout)
        self.encoder1 = UBlockCbam(in_channels, f[0], f[0], **kw)
        self.encoder2 = UBlockCbam(f[0], f[1], f[1], **kw)
        self.encoder3 = UBlockCbam(f[1], f[2], f[2], **kw)
        self.encoder4 = UBlockCbam(f[2], f[3], f[3], **kw)
        self.bottom = UBlockCbam(f[3], f[3], f[3], dilation=(2, 2), **kw)
        self.bottom_2 = nn.Sequential(ConvBnRelu(2 * f[3], f[2], act, norm, dropout=dropout),
                                      CBAM(f[2], norm=norm))
        self.decoder3 = UBlock(2 * f[2], f[2], f[1], **kw)
        self.decoder2 = UBlock(2 * f[1], f[1], f[0], **kw)
        self.decoder1 = UBlock(2 * f[0], f[0], f[0], **kw)
        self._heads(f, f[0], num_classes, deep_supervision)
