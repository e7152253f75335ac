"""Plain PyTorch copies of the two networks of the benchmark's configurations,
written from the published reference (github.com/Alxaline/BraTS21,
``src/networks/equiunet2021.py`` and ``src/networks/equiunet2020.py``).

They run in float32 in NCDHW layout with ordinary ``nn.Conv3d`` layers and
no hand-written kernel. Module and attribute names are the reference's, so
``state_dict()`` keys equal a published ``best_model.pth``'s and the same
seeded weights load into these networks and into the program.

Every convolution and linear layer rounds its operands through
:class:`Quantized`, the identity unless a lower-precision control sets it (``fp8.py``, :func:`set_quant`, which also rounds every
module's output): then the network computes as one whose activations are
stored in float8.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

Quant = Callable[[torch.Tensor], torch.Tensor]


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


class Quantized:
    """Holds the rounding of every GEMM-like layer's operands
    (``quant``)."""

    quant: Quant = staticmethod(_identity)

    def gemm_input(self, t: torch.Tensor) -> torch.Tensor:
        return self.quant(t)


class Conv(nn.Conv3d, Quantized):
    """3D convolution with padding d·(k−1)/2 (the reference's SAME)."""

    def __init__(self, cin: int, cout: int, k: int = 3, dilation: int = 1, bias: bool = True):
        super().__init__(cin, cout, k, padding=dilation * (k - 1) // 2, dilation=dilation,
                         bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv3d(self.gemm_input(x), self.gemm_input(self.weight), self.bias,
                        padding=self.padding, dilation=self.dilation)


class Linear(nn.Linear, Quantized):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.gemm_input(x), self.gemm_input(self.weight), self.bias)


def upsample(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """nn.Upsample(scale_factor, mode='trilinear', align_corners=True)."""
    return F.interpolate(x, scale_factor=scale, mode="trilinear", align_corners=True)


class DeepHead(nn.Sequential):
    """conv1x1 then ×scale trilinear upsample (equiunet2020.py:443-458)."""

    def __init__(self, cin: int, classes: int, scale: int):
        super().__init__(Conv(cin, classes, 1))
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample(self[0](x), self.scale)


# ---------------------------------------------------------------- 2021 line


class EvoNormS0(nn.Module):
    """EvoNorm-S0, efficient swish, affine (equiunet2021.py:55-118):
    x·sigmoid(x) / group_std(x)·γ + β, group_std over (C/G, D, H, W) with
    the unbiased variance, G = min(8, C), eps 1e-5. ``v`` and
    ``running_var`` exist for the checkpoint's keys and are unused."""

    def __init__(self, channels: int, groups: int = 8, eps: float = 1e-5):
        super().__init__()
        shape = (1, channels, 1, 1, 1)
        self.groups, self.eps = min(groups, channels), eps
        self.gamma = nn.Parameter(torch.ones(shape))
        self.beta = nn.Parameter(torch.zeros(shape))
        self.v = nn.Parameter(torch.ones(shape))
        self.register_buffer("running_var", torch.ones(shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        g = x.reshape(n, self.groups, c // self.groups, *x.shape[2:])
        var = torch.var(g, dim=(2, 3, 4, 5), keepdim=True)
        std = torch.sqrt(var + self.eps).expand_as(g).reshape(x.shape)
        return x * torch.sigmoid(x) / std * self.gamma + self.beta


class ConvEvo(nn.Module):
    """conv → EvoNorm (dropout 0) (equiunet2021.py:212-222)."""

    def __init__(self, cin: int, cout: int, k: int = 1, dilation: int = 1):
        super().__init__()
        self.conv = Conv(cin, cout, k, dilation)
        self.evo = EvoNormS0(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.evo(self.conv(x))


class ResidualSE(nn.Module):
    """MONAI ResidualSELayer(r=2): x + x·sigmoid(fc2(relu(fc1(gap(x)))))."""

    def __init__(self, channels: int, r: int = 2):
        super().__init__()
        self.fc = nn.Sequential(Linear(channels, channels // r), nn.ReLU(),
                                Linear(channels // r, channels), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.fc(x.mean(dim=(2, 3, 4)))
        return x + x * s[:, :, None, None, None]


class ConvEvoBlock(nn.Module):
    """(conv3 → EvoNorm → dropout) ×2 → ResidualSE as one Sequential
    ``conv_conv_se`` (equiunet2021.py:192-209)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv_conv_se = nn.Sequential(Conv(cin, cout, 3), EvoNormS0(cout), nn.Identity(),
                                          Conv(cout, cout, 3), EvoNormS0(cout), nn.Identity(),
                                          ResidualSE(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_conv_se(x)


class SimpleASPP(nn.Module):
    """Convs k=1,3,3,3 at dilations 1,2,4,6 concatenated, then a 1×1
    ConvEvo (equiunet2021.py:121-189)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.convs = nn.ModuleList([Conv(cin, cout, k, d)
                                    for k, d in zip((1, 3, 3, 3), (1, 2, 4, 6))])
        self.conv_k1 = ConvEvo(4 * cout, 4 * cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_k1(torch.cat([conv(x) for conv in self.convs], dim=1))


def max_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """MONAI MaxAvgPool: concat(maxpool 2, avgpool 2) on channels."""
    return torch.cat([F.max_pool3d(x, 2), F.avg_pool3d(x, 2)], dim=1)


class EquiUnetASSPEvo(nn.Module):
    """The BraTS 2021 network (equiunet2021.py:225-333) with deep
    supervision: ``forward(x)`` returns ``(logits, [deep3, deep2])``,
    ``forward(x, with_deep=False)`` the logits alone."""

    def __init__(self, width: int = 48, classes: int = 3, cin: int = 4):
        super().__init__()
        f = [width * 2 ** i for i in range(4)]
        self.encoder1 = ConvEvoBlock(cin, f[0])
        self.encoder2 = ConvEvoBlock(2 * f[0], f[1])
        self.encoder3 = ConvEvoBlock(2 * f[1], f[2])
        self.encoder4 = ConvEvoBlock(2 * f[2], f[3])
        self.aspp = SimpleASPP(f[3], f[3] // 4)
        self.bridge1 = ConvEvo(f[0], f[0] // 2)
        self.bridge2 = ConvEvo(f[1], f[1] // 2)
        self.bridge3 = ConvEvo(f[2], f[2] // 2)
        self.upconv3 = ConvEvo(f[3], f[3] // 4)
        self.decoder3 = ConvEvoBlock(f[2], f[2])
        self.upconv2 = ConvEvo(f[2], f[2] // 4)
        self.decoder2 = ConvEvoBlock(f[1], f[1])
        self.upconv1 = ConvEvo(f[1], f[1] // 4)
        self.decoder1 = ConvEvoBlock(f[0], f[0])
        self.out_conv = Conv(f[0], classes, 1)
        self.deep3 = DeepHead(f[2], classes, 4)
        self.deep2 = DeepHead(f[1], classes, 2)

    def forward(self, x: torch.Tensor, with_deep: bool = True):
        down1 = self.encoder1(x)
        down2 = self.encoder2(max_avg_pool(down1))
        down3 = self.encoder3(max_avg_pool(down2))
        down4 = self.encoder4(max_avg_pool(down3))
        assp = self.aspp(down4)
        up3 = upsample(self.upconv3(assp))
        up3 = self.decoder3(torch.cat([self.bridge3(down3), up3], dim=1))
        up2 = upsample(self.upconv2(up3))
        up2 = self.decoder2(torch.cat([self.bridge2(down2), up2], dim=1))
        up1 = upsample(self.upconv1(up2))
        up1 = self.decoder1(torch.cat([self.bridge1(down1), up1], dim=1))
        out = self.out_conv(up1)
        if not with_deep:
            return out
        return out, [self.deep3(up3), self.deep2(up2)]


# ---------------------------------------------------------------- 2020 line


class ConvBnRelu(nn.Module):
    """conv3 (no bias) → GroupNorm(min(8, C)) → ReLU (dropout 0)
    (equiunet2020.py:51-75)."""

    def __init__(self, cin: int, cout: int, dilation: int = 1):
        super().__init__()
        self.conv = Conv(cin, cout, 3, dilation, bias=False)
        self.bn = nn.GroupNorm(min(8, cout), cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class UBlock(nn.Module):
    def __init__(self, cin: int, mid: int, cout: int, dilation: Sequence[int] = (1, 1)):
        super().__init__()
        self.ConvBnRelu1 = ConvBnRelu(cin, mid, dilation[0])
        self.ConvBnRelu2 = ConvBnRelu(mid, cout, dilation[1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvBnRelu2(self.ConvBnRelu1(x))


class EquiUnet(nn.Module):
    """EquiUnet with GroupNorm and ReLU (equiunet2020.py:408-500), deep
    supervision on: ``forward(x)`` returns ``(logits, [deep_bottom,
    deep_bottom2, deep3, deep2])``."""

    def __init__(self, width: int = 48, classes: int = 3, cin: int = 4):
        super().__init__()
        f = [width * 2 ** i for i in range(4)]
        self.encoder1 = UBlock(cin, f[0], f[0])
        self.encoder2 = UBlock(f[0], f[1], f[1])
        self.encoder3 = UBlock(f[1], f[2], f[2])
        self.encoder4 = UBlock(f[2], f[3], f[3])
        self.bottom = UBlock(f[3], f[3], f[3], dilation=(2, 2))
        self.bottom_2 = ConvBnRelu(2 * f[3], f[2])
        self.decoder3 = UBlock(2 * f[2], f[2], f[1])
        self.decoder2 = UBlock(2 * f[1], f[1], f[0])
        self.decoder1 = UBlock(2 * f[0], f[0], f[0])
        self.outconv = Conv(f[0], classes, 1)
        self.deep_bottom = DeepHead(f[3], classes, 8)
        self.deep_bottom2 = DeepHead(f[2], classes, 8)
        self.deep3 = DeepHead(f[1], classes, 4)
        self.deep2 = DeepHead(f[0], classes, 2)

    def forward(self, x: torch.Tensor, with_deep: bool = True):
        down1 = self.encoder1(x)
        down2 = self.encoder2(F.max_pool3d(down1, 2))
        down3 = self.encoder3(F.max_pool3d(down2, 2))
        down4 = self.encoder4(F.max_pool3d(down3, 2))
        bottom = self.bottom(down4)
        bottom_2 = self.bottom_2(torch.cat([down4, bottom], dim=1))
        up3 = self.decoder3(torch.cat([down3, upsample(bottom_2)], dim=1))
        up2 = self.decoder2(torch.cat([down2, upsample(up3)], dim=1))
        up1 = self.decoder1(torch.cat([down1, upsample(up2)], dim=1))
        out = self.outconv(up1)
        if not with_deep:
            return out
        return out, [self.deep_bottom(bottom), self.deep_bottom2(bottom_2),
                     self.deep3(up3), self.deep2(up2)]


NETWORKS = {"EquiUnetASSPEvo": EquiUnetASSPEvo, "EquiUnet": EquiUnet}


def build(name: str, **kwargs) -> nn.Module:
    """The network named in a configuration file's ``reference`` entry."""
    return NETWORKS[name](**kwargs)


def set_quant(model: nn.Module, quant: Optional[Quant]) -> None:
    """Round every GEMM operand of ``model`` and every module's output with
    ``quant`` (None: no rounding, and the outputs' rounding taken off)."""
    for m in model.modules():
        if isinstance(m, Quantized):
            m.quant = quant or _identity
        for handle in getattr(m, "_quant_hooks", []):
            handle.remove()
        m._quant_hooks = []
        if quant is not None:
            m._quant_hooks.append(m.register_forward_hook(
                lambda mod, args, out, q=quant: _tree(q, out)))


def _tree(fn: Quant, out):
    if isinstance(out, torch.Tensor):
        return fn(out) if out.is_floating_point() else out
    if isinstance(out, (list, tuple)):
        return type(out)(_tree(fn, o) for o in out)
    return out


def heads(out) -> List[torch.Tensor]:
    """Every head of a ``(logits, [deep heads])`` output, main head first."""
    main, deeps = out
    return [main, *deeps]


def main_head(out) -> torch.Tensor:
    return out[0] if isinstance(out, tuple) else out


__all__ = ["EquiUnetASSPEvo", "EquiUnet", "EvoNormS0", "Conv", "build", "set_quant",
           "heads", "main_head"]
