"""EquiUnetASSPEvo — the 2021 winner: Bridge-Unet + ASPP + SE + EvoNorm.

Port of ``brats21_tpu/models/assp_evo.py`` (reference
networks/equiunet2021.py, cited per class). Module and attribute names
reproduce the reference's, so ``state_dict()`` keys equal a published
``best_model.pth``'s (reconstructed in
``brats21_tpu/utils/import_torch.py:136-183``): ``encoderN.conv_conv_se.
{0,1,3,4,6}``, ``aspp.convs.i``, ``aspp.conv_k1.{conv,evo}``,
``bridgeN``/``upconvN.{conv,evo}``, ``deep3.0`` and ``out_conv``; the
refinement variant (``equiunet_assp_evo_ref``) adds ``refunet.*`` in the
2020 line's naming (``models/equiunet.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.evonorm import (EvoNormS0Function, evonorm_s0_apply, evonorm_s0_stats,
                                   inv_std)
from ..ops.kernels.glue import se_gate_pool, upsample_cat
from ..parallel import spatial
from .equiunet import DeepHead, RefUnet
from .layers import (Conv3d, Dropout, from_kernel_layout, global_avg_pool,
                     max_avg_pool, to_kernel_layout, upsample)


def group_std(x: torch.Tensor, groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Per-(sample, group) std over (C/G, D, H, W) with the unbiased
    variance (equiunet2021.py:48-52), broadcast back to ``x``'s
    ``[B, D, H, W, C]`` shape; on a slab, of the whole volume."""
    b, c = x.shape[0], x.shape[-1]
    g = x.reshape(b, -1, groups, c // groups)
    slab = spatial.active()
    if slab is None:
        n = g.shape[1] * g.shape[3]
        var = g.var(dim=(1, 3), keepdim=True, unbiased=False) * (n / max(n - 1, 1))
    else:
        cnt, _, m2 = spatial.group_moments(g.float(), slab).unbind(-1)
        var = (m2 / (cnt - 1).clamp(min=1)).to(x.dtype)[:, None, :, None]
    return torch.sqrt(var + eps).expand(g.shape).reshape(x.shape)


def instance_std(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Unbiased per-(sample, channel) spatial std of ``[B, D, H, W, C]``
    (equiunet2021.py:41-45); on a slab, of the whole volume."""
    slab = spatial.active()
    if slab is None:
        n = x.shape[1] * x.shape[2] * x.shape[3]
        var = x.var(dim=(1, 2, 3), keepdim=True, unbiased=False) * (n / max(n - 1, 1))
    else:
        b, c = x.shape[0], x.shape[-1]
        cnt, _, m2 = spatial.group_moments(x.reshape(b, -1, c, 1).float(), slab).unbind(-1)
        var = (m2 / (cnt - 1).clamp(min=1)).to(x.dtype).reshape(b, 1, 1, 1, c)
    return torch.sqrt(var + eps)


class EvoNorm3D(nn.Module):
    """EvoNorm S0/B0 (equiunet2021.py:55-118, ``assp_evo.py:71-141``).

    S0 in the form the model uses (efficient swish, affine),
    ``x·sigmoid(x) / group_std(x)·γ + β`` with the unbiased group variance,
    runs the hand-written :func:`evonorm_s0` through its trainable
    :class:`EvoNormS0Function`. The other forms are plain PyTorch, as they
    are XLA in the JAX package: S0 with ``efficient=False`` takes
    ``x·sigmoid(v·x)``, ``non_linear=False`` is the affine alone; B0
    divides by ``max(sqrt(var + eps), v·x + instance_std(x))`` where var is
    the biased batch variance in training, which moves the
    ``running_var`` buffer by ``r ← 0.9·r + 0.1·var``, and ``running_var``
    in eval. ``affine=False`` applies no affine (the JAX module raises
    there, multiplying by a missing γ). These other forms compute in fp32
    and return the input's dtype.

    ``gamma``, ``beta``, ``v`` and ``running_var`` have the reference's
    shape ``(1, C, 1, 1, 1)``; ``v`` and ``running_var`` are allocated in
    every form, so reference checkpoints load with a plain
    ``load_state_dict``.

    On a slab (``parallel/spatial.py``) S0's kernel form splits: the
    statistics kernel's (n, mean, M2) of this slab, merged over the space
    group in fp64, give inv, and the apply kernel runs on it; the other
    forms' ``group_std`` / ``instance_std`` merge the same way."""

    def __init__(self, num_features: int, non_linear: bool = True, version: str = "S0",
                 efficient: bool = True, affine: bool = True, momentum: float = 0.9,
                 eps: float = 1e-5, groups: int = 8):
        super().__init__()
        if version not in ("B0", "S0"):
            raise ValueError("Invalid EvoNorm version")
        self.non_linear, self.version, self.efficient = non_linear, version, efficient
        self.affine, self.momentum = affine, momentum
        self.eps = eps
        self.groups = groups
        shape = (1, num_features, 1, 1, 1)
        self.gamma = nn.Parameter(torch.ones(shape))
        self.beta = nn.Parameter(torch.zeros(shape))
        self.v = nn.Parameter(torch.ones(shape))
        self.register_buffer("running_var", torch.ones(shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        slab = spatial.active()
        if self.version == "S0" and self.non_linear and self.efficient and self.affine \
                and slab is not None:
            xk = to_kernel_layout(x)
            stats = spatial.merge_moments(evonorm_s0_stats(xk, min(self.groups, c)), slab.group)
            return from_kernel_layout(evonorm_s0_apply(
                xk, inv_std(stats, self.eps).to(x.device), self.gamma.reshape(c),
                self.beta.reshape(c)))
        if self.version == "S0" and self.non_linear and self.efficient and self.affine:
            y = EvoNormS0Function.apply(to_kernel_layout(x), self.gamma.reshape(c),
                                        self.beta.reshape(c), min(self.groups, c),
                                        self.eps)
            return from_kernel_layout(y)
        xf = to_kernel_layout(x).float()
        v = self.v.reshape(c)
        if not self.non_linear:
            out = xf
        elif self.version == "S0":
            num = xf * torch.sigmoid(xf if self.efficient else v * xf)
            out = num / group_std(xf, min(self.groups, c), self.eps)
        else:
            if self.training:
                var = xf.var(dim=(0, 1, 2, 3), unbiased=False)
                with torch.no_grad():
                    self.running_var.mul_(self.momentum).add_(
                        (1 - self.momentum) * var.reshape(self.running_var.shape))
            else:
                var = self.running_var.reshape(c)
            den = torch.maximum(torch.sqrt(var + self.eps),
                                v * xf + instance_std(xf, self.eps))
            out = xf / den
        if self.affine:
            out = out * self.gamma.reshape(c) + self.beta.reshape(c)
        return from_kernel_layout(out.to(x.dtype))


class ConvEvo(nn.Module):
    """conv → EvoNorm3D → dropout (equiunet2021.py:212-222)."""

    def __init__(self, in_channels: int, features: int, dropout_p: float = 0.0,
                 kernel_size: int = 1, dilation: int = 1):
        super().__init__()
        self.conv = Conv3d(in_channels, features, kernel_size, dilation=dilation)
        self.evo = EvoNorm3D(features)
        self.drop = Dropout(dropout_p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.evo(self.conv(x)))


class ResidualSELayer(nn.Module):
    """MONAI ResidualSELayer(r=2, relu/sigmoid):
    x + x·sigmoid(fc2(relu(fc1(gap(x))))) (equiunet2021.py:204-205); the
    reference's ``fc`` Sequential puts the Linears at keys fc.0 / fc.2."""

    def __init__(self, channels: int, r: int = 2):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(channels, channels // r), nn.ReLU(),
                                nn.Linear(channels // r, channels), nn.Sigmoid())

    def gate(self, x: torch.Tensor) -> torch.Tensor:
        """s = sigmoid(fc2(relu(fc1(gap(x))))), ``[B, C]`` in x's dtype."""
        fc1, fc2 = self.fc[0], self.fc[2]
        h = torch.relu(F.linear(global_avg_pool(x), fc1.weight.to(x.dtype),
                                fc1.bias.to(x.dtype)))
        return torch.sigmoid(F.linear(h, fc2.weight.to(x.dtype), fc2.bias.to(x.dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + x * self.gate(x)[:, :, None, None, None]


class ConvEvoBlockCorrected(nn.Module):
    """(conv3 → EvoNorm → drop) ×2 → ResidualSE as ONE Sequential
    ``conv_conv_se`` (equiunet2021.py:192-209)."""

    def __init__(self, in_channels: int, features: int, dropout_p: float = 0.0):
        super().__init__()
        self.conv_conv_se = nn.Sequential(
            Conv3d(in_channels, features, 3), EvoNorm3D(features),
            Dropout(dropout_p),
            Conv3d(features, features, 3), EvoNorm3D(features),
            Dropout(dropout_p),
            ResidualSELayer(features, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_conv_se(x)

    def gated(self, x: torch.Tensor, pool: bool
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The block's output and, with ``pool``, its MaxAvgPool (else None),
        the ResidualSE gate and the pool in one :func:`se_gate_pool` pass."""
        *body, se = self.conv_conv_se
        for layer in body:
            x = layer(x)
        y, pooled = se_gate_pool(to_kernel_layout(x), se.gate(x), pool)
        return from_kernel_layout(y), None if pooled is None else from_kernel_layout(pooled)


class SimpleASPPEVO(nn.Module):
    """Four parallel convs (k=1,3,3,3 / d=1,2,4,6) concatenated, then a 1×1
    ConvEvo (equiunet2021.py:121-189)."""

    def __init__(self, in_channels: int, conv_out_channels: int,
                 kernel_sizes: Sequence[int] = (1, 3, 3, 3),
                 dilations: Sequence[int] = (1, 2, 4, 6)):
        super().__init__()
        if len(kernel_sizes) != len(dilations):
            raise ValueError("kernel_sizes and dilations length must match")
        self.convs = nn.ModuleList(
            [Conv3d(in_channels, conv_out_channels, k, dilation=d)
             for k, d in zip(kernel_sizes, dilations)])
        cat = conv_out_channels * len(kernel_sizes)
        self.conv_k1 = ConvEvo(cat, cat, 0.0, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_k1(torch.cat([conv(x) for conv in self.convs], dim=1))


ModelOutput = Union[torch.Tensor, Tuple[torch.Tensor, List[torch.Tensor]]]


def glue_route() -> bool:
    """Whether a forward takes the glue passes between its blocks
    (:mod:`..ops.kernels.glue`; CPU tensors take their plain versions):
    with no autograd (``evaluate`` serves under ``inference_mode``) and
    outside a slab. Training and the Z-sharded forward keep the
    composition of PyTorch calls, whose outputs the passes equal."""
    return not torch.is_grad_enabled() and spatial.active() is None


def _encode(block: ConvEvoBlockCorrected, x: torch.Tensor, glue: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """An encoder block's output and the next level's input, its
    MaxAvgPool."""
    if glue:
        return block.gated(x, pool=True)
    y = block(x)
    return y, max_avg_pool(y)


def _decode(block: ConvEvoBlockCorrected, low: torch.Tensor, skip: torch.Tensor,
            glue: bool) -> torch.Tensor:
    """A decoder block on ``[skip, low upsampled ×2]`` on channels."""
    if glue:
        return block.gated(from_kernel_layout(upsample_cat(to_kernel_layout(skip),
                                                           to_kernel_layout(low))),
                           pool=False)[0]
    return block(torch.cat([skip, upsample(low)], dim=1))


class EquiUnetASSPEvo(nn.Module):
    """The selected BraTS21 architecture (equiunet2021.py:225-333):
    channel-doubling MaxAvgPool downsample, half-width bridge skips, ASPP
    bottleneck, ConvEvo up-convs + trilinear upsample decoders, deep
    supervision at up3/up2; with ``refinement`` a RefUnet on the logits
    (``equiunet_assp_evo_ref``).

    ``forward(x)`` returns ``(logits, [deep3, deep2])`` with deep
    supervision on (``([refined, logits], deeps)`` with the refinement);
    ``forward(x, with_deep=False)`` skips the deep heads
    for callers that read the main head only (XLA drops them under ``jit``
    on the TPU). Z-sharded, the slabs are cut at multiples of 8 (16 with the
    refinement, whose Z need only be a multiple of 8: the last slab then
    holds a partial block)."""

    spatial_factor = 8

    def __init__(self, features: Sequence[int], num_classes: int = 3,
                 deep_supervision: bool = False, dropout: float = 0.0,
                 in_channels: int = 4, refinement: bool = False):
        super().__init__()
        f = list(features)
        self.deep_supervision = deep_supervision
        self.encoder1 = ConvEvoBlockCorrected(in_channels, f[0], dropout)
        self.encoder2 = ConvEvoBlockCorrected(2 * f[0], f[1], dropout)
        self.encoder3 = ConvEvoBlockCorrected(2 * f[1], f[2], dropout)
        self.encoder4 = ConvEvoBlockCorrected(2 * f[2], f[3], dropout)
        self.aspp = SimpleASPPEVO(f[3], f[3] // 4)
        self.bridge1 = ConvEvo(f[0], f[0] // 2, dropout)
        self.bridge2 = ConvEvo(f[1], f[1] // 2, dropout)
        self.bridge3 = ConvEvo(f[2], f[2] // 2, dropout)
        self.upconv3 = ConvEvo(f[3], f[3] // 4, dropout)
        self.decoder3 = ConvEvoBlockCorrected(f[2], f[2], dropout)
        self.upconv2 = ConvEvo(f[2], f[2] // 4, dropout)
        self.decoder2 = ConvEvoBlockCorrected(f[1], f[1], dropout)
        self.upconv1 = ConvEvo(f[1], f[1] // 4, dropout)
        self.decoder1 = ConvEvoBlockCorrected(f[0], f[0], dropout)
        self.out_conv = Conv3d(f[0], num_classes, 1)
        if deep_supervision:
            self.deep3 = DeepHead(f[2], num_classes, 4)
            self.deep2 = DeepHead(f[1], num_classes, 2)
        # equiunet_assp_evo_ref (assp_evo.py:300-304): relu and GroupNorm
        # whatever the CLI's --act and --norm
        self.refunet = RefUnet(num_classes, f[0], "relu", "group", dropout) \
            if refinement else None
        if refinement:
            self.spatial_factor, self.spatial_multiple = RefUnet.spatial_factor, 8

    def forward(self, x: torch.Tensor, with_deep: bool = True) -> ModelOutput:
        glue = glue_route()
        down1, x = _encode(self.encoder1, x, glue)
        down2, x = _encode(self.encoder2, x, glue)
        down3, x = _encode(self.encoder3, x, glue)
        down4 = self.encoder4.gated(x, pool=False)[0] if glue else self.encoder4(x)
        assp = self.aspp(down4)

        up3 = _decode(self.decoder3, self.upconv3(assp), self.bridge3(down3), glue)
        up2 = _decode(self.decoder2, self.upconv2(up3), self.bridge2(down2), glue)
        up1 = _decode(self.decoder1, self.upconv1(up2), self.bridge1(down1), glue)

        out = self.out_conv(up1)
        if self.refunet is not None:
            out = [self.refunet(out), out]
        if not self.deep_supervision:
            return out
        deeps = [self.deep3(up3), self.deep2(up2)] if with_deep else []
        return out, deeps
