"""A plain PyTorch copy of Swin UNETR for the benchmark's
``swin_unetr_f48`` configuration, written from the published equations
(Hatamizadeh et al., arXiv:2201.01266; MONAI ``SwinUNETR`` with the BraTS
2021 settings of Project-MONAI ``research-contributions``
``SwinUNETR/BRATS21``): feature size 48, depths (2, 2, 2, 2), heads (3, 6,
12, 24), window 7, patch 2, MLP ratio 4, qkv bias, LayerNorm,
``normalize=True``, instance norm without affine, merging "merging".

It runs in float32 with ordinary layers and no hand-written kernel. Module
names are MONAI's, so the seeded weights load into it and into the program
by key. Its convolutions and linears are :class:`nets.Conv` and
:class:`nets.Linear` (the stride-2 patch embedding and the transposed convs
their own :class:`nets.Quantized` layers), and the attention's two products
round their operands through ``Quantized.gemm_input`` in
:class:`AttentionCore`: the fp8 control rounds them all. Importing this
module registers ``SwinUNETR`` in ``nets.NETWORKS``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import nets

WINDOW = 7
HEAD_DIM = 16


def window_and_shift(size: Sequence[int]):
    """MONAI's ``get_window_size``: an axis of at most 7 tokens is one
    window and is not shifted."""
    ws = [s if s <= WINDOW else WINDOW for s in size]
    shift = [0 if s <= WINDOW else WINDOW // 2 for s in size]
    return ws, shift


def relative_position_index(device=None) -> torch.Tensor:
    """``[343, 343]``: MONAI's table row of each token pair of a 7³ window."""
    r = torch.arange(WINDOW, device=device)
    coords = torch.stack(torch.meshgrid(r, r, r, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (WINDOW - 1)
    span = 2 * WINDOW - 1
    return rel[..., 0] * span * span + rel[..., 1] * span + rel[..., 2]


def partition(x: torch.Tensor, ws: Sequence[int]) -> torch.Tensor:
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, ws[0] * ws[1] * ws[2], c)


def reverse(windows: torch.Tensor, ws: Sequence[int], dims: Sequence[int]) -> torch.Tensor:
    b, d, h, w = dims
    x = windows.view(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def shift_mask(dims: Sequence[int], ws: Sequence[int], shift: Sequence[int], device
               ) -> torch.Tensor:
    """MONAI's ``compute_mask``: ``[windows, n, n]``, −100 between tokens of
    different regions of the rolled grid, cut on each axis by ``(0:−ws),
    (−ws:−shift), (−shift:)``."""
    ids = []
    for p, w, s in zip(dims, ws, shift):
        c = torch.arange(p, device=device)
        ids.append(torch.where(c < p - w, 0, torch.where(c < p - s, 1, 2)))
    grid = ids[0][:, None, None] * 9 + ids[1][None, :, None] * 3 + ids[2][None, None, :]
    win = partition(grid[None, ..., None].float(), ws)[..., 0]
    return torch.where(win[:, :, None] != win[:, None, :], -100.0, 0.0)


class AttentionCore(nn.Module, nets.Quantized):
    """``softmax((q·d^−½) kᵀ + bias + mask) v`` of q, k, v ``[B·windows,
    heads, n, d]``: the work that kernel B4 does (the roofline reader counts
    it from this module's calls)."""

    def forward(self, q, k, v, bias, mask):
        s = self.gemm_input(q * q.shape[-1] ** -0.5) @ self.gemm_input(k).transpose(-2, -1)
        s = s + bias[None]
        if mask is not None:
            nw, n = mask.shape[0], s.shape[-1]
            s = (s.view(-1, nw, s.shape[1], n, n) + mask[None, :, None]).view(s.shape)
        return self.gemm_input(torch.softmax(s, dim=-1)) @ self.gemm_input(v)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * WINDOW - 1) ** 3, heads))
        self.qkv = nets.Linear(dim, 3 * dim, bias=True)
        self.core = AttentionCore()
        self.proj = nets.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        idx = relative_position_index(x.device)[:n, :n].reshape(-1)
        bias = self.relative_position_bias_table[idx].reshape(n, n, -1).permute(2, 0, 1)
        o = self.core(qkv[0], qkv[1], qkv[2], bias, mask)
        return self.proj(o.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = nets.Linear(dim, hidden)
        self.linear2 = nets.Linear(hidden, dim)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x)))


class SwinBlock(nn.Module):
    """``x + crop(roll⁻¹(reverse(attn(partition(roll(pad(LN1(x))))))))``,
    then ``x + MLP(LN2(x))``; ``shifted`` for the second block of a stage."""

    def __init__(self, dim: int, heads: int, shifted: bool):
        super().__init__()
        self.shifted = shifted
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, w, c = x.shape
        ws, shift = window_and_shift((d, h, w))
        if not self.shifted:
            shift = [0, 0, 0]
        y = self.norm1(x)
        pads = [(ws[i] - s % ws[i]) % ws[i] for i, s in enumerate((d, h, w))]
        y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        dims = [b, *y.shape[1:4]]
        mask = None
        if any(shift):
            y = torch.roll(y, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
            mask = shift_mask(dims[1:], ws, shift, x.device)
        a = reverse(self.attn(partition(y, ws), mask), ws, dims)
        if any(shift):
            a = torch.roll(a, shifts=tuple(shift), dims=(1, 2, 3))
        x = x + a[:, :d, :h, :w]
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """MONAI v0.9's "merging": the eight sub-grids in its order (x[0::2,
    0::2, 0::2], x[1::2, 0::2, 0::2], x[0::2, 1::2, 0::2], x[0::2, 0::2,
    1::2], x[1::2, 0::2, 1::2], x[0::2, 1::2, 0::2], x[0::2, 0::2, 1::2],
    x[1::2, 1::2, 1::2]), LayerNorm(8C), Linear(8C, 2C) without bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nets.Linear(8 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(8 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = [x[:, 0::2, 0::2, 0::2], x[:, 1::2, 0::2, 0::2], x[:, 0::2, 1::2, 0::2],
                 x[:, 0::2, 0::2, 1::2], x[:, 1::2, 0::2, 1::2], x[:, 0::2, 1::2, 0::2],
                 x[:, 0::2, 0::2, 1::2], x[:, 1::2, 1::2, 1::2]]
        return self.reduction(self.norm(torch.cat(parts, -1)))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, heads: int, depth: int):
        super().__init__()
        self.blocks = nn.ModuleList([SwinBlock(dim, heads, i % 2 == 1) for i in range(depth)])
        self.downsample = PatchMerging(dim)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return self.downsample(x)


class StridedConv(nn.Conv3d, nets.Quantized):
    """The patch embedding: a 2³ conv of stride 2, with bias."""

    def forward(self, x):
        return F.conv3d(self.gemm_input(x), self.gemm_input(self.weight), self.bias,
                        stride=self.stride)


class PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.proj = StridedConv(cin, dim, 2, stride=2)


class SwinViT(nn.Module):
    def __init__(self, cin: int, dim: int, depths: Sequence[int], heads: Sequence[int]):
        super().__init__()
        self.patch_embed = PatchEmbed(cin, dim)
        for i in range(4):
            setattr(self, f"layers{i + 1}",
                    nn.ModuleList([BasicLayer(dim * 2 ** i, heads[i], depths[i])]))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        t = self.patch_embed.proj(x).permute(0, 2, 3, 4, 1)
        outs = [t]
        for i in range(4):
            t = getattr(self, f"layers{i + 1}")[0](t)
            outs.append(t)
        return [F.layer_norm(o, o.shape[-1:]).permute(0, 4, 1, 2, 3) for o in outs]


class ConvOnly(nn.Module):
    """MONAI's conv-only ``Convolution`` (child ``conv``)."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = False):
        super().__init__()
        self.conv = nets.Conv(cin, cout, k, bias=bias)

    def forward(self, x):
        return self.conv(x)


class ResBlock(nn.Module):
    """MONAI ``UnetResBlock``: conv3 → IN → leaky ReLU 0.01 → conv3 → IN,
    plus conv1 → IN where the channels change, leaky ReLU after the sum;
    bias-free convs, instance norm without affine."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = ConvOnly(cin, cout, 3)
        self.conv2 = ConvOnly(cout, cout, 3)
        self.norm1 = nn.InstanceNorm3d(cout)
        self.norm2 = nn.InstanceNorm3d(cout)
        self.downsample = cin != cout
        if self.downsample:
            self.conv3 = ConvOnly(cin, cout, 1)
            self.norm3 = nn.InstanceNorm3d(cout)

    def forward(self, x):
        y = F.leaky_relu(self.norm1(self.conv1(x)), 0.01)
        y = self.norm2(self.conv2(y))
        res = self.norm3(self.conv3(x)) if self.downsample else x
        return F.leaky_relu(y + res, 0.01)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.layer = ResBlock(cin, cout)

    def forward(self, x):
        return self.layer(x)


class TransposedConv(nn.ConvTranspose3d, nets.Quantized):
    def forward(self, x):
        return F.conv_transpose3d(self.gemm_input(x), self.gemm_input(self.weight), None,
                                  stride=self.stride)


class TranspConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = TransposedConv(cin, cout, 2, stride=2, bias=False)

    def forward(self, x):
        return self.conv(x)


class UpBlock(nn.Module):
    """MONAI ``UnetrUpBlock``: 2³/s2 transposed conv, concat the skip,
    ``ResBlock(2C → C)``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.transp_conv = TranspConv(cin, cout)
        self.conv_block = ResBlock(2 * cout, cout)

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=1))


class OutBlock(nn.Module):
    def __init__(self, cin: int, classes: int):
        super().__init__()
        self.conv = ConvOnly(cin, classes, 1, bias=True)

    def forward(self, x):
        return self.conv(x)


class SwinUNETR(nn.Module):
    """``forward(x, with_deep)`` returns the logits (no deep supervision)."""

    def __init__(self, feature_size: int = 48, num_heads: Sequence[int] = (3, 6, 12, 24),
                 depths: Sequence[int] = (2, 2, 2, 2), in_channels: int = 4,
                 num_classes: int = 3):
        super().__init__()
        fs = feature_size
        self.swinViT = SwinViT(in_channels, fs, depths, num_heads)
        self.encoder1 = BasicBlock(in_channels, fs)
        self.encoder2 = BasicBlock(fs, fs)
        self.encoder3 = BasicBlock(2 * fs, 2 * fs)
        self.encoder4 = BasicBlock(4 * fs, 4 * fs)
        self.encoder10 = BasicBlock(16 * fs, 16 * fs)
        self.decoder5 = UpBlock(16 * fs, 8 * fs)
        self.decoder4 = UpBlock(8 * fs, 4 * fs)
        self.decoder3 = UpBlock(4 * fs, 2 * fs)
        self.decoder2 = UpBlock(2 * fs, fs)
        self.decoder1 = UpBlock(fs, fs)
        self.out = OutBlock(fs, num_classes)

    def forward(self, x: torch.Tensor, with_deep: bool = False) -> torch.Tensor:
        hs = self.swinViT(x)
        enc0 = self.encoder1(x)
        enc1 = self.encoder2(hs[0])
        enc2 = self.encoder3(hs[1])
        enc3 = self.encoder4(hs[2])
        dec4 = self.encoder10(hs[4])
        dec3 = self.decoder5(dec4, hs[3])
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        dec0 = self.decoder2(dec1, enc1)
        return self.out(self.decoder1(dec0, enc0))


nets.NETWORKS["SwinUNETR"] = SwinUNETR
