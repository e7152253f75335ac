"""A plain float32 Swin UNETR, written from the published equations (MONAI
``SwinUNETR`` with the BraTS 2021 settings of ``research-contributions``
``SwinUNETR/BRATS21``) to hold the port's ``--model swin_unetr`` against.

It imports neither JAX nor any module of the port: ordinary ``torch.nn``
layers, tokens ``[B, D, H, W, C]``, MONAI's module names (so the port's
``state_dict`` loads by key), and the window attention as MONAI computes
it: roll by ``-shift``, partition into 7³ windows (an axis of at most 7
tokens one window, unshifted), ``softmax((q·d^−½) kᵀ + table[idx[:n,
:n]] + mask) v``, reverse, roll back, crop the far-end zero pad. Where it
runs on a card, TF32 is off.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

WINDOW = 7


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def window_and_shift(size: Sequence[int]):
    ws = [s if s <= WINDOW else WINDOW for s in size]
    shift = [0 if s <= WINDOW else WINDOW // 2 for s in size]
    return ws, shift


def relative_position_index() -> torch.Tensor:
    """``[343, 343]`` MONAI's index of the 7³ window."""
    coords = torch.stack(torch.meshgrid(*[torch.arange(WINDOW)] * 3, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0).contiguous()
    rel += WINDOW - 1
    rel[:, :, 0] *= (2 * WINDOW - 1) ** 2
    rel[:, :, 1] *= 2 * WINDOW - 1
    return rel.sum(-1)


def window_partition(x: torch.Tensor, ws: Sequence[int]) -> torch.Tensor:
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, ws[0] * ws[1] * ws[2], c)


def window_reverse(windows: torch.Tensor, ws: Sequence[int], dims: Sequence[int]) -> torch.Tensor:
    b, d, h, w = dims
    x = windows.view(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def compute_mask(dims: Sequence[int], ws: Sequence[int], shift: Sequence[int]) -> torch.Tensor:
    """MONAI's ``compute_mask``: ``[windows, n, n]``, −100 across regions."""
    d, h, w = dims
    img = torch.zeros((1, d, h, w, 1))
    cnt = 0
    cuts = [(slice(-ws[i]), slice(-ws[i], -shift[i]), slice(-shift[i], None)) for i in range(3)]
    for sd in cuts[0]:
        for sh in cuts[1]:
            for sw in cuts[2]:
                img[:, sd, sh, sw, :] = cnt
                cnt += 1
    ids = window_partition(img, ws).squeeze(-1)
    diff = ids.unsqueeze(1) - ids.unsqueeze(2)
    return diff.masked_fill(diff != 0, -100.0).masked_fill(diff == 0, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * WINDOW - 1) ** 3, heads))
        self.register_buffer("relative_position_index", relative_position_index(),
                             persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        attn = q @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[
            self.relative_position_index[:n, :n].reshape(-1)].reshape(n, n, -1)
        attn = attn + bias.permute(2, 0, 1).unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b // nw, nw, self.heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x)))


class SwinBlock(nn.Module):
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
        if any(shift):
            y = torch.roll(y, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
            mask = compute_mask(dims[1:], ws, shift).to(x.device)
        else:
            mask = None
        a = self.attn(window_partition(y, ws), mask)
        a = window_reverse(a, ws, dims)
        if any(shift):
            a = torch.roll(a, shifts=tuple(shift), dims=(1, 2, 3))
        x = x + a[:, :d, :h, :w]
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(8 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = x[:, 0::2, 0::2, 0::2]
        x1 = x[:, 1::2, 0::2, 0::2]
        x2 = x[:, 0::2, 1::2, 0::2]
        x3 = x[:, 0::2, 0::2, 1::2]
        x4 = x[:, 1::2, 0::2, 1::2]
        x5 = x[:, 0::2, 1::2, 0::2]
        x6 = x[:, 0::2, 0::2, 1::2]
        x7 = x[:, 1::2, 1::2, 1::2]
        x = torch.cat([x0, x1, x2, x3, x4, x5, x6, x7], -1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, heads: int, depth: int):
        super().__init__()
        self.blocks = nn.ModuleList([SwinBlock(dim, heads, i % 2 == 1) for i in range(depth)])
        self.downsample = PatchMerging(dim)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return self.downsample(x)


class PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.proj = nn.Conv3d(cin, dim, kernel_size=2, stride=2)


class SwinViT(nn.Module):
    def __init__(self, cin: int, dim: int, depths, heads):
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
        # proj_out: LayerNorm without affine, eps 1e-5, back to NCDHW
        return [F.layer_norm(o, o.shape[-1:]).permute(0, 4, 1, 2, 3) for o in outs]


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, bias: bool = False):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, k, padding=k // 2, bias=bias)

    def forward(self, x):
        return self.conv(x)


class ResBlock(nn.Module):
    """MONAI ``UnetResBlock``, instance norm without affine, leaky ReLU 0.01."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3)
        self.conv2 = Conv(cout, cout, 3)
        self.norm1 = nn.InstanceNorm3d(cout)
        self.norm2 = nn.InstanceNorm3d(cout)
        self.downsample = cin != cout
        if self.downsample:
            self.conv3 = Conv(cin, cout, 1)
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


class TranspConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.ConvTranspose3d(cin, cout, 2, stride=2, bias=False)

    def forward(self, x):
        return self.conv(x)


class UpBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.transp_conv = TranspConv(cin, cout)
        self.conv_block = ResBlock(2 * cout, cout)

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=1))


class OutBlock(nn.Module):
    def __init__(self, cin: int, classes: int):
        super().__init__()
        self.conv = Conv(cin, classes, 1, bias=True)

    def forward(self, x):
        return self.conv(x)


class SwinUNETR(nn.Module):
    def __init__(self, feature_size: int = 48, num_heads=(3, 6, 12, 24), depths=(2, 2, 2, 2),
                 in_channels: int = 4, num_classes: int = 3):
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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


__all__ = ["SwinUNETR", "compute_mask", "relative_position_index", "window_partition",
           "no_tf32"]
