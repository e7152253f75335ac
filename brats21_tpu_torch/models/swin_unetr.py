"""Swin UNETR, the shifted-window transformer U-Net (``--model
swin_unetr``).

Hatamizadeh et al., "Swin UNETR: Swin Transformers for Semantic
Segmentation of Brain Tumors in MRI Images" (BrainLes 2021,
arXiv:2201.01266), as MONAI's ``monai.networks.nets.SwinUNETR`` builds it
with the BraTS 2021 settings of Project-MONAI ``research-contributions``
(``SwinUNETR/BRATS21``): 4 channels in, 3 out, ``feature_size`` 48,
``depths`` (2, 2, 2, 2), ``num_heads`` (3, 6, 12, 24) (head size 16 in
every stage), window 7, patch 2, MLP ratio 4, qkv bias, LayerNorm,
``normalize=True``, ``norm_name="instance"`` (no affine), patch merging
``"merging"``, dropouts 0. It has no counterpart in the JAX package.

Names are MONAI's, so a published checkpoint loads by key:
``swinViT.patch_embed.proj``, ``swinViT.layers{1..4}.0.blocks.{0,1}``
(``norm1``, ``attn.relative_position_bias_table``, ``attn.qkv``,
``attn.proj``, ``norm2``, ``mlp.linear{1,2}``),
``swinViT.layers{1..4}.0.downsample.{norm,reduction}``, ``encoder1`` …
``encoder4``, ``encoder10``, ``decoder5`` … ``decoder1``, ``out``. MONAI's
``attn.relative_position_index`` buffer is a constant of the window
(:func:`..ops.kernels.window_attn.relative_index`) and is dropped on load.

The tokens are channels-last ``[B, D, H, W, C]``. Precision follows the
port: bf16 activations and fp32 parameters cast per layer, LayerNorm and
InstanceNorm statistics in fp32, attention scores, bias, mask and softmax
in fp32 with the bf16 product back into v. Forwards with no autograd
take B4 (``ops/kernels/window_attn.py``; CPU tensors its plain version);
training takes the plain composition. The decoder's 3³ convs run B1.
Every spatial size must be a multiple of 32 (a patch of 2, four merges):
serve it with ``--sliding_window_inference --sliding_window_size 128 128
128``. Windows, shifts and merges cross slab bounds, so it has no
Z-sharded forward.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels import window_attn as wa
from ..parallel import spatial
from ..utils.profiling import annotate
from .dynunet import UnetOutBlock
from .layers import Conv3d, InstanceNorm, Linear, from_kernel_layout, to_kernel_layout
from .unetr import MLP, UnetrBasicBlock, UnetrUpBlock, layer_norm_fp32

#: a patch of 2 and four 2× merges
SIZE_MULTIPLE = 32


def attn_route() -> bool:
    """Whether a block's attention takes B4's wrapper (CPU tensors: its
    plain version): with no autograd (``evaluate`` serves under
    ``inference_mode``). Training takes the plain composition,
    differentiable. On a card the wrapper launches B4 or raises."""
    return not torch.is_grad_enabled()


def _drop_relative_position_index(state_dict, prefix, *args) -> None:
    state_dict.pop(prefix + "relative_position_index", None)


class WindowAttention(nn.Module):
    """MONAI's ``WindowAttention``: ``qkv`` with bias, the relative position
    bias table ``[(2·7−1)³, heads]``, ``proj``."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wa.WINDOW - 1) ** 3, heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.qkv = Linear(dim, 3 * dim, bias=True)
        self.proj = Linear(dim, dim)
        self._register_load_state_dict_pre_hook(_drop_relative_position_index)


class SwinBlock(nn.Module):
    """MONAI's ``SwinTransformerBlock``: ``x + P(attn(pad(LN1(x))))`` then
    ``x + MLP(LN2(x))``; the second block of a stage shifts its windows."""

    def __init__(self, dim: int, heads: int, shifted: bool):
        super().__init__()
        self.shifted = shifted
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = MLP(dim, 4 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, w, c = x.shape
        ws, shift = wa.window_geometry((d, h, w))
        if not self.shifted:
            shift = (0, 0, 0)
        y = layer_norm_fp32(self.norm1, x)
        pads = [(-s) % k for s, k in zip((d, h, w), ws)]
        if any(pads):        # zeros after the norm: padded tokens' q, k, v are the bias
            y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        heads = self.attn.heads
        qkv = self.attn.qkv(y).view(*y.shape[:4], 3, heads, c // heads)
        table = self.attn.relative_position_bias_table
        attend = wa.window_attn if attn_route() else wa.window_attn_plain
        a = attend(qkv, table, ws, shift)
        if any(pads):
            a = a[:, :d, :h, :w]
        x = x + self.attn.proj(a)
        return x + self.mlp(layer_norm_fp32(self.norm2, x))


class PatchMerging(nn.Module):
    """MONAI's ``PatchMerging`` (v0.9's ``"merging"``): eight sub-grids
    concatenated in MONAI's order (two of them repeated, as MONAI's are),
    ``LayerNorm(8C)``, ``Linear(8C, 2C)`` without bias."""

    #: the (d, h, w) offsets of the sub-grids, in MONAI's order
    ORDER = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (0, 1, 0), (0, 0, 1),
             (1, 1, 1))

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(8 * dim, eps=1e-5)
        self.reduction = Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d, h, w = x.shape[1:4]
        if d % 2 or h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in self.ORDER], -1)
        return self.reduction(layer_norm_fp32(self.norm, x))


class BasicLayer(nn.Module):
    """A stage: a plain and a shifted block, then patch merging."""

    def __init__(self, dim: int, heads: int, depth: int = 2):
        super().__init__()
        self.blocks = nn.ModuleList([SwinBlock(dim, heads, i % 2 == 1) for i in range(depth)])
        self.downsample = PatchMerging(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return self.downsample(x)


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, patch: int = 2):
        super().__init__()
        self.proj = Conv3d(in_channels, dim, kernel_size=patch, stride=patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return to_kernel_layout(self.proj(x))


class SwinTransformer(nn.Module):
    """MONAI's ``SwinTransformer`` (``swinViT``): the patch embedding and
    four stages; ``forward`` gives the five levels, each normalised by
    ``proj_out`` (LayerNorm without affine), as NCDHW views in
    channels-last memory."""

    def __init__(self, in_channels: int, dim: int, depths: Sequence[int], heads: Sequence[int]):
        super().__init__()
        self.patch_embed = PatchEmbed(in_channels, dim)
        for i, (depth, nh) in enumerate(zip(depths, heads)):
            setattr(self, f"layers{i + 1}", nn.ModuleList([BasicLayer(dim * 2 ** i, nh, depth)]))

    @staticmethod
    def proj_out(t: torch.Tensor) -> torch.Tensor:
        return from_kernel_layout(F.layer_norm(t.float(), t.shape[-1:]).to(t.dtype))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        t = self.patch_embed(x)
        outs = [self.proj_out(t)]
        for i in range(1, 5):
            t = getattr(self, f"layers{i}")[0](t)
            outs.append(self.proj_out(t))
        return outs


class SwinUNETR(nn.Module):
    """MONAI's ``SwinUNETR`` with its UNETR decoder (instance norm without
    affine). ``forward(x, with_deep)`` returns the logits (no deep
    supervision), as ``unet_tr``'s does."""

    def __init__(self, num_classes: int = 3, feature_size: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 in_channels: int = 4):
        super().__init__()
        fs = feature_size
        norm = functools.partial(InstanceNorm, affine=False)
        self.swinViT = SwinTransformer(in_channels, fs, depths, num_heads)
        self.encoder1 = UnetrBasicBlock(in_channels, fs, norm)
        self.encoder2 = UnetrBasicBlock(fs, fs, norm)
        self.encoder3 = UnetrBasicBlock(2 * fs, 2 * fs, norm)
        self.encoder4 = UnetrBasicBlock(4 * fs, 4 * fs, norm)
        self.encoder10 = UnetrBasicBlock(16 * fs, 16 * fs, norm)
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs, norm)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs, norm)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs, norm)
        self.decoder2 = UnetrUpBlock(2 * fs, fs, norm)
        self.decoder1 = UnetrUpBlock(fs, fs, norm)
        self.out = UnetOutBlock(fs, num_classes)

    def forward(self, x: torch.Tensor, with_deep: bool = True) -> torch.Tensor:
        if spatial.active() is not None:
            raise ValueError("swin_unetr has no Z-sharded forward: its windows, their shifts "
                             "and its patch merges cross the slabs' bounds; serve it on one "
                             "rank")
        size = tuple(x.shape[2:])
        if any(s % SIZE_MULTIPLE for s in size):
            raise ValueError(f"swin_unetr needs every spatial size a multiple of "
                             f"{SIZE_MULTIPLE} (a patch of 2, four 2x merges), got {size}: "
                             f"serve it with --sliding_window_inference "
                             f"--sliding_window_size 128 128 128")
        with annotate("swin.vit"):
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
