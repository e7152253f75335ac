"""UNETR, the transformer-encoder U-Net of the model zoo (``--model
unet_tr``).

Port of ``brats21_tpu/models/unetr.py`` (MONAI UNETR as definer.py:68-83
configures it: feature size 16, ViT-B/16 — hidden 768, 12 layers, 12 heads,
MLP 3072 — perceptron patch embedding over 16³ patches). Names are MONAI
0.6.0's (``import_torch.py:515-565``): ``vit.patch_embedding``
(``patch_embeddings.1``, ``position_embeddings``), ``vit.blocks.{i}``
(``norm1``, ``attn.qkv`` without bias, ``attn.out_proj``, ``norm2``,
``mlp.linear{1,2}``), ``vit.norm``; ``encoder1.layer`` (UnetResBlock),
``encoder{2,3,4}.{transp_conv_init,blocks.j}`` (bare transposed convs),
``decoder{5..2}.{transp_conv,conv_block}``, ``out.conv``.

The computation is the JAX package's: token features ordered (x y z c); each
LayerNorm in fp32 with eps 1e-5, cast back to the activation dtype; the
fused qkv split head-major; attention scores from the activation-dtype q and
k with fp32 products and accumulation (the bf16 values are upcast, so every
product is exact), fp32 softmax, cast back before the value product; exact
(erf) GELU in the MLP; the skips tapped after blocks 4, 7 and 10. The
decoder's stride-1 3³ convs (10 a forward: 16, 32, 64 and 128 channels out)
run the hand-written conv kernel. The position embedding fixes the input
size to ``img_size`` (the train patch): serve it with sliding windows of
that size.

Z-sharded (``parallel/spatial.py``), a slab aligned at the patch holds the
tokens whose Z patch falls in it, a strided subset of the token order with
their rows of the position embedding; the attention computes the queries
of its own tokens against the keys and values of every token, gathered
over the space group in the token order. LayerNorm and the MLP are per
token, and the decoders' grids are per slab.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import spatial
from .dynunet import UnetOutBlock, _TranspConv
from .extra import Convolution
from .layers import Linear, get_norm_layer


def layer_norm_fp32(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.LayerNorm(epsilon=1e-5, dtype=float32)`` then a cast back
    to the input's dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps).to(x.dtype)


class MHSA(nn.Module):
    """MONAI SABlock (``unetr.py:31-59``): fused bias-free ``qkv``, the
    output split (qkv, head, dim), scale head_dim^-½, ``out_proj``."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.out_proj = Linear(hidden, hidden)
        self.qkv = Linear(hidden, 3 * hidden, bias=False)

    def forward(self, x: torch.Tensor,
                gather: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                ) -> torch.Tensor:
        """``gather`` (on a slab) maps this rank's ``[B, heads, n, d]``
        keys or values to every token's, in the token order."""
        b, n, c = x.shape
        h = self.heads
        d = c // h
        qkv = self.qkv(x).reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        if gather is not None:
            k, v = gather(k), gather(v)
        att = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
        att = torch.softmax(att, dim=-1).to(x.dtype)
        out = torch.matmul(att, v).permute(0, 2, 1, 3).reshape(b, n, c)
        return self.out_proj(out)


class MLP(nn.Module):
    """MONAI MLPBlock: ``linear1`` → exact GELU → ``linear2`` (JAX
    ``jax.nn.gelu(approximate=False)``, not the tanh form of
    ``layers.get_act("gelu")``)."""

    def __init__(self, hidden: int, mlp_dim: int):
        super().__init__()
        self.linear1 = Linear(hidden, mlp_dim)
        self.linear2 = Linear(mlp_dim, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.gelu(self.linear1(x), approximate="none"))


class TransformerBlock(nn.Module):
    """x + attn(norm1(x)); x + mlp(norm2(x)) (``unetr.py:62-84``)."""

    def __init__(self, hidden: int, mlp_dim: int, heads: int):
        super().__init__()
        self.mlp = MLP(hidden, mlp_dim)
        self.norm1 = nn.LayerNorm(hidden, eps=1e-5)
        self.attn = MHSA(hidden, heads)
        self.norm2 = nn.LayerNorm(hidden, eps=1e-5)

    def forward(self, x: torch.Tensor,
                gather: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                ) -> torch.Tensor:
        x = x + self.attn(layer_norm_fp32(self.norm1, x), gather)
        return x + self.mlp(layer_norm_fp32(self.norm2, x))


class PatchEmbedding(nn.Module):
    """MONAI's perceptron PatchEmbeddingBlock: ``patch_embeddings`` =
    (rearrange, Linear) and learned ``position_embeddings``
    ``[1, tokens, hidden]``."""

    def __init__(self, in_channels: int, patch: int, hidden: int, n_tokens: int):
        super().__init__()
        self.patch = patch
        self.patch_embeddings = nn.Sequential(nn.Identity(),
                                              Linear(patch ** 3 * in_channels, hidden))
        self.position_embeddings = nn.Parameter(torch.zeros(1, n_tokens, hidden))
        nn.init.normal_(self.position_embeddings, std=0.02)

    def forward(self, x: torch.Tensor, z_patches: Optional[Tuple[int, int]] = None
                ) -> torch.Tensor:
        """``z_patches`` (on a slab): (this slab's first Z patch, the
        volume's Z patches), which pick the slab's rows of the position
        embedding."""
        b, c = x.shape[:2]
        p = self.patch
        g = [s // p for s in x.shape[2:]]
        t = x.reshape(b, c, g[0], p, g[1], p, g[2], p).permute(0, 2, 4, 6, 3, 5, 7, 1)
        tokens = self.patch_embeddings(t.reshape(b, g[0] * g[1] * g[2], p ** 3 * c))
        pos = self.position_embeddings
        if z_patches is not None:
            first, total = z_patches
            rows = (torch.arange(g[0] * g[1], device=pos.device)[:, None] * total + first
                    + torch.arange(g[2], device=pos.device)).reshape(-1)
            pos = pos.index_select(1, rows)
        return tokens + pos.to(tokens.dtype)


class ViT(nn.Module):
    def __init__(self, in_channels: int, img_size: Sequence[int], patch: int, hidden: int,
                 mlp_dim: int, layers: int, heads: int):
        super().__init__()
        n = math.prod(s // patch for s in img_size)
        self.patch_embedding = PatchEmbedding(in_channels, patch, hidden, n)
        self.blocks = nn.ModuleList(
            [TransformerBlock(hidden, mlp_dim, heads) for _ in range(layers)])
        self.norm = nn.LayerNorm(hidden, eps=1e-5)


class UnetResBlock(nn.Module):
    """MONAI UnetResBlock (``unetr.py:87-113``): conv3 → norm → lrelu →
    conv3 → norm, plus a 1³ conv → norm shortcut where the channels change,
    lrelu after the sum; bias-free convs. ``norm`` is a ``--norm`` name or
    a norm's constructor."""

    def __init__(self, cin: int, ch: int, norm: Union[str, None, Callable[[int], nn.Module]]):
        super().__init__()
        ctor = norm if callable(norm) else get_norm_layer(norm)
        self.conv1 = Convolution(cin, ch, bias=False)
        self.conv2 = Convolution(ch, ch, bias=False)
        self.norm1 = ctor(ch)
        self.norm2 = ctor(ch)
        if cin != ch:
            self.conv3 = Convolution(cin, ch, 1, bias=False)
            self.norm3 = ctor(ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(self.norm1(self.conv1(x)), 0.01)
        y = self.norm2(self.conv2(y))
        res = self.norm3(self.conv3(x)) if hasattr(self, "conv3") else x
        return F.leaky_relu(y + res, 0.01)


class UnetrBasicBlock(nn.Module):
    def __init__(self, cin: int, ch: int, norm: Optional[str]):
        super().__init__()
        self.layer = UnetResBlock(cin, ch, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class UnetrPrUpBlock(nn.Module):
    """``transp_conv_init`` then ``num_layer`` bare transposed convs (MONAI's
    ``conv_block=False``)."""

    def __init__(self, cin: int, ch: int, num_layer: int):
        super().__init__()
        self.transp_conv_init = _TranspConv(cin, ch)
        self.blocks = nn.ModuleList([_TranspConv(ch, ch) for _ in range(num_layer)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.transp_conv_init(x)
        for blk in self.blocks:
            x = blk(x)
        return x


class UnetrUpBlock(nn.Module):
    def __init__(self, cin: int, ch: int, norm: Optional[str]):
        super().__init__()
        self.transp_conv = _TranspConv(cin, ch)
        self.conv_block = UnetResBlock(2 * ch, ch, norm)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=1))


class UNETR(nn.Module):
    """ViT encoder over ``patch``³ patches and the res-block convolutional
    decoder (MONAI UNETR, ``unetr.py:116-189``)."""

    def __init__(self, img_size: Sequence[int], num_classes: int = 3, feature_size: int = 16,
                 hidden_size: int = 768, mlp_dim: int = 3072, num_heads: int = 12,
                 num_layers: int = 12, patch: int = 16, norm: Optional[str] = "instance",
                 in_channels: int = 4):
        super().__init__()
        self.img_size = tuple(int(s) for s in img_size)
        self.patch, self.hidden = patch, hidden_size
        #: Z-sharded, the slabs are cut at multiples of the patch
        self.spatial_factor = patch
        fs = feature_size
        self.vit = ViT(in_channels, self.img_size, patch, hidden_size, mlp_dim, num_layers,
                       num_heads)
        self.encoder1 = UnetrBasicBlock(in_channels, fs, norm)
        self.encoder2 = UnetrPrUpBlock(hidden_size, fs * 2, 2)
        self.encoder3 = UnetrPrUpBlock(hidden_size, fs * 4, 1)
        self.encoder4 = UnetrPrUpBlock(hidden_size, fs * 8, 0)
        self.decoder5 = UnetrUpBlock(hidden_size, fs * 8, norm)
        self.decoder4 = UnetrUpBlock(fs * 8, fs * 4, norm)
        self.decoder3 = UnetrUpBlock(fs * 4, fs * 2, norm)
        self.decoder2 = UnetrUpBlock(fs * 2, fs, norm)
        self.out = UnetOutBlock(fs, num_classes)

    def _grid(self, t: torch.Tensor, grid: Tuple[int, ...]) -> torch.Tensor:
        """Tokens ``[B, n, hidden]`` → an NCDHW feature map."""
        return t.reshape(t.shape[0], *grid, self.hidden).permute(0, 4, 1, 2, 3)

    def forward(self, x: torch.Tensor, with_deep: bool = True) -> torch.Tensor:
        p = self.patch
        size = tuple(x.shape[2:])
        slab = spatial.active()
        if slab is not None:                   # the whole volume's Z
            start, sizes = slab.level(x)
            size = (*size[:2], sum(sizes))
        if any(s % p for s in size) or math.prod(
                s // p for s in size) != math.prod(s // p for s in self.img_size):
            raise ValueError(f"unet_tr takes inputs of its img_size {self.img_size} (its "
                             f"position embedding fixes the tokens), got {size}: "
                             f"serve it with --sliding_window_inference --sliding_window_size "
                             f"{' '.join(map(str, self.img_size))}")
        grid = tuple(s // p for s in x.shape[2:])
        vit = self.vit
        gather = None
        if slab is None:
            tokens = vit.patch_embedding(x)
        else:
            tokens = vit.patch_embedding(x, (start // p, size[2] // p))
            gather = self._token_gather(slab, grid, [s // p for s in sizes])
        taps = []
        for i, blk in enumerate(vit.blocks):
            tokens = blk(tokens, gather)
            if i in (3, 6, 9):
                taps.append(tokens)
        tokens = layer_norm_fp32(vit.norm, tokens)
        enc1 = self.encoder1(x)
        enc2 = self.encoder2(self._grid(taps[0], grid))
        enc3 = self.encoder3(self._grid(taps[1], grid))
        enc4 = self.encoder4(self._grid(taps[2], grid))
        d = self.decoder5(self._grid(tokens, grid), enc4)
        d = self.decoder4(d, enc3)
        d = self.decoder3(d, enc2)
        d = self.decoder2(d, enc1)
        return self.out(d)

    @staticmethod
    def _token_gather(slab: "spatial.Slab", grid: Tuple[int, ...],
                      z_patches: Sequence[int]) -> Callable[[torch.Tensor], torch.Tensor]:
        """Every rank's ``[B, heads, tokens, d]`` (its ``z_patches`` of each
        (g0, g1) row) gathered over the space group into the token order."""
        def gather(t: torch.Tensor) -> torch.Tensor:
            b, h, _, d = t.shape
            rows = t.reshape(b, h, grid[0], grid[1], grid[2], d)
            return spatial.gather_planes(rows, slab.group, 4, z_patches).reshape(b, h, -1, d)
        return gather
