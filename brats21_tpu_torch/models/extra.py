"""The MONAI-backed members of the model zoo: BasicUNet, SegResNet(+VAE),
HighResNet and VNet.

Port of ``brats21_tpu/models/extra.py`` (the reference builds them from
``monai.networks.nets``, definer.py:49-127). Attribute names and Sequential
indices follow MONAI 0.6.0's module graphs, so ``state_dict()`` keys equal a
reference ``best_model.pth``'s (the JAX importer's rules,
``brats21_tpu/utils/import_torch.py:281-512``): a MONAI ``Convolution`` is
:class:`Convolution` (children ``conv`` and, with a norm, ``adn.N``),
SegResNet's blocks sit in ``down_layers``/``up_samples``/``up_layers``,
HighResNet's in one positional ``blocks`` Sequential, VNet's in its
transitions. The computation is the JAX package's: every 3×3×3 conv with
stride 1 and dilation 1 runs the hand-written conv kernel
(:class:`Conv3d`), narrow ones included; strided, dilated, 1³, 2³ and 5³
convs run ``F.conv3d``; transposed convs ``F.conv_transpose3d``.

Stochastic layers follow the JAX train step, not ``model.train()``: they
draw only inside :class:`~.layers.stochastic` with a generator, which the
train step opens when ``model_uses_rng`` holds (``train_state.py:55-59``).
So under ``--dropout 0`` VNet's fixed 0.5 skip dropout is off in training,
as in the JAX package (MONAI applies it in every training forward: ROADMAP
C8).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (Act, BatchNorm, Conv3d, ConvTranspose3d, Dropout, GroupNorm,
                     InstanceNorm, Upsample, get_act, get_norm_layer,
                     kaiming_normal_fan_out, max_pool3d, to_kernel_layout)


def _conv(cin: int, cout: int, k: int = 3, **kw) -> Conv3d:
    """A conv with the JAX package's default init (kaiming normal, fan out;
    zero bias)."""
    return Conv3d(cin, cout, k, kernel_init=kaiming_normal_fan_out, **kw)


def norm_or_identity(norm: Optional[str], ch: int) -> nn.Module:
    """The ``--norm`` layer, or an Identity that keeps a Sequential's
    indices where there is none."""
    ctor = get_norm_layer(norm)
    return ctor(ch) if ctor is not None else nn.Identity()


def fill_affine_less_norms(module: nn.Module, state_dict: Dict[str, torch.Tensor],
                           prefix: str, *args) -> None:
    """Load pre-hook: MONAI's plain-string ``norm="instance"`` builds
    ``nn.InstanceNorm3d(affine=False)``, whose checkpoints carry no norm
    tensors; an instance norm of ``module`` with neither ``weight`` nor
    ``bias`` in ``state_dict`` loads the identity affine (the JAX importer's
    ``opt_vec`` rule, ``import_torch.py:684-693``)."""
    for name, m in module.named_modules():
        if not isinstance(m, InstanceNorm):
            continue
        key = f"{prefix}{name}." if name else prefix
        if key + "weight" not in state_dict and key + "bias" not in state_dict:
            state_dict[key + "weight"] = torch.ones_like(m.weight)
            state_dict[key + "bias"] = torch.zeros_like(m.bias)


class ADN(nn.Module):
    """MONAI's ADN as the JAX package orders it: norm (child ``N``) → act
    → dropout."""

    def __init__(self, ch: int, norm: Optional[str], act: Optional[str],
                 dropout: float = 0.0, channel_wise: bool = False):
        super().__init__()
        ctor = get_norm_layer(norm)
        self.N = ctor(ch) if ctor is not None else nn.Identity()
        self.act = act
        self.D = Dropout(dropout, channel_wise)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.N(x)
        if self.act is not None:
            x = get_act(self.act)(x)
        return self.D(x)


class Convolution(nn.Module):
    """MONAI ``blocks.Convolution``: ``conv`` and, unless conv-only,
    ``adn``."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 bias: bool = True, adn: Optional[ADN] = None, padding: Optional[int] = None):
        super().__init__()
        self.conv = _conv(cin, cout, k, stride=stride, use_bias=bias, padding=padding)
        self.adn = adn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return self.adn(x) if self.adn is not None else x


# ---------------------------------------------------------------------------
# BasicUNet (monai.networks.nets.BasicUNet; definer.py:49-60)
# ---------------------------------------------------------------------------

class TwoConv(nn.Module):
    """(conv3 → norm → act → element-wise dropout) ×2 (MONAI TwoConv,
    ``extra.py:27-45``)."""

    def __init__(self, cin: int, cout: int, norm: Optional[str], act: str,
                 dropout: float = 0.0):
        super().__init__()
        self.conv_0 = Convolution(cin, cout, adn=ADN(cout, norm, act, dropout))
        self.conv_1 = Convolution(cout, cout, adn=ADN(cout, norm, act, dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_1(self.conv_0(x))


class _Down(nn.Module):
    def __init__(self, cin: int, cout: int, norm: Optional[str], act: str, dropout: float):
        super().__init__()
        self.convs = TwoConv(cin, cout, norm, act, dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convs(max_pool3d(x))


class _UpCat(nn.Module):
    """2³/s2 transposed conv (``upsample.deconv``), concat after the skip,
    TwoConv (``convs``)."""

    def __init__(self, cin: int, cat_ch: int, up_ch: int, cout: int,
                 norm: Optional[str], act: str, dropout: float):
        super().__init__()
        self.upsample = nn.Sequential()
        self.upsample.add_module("deconv", ConvTranspose3d(cin, up_ch))
        self.convs = TwoConv(cat_ch + up_ch, cout, norm, act, dropout)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.convs(torch.cat([skip, self.upsample(x)], dim=1))


class BasicUNet(nn.Module):
    """4-down/4-up U-Net with an extra final width (MONAI BasicUNet,
    ``extra.py:48-88``): ``features`` = [f0..f4, f_final]; ``upcat_1``
    keeps f1 channels out of its deconv (MONAI's ``halves=False``)."""

    def __init__(self, features: Sequence[int], num_classes: int = 3,
                 act: str = "leakyrelu", norm: Optional[str] = "instance",
                 dropout: float = 0.0, in_channels: int = 4):
        super().__init__()
        f = list(features)
        a = (norm, act, dropout)
        self.conv_0 = TwoConv(in_channels, f[0], *a)
        self.down_1 = _Down(f[0], f[1], *a)
        self.down_2 = _Down(f[1], f[2], *a)
        self.down_3 = _Down(f[2], f[3], *a)
        self.down_4 = _Down(f[3], f[4], *a)
        self.upcat_4 = _UpCat(f[4], f[3], f[3], f[3], *a)
        self.upcat_3 = _UpCat(f[3], f[2], f[2], f[2], *a)
        self.upcat_2 = _UpCat(f[2], f[1], f[1], f[1], *a)
        self.upcat_1 = _UpCat(f[1], f[0], f[1], f[5], *a)
        self.final_conv = _conv(f[5], num_classes, 1)
        self._register_load_state_dict_pre_hook(fill_affine_less_norms, with_module=True)

    def forward(self, x: torch.Tensor, with_deep: bool = True) -> torch.Tensor:
        x0 = self.conv_0(x)
        x1 = self.down_1(x0)
        x2 = self.down_2(x1)
        x3 = self.down_3(x2)
        x4 = self.down_4(x3)
        u = self.upcat_4(x4, x3)
        u = self.upcat_3(u, x2)
        u = self.upcat_2(u, x1)
        u = self.upcat_1(u, x0)
        return self.final_conv(u)


# ---------------------------------------------------------------------------
# SegResNet / SegResNetVAE (definer.py:85-110)
# ---------------------------------------------------------------------------

class ResBlock(nn.Module):
    """GroupNorm → relu → conv3 (no bias) ×2 with the residual (MONAI
    SegResNet ResBlock, ``extra.py:96-111``)."""

    def __init__(self, ch: int, norm_groups: int = 8):
        super().__init__()
        self.norm1 = GroupNorm(ch, norm_groups)
        self.conv1 = Convolution(ch, ch, bias=False)
        self.norm2 = GroupNorm(ch, norm_groups)
        self.conv2 = Convolution(ch, ch, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return x + y


def _segres_decoder(f: int, levels: int,
                    blocks_up: Sequence[int]) -> Tuple[nn.ModuleList, nn.ModuleList]:
    """SegResNet's decoder stages: ``up_samples.{i}`` = (conv1³, trilinear
    ×2 with ``align_corners=False``), ``up_layers.{i}`` = ResBlocks."""
    up_samples, up_layers = nn.ModuleList(), nn.ModuleList()
    for i, n in enumerate(blocks_up):
        ch = f * 2 ** (levels - i - 2)
        up_samples.append(nn.Sequential(Convolution(2 * ch, ch, 1, bias=False),
                                        Upsample(2, align_corners=False)))
        up_layers.append(nn.Sequential(*[ResBlock(ch) for _ in range(n)]))
    return up_samples, up_layers


class SegResNet(nn.Module):
    """Encoder of (1, 2, 2, 4) ResBlocks with strided-conv downs, decoder of
    (1, 1, 1) with 1³ conv + trilinear up (MONAI SegResNet defaults,
    ``extra.py:114-149``). The JAX package's ``norm`` is unused: every norm
    is GroupNorm(8)."""

    def __init__(self, init_filters: int = 8, num_classes: int = 3, dropout: float = 0.0,
                 norm: str = "group", blocks_down: Sequence[int] = (1, 2, 2, 4),
                 blocks_up: Sequence[int] = (1, 1, 1), in_channels: int = 4):
        super().__init__()
        f = init_filters
        self.blocks_down = tuple(blocks_down)
        self.convInit = Convolution(in_channels, f, bias=False)
        self.dropout = Dropout(dropout, channel_wise=True)
        self.down_layers = nn.ModuleList()
        for i, n in enumerate(blocks_down):
            ch = f * 2 ** i
            pre = Convolution(ch // 2, ch, stride=2, bias=False) if i else nn.Identity()
            self.down_layers.append(nn.Sequential(pre, *[ResBlock(ch) for _ in range(n)]))
        self.up_samples, self.up_layers = _segres_decoder(f, len(blocks_down), blocks_up)
        self.conv_final = nn.Sequential(GroupNorm(f, 8), nn.ReLU(),
                                        Convolution(f, num_classes, 1, bias=True))

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        x = self.dropout(self.convInit(x))
        skips = []
        for down in self.down_layers:
            x = down(x)
            skips.append(x)
        return x, skips

    def decode(self, x: torch.Tensor, skips: List[torch.Tensor]) -> torch.Tensor:
        for i, (up, layer) in enumerate(zip(self.up_samples, self.up_layers)):
            x = layer(up(x) + skips[len(self.blocks_down) - i - 2])
        return self.conv_final(x)

    def forward(self, x: torch.Tensor, with_deep: bool = True) -> torch.Tensor:
        return self.decode(*self.encode(x))


class SegResNetVAE(SegResNet):
    """SegResNet + the VAE regularisation branch (MONAI SegResNetVAE,
    ``extra.py:152-233``), returning ``(seg, {"vae_loss": scalar})``: the
    training loss adds the scalar after the criterion's mean
    (:func:`~brats21_tpu_torch.learning.losses.deep_supervision_loss`).

    As in the JAX package, the branch runs on the bottom features at
    every call: the latent is flattened in channels-last order (D, H, W, C),
    ``z = μ + σ·ε`` while a generator is set in training
    (:class:`~.layers.stochastic`), else ``z = μ``; the VAE's Linear layers
    and everything after them run in fp32 (flax's Dense promotes the bf16
    input to its fp32 parameters). Its decoder has weights of its own
    (``vae_up_samples``/``vae_up_layers``); MONAI shares them with the
    segmentation decoder, so a reference checkpoint, which has only the
    shared ones, fills both (the JAX importer's rule,
    ``import_torch.py:357-364``). ``forward(x, with_deep=False)`` returns
    the segmentation alone and skips the branch, after checking the input
    size the branch's Linear layers fix (``input_image_size``), where the
    JAX model's Dense would raise."""

    #: its outputs carry ``vae_loss``, a leaf without the batch axis: the
    #: engine's case-parallel evaluation takes the serial path for it
    unbatched_outputs = True

    def __init__(self, input_image_size: Sequence[int], init_filters: int = 8,
                 num_classes: int = 3, dropout: float = 0.0, vae_nz: int = 256,
                 in_channels: int = 4):
        super().__init__(init_filters, num_classes, dropout, in_channels=in_channels)
        f = init_filters
        self.input_image_size = tuple(int(s) for s in input_image_size)
        self.generator: Optional[torch.Generator] = None
        self.deterministic = False
        smallest = 16
        self.latent_shape = tuple(s // 16 for s in self.input_image_size)
        total = smallest * self.latent_shape[0] * self.latent_shape[1] * self.latent_shape[2]
        self.vae_down = nn.Sequential(GroupNorm(f * 8, 8), nn.ReLU(),
                                      Convolution(f * 8, smallest, stride=2, bias=True),
                                      GroupNorm(smallest, 8), nn.ReLU())
        self.vae_fc1 = nn.Linear(total, vae_nz)
        self.vae_fc2 = nn.Linear(total, vae_nz)
        self.vae_fc3 = nn.Linear(vae_nz, total)
        self.vae_fc_up_sample = nn.Sequential(
            Convolution(smallest, f * 8, 1, bias=False), Upsample(2, align_corners=False),
            GroupNorm(f * 8, 8), nn.ReLU())
        self.vae_up_samples, self.vae_up_layers = _segres_decoder(f, 4, (1, 1, 1))
        self.vae_conv_final = nn.Sequential(GroupNorm(f, 8), nn.ReLU(),
                                            Convolution(f, in_channels, 1, bias=True))
        self._register_load_state_dict_pre_hook(self._fill_vae_decoder)

    @staticmethod
    def _fill_vae_decoder(state_dict, prefix, *args) -> None:
        """A reference checkpoint's shared decoder fills the VAE's."""
        shared = (prefix + "up_samples.", prefix + "up_layers.")
        for key in [k for k in state_dict if k.startswith(shared)]:
            state_dict.setdefault(prefix + "vae_" + key[len(prefix):], state_dict[key])

    def _check_size(self, x: torch.Tensor) -> None:
        if tuple(x.shape[2:]) != self.input_image_size:
            raise ValueError(
                f"segresnetvae takes inputs of its input_image_size "
                f"{self.input_image_size} (the VAE's Linear layers fix it), got "
                f"{tuple(x.shape[2:])}: serve it with --sliding_window_inference "
                f"--sliding_window_size {' '.join(map(str, self.input_image_size))}")

    def forward(self, x: torch.Tensor, with_deep: bool = True):
        self._check_size(x)
        bottom, skips = self.encode(x)
        seg = self.decode(bottom, skips)
        if not with_deep:
            return seg
        return seg, {"vae_loss": self.vae_loss(x, bottom)}

    def vae_loss(self, xin: torch.Tensor, bottom: torch.Tensor) -> torch.Tensor:
        v = self.vae_down(bottom)
        flat = to_kernel_layout(v).reshape(v.shape[0], -1).float()
        mu = self.vae_fc1(flat)
        sigma = F.softplus(self.vae_fc2(flat))
        if self.training and not self.deterministic:
            eps = torch.randn(mu.shape, generator=self.generator, device=mu.device)
            z = mu + sigma * eps
        else:
            z = mu
        d = F.relu(self.vae_fc3(z))
        b, c = v.shape[:2]
        d = d.reshape(b, *v.shape[2:], c).permute(0, 4, 1, 2, 3)
        d = self.vae_fc_up_sample(d)
        for up, layer in zip(self.vae_up_samples, self.vae_up_layers):
            d = layer(up(d))
        recon = self.vae_conv_final(d)
        return (torch.mean((recon - xin) ** 2)
                + 0.5 * torch.mean(mu ** 2 + sigma ** 2 - torch.log(sigma ** 2 + 1e-8) - 1)
                ).float()


# ---------------------------------------------------------------------------
# HighResNet (definer.py:111-119)
# ---------------------------------------------------------------------------

class _ConvNormActi(nn.Module):
    """MONAI ConvNormActi: a positional ``layers`` Sequential [conv, norm,
    act (, dropout)]; a missing norm keeps its index as an Identity."""

    def __init__(self, cin: int, cout: int, k: int, norm: Optional[str] = None,
                 act: Optional[str] = None, dropout: float = 0.0, with_norm: bool = True):
        super().__init__()
        mods: List[nn.Module] = [_conv(cin, cout, k)]
        if with_norm:
            mods.append(norm_or_identity(norm, cout))
        if act is not None:
            mods.append(Act(act))
        if dropout:
            mods.append(Dropout(dropout, channel_wise=True))
        self.layers = nn.Sequential(*mods)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


class HighResBlock(nn.Module):
    """(norm → act → dilated conv3) ×2 with a channel-padded residual
    (MONAI HighResBlock, ``extra.py:241-273``): ``layers`` = [norm, act,
    conv, norm, act, conv]; the pad splits (out−in)//2 before, the rest
    after. Dilation 1 runs the conv kernel, dilations 2 and 4
    ``F.conv3d``."""

    def __init__(self, cin: int, ch: int, dilation: int, norm: Optional[str], act: str):
        super().__init__()
        mods: List[nn.Module] = []
        c = cin
        for _ in range(2):
            mods += [norm_or_identity(norm, c), Act(act), _conv(c, ch, 3, dilation=dilation)]
            c = ch
        self.layers = nn.Sequential(*mods)
        self.grow = ch - cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.layers(x)
        if self.grow:
            x = F.pad(x, (0, 0, 0, 0, 0, 0, self.grow // 2, self.grow - self.grow // 2))
        return x + y


class HighResNet(nn.Module):
    """Dilated residual network (MONAI HighResNet defaults: three groups of
    three blocks at dilations 1/2/4, widths 16/32/64; ``extra.py:276-310``),
    one ``blocks`` Sequential: ConvNormActi, 9 HighResBlocks,
    ConvNormActi(80, 1³, channel-wise dropout) and a bare 1³ conv."""

    def __init__(self, num_classes: int = 3, act: str = "relu", norm: Optional[str] = "batch",
                 dropout: float = 0.0, in_channels: int = 4):
        super().__init__()
        blocks: List[nn.Module] = [_ConvNormActi(in_channels, 16, 3, norm, act)]
        c = 16
        for ch, dil in ((16, 1), (32, 2), (64, 4)):
            for _ in range(3):
                blocks.append(HighResBlock(c, ch, dil, norm, act))
                c = ch
        blocks.append(_ConvNormActi(64, 80, 1, norm, act, dropout))
        blocks.append(_ConvNormActi(80, num_classes, 1, with_norm=False))
        self.blocks = nn.Sequential(*blocks)
        if norm == "instance":
            self._register_load_state_dict_pre_hook(fill_affine_less_norms,
                                                    with_module=True)

    def forward(self, x: torch.Tensor, with_deep: bool = True) -> torch.Tensor:
        return self.blocks(x)


# ---------------------------------------------------------------------------
# VNet (definer.py:120-127)
# ---------------------------------------------------------------------------

class _LUConv(nn.Module):
    """5³ conv (bias) → BatchNorm (``conv_block.adn.N``) → act."""

    def __init__(self, ch: int, act: str):
        super().__init__()
        self.conv_block = Convolution(ch, ch, 5, adn=ADN(ch, "batch", None), padding=2)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return get_act(self.act)(self.conv_block(x))


class _InputTransition(nn.Module):
    def __init__(self, cin: int, act: str):
        super().__init__()
        self.conv_block = Convolution(cin, 16, 5, adn=ADN(16, "batch", None), padding=2)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv_block(x)
        return get_act(self.act)(out + x.repeat(1, 16 // x.shape[1], 1, 1, 1))


class _DownTransition(nn.Module):
    """2³/s2 conv → BN → act, channel-wise dropout, LUConv chain, residual,
    act (MONAI DownTransition)."""

    def __init__(self, cin: int, nconvs: int, act: str, dropout: float = 0.0):
        super().__init__()
        out = 2 * cin
        self.down_conv = _conv(cin, out, 2, stride=2, padding=0)
        self.bn1 = BatchNorm(out)
        self.dropout = Dropout(dropout, channel_wise=True)
        self.ops = nn.Sequential(*[_LUConv(out, act) for _ in range(nconvs)])
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        down = get_act(self.act)(self.bn1(self.down_conv(x)))
        return get_act(self.act)(self.ops(self.dropout(down)) + down)


class _UpTransition(nn.Module):
    """Channel-wise dropout of the input, the fixed 0.5 dropout of the skip,
    2³/s2 transposed conv → BN → act, concat, LUConv chain, residual, act
    (MONAI UpTransition)."""

    def __init__(self, cin: int, cout: int, nconvs: int, act: str, dropout: float = 0.0):
        super().__init__()
        self.up_conv = ConvTranspose3d(cin, cout // 2)
        self.bn1 = BatchNorm(cout // 2)
        self.dropout = Dropout(dropout, channel_wise=True)
        self.dropout2 = Dropout(0.5, channel_wise=True)
        self.ops = nn.Sequential(*[_LUConv(cout, act) for _ in range(nconvs)])
        self.act = act

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        skip = self.dropout2(skip)
        up = get_act(self.act)(self.bn1(self.up_conv(self.dropout(x))))
        xcat = torch.cat([up, skip], dim=1)
        return get_act(self.act)(self.ops(xcat) + xcat)


class _OutputTransition(nn.Module):
    def __init__(self, cin: int, num_classes: int, act: str):
        super().__init__()
        self.conv_block = Convolution(cin, num_classes, 5, adn=ADN(num_classes, "batch", None),
                                      padding=2)
        self.conv2 = _conv(num_classes, num_classes, 1)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(get_act(self.act)(self.conv_block(x)))


class VNet(nn.Module):
    """V-Net in MONAI's layout (``extra.py:390-436``): ``in_tr``,
    ``down_tr{32,64,128,256}`` (1, 2, 3, 2 LUConvs), ``up_tr{256,128,64,32}``
    (2, 2, 1, 1), ``out_tr``; BatchNorm with running statistics throughout
    (so everything after the first runs in fp32, ROADMAP C6), dropout on the
    two deepest down and up transitions, and the fixed 0.5 skip dropout.
    No 3³ conv: the conv kernel is not on its path."""

    def __init__(self, num_classes: int = 3, act: str = "elu", dropout: float = 0.0,
                 in_channels: int = 4):
        super().__init__()
        self.in_tr = _InputTransition(in_channels, act)
        self.down_tr32 = _DownTransition(16, 1, act)
        self.down_tr64 = _DownTransition(32, 2, act)
        self.down_tr128 = _DownTransition(64, 3, act, dropout)
        self.down_tr256 = _DownTransition(128, 2, act, dropout)
        self.up_tr256 = _UpTransition(256, 256, 2, act, dropout)
        self.up_tr128 = _UpTransition(256, 128, 2, act, dropout)
        self.up_tr64 = _UpTransition(128, 64, 1, act)
        self.up_tr32 = _UpTransition(64, 32, 1, act)
        self.out_tr = _OutputTransition(32, num_classes, act)

    def forward(self, x: torch.Tensor, with_deep: bool = True) -> torch.Tensor:
        y16 = self.in_tr(x)
        d32 = self.down_tr32(y16)
        d64 = self.down_tr64(d32)
        d128 = self.down_tr128(d64)
        d256 = self.down_tr256(d128)
        u = self.up_tr256(d256, d128)
        u = self.up_tr128(u, d64)
        u = self.up_tr64(u, d32)
        u = self.up_tr32(u, y16)
        return self.out_tr(u)

