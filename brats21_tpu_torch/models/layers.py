"""Core 3D layers, norms, activations and resizes: NCDHW modules whose
activations live in ``torch.channels_last_3d`` memory (physically the JAX
package's ``[B, D, H, W, C]``).

Port of ``brats21_tpu/models/layers.py`` (reference networks/factory.py
and equiunet2020.py). Precision follows the JAX package's explicit casts
rather than autocast: parameters stay fp32 and each layer casts its
weights to the activation dtype (``layers.py:266,269``); GroupNorm,
InstanceNorm and BCNorm compute in fp32 and return the input's dtype,
while BatchNorm returns fp32, as flax's ``nn.BatchNorm(dtype=float32)``
does (``layers.py:155-158``), so everything after a BatchNorm runs in
fp32. Parameter and buffer names are torch's (``weight``/``bias``,
``running_mean``/``running_var``), so reference checkpoints load with a
plain ``load_state_dict``.

Under ``parallel/spatial.py``'s slab context (a volume sharded on W over a
space group) the convolutions, GroupNorm, InstanceNorm, the pools and the
resizes take their sharded forms; BatchNorm in eval normalises by its
running statistics and stays local.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.conv3d import Conv3x3x3Function, conv3x3x3
from ..parallel import spatial
from ..parallel.mesh import batch_sharded, batch_sum


def to_kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """NCDHW → the kernels' contiguous ``[B, D, H, W, C]``; free for a
    channels_last_3d tensor, a copy otherwise."""
    y = x.permute(0, 2, 3, 4, 1)
    return y if y.is_contiguous() else y.contiguous()


def from_kernel_layout(y: torch.Tensor) -> torch.Tensor:
    """``[B, D, H, W, C]`` → an NCDHW view in channels_last_3d memory."""
    return y.permute(0, 4, 1, 2, 3)


# ---------------------------------------------------------------------------
# Initializers (reference factory.py:203-224), in place on a torch tensor
# ---------------------------------------------------------------------------

def kaiming_normal_fan_out(w: torch.Tensor) -> torch.Tensor:
    """torch ``kaiming_normal_(a=0, mode='fan_out')`` (factory.py:212):
    std = sqrt(2 / fan_out), fan_out = C_out · prod(kernel)."""
    return nn.init.kaiming_normal_(w, a=0, mode="fan_out", nonlinearity="relu")


def torch_default_conv(w: torch.Tensor) -> torch.Tensor:
    """torch's default conv init, kaiming_uniform with a = sqrt(5): variance
    1 / (3 · fan_in), uniform."""
    return nn.init.kaiming_uniform_(w, a=math.sqrt(5))


def init_by_name(name: str, gain: float = 0.02) -> Callable[[torch.Tensor], torch.Tensor]:
    """The reference's init registry (factory.py:203-224)."""
    if name == "normal":
        return partial(nn.init.normal_, mean=0.0, std=gain)
    if name == "xavier":
        return nn.init.xavier_normal_
    if name == "kaiming":
        return kaiming_normal_fan_out
    if name == "orthogonal":
        return partial(nn.init.orthogonal_, gain=gain)
    if name == "torch_default":
        return torch_default_conv
    raise NotImplementedError(f"initialization method [{name}] is not implemented")


# ---------------------------------------------------------------------------
# Activations (reference factory.py:195-200, MONAI Act registry)
# ---------------------------------------------------------------------------

_ACTS: dict = {
    "relu": F.relu,
    "leakyrelu": partial(F.leaky_relu, negative_slope=0.01),
    "elu": F.elu,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": partial(F.gelu, approximate="tanh"),
    "swish": F.silu,
    "silu": F.silu,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softmax": partial(torch.softmax, dim=1),     # the channel axis
    "prelu": partial(F.leaky_relu, negative_slope=0.25),  # torch PReLU's init, fixed
}


def get_act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    key = name.lower()
    if key not in _ACTS:
        raise ValueError(f"unknown activation {name!r}; choices: {sorted(_ACTS)}")
    return _ACTS[key]


class Act(nn.Module):
    """An activation of :data:`_ACTS` as a parameter-free module (the
    reference's Sequentials hold them between their convs and norms)."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name
        self.fn = get_act(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


# ---------------------------------------------------------------------------
# Norms (reference factory.py:125-192)
# ---------------------------------------------------------------------------

def _per_channel(t: torch.Tensor) -> torch.Tensor:
    """A ``[C]`` vector broadcast over ``[B, D, H, W, C]``."""
    return t.reshape(1, 1, 1, 1, -1)


class GroupNorm(nn.Module):
    """GroupNorm with torch semantics (factory.py:182): ``min(groups, C)``
    groups, biased variance, eps 1e-5, affine ``weight``/``bias``; fp32
    inside, the input's dtype out (``layers.py:88-115``)."""

    def __init__(self, num_features: int, num_groups: int = 8, eps: float = 1e-5):
        super().__init__()
        self.groups = min(num_groups, num_features)
        if num_features % self.groups:
            raise ValueError(f"channels {num_features} not divisible by groups {self.groups}")
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = to_kernel_layout(x).float()
        b, c = xf.shape[0], xf.shape[-1]
        g = xf.reshape(b, -1, self.groups, c // self.groups)
        slab = spatial.active()
        if slab is None:
            mean = g.mean(dim=(1, 3), keepdim=True)
            var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
        else:
            n, mean, m2 = spatial.group_moments(g, slab).unbind(-1)
            mean, var = mean.float()[:, None, :, None], (m2 / n).float()[:, None, :, None]
        g = (g - mean) * torch.rsqrt(var + self.eps)
        y = g.reshape(xf.shape) * _per_channel(self.weight) + _per_channel(self.bias)
        return from_kernel_layout(y.to(x.dtype))


class InstanceNorm(nn.Module):
    """InstanceNorm3d with affine (factory.py:188): per sample and channel
    over the spatial axes, biased variance, eps 1e-5; fp32 inside, the
    input's dtype out (``layers.py:118-135``)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = to_kernel_layout(x).float()
        slab = spatial.active()
        if slab is None:
            mean = xf.mean(dim=(1, 2, 3), keepdim=True)
            var = (xf - mean).square().mean(dim=(1, 2, 3), keepdim=True)
        else:
            b, c = xf.shape[0], xf.shape[-1]
            n, mean, m2 = spatial.group_moments(xf.reshape(b, -1, c, 1), slab).unbind(-1)
            mean, var = (t.float().reshape(b, 1, 1, 1, c) for t in (mean, m2 / n))
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * _per_channel(self.weight) + _per_channel(self.bias)
        return from_kernel_layout(y.to(x.dtype))


class BatchNorm(nn.BatchNorm3d):
    """BatchNorm3d as the JAX package runs it (``layers.py:138-158``, flax
    ``nn.BatchNorm(momentum=0.9, dtype=float32)``), with nn.BatchNorm3d's
    parameters and buffers so reference checkpoints load:

    - training mode normalises by the batch statistics over (B, D, H, W),
      the variance E[x²] − E[x]² clipped at 0 (flax's fast variance), and
      moves the running statistics by ``r ← 0.9·r + 0.1·s`` with the
      **biased** batch variance (nn.BatchNorm3d would take the unbiased);
    - eval mode, and a ``frozen`` norm in either mode (the unet family's
      attention gates, which the JAX package always calls with
      ``use_running_average=True``), normalise by the running statistics
      and leave them as they are;
    - the output is fp32 whatever the input's dtype."""

    def __init__(self, num_features: int, eps: float = 1e-5, frozen: bool = False):
        super().__init__(num_features, eps=eps, momentum=0.1)
        self.frozen = frozen

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = to_kernel_layout(x).float()
        if self.training and not self.frozen:
            if batch_sharded():
                mean, var = self._global_statistics(xf)
            else:
                mean = xf.mean(dim=(0, 1, 2, 3))
                var = torch.clamp(xf.square().mean(dim=(0, 1, 2, 3)) - mean.square(),
                                  min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - _per_channel(mean)) * _per_channel(mul) + _per_channel(self.bias)
        return from_kernel_layout(y)

    @staticmethod
    def _global_statistics(xf: torch.Tensor):
        """Mean and variance over the global batch of a data-parallel step
        (``parallel/mesh.py:batch_group``): the slices' sums of x and x²
        and their element counts, all-reduced in one call."""
        sums = torch.stack([xf.sum(dim=(0, 1, 2, 3)), xf.square().sum(dim=(0, 1, 2, 3)),
                            torch.full_like(xf[0, 0, 0, 0], xf[..., 0].numel())])
        s1, s2, n = batch_sum(sums).unbind(0)
        mean = s1 / n
        return mean, torch.clamp(s2 / n - mean.square(), min=0.0)


class EstBN(nn.Module):
    """The reference's EstBN with its zero-initialised moving speed
    (factory.py:149-176): its running statistics never move from mean 0,
    variance 1, so it is ``x / sqrt(1 + 1e-5) · weight + bias``."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, xf: torch.Tensor) -> torch.Tensor:
        c = xf.shape[1]
        return (xf / math.sqrt(1.0 + 1e-5) * self.weight.reshape(1, c, 1, 1, 1)
                + self.bias.reshape(1, c, 1, 1, 1))


class BCNorm(nn.Module):
    """Batch-channel norm (factory.py:125-146, ``layers.py:161-194``):
    :class:`EstBN`, then standardisation over ``(1, B·groups, −1)`` of the
    NCDHW element order with ``(1, groups, 1)`` affines; fp32 inside, the
    input's dtype out.

    Keys (the JAX package has no import rule for it): ``bn.weight`` and
    ``bn.bias`` ``[C]`` (EstBN's affine), ``weight`` and ``bias``
    ``(1, groups, 1)``."""

    def __init__(self, num_features: int, num_groups: int = 8, eps: float = 1e-5):
        super().__init__()
        self.groups = num_groups
        self.eps = eps
        self.bn = EstBN(num_features)
        self.weight = nn.Parameter(torch.ones(1, num_groups, 1))
        self.bias = nn.Parameter(torch.zeros(1, num_groups, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn(x.float()).contiguous()          # NCDHW element order
        n, g = out.shape[0], self.groups
        flat = out.reshape(1, n * g, -1)
        mean = flat.mean(dim=-1, keepdim=True)
        var = (flat - mean).square().mean(dim=-1, keepdim=True)
        flat = (flat - mean) * torch.rsqrt(var + self.eps)
        flat = flat.reshape(n, g, -1) * self.weight + self.bias
        y = flat.reshape(out.shape).to(x.dtype)
        return y.contiguous(memory_format=torch.channels_last_3d)


def get_norm_layer(norm_type: Optional[str]) -> Optional[Callable[[int], nn.Module]]:
    """Norm factory (factory.py:179-192, ``layers.py:197-210``): a
    constructor taking the channel count, or None for ``none`` (the conv
    then keeps its bias, equiunet2020.py:67-75)."""
    if norm_type in (None, "none"):
        return None
    if norm_type == "group":
        return partial(GroupNorm, num_groups=8)
    if norm_type == "batch":
        return BatchNorm
    if norm_type == "instance":
        return InstanceNorm
    if norm_type == "bcn":
        return partial(BCNorm, num_groups=8)
    raise ValueError("Norm type is not correct")


# ---------------------------------------------------------------------------
# Convolutions
# ---------------------------------------------------------------------------

class Conv3d(nn.Conv3d):
    """3D convolution with torch-style symmetric padding, d·(k−1)/2 unless
    ``padding`` is given (``layers.py:279-305``; VNet's 5³ convs take 2,
    its 2³/s2 convs 0); ``weight``/``bias`` keep nn.Conv3d's names, so
    reference checkpoints load as they are. ``kernel_init`` (one of the
    initializers above) sets the weight and zeroes the bias, as the JAX
    package's flax init does; without it nn.Conv3d's default init stays.

    The case the JAX package hands to its Pallas kernel (k = 3, stride 1,
    dilation 1, pad 1; ``layers.py:258-261``) goes to the hand-written
    :func:`conv3x3x3` through its trainable :class:`Conv3x3x3Function`,
    with a zero fp32 bias where the conv has none, at every width; every
    other conv is ``F.conv3d``, as the JAX package leaves those to XLA.

    On a slab (``parallel/spatial.py``) a conv takes the planes its reach
    needs from the slabs beside it and runs VALID on the sharded axis; the
    kernel's case runs the kernel SAME on the extended slab, a fresh
    contiguous tensor, and drops its first and last output plane, the only
    ones that see the kernel's zero pad on that axis."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 dilation: int = 1, stride: int = 1, use_bias: bool = True,
                 kernel_init: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 padding: Optional[int] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=(dilation * (kernel_size - 1) // 2 if padding is None
                                  else padding),
                         dilation=dilation, bias=use_bias)
        if kernel_init is not None:
            kernel_init(self.weight.data)
            if self.bias is not None:
                nn.init.zeros_(self.bias)

    @property
    def uses_kernel(self) -> bool:
        return (self.kernel_size == (3, 3, 3) and self.dilation == (1, 1, 1)
                and self.stride == (1, 1, 1) and self.padding == (1, 1, 1)
                and self.groups == 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        slab = spatial.active()
        if slab is not None:
            return self._sharded(x, slab)
        w = self.weight.to(x.dtype)
        if self.uses_kernel:
            y = Conv3x3x3Function.apply(
                to_kernel_layout(x), w.permute(2, 3, 4, 1, 0).contiguous(), self._kernel_bias(x))
            return from_kernel_layout(y)
        return F.conv3d(x, w, None if self.bias is None else self.bias.to(x.dtype),
                        stride=self.stride, padding=self.padding, dilation=self.dilation)

    def _kernel_bias(self, x: torch.Tensor) -> torch.Tensor:
        """The kernel's fp32 bias: the conv's, or zeros."""
        return (self.bias.float() if self.bias is not None else
                torch.zeros(self.out_channels, dtype=torch.float32, device=x.device))

    def _sharded(self, x: torch.Tensor, slab: "spatial.Slab") -> torch.Tensor:
        w = self.weight.to(x.dtype)
        if self.uses_kernel:
            y = conv3x3x3(spatial.halo(x, 1, 1, slab), w.permute(2, 3, 4, 1, 0).contiguous(),
                          self._kernel_bias(x))
            return from_kernel_layout(y[:, :, :, 1:-1])
        start, sizes = slab.level(x)
        lo, hi = spatial.conv_reach(self.kernel_size[2], self.dilation[2], self.padding[2],
                                    self.stride[2], start, x.shape[4], sum(sizes))
        ext = from_kernel_layout(spatial.halo(x, lo, max(hi, 0), slab))
        if hi < 0:
            ext = ext.narrow(4, 0, ext.shape[4] + hi)

        def conv(v):
            return F.conv3d(v, w, None if self.bias is None else self.bias.to(x.dtype),
                            stride=self.stride, padding=(*self.padding[:2], 0),
                            dilation=self.dilation)

        if x.shape[4] == 0:
            return spatial.on_empty(conv, x, self.dilation[2] * (self.kernel_size[2] - 1) + 1)
        return conv(ext)


class ConvTranspose3d(nn.ConvTranspose3d):
    """flax ``nn.ConvTranspose(ch, (k,)*3, strides=k, dtype=x.dtype)`` as
    the model zoo uses it (k = stride = 2): computed in the input's dtype
    with the weight and bias cast to it. The weight is torch's
    ``[C_in, C_out, k, k, k]``, whose taps are flax's kernel flipped on
    every spatial axis (flax does not flip; ``import_torch.py:641-646``,
    :func:`brats21_tpu_torch.utils.weights.state_dict_from_flax`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 2,
                 stride: int = 2, use_bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose3d(
            x, self.weight.to(x.dtype), None if self.bias is None else self.bias.to(x.dtype),
            stride=self.stride)


class Linear(nn.Linear):
    """flax ``nn.Dense(dtype=x.dtype)``: the weight and bias cast to the
    input's dtype (fp32 parameters)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class WSConv3d(nn.Conv3d):
    """Weight-standardised conv (factory.py:13-29, ``layers.py:308-344``):
    each output channel's weights centred and divided by their unbiased
    std + 1e-5, then the conv with fp32 accumulation, stored in the input's
    dtype, then the bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, use_bias: bool = True,
                 kernel_init: Callable[[torch.Tensor], torch.Tensor] = kaiming_normal_fan_out):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=dilation * (kernel_size - 1) // 2, dilation=dilation,
                         bias=use_bias)
        kernel_init(self.weight.data)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def standardized(self) -> torch.Tensor:
        w = self.weight - self.weight.mean(dim=(1, 2, 3, 4), keepdim=True)
        std = w.reshape(w.shape[0], -1).std(dim=1) + 1e-5
        return w / std.reshape(-1, 1, 1, 1, 1)

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        y = F.conv3d(x.float(), w.to(x.dtype).float(), None, stride=self.stride,
                     padding=self.padding, dilation=self.dilation).to(x.dtype)
        return y if self.bias is None else y + self.bias.to(y.dtype).reshape(1, -1, 1, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(x, self.standardized())


class ConvAWS3d(WSConv3d):
    """Adaptive weight standardisation (factory.py:32-87,
    ``layers.py:347-385``): weights centred and divided by
    sqrt(unbiased var + 1e-5), then ``weight_gamma · w + weight_beta`` from
    two buffers (ones, zeros; shape ``[C_out, 1, 1, 1, 1]``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, use_bias: bool = True,
                 kernel_init: Callable[[torch.Tensor], torch.Tensor] = kaiming_normal_fan_out):
        super().__init__(in_channels, out_channels, kernel_size, stride, dilation,
                         use_bias, kernel_init)
        self.register_buffer("weight_gamma", torch.ones(out_channels, 1, 1, 1, 1))
        self.register_buffer("weight_beta", torch.zeros(out_channels, 1, 1, 1, 1))

    def standardized(self) -> torch.Tensor:
        flat = self.weight.reshape(self.weight.shape[0], -1)
        mean = flat.mean(dim=1).reshape(-1, 1, 1, 1, 1)
        std = torch.sqrt(flat.var(dim=1) + 1e-5).reshape(-1, 1, 1, 1, 1)
        return self.weight_gamma * ((self.weight - mean) / std) + self.weight_beta


# ---------------------------------------------------------------------------
# Pooling and resizing
# ---------------------------------------------------------------------------

def max_pool3d(x: torch.Tensor, window: int = 2, stride: Optional[int] = None,
               ceil_mode: bool = False) -> torch.Tensor:
    """MaxPool3d(2, 2) (equiunet2020.py:342; the ceil-mode variant :274);
    local on an aligned slab."""
    slab = spatial.active()
    if slab is not None:
        spatial.check_pool(x, window, stride or window, slab)
        if x.shape[4] == 0:
            return spatial.on_empty(lambda v: F.max_pool3d(v, window, stride or window), x,
                                    window)
    return F.max_pool3d(x, window, stride or window, ceil_mode=ceil_mode)


def avg_pool3d(x: torch.Tensor, window: int = 2, stride: Optional[int] = None) -> torch.Tensor:
    slab = spatial.active()
    if slab is not None:
        spatial.check_pool(x, window, stride or window, slab)
        if x.shape[4] == 0:
            return spatial.on_empty(lambda v: avg_pool3d(v.float(), window, stride), x,
                                    window).to(x.dtype)
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        # PyTorch's CPU avg_pool3d has no bf16 kernel: pool in fp32, as the
        # CUDA kernel accumulates anyway, and round once
        return F.avg_pool3d(x.float(), window, stride or window).to(x.dtype)
    return F.avg_pool3d(x, window, stride or window)


def max_avg_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """MONAI MaxAvgPool: concat(maxpool, avgpool) on channels — the
    channel-doubling downsample of EquiUnetASSPEvo (equiunet2021.py:261)."""
    return torch.cat([max_pool3d(x, window), avg_pool3d(x, window)], dim=1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[B, C, D, H, W] → [B, C]; on a slab the fp32 sums all-reduced over
    the space group, divided by the whole volume's count."""
    slab = spatial.active()
    if slab is None:
        return x.mean(dim=(2, 3, 4))
    _, sizes = slab.level(x)
    total = spatial.all_reduce(x.float().sum(dim=(2, 3, 4)), slab.group)
    return (total / (x.shape[2] * x.shape[3] * sum(sizes))).to(x.dtype)


def global_max_pool(x: torch.Tensor) -> torch.Tensor:
    """[B, C, D, H, W] → [B, C]; on a slab the maxima all-reduced."""
    slab = spatial.active()
    if slab is None:
        return x.amax(dim=(2, 3, 4))
    local = (x.amax(dim=(2, 3, 4)).float() if x.shape[4] else
             torch.full(x.shape[:2], -math.inf, device=x.device))
    return spatial.all_reduce(local, slab.group, dist.ReduceOp.MAX).to(x.dtype)


def resize_trilinear(x: torch.Tensor, out_shape: Sequence[int],
                     align_corners: bool = True) -> torch.Tensor:
    """Trilinear resize to the spatial ``out_shape`` (``layers.py:462-480``;
    ``align_corners=False`` is torch's half-pixel rule with the source
    clamped at 0, as the JAX package's interpolation matrices have it).

    On a slab the sharded axis must grow by an integer factor: it is
    interpolated from global coordinates (``spatial.resize_sharded_axis``),
    then the other two axes, in fp32, rounded once to x's dtype."""
    slab = spatial.active()
    if slab is None:
        return F.interpolate(x, size=tuple(out_shape), mode="trilinear",
                             align_corners=align_corners)
    # an empty slab scales its W as its D (the covered models resize alike)
    scale, rest = (divmod(out_shape[2], x.shape[4]) if x.shape[4] else
                   divmod(out_shape[0], x.shape[2]))
    if rest or scale < 1:
        raise ValueError(f"a resize of a slab of {x.shape[4]} planes to {out_shape[2]}: the "
                         "sharded axis takes integer factors only")
    y = spatial.resize_sharded_axis(x, scale, align_corners, slab) if scale > 1 else x.float()
    if y.shape[4] == 0:
        return y.new_zeros((*y.shape[:2], out_shape[0], out_shape[1], 0)).to(x.dtype)
    return F.interpolate(y, size=(out_shape[0], out_shape[1], y.shape[4]), mode="trilinear",
                         align_corners=align_corners).to(x.dtype)


def upsample(x: torch.Tensor, scale_factor: int = 2,
             align_corners: bool = True) -> torch.Tensor:
    """Trilinear ×scale (``layers.py:483-486``): ``align_corners=True`` is
    torch nn.Upsample's in equiunet2020.py:351,439, ``False`` MONAI
    SegResNet's."""
    d, h, w = x.shape[2:]
    return resize_trilinear(x, (d * scale_factor, h * scale_factor, w * scale_factor),
                            align_corners)


class Upsample(nn.Module):
    """:func:`upsample` as a parameter-free module (MONAI's Sequentials
    hold it between a conv and a norm)."""

    def __init__(self, scale_factor: int = 2, align_corners: bool = False):
        super().__init__()
        self.scale_factor = scale_factor
        self.align_corners = align_corners

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample(x, self.scale_factor, self.align_corners)


class Dropout(nn.Module):
    """Dropout that is a no-op at rate 0, in eval mode and while
    ``deterministic``; ``channel_wise`` drops whole (sample, channel) maps
    as torch ``nn.Dropout3d`` does (``layers.py:494-514``). The masks draw
    from ``generator`` when one is set (:func:`stochastic`), else from
    torch's global generator."""

    def __init__(self, rate: float = 0.0, channel_wise: bool = False):
        super().__init__()
        self.rate = rate
        self.channel_wise = channel_wise
        self.generator: Optional[torch.Generator] = None
        self.deterministic = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training or self.deterministic:
            return x
        shape = x.shape[:2] + (1,) * (x.dim() - 2) if self.channel_wise else x.shape
        keep = torch.empty(shape, dtype=x.dtype, device=x.device).bernoulli_(
            1.0 - self.rate, generator=self.generator)
        return x * keep * (1.0 / (1.0 - self.rate))


def step_generator(seed: int, step: int, device: torch.device, rank: int = 0
                   ) -> torch.Generator:
    """The stochastic layers' generator of one train step, seeded from
    ``(seed, step)``, as the JAX package folds its step rng on the global
    step (``engine.py:332``): a run resumed mid-epoch draws the same masks
    as an uninterrupted one. The ``rank`` of a data-parallel run offsets
    the seed, so that its ranks draw different masks for their slices;
    rank 0's seed is the one-process run's."""
    key = ((int(seed) & 0x7FFFFFFF) << 32) | (int(step) & 0xFFFFFFFF)
    g = torch.Generator(device=device)
    g.manual_seed((key + int(rank) * 0x9E3779B97F4A7C15) % 2 ** 64)
    return g


class stochastic:
    """The JAX train step's ``deterministic = not model_uses_rng(cfg)``
    (``train_state.py:55-59,74``) on a torch model, for one forward: every
    module with a ``generator`` attribute (:class:`Dropout`, SegResNetVAE's
    latent sampling) draws from ``generator``, or, when it is None, runs
    deterministically in training too (VNet's fixed 0.5 skip dropout under
    ``--dropout 0``). Restores the modules' state on exit."""

    def __init__(self, model: nn.Module, generator: Optional[torch.Generator]):
        self.mods = [m for m in model.modules() if hasattr(m, "generator")]
        self.generator = generator

    def __enter__(self) -> "stochastic":
        self.saved = [(m.generator, m.deterministic) for m in self.mods]
        for m in self.mods:
            m.generator, m.deterministic = self.generator, self.generator is None
        return self

    def __exit__(self, *exc) -> None:
        for m, (g, det) in zip(self.mods, self.saved):
            m.generator, m.deterministic = g, det
