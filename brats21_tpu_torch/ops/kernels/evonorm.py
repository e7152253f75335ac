"""EvoNorm-S0 forward — CUDA C++: one ctypes call enqueues two kernels, the
group statistics with their merge, then one fused apply pass.

Replaces ``brats21_tpu/ops/pallas/evonorm_kernel.py:evonorm_s0_pallas``
(apply body ``_apply_kernel`` :45; the group statistics ``_group_inv_std``
:32 run in XLA there). For each (sample b, group g) with G = min(8, C), the
unbiased variance over the spatial axes × C/G channels (divisor n − 1)
gives inv = rsqrt(var + eps); then out = x·sigmoid(x)·inv·γ + β, all in
fp32, stored in x's dtype.

Bound on the H100: a few operations per element against 2 bytes read and
2 written in bf16, so device memory bounds it; at the deep levels the
host's cost per call does. ``csrc/evonorm_s0.cu``: every thread owns a fixed
16-byte channel vector (narrower where C does not allow it) and strides
over the rows of one sample. The statistics kernel keeps Welford (n, mean,
M2) per channel in fp32, merges them per (block, group) in shared memory,
and the last block of each sample to finish (an atomic ticket) merges the
partials in fp64 — n reaches ~3·10⁷ per group at full volume, where an fp32
sum of squares would lose the variance — and writes inv. The apply kernel
reads x once more and writes the output once. Both must read x, which is
ten times the L2 at the largest level, so the design moves 6 bytes an
element against the 4 of the bound. One ctypes call, two launches and two
``torch.empty`` keep a call cheap on the host.

:class:`EvoNormS0Function` makes it trainable as ``evonorm_kernel.py:118-138``
does: the forward is the kernels, the backward autograd of
:func:`evonorm_s0_plain` recomputed from the saved (x, γ, β), with no
hand-written backward kernel, as the JAX package has none.

The split entry points serve a volume sharded over ranks
(``parallel/spatial.py``), whose group statistics must be summed across
the slabs before the apply: :func:`evonorm_s0_stats` launches the
statistics kernel alone and stops after its per-sample fp64 merge, writing
the per-(sample, group) (n, mean, M2) in fp64 instead of inv; the caller
merges the ranks' triples (Chan's formula, fp64) into inv
(:func:`inv_std`); :func:`evonorm_s0_apply` launches the apply kernel
alone. Each counts its own launches; the one-call path is unchanged.

Layout contract (the JAX package's): x ``[B, D, H, W, C]`` contiguous,
gamma and beta ``[C]`` fp32.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from . import load_library

#: launches (one per call: the statistics and the apply kernel) since the last reset
launches = 0
#: launches of the split entry points: the statistics kernel alone, the apply kernel alone
stats_launches = 0
apply_launches = 0

SOURCE = "evonorm_s0.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
THREADS = 256           # threads of a block (csrc/evonorm_s0.cu)
UNROLL = 4              # rows a thread has in flight (csrc/evonorm_s0.cu)
STATS_BLOCKS = 396      # one wave of the statistics kernel: 132 SMs × 3 blocks
APPLY_BLOCKS = 1056     # one wave of the apply kernel: 132 SMs × 8 blocks
MAX_BATCH = 1024        # samples the per-device ticket buffer holds


@dataclass(frozen=True)
class EvoPlan:
    """Thread ``t`` of a block owns channels (t % tpr)·vec + [0, vec) of row
    lane t // tpr (lanes 0 … rpi − 1). The statistics kernel's grid of
    (``blocks``, B) strides over each sample's S rows from the last: row r
    goes to block ((S − 1 − r) // rpi) % blocks, which writes one partial
    per group. The apply kernel's (``apply_blocks``, B) strides from the
    first."""

    vec: int
    tpr: int
    rpi: int
    blocks: int
    apply_blocks: int


@functools.lru_cache(maxsize=256)
def evonorm_plan(b: int, s: int, c: int, itemsize: int, align: int = 16) -> EvoPlan:
    """The launch plan for x ``[b, s rows, c]`` of ``itemsize``-byte
    elements whose address is a multiple of ``align`` bytes: 16-byte
    vectors where C and the address allow, else the widest that divides
    both; enough blocks to fill the card where each thread still gets
    ``UNROLL`` rows (fewer partials to merge at the small levels), none
    without a row."""
    vec = 16 // itemsize
    while vec > 1 and (c % vec or align % (vec * itemsize)):
        vec //= 2
    tpr = c // vec
    if tpr > THREADS:
        raise ValueError(f"evonorm_s0: {c} channels need {tpr} threads a row, "
                         f"more than a block's {THREADS}")
    rpi = THREADS // tpr
    lanes = -(-s // (rpi * UNROLL))
    return EvoPlan(vec, tpr, rpi, max(1, min(lanes, -(-STATS_BLOCKS // b))),
                   max(1, min(lanes, -(-APPLY_BLOCKS // b))))


def evonorm_s0_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """The plain PyTorch version (``_evonorm_s0_xla``): fp32 maths, output
    in x's dtype."""
    b, c = x.shape[0], x.shape[-1]
    g = min(groups, c)
    xf = x.reshape(b, -1, c).float()
    xg = xf.reshape(b, xf.shape[1], g, c // g)
    n = xg.shape[1] * (c // g)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).sum(dim=(1, 3), keepdim=True) / max(n - 1, 1)
    inv = torch.rsqrt(var + eps).expand(b, 1, g, c // g).reshape(b, 1, c)
    out = xf * torch.sigmoid(xf) * inv * gamma.reshape(1, 1, c) \
        + beta.reshape(1, 1, c)
    return out.reshape(x.shape).to(x.dtype)


def evonorm_s0_stats_plain(x: torch.Tensor, groups: int = 8) -> torch.Tensor:
    """The plain version of :func:`evonorm_s0_stats`: per (sample, group)
    the count, mean and M2 (sum of squared deviations) over the spatial
    axes × C/G channels, ``[B, G, 3]`` fp64, computed in fp64."""
    b, c = x.shape[0], x.shape[-1]
    g = min(groups, c)
    xg = x.reshape(b, -1, g, c // g).double()
    if xg.numel() == 0:                     # no rows: no count
        mean = m2 = xg.new_zeros((b, g))
    else:
        mean = xg.mean(dim=(1, 3))
        m2 = (xg - mean[:, None, :, None]).square().sum(dim=(1, 3))
    return torch.stack([torch.full_like(mean, float(xg.shape[1] * (c // g))), mean, m2], -1)


def inv_std(stats: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """inv = 1 / sqrt(M2 / max(n − 1, 1) + eps) ``[B, G]`` fp32 from
    (n, mean, M2) ``[B, G, 3]``, in fp64 as the statistics kernel's merge
    computes it."""
    n, _, m2 = stats.double().unbind(-1)
    return (1.0 / torch.sqrt(m2 / (n - 1.0).clamp(min=1.0) + eps)).float()


def evonorm_s0_apply_plain(x: torch.Tensor, inv: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`evonorm_s0_apply`: x·σ(x)·inv·γ + β in
    fp32 (``evonorm_s0_plain``'s order), ``inv`` ``[B, G]``, output in x's
    dtype."""
    b, c = x.shape[0], x.shape[-1]
    g = inv.shape[1]
    xf = x.reshape(b, -1, c).float()
    iv = inv.float().reshape(b, 1, g, 1).expand(b, 1, g, c // g).reshape(b, 1, c)
    out = xf * torch.sigmoid(xf) * iv * gamma.reshape(1, 1, c) + beta.reshape(1, 1, c)
    return out.reshape(x.shape).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.brats_evonorm_s0.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 5
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.brats_evonorm_s0.restype = ctypes.c_int
    lib.brats_evonorm_s0_stats.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 5
        + [ctypes.c_int, ctypes.c_void_p])
    lib.brats_evonorm_s0_stats.restype = ctypes.c_int
    lib.brats_evonorm_s0_apply.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 5
        + [ctypes.c_int, ctypes.c_void_p])
    lib.brats_evonorm_s0_apply.restype = ctypes.c_int
    lib.brats_evonorm_error_string.argtypes = [ctypes.c_int]
    lib.brats_evonorm_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _tickets(device: torch.device) -> torch.Tensor:
    """The statistics kernel's per-sample tickets on ``device``: zeroed
    once, and left zero by every launch. Calls on one device are ordered by
    its stream; two streams must not run the kernel at once."""
    return torch.zeros(MAX_BATCH, dtype=torch.int32, device=device)


def _check(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           groups: int) -> None:
    c = x.shape[-1]
    if x.dim() < 3:
        raise ValueError(f"evonorm_s0: x must be [B, ..., C], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"evonorm_s0: unsupported dtype {x.dtype}")
    if gamma.shape != (c,) or beta.shape != (c,) \
            or gamma.dtype != torch.float32 or beta.dtype != torch.float32:
        raise ValueError(f"evonorm_s0: gamma and beta must be fp32 [{c}]")
    if not (x.device == gamma.device == beta.device):
        raise ValueError("evonorm_s0: x, gamma and beta must be on one device")
    if not (x.is_contiguous() and gamma.is_contiguous() and beta.is_contiguous()):
        raise ValueError("evonorm_s0: x, gamma and beta must be contiguous")
    if c % min(groups, c):
        raise ValueError(f"evonorm_s0: {c} channels not divisible by {groups} groups")


def evonorm_s0(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """EvoNorm-S0 of x ``[B, ..., C]`` (channels last), output in x's dtype.
    CPU tensors take :func:`evonorm_s0_plain`; CUDA tensors launch the
    CUDA kernels on the current stream."""
    global launches
    if x.device.type == "cpu":
        return evonorm_s0_plain(x, gamma, beta, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"evonorm_s0: no kernel for device {x.device}")
    _check(x, gamma, beta, groups)
    b, c = x.shape[0], x.shape[-1]
    if b > MAX_BATCH:
        raise ValueError(f"evonorm_s0: batch {b} over {MAX_BATCH}")
    s = x.numel() // (b * c)
    g = min(groups, c)
    plan = evonorm_plan(b, s, c, x.element_size(), math.gcd(x.data_ptr(), 16))
    lib = _library()
    part = torch.empty(b * plan.blocks * g * 3 + b * g, dtype=torch.float32,
                       device=x.device)
    y = torch.empty_like(x)
    # the library switches to x's device for the launches; a deep level's
    # call costs the host more than the card, so the stream is read raw
    dev = x.device.index
    rc = lib.brats_evonorm_s0(
        x.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(), part.data_ptr(),
        _tickets(x.device).data_ptr(), b, s, c, g, _DTYPES[x.dtype], plan.vec,
        plan.blocks, plan.apply_blocks, eps, dev, torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"evonorm_s0 launch failed: "
                           f"{lib.brats_evonorm_error_string(rc).decode()}")
    launches += 1
    return y


def _device_checks(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dim() < 3:
        raise ValueError(f"{what}: x must be [B, ..., C], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    if x.shape[0] > MAX_BATCH:
        raise ValueError(f"{what}: batch {x.shape[0]} over {MAX_BATCH}")


def evonorm_s0_stats(x: torch.Tensor, groups: int = 8) -> torch.Tensor:
    """Per (sample, group) (n, mean, M2) ``[B, G, 3]`` fp64 of x
    ``[B, ..., C]``: the statistics kernel alone, its partials merged in
    fp64 by each sample's last block. CPU tensors take
    :func:`evonorm_s0_stats_plain`; CUDA tensors launch the kernel."""
    global stats_launches
    if x.device.type == "cpu":
        return evonorm_s0_stats_plain(x, groups)
    _device_checks(x, "evonorm_s0_stats")
    b, c = x.shape[0], x.shape[-1]
    g = min(groups, c)
    if c % g:
        raise ValueError(f"evonorm_s0_stats: {c} channels not divisible by {g} groups")
    s = x.numel() // (b * c)
    if s == 0:                              # an empty slab: no count, no launch
        return torch.zeros((b, g, 3), dtype=torch.float64, device=x.device)
    plan = evonorm_plan(b, s, c, x.element_size(), math.gcd(x.data_ptr(), 16))
    part = torch.empty(b * plan.blocks * g * 3, dtype=torch.float32, device=x.device)
    stats = torch.empty((b, g, 3), dtype=torch.float64, device=x.device)
    dev = x.device.index
    lib = _library()
    rc = lib.brats_evonorm_s0_stats(
        x.data_ptr(), part.data_ptr(), stats.data_ptr(), _tickets(x.device).data_ptr(), b, s,
        c, g, _DTYPES[x.dtype], plan.vec, plan.blocks, dev,
        torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"evonorm_s0_stats launch failed: "
                           f"{lib.brats_evonorm_error_string(rc).decode()}")
    stats_launches += 1
    return stats


def evonorm_s0_apply(x: torch.Tensor, inv: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor) -> torch.Tensor:
    """x·σ(x)·inv·γ + β of x ``[B, ..., C]`` with ``inv`` ``[B, G]`` fp32
    (G groups of C/G channels): the apply kernel alone, output in x's dtype.
    CPU tensors take :func:`evonorm_s0_apply_plain`; CUDA tensors launch
    the kernel."""
    global apply_launches
    if x.device.type == "cpu":
        return evonorm_s0_apply_plain(x, inv, gamma, beta)
    _device_checks(x, "evonorm_s0_apply")
    b, c = x.shape[0], x.shape[-1]
    g = inv.shape[-1]
    _check(x, gamma, beta, g)
    if inv.shape != (b, g) or inv.dtype != torch.float32 or not inv.is_contiguous() \
            or inv.device != x.device or g != min(g, c):
        raise ValueError(f"evonorm_s0_apply: inv must be fp32 [{b}, G] on x's device, "
                         f"got {inv.dtype} {tuple(inv.shape)}")
    s = x.numel() // (b * c)
    y = torch.empty_like(x)
    if s == 0:                              # an empty slab: nothing to launch
        return y
    plan = evonorm_plan(b, s, c, x.element_size(), math.gcd(x.data_ptr(), 16))
    dev = x.device.index
    lib = _library()
    rc = lib.brats_evonorm_s0_apply(
        x.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(), inv.data_ptr(), b, s,
        c, g, _DTYPES[x.dtype], plan.vec, plan.apply_blocks, dev,
        torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"evonorm_s0_apply launch failed: "
                           f"{lib.brats_evonorm_error_string(rc).decode()}")
    apply_launches += 1
    return y


class EvoNormS0Function(torch.autograd.Function):
    """Trainable :func:`evonorm_s0` (``evonorm_kernel.py:118-138``): the
    forward is the wrapper (the CUDA kernels on a card, the plain version
    on the CPU), the backward autograd of :func:`evonorm_s0_plain`
    recomputed from the saved (x, γ, β). The backward launches no
    hand-written kernel."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
        ctx.save_for_backward(x, gamma, beta)
        ctx.groups, ctx.eps = groups, eps
        return evonorm_s0(x, gamma, beta, groups, eps)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        needs = ctx.needs_input_grad[:3]
        inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            out = evonorm_s0_plain(*inputs, ctx.groups, ctx.eps)
        wanted = [t for t, n in zip(inputs, needs) if n]
        got = iter(torch.autograd.grad(out, wanted, grad))
        return (*(next(got) if n else None for n in needs), None, None)
