"""EquiUnetASSPEvo's glue between B1 and B2 — CUDA C++: the ResidualSE gate
with MaxAvgPool, and the trilinear ×2 upsample with the skip concat, each
one channels-last pass.

Replaces no TPU kernel: the JAX package leaves these steps to XLA, which
fuses them into the operations around them. Run as PyTorch calls they were
the largest block of the served forward's device time, larger than B1:
``x + x·s`` is a broadcast multiply and an add; MaxAvgPool's
``avg_pool3d`` copies its channels-last input to NCDHW, ``max_pool3d``
writes an index tensor no one reads, their concat falls back to strided
copies into an NCDHW tensor that the next conv copies back; the decoders'
``upsample_trilinear3d`` loops over channels on channels-last strides and
the concat copies its output again. ``csrc/glue3d.cu`` computes each in one
pass that reads its inputs once and writes the contiguous
``[B, D, H, W, C]`` tensor that the next B1 or 1×1 conv reads.

Bound on the H100: device memory (a few operations an element against 2
bytes read and 2 written in bf16). Threads hold 16-byte channel vectors,
neighbouring threads neighbouring channels, then voxels;
:func:`se_gate_pool` loads each output voxel's 2³ window at once.

Both kernels reproduce PyTorch's roundings on the card: the gate's
multiply and add each rounded to x's type, the max exact, the mean summed
in fp32 in ``avg_pool3d``'s order and rounded once, the upsample's indices
and weights by ``upsample_trilinear3d``'s formulas. The plain versions are
PyTorch's own calls in the kernels' layout, the composition the model used.

Layout contract: every tensor ``[B, D, H, W, C]`` contiguous (the kernels'
layout, ``models/layers.py:to_kernel_layout``), the gate ``s`` ``[B, C]``,
all fp32 or all bf16 (``--no_amp`` or the served bf16), on one device.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import load_library

#: launches of both entry points since the last reset
launches = 0
#: launches of each entry point
se_gate_pool_launches = 0
upsample_cat_launches = 0

SOURCE = "glue3d.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256             # threads of a block (csrc/glue3d.cu)
MAX_BLOCKS = 1 << 20      # blocks a sample; the kernels stride over the rest


@dataclass(frozen=True)
class GluePlan:
    """A block covers ``rpi`` output voxels at a time with ``tpr`` threads
    of ``vec`` channels each: the gate's thread ``t`` owns vector t % tpr
    of voxel lane t // tpr; the upsample's first rpi·(Cs/vec) threads copy
    skip's vectors, the others interpolate low's. A grid of (``blocks``,
    B) strides over each sample's output voxels."""

    vec: int
    tpr: int
    rpi: int
    blocks: int


@functools.lru_cache(maxsize=256)
def glue_plan(rows: int, widths: Tuple[int, ...], itemsize: int, align: int = 16) -> GluePlan:
    """The launch plan for ``rows`` output voxels of the channel segments
    ``widths`` (one for the gate, skip's and low's for the upsample) of
    ``itemsize``-byte elements whose addresses are multiples of ``align``
    bytes: 16-byte vectors where every segment and the addresses allow,
    else the widest that divides them all."""
    vec = 16 // itemsize
    while vec > 1 and (any(c % vec for c in widths) or align % (vec * itemsize)):
        vec //= 2
    tpr = sum(widths) // vec
    if tpr > THREADS:
        raise ValueError(f"glue: {sum(widths)} channels need {tpr} threads a voxel, more "
                         f"than a block's {THREADS}")
    rpi = THREADS // tpr
    return GluePlan(vec, tpr, rpi, max(1, min(-(-rows // rpi), MAX_BLOCKS)))


def se_gate_pool_plain(x: torch.Tensor, s: torch.Tensor, pool: bool
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version of :func:`se_gate_pool`: ``ResidualSELayer``'s
    ``x + x·s`` and ``layers.max_avg_pool`` (on the CPU, bf16 is averaged
    in fp32 and rounded once) as the model called them."""
    y = x + x * s[:, None, None, None, :]
    if not pool:
        return y, None
    v = y.permute(0, 4, 1, 2, 3)
    mean = (F.avg_pool3d(v.float(), 2).to(v.dtype) if v.dtype == torch.bfloat16
            else F.avg_pool3d(v, 2))
    return y, torch.cat([F.max_pool3d(v, 2), mean], 1).permute(0, 2, 3, 4, 1).contiguous()


def upsample_cat_plain(skip: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`upsample_cat`: ``F.interpolate``
    (trilinear, ``align_corners=True``) and the concat, as the model
    called them."""
    up = F.interpolate(low.permute(0, 4, 1, 2, 3), size=tuple(skip.shape[1:4]),
                       mode="trilinear", align_corners=True)
    return torch.cat([skip.permute(0, 4, 1, 2, 3), up], 1).permute(0, 2, 3, 4, 1).contiguous()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.brats_se_gate_pool.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    lib.brats_se_gate_pool.restype = ctypes.c_int
    lib.brats_upsample_cat.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 + [
        ctypes.c_void_p]
    lib.brats_upsample_cat.restype = ctypes.c_int
    lib.brats_glue_error_string.argtypes = [ctypes.c_int]
    lib.brats_glue_error_string.restype = ctypes.c_char_p
    return lib


def _check(what: str, *ts: torch.Tensor) -> None:
    first = ts[0]
    if first.dtype not in _DTYPES:
        raise TypeError(f"{what}: unsupported dtype {first.dtype}")
    if any(t.dtype != first.dtype or t.device != first.device for t in ts):
        raise ValueError(f"{what}: every input must have one dtype and one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: inputs must be contiguous")


def _align(ts: Sequence[torch.Tensor]) -> int:
    return functools.reduce(math.gcd, (t.data_ptr() for t in ts), 16)


def _raise(lib: ctypes.CDLL, what: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.brats_glue_error_string(rc).decode()}")


def se_gate_pool(x: torch.Tensor, s: torch.Tensor, pool: bool
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The ResidualSE gate ``y = x + x·s`` of x ``[B, D, H, W, C]`` with s
    ``[B, C]``, and with ``pool`` its MaxAvgPool ``[B, D/2, H/2, W/2, 2C]``
    (channels [:C] the 2³ max, [C:] the mean; D, H, W even), else None.
    CPU tensors take :func:`se_gate_pool_plain`; CUDA tensors launch the
    kernel on the current stream."""
    global launches, se_gate_pool_launches
    if x.dim() != 5 or s.shape != (x.shape[0], x.shape[4]):
        raise ValueError(f"se_gate_pool: x must be [B, D, H, W, C] and s [B, C], got "
                         f"{tuple(x.shape)} and {tuple(s.shape)}")
    b, d, h, w, c = x.shape
    if pool and (d % 2 or h % 2 or w % 2):
        raise ValueError(f"se_gate_pool: pooling needs even D, H, W, got {(d, h, w)}")
    if x.device.type == "cpu":
        return se_gate_pool_plain(x, s, pool)
    if x.device.type != "cuda":
        raise ValueError(f"se_gate_pool: no kernel for device {x.device}")
    _check("se_gate_pool", x, s)
    y = torch.empty_like(x)
    pooled = x.new_empty((b, d // 2, h // 2, w // 2, 2 * c)) if pool else None
    if x.numel() == 0:
        return y, pooled
    rows = (d // 2) * (h // 2) * (w // 2) if pool else d * h * w
    plan = glue_plan(rows, (c,), x.element_size(),
                     _align([x, y] if pooled is None else [x, y, pooled]))
    lib = _library()
    dev = x.device.index
    rc = lib.brats_se_gate_pool(
        x.data_ptr(), s.data_ptr(), y.data_ptr(), None if pooled is None else pooled.data_ptr(),
        b, d, h, w, c, _DTYPES[x.dtype], plan.vec, plan.blocks, dev,
        torch._C._cuda_getCurrentRawStream(dev))
    _raise(lib, "se_gate_pool", rc)
    launches += 1
    se_gate_pool_launches += 1
    return y, pooled


def upsample_cat(skip: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """``[skip, trilinear ×2 of low]`` on channels, ``[B, D, H, W, Cs + Cu]``
    from skip ``[B, D, H, W, Cs]`` and low ``[B, D/2, H/2, W/2, Cu]``
    (``align_corners=True``). CPU tensors take :func:`upsample_cat_plain`;
    CUDA tensors launch the kernel on the current stream."""
    global launches, upsample_cat_launches
    if skip.dim() != 5 or low.dim() != 5 or skip.shape[0] != low.shape[0] or any(
            a != 2 * e for a, e in zip(skip.shape[1:4], low.shape[1:4])):
        raise ValueError(f"upsample_cat: skip must be [B, 2D, 2H, 2W, Cs] of low "
                         f"[B, D, H, W, Cu], got {tuple(skip.shape)} and {tuple(low.shape)}")
    if skip.device.type == "cpu":
        return upsample_cat_plain(skip, low)
    if skip.device.type != "cuda":
        raise ValueError(f"upsample_cat: no kernel for device {skip.device}")
    _check("upsample_cat", skip, low)
    b, d, h, w, cs = skip.shape
    _, d1, h1, w1, cu = low.shape
    out = skip.new_empty((b, d, h, w, cs + cu))
    if out.numel() == 0:
        return out
    plan = glue_plan(d * h * w, (cs, cu), skip.element_size(), _align([skip, low, out]))
    lib = _library()
    dev = skip.device.index
    rc = lib.brats_upsample_cat(
        skip.data_ptr(), low.data_ptr(), out.data_ptr(), b, d, h, w, cs, d1, h1, w1, cu,
        _DTYPES[skip.dtype], plan.vec, plan.blocks, dev, torch._C._cuda_getCurrentRawStream(dev))
    _raise(lib, "upsample_cat", rc)
    launches += 1
    upsample_cat_launches += 1
    return out
