"""B4, Swin UNETR's shifted-window attention — CUDA C++: the cyclic shift,
the window partition, the relative position bias, the shift mask, an fp32
softmax over the window's keys and the product with v, in one kernel.

Replaces no TPU kernel: the JAX package has no Swin UNETR. As PyTorch calls
(:func:`window_attn_plain`, the composition MONAI's ``SwinUNETR`` runs) a
block at stage 1 of a 128³ window rolls and partitions the qkv grid, writes
1000 windows × heads × 343² fp32 scores, reads and rewrites them for the
bias, the mask and the softmax, then reverses the partition and the roll.
``csrc/window_attn.cu`` reads q, k and v once from the qkv Linear's output
and writes each token's attention output where the token lies in the
unshifted grid, ready for ``proj``; no score leaves the chip's registers.

Semantics (MONAI ``SwinUNETR``, ``norm_name="instance"``, window 7):

- a grid ``[B, Dp, Hp, Wp]`` padded to multiples of the window is rolled
  by ``-shift`` and cut into windows of ``window`` tokens in (d, h, w)
  order; an axis of at most 7 tokens is one window of its size with shift
  0 (:func:`window_geometry`);
- scores ``(q·scale) kᵀ + B_rel + M``: ``B_rel[h, i, j] = table[idx[i, j],
  h]`` with MONAI's index of the 7³ window, of which a window of n < 343
  tokens takes ``idx[:n, :n]`` (:func:`relative_index`); ``M`` −100 between
  tokens of different regions of the shifted grid where any shift is
  nonzero, else 0 (:func:`region_ids`);
- softmax in fp32, its bf16 (the activation dtype) product with v, the
  output rolled back by ``+shift``.

fp32 inputs (``--no_amp``) take a plain FMA kernel in the same source, fp32
throughout.

Layout contract: ``qkv`` ``[B, Dp, Hp, Wp, 3, heads, 16]`` contiguous in bf16
or fp32 (the qkv Linear's output over the padded grid, q then k then v,
head-major), ``table`` the fp32 ``[(2·7−1)³, heads]`` parameter; the output
``[B, Dp, Hp, Wp, heads·16]`` in qkv's dtype.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence, Tuple

import torch

from . import load_library

#: launches since the last reset
launches = 0

SOURCE = "window_attn.cu"
WINDOW = 7                    # the module's window: the table's and idx's geometry
HEAD_DIM = 16                 # the kernel's head size (Swin UNETR's in every stage)
MASK_VALUE = -100.0           # MONAI's compute_mask
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def window_geometry(size: Sequence[int]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(window, shift) per axis of a grid of ``size`` tokens (MONAI's
    ``get_window_size``): an axis of at most 7 tokens is one window of its
    size and is not shifted; the others take 7 and 3."""
    ws = tuple(s if s <= WINDOW else WINDOW for s in size)
    shift = tuple(0 if s <= WINDOW else WINDOW // 2 for s in size)
    return ws, shift


@functools.lru_cache(maxsize=64)
def relative_index(n: int) -> torch.Tensor:
    """MONAI's ``relative_position_index[:n, :n]``: the table row of each
    (query, key) pair of the 7³ window's first ``n`` tokens,
    ``(Δd + 6)·13² + (Δh + 6)·13 + (Δw + 6)``."""
    r = torch.arange(WINDOW)
    coords = torch.stack(torch.meshgrid(r, r, r, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (WINDOW - 1)
    span = 2 * WINDOW - 1
    idx = rel[..., 0] * span * span + rel[..., 1] * span + rel[..., 2]
    return idx[:n, :n].contiguous()


def region_ids(padded: Sequence[int], ws: Sequence[int], shift: Sequence[int],
               device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """MONAI's ``compute_mask`` regions, ``[Dp, Hp, Wp]`` int64: each axis of
    the rolled grid cut by ``(0:−ws), (−ws:−shift), (−shift:)``, the 27
    regions numbered in that order."""
    per_axis = []
    for p, w, s in zip(padded, ws, shift):
        c = torch.arange(p, device=device)
        per_axis.append(torch.where(c < p - w, 0, torch.where(c < p - s, 1, 2)))
    d, h, w = per_axis
    return d[:, None, None] * 9 + h[None, :, None] * 3 + w[None, None, :]


def partition(t: torch.Tensor, ws: Sequence[int]) -> torch.Tensor:
    """``[B, Dp, Hp, Wp, *rest]`` → ``[B·windows, n, *rest]`` (MONAI's
    ``window_partition``: windows in (d, h, w) order, tokens likewise)."""
    b, dp, hp, wp, *rest = t.shape
    wd, wh, ww = ws
    t = t.reshape(b, dp // wd, wd, hp // wh, wh, wp // ww, ww, *rest)
    t = t.permute(0, 1, 3, 5, 2, 4, 6, *range(7, t.dim()))
    return t.reshape(-1, wd * wh * ww, *rest)


def unpartition(t: torch.Tensor, ws: Sequence[int], grid: Sequence[int]) -> torch.Tensor:
    """The inverse of :func:`partition` onto ``grid`` = (B, Dp, Hp, Wp)."""
    b, dp, hp, wp = grid
    wd, wh, ww = ws
    rest = t.shape[2:]
    t = t.reshape(b, dp // wd, hp // wh, wp // ww, wd, wh, ww, *rest)
    t = t.permute(0, 1, 4, 2, 5, 3, 6, *range(7, t.dim()))
    return t.reshape(b, dp, hp, wp, *rest)


def shift_mask(padded: Sequence[int], ws: Sequence[int], shift: Sequence[int],
               device: torch.device) -> torch.Tensor:
    """``[windows, n, n]`` fp32 on ``device``: −100 between tokens of
    different regions of a window, 0 within one."""
    ids = partition(region_ids(padded, ws, shift, device)[None, ..., None], ws)[..., 0]
    return torch.where(ids[:, :, None] != ids[:, None, :], MASK_VALUE, 0.0)


def relative_bias(table: torch.Tensor, n: int) -> torch.Tensor:
    """``[heads, n, n]`` fp32: the table's rows at :func:`relative_index`."""
    idx = _relative_index_on(n, table.device)
    return table.float()[idx].reshape(n, n, -1).permute(2, 0, 1)


@functools.lru_cache(maxsize=64)
def _relative_index_on(n: int, device: torch.device) -> torch.Tensor:
    return relative_index(n).reshape(-1).to(device)


def window_attn_plain(qkv: torch.Tensor, table: torch.Tensor, ws: Sequence[int],
                      shift: Sequence[int]) -> torch.Tensor:
    """The composition MONAI runs, in the kernel's layout (any head size
    d): roll, partition, scores ``(q·d^−½) kᵀ`` in fp32 from the
    activation-dtype q and k, bias, mask, fp32 softmax, its product with v
    in the activation dtype, reverse, roll back. Differentiable (training
    takes it)."""
    b, dp, hp, wp, _, heads, hd = qkv.shape
    scale = hd ** -0.5
    shifted = any(shift)
    if shifted:
        qkv = torch.roll(qkv, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
    n = math.prod(ws)
    q, k, v = partition(qkv, ws).permute(2, 0, 3, 1, 4).unbind(0)   # [Bw, heads, n, d]
    att = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    att = att + relative_bias(table, n)[None]
    if shifted:
        mask = shift_mask((dp, hp, wp), ws, shift, qkv.device)
        att = (att.view(b, -1, heads, n, n) + mask[None, :, None]).view(-1, heads, n, n)
    att = torch.softmax(att, dim=-1).to(v.dtype)
    out = torch.matmul(att, v).permute(0, 2, 1, 3).reshape(-1, n, heads * hd)
    out = unpartition(out, ws, (b, dp, hp, wp))
    if shifted:
        out = torch.roll(out, shifts=tuple(shift), dims=(1, 2, 3))
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.brats_window_attn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 + [
        ctypes.c_void_p]
    lib.brats_window_attn.restype = ctypes.c_int
    lib.brats_window_attn_error_string.argtypes = [ctypes.c_int]
    lib.brats_window_attn_error_string.restype = ctypes.c_char_p
    return lib


def window_attn(qkv: torch.Tensor, table: torch.Tensor, ws: Sequence[int],
                shift: Sequence[int]) -> torch.Tensor:
    """Shifted-window attention of ``qkv`` ``[B, Dp, Hp, Wp, 3, heads, d]``
    (windows ``ws`` ≤ 7 dividing the padded grid, ``shift`` per axis) with
    the bias table ``[(2·7−1)³, heads]``: ``[B, Dp, Hp, Wp, heads·16]``.
    CPU tensors take :func:`window_attn_plain`; a CUDA tensor (bf16 or fp32,
    d = 16, contiguous) launches B4 on the current stream or raises."""
    global launches
    if qkv.dim() != 7 or qkv.shape[4] != 3:
        raise ValueError(f"window_attn: qkv must be [B, Dp, Hp, Wp, 3, heads, d], got "
                         f"{tuple(qkv.shape)}")
    b, dp, hp, wp, _, heads, hd = qkv.shape
    span = (2 * WINDOW - 1) ** 3
    if table.shape != (span, heads):
        raise ValueError(f"window_attn: table must be [{span}, {heads}], got "
                         f"{tuple(table.shape)}")
    if any(w < 1 or w > WINDOW or p % w for p, w in zip((dp, hp, wp), ws)) or any(
            s < 0 or s >= w for s, w in zip(shift, ws)):
        raise ValueError(f"window_attn: windows {tuple(ws)} (at most {WINDOW}) must divide "
                         f"the padded grid {(dp, hp, wp)}, shifts {tuple(shift)} lie below them")
    if qkv.device.type == "cpu":
        return window_attn_plain(qkv, table, ws, shift)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attn: no kernel for device {qkv.device}")
    if qkv.dtype not in _DTYPES or hd != HEAD_DIM:
        raise TypeError(f"window_attn: the kernel takes bf16 or fp32 qkv of head size "
                        f"{HEAD_DIM}, got {qkv.dtype} of {hd}")
    if table.dtype != torch.float32 or table.device != qkv.device:
        raise ValueError("window_attn: the table must be fp32 on qkv's device")
    if not (qkv.is_contiguous() and table.is_contiguous()) or qkv.data_ptr() % 16:
        raise ValueError("window_attn: qkv and table must be contiguous, qkv 16-byte aligned")
    out = qkv.new_empty((b, dp, hp, wp, heads * hd))
    if out.numel() == 0:
        return out
    lib = _library()
    dev = qkv.device.index
    rc = lib.brats_window_attn(qkv.data_ptr(), table.data_ptr(), out.data_ptr(), b, dp, hp, wp,
                               heads, *ws, *shift, _DTYPES[qkv.dtype], dev,
                               torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError("window_attn launch failed: "
                           f"{lib.brats_window_attn_error_string(rc).decode()}")
    launches += 1
    return out
