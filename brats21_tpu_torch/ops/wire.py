"""Sparse host↔device wire formats (JAX ``brats21_tpu/ops/wire.py``).

A BraTS bbox-cropped volume is ~50% background zeros (the brain mask), and
BraTS label maps use only the 4 symbols {0, 1, 2, 4}. Where the host link
is the bottleneck the wire bytes shrink both ways:

* **in**: :func:`pack_volume` sends one packbits brain mask (1 bit a voxel,
  shared by the modalities) and the nonzero voxel rows;
  :func:`unpack_volume_device` rebuilds the volume exactly on the device
  with a cumsum index and a gather.
* **out**: :func:`pack_bits_device` packs a binary volume 8 voxels a byte
  and :func:`pack_labels_device` BraTS labels 2 bits a voxel on the
  device; :func:`unpack_bits` / :func:`unpack_labels` restore them on the
  host with numpy.

For integer volumes :func:`pack_values_narrow` re-encodes the nonzero rows
as a ``b``-bit big-endian bitstream (``b = vmax.bit_length()``, lossless);
:func:`unpack_values_narrow_device` decodes it with a 3-byte gather and a
shift per value.

The host halves are numpy and write the JAX package's bytes (``np.packbits``
order, the :data:`CAP_STEP` capacity rounding); the device halves are plain
torch on tensors of any device. Every round trip is exact.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

#: values-buffer capacity granularity (the JAX package's one executable a
#: step; kept so that both packages write the same bytes)
CAP_STEP = 1 << 18


def pack_volume(vol: np.ndarray,
                cap_step: int = CAP_STEP) -> Tuple[np.ndarray, np.ndarray]:
    """[X, Y, Z, C] array → (packbits mask [ceil(V/8)] uint8, values [cap, C]
    of the input dtype). The mask is the any-channel nonzero brain mask;
    ``cap`` is the nonzero count rounded up to ``cap_step`` (at most V)."""
    c = vol.shape[-1]
    flat = vol.reshape(-1, c)
    mask = (flat != 0).any(axis=1)
    vals = flat[mask]
    n_vox = flat.shape[0]
    cap = min(-(-max(vals.shape[0], 1) // cap_step) * cap_step, n_vox)
    assert vals.shape[0] <= cap
    vals = np.pad(vals, ((0, cap - vals.shape[0]), (0, 0)))
    return np.packbits(mask), np.ascontiguousarray(vals)


def _bits_msb_first(packed: torch.Tensor) -> torch.Tensor:
    """uint8 bytes → their bits, most significant first (np.unpackbits)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    return ((packed[:, None] >> shifts) & 1).reshape(-1)


def unpack_volume_device(bits: torch.Tensor, vals: torch.Tensor,
                         spatial: Tuple[int, int, int]) -> torch.Tensor:
    """Exact reconstruction on ``vals``' device: [1, X, Y, Z, C] of
    vals.dtype."""
    n_vox = spatial[0] * spatial[1] * spatial[2]
    mask = _bits_msb_first(bits)[:n_vox].bool()
    idx = (torch.cumsum(mask, 0) - 1).clamp_(0, vals.shape[0] - 1)
    vol = torch.where(mask[:, None], vals[idx], torch.zeros((), dtype=vals.dtype,
                                                            device=vals.device))
    return vol.reshape(1, *spatial, vals.shape[-1])


def pack_values_narrow(vals: np.ndarray, bits_per_value: int) -> np.ndarray:
    """[N, C] non-negative ints (each ``< 2**b``) → flat uint8 bitstream of
    consecutive ``b``-bit big-endian fields, row-major, zero-padded to a
    whole byte. Inverses: :func:`unpack_values_narrow_device` (device),
    :func:`unpack_values_narrow` (host)."""
    b = int(bits_per_value)
    assert 1 <= b <= 16, b
    v = np.ascontiguousarray(vals).astype(np.int64).reshape(-1)
    assert v.size == 0 or (v.min() >= 0 and int(v.max()) < (1 << b)), \
        f"values out of range for {b}-bit pack"
    bits = ((v[:, None] >> np.arange(b - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(-1))


def unpack_values_narrow(packed: np.ndarray, n_rows: int, channels: int,
                         bits_per_value: int) -> np.ndarray:
    """Host inverse of :func:`pack_values_narrow` → [n_rows, channels] int32."""
    b = int(bits_per_value)
    n = n_rows * channels
    bits = np.unpackbits(np.asarray(packed))[:n * b].reshape(n, b)
    weights = (1 << np.arange(b - 1, -1, -1)).astype(np.int64)
    return (bits.astype(np.int64) @ weights).reshape(n_rows, channels).astype(np.int32)


def unpack_values_narrow_device(packed: torch.Tensor, n_rows: int, channels: int,
                                bits_per_value: int,
                                dtype: torch.dtype = torch.int16) -> torch.Tensor:
    """Device inverse of :func:`pack_values_narrow` → [n_rows, channels].
    Each ``b``-bit field (b ≤ 16) spans at most 3 bytes: a 3-byte gather
    and one shift and mask a value, no [N*C, b] bit tensor."""
    b = int(bits_per_value)
    n = n_rows * channels
    u = torch.cat([packed.to(torch.int32),
                   torch.zeros(2, dtype=torch.int32, device=packed.device)])
    start = torch.arange(n, dtype=torch.int64, device=packed.device) * b
    j, r = start >> 3, (start & 7).to(torch.int32)
    window = (u[j] << 16) | (u[j + 1] << 8) | u[j + 2]
    v = (window >> (24 - r - b)) & ((1 << b) - 1)
    return v.reshape(n_rows, channels).to(dtype)


def pack_volume_narrow(vol: np.ndarray, bits_per_value: int, cap_step: int = CAP_STEP,
                       ) -> Tuple[np.ndarray, np.ndarray, int]:
    """:func:`pack_volume` with the values re-encoded as a ``b``-bit
    bitstream → (packbits mask, uint8 bitstream, cap); ``cap``, the padded
    row count, is what the device decode needs besides the stream."""
    bits, vals = pack_volume(vol, cap_step=cap_step)
    return bits, pack_values_narrow(vals, bits_per_value), vals.shape[0]


def unpack_volume_narrow_device(bits: torch.Tensor, packed_vals: torch.Tensor,
                                spatial: Tuple[int, int, int], channels: int,
                                cap: int, bits_per_value: int,
                                dtype: torch.dtype = torch.int16) -> torch.Tensor:
    """Device inverse of :func:`pack_volume_narrow` → [1, X, Y, Z, C]."""
    vals = unpack_values_narrow_device(packed_vals, cap, channels, bits_per_value, dtype)
    return unpack_volume_device(bits, vals, spatial)


def narrow_bits_for(vals: np.ndarray) -> int:
    """The smallest lossless bitstream width for ``vals``: 0 when narrow
    packing does not apply (negatives, non-integer dtype, or ≥ 16 bits
    needed), else ``max(vmax.bit_length(), 1)``."""
    if vals.size == 0:
        return 1
    if not np.issubdtype(vals.dtype, np.integer):
        return 0
    vmin, vmax = int(vals.min()), int(vals.max())
    if vmin < 0:
        return 0
    b = max(int(vmax).bit_length(), 1)
    return b if b < 16 else 0


def pack_bits_device(binary: torch.Tensor) -> torch.Tensor:
    """A binary tensor (exact {0, 1} values, any dtype and shape) → flat
    uint8, 8 voxels a byte, most significant bit first as np.packbits: the
    fused eval output crosses to the host 32× smaller than in fp32."""
    flat = binary.reshape(-1).to(torch.uint8)
    pad = (-flat.shape[0]) % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=flat.device)
    return (flat.reshape(-1, 8) << shifts).sum(dim=1).to(torch.uint8)


def unpack_bits(packed: np.ndarray, shape: Tuple[int, ...],
                dtype=np.float32) -> np.ndarray:
    """Host inverse of :func:`pack_bits_device` → array of ``shape``."""
    n = int(np.prod(shape))
    flat = np.unpackbits(np.asarray(packed))[:n]
    return flat.reshape(shape).astype(dtype)


def pack_labels_device(labels: torch.Tensor) -> torch.Tensor:
    """BraTS label map (values in {0, 1, 2, 4}, 4 | #voxels) → uint8 of
    packed 2-bit symbols, 4 voxels a byte."""
    l2 = torch.where(labels == 4, 3, labels).to(torch.uint8).reshape(-1, 4)
    return l2[:, 0] | (l2[:, 1] << 2) | (l2[:, 2] << 4) | (l2[:, 3] << 6)


def unpack_labels(packed: np.ndarray, spatial: Tuple[int, int, int]) -> np.ndarray:
    """Host inverse of :func:`pack_labels_device` → [X, Y, Z] uint8."""
    p = np.asarray(packed)
    l2 = np.stack([(p >> s) & 3 for s in (0, 2, 4, 6)], axis=1).reshape(spatial).astype(np.uint8)
    l2[l2 == 3] = 4
    return l2
