"""Minimal, dependency-free NIfTI-1 reader/writer (.nii / .nii.gz).

The reference reads volumes with nibabel/SimpleITK (utils/files.py:103-144)
and saves segmentations with MONAI ``write_nifti`` preserving the affine
(files.py:233-253). Neither library is assumed here: BraTS NIfTI files are
plain single-file NIfTI-1, which this module parses directly with numpy.

Only the features the framework needs are implemented: dim/datatype/affine
(srow or simple qform), scl_slope/scl_inter scaling, gzip container.
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

_HDR_SIZE = 348
_MAGIC_OFFSET = 344

# NIfTI-1 datatype codes
_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class NiftiImage:
    """A loaded NIfTI volume: data in array (x, y, z) index order + affine."""

    data: np.ndarray
    affine: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float64))

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.data.shape

    @property
    def spacing(self) -> Tuple[float, float, float]:
        return tuple(float(np.linalg.norm(self.affine[:3, i])) for i in range(3))


def _open_maybe_gzip(path: str, mode: str = "rb"):
    if path.endswith(".gz"):
        if "w" in mode:
            # nibabel's default compresslevel is 1 — a uint8 segmentation
            # compresses ~5× faster at near-identical size vs Python's
            # default level 9 (the save sits on the serving critical path)
            level = int(os.environ.get("BRATS21_GZIP_LEVEL", "1"))
            return gzip.open(path, mode, compresslevel=level)
        return gzip.open(path, mode)
    # sniff gzip magic even without extension
    if "r" in mode:
        with open(path, "rb") as f:
            magic = f.read(2)
        if magic == b"\x1f\x8b":
            return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: str) -> NiftiImage:
    """Read a NIfTI-1 file into (x, y, z[, t]) numpy array + 4×4 affine."""
    with _open_maybe_gzip(path) as f:
        raw = f.read()
    hdr = raw[:_HDR_SIZE]
    (sizeof_hdr,) = struct.unpack_from("<i", hdr, 0)
    endian = "<"
    if sizeof_hdr != _HDR_SIZE:
        endian = ">"
        (sizeof_hdr,) = struct.unpack_from(">i", hdr, 0)
        if sizeof_hdr != _HDR_SIZE:
            raise ValueError(f"{path}: not a NIfTI-1 file")
    magic = hdr[_MAGIC_OFFSET:_MAGIC_OFFSET + 4]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = struct.unpack_from(endian + "8h", hdr, 40)
    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1:1 + ndim])
    (datatype,) = struct.unpack_from(endian + "h", hdr, 70)
    (bitpix,) = struct.unpack_from(endian + "h", hdr, 72)
    pixdim = struct.unpack_from(endian + "8f", hdr, 76)
    (vox_offset,) = struct.unpack_from(endian + "f", hdr, 108)
    scl_slope, scl_inter = struct.unpack_from(endian + "2f", hdr, 112)
    (sform_code,) = struct.unpack_from(endian + "h", hdr, 254)
    srow = np.array(struct.unpack_from(endian + "12f", hdr, 280),
                    dtype=np.float64).reshape(3, 4)

    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    count = int(np.prod(shape)) if shape else 0
    data = np.frombuffer(raw, dtype=dtype, count=count,
                         offset=int(vox_offset)).reshape(shape, order="F")
    data = np.asarray(data, dtype=data.dtype.newbyteorder("="))
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter

    if sform_code > 0:
        affine = np.eye(4)
        affine[:3, :] = srow
    else:
        # fall back to pixdim scaling (ignore quaternion rotations — BraTS
        # files carry sform)
        affine = np.diag([pixdim[1], pixdim[2], pixdim[3], 1.0]).astype(np.float64)
    return NiftiImage(data=data, affine=affine)


def write_nifti(path: str, data: np.ndarray,
                affine: Optional[np.ndarray] = None) -> None:
    """Write an (x, y, z) array as NIfTI-1 (.nii or .nii.gz by extension),
    affine stored in the sform (MONAI write_nifti parity for uint8 segs,
    reference files.py:233-253)."""
    data = np.asarray(data)
    if data.dtype == bool:
        data = data.astype(np.uint8)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    affine = np.eye(4) if affine is None else np.asarray(affine, np.float64)

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    ndim = data.ndim
    dims = [ndim] + list(data.shape) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[np.dtype(data.dtype)])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    spacing = [float(np.linalg.norm(affine[:3, i])) for i in range(3)]
    struct.pack_into("<8f", hdr, 76, 1.0, *spacing, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)            # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)        # scl_slope/inter
    struct.pack_into("<h", hdr, 252, 0)                # qform_code
    struct.pack_into("<h", hdr, 254, 1)                # sform_code = SCANNER
    struct.pack_into("<12f", hdr, 280, *affine[:3, :].ravel())
    hdr[_MAGIC_OFFSET:_MAGIC_OFFSET + 4] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + data.tobytes(order="F")
    with _open_maybe_gzip(path, "wb") as f:
        f.write(payload)


def load_nifty_volume_as_array(path: str) -> Tuple[np.ndarray, NiftiImage]:
    """Reference files.py:103-115 contract: returns the volume transposed to
    [z, y, x] plus the image handle (for affine/metadata)."""
    img = read_nifti(path)
    return np.transpose(img.data, (2, 1, 0)), img
