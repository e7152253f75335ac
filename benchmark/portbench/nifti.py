"""NIfTI-1 files, gzipped, written and read without the program's code:
the benchmark writes the cases it serves and reads back the label maps
the program wrote. One volume a file, voxels in Fortran order after the
348-byte header and a 4-byte empty extension."""

from __future__ import annotations

import gzip
import struct

import numpy as np

_CODES = {np.dtype(np.uint8): 2, np.dtype(np.int16): 4, np.dtype(np.int32): 8,
          np.dtype(np.float32): 16, np.dtype(np.float64): 64, np.dtype(np.int8): 256,
          np.dtype(np.uint16): 512}
_DTYPES = {v: k for k, v in _CODES.items()}


def write(path: str, data: np.ndarray, affine: np.ndarray, level: int = 1) -> None:
    """Write ``data`` (3D) with ``affine`` (its sform) as ``path``."""
    data = np.asarray(data)
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dims = [3, *data.shape] + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, _CODES[data.dtype])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    spacing = np.sqrt((np.asarray(affine)[:3, :3] ** 2).sum(axis=0))
    struct.pack_into("<8f", hdr, 76, 1.0, *spacing, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<ff", hdr, 112, 1.0, 0.0)
    struct.pack_into("<b", hdr, 123, 10)                 # mm, s
    struct.pack_into("<hh", hdr, 252, 0, 1)               # qform 0, sform 1
    struct.pack_into("<12f", hdr, 280, *np.asarray(affine, np.float64)[:3].ravel())
    hdr[344:348] = b"n+1\x00"
    with gzip.open(path, "wb", compresslevel=level) as f:
        f.write(bytes(hdr) + b"\x00" * 4 + np.asarray(data).tobytes(order="F"))


def read(path: str):
    """(data, affine) of ``path``; slope and intercept applied when set
    to anything but (1, 0) or a zero slope."""
    with gzip.open(path, "rb") as f:
        raw = f.read()
    if struct.unpack_from("<i", raw, 0)[0] != 348:
        raise ValueError(f"{path}: not a little-endian NIfTI-1 file")
    dims = struct.unpack_from("<8h", raw, 40)
    shape = tuple(int(d) for d in dims[1:1 + dims[0]])
    dtype = _DTYPES[struct.unpack_from("<h", raw, 70)[0]]
    offset = int(struct.unpack_from("<f", raw, 108)[0])
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=offset)
    data = data.reshape(shape, order="F")
    slope, inter = struct.unpack_from("<ff", raw, 112)
    if slope not in (0.0, 1.0) or inter != 0.0:
        data = data * (slope or 1.0) + inter
    affine = np.eye(4)
    affine[:3] = np.asarray(struct.unpack_from("<12f", raw, 280)).reshape(3, 4)
    return np.array(data), affine
