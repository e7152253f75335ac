"""EDT min-plus envelope along one axis — CUDA C++ (``csrc/edt_envelope.cu``).

Replaces ``brats21_tpu/ops/pallas/edt_kernel.py:envelope_last_axis`` (body
``_envelope_kernel`` :28): ``out[i] = min_j g[j] + (s·(i − j))²`` along one
axis, in fp32, the accumulator starting at the 1e12 sentinel. It is one
pass of the separable exact EDT (``ops/edt.py``).

Bound on the H100: n candidates of four operations per output against 8
bytes moved per element, so fp32 arithmetic bounds it at the BraTS line
lengths (128-240). The kernel takes the tensor as ``[outer, n, inner]``, so
it runs along any axis of a contiguous tensor through its stride (the TPU
version transposes each axis last), stages 32 lines at a time in shared
memory and scans them there; each candidate is rounded step by step as the
JAX package's, so the kernel equals :func:`envelope_plain` bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import load_library

#: launches of the CUDA kernel since the last reset (read by chip_smoke.py)
launches = 0

SOURCE = "edt_envelope.cu"
INF = 1e12          # the JAX package's sentinel (ops/edt.py:_INF)
MAX_N = 768         # two [n, 33] fp32 tiles must fit a block's shared memory


def envelope_plain(g: torch.Tensor, sampling: float = 1.0, axis: int = -1
                   ) -> torch.Tensor:
    """The plain PyTorch version: ``ops/edt.py:_envelope_1d`` step by step
    along ``axis`` (one candidate per j, minimum into an accumulator that
    starts at 1e12)."""
    gl = g.movedim(axis, -1)
    n = gl.shape[-1]
    idx = torch.arange(n, dtype=torch.float32, device=g.device)
    acc = torch.full_like(gl, INF)
    for j in range(n):
        d = (idx - j) * sampling
        acc = torch.minimum(acc, gl[..., j:j + 1] + d * d)
    return acc.movedim(-1, axis).contiguous()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.brats_edt_envelope.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
    lib.brats_edt_envelope.restype = ctypes.c_int
    lib.brats_edt_error_string.argtypes = [ctypes.c_int]
    lib.brats_edt_error_string.restype = ctypes.c_char_p
    return lib


def envelope(g: torch.Tensor, sampling: float = 1.0, axis: int = -1
             ) -> torch.Tensor:
    """min-plus envelope of fp32 ``g`` along ``axis``. CPU tensors take
    :func:`envelope_plain`; CUDA tensors launch the CUDA kernel on the
    current stream."""
    global launches
    if g.device.type == "cpu":
        return envelope_plain(g, sampling, axis)
    if g.device.type != "cuda":
        raise ValueError(f"edt envelope: no kernel for device {g.device}")
    if g.dtype != torch.float32:
        raise TypeError(f"edt envelope: g must be fp32, got {g.dtype}")
    if not g.is_contiguous():
        raise ValueError("edt envelope: g must be contiguous")
    axis = axis % g.dim()
    n = g.shape[axis]
    if n > MAX_N:
        raise ValueError(f"edt envelope: lines of {n} > {MAX_N} elements")
    outer = math.prod(g.shape[:axis])
    inner = math.prod(g.shape[axis + 1:])
    out = torch.empty_like(g)
    lib = _library()
    # the library launches on the current device: make it g's
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = lib.brats_edt_envelope(g.data_ptr(), out.data_ptr(), outer, n, inner,
                                    float(sampling), stream)
    if rc != 0:
        raise RuntimeError(f"edt envelope launch failed: "
                           f"{lib.brats_edt_error_string(rc).decode()}")
    launches += 1
    return out
