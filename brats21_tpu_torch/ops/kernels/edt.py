"""EDT lower envelope along one axis — CUDA C++ (``csrc/edt_envelope.cu``).

Replaces ``brats21_tpu/ops/pallas/edt_kernel.py:envelope_last_axis`` (body
``_envelope_kernel`` :28): ``out[i] = min(1e12, min_j g[j] + (s·(i − j))²)``
along one axis, in fp32. It is one pass of the separable exact EDT
(``ops/edt.py``).

The kernels compute the lower envelope of the parabolas in O(n) a line, so
the function is bound by its bytes: lines at unit sampling with integer
values take Felzenszwalb-Huttenlocher's stack with integer separators, each
line cut into four bands whose stacks one thread joins; other lines take
Meijster's two phases with an fp32 separator. The tensor is taken as
``[outer, n, inner]``, so a pass runs along any axis through its stride.
:func:`envelope_mask` is the first pass of a mask: it reads the bool mask
itself, 1 byte an element. At unit sampling with integer values (every
mask) both equal :func:`envelope_plain`, the scan, bit for bit; at other
samplings the general pass is within a rounding of it (rtol 1e-6), the mask
pass still bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from . import load_library

#: launches of the CUDA kernels (general and mask pass) since the last reset
#: (read by chip_smoke.py); the train loader's threads launch too
launches = 0
_count_lock = threading.Lock()

SOURCE = "edt_envelope.cu"
INF = 1e12          # the JAX package's sentinel (ops/edt.py:_INF)
MAX_N = 768         # two [n, 33] 4-byte tiles + 1.5 KB fit a block's 227 KB to 854


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


def envelope_mask_plain(mask: torch.Tensor, sampling: float = 1.0, axis: int = -1
                        ) -> torch.Tensor:
    """The plain version of the mask pass: :func:`envelope_plain` of
    ``where(mask, 1e12, 0)`` in fp32."""
    return envelope_plain(torch.where(mask.bool(), INF, 0.0).to(torch.float32),
                          sampling, axis)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.brats_edt_envelope.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
    lib.brats_edt_envelope.restype = ctypes.c_int
    lib.brats_edt_envelope_mask.argtypes = lib.brats_edt_envelope.argtypes
    lib.brats_edt_envelope_mask.restype = ctypes.c_int
    lib.brats_edt_error_string.argtypes = [ctypes.c_int]
    lib.brats_edt_error_string.restype = ctypes.c_char_p
    return lib


def take_launches() -> int:
    """The count since the last reset, read and zeroed under the lock the
    loader's threads count under, so that no launch falls between."""
    global launches
    with _count_lock:
        taken, launches = launches, 0
    return taken


def _launch(fn, x: torch.Tensor, sampling: float, axis: int) -> torch.Tensor:
    """Launch ``fn`` of the library along ``axis`` of contiguous ``x`` on
    the current stream of its card; returns the fp32 result."""
    global launches
    if not x.is_contiguous():
        raise ValueError("edt envelope: the input must be contiguous")
    axis = axis % x.dim()
    n = x.shape[axis]
    if n > MAX_N:
        raise ValueError(f"edt envelope: lines of {n} > {MAX_N} elements")
    outer = math.prod(x.shape[:axis])
    inner = math.prod(x.shape[axis + 1:])
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    lib = _library()
    # the library launches on the current device: make it x's
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, fn)(x.data_ptr(), out.data_ptr(), outer, n, inner,
                              float(sampling), stream)
    if rc != 0:
        raise RuntimeError(f"edt envelope launch failed: "
                           f"{lib.brats_edt_error_string(rc).decode()}")
    with _count_lock:
        launches += 1
    return out


def envelope(g: torch.Tensor, sampling: float = 1.0, axis: int = -1
             ) -> torch.Tensor:
    """min-plus envelope of fp32 ``g`` along ``axis``. CPU tensors take
    :func:`envelope_plain`; CUDA tensors launch the CUDA kernel on the
    current stream."""
    if g.device.type == "cpu":
        return envelope_plain(g, sampling, axis)
    if g.device.type != "cuda":
        raise ValueError(f"edt envelope: no kernel for device {g.device}")
    if g.dtype != torch.float32:
        raise TypeError(f"edt envelope: g must be fp32, got {g.dtype}")
    return _launch("brats_edt_envelope", g, sampling, axis)


def envelope_mask(mask: torch.Tensor, sampling: float = 1.0, axis: int = -1
                  ) -> torch.Tensor:
    """The envelope of ``where(mask, 1e12, 0)`` along ``axis`` (the squared
    1-D distance to the nearest False), fp32, from a bool or uint8 mask.
    CPU tensors take :func:`envelope_mask_plain`; CUDA tensors launch the
    mask kernel, which reads the mask's bytes (made contiguous first)."""
    if mask.device.type == "cpu":
        return envelope_mask_plain(mask, sampling, axis)
    if mask.device.type != "cuda":
        raise ValueError(f"edt envelope: no kernel for device {mask.device}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"edt envelope: the mask must be bool or uint8, got {mask.dtype}")
    return _launch("brats_edt_envelope_mask", mask.contiguous(), sampling, axis)
