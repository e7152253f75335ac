"""3×3×3 convolution (stride 1, padding 1) — CUDA C++ implicit GEMM.

Replaces ``brats21_tpu/ops/pallas/conv3d_kernel.py:_conv3x3x3_pallas``
(kernel body ``_conv_kernel`` :52), which builds an im2col block in VMEM and
issues one MXU dot per tile. On the H100 the same work — 2·M·C_out·27·C_in
operations on (C_in + C_out) bytes per voxel — is far above the card's
ridge point at the model's widths, so the tensor cores bound it. The kernels
(``csrc/conv3x3x3.cu``) keep im2col out of device memory too: each block
gathers its [128 voxels × 32 k] tile straight into shared memory with a
zero halo, stages the [32 k × 64 or 128 C_out] weight tile, and runs bf16
WMMA fragments with fp32 accumulation; the bias is fused into the epilogue.
In bf16 both tiles arrive by ``cp.async``, 16 bytes (8 channels) a copy,
through a 4-deep ring, so the wrapper zero-pads C_in and C_out to multiples
of 8 (the model's 4-channel stem; ragged test shapes). fp32 inputs
(``--no_amp``) take a plain FMA tile kernel in the same library, at any
shape.

Layout contract (the JAX package's): x ``[B, D, H, W, C_in]`` contiguous,
w ``[3, 3, 3, C_in, C_out]`` in x's dtype, bias ``[C_out]`` fp32; the output
is ``[B, D, H, W, C_out]`` in x's dtype. There is no backward yet.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import load_library

#: launches of the CUDA kernel since the last reset (read by chip_smoke.py)
launches = 0

SOURCE = "conv3x3x3.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def conv3x3x3_plain(x: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version (``_conv3x3x3_xla`` semantics):
    conv3d in x's dtype, then + bias in x's dtype."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.to(x.dtype).permute(4, 3, 0, 1, 2),
                 padding=1)
    return y.permute(0, 2, 3, 4, 1) + bias.to(y.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.brats_conv3x3x3.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    lib.brats_conv3x3x3.restype = ctypes.c_int
    lib.brats_cuda_error_string.argtypes = [ctypes.c_int]
    lib.brats_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dim() != 5:
        raise ValueError(f"conv3x3x3: x must be [B, D, H, W, C_in], got {tuple(x.shape)}")
    c_in = x.shape[-1]
    if w.shape[:4] != (3, 3, 3, c_in) or w.dim() != 5:
        raise ValueError(f"conv3x3x3: w must be [3, 3, 3, {c_in}, C_out], "
                         f"got {tuple(w.shape)}")
    if bias.shape != (w.shape[-1],):
        raise ValueError(f"conv3x3x3: bias must be [{w.shape[-1]}], got {tuple(bias.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype or bias.dtype != torch.float32:
        raise TypeError(f"conv3x3x3: x and w must be both fp32 or both bf16 and "
                        f"bias fp32, got {x.dtype}, {w.dtype}, {bias.dtype}")
    if not (x.device == w.device == bias.device):
        raise ValueError("conv3x3x3: x, w and bias must be on one device")
    for name, t in (("x", x), ("w", w), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"conv3x3x3: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"conv3x3x3: {name} must be 16-byte aligned")
    if x.numel() >= 2 ** 31 or x.shape[:4].numel() * w.shape[-1] >= 2 ** 31:
        raise ValueError("conv3x3x3: tensors of 2**31 elements or more")


def conv3x3x3(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """y = conv3d(x, w, stride 1, SAME) + bias, fp32 accumulation, output in
    x's dtype. CPU tensors take :func:`conv3x3x3_plain`; CUDA tensors
    launch the CUDA kernel on the current stream."""
    global launches
    if x.device.type == "cpu":
        return conv3x3x3_plain(x, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3x3: no kernel for device {x.device}")
    _check(x, w, bias)
    c_out = w.shape[-1]
    pad_in, pad_out = -x.shape[-1] % 8, -c_out % 8
    if x.dtype == torch.bfloat16 and (pad_in or pad_out):
        # the bf16 kernel copies 8 channels at a time: zero channels add nothing
        x = F.pad(x, (0, pad_in))
        w = F.pad(w, (0, pad_out, 0, pad_in))
        bias = F.pad(bias, (0, pad_out))
    b, d, h, wd, c_in = x.shape
    out = torch.empty((b, d, h, wd, w.shape[-1]), dtype=x.dtype, device=x.device)
    lib = _library()
    # the library launches on the current device: make it x's
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.brats_conv3x3x3(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                 out.data_ptr(), b, d, h, wd, c_in, w.shape[-1],
                                 _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3x3 launch failed: "
                           f"{lib.brats_cuda_error_string(rc).decode()}")
    launches += 1
    if out.shape[-1] != c_out:
        out = out[..., :c_out].contiguous()
    return out
