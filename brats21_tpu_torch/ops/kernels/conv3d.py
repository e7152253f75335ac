"""3×3×3 convolution (stride 1, padding 1) — CUDA C++ implicit GEMM.

Replaces ``brats21_tpu/ops/pallas/conv3d_kernel.py:_conv3x3x3_pallas``
(kernel body ``_conv_kernel`` :52), which builds an im2col block in VMEM and
issues one MXU dot per tile. On the H100 the same work — 2·M·C_out·27·C_in
operations on (C_in + C_out) bytes per voxel — is far above the card's
ridge point at the model's widths, so the tensor cores bound it. The bf16
kernel (``csrc/conv3x3x3.cu``) is a warp-specialised ``wgmma`` implicit
GEMM: a block computes a brick of 4×8×8 (at 48 channels) or 2×8×8 output
voxels for one N tile of 48, 96 or 192 output channels; a producer warp brings each 8-channel input
box with its halo in one TMA load (the out-of-bounds fill is the zero
halo) and the weights as one bulk copy per group of taps; every tap is a
shifted window of the same box, read by the ``wgmma`` descriptor directly.
Where bricks × N tiles fall under one wave of the card's SMs, K is split
over C_in chunks into an fp32 workspace and summed by a second launch.
fp32 inputs (``--no_amp``) take a plain FMA tile kernel in the same
library, at any shape.

The host side lives here: :func:`conv_plan` (C_in padded to 16, the N tile,
bricks and split-K count) and :func:`pack_weights` (the layout the kernel's
descriptors read).

Layout contract (the JAX package's): x ``[B, D, H, W, C_in]`` contiguous,
w ``[3, 3, 3, C_in, C_out]`` in x's dtype, bias ``[C_out]`` fp32; the output
is ``[B, D, H, W, C_out]`` in x's dtype.

:class:`Conv3x3x3Function` makes it trainable as ``conv3d_kernel.py:141-156``
does: the forward is the kernel, the backward is the plain version's
(:func:`conv3x3x3_plain_grads`) from the saved (x, w), with no hand-written
backward kernel, as the JAX package has none.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import load_library

#: launches of the CUDA kernel since the last reset (read by chip_smoke.py)
launches = 0

SOURCE = "conv3x3x3.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NUM_SMS = 132                # H100 SXM: one block of the bf16 kernel per SM
BRICK_HW = (8, 8)            # output voxels (h, w) of one block's brick
K_CHUNK = 16                 # input channels per K chunk (one wgmma k16 step)
N_TILES = (48, 96, 192)      # wgmma widths the library is built for


@dataclass(frozen=True)
class ConvPlan:
    """How the bf16 kernel covers one call: x padded to ``c_in`` channels,
    the output to ``c_out`` = ``bn`` · ``n_tiles``; a grid of ``bricks`` ×
    ``n_tiles`` × ``splits`` blocks, split ``s`` running K chunks
    [s·``chunks_per_split``, (s + 1)·``chunks_per_split``) ∩ [0, ``chunks``).
    With ``brick`` = (bd, 8, 8), block x = ((b·nd + dz)·nh + hy)·nw + wx
    computes voxels (bd·dz + [0, bd), 8·hy + [0, 8), 8·wx + [0, 8)),
    masked to the volume."""

    c_in: int
    c_out: int
    bn: int
    n_tiles: int
    brick: tuple
    bricks_dhw: tuple
    bricks: int
    chunks: int
    splits: int
    chunks_per_split: int


def conv_plan(b: int, d: int, h: int, w: int, c_in: int, c_out: int) -> ConvPlan:
    """The launch plan of the bf16 kernel. K is split only where the grid
    of bricks × N tiles is under one wave of ``NUM_SMS`` blocks: into at
    least two parts and as many as fill one wave, bounded by the chunks."""
    c_in_p = -(-c_in // K_CHUNK) * K_CHUNK
    bn = next((n for n in N_TILES if c_out <= n), N_TILES[-1])
    n_tiles = -(-c_out // bn)
    brick = (4 if bn == 48 else 2, *BRICK_HW)    # Cfg<BN>::BRICK_D in the source
    bricks_dhw = tuple(-(-s // k) for s, k in zip((d, h, w), brick))
    bricks = b * bricks_dhw[0] * bricks_dhw[1] * bricks_dhw[2]
    chunks = c_in_p // K_CHUNK
    grid = bricks * n_tiles
    splits = 1 if grid >= NUM_SMS else min(chunks, max(2, NUM_SMS // grid))
    per_split = -(-chunks // splits)
    splits = -(-chunks // per_split)
    return ConvPlan(c_in_p, bn * n_tiles, bn, n_tiles, brick, bricks_dhw, bricks, chunks,
                    splits, per_split)


def pack_weights(w: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """w ``[3, 3, 3, C_in, C_out]`` zero-padded to the plan's channels and
    reordered into the kernel's B operand, flat, with the index map

        packed[nt, c, tap, half, ng, n8, k8]
            = w[tap // 9, tap // 3 % 3, tap % 3, 16·c + 8·half + k8, bn·nt + 8·ng + n8]

    so each (N tile nt, K chunk c) holds 27 taps of K-major core matrices
    (8 output channels × 8 input channels, 128 bytes) and any run of taps
    is one contiguous copy."""
    c_in, c_out = w.shape[3], w.shape[4]
    w = F.pad(w, (0, plan.c_out - c_out, 0, plan.c_in - c_in))
    w = w.reshape(27, plan.chunks, 2, 8, plan.n_tiles, plan.bn // 8, 8)
    return w.permute(4, 1, 0, 2, 5, 6, 3).contiguous()


def conv3x3x3_plain(x: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version (``_conv3x3x3_xla`` semantics):
    conv3d in x's dtype, then + bias in x's dtype."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.to(x.dtype).permute(4, 3, 0, 1, 2),
                 padding=1)
    return y.permute(0, 2, 3, 4, 1) + bias.to(y.dtype)


def conv3x3x3_plain_grads(x: torch.Tensor, w: torch.Tensor, grad: torch.Tensor,
                          needs=(True, True, True)):
    """(dx, dw, dbias) of :func:`conv3x3x3_plain` at (x, w) for the output
    gradient ``grad``, each None where ``needs`` says so: the convolution's
    own backward (``aten.convolution_backward``, the node autograd of the
    plain version runs, without re-running the forward it does not need)
    and the bias add's sum in the output's dtype. Equal to autograd of
    :func:`conv3x3x3_plain` bit for bit."""
    dx = dw = dbias = None
    if needs[0] or needs[1]:
        dx, dw, _ = torch.ops.aten.convolution_backward(
            grad.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3),
            w.to(x.dtype).permute(4, 3, 0, 1, 2), None, [1, 1, 1], [1, 1, 1],
            [1, 1, 1], False, [0, 0, 0], 1, [bool(needs[0]), bool(needs[1]), False])
        dx = dx.permute(0, 2, 3, 4, 1) if needs[0] else None
        dw = dw.permute(2, 3, 4, 1, 0).to(w.dtype) if needs[1] else None
    if needs[2]:
        dbias = grad.sum(dim=(0, 1, 2, 3))
    return dx, dw, dbias


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.brats_conv3x3x3.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
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
    b, d, h, wd, c_in = x.shape
    c_out = w.shape[-1]
    ws = None
    if x.dtype == torch.bfloat16:
        plan = conv_plan(b, d, h, wd, c_in, c_out)
        # zero channels add nothing: C_in to whole k16 steps, C_out to N tiles
        x = F.pad(x, (0, plan.c_in - c_in)) if plan.c_in != c_in else x
        w = pack_weights(w, plan)
        bias = F.pad(bias, (0, plan.c_out - c_out))
        args = (plan.c_in, plan.c_out, _DTYPES[x.dtype], plan.bn, plan.splits)
        if plan.splits > 1:
            ws = torch.empty((plan.splits, b * d * h * wd, plan.c_out),
                             dtype=torch.float32, device=x.device)
    else:
        args = (c_in, c_out, _DTYPES[x.dtype], 0, 1)
    out = torch.empty((b, d, h, wd, args[1]), dtype=x.dtype, device=x.device)
    lib = _library()
    # the library launches on the current device: make it x's
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.brats_conv3x3x3(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                 out.data_ptr(), None if ws is None else ws.data_ptr(),
                                 b, d, h, wd, *args, stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3x3 launch failed: "
                           f"{lib.brats_cuda_error_string(rc).decode()}")
    launches += 1
    if out.shape[-1] != c_out:
        out = out[..., :c_out].contiguous()
    return out


class Conv3x3x3Function(torch.autograd.Function):
    """Trainable :func:`conv3x3x3` (``conv3d_kernel.py:141-156``): the
    forward is the wrapper (the CUDA kernel on a card, the plain version on
    the CPU), the backward :func:`conv3x3x3_plain_grads` from the saved
    (x, w). The backward launches no hand-written kernel."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor
                ) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = bias.dtype
        return conv3x3x3(x, w, bias)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        x, w = ctx.saved_tensors
        dx, dw, dbias = conv3x3x3_plain_grads(x, w, grad, ctx.needs_input_grad)
        return dx, dw, None if dbias is None else dbias.to(ctx.bias_dtype)
