"""The control's precision, the step below the bfloat16 activations the
configurations state: fp8. Every GEMM operand and every module's output
is rounded to float8 E4M3 with one scale a tensor (its largest magnitude
maps to the format's largest finite value); products, sums and the
elementwise arithmetic inside a module stay float32."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def round_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 E4M3 with a per-tensor scale, back in its dtype."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
