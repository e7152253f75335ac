"""Sliding-window inference on the card.

Port of ``brats21_tpu/ops/sliding_window.py`` (reference
utils/inferers.py:26-162, a MONAI fork). The volume, the weighted
accumulator and the count map stay on the device: windows are cut from the
padded volume in batches of ``sw_batch_size``, each batch is one predictor
call, and each window's weighted logits are added in place into its slice
of the accumulator. No window crosses to the host.

Semantics preserved: overlap 0.25 scan intervals (:111,165-186), Gaussian
importance map with σ = 0.125·roi (:119-121), pad-to-roi then crop
(:104-109, 156-162), deep-supervision head[0] selection (:135-138).
Where the JAX version fills the last batch with copies of the last window
at zero weight, this one sends a shorter last batch; the sums are the same.

Spans (``utils/profiling.annotate``, recorded while a profiler runs):
``sw.predict`` around each predictor call (its count ``windows``, the
batch's windows), ``sw.stitch`` around each batch's weighted adds and
around the final division.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import annotate
from .tta import main_head


def get_scan_interval(image_size: Sequence[int], roi_size: Sequence[int],
                      overlap: float = 0.25) -> Tuple[int, ...]:
    """Reference _get_scan_interval (inferers.py:165-186)."""
    out = []
    for im, roi in zip(image_size, roi_size):
        if roi == im:
            out.append(int(roi))
        else:
            interval = int(roi * (1 - overlap))
            out.append(interval if interval > 0 else 1)
    return tuple(out)


def dense_patch_starts(image_size: Sequence[int], roi_size: Sequence[int],
                       scan_interval: Sequence[int]) -> np.ndarray:
    """Window start offsets (MONAI dense_patch_slices semantics): per-axis
    starts at i*interval, last start clipped to size-roi. [N, 3] int32."""
    per_axis: List[List[int]] = []
    for im, roi, step in zip(image_size, roi_size, scan_interval):
        scan_num = int(math.ceil((im - roi) / step) + 1) if im > roi else 1
        per_axis.append(sorted({min(i * step, im - roi) for i in range(scan_num)}))
    grid = np.stack(np.meshgrid(*per_axis, indexing="ij"), axis=-1)
    return grid.reshape(-1, 3).astype(np.int32)


def gaussian_importance_map(roi_size: Sequence[int],
                            sigma_scale: float = 0.125) -> np.ndarray:
    """Separable Gaussian centered on the patch, max-normalized, zero floor
    lifted to the smallest positive value (MONAI compute_importance_map)."""
    axes = []
    for s in roi_size:
        center = (s - 1) / 2.0
        sigma = sigma_scale * s
        i = np.arange(s, dtype=np.float64)
        axes.append(np.exp(-0.5 * ((i - center) / sigma) ** 2))
    m = axes[0][:, None, None] * axes[1][None, :, None] * axes[2][None, None, :]
    m = m / m.max()
    m = np.maximum(m, m[m > 0].min())
    return m.astype(np.float32)


def window_plan(spatial: Sequence[int], roi_size: Sequence[int],
                overlap: float = 0.25) -> Tuple[List[int], List[Tuple[int, int]], np.ndarray]:
    """(roi, per-axis (before, after) pad to at least the roi, window
    starts [N, 3] in the padded volume)."""
    roi = [min(r, max(s, r)) for r, s in zip(roi_size, spatial)]
    pads = [((r - s) // 2, (r - s) - (r - s) // 2) if r > s else (0, 0)
            for s, r in zip(spatial, roi)]
    padded = [s + b + a for s, (b, a) in zip(spatial, pads)]
    starts = dense_patch_starts(padded, roi, get_scan_interval(padded, roi, overlap))
    return roi, pads, starts


def sliding_window_inference(
        inputs: torch.Tensor,
        roi_size: Sequence[int],
        predictor: Callable[[torch.Tensor], Any],
        sw_batch_size: int = 2,
        overlap: float = 0.25,
        mode: str = "constant",  # reference default (inferers.py:32); 'gaussian' available
) -> torch.Tensor:
    """Stitched full-volume fp32 logits of ``predictor`` over channels-last
    ``[B, X, Y, Z, C]``, as ``[B, X, Y, Z, C_out]``.

    ``predictor`` takes a channels-last batch ``[n·B, *roi, C]`` of windows
    and returns logits, or ``(logits, deeps)``, in the same layout; only
    head[0] is kept (inferers.py:135-138)."""
    return stitch_windows(inputs, roi_size, predictor, sw_batch_size, overlap, mode)


def stitch_windows(inputs: torch.Tensor, roi_size: Sequence[int],
                   predictor: Callable[[torch.Tensor], Any], sw_batch_size: int = 2,
                   overlap: float = 0.25, mode: str = "constant",
                   select: Callable[[np.ndarray], np.ndarray] = lambda starts: starts,
                   reduce: Callable[[torch.Tensor], torch.Tensor] = lambda t: t,
                   out_channels: Optional[int] = None) -> torch.Tensor:
    """:func:`sliding_window_inference` over the windows ``select`` keeps
    of the plan's, with the weighted sums and the count map passed through
    ``reduce`` before the division (window parallelism,
    ``parallel/distributed.py``: each rank's windows, sums all-reduced).
    ``out_channels`` sizes the accumulators of a selection with no window."""
    b, *spatial, c_in = inputs.shape
    roi, pads, starts = window_plan(spatial, roi_size, overlap)
    starts = select(starts)
    # pad to at least roi, half before (inferers.py:104-109)
    flat_pads = [0, 0]
    for before, after in reversed(pads):
        flat_pads += [before, after]
    x = F.pad(inputs, flat_pads) if any(map(sum, pads)) else inputs
    padded = x.shape[1:4]
    if mode == "gaussian":
        imp = torch.from_numpy(gaussian_importance_map(roi)).to(x.device)
    else:
        imp = torch.ones(roi, dtype=torch.float32, device=x.device)
    imp = imp[None, :, :, :, None]

    def zeros(c: int) -> torch.Tensor:
        return torch.zeros((b, *padded, c), dtype=torch.float32, device=x.device)

    out_sum = None if out_channels is None else zeros(out_channels)
    count = torch.zeros((1, *padded, 1), dtype=torch.float32, device=x.device)
    for i in range(0, len(starts), sw_batch_size):
        group = starts[i:i + sw_batch_size]
        with annotate("sw.predict", windows=len(group)):
            wins = torch.cat([x[:, s0:s0 + roi[0], s1:s1 + roi[1], s2:s2 + roi[2]]
                              for s0, s1, s2 in group])
            preds = main_head(predictor(wins)).float()
        with annotate("sw.stitch"):
            if out_sum is None:
                out_sum = zeros(preds.shape[-1])
            for j, (s0, s1, s2) in enumerate(group):
                sl = (slice(None), slice(s0, s0 + roi[0]), slice(s1, s1 + roi[1]),
                      slice(s2, s2 + roi[2]))
                out_sum[sl] += imp * preds[j * b:(j + 1) * b]
                count[sl] += imp
    with annotate("sw.stitch"):
        stitched = reduce(out_sum) / reduce(count)
    # crop the pad-to-roi margins (inferers.py:156-162)
    return stitched[(slice(None),) + tuple(
        slice(before, before + s) for (before, _), s in zip(pads, spatial))]
