"""The served path with sliding windows, plain: a raw case's 16-combo TTA
mean of the sigmoid of logits stitched from ``roi``³ windows, as the
published reference's inference does it with ``--sliding_window_inference``
(github.com/Alxaline/BraTS21, ``src/utils/inferers.py``, a MONAI fork:
overlap 0.25, constant weights, windows cut from the volume padded to at
least the roi, half the pad before, and the stitched logits cropped back).

Written from those semantics, not from the program's
``ops/sliding_window.py``; the crop, z-score, pad and post-processing are
``serve.py``'s. Windows go through the network one at a time, float32 with
TF32 off.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import serve


def scan_starts(size: int, roi: int, overlap: float = 0.25) -> List[int]:
    """Window starts along one axis of ``size`` (at least ``roi``): steps of
    ``int(roi·(1 − overlap))``, the last start clipped to ``size − roi``."""
    if size <= roi:
        return [0]
    step = max(int(roi * (1 - overlap)), 1)
    count = int(math.ceil((size - roi) / step)) + 1
    return sorted({min(i * step, size - roi) for i in range(count)})


def plan(shape: Sequence[int], roi: Sequence[int], overlap: float = 0.25
         ) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int, int]]]:
    """(per-axis (before, after) pad up to the roi, window starts in the
    padded volume, in (x, y, z) order)."""
    pads = [((r - s) // 2, r - s - (r - s) // 2) if s < r else (0, 0)
            for s, r in zip(shape, roi)]
    padded = [s + a + b for s, (a, b) in zip(shape, pads)]
    axes = [scan_starts(p, r, overlap) for p, r in zip(padded, roi)]
    return pads, [(a, b, c) for a in axes[0] for b in axes[1] for c in axes[2]]


def stitched_logits(model, x: torch.Tensor, roi: Sequence[int], overlap: float = 0.25
                    ) -> torch.Tensor:
    """Logits ``[1, classes, *x.shape[2:]]`` of ``x`` ``[1, C, s0, s1, s2]``:
    each window's logits summed where it lies, over the count of windows
    covering each voxel."""
    shape = x.shape[2:]
    pads, starts = plan(shape, roi, overlap)
    flat = [p for a, b in reversed(pads) for p in (a, b)]
    v = torch.nn.functional.pad(x, flat) if any(a or b for a, b in pads) else x
    acc = count = None
    for s0, s1, s2 in starts:
        win = v[:, :, s0:s0 + roi[0], s1:s1 + roi[1], s2:s2 + roi[2]].contiguous()
        y = model(win, with_deep=False).float()
        if acc is None:
            acc = torch.zeros((1, y.shape[1], *v.shape[2:]), dtype=torch.float32,
                              device=x.device)
            count = torch.zeros((1, 1, *v.shape[2:]), dtype=torch.float32, device=x.device)
        acc[:, :, s0:s0 + roi[0], s1:s1 + roi[1], s2:s2 + roi[2]] += y
        count[:, :, s0:s0 + roi[0], s1:s1 + roi[1], s2:s2 + roi[2]] += 1.0
    out = acc / count
    return out[(slice(None), slice(None)) + tuple(
        slice(a, a + s) for (a, _), s in zip(pads, shape))]


def tta_probs(model, x: torch.Tensor, roi: Sequence[int], overlap: float = 0.25
              ) -> torch.Tensor:
    """Mean sigmoid over the 16 combos (axis order × horizontal flip ×
    rotation in the first two spatial axes) of the stitched logits, each
    de-augmented. ``x`` is [1, C, s0, s1, s2] with s0 == s1."""
    acc = torch.zeros((1, 3, *x.shape[2:]), dtype=torch.float32, device=x.device)
    n = 0
    for axe in serve.AXES:
        for flip in serve.FLIPS:
            for angle in serve.ANGLES:
                k = angle // 90
                v = x.permute(0, 1, 3, 4, 2) if axe == "xyz" else x
                if flip:
                    v = torch.flip(v, dims=(3,))
                v = torch.rot90(v, k, dims=(2, 3))
                y = stitched_logits(model, v, roi, overlap)
                y = torch.rot90(y, -k, dims=(2, 3))
                if flip:
                    y = torch.flip(y, dims=(3,))
                if axe == "xyz":
                    y = y.permute(0, 1, 4, 2, 3)
                acc += torch.sigmoid(y)
                n += 1
    return acc / n


def padded_case(raw: np.ndarray) -> Tuple[np.ndarray, Dict]:
    """A raw case [X, Y, Z, 4] cropped, z-scored, padded to multiples of 8
    and square in X, Y (``serve.probabilities``' steps), and that space's
    geometry."""
    box, _, _ = serve.crop_foreground(raw)
    img = serve.zscore(raw[box])
    padded, before, after = serve.pad_divisible(img)
    side = max(padded.shape[0], padded.shape[1])
    extra = (side - padded.shape[0], side - padded.shape[1])
    padded = np.pad(padded, [(0, extra[0]), (0, extra[1]), (0, 0), (0, 0)])
    after = after + np.array([extra[0], extra[1], 0])
    geom = dict(box=box, before=before, after=after, shape=raw.shape[:3],
                brain=(padded != 0).any(axis=-1))
    return padded, geom


@torch.no_grad()
def probabilities(model, raw: np.ndarray, device: torch.device, roi: Sequence[int],
                  overlap: float = 0.25) -> Tuple[np.ndarray, Dict]:
    """The 16-combo TTA mean probabilities [X', Y', Z', 3] of one raw case
    through windows of ``roi``, in the padded crop's space, and its
    geometry (``serve.finish`` and ``serve.label_margin`` take both)."""
    padded, geom = padded_case(raw)
    x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(padded, -1, 0)))[None].to(device)
    probs = tta_probs(model, x, roi, overlap)[0].permute(1, 2, 3, 0).cpu().numpy()
    return probs, geom
