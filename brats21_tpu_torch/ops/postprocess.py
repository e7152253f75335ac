"""BraTS post-processing on the card.

Port of ``brats21_tpu/ops/postprocess.py``. Reference chain
(definer.py:679-698, engine.py:249-259): threshold@0.5 →
multichannel→BraTS labels → 3→4 → KeepLargestConnectedComponent(threshold)
→ ReplaceWithClosestValue(thresh) → back to multichannel.

* threshold + label codecs: elementwise tensor ops (channels-last).
* connected components: iterative min-label propagation (3³ min-pool until
  fixpoint) + component sizes by ``bincount`` — the same partition as
  skimage ``morphology.label`` with 26-connectivity.
* replace-with-closest: per-axial-slice nearest-neighbour reassignment via
  a two-pass argmin envelope, each pass a loop over one axis of tensor ops
  batched over every axial slice. Ties resolve to the lowest index, as in
  the JAX package, so the two agree exactly.
* scipy host twins of each step back the tests.

Spans (``utils/profiling.py``, recorded while a profiler runs):
``post.process`` around the chain, ``post.components`` and
``post.replace`` around its two loops, each with ``reads``, the host reads
that make the thread wait for the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from ..utils.profiling import annotate

_INF = 3.0e38   # background label / unreached cost, as the JAX package's


# ---------------------------------------------------------------------------
# threshold + codecs
# ---------------------------------------------------------------------------


def threshold_probs(probs: torch.Tensor, logit_thresh: float = 0.5) -> torch.Tensor:
    """AsDiscrete(threshold_values=True) (definer.py:682-683)."""
    return (probs >= logit_thresh).float()


def multichannel_to_brats(channels: torch.Tensor) -> torch.Tensor:
    """[..., 3] WT/TC/ET binaries → label map {0,1,2,3} with ET→NET→ED
    precedence (transforms.py:169-193)."""
    wt = channels[..., 0] > 0
    tc = channels[..., 1] > 0
    et = channels[..., 2] > 0
    out = torch.zeros(channels.shape[:-1], dtype=torch.float32,
                      device=channels.device)
    out = torch.where(wt & ~tc, 2.0, out)
    out = torch.where(tc & ~et, 1.0, out)
    return torch.where(et, 3.0, out)


def change_label_3_to_4(label_map: torch.Tensor) -> torch.Tensor:
    return torch.where(label_map == 3.0, 4.0, label_map)


def brats_to_multichannel(label_map: torch.Tensor) -> torch.Tensor:
    """Labels {1,2,4} → [..., 3] WT/TC/ET (transforms.py:145-166)."""
    l1 = label_map == 1
    l2 = label_map == 2
    l4 = label_map == 4
    return torch.stack([l1 | l2 | l4, l1 | l4, l4], dim=-1).float()


# ---------------------------------------------------------------------------
# connected components
# ---------------------------------------------------------------------------


def _min_pool3(x: torch.Tensor) -> torch.Tensor:
    """3³ min-pool, stride 1, SAME — one label-propagation sweep."""
    return -F.max_pool3d(-x[None, None], 3, stride=1, padding=1)[0, 0]


def label_components(mask: torch.Tensor) -> torch.Tensor:
    """Connected-component labels of a 3D bool mask (26-connectivity, as
    skimage ``morphology.label``). Background = 0; labels are distinct
    positive ints (the component's smallest flat index + 1)."""
    return _label_components(mask)[0]


def _label_components(mask: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(:func:`label_components`, its sweeps): each sweep ends in a
    ``torch.equal``, a host read."""
    n = mask.numel()
    # labels are exact in fp32 below 2**24 voxels
    dtype = torch.float32 if n < 2 ** 24 else torch.float64
    ids = torch.arange(1, n + 1, dtype=dtype, device=mask.device).reshape(mask.shape)
    labels = torch.where(mask, ids, _INF)
    sweeps = 0
    while True:
        new = torch.where(mask, torch.minimum(labels, _min_pool3(labels)), _INF)
        sweeps += 1
        if torch.equal(new, labels):
            break
        labels = new
    return torch.where(mask, labels, 0.0).long(), sweeps


def filter_components(volume: torch.Tensor, threshold: float) -> torch.Tensor:
    """get_largest_component with a size threshold (transforms.py:579-600):
    zero out components of size ≤ threshold. ``volume`` is a label map;
    any nonzero voxel belongs to the foreground. Span ``post.components``,
    ``reads`` the host reads of the sweeps and of ``bincount``."""
    with annotate("post.components") as span:
        mask = volume != 0
        labels, sweeps = _label_components(mask)
        span.count("reads", sweeps)
        flat = labels.reshape(-1)
        sizes = torch.bincount(flat, weights=mask.reshape(-1).float(),
                               minlength=volume.numel() + 1)
        span.count("reads")     # bincount reads its input's maximum on the host
        sizes[0] = 0.0
        keep = (sizes[flat] > threshold).reshape(volume.shape)
        return torch.where(keep & mask, volume, torch.zeros_like(volume))


# ---------------------------------------------------------------------------
# replace-with-closest: per-axial-slice nearest neighbour
# ---------------------------------------------------------------------------


def _envelope_argmin(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """1D lower envelope along the last axis with its argmin:
    best[i] = min_j g[j] + (i − j)², first j on ties. g: [..., n] fp32."""
    n = g.shape[-1]
    idx = torch.arange(n, dtype=torch.float32, device=g.device)
    best = torch.full_like(g, _INF)
    bestj = torch.zeros(g.shape, dtype=torch.long, device=g.device)
    for j in range(n):
        cand = g[..., j:j + 1] + (idx - j) ** 2
        take = cand < best
        best = torch.where(take, cand, best)
        bestj = torch.where(take, j, bestj)
    return best, bestj


def nearest_feature_2d(mask_valid: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """For each pixel of each 2D grid, the value of the nearest valid pixel
    (euclidean; scipy griddata method='nearest', transforms.py:603-624).
    mask_valid, values: [N, H, W] — N slices at once."""
    f0 = torch.where(mask_valid, 0.0, _INF)
    d1, src_w = _envelope_argmin(f0)                       # along W
    _, src_h_t = _envelope_argmin(d1.transpose(1, 2))      # along H
    src_h = src_h_t.transpose(1, 2)                        # best row h*
    # the source pixel of (h, w) is (h*, src_w[h*, w])
    src_w_final = torch.gather(src_w, 1, src_h)
    flat = src_h * values.shape[2] + src_w_final
    return torch.gather(values.reshape(values.shape[0], -1), 1,
                        flat.reshape(values.shape[0], -1)).reshape(values.shape)


def replace_small_values_axial(label_map: torch.Tensor,
                               thresh: float = 20.0) -> torch.Tensor:
    """ReplaceWithClosestValue (transforms.py:233-268, 627-647): label values
    whose total voxel count ≤ thresh are re-assigned, per axial slice
    (axis 2), to the nearest surviving label. label_map: [X, Y, Z] float
    labels {0,1,2,4}. Span ``post.replace``, ``reads`` its host reads."""
    with annotate("post.replace") as span:
        replace = torch.zeros(label_map.shape, dtype=torch.bool, device=label_map.device)
        for v in (0.0, 1.0, 2.0, 3.0, 4.0):
            hit = label_map == v
            count = int(hit.sum())
            span.count("reads")
            if 0 < count <= thresh:
                replace |= hit
        span.count("reads")
        if not bool(replace.any()):
            return label_map
        moved_l = label_map.permute(2, 0, 1)
        moved_r = replace.permute(2, 0, 1)
        nearest = nearest_feature_2d(~moved_r, moved_l)
        return torch.where(moved_r, nearest, moved_l).permute(1, 2, 0)


# ---------------------------------------------------------------------------
# host (scipy) twins — golden references
# ---------------------------------------------------------------------------


def label_components_host(mask: np.ndarray) -> np.ndarray:
    structure = np.ones((3, 3, 3), bool)  # 26-connectivity like skimage
    labels, _ = ndimage.label(mask, structure=structure)
    return labels


def filter_components_host(volume: np.ndarray,
                           threshold: Optional[int] = None) -> np.ndarray:
    """transforms.py:583-600 host behaviour."""
    out = volume.copy()
    mask = out != 0
    labels = label_components_host(mask)
    if labels.max() == 0:
        return out
    sizes = np.bincount(labels.ravel())
    if threshold is None:
        keep = np.array([np.argmax(sizes[1:]) + 1])
    else:
        keep = np.argwhere(sizes[1:] > threshold).ravel() + 1
    out[~np.isin(labels, keep)] = 0
    return out


def replace_small_values_axial_host(label_map: np.ndarray,
                                    thresh: float = 20.0) -> np.ndarray:
    """transforms.py:233-268 host behaviour (nearest per axial slice)."""
    uniq, counts = np.unique(label_map, return_counts=True)
    values = uniq[counts <= thresh]
    if values.size == 0:
        return label_map
    out = np.zeros_like(label_map)
    replace = np.isin(label_map, values)
    for z in range(label_map.shape[2]):
        sl = label_map[:, :, z]
        m = replace[:, :, z]
        if not m.any():
            out[:, :, z] = sl
            continue
        ind = ndimage.distance_transform_edt(
            m, return_distances=False, return_indices=True)
        out[:, :, z] = sl[tuple(ind)]
    return out


# ---------------------------------------------------------------------------
# full post chain (definer.py:671-698)
# ---------------------------------------------------------------------------


def post_process(probs: torch.Tensor, logit_thresh: float = 0.5,
                 cleaning_areas: bool = False, cleaning_areas_threshold: int = 20,
                 replace_value: bool = False, replace_value_threshold: int = 300,
                 ) -> torch.Tensor:
    """probs [1, X, Y, Z, 3] → binarized multichannel [1, X, Y, Z, 3] after
    the configured cleanup (one volume at a time). Span ``post.process``."""
    with annotate("post.process"):
        binary = threshold_probs(probs, logit_thresh)
        if not (cleaning_areas or replace_value):
            return binary
        labels = change_label_3_to_4(multichannel_to_brats(binary[0]))
        if cleaning_areas:
            labels = filter_components(labels, float(cleaning_areas_threshold))
        if replace_value:
            labels = replace_small_values_axial(labels, float(replace_value_threshold))
        return brats_to_multichannel(labels)[None]
