"""The served path, plain: a raw four-modality case to its label map, as
the published reference's inference does it (github.com/Alxaline/BraTS21,
``src/main_inference.py``, ``src/utils/definer.py:553-698``,
``src/utils/transforms.py``): foreground crop, z-score over the brain,
pad to multiples of 8 (and square for TTA), the 16-combo TTA mean of the
sigmoid, threshold 0.5, BraTS labels, small components removed, rare
labels replaced slice by slice, zeroed outside the brain, un-padded,
un-cropped, uint8.

Host steps are NumPy and SciPy; the forward is the network of ``nets.py``
on the card, float32 with TF32 off.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from scipy import ndimage

AXES = ("zxy", "xyz")
FLIPS = (False, True)
ANGLES = (0, 90, 180, 270)


def crop_foreground(img: np.ndarray) -> Tuple[Tuple[slice, ...], np.ndarray, np.ndarray]:
    """The bounding box of the voxels where any modality is nonzero."""
    mask = (img != 0).any(axis=-1)
    coords = np.nonzero(mask)
    start = np.array([c.min() for c in coords])
    end = np.array([c.max() + 1 for c in coords])
    return tuple(slice(s, e) for s, e in zip(start, end)), start, end


def zscore(img: np.ndarray, clip: float = 0.0) -> np.ndarray:
    """Channel-wise z-score over the nonzero voxels (float64 statistics),
    optionally clipped to ±clip."""
    out = img.astype(np.float32).copy()
    for c in range(img.shape[-1]):
        ch = out[..., c]
        mask = ch != 0
        if not mask.any():
            continue
        vals = ch[mask].astype(np.float64)
        std = vals.std() or 1.0
        z = (vals - vals.mean()) / std
        if clip:
            z = np.clip(z, -clip, clip)
        ch[mask] = z
    return out


def pad_divisible(arr: np.ndarray, k: int = 8) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad the spatial axes to multiples of k, the larger half before."""
    size = np.asarray(arr.shape[:3])
    p = -(-size // k) * k - size
    before, after = -(-p // 2), p // 2
    pads = [(int(b), int(a)) for b, a in zip(before, after)] + [(0, 0)] * (arr.ndim - 3)
    return np.pad(arr, pads), before, after


def tta_probs(model, x: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid of the main head over the 16 combos (axis order ×
    horizontal flip × rotation by 0/90/180/270 in the first two spatial
    axes), each de-augmented. ``x`` is [1, C, s0, s1, s2] with s0 == s1."""
    acc = torch.zeros((1, 3, *x.shape[2:]), dtype=torch.float32, device=x.device)
    n = 0
    for axe in AXES:
        for flip in FLIPS:
            for angle in ANGLES:
                k = angle // 90
                v = x.permute(0, 1, 3, 4, 2) if axe == "xyz" else x
                if flip:
                    v = torch.flip(v, dims=(3,))
                v = torch.rot90(v, k, dims=(2, 3))
                y = model(v.contiguous(), with_deep=False)
                y = torch.rot90(y, -k, dims=(2, 3))
                if flip:
                    y = torch.flip(y, dims=(3,))
                if axe == "xyz":
                    y = y.permute(0, 1, 4, 2, 3)
                acc += torch.sigmoid(y.float())
                n += 1
    return acc / n


def to_labels(binary: np.ndarray) -> np.ndarray:
    """[..., 3] WT/TC/ET → labels {0, 1, 2, 4}: ET 4, TC without ET 1, WT
    without TC 2."""
    wt, tc, et = binary[..., 0], binary[..., 1], binary[..., 2]
    out = np.zeros(binary.shape[:-1], np.uint8)
    out[wt & ~tc] = 2
    out[tc & ~et] = 1
    out[et] = 4
    return out


def to_channels(labels: np.ndarray) -> np.ndarray:
    return np.stack([labels > 0, (labels == 1) | (labels == 4), labels == 4], axis=-1)


def remove_small_components(labels: np.ndarray, threshold: int) -> np.ndarray:
    """Zero the 26-connected components of the nonzero voxels of size
    ≤ threshold."""
    comp, n = ndimage.label(labels != 0, structure=np.ones((3, 3, 3), bool))
    if n == 0:
        return labels
    sizes = np.bincount(comp.ravel())
    keep = sizes > threshold
    keep[0] = False
    return np.where(keep[comp], labels, 0).astype(labels.dtype)


LABELS = (0, 1, 2, 4)


def replace_rare_labels(labels: np.ndarray, threshold: int) -> Tuple[np.ndarray, np.ndarray]:
    """Every label value with at most ``threshold`` voxels takes, in each
    axial slice, the value of the nearest voxel of another value. Returns
    the labels and, for each replaced voxel, the bits (in :data:`LABELS`
    order) of every value at that nearest distance: a tie may go to any."""
    values, counts = np.unique(labels, return_counts=True)
    rare = values[counts <= threshold]
    ties = np.zeros(labels.shape, np.uint8)
    if rare.size == 0:
        return labels, ties
    out = labels.copy()
    replace = np.isin(labels, rare)
    kept = [v for v in values if v not in rare]
    for z in range(labels.shape[2]):
        m = replace[:, :, z]
        if not m.any() or m.all():
            continue
        sl = labels[:, :, z]
        dist = {v: ndimage.distance_transform_edt(sl != v) if (sl == v).any() else None
                for v in kept}
        dist = {v: d for v, d in dist.items() if d is not None}
        nearest = np.minimum.reduce(list(dist.values()))
        bits = np.zeros(sl.shape, np.uint8)
        for v, d in dist.items():
            bits |= np.where(d == nearest, 1 << LABELS.index(int(v)), 0).astype(np.uint8)
        idx = ndimage.distance_transform_edt(m, return_distances=False, return_indices=True)
        out[:, :, z] = sl[tuple(idx)]
        ties[:, :, z] = np.where(m, bits, 0)
    return out, ties


@torch.no_grad()
def probabilities(model, raw: np.ndarray, device: torch.device) -> Tuple[np.ndarray, Dict]:
    """The 16-combo TTA mean probabilities [X', Y', Z', 3] of one raw case
    [X, Y, Z, 4] (the modalities in the order the case files are listed)
    in the padded crop's space, and that space's geometry."""
    box, _, _ = crop_foreground(raw)
    img = zscore(raw[box])
    padded, before, after = pad_divisible(img)
    side = max(padded.shape[0], padded.shape[1])
    extra = (side - padded.shape[0], side - padded.shape[1])
    padded = np.pad(padded, [(0, extra[0]), (0, extra[1]), (0, 0), (0, 0)])
    after = after + np.array([extra[0], extra[1], 0])
    x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(padded, -1, 0)))[None].to(device)
    probs = tta_probs(model, x)[0].permute(1, 2, 3, 0).cpu().numpy()
    geom = dict(box=box, before=before, after=after, shape=raw.shape[:3],
                brain=(padded != 0).any(axis=-1))
    return probs, geom


def finish(binary: np.ndarray, geom: Dict, post: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """Thresholded channels [X', Y', Z', 3] of the padded crop to the saved
    label map [X, Y, Z] uint8: BraTS labels, small components removed, rare
    labels replaced (each where ``post`` names its threshold), zeroed
    outside the brain, un-padded and un-cropped. Returns the labels and the
    replaced voxels' tied values (:func:`replace_rare_labels`)."""
    labels = to_labels(binary)
    ties = np.zeros(labels.shape, np.uint8)
    if "cleaning_areas_threshold" in post:
        labels = remove_small_components(labels, int(post["cleaning_areas_threshold"]))
    if "replace_value_threshold" in post:
        labels, ties = replace_rare_labels(labels, int(post["replace_value_threshold"]))
    brain = geom["brain"]
    labels = np.where(brain, labels, 0).astype(np.uint8)
    ties = np.where(brain, ties, 0).astype(np.uint8)
    sl = tuple(slice(int(b), labels.shape[i] - int(a))
               for i, (b, a) in enumerate(zip(geom["before"], geom["after"])))
    out = np.zeros(geom["shape"], np.uint8)
    out[geom["box"]] = labels[sl]
    out_ties = np.zeros(geom["shape"], np.uint8)
    out_ties[geom["box"]] = ties[sl]
    return out, out_ties


def agrees(labels: np.ndarray, ref: np.ndarray, ties: np.ndarray, cleaning: int = 0) -> bool:
    """Whether ``labels`` equal the reference's, a tied voxel of the rare
    labels' replacement taking any of its tied values, and what else
    differs forming components of at most ``cleaning`` voxels: one decision
    of the small components' removal moves at most that many, and a
    component reaching out of the brain, where the saved labels show
    nothing, can take it the other way."""
    same = labels == ref
    if same.all():
        return True
    bit = np.zeros(labels.shape, np.uint8)
    for i, v in enumerate(LABELS):
        bit[labels == v] = 1 << i
    rest = ~(same | ((bit & ties) != 0))
    if not rest.any():
        return True
    comp, _ = ndimage.label(rest, structure=np.ones((3, 3, 3), bool))
    return bool(np.bincount(comp.ravel())[1:].max() <= cleaning)


def segment(model, raw: np.ndarray, device: torch.device, post: Dict) -> np.ndarray:
    """The label map [X, Y, Z] uint8 of one raw case through ``model``."""
    probs, geom = probabilities(model, raw, device)
    return finish(probs >= post.get("logit_threshold", 0.5), geom, post)[0]


def to_padded(labels: np.ndarray, geom: Dict) -> np.ndarray:
    """A saved label map [X, Y, Z] in the padded crop's space."""
    crop = labels[geom["box"]]
    pads = [(int(b), int(a)) for b, a in zip(geom["before"], geom["after"])]
    return np.pad(crop, pads)


#: the margins tried, ascending
MARGINS = (0.0, 1e-4, 2e-4, 5e-4, 1e-3, 2e-3, 5e-3, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5)


def label_margin(labels: np.ndarray, probs: np.ndarray, geom: Dict, post: Dict) -> float:
    """How far from the threshold the reference's probabilities must be
    moved to give ``labels``: the least margin δ of :data:`MARGINS` such
    that, at every voxel whose label the reference's thresholded channels
    can be turned to by flipping channels whose probability lies within δ
    of the threshold, flipping them, then post-processing as the reference
    does, gives ``labels`` (:func:`agrees`); 1.0 where none does. A label map that
    the reference's own probabilities give reads 0; rounding in the
    program moves only voxels near the threshold, and what post-processing
    makes of them follows."""
    thresh = post.get("logit_threshold", 0.5)
    box_only = np.zeros(labels.shape, bool)
    box_only[geom["box"]] = True
    if labels[~box_only].any():
        return 1.0
    # the saved labels are zeroed outside the brain after post-processing,
    # so there the program's channels are unseen: the reference's stand
    brain = geom["brain"]
    ref = probs >= thresh
    margin = np.abs(probs - thresh)
    lab = to_padded(labels, geom)
    wt, tc, et = ref[..., 0], ref[..., 1], ref[..., 2]
    m_wt, m_tc, m_et = margin[..., 0], margin[..., 1], margin[..., 2]
    on = lambda bit, m: np.where(bit, 0.0, m)       # the cost of turning a channel on
    off = lambda bit, m: np.where(bit, m, 0.0)      # of turning it off
    # the cheapest channels giving each label (to_labels) and their cost
    cost = np.select([lab == 4, lab == 1, lab == 2],
                     [on(et, m_et), np.maximum(on(tc, m_tc), off(et, m_et)),
                      np.maximum.reduce([on(wt, m_wt), off(tc, m_tc), off(et, m_et)])],
                     np.maximum.reduce([off(wt, m_wt), off(tc, m_tc), off(et, m_et)]))
    want = np.stack([np.select([lab == 4, lab == 1], [wt, wt], lab == 2),
                     np.select([lab == 4], [tc], lab == 1),
                     lab == 4], axis=-1)
    cost = np.where(brain, cost, 0.0)
    want = np.where(brain[..., None], want, ref)
    widest = float(cost.max())
    candidates = [m for m in MARGINS if m < widest] + [widest]

    def gives(delta: float) -> bool:
        take = (cost <= delta)[..., None]
        return agrees(labels, *finish(np.where(take, want, ref), geom, post),
                      int(post.get("cleaning_areas_threshold", 0)))

    lo, hi = 0, len(candidates) - 1
    if not gives(candidates[hi]):
        return 1.0
    while lo < hi:                          # the least candidate that gives them
        mid = (lo + hi) // 2
        if gives(candidates[mid]):
            hi = mid
        else:
            lo = mid + 1
    return float(candidates[lo])
