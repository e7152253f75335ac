"""Host-side eval preprocessing, numpy, channels-last (X, Y, Z, C).

The eval half of ``brats21_tpu/data/transforms.py`` (label codecs, z-score,
foreground crop, the divisible pad and its inverses), copied so the port has
no import of the JAX package. The train augmentations come with the training
slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# BraTS label codecs (utils/transforms.py:145-206)
# ---------------------------------------------------------------------------


def brats_labels_to_multichannel(seg: np.ndarray) -> np.ndarray:
    """Labels {1: NCR/NET, 2: ED, 4: ET} → 3 overlapping channels
    [WT, TC, ET], channels-last float32 (transforms.py:145-166)."""
    wt = (seg == 1) | (seg == 4) | (seg == 2)
    tc = (seg == 1) | (seg == 4)
    et = seg == 4
    return np.stack([wt, tc, et], axis=-1).astype(np.float32)


def multichannel_to_brats_labels(channels: np.ndarray) -> np.ndarray:
    """[X, Y, Z, 3] binary WT/TC/ET → label map {1, 2, 3} with the reference
    ET→NET→ED precedence (transforms.py:169-193); use
    :func:`change_label_3_to_4` afterwards for BraTS submission labels."""
    if channels.shape[-1] != 3:
        raise ValueError("Number of channel need to be 3 (WT/TC/ET)")
    wt = channels[..., 0].astype(bool)
    tc = channels[..., 1].astype(bool)
    et = channels[..., 2].astype(bool)
    net = tc & ~et
    ed = wt & ~tc
    label_map = np.zeros(channels.shape[:-1], np.float32)
    label_map[et] = 3
    label_map[net] = 1
    label_map[ed] = 2
    return label_map


def change_label_3_to_4(label_map: np.ndarray) -> np.ndarray:
    """ET back to BraTS label 4 (transforms.py:196-206)."""
    out = label_map.copy()
    out[out == 3] = 4
    return out


# ---------------------------------------------------------------------------
# Intensity (utils/transforms.py:328-447)
# ---------------------------------------------------------------------------


def normalize_intensity(img: np.ndarray, nonzero: bool = True,
                        channel_wise: bool = True,
                        remove_outliers: bool = False,
                        outliers_value: float = 3.0) -> np.ndarray:
    """Z-score normalization, nonzero-only, channel-wise, optional ±3σ clip
    (transforms.py:328-447; clip :382-384). Channels-last."""
    img = img.astype(np.float32).copy()

    def _norm(ch: np.ndarray) -> np.ndarray:
        mask = (ch != 0) if nonzero else np.ones(ch.shape, bool)
        if not mask.any():
            return ch
        sub = ch[mask].mean()
        div = ch[mask].std()
        if div == 0.0:
            div = 1.0
        ch[mask] = (ch[mask] - sub) / div
        if remove_outliers:
            ch[mask] = np.clip(ch[mask], -outliers_value, outliers_value)
        return ch

    if channel_wise:
        for c in range(img.shape[-1]):
            img[..., c] = _norm(img[..., c])
    else:
        img = _norm(img)
    return img


# ---------------------------------------------------------------------------
# Spatial: foreground crop, eval pad and their inverses
# ---------------------------------------------------------------------------


def crop_foreground(img: np.ndarray, *extra: np.ndarray,
                    ) -> Tuple[np.ndarray, Tuple[np.ndarray, ...],
                               np.ndarray, np.ndarray]:
    """Crop to the bounding box where any channel is nonzero (MONAI
    CropForegroundd with source_key='img'). Returns (img, extras,
    start_coord, end_coord) — the coords feed
    :func:`pad_back_to_shape_before_compose`."""
    mask = (img != 0).any(axis=-1)
    if not mask.any():
        start = np.zeros(3, np.int64)
        end = np.asarray(mask.shape, np.int64)
    else:
        coords = np.nonzero(mask)
        start = np.array([c.min() for c in coords], np.int64)
        end = np.array([c.max() + 1 for c in coords], np.int64)
    sl = tuple(slice(s, e) for s, e in zip(start, end))
    cropped = img[sl]
    extras = tuple(e[sl] for e in extra)
    return cropped, extras, start, end


def shape_to_divisible(arr: np.ndarray, k: int = 8,
                       min_shape: Optional[int] = None,
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Eval-path pad: ceil-half *before*, floor-half after (reference
    transforms.py:483-512 — note the opposite rounding of MONAI's pad).
    Channels-last [X, Y, Z, C]. Returns (padded, p_b, p_a)."""
    spatial = np.asarray(arr.shape[:3])
    target = np.ceil(spatial / k).astype(np.int64) * k
    if min_shape is not None:
        target[target < min_shape] = min_shape
    p = target - spatial
    p_b = np.ceil(p / 2).astype(np.int64)
    p_a = np.floor(p / 2).astype(np.int64)
    pads = [(int(b), int(a)) for b, a in zip(p_b, p_a)] + [(0, 0)] * (arr.ndim - 3)
    return np.pad(arr, pads), p_b, p_a


def shape_to_original(arr: np.ndarray, p_b: np.ndarray, p_a: np.ndarray) -> np.ndarray:
    """Undo :func:`shape_to_divisible` (transforms.py:515-533)."""
    sl = tuple(slice(int(b), arr.shape[i] - int(a))
               for i, (b, a) in enumerate(zip(p_b, p_a)))
    return arr[sl]


def pad_back_to_shape_before_compose(outputs: np.ndarray,
                                     start_coord: np.ndarray,
                                     end_coord: np.ndarray,
                                     original_shape: Sequence[int]) -> np.ndarray:
    """Un-crop: border-pad the foreground crop back into the original volume
    (transforms.py:553-576). outputs: [X, Y, Z(, C)]."""
    pads = [(int(s), int(o - e)) for s, e, o in
            zip(start_coord, end_coord, original_shape)]
    pads += [(0, 0)] * (outputs.ndim - 3)
    return np.pad(outputs, pads)


def remove_background_voxels(img: np.ndarray, outputs: np.ndarray) -> np.ndarray:
    """Zero predictions outside the brain mask (any-modality nonzero,
    transforms.py:536-550). img: [X,Y,Z,4]; outputs: [X,Y,Z,C]."""
    brain = (img != 0).any(axis=-1)
    return outputs * brain[..., None]


# ---------------------------------------------------------------------------
# Composed eval front half (definer.py:481-493, 561-567)
# ---------------------------------------------------------------------------


def preprocess_case(img: np.ndarray, seg: Optional[np.ndarray],
                    remove_outliers: bool = False, crop: bool = True,
                    compute_distance_map: bool = False,
                    normalize: bool = True,
                    ) -> Dict[str, np.ndarray]:
    """The deterministic front half shared by all pipelines: label codec →
    foreground crop → z-score normalize (+ optional boundary-loss distance
    map, definer.py:455-456). Returns a dict sample."""
    sample: Dict[str, np.ndarray] = {}
    original_shape = np.asarray(img.shape[:3], np.int64)
    seg_mc = brats_labels_to_multichannel(seg) if seg is not None else None
    if crop:
        extras = (seg_mc,) if seg_mc is not None else ()
        img, extras, start, end = crop_foreground(img, *extras)
        if seg_mc is not None:
            seg_mc = extras[0]
    else:
        start = np.zeros(3, np.int64)
        end = original_shape.copy()
    if normalize:
        img = normalize_intensity(img, nonzero=True, channel_wise=True,
                                  remove_outliers=remove_outliers)
    sample["img"] = img.astype(np.float32)
    if seg_mc is not None:
        sample["seg"] = seg_mc
        if compute_distance_map:
            sample["distance_map"] = compute_distance_map_fn(seg_mc)
    sample["foreground_start_coord"] = start
    sample["foreground_end_coord"] = end
    sample["original_shape"] = original_shape
    return sample


def compute_distance_map_fn(seg_mc: np.ndarray) -> np.ndarray:
    """Signed boundary-loss map (OneHotToDistd, definer.py:455-456). It
    needs the exact EDT (``ops/edt.py`` and its envelope kernel), which the
    port does not have yet."""
    raise NotImplementedError(
        "distance maps need the EDT envelope kernel, which comes with the "
        "EDT slice of the port (ROADMAP A9/B3)")
