"""Host-side preprocessing and train augmentations, numpy, channels-last
(X, Y, Z, C).

``brats21_tpu/data/transforms.py`` (label codecs, z-score, foreground crop,
the pads and their inverses, the MONAI-semantics random augmentations, the
boundary losses' distance map), copied so the port has no import of the
JAX package. The distance map runs the port's EDT (``ops/edt.py``) on the
device it is given: the kernels on a card, their plain versions on the
CPU.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

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


def _symmetric_pads(shape: Sequence[int], target: Sequence[int]) -> List[Tuple[int, int]]:
    """MONAI symmetric pad rule: floor-half before, rest after."""
    pads = []
    for cur, tgt in zip(shape, target):
        p = max(tgt - cur, 0)
        pads.append((p // 2, p - p // 2))
    return pads


def spatial_pad(arr: np.ndarray, target: Sequence[int]) -> np.ndarray:
    """Pad spatial dims up to ``target`` (MONAI SpatialPadd, definer.py:452)."""
    pads = _symmetric_pads(arr.shape[:3], target) + [(0, 0)] * (arr.ndim - 3)
    return np.pad(arr, pads)


def divisible_pad(arr: np.ndarray, k: int = 8) -> np.ndarray:
    """Pad spatial dims to multiples of k (MONAI DivisiblePadd, definer.py:465)."""
    target = [int(math.ceil(s / k)) * k for s in arr.shape[:3]]
    return spatial_pad(arr, target)


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
# Random augmentations (MONAI 0.6 semantics; definer.py:458-464)
# ---------------------------------------------------------------------------


def rand_spatial_crop(rng: np.random.Generator, roi: Sequence[int],
                      *arrays: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Random fixed-size crop (RandSpatialCropd random_size=False)."""
    shape = arrays[0].shape[:3]
    starts = [int(rng.integers(0, max(s - r, 0) + 1)) for s, r in zip(shape, roi)]
    sl = tuple(slice(st, st + r) for st, r in zip(starts, roi))
    return tuple(a[sl] for a in arrays)


def rand_rotate90(rng: np.random.Generator, prob: float, axes: Tuple[int, int],
                  *arrays: np.ndarray) -> Tuple[np.ndarray, ...]:
    """RandRotate90d(prob, spatial_axes): k ~ randint(1..3) (definer.py:459)."""
    if rng.random() >= prob:
        return arrays
    k = int(rng.integers(0, 3)) + 1
    return tuple(np.ascontiguousarray(np.rot90(a, k, axes)) for a in arrays)


def rand_flip(rng: np.random.Generator, prob: float, axes: Sequence[int],
              *arrays: np.ndarray) -> Tuple[np.ndarray, ...]:
    """RandFlipd(prob, spatial_axis=(0,1,2)): all listed axes flip together
    when triggered (definer.py:460)."""
    if rng.random() >= prob:
        return arrays
    return tuple(np.ascontiguousarray(np.flip(a, axes)) for a in arrays)


def rand_shift_intensity(rng: np.random.Generator, prob: float, offsets: float,
                         img: np.ndarray) -> np.ndarray:
    """RandShiftIntensityd(prob=0.7, offsets=0.1) (definer.py:461)."""
    if rng.random() >= prob:
        return img
    return img + float(rng.uniform(-offsets, offsets))


def rand_adjust_contrast(rng: np.random.Generator, prob: float,
                         gamma: Tuple[float, float], img: np.ndarray) -> np.ndarray:
    """RandAdjustContrastd(prob=0.2, gamma=(0.5, 4.5)) (definer.py:462):
    ((img − min)/range)^γ · range + min."""
    if rng.random() >= prob:
        return img
    g = float(rng.uniform(*gamma))
    mn = img.min()
    span = img.max() - mn
    return ((img - mn) / (span + 1e-7)) ** g * span + mn


def rand_gaussian_noise(rng: np.random.Generator, prob: float, mean: float,
                        std: float, img: np.ndarray) -> np.ndarray:
    """RandGaussianNoised(prob=0.5, std=0.1): noise std ~ U(0, std)
    (definer.py:463)."""
    if rng.random() >= prob:
        return img
    s = float(rng.uniform(0, std))
    return img + rng.normal(mean, s, size=img.shape).astype(img.dtype)


def rand_gaussian_smooth(rng: np.random.Generator, prob: float, img: np.ndarray,
                         sigma_range: Tuple[float, float] = (0.25, 1.5)) -> np.ndarray:
    """RandGaussianSmoothd(prob=0.2) with MONAI's default per-axis σ ranges
    (definer.py:464); a channel-wise 3D gaussian filter."""
    if rng.random() >= prob:
        return img
    sigmas = [float(rng.uniform(*sigma_range)) for _ in range(3)]
    out = np.empty_like(img)
    for c in range(img.shape[-1]):
        out[..., c] = ndimage.gaussian_filter(img[..., c], sigmas)
    return out


# ---------------------------------------------------------------------------
# Composed pipelines (definer.py:448-505, 481-493, 561-567)
# ---------------------------------------------------------------------------


def preprocess_case(img: np.ndarray, seg: Optional[np.ndarray],
                    remove_outliers: bool = False, crop: bool = True,
                    compute_distance_map: bool = False,
                    normalize: bool = True, device: Any = None,
                    ) -> Dict[str, np.ndarray]:
    """The deterministic front half shared by all pipelines: label codec →
    foreground crop → z-score normalize (+ optional boundary-loss distance
    map on ``device``, definer.py:455-456). Returns a dict sample."""
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
            sample["distance_map"] = compute_distance_map_fn(seg_mc, device)
    sample["foreground_start_coord"] = start
    sample["foreground_end_coord"] = end
    sample["original_shape"] = original_shape
    return sample


def compute_distance_map_fn(seg_mc: np.ndarray, device: Any) -> np.ndarray:
    """Signed boundary-loss map (OneHotToDistd, definer.py:455-456) of a
    channels-last one-hot seg, fp32, by the port's ``one_hot2dist`` on
    ``device``, which has no default: ``None`` raises rather than run on
    the host unasked. On a card it runs on a side stream of the calling
    thread (a loader worker), synchronised before the map becomes numpy,
    as the JAX package computes it on its default device."""
    import torch
    from ..ops.edt import one_hot2dist
    if device is None:
        raise ValueError("compute_distance_map_fn needs a device for the EDT")
    device = torch.device(device)
    # the masks cross as bytes, channels first: one EDT batch of C masks
    seg = torch.from_numpy(np.ascontiguousarray(np.moveaxis(seg_mc != 0, -1, 0)))
    if device.type != "cuda":
        dm = one_hot2dist(seg.to(device))
    else:
        stream = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            dm = one_hot2dist(seg.to(device)).cpu()
        stream.synchronize()
    return np.moveaxis(dm.numpy(), 0, -1)


def augment_train_sample(sample: Dict[str, np.ndarray], rng: np.random.Generator,
                         patch_size: Sequence[int], normalize: bool = True,
                         remove_outliers: bool = False, compute_dm: bool = False,
                         device: Any = None) -> Dict[str, np.ndarray]:
    """The random back half of the train pipeline (definer.py:452-468):
    SpatialPad → (with ``compute_dm``, the boundary distance map of the
    padded seg, on ``device``) → RandSpatialCrop → RandRotate90(p .7, axes
    0, 2) → RandFlip(p .7), the map riding with the seg → intensity
    augmentations → DivisiblePad(8), then, with ``normalize``, the z-score
    on the augmented raw intensities, last, as the reference does."""
    keys = [k for k in ("img", "seg") if k in sample]
    arrays = [sample[k] for k in keys]
    patch = list(patch_size)
    if any(p > 0 for p in patch):
        arrays = [spatial_pad(a, patch) for a in arrays]
    if compute_dm:
        # after SpatialPadd (definer.py:452-456), so the pad margins carry
        # true distances
        keys.append("distance_map")
        arrays.append(compute_distance_map_fn(arrays[keys.index("seg")], device))
    if any(p > 0 for p in patch):
        arrays = list(rand_spatial_crop(rng, patch, *arrays))
    arrays = list(rand_rotate90(rng, 0.7, (0, 2), *arrays))
    arrays = list(rand_flip(rng, 0.7, (0, 1, 2), *arrays))
    out = dict(zip(keys, arrays))
    img = out["img"]
    img = rand_shift_intensity(rng, 0.7, 0.1, img)
    img = rand_adjust_contrast(rng, 0.2, (0.5, 4.5), img)
    img = rand_gaussian_noise(rng, 0.5, 0.0, 0.1, img)
    img = rand_gaussian_smooth(rng, 0.2, img)
    out["img"] = img.astype(np.float32)
    for k in keys:
        out[k] = divisible_pad(out[k], 8)
    if normalize:
        out["img"] = normalize_intensity(out["img"], nonzero=True, channel_wise=True,
                                         remove_outliers=remove_outliers)
    for k in ("foreground_start_coord", "foreground_end_coord", "original_shape"):
        out[k] = sample[k]
    return out
