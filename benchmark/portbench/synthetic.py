"""The benchmark's cases: synthetic four-modality BraTS-like volumes made
from the seed and written as ``.nii.gz`` with BraTS naming.

:func:`make_case` is a copy of ``brats21_tpu_torch/data/synthetic.py``'s
``make_case`` (a spherical tumor with nested WT/TC/ET shells over a noisy
brain ellipsoid), kept here so that the yardstick does not move with the
program. The intensities are stored as int16, as BraTS releases store
them.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import nifti

MODALITIES = ("t1", "t1ce", "flair", "t2")


def make_case(shape: Tuple[int, int, int] = (64, 64, 48), seed=0,
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (img [X,Y,Z,4] float32, seg [X,Y,Z] uint8 with labels 0/1/2/4)."""
    rng = np.random.default_rng(seed)
    grid = np.indices(shape).astype(np.float32)
    center = np.asarray(shape, np.float32) / 2
    radii = np.asarray(shape, np.float32) / 2.4
    dist = np.sqrt(sum(((g - c) / r) ** 2 for g, c, r in zip(grid, center, radii)))
    brain = dist <= 1.0

    tumor_center = center + (rng.random(3) - 0.5) * np.asarray(shape) * 0.2
    tdist = np.sqrt(sum((g - c) ** 2 for g, c in zip(grid, tumor_center)))
    r = min(shape) / 5.0
    seg = np.zeros(shape, np.uint8)
    seg[tdist <= r] = 2          # edema
    seg[tdist <= r * 0.7] = 1    # NCR/NET
    seg[tdist <= r * 0.4] = 4    # ET
    seg[~brain] = 0

    img = np.zeros(shape + (len(MODALITIES),), np.float32)
    for c in range(len(MODALITIES)):
        base = 80 + 30 * c
        vol = np.zeros(shape, np.float32)
        vol[brain] = base + rng.normal(0, 10, int(brain.sum()))
        # tumor contrast differs per modality
        vol[seg == 2] += 25 + 5 * c
        vol[seg == 1] += 40 - 5 * c
        vol[seg == 4] += 60 + 3 * c
        vol[~brain] = 0
        img[..., c] = np.clip(vol, 0, None)
    return img, seg


def pool_ids(count: int) -> List[str]:
    return [f"BraTS2021_{i:05d}" for i in range(count)]


def write_pool(root: str, seed: int, count: int, shape: Sequence[int],
               with_seg: bool) -> Dict[str, dict]:
    """Make ``count`` cases from ``seed`` (case k from ``(seed, k)``) and
    write them under ``root/<id>/<id>_<modality>.nii.gz`` (and ``_seg``),
    in threads. Returns ``{id: {"img": int16 [X,Y,Z,4] as float32,
    "seg": uint8}}`` as written."""
    shape = tuple(int(s) for s in shape)
    affine = np.eye(4)
    ids = pool_ids(count)

    def one(k: int):
        pid = ids[k]
        img, seg = make_case(shape, seed=(seed, k))
        img = np.rint(img).astype(np.int16)
        case_dir = os.path.join(root, pid)
        os.makedirs(case_dir, exist_ok=True)
        for c, mod in enumerate(MODALITIES):
            nifti.write(os.path.join(case_dir, f"{pid}_{mod}.nii.gz"), img[..., c], affine)
        if with_seg:
            nifti.write(os.path.join(case_dir, f"{pid}_seg.nii.gz"), seg, affine)
        return pid, dict(img=img.astype(np.float32), seg=seg, affine=affine)

    with ThreadPoolExecutor(min(count, 6)) as pool:
        return dict(pool.map(one, range(count)))
