"""Synthetic 4-modality BraTS-like case generator — the test fixture the
reference never had (SURVEY.md §4): spherical tumor with nested WT/TC/ET
shells over a noisy brain ellipsoid, written as real NIfTI files with the
BraTS naming convention (``<id>_{t1,t1ce,t2,flair,seg}.nii.gz``)."""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .nifti import write_nifti

MODALITIES = ("t1", "t1ce", "flair", "t2")


def make_case(shape: Tuple[int, int, int] = (64, 64, 48), seed: int = 0,
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


def generate_synthetic_dataset(root: str, num_cases: int = 3,
                               shape: Tuple[int, int, int] = (64, 64, 48),
                               seed: int = 0, with_seg: bool = True,
                               first_case: int = 0) -> None:
    """Write ``num_cases`` BraTS-layout patient directories under root.
    ``first_case`` offsets the patient numbering (incremental injection,
    scripts/bench_serving.py)."""
    affine = np.eye(4)
    for i in range(first_case, first_case + num_cases):
        pid = f"BraTS2021_{i:05d}"
        case_dir = os.path.join(root, pid)
        os.makedirs(case_dir, exist_ok=True)
        img, seg = make_case(shape, seed=seed + i)
        for c, mod in enumerate(MODALITIES):
            write_nifti(os.path.join(case_dir, f"{pid}_{mod}.nii.gz"),
                        img[..., c], affine)
        if with_seg:
            write_nifti(os.path.join(case_dir, f"{pid}_seg.nii.gz"), seg, affine)
