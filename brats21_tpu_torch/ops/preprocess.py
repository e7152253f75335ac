"""Z-score normalisation on the card: the tensor twin of the host stage.

Port of ``brats21_tpu/ops/preprocess.py``. A caller may ship the raw int16
voxels (half the bytes of fp32, the BraTS source dtype) and normalise on the
device. The semantics are those of ``data.transforms.normalize_intensity``:
per channel, mean and standard deviation over the nonzero voxels, an
optional ±3σ clip, and zeros stay exactly zero (they mark the background for
``remove_background_voxels``). Nothing on the CLI path calls it: the loader
normalises on the host.
"""

from __future__ import annotations

import torch


def normalize_intensity_device(img: torch.Tensor, remove_outliers: bool = False,
                               outliers_value: float = 3.0) -> torch.Tensor:
    """img: [..., C] of any numeric dtype → fp32, z-scored over the nonzero
    voxels of each channel."""
    x = img.float()
    axes = tuple(range(x.ndim - 1))
    mask = x != 0
    count = mask.sum(dim=axes).clamp_min(1)
    mean = torch.where(mask, x, 0.0).sum(dim=axes) / count
    var = torch.where(mask, (x - mean) ** 2, 0.0).sum(dim=axes) / count
    std = torch.sqrt(var)
    std = torch.where(std == 0.0, 1.0, std)
    normed = (x - mean) / std
    if remove_outliers:
        normed = normed.clamp(-outliers_value, outliers_value)
    return torch.where(mask, normed, 0.0)
