"""Exact Euclidean distance transform of mask batches, on the device.

Port of ``brats21_tpu/ops/edt.py``: the separable decomposition
(Felzenszwalb & Huttenlocher) in which each axis applies the lower envelope
``d[i] = min_j g[j] + (s·(i − j))²``, here the hand-written kernels of
``ops/kernels/edt.py``: the first axis reads the mask itself, the others
the fp32 result. Masks come as a batch ``[N, *spatial]``: one envelope
launch per spatial axis covers all N masks, where the JAX package vmaps
over them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .kernels.edt import envelope, envelope_mask


def edt_sq(mask: torch.Tensor, sampling: Optional[Sequence[float]] = None
           ) -> torch.Tensor:
    """Squared EDT of each mask of ``[N, *spatial]``: the squared distance
    from each voxel to the nearest voxel where the mask is False (scipy
    ``distance_transform_edt(mask)**2`` per mask), fp32."""
    spatial = mask.dim() - 1
    sampling = sampling or (1.0,) * spatial
    f = envelope_mask(mask.bool(), float(sampling[0]), 1)
    for ax in range(1, spatial):
        f = envelope(f, float(sampling[ax]), ax + 1)
    return f


def edt(mask: torch.Tensor, sampling: Optional[Sequence[float]] = None
        ) -> torch.Tensor:
    """Euclidean distance transform of each mask of ``[N, *spatial]``."""
    return torch.sqrt(edt_sq(mask, sampling))


def _any_per_mask(pos: torch.Tensor) -> torch.Tensor:
    return pos.flatten(1).any(dim=1).reshape((-1,) + (1,) * (pos.dim() - 1))


def one_hot2dist(seg: torch.Tensor, sampling: Optional[Sequence[float]] = None
                 ) -> torch.Tensor:
    """Signed boundary-loss distance map per channel of ``[C, *spatial]``
    (reference losses.py:59-74): ``edt(~pos)·~pos − (edt(pos) − 1)·pos``;
    zero for empty channels. Both transforms run as one batch."""
    pos = seg.bool()
    neg = ~pos
    d = edt(torch.cat([neg, pos]), sampling)
    dist_to_pos, dist_to_neg = d[:len(pos)], d[len(pos):]
    res = dist_to_pos * neg - (dist_to_neg - 1.0) * pos
    return torch.where(_any_per_mask(pos), res, 0.0)


def one_hot2hd_dist(seg: torch.Tensor, sampling: Optional[Sequence[float]] = None
                    ) -> torch.Tensor:
    """HD-loss distance map per mask of ``[N, *spatial]`` (reference
    losses.py:77-95): the EDT of the positive mask (distance to its nearest
    non-positive voxel), which is zero for an empty mask as the reference's
    map is."""
    return edt(seg.bool(), sampling)
