"""Segmentation metrics with BraTS edge-case conventions.

Port of ``brats21_tpu/utils/metrics.py`` (reference utils/metrics.py:35-134,
``compute_metric_tensor``):

- Dice: empty-pred ∧ empty-GT → 1.0; existence mismatch → 0.0
- HD95: empty∧empty → 0.0; mismatch → image diagonal of (240, 240, 155)
  (the fixed constant at metrics.py:77)
- sensitivity/specificity from the confusion matrix with the same rules.

Dice and the confusion matrix are tensor functions that run on their
inputs' device; the surface-distance metrics and ROC-AUC run on the host on
numpy/scipy per case, as the JAX package runs them, matching MONAI
``HausdorffDistanceMetric(distance_metric='euclidean', percentile=95)``
(metrics.py:149-151).

Layout: channels-last ``[B, D, H, W, C]`` binary arrays.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from scipy import ndimage

ArrayLike = Union[np.ndarray, torch.Tensor]

#: worst-case HD95 = diagonal of the BraTS volume (reference metrics.py:76-79)
BRATS_DIAGONAL = math.sqrt(240.0 ** 2 + 240.0 ** 2 + 155.0 ** 2)

_SPATIAL = (1, 2, 3)


# ---------------------------------------------------------------------------
# tensor metrics
# ---------------------------------------------------------------------------


def _edge_rules(value: torch.Tensor, exists_p: torch.Tensor,
                exists_g: torch.Tensor) -> torch.Tensor:
    """both empty → 1, existence mismatch → 0."""
    value = torch.where(~exists_p & ~exists_g, torch.ones_like(value), value)
    return torch.where(exists_p ^ exists_g, torch.zeros_like(value), value)


def dice_metric(y_pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-(batch, channel) Dice of binary masks with the BraTS edge rules.
    Returns [B, C] float32."""
    p = y_pred.float()
    g = y.float()
    inter = torch.sum(p * g, dim=_SPATIAL)
    p_sum = torch.sum(p, dim=_SPATIAL)
    g_sum = torch.sum(g, dim=_SPATIAL)
    return _edge_rules(2.0 * inter / (p_sum + g_sum), p_sum > 0, g_sum > 0)


def confusion_matrix(y_pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[B, C, 4] = (tp, fp, tn, fn) voxel counts (MONAI ConfusionMatrixMetric
    layout, reference metrics.py:87-112)."""
    p = y_pred.float()
    g = y.float()
    tp = torch.sum(p * g, dim=_SPATIAL)
    fp = torch.sum(p * (1 - g), dim=_SPATIAL)
    fn = torch.sum((1 - p) * g, dim=_SPATIAL)
    tn = torch.sum((1 - p) * (1 - g), dim=_SPATIAL)
    return torch.stack([tp, fp, tn, fn], dim=-1)


def sensitivity_specificity(y_pred: torch.Tensor, y: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, channel) sensitivity / specificity with edge rules
    (both-empty → 1, mismatch → 0)."""
    tp, fp, tn, fn = confusion_matrix(y_pred, y).unbind(-1)
    sens = tp / torch.clamp(tp + fn, min=1e-12)
    spec = tn / torch.clamp(tn + fp, min=1e-12)
    exists_p, exists_g = (tp + fp) > 0, (tp + fn) > 0
    return (_edge_rules(sens, exists_p, exists_g),
            _edge_rules(spec, exists_p, exists_g))


# ---------------------------------------------------------------------------
# host-side surface-distance metrics (scipy), per case
# ---------------------------------------------------------------------------


def _mask_edges(mask: np.ndarray) -> np.ndarray:
    """Surface voxels: mask XOR erosion(mask) (MONAI get_mask_edges)."""
    if not mask.any():
        return np.zeros_like(mask, dtype=bool)
    eroded = ndimage.binary_erosion(mask)
    return mask ^ eroded


def _directed_distances(src_edges: np.ndarray, dst_edges: np.ndarray) -> np.ndarray:
    """Distances from each surface voxel of src to the nearest surface voxel
    of dst (MONAI get_surface_distance, euclidean)."""
    if not dst_edges.any():
        return np.full(int(src_edges.sum()), np.inf)
    dist = ndimage.distance_transform_edt(~dst_edges)
    return dist[src_edges]


def hausdorff_distance_95(y_pred: np.ndarray, y: np.ndarray,
                          percentile: float = 95.0) -> float:
    """HD-percentile of two binary volumes, MONAI semantics: max of the two
    directed percentile distances. NaN if either mask is empty (the caller
    applies the edge rules)."""
    pred = np.asarray(y_pred, bool)
    gt = np.asarray(y, bool)
    if not pred.any() or not gt.any():
        return float("nan")
    pe, ge = _mask_edges(pred), _mask_edges(gt)
    d_pg = _directed_distances(pe, ge)
    d_gp = _directed_distances(ge, pe)
    if d_pg.size == 0 or d_gp.size == 0:
        return float("nan")
    return float(max(np.percentile(d_pg, percentile),
                     np.percentile(d_gp, percentile)))


def average_surface_distance(y_pred: np.ndarray, y: np.ndarray,
                             symmetric: bool = False) -> float:
    """MONAI SurfaceDistanceMetric (avg. surface distance, pred→gt;
    symmetric option averages both directions)."""
    pred = np.asarray(y_pred, bool)
    gt = np.asarray(y, bool)
    if not pred.any() or not gt.any():
        return float("nan")
    d_pg = _directed_distances(_mask_edges(pred), _mask_edges(gt))
    if not symmetric:
        return float(d_pg.mean()) if d_pg.size else float("nan")
    d_gp = _directed_distances(_mask_edges(gt), _mask_edges(pred))
    alld = np.concatenate([d_pg, d_gp])
    return float(alld.mean()) if alld.size else float("nan")


# ---------------------------------------------------------------------------
# the BraTS evaluation entry point (reference compute_metric_tensor)
# ---------------------------------------------------------------------------


def compute_case_metrics(y_pred: ArrayLike, y: ArrayLike,
                         metrics: Sequence[str] = ("dice", "hausdorff_distance95"),
                         y_probs: Optional[np.ndarray] = None,
                         ) -> Dict[str, np.ndarray]:
    """Per-channel metrics for ONE case (batch size 1, reference
    metrics.py:40) with the BraTS edge-case conventions (:47-80).

    y_pred, y: [1, D, H, W, C] binary arrays, numpy or tensors; Dice,
    sensitivity and specificity run on the tensors' device, the surface
    distances and ROC-AUC on the host. Returns {metric: [1, C]} numpy."""
    if y_pred.shape[0] != 1:
        raise ValueError("MUST BE batch size = 1 (metrics.py:40)")
    p = torch.as_tensor(y_pred).bool()
    g = torch.as_tensor(y).bool().to(p.device)
    c = p.shape[-1]
    exists_p = p.any(dim=3).any(dim=2).any(dim=1)[0].cpu().numpy()
    exists_g = g.any(dim=3).any(dim=2).any(dim=1)[0].cpu().numpy()
    both_empty = ~exists_p & ~exists_g
    mismatch = exists_p ^ exists_g
    host = None

    def on_host():
        nonlocal host
        if host is None:
            host = p[0].cpu().numpy(), g[0].cpu().numpy()
        return host

    out: Dict[str, np.ndarray] = {}
    for metric in metrics:
        name = metric.lower()
        if name == "dice":
            out["Dice"] = dice_metric(p, g).cpu().numpy()
        elif name == "hausdorff_distance95":
            vals = np.empty((1, c), np.float32)
            for ci in range(c):
                if both_empty[ci]:
                    vals[0, ci] = 0.0
                elif mismatch[ci]:
                    vals[0, ci] = BRATS_DIAGONAL
                else:
                    hp, hg = on_host()
                    vals[0, ci] = hausdorff_distance_95(hp[..., ci], hg[..., ci])
            out["Hausdorff_Distance95"] = vals
        elif name == "sensitivity":
            out["Sensitivity"] = sensitivity_specificity(p, g)[0].cpu().numpy()
        elif name == "specificity":
            out["Specificity"] = sensitivity_specificity(p, g)[1].cpu().numpy()
        elif name == "surface_distance":
            raise NotImplementedError(
                "Not tested and not implemented for the moment")  # metrics.py:83
        elif name == "roc_auc":
            if y_probs is None:
                raise ValueError("y_probs is required for computing roc auc")
            hg = on_host()[1]
            vals = np.empty((1, c), np.float32)
            for ci in range(c):
                if both_empty[ci]:
                    vals[0, ci] = 1.0
                elif mismatch[ci]:
                    vals[0, ci] = 0.0
                else:
                    vals[0, ci] = roc_auc(np.asarray(y_probs)[0, ..., ci].ravel(),
                                          hg[..., ci].ravel())
            out["Roc_Auc"] = vals
        else:
            raise NotImplementedError(f"the metric {metric} is not implemented.")
    return out


def _rankdata_average(a: np.ndarray) -> np.ndarray:
    """1-based ranks with ties assigned the AVERAGE rank of their group —
    scipy.stats.rankdata(method='average') semantics, dependency-free."""
    sorter = np.argsort(a, kind="mergesort")
    inv = np.empty(a.size, np.intp)
    inv[sorter] = np.arange(a.size)
    sa = a[sorter]
    group_start = np.r_[True, sa[1:] != sa[:-1]]      # first of each tie group
    dense = group_start.cumsum()[inv]                 # 1-based group id
    # boundary[k] = index where group k+1 starts; boundary[-1] = n
    boundary = np.r_[np.nonzero(group_start)[0], a.size]
    # average of 1-based positions boundary[g-1]+1 .. boundary[g]
    return 0.5 * (boundary[dense] + boundary[dense - 1] + 1)


def roc_auc(probs: np.ndarray, labels: np.ndarray) -> float:
    """Binary ROC-AUC via the Mann-Whitney rank statistic (no sklearn
    dependency needed). Ties get AVERAGE ranks, matching sklearn/MONAI's
    trapezoidal AUC used by the reference (``compute_roc_auc``,
    metrics.py:158) on quantized/saturated probabilities."""
    pos_mask = labels.astype(bool)
    pos = probs[pos_mask]
    neg = probs[~pos_mask]
    if pos.size == 0 or neg.size == 0:
        return float("nan")
    ranks = _rankdata_average(np.concatenate([pos, neg]))
    auc = (ranks[: pos.size].sum() - pos.size * (pos.size + 1) / 2) / (pos.size * neg.size)
    return float(auc)
