"""Segmentation losses on NCDHW tensors.

Port of ``brats21_tpu/learning/losses.py`` (the reference criterion zoo with
the kwargs definer.py:177-288 selects): pure functions of logits
``[B, C, D, H, W]`` and multi-channel binary targets (WT/TC/ET) of the same
shape. The Hausdorff losses take their distance maps from the on-device EDT
(``ops/edt.py``), detached, as the JAX package's ``stop_gradient`` and the
reference's numpy maps are; under deep supervision (:class:`HDCriterion`)
the target's maps and every head's come from one EDT batch. ``boundary``
and ``dice_boundary`` take a ``(seg, distance_map)`` target, the map made
by the data loader (``data/transforms.py:compute_distance_map_fn``).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.edt import one_hot2hd_dist

LossFn = Callable[..., torch.Tensor]


def _spatial(x: torch.Tensor) -> tuple:
    return tuple(range(2, x.dim()))


def _activate(logits: torch.Tensor, sigmoid: bool, softmax: bool) -> torch.Tensor:
    if sigmoid:
        return torch.sigmoid(logits)
    if softmax:
        return torch.softmax(logits, dim=1)
    return logits


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


def dice_loss(logits: torch.Tensor, target: torch.Tensor, *,
              include_background: bool = True, sigmoid: bool = True,
              softmax: bool = False, squared_pred: bool = True,
              jaccard: bool = False, batch: bool = True, smooth_nr: float = 1e-5,
              smooth_dr: float = 1e-5, reduction: str = "mean") -> torch.Tensor:
    """MONAI DiceLoss with the reference 'dice'/'jaccard' kwargs
    (definer.py:184-203)."""
    probs = _activate(logits.float(), sigmoid, softmax)
    tgt = target.float()
    if not include_background:
        probs, tgt = probs[:, 1:], tgt[:, 1:]
    axes = ((0,) + _spatial(probs)) if batch else _spatial(probs)
    intersection = torch.sum(tgt * probs, dim=axes)
    if squared_pred:
        ground_o = torch.sum(tgt ** 2, dim=axes)
        pred_o = torch.sum(probs ** 2, dim=axes)
    else:
        ground_o = torch.sum(tgt, dim=axes)
        pred_o = torch.sum(probs, dim=axes)
    denominator = ground_o + pred_o
    if jaccard:
        denominator = 2.0 * (denominator - intersection)
    f = 1.0 - (2.0 * intersection + smooth_nr) / (denominator + smooth_dr)
    return _reduce(f, reduction)


def generalized_dice_loss(logits: torch.Tensor, target: torch.Tensor, *,
                          include_background: bool = True, sigmoid: bool = True,
                          softmax: bool = False, w_type: str = "square",
                          batch: bool = False, smooth_nr: float = 1e-5,
                          smooth_dr: float = 1e-5, reduction: str = "mean",
                          **_ignored: Any) -> torch.Tensor:
    """MONAI GeneralizedDiceLoss (definer.py:223-231); infinite weights of
    empty classes take the largest finite weight."""
    probs = _activate(logits.float(), sigmoid, softmax)
    tgt = target.float()
    if not include_background:
        probs, tgt = probs[:, 1:], tgt[:, 1:]
    axes = ((0,) + _spatial(probs)) if batch else _spatial(probs)
    intersection = torch.sum(tgt * probs, dim=axes)
    ground_o = torch.sum(tgt, dim=axes)
    pred_o = torch.sum(probs, dim=axes)
    denominator = ground_o + pred_o
    if w_type == "square":
        w = 1.0 / (ground_o * ground_o)
    elif w_type == "simple":
        w = 1.0 / ground_o
    else:
        w = torch.ones_like(ground_o)
    finite = torch.isfinite(w)
    w_max = torch.where(finite, w, 0.0).amax(dim=-1, keepdim=True)
    w = torch.where(finite, w, w_max.expand_as(w))
    numer = 2.0 * torch.sum(intersection * w, dim=-1) + smooth_nr
    denom = torch.sum(denominator * w, dim=-1) + smooth_dr
    return _reduce(1.0 - numer / denom, reduction)


def focal_loss(logits: torch.Tensor, target: torch.Tensor, *, gamma: float = 2.0,
               reduction: str = "mean") -> torch.Tensor:
    """MONAI FocalLoss (definer.py:232-236): sigmoid focal BCE."""
    i = logits.float()
    t = target.float()
    max_val = torch.clamp(-i, min=0.0)
    ce = i - i * t + max_val + torch.log(torch.exp(-max_val) + torch.exp(-i - max_val))
    invprobs = F.logsigmoid(-i * (t * 2.0 - 1.0))
    return _reduce(torch.exp(invprobs * gamma) * ce, reduction)


def tversky_loss(logits: torch.Tensor, target: torch.Tensor, *,
                 include_background: bool = True, sigmoid: bool = True,
                 softmax: bool = False, alpha: float = 0.5, beta: float = 0.5,
                 batch: bool = False, smooth_nr: float = 1e-5,
                 smooth_dr: float = 1e-5, reduction: str = "mean") -> torch.Tensor:
    """MONAI TverskyLoss (definer.py:237-245)."""
    probs = _activate(logits.float(), sigmoid, softmax)
    tgt = target.float()
    if not include_background:
        probs, tgt = probs[:, 1:], tgt[:, 1:]
    p0, p1 = probs, 1.0 - probs
    g0, g1 = tgt, 1.0 - tgt
    axes = ((0,) + _spatial(probs)) if batch else _spatial(probs)
    tp = torch.sum(p0 * g0, dim=axes)
    fp = alpha * torch.sum(p0 * g1, dim=axes)
    fn = beta * torch.sum(p1 * g0, dim=axes)
    return _reduce(1.0 - (tp + smooth_nr) / (tp + fp + fn + smooth_dr), reduction)


def cross_entropy_loss(logits: torch.Tensor, target: torch.Tensor,
                       reduction: str = "mean") -> torch.Tensor:
    """torch CrossEntropyLoss over channel logits with the argmax of the
    one-hot target as label (reference DiceCELoss.ce, losses.py:559-575)."""
    labels = torch.argmax(target, dim=1, keepdim=True)
    logp = torch.log_softmax(logits.float(), dim=1)
    return _reduce(-torch.gather(logp, 1, labels)[:, 0], reduction)


def dice_ce_loss(logits: torch.Tensor, target: torch.Tensor, *,
                 lambda_dice: float = 1.0, lambda_ce: float = 1.0,
                 **dice_kwargs: Any) -> torch.Tensor:
    """Reference DiceCELoss (losses.py:470-595) with definer kwargs (:204-212)."""
    return (lambda_dice * dice_loss(logits, target, **dice_kwargs)
            + lambda_ce * cross_entropy_loss(logits, target))


def dice_focal_loss(logits: torch.Tensor, target: torch.Tensor, *,
                    gamma: float = 2.0, lambda_dice: float = 1.0,
                    lambda_focal: float = 1.0, **dice_kwargs: Any) -> torch.Tensor:
    """MONAI DiceFocalLoss with definer kwargs (:213-221, batch=False)."""
    return (lambda_dice * dice_loss(logits, target, **dice_kwargs)
            + lambda_focal * focal_loss(logits, target, gamma=gamma))


def _select(x: torch.Tensor, idc: Optional[Sequence[int]]) -> torch.Tensor:
    """``x[:, idc]``, or ``x`` itself when ``idc`` is every channel in order."""
    if idc is None or list(idc) == list(range(x.shape[1])):
        return x
    return x[:, list(idc)]


def _dist_maps(seg: torch.Tensor) -> torch.Tensor:
    """One HD distance map per (b, c) of ``[B, C, *spatial]``: one EDT
    batch of B·C masks."""
    flat = seg.reshape((-1,) + tuple(seg.shape[2:]))
    return one_hot2hd_dist(flat).reshape(seg.shape)


def _pred_one_hot(logits: torch.Tensor, idc: Optional[Sequence[int]],
                  sigmoid: bool, softmax: bool) -> torch.Tensor:
    """The prediction's one-hot for its HD map, as bool masks: the argmax
    over all channels of the activated logits (the first of equal maxima,
    reference losses.py:43-56), taken before the ``idc`` selection
    (losses.py:158-159)."""
    probs = _activate(logits.float(), sigmoid, softmax)
    cls = torch.argmax(probs, dim=1, keepdim=True)
    channels = torch.arange(probs.shape[1], device=probs.device)
    return _select(cls == channels.view((1, -1) + (1,) * (probs.dim() - 2)), idc)


def hd_dist_maps(target: torch.Tensor, pred_one_hots: Sequence[torch.Tensor]
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The target's HD maps and each prediction one-hot's, all
    ``[B, C, *spatial]`` of one shape, from one EDT batch (three envelope
    launches)."""
    maps = _dist_maps(torch.cat([target.bool()] + list(pred_one_hots)))
    maps = list(maps.split(target.shape[0]))
    return maps[0], maps[1:]


def hausdorff_loss(logits: torch.Tensor, target: torch.Tensor, *,
                   idc: Optional[Sequence[int]] = None, alpha: float = 2.0,
                   sigmoid: bool = True, softmax: bool = False,
                   reduction: str = "mean",
                   maps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> torch.Tensor:
    """HD loss (reference losses.py:98-179): (p − t)² weighted by
    tdm^α + pdm^α, the maps from the on-device EDT, detached, or given as
    ``maps = (tdm, pdm)`` (:func:`hd_dist_maps`, after the ``idc``
    selection)."""
    probs = _select(_activate(logits.float(), sigmoid, softmax), idc)
    tgt = _select(target.float(), idc)
    if maps is None:
        with torch.no_grad():
            tdm, (pdm,) = hd_dist_maps(tgt, [_pred_one_hot(logits, idc, sigmoid, softmax)])
    else:
        tdm, pdm = maps
    delta = (probs - tgt) ** 2
    dtm = tdm ** alpha + pdm ** alpha
    return _reduce(delta * dtm, reduction)


def dice_hd_loss(logits: torch.Tensor, target: torch.Tensor, *,
                 idc_hd: Optional[Sequence[int]] = None, alpha_hd: float = 2.0,
                 hybrid: bool = False, weight_hd: float = 0.5,
                 weight_dice: float = 0.5,
                 maps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 **dice_kwargs: Any) -> torch.Tensor:
    """Reference DiceHDLoss (losses.py:182-293) with definer kwargs (:254-266)."""
    d = dice_loss(logits, target, **dice_kwargs)
    h = hausdorff_loss(logits, target, idc=idc_hd, alpha=alpha_hd,
                       sigmoid=dice_kwargs.get("sigmoid", True),
                       softmax=dice_kwargs.get("softmax", False), maps=maps)
    if hybrid:
        return weight_dice * d + weight_hd * h
    return d + h


class HDCriterion:
    """``hd`` / ``dice_hd`` as ``criterion(logits, target)``, plus
    :meth:`per_head` for deep supervision: the target's maps once and every
    head's prediction maps in the same EDT batch, where head by head the
    target's maps would be recomputed for each head. The losses are those
    of the head-by-head calls, bit for bit."""

    def __init__(self, loss: LossFn, **kwargs: Any):
        self.loss = partial(loss, **kwargs)
        # what the maps depend on, under the names hd and dice_hd take
        self.idc = kwargs.get("idc", kwargs.get("idc_hd"))
        self.sigmoid = kwargs.get("sigmoid", True)
        self.softmax = kwargs.get("softmax", False)

    def __call__(self, logits: torch.Tensor, target: torch.Tensor,
                 maps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> torch.Tensor:
        return self.loss(logits, target, maps=maps)

    @torch.no_grad()
    def maps(self, heads: Sequence[torch.Tensor], target: torch.Tensor
             ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The target's HD maps and each head's, from one EDT batch."""
        return hd_dist_maps(_select(target, self.idc), [
            _pred_one_hot(h, self.idc, self.sigmoid, self.softmax) for h in heads])

    def per_head(self, heads: Sequence[torch.Tensor], target: torch.Tensor
                 ) -> List[torch.Tensor]:
        tdm, pdms = self.maps(heads, target)
        return [self(h, target, maps=(tdm, pdm)) for h, pdm in zip(heads, pdms)]


def boundary_loss(logits: torch.Tensor, dist_maps: Any, *,
                  idc: Optional[Sequence[int]] = None, sigmoid: bool = True,
                  softmax: bool = False, reduction: str = "mean") -> torch.Tensor:
    """Surface/Boundary loss (reference losses.py:296-358): mean of
    probs · precomputed signed distance maps (NCDHW). A (seg, dist_map)
    pair is unwrapped to the map (reference :315-317)."""
    if isinstance(dist_maps, (tuple, list)):
        dist_maps = dist_maps[1]
    probs = _activate(logits.float(), sigmoid, softmax)
    dmaps = dist_maps.float()
    if idc is not None:
        idc = list(idc)
        probs, dmaps = probs[:, idc], dmaps[:, idc]
    return _reduce(probs * dmaps, reduction)


def dice_boundary_loss(logits: torch.Tensor,
                       target_and_dist: Tuple[torch.Tensor, torch.Tensor], *,
                       idc_boundary: Optional[Sequence[int]] = None,
                       lambda_dice: float = 1.0, lambda_boundary: float = 1.0,
                       **dice_kwargs: Any) -> torch.Tensor:
    """Reference DiceBoundaryLoss (losses.py:361-467): the target is a
    (seg, distance_map) pair."""
    target, dist_maps = target_and_dist
    d = dice_loss(logits, target, **dice_kwargs)
    b = boundary_loss(logits, dist_maps, idc=idc_boundary,
                      sigmoid=dice_kwargs.get("sigmoid", True),
                      softmax=dice_kwargs.get("softmax", False))
    return lambda_dice * d + lambda_boundary * b


def make_criterion(cfg: Any) -> LossFn:
    """Criterion dispatch of definer.py:177-288 (the JAX package's
    ``make_criterion``), returning ``loss(logits, target)``."""
    get = cfg.get if isinstance(cfg, dict) else (lambda k, d=None: getattr(cfg, k, d))
    name = get("criterion")
    idc = list(range(get("num_classes", 3) or 3))
    base = dict(include_background=True, sigmoid=True, softmax=False,
                reduction="mean")
    if name == "dice":
        return partial(dice_loss, **base, squared_pred=True, jaccard=False, batch=True)
    if name == "jaccard":
        return partial(dice_loss, **base, squared_pred=True, jaccard=True, batch=True)
    if name == "dice_ce":
        return partial(dice_ce_loss, **base, squared_pred=True, batch=True)
    if name == "dice_focal":
        return partial(dice_focal_loss, **base, squared_pred=True, batch=False)
    if name == "generalized_dice":
        return partial(generalized_dice_loss, include_background=True, sigmoid=True,
                       softmax=False, w_type="square", reduction="mean")
    if name == "focal":
        return partial(focal_loss, gamma=2.0, reduction="mean")
    if name == "tversky":
        return partial(tversky_loss, **base, alpha=0.5, beta=0.5)
    if name == "hd":
        return HDCriterion(hausdorff_loss, idc=idc, alpha=2.0,
                           sigmoid=True, softmax=False, reduction="mean")
    if name == "dice_hd":
        # reference DiceHDLoss defaults batch=False (losses.py:212)
        return HDCriterion(dice_hd_loss, idc_hd=idc, alpha_hd=2.0,
                           hybrid=False, weight_hd=0.5, weight_dice=0.5, **base,
                           squared_pred=True, batch=False)
    if name == "boundary":
        return partial(boundary_loss, idc=idc, sigmoid=True, softmax=False,
                       reduction="mean")
    if name == "dice_boundary":
        # reference DiceBoundaryLoss defaults batch=False (losses.py:387)
        return partial(dice_boundary_loss, idc_boundary=idc, **base,
                       squared_pred=True, batch=False)
    raise NameError("Not Supported Criterion")


def deep_supervision_loss(criterion: LossFn, outputs: Any, target: Any) -> torch.Tensor:
    """Mean of the criterion over the main and deep-supervision heads
    (reference engine.py:312-333, JAX ``losses.py:307-330``): ``outputs``
    is logits, ``(logits, [deep heads])``, for the refinement models
    ``([refined, logits], [deep heads])``, every main head entering the
    mean, or ``(logits, {name: scalar})``, whose scalars are additive
    auxiliary losses (SegResNetVAE's ``vae_loss``, MONAI semantics) added
    after the mean and never given to the criterion; ``target`` is the seg
    or, for the boundary criteria, the (seg, distance_map) pair, the same
    for every head. An :class:`HDCriterion` takes all heads at once."""
    aux: Dict[str, torch.Tensor] = {}
    if isinstance(outputs, tuple) and len(outputs) == 2 and isinstance(outputs[1], dict):
        (main, aux), deeps = outputs, []
    elif isinstance(outputs, tuple) and len(outputs) == 2 \
            and isinstance(outputs[1], (list, tuple)):
        main, deeps = outputs
    else:
        main, deeps = outputs, []
    heads = (list(main) if isinstance(main, (list, tuple)) else [main]) + list(deeps)
    if isinstance(criterion, HDCriterion):
        losses = criterion.per_head(heads, target)
    else:
        losses = [criterion(h, target) for h in heads]
    loss = torch.stack(losses).mean()
    for value in aux.values():
        loss = loss + value
    return loss
