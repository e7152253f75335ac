"""Test-time augmentation on the card.

Port of ``brats21_tpu/ops/tta.py``. The 16-combo set —
``OnAxes(["zxy","xyz"]) × HorizontalFlip × Rotate90([0,90,180,270])``
(definer.py:653-657) — runs as a Python loop in the reference order, each
combo augmenting the volume, running the model, de-augmenting the main
head and adding its fp32 sigmoid probabilities to one accumulator, so
memory stays one volume's worth whatever the combo count. With a
criterion and a target (validation), each combo's whole output tree is
de-augmented and its deep-supervision loss added to a second accumulator.

Layout: channels-last ``[B, s0, s1, s2, C]`` as in the JAX package.
Torch spatial dims (2,3,4) map to (1,2,3): HorizontalFlip = flip axis 2,
Rotate90 = rot in axes (1,2), OnAxes 'xyz' = spatial (s0,s1,s2)→(s1,s2,s0).
Flips/rot90 mix axes 1 and 2, so TTA requires s0 == s1 (pad first).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from ..learning.losses import deep_supervision_loss


def main_head(out: Any) -> torch.Tensor:
    """Main-head logits from a model output: plain logits, (logits, deeps)
    tuples, or [refined, out] refinement pairs (inferers.py:135-138)."""
    if isinstance(out, tuple) and len(out) == 2 \
            and isinstance(out[1], (list, tuple)):
        out = out[0]
    if isinstance(out, (list, tuple)):
        out = out[0]
    return out


AXES: Tuple[str, ...] = ("zxy", "xyz")       # definer.py:653; 'zxy' = identity
ANGLES: Tuple[int, ...] = (0, 90, 180, 270)
FLIPS: Tuple[bool, ...] = (False, True)

#: Cartesian product in the reference order (tta/base.py:115):
#: for axe in AXES: for flip in FLIPS: for angle in ANGLES
COMBOS: List[Tuple[str, bool, int]] = [
    (a, f, r) for a in AXES for f in FLIPS for r in ANGLES]
NUM_COMBOS = len(COMBOS)  # 16


def aug_axes(x: torch.Tensor, axe: str) -> torch.Tensor:
    """OnAxes.apply_aug_image (tta/transforms.py:33-39), channels-last."""
    if axe == "zxy":
        return x
    if axe == "xyz":
        return x.permute(0, 2, 3, 1, 4)
    if axe == "yzx":
        return x.permute(0, 3, 1, 2, 4)
    raise ValueError(axe)


def deaug_axes(y: torch.Tensor, axe: str) -> torch.Tensor:
    """OnAxes.apply_deaug_mask (tta/transforms.py:41-47)."""
    if axe == "zxy":
        return y
    if axe == "xyz":
        return y.permute(0, 3, 1, 2, 4)
    if axe == "yzx":
        return y.permute(0, 2, 3, 1, 4)
    raise ValueError(axe)


def aug_flip_rot(x: torch.Tensor, flip: bool, angle: int) -> torch.Tensor:
    """HorizontalFlip then Rotate90 (tta/transforms.py:63-66, 165-167)."""
    if flip:
        x = torch.flip(x, dims=(2,))
    k = (angle // 90) % 4
    if k:
        x = torch.rot90(x, k, dims=(1, 2))
    return x


def deaug_flip_rot(y: torch.Tensor, flip: bool, angle: int) -> torch.Tensor:
    """Inverse, reversed order (Compose reverses the de-aug chain,
    tta/base.py:119-133)."""
    k = (-(angle // 90)) % 4
    if k:
        y = torch.rot90(y, k, dims=(1, 2))
    if flip:
        y = torch.flip(y, dims=(2,))
    return y


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    """``fn`` on every head of a model output (a tensor, or nested
    tuples/lists of them); a dict of auxiliary loss scalars
    (SegResNetVAE's ``{"vae_loss": s}``) passes as it is."""
    if isinstance(tree, dict):
        return tree
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def tta_mean_probs(apply_fn: Callable[[torch.Tensor], Any], x: torch.Tensor,
                   criterion: Optional[Callable] = None, target: Any = None,
                   axes: Sequence[str] = AXES,
                   num_classes: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean sigmoid probabilities (fp32) of the main head, mean
    deep-supervision loss) over the TTA combos — the engine.py:229-249
    fusion. ``apply_fn`` maps a channels-last volume to the model output in
    the same layout (logits, or (logits, deeps)). With ``criterion`` and
    ``target`` (NCDHW, or the boundary criteria's (seg, distance_map) pair,
    as the port's losses take them) each combo's de-augmented output tree
    goes through ``deep_supervision_loss`` as NCDHW views; else the loss is
    0."""
    if x.shape[1] != x.shape[2]:
        raise ValueError(
            f"TTA requires square first two spatial dims, got {tuple(x.shape)}; "
            "pad with pad_to_square_tta first")
    probs = torch.zeros(x.shape[:-1] + (num_classes,), dtype=torch.float32,
                        device=x.device)
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    with_loss = criterion is not None and target is not None
    combos = [c for c in COMBOS if c[0] in axes]
    for axe, flip, angle in combos:
        out = apply_fn(aug_flip_rot(aug_axes(x, axe), flip, angle))
        if not with_loss:
            out = main_head(out)      # de-augment the main head alone
        out = tree_map(lambda t: deaug_axes(deaug_flip_rot(t, flip, angle), axe), out)
        probs += torch.sigmoid(main_head(out).float())
        if with_loss:
            loss += deep_supervision_loss(
                criterion, tree_map(lambda t: t.permute(0, 4, 1, 2, 3), out), target)
    return probs / len(combos), loss / len(combos)


def pad_to_square_tta(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Zero-pad spatial axes 1,2 to the common square size required by TTA;
    returns (padded, (pad0, pad1)) for later cropping."""
    s0, s1 = x.shape[1], x.shape[2]
    side = max(s0, s1)
    pads = [0, 0] * (x.ndim - 3) + [0, side - s1, 0, side - s0]
    return torch.nn.functional.pad(x, pads), (side - s0, side - s1)


def crop_from_square_tta(y: torch.Tensor, pads: Tuple[int, int]) -> torch.Tensor:
    p0, p1 = pads
    return y[:, : y.shape[1] - p0, : y.shape[2] - p1]
