"""Composable TTA: build any Cartesian product of dual transforms and
iterate its (augment, de-augment) pairs.

Port of ``brats21_tpu/ops/tta_compose.py`` (the reference ``tta`` package,
tta/base.py, adapted from qubvel/ttach) on the port's NCDHW tensors
``[B, C, D, H, W]``, the reference's own layout: HorizontalFlip flips dim 3,
VerticalFlip dim 2 and Rotate90 turns dims (2, 3). The 16 combos that
serving runs go through ``ops/tta.py``; this module is the general surface
(custom combo sets, VerticalFlip, noise). No code path of the port calls it.
"""

from __future__ import annotations

import itertools
from typing import Any, Iterator, List, Sequence, Tuple

import torch

# OnAxes as permutations of NCDHW's spatial dims (tta/transforms.py:33-47);
# 'zxy' is the identity
_AUG_AXES = {"zxy": (0, 1, 2, 3, 4), "xyz": (0, 1, 3, 4, 2), "yzx": (0, 1, 4, 2, 3)}
_DEAUG_AXES = {"zxy": (0, 1, 2, 3, 4), "xyz": (0, 1, 4, 2, 3), "yzx": (0, 1, 3, 4, 2)}


class DualTransform:
    """A parameterised invertible transform (tta/base.py:14-39)."""

    identity_param: Any = None

    def __init__(self, pname: str, params: Sequence[Any]):
        self.pname = pname
        self.params = list(params)

    def apply_aug_image(self, image: torch.Tensor, param: Any) -> torch.Tensor:
        raise NotImplementedError

    def apply_deaug_mask(self, mask: torch.Tensor, param: Any) -> torch.Tensor:
        raise NotImplementedError


class OnAxes(DualTransform):
    """Axis permutations xyz / yzx / zxy (tta/transforms.py:16-50)."""

    identity_param = "zxy"

    def __init__(self, axes: Sequence[str]):
        if not all(a in _AUG_AXES for a in axes):
            raise ValueError("axes need to be 'xyz', 'yzx', 'zxy'")
        super().__init__("axe", axes)

    def apply_aug_image(self, image, param):
        return image.permute(*_AUG_AXES[param])

    def apply_deaug_mask(self, mask, param):
        return mask.permute(*_DEAUG_AXES[param])


class HorizontalFlip(DualTransform):
    """Flip dim 3 (tta/transforms.py:53-74)."""

    identity_param = False

    def __init__(self):
        super().__init__("apply", [False, True])

    def apply_aug_image(self, image, param):
        return torch.flip(image, dims=(3,)) if param else image

    apply_deaug_mask = apply_aug_image


class VerticalFlip(DualTransform):
    """Flip dim 2 (tta/transforms.py:77-98)."""

    identity_param = False

    def __init__(self):
        super().__init__("apply", [False, True])

    def apply_aug_image(self, image, param):
        return torch.flip(image, dims=(2,)) if param else image

    apply_deaug_mask = apply_aug_image


class GaussianNoise(VerticalFlip):
    """The reference's GaussianNoise body is a copy of VerticalFlip's
    (tta/transforms.py:125-146); kept so for parity."""


class RandomGaussianNoise(DualTransform):
    """Noise on the image, identity de-augmentation (tta/transforms.py:101-122):
    std ~ U(0, ``std``), then ``mean`` + std · N(0, 1), deterministic
    under ``seed``."""

    identity_param = True

    def __init__(self, mean: float = 0.0, std: float = 0.1, seed: int = 0):
        super().__init__("apply", [True])
        self.mean = mean
        self.std = std
        self.seed = seed

    def apply_aug_image(self, image, param):
        gen = torch.Generator(device=image.device).manual_seed(self.seed)
        s = torch.rand((), generator=gen, device=image.device) * self.std
        noise = torch.randn(image.shape, generator=gen, device=image.device)
        return image + self.mean + (s * noise).to(image.dtype)

    def apply_deaug_mask(self, mask, param):
        return mask


class Rotate90(DualTransform):
    """Rotations in dims (2, 3) (tta/transforms.py:149-173)."""

    identity_param = 0

    def __init__(self, angles: Sequence[int]):
        angles = list(angles)
        if self.identity_param not in angles:
            angles = [self.identity_param] + angles
        super().__init__("angle", angles)

    def apply_aug_image(self, image, param):
        k = (param // 90) % 4
        return torch.rot90(image, k, dims=(2, 3)) if k else image

    def apply_deaug_mask(self, mask, param):
        k = (-(param // 90)) % 4
        return torch.rot90(mask, k, dims=(2, 3)) if k else mask


class Transformer:
    """One (augment chain, reversed de-augment chain) pair
    (tta/base.py:119-133)."""

    def __init__(self, chain: List[Tuple[DualTransform, Any]]):
        self.chain = chain

    def augment_image(self, image: torch.Tensor) -> torch.Tensor:
        for t, p in self.chain:
            image = t.apply_aug_image(image, p)
        return image

    def deaugment_mask(self, mask: torch.Tensor) -> torch.Tensor:
        for t, p in reversed(self.chain):
            mask = t.apply_deaug_mask(mask, p)
        return mask


class Compose:
    """Cartesian product of the transforms' params (tta/base.py:103-133)."""

    def __init__(self, transforms: Sequence[DualTransform]):
        self.transforms = list(transforms)

    def __len__(self) -> int:
        out = 1
        for t in self.transforms:
            out *= len(t.params)
        return out

    def __iter__(self) -> Iterator[Transformer]:
        for combo in itertools.product(*(t.params for t in self.transforms)):
            yield Transformer(list(zip(self.transforms, combo)))


def default_compose() -> Compose:
    """The reference's configured 16 combos, in its order
    (definer.py:647-658)."""
    return Compose([OnAxes(axes=["zxy", "xyz"]), HorizontalFlip(),
                    Rotate90(angles=[0, 90, 180, 270])])
