"""Deep-supervision head shared by the equiunet family
(``brats21_tpu/models/equiunet.py:179``). The rest of the family comes with
the model-zoo slice."""

from __future__ import annotations

from torch import nn

from .layers import Conv3d


class DeepHead(nn.Sequential):
    """conv1x1 → ×scale trilinear upsample (equiunet2020.py:443-458); the
    reference's Sequential puts the conv at key ``.0``."""

    def __init__(self, in_channels: int, num_classes: int, scale: int):
        super().__init__(
            Conv3d(in_channels, num_classes, 1),
            nn.Upsample(scale_factor=scale, mode="trilinear", align_corners=True))
