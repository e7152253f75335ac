"""Model factory, keyed by the reference CLI names (definer.py:37-174)."""

from __future__ import annotations

from typing import Any

from torch import nn

from ..config import MODEL_CHOICES
from .assp_evo import EquiUnetASSPEvo, EvoNorm3D
from .equiunet import CBAM, AttEquiUnet, EquiUnet, RefUnet, Unet
from .unet_family import AttUnet, R2AttUnet, R2Unet, UnetFamily

__all__ = ["get_model", "EquiUnet", "AttEquiUnet", "Unet", "EquiUnetASSPEvo",
           "EvoNorm3D", "CBAM", "RefUnet", "IN_CHANNELS"]

IN_CHANNELS = 4  # t1 / t1ce / t2 / flair (definer.py:46)

_UNET_FAMILY = {"modified_unet": UnetFamily, "att_unet": AttUnet,
                "r2unet": R2Unet, "r2attunet": R2AttUnet}


def get_model(cfg: Any) -> nn.Module:
    """Build the model named by ``cfg.model`` (a TrainConfig, argparse
    Namespace or dict carrying model/norm/act/width/dropout/num_classes),
    with deep supervision on, as the JAX package's ``get_model``
    (``models/__init__.py:20-64``) does. The port serves the equiunet
    lines (``equiunet``, ``equiunet_ref``, ``att_equiunet``,
    ``equiunet_assp_evo``/``_evocor``, ``equiunet_assp_evo_ref``) and the
    unet family (``modified_unet``, ``att_unet``, ``r2unet``,
    ``r2attunet``); the MONAI-backed names come with the second part of the
    model zoo (ROADMAP A7)."""
    get = cfg.get if isinstance(cfg, dict) else (
        lambda k, d=None: getattr(cfg, k, d))
    name = get("model")
    width = get("width", 48)
    num_classes = get("num_classes", 3)
    dropout = get("dropout", 0.0) or 0.0
    norm = get("norm", "group")
    act = get("act", "relu")
    features4 = [width * 2 ** i for i in range(4)]
    common = dict(features=features4, num_classes=num_classes, act=act, norm=norm,
                  deep_supervision=True, dropout=dropout, in_channels=IN_CHANNELS)
    if name in ("equiunet", "equiunet_ref"):
        return EquiUnet(**common, refinement=name == "equiunet_ref")
    if name == "att_equiunet":
        return AttEquiUnet(**common)
    if name in ("equiunet_assp_evo", "equiunet_assp_evocor", "equiunet_assp_evo_ref"):
        # EvoNorm only: --norm and --act do not apply (equiunet2021.py:233)
        return EquiUnetASSPEvo(features4, num_classes=num_classes, deep_supervision=True,
                               dropout=dropout, in_channels=IN_CHANNELS,
                               refinement=name == "equiunet_assp_evo_ref")
    if name in _UNET_FAMILY:
        # the reference's dispatch tests "att_equiunet" where it means
        # "att_unet" (definer.py:158); fixed as the JAX package fixes it.
        # The family takes no dropout.
        return _UNET_FAMILY[name](features4, num_classes=num_classes, norm=norm, act=act,
                                  deep_supervision=True, in_channels=IN_CHANNELS)
    if name in MODEL_CHOICES:
        raise NameError(
            f"model {name!r} is not ported yet: the MONAI-backed models come with "
            "the second part of the model zoo (ROADMAP A7, part 2)")
    raise NameError("Not Supported Model")
