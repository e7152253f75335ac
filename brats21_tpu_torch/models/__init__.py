"""Model factory, keyed by the reference CLI names (definer.py:37-174)."""

from __future__ import annotations

from typing import Any

from torch import nn

from ..config import MODEL_CHOICES
from .assp_evo import EquiUnetASSPEvo, EvoNorm3D

__all__ = ["get_model", "EquiUnetASSPEvo", "EvoNorm3D", "IN_CHANNELS"]

IN_CHANNELS = 4  # t1 / t1ce / t2 / flair (definer.py:46)


def get_model(cfg: Any) -> nn.Module:
    """Build the model named by ``cfg.model`` (a TrainConfig, argparse
    Namespace or dict carrying model/width/dropout/num_classes), with deep
    supervision on as in the JAX package. This slice serves
    EquiUnetASSPEvo; the other names come with the model-zoo slice."""
    get = cfg.get if isinstance(cfg, dict) else (
        lambda k, d=None: getattr(cfg, k, d))
    name = get("model")
    width = get("width", 48)
    features4 = [width * 2 ** i for i in range(4)]
    if name in ("equiunet_assp_evo", "equiunet_assp_evocor"):
        return EquiUnetASSPEvo(features4, num_classes=get("num_classes", 3),
                               deep_supervision=True,
                               dropout=get("dropout", 0.0) or 0.0,
                               in_channels=IN_CHANNELS)
    if name in MODEL_CHOICES:
        raise NameError(
            f"model {name!r} is not ported yet: it comes with the model-zoo "
            "slice of the port (ROADMAP A7)")
    raise NameError("Not Supported Model")
