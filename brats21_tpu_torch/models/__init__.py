"""Model factory, keyed by the reference CLI names (definer.py:37-174)."""

from __future__ import annotations

from typing import Any

from torch import nn

from .assp_evo import EquiUnetASSPEvo, EvoNorm3D
from .equiunet import CBAM, AttEquiUnet, EquiUnet, RefUnet, Unet
from .dynunet import DynUNet
from .extra import BasicUNet, HighResNet, SegResNet, SegResNetVAE, VNet
from .unet_family import AttUnet, R2AttUnet, R2Unet, UnetFamily
from .swin_unetr import SwinUNETR
from .unetr import UNETR

__all__ = ["get_model", "EquiUnet", "AttEquiUnet", "Unet", "EquiUnetASSPEvo",
           "EvoNorm3D", "CBAM", "RefUnet", "BasicUNet", "SegResNet", "SegResNetVAE",
           "HighResNet", "VNet", "DynUNet", "UNETR", "SwinUNETR", "IN_CHANNELS"]

IN_CHANNELS = 4  # t1 / t1ce / t2 / flair (definer.py:46)

_UNET_FAMILY = {"modified_unet": UnetFamily, "att_unet": AttUnet,
                "r2unet": R2Unet, "r2attunet": R2AttUnet}


def get_model(cfg: Any) -> nn.Module:
    """Build the model named by ``cfg.model`` (a TrainConfig, argparse
    Namespace or dict carrying model/norm/act/width/dropout/num_classes and,
    for ``segresnetvae`` and ``unet_tr``, patch_size), as the JAX package's
    ``get_model`` (``models/__init__.py:20-94``) does: the equiunet lines
    and the unet family with deep supervision on, and the MONAI-backed names
    (``basic_unet``, ``segresnet``, ``segresnetvae``, ``highresnet``,
    ``vnet``, ``nnunet``, ``unet_tr``) with the reference's
    hyperparameters, and ``swin_unetr`` with the published BraTS 2021
    sizes (feature size 48, heads 3, 6, 12, 24; ``--width``, ``--norm``
    and ``--act`` do not apply)."""
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
    if name == "basic_unet":
        features = [width * 2 ** i for i in range(5)] + [width]
        return BasicUNet(features, num_classes=num_classes, act=act, norm=norm,
                         dropout=dropout, in_channels=IN_CHANNELS)
    if name == "segresnet":
        return SegResNet(init_filters=8, num_classes=num_classes, dropout=dropout, norm=norm,
                         in_channels=IN_CHANNELS)
    if name == "segresnetvae":
        return SegResNetVAE(get("patch_size"), init_filters=8, num_classes=num_classes,
                            dropout=dropout, in_channels=IN_CHANNELS)
    if name == "highresnet":
        return HighResNet(num_classes=num_classes, act=act, norm=norm, dropout=dropout,
                          in_channels=IN_CHANNELS)
    if name == "vnet":
        return VNet(num_classes=num_classes, act=act, dropout=dropout, in_channels=IN_CHANNELS)
    if name == "nnunet":
        return DynUNet(num_classes=num_classes, norm=norm, in_channels=IN_CHANNELS)
    if name == "unet_tr":
        return UNETR(tuple(get("patch_size")), num_classes=num_classes, feature_size=16,
                     hidden_size=768, mlp_dim=3072, num_heads=12, norm=norm,
                     in_channels=IN_CHANNELS)
    if name == "swin_unetr":
        return SwinUNETR(num_classes=num_classes, feature_size=48, depths=(2, 2, 2, 2),
                         num_heads=(3, 6, 12, 24), in_channels=IN_CHANNELS)
    raise NameError("Not Supported Model")
