"""Weights into the port: reference ``.pth`` files, and the JAX package's
flax parameter trees.

``load_reference_pth`` reads what the reference trainer saves
(src/main_inference.py:62-69): ``{"model": sd}``, ``{"swa_model": sd}`` for
SWA runs (an AveragedModel: keys prefixed ``module.`` plus an
``n_averaged`` buffer), ``{"state_dict": sd}`` or a bare state_dict.

``state_dict_from_flax`` is the inverse of the JAX package's
``state_dict_to_flax`` for EquiUnetASSPEvo (``_torch_key_assp_evo`` +
``_convert`` in brats21_tpu/utils/import_torch.py): it maps a flax param
tree, as nested dicts of numpy arrays, onto the port's ``state_dict`` keys
and layouts.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

__all__ = ["load_reference_pth", "state_dict_from_flax"]


def load_reference_pth(path: str, prefer_swa: bool = False
                       ) -> Dict[str, torch.Tensor]:
    """Load a reference checkpoint as a flat name → tensor state_dict.

    Only tensors and plain containers are unpickled (``weights_only``)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob
    if isinstance(blob, Mapping) and not all(
            isinstance(v, torch.Tensor) for v in blob.values()):
        for key in (("swa_model", "model") if prefer_swa
                    else ("model", "swa_model", "state_dict")):
            if key in blob:
                sd = blob[key]
                break
        else:
            raise KeyError(f"{path}: no model/swa_model/state_dict entry; "
                           f"keys={sorted(blob)[:10]}")
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k == "n_averaged":          # AveragedModel bookkeeping
            continue
        if k.startswith("module."):    # AveragedModel wrapper prefix
            k = k[len("module."):]
        out[k] = v
    return out


def _leaf_name(leaf: str) -> str:
    return {"kernel": "weight", "bias": "bias"}[leaf]


def _torch_key(path: Sequence[str]) -> Tuple[str, str]:
    """(torch key, kind) of one EquiUnetASSPEvo flax param path
    (equiunet2021.py:192-333 naming)."""
    parts = list(path)
    leaf, block = parts[-1], parts[0]
    conv = "conv_w" if leaf == "kernel" else "vec"
    if block.startswith("deep"):
        return f"{block}.0.{_leaf_name(leaf)}", conv
    if block == "out_conv":
        return f"out_conv.{_leaf_name(leaf)}", conv
    if block == "aspp":
        sub = parts[1]
        if sub == "conv_k1":
            if parts[2] == "conv":
                return f"aspp.conv_k1.conv.{_leaf_name(leaf)}", conv
            return f"aspp.conv_k1.evo.{leaf}", "evo"
        if sub.startswith("conv_"):
            return f"aspp.convs.{sub.split('_')[1]}.{_leaf_name(leaf)}", conv
    if block.startswith(("bridge", "upconv")):
        if parts[1] == "conv":
            return f"{block}.conv.{_leaf_name(leaf)}", conv
        return f"{block}.evo.{leaf}", "evo"
    if block.startswith(("encoder", "decoder")):
        sub = parts[1]
        seq = {"conv1": "0", "evo1": "1", "conv2": "3", "evo2": "4"}
        if sub in ("conv1", "conv2"):
            return f"{block}.conv_conv_se.{seq[sub]}.{_leaf_name(leaf)}", conv
        if sub in ("evo1", "evo2"):
            return f"{block}.conv_conv_se.{seq[sub]}.{leaf}", "evo"
        if sub == "se":
            fc = {"fc1": "0", "fc2": "2"}[parts[2]]
            return (f"{block}.conv_conv_se.6.fc.{fc}.{_leaf_name(leaf)}",
                    "lin_w" if leaf == "kernel" else "vec")
    raise KeyError(f"assp_evo: unmapped flax path {'/'.join(parts)}")


def _to_torch(arr: np.ndarray, kind: str) -> torch.Tensor:
    arr = np.asarray(arr, np.float32)
    if kind == "conv_w":      # flax [kd, kh, kw, in, out] → torch [out, in, kd, kh, kw]
        arr = arr.transpose(4, 3, 0, 1, 2)
    elif kind == "lin_w":     # flax [in, out] → torch [out, in]
        arr = arr.T
    elif kind == "evo":       # (C,) → (1, C, 1, 1, 1)
        arr = arr.reshape(1, -1, 1, 1, 1)
    return torch.from_numpy(np.array(arr, np.float32, order="C"))


def state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's EquiUnetASSPEvo ``state_dict`` from the JAX package's flax
    params (nested dicts of arrays, ``Conv_0`` levels included). Adds each
    EvoNorm's ``v`` (ones) if absent and its vestigial ``running_var``."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], path: Tuple[str, ...]) -> None:
        for name, child in node.items():
            if isinstance(child, Mapping):
                walk(child, path + (str(name),))
            else:
                key, kind = _torch_key(path + (str(name),))
                sd[key] = _to_torch(child, kind)

    walk(params, ())
    for key in [k for k in sd if k.endswith(".gamma")]:
        prefix = key[: -len("gamma")]
        sd.setdefault(prefix + "v", torch.ones_like(sd[key]))
        sd[prefix + "running_var"] = torch.ones_like(sd[key])
    return sd
