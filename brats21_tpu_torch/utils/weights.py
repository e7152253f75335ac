"""Weights into the port: reference ``.pth`` files, and the JAX package's
flax parameter trees.

``load_reference_pth`` reads what the reference trainer saves
(src/main_inference.py:62-69): ``{"model": sd}``, ``{"swa_model": sd}`` for
SWA runs (an AveragedModel: keys prefixed ``module.`` plus an
``n_averaged`` buffer), ``{"state_dict": sd}`` or a bare state_dict.

``state_dict_from_flax`` is the inverse of the JAX package's
``state_dict_to_flax`` (``brats21_tpu/utils/import_torch.py``) for every
model the port serves: it maps a flax param tree (and the ``batch_stats``
tree of a model with BatchNorms), as nested dicts of numpy arrays, onto
the port's ``state_dict`` keys and layouts through a copy of that
module's per-family key rules.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

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
    return _drop_shared_duplicates(out)


#: MONAI DynUNet's ``skip_layers`` chain re-registers the blocks it wires
#: (``input_block``, ``downsamples``, ``bottleneck``, ``upsamples``, the
#: heads) under nested ``downsample``/``upsample``/``next_layer``/
#: ``super_head`` names (``import_torch.py:606-611``)
_SKIP_PREFIX = "net.skip_layers."
_SKIP_ROLES = ("downsample.", "upsample.", "super_head.", "heads.")


def _drop_shared_duplicates(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An nnunet checkpoint without its ``net.skip_layers.*`` keys. Each
    dropped tensor must equal a kept one of the same name below the chain
    (``…conv1.conv.weight`` of ``net.downsamples.0``, say), else the
    checkpoint is not MONAI's shared-module layout and this raises."""
    dup = [k for k in sd if k.startswith(_SKIP_PREFIX)]
    if not dup:
        return sd
    kept = {k: v for k, v in sd.items() if not k.startswith(_SKIP_PREFIX)}
    for k in dup:
        tail = k[len(_SKIP_PREFIX):]
        while tail.startswith("next_layer."):
            tail = tail[len("next_layer."):]
        for role in _SKIP_ROLES:
            if tail.startswith(role):
                tail = tail[len(role):]
                break
        if not any(c.endswith("." + tail) and c != k and v.shape == sd[k].shape
                   and torch.equal(v, sd[k]) for c, v in kept.items()):
            raise ValueError(f"{k}: no kept tensor named …{tail} equals it, so it is not a "
                             "re-registration of a shared module")
    return kept


def _wb(leaf: str) -> str:
    """torch's name for a flax leaf; BCNorm's EstBN affine (no rule in the
    JAX package) sits under the norm's ``bn`` child."""
    return {"kernel": "weight", "scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var",
            "estbn_scale": "bn.weight", "estbn_bias": "bn.bias"}[leaf]


def _kind(leaf: str, weight_kind: str = "conv_w") -> str:
    return weight_kind if leaf == "kernel" else "vec"


def _torch_key_equiunet(parts: Sequence[str]) -> Tuple[str, str]:
    """The 2020 line (``import_torch.py:112-133``): ``encoderN/ConvBnRelu1/
    {conv/Conv_0, bn}`` → ``encoderN.ConvBnRelu1.{conv,bn}``, ``deep_*/conv``
    → ``deep_*.0``, and RefUnet's ``refunet/{conv0,hx*,d*,conv_d0}`` alike."""
    leaf = parts[-1]
    if parts[0].startswith("deep"):
        return f"{parts[0]}.0.{_wb(leaf)}", _kind(leaf)
    if parts[-2] == "Conv_0":
        return f"{'.'.join(parts[:-2])}.{_wb(leaf)}", _kind(leaf)
    if parts[-2] == "bn":
        return f"{'.'.join(parts[:-2])}.bn.{_wb(leaf)}", "vec"
    raise KeyError(f"equiunet: unmapped flax path {'/'.join(parts)}")


def _torch_key_att_equiunet(parts: Sequence[str]) -> Tuple[str, str]:
    """AttEquiUnet (``import_torch.py:186-214``): ChannelGate's
    ``Dense_{0,1}`` → ``mlp.{1,3}``, SpatialGate's ``spatial_{conv,bn}`` →
    ``spatial.{conv,bn}``, and flax's ``bottom_2``/``bottom_2_cbam`` →
    ``bottom_2.0``/``bottom_2.1``."""
    parts = list(parts)
    leaf = parts[-1]
    if parts[0] == "bottom_2":
        parts = ["bottom_2", "0"] + parts[1:]
    elif parts[0] == "bottom_2_cbam":
        parts = ["bottom_2", "1"] + parts[1:]
    if "ChannelGate" in parts:
        i = parts.index("ChannelGate")
        idx = {"Dense_0": "1", "Dense_1": "3"}[parts[i + 1]]
        return f"{'.'.join(parts[:i + 1])}.mlp.{idx}.{_wb(leaf)}", _kind(leaf, "lin_w")
    if "SpatialGate" in parts:
        i = parts.index("SpatialGate")
        prefix = ".".join(parts[:i + 1])
        if parts[i + 1] == "spatial_conv":
            return f"{prefix}.spatial.conv.{_wb(leaf)}", _kind(leaf)
        return f"{prefix}.spatial.bn.{_wb(leaf)}", "vec"
    return _torch_key_equiunet(parts)


def _torch_key_assp_evo(parts: Sequence[str]) -> Tuple[str, str]:
    """EquiUnetASSPEvo (``import_torch.py:136-183``, equiunet2021.py:192-333
    naming); the refinement's ``refunet`` takes the 2020 line's rule."""
    leaf, block = parts[-1], parts[0]
    conv = _kind(leaf)
    if block == "refunet":
        return _torch_key_equiunet(parts)
    if block.startswith("deep"):
        return f"{block}.0.{_wb(leaf)}", conv
    if block == "out_conv":
        return f"out_conv.{_wb(leaf)}", conv
    if block == "aspp":
        sub = parts[1]
        if sub == "conv_k1":
            if parts[2] == "conv":
                return f"aspp.conv_k1.conv.{_wb(leaf)}", conv
            return f"aspp.conv_k1.evo.{leaf}", "evo"
        if sub.startswith("conv_"):
            return f"aspp.convs.{sub.split('_')[1]}.{_wb(leaf)}", conv
    if block.startswith(("bridge", "upconv")):
        if parts[1] == "conv":
            return f"{block}.conv.{_wb(leaf)}", conv
        return f"{block}.evo.{leaf}", "evo"
    if block.startswith(("encoder", "decoder")):
        sub = parts[1]
        seq = {"conv1": "0", "evo1": "1", "conv2": "3", "evo2": "4"}
        if sub in ("conv1", "conv2"):
            return f"{block}.conv_conv_se.{seq[sub]}.{_wb(leaf)}", conv
        if sub in ("evo1", "evo2"):
            return f"{block}.conv_conv_se.{seq[sub]}.{leaf}", "evo"
        if sub == "se":
            fc = {"fc1": "0", "fc2": "2"}[parts[2]]
            return f"{block}.conv_conv_se.6.fc.{fc}.{_wb(leaf)}", _kind(leaf, "lin_w")
    raise KeyError(f"assp_evo: unmapped flax path {'/'.join(parts)}")


def _unet_family_rule(recurrent: bool, norm: Optional[str]):
    """The unet family (``import_torch.py:222-278``): the Sequential index
    of a block's second conv and of its norms depends on whether there is
    a norm; the recurrent models' blocks are ``RRCNNn``/``Up_RRCNNn``
    where flax names them ``Convn``/``Up_convn``; the attention gates are
    Sequential(conv1x1, BatchNorm3d)."""
    has_norm = norm not in (None, "none")

    def rule(parts: Sequence[str]) -> Tuple[str, str]:
        leaf, block = parts[-1], parts[0]
        kind = _kind(leaf)
        if block == "Conv_1x1" or block.startswith("outconv"):
            return f"{block}.{_wb(leaf)}", kind
        if block.startswith("Att"):
            gate, idx = {"W_g": ("W_g", "0"), "bn_g": ("W_g", "1"),
                         "W_x": ("W_x", "0"), "bn_x": ("W_x", "1"),
                         "psi": ("psi", "0"), "bn_psi": ("psi", "1")}[parts[1]]
            return f"{block}.{gate}.{idx}.{_wb(leaf)}", kind
        if block.startswith("Up") and not block.startswith("Up_conv"):
            idx = {"conv": "1", "norm": "2"}[parts[1]]
            return f"{block}.up.{idx}.{_wb(leaf)}", kind
        if recurrent:
            tblock = ("Up_RRCNN" + block[len("Up_conv"):] if block.startswith("Up_conv")
                      else "RRCNN" + block[len("Conv"):])
            if parts[1] == "conv_1x1":
                return f"{tblock}.Conv_1x1.{_wb(leaf)}", kind
            rec = {"rec1": "0", "rec2": "1"}[parts[1]]
            idx = {"conv": "0", "norm": "1"}[parts[2]]
            return f"{tblock}.RCNN.{rec}.conv.{idx}.{_wb(leaf)}", kind
        idx = ({"conv1": "0", "norm1": "1", "conv2": "3", "norm2": "4"} if has_norm
               else {"conv1": "0", "conv2": "2"})[parts[1]]
        return f"{block}.conv.{idx}.{_wb(leaf)}", kind

    return rule


_UNET_FAMILY = {"modified_unet": False, "att_unet": False, "r2unet": True,
                "r2attunet": True}


# ---------------------------------------------------------------------------
# The MONAI-backed zoo: copies of ``import_torch.py:281-565`` (MONAI 0.6.0's
# module graphs: a Convolution is (conv, adn) with the norm at ``adn.N``,
# dynunet blocks conv1/norm1/conv2/norm2, conv-only layers keep ``conv``)
# ---------------------------------------------------------------------------

def _basic_unet_rule(parts: Sequence[str]) -> Tuple[str, str]:
    """BasicUNet (``import_torch.py:290-331``)."""
    leaf, block = parts[-1], parts[0]

    def two_conv(prefix: str, sub: str) -> Tuple[str, str]:
        i = sub.rsplit("_", 1)[1]
        if sub.startswith("conv"):
            return f"{prefix}.conv_{i}.conv.{_wb(leaf)}", _kind(leaf)
        return f"{prefix}.conv_{i}.adn.N.{_wb(leaf)}", "vec"

    if block == "conv_0":
        return two_conv("conv_0", parts[1])
    if block.startswith("down_"):
        return two_conv(f"{block}.convs", parts[1])
    if block.endswith("_upconv"):
        return f"{block[:-len('_upconv')]}.upsample.deconv.{_wb(leaf)}", _kind(leaf, "deconv_w")
    if block.endswith("_convs"):
        return two_conv(f"{block[:-len('_convs')]}.convs", parts[1])
    if block == "final_conv":
        return f"final_conv.{_wb(leaf)}", _kind(leaf)
    raise KeyError(f"basic_unet: unmapped flax path {'/'.join(parts)}")


def _segresnet_rule(parts: Sequence[str]) -> Tuple[str, str]:
    """SegResNet (``import_torch.py:334-370``)."""
    leaf, block = parts[-1], parts[0]
    kind = _kind(leaf)
    if block == "conv_init":
        return f"convInit.conv.{_wb(leaf)}", kind
    if block == "norm_final":
        return f"conv_final.0.{_wb(leaf)}", "vec"
    if block == "conv_final":
        return f"conv_final.2.conv.{_wb(leaf)}", kind

    def res_block(prefix: str, sub: str) -> Tuple[str, str]:
        if sub.startswith("conv"):
            return f"{prefix}.{sub}.conv.{_wb(leaf)}", kind
        return f"{prefix}.{sub}.{_wb(leaf)}", "vec"

    m = re.fullmatch(r"down_(\d+)_block_(\d+)", block)
    if m:
        return res_block(f"down_layers.{m.group(1)}.{int(m.group(2)) + 1}", parts[1])
    m = re.fullmatch(r"down_(\d+)", block)
    if m:
        return f"down_layers.{m.group(1)}.0.conv.{_wb(leaf)}", kind
    m = re.fullmatch(r"up_conv_(\d+)", block)
    if m:
        return f"up_samples.{m.group(1)}.0.conv.{_wb(leaf)}", kind
    m = re.fullmatch(r"up_(\d+)_block_(\d+)", block)
    if m:
        return res_block(f"up_layers.{m.group(1)}.{m.group(2)}", parts[1])
    raise KeyError(f"segresnet: unmapped flax path {'/'.join(parts)}")


def _segresnetvae_rule(parts: Sequence[str]) -> Tuple[str, str]:
    """SegResNetVAE (``import_torch.py:373-410``), except that the VAE's
    decoder has weights of its own in the port (``vae_up_samples``,
    ``vae_up_layers``) where the JAX importer fills it from MONAI's shared
    segmentation decoder."""
    leaf, block = parts[-1], parts[0]
    kind = _kind(leaf)
    vae = {"vae_norm": ("vae_down.0", "vec"), "vae_down": ("vae_down.2.conv", kind),
           "vae_down_norm": ("vae_down.3", "vec"),
           "vae_up_conv": ("vae_fc_up_sample.0.conv", kind),
           "vae_up_norm": ("vae_fc_up_sample.2", "vec"),
           "vae_final_norm": ("vae_conv_final.0", "vec"),
           "vae_recon": ("vae_conv_final.2.conv", kind)}
    if block in vae:
        prefix, k = vae[block]
        return f"{prefix}.{_wb(leaf)}", k
    lin = {"vae_mu": "vae_fc1", "vae_sigma": "vae_fc2", "vae_fc_up": "vae_fc3"}
    if block in lin:
        return f"{lin[block]}.{_wb(leaf)}", _kind(leaf, "lin_w")
    if block.startswith("vae_up_block_"):
        key, k = _segresnet_rule([f"up_{block.rsplit('_', 1)[1]}_block_0", *parts[1:]])
        return "vae_" + key, k
    if block.startswith("vae_up_"):
        key, k = _segresnet_rule([f"up_conv_{block.rsplit('_', 1)[1]}", *parts[1:]])
        return "vae_" + key, k
    return _segresnet_rule(parts)


def _dynunet_rule(parts: Sequence[str], levels: int = 6) -> Tuple[str, str]:
    """DynUNet under the wrapper's ``net.`` prefix (``import_torch.py:413-460``)."""
    leaf, block = parts[-1], parts[0]

    def basic_block(prefix: str) -> Tuple[str, str]:
        n = {"layer0": "1", "layer1": "2"}[parts[1]]
        if parts[2] == "conv":
            return f"{prefix}.conv{n}.conv.{_wb(leaf)}", _kind(leaf)
        return f"{prefix}.norm{n}.{_wb(leaf)}", "vec"

    if block == "input_block":
        return basic_block("net.input_block")
    m = re.fullmatch(r"down_(\d+)", block)
    if m:
        i = int(m.group(1))
        return basic_block("net.bottleneck" if i == levels - 1 else f"net.downsamples.{i - 1}")
    m = re.fullmatch(r"up_(\d+)_transp", block)
    if m:
        j = levels - 2 - int(m.group(1))
        return f"net.upsamples.{j}.transp_conv.conv.{_wb(leaf)}", _kind(leaf, "deconv_w")
    m = re.fullmatch(r"up_(\d+)_block", block)
    if m:
        return basic_block(f"net.upsamples.{levels - 2 - int(m.group(1))}.conv_block")
    if block == "out_main":
        return f"net.output_block.conv.conv.{_wb(leaf)}", _kind(leaf)
    m = re.fullmatch(r"out_deep_(\d+)", block)
    if m:
        k = int(m.group(1)) - 1
        return f"net.deep_supervision_heads.{k}.conv.conv.{_wb(leaf)}", _kind(leaf)
    raise KeyError(f"nnunet: unmapped flax path {'/'.join(parts)}")


def _highresnet_rule(parts: Sequence[str]) -> Tuple[str, str]:
    """HighResNet's positional ``blocks`` (``import_torch.py:463-495``)."""
    leaf, block = parts[-1], parts[0]
    kind = _kind(leaf)
    flat = {"conv_init": ("blocks.0.layers.0", kind), "norm_init": ("blocks.0.layers.1", "vec"),
            "conv_penult": ("blocks.10.layers.0", kind),
            "norm_penult": ("blocks.10.layers.1", "vec"),
            "conv_final": ("blocks.11.layers.0", kind)}
    if block in flat:
        prefix, k = flat[block]
        return f"{prefix}.{_wb(leaf)}", k
    m = re.fullmatch(r"res_(\d+)_(\d+)", block)
    if m:
        idx = 1 + 3 * int(m.group(1)) + int(m.group(2))
        layer = {"norm_0": "0", "conv_0": "2", "norm_1": "3", "conv_1": "5"}[parts[1]]
        return (f"blocks.{idx}.layers.{layer}.{_wb(leaf)}",
                kind if parts[1].startswith("conv") else "vec")
    raise KeyError(f"highresnet: unmapped flax path {'/'.join(parts)}")


def _vnet_rule(parts: Sequence[str]) -> Tuple[str, str]:
    """VNet's transitions (``import_torch.py:498-534``)."""
    leaf, block, sub = parts[-1], parts[0], parts[1]
    kind = _kind(leaf)
    if block in ("in_tr", "out_tr"):
        if sub == "conv":
            return f"{block}.conv_block.conv.{_wb(leaf)}", kind
        if sub == "norm":
            return f"{block}.conv_block.adn.N.{_wb(leaf)}", "vec"
        if sub == "conv2":
            return f"{block}.conv2.{_wb(leaf)}", kind
    if re.fullmatch(r"(down|up)_tr\d+", block):
        if sub == "down_conv":
            return f"{block}.down_conv.{_wb(leaf)}", kind
        if sub == "up_conv":
            return f"{block}.up_conv.{_wb(leaf)}", _kind(leaf, "deconv_w")
        if sub == "bn1":
            return f"{block}.bn1.{_wb(leaf)}", "vec"
        m = re.fullmatch(r"ops_(\d+)_(conv|norm)", parts[2]) if sub == "ops" else None
        if m:
            k, what = m.groups()
            if what == "conv":
                return f"{block}.ops.{k}.conv_block.conv.{_wb(leaf)}", kind
            return f"{block}.ops.{k}.conv_block.adn.N.{_wb(leaf)}", "vec"
    raise KeyError(f"vnet: unmapped flax path {'/'.join(parts)}")


def _unetr_rule(parts: Sequence[str]) -> Tuple[str, str]:
    """UNETR's ViT and decoder (``import_torch.py:537-587``)."""
    leaf, block = parts[-1], parts[0]
    kind, lin = _kind(leaf), _kind(leaf, "lin_w")
    if block == "patch_embed":
        return f"vit.patch_embedding.patch_embeddings.1.{_wb(leaf)}", lin
    if block == "pos_embed":
        return "vit.patch_embedding.position_embeddings", "vec"
    if block == "vit_norm":
        return f"vit.norm.{_wb(leaf)}", "vec"
    m = re.fullmatch(r"block_(\d+)", block)
    if m:
        i, sub = m.group(1), parts[1]
        if sub in ("ln1", "ln2"):
            return f"vit.blocks.{i}.norm{sub[-1]}.{_wb(leaf)}", "vec"
        if sub == "attn":
            name = {"qkv": "qkv", "proj": "out_proj"}[parts[2]]
            return f"vit.blocks.{i}.attn.{name}.{_wb(leaf)}", lin
        if sub in ("fc1", "fc2"):
            return f"vit.blocks.{i}.mlp.linear{sub[-1]}.{_wb(leaf)}", lin
    if block == "out":
        return f"out.conv.conv.{_wb(leaf)}", kind

    def res_block(prefix: str, sub: str) -> Tuple[str, str]:
        if sub.startswith("conv"):
            return f"{prefix}.{sub}.conv.{_wb(leaf)}", kind
        return f"{prefix}.{sub}.{_wb(leaf)}", "vec"

    if block == "encoder1":
        return res_block("encoder1.layer", parts[1])
    m = re.fullmatch(r"encoder(\d)_transp_(\d+)", block)
    if m:
        enc, j = m.group(1), int(m.group(2))
        prefix = f"encoder{enc}.transp_conv_init" if j == 0 else f"encoder{enc}.blocks.{j - 1}"
        return f"{prefix}.conv.{_wb(leaf)}", _kind(leaf, "deconv_w")
    m = re.fullmatch(r"decoder(\d)_transp", block)
    if m:
        return f"decoder{m.group(1)}.transp_conv.conv.{_wb(leaf)}", _kind(leaf, "deconv_w")
    m = re.fullmatch(r"decoder(\d)_res", block)
    if m:
        return res_block(f"decoder{m.group(1)}.conv_block", parts[1])
    raise KeyError(f"unet_tr: unmapped flax path {'/'.join(parts)}")


_ZOO_RULES = {"basic_unet": _basic_unet_rule, "segresnet": _segresnet_rule,
              "segresnetvae": _segresnetvae_rule, "nnunet": _dynunet_rule,
              "highresnet": _highresnet_rule, "vnet": _vnet_rule, "unet_tr": _unetr_rule}


def _rule_for(model_name: str, norm: Optional[str]):
    if model_name in ("equiunet", "equiunet_ref"):
        return _torch_key_equiunet
    if model_name == "att_equiunet":
        return _torch_key_att_equiunet
    if model_name in ("equiunet_assp_evo", "equiunet_assp_evocor", "equiunet_assp_evo_ref"):
        return _torch_key_assp_evo
    if model_name in _UNET_FAMILY:
        return _unet_family_rule(_UNET_FAMILY[model_name], norm)
    if model_name in _ZOO_RULES:
        return _ZOO_RULES[model_name]
    raise NotImplementedError(f"state_dict_from_flax: no rule for {model_name!r}")


def _to_torch(arr: np.ndarray, kind: str) -> torch.Tensor:
    arr = np.asarray(arr, np.float32)
    if kind == "conv_w":      # flax [kd, kh, kw, in, out] → torch [out, in, kd, kh, kw]
        arr = arr.transpose(4, 3, 0, 1, 2)
    elif kind == "deconv_w":  # flax [k, k, k, in, out] → torch [in, out, k, k, k], flipped
        arr = arr[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
    elif kind == "lin_w":     # flax [in, out] → torch [out, in]
        arr = arr.T
    elif kind == "evo":       # (C,) or (1, 1, 1, 1, C) → (1, C, 1, 1, 1)
        arr = arr.reshape(1, -1, 1, 1, 1)
    return torch.from_numpy(np.array(arr, np.float32, order="C"))


def state_dict_from_flax(params: Mapping[str, Any], model_name: str = "equiunet_assp_evo",
                         norm: Optional[str] = "group",
                         batch_stats: Optional[Mapping[str, Any]] = None
                         ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` of ``model_name`` (built with ``norm``)
    from the JAX package's flax params, and from its ``batch_stats`` where
    the model has BatchNorms (``--norm batch``, the attention gates): nested
    dicts of arrays, ``Conv_0`` and ``BatchNorm_0`` levels included. Adds
    each EvoNorm's ``v`` (ones) if absent and its ``running_var`` (ones,
    unless ``batch_stats`` holds it), and each BatchNorm's
    ``num_batches_tracked`` (0)."""
    rule = _rule_for(model_name, norm)
    sd: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], path: Tuple[str, ...]) -> None:
        for name, child in node.items():
            if isinstance(child, Mapping):
                # layers.BatchNorm nests flax's own under "BatchNorm_0"
                walk(child, path if name == "BatchNorm_0" else path + (str(name),))
            else:
                key, kind = rule(path + (str(name),))
                sd[key] = _to_torch(child, kind)

    walk(params, ())
    if batch_stats is not None:
        walk(batch_stats, ())
    for key in [k for k in sd if k.endswith(".gamma")]:
        prefix = key[: -len("gamma")]
        sd.setdefault(prefix + "v", torch.ones_like(sd[key]))
        sd.setdefault(prefix + "running_var", torch.ones_like(sd[key]))
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return sd
