"""Configuration tree for training and inference.

The reference serializes its flat argparse namespace to ``config.yaml``
(main_train.py:67-69) and reloads it on resume (arguments_train.py:205-216)
and at inference time (arguments_inference.py:104-151). We keep that contract:
:class:`TrainConfig` has exactly the argparse dest names / defaults of
``src/arguments_train.py:16-179`` and round-trips through a flat yaml mapping.

Group membership (used for experiment naming, definer.py:411-435) is recorded
in ``_GROUPS``.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Dict, List, Optional, Tuple

import yaml

MODEL_CHOICES = (
    "basic_unet", "nnunet", "unet_tr", "segresnet", "segresnetvae",
    "highresnet", "vnet", "modified_unet", "att_unet", "r2unet", "r2attunet",
    "equiunet", "att_equiunet", "equiunet_ref", "equiunet_assp_evo",
    "equiunet_assp_evo_ref", "equiunet_assp_evocor", "swin_unetr",
)
CRITERION_CHOICES = (
    "dice", "generalized_dice", "focal", "tversky", "jaccard", "hd",
    "dice_hd", "boundary", "dice_boundary", "dice_ce", "dice_focal",
)
OPTIMIZER_CHOICES = ("sgd", "adam", "adamw", "ranger", "ranger21", "novograd")
DECAY_CHOICES = ("step", "step_warmup", "cosine_warmup", "cosine", "flat_cosine")
NORM_CHOICES = ("batch", "group", "instance", "bcn", "none")
ACT_CHOICES = ("elu", "relu", "leakyrelu", "prelu", "swish", "mish")


@dataclass
class TrainConfig:
    """Flat training config mirroring arguments_train.py argparse dests."""

    # --- model group (arguments_train.py:16-54)
    model: str = "equiunet"
    norm: str = "instance"
    act: str = "relu"
    width: int = 48
    dropout: float = 0.0
    num_classes: int = 3

    # --- data group (arguments_train.py:57-71)
    train_data_path: Optional[str] = None
    val_data_path: Optional[str] = None
    already_preprocess: bool = False
    save_path: str = "./runs"
    resume: Optional[str] = None
    no_full_name: bool = False

    # --- training group (arguments_train.py:74-107)
    batch_size: int = 1
    patch_size: List[int] = field(default_factory=lambda: [128, 128, 128])
    epochs: int = 350
    val_frequency: int = 3
    no_amp: bool = False
    criterion: str = "dice"
    gradient_accumulation_iter: Optional[int] = None
    adaptive_gradient_clipping: bool = False
    gradient_clipping: bool = False
    max_grad_norm: float = 1
    remove_outliers: bool = False
    num_workers: int = 4
    seed: int = 123
    fold: Optional[int] = 0
    device: str = "0"

    # --- optimizer & lr group (arguments_train.py:110-130)
    learning_rate: float = 0.0001
    weight_decay: float = 0.00001
    optimizer: str = "ranger"
    decay_type: str = "flat_cosine"
    swa_start: Optional[int] = None
    swa_lr: float = 0.00005
    swa_anneal_epochs: int = 10

    # --- ranger options group (arguments_train.py:133-146)
    use_gc: bool = False
    use_gcnorm: bool = False
    normloss: bool = False
    normloss_factor: float = 1e-4
    gc_conv_only: bool = False

    # --- log group (arguments_train.py:149-179)
    log_train_interval: int = 10
    log_train_metrics: bool = False
    log_val_interval: int = 1
    log_val_metrics: bool = False
    key_metric: List[str] = field(default_factory=lambda: ["dice"])
    additional_metrics: List[str] = field(default_factory=lambda: ["hausdorff_distance95"])
    save_on: str = "loss"
    no_tensorboard: bool = False
    evaluate_end_training: bool = False
    only_evaluate: bool = False
    debug_val: bool = False
    sliding_window_inference: bool = False
    sliding_window_size: List[int] = field(default_factory=lambda: [128, 128, 128])
    verbosity: int = 0
    # eval cases are padded to multiples of this (the reference's 8,
    # engine.py:192); the JAX package's coarser buckets cut its compiles
    eval_bucket: int = 8
    # host↔device wire of the per-case eval path (JAX config.py:113-120):
    # "dense" (fp16 volumes in, fp32 fused out), "sparse" (brain-masked
    # packed volumes in, bit-packed fused out; ops/wire.py), "auto" (probe
    # the link once and pick); BRATS21_SPARSE_WIRE=0/1 overrides it
    wire: str = "auto"

    def validate(self) -> "TrainConfig":
        if self.model not in MODEL_CHOICES:
            raise ValueError(f"unknown model {self.model!r}; choices: {MODEL_CHOICES}")
        if self.criterion not in CRITERION_CHOICES:
            raise ValueError(f"unknown criterion {self.criterion!r}")
        if self.optimizer not in OPTIMIZER_CHOICES:
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.decay_type not in DECAY_CHOICES:
            raise ValueError(f"unknown decay_type {self.decay_type!r}")
        if self.gradient_accumulation_iter is not None and self.gradient_accumulation_iter <= 0:
            raise ValueError("gradient_accumulation_iter must be > 0")
        if self.fold is not None and self.fold not in (0, 1, 2, 3, 4):
            raise ValueError("fold must be in 0..4 or None")
        check_eval_bucket(self.eval_bucket)
        if self.wire not in ("auto", "sparse", "dense"):
            raise ValueError("wire must be auto|sparse|dense")
        return self

    # --- yaml roundtrip (config.yaml contract, main_train.py:67-69)
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_yaml(self, path: str) -> None:
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_yaml(cls, path: str) -> "TrainConfig":
        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))


def check_eval_bucket(bucket: int) -> int:
    """The eval pad must be a multiple of 8, the model's downsampling
    factor, or the skip concats' shapes differ."""
    if bucket < 8 or bucket % 8:
        raise ValueError(f"eval bucket must be a multiple of 8 (the model's "
                         f"downsampling factor), got {bucket}")
    return bucket


#: group name -> field names, mirroring the argparse groups that drive
#: experiment naming and hparams (definer.py:411-435).
_GROUPS: Dict[str, Tuple[str, ...]] = {
    "model": ("model", "norm", "act", "width", "dropout", "num_classes"),
    "training": ("batch_size", "patch_size", "epochs", "val_frequency", "no_amp",
                 "criterion", "gradient_accumulation_iter", "adaptive_gradient_clipping",
                 "gradient_clipping", "max_grad_norm", "remove_outliers",
                 "num_workers", "seed", "fold", "device"),
    "optimizer & lr": ("learning_rate", "weight_decay", "optimizer", "decay_type",
                       "swa_start", "swa_lr", "swa_anneal_epochs"),
}


def safe_file_name(name: str) -> str:
    """Replace filesystem-hostile characters (reference utils/files.py)."""
    return re.sub(r"[^\w\-_.]", "_", name)


def make_experience_name(cfg: TrainConfig, add_current_date_time: bool = True,
                         extra_groups: Optional[Dict[str, Dict[str, Any]]] = None,
                         include_base: bool = True,
                         ) -> Tuple[str, Dict[str, Any]]:
    """Build the run-directory name from the grouped config, byte-compatible
    with reference definer.py:411-435 (category order model/training/
    optimizer & lr/processing; key abbreviation rule; value truncation)."""
    current_date_time = datetime.now().strftime("%b%d_%H-%M-%S-%f")
    h_params: Dict[str, Any] = {}
    result = []
    groups: Dict[str, Dict[str, Any]] = {
        name: {k: getattr(cfg, k) for k in keys} for name, keys in _GROUPS.items()
    } if include_base else {}
    if extra_groups:
        groups.update(extra_groups)
    for category in ["model", "training", "optimizer & lr", "processing"]:
        if category not in groups:
            continue
        items = sorted(groups[category].items())
        h_params.update(items)
        result.append("_".join(
            (str(k)[0:3] + "_" + str(v)[0:3]) if len(str(k).split("_")) == 1
            else ("".join(x[:1] for x in str(k).split("_")) + "_" + str(v))
            for k, v in items))
    experience_name = re.sub("_+", "_", safe_file_name("_".join(result)))
    if add_current_date_time:
        experience_name = current_date_time + "_" + experience_name
    return experience_name, h_params
