"""Argparse surfaces with the JAX package's flag names and defaults: train
(reference src/arguments_train.py:16-223) parsing into a TrainConfig, and
inference (src/arguments_inference.py:18-156) parsing into per-member
config namespaces. Weights come from reference ``.pth`` files through
``--import_pth``."""

from __future__ import annotations

import argparse
import os
from copy import deepcopy
from typing import Dict, Tuple

import yaml

from ..config import (ACT_CHOICES, CRITERION_CHOICES, DECAY_CHOICES,
                      MODEL_CHOICES, NORM_CHOICES, OPTIMIZER_CHOICES,
                      TrainConfig, make_experience_name)


def check_isdir(path: str) -> str:
    if path is not None and not os.path.isdir(path):
        raise argparse.ArgumentTypeError(f"{path} is not a directory")
    return path


def check_exist(path: str) -> str:
    if path is not None and not os.path.exists(path):
        raise argparse.ArgumentTypeError(f"{path} does not exist")
    return path


def build_train_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Segmentation Model Training (brats21_tpu_torch)")
    g = parser.add_argument_group("model", "Model configuration")
    g.add_argument("--model", default="equiunet", choices=MODEL_CHOICES)
    g.add_argument("--norm", type=str, default="instance", choices=NORM_CHOICES)
    g.add_argument("--act", type=str, default="relu", choices=ACT_CHOICES)
    g.add_argument("--width", type=int, default=48)
    g.add_argument("--dropout", type=float, default=0.0)
    g.add_argument("--num_classes", type=int, default=3)

    g = parser.add_argument_group("data", "Data loading & save")
    g.add_argument("--train_data_path", type=check_isdir, required=True)
    g.add_argument("--val_data_path", type=check_isdir, default=None)
    g.add_argument("--already_preprocess", action="store_true", default=False)
    parser.add_argument("--save_path", type=str, default="./runs")
    parser.add_argument("--resume", type=check_exist,
                        help="last_model.pth of a run to continue from")
    parser.add_argument("--no_full_name", action="store_true", default=False)

    g = parser.add_argument_group("training", "Training hyper parameters")
    g.add_argument("--batch_size", type=int, default=1)
    g.add_argument("--patch_size", type=int, nargs=3, default=[128, 128, 128])
    g.add_argument("--epochs", type=int, default=350)
    g.add_argument("--val_frequency", type=int, default=3)
    g.add_argument("--no_amp", action="store_true", default=False)
    g.add_argument("--remat_mode", type=str, default="norm",
                   choices=["block", "norm", "none"],
                   help="accepted for the JAX package's command lines; the "
                        "TPU's rematerialization knob, ignored here")
    g.add_argument("--criterion", type=str, default="dice", choices=CRITERION_CHOICES)
    g.add_argument("--gradient_accumulation_iter", type=int, default=None)
    g.add_argument("--adaptive_gradient_clipping", action="store_true", default=False)
    g.add_argument("--gradient_clipping", action="store_true", default=False)
    g.add_argument("--max_grad_norm", type=float, default=1)
    g.add_argument("--remove_outliers", action="store_true", default=False)
    g.add_argument("--num_workers", type=int, default=4)
    g.add_argument("--wire", type=str, default="auto",
                   choices=["auto", "sparse", "dense"],
                   help="accepted for the JAX package's command lines; its "
                        "TPU eval wire format, ignored here")
    g.add_argument("--seed", type=int, default=123)
    g.add_argument("--fold", default=0, type=lambda x: None if x == "None" else int(x))
    g.add_argument("--device", type=str, default="0",
                   help="CUDA device index, or 'cpu' to run the plain "
                        "PyTorch versions of the kernels on the host")

    g = parser.add_argument_group("optimizer & lr", "Optimizer & learning rate scheduler")
    g.add_argument("--learning_rate", type=float, default=0.0001)
    g.add_argument("--weight_decay", type=float, default=0.00001)
    g.add_argument("--optimizer", default="ranger", choices=OPTIMIZER_CHOICES)
    g.add_argument("--decay_type", default="flat_cosine", choices=DECAY_CHOICES)
    g.add_argument("--swa_start", type=int, default=None)
    g.add_argument("--swa_lr", type=float, default=0.00005)
    g.add_argument("--swa_anneal_epochs", type=int, default=10)

    g = parser.add_argument_group("Ranger options")
    g.add_argument("--use_gc", action="store_true", default=False)
    g.add_argument("--use_gcnorm", action="store_true", default=False)
    g.add_argument("--normloss", action="store_true", default=False)
    g.add_argument("--normloss_factor", type=float, default=1e-4)
    g.add_argument("--gc_conv_only", action="store_true", default=False)

    g = parser.add_argument_group("log", "Log and metrics")
    g.add_argument("--log_train_interval", type=int, default=10)
    g.add_argument("--log_train_metrics", action="store_true", default=False)
    g.add_argument("--log_val_interval", type=int, default=1)
    g.add_argument("--log_val_metrics", action="store_true", default=False)
    g.add_argument("--key_metric", nargs=1, choices=["dice", "hausdorff_distance95"],
                   default=["dice"])
    g.add_argument("--additional_metrics", nargs="+",
                   choices=["dice", "hausdorff_distance95", "sensitivity", "specificity"],
                   default=["hausdorff_distance95"])
    g.add_argument("--save_on", type=str, default="loss", choices=["key_metric", "loss"])
    g.add_argument("--no_tensorboard", action="store_true", default=False)
    g.add_argument("--evaluate_end_training", action="store_true", default=False)
    g.add_argument("--only_evaluate", action="store_true", default=False)
    g.add_argument("--debug_val", action="store_true", default=False)
    g.add_argument("--sliding_window_inference", action="store_true", default=False)
    g.add_argument("--sliding_window_size", type=int, nargs=3, default=[128, 128, 128])
    g.add_argument("-v", "--verbosity", action="count", default=0)
    return parser


def get_train_args(argv=None) -> TrainConfig:
    """arguments_train.py:182-223, with the resume reload of the run's
    config.yaml (``--resume RUN/last_model.pth``)."""
    args = build_train_parser().parse_args(argv)
    if args.only_evaluate and not args.resume:
        raise ValueError("if only_evaluate: the config file .yaml corresponding "
                         "to resume args is needed")
    if args.resume:
        save_path = os.path.dirname(os.path.abspath(args.resume))
        with open(os.path.join(save_path, "config.yaml")) as f:
            cfg = TrainConfig.from_dict(yaml.safe_load(f))
        cfg.resume = args.resume
        cfg.save_path = save_path
        cfg.train_data_path = args.train_data_path
        cfg.val_data_path = args.val_data_path
        cfg.device = args.device
        return cfg.validate()
    return TrainConfig.from_dict(vars(args)).validate()


def build_inference_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Segmentation Model Inference (brats21_tpu_torch)")
    g = parser.add_argument_group("model", "Model configuration")
    g.add_argument("--config", type=check_exist, required=True, nargs="+",
                   help="path(s) to trained config.yaml files (ensemble)")
    g.add_argument("--train_data_path", type=check_isdir)
    g.add_argument("--val_data_path", type=check_isdir, default=None)
    g.add_argument("--input", "--test_data_path", dest="test_data_path",
                   type=check_isdir, default=None)
    g.add_argument("--on", default="val", choices=["val", "train", "test"])
    g.add_argument("--device", type=str, default="0",
                   help="CUDA device index, or 'cpu' to run the plain "
                        "PyTorch versions of the kernels on the host")
    g.add_argument("--output", "--save_path", dest="save_path", type=str,
                   default=None)
    g.add_argument("--create_patient_dir", action="store_true", default=False)
    g.add_argument("--docker_test", action="store_true", default=False)
    g.add_argument("--num_workers", type=int, default=0)
    g.add_argument("-v", "--verbosity", action="count", default=0)
    g.add_argument("--watch", action="store_true", default=False,
                   help="serve mode: keep polling the input directory "
                        "(not ported yet)")
    g.add_argument("--import_pth", type=str, nargs="+", default=None,
                   help="reference torch checkpoint(s) (.pth) to serve, one "
                        "per --config")

    g = parser.add_argument_group("processing", "Processing configuration")
    g.add_argument("--sliding_window_inference", action="store_true",
                   default=False)
    g.add_argument("--sliding_window_size", type=int, nargs=3,
                   default=[128, 128, 128])
    g.add_argument("--tta", action="store_true", default=False)
    g.add_argument("--logit_threshold", type=float, default=0.5)
    g.add_argument("--perform_staple", action="store_true", default=False)
    g.add_argument("--staple_threshold", type=float, default=0.5)
    g.add_argument("--cleaning_areas", action="store_true", default=False)
    g.add_argument("--cleaning_areas_threshold", type=int, default=10)
    g.add_argument("--replace_value", action="store_true", default=False)
    g.add_argument("--replace_value_threshold", type=int, default=20)
    return parser


def get_inference_args(argv=None) -> Tuple[Dict[str, argparse.Namespace], str]:
    """arguments_inference.py:74-156: merge each trained config.yaml with CLI
    overrides into {config_i: Namespace}, one ``--import_pth`` per config."""
    parser = build_inference_parser()
    args = parser.parse_args(argv)

    if args.on == "test" and args.test_data_path is None:
        raise ValueError("if 'on' is test, a test_data_path is needed")
    if len(args.config) > 1 and args.save_path is None:
        raise ValueError("Several configs/models files has been selected and "
                         "you don't have specified a 'save_path'")
    if len(args.config) > 1:
        if args.on == "val" and args.val_data_path is None and args.train_data_path is None:
            raise ValueError("'on' is val. You need to specify a data path")
        if args.on == "train":
            raise ValueError("'on' is train. This mode is incompatible with "
                             "several configs/models files")
    if args.import_pth is not None and len(args.import_pth) != len(args.config):
        raise ValueError(
            f"--import_pth needs one .pth per --config "
            f"({len(args.import_pth)} vs {len(args.config)})")

    config_dict: Dict[str, argparse.Namespace] = {}
    for idx, config_file in enumerate(args.config):
        folder = os.path.dirname(os.path.abspath(config_file))
        with open(config_file) as f:
            loaded = yaml.safe_load(f)
        keep = {k: deepcopy(loaded.get(k)) for k in
                ("train_data_path", "val_data_path", "save_path")}
        loaded.update(vars(args))
        for k, v in keep.items():
            if loaded[k] is None:
                loaded[k] = v
        loaded["config"] = config_file
        loaded["model_dir"] = folder
        loaded["import_pth"] = (args.import_pth[idx]
                                if args.import_pth else None)
        if args.on == "val" and args.val_data_path is not None:
            loaded["fold"] = None
            loaded["train_data_path"] = None
        config_dict[f"config_{idx}"] = argparse.Namespace(**loaded)

    # processing-group experiment suffix (main_inference.py:86)
    proc_keys = ("sliding_window_inference", "sliding_window_size", "tta",
                 "logit_threshold", "perform_staple", "staple_threshold",
                 "cleaning_areas", "cleaning_areas_threshold",
                 "replace_value", "replace_value_threshold")
    name, _ = make_experience_name(
        TrainConfig(), add_current_date_time=False, include_base=False,
        extra_groups={"processing": {k: getattr(args, k) for k in proc_keys}})
    return config_dict, name
