"""Inference argparse surface (reference src/arguments_inference.py:18-156)
parsing into per-member config namespaces, with the JAX package's flag
names and defaults. Weights come from reference ``.pth`` files through
``--import_pth``."""

from __future__ import annotations

import argparse
import os
from copy import deepcopy
from typing import Dict, Tuple

import yaml

from ..config import TrainConfig, make_experience_name


def check_isdir(path: str) -> str:
    if path is not None and not os.path.isdir(path):
        raise argparse.ArgumentTypeError(f"{path} is not a directory")
    return path


def check_exist(path: str) -> str:
    if path is not None and not os.path.exists(path):
        raise argparse.ArgumentTypeError(f"{path} does not exist")
    return path


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
