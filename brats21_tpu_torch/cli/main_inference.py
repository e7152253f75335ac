"""Inference CLI — reference src/main_inference.py:24-96: load N configs +
reference ``.pth`` checkpoints as an ensemble, segment every case of the
test set (``--on test``) or of the first config's val or train split
(``--on val|train``, scored against its segs into
``Evaluation_inference_{on}*.xlsx/.csv``), with TTA, sliding windows,
STAPLE and post-processing as asked, and write the NIfTI label maps.

    python -m brats21_tpu_torch.cli.main_inference --config run/config.yaml \\
        --import_pth run/best_model.pth --on test --input cases/ \\
        --output out/ [--tta] [--sliding_window_inference] [--perform_staple] \\
        [--cleaning_areas] [--replace_value] [--device cpu]

Runs on ``cuda:<--device>``; ``--device cpu`` runs on the host with the
kernels' plain PyTorch versions. ``--watch`` serving is not ported yet and
raises ``NotImplementedError`` rather than being ignored.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict

import torch
from torch import nn

from .. import set_main_logger
from ..config import TrainConfig
from ..data.pipeline import make_test_loader, make_train_val_loaders
from ..learning.engine import Engine
from ..learning.losses import make_criterion
from ..models import get_model
from ..utils.meter import AverageMeter
from ..utils.reporting import EvaluationReport
from ..utils.weights import load_reference_pth
from .arguments import get_inference_args


def resolve_device(spec: str) -> torch.device:
    """``--device``: a CUDA index (the reference's default "0") or "cpu".
    A CUDA device on a host without CUDA raises: the port never falls back
    to the CPU unasked. On CUDA, TF32 is turned off for cuDNN and matmuls,
    so what the configuration runs in fp32 (``--no_amp``, the cuDNN convs'
    grads, the loss) is fp32."""
    if spec.strip().lower() == "cpu":
        return torch.device("cpu")
    try:
        index = int(spec)
    except ValueError:
        raise ValueError(f"--device must be a CUDA index or 'cpu', got {spec!r}") from None
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {spec}: CUDA is not available on this host "
            "(pass --device cpu to run on the CPU)")
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"--device {spec}: only {torch.cuda.device_count()} "
                           "CUDA device(s)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", index)


def post_kwargs_from_cfg(cfg) -> dict:
    """get_post_transforms flags (definer.py:671-698; JAX
    cli/main_train.py:39)."""
    return dict(
        logit_thresh=getattr(cfg, "logit_threshold", 0.5),
        cleaning_areas=getattr(cfg, "cleaning_areas", False),
        cleaning_areas_threshold=getattr(cfg, "cleaning_areas_threshold", 10),
        replace_value=getattr(cfg, "replace_value", False),
        replace_value_threshold=getattr(cfg, "replace_value_threshold", 20),
    )


def check_ported(ns: argparse.Namespace) -> None:
    """Raise for the flags whose paths come with later slices."""
    if ns.watch or ns.watch_warmup is not None or ns.watch_stop_file is not None:
        raise NotImplementedError(
            "--watch serving comes with a later slice of the port")
    if not ns.import_pth:
        raise NotImplementedError(
            "the port serves reference .pth weights through --import_pth; the "
            "JAX package's Orbax checkpoints cannot be read without JAX")


def load_member(ns: argparse.Namespace, device: torch.device) -> nn.Module:
    """The model of one merged config namespace with its ``--import_pth``
    weights (main_inference.py:62-69); SWA runs serve the AveragedModel
    payload, as the reference does."""
    model = get_model(ns)
    model.load_state_dict(load_reference_pth(ns.import_pth,
                                             prefer_swa=bool(ns.swa_start)))
    return model.to(device).eval()


def main(argv=None) -> Dict[str, AverageMeter]:
    """Run the CLI; returns the evaluation's meters (``batch_time`` holds
    the per-case seconds)."""
    total_start = time.time()
    config_dict, experience_name = get_inference_args(argv)
    members_ns = list(config_dict.values())
    cfg0 = members_ns[0]
    for ns in members_ns:
        check_ported(ns)
    device = resolve_device(cfg0.device)
    if cfg0.save_path is None:
        raise ValueError("--output is needed")
    os.makedirs(cfg0.save_path, exist_ok=True)
    logger = set_main_logger(os.path.join(cfg0.save_path, "logfile_inference.log"),
                             verbosity=max(cfg0.verbosity, 1))
    logger.info("device: %s%s", device, f" ({torch.cuda.get_device_name(device)})"
                if device.type == "cuda" else "")

    # the first member's run config, with the inference flags (the
    # TrainConfig fields among them come through from_dict)
    cfg = TrainConfig.from_dict(vars(cfg0))
    cfg.create_patient_dir = cfg0.create_patient_dir
    if cfg0.on == "train":
        _, loader = make_train_val_loaders(cfg, device, train_in_val_mode=True)
    elif cfg0.on == "val":
        _, loader = make_train_val_loaders(cfg, device)
    else:
        loader = make_test_loader(cfg0)
    if loader is None:
        raise ValueError(f"no case found for --on {cfg0.on}")
    members = [load_member(ns, device) for ns in members_ns]
    logger.info("ensemble of %d member(s)", len(members))

    engine = Engine(cfg, device, criterion=make_criterion(cfg))
    with_target = cfg0.on in ("val", "train")
    name = f"Evaluation_inference_{cfg0.on}{experience_name}"
    report = EvaluationReport(autosave_dir=cfg0.save_path, name=name) if with_target else None
    meters = engine.evaluate(
        members, loader, 0, use_tta=bool(cfg0.tta), save_seg=True,
        output_path=os.path.join(cfg0.save_path, f"Inference_segmentations_{cfg0.on}"),
        perform_staple=bool(cfg0.perform_staple), staple_threshold=cfg0.staple_threshold,
        post_kwargs=post_kwargs_from_cfg(cfg0), report=report,
        step_mode=f"metric_{cfg0.on}")
    if report is not None:
        report.save(cfg0.save_path)
    logger.info("total time: %.1fs", time.time() - total_start)
    return meters


if __name__ == "__main__":
    main()
