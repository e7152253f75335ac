"""Training CLI — the epoch loop of ``brats21_tpu/cli/main_train.py:71-283``
(reference src/main_train.py:34-243) on one device: config → loader →
model, criterion, optimizer → epochs → best/last checkpoints.

    python -m brats21_tpu_torch.cli.main_train --train_data_path DATA \\
        --save_path RUNS --model equiunet_assp_evo --width 48 \\
        --criterion dice_hd --optimizer ranger --decay_type cosine \\
        --learning_rate 3e-4 --use_gc --remove_outliers --fold None [--device cpu]

Runs on ``cuda:<--device>``; ``--device cpu`` runs on the host with the
kernels' plain PyTorch versions. With ``--fold None`` the checkpoints follow
the train loss after every epoch (``main_train.py:282-283``). Validation,
the end-of-training evaluation and ``--only_evaluate`` come with a later
slice: a run that would reach them raises ``NotImplementedError`` before
its first step. Multi-host runs and preemption are not ported.
"""

from __future__ import annotations

import os
import time
import warnings
from datetime import datetime
from typing import Dict, Optional

import torch

from .. import set_main_logger
from ..config import TrainConfig, make_experience_name
from ..data.pipeline import create_train_val_records, make_train_loader
from ..learning.checkpoint import CheckpointManager, resume
from ..learning.engine import Engine
from ..learning.losses import make_criterion
from ..learning.optimizers import make_optimizer
from ..learning.train_state import TrainState, TrainStep
from ..models import get_model
from ..utils.meter import AverageMeter, ProgressMeter
from .arguments import get_train_args
from .main_inference import resolve_device


def setup_save_path(cfg: TrainConfig) -> None:
    """Experiment directory naming, with the too-long-name fallback
    (main_train.py:47-64); a resumed run keeps its directory."""
    if cfg.resume:
        return
    original = cfg.save_path
    name, _ = make_experience_name(cfg)
    cfg.save_path = os.path.join(original, name if not cfg.no_full_name else "")
    try:
        os.makedirs(cfg.save_path, exist_ok=True)
    except OSError:
        warnings.warn("Automatic file name with args is too long, replace "
                      "with the current date and time")
        cfg.save_path = os.path.join(original, datetime.now().strftime("%b%d_%H-%M-%S-%f"))
        os.makedirs(cfg.save_path, exist_ok=True)


_LATER = ("needs validation (engine.evaluate in val mode, utils/metrics.py): "
          "a later slice of the port")


def check_ported(cfg: TrainConfig) -> None:
    """Raise, before any step, for what needs validation (``engine.evaluate``
    in val mode and ``utils/metrics.py``, a later slice): a validation set,
    the end-of-training evaluation, ``--only_evaluate`` and ``--debug_val``
    (:func:`check_fold_validation` covers the fold's validation epochs)."""
    if cfg.only_evaluate:
        raise NotImplementedError(f"--only_evaluate {_LATER}")
    if cfg.evaluate_end_training:
        raise NotImplementedError(f"--evaluate_end_training {_LATER}")
    if cfg.val_data_path is not None:
        raise NotImplementedError(f"--val_data_path {_LATER}")
    if cfg.debug_val:
        raise NotImplementedError(f"--debug_val {_LATER}")


def check_fold_validation(cfg: TrainConfig, start_epoch: int) -> None:
    """Raise when a fold's validation epoch (every ``val_frequency``) falls
    inside epochs start_epoch..epochs."""
    if cfg.fold is not None and any(e % cfg.val_frequency == 0
                                    for e in range(start_epoch, cfg.epochs + 1)):
        raise NotImplementedError(
            f"--fold {cfg.fold} validates every {cfg.val_frequency} epochs, which "
            f"{_LATER}; train fewer epochs or use --fold None")


def main(argv=None) -> Dict[str, float]:
    """Run the CLI; returns the last epoch's mean train loss and the run
    directory's best value."""
    total_start = time.time()
    cfg = get_train_args(argv)
    check_ported(cfg)
    device = resolve_device(cfg.device)
    payload: Optional[dict] = None
    start_epoch = 1
    if cfg.resume:
        payload = torch.load(cfg.resume, map_location="cpu", weights_only=True)
        start_epoch = int(payload["epoch"]) + 1
    check_fold_validation(cfg, start_epoch)
    setup_save_path(cfg)
    if not cfg.resume:
        cfg.to_yaml(os.path.join(cfg.save_path, "config.yaml"))
    logger = set_main_logger(os.path.join(cfg.save_path, "logfile.log"),
                             verbosity=max(cfg.verbosity, 1))
    logger.info("device: %s%s", device, f" ({torch.cuda.get_device_name(device)})"
                if device.type == "cuda" else "")
    if not cfg.no_tensorboard:
        logger.warning("TensorBoard logging comes with a later slice of the port "
                       "(utils/reporting.py); the meters go to the log only")

    train_files, _ = create_train_val_records(cfg)
    loader = make_train_loader(cfg, train_files, device)
    if loader is None:
        raise ValueError(f"no training case found in {cfg.train_data_path}")
    steps_per_epoch = max(len(loader), 1)

    torch.manual_seed(cfg.seed)
    model = get_model(cfg).to(device)
    criterion = make_criterion(cfg)
    optimizer = make_optimizer(cfg, model.parameters(), steps_per_epoch)
    swa = torch.optim.swa_utils.AveragedModel(model) if cfg.swa_start else None
    state = TrainState(model, optimizer, swa)
    step = TrainStep(criterion, use_amp=not cfg.no_amp,
                     log_metrics=cfg.log_train_metrics)
    engine = Engine(cfg, device)
    ckpt = CheckpointManager(cfg.save_path, save_on=cfg.save_on,
                             key_metric=cfg.key_metric[0])
    if payload is not None:
        resume(state, payload)
        ckpt.best_value = float(payload["best_value"])
        logger.info("resumed from %s at epoch %d (best %s)", cfg.resume,
                    start_epoch - 1, ckpt.best_value)

    epoch_time = AverageMeter("Time", ":6.3f")
    progress = ProgressMeter(cfg.epochs, [epoch_time], prefix="Epoch: ")
    logger.info("Time elapsed before training: %.1fs", time.time() - total_start)
    t0 = time.time()
    result: Dict[str, float] = {}
    for epoch in range(start_epoch, cfg.epochs + 1):
        meters = engine.train_epoch(state, step, loader, epoch)
        epoch_time.update(time.time() - t0)
        t0 = time.time()
        progress.display(epoch)
        result["train_loss"] = float(meters["loss"].avg)
        if cfg.fold is None:
            ckpt.save(state, epoch, result["train_loss"])
    if ckpt.best_value is not None:
        result["best_value"] = ckpt.best_value
    logger.info("total time: %.1fs", time.time() - total_start)
    return result


if __name__ == "__main__":
    main()
