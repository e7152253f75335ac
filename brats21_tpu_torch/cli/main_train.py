"""Training CLI — the epoch loop of ``brats21_tpu/cli/main_train.py:71-283``
(reference src/main_train.py:34-243) on one device: config → loader →
model, criterion, optimizer → epochs → best/last checkpoints.

    python -m brats21_tpu_torch.cli.main_train --train_data_path DATA \\
        --save_path RUNS --model equiunet_assp_evo --width 48 \\
        --criterion dice_hd --optimizer ranger --decay_type cosine \\
        --learning_rate 3e-4 --use_gc --remove_outliers --fold None [--device cpu]

Runs on ``cuda:<--device>``; ``--device cpu`` runs on the host with the
kernels' plain PyTorch versions. With ``--fold k`` the fold's val cases are
evaluated every ``--val_frequency`` epochs — the SWA average past
``--swa_start`` — and the checkpoints follow the validation loss (or the
mean key metric); with ``--fold None`` they follow the train loss after
every epoch (``main_train.py:282-283``), and ``--val_data_path`` may name
the val cases. ``--debug_val`` skips the train epochs.
``--evaluate_end_training`` and ``--only_evaluate`` reload the best weights
and evaluate the val cases without and with TTA into
``segmentations{,_tta}/`` and ``Evaluation{,_tta}.xlsx/.csv``.

Preemption (JAX ``main_train.py:77-98,159-236``): a SIGTERM during training
is deferred to the next batch, where the run saves ``last_model.pth`` with
the last whole epoch and a ``batch_cursor`` (the batches of the next epoch
already applied; none when the stop lands after an epoch's last batch) and
exits 0; ``--resume RUN/last_model.pth`` goes on from that batch with the
engine's global step, and with it each step's dropout generator, where the
uninterrupted run had them. Outside training (``--only_evaluate``, the
end-of-training evaluation) SIGTERM terminates with 128 + 15.
``BRATS21_PREEMPT_AT_STEP=N`` acts as a SIGTERM landing once the global
step reaches N.

Under ``torchrun`` (JAX ``main_train.py:110-310``; ``parallel/``) each rank
holds the model in DistributedDataParallel over every rank (rank 0's
initial parameters broadcast) and takes its slice of its node's batch
(``--batch_size`` is a node's); the nodes' train records are striped
(padded to lock-step) and their val cases too. Only the primary writes
``config.yaml``, the log file, TensorBoard and the checkpoints. A SIGTERM
stops the run iff any rank was signalled, decided at the epoch's end
(cursor 0). Validation meters merge across nodes; the end-of-training
evaluation waits for the checkpoint at a barrier and raises on a rank that
cannot read it.

    torchrun --nproc_per_node 2 -m brats21_tpu_torch.cli.main_train ... --batch_size 2
"""

from __future__ import annotations

import os
import signal
import time
import warnings
from datetime import datetime
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from .. import get_logger, set_main_logger
from ..config import TrainConfig, make_experience_name
from ..data.pipeline import make_train_val_loaders
from ..learning.checkpoint import (BEST_NAME, LAST_NAME, CheckpointManager,
                                   load_for_evaluation, resume)
from ..learning.engine import Engine
from ..learning.losses import make_criterion
from ..learning.optimizers import make_optimizer
from ..learning.train_state import (TrainState, TrainStep, model_uses_rng,
                                   sync_swa_buffers)
from ..models import get_model
from ..parallel import multihost
from ..parallel.mesh import init_topology
from ..utils.meter import AverageMeter, ProgressMeter
from ..utils.reporting import EvaluationReport, TensorBoardLogger
from .arguments import get_train_args
from .main_inference import post_kwargs_from_cfg

logger = get_logger("main_train")


def setup_save_path(cfg: TrainConfig) -> dict:
    """Experiment directory naming, with the too-long-name fallback
    (main_train.py:47-64); a resumed run keeps its directory. Returns the
    hyper-parameters for the TensorBoard hparams table."""
    name, h_params = make_experience_name(cfg)
    if cfg.resume:
        return h_params
    original = cfg.save_path
    cfg.save_path = os.path.join(original, name if not cfg.no_full_name else "")
    try:
        os.makedirs(cfg.save_path, exist_ok=True)
    except OSError:
        warnings.warn("Automatic file name with args is too long, replace "
                      "with the current date and time")
        cfg.save_path = os.path.join(original, datetime.now().strftime("%b%d_%H-%M-%S-%f"))
        os.makedirs(cfg.save_path, exist_ok=True)
    return h_params


def evaluate_end_training(cfg: TrainConfig, engine: Engine, valid_loader,
                          h_params: dict, tb: TensorBoardLogger, device) -> Dict[str, float]:
    """Reload best (last's SWA average on SWA runs) and evaluate without and
    with TTA, saving the segmentations and the Evaluation reports
    (main_train.py:197-243); returns each run's mean key metric. Under
    ``torchrun`` every rank scores its node's stripe (count-0 meters when
    it is empty) after a barrier that waits for the primary's checkpoint,
    and the primary writes the merged reports (JAX :284-306)."""
    primary = multihost.is_primary()
    if multihost.distributed():
        multihost.barrier()
        name = LAST_NAME if cfg.swa_start else BEST_NAME
        if not os.path.exists(os.path.join(cfg.save_path, name)):
            raise FileNotFoundError(
                f"rank {dist.get_rank()} cannot read {os.path.join(cfg.save_path, name)}: "
                "the end-of-training evaluation across nodes needs the run directory on "
                "storage every node shares")
    model = get_model(cfg)
    model.load_state_dict(load_for_evaluation(cfg.save_path, bool(cfg.swa_start)))
    model = model.to(device).eval()
    out: Dict[str, float] = {}
    for eval_type in ("", "_tta"):
        logger.info("Starting Evaluation %s", eval_type)
        engine.val_step = 0
        suffix = f"_swa{eval_type}" if cfg.swa_start else eval_type
        report = EvaluationReport(autosave_dir=cfg.save_path if primary else None,
                                  name=f"Evaluation{suffix}")
        if valid_loader is not None and len(valid_loader):
            meters = engine.evaluate(
                [model], valid_loader, 0, use_tta=bool(eval_type), save_seg=True,
                output_path=os.path.join(cfg.save_path, f"segmentations{eval_type}"),
                post_kwargs=post_kwargs_from_cfg(cfg), report=report,
                step_mode="metric_val")
        else:
            meters = engine.empty_eval_meters()
        multihost.merge_meters(meters)
        multihost.merge_report_rows(report)
        if not primary:
            continue
        report.save(cfg.save_path)
        summary = {f"{k}_mean": float(np.nanmean(m.avg)) for k, m in meters.items()
                   if k not in ("batch_time", "data_time")}
        tb.log_hparams({**h_params, "tta": bool(eval_type), "swa": bool(cfg.swa_start)},
                       summary)
        out[f"eval{suffix}_{cfg.key_metric[0]}"] = summary[f"{cfg.key_metric[0]}_mean"]
    return out


def main(argv=None) -> Dict[str, float]:
    """Run the CLI; returns the last epoch's mean train loss and validation
    loss, the engine's global step, the run directory's best value and,
    after the end-of-training evaluation, its mean key metrics."""
    total_start = time.time()
    # installed first, so a SIGTERM during start-up is honoured at the
    # first batch; outside a training phase it keeps terminate semantics
    stop = {"flag": False, "defer": True}

    def request_stop(signum, frame):
        stop["flag"] = True
        if not stop["defer"]:
            raise SystemExit(128 + signum)

    try:
        previous = signal.signal(signal.SIGTERM, request_stop)
    except ValueError:          # not the main thread
        previous = None
    try:
        return _main(argv, total_start, stop)
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)


def _main(argv, total_start: float, stop: Dict[str, bool]) -> Dict[str, float]:
    cfg = get_train_args(argv)
    topo = init_topology(cfg.device)
    device = topo.device
    payload: Optional[dict] = None
    start_epoch = 1
    resume_batch = 0
    if cfg.resume:
        payload = torch.load(cfg.resume, map_location="cpu", weights_only=True)
        start_epoch = int(payload["epoch"]) + 1
        # a mid-epoch preemption's cursor: epoch start_epoch already ran
        # its first resume_batch batches
        resume_batch = int(payload.get("batch_cursor", 0))
    primary = topo.primary
    # the primary names (and makes) the run directory; its name carries the
    # primary's clock, so the other ranks take it from the primary
    h_params = setup_save_path(cfg) if primary else make_experience_name(cfg)[1]
    cfg.save_path = multihost.from_primary(cfg.save_path)
    if not cfg.resume and primary:
        cfg.to_yaml(os.path.join(cfg.save_path, "config.yaml"))
    logger = set_main_logger(os.path.join(cfg.save_path, "logfile.log") if primary else None,
                             verbosity=max(cfg.verbosity, 1))
    logger.info("device: %s%s", device, f" ({torch.cuda.get_device_name(device)})"
                if device.type == "cuda" else "")
    if topo.distributed:
        logger.info("rank %d of %d (node %d of %d, local rank %d of %d), backend %s",
                    topo.rank, topo.world_size, topo.node, topo.nodes, topo.local_rank,
                    topo.local_size, topo.backend)
    tb = TensorBoardLogger(cfg.save_path, enabled=not cfg.no_tensorboard and primary)

    train_loader, valid_loader = make_train_val_loaders(cfg, device)
    if train_loader is None and not (cfg.only_evaluate or cfg.debug_val):
        raise ValueError(f"no training case found in {cfg.train_data_path}")
    steps_per_epoch = max(len(train_loader), 1) if train_loader else 1

    torch.manual_seed(cfg.seed)
    model = get_model(cfg).to(device)
    criterion = make_criterion(cfg)
    optimizer = make_optimizer(cfg, model.parameters(), steps_per_epoch)
    swa = torch.optim.swa_utils.AveragedModel(model) if cfg.swa_start else None
    state = TrainState(model, optimizer, swa)
    step = TrainStep(criterion, use_amp=not cfg.no_amp, log_metrics=cfg.log_train_metrics,
                     stochastic=model_uses_rng(cfg), seed=cfg.seed, rank=topo.rank,
                     sharded_over=topo.batch_group)
    engine = Engine(cfg, device, criterion=criterion, tb=tb, topo=topo)
    ckpt = CheckpointManager(cfg.save_path, save_on=cfg.save_on,
                             key_metric=cfg.key_metric[0])
    if payload is not None:
        resume(state, payload)
        # each step's generator is keyed on the global step: restore it so
        # the resumed run draws what the uninterrupted one did
        engine.global_step = (start_epoch - 1) * steps_per_epoch + resume_batch
        ckpt.best_value = float(payload["best_value"])
        logger.info("resumed from %s at epoch %d (batch %d, best %s)", cfg.resume,
                    start_epoch - 1, resume_batch, ckpt.best_value)
    if topo.distributed:
        # every rank's replica starts from rank 0's parameters and buffers
        state.ddp = DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda" else None,
            broadcast_buffers=False, static_graph=True)

    epoch_time = AverageMeter("Time", ":6.3f")
    progress = ProgressMeter(cfg.epochs, [epoch_time], prefix="Epoch: ")
    result: Dict[str, float] = {}
    if cfg.only_evaluate:
        stop["defer"] = False           # no training phase: SIGTERM exits
    else:
        logger.info("Time elapsed before training: %.1fs", time.time() - total_start)
        t0 = time.time()
        stop_at = os.environ.get("BRATS21_PREEMPT_AT_STEP")
        stop_at = int(stop_at) if stop_at is not None else None

        def should_stop() -> bool:
            if stop_at is not None and engine.global_step >= stop_at:
                stop["flag"] = True
            return stop["flag"]

        for epoch in range(start_epoch, cfg.epochs + 1):
            train_meters = None
            if not cfg.debug_val:
                # across ranks the stop is decided at the epoch's end: every
                # rank must take the same steps
                train_meters = engine.train_epoch(
                    state, step, train_loader, epoch,
                    should_stop=None if topo.distributed else should_stop,
                    start_batch=resume_batch if epoch == start_epoch else 0)
                result["train_loss"] = float(train_meters["loss"].avg)
            if topo.distributed:
                # stop iff any rank was signalled
                stop["flag"] = multihost.any_rank(should_stop())
            if stop["flag"]:
                # mid-epoch: the last whole epoch and the batch cursor; after
                # the epoch's last batch (or across ranks) the epoch counts
                # in full
                stop_batch = engine.last_epoch_stop
                done_epoch, cursor = ((epoch, 0) if stop_batch is None
                                      else (epoch - 1, stop_batch))
                if primary:
                    ckpt.save_last(state, done_epoch, batch_cursor=cursor)
                logger.info("preempted after epoch %d (batch cursor %d): last_model saved, "
                            "exiting cleanly", done_epoch, cursor)
                break
            epoch_time.update(time.time() - t0)
            t0 = time.time()
            progress.display(epoch)
            if cfg.fold is not None and epoch % cfg.val_frequency == 0 \
                    and (valid_loader is not None or topo.distributed):
                # past swa_start the SWA average is validated
                # (reference engine.py:184-187)
                use_swa = bool(cfg.swa_start) and epoch > cfg.swa_start
                if use_swa:
                    # the averaged weights with the current running
                    # statistics (JAX main_train.py:244-251)
                    sync_swa_buffers(state)
                val_model = (state.swa_model.module if use_swa else state.model).eval()
                if valid_loader is not None and len(valid_loader):
                    val_meters = engine.evaluate(
                        [val_model], valid_loader, epoch,
                        post_kwargs=post_kwargs_from_cfg(cfg),
                        step_mode="val_swa" if use_swa else "val")
                else:
                    # an empty stripe still joins the merge below
                    val_meters = engine.empty_eval_meters()
                multihost.merge_meters(val_meters)
                state.model.train()
                result["val_loss"] = float(val_meters["loss"].avg)
                value = (val_meters["loss"].avg if cfg.save_on == "loss"
                         else float(np.nanmean(val_meters[cfg.key_metric[0]].avg)))
                if primary:
                    ckpt.save(state, epoch, float(value))
                if train_meters is not None:
                    tb.log_scalar("Loss/overfit",
                                  val_meters["loss"].avg - train_meters["loss"].avg, epoch)
            if cfg.fold is None and train_meters is not None and primary:
                ckpt.save(state, epoch, result["train_loss"])
    # nothing checkpointable is left: SIGTERM terminates the evaluation
    stop["defer"] = False
    result["global_step"] = engine.global_step
    if ckpt.best_value is not None:
        result["best_value"] = ckpt.best_value
    has_val = valid_loader is not None
    if topo.distributed:
        has_val = multihost.any_rank(has_val)
    if (cfg.evaluate_end_training or cfg.only_evaluate) and has_val and not stop["flag"]:
        result.update(evaluate_end_training(cfg, engine, valid_loader, h_params, tb,
                                            device))
    tb.close()
    logger.info("total time: %.1fs", time.time() - total_start)
    return result


if __name__ == "__main__":
    main()
    multihost.shutdown()
