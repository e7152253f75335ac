"""Fold-parallel training CLI: the five cross-validation folds of one
recipe in one run (``parallel/folds.py``; JAX ``cli/main_train_folds.py``).
The flag surface is ``main_train``'s and ``--fold`` is ignored. It writes
``<save_path>/<name>_folds/fold_<f>/`` for f in 0-4, each with its
``config.yaml`` and ``best_model.pth`` / ``last_model.pth``, which
``main_inference --config fold_*/config.yaml`` serves as an ensemble.

    python -m brats21_tpu_torch.cli.main_train_folds --train_data_path DATA ...
    torchrun --nproc_per_node 5 -m brats21_tpu_torch.cli.main_train_folds ...

Under ``torchrun`` fold f trains on rank ``f % WORLD_SIZE``; a rank with
several folds advances them in lock-step, and the ranks, whose folds end
at different times, wait for each other at the end with no time limit.
Every ``--val_frequency`` epochs each fold is validated on its val cases
and its checkpoints are written, following the validation loss (or the
mean key metric), as the JAX package writes them on validation epochs
alone.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List

import numpy as np
import torch

from .. import set_main_logger
from ..config import make_experience_name
from ..data.discovery import MODALITIES_WITH_SEG, create_database, kfold_split, make_file_records
from ..data.pipeline import BraTSDataset, EvalLoader, TrainLoader
from ..learning.checkpoint import CheckpointManager
from ..learning.engine import Engine
from ..learning.losses import make_criterion
from ..learning.optimizers import make_optimizer
from ..learning.train_state import TrainState, TrainStep, model_uses_rng
from ..models import get_model
from ..parallel import multihost
from ..parallel.folds import Fold, fold_seed, owned_folds, train_folds_epoch
from ..parallel.mesh import init_topology
from ..utils.profiling import maybe_enable_from_env, tune_host_allocator
from .arguments import get_train_args
from .main_inference import post_kwargs_from_cfg

N_FOLDS = 5


def main(argv=None) -> Dict[int, List[float]]:
    """Run the CLI; returns each of this rank's folds' mean train loss an
    epoch."""
    total_start = time.time()
    cfg = get_train_args(argv)
    topo = init_topology(cfg.device)
    device = topo.device
    # named on the primary's clock, for every rank
    experience_name = multihost.from_primary(make_experience_name(cfg)[0])
    base_dir = os.path.join(cfg.save_path, experience_name + "_folds")
    os.makedirs(base_dir, exist_ok=True)
    logger = set_main_logger(os.path.join(base_dir, "logfile.log") if topo.primary else None,
                             verbosity=max(cfg.verbosity, 1))
    maybe_enable_from_env()
    tune_host_allocator()
    mine = owned_folds(N_FOLDS, topo.rank, topo.world_size)
    logger.info("rank %d of %d on %s (node %d of %d), backend %s: folds %s", topo.rank,
                topo.world_size, device, topo.node, topo.nodes, topo.backend, mine)
    if topo.world_size < N_FOLDS:
        logger.warning("%d rank(s) for %d folds: each rank loops its folds in lock-step",
                       topo.world_size, N_FOLDS)

    db = create_database(cfg.train_data_path, required_modality=MODALITIES_WITH_SEG)
    ids = list(db)
    recs = make_file_records(db, with_seg=True)
    splits = [kfold_split(ids, f, N_FOLDS, cfg.seed) for f in range(N_FOLDS)]
    bs = max(cfg.batch_size, 1)
    # whole batches only, the fewest of any fold: every fold takes the same
    # steps wherever it trains (the JAX package's drop_last and min)
    n_steps = min(len(train_id) // bs for train_id, _ in splits)
    if n_steps == 0:
        raise ValueError(f"a fold has fewer than --batch_size {bs} train cases")
    needs_dm = "boundary" in cfg.criterion
    criterion = make_criterion(cfg)
    engine = Engine(cfg, device, criterion=criterion)       # each fold alone on its rank
    folds: List[Fold] = []
    for f in mine:
        train_id, val_id = (set(x) for x in splits[f])
        fold_dir = os.path.join(base_dir, f"fold_{f}")
        os.makedirs(fold_dir, exist_ok=True)
        dataclasses.replace(cfg, fold=f, save_path=fold_dir).to_yaml(
            os.path.join(fold_dir, "config.yaml"))
        ds = BraTSDataset([r for r in recs if r["patient_id"] in train_id], with_seg=True,
                          remove_outliers=cfg.remove_outliers,
                          already_preprocess=cfg.already_preprocess, normalize=False)
        loader = TrainLoader(ds, bs, cfg.patch_size, seed=fold_seed(cfg.seed, f),
                             num_workers=cfg.num_workers, compute_dm=needs_dm, device=device)
        val_recs = [r for r in recs if r["patient_id"] in val_id]
        val_loader = EvalLoader(BraTSDataset(
            val_recs, with_seg=True, remove_outliers=cfg.remove_outliers,
            already_preprocess=cfg.already_preprocess, compute_distance_map=needs_dm,
            device=device)) if val_recs else None
        torch.manual_seed(fold_seed(cfg.seed, f))
        model = get_model(cfg).to(device)
        optimizer = make_optimizer(cfg, model.parameters(), n_steps)
        swa = torch.optim.swa_utils.AveragedModel(model) if cfg.swa_start else None
        step = TrainStep(criterion, use_amp=not cfg.no_amp, stochastic=model_uses_rng(cfg),
                         seed=fold_seed(cfg.seed, f))
        folds.append(Fold(f, TrainState(model, optimizer, swa), step, loader, val_loader,
                          CheckpointManager(fold_dir, save_on=cfg.save_on,
                                            key_metric=cfg.key_metric[0])))

    post_kwargs = post_kwargs_from_cfg(cfg)
    for epoch in range(1, cfg.epochs + 1):
        t0 = time.time()
        losses = train_folds_epoch(folds, engine, epoch, n_steps, cfg.swa_start)
        logger.info("epoch %d (%.1fs, %d steps a fold): fold losses %s", epoch,
                    time.time() - t0, n_steps,
                    {f: round(v, 4) for f, v in losses.items()})
        if epoch % cfg.val_frequency:
            continue
        for fold in folds:
            # the fold's val cases decide its best checkpoint (its train
            # loss when it has none)
            value = losses[fold.index]
            if fold.val_loader is not None:
                use_swa = bool(cfg.swa_start) and epoch > cfg.swa_start
                model = (fold.state.swa_model.module if use_swa else fold.state.model).eval()
                meters = engine.evaluate([model], fold.val_loader, epoch,
                                         post_kwargs=post_kwargs,
                                         step_mode=f"val_fold{fold.index}")
                fold.state.model.train()
                value = (meters["loss"].avg if cfg.save_on == "loss"
                         else float(np.nanmean(meters[cfg.key_metric[0]].avg)))
            fold.ckpt.save(fold.state, epoch, float(value))
    # the ranks' folds end at different times, with no collective between:
    # a barrier bounded by BRATS21_DIST_TIMEOUT would fail the lighter rank
    multihost.wait_all(topo.store, "brats21/folds_done", topo.world_size)
    logger.info("total time: %.1fs", time.time() - total_start)
    return {fold.index: fold.history for fold in folds}


if __name__ == "__main__":
    main()
    multihost.shutdown()
