"""Fold-parallel training: the K cross-validation folds of one recipe, each
trained by one rank, with no gradient sync between folds.

Port of ``brats21_tpu/parallel/folds.py``. The JAX package stacks the folds
on a leading axis sharded over its mesh and advances every fold in one
step; here fold f trains on global rank ``f % WORLD_SIZE`` (on one node,
local rank ``f % LOCAL_WORLD_SIZE``), and a rank that holds several folds
advances them in lock-step, one step of each in turn: with one rank all K,
as the JAX package loops them on one device. Every fold takes the same
number of steps an epoch (the fewest whole batches of any fold), and its
initial weights, loader and dropout draws depend on its index alone, so a
fold's result does not depend on how many ranks share the folds.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from ..learning.checkpoint import CheckpointManager
from ..learning.train_state import TrainState, TrainStep, swa_update


def owned_folds(n_folds: int, rank: int, world_size: int) -> List[int]:
    """The folds rank ``rank`` of ``world_size`` trains."""
    return [f for f in range(n_folds) if f % world_size == rank]


def fold_seed(seed: int, fold: int) -> int:
    """A fold's seed for its initial weights, its batches' order and
    augmentations and its dropout (the JAX package's ``fold_in(rng, f)``)."""
    return (int(seed) << 8) + int(fold)


@dataclass
class Fold:
    """One fold's run: its state, step, loaders, checkpoints and global step."""

    index: int
    state: TrainState
    step: TrainStep
    loader: Any
    val_loader: Optional[Any]
    ckpt: CheckpointManager
    global_step: int = 0
    history: List[float] = field(default_factory=list)


def train_folds_epoch(folds: List[Fold], engine, epoch: int, n_steps: int,
                      swa_start: Optional[int] = None) -> Dict[int, float]:
    """One epoch of every fold in ``folds``, in lock-step: step i of each
    fold in turn, ``n_steps`` steps. Returns each fold's mean loss."""
    iters = []
    for fold in folds:
        fold.loader.set_epoch(epoch)
        iters.append(iter(fold.loader))
    sums = np.zeros(len(folds))
    for _ in range(n_steps):
        for k, (fold, it) in enumerate(zip(folds, iters)):
            img, target = engine.batch_to_device(next(it))
            metrics = fold.step(fold.state, img, target, fold.global_step)
            fold.global_step += 1
            sums[k] += float(metrics["loss"])
    for it in iters:
        if hasattr(it, "close"):
            it.close()
    out = {}
    for k, fold in enumerate(folds):
        if swa_start and epoch > swa_start:
            swa_update(fold.state)
        out[fold.index] = float(sums[k] / max(n_steps, 1))
        fold.history.append(out[fold.index])
    return out

