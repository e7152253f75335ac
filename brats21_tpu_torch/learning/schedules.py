"""Learning-rate schedules: the per-step learning rates of
``brats21_tpu/learning/schedules.py`` (reference learning/lr_scheduler.py and
the torch schedulers wired in definer.py:383-408).

The reference steps its schedulers once per epoch (main_train.py:151-159);
each schedule here is a function of the optimizer's step count with a known
``steps_per_epoch``, returning a Python float.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np

Schedule = Callable[[int], float]


def multistep_lr(base_lr: float, epochs: int, steps_per_epoch: int,
                 milestone_every: int = 30, gamma: float = 0.1) -> Schedule:
    """MultiStepLR(milestones=range(30, epochs, 30), gamma=0.1)
    (definer.py:393)."""
    milestones = list(range(milestone_every, epochs, milestone_every))

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        return base_lr * gamma ** sum(epoch >= m for m in milestones)

    return schedule


def cosine_lr(base_lr: float, epochs: int, steps_per_epoch: int,
              eta_min: float = 0.0) -> Schedule:
    """CosineAnnealingLR(T_max=epochs, eta_min=0) stepped per epoch
    (definer.py:402)."""

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * epoch / epochs)) / 2

    return schedule


def flat_cosine_lr(base_lr: float, epochs: int, steps_per_epoch: int,
                   step_size: float = 0.70, eta_min: float = 0.0) -> Schedule:
    """FlatplusAnneal (lr_scheduler.py:88-111): flat for 70 % of the epochs,
    then cosine to eta_min (definer.py:404)."""
    flat_range = int(epochs * step_size)
    t_max = max(epochs - flat_range, 1)

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        if epoch < flat_range:
            return base_lr
        cr = max(epoch - flat_range, 0)
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * cr / t_max)) / 2

    return schedule


def warmup_wrap(inner: Schedule, base_lr: float, steps_per_epoch: int,
                total_epoch: int) -> Schedule:
    """GradualWarmupScheduler (lr_scheduler.py:15-85) with multiplier 1:
    linear 0 → base over ``total_epoch`` epochs, then ``inner``, whose
    epoch count lags by total_epoch + 1 (the torch wrapper's hand-off; the
    JAX package's ``warmup_wrap``)."""

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        if epoch <= total_epoch:
            return min(base_lr * epoch / max(total_epoch, 1), base_lr)
        return inner(step - (total_epoch + 1) * steps_per_epoch)

    return schedule


def simulate_reference_swa_lrs(cfg: Any) -> np.ndarray:
    """Per-epoch learning rates of the reference's SWA stepping
    (engine.py:149-159 with torch's recursive schedulers and SWALR),
    simulated in float64: the JAX package's ``_simulate_reference_swa_lrs``.
    Until ``swa_start`` the base scheduler is not stepped; after it the base
    scheduler and SWALR step back to back every epoch."""
    base_lr = float(cfg.learning_rate)
    epochs = int(cfg.epochs)
    decay = cfg.decay_type
    swa_start = int(cfg.swa_start)
    swa_lr = float(cfg.swa_lr)
    anneal = max(int(cfg.swa_anneal_epochs), 1)
    milestones = set(range(30, epochs, 30))
    warm_total = 5 if decay == "step_warmup" else max(epochs // 20, 1)
    flat_range = int(epochs * 0.70)
    t_max_flat = max(epochs - flat_range, 1)

    # base scheduler: last_epoch ell, group lr L, and the warmup wrapper's
    # after-scheduler epoch ell_a (-1 until the hand-off)
    ell, ell_a = 0, -1
    lr = 0.0 if decay in ("step_warmup", "cosine_warmup") else base_lr

    def base_step() -> None:
        nonlocal ell, ell_a, lr
        ell += 1
        if decay == "step":
            if ell in milestones:
                lr *= 0.1
        elif decay == "cosine":
            lr = lr * (1 + math.cos(math.pi * ell / epochs)) \
                / (1 + math.cos(math.pi * (ell - 1) / epochs))
        elif decay == "flat_cosine":
            lr = base_lr if ell < flat_range else \
                base_lr * (1 + math.cos(math.pi * (ell - flat_range) / t_max_flat)) / 2
        elif ell <= warm_total:
            lr = base_lr * ell / warm_total
        elif ell_a < 0:
            ell_a, lr = 0, base_lr
        else:
            ell_a += 1
            if decay == "step_warmup":
                if ell_a in milestones:
                    lr *= 0.1
            else:
                lr = lr * (1 + math.cos(math.pi * ell_a / epochs)) \
                    / (1 + math.cos(math.pi * (ell_a - 1) / epochs))

    def alpha(t: float) -> float:
        return (1 - math.cos(math.pi * min(max(t, 0.0), 1.0))) / 2

    s = 0
    lrs = []
    for epoch in range(1, epochs + 1):
        lrs.append(lr)
        if epoch <= swa_start:
            continue
        base_step()
        s += 1
        a_s, a_p = alpha(s / anneal), alpha((s - 1) / anneal)
        prev = swa_lr if a_p >= 1.0 else (lr - a_p * swa_lr) / (1 - a_p)
        lr = swa_lr * a_s + (1 - a_s) * prev
    return np.asarray(lrs, dtype=np.float32)


def swa_wrap(inner: Schedule, cfg: Any, steps_per_epoch: int) -> Schedule:
    """SWA composition (main_train.py:113-115, engine.py:151-159): the
    simulated per-epoch table, indexed by epoch; ``inner`` without SWA."""
    if not cfg.swa_start:
        return inner
    table = simulate_reference_swa_lrs(cfg)

    def schedule(step: int) -> float:
        epoch = min(max(step // steps_per_epoch, 0), len(table) - 1)
        return float(table[epoch])

    return schedule


def make_lr_schedule(cfg: Any, steps_per_epoch: int) -> Schedule:
    """Scheduler dispatch of definer.py:383-408, with the SWA wrap."""
    base_lr = float(cfg.learning_rate)
    epochs = int(cfg.epochs)
    decay = cfg.decay_type
    if decay == "step":
        sched = multistep_lr(base_lr, epochs, steps_per_epoch)
    elif decay == "step_warmup":
        sched = warmup_wrap(multistep_lr(base_lr, epochs, steps_per_epoch),
                            base_lr, steps_per_epoch, total_epoch=5)
    elif decay == "cosine_warmup":
        sched = warmup_wrap(cosine_lr(base_lr, epochs, steps_per_epoch),
                            base_lr, steps_per_epoch, total_epoch=max(epochs // 20, 1))
    elif decay == "cosine":
        sched = cosine_lr(base_lr, epochs, steps_per_epoch)
    elif decay == "flat_cosine":
        sched = flat_cosine_lr(base_lr, epochs, steps_per_epoch)
    else:
        raise ValueError(f"unknown lr scheduler: {decay}")
    return swa_wrap(sched, cfg, steps_per_epoch)
