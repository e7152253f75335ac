"""The train step and the SWA average.

Port of ``brats21_tpu/learning/train_state.py``: the JAX package's pure
``train_step(state, img, target)`` becomes :class:`TrainStep` over a
:class:`TrainState` holding the model, its :class:`TrainOptimizer` and the
optional SWA average. Precision is the JAX package's: parameters fp32, the
input cast to bf16 unless ``no_amp`` (each layer casts its weights to the
activation dtype), losses, gradients and the optimizer fp32; no GradScaler.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..models.layers import step_generator, stochastic
from .losses import LossFn, deep_supervision_loss
from .optimizers import TrainOptimizer, global_norm


@dataclass
class TrainState:
    model: nn.Module
    optimizer: TrainOptimizer
    swa_model: Optional[torch.optim.swa_utils.AveragedModel] = None


def dice_metric(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-(batch, channel) Dice of binary NCDHW masks with the BraTS edge
    rules (``brats21_tpu/utils/metrics.py:dice_metric``): 1 where both are
    empty, 0 where one is. Returns ``[B, C]`` fp32."""
    p, g = pred.float(), target.float()
    dims = tuple(range(2, p.dim()))
    inter = (p * g).sum(dim=dims)
    p_sum, g_sum = p.sum(dim=dims), g.sum(dim=dims)
    dice = 2.0 * inter / (p_sum + g_sum)
    exists_p, exists_g = p_sum > 0, g_sum > 0
    dice = torch.where(~exists_p & ~exists_g, 1.0, dice)
    return torch.where(exists_p ^ exists_g, 0.0, dice)


def model_uses_rng(cfg: Any) -> bool:
    """Whether the model draws random numbers in training
    (``train_state.py:55-59``): dropout layers, or SegResNetVAE's latent
    sampling (z = μ + σ·ε)."""
    return (getattr(cfg, "dropout", 0.0) or 0.0) > 0 or getattr(cfg, "model", "") == "segresnetvae"


class TrainStep:
    """forward (bf16 unless ``no_amp``) → deep-supervision loss → backward
    → optimizer step, as ``make_train_step`` (train_state.py:62-111). The
    metrics stay on the device, so the caller can read step i−1's while
    step i runs. ``log_metrics`` adds the main head's per-channel batch
    Dice.

    With ``stochastic`` (the JAX package's ``not deterministic``,
    :func:`model_uses_rng`) the model's dropout masks and latent samples
    draw from a generator seeded from ``(seed, step)`` on the batch's
    device, ``step`` being the engine's global step, as the JAX package
    folds its step rng (``engine.py:332``); otherwise they are off, in
    training too."""

    def __init__(self, criterion: LossFn, use_amp: bool = True,
                 log_metrics: bool = False, stochastic: bool = False, seed: int = 0):
        self.criterion = criterion
        self.use_amp = use_amp
        self.log_metrics = log_metrics
        self.stochastic = stochastic
        self.seed = seed

    def forward_loss(self, state: TrainState, img: torch.Tensor, target: Any,
                     step: int = 0):
        """(loss, main-head logits) of one batch, NCDHW; ``target`` is the
        seg or the boundary criteria's (seg, distance_map) pair."""
        x = img.to(torch.bfloat16 if self.use_amp else torch.float32)
        gen = step_generator(self.seed, step, x.device) if self.stochastic else None
        with stochastic(state.model, gen):
            outputs = state.model(x)
        loss = deep_supervision_loss(self.criterion, outputs, target)
        main = outputs[0] if isinstance(outputs, tuple) else outputs
        if isinstance(main, (list, tuple)):     # [refined, logits]: the metric head
            main = main[0]
        return loss, main

    def backward_update(self, state: TrainState, loss: torch.Tensor) -> torch.Tensor:
        """Gradients of ``loss`` and one optimizer step; returns the
        gradients' global norm."""
        opt = state.optimizer
        opt.zero_grad()
        loss.backward()
        gnorm = global_norm([p.grad for p in opt.params if p.grad is not None])
        opt.step()
        return gnorm

    def __call__(self, state: TrainState, img: torch.Tensor, target: Any,
                 step: int = 0) -> Dict[str, torch.Tensor]:
        state.model.train()
        loss, main = self.forward_loss(state, img, target, step)
        metrics = {"loss": loss.detach(), "grad_norm": self.backward_update(state, loss)}
        if self.log_metrics:
            with torch.no_grad():
                pred = torch.sigmoid(main.float()) >= 0.5
                seg = target[0] if isinstance(target, tuple) else target
                metrics["dice"] = dice_metric(pred, seg).mean(dim=0)
        return metrics


def swa_update(state: TrainState) -> None:
    """Equal-average SWA update (torch AveragedModel, main_train.py:113-115,
    engine.py:155-159): called once per epoch after ``swa_start``."""
    if state.swa_model is not None:
        state.swa_model.update_parameters(state.model)
        sync_swa_buffers(state)


def sync_swa_buffers(state: TrainState) -> None:
    """Give the SWA average the model's current buffers (BatchNorm's
    running statistics), as the JAX package pairs ``swa_params`` with the
    current ``batch_stats`` for validation and in its checkpoints
    (``cli/main_train.py:244-251``); AveragedModel would keep its own copy
    from construction."""
    if state.swa_model is not None:
        with torch.no_grad():
            for avg, cur in zip(state.swa_model.module.buffers(), state.model.buffers()):
                avg.copy_(cur)

