"""Optimizer factory: ``brats21_tpu/learning/optimizers.py``'s update chain
(definer.py:291-380) on PyTorch.

``make_optimizer`` returns a :class:`TrainOptimizer`: [AGC or global-norm
clipping] → the optimizer at the scheduled learning rate, optionally inside
gradient accumulation with ``optax.MultiSteps``'s semantics (the running
mean of k mini-steps' gradients; the optimizer, clipping and schedule step
on every k-th call only).
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from .ranger import Ranger, adaptive_grad_clip_, ranger21
from .schedules import Schedule, make_lr_schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


class TrainOptimizer:
    """One optimizer step per :meth:`step`, reading each parameter's
    ``.grad`` (a missing gradient counts as zero, as the JAX package
    differentiates every parameter). With ``accumulate`` = k the gradients
    are averaged over k calls and the chain runs on the k-th."""

    def __init__(self, params: List[torch.Tensor], optimizer: torch.optim.Optimizer,
                 schedule: Schedule, clip: str = "none", max_grad_norm: float = 1.0,
                 accumulate: int = 1):
        self.params = list(params)
        self.optimizer = optimizer
        self.schedule = schedule
        self.clip = clip
        self.max_grad_norm = float(max_grad_norm)
        self.accumulate = int(accumulate)
        self.count = 0          # optimizer steps taken: the schedule's index
        self.mini_step = 0
        self._acc: List[torch.Tensor] = []

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def _accumulated(self) -> bool:
        """Fold this call's gradients into the running mean; True when the
        mean is complete and now stands in ``.grad``."""
        if not self._acc:
            self._acc = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        n = self.mini_step
        for p, acc in zip(self.params, self._acc):
            acc.add_((p.grad.float() - acc) / (n + 1))
        self.mini_step = (n + 1) % self.accumulate
        if self.mini_step:
            return False
        for p, acc in zip(self.params, self._acc):
            p.grad = acc.clone()
            acc.zero_()
        return True

    @torch.no_grad()
    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.accumulate > 1 and not self._accumulated():
            return
        if self.clip == "agc":
            adaptive_grad_clip_(self.params, clipping=1e-2, eps=1e-3)
        elif self.clip == "global_norm":
            # optax.clip_by_global_norm: scale by max/‖g‖ unless ‖g‖ < max
            norm = global_norm([p.grad for p in self.params])
            keep = norm < self.max_grad_norm
            for p in self.params:
                p.grad = torch.where(keep, p.grad, p.grad / norm * self.max_grad_norm)
        lr = self.schedule(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1

    def state_dict(self) -> Dict[str, Any]:
        return {"optimizer": self.optimizer.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": [a.cpu() for a in self._acc]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        self._acc = [a.to(p.device) for a, p in zip(state["acc"], self.params)]


class NovoGrad(torch.optim.Optimizer):
    """``optax.novograd(lr, b1, b2, eps, weight_decay)``
    (``brats21_tpu/learning/optimizers.py:48-49``) with optax's
    ``scale_by_novograd`` semantics: per parameter tensor one scalar
    ``nu`` — ‖g‖² at the first step, then b2·nu + (1−b2)·‖g‖² — and
    ``mu`` = g / (√nu + eps) + wd·p at the first step, then b1·mu + that,
    with no (1−b1) factor and no bias correction; the update is −lr·mu at
    each group's ``lr`` (set by the caller from the schedule). A parameter
    without a gradient steps as with a zero one."""

    def __init__(self, params, lr: float = 0.0, betas=(0.9, 0.98), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            eps, wd, lr = group["eps"], group["weight_decay"], group["lr"]
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                state = self.state[p]
                sq = torch.linalg.vector_norm(g) ** 2
                nu = sq if not state else (1 - b2) * sq + b2 * state["nu"]
                u = g / (torch.sqrt(nu) + eps) + wd * p
                state["mu"] = u if not state else b1 * state["mu"] + u
                state["nu"] = nu
                p.add_(-lr * state["mu"])
        return None


def make_optimizer(cfg: Any, params: List[torch.Tensor],
                   steps_per_epoch: int) -> TrainOptimizer:
    """definer.py:291-380 dispatch with the JAX package's kwargs."""
    params = list(params)
    wd = float(cfg.weight_decay)
    name = cfg.optimizer
    if name == "sgd":
        # optax chain(add_decayed_weights, sgd(momentum 0.9)) = torch SGD
        opt: torch.optim.Optimizer = torch.optim.SGD(params, lr=0.0, momentum=0.9,
                                                     weight_decay=wd)
    elif name == "adam":
        # torch Adam applies weight decay as L2 into the gradient
        opt = torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=wd)
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=wd)
    elif name == "ranger":
        opt = Ranger(params, 0.0, alpha=0.5, k=6, n_sma_threshold=5,
                     betas=(0.95, 0.999), eps=1e-5, weight_decay=wd,
                     use_gc=cfg.use_gc, use_gcnorm=cfg.use_gcnorm,
                     normloss=cfg.normloss, normloss_factor=cfg.normloss_factor,
                     gc_conv_only=cfg.gc_conv_only)
    elif name == "ranger21":
        # the reference overrides Ranger21's decay with args.weight_decay
        # unconditionally (definer.py:377-379)
        opt = ranger21(params, 0.0, weight_decay=wd, use_gc=cfg.use_gc,
                       gc_conv_only=cfg.gc_conv_only, normloss=cfg.normloss,
                       normloss_factor=cfg.normloss_factor)
    elif name == "novograd":
        opt = NovoGrad(params, 0.0, betas=(0.9, 0.98), eps=1e-8, weight_decay=wd)
    else:
        raise NameError("Not Supported Optimizer")
    if getattr(cfg, "adaptive_gradient_clipping", False):
        clip = "agc"
    elif getattr(cfg, "gradient_clipping", False):
        clip = "global_norm"
    else:
        clip = "none"
    return TrainOptimizer(params, opt, make_lr_schedule(cfg, steps_per_epoch), clip=clip,
                          max_grad_norm=float(getattr(cfg, "max_grad_norm", 1.0)),
                          accumulate=getattr(cfg, "gradient_accumulation_iter", None) or 1)
