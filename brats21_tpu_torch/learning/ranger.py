"""Ranger2020 (RAdam + Lookahead + gradient centralization + norm-loss) and
adaptive gradient clipping, on the tensors' own device.

Port of ``brats21_tpu/learning/ranger.py`` (reference learning/optimizer.py
:62-255 and lr_scheduler.py:114-215). Parameters keep the reference's torch
layouts, so gradient centralization, the norm-loss unit norm and AGC's unit
norm use the reference's own axes: conv ``[out, in, k, k, k]`` and linear
``[out, in]`` weights reduce over dims 1.., EvoNorm's rank-5 ``(1, C, 1, 1,
1)`` affines over their whole vector, as the JAX package reproduces them on
its transposed flax layouts.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

import torch


def _centralize(g: torch.Tensor, conv_only: bool) -> torch.Tensor:
    """Gradient centralization (optimizer.py:11-20): subtract the mean over
    dims 1..; rank > 1 (rank > 3 with ``conv_only``)."""
    if g.dim() > (3 if conv_only else 1):
        return g - g.mean(dim=tuple(range(1, g.dim())), keepdim=True)
    return g


def _normalize_gradient(g: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Std-normalize a gradient (optimizer.py:23-36, use_channels=False;
    torch's Bessel-corrected std)."""
    if g.numel() > 2:
        return g / (g.std() + eps)
    return g


def _unit_norm(x: torch.Tensor) -> torch.Tensor:
    """Axis-based euclidean norm of the norm-loss (optimizer.py:39-59)."""
    if x.dim() <= 1:
        return torch.linalg.vector_norm(x)
    dims = (1,) if x.dim() in (2, 3) else tuple(range(1, x.dim()))
    return torch.linalg.vector_norm(x, dim=dims, keepdim=True)


def _agc_unitwise_norm(x: torch.Tensor) -> torch.Tensor:
    """AGC's unitwise norm (lr_scheduler.py:114-130): whole vector for rank
    ≤ 1, dim 0 for rank 2-3, dims 1.. otherwise."""
    if x.dim() <= 1:
        return torch.linalg.vector_norm(x)
    dims = (0,) if x.dim() in (2, 3) else tuple(range(1, x.dim()))
    return torch.linalg.vector_norm(x, dim=dims, keepdim=True)


@torch.no_grad()
def adaptive_grad_clip_(params: Iterable[torch.Tensor], clipping: float = 1e-2,
                        eps: float = 1e-3) -> None:
    """Adaptive gradient clipping in place (lr_scheduler.py:133-215):
    ``g ← g·max_norm/max(‖g‖, 1e-6)`` per unit where ``‖g‖ > max_norm``,
    ``max_norm = clipping·max(‖p‖, eps)``."""
    for p in params:
        if p.grad is None:
            continue
        g = p.grad
        max_norm = torch.clamp(_agc_unitwise_norm(p), min=eps) * clipping
        grad_norm = _agc_unitwise_norm(g)
        clipped = g * (max_norm / torch.clamp(grad_norm, min=1e-6))
        p.grad = torch.where(grad_norm > max_norm, clipped, g)


class Ranger(torch.optim.Optimizer):
    """Ranger2020 with the definer.py:316-331 parameter surface and the
    exact update of ``brats21_tpu/learning/ranger.py:135-240``.

    The learning rate is each group's ``lr`` at the step (the caller sets it
    from the schedule). The step count lives in each group's ``step``.
    Parameters without a gradient step as with a zero one (the JAX package
    differentiates every parameter, so weight decay and lookahead still
    move them)."""

    def __init__(self, params, lr: float = 1e-3, alpha: float = 0.5, k: int = 6,
                 n_sma_threshold: float = 5, betas: Sequence[float] = (0.95, 0.999),
                 eps: float = 1e-5, weight_decay: float = 0.0, use_gc: bool = False,
                 use_gcnorm: bool = False, normloss: bool = False,
                 normloss_factor: float = 1e-4, gc_conv_only: bool = False):
        defaults = dict(lr=lr, alpha=alpha, k=k, n_sma_threshold=n_sma_threshold,
                        betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                        use_gc=use_gc, use_gcnorm=use_gcnorm, normloss=normloss,
                        normloss_factor=normloss_factor, gc_conv_only=gc_conv_only,
                        step=0)
        super().__init__(params, defaults)

    @staticmethod
    def _step_size(t: int, b1: float, b2: float, threshold: float):
        """(rectified?, step size) at step t, the beta powers through expm1
        as the JAX package computes them (ranger.py:186-202)."""
        log_b1, log_b2 = math.log(b1), math.log(b2)
        beta2_t = math.exp(t * log_b2)
        one_m_beta2_t = -math.expm1(t * log_b2)
        n_sma_max = 2.0 / (1 - b2) - 1.0
        n_sma = n_sma_max - 2.0 * t * beta2_t / one_m_beta2_t
        bias1 = 1.0 / -math.expm1(t * log_b1)
        if n_sma <= threshold:
            return False, bias1
        rect = math.sqrt(one_m_beta2_t * (n_sma - 4) / (n_sma_max - 4)
                         * (n_sma - 2) / n_sma * n_sma_max / (n_sma_max - 2))
        return True, rect * bias1

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Ranger.step takes no closure")
        for group in self.param_groups:
            group["step"] += 1
            t = group["step"]
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            use_rect, step_size = self._step_size(t, b1, b2, group["n_sma_threshold"])
            sync = t % group["k"] == 0
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                    state["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                    state["slow"] = p.detach().float().clone()
                g = torch.zeros_like(p, dtype=torch.float32) if p.grad is None \
                    else p.grad.float()
                if group["use_gc"]:
                    g = _centralize(g, group["gc_conv_only"])
                if group["use_gcnorm"]:
                    g = _normalize_gradient(g)
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.mul_(b1).add_(g * (1 - b1))
                v.mul_(b2).add_((g * (1 - b2)) * g)
                p32 = p.float()
                if group["normloss"]:
                    # scales the weights before weight decay reads them
                    # (optimizer.py:192-198,242-243)
                    correction = 2 * group["normloss_factor"] * (
                        1 - 1.0 / (_unit_norm(p32) + eps))
                    p32 = p32 * (1 - lr * correction)
                upd = m / (v.sqrt() + eps) if use_rect else m
                if wd:
                    upd = upd + wd * p32
                fast = p32 - (step_size * lr) * upd
                if sync:
                    # lookahead (optimizer.py:245-253): blend into the slow
                    # weights and reset the fast ones to them
                    slow = state["slow"]
                    slow.add_((fast - slow) * group["alpha"])
                    fast = slow
                p.copy_(fast)


def ranger21(params, lr: float = 1e-3, betas: Sequence[float] = (0.9, 0.999),
             eps: float = 1e-8, weight_decay: float = 1e-4, use_gc: bool = False,
             gc_conv_only: bool = False, normloss: bool = False,
             normloss_factor: float = 1e-4, lookahead_k: int = 5,
             lookahead_alpha: float = 0.5) -> Ranger:
    """Ranger21 as definer.py:332-366 configures it (lookahead every 5, no
    warmup, warmdown, AGC or Chebyshev steps): the same rectified-RAdam
    chain with Ranger21's betas, eps and decay (ranger.py:243)."""
    return Ranger(params, lr, alpha=lookahead_alpha, k=lookahead_k, betas=betas,
                  eps=eps, weight_decay=weight_decay, use_gc=use_gc,
                  gc_conv_only=gc_conv_only, normloss=normloss,
                  normloss_factor=normloss_factor)
