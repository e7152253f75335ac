"""best/last checkpoints in the reference's torch format.

The policy of ``brats21_tpu/learning/checkpoint.py:58-132`` (reference
engine.py:454-509): every save writes ``last_model.pth`` and, when the
tracked value improves, ``best_model.pth``; "best" is the lowest loss or
hausdorff_distance95, else the highest key metric. Each file is the
reference's payload ``{"model", "optimizer", "epoch", "best_value"}``, plus
``"swa_model"`` (an AveragedModel's state_dict) on SWA runs, so
``utils/weights.py:load_reference_pth`` and the reference read it.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from .. import get_logger
from .train_state import TrainState

logger = get_logger("checkpoint")

BEST_NAME = "best_model.pth"
LAST_NAME = "last_model.pth"


class CheckpointManager:
    """The best/last pair with the engine.py:474-497 improvement rule."""

    def __init__(self, save_dir: str, save_on: str = "loss", key_metric: str = "dice"):
        if save_on not in ("loss", "key_metric"):
            raise ValueError("save_on must be 'loss' or 'key_metric'")
        self.save_dir = os.path.abspath(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)
        self.save_on = save_on
        self.minimize = save_on == "loss" or key_metric == "hausdorff_distance95"
        self.best_value: Optional[float] = None

    def _write(self, name: str, state: TrainState, epoch: int, value: float) -> None:
        payload: Dict[str, Any] = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "epoch": epoch,
            "best_value": value,
        }
        if state.swa_model is not None:
            payload["swa_model"] = state.swa_model.state_dict()
        path = os.path.join(self.save_dir, name)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)

    def save(self, state: TrainState, epoch: int, value: float) -> bool:
        """Write last; write best too if ``value`` improved. True when best."""
        improved = self.best_value is None or (
            value < self.best_value if self.minimize else value > self.best_value)
        if improved:
            self.best_value = float(value)
        self._write(LAST_NAME, state, epoch, self.best_value)
        if improved:
            self._write(BEST_NAME, state, epoch, self.best_value)
            logger.info("epoch %d: new best %s=%.5f", epoch, self.save_on, value)
        return improved


def resume(state: TrainState, payload: Dict[str, Any]) -> None:
    """Load a ``last_model.pth`` payload into ``state`` (reference
    Engine.resume, engine.py:511-525): model, optimizer and SWA average; the
    caller continues from its ``epoch`` and ``best_value``."""
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    if state.swa_model is not None and "swa_model" in payload:
        state.swa_model.load_state_dict(payload["swa_model"])
