"""Training epochs, and serial single-device evaluation: ensemble × TTA →
post-process → NIfTI.

``Engine.train_epoch`` ports ``brats21_tpu/learning/engine.py:256-348``:
each batch crosses to the card as the JAX package's wire has it (fp16
images, uint8 targets, fp32 distance maps for the boundary criteria, from
pinned memory without blocking) and is cast there; step i−1's metrics are read only after step i is enqueued, so the
card never waits on the host's read.

``Engine.evaluate`` ports the serial branch of ``Engine.evaluate``
(reference engine.py:163-296) for cases without a target (``--on test``):
pad each case to a multiple of 8 (``_pad_case``), copy it to the card in
fp16 as the JAX package's dense wire does, run each
member — the plain forward or the 16-combo TTA mean — and take the fp32
sigmoid of the main head, average the members, post-process, zero the
prediction outside the brain, and un-pad, un-crop and write the labels.
The loader decodes the next case in a background thread meanwhile.
Metrics, losses, sliding windows and STAPLE come with later slices.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import get_logger
from ..data import transforms as T
from ..data.nifti import write_nifti
from ..ops.postprocess import post_process
from ..ops.tta import main_head, tta_mean_probs
from ..utils.meter import AverageMeter, ProgressMeter
from .train_state import TrainState, TrainStep, swa_update

logger = get_logger("engine")


def forward_main_head(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Main-head logits of a channels-last volume ``[B, X, Y, Z, C]``, as
    ``[B, X, Y, Z, classes]``; the deep heads are skipped."""
    xin = x.permute(0, 4, 1, 2, 3).contiguous(memory_format=torch.channels_last_3d)
    return main_head(model(xin, with_deep=False)).permute(0, 2, 3, 4, 1)


class Engine:
    """Training and evaluation on one device. ``cfg`` carries ``no_amp``,
    ``num_classes``, ``create_patient_dir`` and, for training,
    ``log_train_interval``, ``log_train_metrics`` and ``swa_start``."""

    def __init__(self, cfg: Any, device: torch.device):
        self.cfg = cfg
        self.device = device

    # ------------------------------------------------------------------ train

    def to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Host batch → the card: pinned, copied without blocking."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def train_epoch(self, state: TrainState, step: TrainStep, loader,
                    epoch: int) -> Dict[str, AverageMeter]:
        """One epoch (engine.py:256-348): batch loop → train step → meters,
        then the SWA update past ``swa_start``."""
        cfg = self.cfg
        loader.set_epoch(epoch)
        batch_time = AverageMeter("time", ":6.3f")
        data_time = AverageMeter("data", ":6.3f")
        losses = AverageMeter("loss", ":.4e")
        gnorms = AverageMeter("grad_norm", ":.3f")
        meters = [batch_time, data_time, losses, gnorms]
        dice_meter = AverageMeter("dice", ":.4f") if cfg.log_train_metrics else None
        if dice_meter is not None:
            meters.append(dice_meter)
        progress = ProgressMeter(len(loader), meters, prefix=f"Epoch: [{epoch}]")
        pending: Optional[Tuple[Dict[str, torch.Tensor], int, int]] = None
        t_done = time.time()

        def collect(entry) -> None:
            nonlocal t_done
            metrics, n, i = entry
            losses.update(float(metrics["loss"]), n=n)     # waits for step i
            gnorms.update(float(metrics["grad_norm"]))
            if dice_meter is not None:
                dice_meter.update(metrics["dice"].cpu().numpy())
            batch_time.update(time.time() - t_done)
            t_done = time.time()
            if (i + 1) % cfg.log_train_interval == 0 or (i + 1) == len(loader):
                progress.display(i + 1)

        wire = np.float32 if cfg.no_amp else np.float16
        t0 = time.time()
        for i, batch in enumerate(loader):
            # [B, X, Y, Z, C] → NCDHW views in channels_last_3d memory
            img = self.to_device(batch["img"].astype(wire)).permute(0, 4, 1, 2, 3)
            target: Any = self.to_device(
                batch["seg"].astype(np.uint8)).float().permute(0, 4, 1, 2, 3)
            if "boundary" in cfg.criterion:
                # the boundary criteria's (seg, distance_map) pair
                # (engine.py:326-327)
                target = (target, self.to_device(
                    batch["distance_map"]).permute(0, 4, 1, 2, 3))
            data_time.update(time.time() - t0)
            metrics = step(state, img, target)
            if pending is not None:
                collect(pending)          # step i is already enqueued
            pending = (metrics, batch["img"].shape[0], i)
            t0 = time.time()
        if pending is not None:
            collect(pending)
        if cfg.swa_start and epoch > cfg.swa_start:
            swa_update(state)
        return {"loss": losses, "grad_norm": gnorms, "batch_time": batch_time,
                "data_time": data_time}

    # --------------------------------------------------------------- evaluate

    def _pad_case(self, img: np.ndarray, use_tta: bool
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host-side pad of [X,Y,Z,C] to multiples of 8, the model's
        downsampling factor (ceil-before / floor-after,
        transforms.py:483-512); TTA additionally requires X == Y (see
        ops/tta.py), padded at the end."""
        padded, p_b, p_a = T.shape_to_divisible(img, k=8)
        if use_tta and padded.shape[0] != padded.shape[1]:
            side = max(padded.shape[0], padded.shape[1])
            extra = [(0, side - padded.shape[0]), (0, side - padded.shape[1]),
                     (0, 0), (0, 0)]
            padded = np.pad(padded, extra)
            p_a = p_a + np.array([extra[0][1], extra[1][1], 0])
        return padded, p_b, p_a

    def member_probs(self, model: nn.Module, img: torch.Tensor,
                     use_tta: bool) -> torch.Tensor:
        """fp32 sigmoid probabilities [1, X, Y, Z, classes] of one member
        (engine.py:431-498, non-sliding branch)."""
        x = img.to(torch.float32 if self.cfg.no_amp else torch.bfloat16)
        if use_tta:
            return tta_mean_probs(lambda v: forward_main_head(model, v), x,
                                  num_classes=self.cfg.num_classes)
        return torch.sigmoid(forward_main_head(model, x).float())

    @torch.inference_mode()
    def evaluate(self, members: List[nn.Module], loader: Iterable[Dict[str, Any]],
                 output_path: str, use_tta: bool = False,
                 post_kwargs: Optional[Dict[str, Any]] = None) -> List[float]:
        """Segment every case of ``loader`` into NIfTI label maps under
        ``output_path``; returns the per-case seconds."""
        post_kwargs = post_kwargs or {}
        times = []
        for batch in loader:
            t0 = time.time()
            padded, p_b, p_a = self._pad_case(batch["img"][0], use_tta)
            img = torch.from_numpy(padded.astype(np.float16)).to(self.device)[None]
            probs = None
            for model in members:
                p = self.member_probs(model, img, use_tta)
                probs = p if probs is None else probs + p
            fused = post_process(probs / len(members), **post_kwargs)
            # background masking (engine.py:259)
            brain = (img != 0).any(dim=-1, keepdim=True)
            fused_np = (fused * brain.to(fused.dtype)).cpu().numpy()
            case_dir = output_path
            if getattr(self.cfg, "create_patient_dir", False):
                case_dir = os.path.join(output_path, batch["patient_id"][0])
            self._save_segmentation(batch, fused_np[0], p_b, p_a, case_dir)
            times.append(time.time() - t0)
            logger.info("case %s: %.3fs", batch["patient_id"][0], times[-1])
        return times

    def _save_segmentation(self, batch: Dict[str, Any], fused: np.ndarray,
                           p_b: np.ndarray, p_a: np.ndarray,
                           output_path: str) -> None:
        """shape_to_original → BraTS labels → pad_back → NIfTI uint8
        (engine.py:281-294, files.py:233-253)."""
        out = T.shape_to_original(fused, p_b, p_a)
        labels = T.change_label_3_to_4(T.multichannel_to_brats_labels(out))
        labels = T.pad_back_to_shape_before_compose(
            labels, np.asarray(batch["foreground_start_coord"][0]),
            np.asarray(batch["foreground_end_coord"][0]),
            np.asarray(batch["original_shape"][0]))
        pid = batch["patient_id"][0]
        os.makedirs(output_path, exist_ok=True)
        fname = f"{pid}.nii.gz"
        affine = np.asarray(batch.get("affine"))
        if affine.ndim == 3:
            affine = affine[0]
        write_nifti(os.path.join(output_path, fname), labels.astype(np.uint8), affine)
        logger.debug("saved segmentation %s", fname)
