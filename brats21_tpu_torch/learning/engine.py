"""Training epochs, and serial single-device evaluation: ensemble × TTA ×
sliding windows → post-process or STAPLE → metrics, report and NIfTI.

``Engine.train_epoch`` ports ``brats21_tpu/learning/engine.py:256-348``:
each batch crosses to the card as the JAX package's wire has it (fp16
images, uint8 targets, fp32 distance maps for the boundary criteria, from
pinned memory without blocking) and is cast there; step i−1's metrics are
read only after step i is enqueued, so the card never waits on the host's
read.

``Engine.evaluate`` ports the serial branch of ``Engine.evaluate``
(engine.py:392-505, 753-1197) with and without a target: pad each case to
a multiple of ``--eval_bucket`` (``_pad_case``) and its target and
distance map alike (``_pad_with``), copy it to the card in fp16 as the JAX
package's dense wire does, run each member — the plain forward, the
16-combo TTA mean, the sliding window, or sliding × TTA — and take the
fp32 sigmoid of the main head; with a target, each member's loss too. The
members' probabilities are averaged and post-processed, or each member is
post-processed and STAPLE fuses them; the prediction is zeroed outside the
brain. With a target, the case's metrics are taken on the padded
prediction and target (Dice on the card, HD95 on the host), meters and the
report take them, and the labels are un-padded, un-cropped and written.
The loader decodes the next case in a background thread meanwhile; the
JAX package's finish-stage thread is not ported.

With several local ranks under ``torchrun`` (``parallel/mesh.py``) the
node's ranks share the evaluation as the JAX package's local mesh does
(engine.py:840-900): the TTA combos or the sliding windows of each case
are striped over them (``parallel/distributed.py``); a homogeneous STAPLE
ensemble's members are; and with none of TTA, sliding windows and STAPLE,
whole cases are, with the meters and the report rows merged over the
node's ranks afterwards. Each case is written once: by its rank when cases
are striped, else by local rank 0.

On a data×space topology (``Topology.space > 1``; engine.py:410-429,
507-566, 852-860) plain evaluation — no TTA, sliding windows or STAPLE —
stripes the cases over the data axis and Z-shards each case's volume over
its space row (``parallel/distributed.py:spatial_sharded_forward``): every
rank of the row holds the replicated heads, the loss is taken on them and
one rank of the row counts and writes the case. ``_pad_case`` pads Z to a
multiple of the space size on the host, so the sharded forward sees the
volume the serial path would. TTA, sliding windows and STAPLE ignore the
space axis there, as the JAX engine does.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .. import get_logger
from ..config import check_eval_bucket
from ..data import transforms as T
from ..data.nifti import write_nifti
from ..ops.postprocess import post_process
from ..ops.sliding_window import sliding_window_inference
from ..ops.staple import staple_multichannel
from ..ops.tta import main_head, tree_map, tta_mean_probs
from ..parallel import multihost
from ..parallel.distributed import (LocalGroup, gather_members, sharded_sliding_window,
                                    sharded_tta_probs, spatial_sharded_forward)
from ..parallel.mesh import Topology
from ..utils.meter import AverageMeter, ProgressMeter
from ..utils.metrics import compute_case_metrics
from ..utils.reporting import EvaluationReport, TensorBoardLogger
from .losses import LossFn, deep_supervision_loss
from .train_state import TrainState, TrainStep, swa_update

logger = get_logger("engine")


def forward_channels_last(model: nn.Module, x: torch.Tensor,
                          with_deep: bool = False) -> Any:
    """The model's output for a channels-last volume ``[B, X, Y, Z, C]``,
    each head as ``[B, X, Y, Z, classes]``: the main head's logits, or
    ``(logits, [deep3, deep2])`` with the deep heads."""
    xin = x.permute(0, 4, 1, 2, 3).contiguous(memory_format=torch.channels_last_3d)
    return tree_map(lambda t: t.permute(0, 2, 3, 4, 1), model(xin, with_deep=with_deep))


def _ncdhw(tree: Any) -> Any:
    return tree_map(lambda t: t.permute(0, 4, 1, 2, 3), tree)


class Engine:
    """Training and evaluation on one device. ``cfg`` carries ``no_amp``,
    ``num_classes``, ``create_patient_dir``, ``sliding_window_inference``,
    ``sliding_window_size``, ``eval_bucket``, ``key_metric``,
    ``additional_metrics``, ``log_val_interval`` and, for training,
    ``log_train_interval``, ``log_train_metrics`` and ``swa_start``.
    ``criterion`` gives evaluation with a target its loss; ``topo`` the
    node's local ranks that share each evaluation."""

    def __init__(self, cfg: Any, device: torch.device,
                 criterion: Optional[LossFn] = None,
                 tb: Optional[TensorBoardLogger] = None,
                 topo: Optional[Topology] = None):
        self.cfg = cfg
        self.device = device
        self.criterion = criterion
        self.tb = tb or TensorBoardLogger(None, enabled=False)
        self.topo = topo or Topology(device=device)
        self.global_step = 0
        self.val_step = 0
        # the batch index where the last train_epoch stopped early, or None
        self.last_epoch_stop: Optional[int] = None

    # ------------------------------------------------------------------ train

    def to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Host batch → the card: pinned, copied without blocking."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def batch_to_device(self, batch: Dict[str, Any], part: slice = slice(None)
                        ) -> Tuple[torch.Tensor, Any]:
        """(image, target) of a train batch's ``part`` on the card as NCDHW
        views in channels_last_3d memory: fp16 images (fp32 under
        ``no_amp``), uint8 targets cast to fp32 there, and the boundary
        criteria's (seg, distance_map) pair (engine.py:326-327)."""
        wire = np.float32 if self.cfg.no_amp else np.float16
        img = self.to_device(batch["img"][part].astype(wire)).permute(0, 4, 1, 2, 3)
        target: Any = self.to_device(
            batch["seg"][part].astype(np.uint8)).float().permute(0, 4, 1, 2, 3)
        if "boundary" in self.cfg.criterion:
            target = (target, self.to_device(
                batch["distance_map"][part]).permute(0, 4, 1, 2, 3))
        return img, target

    def train_epoch(self, state: TrainState, step: TrainStep, loader, epoch: int,
                    should_stop: Optional[Callable[[], bool]] = None,
                    start_batch: int = 0) -> Dict[str, AverageMeter]:
        """One epoch (engine.py:256-348): batch loop → train step → meters,
        then the SWA update past ``swa_start``.

        ``should_stop`` is polled before every batch (graceful preemption);
        when it turns true the epoch ends with the meters so far, the batch
        index stays in :attr:`last_epoch_stop` (None after a whole epoch)
        and the partial epoch adds nothing to the SWA average.
        ``start_batch`` resumes a preempted epoch: the loader's order for
        the epoch is the same, the first ``start_batch`` batches are not
        made, and each step's generator is keyed on ``global_step``, which
        the caller restores."""
        cfg = self.cfg
        self.last_epoch_stop = None
        loader.set_epoch(epoch, start_batch)
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
                self.tb.log_meters(self.global_step, [losses, gnorms],
                                   step_mode="train_step")

        t0 = time.time()
        for i, batch in enumerate(loader, start=start_batch):
            if should_stop is not None and should_stop():
                logger.info("train_epoch: stop requested at batch %d/%d", i, len(loader))
                self.last_epoch_stop = i
                break
            part = self._batch_part(batch["img"].shape[0])
            img, target = self.batch_to_device(batch, part)
            data_time.update(time.time() - t0)
            metrics = step(state, img, target, self.global_step,
                           sharded=self.topo.distributed and part != slice(None))
            self.global_step += 1
            if pending is not None:
                collect(pending)          # step i is already enqueued
            pending = (metrics, batch["img"].shape[0], i)
            t0 = time.time()
        if pending is not None:
            collect(pending)
        if self.topo.distributed:
            # the global batch's loss: the ranks' slices are equal, so the
            # mean over the ranks of their means
            multihost.merge_meters({"loss": losses}, dist.group.WORLD)
        self.tb.log_meters(epoch, [losses], step_mode="train_epoch")
        if cfg.swa_start and epoch > cfg.swa_start and self.last_epoch_stop is None:
            swa_update(state)
        return {"loss": losses, "grad_norm": gnorms, "batch_time": batch_time,
                "data_time": data_time}

    def _batch_part(self, n: int) -> slice:
        """This rank's slice of a node batch of ``n`` (all of it in a
        one-process run, or when ``n`` does not divide over the node's
        ranks: replicated, as the JAX package's ``_put_batch``, which a
        global batch across nodes must not be)."""
        if not self.topo.distributed:
            return slice(None)
        part = self.topo.shard_batch(n)
        if part is None:
            if self.topo.nodes > 1:
                raise ValueError(
                    f"a node batch of {n} does not divide over {self.topo.local_size} "
                    "local ranks: across nodes the global batch must shard; pick a "
                    "--batch_size divisible by the local rank count")
            return slice(None)
        return part

    # --------------------------------------------------------------- evaluate

    def _pad_case(self, img: np.ndarray, use_tta: bool, bucket: int = 8,
                  z_multiple: int = 1) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host-side pad of [X,Y,Z,C] to multiples of ``bucket`` (8, the
        model's downsampling factor, or a multiple of it; ceil-before /
        floor-after, transforms.py:483-512); TTA additionally requires
        X == Y (see ops/tta.py), padded at the end; Z is padded at its end
        to a multiple of ``z_multiple`` (the space size, engine.py:753-778),
        so the pad enters the global reductions as the ÷8 pad does."""
        padded, p_b, p_a = T.shape_to_divisible(img, k=bucket)
        if use_tta and padded.shape[0] != padded.shape[1]:
            side = max(padded.shape[0], padded.shape[1])
            extra = [(0, side - padded.shape[0]), (0, side - padded.shape[1]),
                     (0, 0), (0, 0)]
            padded = np.pad(padded, extra)
            p_a = p_a + np.array([extra[0][1], extra[1][1], 0])
        pad_z = (-padded.shape[2]) % z_multiple
        if pad_z:
            padded = np.pad(padded, [(0, 0), (0, 0), (0, pad_z), (0, 0)])
            p_a = p_a + np.array([0, 0, pad_z])
        return padded, p_b, p_a

    @staticmethod
    def _pad_with(arr: np.ndarray, p_b: np.ndarray, p_a: np.ndarray) -> np.ndarray:
        """The image's padding applied to an aligned array (the target and
        the distance map)."""
        pads = [(int(b), int(a)) for b, a in zip(p_b, p_a)]
        pads += [(0, 0)] * (arr.ndim - 3)
        return np.pad(arr, pads)

    def _wanted_metrics(self) -> List[str]:
        cfg = self.cfg
        return list(dict.fromkeys(
            list(cfg.key_metric) + [m for m in cfg.additional_metrics if m]))

    def member_probs(self, model: nn.Module, img: torch.Tensor, use_tta: bool = False,
                     sliding: bool = False, target: Any = None,
                     local: Optional[LocalGroup] = None, spatial: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(fp32 sigmoid probabilities [1, X, Y, Z, classes], loss) of one
        member (engine.py:431-498): plain, TTA, sliding window, or sliding
        × TTA. With a ``target`` (NCDHW, or the boundary criteria's pair)
        the loss is ``deep_supervision_loss`` of the member's output: with
        the deep heads for the plain and TTA forwards (:492-498), of the
        stitched main logits for the sliding window (:455-467); else 0.
        With ``local`` (the node's ranks, all calling) the sliding windows
        are striped over the ranks, else the TTA combos (engine.py:432-452).
        With ``spatial`` (every rank of the space row calling) the plain
        forward runs Z-sharded over the row, with every head when there is
        a target (engine.py:410-429)."""
        cfg = self.cfg
        x = img.to(torch.float32 if cfg.no_amp else torch.bfloat16)
        criterion = self.criterion if target is not None else None
        if target is not None and criterion is None:
            raise ValueError("evaluation with a target needs the engine's criterion")
        if spatial:
            out = spatial_sharded_forward(model, x, self.topo, full_outputs=target is not None,
                                          no_amp=cfg.no_amp)
            loss = (deep_supervision_loss(criterion, _ncdhw(out), target)
                    if criterion is not None
                    else torch.zeros((), dtype=torch.float32, device=x.device))
            return torch.sigmoid(main_head(out).float()), loss
        if sliding:
            roi = tuple(cfg.sliding_window_size)

            def predictor(w):
                return forward_channels_last(model, w)

            def apply(v):
                if local is not None:
                    return sharded_sliding_window(v, roi, predictor, local, cfg.num_classes)
                return sliding_window_inference(v, roi, predictor, sw_batch_size=2)
        else:
            def apply(v):
                return forward_channels_last(model, v, with_deep=target is not None)
        if use_tta and local is not None and not sliding:
            return sharded_tta_probs(apply, x, local, criterion=criterion, target=target,
                                     num_classes=cfg.num_classes)
        if use_tta:
            return tta_mean_probs(apply, x, criterion=criterion, target=target,
                                  num_classes=cfg.num_classes)
        out = apply(x)
        loss = (deep_supervision_loss(criterion, _ncdhw(out), target)
                if criterion is not None
                else torch.zeros((), dtype=torch.float32, device=x.device))
        return torch.sigmoid(main_head(out).float()), loss

    def eval_case(self, members: List[nn.Module], batch: Dict[str, Any],
                  use_tta: bool = False, sliding: bool = False,
                  perform_staple: bool = False, staple_threshold: float = 0.5,
                  post_kwargs: Optional[Dict[str, Any]] = None,
                  local: Optional[LocalGroup] = None,
                  member_stripe: bool = False, spatial: bool = False) -> Dict[str, Any]:
        """One case through every member: the fused, brain-masked
        prediction [1, X, Y, Z, 3] on the card, the padded channels-last
        target (None without a seg), the members' mean loss (None without a
        seg) and the pads. With ``local`` every rank of the node calls it
        for the case: each member's TTA combos or windows are striped over
        the ranks, or with ``member_stripe`` the members themselves
        (``engine.py:866-894``). With ``spatial`` each member's forward is
        Z-sharded over this rank's space row."""
        post_kwargs = post_kwargs or {}
        padded, p_b, p_a = self._pad_case(batch["img"][0], use_tta, self.cfg.eval_bucket,
                                          z_multiple=self.topo.space)
        img = torch.from_numpy(padded.astype(np.float16)).to(self.device)[None]
        seg = batch.get("seg")
        target = target_cl = None
        if seg is not None:
            target_cl = torch.from_numpy(self._pad_with(seg[0], p_b, p_a)).to(
                self.device)[None].float()
            target = target_cl.permute(0, 4, 1, 2, 3)
            if "boundary" in self.cfg.criterion and "distance_map" in batch:
                dm = torch.from_numpy(self._pad_with(batch["distance_map"][0], p_b, p_a))
                target = (target, dm.to(self.device)[None].permute(0, 4, 1, 2, 3))
        if member_stripe:
            group, rank, size = local
            mine = list(range(rank, len(members), size))
            results = [self.member_probs(members[m], img, use_tta, sliding, target)
                       for m in mine]
            shape = (1, *img.shape[1:4], self.cfg.num_classes)
            per_member = gather_members(len(members), mine, results, shape, self.device,
                                        local)
        else:
            per_member = (self.member_probs(model, img, use_tta, sliding, target, local,
                                            spatial)
                          for model in members)
        probs_sum, loss_sum, posts = None, 0.0, []
        for probs, loss in per_member:
            loss_sum = loss_sum + loss
            if perform_staple:
                posts.append(post_process(probs, **post_kwargs))
            else:
                probs_sum = probs if probs_sum is None else probs_sum + probs
        if perform_staple:
            fused = staple_multichannel(torch.stack(posts), threshold_value=staple_threshold)
        else:
            fused = post_process(probs_sum / len(members), **post_kwargs)
        # background masking (engine.py:259)
        brain = (img != 0).any(dim=-1, keepdim=True)
        return dict(fused=fused * brain.to(fused.dtype), target=target_cl,
                    loss=(float(loss_sum) / len(members) if seg is not None else None),
                    p_b=p_b, p_a=p_a)

    @torch.inference_mode()
    def evaluate(self, members: List[nn.Module], loader: Iterable[Dict[str, Any]],
                 epoch: int = 0, use_tta: bool = False, save_seg: bool = False,
                 output_path: Optional[str] = None,
                 suffix_seg_name: Optional[str] = None,
                 perform_staple: bool = False, staple_threshold: float = 0.5,
                 post_kwargs: Optional[Dict[str, Any]] = None,
                 report: Optional[EvaluationReport] = None,
                 step_mode: str = "val") -> Dict[str, AverageMeter]:
        """Ensemble × TTA × sliding-window evaluation over an EvalLoader
        (engine.py:163-296), case by case. Cases with a seg update the loss
        and metric meters and ``report``; with ``save_seg`` every case's
        labels go to ``output_path``. Returns the meters; ``batch_time``
        holds each case's seconds from the decoded case to its written
        NIfTI. With several local ranks (``topo``) every rank of the node
        calls it with the same loader, shares the work
        (:meth:`_parallel_mode`) and returns the node's meters and rows."""
        cfg = self.cfg
        metrics_wanted = self._wanted_metrics()
        meters = self.empty_eval_meters()
        losses, batch_time, data_time = meters["loss"], meters["batch_time"], meters["data_time"]
        metric_meters = {m: meters[m] for m in metrics_wanted}
        check_eval_bucket(cfg.eval_bucket)
        sliding = bool(getattr(cfg, "sliding_window_inference", False))
        if save_seg and not output_path:
            raise ValueError("if save_seg, output_path is needed")
        case_parallel, member_stripe = self._parallel_mode(members, use_tta, sliding,
                                                           perform_staple)
        spatial = self._spatial_mode(use_tta, sliding, member_stripe)
        topo = self.topo
        local = (topo.local_group, topo.local_rank, topo.local_size)
        if case_parallel:
            # each data index takes cases data_rank::data_size (its space
            # row together, each case Z-sharded over the row)
            loader = (loader.stripe(topo.data_rank, topo.data_size)
                      if hasattr(loader, "stripe") else
                      [b for i, b in enumerate(loader) if i % topo.data_size == topo.data_rank])
        collective = topo.local_size > 1 and not case_parallel
        # a space row's first rank alone counts its cases
        counts = not (case_parallel and spatial) or topo.space_rank == 0
        writes = counts and (not collective or topo.local_rank == 0)
        progress = ProgressMeter(len(loader), [batch_time, data_time, losses,
                                               *metric_meters.values()],
                                 prefix=f"Epoch Valid: [{epoch}]")
        n_cases = len(loader)
        t_wait = time.time()
        for done, batch in enumerate(loader, start=1):
            t0 = time.time()
            data_time.update(t0 - t_wait)
            pid = batch["patient_id"][0]
            case = self.eval_case(members, batch, use_tta, sliding,
                                  perform_staple, staple_threshold, post_kwargs,
                                  local=local if collective else None,
                                  member_stripe=member_stripe, spatial=spatial)
            if case["loss"] is not None and counts:
                losses.update(case["loss"])
                # metrics on the padded prediction and target (engine.py:905-914)
                case_metrics = compute_case_metrics(case["fused"], case["target"],
                                                    metrics_wanted)
                for name, meter in metric_meters.items():
                    meter.update(np.asarray(case_metrics[name.title()]).ravel())
                if report is not None:
                    report.add(pid, case_metrics)
            if save_seg and writes:
                case_dir = output_path
                if getattr(cfg, "create_patient_dir", False):
                    case_dir = os.path.join(output_path, pid)
                self._save_segmentation(batch, case["fused"][0].cpu().numpy(), case["p_b"],
                                        case["p_a"], case_dir, suffix_seg_name)
            batch_time.update(time.time() - t0)
            self.val_step += 1
            logger.info("case %s: %.3fs", pid, batch_time.val)
            if done % cfg.log_val_interval == 0 or done == n_cases:
                progress.display(done)
                self.tb.log_meters(self.val_step, [losses, *metric_meters.values()],
                                   step_mode=f"{step_mode}_step")
            t_wait = time.time()
        if case_parallel:
            # the node's meters and rows on every local rank (collectives)
            multihost.merge_meters(meters, topo.local_group)
            if report is not None:
                multihost.merge_report_rows(report, topo.local_group)
        self.tb.log_meters(epoch, [losses, *metric_meters.values()],
                           step_mode=f"{step_mode}_epoch")
        return meters

    def empty_eval_meters(self) -> Dict[str, AverageMeter]:
        """The meters :meth:`evaluate` returns, all at count 0: a node whose
        eval stripe is empty joins the cross-node merge with them (JAX
        ``engine.py:792``)."""
        return {"loss": AverageMeter("loss", ":.4e"),
                "batch_time": AverageMeter("time", ":6.3f"),
                "data_time": AverageMeter("data", ":6.3f"),
                **{m: AverageMeter(m, ":.4f") for m in self._wanted_metrics()}}

    def _parallel_mode(self, members: List[nn.Module], use_tta: bool, sliding: bool,
                       perform_staple: bool) -> Tuple[bool, bool]:
        """(case-parallel, member-striped) for the node's local ranks, each
        decision logged (engine.py:840-900). Without TTA, sliding windows
        and STAPLE the cases are striped, unless a member's outputs carry a
        leaf without the batch axis (SegResNetVAE's ``vae_loss``), as the
        JAX package's batched path cannot take them. A STAPLE ensemble
        without TTA and sliding windows stripes its members when they share
        one architecture and shapes, unless ``BRATS21_STAPLE_SERIAL`` is
        set."""
        n = self.topo.local_size
        if n <= 1:
            return False, False
        case_parallel = not use_tta and not sliding and not perform_staple
        if case_parallel and any(getattr(m, "unbatched_outputs", False) for m in members):
            logger.info("a member's outputs have a leaf without the batch axis: cases run "
                        "serially on the %d local ranks", n)
            case_parallel = False
        member_stripe = False
        if perform_staple and len(members) > 1:
            if use_tta or sliding:
                logger.info("STAPLE×%s: members run serially, the %d local ranks share %s "
                            "within each member", "TTA" if use_tta else "sliding-window", n,
                            "the 16 TTA combos" if use_tta else "the window grid")
            elif os.environ.get("BRATS21_STAPLE_SERIAL"):
                logger.info("BRATS21_STAPLE_SERIAL=1: STAPLE members run serially by request")
            elif not _homogeneous(members):
                logger.info("STAPLE ensemble mixes architectures/param shapes: member "
                            "striping needs a homogeneous stack — falling back to the "
                            "serial member loop")
            else:
                member_stripe = True
                if self.topo.nodes > 1:
                    logger.info("multi-node STAPLE: %d members stripe over the %d local "
                                "ranks of each node (cases already stripe across nodes)",
                                len(members), n)
                if len(members) > n:
                    logger.info("STAPLE: %d members > %d local ranks — each rank forwards "
                                "ceil(%d/%d) members in sequence", len(members), n,
                                len(members), n)
        return case_parallel, member_stripe

    def _spatial_mode(self, use_tta: bool, sliding: bool, member_stripe: bool) -> bool:
        """Whether each case's volume is Z-sharded over the space row: on
        a topology with ``space > 1``, for plain evaluation and serial
        STAPLE members, as the JAX engine's per-member eval function does
        (engine.py:410-429); TTA, sliding windows and a member-striped
        ensemble ignore the space axis there. Logged either way."""
        space = self.topo.space
        if space <= 1:
            return False
        if use_tta or sliding or member_stripe:
            logger.info("space axis of %d: %s use the %d local ranks as on a data-only "
                        "topology (the volume is not sharded)", space,
                        "TTA" if use_tta else "sliding windows" if sliding
                        else "STAPLE's striped members", self.topo.local_size)
            return False
        logger.info("each case's volume Z-sharded over a space row of %d ranks; cases "
                    "striped over the %d rows", space, self.topo.data_size)
        return True

    def _save_segmentation(self, batch: Dict[str, Any], fused: np.ndarray,
                           p_b: np.ndarray, p_a: np.ndarray, output_path: str,
                           suffix: Optional[str] = None) -> None:
        """shape_to_original → BraTS labels → pad_back → NIfTI uint8
        (engine.py:1179-1197, files.py:233-253)."""
        out = T.shape_to_original(fused, p_b, p_a)
        labels = T.change_label_3_to_4(T.multichannel_to_brats_labels(out))
        labels = T.pad_back_to_shape_before_compose(
            labels, np.asarray(batch["foreground_start_coord"][0]),
            np.asarray(batch["foreground_end_coord"][0]),
            np.asarray(batch["original_shape"][0]))
        pid = batch["patient_id"][0]
        os.makedirs(output_path, exist_ok=True)
        fname = f"{pid}_{suffix}.nii.gz" if suffix else f"{pid}.nii.gz"
        affine = np.asarray(batch.get("affine"))
        if affine.ndim == 3:
            affine = affine[0]
        write_nifti(os.path.join(output_path, fname), labels.astype(np.uint8), affine)
        logger.debug("saved segmentation %s", fname)


def _homogeneous(members: List[nn.Module]) -> bool:
    """Whether the members share one class and every parameter's shape."""
    first = members[0]
    shapes = {k: v.shape for k, v in first.state_dict().items()}
    return all(type(m) is type(first)
               and {k: v.shape for k, v in m.state_dict().items()} == shapes
               for m in members[1:])
