"""Training epochs, and the pipelined evaluation: ensemble × TTA × sliding
windows → post-process or STAPLE → metrics, report and NIfTI.

``Engine.train_epoch`` ports ``brats21_tpu/learning/engine.py:256-348``:
each batch crosses to the card as the JAX package's wire has it (fp16
images, uint8 targets, fp32 distance maps for the boundary criteria, from
pinned memory without blocking; ``BRATS21_TRAIN_WIRE=fp32`` sends images
and targets as they are) and is cast there; step i−1's metrics are read
only after step i is enqueued, so the card never waits on the host's read.

``Engine.evaluate`` ports the JAX package's pipelined ``evaluate``
(engine.py:52-195, 664-742, 803-1175) with and without a target. Three
host stages overlap the card:

* **prep** (:class:`_IterStage`, one thread, ``BRATS21_EVAL_PIPELINE``
  cases ahead of the card): pad each case to a multiple of the eval bucket
  (``--eval_bucket``, overridden by ``BRATS21_EVAL_BUCKET``; ``_pad_case``)
  and its target and distance map alike (``_pad_with``), and run the
  wire's host half (``_pack_case_host``): the fp16 cast of the dense wire,
  or the sparse wire's brain-mask bits and nonzero rows (``ops/wire.py``;
  ``--wire``, ``BRATS21_SPARSE_WIRE``, and for ``auto`` a probe of the
  link against ``BRATS21_WIRE_AUTO_MBPS``);
* **the main thread** enqueues a case (:meth:`Engine.eval_case`): the copy
  in (pinned, without blocking; the sparse wire unpacked on the card), each
  member — the plain forward, the 16-combo TTA mean, the sliding window, or
  sliding × TTA — with the fp32 sigmoid of its main head and, with a
  target, its loss; the members' mean post-processed, or each member
  post-processed and fused by STAPLE; the seal (zeroed outside the brain,
  bit-packed on the card on the sparse wire) and the copy out into pinned
  memory behind an event. Up to ``BRATS21_EVAL_PIPELINE`` cases (default
  2) are in flight: case N is collected (its event waited on, the bits
  unpacked on the host, its metrics taken: Dice on the card, HD95 on the
  host) after case N+1 is enqueued;
* **finish** (:class:`_SinkStage`, one ordered thread that only receives
  numpy): meters, report rows, progress, TensorBoard, and the un-padded,
  un-cropped labels written as NIfTI.

``BRATS21_EVAL_STAGES=0`` runs prep and finish inline on the caller's
thread. Every card launch stays on the main thread and its current stream
(B2's statistics kernel shares one ticket buffer a device). ``batch_time``
is the interval between collects, as in the JAX package (the save runs
behind it), ``data_time`` the wait for the prep stage.

While a profiler runs, the stages record spans (``utils/profiling.py``)
with the case's patient id: ``eval.wait_prep``, ``eval.case`` (holding
``eval.put``, ``eval.member``, post-processing's ``post.*`` and
``eval.seal``) and ``eval.collect`` on the main thread; ``finish.save`` on
the finish thread.

With several local ranks under ``torchrun`` (``parallel/mesh.py``) the
node's ranks share the evaluation as the JAX package's local mesh does
(engine.py:840-900): the TTA combos or the sliding windows of each case
are striped over them (``parallel/distributed.py``); a homogeneous STAPLE
ensemble's members are; and with none of TTA, sliding windows and STAPLE,
whole cases are, with the meters and the report rows merged over the
node's ranks afterwards. Each case is written once: by its rank when cases
are striped, else by local rank 0. Where the ranks share a case, every
rank enqueues the cases in one order on its main thread and collecting a
case issues no collective, so such a path keeps ``BRATS21_EVAL_PIPELINE``
cases in flight too.

On a data×space topology (``Topology.space > 1``; engine.py:410-429,
507-566, 852-860) plain evaluation — no TTA, sliding windows or STAPLE —
stripes the cases over the data axis and Z-shards each case's volume over
its space row (``parallel/distributed.py:spatial_sharded_forward``, every
``--model`` name, its slabs at the model's downsampling factor): every
rank of the row holds the replicated heads, the loss is taken on them and
one rank of the row counts and writes the case. ``_pad_case`` pads Z to a
multiple of the space size on the host, so the sharded forward sees the
volume the serial path would (nnunet still needs ``--eval_bucket 32``). TTA, sliding windows and STAPLE ignore the
space axis there, as the JAX engine does.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .. import get_logger
from ..config import check_eval_bucket
from ..data import transforms as T
from ..data.nifti import write_nifti
from ..ops import wire
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
from ..utils.profiling import annotate
from ..utils.reporting import EvaluationReport, TensorBoardLogger
from .losses import LossFn, deep_supervision_loss
from .train_state import TrainState, TrainStep, swa_update

logger = get_logger("engine")

#: per-process cache of the measured host link bandwidth (wire="auto"), by device
_WIRE_PROBE_MBPS: Dict[str, float] = {}
#: seconds a stage's queue wait lasts before it re-checks its closed flag
_POLL_S = 0.5
#: seconds ``evaluate`` waits, on its way out, for a closed stage's thread
_STAGE_JOIN_S = 60.0
_STAGE_SENTINEL = object()


def _close_source(src: Any) -> None:
    close = getattr(src, "close", None)
    if close is not None:
        close()


class _IterStage:
    """One background thread mapping ``fn`` over ``src_iter`` through a
    bounded queue, in order: the evaluation's prep stage runs ahead of the
    card (JAX engine.py:52-97). An error in the source or in ``fn``
    re-raises in the consumer; a consumer that stops early releases the
    producer with :meth:`close`, and the producer then closes the source.
    Every queue wait lasts at most ``_POLL_S`` and re-checks the closed
    flag."""

    def __init__(self, src_iter: Iterator, fn: Callable[[Any], Any], depth: int = 2,
                 name: str = "eval-prep"):
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=max(depth, 1))
        self._err: Optional[BaseException] = None
        self._closed = threading.Event()

        def _put(item) -> bool:
            while not self._closed.is_set():
                try:
                    self._q.put(item, timeout=_POLL_S)
                    return True
                except queue.Full:
                    continue
            return False

        def run():
            try:
                for item in src_iter:
                    if not _put(fn(item)):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
                self._err = e
            finally:
                _close_source(src_iter)
                _put(_STAGE_SENTINEL)

        self._t = threading.Thread(target=run, name=name, daemon=True)
        self._t.start()

    def close(self) -> None:
        self._closed.set()

    def wait(self, timeout: float) -> bool:
        """Wait at most ``timeout`` s for the thread; whether it ended."""
        self._t.join(timeout)
        return not self._t.is_alive()

    def __del__(self):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                item = self._q.get(timeout=_POLL_S)
            except queue.Empty:
                # a closed stage, or a producer gone without its sentinel
                if (self._closed.is_set() or not self._t.is_alive()) and self._q.empty():
                    item = _STAGE_SENTINEL
                else:
                    continue
            if item is _STAGE_SENTINEL:
                self.close()
                if self._err is not None:
                    raise self._err
                raise StopIteration
            return item


class _InlineIter:
    """Thread-free stand-in for :class:`_IterStage`
    (``BRATS21_EVAL_STAGES=0``): maps on the caller's thread."""

    def __init__(self, src_iter: Iterator, fn: Callable[[Any], Any]):
        self._it, self._fn = src_iter, fn

    def close(self) -> None:
        _close_source(self._it)

    def wait(self, timeout: float) -> bool:
        return True

    def __iter__(self):
        return self

    def __next__(self):
        return self._fn(next(self._it))


class _InlineSink:
    """Thread-free stand-in for :class:`_SinkStage`."""

    def __init__(self, fn: Callable[..., None]):
        self._fn = fn

    def submit(self, *args) -> None:
        self._fn(*args)

    def close(self) -> None:
        pass

    def join(self) -> None:
        pass

    def wait(self, timeout: float) -> bool:
        return True


class _SinkStage:
    """One background thread running ``fn(*args)`` for each submission, in
    submission order: the evaluation's finish stage (meters, report rows,
    the NIfTI save) runs behind the card (JAX engine.py:131-195). An error
    re-raises on the next :meth:`submit` or at :meth:`join`; ``submit``
    after :meth:`close` raises rather than drop the work. Every queue wait
    lasts at most ``_POLL_S`` and re-checks the closed flag."""

    def __init__(self, fn: Callable[..., None], depth: int = 4, name: str = "eval-finish"):
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=max(depth, 1))
        self._err: Optional[BaseException] = None
        self._closed = threading.Event()

        def run():
            while not self._closed.is_set():
                try:
                    item = self._q.get(timeout=_POLL_S)
                except queue.Empty:
                    continue
                if item is _STAGE_SENTINEL:
                    return
                if self._err is not None:
                    continue        # drain what is left after an error
                try:
                    fn(*item)
                except BaseException as e:  # noqa: BLE001 — re-raised in the caller
                    self._err = e

        self._t = threading.Thread(target=run, name=name, daemon=True)
        self._t.start()

    def submit(self, *args) -> None:
        while not self._closed.is_set():
            if self._err is not None:
                raise self._err
            try:
                self._q.put(args, timeout=_POLL_S)
                return
            except queue.Full:
                continue
        # a closed sink's thread never runs this item: dropping it silently
        # could lose a NIfTI save on an error path
        raise RuntimeError("_SinkStage.submit() after close(): work dropped")

    def close(self) -> None:
        """Release the thread without draining (error paths)."""
        self._closed.set()

    def __del__(self):
        self.close()

    def join(self) -> None:
        """Run everything submitted, stop the thread, re-raise its error."""
        while self._t.is_alive():
            try:
                self._q.put(_STAGE_SENTINEL, timeout=_POLL_S)
                break
            except queue.Full:
                continue
        while self._t.is_alive():
            self._t.join(_POLL_S)
        if self._err is not None:
            raise self._err

    def wait(self, timeout: float) -> bool:
        """Wait at most ``timeout`` s for the thread (after :meth:`close`);
        whether it ended."""
        self._t.join(timeout)
        return not self._t.is_alive()


def probe_wire_bandwidth(device: torch.device) -> float:
    """Host → ``device`` MB/s of an 8 MB buffer: the median of five timed
    copies after one untimed warm-up, each ended by a tiny read back
    (JAX engine.py:196-220). Cached per device for the process."""
    device = torch.device(device)
    key = str(device)
    if key in _WIRE_PROBE_MBPS:
        return _WIRE_PROBE_MBPS[key]
    buf = torch.zeros(4 * 1024 * 1024, dtype=torch.float16)        # 8 MB
    samples = []
    for i in range(6):
        t0 = time.perf_counter()
        buf.to(device, copy=True)[:8].cpu()
        if i > 0:   # the first copy pays the warm-up
            samples.append(buf.nbytes / 1e6 / max(time.perf_counter() - t0, 1e-9))
    med = float(np.median(samples))
    _WIRE_PROBE_MBPS[key] = med
    return med


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
        self._wire_resolved: Optional[str] = None
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
        views in channels_last_3d memory, over the train wire
        (:meth:`_train_wire_img`, :meth:`_train_wire_seg`), targets cast to
        fp32 there, with the boundary criteria's (seg, distance_map) pair
        (engine.py:326-327)."""
        img = self.to_device(self._train_wire_img(batch["img"][part])).permute(0, 4, 1, 2, 3)
        target: Any = self.to_device(
            self._train_wire_seg(batch["seg"][part])).float().permute(0, 4, 1, 2, 3)
        if "boundary" in self.cfg.criterion:
            target = (target, self.to_device(
                batch["distance_map"][part]).permute(0, 4, 1, 2, 3))
        return img, target

    def _train_wire_img(self, arr: np.ndarray) -> np.ndarray:
        """Training images cross as fp16 under amp (the step casts to bf16;
        fp16 keeps 3 more mantissa bits), as they are under ``no_amp`` or
        ``BRATS21_TRAIN_WIRE=fp32`` (JAX engine.py:350-359)."""
        if self.cfg.no_amp or os.environ.get("BRATS21_TRAIN_WIRE") == "fp32":
            return arr
        return arr.astype(np.float16)

    def _train_wire_seg(self, arr: np.ndarray) -> np.ndarray:
        """Binary one-hot targets cross as uint8 (exact), as they are under
        ``BRATS21_TRAIN_WIRE=fp32`` (JAX engine.py:361-366)."""
        if os.environ.get("BRATS21_TRAIN_WIRE") == "fp32":
            return arr
        return arr.astype(np.uint8)

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
        with annotate("eval.member"):
            cfg = self.cfg
            x = img.to(torch.float32 if cfg.no_amp else torch.bfloat16)
            criterion = self.criterion if target is not None else None
            if target is not None and criterion is None:
                raise ValueError("evaluation with a target needs the engine's criterion")
            if spatial:
                out = spatial_sharded_forward(model, x, self.topo,
                                              full_outputs=target is not None,
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

    # ------------------------------------------------------------------ wire

    def _resolve_wire(self) -> str:
        """'sparse' or 'dense', resolved once per engine (JAX
        engine.py:664-686) from, in order, ``BRATS21_SPARSE_WIRE``,
        ``cfg.wire``, and for ``auto`` a probe of the host link against
        ``BRATS21_WIRE_AUTO_MBPS`` (default 500 MB/s): slower links take
        the sparse wire; the decision logged with its source (and for
        ``auto`` the measured MB/s)."""
        if self._wire_resolved is not None:
            return self._wire_resolved
        env = os.environ.get("BRATS21_SPARSE_WIRE")
        if env is not None:
            mode = "dense" if env in ("0", "false", "False") else "sparse"
            why = f"BRATS21_SPARSE_WIRE={env}"
        else:
            mode = getattr(self.cfg, "wire", "auto")
            why = f"--wire {mode}"
            if mode == "auto":
                mbps = probe_wire_bandwidth(self.device)
                thresh = float(os.environ.get("BRATS21_WIRE_AUTO_MBPS", "500"))
                mode = "sparse" if mbps < thresh else "dense"
                why = f"--wire auto: link {mbps:.1f} MB/s against {thresh:.0f}"
        logger.info("wire: %s (%s)", mode, why)
        self._wire_resolved = mode
        return mode

    def _pack_case_host(self, padded: np.ndarray) -> Tuple:
        """The host half of :meth:`_put_case`, pure numpy (the prep stage
        runs it): the dense wire's fp16 cast, or the sparse wire's packed
        mask and nonzero fp16 rows."""
        if self._resolve_wire() == "dense":
            return ("dense", padded.astype(np.float16))
        return ("sparse", *wire.pack_volume(padded.astype(np.float16)))

    def _put_case(self, shape: Tuple[int, ...], payload: Tuple) -> torch.Tensor:
        """A case's fp16 [1, X, Y, Z, C] on the card from its wire payload:
        the dense copy, or the sparse format unpacked on the card, exact.
        Span ``eval.put``."""
        with annotate("eval.put"):
            if payload[0] == "dense":
                return self.to_device(payload[1])[None]
            _, bits, vals = payload
            return wire.unpack_volume_device(self.to_device(bits), self.to_device(vals),
                                             tuple(shape[:3]))

    @staticmethod
    def _seal(fused: torch.Tensor, img: torch.Tensor, pack: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the fused prediction zeroed outside the brain (engine.py:259),
        what crosses to the host): the masked prediction, or on the sparse
        wire its bits packed on the card (32× fewer bytes than fp32; exact,
        the prediction being binary)."""
        brain = (img != 0).any(dim=-1, keepdim=True)
        out = fused * brain.to(fused.dtype)
        return out, (wire.pack_bits_device(out) if pack else out)

    @staticmethod
    def _copy_out(t: torch.Tensor) -> torch.Tensor:
        """``t`` in host memory without blocking: on a card a pinned tensor
        that holds it once the stream has passed the copy (CPU tensors as
        they are)."""
        if t.device.type != "cuda":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t, non_blocking=True)

    # --------------------------------------------------------------- evaluate

    def _eval_bucket(self) -> int:
        """The eval pad: ``BRATS21_EVAL_BUCKET``, else ``cfg.eval_bucket``
        (JAX engine.py:834-846), a multiple of 8."""
        return check_eval_bucket(int(os.environ.get("BRATS21_EVAL_BUCKET", "0"))
                                 or int(getattr(self.cfg, "eval_bucket", 8) or 8))

    def prep_case(self, batch: Dict[str, Any], use_tta: bool = False,
                  bucket: int = 8) -> Dict[str, Any]:
        """A decoded case for :meth:`eval_case`, on the host (the prep
        stage): the image padded to ``bucket`` (and Z to the space size) in
        its wire's payload, the target and distance map padded alike, the
        pads."""
        padded, p_b, p_a = self._pad_case(batch["img"][0], use_tta, bucket,
                                          z_multiple=self.topo.space)
        seg = batch.get("seg")
        tgt = self._pad_with(seg[0], p_b, p_a) if seg is not None else None
        dm = None
        if seg is not None and "boundary" in self.cfg.criterion and "distance_map" in batch:
            dm = self._pad_with(batch["distance_map"][0], p_b, p_a)
        return dict(batch=batch, shape=padded.shape, p_b=p_b, p_a=p_a, tgt_padded=tgt, dm=dm,
                    wire=self._pack_case_host(padded))

    def eval_case(self, members: List[nn.Module], case: Dict[str, Any],
                  use_tta: bool = False, sliding: bool = False,
                  perform_staple: bool = False, staple_threshold: float = 0.5,
                  post_kwargs: Optional[Dict[str, Any]] = None,
                  local: Optional[LocalGroup] = None,
                  member_stripe: bool = False, spatial: bool = False) -> Dict[str, Any]:
        """Enqueue one prepped case (:meth:`prep_case`) through every
        member, without waiting for the card (JAX ``dispatch``,
        engine.py:1010-1067): the copy in, the members, the fusion, the
        seal and the copy out. Returns the fused, brain-masked prediction
        [1, X, Y, Z, 3] and the padded channels-last target (None without a
        seg) on the card, and for :meth:`_collect` the copies in host
        memory (the sealed prediction, the members' summed loss) and the
        event after them. With ``local`` every rank of the node calls it
        for the case: each member's TTA combos or windows are striped over
        the ranks, or with ``member_stripe`` the members themselves
        (``engine.py:866-894``). With ``spatial`` each member's forward is
        Z-sharded over this rank's space row. The ops' own host reads
        (connected components' convergence test, STAPLE's EM) still wait
        for the card here. Spans: ``eval.case`` around it all, ``eval.seal``
        around the seal and the copies out."""
        post_kwargs = post_kwargs or {}
        with annotate("eval.case", case=case["batch"]["patient_id"][0]):
            img = self._put_case(case["shape"], case["wire"])
            target = target_cl = None
            if case["tgt_padded"] is not None:
                target_cl = self.to_device(case["tgt_padded"])[None].float()
                target = target_cl.permute(0, 4, 1, 2, 3)
                if case["dm"] is not None:
                    target = (target, self.to_device(case["dm"])[None].permute(0, 4, 1, 2, 3))
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
            probs_sum, loss_sum, posts = None, None, []
            for probs, loss in per_member:
                loss_sum = loss if loss_sum is None else loss_sum + loss
                if perform_staple:
                    posts.append(post_process(probs, **post_kwargs))
                else:
                    probs_sum = probs if probs_sum is None else probs_sum + probs
            if perform_staple:
                fused = staple_multichannel(torch.stack(posts), threshold_value=staple_threshold)
            else:
                fused = post_process(probs_sum / len(members), **post_kwargs)
            with annotate("eval.seal"):
                fused, sealed = self._seal(fused, img, self._resolve_wire() == "sparse")
                entry = dict(case=case, fused=fused, target=target_cl,
                             sealed=self._copy_out(sealed),
                             loss=self._copy_out(loss_sum) if target is not None else None,
                             ready=None)
            if self.device.type == "cuda":
                entry["ready"] = torch.cuda.Event()
                entry["ready"].record(torch.cuda.current_stream(self.device))
            return entry

    def _collect(self, entry: Dict[str, Any], n_members: int
                 ) -> Tuple[np.ndarray, Optional[float]]:
        """(the fused prediction as host numpy, the members' mean loss or
        None) of an enqueued case, once its copies have landed. Span
        ``eval.collect``."""
        with annotate("eval.collect", case=entry["case"]["batch"]["patient_id"][0]):
            if entry["ready"] is not None:
                entry["ready"].synchronize()
            sealed = entry["sealed"].numpy()
            fused_np = (wire.unpack_bits(sealed, tuple(entry["fused"].shape))
                        if sealed.dtype == np.uint8 else sealed)
            loss = entry["loss"]
            return fused_np, (float(loss) / n_members if loss is not None else None)

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
        (engine.py:163-296), pipelined as the module docstring says: prep
        ahead in a thread, up to ``BRATS21_EVAL_PIPELINE`` cases on the
        card, finish behind in an ordered thread (``BRATS21_EVAL_STAGES=0``:
        both inline). Cases with a seg update the loss and metric meters
        and ``report``; with ``save_seg`` every case's labels go to
        ``output_path``. Returns the meters; ``batch_time`` holds the
        seconds between collects, one entry a case. An error in any stage
        raises here, and no stage thread outlives the call. With several
        local ranks (``topo``) every rank of the node calls it with the
        same loader, shares the work (:meth:`_parallel_mode`) and returns
        the node's meters and rows."""
        cfg = self.cfg
        metrics_wanted = self._wanted_metrics()
        meters = self.empty_eval_meters()
        losses, batch_time, data_time = meters["loss"], meters["batch_time"], meters["data_time"]
        metric_meters = {m: meters[m] for m in metrics_wanted}
        bucket = self._eval_bucket()
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
        depth = max(int(os.environ.get("BRATS21_EVAL_PIPELINE", "2")), 1)
        use_stages = os.environ.get("BRATS21_EVAL_STAGES", "1") != "0"
        self._resolve_wire()        # here: its probe touches the card
        progress = ProgressMeter(len(loader), [batch_time, data_time, losses,
                                               *metric_meters.values()],
                                 prefix=f"Epoch Valid: [{epoch}]")
        n_cases = len(loader)
        done = 0

        def prep(batch: Dict[str, Any]) -> Dict[str, Any]:
            return self.prep_case(batch, use_tta, bucket)

        def finish_case(case: Dict[str, Any], fused_np: np.ndarray, loss: Optional[float],
                        case_metrics: Optional[Dict[str, np.ndarray]], elapsed: float) -> None:
            """Meters, report row, progress and the save: host numpy only
            (the finish stage's thread never touches the card)."""
            nonlocal done
            done += 1
            self.val_step += 1
            batch = case["batch"]
            pid = batch["patient_id"][0]
            if case_metrics is not None:
                losses.update(loss)
                for name, meter in metric_meters.items():
                    meter.update(np.asarray(case_metrics[name.title()]).ravel())
                if report is not None:
                    report.add(pid, case_metrics)
            batch_time.update(elapsed)
            logger.info("case %s: %.3fs", pid, elapsed)
            if done % cfg.log_val_interval == 0 or done == n_cases:
                progress.display(done)
                self.tb.log_meters(self.val_step, [losses, *metric_meters.values()],
                                   step_mode=f"{step_mode}_step")
            if save_seg and writes:
                case_dir = output_path
                if getattr(cfg, "create_patient_dir", False):
                    case_dir = os.path.join(output_path, pid)
                self._save_segmentation(batch, fused_np[0], case["p_b"], case["p_a"],
                                        case_dir, suffix_seg_name)

        t_collect = time.time()

        def collect(entry: Dict[str, Any]) -> None:
            """Land one enqueued case, take its metrics on this thread
            (engine.py:905-914: on the padded prediction and target), and
            hand it to the finish stage."""
            nonlocal t_collect
            fused_np, loss = self._collect(entry, len(members))
            case_metrics = None
            if loss is not None and counts:
                case_metrics = compute_case_metrics(entry["fused"], entry["target"],
                                                    metrics_wanted)
            now = time.time()
            writer.submit(entry["case"], fused_np, loss, case_metrics, now - t_collect)
            t_collect = now

        writer = prep_stage = None
        try:
            writer = _SinkStage(finish_case) if use_stages else _InlineSink(finish_case)
            prep_stage = (_IterStage(iter(loader), prep, depth=depth) if use_stages
                          else _InlineIter(iter(loader), prep))
            inflight: List[Dict[str, Any]] = []
            while True:
                t_wait = time.time()
                try:
                    with annotate("eval.wait_prep"):
                        case = next(prep_stage)
                except StopIteration:
                    break
                data_time.update(time.time() - t_wait)
                inflight.append(self.eval_case(
                    members, case, use_tta, sliding, perform_staple, staple_threshold,
                    post_kwargs, local=local if collective else None,
                    member_stripe=member_stripe, spatial=spatial))
                while len(inflight) >= depth:
                    collect(inflight.pop(0))
            while inflight:
                collect(inflight.pop(0))
            writer.join()
        finally:
            for stage in (prep_stage, writer):
                if stage is not None:
                    stage.close()
            for stage, name in ((prep_stage, "prep"), (writer, "finish")):
                if stage is not None and not stage.wait(_STAGE_JOIN_S):
                    logger.warning("the eval %s stage's thread is still running %.0fs after "
                                   "it was closed", name, _STAGE_JOIN_S)
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
        (engine.py:1179-1197, files.py:233-253). Span ``finish.save``."""
        with annotate("finish.save", case=batch["patient_id"][0]):
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
