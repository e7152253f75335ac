"""Inference CLI — reference src/main_inference.py:24-96: load N run
directories (their ``config.yaml`` and checkpoint, or ``--import_pth``'s
reference ``.pth``) as an ensemble, segment every case of the test set
(``--on test``) or of the first config's val or train split (``--on
val|train``, scored against its segs into
``Evaluation_inference_{on}*.xlsx/.csv``), with TTA, sliding windows,
STAPLE and post-processing as asked, and write the NIfTI label maps.

    python -m brats21_tpu_torch.cli.main_inference --config run/config.yaml \\
        --on test --input cases/ --output out/ [--import_pth run/best_model.pth] \\
        [--tta] [--sliding_window_inference] [--perform_staple] \\
        [--cleaning_areas] [--replace_value] [--device cpu] \\
        [--watch --watch_interval S --watch_stop_file F --watch_warmup X Y Z]

Runs on ``cuda:<--device>``; ``--device cpu`` runs on the host with the
kernels' plain PyTorch versions. ``--watch --on test`` keeps serving the
cases that land in ``--input`` (:class:`WatchServer`).

Under ``torchrun`` (JAX ``main_inference.py:52-180``) the cases are
striped over the nodes; under ``--watch`` each case goes to the node
``crc32(patient_id) % nodes``, from one canonical first snapshot. Within a
node the local ranks share each case's TTA combos, windows or STAPLE
members, or take whole cases (``learning/engine.py``). The report rows
merge across nodes, and only the primary writes ``Evaluation*.xlsx``.

    torchrun --nproc_per_node 2 -m brats21_tpu_torch.cli.main_inference ...
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
import zlib
from typing import Dict, List, Optional, Sequence, Set

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .. import get_logger, set_main_logger
from ..config import TrainConfig
from ..data.discovery import MODALITIES
from ..data.nifti import read_nifti, write_nifti
from ..data.pipeline import (discover_test_records, make_records_loader,
                             make_train_val_loaders)
from ..learning.checkpoint import load_for_evaluation
from ..learning.engine import Engine
from ..learning.losses import make_criterion
from ..models import get_model
from ..ops import kernels
from ..parallel import multihost
from ..parallel.mesh import init_topology
from ..utils.meter import AverageMeter
from ..utils.reporting import EvaluationReport
from ..utils.weights import load_reference_pth
from .arguments import get_inference_args

logger = get_logger("main_inference")


def post_kwargs_from_cfg(cfg) -> dict:
    """get_post_transforms flags (definer.py:671-698; JAX
    cli/main_train.py:39)."""
    return dict(
        logit_thresh=getattr(cfg, "logit_threshold", 0.5),
        cleaning_areas=getattr(cfg, "cleaning_areas", False),
        cleaning_areas_threshold=getattr(cfg, "cleaning_areas_threshold", 10),
        replace_value=getattr(cfg, "replace_value", False),
        replace_value_threshold=getattr(cfg, "replace_value_threshold", 20),
    )


def load_member(ns: argparse.Namespace, device: torch.device) -> nn.Module:
    """The model of one merged config namespace with its weights
    (main_inference.py:62-69): ``--import_pth``'s, else its run directory's
    ``best_model.pth``; SWA runs serve the AveragedModel payload
    (``last_model.pth``'s, from a run directory), as the reference does."""
    model = get_model(ns)
    swa = bool(ns.swa_start)
    if ns.import_pth:
        state = load_reference_pth(ns.import_pth, prefer_swa=swa)
    else:
        state = load_for_evaluation(ns.model_dir, swa)
    model.load_state_dict(state)
    return model.to(device).eval()


def main(argv=None) -> Dict[str, AverageMeter]:
    """Run the CLI; returns the evaluation's meters (``batch_time`` holds
    the per-case seconds; empty under ``--watch``)."""
    total_start = time.time()
    config_dict, experience_name = get_inference_args(argv)
    members_ns = list(config_dict.values())
    cfg0 = members_ns[0]
    topo = init_topology(cfg0.device)
    device = topo.device
    if cfg0.save_path is None:
        raise ValueError("--output is needed")
    os.makedirs(cfg0.save_path, exist_ok=True)
    logger = set_main_logger(os.path.join(cfg0.save_path, "logfile_inference.log")
                             if topo.primary else None, verbosity=max(cfg0.verbosity, 1))
    logger.info("device: %s%s", device, f" ({torch.cuda.get_device_name(device)})"
                if device.type == "cuda" else "")
    if topo.distributed:
        logger.info("rank %d of %d (node %d of %d, local rank %d of %d), backend %s",
                    topo.rank, topo.world_size, topo.node, topo.nodes, topo.local_rank,
                    topo.local_size, topo.backend)

    # the first member's run config, with the inference flags (the
    # TrainConfig fields among them come through from_dict)
    cfg = TrainConfig.from_dict(vars(cfg0))
    cfg.create_patient_dir = cfg0.create_patient_dir
    watch = bool(cfg0.watch) and cfg0.on == "test"
    if cfg0.watch_warmup and not watch:
        logger.warning("--watch_warmup is only meaningful with --watch --on test "
                       "(got watch=%s, on=%s): ignoring it", cfg0.watch, cfg0.on)
    records = None
    if cfg0.on == "train":
        _, loader = make_train_val_loaders(cfg, device, train_in_val_mode=True)
    elif cfg0.on == "val":
        _, loader = make_train_val_loaders(cfg, device)
    else:
        # discovered before the initial pass, so that --watch serves the
        # cases landing during that pass at its first poll
        records = discover_test_records(cfg0)
        if topo.nodes > 1 and watch:
            # one canonical snapshot across nodes (a case landing during
            # discovery may show in one node's listing only), split by the
            # owner hash the polls use
            canonical: Dict[str, dict] = {}
            for recs in multihost.gather_objects(records):
                for r in recs:
                    canonical.setdefault(r["patient_id"], r)
            records = [canonical[k] for k in sorted(canonical)
                       if owner(k, topo.nodes) == topo.node]
        elif topo.nodes > 1:
            records = multihost.shard_eval_records(records)
        loader = make_records_loader(records, cfg0)
    # --watch may start on an empty folder; a node's stripe may be empty
    if not watch and not multihost.any_rank(loader is not None):
        raise ValueError(f"no case found for --on {cfg0.on}")
    members = [load_member(ns, device) for ns in members_ns]
    logger.info("ensemble of %d member(s)", len(members))

    engine = Engine(cfg, device, criterion=make_criterion(cfg), topo=topo)
    out_dir = os.path.join(cfg0.save_path, f"Inference_segmentations_{cfg0.on}")
    eval_kw = dict(use_tta=bool(cfg0.tta), perform_staple=bool(cfg0.perform_staple),
                   staple_threshold=cfg0.staple_threshold,
                   post_kwargs=post_kwargs_from_cfg(cfg0), step_mode=f"metric_{cfg0.on}")
    meters: Dict[str, AverageMeter] = {}
    if watch:
        WatchServer(engine, members, cfg0, out_dir, eval_kw).serve(records)
    else:
        with_target = cfg0.on in ("val", "train")
        name = f"Evaluation_inference_{cfg0.on}{experience_name}"
        report = EvaluationReport(autosave_dir=cfg0.save_path if topo.primary else None,
                                  name=name) if with_target else None
        if loader is not None:
            meters = engine.evaluate(members, loader, 0, save_seg=True, output_path=out_dir,
                                     report=report, **eval_kw)
        else:
            meters = engine.empty_eval_meters()
        if report is not None:
            multihost.merge_meters(meters)
            multihost.merge_report_rows(report)
            if topo.primary:
                report.save(cfg0.save_path)
    logger.info("total time: %.1fs", time.time() - total_start)
    return meters


class WatchServer:
    """``--watch`` serving (JAX ``cli/main_inference.py:170-358``, one
    process): segment the cases on disk, then poll ``--input`` every
    ``--watch_interval`` seconds and segment each complete case that lands
    (cases must land atomically: written elsewhere, renamed in), until
    ``--watch_stop_file`` appears or the process is interrupted.

    A poll's cases are segmented as one batch; when it fails, case by case,
    so that one corrupt upload cannot sink its siblings. A failing case is
    charged an attempt only when it is plausibly its own fault (its files
    fail to decode, or a sibling succeeded in the same poll), and after
    ``BRATS21_WATCH_MAX_ATTEMPTS`` attempts (default 3) it is quarantined
    for good.

    Across nodes each node serves the cases it owns (:func:`owner`); a
    node's local ranks share each case, so its local rank 0 polls and
    decides when to stop, and the others follow its word."""

    def __init__(self, engine: Engine, members: List[nn.Module],
                 cfg0: argparse.Namespace, out_dir: str, eval_kw: dict):
        self.engine, self.members, self.cfg0 = engine, members, cfg0
        self.out_dir, self.eval_kw = out_dir, eval_kw
        self.seen: Set[str] = set()          # segmented, or quarantined for good
        self.attempts: Dict[str, int] = {}
        self.max_attempts = int(os.environ.get("BRATS21_WATCH_MAX_ATTEMPTS", "3"))

    def agree(self, obj):
        """Local rank 0's ``obj`` on every local rank of the node."""
        topo = self.engine.topo
        if topo.local_group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=topo.node * topo.local_size,
                                   group=topo.local_group)
        return box[0]

    def segment(self, records: List[dict], save_seg: bool = True) -> None:
        self.engine.evaluate(self.members, make_records_loader(records, self.cfg0), 0,
                             save_seg=save_seg, output_path=self.out_dir, **self.eval_kw)

    def seg_saved(self, rec: dict) -> bool:
        pid = rec["patient_id"]
        d = (os.path.join(self.out_dir, pid) if self.cfg0.create_patient_dir
             else self.out_dir)
        return os.path.exists(os.path.join(d, f"{pid}.nii.gz"))

    def mark_done(self, rec: dict) -> None:
        self.seen.add(rec["patient_id"])
        self.attempts.pop(rec["patient_id"], None)

    def quarantine(self, rec: dict, infra_healthy: bool) -> None:
        pid = rec["patient_id"]
        if not infra_healthy and decodes_cleanly(rec):
            # no sibling got through and the files decode: an outage of the
            # card or the mount, not the case; it must not use up attempts
            logger.warning("watch: case %s failed but decodes cleanly and no sibling "
                           "case succeeded: retrying next poll (no attempt charged)", pid)
            return
        self.attempts[pid] = self.attempts.get(pid, 0) + 1
        if self.attempts[pid] >= self.max_attempts:
            self.seen.add(pid)
            logger.error("watch: case %s failed %d/%d attempts: permanently quarantined "
                         "(not segmented)", pid, self.attempts[pid], self.max_attempts)
        else:
            logger.warning("watch: case %s failed (attempt %d/%d): will retry next poll",
                           pid, self.attempts[pid], self.max_attempts)

    def segment_batch(self, records: List[dict]) -> None:
        """The batch first; on failure, case by case."""
        t0 = time.time()
        try:
            self.segment(records)
            for rec in records:
                self.mark_done(rec)
            logger.info("watch: segmented %d case(s) in %.2fs", len(records),
                        time.time() - t0)
            return
        except Exception:  # noqa: BLE001 — isolate the poison case
            logger.exception("watch: batch of %d case(s) failed: isolating per case",
                             len(records))
        failures, infra_healthy = [], False
        for rec in records:
            if self.seg_saved(rec):
                # the failed batch, or an earlier server, saved it already
                logger.info("watch: case %s already segmented on disk: skipping",
                            rec["patient_id"])
                self.mark_done(rec)
                continue
            try:
                self.segment([rec])
                self.mark_done(rec)
                infra_healthy = True
            except Exception:  # noqa: BLE001 — charged below
                failures.append(rec)
        for rec in failures:
            self.quarantine(rec, infra_healthy)

    def warm_up(self, shape: Sequence[int]) -> None:
        """Build the kernels and launch each once (outside the ``try``: a
        build or launch failure stops the server, since every case would
        fail the same way), then run one synthetic four-modality case of
        the cropped ``shape`` through the whole evaluation, unsaved: the
        loader's native library build and cuDNN's first-use work happen
        before the first real case. A failure there is logged and serving
        goes on."""
        t0 = time.time()
        if self.engine.device.type == "cuda":
            kernels.warm_up(self.engine.device)
        wdir = tempfile.mkdtemp(prefix="brats21_watch_warmup_")
        try:
            pid = "BraTSWarmup_00000"
            os.makedirs(os.path.join(wdir, pid))
            # nonzero everywhere: the foreground crop is the identity, so
            # the case is padded as a real case of this cropped shape is
            vol = np.random.default_rng(0).normal(1000.0, 50.0, size=tuple(shape))
            paths = []
            for mod in MODALITIES:
                paths.append(os.path.join(wdir, pid, f"{pid}_{mod}.nii.gz"))
                write_nifti(paths[-1], vol.astype(np.float32), np.eye(4))
            self.segment([{"patient_id": pid, "img": paths}], save_seg=False)
            logger.info("watch: warm-up for cropped shape %s done in %.2fs",
                        tuple(shape), time.time() - t0)
        except Exception:  # noqa: BLE001 — a warm-up failure must not stop serving
            logger.exception("watch: warm-up failed: serving anyway")
        finally:
            shutil.rmtree(wdir, ignore_errors=True)

    def serve(self, records: Optional[List[dict]]) -> None:
        """Warm up (``--watch_warmup``), segment ``records`` (the initial
        snapshot, through the same isolation as a poll's), then poll."""
        cfg0 = self.cfg0
        if cfg0.watch_warmup:
            self.warm_up(cfg0.watch_warmup)
        if records:
            self.segment_batch(records)
        logger.info("watch mode: serving %s every %.1fs (%d case(s) done)",
                    cfg0.test_data_path, cfg0.watch_interval, len(self.seen))
        stop_file = cfg0.watch_stop_file
        topo = self.engine.topo
        try:
            while not self.agree(bool(stop_file and os.path.exists(stop_file))):
                time.sleep(cfg0.watch_interval)
                try:
                    new = [r for r in discover_test_records(cfg0)
                           if r["patient_id"] not in self.seen
                           and owner(r["patient_id"], topo.nodes) == topo.node]
                    new = self.agree(new)
                    if new:
                        self.segment_batch(new)
                except Exception:  # noqa: BLE001 — the server outlives a failed poll
                    logger.exception("watch: poll failed: retrying next interval")
        except KeyboardInterrupt:
            logger.info("watch mode interrupted; exiting")


def decodes_cleanly(rec: dict) -> bool:
    """Whether every modality file of ``rec`` decodes on the host."""
    try:
        for path in rec["img"]:
            read_nifti(path)
        return True
    except Exception:  # noqa: BLE001 — any decode error means a bad case
        return False



def owner(patient_id: str, nodes: int) -> int:
    """The node that serves a case under ``--watch`` across nodes: a
    stable hash, since the nodes' polls see a new case at different times
    and index striping would give it to none or two."""
    return zlib.crc32(patient_id.encode()) % nodes


if __name__ == "__main__":
    main()
    multihost.shutdown()
