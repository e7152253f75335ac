"""Datasets and prefetching loaders feeding the card.

``brats21_tpu/data/pipeline.py`` without JAX: NIfTI decode, numpy
preprocessing and the train augmentations run in background threads while
the card computes the previous step or case; batches are numpy arrays that
the engine copies to the device. The boundary criteria's distance maps are
made on the run's device. A case decodes through the native C++ loader
(``data/native.py``) and falls back to the numpy path without it. The split
follows definer.py:583-628 (KFold(5, shuffle, seed)). Multi-host striping
comes with a later slice.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import get_logger
from .discovery import (MODALITIES, MODALITIES_WITH_SEG, create_database,
                        create_database_test_docker, kfold_split,
                        make_file_records)
from . import native
from .nifti import read_nifti
from .transforms import (augment_train_sample, brats_labels_to_multichannel,
                         compute_distance_map_fn, preprocess_case)

logger = get_logger("data")


def load_case(record: Dict[str, Any]) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """Load 4 modality volumes + optional seg → ([X,Y,Z,4], [X,Y,Z]?, affine)."""
    vols = []
    affine = None
    for path in record["img"]:
        img = read_nifti(path)
        vols.append(np.asarray(img.data, np.float32))
        affine = img.affine if affine is None else affine
    img4 = np.stack(vols, axis=-1)
    seg = None
    if "seg" in record:
        seg = np.asarray(read_nifti(record["seg"]).data)
    return img4, seg, affine


class BraTSDataset:
    """Lazy per-case dataset: record → preprocessed sample dict, on the
    native loader's path, else (and always with ``already_preprocess``) on
    the numpy path, as the JAX package's dataset. Eval datasets normalize
    at load; train datasets load raw (``normalize=False``) and the loader
    normalizes after the augmentations (definer.py:458-468). With
    ``compute_distance_map`` (the boundary criteria's eval datasets) each
    sample carries the seg's distance map, made on ``device``, which it
    then needs."""

    def __init__(self, records: List[Dict[str, Any]], *,
                 with_seg: bool, remove_outliers: bool = False,
                 crop: bool = True, already_preprocess: bool = False,
                 normalize: bool = True, compute_distance_map: bool = False,
                 device: Any = None):
        if compute_distance_map and device is None:
            raise ValueError("compute_distance_map needs a device for the EDT")
        self.records = records
        self.with_seg = with_seg
        self.remove_outliers = remove_outliers
        self.crop = crop and not already_preprocess
        self.already_preprocess = already_preprocess
        self.normalize = normalize and not already_preprocess
        self.compute_distance_map = compute_distance_map
        self.device = device

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        record = self.records[idx]
        sample = None
        if not self.already_preprocess:
            sample = self._getitem_native(record)
            native.count(sample is not None)
        if sample is None:
            sample = self._getitem_numpy(record)
        sample["patient_id"] = record["patient_id"]
        return sample

    def _getitem_numpy(self, record: Dict[str, Any]) -> Dict[str, Any]:
        img, seg, affine = load_case(record)
        if not self.with_seg:
            seg = None
        dm = dict(compute_distance_map=self.compute_distance_map, device=self.device)
        if self.already_preprocess:
            # skip crop+normalize (definer.py:476-479)
            sample = preprocess_case(img, seg, crop=False, normalize=False, **dm)
        else:
            sample = preprocess_case(img, seg, remove_outliers=self.remove_outliers,
                                     crop=self.crop, normalize=self.normalize, **dm)
        sample["affine"] = affine
        return sample

    def _getitem_native(self, record: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """The C++ path (``csrc/nifti_native.cc``): decode, crop and
        normalise in one call; the seg stays on numpy, cropped to the
        library's bounding box. None when the library is unavailable or
        the load fails."""
        sample = native.load_case_native(record["img"], crop=self.crop,
                                         normalize=self.normalize,
                                         remove_outliers=self.remove_outliers)
        if sample is None or not (self.with_seg and "seg" in record):
            return sample
        start, end = sample["foreground_start_coord"], sample["foreground_end_coord"]
        seg_mc = brats_labels_to_multichannel(np.asarray(read_nifti(record["seg"]).data))
        seg_mc = seg_mc[start[0]:end[0], start[1]:end[1], start[2]:end[2]]
        sample["seg"] = seg_mc
        if self.compute_distance_map:
            sample["distance_map"] = compute_distance_map_fn(seg_mc, self.device)
        return sample


def _collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack array fields into a batch (requires equal shapes)."""
    batch: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            batch[key] = np.stack(vals)
        else:
            batch[key] = vals
    return batch


_SENTINEL = object()


class _PrefetchIterator:
    """A producer thread over a pool of ``num_workers`` threads + bounded
    queue: keeps ``prefetch`` items queued while ``num_workers`` more are
    made, in order. A consumer that stops early releases the producer
    through :meth:`close` (also called when the iterator is collected)."""

    def __init__(self, make_item: Callable[[int], Any], n: int,
                 prefetch: int = 2, num_workers: int = 1):
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=max(prefetch, 1))
        self._error: Optional[BaseException] = None
        self._closed = threading.Event()

        def _put(item) -> bool:
            while not self._closed.is_set():
                try:
                    self._q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        workers = max(num_workers, 1)

        def producer():
            try:
                # a bounded window of submissions: pool.map would schedule
                # the whole epoch at once and hold every batch in memory
                with ThreadPoolExecutor(workers) as pool:
                    futures: "deque" = deque()
                    idx = 0
                    while idx < n or futures:
                        while idx < n and len(futures) < workers:
                            futures.append(pool.submit(make_item, idx))
                            idx += 1
                        if not _put(futures.popleft().result()):
                            return
            except BaseException as e:  # noqa: BLE001 — re-raised in __next__
                self._error = e
            finally:
                _put(_SENTINEL)

        self._thread = threading.Thread(target=producer, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Release the producer thread (idempotent)."""
        self._closed.set()

    def __del__(self):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _SENTINEL:
            self.close()
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


class EvalLoader:
    """Batch-size-1 loader for val and test cases (reference val loader,
    definer.py:524); decodes ``prefetch`` cases ahead in one thread."""

    def __init__(self, dataset: BraTSDataset, prefetch: int = 2):
        self.dataset = dataset
        self.prefetch = prefetch

    def __len__(self) -> int:
        return len(self.dataset)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        def make_item(i: int) -> Dict[str, Any]:
            return _collate([self.dataset[i]])

        return iter(_PrefetchIterator(make_item, len(self.dataset),
                                      self.prefetch))


class TrainLoader:
    """Shuffling, augmenting, batching loader with deterministic per-epoch
    seeds (the JAX package's TrainLoader, replacing the reference's
    set_determinism, definer.py:507-508): the epoch's order and each case's
    augmentation seed come from ``default_rng((seed, epoch))``. The last
    batch may be short, as the reference DataLoader's (definer.py:521).
    With ``compute_dm`` each sample carries the boundary distance map,
    computed on ``device`` (which it then needs) by the worker threads."""

    def __init__(self, dataset: BraTSDataset, batch_size: int,
                 patch_size: Sequence[int], seed: int = 123, num_workers: int = 4,
                 compute_dm: bool = False, device: Any = None):
        if compute_dm and device is None:
            raise ValueError("compute_dm needs a device for the EDT")
        self.dataset = dataset
        self.batch_size = batch_size
        self.patch_size = list(patch_size)
        self.seed = seed
        self.num_workers = num_workers
        self.compute_dm = compute_dm
        self.device = device
        self.epoch = 0
        self.start_batch = 0

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """The epoch keys the order and the augmentations; iteration yields
        its batches from ``start_batch`` on (a preempted epoch's remainder)
        without making the ones before, whose draws it does not shift."""
        self.epoch = epoch
        self.start_batch = start_batch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        rng = np.random.default_rng((self.seed, self.epoch))
        order = rng.permutation(len(self.dataset))
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]
        aug_seeds = rng.integers(0, 2 ** 31, size=len(self.dataset))
        ds = self.dataset
        normalize = not ds.normalize and not ds.already_preprocess

        def make_batch(bi: int) -> Dict[str, Any]:
            return _collate([augment_train_sample(
                ds[int(idx)], np.random.default_rng(int(aug_seeds[idx])),
                self.patch_size, normalize=normalize,
                remove_outliers=ds.remove_outliers, compute_dm=self.compute_dm,
                device=self.device) for idx in batches[bi]])

        first = self.start_batch
        return iter(_PrefetchIterator(lambda bi: make_batch(first + bi), len(batches) - first,
                                      num_workers=self.num_workers))


def create_train_val_records(cfg: Any) -> Tuple[List[Dict], List[Dict]]:
    """definer.py:583-628: KFold(5, shuffle, seed) over the sorted patient
    list, or an explicit ``val_data_path``."""
    if cfg.val_data_path is not None and cfg.fold is not None:
        raise ValueError("Specified a val_data_path when a fold split is "
                         "specified is not possible")
    train_files: List[Dict] = []
    val_files: List[Dict] = []
    if cfg.val_data_path:
        db = create_database(cfg.val_data_path, required_modality=MODALITIES_WITH_SEG)
        val_files = make_file_records(db, with_seg=True)
    if cfg.train_data_path:
        db = create_database(cfg.train_data_path, required_modality=MODALITIES_WITH_SEG)
        ids = list(db)
        train_id, val_id = (ids, []) if (cfg.fold is None or cfg.val_data_path) \
            else kfold_split(ids, cfg.fold, 5, cfg.seed)
        recs = make_file_records(db, with_seg=True)
        train_files = [r for r in recs if r["patient_id"] in set(train_id)]
        if not cfg.val_data_path:
            val_files = [r for r in recs if r["patient_id"] in set(val_id)]
    if not train_files and not val_files:
        raise ValueError("train files and val files are empty")
    return train_files, val_files


def make_train_loader(cfg: Any, train_files: Sequence[Dict],
                      device: Any) -> Optional[TrainLoader]:
    """The train half of the JAX package's ``make_train_val_loaders``
    (definer.py:438-527): raw loads, augmentations, normalization last; the
    boundary criteria's distance maps on ``device``."""
    if not train_files:
        return None
    ds = BraTSDataset(list(train_files), with_seg=True,
                      remove_outliers=cfg.remove_outliers,
                      already_preprocess=cfg.already_preprocess, normalize=False)
    return TrainLoader(ds, cfg.batch_size, cfg.patch_size, seed=cfg.seed,
                       num_workers=cfg.num_workers,
                       compute_dm="boundary" in cfg.criterion, device=device)


def make_train_val_loaders(cfg: Any, device: Any, train_in_val_mode: bool = False
                           ) -> Tuple[Optional[TrainLoader], Optional[EvalLoader]]:
    """definer.py:438-527 (the JAX package's ``make_train_val_loaders``,
    single process): the train loader, and the eval loader over the val
    cases (the train cases with ``train_in_val_mode``), whose samples carry
    the seg and, for the boundary criteria, its distance map made on
    ``device``."""
    train_files, val_files = create_train_val_records(cfg)
    train_loader = None
    if not train_in_val_mode:
        train_loader = make_train_loader(cfg, train_files, device)
    eval_files = train_files if train_in_val_mode else val_files
    val_loader = None
    if eval_files:
        val_ds = BraTSDataset(list(eval_files), with_seg=True,
                              remove_outliers=cfg.remove_outliers,
                              already_preprocess=cfg.already_preprocess,
                              compute_distance_map="boundary" in cfg.criterion,
                              device=device)
        val_loader = EvalLoader(val_ds, prefetch=max(cfg.num_workers // 2, 1))
    return train_loader, val_loader


def discover_test_records(cfg: Any) -> list:
    """Complete (all-modality) test cases on disk right now."""
    if getattr(cfg, "docker_test", False):
        db = create_database_test_docker(cfg.test_data_path,
                                         required_modality=MODALITIES)
    else:
        db = create_database(cfg.test_data_path, required_modality=MODALITIES)
    return make_file_records(db, with_seg=False)


def make_records_loader(records: Sequence[Any], cfg: Any
                        ) -> Optional[EvalLoader]:
    """EvalLoader over explicit no-seg records."""
    if not records:
        return None
    ds = BraTSDataset(list(records), with_seg=False, remove_outliers=False)
    return EvalLoader(ds, prefetch=max(getattr(cfg, "num_workers", 2) // 2, 1))


def make_test_loader(cfg: Any) -> Optional[EvalLoader]:
    """definer.py:554-580: no seg, crop + plain z-score normalize."""
    return make_records_loader(discover_test_records(cfg), cfg)
