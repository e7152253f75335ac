"""Eval dataset and prefetching loader feeding the card.

The eval half of ``brats21_tpu/data/pipeline.py``: NIfTI decode and numpy
preprocessing run in a background thread while the card computes the
previous case; batches are numpy arrays that the engine copies to the
device. The native (ctypes) loader, the train loader and multi-host
striping come with later slices.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import get_logger
from .discovery import (MODALITIES, create_database,
                        create_database_test_docker, make_file_records)
from .nifti import read_nifti
from .transforms import preprocess_case

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
    """Lazy per-case dataset: record → preprocessed sample dict (numpy
    path of the JAX package's dataset)."""

    def __init__(self, records: List[Dict[str, Any]], *,
                 with_seg: bool, remove_outliers: bool = False,
                 crop: bool = True, already_preprocess: bool = False):
        self.records = records
        self.with_seg = with_seg
        self.remove_outliers = remove_outliers
        self.crop = crop and not already_preprocess
        self.already_preprocess = already_preprocess

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        record = self.records[idx]
        img, seg, affine = load_case(record)
        if not self.with_seg:
            seg = None
        if self.already_preprocess:
            # skip crop+normalize (definer.py:476-479)
            sample = preprocess_case(img, seg, crop=False, normalize=False)
        else:
            sample = preprocess_case(img, seg, remove_outliers=self.remove_outliers,
                                     crop=self.crop)
        sample["affine"] = affine
        sample["patient_id"] = record["patient_id"]
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
    """One producer thread + bounded queue: keeps ``prefetch`` items in
    flight. A consumer that stops early releases the producer through
    :meth:`close` (also called when the iterator is collected)."""

    def __init__(self, make_item: Callable[[int], Any], n: int,
                 prefetch: int = 2):
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

        def producer():
            try:
                for i in range(n):
                    if not _put(make_item(i)):
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
    """Batch-size-1 loader for test cases (reference val loader,
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
