"""TensorBoard + per-patient xlsx reporting (reference utils/visualization.py),
a copy of ``brats21_tpu/utils/reporting.py``.

- scalar logging per label channel (visualization.py:17-52)
- per-patient metric rows + describe() stats sheet into ``Evaluation.xlsx``
  (visualization.py:55-137) — built with pandas + our minimal xlsx writer.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np

from .meter import AverageMeter
from .xlsx import write_xlsx

LABELS = ("WT", "TC", "ET")  # channel order of the 3-channel codec


class TensorBoardLogger:
    """Thin wrapper over tensorboardX, matching log_tensorboard semantics
    (visualization.py:17-52): scalar per meter, per-label sub-scalars for
    array-valued meters. No-op when disabled. Enabled on a host without
    ``tensorboardX`` it raises at construction, which the CLIs reach before
    their first step."""

    def __init__(self, log_dir: Optional[str], enabled: bool = True):
        self.writer = None
        if enabled and log_dir is not None:
            try:
                from tensorboardX import SummaryWriter
            except ImportError as e:
                raise ImportError(
                    "TensorBoard logging needs the tensorboardX package, which "
                    "this host lacks: install it or pass --no_tensorboard") from e
            self.writer = SummaryWriter(log_dir)

    def log_meters(self, global_step: int, meters: Sequence[AverageMeter],
                   step_mode: str = "train", tag: str = "metric",
                   labels: Sequence[str] = LABELS) -> None:
        if self.writer is None:
            return
        for meter in meters:
            val = meter.val
            if isinstance(val, np.ndarray):
                flat = np.asarray(val).ravel()
                for i, v in enumerate(flat[: len(labels)]):
                    self.writer.add_scalar(
                        f"{tag}/{step_mode}/{meter.name}/{labels[i]}",
                        float(v), global_step)
                self.writer.add_scalar(
                    f"{tag}/{step_mode}/{meter.name}/mean",
                    float(np.nanmean(flat)), global_step)
            else:
                self.writer.add_scalar(f"{tag}/{step_mode}/{meter.name}",
                                       float(val), global_step)

    def log_scalar(self, name: str, value: float, step: int) -> None:
        if self.writer is not None:
            self.writer.add_scalar(name, float(value), step)

    def log_hparams(self, hparams: Mapping[str, Any],
                    metrics: Mapping[str, float]) -> None:
        """hparams table at end of training (main_train.py:229-243)."""
        if self.writer is None:
            return
        clean = {k: (v if isinstance(v, (int, float, bool, str)) else str(v))
                 for k, v in hparams.items()}
        self.writer.add_hparams(clean, dict(metrics))

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


class EvaluationReport:
    """Accumulates per-patient per-label metric rows and writes
    ``Evaluation.xlsx`` (+ CSV twin) with a describe() stats sheet
    (visualization.py:120-137, files.py:269-333).

    Like the reference's per-case xlsx appender (files.py:269-333), rows are
    flushed to disk incrementally when ``autosave_dir`` is set: every
    :meth:`add` rewrites the report atomically (tmp+rename), so killing the
    process mid-eval leaves a readable report with all completed cases."""

    def __init__(self, labels: Sequence[str] = LABELS,
                 autosave_dir: Optional[str] = None,
                 name: str = "Evaluation",
                 autosave_xlsx_every: int = 25):
        self.labels = list(labels)
        self.rows: Dict[str, Dict[str, float]] = {}
        self.autosave_dir = autosave_dir
        self.name = name
        # per-case crash safety at O(n): the CSV is APPENDED one row per
        # case (reference appends per case too, files.py:269-333); the
        # xlsx + stats sheet (a full rebuild) refreshes every N cases and
        # at the final save() — rebuilding both per case would be O(n²)
        self.autosave_xlsx_every = max(int(autosave_xlsx_every), 1)
        self._csv_cols: Optional[list] = None

    def _csv_append(self, patient_id: str, row: Dict[str, float]) -> None:
        """Append one case to the autosave CSV; the header is fixed by the
        first case's columns (all cases share one metric set) — a column
        drift falls back to a full rewrite at the next xlsx refresh."""
        csv_path = os.path.join(self.autosave_dir, f"{self.name}.csv")
        if self._csv_cols is None or not os.path.exists(csv_path):
            self._csv_cols = list(row)
            with open(csv_path, "w") as f:
                f.write(",".join(["patient_id"] + self._csv_cols) + "\n")
        with open(csv_path, "a") as f:
            f.write(",".join([patient_id] + [
                "" if row.get(c) is None else str(row.get(c))
                for c in self._csv_cols]) + "\n")

    def add(self, patient_id: str, metrics: Mapping[str, np.ndarray]) -> None:
        row = self.rows.setdefault(patient_id, {})
        for name, values in metrics.items():
            flat = np.asarray(values).ravel()
            for i, lbl in enumerate(self.labels[: len(flat)]):
                row[f"{name}_{lbl}"] = float(flat[i])
            row[f"{name}_mean"] = float(np.nanmean(flat))
        if self.autosave_dir is not None:
            self._csv_append(patient_id, row)
            if (len(self.rows) == 1
                    or len(self.rows) % self.autosave_xlsx_every == 0):
                self.save(self.autosave_dir, self.name)

    def _columns(self) -> list:
        cols: list = []
        for row in self.rows.values():
            for c in row:
                if c not in cols:
                    cols.append(c)
        return cols

    def describe(self) -> Dict[str, Dict[str, float]]:
        cols = self._columns()
        stats: Dict[str, Dict[str, float]] = {}
        for c in cols:
            vals = np.asarray([r[c] for r in self.rows.values() if c in r])
            if vals.size == 0:
                continue
            stats[c] = {
                "count": float(vals.size),
                "mean": float(np.nanmean(vals)),
                "std": float(np.nanstd(vals, ddof=1)) if vals.size > 1 else 0.0,
                "min": float(np.nanmin(vals)),
                "25%": float(np.nanpercentile(vals, 25)),
                "50%": float(np.nanpercentile(vals, 50)),
                "75%": float(np.nanpercentile(vals, 75)),
                "max": float(np.nanmax(vals)),
            }
        return stats

    def save(self, save_dir: str, name: Optional[str] = None) -> str:
        name = name or self.name
        os.makedirs(save_dir, exist_ok=True)
        cols = self._columns()
        rows = [["patient_id"] + cols]
        for pid, row in self.rows.items():
            rows.append([pid] + [row.get(c) for c in cols])
        stats = self.describe()
        stat_names = ["count", "mean", "std", "min", "25%", "50%", "75%", "max"]
        stat_rows = [["stat"] + cols]
        for s in stat_names:
            stat_rows.append([s] + [stats.get(c, {}).get(s) for c in cols])
        # atomic writes (tmp+rename): an interrupted flush never corrupts
        # the previously written report
        path = os.path.join(save_dir, f"{name}.xlsx")
        tmp = path + ".tmp"
        write_xlsx(tmp, {"metrics": rows, "stats": stat_rows})
        os.replace(tmp, path)
        csv_path = os.path.join(save_dir, f"{name}.csv")
        with open(csv_path + ".tmp", "w") as f:
            for r in rows:
                f.write(",".join("" if v is None else str(v) for v in r) + "\n")
        os.replace(csv_path + ".tmp", csv_path)
        if save_dir == self.autosave_dir and name == self.name:
            # the rewrite is the new append base — keep column order in sync
            self._csv_cols = cols
        return path
