"""Average/progress meters (reference utils/meter.py:17-84), a copy of
``brats21_tpu/utils/meter.py``."""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

from .. import get_logger

logger = get_logger("meter")


class AverageMeter:
    """Tracks val/avg/std of scalars or ndarrays (meter.py:17-62)."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self) -> None:
        self.val: Union[float, np.ndarray] = 0.0
        self.avg: Union[float, np.ndarray] = 0.0
        self.sum: Union[float, np.ndarray] = 0.0
        self.count = 0
        self.history: List[Union[float, np.ndarray]] = []

    def update(self, val: Union[float, np.ndarray], n: int = 1) -> None:
        if isinstance(val, np.ndarray):
            val = np.asarray(val, np.float64)
        self.val = val
        self.sum = self.sum + val * n
        self.count += n
        self.avg = self.sum / self.count
        self.history.append(val)

    @property
    def std(self) -> Union[float, np.ndarray]:
        if not self.history:
            return 0.0
        return np.std(np.asarray(self.history, np.float64), axis=0)

    def __str__(self) -> str:
        val = np.mean(self.val) if isinstance(self.val, np.ndarray) else self.val
        avg = np.mean(self.avg) if isinstance(self.avg, np.ndarray) else self.avg
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(name=self.name, val=val, avg=avg)


class ProgressMeter:
    """Formatted per-step logging lines (meter.py:65-84)."""

    def __init__(self, num_batches: int, meters: Sequence[AverageMeter],
                 prefix: str = ""):
        self.batch_fmtstr = self._get_batch_fmtstr(num_batches)
        self.meters = list(meters)
        self.prefix = prefix

    def display(self, batch: int) -> None:
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        logger.info("\t".join(entries))

    @staticmethod
    def _get_batch_fmtstr(num_batches: int) -> str:
        num_digits = len(str(num_batches // 1))
        fmt = "{:" + str(num_digits) + "d}"
        return "[" + fmt + "/" + fmt.format(num_batches) + "]"
