"""Small helpers (reference utils/misc.py:13-52; JAX
``brats21_tpu/utils/misc.py``)."""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch


def apply_f(seq: Any, f: Callable) -> Any:
    """Apply ``f`` to every leaf of an arbitrarily nested list/tuple
    (misc.py:13-24)."""
    if isinstance(seq, (list, tuple)):
        return [apply_f(t, f) for t in seq]
    return f(seq)


def flatten(seq: Any) -> List:
    """Flatten an irregular nested list (misc.py:27-39)."""
    result: List = []
    if isinstance(seq, (list, tuple)):
        for x in seq:
            result.extend(flatten(x))
    else:
        result.append(seq)
    return result


def to_array(x: Any) -> np.ndarray:
    """A tensor (on any device) or array-like → host numpy (misc.py:42-52)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
