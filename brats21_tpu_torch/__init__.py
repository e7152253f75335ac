"""brats21_tpu_torch — the PyTorch/CUDA port of ``brats21_tpu`` for one
NVIDIA H100.

The package mirrors ``brats21_tpu``'s layout so that each counterpart is
found by path. Modules take and return NCDHW tensors (the reference
checkpoints' convention) whose memory is ``torch.channels_last_3d``, i.e.
physically the JAX package's ``[B, D, H, W, C]``. The two Pallas kernels of
the serving path are hand-written for Hopper (``ops/kernels``): a CUDA C++
implicit-GEMM 3×3×3 conv and a Triton EvoNorm-S0. The package imports
neither JAX nor anything of ``brats21_tpu``.

Reference logger setup: src/__init__.py:6-37.
"""

from __future__ import annotations

import logging
import sys

__version__ = "0.1.0"

_LOGGER_NAME = "brats21_tpu_torch"


def get_logger_lvl(verbosity: int) -> int:
    """Map a ``-v`` count to a logging level (reference src/__init__.py:6-18)."""
    if verbosity >= 2:
        return logging.DEBUG
    if verbosity == 1:
        return logging.INFO
    return logging.WARNING


def set_main_logger(log_file: str | None = None, verbosity: int = 1) -> logging.Logger:
    """Configure the package logger: stdout + optional logfile
    (reference src/__init__.py:21-37)."""
    logger = logging.getLogger(_LOGGER_NAME)
    logger.setLevel(get_logger_lvl(verbosity))
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file is not None:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def get_logger(name: str | None = None) -> logging.Logger:
    if name:
        return logging.getLogger(f"{_LOGGER_NAME}.{name}")
    return logging.getLogger(_LOGGER_NAME)
