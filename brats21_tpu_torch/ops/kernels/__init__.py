"""Hand-written Hopper kernels and how they are built.

Each kernel module holds the kernel's wrapper, a plain PyTorch version of
the same function, and a ``launches`` counter. A wrapper given a CPU tensor
runs the plain version; given a CUDA tensor it launches the kernel or
raises. CUDA C++ sources (``csrc/*.cu``) are compiled at first use with
``nvcc`` into a shared library with a plain C interface under
``brats21_tpu_torch/_build/`` and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc from ``$CUDA_HOME/bin``, else from ``PATH``; raises when there
    is none."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin/ on "
        "PATH to build the port's CUDA kernels")


def library_path(source: str) -> Path:
    """Build output for ``csrc/<source>``, named by a hash of the source and
    the flags so a changed kernel is never served from a stale build."""
    text = (CSRC_DIR / source).read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


@dataclass
class Build:
    """An ``nvcc`` run writing ``tmp``, renamed to ``out`` when it succeeds."""

    proc: "subprocess.Popen[str]"
    tmp: Path
    out: Path


def start_build(source: str) -> Optional[Build]:
    """Start ``nvcc`` on ``csrc/<source>`` in the background, or return None
    when the library is already built. :func:`finish_build` waits."""
    out = library_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return Build(proc, tmp, out)


def finish_build(build: Optional[Build]) -> str:
    """Wait for a build from :func:`start_build`; return nvcc's output
    (the ``-Xptxas -v`` resource report) or raise with it on failure."""
    if build is None:
        return ""
    log, _ = build.proc.communicate()
    if build.proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({build.proc.returncode}) on {build.out.name}:\n{log}")
    os.replace(build.tmp, build.out)
    build.out.with_suffix(".log").write_text(log)
    return log


@functools.lru_cache(maxsize=None)
def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the shared library of ``csrc/<source>``."""
    finish_build(start_build(source))
    return ctypes.CDLL(str(library_path(source)))
