"""Hand-written Hopper kernels and how they are built.

Each kernel module holds the kernel's wrapper, a plain PyTorch version of
the same function, and a ``launches`` counter. A wrapper given a CPU tensor
runs the plain version; given a CUDA tensor it launches the kernel or
raises. CUDA C++ sources (``csrc/*.cu``) are compiled at first use with
``nvcc`` into a shared library with a plain C interface under
``brats21_tpu_torch/_build/`` and bound with ``ctypes``; the native case
loader (``data/native.py``) builds its host C++ source the same way.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence

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


def library_path(source: str, key: Sequence[str] = NVCC_FLAGS) -> Path:
    """Build output for ``csrc/<source>``, named by a hash of the source and
    the build's ``key`` (its flags; a host compiler's name too) so a changed
    source is never served from a stale build."""
    text = (CSRC_DIR / source).read_bytes()
    digest = hashlib.sha256(text + " ".join(key).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def _key(compiler: Optional[str], flags: Sequence[str], libs: Sequence[str]) -> tuple:
    return (*flags, *libs) if compiler is None else (compiler, *flags, *libs)


@dataclass
class Build:
    """A compiler run writing ``tmp``, renamed to ``out`` when it succeeds."""

    proc: "subprocess.Popen[str]"
    tmp: Path
    out: Path


def start_build(source: str, compiler: Optional[str] = None,
                flags: Sequence[str] = NVCC_FLAGS, libs: Sequence[str] = ()
                ) -> Optional[Build]:
    """Start ``compiler`` (``nvcc`` when None) on ``csrc/<source>`` in the
    background, or return None when the library is already built.
    :func:`finish_build` waits. The output is written under a name of this
    process and thread and renamed into place, so concurrent builds of one
    library (test workers, loader threads) never see a partial file."""
    out = library_path(source, _key(compiler, flags, libs))
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
    cmd = [compiler or find_nvcc(), *flags, "-o", str(tmp), str(CSRC_DIR / source), *libs]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return Build(proc, tmp, out)


def finish_build(build: Optional[Build]) -> str:
    """Wait for a build from :func:`start_build`; return the compiler's
    output (nvcc's ``-Xptxas -v`` resource report) or raise with it on
    failure."""
    if build is None:
        return ""
    log, _ = build.proc.communicate()
    if build.proc.returncode != 0:
        build.tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(build.proc.args[0]).name} failed "
                           f"({build.proc.returncode}) on {build.out.name}:\n{log}")
    os.replace(build.tmp, build.out)
    build.out.with_suffix(".log").write_text(log)
    return log


def build_library(source: str, compiler: Optional[str] = None,
                  flags: Sequence[str] = NVCC_FLAGS, libs: Sequence[str] = ()) -> Path:
    """Build ``csrc/<source>`` if needed; its shared library's path."""
    finish_build(start_build(source, compiler, flags, libs))
    return library_path(source, _key(compiler, flags, libs))


@functools.lru_cache(maxsize=None)
def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the shared library of ``csrc/<source>``."""
    return ctypes.CDLL(str(build_library(source)))


#: the CUDA sources of the kernels, one library each
SOURCES = ("conv3x3x3.cu", "evonorm_s0.cu", "edt_envelope.cu", "glue3d.cu")


def warm_up(device) -> None:
    """Build every kernel library that is not built yet (one ``nvcc`` each,
    all started together), then launch each kernel once on ``device`` and
    wait for it: a build or launch failure raises here, not at a case."""
    import torch

    from .conv3d import conv3x3x3
    from .edt import envelope
    from .evonorm import evonorm_s0
    from .glue import se_gate_pool, upsample_cat
    builds = [start_build(src) for src in SOURCES]
    for build in builds:
        finish_build(build)
    conv3x3x3(torch.ones((1, 2, 2, 2, 8), device=device, dtype=torch.bfloat16),
              torch.ones((3, 3, 3, 8, 8), device=device, dtype=torch.bfloat16),
              torch.zeros(8, device=device))
    evonorm_s0(torch.ones((1, 2, 2, 2, 8), device=device), torch.ones(8, device=device),
               torch.zeros(8, device=device))
    envelope(torch.zeros((2, 8), device=device))
    ones = functools.partial(torch.ones, device=device, dtype=torch.bfloat16)
    se_gate_pool(ones((1, 2, 2, 2, 8)), ones((1, 8)), pool=True)
    upsample_cat(ones((1, 2, 2, 2, 8)), ones((1, 1, 1, 1, 8)))
    torch.cuda.synchronize(device)
