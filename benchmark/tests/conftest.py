"""The benchmark's tests: its files by name, the work it counts, its
import check, and each traffic kind end to end at width 4 on small cases
through the program's plain PyTorch paths on the CPU.

    python -m pytest benchmark/tests -q              # CPU
    python -m pytest benchmark/tests -q -m cuda      # on the card
"""

import copy
import os
import sys
import tempfile

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


def small_cell(name: str, width: int = 4, shape=(64, 64, 48), limits=None):
    """Cell ``name`` at ``width`` on ``shape`` cases (a pool of two, one
    of them compared; 64×64×48 by default, large enough that no label is
    rare in every slice), its limits replaced by ``limits`` where given."""
    from portbench import manifest
    cell = manifest.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["cli"] = [str(width) if c == "48" else c for c in cell.config["cli"]]
    cell.config["reference"]["kwargs"]["width"] = width
    cell.traffic = dict(cell.traffic, case_shape=list(shape), pool_cases=2, check_cases=1)
    if limits is not None:
        cell.limits = dict(limits)
    return cell


def run_small(cell, seed: int = 2 ** 31 + 11, seconds: float = 3.0, variant=None):
    """One run of ``cell`` on the CPU; its result line (a dict)."""
    import torch
    from portbench import harness
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    tmp = tempfile.mkdtemp(prefix="portbench-test-")
    run = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=False,
                      device=torch.device("cpu"), tmp=tmp)
    try:
        import time
        return harness.execute(run, time.perf_counter(), variant)
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
