"""The served cell end to end at width 4 on small cases through the
program's plain PyTorch paths on the CPU: one contract line with
``correct`` true, and ``correct`` false with the timed path broken
underneath (an answer altered where it is produced, half of the TTA
combos left out) or with the reference at fp8 in the program's place.

The limit here is the small size's (width 4, 64×64×48 cases), set from
CPU readings (the program's label margin 0 to 1e-4, the control's 0.005
to 0.05); the cell's own limit was set on the chip at its size
(``workloads/*.json``, PERF.md)."""

import json

import pytest

from conftest import run_small, small_cell

SERVE_LIMITS = {"label_margin": 0.002}
CELL = "assp_evo_w48.serve_tta"


def _line_ok(line):
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    json.dumps(line)
    assert line["attempted"] > 0 and line["failed"] == 0


def test_serve_cell_is_correct():
    line = run_small(small_cell(CELL, limits=SERVE_LIMITS))
    _line_ok(line)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"cases_per_s", "setup_s"}
    assert set(line["reported"]) == {"label_mismatch"}


def _planted(fault, cell, seed):
    import control
    return control.plant(fault, cell, seed)


@pytest.mark.parametrize("fault", ["alter_label", "half_tta"])
def test_serve_faults_are_not_correct(fault):
    cell = small_cell(CELL, limits=SERVE_LIMITS)
    seed = 2 ** 31 + 11
    undo = _planted(fault, cell, seed)
    try:
        line = run_small(cell, seed=seed)
    finally:
        undo()
    assert not line["correct"], line["checks"]


def test_serve_control_is_not_correct():
    line = run_small(small_cell(CELL, limits=SERVE_LIMITS),
                     variant="control")
    assert not line["correct"], line["checks"]
