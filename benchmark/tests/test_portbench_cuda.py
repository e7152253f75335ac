"""On the card (``-m cuda``; skipped without one): the control at a size a
test run holds. The served cell's program at width 48 on 96×96×64 cases
reads a label mismatch at least three times below the control's, the
reference at fp8 in the program's place; and a whole run of the cell at
that size prints a contract line."""

import pytest

from conftest import small_cell

pytestmark = pytest.mark.cuda


def _run_on_card(cell, card, variant=None, seed=2 ** 31 + 101, seconds=5.0):
    import shutil
    import tempfile
    import time

    from portbench import harness
    tmp = tempfile.mkdtemp(prefix="portbench-test-")
    try:
        run = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=False, device=card,
                          tmp=tmp)
        return harness.execute(run, time.perf_counter(), variant)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def test_control_reads_far_above_the_program(card):
    cell = small_cell("assp_evo_w48.serve_tta", width=48, shape=(96, 96, 64),
                      limits={"label_margin": 1.0})
    program = _run_on_card(cell, card)["reported"]["label_mismatch"]
    control = _run_on_card(cell, card, "control")["reported"]["label_mismatch"]
    assert control >= 3 * program, (program, control)


def test_the_cell_runs_on_the_card(card):
    cell = small_cell("assp_evo_w48.serve_tta", width=48, shape=(96, 96, 64))
    cell.limits = {k: 1.0 for k in cell.limits}
    line = _run_on_card(cell, card)
    assert line["device"]["platform"] == "gpu" and line["attempted"] > 0
    assert line["correct"], line["checks"]
