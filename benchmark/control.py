"""The readings that a cell's limits are set from, on the chip.

    python benchmark/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] \
        [--faults half_tta alter_label] [--control_seeds <k>]

Each reading is one whole run through ``harness.execute``, the path that
``run.py`` takes: the program at the cell's own sizes with a window of
``--seconds``, its compared numbers (the lower readings); on the first
``--control_seeds`` seeds also the control, the plain reference at the
precision below the configuration's (fp8 GEMM operands for bf16) in the
program's place (the upper readings), and ``--faults``, runs with the
timed path broken underneath: ``half_tta`` (the mean over half of the 16
TTA combos), ``alter_label`` (one served case's channels flipped where
its labels are made). One JSON line a reading.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from portbench import harness, manifest, synthetic  # noqa: E402


def plant(fault: str, cell, seed: int):
    """Break the program's timed path for ``fault``; returns the undo."""
    if fault == "half_tta":
        from brats21_tpu_torch.ops import tta
        combos = tta.COMBOS
        tta.COMBOS = combos[:len(combos) // 2]
        return lambda: setattr(tta, "COMBOS", combos)
    if fault == "alter_label":
        from brats21_tpu_torch.learning.engine import Engine
        save = Engine._save_segmentation
        done = []
        tr = cell.traffic
        ids = synthetic.pool_ids(tr["pool_cases"])
        checked = set(cell.kind.check_sample(seed, ids, tr["check_cases"]))

        def altered(self, batch, fused, *args, **kwargs):
            pid = batch["patient_id"][0]
            if (not done and pid.startswith("BraTS2021_01")
                    and ids[cell.kind.pool_index(pid, len(ids))] in checked):
                fused = 1.0 - fused          # every channel of the answer flipped
                done.append(pid)
            return save(self, batch, fused, *args, **kwargs)

        Engine._save_segmentation = altered
        return lambda: setattr(Engine, "_save_segmentation", save)
    raise ValueError(fault)


def reading(args, seed: int, fault=None, variant=None) -> dict:
    import torch
    cell = manifest.load_cell(args.workload)
    tmp = tempfile.mkdtemp(prefix="portbench-control-")
    undo = plant(fault, cell, seed) if fault else None
    try:
        run = harness.Run(cell=cell, seed=seed, seconds=args.seconds, trace=False,
                          device=torch.device("cuda", 0), tmp=tmp)
        t0 = time.perf_counter()
        line = harness.execute(run, t0, variant)
        numbers = {**line["reported"], **{n: c["value"] for n, c in line["checks"].items()}}
        return {"workload": args.workload, "seed": seed, "fault": fault, "variant": variant,
                "correct": line["correct"], "attempted": line["attempted"],
                "failed": line["failed"], "numbers": numbers,
                "seconds": time.perf_counter() - t0}
    finally:
        if undo:
            undo()
        shutil.rmtree(tmp, ignore_errors=True)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--control_seeds", type=int, default=3,
                   help="the control and the faults are read on the first this many seeds")
    args = p.parse_args()
    for i, seed in enumerate(args.seeds):
        print(json.dumps(reading(args, seed)), flush=True)
        if i < args.control_seeds:
            print(json.dumps(reading(args, seed, variant="control")), flush=True)
            for fault in args.faults:
                print(json.dumps(reading(args, seed, fault)), flush=True)


if __name__ == "__main__":
    main()
