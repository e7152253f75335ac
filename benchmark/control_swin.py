"""``control.py`` with two more planted faults for the Swin UNETR cell, each
taking the served forwards' attention to its plain composition and
breaking it there:

* ``swin_mask_off``: the shifted blocks' −100 region mask left off;
* ``swin_bias_off``: the relative position bias left off.

    python benchmark/control_swin.py --workload swin_unetr_f48.serve_sw_tta \
        --seconds <s> --seeds <n> [<n> ...] --faults swin_mask_off swin_bias_off

Every other argument and fault is ``control.py``'s; one JSON line a reading.
"""

import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

import control  # noqa: E402

_plant = control.plant
#: fault → the ``ops/kernels/window_attn.py`` function whose term it zeroes
ZEROED = {"swin_mask_off": "shift_mask", "swin_bias_off": "relative_bias"}


def plant(fault: str, cell, seed: int):
    """Break the program's timed path for ``fault``; returns the undo."""
    if fault not in ZEROED:
        return _plant(fault, cell, seed)
    import torch
    from brats21_tpu_torch.models import swin_unetr
    from brats21_tpu_torch.ops.kernels import window_attn as wa
    route, term = swin_unetr.attn_route, getattr(wa, ZEROED[fault])
    swin_unetr.attn_route = lambda: False
    setattr(wa, ZEROED[fault], lambda *a, **k: torch.zeros_like(term(*a, **k)))

    def undo():
        swin_unetr.attn_route = route
        setattr(wa, ZEROED[fault], term)
    return undo


control.plant = plant

if __name__ == "__main__":
    control.main()
