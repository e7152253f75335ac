"""Turn a reference-trained ``.pth`` into a run directory the port serves.

Counterpart of ``brats21_tpu/cli/import_torch.py``, with its flags: one
command bridges the reference workflow (``best_model.pth``,
src/main_inference.py:62-69) into the port's run-directory layout:

    python -m brats21_tpu_torch.cli.import_torch \\
        --pth /runs/model6/best_model.pth \\
        --model equiunet_assp_evo --width 48 \\
        --out /runs/model6_torch

writes ``/runs/model6_torch/{config.yaml, best_model.pth}``, which the
inference CLI serves without ``--import_pth``, as the Dockerfile deploys a
run directory:

    python -m brats21_tpu_torch.cli.main_inference \\
        --config /runs/model6_torch/config.yaml --on test --input ... --tta

The weights are loaded into the port's model with a strict
``load_state_dict`` first, so a checkpoint of another architecture or
width fails here, not at serving time. ``--swa`` reads the ``swa_model``
payload (AveragedModel's ``module.`` prefix and ``n_averaged`` dropped)
instead of ``model``; the run directory then holds those weights as its
plain ``best_model.pth``, and its config leaves ``swa_start`` unset.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from ..config import MODEL_CHOICES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Import a reference torch .pth into a brats21_tpu_torch run dir")
    p.add_argument("--pth", required=True,
                   help="reference best_model.pth / last_model.pth")
    p.add_argument("--out", required=True, help="output run directory")
    p.add_argument("--model", default="equiunet_assp_evo", choices=list(MODEL_CHOICES))
    p.add_argument("--width", type=int, default=48)
    p.add_argument("--num_classes", type=int, default=3)
    p.add_argument("--norm", type=str, default="group",
                   help="equiunet-family norm layer (definer.py:37-66)")
    p.add_argument("--act", type=str, default="relu")
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--swa", action="store_true", default=False,
                   help="the .pth holds an AveragedModel ('swa_model' key)")
    p.add_argument("-v", "--verbosity", action="count", default=0)
    return p


def main(argv: Optional[List[str]] = None) -> str:
    """Run the CLI; returns the run directory."""
    args = build_parser().parse_args(argv)

    import torch

    from .. import set_main_logger
    from ..config import TrainConfig
    from ..learning.checkpoint import BEST_NAME
    from ..models import get_model
    from ..utils.weights import load_reference_pth

    logger = set_main_logger(None, verbosity=max(args.verbosity, 1))
    cfg = TrainConfig(model=args.model, width=args.width, num_classes=args.num_classes,
                      norm=args.norm, act=args.act, dropout=args.dropout)
    model = get_model(cfg)
    model.load_state_dict(load_reference_pth(args.pth, prefer_swa=args.swa), strict=True)

    os.makedirs(args.out, exist_ok=True)
    cfg.save_path = args.out
    cfg.to_yaml(os.path.join(args.out, "config.yaml"))
    # the port's checkpoint payload (learning/checkpoint.py), without an
    # optimizer state: a run directory to serve, not to resume
    path = os.path.join(os.path.abspath(args.out), BEST_NAME)
    torch.save({"model": model.state_dict(), "epoch": 0, "best_value": float("nan")},
               path + ".tmp")
    os.replace(path + ".tmp", path)
    logger.info("wrote %s (+config.yaml) — serve with: python -m "
                "brats21_tpu_torch.cli.main_inference --config %s/config.yaml ...",
                path, args.out)
    return args.out


if __name__ == "__main__":
    main()
