"""Finding a cell's files by name.

``BENCHMARK.json`` (at the checkout's root) names the cells, the metrics and
the configurations. Everything else is a file of its own that this module
finds by name, so a later change adds a configuration, a traffic mix or a
metric by adding files:

* ``configs/<config>.json``: the model's sizes, its CLI flags and its
  reference network;
* ``traffic/<traffic>.json``: the mix's parameters, with ``kind`` naming
  the generator ``traffic/<kind>.py``;
* ``workloads/<cell>.json``: the cell's correctness limits;
* ``metrics/<name>.py``: the reader of a per-layer metric, found by its
  whole name, else by the name with its last dotted parts dropped
  (``mfu.serve`` → ``metrics/mfu.py``).
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One entry of ``workloads`` with every file it names, loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    kind: ModuleType = field(repr=False)


def _applies(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    """Whether ``metric`` is reported in ``cell``: listed there, or, with no
    ``workloads`` key, in every cell (a per-layer metric: in every cell
    that reports the end-to-end metric it moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(name: str, manifest: Optional[dict] = None, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``manifest`` (``BENCHMARK.json`` by default)
    with its files under ``bench_dir``."""
    manifest = (manifest if manifest is not None
                else load_json(Path(bench_dir).parent / "BENCHMARK.json"))
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(cells: {', '.join(sorted(entries))})")
    w = entries[name]
    bench_dir = Path(bench_dir)
    config = load_json(bench_dir / "configs" / f"{w['config']}.json")
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits_path = bench_dir / "workloads" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    kind = load_module(bench_dir / "traffic" / f"{traffic['kind']}.py",
                       f"portbench_kind_{traffic['kind']}")
    e2e = [m for m in manifest["end_to_end"] if _applies(m, name, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in manifest["per_layer"] if _applies(m, name, e2e_names)]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=per_layer, kind=kind)


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> Optional[ModuleType]:
    """The reader module of per-layer metric ``name``, or None."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = Path(bench_dir) / "metrics" / (".".join(parts[:n]) + ".py")
        if path.exists():
            return load_module(path, "portbench_metric_" + ".".join(parts[:n]).replace(".", "_"))
    return None
