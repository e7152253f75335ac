"""One run of one cell: set-up, the measured window, the check against the
plain reference, the metrics, and the result line.

A traffic kind (``traffic/<kind>.py``) provides five functions, each
taking the :class:`Run` and the state that :func:`setup` returned:

* ``setup(run)``: make the inputs and weights from the seed, build the
  program's objects and warm up every shape the window uses;
* ``window(run, state)``: the measured window, bracketed by
  :meth:`Run.begin_window` and :meth:`Run.end_window`;
* ``measure(run, state)``: ``{"attempted", "failed", "end_to_end": {...},
  "layer": {...}}`` (what the per-layer readers read);
* ``release(run, state)``: drop the program's device state;
* ``check(run, state, variant)``: the numbers from the reference run
  after the release, ``[(name, value, limit)]``; those whose limit is None
  are reported and not compared.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

from . import hostload, manifest
from .trace import Spans, Trace, Tracer

#: top-level module names that may not be loaded: JAX and the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "brats21_tpu"})


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def gpu_query() -> Dict[str, str]:
    """The card's name, power limit and draw, SM clock and temperature by
    ``nvidia-smi``, or {} where it cannot be read."""
    keys = ["name", "power.limit", "power.draw", "clocks.sm", "clocks.max.sm",
            "temperature.gpu"]
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(keys)}",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    return dict(zip(keys, (v.strip() for v in out[0].split(",")))) if out else {}


@dataclass
class Run:
    """Everything one run of one cell knows."""

    cell: manifest.Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    tmp: str
    spans: Spans = field(default_factory=Spans)
    tracer: Optional[Tracer] = None
    traced: Optional[Trace] = None
    t0: float = 0.0
    t0_ns: int = 0
    deadline: float = 0.0
    t_end: float = 0.0
    launches_at_start: Dict[str, int] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)
    host: Dict[str, dict] = field(default_factory=dict)

    def note(self, msg: str) -> None:
        """A line for standard error before the result."""
        print(f"[portbench] {msg}", file=sys.stderr, flush=True)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Notes the seconds a stage of the set-up took."""
        t = time.perf_counter()
        yield
        self.note(f"{name}: {time.perf_counter() - t:.3f} s")

    def timed(self, name: str, fn):
        """``fn`` noting its seconds when it runs (on any thread)."""
        def wrapped(*args, **kwargs):
            with self.stage(name):
                return fn(*args, **kwargs)
        return wrapped

    def mark_host(self, label: str) -> None:
        """Keeps the host's CPU counters (:mod:`hostload`) at the first
        call for ``label``."""
        if label not in self.host:
            snap = hostload.snapshot()
            if snap is not None:
                self.host[label] = snap

    def begin_window(self) -> float:
        """Start the window (and the trace); returns its deadline, on
        ``time.perf_counter``."""
        self.mark_host("start")
        self.launches_at_start = kernel_launches()
        if self.trace:
            self.tracer = Tracer(self.device)
            self.tracer.start()
        self.t0 = time.perf_counter()
        self.t0_ns = time.time_ns()
        self.deadline = self.t0 + self.seconds
        return self.deadline

    def end_window(self) -> None:
        """Close the window once the program's work is done (the trace stops
        after the card has finished)."""
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t_end = time.perf_counter()
        self.mark_host("end")
        if self.tracer is not None:
            self.traced = self.tracer.stop()
            self.tracer = None
        now = kernel_launches()
        self.launches = {k: now[k] - self.launches_at_start.get(k, 0) for k in now}


def kernel_launches() -> Dict[str, int]:
    """The program's kernel launch counters (``launches`` of each module of
    ``brats21_tpu_torch.ops.kernels`` that is loaded)."""
    prefix = "brats21_tpu_torch.ops.kernels."
    return {name[len(prefix):]: int(getattr(mod, "launches"))
            for name, mod in list(sys.modules.items())
            if name.startswith(prefix) and isinstance(getattr(mod, "launches", None), int)}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="One run of one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cuda_device(chips: int):
    """The run's card, or None (with the reason on standard error) when the
    machine has no CUDA or fewer cards than the cell asks for."""
    import torch
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is false", file=sys.stderr)
        return None
    if torch.cuda.device_count() < chips:
        print(f"portbench: {torch.cuda.device_count()} card(s), the cell asks for {chips}",
              file=sys.stderr)
        return None
    return torch.device("cuda", 0)


def per_layer(run: Run, layer: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Each per-layer metric of the cell that its reader finds something
    to read for."""
    ctx = SimpleNamespace(trace=run.traced, spans=run.spans, launches=run.launches,
                          run=run, **layer)
    out = {}
    for m in run.cell.per_layer:
        reader = manifest.metric_reader(m["name"])
        if reader is None:
            raise FileNotFoundError(f"no reader for per-layer metric {m['name']!r}")
        value = reader.read(ctx, m["name"])
        if value is None:
            run.note(f"per-layer metric {m['name']}: nothing to read")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(run: Run, correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Dict[str, Any]], peak: int, numbers: List[tuple],
                breakdown: Optional[dict] = None) -> dict:
    """The contract's line; ``numbers`` [(name, value, limit)] go last,
    those with a limit under ``checks``, those reported alone (limit None)
    under ``reported`` before it."""
    import torch
    cuda = run.device.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
              "count": run.cell.chips, "memory_peak_bytes": int(peak)}
    if run.traced is not None:
        device["busy_s"] = run.traced.busy_s
        device["window_s"] = run.traced.window_s
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["reported"] = {name: value for name, value, limit in numbers if limit is None}
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in numbers if limit is not None}
    return line


class ForbiddenImport(RuntimeError):
    """JAX or the JAX package was loaded in the run's process."""


def execute(run: Run, t_process: float, variant: Optional[str] = None) -> dict:
    """Set-up, window, check and metrics of ``run``; the result line as a
    dict, with every number the check read (``variant`` "control" puts
    the reference at the precision below the configuration's in the
    program's place)."""
    import torch
    cuda = run.device.type == "cuda"
    kind = run.cell.kind
    state = kind.setup(run)
    setup_s = time.perf_counter() - t_process
    run.note(f"setup_s {setup_s:.3f}")
    kind.window(run, state)
    if "start" in run.host:
        run.note(hostload.report(run.host["start"], run.host.get("deadline", run.host["end"])))
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(", ".join(found))
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    run.note(f"device memory peak {peak} bytes")
    measured = kind.measure(run, state)
    kind.release(run, state)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = kind.check(run, state, variant)
    for name, value, limit in numbers:
        if limit is None:
            run.note(f"reported, not compared: {name} {value!r}")
    checks = [(n, v, lim) for n, v, lim in numbers if lim is not None]
    correct = measured["failed"] == 0 and all(v <= lim for _, v, lim in checks)
    if run.trace:
        metrics = per_layer(run, measured["layer"])
        breakdown = {"device_ops": run.traced.top_ops(10),
                     "idle_gaps": run.traced.idle_by_span(run.spans)}
    else:
        e2e = dict(measured["end_to_end"], setup_s=setup_s)
        metrics = {}
        for m in run.cell.end_to_end:
            if m["name"] not in e2e:
                raise KeyError(f"the {run.cell.traffic['kind']} traffic does not measure "
                               f"{m['name']}")
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
        breakdown = None
    return result_line(run, correct, measured["attempted"], measured["failed"], metrics,
                       peak, numbers, breakdown)


def run_cell(args: argparse.Namespace, t_process: float) -> int:
    """The whole run; the process's exit code."""
    cell = manifest.load_cell(args.workload)
    device = cuda_device(cell.chips)
    if device is None:
        return 3
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        run = Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  device=device, tmp=tmp)
        run.note("card: " + json.dumps(gpu_query()))
        try:
            line = execute(run, t_process)
            found = forbidden_modules()
            if found:
                raise ForbiddenImport(", ".join(found))
        except ForbiddenImport as e:
            print(f"portbench: forbidden modules loaded: {e}", file=sys.stderr)
            return 4
        run.note("card after: " + json.dumps(gpu_query()))
        for name, check in line["checks"].items():
            print(f"check {name}: {check['value']!r} (limit {check['limit']!r})",
                  file=sys.stderr, flush=True)
        print(json.dumps(line), flush=True)
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def quantile(values: List[float], q: float) -> float:
    """The ``q`` quantile (0-1) by linear interpolation between order
    statistics (numpy's default)."""
    import numpy as np
    return float(np.quantile(np.asarray(values, np.float64), q))


def env_for_run() -> None:
    """The run's environment: no library loads JAX on its own (``USE_FLAX``
    for ``transformers``)."""
    os.environ.setdefault("USE_FLAX", "0")
