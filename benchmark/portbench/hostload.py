"""The host's load over a stretch of the window, from ``/proc``: the
machine's CPU time by kind (user, system, I/O wait, time taken by the
hypervisor for other guests) and this process's CPU time by thread.

A served cell's pace is partly the host's: the main thread's waits on the
card inside each case, the prep stage's decode and the finish stage's
save share the machine's cores. Two runs of one seed that differ in rate
are told apart by these notes. Reading them costs a few file reads at
the window's start and at its deadline; nothing runs during the window.
"""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

_CPU_KINDS = ("user", "nice", "system", "idle", "iowait", "irq", "softirq", "steal")


def _ticks() -> float:
    return float(os.sysconf("SC_CLK_TCK"))


def _machine() -> Dict[str, float]:
    with open("/proc/stat") as f:
        fields = f.readline().split()[1:1 + len(_CPU_KINDS)]
    return {k: int(v) / _ticks() for k, v in zip(_CPU_KINDS, fields)}


def _threads() -> Dict[int, float]:
    """CPU seconds (user + system) of each live thread of this process."""
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                rest = f.read().rsplit(")", 1)[1].split()
            out[int(tid)] = (int(rest[11]) + int(rest[12])) / _ticks()
        except (OSError, ValueError, IndexError):
            continue
    return out


def _process() -> float:
    with open("/proc/self/stat") as f:
        rest = f.read().rsplit(")", 1)[1].split()
    # utime, stime, and those of waited-for children
    return (int(rest[11]) + int(rest[12])) / _ticks()


def snapshot() -> Optional[dict]:
    """The machine's and this process's CPU counters now, or None where
    ``/proc`` cannot be read."""
    try:
        names = {t.native_id: t.name for t in threading.enumerate()}
        return dict(t=time.perf_counter(), machine=_machine(), process=_process(),
                    threads=_threads(), names=names)
    except (OSError, ValueError, IndexError):
        return None


def report(a: dict, b: dict) -> str:
    """One line: the stretch's seconds, the machine's cores busy by kind,
    and this process's CPU seconds in all and by thread name (threads of
    the same name summed; threads the interpreter does not know, such as
    the CUDA driver's and the native loader's workers, as ``other``;
    threads that ended within the stretch are in the total alone)."""
    wall = max(b["t"] - a["t"], 1e-9)
    cores = {k: (b["machine"][k] - a["machine"].get(k, 0.0)) / wall for k in _CPU_KINDS}
    names = {**a["names"], **b["names"]}
    by_name: Dict[str, float] = defaultdict(float)
    for tid, cpu in b["threads"].items():
        by_name[names.get(tid, "other")] += cpu - a["threads"].get(tid, 0.0)
    threads = ", ".join(f"{n} {s:.2f}" for n, s in sorted(by_name.items(), key=lambda kv: -kv[1]))
    kinds = ", ".join(f"{k} {cores[k]:.2f}" for k in _CPU_KINDS if k != "nice")
    if not any(cores.values()):
        # a sandbox whose /proc/stat counts nothing
        kinds = "not counted by this machine's /proc/stat"
    return (f"host over {wall:.3f} s: machine cores busy by kind ({os.cpu_count()} cores): "
            f"{kinds}; this process {b['process'] - a['process']:.2f} CPU s; by thread: "
            f"{threads}")
