"""Several processes on ``torch.distributed``, started by ``torchrun``.

Port of ``brats21_tpu/parallel/multihost.py``. The JAX package runs one
process per host over that host's local devices; the port runs one process
per card. The mapping keeps a recipe's meaning:

* a ``torchrun`` node is a JAX process: its index is ``GROUP_RANK``, the
  node count ``WORLD_SIZE // LOCAL_WORLD_SIZE``;
* the node's local ranks (``LOCAL_RANK`` of ``LOCAL_WORLD_SIZE``) are that
  process's local devices, so ``--batch_size`` is the batch of a node, split
  over its local ranks (:meth:`~.mesh.Topology.shard_batch`).

Dataset records are striped per node with :func:`process_shard` (padded by
wrapping, so every node takes the same number of lock-step steps) and
:func:`shard_eval_records` (untrimmed: every case is scored once);
artifacts are written by the primary (global rank 0) alone.

``replicate_tree`` and ``global_batch_from_local`` have no counterpart:
DDP's broadcast of rank 0's parameters at construction replicates the
state, and each rank feeds its own slice of the node batch.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from datetime import timedelta
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch.distributed as dist

from .. import get_logger

logger = get_logger("multihost")

#: seconds a collective (and the rendezvous) may wait before it fails
TIMEOUT_ENV = "BRATS21_DIST_TIMEOUT"
DEFAULT_TIMEOUT = 600


def launched() -> bool:
    """Whether this process is one rank of several started by ``torchrun``."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def rendezvous():
    """(store, rank, world size) of ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), the store bounded by
    ``BRATS21_DIST_TIMEOUT`` seconds (default 600)."""
    seconds = int(os.environ.get(TIMEOUT_ENV, DEFAULT_TIMEOUT))
    return next(dist.rendezvous("env://", timeout=timedelta(seconds=seconds)))


def maybe_initialize_distributed(backend: str = "gloo", store=None) -> bool:
    """``init_process_group`` from ``torchrun``'s environment (or its
    :func:`rendezvous` ``store``) with a timeout of ``BRATS21_DIST_TIMEOUT``
    seconds (default 600) for every collective. Idempotent. Without such an
    environment it returns False and nothing changes for a one-process
    run."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    if not launched():
        return False
    seconds = int(os.environ.get(TIMEOUT_ENV, DEFAULT_TIMEOUT))
    if store is None:
        store = rendezvous()[0]
    dist.init_process_group(backend=backend, store=store, timeout=timedelta(seconds=seconds),
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return dist.get_world_size() > 1


def distributed() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def local_world_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", "1")) if distributed() else 1


def process_index() -> int:
    """This node's index (``GROUP_RANK``), 0 in a one-process run."""
    return int(os.environ.get("GROUP_RANK", "0")) if distributed() else 0


def process_count() -> int:
    """The number of nodes, 1 in a one-process run."""
    return dist.get_world_size() // local_world_size() if distributed() else 1


def is_primary() -> bool:
    return not distributed() or dist.get_rank() == 0


def process_shard(records: Sequence[Any], index: Optional[int] = None,
                  count: Optional[int] = None) -> List[Any]:
    """This node's stripe of a record list, padded by wrapping around the
    full list so every node gets ceil(len/count) records (lock-step epochs
    need equal step counts; trimming would exclude up to count-1 records
    for good). At most count-1 records are repeated an epoch, none dropped,
    as with torch's DistributedSampler."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    if count <= 1:
        return list(records)
    records = list(records)
    per = -(-len(records) // count)
    stripe = records[index::count]
    k = index
    while len(stripe) < per:
        stripe.append(records[k % len(records)])
        k += count + 1  # decorrelate the wrap picks across nodes
    return stripe


def shard_eval_records(records: Sequence[Any], index: Optional[int] = None,
                       count: Optional[int] = None) -> List[Any]:
    """This node's stripe of the eval cases, untrimmed: every case is
    scored once, and unequal stripes are fine since the eval loop's
    collectives stay within a node."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    if count <= 1:
        return list(records)
    return list(records[index::count])


def shutdown() -> None:
    """Wait for every rank, then take the process group down (the end of a
    CLI run under ``torchrun``)."""
    from . import mesh
    if distributed():
        dist.barrier()
        dist.destroy_process_group()
    mesh.forget_topology()


def barrier() -> None:
    """Wait for every rank (the JAX package's ``warmup_collectives`` brings
    its gloo context up early; ``init_process_group`` already has)."""
    if distributed():
        dist.barrier()


def wait_all(store, key: str, world: int, poll_s: float = 2.0) -> None:
    """Wait, with no time limit, until all ``world`` ranks have called it
    with ``key`` (each adds one to the key in the rendezvous ``store``).
    Where ranks end unequal work with no collective between, such as
    fold-parallel training, a :func:`barrier` would fail once the lighter
    rank has waited ``BRATS21_DIST_TIMEOUT`` seconds. A rank that fails
    instead ends the run through ``torchrun``, which stops the others."""
    if store is None or world <= 1:
        return
    store.add(key, 1)
    while store.add(key, 0) < world:
        time.sleep(poll_s)


def gather_objects(obj: Any, group: Optional[dist.ProcessGroup] = None) -> List[Any]:
    """All-gather one picklable object. Without ``group``: one object per
    node, each node's local rank 0's, ordered by node (every local rank of
    a node holds the node's merged state); with ``group``: one per rank of
    the group. A collective: every rank (of the group) must call it."""
    if not distributed():
        return [obj]
    size = dist.get_world_size(group)
    out: List[Any] = [None] * size
    dist.all_gather_object(out, obj, group=group)
    if group is not None:
        return out
    return out[::local_world_size()]


def from_primary(obj: Any) -> Any:
    """The primary's ``obj`` on every rank (collective), e.g. a run
    directory whose name carries the primary's clock."""
    if not distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def any_rank(flag: bool) -> bool:
    """True on every rank iff ``flag`` is true on any rank (collective)."""
    return any(gather_objects(bool(flag), dist.group.WORLD if distributed() else None))


def merge_meters(meters: Dict[str, Any], group: Optional[dist.ProcessGroup] = None
                 ) -> Dict[str, Any]:
    """Merge AverageMeter (sum, count) states in place, exactly, on every
    rank: across nodes without ``group``, across the group's ranks with
    it. Keys are unioned; a rank whose stripe was empty joins with count-0
    meters (:meth:`Engine.empty_eval_meters`)."""
    from ..utils.meter import AverageMeter
    if not distributed():
        return meters
    payload = {name: {"sum": np.asarray(m.sum, np.float64).tolist(), "count": int(m.count)}
               for name, m in meters.items()}
    gathered = gather_objects(payload, group)
    names: List[str] = []
    for g in gathered:
        names.extend(k for k in g if k not in names)
    for name in names:
        total: Any = 0.0
        count = 0
        for g in gathered:
            ent = g.get(name)
            if not ent or ent["count"] == 0:
                continue
            total = total + np.asarray(ent["sum"], np.float64)
            count += ent["count"]
        m = meters.setdefault(name, AverageMeter(name, ":.4f"))
        m.sum, m.count = total, count
        m.avg = total / count if count else 0.0
    return meters


def merge_report_rows(report, group: Optional[dist.ProcessGroup] = None) -> None:
    """Gather every node's (or the group's ranks') EvaluationReport rows
    into this rank's report (collective; the primary then writes)."""
    if not distributed():
        return
    for rows in gather_objects(report.rows, group):
        for pid, row in rows.items():
            report.rows.setdefault(pid, {}).update(row)


# ---------------------------------------------------------------------------
# launching ranks (tests, chip_smoke.py)
# ---------------------------------------------------------------------------


def free_port() -> int:
    """An OS-assigned free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun_argv(target: Sequence[str], nproc: int, nnodes: int = 1,
                  port: Optional[int] = None, rdzv_id: str = "brats21") -> List[str]:
    """``python -m torch.distributed.run`` for ``target`` (``-m module
    args`` or ``script args``): one node with a static rendezvous on
    localhost, or one of ``nnodes`` with a c10d rendezvous on localhost
    (which numbers the nodes as they join)."""
    argv = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc),
            "--nnodes", str(nnodes), "--max_restarts", "0"]
    if nnodes == 1:
        argv += ["--master_addr", "127.0.0.1", "--master_port", str(port or free_port())]
    else:
        argv += ["--rdzv_backend", "c10d", "--rdzv_endpoint", f"127.0.0.1:{port}",
                 "--rdzv_id", rdzv_id]
    return argv + list(target)


def run_ranks(target: Sequence[str], nproc: int, nnodes: int = 1, timeout: float = 600,
              env: Optional[Dict[str, str]] = None, cwd: Optional[str] = None) -> List[str]:
    """Run ``target`` on ``nnodes`` × ``nproc`` ranks on this host (one
    ``torchrun`` per node, all started together) and return each node's
    output. Raises when a node fails or outlives ``timeout`` seconds; every
    process it started is stopped before it returns."""
    port = free_port()
    run_env = {**os.environ, **(env or {})}
    run_env.setdefault(TIMEOUT_ENV, str(int(min(timeout, DEFAULT_TIMEOUT))))
    procs = [subprocess.Popen(
        torchrun_argv(target, nproc, nnodes, port, rdzv_id=f"brats21-{port}"),
        env=run_env, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True) for _ in range(nnodes)]
    deadline = time.time() + timeout
    outs: List[str] = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.time(), 1.0))[0])
    except subprocess.TimeoutExpired:
        raise TimeoutError(f"ranks of {list(target)} still running after {timeout:.0f}s")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    for node, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"node {node} of {list(target)} failed (rc {p.returncode}):\n"
                               f"{out[-4000:]}")
    return outs

