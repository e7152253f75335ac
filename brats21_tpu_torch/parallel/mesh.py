"""The ranks of a run, their devices and the process group of the data axis.

Port of ``brats21_tpu/parallel/mesh.py`` without the spatial axis: the JAX
package's ``data`` axis over a process's local devices is the group of a
node's local ranks here (:class:`Topology`). Each local rank runs on
``cuda:(LOCAL_RANK % device_count)``; the collective backend is ``nccl``
when every rank has a card of its own, ``gloo`` when local ranks outnumber
the cards or several nodes on one host share one (NCCL refuses two ranks
on one device) and with ``--device cpu``. The backend carries the
collectives only: the work stays on the card either way.

:func:`batch_group` marks the forward and loss of a data-parallel train
step: inside it the batch-wide sums (Dice with ``batch=True``, BatchNorm's
statistics) are all-reduced over the ranks that share the global batch, as
the JAX package's GSPMD computes them over its global batch.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Iterator, Optional

import torch
import torch.distributed as dist

from .. import get_logger
from . import multihost

logger = get_logger("mesh")


def resolve_device(spec: str) -> torch.device:
    """``--device``: a CUDA index (the reference's default "0") or "cpu".
    A CUDA device on a host without CUDA raises: the port never falls back
    to the CPU unasked. On CUDA, TF32 is turned off for cuDNN and matmuls,
    so what the configuration runs in fp32 (``--no_amp``, the cuDNN convs'
    grads, the loss) is fp32."""
    if spec.strip().lower() == "cpu":
        return torch.device("cpu")
    try:
        index = int(spec)
    except ValueError:
        raise ValueError(f"--device must be a CUDA index or 'cpu', got {spec!r}") from None
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {spec}: CUDA is not available on this host "
            "(pass --device cpu to run on the CPU)")
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"--device {spec}: only {torch.cuda.device_count()} "
                           "CUDA device(s)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", index)


@dataclass
class Topology:
    """One rank's place in the run: global, node and local rank and size,
    its device, the backend, the group of its node's local ranks (None when
    the node has one rank), a group of every rank for the global batch's
    sums (apart from DDP's own, so their collectives never interleave) and
    the rendezvous store."""

    rank: int = 0
    world_size: int = 1
    node: int = 0
    nodes: int = 1
    local_rank: int = 0
    local_size: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    local_group: Optional[dist.ProcessGroup] = None
    batch_group: Optional[dist.ProcessGroup] = None
    store: Optional[dist.Store] = None

    @property
    def distributed(self) -> bool:
        return self.world_size > 1

    @property
    def primary(self) -> bool:
        return self.rank == 0

    def shard_batch(self, n: int) -> Optional[slice]:
        """This local rank's slice of a node batch of ``n`` samples, or
        None when ``n`` does not divide over the local ranks and every rank
        takes the whole batch (the JAX package replicates it then,
        ``engine.py:367-388``)."""
        if n % self.local_size:
            return None
        per = n // self.local_size
        return slice(self.local_rank * per, (self.local_rank + 1) * per)


_TOPOLOGY: Optional[Topology] = None


def choose_backend(device: torch.device, local_size: int, store=None, rank: int = 0,
                   world: int = 1) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``: on the
    CPU, when a node's local ranks outnumber its cards, or when ranks of
    several nodes on one host share a card (each rank posts its card's UUID
    to the rendezvous ``store`` and reads every rank's)."""
    if device.type != "cuda" or local_size > torch.cuda.device_count():
        return "gloo"
    if store is None:
        return "nccl"
    props = torch.cuda.get_device_properties(device)
    store.set(f"brats21/card/{rank}", str(getattr(props, "uuid", "")) or
              f"{os.uname().nodename}/{device.index}")
    cards = {store.get(f"brats21/card/{r}") for r in range(world)}
    return "nccl" if len(cards) == world else "gloo"


def init_topology(device_spec: str = "0") -> Topology:
    """The run's :class:`Topology`. One process (no ``torchrun``
    environment): ``--device``'s device, no group. Under ``torchrun``: the
    local rank's card is made current, the process group is brought up once
    (:func:`multihost.maybe_initialize_distributed`) with the backend
    :func:`choose_backend` picks, and one group per node is made for the
    data axis."""
    global _TOPOLOGY
    if not multihost.launched():
        return Topology(device=resolve_device(device_spec))
    if _TOPOLOGY is not None:
        return _TOPOLOGY
    local_rank = int(os.environ["LOCAL_RANK"])
    local_size = int(os.environ["LOCAL_WORLD_SIZE"])
    if device_spec.strip().lower() == "cpu":
        device = torch.device("cpu")
    else:
        resolve_device("0")                # raises without CUDA; TF32 off
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    store, rank, world = multihost.rendezvous()
    backend = choose_backend(device, local_size, store, rank, world)
    multihost.maybe_initialize_distributed(backend, store)
    nodes = world // local_size
    node = rank // local_size
    if node != int(os.environ.get("GROUP_RANK", node)) or nodes * local_size != world:
        raise RuntimeError(f"rank {rank} of {world}: expected {nodes} nodes of "
                           f"{local_size} ranks, node-major (GROUP_RANK "
                           f"{os.environ.get('GROUP_RANK')})")
    local_group = None
    for n in range(nodes):             # every rank makes every group, in order
        g = dist.new_group(list(range(n * local_size, (n + 1) * local_size)))
        if n == node:
            local_group = g
    _TOPOLOGY = Topology(rank=rank, world_size=world, node=node, nodes=nodes,
                         local_rank=local_rank, local_size=local_size, device=device,
                         backend=backend,
                         local_group=local_group if local_size > 1 else None,
                         batch_group=dist.new_group(list(range(world))), store=store)
    logger.info("rank %d/%d: node %d/%d, local rank %d/%d on %s, backend %s",
                rank, world, node, nodes, local_rank, local_size, device, backend)
    return _TOPOLOGY


def forget_topology() -> None:
    """Drop the cached topology (its process group is gone)."""
    global _TOPOLOGY
    _TOPOLOGY = None


# ---------------------------------------------------------------------------
# the global batch's sums
# ---------------------------------------------------------------------------

_BATCH_GROUP: Optional[dist.ProcessGroup] = None
_BATCH_ACTIVE = False


@contextlib.contextmanager
def batch_group(group: Optional[dist.ProcessGroup], active: bool = True) -> Iterator[None]:
    """Within the block, :func:`batch_sum` all-reduces over ``group`` when
    ``active``: the group's ranks each hold a slice of one global batch."""
    global _BATCH_GROUP, _BATCH_ACTIVE
    saved = _BATCH_GROUP, _BATCH_ACTIVE
    _BATCH_GROUP, _BATCH_ACTIVE = group, bool(active)
    try:
        yield
    finally:
        _BATCH_GROUP, _BATCH_ACTIVE = saved


def batch_sharded() -> bool:
    """Whether the code runs on a slice of a global batch (:func:`batch_group`)."""
    return _BATCH_ACTIVE


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks that share the global batch, through the
    autograd-aware all-reduce (its backward sums the ranks' gradients, so
    DDP's average of them is the global batch's gradient); ``t`` itself
    outside :func:`batch_group`."""
    if not _BATCH_ACTIVE:
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t, group=_BATCH_GROUP)

