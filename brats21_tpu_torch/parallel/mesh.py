"""The ranks of a run, their devices and the process groups of its axes.

Port of ``brats21_tpu/parallel/mesh.py``: the JAX package's mesh of a
process's local devices, shaped ``(data, space)``, is a node's local ranks
here (:class:`Topology`), local rank ``r`` at data index ``r // space`` and
space index ``r % space``, so the ranks of one space row are adjacent. The
node's group carries the data axis; each space row has a group of its own,
over which a volume is sharded on Z (``parallel/spatial.py``). The CLIs
build ``space=1``, as the JAX CLIs do. Each local rank runs on
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
    sums (apart from DDP's own, so their collectives never interleave), the
    rendezvous store, and the spatial axis: ``space`` ranks a row, this
    rank's index in its row and the row's group (None at ``space=1``)."""

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
    space: int = 1
    space_rank: int = 0
    space_group: Optional[dist.ProcessGroup] = None

    @property
    def distributed(self) -> bool:
        return self.world_size > 1

    @property
    def data_rank(self) -> int:
        """This rank's index on the node's data axis."""
        return self.local_rank // self.space

    @property
    def data_size(self) -> int:
        """The node's data axis: its local ranks over the space axis."""
        return self.local_size // self.space

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


def init_topology(device_spec: str = "0", space: int = 1) -> Topology:
    """The run's :class:`Topology`. One process (no ``torchrun``
    environment): ``--device``'s device, no group. Under ``torchrun``: the
    local rank's card is made current, the process group is brought up once
    (:func:`multihost.maybe_initialize_distributed`) with the backend
    :func:`choose_backend` picks, one group per node is made for the data
    axis and, with ``space > 1``, one per space row (``space`` adjacent
    local ranks; it must divide the node's local ranks)."""
    global _TOPOLOGY
    if not multihost.launched():
        if space != 1:
            raise ValueError(f"space={space} needs ranks under torchrun")
        return Topology(device=resolve_device(device_spec))
    if _TOPOLOGY is not None:
        if _TOPOLOGY.space != space:
            raise ValueError(f"the topology was made with space={_TOPOLOGY.space}, "
                             f"not {space}")
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
    if space < 1 or local_size % space:
        raise ValueError(f"space={space} does not divide the node's {local_size} local ranks")
    local_group = None
    for n in range(nodes):             # every rank makes every group, in order
        g = dist.new_group(list(range(n * local_size, (n + 1) * local_size)))
        if n == node:
            local_group = g
    batch_group = dist.new_group(list(range(world)))
    space_group = None
    if space > 1:
        for first in range(0, world, space):        # the rows, node by node
            g = dist.new_group(list(range(first, first + space)))
            if first == rank - rank % space:
                space_group = g
    _TOPOLOGY = Topology(rank=rank, world_size=world, node=node, nodes=nodes,
                         local_rank=local_rank, local_size=local_size, device=device,
                         backend=backend,
                         local_group=local_group if local_size > 1 else None,
                         batch_group=batch_group, store=store, space=space,
                         space_rank=local_rank % space, space_group=space_group)
    logger.info("rank %d/%d: node %d/%d, local rank %d/%d (data %d/%d, space %d/%d) on %s, "
                "backend %s", rank, world, node, nodes, local_rank, local_size,
                local_rank // space, local_size // space, local_rank % space, space, device,
                backend)
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

