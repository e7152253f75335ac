"""TTA-, window- and member-parallel evaluation over a node's local ranks.

Port of ``brats21_tpu/parallel/distributed.py:1-188`` without the spatial
axis. Where the JAX package maps one jitted function over the ``data`` axis
of its local mesh (``shard_map`` with a ``psum``), each local rank here
runs its share as plain eager code through the kernels and one
``all_reduce`` over the node's group (:class:`~.mesh.Topology`) merges the
shares; every rank ends with the whole result.

* :func:`sharded_tta_probs`: the 8 (flip, rot) combos of each axis order go
  round-robin to the ranks; probabilities (and the loss with a target) are
  summed over the ranks and divided by the 16 combos;
* :func:`sharded_sliding_window`: rank d takes the windows ``d::n`` of the
  padded grid; the weighted sums and the count map are summed;
* :func:`gather_members`: the members' probabilities and losses of a
  member-striped STAPLE ensemble, each rank's in its slots of one zeroed
  stack, summed (adding zeros is exact).

Each is exact up to the order of float additions.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops import tta as tta_ops
from ..ops.sliding_window import stitch_windows

LocalGroup = Tuple[Optional[dist.ProcessGroup], int, int]   # (group, rank, size)


def all_reduce_sum(t: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """``t`` summed over ``group``'s ranks, in place."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def sharded_tta_probs(apply_fn: Callable[[torch.Tensor], Any], x: torch.Tensor,
                      local: LocalGroup, criterion: Optional[Callable] = None,
                      target: Any = None, num_classes: int = 3
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`~..ops.tta.tta_mean_probs` with each axis order's 8 (flip,
    rot) combos striped over the ranks of ``local`` (rank d: combos
    ``d::n`` of each order); the sums of probabilities and losses are
    summed over the ranks before the division by the 16 combos."""
    group, rank, size = local

    def select(combos):
        return [c for axe in tta_ops.AXES
                for c in [k for k in combos if k[0] == axe][rank::size]]

    return tta_ops.tta_mean_probs(apply_fn, x, criterion, target, num_classes=num_classes,
                                  select=select, reduce=lambda t: all_reduce_sum(t, group))


def sharded_sliding_window(inputs: torch.Tensor, roi_size: Sequence[int],
                           predictor: Callable[[torch.Tensor], Any], local: LocalGroup,
                           out_channels: int, sw_batch_size: int = 2,
                           overlap: float = 0.25, mode: str = "constant") -> torch.Tensor:
    """:func:`~..ops.sliding_window.sliding_window_inference` with the
    window grid striped over the ranks of ``local`` (rank d: windows
    ``d::n``); the weighted sums and the count map are summed over the
    ranks before the division. ``out_channels`` is the predictor's, for a
    rank left without a window."""
    group, rank, size = local
    return stitch_windows(inputs, roi_size, predictor, sw_batch_size, overlap, mode,
                          select=lambda starts: starts[rank::size],
                          reduce=lambda t: all_reduce_sum(t, group),
                          out_channels=out_channels)


def gather_members(n_members: int, mine: Sequence[int],
                   results: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                   shape: Sequence[int], device: torch.device,
                   local: LocalGroup) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Every member's (probabilities of ``shape``, loss) on every rank, from
    each rank's ``results`` for its members ``mine`` (none on a rank when
    the members are fewer than the ranks)."""
    numel = int(torch.Size(shape).numel())
    stack = torch.zeros((n_members, numel + 1), dtype=torch.float32, device=device)
    for m, (p, l) in zip(mine, results):
        stack[m, :numel] = p.reshape(-1)
        stack[m, numel] = l
    all_reduce_sum(stack, local[0])
    return [(stack[m, :numel].reshape(tuple(shape)), stack[m, numel])
            for m in range(n_members)]
