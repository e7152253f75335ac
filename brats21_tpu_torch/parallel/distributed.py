"""TTA-, window- and member-parallel evaluation over a node's local ranks,
and the volume sharded on Z over a space group.

Port of ``brats21_tpu/parallel/distributed.py``. Where the JAX package
maps one jitted function over the ``data`` axis of its local mesh
(``shard_map`` with a ``psum``), each local rank here
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
  stack, summed (adding zeros is exact);
* :func:`spatial_sharded_forward`: the model on a volume sharded on Z over
  the ranks of a space group, each rank's slab through the layers' sharded
  forms (``parallel/spatial.py``), the heads gathered to every rank;
  :func:`halo_exchange` and :func:`sharded_conv3d` are its building block
  and the JAX package's example of it.

Each is exact up to the order of float additions.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops import tta as tta_ops
from ..ops.sliding_window import stitch_windows
from . import spatial
from .mesh import Topology

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


# ---------------------------------------------------------------------------
# the volume sharded on Z over a space group
# ---------------------------------------------------------------------------

def halo_exchange(x: torch.Tensor, halo: int, group: Optional[dist.ProcessGroup],
                  dim: int = 2, sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Each rank's slab ``x`` along ``dim`` concatenated with ``halo``
    planes from the slabs before and after it, zero planes at the volume's
    edges (JAX ``distributed.py:265-287``; its default axis, X of
    ``[B, X, Y, Z, C]``, is dim 2 of NCDHW). The slabs are equal unless
    ``sizes`` gives every rank's; a halo may be wider than a slab."""
    n = dist.get_world_size(group)
    return spatial.exchange_planes(x, halo, halo, group, dim,
                                   list(sizes) if sizes is not None else [x.shape[dim]] * n)


def sharded_conv3d(x: torch.Tensor, weight: torch.Tensor,
                   group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """SAME conv3d (stride 1, any odd kernel ``[C_out, C_in, kd, kh, kw]``)
    of NCDHW slabs sharded on dim 2 (X) over ``group``: the kernel radius
    exchanged, then VALID on that axis (JAX ``distributed.py:290-312``).
    Exact against the unsharded conv."""
    kd, kh, kw = weight.shape[2:]
    ext = halo_exchange(x, kd // 2, group, dim=2)
    return F.conv3d(ext, weight.to(x.dtype), padding=(0, kh // 2, kw // 2))


def spatial_sharded_forward(model: torch.nn.Module, x: torch.Tensor, topo: Topology,
                            full_outputs: bool = False, no_amp: bool = False) -> Any:
    """The model's heads for a volume ``[B, X, Y, Z, C]`` with Z sharded
    over ``topo``'s space group (JAX ``distributed.py:196-257``): Z is
    zero-padded at its end to a multiple of the group's size (the pad
    enters the global reductions, as the JAX package's does), cut into
    slabs at multiples of the model's downsampling factor (its
    ``spatial_factor``: 8 for the models that pool three times, 16 for
    RefUnet, basic_unet, vnet, segresnetvae and unet_tr, 32 for nnunet, 1
    for highresnet; ``spatial.slab_bounds``). A padded Z that is not a
    multiple of what the model's forward takes (its ``spatial_multiple``,
    else the factor) raises ``ValueError``, where the JAX forward fails at a
    skip's concatenation or nnunet's own check; a RefUnet takes a multiple
    of 8, its last slab holding a partial block of 16; with fewer blocks
    than ranks the last ranks' slabs are empty. This rank's slab runs
    through the model in bf16 (fp32 with ``no_amp``) under the slab
    context, and the heads — the main head (``ops/tta.py:main_head``), or
    every head with ``full_outputs`` — are gathered to every rank of the
    group and un-padded: replicated, ``[B, X, Y, Z, classes]`` each
    (SegResNetVAE's ``vae_loss`` is the whole volume's on every rank).
    Every rank of the group calls it with the whole volume. Eval only: the
    model must be in eval mode and cover only layers the slab context
    covers (``spatial.check_covered``); it runs without grad."""
    if model.training:
        raise ValueError("the Z-sharded forward runs a model in eval mode")
    spatial.check_covered(model)
    n = topo.space
    z = x.shape[3]
    pad = (-z) % n
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    factor = model.spatial_factor
    bounds = spatial.slab_bounds(z + pad, n, factor, getattr(model, "spatial_multiple", factor))
    slab = spatial.Slab(topo.space_group, topo.space_rank, tuple(bounds), x.shape[1], factor)
    part = x[:, :, :, bounds[slab.rank]:bounds[slab.rank + 1]]
    part = part.to(torch.float32 if no_amp else torch.bfloat16)
    xin = part.permute(0, 4, 1, 2, 3).contiguous(memory_format=torch.channels_last_3d)
    with torch.no_grad(), spatial.sharded(slab):
        out = model(xin, with_deep=full_outputs)
    if not full_outputs:
        out = tta_ops.main_head(out)

    def gather(t):
        _, sizes = slab.level(t)
        return spatial.gather_planes(t.permute(0, 2, 3, 4, 1), slab.group, 3, sizes)[:, :, :, :z]

    return tta_ops.tree_map(gather, out)
