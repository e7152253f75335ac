"""The slab context: a volume sharded on Z over the ranks of a space group.

The JAX package shards axis 3 (Z) of ``[B, X, Y, Z, C]`` over its mesh's
``space`` axis and lets GSPMD insert the halo exchanges of every windowed
op and the all-reduces of every global reduction
(``brats21_tpu/parallel/distributed.py:196-257``). The port runs each
rank's slab through the model's own layers under :func:`sharded`, and the
layers consult :func:`active`: outside the context every layer is
unchanged; inside it

* a convolution takes a halo of its reach from the slabs beside it
  (:func:`exchange_planes`) and runs VALID on the sharded axis — the 3³
  conv of the hand-written kernel runs SAME on the extended slab and drops
  its outer planes; a strided conv's slab is aligned to its stride;
* the pools, the nearest upsamples and the transposed convs (kernel =
  stride) stay local, since every slab starts at a multiple of the model's
  downsampling factor (its ``spatial_factor``, :func:`slab_bounds`); where
  Z is not a multiple of it the last slab holds the partial block, so a
  ceil-mode pool's partial window falls only at the volume's end;
* the global pools all-reduce their sums (or maxima), the norms their
  per-group (count, mean, M2) (:func:`merge_moments`, fp64, merged in rank
  order on every rank);
* a trilinear resize interpolates the sharded axis from global
  coordinates to any global size (``align_corners=True`` reads
  ``o·(N_in−1)/(N_out−1)``) with the halo its ratio needs
  (:func:`resize_sharded_axis`);
* what mixes every position (the ViT's attention, the VAE's Linear layers)
  gathers its keys and values, or its latent, over the space group.

The sharded axis is torch dim 4 (W) of NCDHW. A layer finds its level's
global extent from its slab's size and its D (:meth:`Slab.level`). The
path is eval only, as the JAX package's (GSPMD under ``jit``, no
backward): :func:`active` raises with grad enabled. gloo carries no CUDA
tensor, so on a gloo group every exchange and gather is staged through the
host.
"""

from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: :func:`slab_bounds`' default alignment: the downsampling factor of the
#: models that pool three times (the Z-sharded forward cuts at each model's
#: own ``spatial_factor``)
BLOCK = 8


def slab_bounds(z: int, size: int, factor: int = BLOCK,
                multiple: Optional[int] = None) -> List[int]:
    """The first plane of each of ``size`` slabs of a (padded) Z of ``z``
    planes, and the end: cut at multiples of ``factor`` (the model's
    downsampling factor), as equal as that allows, the larger slabs first
    (136 planes on 2 ranks at 8: 72 + 64; 16 on 4: 8 + 8 + 0 + 0, the empty
    slabs' ranks joining every collective). Z must be a multiple of
    ``multiple`` (``factor`` unless given: what the model's own forward
    takes); where it is not one of ``factor``, the last non-empty slab holds
    the partial block (136 on 2 ranks at 16: 80 + 56), so that a ceil-mode
    pool's partial window falls only at the volume's end."""
    multiple = factor if multiple is None else multiple
    if z % multiple or z <= 0:
        raise ValueError(f"a Z-sharded volume needs Z padded to a multiple of {multiple} (the "
                         f"model's downsampling factor), got Z = {z} on {size} ranks")
    per, extra = divmod(-(-z // factor), size)
    bounds = [0]
    for r in range(size):
        bounds.append(min(bounds[-1] + (per + (r < extra)) * factor, z))
    return bounds


@functools.lru_cache(maxsize=4096)
def _level_sizes(bounds: Tuple[int, ...], depth: int, factor: int, rank: int, n: int,
                 level_depth: int) -> Tuple[int, ...]:
    """Every slab's size at the level where this rank's slab has ``n``
    planes and the volume's D is ``level_depth``: the ratio d (a power of
    two from 1/16 to ``factor``) whose slabs, cut at the input's bounds / d
    with the last rounded up (ceil-mode pools, strided convs), give this
    rank ``n`` planes and whose D, the input's ``depth`` / d rounded either
    way, is ``level_depth`` (every model of the zoo scales D and Z alike)."""
    found = set()
    k = -4
    while Fraction(2) ** k <= factor:
        d = Fraction(2) ** k
        k += 1
        ends = [b / d for b in bounds]
        if any(e.denominator != 1 for e, a, b in zip(ends, bounds, bounds[1:]) if a < b):
            continue                      # a non-empty slab starts off this level's planes
        ends = [math.ceil(e) for e in ends]
        sizes = tuple(b - a for a, b in zip(ends, ends[1:]))
        if sizes[rank] == n and level_depth in (math.floor(depth / d), math.ceil(depth / d)):
            found.add(sizes)
    if len(found) != 1:
        raise ValueError(f"a slab of {n} planes (D {level_depth}) on rank {rank} of bounds "
                         f"{list(bounds)}: the level is "
                         + ("finer than the slabs' alignment" if not found else
                            f"ambiguous ({sorted(found)})"))
    return found.pop()


@dataclass(frozen=True)
class Slab:
    """This rank's slab of the padded volume: the space group, this rank's
    index in it, every slab's bounds in planes of the model's input
    (:func:`slab_bounds`), the input's D and the model's downsampling
    factor (the coarsest level's ratio)."""

    group: Optional[dist.ProcessGroup]
    rank: int
    bounds: Tuple[int, ...]
    depth: int
    factor: int

    def sizes_at(self, n: int, level_depth: int) -> Tuple[int, List[int]]:
        """(this slab's first plane, every slab's size) at the level where
        this rank holds ``n`` planes and D is ``level_depth``
        (:func:`_level_sizes`); raises where no level of the model fits."""
        sizes = list(_level_sizes(tuple(self.bounds), self.depth, self.factor, self.rank, n,
                                  level_depth))
        return sum(sizes[:self.rank]), sizes

    def level(self, x: torch.Tensor) -> Tuple[int, List[int]]:
        """:meth:`sizes_at` the level of the NCDHW slab ``x``."""
        return self.sizes_at(x.shape[4], x.shape[2])


_ACTIVE: Optional[Slab] = None


@contextlib.contextmanager
def sharded(slab: Slab) -> Iterator[None]:
    """Within the block the model's layers run on ``slab``."""
    global _ACTIVE
    saved = _ACTIVE
    _ACTIVE = slab
    try:
        yield
    finally:
        _ACTIVE = saved


def active() -> Optional[Slab]:
    """The slab the layers run on, or None outside :func:`sharded`. Raises
    with grad enabled: the spatial path is eval only."""
    if _ACTIVE is not None and torch.is_grad_enabled():
        raise RuntimeError("the Z-sharded forward is eval only: run it without grad")
    return _ACTIVE


# ---------------------------------------------------------------------------
# communication over a space group
# ---------------------------------------------------------------------------

def _staged(t: torch.Tensor, group: Optional[dist.ProcessGroup]) -> bool:
    """Whether ``t`` crosses ``group`` through the host: gloo carries no
    CUDA tensor."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def exchange_planes(x: torch.Tensor, lo: int, hi: int, group: Optional[dist.ProcessGroup],
                    dim: int, sizes: Sequence[int]) -> torch.Tensor:
    """``x`` (this rank's slab along ``dim``; ``sizes`` every rank's, in
    group order) with the ``lo`` planes before it and the ``hi`` planes
    after it concatenated, zero planes beyond the volume. A halo may reach
    past the next slab: each plane comes from the rank that holds it, by
    non-blocking sends and receives in one batch (at most one message a
    pair of ranks), so no two ranks block on each other.
    Every rank of ``group`` must call it with the same ``lo``, ``hi`` and
    ``sizes``."""
    if lo == 0 and hi == 0:
        return x
    rank, n = dist.get_rank(group), len(sizes)
    starts = [0]
    for s in sizes:
        starts.append(starts[-1] + s)
    total = starts[-1]

    def wanted(r):
        return [(max(starts[r] - lo, 0), starts[r]), (starts[r + 1], min(starts[r + 1] + hi,
                                                                          total))]

    def held_by(ranges, q):
        return [(max(a, starts[q]), min(b, starts[q + 1])) for a, b in ranges
                if max(a, starts[q]) < min(b, starts[q + 1])]

    stage = _staged(x, group)
    ops, pieces = [], {}
    for q in range(n):
        if q == rank:
            continue
        peer = dist.get_global_rank(group, q) if group is not None else q
        for a, b in held_by(wanted(q), rank):
            t = x.narrow(dim, a - starts[rank], b - a).contiguous()
            ops.append(dist.P2POp(dist.isend, t.cpu() if stage else t, peer, group))
        for a, b in held_by(wanted(rank), q):
            shape = list(x.shape)
            shape[dim] = b - a
            pieces[a] = torch.empty(shape, dtype=x.dtype, device="cpu" if stage else x.device)
            ops.append(dist.P2POp(dist.irecv, pieces[a], peer, group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    def zeros(k):
        shape = list(x.shape)
        shape[dim] = k
        return [torch.zeros(shape, dtype=x.dtype, device=x.device)] if k else []

    left = [pieces[a].to(x.device) for a in sorted(pieces) if a < starts[rank]]
    right = [pieces[a].to(x.device) for a in sorted(pieces) if a >= starts[rank + 1]]
    return torch.cat(zeros(max(lo - starts[rank], 0)) + left + [x] + right
                     + zeros(max(starts[rank + 1] + hi - total, 0)), dim)


def all_gather(t: torch.Tensor, group: Optional[dist.ProcessGroup]) -> List[torch.Tensor]:
    """Every rank's ``t`` (one shape on every rank), in group order."""
    stage = _staged(t, group)
    src = (t.cpu() if stage else t).contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out]


def gather_planes(t: torch.Tensor, group: Optional[dist.ProcessGroup], dim: int,
                  sizes: Sequence[int]) -> torch.Tensor:
    """The slabs of every rank (``sizes`` along ``dim``) concatenated in
    group order: the whole volume, on every rank."""
    widest = max(sizes)
    pad = widest - t.shape[dim]
    if pad:
        shape = list(t.shape)
        shape[dim] = pad
        t = torch.cat([t, torch.zeros(shape, dtype=t.dtype, device=t.device)], dim)
    parts = all_gather(t, group)
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim)


def all_reduce(t: torch.Tensor, group: Optional[dist.ProcessGroup],
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group``'s ranks (a new tensor)."""
    stage = _staged(t, group)
    out = t.cpu() if stage else t.clone()
    dist.all_reduce(out, op=op, group=group)
    return out.to(t.device)


def chan_merge(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``[..., 3]`` (count, mean, M2) statistics of disjoint parts merged
    in order by Chan's formula, in fp64."""
    n, mean, m2 = parts[0].double().unbind(-1)
    for part in parts[1:]:
        nb, mb, m2b = part.double().unbind(-1)
        tot = n + nb
        d = mb - mean
        f = torch.where(tot > 0, nb / tot.clamp(min=1), torch.zeros_like(tot))
        mean = mean + d * f
        m2 = m2 + m2b + d * d * n * f
        n = tot
    return torch.stack([n, mean, m2], -1)


def merge_moments(stats: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """This rank's ``[..., 3]`` (count, mean, M2) merged with every rank's
    of ``group`` (:func:`chan_merge`, in rank order on every rank, so every
    rank holds the same statistics)."""
    return chan_merge(all_gather(stats.double(), group))


def group_moments(xg: torch.Tensor, slab: Slab) -> torch.Tensor:
    """(count, mean, M2) ``[B, G, 3]`` fp64 over the whole volume of a
    sharded ``xg`` ``[B, rows, G, K]`` (fp32): this slab's, then merged."""
    b, rows, g, k = xg.shape
    if rows * k == 0:                       # an empty slab: no count
        mean = m2 = xg.new_zeros((b, g))
    else:
        mean = xg.mean(dim=(1, 3))
        m2 = (xg - mean[:, None, :, None]).square().sum(dim=(1, 3))
    count = torch.full_like(mean, float(rows * k))
    return merge_moments(torch.stack([count, mean, m2], -1), slab.group)


# ---------------------------------------------------------------------------
# layers' sharded forms
# ---------------------------------------------------------------------------

def halo(x: torch.Tensor, lo: int, hi: int, slab: Slab) -> torch.Tensor:
    """An NCDHW slab extended by ``lo``/``hi`` planes on W, as a fresh
    tensor in the kernels' contiguous ``[B, D, H, W, C]`` layout (the
    hand-written kernels' contract)."""
    xk = x.permute(0, 2, 3, 4, 1)
    _, sizes = slab.level(x)
    ext = exchange_planes(xk, lo, hi, slab.group, 3, sizes)
    return ext if ext.is_contiguous() else ext.contiguous()


def conv_reach(kernel: int, dilation: int, padding: int, stride: int, start: int, n: int,
               total: int) -> Tuple[int, int]:
    """(planes before, planes after) a slab's conv needs on the sharded
    axis to give its own outputs; raises where a strided conv's non-empty
    slab is not aligned to the stride."""
    out_total = (total + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1
    if stride != 1 and n and (start % stride or n % stride or out_total * stride != total):
        raise ValueError(f"a conv of stride {stride} on a slab of planes [{start}, "
                         f"{start + n}) of {total}: the slab is not aligned to the stride")
    return padding, dilation * (kernel - 1) - padding - stride + 1


def check_pool(x: torch.Tensor, window: int, stride: int, slab: Slab,
               ceil_mode: bool = False) -> None:
    """A pool stays local where its slab starts and ends on a window; a
    ceil-mode pool's partial window may end the volume's last slab (an
    empty slab has nothing to pool)."""
    start, sizes = slab.level(x)
    end = start + x.shape[4]
    if window != stride or x.shape[4] and (start % window or (
            x.shape[4] % window and not (ceil_mode and end == sum(sizes)))):
        raise ValueError(f"a pool of window {window}, stride {stride} on a slab of "
                         f"planes [{start}, {end}) of {sum(sizes)}: not aligned")


def source_planes(out: torch.Tensor, n_in: int, n_out: int,
                  align_corners: bool) -> torch.Tensor:
    """The fp32 source coordinate of each output plane ``out`` of a linear
    resize of ``n_in`` planes to ``n_out``, as PyTorch's kernels compute
    it (fp32 scale; ``align_corners``: o·(n_in−1)/(n_out−1), else
    max((o + ½)·n_in/n_out − ½, 0))."""
    n = torch.tensor(float(n_in), dtype=torch.float32)
    if align_corners:
        return (n - 1) / (n_out - 1) * out if n_out > 1 else out * 0
    return (n / n_out * (out + 0.5) - 0.5).clamp(min=0.0)


def resize_sharded_axis(x: torch.Tensor, out_sizes: Sequence[int], align_corners: bool,
                        slab: Slab) -> torch.Tensor:
    """Linear interpolation of the sharded axis (W of NCDHW) of every slab
    to ``out_sizes`` (every rank's output planes, whose sum is the
    resized volume's: any size, ×2 as well as a skip's exact shape), from
    global coordinates (:func:`source_planes`), in fp32. Each rank's
    outputs read two planes each; the halo is the widest reach past its
    slab over every rank's outputs (one plane for the zoo's resizes). The
    weights are computed as PyTorch's trilinear kernel computes them
    (w0 = 1 − w1, the upper index clamped), so that the interpolation of
    the other two axes after it (W's weights then 1 and 0) adds in its
    order."""
    start, sizes = slab.level(x)
    n_in, n_out = sum(sizes), sum(out_sizes)
    firsts = [sum(out_sizes[:q]) for q in range(len(out_sizes))]
    in_firsts = [sum(sizes[:q]) for q in range(len(sizes))]
    lo = hi = 0
    for q, (a, k) in enumerate(zip(firsts, out_sizes)):
        if k:
            src = source_planes(torch.tensor([float(a), float(a + k - 1)]), n_in, n_out,
                                align_corners)
            first, last = int(src[0].floor()), min(int(src[1].floor()) + 1, n_in - 1)
            lo = max(lo, in_firsts[q] - first)
            hi = max(hi, last - (in_firsts[q] + sizes[q] - 1))
    mine = firsts[slab.rank]
    out = torch.arange(mine, mine + out_sizes[slab.rank], dtype=torch.float32)
    src = source_planes(out, n_in, n_out, align_corners)
    i0 = src.floor()
    i1 = (i0 + 1).clamp(max=n_in - 1)
    w1 = (src - i0).to(x.device)
    ext = halo(x, lo, hi, slab).float()            # global planes start-lo … start+n+hi
    idx0 = (i0 - start + lo).long().to(x.device)
    idx1 = (i1 - start + lo).long().to(x.device)
    y = (1.0 - w1)[:, None] * ext.index_select(3, idx0) + w1[:, None] * ext.index_select(3, idx1)
    return y.permute(0, 4, 1, 2, 3)                # NCDHW view, fp32


def on_empty(fn, x: torch.Tensor, planes: int) -> torch.Tensor:
    """``fn``'s output for an empty slab ``x`` (no planes on the sharded
    axis), which PyTorch's pools, resizes and convs refuse: ``fn`` of
    ``planes`` zero planes, cut to none."""
    return fn(x.new_zeros((*x.shape[:4], planes))).narrow(4, 0, 0)


def _covered() -> Tuple[tuple, tuple]:
    """(the layer classes the slab context covers, those whose children run
    on a globally pooled vector, not on the slab)."""
    from torch import nn

    from ..models import assp_evo, dynunet, equiunet, extra, layers, unet_family, unetr
    covered = (
        # the assp_evo and equiunet lines, CBAM, RefUnet
        assp_evo.EquiUnetASSPEvo, assp_evo.ConvEvoBlockCorrected, assp_evo.ConvEvo,
        assp_evo.SimpleASPPEVO, assp_evo.EvoNorm3D, equiunet.Unet, equiunet.EquiUnet,
        equiunet.AttEquiUnet, equiunet.UBlock, equiunet.UBlockCbam, equiunet.ConvBnRelu,
        equiunet.DeepHead, equiunet.CBAM, equiunet.SpatialGate, equiunet.BasicConv,
        equiunet.RefUnet,
        # the layers
        layers.Conv3d, layers.ConvTranspose3d, layers.WSConv3d, layers.ConvAWS3d,
        layers.GroupNorm, layers.InstanceNorm, layers.BatchNorm, layers.BCNorm, layers.EstBN,
        layers.Dropout, layers.Upsample, layers.UpsampleNearest, layers.Act,
        # the unet family
        unet_family.UnetFamily, unet_family.R2Unet, unet_family.AttUnet,
        unet_family.R2AttUnet, unet_family.ConvBlock, unet_family.UpConv,
        unet_family.RecurrentBlock, unet_family.RRCNNBlock, unet_family.AttentionBlock,
        # the MONAI-backed zoo
        extra.BasicUNet, extra.TwoConv, extra._Down, extra._UpCat, extra.Convolution, extra.ADN,
        extra.SegResNet, extra.SegResNetVAE, extra.ResBlock, extra.HighResNet,
        extra._ConvNormActi, extra.HighResBlock, extra.VNet, extra._LUConv,
        extra._InputTransition, extra._DownTransition, extra._UpTransition,
        extra._OutputTransition, dynunet.DynUNet, dynunet._DynUNetNet, dynunet.UnetBasicBlock,
        dynunet._TranspConv, dynunet.UnetUpBlock, dynunet.UnetOutBlock, unetr.UNETR, unetr.ViT,
        unetr.PatchEmbedding, unetr.TransformerBlock, unetr.MHSA, unetr.MLP,
        unetr.UnetResBlock, unetr.UnetrBasicBlock, unetr.UnetrPrUpBlock, unetr.UnetrUpBlock,
        # per token or per element: the ViT's Linear layers and norms, the
        # VAE's Linear layers on its gathered latent
        layers.Linear, nn.Linear, nn.LayerNorm, nn.Identity, nn.ReLU, nn.Sigmoid,
        nn.Sequential, nn.ModuleList)
    pooled = (assp_evo.ResidualSELayer, equiunet.ChannelGate)
    return covered, pooled


def check_covered(model: torch.nn.Module) -> None:
    """Raises, naming the first layer, where ``model`` holds a layer the
    slab context does not cover (it would compute on its slab alone)."""
    covered, pooled = _covered()

    def walk(module, name):
        if isinstance(module, pooled):
            return                     # its MLP runs on the globally pooled vector
        if type(module) not in covered:
            raise ValueError(f"the Z-sharded forward does not cover layer {name or 'model'} "
                             f"({type(module).__name__})")
        for child_name, child in module.named_children():
            walk(child, f"{name}.{child_name}" if name else child_name)

    walk(model, "")
