"""EvoNorm-S0 forward — three Triton kernels: split group statistics, their
fp64 merge, then one fused apply pass.

Replaces ``brats21_tpu/ops/pallas/evonorm_kernel.py:evonorm_s0_pallas``
(apply body ``_apply_kernel`` :45; the group statistics ``_group_inv_std``
:32 run in XLA there). For each (sample b, group g) with G = min(8, C), the
unbiased variance over the spatial axes × C/G channels (divisor n − 1)
gives inv = rsqrt(var + eps); then out = x·sigmoid(x)·inv·γ + β, all in
fp32, stored in x's dtype.

Bound on the H100: a few operations per element against 2 bytes read and
2 written in bf16, so device memory bounds it. The design moves as few
bytes as the two-pass maths allows. Pass 1 (``_stats_kernel``) splits each
sample's voxels over many programs; each reads its rows [rows × C] once,
keeps per-channel (mean, M2) over its tiles with Chan's merge in fp32, and
writes one partial per channel — never a full fp32 copy of x, which XLA's
reduction materialises on the TPU. ``_merge_kernel`` (one program per
(b, g)) merges the partials in fp64: n reaches ~5·10⁷ elements per group
at full volume, where an fp32 sum of squares would lose the variance.
Pass 2 (``_apply_kernel``) reads x once more, applies the formula in fp32
and writes the output once. Three launches and no other device op keep a
call cheap on the host too, which bounds the small deep levels. There is
no backward yet.

Layout contract (the JAX package's): x ``[B, D, H, W, C]`` contiguous,
gamma and beta ``[C]`` fp32.
"""

from __future__ import annotations

import functools

import torch

#: launches (one per call: stats, merge and apply) since the last reset
launches = 0

STATS_TILES = 16    # tiles of rows merged in registers by one stats program
TILE_ELEMS = 4096   # elements of x one program holds per tile


def evonorm_s0_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """The plain PyTorch version (``_evonorm_s0_xla``): fp32 maths, output
    in x's dtype."""
    b, c = x.shape[0], x.shape[-1]
    g = min(groups, c)
    xf = x.reshape(b, -1, c).float()
    xg = xf.reshape(b, xf.shape[1], g, c // g)
    n = xg.shape[1] * (c // g)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).sum(dim=(1, 3), keepdim=True) / max(n - 1, 1)
    inv = torch.rsqrt(var + eps).expand(b, 1, g, c // g).reshape(b, 1, c)
    out = xf * torch.sigmoid(xf) * inv * gamma.reshape(1, 1, c) \
        + beta.reshape(1, 1, c)
    return out.reshape(x.shape).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernels():
    """The Triton kernels, defined at first use: Triton is imported only
    where a kernel launches."""
    import triton
    import triton.language as tl

    @triton.jit
    def _stats_kernel(x_ptr, mean_ptr, m2_ptr, S, C, n_progs,
                      BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr,
                      TILES: tl.constexpr):
        # program (b, p): rows [p*BLOCK_S*TILES, +BLOCK_S*TILES) of sample b
        b = tl.program_id(0)
        p = tl.program_id(1)
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < C
        row0 = p * (BLOCK_S * TILES)
        mean_a = tl.zeros([BLOCK_C], dtype=tl.float32)
        m2_a = tl.zeros([BLOCK_C], dtype=tl.float32)
        for t in range(TILES):
            start = row0 + t * BLOCK_S
            rows = start + tl.arange(0, BLOCK_S)
            rmask = rows < S
            m = rmask[:, None] & cmask[None, :]
            offs = (b * S + rows).to(tl.int64)[:, None] * C + cols[None, :]
            xt = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
            n_a = tl.minimum(tl.maximum(S - row0, 0), t * BLOCK_S).to(tl.float32)
            n_b = tl.minimum(tl.maximum(S - start, 0), BLOCK_S).to(tl.float32)
            n = n_a + n_b
            mean_b = tl.sum(xt, axis=0) / tl.maximum(n_b, 1.0)
            dev = tl.where(m, xt - mean_b[None, :], 0.0)
            m2_b = tl.sum(dev * dev, axis=0)
            # Chan's merge of (n_a, mean_a, m2_a) with the tile's stats
            delta = mean_b - mean_a
            w_b = n_b / tl.maximum(n, 1.0)
            mean_a = mean_a + delta * w_b
            m2_a = m2_a + m2_b + delta * delta * n_a * w_b
        out = (b * n_progs + p) * C + cols
        tl.store(mean_ptr + out, mean_a, mask=cmask)
        tl.store(m2_ptr + out, m2_a, mask=cmask)

    @triton.jit
    def _apply_kernel(x_ptr, y_ptr, inv_ptr, gamma_ptr, beta_ptr, S, C, R,
                      BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
        # rows [pid*BLOCK_S, +BLOCK_S) of x viewed as [R = B*S, C]
        rows = tl.program_id(0) * BLOCK_S + tl.arange(0, BLOCK_S)
        cols = tl.arange(0, BLOCK_C)
        rmask = rows < R
        cmask = cols < C
        m = rmask[:, None] & cmask[None, :]
        offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
        x = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
        bidx = rows // S
        inv = tl.load(inv_ptr + bidx[:, None] * C + cols[None, :], mask=m, other=0.0)
        gam = tl.load(gamma_ptr + cols, mask=cmask, other=0.0)
        bet = tl.load(beta_ptr + cols, mask=cmask, other=0.0)
        y = x * tl.sigmoid(x) * inv * gam[None, :] + bet[None, :]
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=m)

    @triton.jit(do_not_specialize=["S"])
    def _merge_kernel(mean_ptr, m2_ptr, inv_ptr, S, C, CG, P, ROWS, eps,
                      BLOCK_P: tl.constexpr, BLOCK_CG: tl.constexpr):
        # program (b, g): merge the group's P × CG per-program, per-channel
        # partials in fp64 — the group mean first, then
        # M2 = Σ M2_p + Σ n_p·(mean_p − mean)² — and write the group's
        # inverse std for each of its CG channels
        b = tl.program_id(0)
        g = tl.program_id(1)
        ch = g * CG + tl.arange(0, BLOCK_CG)
        cmask = tl.arange(0, BLOCK_CG) < CG
        n = S.to(tl.float64) * CG
        tot = tl.zeros([BLOCK_P, BLOCK_CG], dtype=tl.float64)
        for p0 in range(0, P, BLOCK_P):
            ps = p0 + tl.arange(0, BLOCK_P)
            m = (ps < P)[:, None] & cmask[None, :]
            cnt = tl.minimum(S - ps * ROWS, ROWS).to(tl.float64)
            offs = (b * P + ps)[:, None] * C + ch[None, :]
            mu_p = tl.load(mean_ptr + offs, mask=m, other=0.0).to(tl.float64)
            tot += tl.where(m, mu_p * cnt[:, None], 0.0)
        mu = tl.sum(tl.sum(tot, axis=1), axis=0) / n
        acc = tl.zeros([BLOCK_P, BLOCK_CG], dtype=tl.float64)
        for p0 in range(0, P, BLOCK_P):
            ps = p0 + tl.arange(0, BLOCK_P)
            m = (ps < P)[:, None] & cmask[None, :]
            cnt = tl.minimum(S - ps * ROWS, ROWS).to(tl.float64)
            offs = (b * P + ps)[:, None] * C + ch[None, :]
            mu_p = tl.load(mean_ptr + offs, mask=m, other=0.0).to(tl.float64)
            m2_p = tl.load(m2_ptr + offs, mask=m, other=0.0).to(tl.float64)
            d = mu_p - mu
            acc += tl.where(m, m2_p + cnt[:, None] * d * d, 0.0)
        var = tl.sum(tl.sum(acc, axis=1), axis=0) / tl.maximum(n - 1.0, 1.0)
        inv = (1.0 / tl.sqrt(var + eps)).to(tl.float32)
        tl.store(inv_ptr + b * C + ch, tl.zeros([BLOCK_CG], tl.float32) + inv,
                 mask=cmask)

    return triton, _stats_kernel, _merge_kernel, _apply_kernel


def _check(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           groups: int) -> None:
    c = x.shape[-1]
    if x.dim() < 3:
        raise ValueError(f"evonorm_s0: x must be [B, ..., C], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"evonorm_s0: unsupported dtype {x.dtype}")
    if gamma.shape != (c,) or beta.shape != (c,) \
            or gamma.dtype != torch.float32 or beta.dtype != torch.float32:
        raise ValueError(f"evonorm_s0: gamma and beta must be fp32 [{c}]")
    if not (x.device == gamma.device == beta.device):
        raise ValueError("evonorm_s0: x, gamma and beta must be on one device")
    if not (x.is_contiguous() and gamma.is_contiguous() and beta.is_contiguous()):
        raise ValueError("evonorm_s0: x, gamma and beta must be contiguous")
    if c % min(groups, c):
        raise ValueError(f"evonorm_s0: {c} channels not divisible by {groups} groups")


def evonorm_s0(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """EvoNorm-S0 of x ``[B, ..., C]`` (channels last), output in x's dtype.
    CPU tensors take :func:`evonorm_s0_plain`; CUDA tensors launch the
    Triton kernels on the current stream."""
    global launches
    if x.device.type == "cpu":
        return evonorm_s0_plain(x, gamma, beta, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"evonorm_s0: no kernel for device {x.device}")
    _check(x, gamma, beta, groups)
    triton, stats_kernel, merge_kernel, apply_kernel = _kernels()
    b, c = x.shape[0], x.shape[-1]
    s = x.numel() // (b * c)
    g = min(groups, c)
    block_c = triton.next_power_of_2(c)
    block_s = max(1, TILE_ELEMS // block_c)
    rows_per_prog = block_s * STATS_TILES
    n_progs = triton.cdiv(s, rows_per_prog)
    # Triton launches on the current device: make it x's
    with torch.cuda.device(x.device):
        mean = torch.empty((b, n_progs, c), dtype=torch.float32, device=x.device)
        m2 = torch.empty_like(mean)
        stats_kernel[(b, n_progs)](x, mean, m2, s, c, n_progs, BLOCK_S=block_s,
                                   BLOCK_C=block_c, TILES=STATS_TILES, num_warps=4)
        block_cg = triton.next_power_of_2(c // g)
        inv = torch.empty((b, c), dtype=torch.float32, device=x.device)
        merge_kernel[(b, g)](mean, m2, inv, s, c, c // g, n_progs, rows_per_prog, eps,
                             BLOCK_P=max(16, 1024 // block_cg), BLOCK_CG=block_cg,
                             num_warps=4)
        y = torch.empty_like(x)
        apply_kernel[(triton.cdiv(b * s, block_s),)](
            x, y, inv, gamma, beta, s, c, b * s, BLOCK_S=block_s, BLOCK_C=block_c,
            num_warps=4)
    launches += 1
    return y
