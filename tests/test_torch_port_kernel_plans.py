"""The host-side pieces the port's CUDA kernels depend on, on the CPU: the
conv's weight packing and launch plan, and EvoNorm's split statistics with
their fp64 merge, each held against the plain version and the JAX
package's XLA reference on the same numpy inputs. The kernels themselves
run only on a card (tests/test_torch_port_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from brats21_tpu_torch.ops.kernels.conv3d import (NUM_SMS, conv3x3x3_plain, conv_plan,
                                                  pack_weights)
from brats21_tpu_torch.ops.kernels.evonorm import EvoPlan, evonorm_plan, evonorm_s0_plain


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread per test process (see
    tests/test_torch_port_kernels.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _conv_via_packed(x, w, b):
    """The convolution as the bf16 kernel contracts it: the implicit im2col
    (x zero-padded by one voxel and to the plan's C_in, 27 shifted windows)
    against the packed weights read through pack_weights' index map."""
    n, d, h, wd, c_in = x.shape
    c_out = w.shape[-1]
    plan = conv_plan(n, d, h, wd, c_in, c_out)
    xp = F.pad(x, (0, plan.c_in - c_in, 1, 1, 1, 1, 1, 1))
    cols = torch.stack([xp[:, kd:kd + d, kh:kh + h, kw:kw + wd]
                        for kd in range(3) for kh in range(3) for kw in range(3)], dim=4)
    cols = cols.reshape(n, d, h, wd, 27, plan.chunks, 2, 8)
    packed = pack_weights(w, plan).reshape(plan.n_tiles, plan.chunks, 27, 2,
                                           plan.bn // 8, 8, 8)
    y = torch.einsum("zdhwtcak,nctagjk->zdhwngj", cols, packed)
    return y.reshape(n, d, h, wd, plan.c_out)[..., :c_out] + b


@pytest.mark.parametrize("c_out", [24, 48, 136])
@pytest.mark.parametrize("c_in", [4, 8, 24])
def test_packed_weights_contract_to_the_plain_conv(c_in, c_out):
    """C_in 4 (padded to 16), 8, 24 (padded to 32); C_out 24 and 48 (one
    48-wide tile), 136 (one 192-wide tile, padded): in float64 equal to
    conv3x3x3_plain to rounding, and to the JAX package's _conv3x3x3_xla
    within 1e-4."""
    from brats21_tpu.ops.pallas.conv3d_kernel import _conv3x3x3_xla
    rng = np.random.default_rng(c_in * 1000 + c_out)
    x = rng.standard_normal((1, 3, 5, 4, c_in)).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, 3, c_in, c_out))).astype(np.float32)
    b = rng.standard_normal(c_out).astype(np.float32)
    got = _conv_via_packed(*(torch.from_numpy(a).double() for a in (x, w, b)))
    plain = conv3x3x3_plain(*(torch.from_numpy(a).double() for a in (x, w, b)))
    torch.testing.assert_close(got, plain, rtol=0, atol=1e-10)
    want = np.asarray(_conv3x3x3_xla(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


# (B, D, H, W, C_in, C_out): the served case (padded 200×200×136) and the
# 128³ train patch at each level of EquiUnetASSPEvo w48, and the card
# tests' ragged shapes
_LEVEL_CONVS = [(1, 4, 48), (1, 48, 48), (2, 96, 96), (3, 192, 192), (4, 384, 384)]
PLAN_SHAPES = sorted({(1, *(s // 2 ** (lvl - 1) for s in vol), ci, co)
                      for vol in ((200, 200, 136), (128, 128, 128))
                      for lvl, ci, co in _LEVEL_CONVS} | {
    (1, 6, 11, 7, 5, 9), (2, 5, 16, 8, 4, 6), (1, 4, 13, 17, 3, 4), (1, 9, 10, 11, 48, 48),
    (1, 8, 8, 8, 4, 48), (1, 7, 9, 5, 16, 24), (1, 6, 6, 6, 384, 384), (1, 7, 9, 5, 96, 96),
    (1, 5, 6, 7, 8, 136), (1, 3, 5, 3, 32, 48), (1, 1, 12, 10, 48, 48),
    (1, 4, 9, 10, 192, 192), (2, 3, 9, 17, 96, 96), (1, 16, 16, 16, 384, 384)})


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_conv_plan_covers_every_output_once(shape):
    """Decoding every block as the kernel does (blockIdx.x → brick, y → N
    tile, z → K split), each output voxel, each output channel and each K
    chunk is covered exactly once; K is split exactly where the grid is
    under one wave and there is more than one chunk."""
    b, d, h, w, c_in, c_out = shape
    plan = conv_plan(b, d, h, w, c_in, c_out)
    assert plan.c_in % 16 == 0 and 0 <= plan.c_in - c_in < 16
    assert plan.bn in (48, 96, 192) and plan.c_out == plan.bn * plan.n_tiles
    assert 0 <= plan.c_out - c_out < plan.bn
    nd, nh, nw = plan.bricks_dhw
    assert plan.bricks == b * nd * nh * nw
    idx = np.arange(plan.bricks)
    wx, hy, dz, bb = idx % nw, idx // nw % nh, idx // (nw * nh) % nd, idx // (nw * nh * nd)
    count = np.zeros((b, d, h, w), np.int32)
    bd, bh, bw = plan.brick
    assert plan.brick == ((4 if plan.bn == 48 else 2), 8, 8)
    for i in range(plan.bricks):
        d0, h0, w0 = dz[i] * bd, hy[i] * bh, wx[i] * bw
        count[bb[i], d0:d0 + bd, h0:h0 + bh, w0:w0 + bw] += 1
    assert (count == 1).all()
    channels = np.zeros(plan.c_out, np.int32)
    for nt in range(plan.n_tiles):
        channels[nt * plan.bn:(nt + 1) * plan.bn] += 1
    assert (channels == 1).all()
    chunks = np.zeros(plan.chunks, np.int32)
    for z in range(plan.splits):
        run = range(z * plan.chunks_per_split,
                    min(plan.chunks, (z + 1) * plan.chunks_per_split))
        assert len(run) > 0
        chunks[run.start:run.stop] += 1
    assert (chunks == 1).all()
    under_a_wave = plan.bricks * plan.n_tiles < NUM_SMS
    assert (plan.splits > 1) == (under_a_wave and plan.chunks > 1)


def test_conv_plan_splits_the_deep_train_level():
    """16³×384 at 128³: 32 bricks × 2 N tiles is half a wave, split in two."""
    plan = conv_plan(1, 16, 16, 16, 384, 384)
    assert (plan.bricks, plan.n_tiles, plan.splits, plan.chunks_per_split) == (32, 2, 2, 12)


def _evonorm_via_partials(x, gamma, beta, plan, groups=8, eps=1e-5):
    """EvoNorm-S0 as the CUDA kernels compute it: row r of a sample goes to
    block ((s − 1 − r) // rpi) % blocks; each block writes one fp32 (n, mean, M2)
    partial per group (the kernel's fp32 Welford, here exact in float64
    and rounded once); the partials merge in float64 into the group's
    mean and M2 = Σ M2_p + Σ n_p·(mean_p − mean)²; inv is rounded to fp32
    and the formula applied in fp32."""
    b, c = x.shape[0], x.shape[-1]
    g = min(groups, c)
    xf = x.reshape(b, -1, c).double()
    s = xf.shape[1]
    block = ((s - 1 - torch.arange(s)) // plan.rpi) % plan.blocks
    inv = torch.empty(b, c, dtype=torch.float32)
    for k in range(b):
        parts = []
        for p in range(plan.blocks):
            rows = xf[k, block == p].reshape(-1, g, c // g).transpose(0, 1).reshape(g, -1)
            n = torch.full((g,), float(rows.shape[1]), dtype=torch.float64)
            mean = rows.sum(dim=1) / n.clamp(min=1)     # a block with no row adds nothing
            m2 = ((rows - mean[:, None]) ** 2).sum(dim=1)
            parts.append(torch.stack([n, mean.float().double(), m2.float().double()]))
        n_p, mean_p, m2_p = torch.stack(parts).unbind(1)         # [blocks, g] each
        n = n_p.sum(0)
        mean = (n_p * mean_p).sum(0) / n
        m2 = m2_p.sum(0) + (n_p * (mean_p - mean) ** 2).sum(0)
        var = m2 / torch.clamp(n - 1, min=1)
        inv[k] = (1.0 / torch.sqrt(var + eps)).float().repeat_interleave(c // g)
    xf = x.reshape(b, -1, c).float()
    out = xf * torch.sigmoid(xf) * inv[:, None] * gamma + beta
    return out.reshape(x.shape)


EVO_PLAN_CASES = [((1, 5, 6, 7), 8), ((3, 7, 11, 13), 8), ((2, 9, 7, 5), 24),
                  ((1, 17, 13, 11), 48), ((2, 4, 5, 3), 384)]


@pytest.mark.parametrize("stride_blocks", [None, 3])
@pytest.mark.parametrize("spatial,c", EVO_PLAN_CASES)
def test_evonorm_partials_merge_to_the_plain_version(spatial, c, stride_blocks):
    """Ragged row counts (210 to 1001 rows a sample), C ∈ {8, 24, 48, 384}
    (one to 48 channels a group), the launch plan's blocks and three
    blocks striding over many rows each: within 1e-6 relative of
    evonorm_s0_plain and of the JAX package's _evonorm_s0_xla."""
    from brats21_tpu.ops.pallas.evonorm_kernel import _evonorm_s0_xla
    rng = np.random.default_rng(c + sum(spatial))
    x = (0.5 + 2.0 * rng.standard_normal((*spatial, c))).astype(np.float32)
    gamma = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    b, s = spatial[0], int(np.prod(spatial[1:]))
    plan = evonorm_plan(b, s, c, 4)
    if stride_blocks is not None:
        plan = EvoPlan(plan.vec, plan.tpr, plan.rpi, stride_blocks, stride_blocks)
    xt, gt, bt = map(torch.from_numpy, (x, gamma, beta))
    got = _evonorm_via_partials(xt, gt, bt, plan)
    plain = evonorm_s0_plain(xt, gt, bt)
    tol = 1e-6 * plain.abs().max().item()
    torch.testing.assert_close(got, plain, rtol=1e-6, atol=tol)
    want = np.asarray(_evonorm_s0_xla(jnp.asarray(x), jnp.asarray(gamma),
                                      jnp.asarray(beta), 8, 1e-5))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=tol)


@pytest.mark.parametrize("c,itemsize,align,vec", [
    (48, 2, 16, 8), (24, 2, 16, 8), (8, 2, 16, 8), (384, 2, 16, 8), (96, 4, 16, 4),
    (6, 2, 16, 2), (12, 4, 16, 4), (48, 2, 4, 2), (5, 4, 16, 1)])
def test_evonorm_plan_vectors(c, itemsize, align, vec):
    """16-byte channel vectors where C and the address allow, else the
    widest that divides both; every row lane covers all C channels and no
    block is left without a row."""
    plan = evonorm_plan(2, 1000, c, itemsize, align)
    assert plan.vec == vec and plan.tpr * plan.vec == c
    assert plan.rpi == 256 // plan.tpr
    for blocks in (plan.blocks, plan.apply_blocks):
        assert 1 <= blocks and (blocks - 1) * plan.rpi < 1000
