"""The port's hand-written kernels on a card: each CUDA kernel held
against its plain PyTorch version on the same CUDA tensors, at ragged
shapes the main path's level sizes do not reach (odd H/W, C_in = 4, C_out
not a multiple of the tile; EDT lines of odd length, longer than a block,
on every axis, and hand-made edge lines), the EDT mask pass, the batched
HD loss and the loader's distance map, the trainable conv / EvoNorm
against autograd of their plain versions (one conv applied three times
too), the model zoo's conv shapes (the MONAI-backed names' at the levels
of a 128³ patch too), Model 1, R2Unet and the seven MONAI-backed names, and
the sliding
window and a dice_hd validation loss on the card against the CPU, a
gloo all-reduce of CUDA tensors between two ranks on one card, B2's
split statistics and apply entry points against their plain versions, the
sparse wire's device round trip, ``Engine.evaluate`` staged with cases
in flight against its inline, case-serial run, byte for byte, and the glue
kernels (the ResidualSE gate with MaxAvgPool, the upsample with the skip
concat) against PyTorch's own calls at the served case's levels, with a
served-shape forward through them against the composition. Marked
``cuda``: without a card every test skips. On a machine with one, from the repository root:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest imports JAX, which the port's
machine need not have.)"""

import pytest
import torch

from brats21_tpu_torch.models import assp_evo, get_model
from brats21_tpu_torch.models.layers import (from_kernel_layout, max_avg_pool,
                                             to_kernel_layout, upsample)
from brats21_tpu_torch.ops.edt import edt_sq
from brats21_tpu_torch.ops.kernels import conv3d, edt, evonorm, glue
from brats21_tpu_torch.ops.kernels.conv3d import (Conv3x3x3Function, conv3x3x3,
                                                  conv3x3x3_plain)
from brats21_tpu_torch.ops.kernels.edt import (INF, envelope, envelope_mask,
                                               envelope_mask_plain, envelope_plain)
from brats21_tpu_torch.ops.kernels.evonorm import (EvoNormS0Function, evonorm_s0,
                                                   evonorm_s0_apply, evonorm_s0_apply_plain,
                                                   evonorm_s0_plain, evonorm_s0_stats,
                                                   evonorm_s0_stats_plain, inv_std)

pytestmark = pytest.mark.cuda

CONV_CASES = [((1, 6, 11, 7, 5), 9), ((2, 5, 16, 8, 4), 6), ((1, 4, 13, 17, 3), 4),
              ((1, 9, 10, 11, 48), 48), ((1, 8, 8, 8, 4), 48), ((1, 7, 9, 5, 16), 24),
              ((1, 6, 6, 6, 384), 384), ((1, 7, 9, 5, 96), 96), ((1, 5, 6, 7, 8), 136),
              # H and W under 8 and not multiples of it; D = 1; the 192 N tile;
              # B = 2 at 96; the split-K level of the 128³ patch (16³×384)
              ((1, 3, 5, 3, 32), 48), ((1, 1, 12, 10, 48), 48), ((1, 4, 9, 10, 192), 192),
              ((2, 3, 9, 17, 96), 96), ((1, 16, 16, 16, 384), 384),
              # the model zoo: decoder inputs made by concatenation (96, 192,
              # 384 and 768 channels, the last at Model 1's served 25×25×17
              # level), RefUnet's conv0 (3 -> 48) and conv_d0 (48 -> 3)
              ((1, 9, 10, 11, 96), 48), ((1, 7, 6, 5, 192), 96), ((1, 6, 5, 4, 384), 192),
              ((1, 25, 25, 17, 768), 192), ((1, 5, 7, 6, 3), 48), ((1, 12, 10, 9, 48), 3),
              # the MONAI-backed zoo at the levels of a 128³ patch: SegResNet's
              # 8 channels (C_in 4 and 8), UNETR's 16 (C_in 4, 16, 32), nnunet's
              # 32, 64 and 320, with the 640 concatenated channels at 8³
              ((1, 128, 128, 128, 4), 8), ((1, 128, 128, 128, 8), 8),
              ((1, 128, 128, 128, 4), 16), ((1, 128, 128, 128, 16), 16),
              ((1, 128, 128, 128, 32), 16), ((1, 128, 128, 128, 4), 32),
              ((1, 128, 128, 128, 32), 32), ((1, 64, 64, 64, 64), 64),
              ((1, 8, 8, 8, 640), 320), ((1, 4, 4, 4, 320), 320)]
EVO_CASES = [(1, 5, 6, 7, 8), (2, 4, 4, 4, 24), (1, 10, 10, 10, 384), (2, 9, 9, 9, 96),
             (1, 33, 31, 29, 48),
             # 3 channels a group at a ragged row count; C = 48 over 10**6 rows;
             # three samples of 1001 rows
             (1, 7, 5, 3, 24), (1, 104, 100, 100, 48), (3, 7, 11, 13, 8)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout", CONV_CASES)
def test_conv_kernel_matches_plain(dev, shape, cout, dtype):
    """Against the fp32 plain conv of the same (rounded) inputs with TF32
    off: fp32 within 1e-4·max|ref| (summation order only); bf16 within
    1e-2·max|ref| (one bf16 rounding of the output, 2**-9 relative, plus
    the tensor cores' accumulation order)."""
    gen = torch.Generator(device=dev).manual_seed(shape[-1] * 1000 + cout)
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    w = (0.1 * torch.randn((3, 3, 3, shape[-1], cout), generator=gen, device=dev)).to(dtype)
    b = torch.randn(cout, generator=gen, device=dev)
    before = conv3d.launches
    y = conv3x3x3(x, w, b)
    torch.cuda.synchronize()
    assert conv3d.launches == before + 1
    assert y.dtype == dtype and y.shape == shape[:4] + (cout,)
    ref = conv3x3x3_plain(x.float(), w.float(), b)
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * ref.abs().max().item()
    assert (y.float() - ref).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", EVO_CASES)
def test_evonorm_kernel_matches_plain(dev, shape, dtype):
    """fp32 within 1e-5 abs (outputs of a few units, summation order
    only); bf16 within one bf16 ulp of the fp32 result, 2**-8·|ref|."""
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    c = shape[-1]
    x = (0.5 + 2.0 * torch.randn(shape, generator=gen, device=dev)).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
    beta = 0.1 * torch.randn(c, generator=gen, device=dev)
    before = evonorm.launches
    y = evonorm_s0(x, gamma, beta)
    torch.cuda.synchronize()
    assert evonorm.launches == before + 1
    assert y.dtype == dtype and y.shape == shape
    diff = (y.float() - evonorm_s0_plain(x.float(), gamma, beta)).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 1e-5
    else:
        ref = evonorm_s0_plain(x.float(), gamma, beta)
        assert bool((diff <= 2.0 ** -8 * ref.abs() + 1e-6).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", EVO_CASES)
def test_evonorm_split_matches_plain(dev, shape, dtype):
    """B2's split entry points (a volume sharded over ranks): the
    statistics kernel's (n, mean, M2) against the fp64 plain statistics —
    counts equal, means within 1e-5 of the group's std, M2 and the inv it
    gives within 1e-5 relative (fp32 Welford per thread, fp64 merge) — and
    the apply kernel on the plain statistics' inv against the plain apply:
    fp32 within 1e-5, bf16 within one bf16 ulp, 2**-8·|ref|. One launch
    each, none of the one-call path's."""
    gen = torch.Generator(device=dev).manual_seed(sum(shape) + 7)
    c = shape[-1]
    x = (0.5 + 2.0 * torch.randn(shape, generator=gen, device=dev)).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
    beta = 0.1 * torch.randn(c, generator=gen, device=dev)
    before = (evonorm.launches, evonorm.stats_launches, evonorm.apply_launches)
    stats = evonorm_s0_stats(x, 8)
    ref = evonorm_s0_stats_plain(x, 8)
    inv = inv_std(ref)
    y = evonorm_s0_apply(x, inv, gamma, beta)
    torch.cuda.synchronize()
    assert (evonorm.launches, evonorm.stats_launches, evonorm.apply_launches) == \
        (before[0], before[1] + 1, before[2] + 1)
    assert stats.dtype == torch.float64 and stats.shape == ref.shape
    assert torch.equal(stats[..., 0], ref[..., 0])
    std = (ref[..., 2] / ref[..., 0]).sqrt()
    assert ((stats[..., 1] - ref[..., 1]).abs() <= 1e-5 * std).all()
    torch.testing.assert_close(stats[..., 2], ref[..., 2], rtol=1e-5, atol=0)
    torch.testing.assert_close(inv_std(stats), inv, rtol=1e-5, atol=0)
    want = evonorm_s0_apply_plain(x.float(), inv, gamma, beta)
    diff = (y.float() - want).abs()
    assert y.dtype == dtype and y.shape == shape
    if dtype == torch.float32:
        assert diff.max().item() <= 1e-5
    else:
        assert bool((diff <= 2.0 ** -8 * want.abs() + 1e-6).all())


@pytest.mark.parametrize("tap", [(1, 1, 1), (0, 0, 0), (2, 1, 0), (0, 2, 2)])
def test_conv_bf16_moves_each_voxel_and_channel_exactly(dev, tap):
    """Weights that copy one tap: out[..., n] = x[voxel + tap - 1, perm(n)]
    with the zero halo, for distinct values at every voxel and channel. The
    sum has one nonzero term, so the bf16 kernel must equal it bit for bit:
    a swapped descriptor stride (rows for channels), a wrong tap window or a
    misplaced brick shows at once."""
    d, h, w, c_in, c_out = 5, 11, 13, 32, 48
    gen = torch.Generator(device=dev).manual_seed(sum(tap))
    x = torch.randn((2, d, h, w, c_in), generator=gen, device=dev).to(torch.bfloat16)
    perm = (torch.arange(c_out, device=dev) * 7) % c_in
    wt = torch.zeros((3, 3, 3, c_in, c_out), device=dev, dtype=torch.bfloat16)
    wt[tap[0], tap[1], tap[2], perm, torch.arange(c_out, device=dev)] = 1
    y = conv3x3x3(x, wt, torch.zeros(c_out, device=dev))
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    want = xp[:, tap[0]:tap[0] + d, tap[1]:tap[1] + h, tap[2]:tap[2] + w][..., perm]
    assert torch.equal(y, want)


def test_wrappers_raise_rather_than_fall_back(dev):
    x = torch.randn((1, 4, 4, 4, 8), device=dev).to(torch.float16)
    with pytest.raises(TypeError):
        conv3x3x3(x, torch.zeros((3, 3, 3, 8, 8), device=dev, dtype=torch.float16),
                  torch.zeros(8, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        evonorm_s0(torch.randn((1, 8, 4, 4, 4), device=dev).permute(0, 2, 3, 4, 1),
                   torch.ones(8, device=dev), torch.zeros(8, device=dev))


def test_kernels_launch_on_the_tensors_card():
    """``--device 1``: tensors on the second card while the current device
    stays 0. Each wrapper must launch on its tensors' card and agree with
    its plain version there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 1)
    assert torch.cuda.current_device() == 0
    gen = torch.Generator(device=dev).manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((1, 6, 9, 7, 4), generator=gen, device=dev).to(dtype)
        w = (0.1 * torch.randn((3, 3, 3, 4, 48), generator=gen, device=dev)).to(dtype)
        b = torch.randn(48, generator=gen, device=dev)
        y = conv3x3x3(x, w, b)
        ref = conv3x3x3_plain(x.float(), w.float(), b)
        tol = (1e-4 if dtype == torch.float32 else 1e-2) * ref.abs().max().item()
        assert y.device == dev and (y.float() - ref).abs().max().item() <= tol
        x = (0.5 + 2.0 * torch.randn((2, 5, 6, 7, 48), generator=gen, device=dev)).to(dtype)
        gamma = torch.ones(48, device=dev)
        beta = torch.zeros(48, device=dev)
        ref = evonorm_s0_plain(x.float(), gamma, beta)
        diff = (evonorm_s0(x, gamma, beta).float() - ref).abs()
        assert bool((diff <= 2.0 ** -8 * ref.abs() + 1e-5).all())
    torch.cuda.synchronize(dev)


def test_model_on_card_matches_cpu(dev):
    """EquiUnetASSPEvo width 8, fp32: the card (kernels) against the CPU
    (plain versions), main head and deep heads within 1e-3."""
    torch.manual_seed(0)
    cpu = get_model({"model": "equiunet_assp_evo", "width": 8}).eval()
    card = get_model({"model": "equiunet_assp_evo", "width": 8}).eval()
    card.load_state_dict(cpu.state_dict())
    card.to(dev)
    x = torch.randn((1, 4, 24, 32, 16)).contiguous(memory_format=torch.channels_last_3d)
    c0, e0 = conv3d.launches, evonorm.launches
    with torch.inference_mode():
        want, want_deeps = cpu(x)
        got, got_deeps = card(x.to(dev))
    assert (conv3d.launches - c0, evonorm.launches - e0) == (14, 21)
    for g, w in [(got, want)] + list(zip(got_deeps, want_deeps)):
        torch.testing.assert_close(g.cpu(), w, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("name", ["equiunet", "r2unet"])
def test_zoo_model_on_card_matches_cpu(dev, name):
    """Model 1 (equiunet, 15 conv launches a forward) and R2Unet (45: each
    recurrent conv three times) at width 8, fp32: the card against the
    CPU, every head within 1e-3."""
    torch.manual_seed(1)
    cpu = get_model({"model": name, "width": 8, "norm": "group"}).eval()
    card = get_model({"model": name, "width": 8, "norm": "group"}).eval()
    card.load_state_dict(cpu.state_dict())
    card.to(dev)
    x = torch.randn((1, 4, 24, 32, 16)).contiguous(memory_format=torch.channels_last_3d)
    c0 = conv3d.launches
    with torch.inference_mode():
        want, want_deeps = cpu(x)
        got, got_deeps = card(x.to(dev))
    assert conv3d.launches - c0 == {"equiunet": 15, "r2unet": 45}[name]
    for g, w in [(got, want)] + list(zip(got_deeps, want_deeps)):
        torch.testing.assert_close(g.cpu(), w, atol=1e-3, rtol=1e-3)


MONAI_ON_CARD = {"basic_unet": ({"width": 8, "norm": "instance"}, 32, 18),
                 "segresnet": ({}, 32, 25), "segresnetvae": ({}, 32, 31),
                 "highresnet": ({"norm": "batch"}, 24, 7), "vnet": ({"act": "elu"}, 32, 0),
                 "nnunet": ({"norm": "instance"}, 32, 17),
                 "unet_tr": ({"norm": "instance"}, 32, 10)}


@pytest.mark.parametrize("name", sorted(MONAI_ON_CARD))
def test_monai_zoo_model_on_card_matches_cpu(dev, name):
    """The seven MONAI-backed names (their published widths; basic_unet at
    width 8), fp32: the card against the CPU, every head (and
    segresnetvae's VAE loss) within 1e-3 of its largest magnitude, with the
    conv kernel's launches a forward."""
    extra, side, launches = MONAI_ON_CARD[name]
    cfg = {"model": name, "patch_size": [side] * 3, **extra}
    torch.manual_seed(2)
    cpu = get_model(cfg).eval()
    card = get_model(cfg).eval()
    card.load_state_dict(cpu.state_dict())
    card.to(dev)
    x = torch.randn((1, 4, side, side, side)).contiguous(memory_format=torch.channels_last_3d)
    c0 = conv3d.launches
    with torch.inference_mode():
        want, got = cpu(x), card(x.to(dev))
    assert conv3d.launches - c0 == launches

    def heads(out):
        if isinstance(out, torch.Tensor):
            return [out]
        main, rest = out
        return [main] + (list(rest.values()) if isinstance(rest, dict) else list(rest))

    for g, w in zip(heads(got), heads(want)):
        scale = max(w.abs().max().item(), 1.0)
        torch.testing.assert_close(g.cpu() / scale, w / scale, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shared_conv_grads_add_up(dev, dtype):
    """One conv applied three times with the same weights (R2Unet's
    RecurrentBlock): the trainable kernel's gradients against autograd of
    the plain version, fp32 within 1e-5 and bf16 within 2e-2 of max|ref|."""
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((1, 6, 7, 9, 16), generator=gen, device=dev).to(dtype)
    w = (0.1 * torch.randn((3, 3, 3, 16, 16), generator=gen, device=dev)).to(dtype)
    b = torch.randn(16, generator=gen, device=dev)
    ct = torch.randn((1, 6, 7, 9, 16), generator=gen, device=dev).to(dtype)
    args = [a.detach().requires_grad_() for a in (x, w, b)]

    def recurrent(fn):
        y = fn(*args)
        for _ in range(2):
            y = fn(args[0] + y, args[1], args[2])
        return y

    got = torch.autograd.grad(recurrent(Conv3x3x3Function.apply), args, ct)
    want = torch.autograd.grad(recurrent(conv3x3x3_plain), args, ct)
    rel = 2e-2 if dtype == torch.bfloat16 else 1e-5
    for g, w_ in zip(got, want):
        assert (g.float() - w_.float()).abs().max().item() <= \
            rel * w_.float().abs().max().item() + 1e-6


EDT_CASES = [((3, 17, 9, 11), 1.0), ((2, 5, 300, 7), 1.5), ((1, 33, 40, 155), 1.5),
             ((1, 240, 3, 2), 1.0), ((70, 1), 1.0), ((2, 240, 7, 155), 1.0),
             ((3, 2, 1, 240), 2.0), ((33, 155, 2), 1.0)]


def _assert_envelope(got, want, sampling, what):
    """Bit for bit at unit sampling (integer values); within rtol 1e-6
    otherwise, where parabolas within an ulp may be chosen otherwise than
    the scan chooses them."""
    if sampling == 1.0:
        assert torch.equal(got, want), what
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0, msg=what)


@pytest.mark.parametrize("shape,sampling", EDT_CASES)
def test_edt_envelope_matches_plain_bit_for_bit(dev, shape, sampling):
    """Every axis, odd lengths, lines longer than a block (300) and of the
    full case (155, 240), inner strides of 1, 2, 7 and 33, with the 1e12
    sentinels and integer values: bit for bit at sampling 1, rtol 1e-6 at
    1.5 and 2."""
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    g = torch.where(torch.rand(shape, generator=gen, device=dev) > 0.5, INF, 0.0)
    g = g + torch.randint(0, 3, shape, generator=gen, device=dev).float()
    for axis in range(g.dim()):
        before = edt.launches
        got = envelope(g, sampling, axis)
        torch.cuda.synchronize()
        assert edt.launches == before + 1
        _assert_envelope(got, envelope_plain(g, sampling, axis), sampling, f"axis {axis}")


@pytest.mark.parametrize("shape", [(3, 17, 9, 11), (2, 9, 240, 5)])
def test_edt_envelope_float_path_at_unit_sampling(dev, shape):
    """Lines holding a non-integer take the kernel's float path (Meijster
    with an fp32 separator) at unit sampling too: within rtol 1e-6 of the
    scan, beside lines on the integer path in the same launch."""
    gen = torch.Generator(device=dev).manual_seed(sum(shape) + 1)
    g = torch.where(torch.rand(shape, generator=gen, device=dev) > 0.5, INF, 0.0)
    g = g + torch.randint(0, 30, shape, generator=gen, device=dev).float()
    g[0] = g[0] + 0.5 * (g[0] < INF)
    for axis in range(1, g.dim()):
        torch.testing.assert_close(envelope(g, 1.0, axis), envelope_plain(g, 1.0, axis),
                                   rtol=1e-6, atol=0, msg=f"axis {axis}")


def _edge_lines(n):
    """All-sentinel, a single zero (first, middle, last), zeros at both ends
    only, and random squared distances up to the full case's largest."""
    g = torch.full((6, n), INF)
    g[1, 0] = g[2, n // 2] = g[3, n - 1] = 0.0
    g[4, 0] = g[4, n - 1] = 0.0
    g[5] = torch.randint(0, 139226, (n,), generator=torch.Generator().manual_seed(n)).float()
    return g


@pytest.mark.parametrize("n", [1, 2, 155, 240])
@pytest.mark.parametrize("sampling", [1.0, 1.5])
def test_edt_envelope_edge_lines(dev, n, sampling):
    g = _edge_lines(n)
    for axis, x in ((1, g), (0, g.t().contiguous())):
        got = envelope(x.to(dev), sampling, axis).cpu()
        _assert_envelope(got, envelope_plain(x, sampling, axis), sampling, f"axis {axis}")
        sentinel_line = got[0] if axis == 1 else got[:, 0]
        assert torch.equal(sentinel_line, torch.full((n,), INF))


@pytest.mark.parametrize("shape", [(3, 17, 9, 11), (2, 240, 5, 3), (1, 4, 155, 6),
                                   (5, 240)])
@pytest.mark.parametrize("sampling", [1.0, 1.5])
def test_edt_mask_pass_matches_plain_bit_for_bit(dev, shape, sampling):
    """The mask pass reads the bool mask (contiguous or a permuted view)
    and equals the scan of where(mask, 1e12, 0) bit for bit at any
    sampling; an all-True line gives 1e12."""
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    mask = torch.rand(shape, generator=gen, device=dev) > 0.6
    mask[0] = True
    for m in (mask, mask.transpose(0, -1)):
        for axis in range(m.dim()):
            before = edt.launches
            got = envelope_mask(m, sampling, axis)
            torch.cuda.synchronize()
            assert edt.launches == before + 1
            assert torch.equal(got, envelope_mask_plain(m, sampling, axis)), f"axis {axis}"


def test_edt_sq_on_card_matches_scipy(dev):
    import numpy as np
    from scipy import ndimage
    mask = np.random.default_rng(1).random((2, 21, 19, 23)) > 0.4
    got = edt_sq(torch.from_numpy(mask).to(dev), (1.0, 2.0, 1.5)).cpu().numpy()
    for k in range(2):
        want = ndimage.distance_transform_edt(mask[k], sampling=(1.0, 2.0, 1.5)) ** 2
        np.testing.assert_allclose(got[k], want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trainable_kernels_grads_match_plain_autograd(dev, dtype):
    """Conv3x3x3Function and EvoNormS0Function (kernel forward, plain
    backward) against autograd of the plain versions: fp32 within
    1e-5·max|ref|, bf16 within 1e-2·max|ref|; the backward launches no
    hand-written kernel."""
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((1, 7, 9, 6, 8), generator=gen, device=dev).to(dtype)
    w = (0.1 * torch.randn((3, 3, 3, 8, 24), generator=gen, device=dev)).to(dtype)
    b = torch.randn(24, generator=gen, device=dev)
    g = 1.0 + 0.1 * torch.randn(24, generator=gen, device=dev)
    beta = 0.1 * torch.randn(24, generator=gen, device=dev)
    for fn, plain, args, ct_shape in (
            (Conv3x3x3Function.apply, conv3x3x3_plain, [x, w, b], (1, 7, 9, 6, 24)),
            (EvoNormS0Function.apply, evonorm_s0_plain, [x.repeat(1, 1, 1, 1, 3), g, beta],
             (1, 7, 9, 6, 24))):
        args = [a.detach().requires_grad_() for a in args]
        ct = torch.randn(ct_shape, generator=gen, device=dev).to(dtype)
        y = fn(*args)
        counts = (conv3d.launches, evonorm.launches)
        got = torch.autograd.grad(y, args, ct)
        assert (conv3d.launches, evonorm.launches) == counts
        want = torch.autograd.grad(plain(*args), args, ct)
        rel = 1e-5 if dtype == torch.float32 else 1e-2
        for gg, ww in zip(got, want):
            assert gg.shape == ww.shape and gg.dtype == ww.dtype
            assert (gg.float() - ww.float()).abs().max().item() <= \
                rel * ww.float().abs().max().item() + 1e-6


def test_hd_loss_on_card_matches_cpu(dev):
    """dice_hd on channels-last views (as the train loader's batches reach
    the loss, B = 1): the card (EDT kernels) against the CPU (plain
    envelope), within 1e-5 relative; one EDT batch of the target and the
    prediction, 3 envelope launches. Under deep supervision the batched
    loss (3 launches for three heads) equals the head-by-head mean on the
    card bit for bit (9 launches); each head's prediction one-hot and the
    maps equal the CPU's bit for bit (the sigmoids differ by at most an ulp
    and no voxel's top two channels lie that close), so each head's loss
    and their mean match the CPU's within the same 1e-5 relative."""
    from brats21_tpu_torch.learning.losses import (_pred_one_hot, deep_supervision_loss,
                                                   make_criterion)
    gen = torch.Generator().manual_seed(3)
    logits = torch.randn((1, 20, 18, 16, 3), generator=gen).permute(0, 4, 1, 2, 3)
    deeps = [torch.randn((1, 20, 18, 16, 3), generator=gen).permute(0, 4, 1, 2, 3)
             for _ in range(2)]
    target = (torch.rand((1, 20, 18, 16, 3), generator=gen) > 0.7).float()
    target = target.permute(0, 4, 1, 2, 3)
    loss = make_criterion({"criterion": "dice_hd"})
    before = edt.launches
    got = loss(logits.to(dev), target.to(dev)).item()
    assert edt.launches == before + 3
    want = loss(logits, target).item()
    assert abs(got - want) <= 1e-5 * abs(want)
    heads = [h.to(dev) for h in [logits] + deeps]
    before = edt.launches
    batched = deep_supervision_loss(loss, (heads[0], heads[1:]), target.to(dev))
    assert edt.launches == before + 3
    head_by_head = torch.stack([loss(h, target.to(dev)) for h in heads]).mean()
    assert edt.launches == before + 3 + 9
    assert torch.equal(batched, head_by_head)
    tdm, pdms = loss.maps(heads, target.to(dev))
    want_tdm, want_pdms = loss.maps([logits] + deeps, target)
    assert torch.equal(tdm.cpu(), want_tdm)
    for i, (h, pdm, want_pdm) in enumerate(zip([logits] + deeps, pdms, want_pdms)):
        assert torch.equal(_pred_one_hot(heads[i], None, True, False).cpu(),
                           _pred_one_hot(h, None, True, False)), f"head {i}"
        assert torch.equal(pdm.cpu(), want_pdm), f"head {i}"
        got = loss(heads[i], target.to(dev), maps=(tdm, pdm)).item()
        want = loss(h, target, maps=(want_tdm, want_pdm)).item()
        assert abs(got - want) <= 1e-5 * abs(want), f"head {i}: {got} vs {want}"
    want = deep_supervision_loss(loss, (logits, deeps), target).item()
    assert abs(batched.item() - want) <= 1e-5 * abs(want)


def test_distance_map_on_card_equals_cpu(dev):
    """compute_distance_map_fn on the card (side stream, the loader's
    path) equals the CPU's bit for bit: 3 envelope launches, one batch of
    the 6 masks."""
    import numpy as np
    from brats21_tpu_torch.data.transforms import compute_distance_map_fn
    seg = (np.random.default_rng(2).random((40, 37, 29, 3)) > 0.8).astype(np.float32)
    seg[..., 2] = 0.0
    before = edt.launches
    got = compute_distance_map_fn(seg, dev)
    assert edt.launches == before + 3
    np.testing.assert_array_equal(got, compute_distance_map_fn(seg, "cpu"))


def _model_pair(dev, seed):
    torch.manual_seed(seed)
    cpu = get_model({"model": "equiunet_assp_evo", "width": 8}).eval()
    card = get_model({"model": "equiunet_assp_evo", "width": 8}).eval()
    card.load_state_dict(cpu.state_dict())
    return cpu, card.to(dev)


def test_sliding_window_on_card_matches_cpu(dev):
    """Stitched logits of a w8 EquiUnetASSPEvo (fp32) over 16³ windows of a
    40×24×12 volume (Z below the roi; 3×2×1 windows, three batches of two):
    the card within 1e-3 of the CPU, one forward of 14 conv and 21 EvoNorm
    launches a batch."""
    from brats21_tpu_torch.learning.engine import forward_channels_last
    from brats21_tpu_torch.ops.sliding_window import sliding_window_inference, window_plan
    cpu, card = _model_pair(dev, 1)
    x = torch.randn((1, 40, 24, 12, 4), generator=torch.Generator().manual_seed(2))
    _, _, starts = window_plan((40, 24, 12), (16, 16, 16))
    batches = -(-len(starts) // 2)
    with torch.inference_mode():
        want = sliding_window_inference(x, (16, 16, 16),
                                        lambda w: forward_channels_last(cpu, w), 2)
        c0, e0 = conv3d.launches, evonorm.launches
        got = sliding_window_inference(x.to(dev), (16, 16, 16),
                                       lambda w: forward_channels_last(card, w), 2)
    assert (conv3d.launches - c0, evonorm.launches - e0) == (14 * batches, 21 * batches)
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-3)


def test_dice_hd_validation_loss_on_card_matches_cpu(dev):
    """``Engine.member_probs`` with a target (w8, fp32, dice_hd, 32×32×16):
    the forward with its deep heads and the loss's one EDT batch on the
    card (14 / 21 / 3 launches) against the CPU. The probabilities within
    1e-3 (the forward's tolerance above); the loss within 1e-3 relative,
    since the fp32 logits differ by summation order and may move a voxel of
    a head's one-hot and with it its distance map. The loss of the CPU's
    own outputs taken on the card is held to 1e-5 relative, as
    test_hd_loss_on_card_matches_cpu holds the loss alone."""
    from brats21_tpu_torch.config import TrainConfig
    from brats21_tpu_torch.learning.engine import Engine, _ncdhw, forward_channels_last
    from brats21_tpu_torch.learning.losses import deep_supervision_loss, make_criterion
    cfg = TrainConfig(model="equiunet_assp_evo", width=8, criterion="dice_hd", no_amp=True)
    cpu, card = _model_pair(dev, 3)
    gen = torch.Generator().manual_seed(4)
    img = torch.randn((1, 32, 32, 16, 4), generator=gen)
    seg = (torch.rand((1, 32, 32, 16, 3), generator=gen) > 0.7).float()
    target = seg.permute(0, 4, 1, 2, 3)
    criterion = make_criterion(cfg)
    with torch.inference_mode():
        want_p, want_l = Engine(cfg, torch.device("cpu"), criterion).member_probs(
            cpu, img, target=target)
        counts = (conv3d.launches, evonorm.launches, edt.launches)
        got_p, got_l = Engine(cfg, dev, criterion).member_probs(
            card, img.to(dev), target=target.to(dev))
        assert (conv3d.launches - counts[0], evonorm.launches - counts[1],
                edt.launches - counts[2]) == (14, 21, 3)
        torch.testing.assert_close(got_p.cpu(), want_p, atol=1e-3, rtol=1e-3)
        assert abs(got_l.item() - want_l.item()) <= 1e-3 * abs(want_l.item())
        outputs = forward_channels_last(cpu, img, with_deep=True)
        on_card = deep_supervision_loss(
            criterion, _ncdhw(tuple([outputs[0].to(dev), [d.to(dev) for d in outputs[1]]])),
            target.to(dev))
    assert abs(on_card.item() - want_l.item()) <= 1e-5 * abs(want_l.item())


_GLOO_RANK = """
import torch, torch.distributed as dist
from brats21_tpu_torch.parallel import multihost
from brats21_tpu_torch.parallel.distributed import all_reduce_sum
from brats21_tpu_torch.parallel.mesh import init_topology
topo = init_topology("0")
assert topo.backend == "gloo" and topo.device.type == "cuda", (topo.backend, topo.device)
t = torch.full((3, 1000), float(topo.rank + 1), device=topo.device)
all_reduce_sum(t, topo.local_group)
assert t.device.type == "cuda" and bool((t == 3.0).all()), t
print("rank", topo.rank, "backend", topo.backend, "ok", flush=True)
multihost.shutdown()
"""


def test_gloo_all_reduce_of_cuda_tensors_on_one_card(dev, tmp_path):
    """Two local ranks on one card: the backend is gloo (NCCL refuses two
    ranks on one device), and gloo all-reduces CUDA tensors over the
    node's group."""
    from pathlib import Path
    from brats21_tpu_torch.parallel import multihost
    if torch.cuda.device_count() != 1:
        pytest.skip("the rule under test: more local ranks than cards")
    script = tmp_path / "rank.py"
    script.write_text(_GLOO_RANK)
    repo = str(Path(__file__).resolve().parents[1])
    outs = multihost.run_ranks([str(script)], 2, timeout=180,
                               env={"PYTHONPATH": repo, multihost.TIMEOUT_ENV: "60"},
                               cwd=repo)
    assert outs[0].count(" ok") == 2 and "backend gloo" in outs[0], outs[0]


def test_sparse_wire_round_trips_on_card(dev):
    """The sparse wire's device halves on CUDA tensors: a packed fp16
    volume unpacked exactly, a binary volume bit-packed as np.packbits
    does, narrow values decoded exactly."""
    import numpy as np
    from brats21_tpu_torch.ops import wire
    rng = np.random.default_rng(9)
    vol = rng.standard_normal((40, 36, 24, 4)).astype(np.float16)
    vol[:10] = 0
    vol[rng.random(vol.shape[:3]) < 0.3] = 0
    bits, vals = wire.pack_volume(vol, cap_step=1000)
    got = wire.unpack_volume_device(torch.from_numpy(bits).to(dev),
                                    torch.from_numpy(vals).to(dev), vol.shape[:3])
    assert got.device.type == "cuda"
    assert got[0].cpu().numpy().tobytes() == vol.tobytes()
    binary = (rng.random((1, 13, 11, 7, 3)) > 0.5).astype(np.float32)
    packed = wire.pack_bits_device(torch.from_numpy(binary).to(dev)).cpu().numpy()
    assert packed.tobytes() == np.packbits(binary.astype(np.uint8).reshape(-1)).tobytes()
    assert wire.unpack_bits(packed, binary.shape).tobytes() == binary.tobytes()
    for b in (1, 7, 12, 16):
        v = rng.integers(0, 1 << b, (501, 4)).astype(np.int32)
        stream = torch.from_numpy(wire.pack_values_narrow(v, b)).to(dev)
        dec = wire.unpack_values_narrow_device(stream, 501, 4, b, dtype=torch.int32)
        assert bool((dec.cpu() == torch.from_numpy(v)).all()), b


def test_staged_evaluate_matches_inline_on_card(dev, tmp_path, monkeypatch):
    """``Engine.evaluate`` on the card (w8 EquiUnetASSPEvo, bf16, three
    32×32×16 cases with background, dice_hd): the staged run at depth 2
    (dense wire) and depth 3 (sparse wire) against the inline run at depth
    1: the same meters exactly and byte-equal NIfTIs, with 14 B1 and 21 B2
    launches a case and 3 B3 (its loss)."""
    import gzip
    import os

    import numpy as np
    from brats21_tpu_torch.config import TrainConfig
    from brats21_tpu_torch.learning.engine import Engine
    from brats21_tpu_torch.learning.losses import make_criterion
    cfg = dict(model="equiunet_assp_evo", width=8, criterion="dice_hd")
    _, card = _model_pair(dev, 5)
    rng = np.random.default_rng(11)
    batches = []
    for i in range(3):
        img = rng.standard_normal((1, 32, 32, 16, 4)).astype(np.float32)
        img[:, : 4 + 2 * i] = 0.0
        batches.append({"img": img, "seg": (rng.random((1, 32, 32, 16, 3)) > 0.7).astype(
            np.float32), "patient_id": [f"c{i}"],
            "foreground_start_coord": np.array([[0, 0, 0]]),
            "foreground_end_coord": np.array([[32, 32, 16]]),
            "original_shape": np.array([[32, 32, 16]]), "affine": np.eye(4)[None]})

    def run(tag, stages, depth, wire):
        monkeypatch.setenv("BRATS21_EVAL_STAGES", stages)
        monkeypatch.setenv("BRATS21_EVAL_PIPELINE", depth)
        monkeypatch.delenv("BRATS21_SPARSE_WIRE", raising=False)
        c = TrainConfig(**cfg, wire=wire)
        counts = (conv3d.launches, evonorm.launches, edt.launches)
        meters = Engine(c, dev, criterion=make_criterion(c)).evaluate(
            [card], batches, 0, save_seg=True, output_path=str(tmp_path / tag))
        torch.cuda.synchronize()
        assert (conv3d.launches - counts[0], evonorm.launches - counts[1],
                edt.launches - counts[2]) == (42, 63, 9)
        segs = {f: gzip.decompress((tmp_path / tag / f).read_bytes())
                for f in sorted(os.listdir(tmp_path / tag))}
        return {k: np.asarray(m.avg) for k, m in meters.items()
                if k not in ("batch_time", "data_time")}, segs

    want = run("inline", "0", "1", "dense")
    assert len(want[1]) == 3
    for got in (run("staged2", "1", "2", "dense"), run("staged3", "1", "3", "sparse")):
        assert sorted(got[0]) == sorted(want[0])
        for k in want[0]:
            assert np.array_equal(got[0][k], want[0][k]), k
        assert got[1] == want[1]


# the served case's levels (200×200×136 padded) with their channels: the
# encoders' gates and pools (level 4: the gate alone), the decoders'
# gates, and the upsample's (skip, low) pairs; then ragged shapes and
# channel counts that take narrower vectors
GATE_CASES = [((1, 200, 200, 136, 48), True), ((1, 100, 100, 68, 96), True),
              ((1, 50, 50, 34, 192), True), ((1, 25, 25, 17, 384), False),
              ((1, 200, 200, 136, 48), False), ((1, 100, 100, 68, 96), False),
              ((1, 50, 50, 34, 192), False), ((2, 6, 4, 10, 24), True),
              ((2, 3, 5, 7, 12), False), ((1, 4, 2, 6, 4), True)]
UPSAMPLE_CASES = [((1, 200, 200, 136, 24), 24), ((1, 100, 100, 68, 48), 48),
                  ((1, 50, 50, 34, 96), 96), ((2, 6, 4, 10, 8), 16), ((1, 4, 6, 2, 12), 4)]


def _within_one_bf16_ulp(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """Bit-equal, or every element within one bf16 ulp of ``want`` (2**-7
    of its magnitude, 2**-133 at zero), with the count that differs
    printed."""
    if torch.equal(got, want):
        return
    g, w = got.float(), want.float()
    differ = int((g != w).sum())
    print(f"{what}: {differ} of {want.numel()} elements differ")
    assert bool(((g - w).abs() <= 2.0 ** -7 * w.abs() + 2.0 ** -133).all()), what


def _gate_input(shape, dtype, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    s = torch.rand((shape[0], shape[-1]), generator=gen, device=dev).to(dtype)
    return x, s


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pool", GATE_CASES)
def test_se_gate_pool_matches_torch(dev, shape, pool, dtype):
    """Against ``x + x·s`` and ``max_avg_pool`` as the model called them on
    the card: the gate and the max bit-equal, the mean bit-equal or within
    one bf16 ulp (fp32 sums in avg_pool3d's order)."""
    x, s = _gate_input(shape, dtype, dev, 16)
    v = from_kernel_layout(x)
    want = v + v * s[:, :, None, None, None]
    n0 = glue.se_gate_pool_launches
    y, pooled = glue.se_gate_pool(x, s, pool)
    assert glue.se_gate_pool_launches == n0 + 1
    assert torch.equal(y, to_kernel_layout(want))
    if not pool:
        assert pooled is None
        return
    ref = to_kernel_layout(max_avg_pool(want))
    c = shape[-1]
    assert pooled.shape == ref.shape and pooled.is_contiguous()
    assert torch.equal(pooled[..., :c], ref[..., :c])
    _within_one_bf16_ulp(pooled[..., c:], ref[..., c:], f"mean {shape} {dtype}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cu", UPSAMPLE_CASES)
def test_upsample_cat_matches_torch(dev, shape, cu, dtype):
    """Against ``torch.cat([skip, upsample(low)], 1)`` on the card: skip's
    channels bit-equal, the upsample bit-equal or within one bf16 ulp."""
    b, d, h, w, cs = shape
    gen = torch.Generator(device=dev).manual_seed(17)
    skip = torch.randn(shape, generator=gen, device=dev).to(dtype)
    low = torch.randn((b, d // 2, h // 2, w // 2, cu), generator=gen, device=dev).to(dtype)
    n0 = glue.upsample_cat_launches
    out = glue.upsample_cat(skip, low)
    assert glue.upsample_cat_launches == n0 + 1
    ref = to_kernel_layout(torch.cat([from_kernel_layout(skip),
                                      upsample(from_kernel_layout(low))], dim=1))
    assert out.shape == ref.shape and out.is_contiguous()
    assert torch.equal(out[..., :cs], skip)
    _within_one_bf16_ulp(out[..., cs:], ref[..., cs:], f"upsample {shape} {cu} {dtype}")


def test_glue_wrappers_raise_rather_than_fall_back(dev):
    x = torch.randn((1, 4, 4, 4, 8), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        glue.se_gate_pool(x.transpose(1, 2), x[:, 0, 0, 0].contiguous(), pool=False)
    with pytest.raises(ValueError, match="one dtype"):
        glue.se_gate_pool(x, x[:, 0, 0, 0].float().contiguous(), pool=True)
    with pytest.raises(TypeError):
        glue.upsample_cat(x.to(torch.float64), x[:, :2, :2, :2].to(torch.float64).contiguous())


def test_served_forward_through_glue_matches_composition(dev):
    """EquiUnetASSPEvo w48 at the served shape, bf16, under inference_mode:
    the glue kernels (7 gate launches and 3 upsample launches a forward
    beside B1's 14 and B2's 21) against the same forward with the
    composition of PyTorch calls, main and deep heads."""
    torch.manual_seed(0)
    model = get_model({"model": "equiunet_assp_evo", "width": 48}).to(dev).eval()
    x = torch.randn((1, 4, 200, 200, 136), device=dev).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last_3d)
    counts = (glue.se_gate_pool_launches, glue.upsample_cat_launches, conv3d.launches,
              evonorm.launches)
    with torch.inference_mode():
        got, got_deeps = model(x)
        after = (glue.se_gate_pool_launches, glue.upsample_cat_launches, conv3d.launches,
                 evonorm.launches)
        route = assp_evo.glue_route
        assp_evo.glue_route = lambda: False
        try:
            want, want_deeps = model(x)
        finally:
            assp_evo.glue_route = route
    assert tuple(a - c for a, c in zip(after, counts)) == (7, 3, 14, 21)
    for g, w in [(got, want)] + list(zip(got_deeps, want_deeps)):
        assert torch.equal(g, w)
