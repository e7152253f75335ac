"""The port's hand-written kernels on a card: each CUDA/Triton kernel held
against its plain PyTorch version on the same CUDA tensors, at ragged
shapes the main path's level sizes do not reach (odd H/W, C_in = 4, C_out
not a multiple of the tile). Marked ``cuda``: without a card every test
skips. On a machine with one, from the repository root:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest imports JAX, which the port's
machine need not have.)"""

import pytest
import torch

from brats21_tpu_torch.models import get_model
from brats21_tpu_torch.ops.kernels import conv3d, evonorm
from brats21_tpu_torch.ops.kernels.conv3d import conv3x3x3, conv3x3x3_plain
from brats21_tpu_torch.ops.kernels.evonorm import evonorm_s0, evonorm_s0_plain

pytestmark = pytest.mark.cuda

CONV_CASES = [((1, 6, 11, 7, 5), 9), ((2, 5, 16, 8, 4), 6), ((1, 4, 13, 17, 3), 4),
              ((1, 9, 10, 11, 48), 48), ((1, 8, 8, 8, 4), 48), ((1, 7, 9, 5, 16), 24),
              ((1, 6, 6, 6, 384), 384), ((1, 7, 9, 5, 96), 96), ((1, 5, 6, 7, 8), 136)]
EVO_CASES = [(1, 5, 6, 7, 8), (2, 4, 4, 4, 24), (1, 10, 10, 10, 384), (2, 9, 9, 9, 96),
             (1, 33, 31, 29, 48)]


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
