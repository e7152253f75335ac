"""``--model swin_unetr`` (Swin UNETR, BraTS 2021 settings) on the CPU: the
port's plain path against ``tests/swin_unetr_reference.py`` (a plain float32
Swin UNETR written from the equations, MONAI's names) on seeded weights
loaded by key, forward and one train step; the shift mask's regions and
MONAI's relative index against hand-worked cases; B4's wrapper on the CPU;
the published model on the meta device; ``Engine.evaluate`` serving a case
through ``--sliding_window_inference``; ``layers.InstanceNorm(affine=False)``;
and the error on a Z-sharded slab. B4 itself runs only on a card: the
``cuda``-marked tests at the end (B4 against the plain composition at the
published network's four stage grids and ragged ones, both block kinds,
batch 2; its wrapper's refusals; a served window forward through it) skip
here. On a machine with a card, from the repository root:

    python -m pytest tests/test_torch_port_swin.py -m cuda --noconftest -q

This file imports no JAX, so it runs there."""

import math

import numpy as np
import pytest
import torch

import swin_unetr_reference as ref
from brats21_tpu_torch.config import TrainConfig
from brats21_tpu_torch.data import transforms as T
from brats21_tpu_torch.data.nifti import read_nifti
from brats21_tpu_torch.learning.engine import Engine
from brats21_tpu_torch.learning.losses import make_criterion
from brats21_tpu_torch.models import get_model
from brats21_tpu_torch.models.layers import InstanceNorm
from brats21_tpu_torch.models.swin_unetr import SwinUNETR
from brats21_tpu_torch.ops.kernels import window_attn as wa
from brats21_tpu_torch.parallel import spatial

SMALL = dict(feature_size=12, num_heads=(1, 2, 4, 8))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread, as every port test file runs (this one
    imports no JAX, so that its card tests run where there is none)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded(model: torch.nn.Module, seed: int = 0) -> dict:
    """Weights that make every term count: linear and conv weights
    1/sqrt(fan in), norm scales 1 ± 0.1, biases ± 0.1, and the relative
    position bias table at unit scale (MONAI's init, std 0.02, would leave
    the bias and a wrong index unseen)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for key, t in model.state_dict().items():
        r = torch.randn(t.shape, generator=gen)
        if key.endswith("relative_position_bias_table"):
            out[key] = r
        elif key.endswith("weight") and t.dim() >= 2:
            out[key] = r / math.sqrt(t[0].numel())
        elif key.endswith("weight"):
            out[key] = 1.0 + 0.1 * r
        else:
            out[key] = 0.1 * r
    return out


def pair(seed: int = 0):
    port = SwinUNETR(**SMALL)
    weights = seeded(port, seed)
    port.load_state_dict(weights)
    plain = ref.SwinUNETR(**SMALL)
    plain.load_state_dict(weights)
    return port, plain


def volume(size: int, seed: int = 1, batch: int = 1) -> torch.Tensor:
    x = torch.randn((batch, 4, size, size, size), generator=torch.Generator().manual_seed(seed))
    return x.contiguous(memory_format=torch.channels_last_3d)


def test_forward_matches_reference_at_64():
    """64³ at feature size 12, heads 1, 2, 4, 8: stage 1 pads 32 → 35 (125
    windows), both block kinds and the shift mask at stages 1-3, stage 4's
    4³ grid one clipped window of 64 tokens (MONAI's idx[:64, :64]), the
    merge order, the decoder's InstanceNorm without affine. Both float32 on
    the CPU; the port's convolutions (the conv kernel's plain version) and
    GEMMs sum in another order than the reference's, so the tolerance is the
    port's whole-model float32 one, atol = rtol = 1e-3 (the logits are of
    order 1; a planted mask, index or merge-order fault moves them by more
    than 0.1)."""
    port, plain = pair()
    x = volume(64)
    with torch.no_grad():
        got = port.eval()(x)
        want = plain.eval()(x)
    assert got.shape == want.shape == (1, 3, 64, 64, 64)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


def test_train_step_matches_reference():
    """One train step's loss (BCE-with-logits on a random target) and every
    parameter's gradient at 64×64×32 (stage 3's grid 8×8×4: windows 7×7×4,
    shifted on two axes and not the third; stage 4's 4×4×2 one clipped
    window), under autograd (the plain attention):
    float32 on the CPU; gradients summed in another order, so atol 1e-4 on
    gradients of order 1e-3 to 1 and rtol 1e-3; the loss within 1e-5."""
    port, plain = pair(seed=3)
    x = torch.randn((1, 4, 64, 64, 32), generator=torch.Generator().manual_seed(4)).contiguous(
        memory_format=torch.channels_last_3d)
    target = (torch.rand((1, 3, 64, 64, 32), generator=torch.Generator().manual_seed(5)) > 0.5
              ).float()
    losses = []
    for model in (port.train(), plain.train()):
        model.zero_grad()
        loss = torch.nn.functional.binary_cross_entropy_with_logits(model(x), target)
        loss.backward()
        losses.append(loss.detach())
    torch.testing.assert_close(losses[0], losses[1], atol=1e-5, rtol=0)
    grads = dict(plain.named_parameters())
    for name, p in port.named_parameters():
        assert p.grad is not None, name
        torch.testing.assert_close(p.grad, grads[name].grad, atol=1e-4, rtol=1e-3, msg=name)


def test_shift_mask_regions_and_relative_index_by_hand():
    """A grid of 14 on D (two windows of 7, shift 3) and one window of 2
    on H and W (shift 0): the rolled grid's D planes 0-6 are one region, 7-10
    the second, 11-13 the third; the first window is unmasked, the second
    masks its planes 7-10 against 11-13, as MONAI's compute_mask does. The
    relative index of a 7³ window: (Δd+6)·169 + (Δh+6)·13 + (Δw+6), token 0
    against token 1 (Δw = −1) 1097, token 49 against 0 (Δd = +1) 1267; a
    window of n tokens takes the first n rows and columns."""
    ws, shift = wa.window_geometry((14, 2, 2))
    assert ws == (7, 2, 2) and shift == (3, 0, 0)
    ids = wa.region_ids((14, 2, 2), ws, shift)
    assert (ids[:, 0, 0] // 9).tolist() == [0] * 7 + [1] * 4 + [2] * 3
    assert (ids == ids[:, :1, :1]).all()
    mask = wa.shift_mask((14, 2, 2), ws, shift, torch.device("cpu"))
    assert mask.shape == (2, 28, 28)
    assert (mask[0] == 0).all()
    plane = torch.arange(28) // 4 + 7                # the second window's D planes
    want = torch.where((plane[:, None] >= 11) != (plane[None, :] >= 11), -100.0, 0.0)
    assert torch.equal(mask[1], want)
    torch.testing.assert_close(mask, ref.compute_mask((14, 2, 2), ws, shift), rtol=0, atol=0)
    idx = wa.relative_index(343)
    assert idx[0, 1] == 1097 and idx[49, 0] == 1267 and idx[0, 0] == 1098
    assert torch.equal(idx, ref.relative_position_index())
    assert torch.equal(wa.relative_index(64), ref.relative_position_index()[:64, :64])


@pytest.mark.parametrize("grid,shifted", [((14, 14, 7), True), ((7, 14, 21), False),
                                          ((4, 4, 4), True)])
def test_window_attn_wrapper_on_cpu_is_the_composition(grid, shifted):
    """B4's wrapper on CPU tensors is its plain version, which equals the
    reference's roll, partition, attention and reverse on the same qkv."""
    heads, hd = 2, 16
    ws, shift = wa.window_geometry(grid)
    if not shifted:
        shift = (0, 0, 0)
    gen = torch.Generator().manual_seed(7)
    qkv = torch.randn((2, *grid, 3, heads, hd), generator=gen)
    table = torch.randn(((2 * 7 - 1) ** 3, heads), generator=gen)
    n0 = wa.launches
    got = wa.window_attn(qkv, table, ws, shift)
    assert wa.launches == n0
    assert torch.equal(got, wa.window_attn_plain(qkv, table, ws, shift))
    attn = ref.WindowAttention(heads * hd, heads)
    attn.relative_position_bias_table.data = table
    n = math.prod(ws)
    y = torch.roll(qkv, tuple(-s for s in shift), (1, 2, 3)) if any(shift) else qkv
    windows = ref.window_partition(y.reshape(*y.shape[:4], -1), ws).reshape(-1, n, 3, heads, hd)
    q, k, v = windows.permute(2, 0, 3, 1, 4)
    s = (q * hd ** -0.5) @ k.transpose(-2, -1) + attn.relative_position_bias_table[
        attn.relative_position_index[:n, :n].reshape(-1)].reshape(n, n, -1).permute(2, 0, 1)
    if any(shift):
        mask = ref.compute_mask(grid, ws, shift)
        s = (s.view(2, -1, heads, n, n) + mask[None, :, None]).view(-1, heads, n, n)
    o = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(-1, n, heads * hd)
    o = ref.window_reverse(o, ws, (2, *grid))
    if any(shift):
        o = torch.roll(o, shift, (1, 2, 3))
    torch.testing.assert_close(got, o, atol=1e-5, rtol=1e-5)


def test_attn_route_is_autograd_alone():
    """A block's attention takes B4's wrapper whenever autograd is off,
    whatever the dtype (on a card the wrapper launches B4 or raises), and
    the plain composition under autograd."""
    import brats21_tpu_torch.models.swin_unetr as sw
    assert not sw.attn_route()
    with torch.no_grad():
        assert sw.attn_route()
    with torch.inference_mode():
        assert sw.attn_route()


def test_get_model_is_the_published_network_on_meta():
    """62.19 M parameters (the published 62.2 M), MONAI's key names, no
    norm parameters in the decoder (instance norm without affine), and a
    published checkpoint's relative_position_index buffers dropped on load."""
    with torch.device("meta"):
        model = get_model({"model": "swin_unetr"})
    assert sum(p.numel() for p in model.parameters()) == 62_191_941
    keys = set(model.state_dict())
    for key in ("swinViT.patch_embed.proj.weight", "swinViT.patch_embed.proj.bias",
                "swinViT.layers1.0.blocks.0.norm1.weight",
                "swinViT.layers1.0.blocks.0.attn.qkv.bias",
                "swinViT.layers1.0.blocks.1.attn.relative_position_bias_table",
                "swinViT.layers1.0.blocks.0.attn.proj.weight",
                "swinViT.layers4.0.blocks.1.mlp.linear2.weight",
                "swinViT.layers1.0.downsample.norm.weight",
                "swinViT.layers4.0.downsample.reduction.weight",
                "encoder1.layer.conv1.conv.weight", "encoder1.layer.conv3.conv.weight",
                "encoder10.layer.conv2.conv.weight", "decoder5.transp_conv.conv.weight",
                "decoder1.conv_block.conv3.conv.weight", "out.conv.conv.weight",
                "out.conv.conv.bias"):
        assert key in keys, key
    assert not [k for k in keys if ".norm" in k and not k.startswith("swinViT")]
    assert model.swinViT.layers4[0].blocks[0].attn.relative_position_bias_table.shape == (2197, 24)
    small = SwinUNETR(**SMALL)
    sd = {k: v.clone() for k, v in small.state_dict().items()}
    sd["swinViT.layers1.0.blocks.0.attn.relative_position_index"] = torch.zeros(343, 343)
    small.load_state_dict(sd, strict=True)


def test_instance_norm_without_affine():
    """``InstanceNorm(affine=False)``: no parameters, per-channel zero mean
    and unit variance; the default keeps its affine."""
    norm = InstanceNorm(5, affine=False)
    assert list(norm.parameters()) == []
    assert len(list(InstanceNorm(5).parameters())) == 2
    x = torch.randn(2, 5, 6, 7, 8).contiguous(memory_format=torch.channels_last_3d) * 3 + 1
    y = norm(x)
    torch.testing.assert_close(y, torch.nn.functional.instance_norm(x, eps=1e-5),
                               atol=1e-5, rtol=1e-5)


def test_slab_raises_with_its_reason():
    model = SwinUNETR(**SMALL).eval()
    slab = spatial.Slab(None, 0, (0, 32, 64), 64, 32)
    with torch.no_grad(), spatial.sharded(slab), pytest.raises(ValueError,
                                                              match="cross the slabs"):
        model(volume(32))
    with pytest.raises(ValueError, match="multiple of 32"):
        model(volume(48))


def test_engine_serves_sliding_windows():
    """``Engine.evaluate`` on a cropped 72×64×64 case (with a target) through
    ``--sliding_window_inference`` with 64³ windows, no TTA, float32 on the
    CPU: two windows in one predictor call, through the model's B4 route
    (its plain version here); the saved labels are the thresholded
    stitched sigmoid of the model's own windows."""
    import os
    import tempfile

    torch.manual_seed(0)
    model = SwinUNETR(**SMALL)
    model.load_state_dict(seeded(model, 9))
    model.eval()
    shapes = []
    forward = model.forward

    def counted(x, with_deep=True):
        shapes.append(tuple(x.shape))
        return forward(x, with_deep)

    model.forward = counted
    rng = np.random.default_rng(0)
    # fp16 values: the dense wire carries the case exactly
    img = rng.standard_normal((1, 72, 64, 64, 4)).astype(np.float16).astype(np.float32)
    seg = (rng.random((1, 72, 64, 64, 3)) > 0.7).astype(np.float32)
    batch = {"img": img, "seg": seg, "patient_id": ["sw0"],
             "foreground_start_coord": np.array([[0, 0, 0]]),
             "foreground_end_coord": np.array([[72, 64, 64]]),
             "original_shape": np.array([[72, 64, 64]]), "affine": np.eye(4)[None]}
    cfg = TrainConfig(model="swin_unetr", criterion="dice", no_amp=True,
                      sliding_window_inference=True, sliding_window_size=[64, 64, 64])
    engine = Engine(cfg, torch.device("cpu"), criterion=make_criterion(cfg))
    out = tempfile.mkdtemp(prefix="swin_eval_")
    meters = engine.evaluate([model], [batch], 0, save_seg=True, output_path=out)
    assert shapes == [(2, 4, 64, 64, 64)]
    assert "loss" in meters or meters
    (name,) = os.listdir(out)
    labels = read_nifti(os.path.join(out, name)).data
    assert labels.shape == (72, 64, 64)
    assert set(np.unique(labels).tolist()) <= {0, 1, 2, 4}
    with torch.no_grad():
        x = torch.from_numpy(img).permute(0, 4, 1, 2, 3)
        a = forward(x[:, :, :64].contiguous(memory_format=torch.channels_last_3d))
        b = forward(x[:, :, 8:].contiguous(memory_format=torch.channels_last_3d))
    logits = torch.zeros((1, 3, 72, 64, 64))
    count = torch.zeros((1, 1, 72, 64, 64))
    logits[:, :, :64] += a
    count[:, :, :64] += 1
    logits[:, :, 8:] += b
    count[:, :, 8:] += 1
    binary = (torch.sigmoid(logits / count)[0] >= 0.5).permute(1, 2, 3, 0).numpy()
    want = T.change_label_3_to_4(T.multichannel_to_brats_labels(binary))
    # the stitch sums the same fp32 windows in the same order: voxels on
    # the threshold aside, the labels are these
    assert (labels != want).mean() < 1e-4




# ---------------------------------------------------------------- the card

#: the padded grids of a 128³ window's four stages and their heads (the
#: published network), and ragged ones: a grid of two window sizes, a
#: clipped window of 4³, heads 1
CARD_GRIDS = [((70, 70, 70), 3), ((35, 35, 35), 6), ((21, 21, 21), 12), ((14, 14, 14), 24),
              ((14, 7, 21), 2), ((4, 4, 4), 1)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B4 has no CPU mode")
    ref.no_tf32()
    return torch.device("cuda", 0)


def _card_inputs(grid, heads, dev, seed=0):
    """bf16 qkv of batch 2 with q and k at twice unit scale (scores of a
    few units, as trained attention has) and a unit-scale table."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((2, *grid, 3, heads, 16), generator=gen, device=dev)
    qkv[..., :2, :, :] *= 2.0
    table = torch.randn((2197, heads), generator=gen, device=dev)
    return qkv.to(torch.bfloat16), table


def _attention(qkv, table, ws, shift, round_scores=False):
    """The plain composition in fp32 from the bf16 qkv (the exact answer
    to fp32 rounding), or with the scores rounded to bf16 before the
    softmax (the precision the kernel must not fall to)."""
    b, dp, hp, wp, _, heads, hd = qkv.shape
    x = qkv.float()
    if any(shift):
        x = torch.roll(x, tuple(-s for s in shift), (1, 2, 3))
    n = math.prod(ws)
    q, k, v = wa.partition(x, ws).permute(2, 0, 3, 1, 4).unbind(0)
    s = (q * hd ** -0.5) @ k.transpose(-1, -2) + wa.relative_bias(table, n)[None]
    if any(shift):
        mask = wa.shift_mask((dp, hp, wp), ws, shift, qkv.device)
        s = (s.view(b, -1, heads, n, n) + mask[None, :, None]).view(-1, heads, n, n)
    if round_scores:
        s = s.to(torch.bfloat16).float()
    o = (torch.softmax(s, -1) @ v).permute(0, 2, 1, 3).reshape(-1, n, heads * hd)
    o = wa.unpartition(o, ws, (b, dp, hp, wp))
    return torch.roll(o, tuple(shift), (1, 2, 3)) if any(shift) else o


def _rel_rms(a, b):
    return float((a.float() - b).square().mean().sqrt() / b.square().mean().sqrt())


#: B4's error against the exact answer, relative RMS: the bf16 output's own
#: rounding (2^-9/√3 ≈ 1.1e-3) and the probabilities rounded to bf16 before
#: the product with v; scores rounded to bf16 before the softmax read more
#: than this at every grid (the test shows it)
B4_REL_RMS = 2.5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("grid,heads", CARD_GRIDS)
def test_window_attn_kernel_matches_plain(dev, grid, heads, shifted):
    """B4 against the plain composition on the card, batch 2, both block
    kinds: within :data:`B4_REL_RMS` of the exact answer, as close as the
    plain bf16 composition is, each output element within 4 bf16 ulps of
    its magnitude plus 0.02; scores rounded to bf16 fail the bound."""
    qkv, table = _card_inputs(grid, heads, dev)
    ws, shift = wa.window_geometry(grid)
    if not shifted:
        shift = (0, 0, 0)
    n0 = wa.launches
    got = wa.window_attn(qkv, table, ws, shift)
    torch.cuda.synchronize()
    assert wa.launches == n0 + 1
    plain = wa.window_attn_plain(qkv, table, ws, shift)
    exact = _attention(qkv, table, ws, shift)
    err, err_plain = _rel_rms(got, exact), _rel_rms(plain, exact)
    assert err <= B4_REL_RMS, (err, err_plain)
    assert err <= 1.5 * err_plain + 2e-4, (err, err_plain)
    torch.testing.assert_close(got.float(), exact, atol=0.02, rtol=4 * 2 ** -8)
    assert _rel_rms(_attention(qkv, table, ws, shift, round_scores=True).to(torch.bfloat16),
                    exact) > B4_REL_RMS


#: B4's fp32 path against the fp32 composition, relative RMS: the
#: exponentials' and the sums' order of rounding (fp32, ~1e-7 each); an
#: output rounded to bf16 once reads ~1.1e-3
B4_F32_REL_RMS = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("grid,heads", CARD_GRIDS)
def test_window_attn_kernel_fp32_matches_plain(dev, grid, heads, shifted):
    """B4's fp32 path (``--no_amp``) against the plain composition in fp32
    (TF32 off), batch 2, both block kinds, within :data:`B4_F32_REL_RMS`."""
    qkv, table = _card_inputs(grid, heads, dev)
    qkv = qkv.float()
    ws, shift = wa.window_geometry(grid)
    if not shifted:
        shift = (0, 0, 0)
    n0 = wa.launches
    got = wa.window_attn(qkv, table, ws, shift)
    torch.cuda.synchronize()
    assert wa.launches == n0 + 1 and got.dtype == torch.float32
    exact = wa.window_attn_plain(qkv, table, ws, shift)
    assert _rel_rms(got, exact) <= B4_F32_REL_RMS
    assert _rel_rms(exact.to(torch.bfloat16), exact) > B4_F32_REL_RMS


@pytest.mark.cuda
def test_window_attn_wrapper_raises_rather_than_fall_back(dev):
    qkv, table = _card_inputs((7, 7, 7), 2, dev)
    with pytest.raises(TypeError):
        wa.window_attn(qkv.half(), table, (7, 7, 7), (0, 0, 0))
    with pytest.raises(TypeError):
        wa.window_attn(qkv[..., :12].contiguous(), table, (7, 7, 7), (0, 0, 0))
    with pytest.raises(ValueError, match="contiguous"):
        wa.window_attn(qkv.transpose(1, 2), table, (7, 7, 7), (0, 0, 0))
    with pytest.raises(ValueError, match="divide"):
        wa.window_attn(qkv, table, (5, 7, 7), (0, 0, 0))


@pytest.mark.cuda
def test_served_window_forward_through_b4(dev):
    """The published network on a batch of two 128³ windows in bf16 under
    inference_mode: 8 B4 launches (4 stages × 2 blocks) against the same
    forward through the plain composition; the logits agree to bf16's
    reach through 24 transformer blocks (relative RMS under 2 %)."""
    torch.manual_seed(0)
    model = get_model({"model": "swin_unetr"})
    model.load_state_dict(seeded(model, 11))
    model = model.to(dev).eval()
    x = torch.randn((2, 4, 128, 128, 128), device=dev).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last_3d)
    n0 = wa.launches
    with torch.inference_mode():
        got = model(x)
    assert wa.launches == n0 + 8
    import brats21_tpu_torch.models.swin_unetr as sw
    route = sw.attn_route
    sw.attn_route = lambda: False
    try:
        with torch.inference_mode():
            want = model(x)
    finally:
        sw.attn_route = route
    assert wa.launches == n0 + 8
    assert _rel_rms(got, want.float()) < 0.02


@pytest.mark.cuda
def test_served_fp32_window_forward_through_b4(dev):
    """``--no_amp`` serving: the published network on a 128³ window in fp32
    under inference_mode launches B4's fp32 path 8 times, and its logits
    equal the plain composition's to fp32's reach (relative RMS 1e-4)."""
    torch.manual_seed(0)
    model = get_model({"model": "swin_unetr"})
    model.load_state_dict(seeded(model, 11))
    model = model.to(dev).eval()
    x = torch.randn((1, 4, 128, 128, 128), device=dev).contiguous(
        memory_format=torch.channels_last_3d)
    n0 = wa.launches
    with torch.inference_mode():
        got = model(x)
    assert wa.launches == n0 + 8 and got.dtype == torch.float32
    import brats21_tpu_torch.models.swin_unetr as sw
    route = sw.attn_route
    sw.attn_route = lambda: False
    try:
        with torch.inference_mode():
            want = model(x)
    finally:
        sw.attn_route = route
    assert _rel_rms(got, want) < 1e-4
