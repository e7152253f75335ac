"""The glue between EquiUnetASSPEvo's blocks on the CPU: the plain versions
of ``se_gate_pool`` (the ResidualSE gate with MaxAvgPool) and
``upsample_cat`` (the trilinear ×2 upsample with the skip concat) against
the composition of PyTorch calls the model makes, bit for bit; the
kernels' launch plans; and the model's forward through the glue route (no
autograd, no slab) against its grad-enabled forward. The kernels
themselves run only on a card (tests/test_torch_port_cuda.py,
chip_smoke.py)."""

import pytest
import torch

from brats21_tpu_torch.models import assp_evo, get_model
from brats21_tpu_torch.models.layers import (from_kernel_layout, max_avg_pool,
                                             to_kernel_layout, upsample)
from brats21_tpu_torch.ops.kernels.glue import (GluePlan, glue_plan, se_gate_pool,
                                                upsample_cat)
from brats21_tpu_torch.parallel import spatial

DTYPES = [torch.float32, torch.bfloat16]


def _channels_last(shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dtype).contiguous(
        memory_format=torch.channels_last_3d)


@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_se_gate_pool_plain_equals_composition(dtype, pool):
    """``ResidualSELayer`` (its gate from the module) then ``max_avg_pool``
    and the next conv's ``to_kernel_layout``, against one call."""
    torch.manual_seed(0)
    se = assp_evo.ResidualSELayer(24)
    x = _channels_last((2, 24, 6, 4, 10), dtype, 1)
    with torch.no_grad():
        s = se.gate(x)
        want = se(x)
        y, pooled = se_gate_pool(to_kernel_layout(x), s, pool)
    assert torch.equal(y, to_kernel_layout(want))
    if pool:
        assert pooled.is_contiguous() and pooled.shape == (2, 3, 2, 5, 48)
        assert torch.equal(pooled, to_kernel_layout(max_avg_pool(want)))
    else:
        assert pooled is None


@pytest.mark.parametrize("dtype", DTYPES)
def test_upsample_cat_plain_equals_composition(dtype):
    skip = _channels_last((2, 8, 6, 4, 10), dtype, 2)
    low = _channels_last((2, 16, 3, 2, 5), dtype, 3)
    out = upsample_cat(to_kernel_layout(skip), to_kernel_layout(low))
    want = torch.cat([skip, upsample(low)], dim=1)
    assert out.is_contiguous() and out.shape == (2, 6, 4, 10, 24)
    assert torch.equal(out, to_kernel_layout(want))


def test_glue_wrappers_check_shapes():
    x = torch.zeros((1, 4, 3, 4, 8))
    with pytest.raises(ValueError, match="even"):
        se_gate_pool(x, torch.zeros((1, 8)), pool=True)
    with pytest.raises(ValueError, match=r"\[B, C\]"):
        se_gate_pool(x, torch.zeros((1, 4)), pool=False)
    with pytest.raises(ValueError, match="2D"):
        upsample_cat(torch.zeros((1, 4, 6, 8, 8)), x)


@pytest.mark.parametrize("rows,widths,itemsize,align,want", [
    # the served level 1 in bf16: 16-byte vectors, 6 threads a voxel
    (680000, (48,), 2, 16, GluePlan(8, 6, 42, 16191)),
    # the upsample's two segments at level 1; level 3's 192 channels
    (5440000, (24, 24), 2, 16, GluePlan(8, 6, 42, 129524)),
    (85000, (96, 96), 2, 16, GluePlan(8, 24, 10, 8500)),
    # fp32: 4 channels a vector; a segment of 4 bf16 channels; an address
    # 8-byte aligned; C = 384 at level 4
    (100, (48,), 4, 16, GluePlan(4, 12, 21, 5)),
    (100, (12, 4), 2, 16, GluePlan(4, 4, 64, 2)),
    (100, (48,), 2, 8, GluePlan(4, 12, 21, 5)),
    (10625, (384,), 2, 16, GluePlan(8, 48, 5, 2125)),
])
def test_glue_plan(rows, widths, itemsize, align, want):
    assert glue_plan(rows, widths, itemsize, align) == want


def test_glue_plan_refuses_more_threads_than_a_block():
    with pytest.raises(ValueError, match="threads"):
        glue_plan(10, (514,), 2)


def _narrow_model():
    torch.manual_seed(0)
    return get_model({"model": "equiunet_assp_evo", "width": 8}).eval()


@pytest.mark.parametrize("with_deep", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_inference_forward_equals_grad_forward(dtype, with_deep):
    """The CPU forward under ``inference_mode`` (the glue route, on the
    plain versions) equals the grad-enabled forward (the composition)
    exactly, with and without the deep heads."""
    model = _narrow_model()
    x = _channels_last((1, 4, 16, 24, 16), dtype, 4)
    want, want_deeps = model(x, with_deep=with_deep)
    with torch.inference_mode():
        got, got_deeps = model(x, with_deep=with_deep)
    assert torch.equal(got, want)
    assert len(got_deeps) == len(want_deeps) == (2 if with_deep else 0)
    assert all(torch.equal(g, w) for g, w in zip(got_deeps, want_deeps))


def test_glue_route_only_without_autograd_outside_a_slab():
    assert not assp_evo.glue_route()
    with torch.no_grad():
        assert assp_evo.glue_route()
    with torch.inference_mode():
        assert assp_evo.glue_route()
        with spatial.sharded(object()):
            assert not assp_evo.glue_route()


def test_state_dict_keys_unchanged():
    """The reference's keys: ``conv_conv_se.{0,1,3,4,6}`` in every block."""
    keys = list(_narrow_model().state_dict())
    block = ["0.weight", "0.bias", "1.gamma", "1.beta", "1.v", "1.running_var", "3.weight",
             "3.bias", "4.gamma", "4.beta", "4.v", "4.running_var", "6.fc.0.weight",
             "6.fc.0.bias", "6.fc.2.weight", "6.fc.2.bias"]
    for name in ("encoder1", "encoder2", "encoder3", "encoder4", "decoder3", "decoder2",
                 "decoder1"):
        assert [k for k in keys if k.startswith(name + ".")] == [
            f"{name}.conv_conv_se.{k}" for k in block]
    assert len(keys) == 168
