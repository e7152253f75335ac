"""The port's EquiUnetASSPEvo and weight carry-over against the JAX
package: flax params → the port's state_dict (and back), reference .pth
unwrapping, the forward and deep heads at width 8, and TTA, all fp32 on the
CPU with the same numpy inputs on both sides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brats21_tpu.models import get_model as jax_get_model
from brats21_tpu.ops.tta import tta_mean_probs as jax_tta_mean_probs
from brats21_tpu.utils.import_torch import state_dict_to_flax
from brats21_tpu_torch.learning.engine import forward_main_head
from brats21_tpu_torch.models import get_model
from brats21_tpu_torch.ops.tta import COMBOS, tta_mean_probs
from brats21_tpu_torch.utils.weights import load_reference_pth, state_dict_from_flax
from test_torch_port_kernels import one_torch_thread  # noqa: F401  (autouse)

CFG = {"model": "equiunet_assp_evo", "width": 8}


@pytest.fixture(scope="module")
def jax_pair():
    """(flax model, params) at width 8: torch-default-init weights with
    perturbed EvoNorm affines and biases, carried into the flax tree by the
    JAX package's own importer (shapes from ``eval_shape``, no init run)."""
    model = jax_get_model(CFG)
    template = jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 16, 16, 16, 4), jnp.float32))["params"]
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in get_model(CFG).state_dict().items():
        v = v.numpy()
        if k.endswith(("gamma", "beta", "bias")):
            v = v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
        sd[k] = v
    return model, state_dict_to_flax(sd, "equiunet_assp_evo", template)


@pytest.fixture(scope="module")
def port_model(jax_pair):
    model = get_model(CFG).eval()
    model.load_state_dict(state_dict_from_flax(jax_pair[1]), strict=True)
    return model


def _to_torch_input(x):
    """numpy channels-last [B, D, H, W, C] → NCDHW channels_last_3d."""
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3)


def test_state_dict_from_flax_loads_strict(jax_pair):
    sd = state_dict_from_flax(jax_pair[1])
    model = get_model(CFG)
    missing, unexpected = model.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    assert set(sd) == set(model.state_dict())
    assert sd["encoder1.conv_conv_se.0.weight"].shape == (8, 4, 3, 3, 3)
    assert sd["encoder1.conv_conv_se.6.fc.0.weight"].shape == (4, 8)
    assert sd["aspp.conv_k1.evo.gamma"].shape == (1, 64, 1, 1, 1)
    assert sd["deep3.0.weight"].shape == (3, 32, 1, 1, 1)


def test_state_dict_round_trips_through_jax_importer(jax_pair, port_model):
    """port state_dict → the JAX package's state_dict_to_flax consumes every
    tensor and reproduces the flax tree exactly."""
    sd = {k: v.numpy() for k, v in port_model.state_dict().items()}
    back = state_dict_to_flax(sd, "equiunet_assp_evo", jax_pair[1])
    flat_want = jax.tree_util.tree_leaves_with_path(jax_pair[1])
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_want) == len(flat_got)
    for path, want in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), want)


def test_reference_pth_unwraps_swa_averaged_model(tmp_path, port_model):
    avg = torch.optim.swa_utils.AveragedModel(port_model)
    pth = str(tmp_path / "last_model.pth")
    torch.save({"epoch": 3, "model": {"stale": torch.zeros(1)},
                "swa_model": avg.state_dict()}, pth)
    sd = load_reference_pth(pth, prefer_swa=True)
    assert "n_averaged" not in sd and not any(k.startswith("module.") for k in sd)
    fresh = get_model(CFG)
    fresh.load_state_dict(sd, strict=True)
    for k, v in port_model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
    with pytest.raises(KeyError, match="no model"):
        torch.save({"epoch": 3}, str(tmp_path / "bad.pth"))
        load_reference_pth(str(tmp_path / "bad.pth"))


def test_forward_and_deep_heads_match_jax(jax_pair, port_model):
    model, params = jax_pair
    x = np.random.default_rng(1).standard_normal((1, 32, 32, 32, 4)).astype(np.float32)
    want, want_deeps = model.apply({"params": params}, jnp.asarray(x),
                                   deterministic=True)
    with torch.inference_mode():
        got, got_deeps = port_model(_to_torch_input(x))
        main_only = port_model(_to_torch_input(x), with_deep=False)
    assert len(got_deeps) == len(want_deeps) == 2
    for g, w in [(got, want)] + list(zip(got_deeps, want_deeps)):
        np.testing.assert_allclose(g.permute(0, 2, 3, 4, 1).numpy(), np.asarray(w),
                                   atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(main_only[0], got, rtol=0, atol=0)
    assert main_only[1] == []


def test_bf16_forward_on_cpu_tracks_fp32(port_model):
    """The served precision (bf16 activations, fp32 parameters) also runs
    with the plain versions on the CPU, and stays within 5e-2·max|fp32|
    of the fp32 forward (bf16 keeps 8 bits of mantissa; measured 1.1e-2
    at this size)."""
    x = np.random.default_rng(3).standard_normal((1, 16, 16, 16, 4)).astype(np.float32)
    with torch.inference_mode():
        want = port_model(_to_torch_input(x), with_deep=False)[0]
        got = port_model(_to_torch_input(x).to(torch.bfloat16), with_deep=False)[0]
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert (got.float() - want).abs().max() <= 5e-2 * want.abs().max()


def test_tta_mean_probs_matches_jax(jax_pair, port_model):
    model, params = jax_pair
    x = np.random.default_rng(2).standard_normal((1, 24, 24, 16, 4)).astype(np.float32)
    want, _ = jax_tta_mean_probs(
        lambda v: model.apply({"params": params}, v, deterministic=True),
        jnp.asarray(x))
    with torch.inference_mode():
        got = tta_mean_probs(lambda v: forward_main_head(port_model, v),
                             torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (1, 24, 24, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)


def test_tta_square_padding_matches_jax():
    from brats21_tpu.ops.tta import pad_to_square_tta as jax_pad
    from brats21_tpu_torch.ops.tta import crop_from_square_tta, pad_to_square_tta
    x = np.random.default_rng(4).standard_normal((1, 6, 9, 5, 3)).astype(np.float32)
    got, pads = pad_to_square_tta(torch.from_numpy(x))
    want, want_pads = jax_pad(jnp.asarray(x))
    assert pads == want_pads == (3, 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(crop_from_square_tta(got, pads).numpy(), x)


def test_tta_combos_in_reference_order():
    assert len(COMBOS) == 16
    assert COMBOS[0] == ("zxy", False, 0) and COMBOS[5] == ("zxy", True, 90)
    assert COMBOS[-1] == ("xyz", True, 270)


def test_get_model_names_later_slices():
    with pytest.raises(NameError, match="model-zoo"):
        get_model({"model": "equiunet", "width": 8})
    with pytest.raises(NameError, match="Not Supported"):
        get_model({"model": "nope"})
