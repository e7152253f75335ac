"""The port's EDT on the CPU against the JAX package and scipy: the envelope's
plain version against ``ops/edt.py:_envelope_1d`` and the Pallas
``envelope_last_axis`` in interpret mode, bit for bit, with the 1e12
sentinels and a sampling of 1.5; ``edt_sq``, ``one_hot2dist`` and
``one_hot2hd_dist`` against the JAX package's and scipy's on odd-sized 3D
masks with an empty channel. The CUDA kernel runs only on a card
(tests/test_torch_port_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax.numpy as jnp

from brats21_tpu.ops import edt as jedt
from brats21_tpu_torch.ops import edt as pedt
from brats21_tpu_torch.ops.kernels import edt as kedt
from test_torch_port_kernels import one_torch_thread  # noqa: F401  (autouse)


def _lines(seed, shape, p=0.5):
    """fp32 lines of 0 and the 1e12 sentinel, as ``edt_sq``'s first pass
    sees them, plus a few finite values as later passes do."""
    rng = np.random.default_rng(seed)
    g = np.where(rng.random(shape) > p, 0.0, kedt.INF).astype(np.float32)
    g[..., 1] = rng.integers(0, 50, shape[:-1])
    return g


@pytest.mark.parametrize("sampling", [1.0, 1.5])
def test_envelope_plain_equals_jax_scan(sampling):
    g = _lines(1, (6, 5, 37))
    want = np.asarray(jedt._envelope_1d(jnp.asarray(g), sampling))
    got = kedt.envelope_plain(torch.from_numpy(g), sampling).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sampling", [1.0, 1.5])
def test_envelope_plain_equals_pallas_interpret(monkeypatch, sampling):
    from brats21_tpu.ops.pallas.edt_kernel import envelope_last_axis
    monkeypatch.setenv("BRATS21_PALLAS", "interpret")
    g = _lines(2, (9, 23))
    want = np.asarray(envelope_last_axis(jnp.asarray(g), sampling))
    got = kedt.envelope_plain(torch.from_numpy(g), sampling).numpy()
    np.testing.assert_array_equal(got, want)


def test_envelope_along_a_middle_axis():
    """The wrapper runs along any axis in place (the kernel's
    ``[outer, n, inner]`` view); on the CPU it is the plain version, which
    equals the JAX scan along that axis moved last, and launches nothing."""
    g = _lines(3, (3, 11, 4, 6))
    before = kedt.launches
    got = kedt.envelope(torch.from_numpy(g), 1.5, axis=1)
    assert kedt.launches == before and got.is_contiguous()
    want = np.moveaxis(np.asarray(jedt._envelope_1d(
        jnp.asarray(np.moveaxis(g, 1, -1)), 1.5)), -1, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def _masks(seed):
    """Three odd-sized 3D masks, the last one empty."""
    m = np.random.default_rng(seed).random((3, 13, 9, 11)) > 0.6
    m[2] = False
    return m


@pytest.mark.parametrize("sampling", [None, (1.0, 1.0, 1.5)])
def test_edt_sq_matches_jax_and_scipy(sampling):
    masks = _masks(4)
    got = pedt.edt_sq(torch.from_numpy(masks), sampling).numpy()
    for k in range(len(masks)):
        want = np.asarray(jedt.edt_sq(jnp.asarray(masks[k]), sampling))
        np.testing.assert_array_equal(got[k], want)
        if masks[k].any():
            ref = ndimage.distance_transform_edt(masks[k], sampling=sampling) ** 2
            np.testing.assert_allclose(got[k], ref, rtol=1e-6, atol=1e-4)


def test_one_hot2dist_and_hd_dist_match_jax_and_scipy():
    seg = _masks(5).astype(np.float32)
    got_d = pedt.one_hot2dist(torch.from_numpy(seg)).numpy()
    got_hd = pedt.one_hot2hd_dist(torch.from_numpy(seg)).numpy()
    np.testing.assert_allclose(got_d, np.asarray(jedt.one_hot2dist(jnp.asarray(seg))),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got_hd, np.asarray(jedt.one_hot2hd_dist(jnp.asarray(seg))),
                               rtol=1e-6, atol=1e-5)
    for k in range(len(seg)):
        pos = seg[k].astype(bool)
        if not pos.any():
            assert (got_d[k] == 0).all() and (got_hd[k] == 0).all()
            continue
        want = (ndimage.distance_transform_edt(~pos) * ~pos
                - (ndimage.distance_transform_edt(pos) - 1) * pos)
        np.testing.assert_allclose(got_d[k], want, atol=1e-4)
        np.testing.assert_allclose(got_hd[k], ndimage.distance_transform_edt(pos),
                                   atol=1e-4)


def test_envelope_wrapper_refuses_devices_without_a_kernel():
    with pytest.raises(ValueError, match="no kernel"):
        kedt.envelope(torch.empty((2, 8), device="meta"))


def test_envelope_build_output_is_named_by_source_hash():
    from brats21_tpu_torch.ops import kernels
    path = kernels.library_path(kedt.SOURCE)
    assert path.name.startswith("edt_envelope-") and path.suffix == ".so"
