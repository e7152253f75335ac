"""The port's kernel modules on the CPU: each plain PyTorch version held
against the JAX package's XLA reference and its Pallas kernel in interpret
mode, on the same numpy inputs. The CUDA kernels themselves run only
on a card (tests/test_torch_port_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brats21_tpu_torch.ops import kernels
from brats21_tpu_torch.ops.kernels.conv3d import conv3x3x3, conv3x3x3_plain
from brats21_tpu_torch.ops.kernels.evonorm import evonorm_s0, evonorm_s0_plain

CONV_CASES = [((1, 6, 11, 7, 5), 9), ((2, 5, 16, 8, 4), 6),
              ((1, 4, 13, 17, 4), 8), ((1, 5, 9, 7, 8), 8)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread per test process: the suite runs six xdist
    workers, each also holding XLA's thread pools, and torch's default of
    one thread per core oversubscribes the host (measured: the port's CPU
    tests ran twice as long)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("BRATS21_PALLAS", "interpret")


def _conv_inputs(seed, shape, cout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, shape[-1], cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("shape,cout", CONV_CASES)
def test_conv_plain_matches_xla(shape, cout):
    from brats21_tpu.ops.pallas.conv3d_kernel import _conv3x3x3_xla
    x, w, b = _conv_inputs(1, shape, cout)
    want = np.asarray(_conv3x3x3_xla(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = conv3x3x3_plain(*map(torch.from_numpy, (x, w, b))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape,cout", CONV_CASES[:2])
def test_conv_plain_matches_pallas_interpret(interpret, shape, cout):
    from brats21_tpu.ops.pallas.conv3d_kernel import conv3x3x3 as conv_pallas
    x, w, b = _conv_inputs(2, shape, cout)
    want = np.asarray(conv_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = conv3x3x3_plain(*map(torch.from_numpy, (x, w, b))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_conv_wrapper_on_cpu_is_the_plain_version():
    x, w, b = map(torch.from_numpy, _conv_inputs(3, (1, 4, 5, 6, 4), 8))
    before = kernels.conv3d.launches
    torch.testing.assert_close(conv3x3x3(x, w, b), conv3x3x3_plain(x, w, b),
                               rtol=0, atol=0)
    assert kernels.conv3d.launches == before      # no kernel launched


def _evo_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    x = (0.5 + 2.0 * rng.standard_normal(shape)).astype(np.float32)
    gamma = (1.0 + 0.2 * rng.standard_normal(shape[-1])).astype(np.float32)
    beta = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, gamma, beta


@pytest.mark.parametrize("c", [8, 24, 48])
def test_evonorm_plain_matches_xla(c):
    from brats21_tpu.ops.pallas.evonorm_kernel import _evonorm_s0_xla
    x, g, b = _evo_inputs(c, (2, 5, 6, 7, c))
    want = np.asarray(_evonorm_s0_xla(jnp.asarray(x), jnp.asarray(g),
                                      jnp.asarray(b), 8, 1e-5))
    got = evonorm_s0_plain(*map(torch.from_numpy, (x, g, b))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("c", [8, 24, 48])
def test_evonorm_plain_matches_pallas_interpret(interpret, c):
    from brats21_tpu.ops.pallas.evonorm_kernel import evonorm_s0_pallas
    x, g, b = _evo_inputs(100 + c, (1, 4, 6, 5, c))
    want = np.asarray(evonorm_s0_pallas(jnp.asarray(x), jnp.asarray(g),
                                        jnp.asarray(b), groups=8))
    got = evonorm_s0_plain(*map(torch.from_numpy, (x, g, b))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty((1, 2, 2, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        conv3x3x3(x, torch.empty((3, 3, 3, 8, 8), device="meta"),
                  torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        evonorm_s0(x, torch.empty(8, device="meta"), torch.empty(8, device="meta"))


def test_missing_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.find_nvcc()


def test_build_output_is_named_by_source_hash():
    path = kernels.library_path("conv3x3x3.cu")
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("conv3x3x3-") and path.suffix == ".so"
