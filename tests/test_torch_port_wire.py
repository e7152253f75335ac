"""The port's wire formats (``brats21_tpu_torch/ops/wire.py``) against the
JAX package's on the same numpy inputs: the host halves write the same
bytes, the device halves (here on CPU tensors) decode to the same arrays,
and every round trip is exact. Then the engine's wire choice
(``_resolve_wire``, ``probe_wire_bandwidth``) and the train wire
(``BRATS21_TRAIN_WIRE``) against the JAX engine's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brats21_tpu.config import TrainConfig as JaxTrainConfig
from brats21_tpu.learning.engine import Engine as JaxEngine
from brats21_tpu.learning.losses import make_criterion as jax_make_criterion
from brats21_tpu.models import get_model as jax_get_model
from brats21_tpu.ops import wire as jax_wire
from brats21_tpu.parallel.mesh import make_mesh
from brats21_tpu_torch.config import TrainConfig
from brats21_tpu_torch.learning import engine as engine_mod
from brats21_tpu_torch.learning.engine import Engine, probe_wire_bandwidth
from brats21_tpu_torch.ops import wire
from test_torch_port_kernels import one_torch_thread  # noqa: F401  (autouse)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _volume(seed, shape=(13, 11, 7, 4), dtype=np.float16):
    """A volume with a zero background slab and zeros scattered inside."""
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        vol = rng.integers(0, 900, shape).astype(dtype)
    else:
        vol = rng.standard_normal(shape).astype(dtype)
    vol[:3] = 0
    vol[rng.random(shape[:3]) < 0.2] = 0
    return vol


@pytest.mark.parametrize("dtype,cap_step", [(np.float16, wire.CAP_STEP), (np.float16, 64),
                                            (np.int16, 100), (np.float32, 7)])
def test_pack_volume_matches_jax_and_round_trips(dtype, cap_step):
    vol = _volume(1, dtype=dtype)
    bits, vals = wire.pack_volume(vol, cap_step=cap_step)
    jbits, jvals = jax_wire.pack_volume(vol, cap_step=cap_step)
    _same(bits, jbits)
    _same(vals, jvals)
    got = wire.unpack_volume_device(torch.from_numpy(bits), torch.from_numpy(vals),
                                    vol.shape[:3]).numpy()
    want = np.asarray(jax_wire.unpack_volume_device(jnp.asarray(jbits), jnp.asarray(jvals),
                                                    vol.shape[:3]))
    _same(got, want)
    _same(got[0], vol)


@pytest.mark.parametrize("b", range(1, 17))
def test_narrow_values_match_jax(b):
    rng = np.random.default_rng(b)
    vals = rng.integers(0, 1 << b, (37, 4)).astype(np.int32)
    vals[0, 0] = (1 << b) - 1
    packed = wire.pack_values_narrow(vals, b)
    _same(packed, jax_wire.pack_values_narrow(vals, b))
    host = wire.unpack_values_narrow(packed, 37, 4, b)
    _same(host, jax_wire.unpack_values_narrow(packed, 37, 4, b))
    _same(host, vals)
    dev = wire.unpack_values_narrow_device(torch.from_numpy(packed), 37, 4, b,
                                           dtype=torch.int32).numpy()
    jdev = np.asarray(jax_wire.unpack_values_narrow_device(jnp.asarray(packed), 37, 4, b,
                                                           dtype=jnp.int32))
    _same(dev, jdev)
    _same(dev, vals)
    assert wire.narrow_bits_for(vals) == jax_wire.narrow_bits_for(vals)


def test_narrow_volume_and_bits_for_match_jax():
    vol = _volume(2, dtype=np.int16)
    b = wire.narrow_bits_for(vol)
    assert b == jax_wire.narrow_bits_for(vol) == 10
    bits, packed, cap = wire.pack_volume_narrow(vol, b, cap_step=64)
    jbits, jpacked, jcap = jax_wire.pack_volume_narrow(vol, b, cap_step=64)
    _same(bits, jbits)
    _same(packed, jpacked)
    assert cap == jcap
    got = wire.unpack_volume_narrow_device(torch.from_numpy(bits), torch.from_numpy(packed),
                                           vol.shape[:3], 4, cap, b).numpy()
    _same(got[0], vol)
    for arr in (np.zeros(0, np.int16), np.array([-1, 3]), np.array([0.5]),
                np.array([1 << 16]), np.array([0, 0, 0], np.uint8)):
        assert wire.narrow_bits_for(arr) == jax_wire.narrow_bits_for(arr)


@pytest.mark.parametrize("shape", [(1, 8, 8, 8, 3), (1, 5, 7, 3, 3), (13,)])
def test_pack_bits_matches_jax_and_round_trips(shape):
    binary = (np.random.default_rng(3).random(shape) > 0.5).astype(np.float32)
    packed = wire.pack_bits_device(torch.from_numpy(binary)).numpy()
    _same(packed, np.asarray(jax_wire.pack_bits_device(jnp.asarray(binary))))
    _same(packed, np.packbits(binary.astype(np.uint8).reshape(-1)))
    _same(wire.unpack_bits(packed, shape), binary)
    _same(wire.unpack_bits(packed, shape), jax_wire.unpack_bits(packed, shape))


def test_pack_labels_match_jax_and_round_trip():
    rng = np.random.default_rng(4)
    labels = rng.choice(np.array([0, 1, 2, 4], np.uint8), size=(6, 5, 4))
    for arr in (labels, labels.astype(np.float32)):
        packed = wire.pack_labels_device(torch.from_numpy(arr)).numpy()
        _same(packed, np.asarray(jax_wire.pack_labels_device(jnp.asarray(arr))))
        _same(wire.unpack_labels(packed, labels.shape), labels)
        _same(wire.unpack_labels(packed, labels.shape),
              jax_wire.unpack_labels(packed, labels.shape))


# ------------------------------------------------------------ wire choice

def _engine(**kw):
    return Engine(TrainConfig(model="equiunet", width=4, **kw), torch.device("cpu"))


def test_resolve_wire_precedence(monkeypatch):
    monkeypatch.delenv("BRATS21_SPARSE_WIRE", raising=False)
    assert _engine(wire="sparse")._resolve_wire() == "sparse"
    assert _engine(wire="dense")._resolve_wire() == "dense"
    # the variable beats the config
    monkeypatch.setenv("BRATS21_SPARSE_WIRE", "1")
    assert _engine(wire="dense")._resolve_wire() == "sparse"
    for off in ("0", "false", "False"):
        monkeypatch.setenv("BRATS21_SPARSE_WIRE", off)
        assert _engine(wire="sparse")._resolve_wire() == "dense"
    with pytest.raises(ValueError, match="wire"):
        TrainConfig(model="equiunet", wire="packed").validate()


def test_resolve_wire_auto_probes(monkeypatch):
    monkeypatch.delenv("BRATS21_SPARSE_WIRE", raising=False)
    monkeypatch.delenv("BRATS21_WIRE_AUTO_MBPS", raising=False)
    monkeypatch.setattr(engine_mod, "probe_wire_bandwidth", lambda device: 40.0)
    assert _engine(wire="auto")._resolve_wire() == "sparse"
    monkeypatch.setattr(engine_mod, "probe_wire_bandwidth", lambda device: 4000.0)
    engine = _engine(wire="auto")
    assert engine._resolve_wire() == "dense"
    # resolved once an engine
    monkeypatch.setattr(engine_mod, "probe_wire_bandwidth", lambda device: 40.0)
    assert engine._resolve_wire() == "dense"
    monkeypatch.setattr(engine_mod, "probe_wire_bandwidth", lambda device: 4000.0)
    monkeypatch.setenv("BRATS21_WIRE_AUTO_MBPS", "8000")
    assert _engine(wire="auto")._resolve_wire() == "sparse"


def test_probe_wire_bandwidth_is_finite_and_cached():
    a = probe_wire_bandwidth(torch.device("cpu"))
    b = probe_wire_bandwidth("cpu")
    assert np.isfinite(a) and a > 0 and a == b


def test_pack_case_host_matches_jax(monkeypatch):
    """The prep stage's host half writes the JAX engine's payload."""
    monkeypatch.delenv("BRATS21_SPARSE_WIRE", raising=False)
    padded = _volume(5, shape=(16, 16, 8, 4), dtype=np.float32)
    mesh = make_mesh(jax.devices()[:1], data=1, space=1)
    for mode in ("dense", "sparse"):
        jcfg = JaxTrainConfig(model="equiunet", width=4, wire=mode)
        jeng = JaxEngine(jcfg, jax_get_model(jcfg), jax_make_criterion(jcfg), mesh=mesh)
        got, want = _engine(wire=mode)._pack_case_host(padded), jeng._pack_case_host(padded)
        assert got[0] == want[0] == mode and len(got) == len(want)
        for a, b in zip(got[1:], want[1:]):
            _same(a, b)


@pytest.mark.parametrize("env", [None, "fp32"])
@pytest.mark.parametrize("no_amp", [False, True])
def test_train_wire_matches_jax(monkeypatch, env, no_amp):
    if env:
        monkeypatch.setenv("BRATS21_TRAIN_WIRE", env)
    else:
        monkeypatch.delenv("BRATS21_TRAIN_WIRE", raising=False)
    rng = np.random.default_rng(6)
    img = rng.standard_normal((2, 8, 8, 8, 4)).astype(np.float32)
    seg = (rng.random((2, 8, 8, 8, 3)) > 0.5).astype(np.float32)
    jcfg = JaxTrainConfig(model="equiunet", width=4, no_amp=no_amp)
    jeng = JaxEngine(jcfg, jax_get_model(jcfg), jax_make_criterion(jcfg),
                     mesh=make_mesh(jax.devices()[:1], data=1, space=1))
    eng = _engine(no_amp=no_amp, criterion="dice")
    _same(eng._train_wire_img(img), jeng._train_wire_img(img))
    _same(eng._train_wire_seg(seg), jeng._train_wire_seg(seg))
    want_img = np.float32 if (no_amp or env) else np.float16
    x, target = eng.batch_to_device({"img": img, "seg": seg})
    assert x.dtype == torch.from_numpy(np.zeros(1, want_img)).dtype
    assert target.dtype == torch.float32
    np.testing.assert_array_equal(target.permute(0, 2, 3, 4, 1).numpy(), seg)
