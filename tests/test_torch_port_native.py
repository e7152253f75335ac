"""The port's native case loader (``data/native.py`` over
``csrc/nifti_native.cc``) and ``ops/preprocess.py`` on the CPU: the loader
against the JAX package's native path and the port's own numpy path on the
same synthetic cases, its fallback, and its first build under concurrent
callers; the tensor z-score against the JAX function."""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brats21_tpu.data import native as jnative
from brats21_tpu.data.pipeline import BraTSDataset as JaxBraTSDataset
from brats21_tpu.ops.preprocess import normalize_intensity_device as jax_normalize
from brats21_tpu_torch.data import native
from brats21_tpu_torch.data.discovery import (MODALITIES_WITH_SEG, create_database,
                                              make_file_records)
from brats21_tpu_torch.data.nifti import read_nifti, write_nifti
from brats21_tpu_torch.data.pipeline import BraTSDataset
from brats21_tpu_torch.data.synthetic import generate_synthetic_dataset
from brats21_tpu_torch.ops import kernels
from brats21_tpu_torch.ops.preprocess import normalize_intensity_device
from test_torch_port_kernels import one_torch_thread  # noqa: F401  (autouse)

# eval datasets normalise at load; train datasets load raw
MODES = {"eval": dict(with_seg=True),
         "train": dict(with_seg=True, normalize=False, remove_outliers=True)}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Two synthetic cases of 40×48×32 with segs: the first as written
    (float32, identity affine), the second rewritten as int16 voxels, the
    BraTS source dtype, with a 1×1×1.5 mm affine and an offset."""
    root = tmp_path_factory.mktemp("port_native")
    generate_synthetic_dataset(str(root), num_cases=2, shape=(40, 48, 32), seed=21)
    recs = make_file_records(create_database(str(root), required_modality=MODALITIES_WITH_SEG),
                             with_seg=True)
    affine = np.diag([1.0, 1.0, 1.5, 1.0])
    affine[:3, 3] = (-90.0, 126.0, -72.0)
    for path in recs[1]["img"]:
        data = read_nifti(path).data
        write_nifti(path, np.round(np.asarray(data) * 10).astype(np.int16), affine)
    return recs


@pytest.mark.parametrize("mode", sorted(MODES))
def test_dataset_native_path_equals_jax_native_path(records, mode):
    """The port's ``BraTSDataset[i]`` on its native path against the JAX
    package's on its own: the same source, flags and inputs, so image,
    bounding box, shapes, affine and seg are equal bit for bit."""
    assert jnative.available()
    native.take_counts()
    ds, jds = BraTSDataset(records, **MODES[mode]), JaxBraTSDataset(records, **MODES[mode])
    for i in range(len(records)):
        got, want = ds[i], jds[i]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v
    assert native.take_counts() == dict(loads=len(records), fallbacks=0)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_dataset_native_path_matches_numpy_path(records, mode):
    """Against the port's numpy path: the same crop, seg and affine; the
    image within 1e-4 (the library takes its statistics in one pass)."""
    ds = BraTSDataset(records, **MODES[mode])
    for i, rec in enumerate(records):
        got, want = ds._getitem_native(rec), ds._getitem_numpy(rec)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if k == "img":
                assert got[k].shape == v.shape
                np.testing.assert_allclose(got[k], v, atol=1e-4, rtol=0)
            else:
                np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert ds[i]["img"].dtype == np.float32


def test_already_preprocess_stays_on_numpy(records):
    native.take_counts()
    ds = BraTSDataset(records, with_seg=True, already_preprocess=True)
    sample = ds[0]
    assert sample["img"].shape == (40, 48, 32, 4)
    assert native.take_counts() == dict(loads=0, fallbacks=0)


def test_failed_build_falls_back_to_numpy(records, monkeypatch):
    """A compiler that cannot run: one warning, the numpy path's sample,
    and every case counted as a fallback."""
    warnings = []
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native.logger, "warning", lambda *a: warnings.append(a))
    monkeypatch.setenv("CXX", "/nonexistent/c++")
    native.take_counts()
    ds = BraTSDataset(records, **MODES["eval"])
    for i, rec in enumerate(records):
        got, want = ds[i], ds._getitem_numpy(rec)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert native.take_counts() == dict(loads=0, fallbacks=len(records))
    assert len(warnings) == 1 and "numpy path" in warnings[0][0]


def test_failed_load_falls_back(records, monkeypatch, tmp_path):
    """A load the library refuses (a truncated file) returns None with a
    warning, and the dataset counts the case as a fallback."""
    warnings = []
    monkeypatch.setattr(native.logger, "warning", lambda *a: warnings.append(a))
    rec = dict(records[0], img=list(records[0]["img"]))
    rec["img"][0] = str(tmp_path / "truncated.nii.gz")
    with open(records[0]["img"][0], "rb") as f:
        (tmp_path / "truncated.nii.gz").write_bytes(f.read()[:200])
    assert native.load_case_native(rec["img"]) is None
    assert len(warnings) == 1 and "failed" in warnings[0][0]
    native.take_counts()
    with pytest.raises(Exception):
        BraTSDataset([rec], with_seg=False)[0]
    assert native.take_counts() == dict(loads=0, fallbacks=1)


def test_first_build_under_concurrent_loads(records, monkeypatch, tmp_path):
    """Eight threads load at once into an empty build directory: one
    build, every load native, no partial file left."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    native.take_counts()
    ds = BraTSDataset(records, **MODES["eval"])
    out, errors = [None] * 8, []

    def load(i):
        try:
            out[i] = ds[i % 2]
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=load, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert native.take_counts() == dict(loads=8, fallbacks=0)
    assert [p.suffix for p in sorted(tmp_path.iterdir())] == [".log", ".so"]
    for i in range(2, 8):
        np.testing.assert_array_equal(out[i]["img"], out[i % 2]["img"])


@pytest.mark.parametrize("remove_outliers", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_normalize_intensity_device_matches_jax(remove_outliers, dtype):
    """Channels-last volumes with background zeros and one empty channel,
    within 1e-5 of the JAX function; zeros stay zero."""
    rng = np.random.default_rng(7)
    img = rng.normal(300, 80, (12, 10, 9, 4))
    img[rng.random(img.shape) < 0.3] = 0
    img[..., 3] = 0
    img[0, 0, 0, 0] = 5000
    img = img.astype(dtype)
    got = normalize_intensity_device(torch.from_numpy(img), remove_outliers).numpy()
    want = np.asarray(jax_normalize(jnp.asarray(img), remove_outliers))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (got[img == 0] == 0).all()
