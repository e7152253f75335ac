"""The port's host data layer, post-processing and CLI surface against the
JAX package: byte-equal data stages on the conftest synthetic cases, exact
post-processing (and against the scipy host twins), and the reference
inference flag surface."""

import os

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from brats21_tpu.data import nifti as jax_nifti
from brats21_tpu.data import pipeline as jax_pipeline
from brats21_tpu.data import transforms as jax_T
from brats21_tpu.ops import postprocess as jax_P
from brats21_tpu_torch.cli.arguments import build_inference_parser, get_inference_args
from brats21_tpu_torch.data import nifti, pipeline
from brats21_tpu_torch.data import transforms as T
from brats21_tpu_torch.data.discovery import create_database, make_file_records
from brats21_tpu_torch.ops import postprocess as P
from test_torch_port_kernels import one_torch_thread  # noqa: F401  (autouse)

from test_cli_surface import REFERENCE_INFERENCE_FLAGS


def _records(root):
    return make_file_records(create_database(root), with_seg=True)


def _assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("case", [0, 3])
def test_load_and_preprocess_byte_equal(synthetic_case, case):
    rec = _records(synthetic_case)[case]
    img, seg, affine = pipeline.load_case(rec)
    j_img, j_seg, j_affine = jax_pipeline.load_case(rec)
    for a, b in ((img, j_img), (seg, j_seg), (affine, j_affine)):
        _assert_same(a, b)
    for remove_outliers in (False, True):
        got = T.preprocess_case(img, seg, remove_outliers=remove_outliers)
        want = jax_T.preprocess_case(img, seg, remove_outliers=remove_outliers)
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])


def test_pad_unpad_and_codecs_byte_equal(synthetic_case):
    rec = _records(synthetic_case)[1]
    img, seg, _ = pipeline.load_case(rec)
    sample = T.preprocess_case(img, seg)
    for k in (8, 16):
        got = T.shape_to_divisible(sample["img"], k=k)
        want = jax_T.shape_to_divisible(sample["img"], k=k)
        for a, b in zip(got, want):
            _assert_same(a, b)
        _assert_same(T.shape_to_original(got[0], got[1], got[2]),
                     jax_T.shape_to_original(want[0], want[1], want[2]))
    mc = sample["seg"]
    _assert_same(T.brats_labels_to_multichannel(seg), jax_T.brats_labels_to_multichannel(seg))
    labels = T.change_label_3_to_4(T.multichannel_to_brats_labels(mc))
    _assert_same(labels, jax_T.change_label_3_to_4(jax_T.multichannel_to_brats_labels(mc)))
    back = T.pad_back_to_shape_before_compose(
        labels, sample["foreground_start_coord"], sample["foreground_end_coord"],
        sample["original_shape"])
    _assert_same(back, jax_T.pad_back_to_shape_before_compose(
        labels, sample["foreground_start_coord"], sample["foreground_end_coord"],
        sample["original_shape"]))
    _assert_same(T.remove_background_voxels(sample["img"], mc),
                 jax_T.remove_background_voxels(sample["img"], mc))
    _assert_same(T.compute_distance_map_fn(mc, "cpu"), jax_T.compute_distance_map_fn(mc))


def test_nifti_round_trip_byte_equal(tmp_path):
    vol = (np.random.default_rng(4).random((9, 7, 5)) * 5).astype(np.uint8)
    affine = np.diag([1.0, 1.5, 2.0, 1.0])
    nifti.write_nifti(str(tmp_path / "port.nii.gz"), vol, affine)
    jax_nifti.write_nifti(str(tmp_path / "jax.nii.gz"), vol, affine)
    got = nifti.read_nifti(str(tmp_path / "port.nii.gz"))
    want = jax_nifti.read_nifti(str(tmp_path / "jax.nii.gz"))
    _assert_same(got.data, want.data)
    _assert_same(got.affine, want.affine)
    _assert_same(got.data, vol)


def test_eval_loader_yields_preprocessed_cases(synthetic_case):
    recs = make_file_records(create_database(synthetic_case, required_modality=(
        "t1", "t1ce", "flair", "t2")), with_seg=False)
    loader = pipeline.EvalLoader(pipeline.BraTSDataset(recs[:2], with_seg=False))
    batches = list(loader)
    assert len(batches) == 2 and batches[1]["patient_id"] == [recs[1]["patient_id"]]
    # the loader decodes on the native path, as the JAX package's dataset does
    want = jax_pipeline.BraTSDataset(recs[1:2], with_seg=False)[0]
    _assert_same(batches[1]["img"][0], want["img"])
    # and the numpy path is the JAX package's numpy preprocessing
    img, _, _ = jax_pipeline.load_case(recs[1])
    _assert_same(loader.dataset._getitem_numpy(recs[1])["img"],
                 jax_T.preprocess_case(img, None)["img"])


# ------------------------------------------------------------------ post-processing


def _post_kwargs():
    return dict(cleaning_areas=True, cleaning_areas_threshold=2,
                replace_value=True, replace_value_threshold=3)


def _host_chain(binary):
    labels = jax_T.change_label_3_to_4(jax_T.multichannel_to_brats_labels(binary[0]))
    labels = P.filter_components_host(labels, threshold=2)
    labels = P.replace_small_values_axial_host(labels, 3)
    return jax_T.brats_labels_to_multichannel(labels)[None]


def _structured_binary():
    """Blobs whose small pieces sit inside uniform regions, so the nearest
    surviving label is unique and scipy agrees with the argmin envelope."""
    lab = np.zeros((14, 12, 6), np.float32)
    lab[2:12, 2:10, :] = 2
    lab[4:9, 4:8, :] = 1
    lab[6, 5, 2] = 4                 # lone ET voxel → replaced by 1
    lab[10, 9, 4] = 4                # lone voxel inside 2 → replaced by 2
    lab[0, 0, 0] = 1                 # isolated component of size 1 → cleaned
    return jax_T.brats_labels_to_multichannel(lab)[None]


@pytest.mark.parametrize("seed", [None, 0, 1, 2])
def test_post_process_exactly_matches_jax(seed):
    kwargs = _post_kwargs()
    if seed is None:
        binary = _structured_binary()
    else:
        # dense WT, sparse ET: cleaning keeps the big component, and the ET
        # label (~7% of voxels) falls under the replace threshold, so the
        # nearest-label search runs with many equidistant candidates
        rng = np.random.default_rng(seed)
        binary = (rng.random((1, 12, 10, 6, 3))
                  > np.array([0.3, 0.7, 0.93])).astype(np.float32)
        kwargs["replace_value_threshold"] = 60
    want = np.asarray(jax_P.post_process(jnp.asarray(binary), **kwargs))
    got = P.post_process(torch.from_numpy(binary), **kwargs).numpy()
    _assert_same(got, want)
    assert not np.array_equal(got, binary)     # the chain did change it
    if seed is None:
        _assert_same(got, _host_chain(binary))


def test_components_and_replace_match_host():
    rng = np.random.default_rng(5)
    mask = rng.random((11, 9, 10)) > 0.7
    got = P.label_components(torch.from_numpy(mask)).numpy()
    want = P.label_components_host(mask)
    assert ((got != 0) == (want != 0)).all()
    for lbl in np.unique(want)[1:]:
        comp = want == lbl
        assert len(np.unique(got[comp])) == 1
        assert not (got[comp][0] == got[~comp & (got != 0)]).any()
    vol = np.zeros((16, 16, 16), np.float32)
    vol[1:3, 1:3, 1:3] = 4
    vol[8:13, 8:13, 8:13] = 2
    _assert_same(P.filter_components(torch.from_numpy(vol), 20.0).numpy(),
                 P.filter_components_host(vol, threshold=20))


def test_threshold_and_codecs_match_jax():
    rng = np.random.default_rng(6)
    probs = rng.random((1, 5, 4, 3, 3)).astype(np.float32)
    _assert_same(P.threshold_probs(torch.from_numpy(probs), 0.4).numpy(),
                 np.asarray(jax_P.threshold_probs(jnp.asarray(probs), 0.4)))
    binary = (probs > 0.5).astype(np.float32)[0]
    labels = P.change_label_3_to_4(P.multichannel_to_brats(torch.from_numpy(binary)))
    want = jax_P.change_label_3_to_4(jax_P.multichannel_to_brats(jnp.asarray(binary)))
    _assert_same(labels.numpy(), np.asarray(want))
    _assert_same(P.brats_to_multichannel(labels).numpy(),
                 np.asarray(jax_P.brats_to_multichannel(want)))


# ------------------------------------------------------------------ CLI surface


def test_inference_flags_superset_of_reference():
    ours = set()
    for action in build_inference_parser()._actions:
        ours.update(action.option_strings)
    missing = [f for f in REFERENCE_INFERENCE_FLAGS + ["--import_pth"] if f not in ours]
    assert not missing, f"reference inference flags not accepted: {missing}"


def test_reference_model6_inference_recipe_parses(tmp_path):
    """The model-6 ensemble inference argv (reference README.md:160-163),
    with one --import_pth per config."""
    configs, pths = [], []
    for member in ("model3", "model5"):
        for fold in range(5):
            d = tmp_path / member / f"fold{fold}"
            d.mkdir(parents=True)
            (d / "config.yaml").write_text(yaml.safe_dump({"model": "equiunet_assp_evo"}))
            configs.append(str(d / "config.yaml"))
            pths.append(str(d / "best_model.pth"))
    val_data = tmp_path / "ValidationData"
    val_data.mkdir()
    argv = (["--config"] + configs +
            ["--test_data_path", str(val_data), "--on", "test", "-vv",
             "--replace_value", "--cleaning_areas",
             "--save_path", str(tmp_path / "model6_inference"),
             "--device", "0", "--replace_value_threshold", "300",
             "--cleaning_areas_threshold", "20", "--device", "0", "--tta",
             "--import_pth"] + pths)
    config_dict, _ = get_inference_args(argv)
    assert len(config_dict) == 10
    ns = config_dict["config_9"]
    assert ns.test_data_path == str(val_data) and ns.on == "test" and ns.tta
    assert ns.save_path == str(tmp_path / "model6_inference")
    assert ns.replace_value and ns.replace_value_threshold == 300
    assert ns.cleaning_areas and ns.cleaning_areas_threshold == 20
    assert ns.verbosity == 2 and ns.import_pth == pths[9]
    assert ns.model == "equiunet_assp_evo" and ns.model_dir == os.path.dirname(configs[9])
