"""The port's validation and evaluation with a target, on the CPU against
the JAX package: ``Engine.evaluate`` on one case (plain, TTA, sliding
window, STAPLE over two members, and the dice_boundary criterion's map),
the boundary eval dataset's distance map, the inference CLI ``--on val``
against the JAX package's CLI, and the train CLI's validation epochs,
end-of-training evaluation, ``--debug_val``, ``--val_data_path`` and
``--only_evaluate``."""

import csv
import dataclasses
import glob
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brats21_tpu.cli.main_inference import main as jax_infer_main
from brats21_tpu.config import TrainConfig as JaxTrainConfig
from brats21_tpu.data.nifti import read_nifti
from brats21_tpu.learning.engine import Engine as JaxEngine
from brats21_tpu.learning.losses import make_criterion as jax_make_criterion
from brats21_tpu.models import get_model as jax_get_model
from brats21_tpu.parallel.mesh import make_mesh
from brats21_tpu.utils.import_torch import state_dict_to_flax
from brats21_tpu.utils.reporting import EvaluationReport as JaxReport
from brats21_tpu_torch.cli.main_inference import main as port_infer_main
from brats21_tpu_torch.cli.main_train import main as port_train_main
from brats21_tpu_torch.config import TrainConfig
from brats21_tpu_torch.data import transforms as T
from brats21_tpu_torch.data.pipeline import BraTSDataset, make_train_val_loaders
from brats21_tpu_torch.data.synthetic import generate_synthetic_dataset, make_case
from brats21_tpu_torch.learning.engine import Engine
from brats21_tpu_torch.learning.losses import make_criterion
from brats21_tpu_torch.models import get_model
from brats21_tpu_torch.ops.sliding_window import window_plan
from brats21_tpu_torch.utils.reporting import EvaluationReport
from brats21_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_port_kernels import one_torch_thread  # noqa: F401  (autouse)

CFG = {"model": "equiunet_assp_evo", "width": 4}
METRICS = ["hausdorff_distance95", "sensitivity", "specificity"]
ROI = (16, 16, 16)


def _members():
    """Two w4 members with the same architecture and different seeded
    weights (output conv ×20, so few voxels sit near the threshold), as
    the port's models and the JAX package's params."""
    template = jax.eval_shape(
        jax_get_model(CFG).init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 16, 16, 16, 4), jnp.float32))["params"]
    ports, params = [], []
    for seed in (3, 4):
        torch.manual_seed(seed)
        model = get_model(CFG).eval()
        with torch.no_grad():
            model.out_conv.weight.mul_(20.0)
        p = state_dict_to_flax({k: v.numpy() for k, v in model.state_dict().items()},
                               "equiunet_assp_evo", template)
        model.load_state_dict(state_dict_from_flax(p), strict=True)
        ports.append(model)
        params.append({"params": p})
    return ports, params


def _case():
    """One cropped, normalised case of 29×15×8 (padded 32×16×8: three 16³
    windows, a short last batch of two, and Z below the roi) with a
    blobby three-channel target inside the brain."""
    img, _ = make_case((36, 18, 9), seed=3)
    rng = np.random.default_rng(5)
    field = rng.standard_normal(img.shape[:3])
    for ax in range(3):
        field = (field + np.roll(field, 1, ax) + np.roll(field, -1, ax)) / 3
    brain = img.any(-1)
    seg = np.stack([field > t for t in (0.0, 0.2, 0.4)], -1) & brain[..., None]
    f_img, (f_seg,), start, end = T.crop_foreground(img, seg.astype(np.float32))
    f_img = T.normalize_intensity(f_img, nonzero=True, channel_wise=True)
    return {"img": f_img[None], "seg": f_seg[None], "patient_id": ["case0"],
            "foreground_start_coord": start[None], "foreground_end_coord": end[None],
            "original_shape": np.asarray(img.shape[:3])[None], "affine": np.eye(4)[None]}


class _Loader:
    def __init__(self, batch):
        self.batch = batch

    def __len__(self):
        return 1

    def __iter__(self):
        return iter([self.batch])


@pytest.fixture(scope="module")
def pair():
    ports, params = _members()
    model = jax_get_model(CFG)
    batch = _case()
    padded = T.shape_to_divisible(batch["img"][0], k=8)[0].shape[:3]
    _, pads, starts = window_plan(padded, ROI)
    assert len(starts) % 2 == 1 and any(map(sum, pads))
    engines = {}
    for criterion in ("dice_hd", "dice_boundary"):
        kw = dict(model="equiunet_assp_evo", width=4, criterion=criterion, no_amp=True,
                  additional_metrics=METRICS, sliding_window_size=list(ROI))
        jcfg = JaxTrainConfig(**kw, wire="dense")
        engines[criterion] = (
            JaxEngine(jcfg, model, jax_make_criterion(jcfg),
                      mesh=make_mesh(jax.devices()[:1], data=1, space=1)),
            Engine(TrainConfig(**kw), torch.device("cpu"),
                   criterion=make_criterion(TrainConfig(**kw))))
    return dict(ports=ports, params=params, batch=batch, engines=engines)


MODES = {"plain": {}, "tta": {"use_tta": True}, "sliding": {"sliding": True},
         "staple": {"perform_staple": True, "members": 2},
         "dice_boundary": {"criterion": "dice_boundary"}}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_evaluate_with_a_target_matches_jax(pair, mode, tmp_path):
    """One case through both engines' ``evaluate``: the loss within 1e-4
    relative, the per-case metrics within 1e-5, the report rows by
    patient, the label maps on ≥ 99.9 % of voxels."""
    opts = dict(MODES[mode])
    n = opts.pop("members", 1)
    criterion = opts.pop("criterion", "dice_hd")
    sliding = opts.pop("sliding", False)
    batch = dict(pair["batch"])
    if criterion == "dice_boundary":
        batch["distance_map"] = T.compute_distance_map_fn(batch["seg"][0], "cpu")[None]
    jengine, pengine = pair["engines"][criterion]
    jengine.cfg.sliding_window_inference = pengine.cfg.sliding_window_inference = sliding
    reports, meters = {}, {}
    for side, engine, members in (("jax", jengine, pair["params"][:n]),
                                  ("port", pengine, pair["ports"][:n])):
        reports[side] = (JaxReport if side == "jax" else EvaluationReport)()
        meters[side] = engine.evaluate(members, _Loader(batch), 0, save_seg=True,
                                       output_path=str(tmp_path / side),
                                       report=reports[side], **opts)
    want, got = meters["jax"], meters["port"]
    np.testing.assert_allclose(got["loss"].avg, want["loss"].avg, rtol=1e-4, atol=0)
    assert list(got) == list(want)
    for k in ["dice"] + METRICS:
        np.testing.assert_allclose(got[k].avg, want[k].avg, atol=1e-5, rtol=0, err_msg=k)
    assert reports["port"].rows.keys() == reports["jax"].rows.keys() == {"case0"}
    row_p, row_j = reports["port"].rows["case0"], reports["jax"].rows["case0"]
    assert list(row_p) == list(row_j)
    np.testing.assert_allclose([row_p[c] for c in row_j], list(row_j.values()),
                               atol=1e-5, rtol=0)
    got_seg = read_nifti(str(tmp_path / "port" / "case0.nii.gz")).data
    want_seg = read_nifti(str(tmp_path / "jax" / "case0.nii.gz")).data
    assert got_seg.shape == want_seg.shape == (36, 18, 9)
    assert (got_seg == want_seg).mean() >= 0.999
    assert len(np.unique(want_seg)) > 1


@pytest.mark.parametrize("bucket,use_tta", [(8, False), (16, False), (32, True)])
def test_eval_bucket_pads_as_jax(pair, bucket, use_tta):
    """``--eval_bucket``: the case, its target and its map padded as the
    JAX package pads them; the parser passes it through, and a bucket that
    is no multiple of 8 raises in the config and in an engine built on
    such a config."""
    from brats21_tpu_torch.cli.arguments import build_train_parser
    jengine, pengine = pair["engines"]["dice_hd"]
    img, seg = pair["batch"]["img"][0], pair["batch"]["seg"][0]
    want = jengine._pad_case(img, use_tta, bucket)
    got = pengine._pad_case(img, use_tta, bucket)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(pengine._pad_with(seg, *got[1:]),
                                  jengine._pad_with(seg, *want[1:]))
    with pytest.raises(ValueError, match="multiple of 8"):
        TrainConfig(eval_bucket=12).validate()
    assert build_train_parser().parse_args(
        ["--train_data_path", ".", "--eval_bucket", "16"]).eval_bucket == 16
    bad = Engine(dataclasses.replace(pengine.cfg, eval_bucket=4), torch.device("cpu"),
                 criterion=pengine.criterion)
    with pytest.raises(ValueError, match="multiple of 8"):
        bad.evaluate(pair["ports"][:1], _Loader(pair["batch"]))


def test_boundary_eval_dataset_maps_match_jax_and_need_a_device(tmp_path, monkeypatch):
    """The eval sample of a boundary criterion, distance map included,
    against the JAX package's: both on their native decoders, then both on
    their numpy paths; without a device the dataset and the loaders raise."""
    from brats21_tpu.data import native
    from brats21_tpu.data.pipeline import BraTSDataset as JaxDataset
    from brats21_tpu_torch.data import native as port_native
    from brats21_tpu_torch.data.discovery import create_database, make_file_records
    generate_synthetic_dataset(str(tmp_path), num_cases=1, shape=(30, 28, 24), seed=9)
    records = make_file_records(create_database(str(tmp_path)), with_seg=True)
    for decoder in ("native", "numpy"):
        if decoder == "numpy":
            monkeypatch.setattr(native, "available", lambda: False)
            monkeypatch.setattr(port_native, "load_case_native", lambda *a, **kw: None)
        want = JaxDataset(records, with_seg=True, compute_distance_map=True)[0]
        got = BraTSDataset(records, with_seg=True, compute_distance_map=True, device="cpu")[0]
        assert sorted(got) == sorted(want)
        for k in ("img", "seg", "foreground_start_coord", "foreground_end_coord",
                  "original_shape"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{decoder} {k}")
        np.testing.assert_allclose(got["distance_map"], want["distance_map"], atol=1e-5)
    with pytest.raises(ValueError, match="needs a device"):
        BraTSDataset(records, with_seg=True, compute_distance_map=True)
    cfg = TrainConfig(train_data_path=str(tmp_path), fold=None, criterion="dice_boundary")
    with pytest.raises(ValueError, match="needs a device"):
        make_train_val_loaders(cfg, None, train_in_val_mode=True)


# ---------------------------------------------------------------- the CLIs

@pytest.fixture(scope="module")
def val_data(tmp_path_factory):
    """Five synthetic cases (fold 0: four to train, one to validate) and a
    served run: a w4 fp32 dice_hd config on them and a seeded .pth."""
    root = tmp_path_factory.mktemp("port_validate")
    generate_synthetic_dataset(str(root / "data"), num_cases=5, shape=(26, 24, 20), seed=9)
    TrainConfig(model="equiunet_assp_evo", width=4, no_amp=True, criterion="dice_hd",
                fold=0, train_data_path=str(root / "data"),
                additional_metrics=METRICS).to_yaml(str(root / "config.yaml"))
    torch.manual_seed(6)
    model = get_model(CFG)
    with torch.no_grad():
        model.out_conv.weight.mul_(20.0)
    torch.save({"model": model.state_dict()}, str(root / "best_model.pth"))
    return root


def _infer_argv(root, out, *extra):
    return ["--config", str(root / "config.yaml"), "--import_pth",
            str(root / "best_model.pth"), "--on", "val", "--output", str(out),
            "--num_workers", "1", *extra]


def _report(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_inference_cli_on_val_matches_jax_cli(val_data, tmp_path):
    """Same config, weights and fold-0 val case through both CLIs: the
    same files, the same report columns and rows (1e-5), the same
    segmentation names, and label maps on ≥ 99.9 % of voxels."""
    meters = port_infer_main(_infer_argv(val_data, tmp_path / "port", "--device", "cpu"))
    jax_infer_main(_infer_argv(val_data, tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    xlsx, = [n for n in names if n.endswith(".xlsx")]
    assert xlsx.startswith("Evaluation_inference_val")
    got = _report(tmp_path / "port" / xlsx.replace(".xlsx", ".csv"))
    want = _report(tmp_path / "jax" / xlsx.replace(".xlsx", ".csv"))
    assert got[0] == want[0] and [r[0] for r in got] == [r[0] for r in want]
    assert len(got) == 2 and meters["loss"].count == 1
    np.testing.assert_allclose(np.asarray(got[1][1:], float), np.asarray(want[1][1:], float),
                               atol=1e-5, rtol=0)
    segs = sorted(os.listdir(tmp_path / "jax" / "Inference_segmentations_val"))
    assert sorted(os.listdir(tmp_path / "port" / "Inference_segmentations_val")) == segs
    g = read_nifti(str(tmp_path / "port" / "Inference_segmentations_val" / segs[0])).data
    w = read_nifti(str(tmp_path / "jax" / "Inference_segmentations_val" / segs[0])).data
    assert g.shape == w.shape == (26, 24, 20) and (g == w).mean() >= 0.999


@pytest.mark.parametrize("extra,n_rows", [
    (["--tta"], 1),
    (["--sliding_window_inference", "--sliding_window_size", "16", "16", "16"], 1),
    (["--sliding_window_inference", "--sliding_window_size", "16", "16", "16", "--tta"], 1),
    (["--perform_staple"], 1),
    (["--on", "train"], 4)])
def test_inference_cli_modes_score_every_case(val_data, tmp_path, extra, n_rows):
    """--tta, the sliding window (alone and × TTA), STAPLE over a
    two-member ensemble and --on train each write one report row a case
    and one label map a case."""
    argv = _infer_argv(val_data, tmp_path, "--device", "cpu", *extra)
    if "--perform_staple" in extra:
        argv[1:2] = [str(val_data / "config.yaml")] * 2
        argv[4:5] = [str(val_data / "best_model.pth")] * 2
        argv += ["--train_data_path", str(val_data / "data")]
    port_infer_main(argv)
    on = "train" if "train" in extra else "val"
    report, = glob.glob(str(tmp_path / f"Evaluation_inference_{on}*.csv"))
    rows = _report(report)
    assert len(rows) == n_rows + 1 and rows[0][0] == "patient_id"
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r[1:])
    segs = os.listdir(tmp_path / f"Inference_segmentations_{on}")
    assert len(segs) == n_rows


def _train_argv(root, runs, *extra):
    return ["--train_data_path", str(root / "data"), "--save_path", str(runs),
            "--model", "equiunet_assp_evo", "--width", "4", "--criterion", "dice_hd",
            "--optimizer", "ranger", "--learning_rate", "3e-4", "--fold", "0",
            "--epochs", "1", "--val_frequency", "1", "--patch_size", "16", "16", "16",
            "--num_workers", "1", "--no_full_name", "--no_tensorboard",
            "--device", "cpu", *extra]


def test_train_cli_validates_then_evaluates_end_training(val_data, tmp_path):
    """--fold 0 --val_frequency 1 --evaluate_end_training: the validation
    loss decides best_model.pth, and the run writes the files the JAX
    package's CLI writes: Evaluation{,_tta}.xlsx/.csv with one row and the
    JAX report's columns, and segmentations{,_tta}/<id>.nii.gz at the
    case's shape."""
    result = port_train_main(_train_argv(val_data, tmp_path, "--evaluate_end_training"))
    # the JAX package's run directory holds the same, with its Orbax
    # best_model/ and last_model/ where the port writes reference .pth files
    assert sorted(os.listdir(tmp_path)) == [
        "Evaluation.csv", "Evaluation.xlsx", "Evaluation_tta.csv", "Evaluation_tta.xlsx",
        "best_model.pth", "config.yaml", "last_model.pth", "logfile.log",
        "segmentations", "segmentations_tta"]
    assert np.isfinite(result["val_loss"]) and result["best_value"] == result["val_loss"]
    assert torch.load(tmp_path / "best_model.pth", weights_only=True)["best_value"] == \
        result["val_loss"]
    jreport = JaxReport()
    jreport.add("x", {"Dice": np.zeros((1, 3)), "Hausdorff_Distance95": np.zeros((1, 3))})
    for suffix in ("", "_tta"):
        rows = _report(tmp_path / f"Evaluation{suffix}.csv")
        assert rows[0] == ["patient_id"] + jreport._columns() and len(rows) == 2
        assert (tmp_path / f"Evaluation{suffix}.xlsx").exists()
        dice = [float(v) for c, v in zip(rows[0], rows[1]) if c.startswith("Dice_")]
        hd = [float(v) for c, v in zip(rows[0], rows[1]) if c.startswith("Hausdorff")]
        assert all(0 <= d <= 1 for d in dice) and all(h >= 0 for h in hd)
        segs = os.listdir(tmp_path / f"segmentations{suffix}")
        assert segs == [f"{rows[1][0]}.nii.gz"]
        seg = read_nifti(str(tmp_path / f"segmentations{suffix}" / segs[0])).data
        assert seg.shape == (26, 24, 20) and set(np.unique(seg)) <= {0, 1, 2, 4}
    assert 0 <= result["eval_dice"] <= 1 and 0 <= result["eval_tta_dice"] <= 1


def _count_evaluations(monkeypatch):
    calls = []
    real = Engine.evaluate

    def counted(self, members, loader, epoch=0, **kw):
        calls.append((epoch, kw.get("step_mode", "val"), len(loader)))
        return real(self, members, loader, epoch, **kw)

    monkeypatch.setattr(Engine, "evaluate", counted)
    return calls


def test_train_cli_validates_every_val_frequency_epochs(val_data, tmp_path, monkeypatch):
    calls = _count_evaluations(monkeypatch)
    argv = _train_argv(val_data, tmp_path, "--epochs", "3", "--val_frequency", "2")
    result = port_train_main(argv)
    assert calls == [(2, "val", 1)]
    assert torch.load(tmp_path / "last_model.pth", weights_only=True)["epoch"] == 2
    assert np.isfinite(result["train_loss"]) and np.isfinite(result["val_loss"])


def test_train_cli_debug_val_validates_without_a_step(val_data, tmp_path, monkeypatch):
    calls = _count_evaluations(monkeypatch)

    def no_step(*_a, **_k):
        raise AssertionError("a step ran")

    monkeypatch.setattr(Engine, "train_epoch", no_step)
    result = port_train_main(_train_argv(val_data, tmp_path, "--debug_val"))
    assert calls == [(1, "val", 1)] and "train_loss" not in result
    assert (tmp_path / "best_model.pth").exists()


def test_train_cli_val_data_path_evaluates_its_cases(val_data, tmp_path):
    """--val_data_path (with --fold None, the JAX package's rule) feeds the
    end-of-training evaluation; with a fold it raises."""
    argv = _train_argv(val_data, tmp_path, "--val_data_path", str(val_data / "data"),
                       "--evaluate_end_training")
    with pytest.raises(ValueError, match="val_data_path"):
        port_train_main(argv)
    argv[argv.index("--fold") + 1] = "None"
    port_train_main(argv)
    assert len(_report(tmp_path / "Evaluation.csv")) == 6      # five cases


def test_train_cli_only_evaluate_reloads_the_run(val_data, tmp_path, monkeypatch):
    port_train_main(_train_argv(val_data, tmp_path))
    calls = _count_evaluations(monkeypatch)

    def no_step(*_a, **_k):
        raise AssertionError("a step ran")

    monkeypatch.setattr(Engine, "train_epoch", no_step)
    port_train_main(["--train_data_path", str(val_data / "data"), "--resume",
                     str(tmp_path / "last_model.pth"), "--only_evaluate", "--device", "cpu"])
    assert [c[1] for c in calls] == ["metric_val", "metric_val"]
    assert len(_report(tmp_path / "Evaluation_tta.csv")) == 2


def test_train_cli_tensorboard_needs_tensorboardx_at_start(val_data, tmp_path, monkeypatch):
    def no_step(*_a, **_k):
        raise AssertionError("a step ran")

    monkeypatch.setattr(Engine, "train_epoch", no_step)
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    argv = _train_argv(val_data, tmp_path)
    argv.remove("--no_tensorboard")
    with pytest.raises(ImportError, match="--no_tensorboard"):
        port_train_main(argv)
