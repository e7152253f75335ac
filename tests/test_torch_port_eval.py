"""The port's eval modules on the CPU against the JAX package, on the same
numpy inputs: the metrics with every BraTS edge rule, the Evaluation
report's files, the sliding-window plan and stitch (an identity predictor
and a w4 EquiUnetASSPEvo), STAPLE, TTA with a dice_hd loss, and
TensorBoard's start-up error."""

import csv
import sys
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brats21_tpu.learning.losses import make_criterion as jax_make_criterion
from brats21_tpu.models import get_model as jax_get_model
from brats21_tpu.ops import sliding_window as jsw
from brats21_tpu.ops import staple as jstaple
from brats21_tpu.ops.tta import tta_mean_probs as jax_tta_mean_probs
from brats21_tpu.utils import metrics as jmetrics
from brats21_tpu.utils.import_torch import state_dict_to_flax
from brats21_tpu.utils.reporting import EvaluationReport as JaxReport
from brats21_tpu_torch.learning.engine import forward_channels_last
from brats21_tpu_torch.learning.losses import make_criterion
from brats21_tpu_torch.models import get_model
from brats21_tpu_torch.ops import sliding_window as psw
from brats21_tpu_torch.ops import staple as pstaple
from brats21_tpu_torch.ops.tta import tta_mean_probs
from brats21_tpu_torch.utils import metrics as pmetrics
from brats21_tpu_torch.utils.reporting import EvaluationReport, TensorBoardLogger
from brats21_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_port_kernels import one_torch_thread  # noqa: F401  (autouse)


def _masks(seed, shape=(1, 9, 8, 7, 3), p=0.4):
    """Prediction and target masks: channel 0 random, channel 1 both empty,
    channel 2 empty prediction against a non-empty target."""
    rng = np.random.default_rng(seed)
    pred = (rng.random(shape) < p).astype(np.float32)
    gt = (rng.random(shape) < p).astype(np.float32)
    pred[..., 1] = gt[..., 1] = 0.0
    pred[..., 2] = 0.0
    return pred, gt


# ------------------------------------------------------------------ metrics

@pytest.mark.parametrize("seed", [0, 1])
def test_dice_and_sensitivity_specificity_match_jax(seed):
    pred, gt = _masks(seed, shape=(2, 9, 8, 7, 3))
    gt[1, ..., 0] = 0.0                   # a mismatch the other way round
    np.testing.assert_allclose(
        pmetrics.dice_metric(torch.from_numpy(pred), torch.from_numpy(gt)).numpy(),
        np.asarray(jmetrics.dice_metric(pred, gt)), atol=1e-6, rtol=0)
    got = pmetrics.sensitivity_specificity(torch.from_numpy(pred), torch.from_numpy(gt))
    want = jmetrics.sensitivity_specificity(pred, gt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_case_metrics_match_jax(as_tensor):
    """Dice, HD95 (both empty → 0, mismatch → the BraTS diagonal),
    sensitivity, specificity and ROC-AUC over probabilities with ties."""
    pred, gt = _masks(2, shape=(1, 14, 12, 10, 3))
    probs = np.round(np.random.default_rng(3).random(pred.shape), 1).astype(np.float32)
    names = ("dice", "hausdorff_distance95", "sensitivity", "specificity", "roc_auc")
    want = jmetrics.compute_case_metrics(pred, gt, names, y_probs=probs)
    args = (torch.from_numpy(pred), torch.from_numpy(gt)) if as_tensor else (pred, gt)
    got = pmetrics.compute_case_metrics(*args, names, y_probs=probs)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)
    assert got["Hausdorff_Distance95"][0, 1] == 0.0
    assert got["Hausdorff_Distance95"][0, 2] == np.float32(pmetrics.BRATS_DIAGONAL)
    assert 0 < got["Roc_Auc"][0, 0] < 1
    labels = np.array([1, 0, 1, 0, 1])
    tied = np.array([0.5, 0.5, 0.7, 0.2, 0.5])
    assert pmetrics.roc_auc(tied, labels) == jmetrics.roc_auc(tied, labels)


def test_hd95_and_surface_distance_match_jax():
    rng = np.random.default_rng(4)
    a = rng.random((12, 11, 10)) < 0.3
    b = np.roll(a, 2, axis=0) | (rng.random(a.shape) < 0.05)
    assert pmetrics.hausdorff_distance_95(a, b) == jmetrics.hausdorff_distance_95(a, b)
    for sym in (False, True):
        assert pmetrics.average_surface_distance(a, b, sym) == \
            jmetrics.average_surface_distance(a, b, sym)


# ------------------------------------------------------------------- report

def test_evaluation_report_files_match_jax(tmp_path):
    """The same rows, CSV files and describe() stats (1e-12), and the xlsx
    a valid zip with both sheets; the autosaved CSV keeps a row a case."""
    rng = np.random.default_rng(5)
    rows = [(f"BraTS2021_{i:05d}", {"Dice": rng.random((1, 3)),
                                     "Hausdorff_Distance95": 10 * rng.random((1, 3))})
            for i in range(3)]
    rows[1][1]["Dice"][0, 2] = np.nan
    got = EvaluationReport(autosave_dir=str(tmp_path / "port"), name="Evaluation")
    want = JaxReport(autosave_dir=str(tmp_path / "jax"), name="Evaluation")
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    for pid, m in rows:
        got.add(pid, m)
        want.add(pid, m)
    for kind in ("port", "jax"):
        assert len(list(csv.reader(open(tmp_path / kind / "Evaluation.csv")))) == 4
    assert got.rows.keys() == want.rows.keys()
    for pid in want.rows:
        np.testing.assert_equal(got.rows[pid], want.rows[pid])
    gs, ws = got.describe(), want.describe()
    assert list(gs) == list(ws)
    for col in ws:
        for stat in ws[col]:
            np.testing.assert_allclose(gs[col][stat], ws[col][stat], atol=1e-12, rtol=0)
    path = got.save(str(tmp_path / "port"))
    want.save(str(tmp_path / "jax"))
    assert (tmp_path / "port" / "Evaluation.csv").read_text() == \
        (tmp_path / "jax" / "Evaluation.csv").read_text()
    with zipfile.ZipFile(path) as z:
        assert z.testzip() is None
        assert {"xl/worksheets/sheet1.xml", "xl/worksheets/sheet2.xml"} <= set(z.namelist())


def test_tensorboard_without_tensorboardx_names_the_flag(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    with pytest.raises(ImportError, match="--no_tensorboard"):
        TensorBoardLogger(str(tmp_path))
    TensorBoardLogger(str(tmp_path), enabled=False).log_scalar("x", 1.0, 0)


# ----------------------------------------------------------- sliding window

@pytest.mark.parametrize("image,roi", [((40, 44, 26), (16, 16, 32)),
                                       ((32, 16, 8), (16, 16, 16)),
                                       ((128, 128, 128), (128, 128, 128)),
                                       ((200, 200, 136), (128, 128, 128))])
def test_window_plan_matches_jax(image, roi):
    interval = psw.get_scan_interval(image, roi)
    assert interval == jsw.get_scan_interval(image, roi)
    np.testing.assert_array_equal(psw.dense_patch_starts(image, roi, interval),
                                  jsw.dense_patch_starts(image, roi, interval))
    np.testing.assert_array_equal(psw.gaussian_importance_map(roi),
                                  jsw.gaussian_importance_map(roi))


def test_window_plan_of_the_served_case():
    """The padded 240×240×155 case (200×200×136) takes 8 windows of 128³,
    4 batches of 2."""
    roi, pads, starts = psw.window_plan((200, 200, 136), (128, 128, 128))
    assert roi == [128] * 3 and pads == [(0, 0)] * 3 and len(starts) == 8


@pytest.mark.parametrize("shape,roi,sw,mode", [
    ((1, 32, 16, 8, 3), (16, 16, 16), 2, "constant"),   # 3 windows: a short last batch
    ((2, 40, 20, 12, 2), (16, 16, 8), 3, "constant"),   # 3×1×2 windows, batches of 3
    ((1, 30, 14, 9, 3), (16, 16, 16), 2, "gaussian")])  # two dims below the roi
def test_sliding_window_identity_matches_jax(shape, roi, sw, mode):
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    want = jsw.sliding_window_inference(jnp.asarray(x), roi, lambda w: w,
                                        sw_batch_size=sw, mode=mode)
    got = psw.sliding_window_inference(torch.from_numpy(x), roi, lambda w: w,
                                       sw_batch_size=sw, mode=mode)
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def w4_pair():
    """(flax model, params) and the port's model at width 4 with the same
    weights, carried by the JAX package's importer; the output conv ×20 so
    the heads are far from zero."""
    cfg = {"model": "equiunet_assp_evo", "width": 4}
    model = jax_get_model(cfg)
    template = jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 16, 16, 16, 4), jnp.float32))["params"]
    torch.manual_seed(1)
    port = get_model(cfg).eval()
    with torch.no_grad():
        port.out_conv.weight.mul_(20.0)
    params = state_dict_to_flax({k: v.numpy() for k, v in port.state_dict().items()},
                                "equiunet_assp_evo", template)
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    return model, params, port


def test_sliding_window_model_matches_jax(w4_pair):
    """A w4 EquiUnetASSPEvo over 16³ windows of a 32×16×8 volume: three
    windows (a short last batch of the two-window batches) and a dimension
    below the roi; within atol = rtol = 1e-3."""
    model, params, port = w4_pair
    x = np.random.default_rng(7).standard_normal((1, 32, 16, 8, 4)).astype(np.float32)
    want = jsw.sliding_window_inference(
        jnp.asarray(x), (16, 16, 16),
        lambda w: model.apply({"params": params}, w, deterministic=True), sw_batch_size=2)
    with torch.inference_mode():
        got = psw.sliding_window_inference(
            torch.from_numpy(x), (16, 16, 16),
            lambda w: forward_channels_last(port, w), sw_batch_size=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=1e-3)


# ------------------------------------------------------------------ STAPLE

def _raters(seed, n=3, shape=(10, 9, 8)):
    rng = np.random.default_rng(seed)
    truth = rng.random(shape) < 0.35
    return np.stack([truth ^ (rng.random(shape) < 0.08 * (r + 1))
                     for r in range(n)]).astype(np.float32)


@pytest.mark.parametrize("seed,n", [(8, 3), (9, 2), (10, 5)])
def test_staple_binary_matches_jax(seed, n):
    d = _raters(seed, n)
    want = np.asarray(jstaple.staple_binary(jnp.asarray(d)))
    got = pstaple.staple_binary(torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert pstaple.last_iterations > 1          # raters that disagree iterate


def test_staple_binary_stops_at_once_on_agreeing_raters():
    """Identical raters leave p and q where they start: the EM stops after
    its first iteration with the raters' own map."""
    d = np.repeat(_raters(12, 1), 2, axis=0)
    got = pstaple.staple_binary(torch.from_numpy(d)).numpy()
    assert pstaple.last_iterations == 1
    np.testing.assert_array_equal(got > 0.5, d[0] > 0.5)


def test_staple_multichannel_matches_jax():
    m = np.stack([_raters(11 + c, 3) for c in range(3)], axis=-1)[:, None]  # [3,1,X,Y,Z,3]
    want = np.asarray(jstaple.staple_multichannel(jnp.asarray(m), 0.5))
    got = pstaple.staple_multichannel(torch.from_numpy(m), 0.5).numpy()
    assert got.shape == want.shape == (1, 10, 9, 8, 3)
    posterior = np.stack([np.asarray(jstaple.staple_binary(jnp.asarray(m[:, 0, ..., c])))
                          for c in range(3)], axis=-1)[None]
    away = np.abs(posterior - 0.5) > 1e-4           # thresholded maps, away from 0.5
    np.testing.assert_array_equal(got[away], want[away])
    with pytest.raises(ValueError, match="BS1"):
        pstaple.staple_multichannel(torch.zeros((2, 2, 3, 3, 3, 3)))


# --------------------------------------------------------------------- TTA

def test_tta_mean_probs_with_dice_hd_loss_matches_jax(w4_pair):
    """Probabilities within 1e-3 and the 16 combos' mean deep-supervision
    dice_hd loss within 1e-4 relative, on a square 16×16×8 volume."""
    model, params, port = w4_pair
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1, 16, 16, 8, 4)).astype(np.float32)
    seg = (rng.random((1, 16, 16, 8, 3)) < 0.3).astype(np.float32)
    want_p, want_l = jax_tta_mean_probs(
        lambda v: model.apply({"params": params}, v, deterministic=True), jnp.asarray(x),
        criterion=jax_make_criterion({"criterion": "dice_hd"}), target=jnp.asarray(seg))
    with torch.inference_mode():
        got_p, got_l = tta_mean_probs(
            lambda v: forward_channels_last(port, v, with_deep=True), torch.from_numpy(x),
            criterion=make_criterion({"criterion": "dice_hd"}),
            target=torch.from_numpy(seg).permute(0, 4, 1, 2, 3))
        plain_p, zero = tta_mean_probs(lambda v: forward_channels_last(port, v),
                                       torch.from_numpy(x))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-3, rtol=0)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-4, atol=0)
    torch.testing.assert_close(plain_p, got_p, rtol=0, atol=1e-6)
    assert float(zero) == 0.0
