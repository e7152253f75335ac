"""Serving as the Dockerfile deploys, on the CPU: the inference CLI on run
directories without ``--import_pth`` (plain and SWA runs), ``--resume``'s
global step, the inference parser's forced flags, ``--watch`` serving
(new cases, poison isolation while serving and at start-up, the warm-up,
the stop file) and ``ops/tta_compose.py`` against the JAX package's."""

import glob
import os
import shutil
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from brats21_tpu.ops import tta_compose as jtc
from brats21_tpu_torch.cli import main_inference, main_train
from brats21_tpu_torch.cli.arguments import get_inference_args
from brats21_tpu_torch.data.nifti import read_nifti
from brats21_tpu_torch.data.synthetic import generate_synthetic_dataset
from brats21_tpu_torch.ops import tta_compose as tc
from brats21_tpu_torch.ops.tta import tta_mean_probs
from brats21_tpu_torch.utils.weights import load_reference_pth
from test_torch_port_kernels import one_torch_thread  # noqa: F401  (autouse)

CASE = (24, 28, 20)


@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_serve_data")
    generate_synthetic_dataset(str(root), num_cases=2, shape=CASE, seed=13)
    return root


def _train_argv(data, runs, *extra):
    return ["--train_data_path", str(data), "--save_path", str(runs),
            "--model", "equiunet_assp_evo", "--width", "4", "--criterion", "dice",
            "--optimizer", "adam", "--learning_rate", "1e-2", "--fold", "None",
            "--epochs", "2", "--patch_size", "16", "16", "16", "--num_workers", "1",
            "--no_full_name", "--no_tensorboard", "--device", "cpu", *extra]


def _train(monkeypatch, argv) -> int:
    """The train CLI; returns its engine's global step at the end."""
    engines = []

    class Probe(main_train.Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    with monkeypatch.context() as m:
        m.setattr(main_train, "Engine", Probe)
        main_train.main(argv)
    engine, = engines
    return engine.global_step


@pytest.fixture(scope="module")
def runs(train_data, tmp_path_factory):
    """Two port-trained run directories (w4, over two cases): a plain one
    of two epochs, and an SWA one (``--swa_start 1``, three epochs) whose
    last_model.pth carries the average of two; and the plain run's global
    step."""
    root = tmp_path_factory.mktemp("port_serve_runs")
    with pytest.MonkeyPatch.context() as m:
        step = _train(m, _train_argv(train_data, root / "plain"))
        _train(m, _train_argv(train_data, root / "swa", "--swa_start", "1",
                              "--epochs", "3"))
    return SimpleNamespace(plain=root / "plain", swa=root / "swa", global_step=step)


def _serve(run, data, out, *extra):
    main_inference.main(["--config", str(run / "config.yaml"), "--on", "test",
                         "--input", str(data), "--output", str(out), "--device", "cpu",
                         "--cleaning_areas", "--cleaning_areas_threshold", "2",
                         "--num_workers", "1", *extra])
    segs = sorted(glob.glob(str(out / "Inference_segmentations_test" / "*.nii.gz")))
    return {os.path.basename(p): read_nifti(p).data for p in segs}


@pytest.mark.parametrize("kind", ["plain", "swa"])
def test_run_directory_serves_without_import_pth(runs, train_data, tmp_path, kind):
    """The CLI given only a run's config.yaml serves the checkpoint the
    reference would (best_model.pth; last_model.pth's SWA average on an SWA
    run): its label maps equal those of the same run served with
    ``--import_pth`` of that file."""
    run = getattr(runs, kind)
    pth = run / ("last_model.pth" if kind == "swa" else "best_model.pth")
    payload = torch.load(pth, weights_only=True)
    ns, = get_inference_args(["--config", str(run / "config.yaml"), "--on", "test",
                              "--input", str(train_data), "--output",
                              str(tmp_path / "x")])[0].values()
    served = main_inference.load_member(ns, torch.device("cpu")).state_dict()
    want_sd = load_reference_pth(str(pth), prefer_swa=kind == "swa")
    assert sorted(served) == sorted(want_sd)
    for k, v in want_sd.items():
        torch.testing.assert_close(served[k], v, rtol=0, atol=0)
    if kind == "swa":                     # the average, not the last weights
        assert not torch.equal(want_sd["out_conv.weight"],
                               payload["model"]["out_conv.weight"])
    got = _serve(run, train_data, tmp_path / "dir")
    want = _serve(run, train_data, tmp_path / "pth", "--import_pth", str(pth))
    assert sorted(got) == ["BraTS2021_00000.nii.gz", "BraTS2021_00001.nii.gz"]
    assert sorted(want) == sorted(got)
    for name, labels in want.items():
        assert got[name].shape == CASE
        np.testing.assert_array_equal(got[name], labels)


def test_folder_without_checkpoint_raises(runs, tmp_path):
    shutil.copy(runs.plain / "config.yaml", tmp_path / "config.yaml")
    with pytest.raises(FileNotFoundError, match="No checkpoint found"):
        get_inference_args(["--config", str(tmp_path / "config.yaml"), "--on", "test",
                            "--input", str(tmp_path), "--output", str(tmp_path / "out")])


def test_resume_restores_global_step(runs, train_data, tmp_path, monkeypatch):
    """One epoch, then ``--resume`` to the second: the engine's global
    step ends where the uninterrupted run's does."""
    argv = _train_argv(train_data, tmp_path / "split")
    argv[argv.index("--epochs") + 1] = "1"
    assert _train(monkeypatch, argv) == runs.global_step // 2
    cfg_path = tmp_path / "split" / "config.yaml"
    cfg = yaml.safe_load(cfg_path.read_text())
    cfg["epochs"] = 2
    cfg_path.write_text(yaml.safe_dump(cfg))
    resumed = _train(monkeypatch, ["--train_data_path", str(train_data), "--resume",
                                   str(tmp_path / "split" / "last_model.pth"),
                                   "--device", "cpu"])
    assert resumed == runs.global_step == 4


def test_inference_parser_forces_log_flags(runs, tmp_path):
    """Every member runs without TensorBoard and logs every case, whatever
    its run was trained with."""
    cfg = yaml.safe_load((runs.plain / "config.yaml").read_text())
    cfg.update(no_tensorboard=False, log_val_interval=5)
    for name in ("a", "b"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "config.yaml").write_text(yaml.safe_dump(cfg))
    members, _ = get_inference_args([
        "--config", str(tmp_path / "a" / "config.yaml"), str(tmp_path / "b" / "config.yaml"),
        "--import_pth", "a.pth", "b.pth", "--on", "test", "--input", str(tmp_path),
        "--output", str(tmp_path / "out")])
    assert len(members) == 2
    for ns in members.values():
        assert ns.no_tensorboard is True and ns.log_val_interval == 1


# ------------------------------------------------------------------ --watch

def _watch(run, data, out, stop, *extra):
    argv = ["--config", str(run / "config.yaml"), "--on", "test", "--input", str(data),
            "--output", str(out), "--device", "cpu", "--num_workers", "1", "--watch",
            "--watch_interval", "0.2", "--watch_stop_file", str(stop), *extra]
    thread = threading.Thread(target=main_inference.main, args=(argv,), daemon=True)
    thread.start()
    return thread


def _wait_for(pred, timeout=60):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.1)
    return False


def _segs(out):
    return sorted(os.path.basename(p) for p in
                  glob.glob(str(out / "Inference_segmentations_test" / "*.nii.gz")))


def _logged(out, text):
    log = out / "logfile_inference.log"
    return log.exists() and text in log.read_text()


def _stop(thread, stop):
    stop.touch()
    thread.join(timeout=60)
    assert not thread.is_alive(), "the watch loop did not stop on the stop file"


def _staging(tmp_path, n, seed, corrupt=None):
    staging = tmp_path / "staging"
    generate_synthetic_dataset(str(staging), num_cases=n, shape=(16, 16, 16), seed=seed,
                               with_seg=False)
    cases = sorted(os.listdir(staging))
    if corrupt is not None:
        # all four modality files exist, so discovery accepts the case, but
        # one is not a NIfTI: the decode fails at load
        bad = cases[corrupt]
        (staging / bad / f"{bad}_t1.nii.gz").write_bytes(b"this is not a nifti")
    return staging, cases


def test_watch_serves_new_cases(runs, tmp_path):
    """A case on disk at start-up, then one landing (renamed in) while the
    server runs: both segmented; the stop file ends the loop."""
    staging, cases = _staging(tmp_path, 2, seed=3)
    data, out, stop = tmp_path / "data", tmp_path / "out", tmp_path / "stop"
    data.mkdir()
    shutil.move(staging / cases[0], data / cases[0])
    thread = _watch(runs.plain, data, out, stop)
    assert _wait_for(lambda: len(_segs(out)) == 1), "the start-up case was not segmented"
    shutil.move(staging / cases[1], data / cases[1])
    assert _wait_for(lambda: len(_segs(out)) == 2), "the watched case was not segmented"
    _stop(thread, stop)
    assert _segs(out) == [f"{c}.nii.gz" for c in cases]


@pytest.mark.parametrize("at_startup", [False, True])
def test_watch_isolates_a_poison_case(runs, tmp_path, monkeypatch, at_startup):
    """A corrupt case beside healthy ones, landing in one poll or on disk
    at start-up: the healthy cases are segmented, the server stays up and
    serves a later case, and the corrupt one is quarantined for good after
    ``BRATS21_WATCH_MAX_ATTEMPTS`` attempts."""
    monkeypatch.setenv("BRATS21_WATCH_MAX_ATTEMPTS", "2")
    staging, cases = _staging(tmp_path, 4, seed=5, corrupt=1)
    data, out, stop = tmp_path / "data", tmp_path / "out", tmp_path / "stop"
    data.mkdir()
    first = cases[:3]
    if at_startup:
        for c in first:
            shutil.move(staging / c, data / c)
    thread = _watch(runs.plain, data, out, stop)
    if not at_startup:
        assert _wait_for(lambda: _logged(out, "watch mode: serving"))
        for c in first:
            shutil.move(staging / c, data / c)
    healthy = [cases[0], cases[2]]
    assert _wait_for(lambda: _segs(out) == [f"{c}.nii.gz" for c in healthy]), \
        "the healthy cases were not segmented"
    shutil.move(staging / cases[3], data / cases[3])
    assert _wait_for(lambda: f"{cases[3]}.nii.gz" in _segs(out)), "a later case was not served"
    assert _wait_for(lambda: _logged(out, "permanently quarantined")), \
        "the corrupt case was not quarantined"
    assert thread.is_alive()
    _stop(thread, stop)
    log = (out / "logfile_inference.log").read_text()
    assert f"case {cases[1]} failed 2/2 attempts" in log
    assert _segs(out) == sorted(f"{c}.nii.gz" for c in healthy + [cases[3]])


def test_watch_warms_up_then_serves(runs, tmp_path):
    """``--watch_warmup`` on an empty folder: the warm-up case runs (and
    leaves no trace), then a case that lands is served."""
    staging, cases = _staging(tmp_path, 1, seed=7)
    data, out, stop = tmp_path / "data", tmp_path / "out", tmp_path / "stop"
    data.mkdir()
    thread = _watch(runs.plain, data, out, stop, "--watch_warmup", "16", "16", "16")
    assert _wait_for(lambda: _logged(out, "watch: warm-up for cropped shape (16, 16, 16) done"))
    shutil.move(staging / cases[0], data / cases[0])
    assert _wait_for(lambda: _segs(out) == [f"{cases[0]}.nii.gz"])
    _stop(thread, stop)
    assert not glob.glob(str(out / "**" / "*Warmup*"), recursive=True)


@pytest.mark.parametrize("failing", ["kernels", "evaluate"])
def test_warm_up_failures(monkeypatch, tmp_path, failing):
    """On a card, a kernel build or launch failure in the warm-up stops
    the server before any case; any other warm-up failure is logged and
    serving goes on."""
    calls = []

    def fail(*a, **kw):
        calls.append(failing)
        raise RuntimeError(f"{failing} failed")

    engine = SimpleNamespace(device=torch.device("cuda", 0),
                             evaluate=fail if failing == "evaluate" else calls.append)
    monkeypatch.setattr(main_inference.kernels, "warm_up",
                        fail if failing == "kernels" else calls.append)
    cfg0 = SimpleNamespace(num_workers=0, create_patient_dir=False)
    server = main_inference.WatchServer(engine, [], cfg0, str(tmp_path), {})
    if failing == "kernels":
        with pytest.raises(RuntimeError, match="kernels failed"):
            server.warm_up((8, 8, 8))
        assert calls == ["kernels"]
    else:
        server.warm_up((8, 8, 8))
        assert calls == [torch.device("cuda", 0), "evaluate"]


def test_watch_holds_only_on_test(runs, train_data, tmp_path):
    """``--watch --on train`` scores the cases once and returns."""
    main_inference.main(["--config", str(runs.plain / "config.yaml"), "--on", "train",
                         "--train_data_path", str(train_data), "--output",
                         str(tmp_path / "out"), "--device", "cpu", "--num_workers", "1",
                         "--watch"])
    assert len(glob.glob(str(tmp_path / "out" / "Inference_segmentations_train" /
                             "*.nii.gz"))) == 2


# -------------------------------------------------------------- tta_compose

def _cl(x):
    """NCDHW torch → channels-last numpy, the JAX package's layout."""
    return np.moveaxis(x.numpy(), 1, -1)


def test_tta_compose_matches_jax_default_compose():
    """The 16 combos in the reference's order, each augmentation and
    de-augmentation equal to the JAX package's on the same volume; their
    mean sigmoid through a channel-mixing model equals ``tta_mean_probs``."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random((1, 3, 8, 8, 6), dtype=np.float32))
    w = torch.from_numpy(rng.random((3, 3), dtype=np.float32))
    compose, jcompose = tc.default_compose(), jtc.default_compose()
    assert len(compose) == len(jcompose) == 16
    total = torch.zeros_like(x)
    for tr, jtr in zip(compose, jcompose):
        assert [(type(t).__name__, p) for t, p in tr.chain] == \
            [(type(t).__name__, p) for t, p in jtr.chain]
        aug = tr.augment_image(x)
        want = jtr.augment_image(jnp.asarray(_cl(x)))
        np.testing.assert_array_equal(_cl(aug), np.asarray(want))
        out = torch.einsum("bcxyz,cd->bdxyz", aug, w)
        back = tr.deaugment_mask(out)
        want = jtr.deaugment_mask(jnp.asarray(_cl(out)))
        np.testing.assert_array_equal(_cl(back), np.asarray(want))
        total += torch.sigmoid(back)
    fast, _ = tta_mean_probs(lambda v: torch.einsum("bxyzc,cd->bxyzd", v, w),
                             x.permute(0, 2, 3, 4, 1))
    np.testing.assert_allclose(_cl(total / 16), fast.numpy(), atol=1e-6)


def test_tta_compose_inverse_and_noise():
    """De-augmenting an augmented volume gives it back for every combo of
    every axis order, both flips and the four rotations; GaussianNoise is
    the reference's VerticalFlip, as the JAX package keeps it; the random
    noise is seeded and de-augments as the identity."""
    x = torch.from_numpy(np.random.default_rng(4).random((1, 2, 6, 6, 6), dtype=np.float32))
    compose = tc.Compose([tc.OnAxes(["zxy", "xyz", "yzx"]), tc.VerticalFlip(),
                          tc.HorizontalFlip(), tc.Rotate90([90, 180, 270])])
    assert len(compose) == 48
    for tr in compose:
        torch.testing.assert_close(tr.deaugment_mask(tr.augment_image(x)), x, rtol=0, atol=0)
    noise = tc.GaussianNoise().apply_aug_image(x, True)
    torch.testing.assert_close(noise, torch.flip(x, dims=(2,)), rtol=0, atol=0)
    np.testing.assert_array_equal(
        _cl(noise), np.asarray(jtc.GaussianNoise().apply_aug_image(jnp.asarray(_cl(x)), True)))
    rnd = tc.RandomGaussianNoise(std=0.1, seed=1)
    a, b = rnd.apply_aug_image(x, True), rnd.apply_aug_image(x, True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert 0 < (a - x).abs().max() < 1.0
    assert rnd.apply_deaug_mask(a, True) is a
    with pytest.raises(ValueError):
        tc.OnAxes(["xzy"])
