"""Preemption and mid-epoch ``--resume`` of the port's train CLI, after
``tests/test_preempt_exact.py``: a run stopped mid-epoch by
``BRATS21_PREEMPT_AT_STEP`` and resumed from its ``last_model.pth`` ends
bit-identical on the CPU to an uninterrupted run (parameters, optimizer
state, SWA average, global step), with dropout drawn from the per-step
generator; a stop that lands after an epoch's last batch counts the epoch
in full; and SIGTERM outside training (``--only_evaluate``) terminates with
143."""

import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from brats21_tpu_torch.cli.main_train import main as train_main
from brats21_tpu_torch.data.synthetic import generate_synthetic_dataset
from test_torch_port_kernels import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Five 24³ cases: ``--fold None`` trains on all (5 steps an epoch)."""
    root = tmp_path_factory.mktemp("preempt_data")
    generate_synthetic_dataset(str(root), num_cases=5, shape=(24, 24, 24), seed=31)
    return str(root)


def _argv(data, save, optimizer, dropout, swa, fold="None", epochs=2):
    argv = ["--train_data_path", data, "--save_path", save, "--model", "equiunet",
            "--width", "4", "--criterion", "dice", "--optimizer", optimizer,
            "--decay_type", "flat_cosine", "--learning_rate", "1e-3", "--dropout", str(dropout),
            "--epochs", str(epochs), "--val_frequency", "1", "--patch_size", "16", "16", "16", "--batch_size", "1",
            "--num_workers", "1", "--fold", fold, "--no_tensorboard", "--no_amp",
            "--no_full_name", "--device", "cpu"]
    return argv + (["--swa_start", "1"] if swa else [])


def _assert_equal(a, b, where=""):
    """Nested payloads equal, tensors bit for bit."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("optimizer,dropout,swa", [("ranger", 0.0, True),
                                                   ("novograd", 0.2, False)])
def test_mid_epoch_preempt_resume_bit_identical(data, tmp_path, monkeypatch, optimizer,
                                                dropout, swa):
    """Stopped at global step 7 (epoch 2, batch 2) and resumed: the same
    ``last_model.pth`` bit for bit as the uninterrupted run's — model,
    optimizer (with its step count), SWA average, epoch — and the same
    global step; with ``--dropout 0.2`` the masks come from the per-step
    generator, so the replayed steps draw what they drew."""
    monkeypatch.delenv("BRATS21_PREEMPT_AT_STEP", raising=False)
    whole = train_main(_argv(data, str(tmp_path / "whole"), optimizer, dropout, swa))
    want = torch.load(tmp_path / "whole" / "last_model.pth", weights_only=True)

    run = tmp_path / "preempted"
    monkeypatch.setenv("BRATS21_PREEMPT_AT_STEP", "7")
    stopped = train_main(_argv(data, str(run), optimizer, dropout, swa))
    mid = torch.load(run / "last_model.pth", weights_only=True)
    assert (mid["epoch"], mid["batch_cursor"], stopped["global_step"]) == (1, 2, 7)
    assert mid["optimizer"]["count"] == 7
    assert not torch.equal(mid["model"]["outconv.weight"], want["model"]["outconv.weight"])

    monkeypatch.delenv("BRATS21_PREEMPT_AT_STEP")
    resumed = train_main(_argv(data, str(run), optimizer, dropout, swa)
                         + ["--resume", str(run / "last_model.pth")])
    got = torch.load(run / "last_model.pth", weights_only=True)
    assert resumed["global_step"] == whole["global_step"] == 10
    assert "batch_cursor" not in got and got["epoch"] == want["epoch"] == 2
    # best_value is the epoch's mean train loss, here over the replayed
    # batches only, as in the JAX package
    for key in ("model", "optimizer") + (("swa_model",) if swa else ()):
        _assert_equal(got[key], want[key], key)


def test_stop_after_an_epochs_last_batch_counts_the_epoch(data, tmp_path, monkeypatch):
    """The flag turns true at global step 5, which the per-batch check sees
    at epoch 2's first batch: epoch 1 is recorded whole, with no cursor,
    and nothing of epoch 2 ran."""
    monkeypatch.setenv("BRATS21_PREEMPT_AT_STEP", "5")
    result = train_main(_argv(data, str(tmp_path / "run"), "ranger", 0.0, False))
    ckpt = torch.load(tmp_path / "run" / "last_model.pth", weights_only=True)
    assert ckpt["epoch"] == 1 and "batch_cursor" not in ckpt
    assert ckpt["optimizer"]["count"] == 5 and result["global_step"] == 5


def test_sigterm_under_only_evaluate_exits_143(data, tmp_path, monkeypatch):
    """``--only_evaluate`` has no training phase, so SIGTERM keeps its
    terminate semantics: the process, signalled during the evaluation,
    exits with 128 + 15."""
    monkeypatch.delenv("BRATS21_PREEMPT_AT_STEP", raising=False)
    run = tmp_path / "run"
    train_main(_argv(data, str(run), "ranger", 0.0, False, fold="0", epochs=1))
    script = (
        "import os, signal, sys, time\n"
        "from brats21_tpu_torch.learning.engine import Engine\n"
        "from brats21_tpu_torch.cli.main_train import main\n"
        "def evaluate(*a, **k):\n"
        "    os.kill(os.getpid(), signal.SIGTERM)\n"
        "    time.sleep(30)\n"
        "Engine.evaluate = evaluate\n"
        "main(sys.argv[1:])\n")
    proc = subprocess.run(
        [sys.executable, "-c", script, "--train_data_path", data, "--resume",
         str(run / "last_model.pth"), "--only_evaluate", "--device", "cpu"],
        cwd=str(REPO), env={**os.environ, "OMP_NUM_THREADS": "1"}, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 128 + signal.SIGTERM, proc.stderr[-2000:]


def test_train_step_generator_is_keyed_on_the_global_step():
    """With ``stochastic`` the dropout masks come from a generator seeded
    from (seed, global step): the same step draws the same masks whatever
    ran before, another step other masks; without it dropout is off in
    training (the JAX step's ``deterministic``), the loss that of the
    model without dropout."""
    from brats21_tpu_torch.learning.losses import make_criterion
    from brats21_tpu_torch.learning.train_state import TrainState, TrainStep
    from brats21_tpu_torch.models import get_model
    torch.manual_seed(0)
    model = get_model({"model": "equiunet", "width": 4, "dropout": 0.5}).train()
    state = TrainState(model, None)
    img = torch.randn((1, 4, 16, 16, 16))
    seg = (torch.rand((1, 3, 16, 16, 16)) > 0.5).float()
    crit = make_criterion({"criterion": "dice"})
    step = TrainStep(crit, use_amp=False, stochastic=True, seed=3)
    with torch.no_grad():
        a = step.forward_loss(state, img, seg, 11)[0]
        torch.rand(100)                  # the global generator moves
        b = step.forward_loss(state, img, seg, 11)[0]
        c = step.forward_loss(state, img, seg, 12)[0]
        off = TrainStep(crit, use_amp=False).forward_loss(state, img, seg, 11)[0]
        plain = TrainStep(crit, use_amp=False).forward_loss(
            TrainState(model.eval(), None), img, seg)[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(off, plain) and not torch.equal(a, off)
