"""The port's training path on the CPU against the JAX package, on the same
numpy inputs: every ported criterion and the deep-supervision mean, the
trainable conv3x3x3 / EvoNorm-S0 gradients, the optimizers and schedules,
a 7-step train-step trajectory of EquiUnetASSPEvo, the train-side data
stages, and the train CLI."""

import glob
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from brats21_tpu.config import TrainConfig as JaxTrainConfig
from brats21_tpu.learning import losses as jlosses
from brats21_tpu.learning.optimizers import make_optimizer as jax_make_optimizer
from brats21_tpu.learning.schedules import make_lr_schedule as jax_make_lr_schedule
from brats21_tpu_torch.learning import losses as plosses
from brats21_tpu_torch.learning.optimizers import TrainOptimizer, make_optimizer
from brats21_tpu_torch.learning.ranger import Ranger
from brats21_tpu_torch.learning.schedules import make_lr_schedule
from brats21_tpu_torch.learning.train_state import TrainState, TrainStep
from brats21_tpu_torch.ops.kernels.conv3d import (Conv3x3x3Function,
                                                  conv3x3x3_plain)
from brats21_tpu_torch.ops.kernels.evonorm import (EvoNormS0Function,
                                                   evonorm_s0_plain)
from test_torch_port_kernels import one_torch_thread  # noqa: F401  (autouse)


def _ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


# ---------------------------------------------------------------- criteria

CRITERIA = ["dice", "jaccard", "dice_ce", "dice_focal", "generalized_dice", "focal",
            "tversky", "hd", "dice_hd"]


def _logits_target(seed, shape=(2, 11, 9, 7, 3)):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal(shape)).astype(np.float32)
    target = (rng.random(shape) > 0.6).astype(np.float32)
    target[1, ..., 2] = 0.0          # an empty channel: hd zeroes its map
    return logits, target


@pytest.mark.parametrize("name", CRITERIA)
def test_criterion_matches_jax(name):
    """Each criterion of make_criterion on the same logits and targets:
    within 1e-5 (relative for the hd terms, whose squared distances reach
    tens)."""
    logits, target = _logits_target(1)
    want = float(jlosses.make_criterion({"criterion": name})(
        jnp.asarray(logits), jnp.asarray(target)))
    got = float(plosses.make_criterion({"criterion": name})(_ncdhw(logits), _ncdhw(target)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 if "hd" not in name else 0)


def test_deep_supervision_loss_matches_jax():
    heads = [_logits_target(s)[0] for s in (2, 3, 4)]
    target = _logits_target(2)[1]
    jc = jlosses.make_criterion({"criterion": "dice_hd"})
    pc = plosses.make_criterion({"criterion": "dice_hd"})
    want = float(jlosses.deep_supervision_loss(
        jc, (jnp.asarray(heads[0]), [jnp.asarray(h) for h in heads[1:]]),
        jnp.asarray(target)))
    got = float(plosses.deep_supervision_loss(
        pc, (_ncdhw(heads[0]), [_ncdhw(h) for h in heads[1:]]), _ncdhw(target)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("name", ["boundary", "dice_boundary"])
def test_boundary_criteria_are_queued(name):
    """Once queued, now ported: each boundary criterion on a (seg,
    distance_map) target equals the JAX package's within 1e-5."""
    logits, target = _logits_target(6)
    dm = np.random.default_rng(6).standard_normal(target.shape).astype(np.float32)
    want = float(jlosses.make_criterion({"criterion": name})(
        jnp.asarray(logits), (jnp.asarray(target), jnp.asarray(dm))))
    got = float(plosses.make_criterion({"criterion": name})(
        _ncdhw(logits), (_ncdhw(target), _ncdhw(dm))))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------- trainable kernels

@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("BRATS21_PALLAS", "interpret")


def test_conv3x3x3_grads_match_jax_vjp(interpret):
    """dx, dw, dbias of Conv3x3x3Function (plain forward on the CPU) against
    jax.vjp of the JAX package's trainable conv3x3x3 (Pallas forward in
    interpret mode, XLA backward), within 1e-5; and against autograd of the
    plain version, bit for bit."""
    from brats21_tpu.ops.pallas.conv3d_kernel import conv3x3x3 as jconv
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 5, 7, 6, 4)).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, 3, 4, 6))).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    ct = rng.standard_normal((1, 5, 7, 6, 6)).astype(np.float32)
    y, vjp = jax.vjp(jconv, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    want = vjp(jnp.asarray(ct))
    inputs = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    out = Conv3x3x3Function.apply(*inputs)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), atol=1e-5)
    got = torch.autograd.grad(out, inputs, torch.from_numpy(ct))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-5, atol=1e-5)
    plain = torch.autograd.grad(conv3x3x3_plain(*inputs), inputs, torch.from_numpy(ct))
    for g, p in zip(got, plain):
        torch.testing.assert_close(g, p, rtol=0, atol=0)


def test_evonorm_s0_grads_match_jax_vjp(interpret):
    """dx, dγ, dβ of EvoNormS0Function against jax.vjp of the JAX
    package's trainable evonorm_s0 (Pallas forward in interpret mode,
    recomputed XLA backward), within 1e-5; and against autograd of the
    plain version, bit for bit."""
    from brats21_tpu.ops.pallas.evonorm_kernel import evonorm_s0 as jevo
    rng = np.random.default_rng(6)
    x = (0.5 + 2.0 * rng.standard_normal((2, 4, 5, 6, 16))).astype(np.float32)
    gamma = (1.0 + 0.2 * rng.standard_normal(16)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(16)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, g, b_: jevo(a, g, b_, 8, 1e-5), jnp.asarray(x),
                     jnp.asarray(gamma), jnp.asarray(beta))
    want = vjp(jnp.asarray(ct))
    inputs = [torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta)]
    got = torch.autograd.grad(EvoNormS0Function.apply(*inputs, 8, 1e-5), inputs,
                              torch.from_numpy(ct))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-5, atol=1e-5)
    plain = torch.autograd.grad(evonorm_s0_plain(*inputs), inputs, torch.from_numpy(ct))
    for g, p in zip(got, plain):
        torch.testing.assert_close(g, p, rtol=0, atol=0)


# ------------------------------------------------- optimizers, schedules

def _cfg(**kw):
    base = dict(learning_rate=1e-2, weight_decay=1e-4, optimizer="ranger",
                decay_type="cosine", epochs=5, use_gc=False, use_gcnorm=False,
                normloss=False, normloss_factor=1e-4, gc_conv_only=False,
                adaptive_gradient_clipping=False, gradient_clipping=False,
                max_grad_norm=1.0, gradient_accumulation_iter=None, swa_start=None,
                swa_lr=5e-5, swa_anneal_epochs=10)
    base.update(kw)
    return SimpleNamespace(**base)


# (torch key, flax path, kind): a conv, a linear, biases and an EvoNorm
# affine, in each framework's layout
_PARAMS = [("conv.weight", ("conv", "kernel"), "conv_w", (6, 4, 3, 3, 3)),
           ("conv.bias", ("conv", "bias"), "vec", (6,)),
           ("fc.weight", ("fc", "kernel"), "lin_w", (5, 6)),
           ("fc.bias", ("fc", "bias"), "vec", (5,)),
           ("evo.gamma", ("evo", "gamma"), "evo", (1, 6, 1, 1, 1))]


def _to_flax(arr, kind):
    if kind == "conv_w":
        return arr.transpose(2, 3, 4, 1, 0)
    if kind == "lin_w":
        return arr.T
    return arr.reshape(-1)


def _tree(arrays):
    tree = {}
    for (_, (mod, leaf), kind, _), a in zip(_PARAMS, arrays):
        tree.setdefault(mod, {})[leaf] = jnp.asarray(_to_flax(a, kind))
    return tree


OPTIMIZER_CASES = {
    "ranger_gc_wd": dict(use_gc=True, weight_decay=1e-2),
    "ranger_gcnorm_normloss_agc": dict(use_gcnorm=True, normloss=True,
                                       adaptive_gradient_clipping=True),
    "ranger_conv_only_accum": dict(use_gc=True, gc_conv_only=True,
                                   gradient_accumulation_iter=2),
    "ranger21_gc": dict(optimizer="ranger21", use_gc=True, decay_type="flat_cosine"),
    "sgd": dict(optimizer="sgd", decay_type="step"),
    "adam_clip": dict(optimizer="adam", gradient_clipping=True, max_grad_norm=0.5),
    "adamw_warmup": dict(optimizer="adamw", decay_type="cosine_warmup",
                         weight_decay=1e-2),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZER_CASES))
def test_optimizer_follows_jax_for_13_steps(case):
    """13 steps (past the RAdam crossover at step 6 and two lookahead
    syncs), 3 steps per epoch so the schedule moves: every parameter within
    1e-6 + 1e-5·|p| of the optax chain's (fp32 rounding of the scalar
    factors differs: the port computes them in float64)."""
    _follow_jax_for_13_steps(case, OPTIMIZER_CASES[case])


NOVOGRAD_CASES = {
    "novograd_wd": dict(optimizer="novograd", weight_decay=1e-2),
    "novograd_clip": dict(optimizer="novograd", gradient_clipping=True, max_grad_norm=0.5,
                          decay_type="cosine_warmup"),
    "novograd_agc_accum": dict(optimizer="novograd", adaptive_gradient_clipping=True,
                               gradient_accumulation_iter=2, weight_decay=1e-3),
}


@pytest.mark.parametrize("case", sorted(NOVOGRAD_CASES))
def test_novograd_follows_optax_for_13_steps(case):
    """``--optimizer novograd`` against ``optax.novograd(lr, b1=0.9,
    b2=0.98, eps=1e-8, weight_decay=wd)`` through the JAX package's chain,
    with global-norm clipping, and with AGC inside gradient accumulation:
    the 13-step pattern and tolerance above."""
    _follow_jax_for_13_steps(case, NOVOGRAD_CASES[case])


def _follow_jax_for_13_steps(case, kw):
    cfg = _cfg(**kw)
    rng = np.random.default_rng(7)
    init = [rng.standard_normal(shape).astype(np.float32) for *_, shape in _PARAMS]
    tx = jax_make_optimizer(cfg, 3)
    jparams = _tree(init)
    jstate = tx.init(jparams)
    update = jax.jit(tx.update)
    tparams = [torch.from_numpy(a.copy()).requires_grad_() for a in init]
    opt = make_optimizer(cfg, tparams, 3)
    for t in range(13):
        grads = [(0.1 * rng.standard_normal(a.shape)).astype(np.float32) for a in init]
        if t == 4:
            grads = [10.0 * g for g in grads]     # trips AGC and global-norm clipping
        updates, jstate = update(_tree(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        for (name, (mod, leaf), kind, _), p in zip(_PARAMS, tparams):
            np.testing.assert_allclose(
                _to_flax(p.detach().numpy(), kind), np.asarray(jparams[mod][leaf]),
                rtol=1e-5, atol=1e-6, err_msg=f"{case}: {name} at step {t + 1}")


@pytest.mark.parametrize("decay,swa", [("step", None), ("step_warmup", None),
                                       ("cosine_warmup", None), ("cosine", None),
                                       ("flat_cosine", None), ("cosine", 4),
                                       ("step_warmup", 3)])
def test_schedule_matches_jax(decay, swa):
    """Per-step learning rates within 1e-6 relative, or 1e-6 of the base
    rate where the JAX package's fp32 cosine cancels near its end (the port
    computes in float64)."""
    cfg = _cfg(decay_type=decay, epochs=70, learning_rate=3e-4, swa_start=swa,
               swa_anneal_epochs=3)
    want = jax_make_lr_schedule(cfg, 2)
    got = make_lr_schedule(cfg, 2)
    for step in range(0, 150, 3):
        np.testing.assert_allclose(got(step), float(want(jnp.asarray(step))),
                                   rtol=1e-6, atol=3e-10, err_msg=f"step {step}")


# ------------------------------------------------ train-step trajectory

def test_assp_evo_dice_hd_trajectory_matches_jax():
    """7 train steps of EquiUnetASSPEvo width 4 at 16³ with deep
    supervision, fp32, dice_hd and Ranger(use_gc, weight decay 1e-2): the
    loss and every parameter follow the JAX package's make_train_step at
    the tolerances of tests/test_train_step_golden.py (loss 2e-5, params
    5e-5). Both start from the port's torch-default init, carried into the
    flax tree by the JAX package's importer (no flax init run)."""
    from flax.core import FrozenDict
    from brats21_tpu.learning.ranger import ranger as jax_ranger
    from brats21_tpu.learning.train_state import TrainState as JaxState, make_train_step
    from brats21_tpu.models import get_model as jax_get_model
    from brats21_tpu.utils.import_torch import state_dict_to_flax
    from brats21_tpu_torch.models import get_model
    from brats21_tpu_torch.utils.weights import state_dict_from_flax

    cfg = {"model": "equiunet_assp_evo", "width": 4, "criterion": "dice_hd",
           "remat_mode": "none"}
    lr = 1e-3
    torch.manual_seed(3)
    model = get_model(cfg)
    jmodel = jax_get_model(cfg)
    template = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, 16, 16, 16, 4), jnp.float32))
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(
        {k: v.numpy() for k, v in model.state_dict().items()}, "equiunet_assp_evo",
        template["params"]))
    tx = jax_ranger(lr, use_gc=True, weight_decay=1e-2)
    state = JaxState(step=jnp.zeros([], jnp.int32), params=params,
                     batch_stats=FrozenDict(), opt_state=tx.init(params), swa_params=None,
                     swa_n=jnp.zeros([], jnp.int32), tx=tx, apply_fn=jmodel.apply)
    jstep = make_train_step(jlosses.make_criterion(cfg), use_amp=False)

    opt = TrainOptimizer(list(model.parameters()),
                         Ranger(model.parameters(), lr, use_gc=True, weight_decay=1e-2),
                         schedule=lambda step: lr)
    pstate = TrainState(model, opt)
    pstep = TrainStep(plosses.make_criterion(cfg), use_amp=False)

    rng = np.random.default_rng(7)
    key = jax.random.PRNGKey(0)
    for t in range(7):
        img = rng.standard_normal((1, 16, 16, 16, 4)).astype(np.float32)
        seg = (rng.random((1, 16, 16, 16, 3)) > 0.55).astype(np.float32)
        state, jm = jstep(state, jnp.asarray(img), jnp.asarray(seg), key)
        pm = pstep(pstate, _ncdhw(img), _ncdhw(seg))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), atol=2e-5,
                                   rtol=1e-5, err_msg=f"loss at step {t + 1}")
        want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, state.params))
        for name, p in model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=5e-5, rtol=0,
                                       err_msg=f"{name} at step {t + 1}")


# ---------------------------------------------------------- data stages

@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    from brats21_tpu_torch.data.synthetic import generate_synthetic_dataset
    root = tmp_path_factory.mktemp("port_train_data")
    generate_synthetic_dataset(str(root), num_cases=2, shape=(30, 28, 24), seed=9)
    return root


def test_augmentations_match_jax():
    """Each augmentation stage and the composed augment_train_sample, byte
    for byte, on one seed where every random stage fires."""
    from brats21_tpu.data import transforms as jT
    from brats21_tpu_torch.data import transforms as pT
    rng = np.random.default_rng(11)
    img = (100 + 20 * rng.standard_normal((20, 18, 14, 4))).astype(np.float32)
    seg = (rng.random((20, 18, 14, 3)) > 0.7).astype(np.float32)
    for name, args in [("rand_spatial_crop", ((16, 16, 16), img, seg)),
                       ("rand_rotate90", (1.0, (0, 2), img, seg)),
                       ("rand_flip", (1.0, (0, 1, 2), img, seg)),
                       ("rand_shift_intensity", (1.0, 0.1, img)),
                       ("rand_adjust_contrast", (1.0, (0.5, 4.5), img)),
                       ("rand_gaussian_noise", (1.0, 0.0, 0.1, img)),
                       ("rand_gaussian_smooth", (1.0, img))]:
        want = getattr(jT, name)(np.random.default_rng(3), *args)
        got = getattr(pT, name)(np.random.default_rng(3), *args)
        for g, w in zip(got if isinstance(got, tuple) else [got],
                        want if isinstance(want, tuple) else [want]):
            np.testing.assert_array_equal(g, w, err_msg=name)
    sample = {"img": img, "seg": seg, "foreground_start_coord": np.zeros(3),
              "foreground_end_coord": np.ones(3), "original_shape": np.ones(3)}
    for seed in range(4):
        want = jT.augment_train_sample(sample, np.random.default_rng(seed), (16, 16, 16))
        got = pT.augment_train_sample(sample, np.random.default_rng(seed), (16, 16, 16))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_train_loader_batches_and_split_match_jax(train_data):
    from brats21_tpu.data.discovery import kfold_split as jax_kfold
    from brats21_tpu.data.pipeline import make_train_val_loaders
    from brats21_tpu_torch.data.discovery import kfold_split
    from brats21_tpu_torch.data.pipeline import (create_train_val_records,
                                                 make_train_loader)
    ids = [f"BraTS2021_{i:05d}" for i in range(13)]
    for fold in range(5):
        assert kfold_split(ids, fold, 5, 93) == jax_kfold(ids, fold, 5, 93)
    cfg = JaxTrainConfig(train_data_path=str(train_data), fold=None, batch_size=1,
                         patch_size=[16, 16, 16], num_workers=1, remove_outliers=True)
    jloader, _ = make_train_val_loaders(cfg)
    ploader = make_train_loader(cfg, create_train_val_records(cfg)[0], "cpu")
    for epoch in (1, 2):
        jloader.set_epoch(epoch)
        want = list(jloader)
        # the same batches in the same order whatever the loader's threads
        for workers in (1, 3):
            ploader.num_workers = workers
            ploader.set_epoch(epoch)
            got = list(ploader)
            assert len(got) == len(want) == 2
            for g, w in zip(got, want):
                assert sorted(g) == sorted(w)
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ------------------------------------------------------------- the CLI

def _train_argv(data, runs, *extra):
    return ["--train_data_path", str(data), "--save_path", str(runs),
            "--model", "equiunet_assp_evo", "--width", "4", "--criterion", "dice_hd",
            "--optimizer", "ranger", "--decay_type", "cosine", "--learning_rate",
            "3e-4", "--use_gc", "--remove_outliers", "--fold", "None", "--epochs", "2",
            "--patch_size", "16", "16", "16", "--num_workers", "1", "--no_full_name",
            "--no_tensorboard", *extra]


def test_train_cli_writes_checkpoints_the_inference_cli_serves(train_data, tmp_path):
    from brats21_tpu_torch.cli.main_inference import main as infer_main
    from brats21_tpu_torch.cli.main_train import main as train_main
    from brats21_tpu_torch.data.nifti import read_nifti
    from brats21_tpu_torch.utils.weights import load_reference_pth
    result = train_main(_train_argv(train_data, tmp_path / "runs", "--device", "cpu"))
    run = tmp_path / "runs"
    assert np.isfinite(result["train_loss"])
    for name in ("best_model.pth", "last_model.pth"):
        payload = torch.load(run / name, weights_only=True)
        assert {"model", "optimizer", "epoch", "best_value"} <= set(payload)
        assert payload["best_value"] == result["best_value"]
    assert torch.load(run / "last_model.pth", weights_only=True)["epoch"] == 2
    assert len(load_reference_pth(str(run / "best_model.pth"))) > 100
    infer_main(["--config", str(run / "config.yaml"), "--import_pth",
                str(run / "best_model.pth"), "--on", "test", "--input", str(train_data),
                "--output", str(tmp_path / "out"), "--device", "cpu"])
    segs = sorted(glob.glob(str(tmp_path / "out" / "Inference_segmentations_test" / "*")))
    assert [os.path.basename(s) for s in segs] == \
        ["BraTS2021_00000.nii.gz", "BraTS2021_00001.nii.gz"]
    seg = read_nifti(segs[0]).data
    assert seg.shape == (30, 28, 24) and set(np.unique(seg)) <= {0, 1, 2, 4}


def test_train_cli_resume_continues_as_one_run(train_data, tmp_path):
    """Two epochs in one run, and one epoch then ``--resume`` from its
    last_model.pth for the second (the run's config.yaml raised to 2
    epochs): the same weights, bit for bit, and the same best value."""
    import yaml
    from brats21_tpu_torch.cli.main_train import main as train_main
    whole = train_main(_train_argv(train_data, tmp_path / "whole", "--device", "cpu"))
    argv = _train_argv(train_data, tmp_path / "split", "--device", "cpu")
    argv[argv.index("--epochs") + 1] = "1"
    train_main(argv)
    cfg_path = tmp_path / "split" / "config.yaml"
    cfg = yaml.safe_load(cfg_path.read_text())
    cfg["epochs"] = 2
    cfg_path.write_text(yaml.safe_dump(cfg))
    resumed = train_main(["--train_data_path", str(train_data), "--resume",
                          str(tmp_path / "split" / "last_model.pth"), "--device", "cpu"])
    assert resumed == whole
    want = torch.load(tmp_path / "whole" / "last_model.pth", weights_only=True)
    got = torch.load(tmp_path / "split" / "last_model.pth", weights_only=True)
    assert got["epoch"] == want["epoch"] == 2
    for k, v in want["model"].items():
        torch.testing.assert_close(got["model"][k], v, rtol=0, atol=0)


def test_train_cli_needs_cuda_unless_asked_for_cpu(train_data, tmp_path):
    from brats21_tpu_torch.cli.main_train import main as train_main
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(_train_argv(train_data, tmp_path / "runs"))


def test_train_parser_accepts_the_reference_flags():
    from test_cli_surface import REFERENCE_TRAIN_FLAGS
    from brats21_tpu_torch.cli.arguments import build_train_parser
    ours = {s for a in build_train_parser()._actions for s in a.option_strings}
    assert not [f for f in REFERENCE_TRAIN_FLAGS + ["--remat_mode", "--wire"]
                if f not in ours]
