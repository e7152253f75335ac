"""Training the port's model zoo on the CPU against the JAX package: one
train step of Model 1 (``equiunet``; dice, Ranger) and of ``equiunet_ref``
(the refinement pair in the loss) against ``make_train_step``, the
deep-supervision loss over a refinement pair, Ranger and Ranger21 on the
new parameter ranks (CBAM's Linear, BCNorm's ``(1, g, 1)``, the norm
vectors), BatchNorm's running statistics through SWA and the checkpoint,
and Model 1's recipe through the train CLI, then served by the inference
CLI from its run directory. Widths ≤ 8, volumes ≤ 16³."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from brats21_tpu.learning import losses as jlosses
from brats21_tpu.learning.optimizers import make_optimizer as jax_make_optimizer
from brats21_tpu_torch.learning import losses as plosses
from brats21_tpu_torch.learning.optimizers import make_optimizer
from brats21_tpu_torch.learning.train_state import TrainState, TrainStep, swa_update
from brats21_tpu_torch.models import get_model
from brats21_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_port_kernels import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_zoo import _cfg, _ncdhw, _port_from, _random_variables


def _opt_cfg(**kw):
    base = dict(learning_rate=1e-2, weight_decay=1e-5, optimizer="ranger",
                decay_type="cosine", epochs=1, use_gc=False, use_gcnorm=False,
                normloss=False, normloss_factor=1e-4, gc_conv_only=False,
                adaptive_gradient_clipping=False, gradient_clipping=False,
                max_grad_norm=1.0, gradient_accumulation_iter=None, swa_start=None,
                swa_lr=5e-5, swa_anneal_epochs=10)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("name", ["equiunet", "equiunet_ref"])
def test_train_step_matches_jax(name):
    """One train step of Model 1's recipe (dice, Ranger, cosine; fp32) at
    width 4 on 16³: the loss within 1e-4 relative and every parameter
    after the step within 1e-4 of the JAX package's ``make_train_step``;
    for ``equiunet_ref`` the loss takes both heads of the refinement pair
    and the four deep heads. Both start from the same numpy weights."""
    from flax.core import FrozenDict
    from brats21_tpu.learning.train_state import TrainState as JaxState, make_train_step
    from brats21_tpu.models import get_model as jax_get_model
    cfg = {**_cfg(name, width=4), "criterion": "dice"}
    jmodel = jax_get_model(cfg)
    variables = _random_variables(jmodel, seed=21)
    model = _port_from(variables, cfg)
    ocfg = _opt_cfg()
    tx = jax_make_optimizer(ocfg, 1)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JaxState(step=jnp.zeros([], jnp.int32), params=params, batch_stats=FrozenDict(),
                     opt_state=tx.init(params), swa_params=None,
                     swa_n=jnp.zeros([], jnp.int32), tx=tx, apply_fn=jmodel.apply)
    jstep = make_train_step(jlosses.make_criterion(cfg), use_amp=False)
    pstate = TrainState(model, make_optimizer(ocfg, model.parameters(), 1))
    pstep = TrainStep(plosses.make_criterion(cfg), use_amp=False)
    rng = np.random.default_rng(22)
    img = rng.standard_normal((1, 16, 16, 16, 4)).astype(np.float32)
    seg = (rng.random((1, 16, 16, 16, 3)) > 0.55).astype(np.float32)
    state, jm = jstep(state, jnp.asarray(img), jnp.asarray(seg), jax.random.PRNGKey(0))
    pm = pstep(pstate, _ncdhw(img), _ncdhw(seg))
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-4)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, state.params), name)
    start = state_dict_from_flax(variables["params"], name)
    moved = 0
    for key, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[key].numpy(), atol=1e-4, rtol=0,
                                   err_msg=key)
        moved += not torch.equal(p, start[key])
    assert moved > 30


def test_refinement_pair_loss_matches_jax():
    """``([refined, logits], deeps)`` through the deep-supervision mean:
    every main head enters the loss, for a plain criterion and for the
    batched HD criterion, within 1e-5 of the JAX package's."""
    rng = np.random.default_rng(23)
    heads = [(2.0 * rng.standard_normal((1, 9, 8, 7, 3))).astype(np.float32) for _ in range(4)]
    seg = (rng.random((1, 9, 8, 7, 3)) > 0.6).astype(np.float32)
    for criterion in ("dice", "dice_hd"):
        want = jlosses.deep_supervision_loss(
            jlosses.make_criterion({"criterion": criterion}),
            ([jnp.asarray(heads[0]), jnp.asarray(heads[1])], [jnp.asarray(h) for h in heads[2:]]),
            jnp.asarray(seg))
        got = plosses.deep_supervision_loss(
            plosses.make_criterion({"criterion": criterion}),
            ([_ncdhw(heads[0]), _ncdhw(heads[1])], [_ncdhw(h) for h in heads[2:]]),
            _ncdhw(seg))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# (torch shape, flax leaf, kind): the zoo's new parameter ranks in each
# framework's layout: a GroupNorm's and BCNorm EstBN's vectors, BCNorm's
# (1, g, 1) group affine, CBAM's Linear
_ZOO_PARAMS = [((8,), "scale", "vec"), ((8,), "estbn_scale", "vec"),
               ((1, 8, 1), "scale", "keep"), ((1, 8, 1), "bias", "keep"),
               ((2, 8), "kernel", "lin_w"), ((2,), "bias", "vec")]


def _flax_tree(arrays):
    return {f"m{i}": {leaf: jnp.asarray(a.T if kind == "lin_w" else a)}
            for i, ((_, leaf, kind), a) in enumerate(zip(_ZOO_PARAMS, arrays))}


@pytest.mark.parametrize("case", ["ranger_gc_normloss", "ranger_gcnorm_agc",
                                  "ranger21_gc_normloss"])
def test_rangers_on_the_zoo_parameter_ranks(case):
    """8 steps of Ranger and Ranger21 with gradient centralisation,
    norm-loss and AGC on the zoo's parameter ranks: each within 1e-6 +
    1e-5·|p| of the JAX package's optax chain (which reproduces the
    reference's torch-layout axes on its transposed flax layouts)."""
    cases = {"ranger_gc_normloss": dict(use_gc=True, normloss=True, weight_decay=1e-2),
             "ranger_gcnorm_agc": dict(use_gcnorm=True, adaptive_gradient_clipping=True),
             "ranger21_gc_normloss": dict(optimizer="ranger21", use_gc=True, normloss=True)}
    cfg = _opt_cfg(**cases[case])
    rng = np.random.default_rng(24)
    init = [(1.0 + rng.standard_normal(shape)).astype(np.float32) for shape, *_ in _ZOO_PARAMS]
    tx = jax_make_optimizer(cfg, 3)
    jparams = _flax_tree(init)
    jstate = tx.init(jparams)
    update = jax.jit(tx.update)
    tparams = [torch.from_numpy(a.copy()).requires_grad_() for a in init]
    opt = make_optimizer(cfg, tparams, 3)
    for t in range(8):
        grads = [(0.1 * rng.standard_normal(a.shape)).astype(np.float32) for a in init]
        if t == 3:
            grads = [10.0 * g for g in grads]     # trips AGC
        updates, jstate = update(_flax_tree(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        for i, ((_, leaf, kind), p) in enumerate(zip(_ZOO_PARAMS, tparams)):
            got = p.detach().numpy()
            np.testing.assert_allclose(got.T if kind == "lin_w" else got,
                                       np.asarray(jparams[f"m{i}"][leaf]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{case}: {leaf} {kind} step {t + 1}")


def test_swa_and_checkpoint_carry_current_batchnorm_statistics(tmp_path):
    """``--norm batch`` with SWA: the averaged model validates and is saved
    with the model's current running statistics (the JAX package pairs
    ``swa_params`` with the current ``batch_stats``), the attention gates'
    statistics never move in training, and ``best_model.pth`` /
    ``last_model.pth`` round-trip every BatchNorm buffer."""
    from brats21_tpu_torch.learning.checkpoint import CheckpointManager, load_for_evaluation
    from brats21_tpu_torch.utils.weights import load_reference_pth
    torch.manual_seed(25)
    cfg = {**_cfg("att_unet", "batch", width=4), "criterion": "dice"}
    model = get_model(cfg)
    gates0 = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("Att")}
    state = TrainState(model, make_optimizer(_opt_cfg(), model.parameters(), 1),
                       torch.optim.swa_utils.AveragedModel(model))
    step = TrainStep(plosses.make_criterion(cfg), use_amp=False)
    rng = np.random.default_rng(26)

    def batch():
        return (_ncdhw(rng.standard_normal((1, 16, 16, 16, 4)).astype(np.float32)),
                _ncdhw((rng.random((1, 16, 16, 16, 3)) > 0.5).astype(np.float32)))

    step(state, *batch())
    swa_update(state)
    step(state, *batch())                  # moves the statistics past the average's copy
    current = {k: v.clone() for k, v in model.state_dict().items()
               if k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    assert not torch.equal(current["Conv1.conv.1.running_mean"],
                           state.swa_model.module.state_dict()["Conv1.conv.1.running_mean"])
    manager = CheckpointManager(str(tmp_path), save_on="loss")
    manager.save(state, 1, 0.5)
    swa = load_for_evaluation(str(tmp_path), swa=True)
    best = load_reference_pth(str(tmp_path / "best_model.pth"))
    for key, value in current.items():
        assert torch.equal(swa[key], value), key
        assert torch.equal(best[key], value), key
        if key.startswith("Att"):
            assert torch.equal(value, gates0[key]), key
    assert int(current["Conv1.conv.1.num_batches_tracked"]) == 2
    fresh = get_model(cfg)
    fresh.load_state_dict(swa, strict=True)
    for key, value in current.items():
        assert torch.equal(fresh.state_dict()[key], value), key


def test_model1_recipe_trains_then_serves(tmp_path):
    """Model 1's command line (``tests/test_cli_surface.py:121-128``) at
    width 4 through the train CLI on the CPU, one epoch over two 24³ cases
    with 16³ patches; then the inference CLI with only ``--config`` of the
    run, as the Dockerfile serves it: a finite loss, ``best_model.pth``
    holding the EquiUnet's keys, and labels ⊆ {0, 1, 2, 4} at each case's
    shape."""
    from brats21_tpu_torch.cli.main_inference import main as infer_main
    from brats21_tpu_torch.cli.main_train import main as train_main
    from brats21_tpu_torch.data.nifti import read_nifti
    from brats21_tpu_torch.data.synthetic import generate_synthetic_dataset
    data = tmp_path / "data"
    generate_synthetic_dataset(str(data), num_cases=2, shape=(24, 24, 24), seed=27)
    result = train_main([
        "--train_data_path", str(data), "--save_path", str(tmp_path / "runs"),
        "--model", "equiunet", "--norm", "group", "--act", "relu", "--width", "4",
        "--criterion", "dice", "--optimizer", "ranger", "--decay_type", "cosine",
        "--learning_rate", "0.0003", "--remove_outliers", "--fold", "None", "--epochs", "1",
        "--patch_size", "16", "16", "16", "--num_workers", "1", "--no_full_name",
        "--no_tensorboard", "--device", "cpu"])
    assert np.isfinite(result["train_loss"])
    run = tmp_path / "runs"
    sd = torch.load(run / "best_model.pth", weights_only=True)["model"]
    assert "encoder1.ConvBnRelu1.conv.weight" in sd and "deep_bottom.0.weight" in sd
    infer_main(["--config", str(run / "config.yaml"), "--on", "test", "--input", str(data),
                "--output", str(tmp_path / "out"), "--device", "cpu"])
    segs = sorted((tmp_path / "out" / "Inference_segmentations_test").glob("*.nii.gz"))
    assert len(segs) == 2
    for path in segs:
        labels = read_nifti(str(path)).data
        assert labels.shape == (24, 24, 24)
        assert set(np.unique(labels)) <= {0, 1, 2, 4}
