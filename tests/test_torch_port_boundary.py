"""The batched Hausdorff criterion and the boundary criteria with their
distance maps, on the CPU, against the JAX package and scipy.

- ``HDCriterion.per_head`` (one EDT batch for the target and every head)
  gives the head-by-head losses bit for bit, and the deep-supervision mean
  matches the JAX package's within 1e-5;
- ``boundary``/``dice_boundary`` and the pair target through
  ``deep_supervision_loss`` match the JAX package within 1e-5;
- ``compute_distance_map_fn`` equals the JAX package's and scipy's map;
  ``augment_train_sample(compute_dm=True)`` and the train loader's batches
  equal the JAX package's under the same numpy generators;
- a 5-step dice_boundary train-step trajectory follows the JAX package's
  ``make_train_step``, and the train CLI trains with ``--criterion
  dice_boundary`` on the host."""

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax
import jax.numpy as jnp

from brats21_tpu.data import transforms as jT
from brats21_tpu.learning import losses as jlosses
from brats21_tpu_torch.data import transforms as pT
from brats21_tpu_torch.learning import losses as plosses
from test_torch_port_kernels import one_torch_thread  # noqa: F401  (autouse)


def _ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _heads_target(seed, shape=(2, 11, 9, 7, 3)):
    rng = np.random.default_rng(seed)
    heads = [(2.0 * rng.standard_normal(shape)).astype(np.float32) for _ in range(3)]
    target = (rng.random(shape) > 0.6).astype(np.float32)
    target[1, ..., 2] = 0.0          # an empty channel: its map is zero
    return heads, target


@pytest.mark.parametrize("name", ["hd", "dice_hd"])
def test_hd_per_head_is_the_head_by_head_loss_bit_for_bit(name, monkeypatch):
    heads, target = _heads_target(1)
    crit = plosses.make_criterion({"criterion": name})
    tt = _ncdhw(target)
    hs = [_ncdhw(h) for h in heads]
    want = [crit(h, tt) for h in hs]
    calls = []
    dist_maps = plosses._dist_maps
    monkeypatch.setattr(plosses, "_dist_maps", lambda seg: calls.append(seg.shape)
                        or dist_maps(seg))
    got = crit.per_head(hs, tt)
    assert len(calls) == 1 and calls[0][0] == 4 * 2     # one batch: target + 3 heads
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    total = plosses.deep_supervision_loss(crit, (hs[0], hs[1:]), tt)
    assert torch.equal(total, torch.stack(want).mean())


@pytest.mark.parametrize("idc", [[0, 2], [1]])
def test_hausdorff_loss_on_a_channel_subset_matches_jax(idc):
    """The prediction's one-hot is taken over all channels before the
    subset (losses.py:158-159): a tie-free argmax, then the maps of the
    selected channels only."""
    heads, target = _heads_target(7)
    want = float(jlosses.hausdorff_loss(jnp.asarray(heads[0]), jnp.asarray(target), idc=idc))
    got = float(plosses.hausdorff_loss(_ncdhw(heads[0]), _ncdhw(target), idc=idc))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_batched_deep_supervision_hd_matches_jax():
    heads, target = _heads_target(2)
    jc = jlosses.make_criterion({"criterion": "dice_hd"})
    want = float(jlosses.deep_supervision_loss(
        jc, (jnp.asarray(heads[0]), [jnp.asarray(h) for h in heads[1:]]),
        jnp.asarray(target)))
    got = float(plosses.deep_supervision_loss(
        plosses.make_criterion({"criterion": "dice_hd"}),
        (_ncdhw(heads[0]), [_ncdhw(h) for h in heads[1:]]), _ncdhw(target)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("name", ["boundary", "dice_boundary"])
def test_boundary_deep_supervision_with_pair_target_matches_jax(name):
    heads, target = _heads_target(3)
    dm = np.stack([jT.compute_distance_map_fn(t) for t in target])
    jc = jlosses.make_criterion({"criterion": name})
    want = float(jlosses.deep_supervision_loss(
        jc, (jnp.asarray(heads[0]), [jnp.asarray(h) for h in heads[1:]]),
        (jnp.asarray(target), jnp.asarray(dm))))
    got = float(plosses.deep_supervision_loss(
        plosses.make_criterion({"criterion": name}),
        (_ncdhw(heads[0]), [_ncdhw(h) for h in heads[1:]]), (_ncdhw(target), _ncdhw(dm))))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_boundary_loss_takes_a_bare_map_or_a_pair():
    heads, target = _heads_target(4)
    dm = np.random.default_rng(4).standard_normal(target.shape).astype(np.float32)
    logits = _ncdhw(heads[0])
    bare = plosses.boundary_loss(logits, _ncdhw(dm), idc=[0, 2])
    pair = plosses.boundary_loss(logits, (_ncdhw(target), _ncdhw(dm)), idc=[0, 2])
    assert torch.equal(bare, pair)
    want = float(jlosses.boundary_loss(jnp.asarray(heads[0]), jnp.asarray(dm), idc=[0, 2]))
    np.testing.assert_allclose(float(bare), want, rtol=1e-5, atol=1e-6)


def _seg_mc(seed, shape=(17, 14, 12)):
    rng = np.random.default_rng(seed)
    labels = np.zeros(shape, np.int64)
    labels[3:12, 2:10, 4:9] = 2
    labels[5:9, 4:8, 5:8] = rng.choice([1, 4], (4, 4, 3))
    return pT.brats_labels_to_multichannel(labels)


def test_compute_distance_map_fn_matches_jax_and_scipy():
    seg = _seg_mc(5)
    seg[..., 2] = 0.0                                   # an empty ET channel
    got = pT.compute_distance_map_fn(seg, "cpu")
    assert got.dtype == np.float32 and got.shape == seg.shape
    np.testing.assert_array_equal(got, jT.compute_distance_map_fn(seg))
    for c in range(seg.shape[-1]):
        pos = seg[..., c].astype(bool)
        if not pos.any():
            assert (got[..., c] == 0).all()
            continue
        want = (ndimage.distance_transform_edt(~pos) * ~pos
                - (ndimage.distance_transform_edt(pos) - 1) * pos)
        np.testing.assert_allclose(got[..., c], want, rtol=1e-6, atol=1e-5)


def test_augment_train_sample_with_distance_map_equals_jax():
    rng = np.random.default_rng(6)
    img = (100 + 20 * rng.standard_normal((17, 14, 12, 4))).astype(np.float32)
    sample = {"img": img, "seg": _seg_mc(6), "foreground_start_coord": np.zeros(3),
              "foreground_end_coord": np.ones(3), "original_shape": np.ones(3)}
    for seed in range(3):
        want = jT.augment_train_sample(sample, np.random.default_rng(seed), (16, 16, 16),
                                       compute_dm=True)
        got = pT.augment_train_sample(sample, np.random.default_rng(seed), (16, 16, 16),
                                      compute_dm=True, device="cpu")
        assert sorted(got) == sorted(want) and "distance_map" in got
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_distance_map_paths_need_a_device():
    """No path runs the EDT on the host unasked: a missing device raises."""
    from brats21_tpu_torch.data.pipeline import BraTSDataset, TrainLoader
    seg = _seg_mc(7)
    sample = {"img": np.zeros(seg.shape[:3] + (4,), np.float32), "seg": seg}
    labels = pT.multichannel_to_brats_labels(seg)
    with pytest.raises(ValueError, match="device"):
        pT.compute_distance_map_fn(seg, None)
    with pytest.raises(ValueError, match="device"):
        pT.augment_train_sample(sample, np.random.default_rng(0), (16, 16, 16),
                                compute_dm=True)
    with pytest.raises(ValueError, match="device"):
        pT.preprocess_case(sample["img"], labels, compute_distance_map=True)
    with pytest.raises(ValueError, match="device"):
        TrainLoader(BraTSDataset([], with_seg=True), 1, (16, 16, 16), compute_dm=True)


@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    from brats21_tpu_torch.data.synthetic import generate_synthetic_dataset
    root = tmp_path_factory.mktemp("port_boundary_data")
    generate_synthetic_dataset(str(root), num_cases=2, shape=(30, 28, 24), seed=9)
    return root


def test_train_loader_distance_maps_match_jax(train_data):
    from brats21_tpu.config import TrainConfig as JaxTrainConfig
    from brats21_tpu.data.pipeline import make_train_val_loaders
    from brats21_tpu_torch.data.pipeline import create_train_val_records, make_train_loader
    cfg = JaxTrainConfig(train_data_path=str(train_data), fold=None, batch_size=1,
                         patch_size=[16, 16, 16], num_workers=1, remove_outliers=True,
                         criterion="dice_boundary")
    jloader, _ = make_train_val_loaders(cfg)
    ploader = make_train_loader(cfg, create_train_val_records(cfg)[0], "cpu")
    assert ploader.compute_dm
    want = list(jloader)
    got = list(ploader)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) and "distance_map" in g
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_assp_evo_dice_boundary_trajectory_matches_jax():
    """5 train steps of EquiUnetASSPEvo width 4 at 16³ with deep
    supervision, fp32, dice_boundary on (seg, distance_map) targets and
    Ranger(use_gc, weight decay 1e-2): loss and every parameter follow the
    JAX package's make_train_step at the dice_hd trajectory's tolerances
    (loss 2e-5, params 5e-5)."""
    from flax.core import FrozenDict
    from brats21_tpu.learning.ranger import ranger as jax_ranger
    from brats21_tpu.learning.train_state import TrainState as JaxState, make_train_step
    from brats21_tpu.models import get_model as jax_get_model
    from brats21_tpu.utils.import_torch import state_dict_to_flax
    from brats21_tpu_torch.learning.optimizers import TrainOptimizer
    from brats21_tpu_torch.learning.ranger import Ranger
    from brats21_tpu_torch.learning.train_state import TrainState, TrainStep
    from brats21_tpu_torch.models import get_model
    from brats21_tpu_torch.utils.weights import state_dict_from_flax

    cfg = {"model": "equiunet_assp_evo", "width": 4, "criterion": "dice_boundary",
           "remat_mode": "none"}
    lr = 1e-3
    torch.manual_seed(4)
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

    rng = np.random.default_rng(8)
    key = jax.random.PRNGKey(0)
    for t in range(5):
        img = rng.standard_normal((1, 16, 16, 16, 4)).astype(np.float32)
        seg = (rng.random((1, 16, 16, 16, 3)) > 0.55).astype(np.float32)
        dm = pT.compute_distance_map_fn(seg[0], "cpu")[None]
        state, jm = jstep(state, jnp.asarray(img), (jnp.asarray(seg), jnp.asarray(dm)), key)
        pm = pstep(pstate, _ncdhw(img), (_ncdhw(seg), _ncdhw(dm)))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), atol=2e-5,
                                   rtol=1e-5, err_msg=f"loss at step {t + 1}")
        want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, state.params))
        for name, p in model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=5e-5, rtol=0,
                                       err_msg=f"{name} at step {t + 1}")


def test_train_cli_trains_with_dice_boundary_on_the_host(train_data, tmp_path):
    from brats21_tpu_torch.cli.main_train import main as train_main
    result = train_main([
        "--train_data_path", str(train_data), "--save_path", str(tmp_path / "runs"),
        "--model", "equiunet_assp_evo", "--width", "4", "--criterion", "dice_boundary",
        "--optimizer", "ranger", "--learning_rate", "3e-4", "--fold", "None",
        "--epochs", "1", "--patch_size", "16", "16", "16", "--num_workers", "1",
        "--no_full_name", "--no_tensorboard", "--log_train_metrics", "--device", "cpu"])
    assert np.isfinite(result["train_loss"])
    assert (tmp_path / "runs" / "best_model.pth").exists()
