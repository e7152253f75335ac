"""The port's spatial axis (``parallel/spatial.py``, the ``space`` rows of
``parallel/mesh.py``, ``parallel/distributed.py:halo_exchange`` /
``sharded_conv3d`` / ``spatial_sharded_forward``, the engine's data×space
evaluation and B2's split statistics) on the CPU, with real gloo ranks
(``tests/torch_parallel_worker.py``), against the JAX package on the same
numpy inputs and weights: its ``halo_exchange`` and ``sharded_conv3d``
under ``shard_map``, its GSPMD ``spatial_sharded_forward`` on meshes of
``space=2|4`` over the 8 CPU devices ``tests/conftest.py`` forces, and its
``Engine`` on a data×space mesh. Two launches of four ranks (space rows of
2 and of 4), one torch thread a rank, every collective bounded by 60 s.
Width 4, volumes of at most 16×16×40."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from brats21_tpu.config import TrainConfig as JaxTrainConfig
from brats21_tpu.learning import losses as jlosses
from brats21_tpu.learning.engine import Engine as JaxEngine
from brats21_tpu.models import get_model as jax_get_model
from brats21_tpu.parallel.distributed import halo_exchange as jax_halo_exchange
from brats21_tpu.parallel.distributed import sharded_conv3d as jax_sharded_conv3d
from brats21_tpu.parallel.distributed import spatial_sharded_forward as jax_spatial_forward
from brats21_tpu.parallel.mesh import make_mesh
from brats21_tpu.utils.reporting import EvaluationReport as JaxReport
from brats21_tpu_torch.config import TrainConfig
from brats21_tpu_torch.data.nifti import read_nifti
from brats21_tpu_torch.learning.engine import Engine
from brats21_tpu_torch.learning.losses import make_criterion
from brats21_tpu_torch.models import get_model
from brats21_tpu_torch.models.assp_evo import EvoNorm3D
from brats21_tpu_torch.models.equiunet import ChannelGate
from brats21_tpu_torch.models.layers import Conv3d, GroupNorm, InstanceNorm, Upsample
from brats21_tpu_torch.ops.kernels.evonorm import (evonorm_s0_apply, evonorm_s0_plain,
                                                   evonorm_s0_stats, inv_std)
from brats21_tpu_torch.parallel import spatial as sp
from brats21_tpu_torch.parallel.distributed import spatial_sharded_forward
from brats21_tpu_torch.parallel.mesh import Topology
from test_torch_port_kernels import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_parallel import EVAL_CFG, METRICS, _case, _launch, _Loader
from test_torch_port_zoo import _cfg, _port_from, _random_variables

SIDE = 16
MODELS = {"assp": _cfg("equiunet_assp_evo", width=4),
          "equi": _cfg("equiunet", width=4),
          "equi_instance": _cfg("equiunet", "instance", width=4)}
# (model, Z) a space size runs: uneven slabs (Z = 40: 24/16 on 2 ranks,
# 16/8/8/8 on 4, so 2/1/1/1 planes at level 4, where the ASPP's dilation-6
# halo and the bottom's dilation 2 pass the next slab), the JAX package's
# Z pad (30 → 32 on 4 ranks), fewer 8-plane blocks than ranks (16 on 4:
# 8/8/0/0, two ranks with empty slabs), and a padded Z its forward cannot
# take
FORWARDS = {2: [("assp", 40), ("equi", 40), ("equi_instance", 40)],
            4: [("assp", 40), ("equi", 40), ("assp", 30), ("assp", 16), ("equi", 16),
                ("assp", 36), ("equi", 36)]}
# halo cases: (X slabs, halo); X-sharded as the JAX package's default axis
HALOS = {2: [((4, 4), 1), ((4, 4), 3), ((5, 3), 4)],
         4: [((2, 2, 2, 2), 1), ((2, 2, 2, 2), 2), ((2, 2, 2, 2), 3), ((3, 1, 2, 2), 2)]}
CONV_KERNELS = (3, 5)
# single layers on Z-slabs of a 40-plane input, against the unsharded
# port: each sharded form the two models do not reach
LAYERS = {"evonorm_s0_plain_form": lambda: EvoNorm3D(8, efficient=False),
          "evonorm_b0": lambda: EvoNorm3D(8, version="B0"),
          "groupnorm": lambda: GroupNorm(8, 4),
          "instancenorm": lambda: InstanceNorm(8),
          "channel_gate": lambda: ChannelGate(8, 4),
          "upsample_half_pixel": lambda: Upsample(2, align_corners=False),
          "upsample_x4": lambda: Upsample(4, align_corners=True),
          "conv_dilation_10": lambda: Conv3d(8, 6, 3, dilation=10),
          "conv_stride_2": lambda: Conv3d(8, 6, 2, stride=2, padding=0)}
MEMBER_Z = 24
ENGINE_MODES = {"spatial": (1, (3, 4, 5), {}, (True, False)),
                "spatial_tta": (1, (4,), {"use_tta": True}, (False, False))}


def _variables(name, seed):
    return _random_variables(jax_get_model(MODELS[name]), seed=seed)


@pytest.fixture(scope="module")
def spatial_run(tmp_path_factory):
    """Inputs, and each rank's results of one 4-rank launch a space size
    (rows of 2: two data rows, the engine on 2×2; one row of 4)."""
    rng = np.random.default_rng(51)
    variables = {name: _variables(name, 52 + i) for i, name in enumerate(MODELS)}
    state = {name: _port_from(v, MODELS[name]).state_dict() for name, v in variables.items()}
    xs = {z: rng.standard_normal((1, SIDE, SIDE, z, 4)).astype(np.float32)
          for z in (16, 30, 36, 40)}
    torch.manual_seed(53)
    layers = {k: (make().eval(), rng.standard_normal((1, 8, 6, 5, 40)).astype(np.float32))
              for k, make in LAYERS.items()}
    for module, _ in layers.values():          # affines off their identity
        if not isinstance(module, Conv3d):
            for p in module.parameters():
                p.data.copy_(1.0 + 0.2 * torch.randn_like(p))
    member = dict(x=rng.standard_normal((1, SIDE, SIDE, MEMBER_Z, 4)).astype(np.float32),
                  seg=(rng.random((1, SIDE, SIDE, MEMBER_Z, 3)) > 0.5).astype(np.float32))
    members = [_variables("assp", s) for s in (56, 57)]
    for v in members:        # output conv ×20: few voxels near the threshold
        v["params"]["out_conv"]["Conv_0"]["kernel"] = \
            v["params"]["out_conv"]["Conv_0"]["kernel"] * 20.0
    batches = {mode: [_case(s) for s in m[1]] for mode, m in ENGINE_MODES.items()}
    halo_x = {n: rng.standard_normal((1, 2, 8, 3, 4)).astype(np.float32) for n in HALOS}
    conv_x = rng.standard_normal((1, 3, 8, 5, 6)).astype(np.float32)
    conv_w = {k: (rng.standard_normal((4, 3, k, k, k)) / k ** 1.5).astype(np.float32)
              for k in CONV_KERNELS}
    out = tmp_path_factory.mktemp("spatial_run")
    ranks = {}
    for n in (2, 4):
        job = dict(
            halo={f"{sizes}/{h}": (halo_x[n], h, list(sizes)) for sizes, h in HALOS[n]},
            conv={k: (conv_x, conv_w[k]) for k in CONV_KERNELS},
            layers=layers,
            forward={f"{name}/{z}": dict(cfg=MODELS[name], state_dict=state[name], x=xs[z])
                     for name, z in FORWARDS[n]})
        kinds = ["spatial"]
        if n == 2:
            job["member"] = dict(train_cfg=EVAL_CFG, cfg=MODELS["assp"],
                                 state_dict=state["assp"], **member)
            kinds.append("engine_eval")
        spec = {"kinds": kinds, "space": n, "spatial": job,
                "engine_eval": dict(train_cfg=EVAL_CFG, cfg=MODELS["assp"],
                                    members=[_port_from(v, MODELS["assp"]).state_dict()
                                             for v in members],
                                    batches=batches, out=str(out / "engine"),
                                    modes={m: (k, kw, {})
                                           for m, (k, _, kw, _) in ENGINE_MODES.items()})}
        ranks[n] = _launch(spec, out / f"space{n}", nproc=4, timeout=240)
    return dict(ranks=ranks, variables=variables, xs=xs, layers=layers, member=member,
                members=members, batches=batches, halo_x=halo_x, conv_x=conv_x,
                conv_w=conv_w, out=out)


def _space_mesh(n):
    return make_mesh(jax.devices(), space=n)


# ---------------------------------------------------------------- topology

@pytest.mark.parametrize("n", [2, 4])
def test_topology_rows(spatial_run, n):
    """Local rank r sits at data index r // space and space index r %
    space; its row's group holds the ranks of its row, in order."""
    for rank, r in enumerate(spatial_run["ranks"][n]):
        assert r["spatial"]["axes"] == (rank // n, 4 // n, rank % n, n)
        first = rank - rank % n
        assert r["spatial"]["row"] == list(range(first, first + n))


# ---------------------------------------------------- halo_exchange, conv

def _padded_window(x, starts, r, halo, dim=2):
    """Slab r of ``x`` with ``halo`` planes each side from the volume
    zero-padded along ``dim``."""
    pad = [(0, 0)] * x.ndim
    pad[dim] = (halo, halo)
    xp = np.pad(x, pad)
    return np.take(xp, range(starts[r], starts[r + 1] + 2 * halo), axis=dim)


@pytest.mark.parametrize("n,case", [(n, i) for n in HALOS for i in range(len(HALOS[n]))])
def test_halo_exchange_matches_jax(spatial_run, n, case):
    """halo_exchange of X-sharded NCDHW slabs on n ranks, plane for plane
    (1e-6): equal slabs against the JAX package's ``halo_exchange`` under
    ``shard_map`` (two ``ppermute`` shifts, neighbours only); a halo wider
    than a slab, and uneven slabs, against the zero-padded volume, which
    JAX's neighbour shifts cannot give."""
    sizes, h = HALOS[n][case]
    x = spatial_run["halo_x"][n]
    starts = np.cumsum([0, *sizes])
    equal = len(set(sizes)) == 1 and h <= sizes[0]
    if equal:
        xj = jnp.asarray(np.moveaxis(x, 1, -1))              # [B, X, Y, Z, C]
        fn = jax.shard_map(lambda xl: jax_halo_exchange(xl, h, "space", spatial_axis=1),
                           mesh=_space_mesh(n), in_specs=P(None, "space"),
                           out_specs=P(None, "space"), check_vma=False)
        got_j = np.moveaxis(np.asarray(fn(xj)), -1, 1)
        per = sizes[0] + 2 * h
    for r, res in enumerate(spatial_run["ranks"][n][:n]):
        got = res["spatial"]["halo"][f"{tuple(sizes)}/{h}"].numpy()
        want = _padded_window(x, starts, r, h)
        if equal:
            np.testing.assert_allclose(want, got_j[:, :, r * per:(r + 1) * per], atol=1e-6)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("k", CONV_KERNELS)
def test_sharded_conv3d_matches_jax(spatial_run, n, k):
    """sharded_conv3d (X-sharded, SAME, k³) gathered over n ranks against
    the JAX package's ``sharded_conv3d`` on a space mesh and the unsharded
    conv, fp32, 1e-5."""
    x, w = spatial_run["conv_x"], spatial_run["conv_w"][k]
    want = np.asarray(jax_sharded_conv3d(_space_mesh(n), jnp.asarray(np.moveaxis(x, 1, -1)),
                                         jnp.asarray(w.transpose(2, 3, 4, 1, 0))))
    plain = torch.nn.functional.conv3d(torch.from_numpy(x), torch.from_numpy(w),
                                       padding=k // 2).numpy()
    for res in spatial_run["ranks"][n]:
        got = res["spatial"]["conv"][k].numpy()
        np.testing.assert_allclose(got, np.moveaxis(want, -1, 1), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got, plain, atol=1e-5, rtol=0)


# ------------------------------------------------------- the model forward

def _heads(out):
    main, deeps = out
    return [main, *deeps]


@pytest.mark.parametrize("n,name,z", [(n, name, z) for n in FORWARDS
                                      for name, z in FORWARDS[n]])
def test_spatial_forward_matches_jax(spatial_run, n, name, z):
    """spatial_sharded_forward on n ranks, main head and every head
    (``full_outputs``), against the JAX package's GSPMD
    ``spatial_sharded_forward`` on a space mesh of n, fp32, atol 2e-5 (its
    own tolerance against one device, tests/test_parallel.py:322-348);
    every rank of the row holds the same heads. Z = 30 on 4 ranks takes the
    JAX pad (to 32, at the end, inside the global reductions); Z = 16 on 4
    ranks leaves two slabs empty, whose ranks join every exchange; at Z = 36 on
    4 ranks (no pad, 36 not a multiple of 8) the JAX forward fails at a
    skip's concatenation and the port raises ValueError naming Z."""
    variables = jax.tree_util.tree_map(jnp.asarray, spatial_run["variables"][name])
    jmodel = jax_get_model(MODELS[name])
    x = spatial_run["xs"][z]
    ranks = [res["spatial"]["forward"][f"{name}/{z}"] for res in spatial_run["ranks"][n]]

    def apply(v, inp):
        return jmodel.apply(v, inp, deterministic=True)

    if z % 8 and (z + (-z) % n) % 8:
        with pytest.raises(TypeError, match="concatenate"):
            jax_spatial_forward(_space_mesh(n), apply, variables, jnp.asarray(x),
                                full_outputs=True)
        for got in ranks:
            assert "Z = 36" in got["error"] and "multiple of 8" in got["error"]
        return
    want = [np.asarray(h) for h in _heads(jax_spatial_forward(
        _space_mesh(n), apply, variables, jnp.asarray(x), full_outputs=True))]
    for got in ranks:
        np.testing.assert_allclose(got["main"].numpy(), want[0], atol=2e-5, rtol=0)
        heads = _heads(got["full"])
        assert len(heads) == len(want)
        for i, (g, w) in enumerate(zip(heads, want)):
            assert g.shape == w.shape == (1, SIDE, SIDE, z, 3)
            np.testing.assert_allclose(g.numpy(), w, atol=2e-5, rtol=0, err_msg=f"head {i}")
        torch.testing.assert_close(got["main"], ranks[0]["main"], rtol=0, atol=0)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("key", sorted(LAYERS))
def test_sharded_layers_match_unsharded(spatial_run, n, key):
    """Each sharded form the two models do not reach, on Z slabs of 40
    planes (24/16, 16/8/8/8) gathered, against the same layer unsharded,
    fp32 1e-5: EvoNorm's plain S0 form and B0 in eval (group_std,
    instance_std), GroupNorm, InstanceNorm, the global max and mean pools
    (CBAM's channel gate), a half-pixel ×2 and an align-corners ×4 upsample,
    a dilation-10 conv (its halo passes the next slab) and an aligned
    stride-2 conv."""
    module, x = spatial_run["layers"][key]
    with torch.no_grad():
        want = module(torch.from_numpy(x).contiguous(memory_format=torch.channels_last_3d))
    for res in spatial_run["ranks"][n]:
        got = res["spatial"]["layers"][key]
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-6)


# -------------------------------------------------------------- the engine

def test_engine_member_forward_matches_jax(spatial_run):
    """The engine's spatial member forward on 2×2 (each row on one case,
    Z = 24: slabs 16/8) against the JAX engine's per-member eval function
    on a data×space mesh (its ``spatial_fn``): the fp32 sigmoid of the main
    head within 2e-5, the deep-supervision loss of the replicated heads
    within 1e-4 relative."""
    jcfg = JaxTrainConfig(**EVAL_CFG, wire="dense")
    jmodel = jax_get_model(MODELS["assp"])
    engine = JaxEngine(jcfg, jmodel, jlosses.make_criterion(jcfg),
                       mesh=make_mesh(jax.devices()[:4], data=2, space=2))
    member = spatial_run["member"]
    fn = engine._get_eval_fn(jmodel, member["x"].shape, use_tta=False, sliding=False,
                             with_target=True)
    probs, loss = fn(jax.tree_util.tree_map(jnp.asarray, spatial_run["variables"]["assp"]),
                     jnp.asarray(member["x"]), jnp.asarray(member["seg"]))
    for res in spatial_run["ranks"][2]:
        got = res["spatial"]["member"]
        np.testing.assert_allclose(got["probs"].numpy(), np.asarray(probs), atol=2e-5, rtol=0)
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-4)


@pytest.mark.parametrize("mode", sorted(ENGINE_MODES))
def test_engine_data_space_evaluate_matches_reference(spatial_run, mode, tmp_path):
    """Engine.evaluate on a 2×2 data×space topology: three cases striped
    over the two rows, each Z-sharded over its row (8 planes: one slab of
    8, one empty), one rank of the row counting and writing it, against
    the JAX Engine on a data×space mesh; and TTA, where the engine ignores
    the space axis as the JAX engine does (the 16 combos over the four
    local ranks), against the port's one-process evaluation (TTA's parallel
    path is held to the JAX engine in tests/test_torch_port_parallel.py).
    The loss within 1e-4 relative, Dice and HD95 within 1e-5 (1e-4 under
    TTA, where reordered sums may move a voxel at the threshold), every rank
    with the node's meters and rows, each case written once, labels equal
    on ≥ 99.9 % of voxels."""
    n_members, seeds, kw, parallel_mode = ENGINE_MODES[mode]
    report = JaxReport()
    if kw.get("use_tta"):
        cfg = TrainConfig(**EVAL_CFG)
        members = [_port_from(v, MODELS["assp"]).eval()
                   for v in spatial_run["members"][:n_members]]
        want = Engine(cfg, torch.device("cpu"), criterion=make_criterion(cfg)).evaluate(
            members, _Loader(spatial_run["batches"][mode]), 0, save_seg=True,
            output_path=str(tmp_path), report=report, **kw)
    else:
        jcfg = JaxTrainConfig(**EVAL_CFG, wire="dense")
        jengine = JaxEngine(jcfg, jax_get_model(MODELS["assp"]), jlosses.make_criterion(jcfg),
                            mesh=make_mesh(jax.devices()[:4], data=2, space=2))
        want = jengine.evaluate(spatial_run["members"][:n_members],
                                _Loader(spatial_run["batches"][mode]), 0, save_seg=True,
                                output_path=str(tmp_path), report=report, **kw)
    ids = sorted(f"case{s}" for s in seeds)
    tol = 1e-4 if kw.get("use_tta") else 1e-5
    ranks = spatial_run["ranks"][2]
    for r in ranks:
        got = r["engine_eval"][mode]
        assert got["parallel_mode"] == parallel_mode
        np.testing.assert_allclose(got["meters"]["loss"][0], want["loss"].avg, rtol=1e-4)
        assert got["meters"]["loss"][1] == len(seeds)
        for k in ["dice"] + METRICS:
            np.testing.assert_allclose(got["meters"][k][0], want[k].avg, atol=tol, rtol=0,
                                       err_msg=k)
        assert sorted(got["rows"]) == sorted(report.rows) == ids
        for pid, row in report.rows.items():
            np.testing.assert_allclose([got["rows"][pid][c] for c in row], list(row.values()),
                                       atol=tol, rtol=0, err_msg=pid)
    saved = [r["engine_eval"]["saved"][mode] for r in ranks]
    assert sorted(sum(saved, [])) == ids
    writers = {0, 2} if mode == "spatial" else {0}
    assert {i for i, s in enumerate(saved) if s} <= writers
    out = spatial_run["out"] / "engine" / mode
    for pid in ids:
        got_seg = read_nifti(str(out / f"{pid}.nii.gz")).data
        want_seg = read_nifti(str(tmp_path / f"{pid}.nii.gz")).data
        assert got_seg.shape == want_seg.shape == (36, 18, 9)
        assert (got_seg == want_seg).mean() >= 0.999


# ------------------------------------------------ in one process: the rules

@pytest.mark.parametrize("z,n,want", [(136, 2, [0, 72, 136]), (40, 4, [0, 16, 24, 32, 40]),
                                      (40, 2, [0, 24, 40]), (32, 4, [0, 8, 16, 24, 32]),
                                      (16, 4, [0, 8, 16, 16, 16])])
def test_slab_bounds(z, n, want):
    assert sp.slab_bounds(z, n) == want


@pytest.mark.parametrize("z,n", [(36, 2), (20, 4), (0, 2)])
def test_slab_bounds_raise(z, n):
    """A padded Z off the model's multiple of 8 (where the JAX forward
    fails too), or none, raises naming Z."""
    with pytest.raises(ValueError, match=f"Z = {z}"):
        sp.slab_bounds(z, n)


@pytest.mark.parametrize("name,layer", [("att_equiunet", "model"),
                                        ("equiunet_ref", "refunet"),
                                        ("segresnet", "model")])
def test_uncovered_layer_raises(name, layer):
    """A model holding a layer the slab context does not cover raises
    before any collective, naming the layer; so does a model in training
    mode."""
    model = get_model(_cfg(name, width=4)).eval()
    x = torch.zeros((1, SIDE, SIDE, 16, 4))
    with pytest.raises(ValueError, match=f"layer {layer}"):
        spatial_sharded_forward(model, x, Topology(space=2))
    with pytest.raises(ValueError, match="eval mode"):
        spatial_sharded_forward(get_model(_cfg("equiunet_assp_evo", width=4)), x,
                                Topology(space=2))


def test_slab_context_raises_with_grad():
    """The Z-sharded path is eval only, as the JAX package's."""
    conv = Conv3d(4, 4, 3)
    with sp.sharded(sp.Slab(None, 0, (0, 8), 4)), pytest.raises(RuntimeError, match="eval"):
        conv(torch.zeros((1, 4, 4, 4, 8)))


@pytest.mark.parametrize("n", [2, 4])
def test_evonorm_split_plain_matches_whole(n):
    """B2's split on the CPU (plain versions): the statistics of Z slabs
    (40 planes: 24/16, 16/8/8/8), merged by Chan's formula in fp64, equal
    the statistics of the whole volume to 1e-12 relative; with the whole
    volume's inv, the plain apply on each slab equals ``evonorm_s0_plain``
    (fp32, 1e-6: the inv is rounded from fp64, not computed in fp32)."""
    rng = np.random.default_rng(60 + n)
    x = torch.from_numpy((0.5 + 2 * rng.standard_normal((2, 6, 5, 40, 16))).astype(np.float32))
    gamma = torch.from_numpy(1 + 0.1 * rng.standard_normal(16).astype(np.float32))
    beta = torch.from_numpy(0.1 * rng.standard_normal(16).astype(np.float32))
    bounds = sp.slab_bounds(40, n)
    slabs = [x[:, :, :, a:b].contiguous() for a, b in zip(bounds, bounds[1:])]
    whole = evonorm_s0_stats(x, 8)
    merged = sp.chan_merge([evonorm_s0_stats(s, 8) for s in slabs])
    assert whole.dtype == merged.dtype == torch.float64 and whole.shape == (2, 8, 3)
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), rtol=1e-12, atol=0)
    inv = inv_std(merged)
    got = torch.cat([evonorm_s0_apply(s, inv, gamma, beta) for s in slabs], dim=3)
    np.testing.assert_allclose(got.numpy(), evonorm_s0_plain(x, gamma, beta).numpy(),
                               atol=1e-6, rtol=1e-6)
