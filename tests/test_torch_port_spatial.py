"""The port's spatial axis (``parallel/spatial.py``, the ``space`` rows of
``parallel/mesh.py``, ``parallel/distributed.py:halo_exchange`` /
``sharded_conv3d`` / ``spatial_sharded_forward``, the engine's data×space
evaluation and B2's split statistics) on the CPU, with real gloo ranks
(``tests/torch_parallel_worker.py``), against the JAX package on the same
numpy inputs and weights: its ``halo_exchange`` and ``sharded_conv3d``
under ``shard_map``, its GSPMD ``spatial_sharded_forward`` on meshes of
``space=2|4`` over the 8 CPU devices ``tests/conftest.py`` forces, and its
``Engine`` on a data×space mesh. Every ``--model`` name runs Z-sharded:
the reference's own networks at width 4, the MONAI-backed ones at their
fixed widths (``unet_tr`` as ViT of hidden 48 at 32³), each slab cut at the
model's downsampling factor. Two launches of four ranks (space rows of 2
and of 4), one torch thread a rank, every collective bounded by 60 s.
Volumes of at most 16×16×40, 24×24×40 for the RefUnet's empty slab
under ceil-mode pools of an odd size, 32×32×32 for ``unet_tr`` and
32×32×64 for nnunet."""

from concurrent.futures import ThreadPoolExecutor

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
from brats21_tpu_torch.learning.engine import Engine, forward_channels_last
from brats21_tpu_torch.learning.losses import make_criterion
from brats21_tpu_torch.models import get_model
from brats21_tpu_torch.models.assp_evo import EvoNorm3D
from brats21_tpu_torch.models.equiunet import ChannelGate, SpatialGate
from brats21_tpu_torch.models.layers import (BCNorm, Conv3d, ConvAWS3d, ConvTranspose3d,
                                             GroupNorm, InstanceNorm, Upsample,
                                             UpsampleNearest, WSConv3d)
from brats21_tpu_torch.models.unetr import UNETR
from brats21_tpu_torch.ops.kernels.evonorm import (evonorm_s0_apply, evonorm_s0_plain,
                                                   evonorm_s0_stats, inv_std)
from brats21_tpu_torch.parallel import spatial as sp
from brats21_tpu_torch.parallel.distributed import spatial_sharded_forward
from brats21_tpu_torch.parallel.mesh import Topology
from brats21_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_port_kernels import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_parallel import EVAL_CFG, METRICS, _case, _launch, _Loader
from test_torch_port_zoo import _cfg, _fill
from test_torch_port_zoo_monai import UNETR_SMALL

SIDE = 16
MODELS = {"assp": _cfg("equiunet_assp_evo", width=4),
          "equi": _cfg("equiunet", width=4),
          "equi_instance": _cfg("equiunet", "instance", width=4),
          # every other --model name: the reference's own networks at width 4,
          # the MONAI-backed ones at their fixed widths (unet_tr smaller)
          "equi_ref": _cfg("equiunet_ref", width=4),
          "att_equi": _cfg("att_equiunet", width=4),
          "assp_ref": _cfg("equiunet_assp_evo_ref", width=4),
          **{name: _cfg(name, width=4) for name in ("modified_unet", "att_unet", "r2unet",
                                                    "r2attunet")},
          "basic_unet": _cfg("basic_unet", "instance", width=4, act="leakyrelu"),
          "segresnet": _cfg("segresnet"),
          "segresnetvae": dict(_cfg("segresnetvae"), patch_size=[SIDE, SIDE, 32]),
          "highresnet": _cfg("highresnet", "batch"),
          "vnet": _cfg("vnet", act="elu"),
          "nnunet": _cfg("nnunet", "instance"),
          "unet_tr": dict(_cfg("unet_tr", "instance"), unetr=UNETR_SMALL),
          "equi_ref_x24": _cfg("equiunet_ref", width=4)}
# X and Y of a name's volumes: nnunet needs multiples of 32, unet_tr its img_size;
# equiunet_ref at 24, where the RefUnet's fourth ceil-mode pool takes X and Y
# from 3 to 2 (a floor pool would give 1)
SIDES = {"nnunet": 32, "unet_tr": 32, "equi_ref_x24": 24}
# (model, Z) a space size runs: uneven slabs (Z = 40: 24/16 on 2 ranks,
# 16/8/8/8 on 4, so 2/1/1/1 planes at level 4, where the ASPP's dilation-6
# halo and the bottom's dilation 2 pass the next slab), the JAX package's
# Z pad (30 → 32 on 4 ranks), fewer 8-plane blocks than ranks (16 on 4:
# 8/8/0/0, two ranks with empty slabs), and a padded Z its forward cannot
# take. Each other name at the smallest Z its factor gives two slabs: the
# RefUnet names (factor 16, Z a multiple of 8) at 40, a partial block on
# the last slab (32 + 8; 16/16/8/0); the factor-8 names at 24 (16/8;
# 8/8/8/0), the factor-16 ones at 32 (16/16; 16/16/0/0), nnunet at 64
# (32/32; 32/32/0/0), highresnet (factor 1) at 12 (6/6; 3/3/3/3, its
# dilation-4 halo passing the next slab)
ZOO = [("equi_ref", 40), ("att_equi", 24), ("assp_ref", 40), ("modified_unet", 24),
       ("att_unet", 24), ("r2unet", 24), ("r2attunet", 24), ("basic_unet", 32),
       ("segresnet", 24), ("segresnetvae", 32), ("highresnet", 12), ("vnet", 32),
       ("nnunet", 64), ("unet_tr", 32)]
# on 4 ranks, a RefUnet name whose empty slab (Z = 40: 16/16/8/0) pools X
# and Y of 3 under ceil mode, as its neighbours do
ZOO_EMPTY_CEIL = [("equi_ref_x24", 40)]
ZOO_CASES = set(ZOO + ZOO_EMPTY_CEIL)
FORWARDS = {2: [("assp", 40), ("equi", 40), ("equi_instance", 40)] + ZOO,
            4: [("assp", 40), ("equi", 40), ("assp", 30), ("assp", 16), ("equi", 16),
                ("assp", 36), ("equi", 36)] + ZOO + ZOO_EMPTY_CEIL}
# the zoo's heads against the JAX package's GSPMD forward, times the head's
# largest magnitude where that exceeds 1: the port's fp32 convs (oneDNN) sum
# in another order than XLA's: its one-process heads read up to 1.7e-5 of
# that scale from JAX's here (nnunet's deep heads; the other names
# 0.8-6.4e-6), its sharded heads up to 2.1e-5 (nnunet; the others up to 5.9e-6)
ZOO_JAX_ATOL = 5e-5
# halo cases: (X slabs, halo); X-sharded as the JAX package's default axis
HALOS = {2: [((4, 4), 1), ((4, 4), 3), ((5, 3), 4)],
         4: [((2, 2, 2, 2), 1), ((2, 2, 2, 2), 2), ((2, 2, 2, 2), 3), ((3, 1, 2, 2), 2)]}
CONV_KERNELS = (3, 5)
# single layers on Z-slabs of a 40-plane input, against the unsharded
# port: each sharded form the models do not reach, and the weight-
# standardised convs, which no model holds
LAYERS = {"evonorm_s0_plain_form": lambda: EvoNorm3D(8, efficient=False),
          "evonorm_b0": lambda: EvoNorm3D(8, version="B0"),
          "groupnorm": lambda: GroupNorm(8, 4),
          "instancenorm": lambda: InstanceNorm(8),
          "bcnorm": lambda: BCNorm(8),
          "channel_gate": lambda: ChannelGate(8, 4),
          "spatial_gate": lambda: SpatialGate("instance"),
          "upsample_half_pixel": lambda: Upsample(2, align_corners=False),
          "upsample_x4": lambda: Upsample(4, align_corners=True),
          "upsample_nearest_x2": lambda: UpsampleNearest(2),
          "conv_dilation_10": lambda: Conv3d(8, 6, 3, dilation=10),
          "conv_stride_2": lambda: Conv3d(8, 6, 2, stride=2, padding=0),
          "conv_transpose_2": lambda: ConvTranspose3d(8, 6),
          "wsconv_dilation_2": lambda: WSConv3d(8, 6, 3, dilation=2),
          "convaws_stride_2": lambda: ConvAWS3d(8, 6, 3, stride=2)}
MEMBER_Z = 24
ENGINE_MODES = {"spatial": (1, (3, 4, 5), {}, (True, False)),
                "spatial_tta": (1, (4,), {"use_tta": True}, (False, False)),
                "spatial_ref": (1, (3, 4, 5), {}, (True, False))}
# the mode's members' model (assp unless named)
ENGINE_MODELS = {"spatial_ref": "assp_ref"}


def _jax_model(name):
    cfg = MODELS[name]
    if "unetr" in cfg:
        from brats21_tpu.models.unetr import UNETR as JaxUNETR
        return JaxUNETR(num_classes=3, **cfg["unetr"])
    return jax_get_model(cfg)


def _shape(name, z=None):
    """A name's input volume ``[1, X, Y, Z, 4]`` (Z its init's unless
    given: the VAE's Linear layers take the patch, UNETR its img_size)."""
    side = SIDES.get(name, SIDE)
    cfg = MODELS[name]
    z = z or (cfg.get("patch_size") or cfg.get("unetr", {}).get("img_size") or [side] * 3)[2]
    return (1, side, side, z, 4)


def _variables(name, seed):
    """Numpy-seeded flax variables of ``name`` (``test_torch_port_zoo._fill``)."""
    return _fill(jax.eval_shape(_jax_model(name).init, jax.random.PRNGKey(0),
                                jax.ShapeDtypeStruct(_shape(name), jnp.float32)), seed)


def _port_from(variables, name):
    """The port's model of ``name`` with the flax ``variables``."""
    cfg = MODELS[name]
    model = UNETR(**cfg["unetr"]) if "unetr" in cfg else get_model(cfg)
    model.load_state_dict(state_dict_from_flax(
        variables["params"], cfg["model"], cfg["norm"], variables.get("batch_stats")),
        strict=True)
    return model


def _engine_members(name, seeds):
    """Members whose output convs (and a RefUnet's last) are ×20: few
    voxels near the threshold."""
    members = [_variables(name, s) for s in seeds]
    for v in members:
        convs = [v["params"]["out_conv"]]
        if "refunet" in v["params"]:
            convs.append(v["params"]["refunet"]["conv_d0"])
        for conv in convs:
            conv["Conv_0"]["kernel"] = conv["Conv_0"]["kernel"] * 20.0
    return members


def _flat(out):
    """(heads, auxiliary scalars) of a model output in either framework:
    logits, (logits, deeps), ([refined, logits], deeps) or (seg,
    {"vae_loss": s}), in that order."""
    if isinstance(out, dict):
        return [], [out["vae_loss"]]
    if isinstance(out, (tuple, list)):
        parts = [_flat(o) for o in out]
        return sum((h for h, _ in parts), []), sum((a for _, a in parts), [])
    return [out], []


@pytest.fixture(scope="module")
def spatial_run(tmp_path_factory):
    """Inputs, and each rank's results of one 4-rank launch a space size
    (rows of 2: two data rows, the engine on 2×2; one row of 4)."""
    rng = np.random.default_rng(51)
    variables = {name: _variables(name, 52 + i) for i, name in enumerate(MODELS)}
    state = {name: _port_from(v, name).state_dict() for name, v in variables.items()}
    xs = {(name, z): rng.standard_normal(_shape(name, z)).astype(np.float32)
          for name, z in sorted({f for fs in FORWARDS.values() for f in fs}
                                - set(ZOO_EMPTY_CEIL))}
    torch.manual_seed(53)
    layers = {k: (make().eval(), rng.standard_normal((1, 8, 6, 5, 40)).astype(np.float32))
              for k, make in LAYERS.items()}
    for module, _ in layers.values():          # affines off their identity
        if not isinstance(module, (torch.nn.Conv3d, torch.nn.ConvTranspose3d)):
            for p in module.parameters():
                p.data.copy_(1.0 + 0.2 * torch.randn_like(p))
    member = dict(x=rng.standard_normal((1, SIDE, SIDE, MEMBER_Z, 4)).astype(np.float32),
                  seg=(rng.random((1, SIDE, SIDE, MEMBER_Z, 3)) > 0.5).astype(np.float32))
    members = {"assp": _engine_members("assp", (56, 57)),
               "assp_ref": _engine_members("assp_ref", (58,))}
    batches = {mode: [_case(s) for s in m[1]] for mode, m in ENGINE_MODES.items()}
    halo_x = {n: rng.standard_normal((1, 2, 8, 3, 4)).astype(np.float32) for n in HALOS}
    conv_x = rng.standard_normal((1, 3, 8, 5, 6)).astype(np.float32)
    conv_w = {k: (rng.standard_normal((4, 3, k, k, k)) / k ** 1.5).astype(np.float32)
              for k in CONV_KERNELS}
    xs.update({(name, z): rng.standard_normal(_shape(name, z)).astype(np.float32)
               for name, z in ZOO_EMPTY_CEIL})
    out = tmp_path_factory.mktemp("spatial_run")

    def launch(n):
        job = dict(
            halo={f"{sizes}/{h}": (halo_x[n], h, list(sizes)) for sizes, h in HALOS[n]},
            conv={k: (conv_x, conv_w[k]) for k in CONV_KERNELS},
            layers=layers,
            forward={f"{name}/{z}": dict(cfg=MODELS[name], state_dict=state[name],
                                         x=xs[name, z], main=(name, z) not in ZOO_CASES)
                     for name, z in FORWARDS[n]})
        kinds = ["spatial"]
        if n == 2:
            job["member"] = dict(train_cfg=EVAL_CFG, cfg=MODELS["assp"],
                                 state_dict=state["assp"], **member)
            kinds.append("engine_eval")
        spec = {"kinds": kinds, "space": n, "spatial": job,
                "engine_eval": dict(train_cfg=EVAL_CFG, cfg=MODELS["assp"],
                                    members=[_port_from(v, "assp").state_dict()
                                             for v in members["assp"]],
                                    mode_members={
                                        m: (MODELS[name], [_port_from(v, name).state_dict()
                                                           for v in members[name]])
                                        for m, name in ENGINE_MODELS.items()},
                                    batches=batches, out=str(out / "engine"),
                                    modes={m: (k, kw, {})
                                           for m, (k, _, kw, _) in ENGINE_MODES.items()})}
        return _launch(spec, out / f"space{n}", nproc=4, timeout=240)

    # the zoo's references while the ranks run
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(lambda: {n: launch(n) for n in (2, 4)})
        refs = {(name, z): _zoo_reference(name, variables[name], xs[name, z])
                for name, z in sorted(ZOO_CASES)}
        ranks = ranks.result()
    return dict(ranks=ranks, variables=variables, xs=xs, layers=layers, member=member,
                members=members, batches=batches, halo_x=halo_x, conv_x=conv_x,
                conv_w=conv_w, out=out, refs=refs)


def _zoo_reference(name, variables, x):
    """(heads, aux scalars) of ``x`` through the JAX package's GSPMD
    ``spatial_sharded_forward`` on a space mesh of 2 and through the port's
    model in one process, fp32, every head."""
    jmodel = _jax_model(name)
    jax_out = jax_spatial_forward(
        make_mesh(jax.devices()[:2], space=2),
        lambda v, inp: jmodel.apply(v, inp, deterministic=True),
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x), full_outputs=True)
    with torch.no_grad():
        port_out = forward_channels_last(_port_from(variables, name).eval(),
                                         torch.from_numpy(x), with_deep=True)
    return {side: ([np.asarray(h) for h in heads], [float(a) for a in aux])
            for side, (heads, aux) in (("jax", _flat(jax_out)), ("port", _flat(port_out)))}


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
    skip's concatenation and the port raises ValueError naming Z.

    Every other --model name (:data:`ZOO`, at its own slab alignment: the
    RefUnet names with a partial block on the last slab under their
    ceil-mode pools, empty slabs on 4 ranks, :data:`ZOO_EMPTY_CEIL`'s empty
    slab under ceil-mode pools of an odd X and Y) runs its every head (the
    deep heads, the RefUnet's refined and plain logits, SegResNetVAE's
    ``vae_loss``) within 2e-5 of the port's own forward in one process,
    times the head's largest magnitude where that exceeds 1 (the zoo's heads
    reach 3-10, and fp32 sums in another order move them by that share);
    and within :data:`ZOO_JAX_ATOL` of the JAX package's GSPMD forward on a
    space mesh of 2, times the same, as the one-process port must be too."""
    x = spatial_run["xs"][name, z]
    ranks = [res["spatial"]["forward"][f"{name}/{z}"] for res in spatial_run["ranks"][n]]
    if (name, z) in ZOO_CASES:
        ref = spatial_run["refs"][name, z]
        (want, want_aux), (one, one_aux) = ref["jax"], ref["port"]
        for i, (w, o) in enumerate([*zip(want, one), *zip(want_aux, one_aux)]):
            w, o = np.asarray(w, dtype=np.float32), np.asarray(o, dtype=np.float32)
            np.testing.assert_allclose(o, w, atol=ZOO_JAX_ATOL * max(1.0, float(np.abs(w).max())),
                                       rtol=0, err_msg=f"one process, output {i}")
        for got in ranks:
            heads, aux = _flat(got["full"])
            assert len(heads) == len(want) == len(one) and len(aux) == len(want_aux)
            for i, (g, w, o) in enumerate([*zip(heads, want, one),
                                           *zip(aux, want_aux, one_aux)]):
                g, w, o = (np.asarray(v, dtype=np.float32) for v in (g, w, o))
                assert g.shape == w.shape == o.shape
                assert g.ndim == 0 or g.shape == (*x.shape[:4], 3)
                scale = max(1.0, float(np.abs(w).max()))
                np.testing.assert_allclose(g, o, atol=2e-5 * scale, rtol=0, err_msg=f"output {i}")
                np.testing.assert_allclose(g, w, atol=ZOO_JAX_ATOL * scale, rtol=0,
                                           err_msg=f"output {i}")
            torch.testing.assert_close(heads[0], _flat(ranks[0]["full"])[0][0], rtol=0, atol=0)
        return
    variables = jax.tree_util.tree_map(jnp.asarray, spatial_run["variables"][name])
    jmodel = _jax_model(name)

    def apply(v, inp):
        return jmodel.apply(v, inp, deterministic=True)

    if z % 8 and (z + (-z) % n) % 8:
        with pytest.raises(TypeError, match="concatenate"):
            jax_spatial_forward(_space_mesh(n), apply, variables, jnp.asarray(x),
                                full_outputs=True)
        for got in ranks:
            assert "Z = 36" in got["error"] and "multiple of 8" in got["error"]
        return
    want, _ = _flat(jax_spatial_forward(
        _space_mesh(n), apply, variables, jnp.asarray(x), full_outputs=True))
    for got in ranks:
        np.testing.assert_allclose(got["main"].numpy(), np.asarray(want[0]), atol=2e-5, rtol=0)
        heads, _ = _flat(got["full"])
        assert len(heads) == len(want)
        for i, (g, w) in enumerate(zip(heads, want)):
            assert g.shape == w.shape == (1, SIDE, SIDE, z, 3)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=0,
                                       err_msg=f"head {i}")
        torch.testing.assert_close(got["main"], ranks[0]["main"], rtol=0, atol=0)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("key", sorted(LAYERS))
def test_sharded_layers_match_unsharded(spatial_run, n, key):
    """Single sharded forms on Z slabs of 40 planes (24/16, 16/8/8/8)
    gathered, against the same layer unsharded, fp32 1e-5: EvoNorm's plain
    S0 form and B0 in eval (group_std, instance_std), GroupNorm,
    InstanceNorm, BCNorm, the global max and mean pools (CBAM's channel
    gate), CBAM's spatial gate (7³ conv, one-channel norm), a half-pixel ×2,
    an align-corners ×4 and a nearest ×2 upsample, a dilation-10 conv (its
    halo passes the next slab), an aligned stride-2 conv, a 2³/s2
    transposed conv, and the weight-standardised convs (dilated, strided),
    which no model holds."""
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
    8, one empty; 16 for equiunet_assp_evo_ref, whose RefUnet aligns its
    slabs at 16: again one slab and one empty), one rank of the row
    counting and writing it, against the JAX Engine on a data×space mesh;
    and TTA, where the engine ignores
    the space axis as the JAX engine does (the 16 combos over the four
    local ranks), against the port's one-process evaluation (TTA's parallel
    path is held to the JAX engine in tests/test_torch_port_parallel.py).
    The loss within 1e-4 relative, Dice and HD95 within 1e-5 (1e-4 under
    TTA, where reordered sums may move a voxel at the threshold), every rank
    with the node's meters and rows, each case written once, labels equal
    on ≥ 99.9 % of voxels."""
    n_members, seeds, kw, parallel_mode = ENGINE_MODES[mode]
    name = ENGINE_MODELS.get(mode, "assp")
    report = JaxReport()
    if kw.get("use_tta"):
        cfg = TrainConfig(**EVAL_CFG)
        members = [_port_from(v, name).eval()
                   for v in spatial_run["members"][name][:n_members]]
        want = Engine(cfg, torch.device("cpu"), criterion=make_criterion(cfg)).evaluate(
            members, _Loader(spatial_run["batches"][mode]), 0, save_seg=True,
            output_path=str(tmp_path), report=report, **kw)
    else:
        jcfg = JaxTrainConfig(**EVAL_CFG, wire="dense")
        jengine = JaxEngine(jcfg, jax_get_model(MODELS[name]), jlosses.make_criterion(jcfg),
                            mesh=make_mesh(jax.devices()[:4], data=2, space=2))
        want = jengine.evaluate(spatial_run["members"][name][:n_members],
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
    writers = {0, 2} if parallel_mode[0] else {0}
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


@pytest.mark.parametrize("z,n,factor,multiple,want", [
    (136, 2, 16, 8, [0, 80, 136]), (40, 2, 16, 8, [0, 32, 40]),
    (40, 4, 16, 8, [0, 16, 32, 40, 40]), (64, 4, 32, 32, [0, 32, 64, 64, 64]),
    (12, 4, 1, 1, [0, 3, 6, 9, 12])])
def test_slab_bounds_at_a_model_factor(z, n, factor, multiple, want):
    """Cut at the model's factor, the last non-empty slab holding a partial
    block where Z is a multiple of what the model takes but not of the
    factor (a RefUnet's 136: 80 + 56)."""
    assert sp.slab_bounds(z, n, factor, multiple) == want


@pytest.mark.parametrize("rank,n,depth,want", [
    (1, 56, 200, [80, 56]), (1, 28, 100, [40, 28]), (1, 7, 25, [10, 7]), (1, 4, 13, [5, 4]),
    (0, 5, 13, [5, 4]), (1, 112, 400, [160, 112])])
def test_slab_levels_follow_the_pooling_chain(rank, n, depth, want):
    """Each level's slabs of the served case's padded Z (136 on 2 ranks at
    16: 80 + 56) under a RefUnet's ceil-mode pools, found from a slab's
    planes and its D (200 → 100 → 50 → 25 → 13), and after a ×2 resize."""
    slab = sp.Slab(None, rank, (0, 80, 136), 200, 16)
    assert slab.sizes_at(n, depth)[1] == want


@pytest.mark.parametrize("z,n", [(36, 2), (20, 4), (0, 2)])
def test_slab_bounds_raise(z, n):
    """A padded Z off the model's multiple of 8 (where the JAX forward
    fails too), or none, raises naming Z."""
    with pytest.raises(ValueError, match=f"Z = {z}"):
        sp.slab_bounds(z, n)


class _Wrapped(torch.nn.Module):
    """A model the slab context does not know, around a covered one."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x, with_deep=True):
        return self.inner(x, with_deep)


@pytest.mark.parametrize("name,layer", [("att_equiunet", "model"),
                                        ("equiunet_ref", "refunet"),
                                        ("segresnet", "model")])
def test_uncovered_layer_raises(name, layer):
    """A model holding a layer the slab context does not cover raises
    before any collective, naming the layer: every --model name is covered,
    so an unknown wrapper around one (``model``) or a bare
    ``torch.nn.Conv3d`` in place of its RefUnet's first conv
    (``refunet.conv0``); so does a model in training mode."""
    model = get_model(_cfg(name, width=4)).eval()
    if layer == "model":
        model = _Wrapped(model).eval()
    else:
        sp.check_covered(model)
        getattr(model, layer).conv0 = torch.nn.Conv3d(3, 4, 3, padding=1)
    x = torch.zeros((1, SIDE, SIDE, 16, 4))
    with pytest.raises(ValueError, match=f"layer {layer}"):
        spatial_sharded_forward(model, x, Topology(space=2))
    with pytest.raises(ValueError, match="eval mode"):
        spatial_sharded_forward(get_model(_cfg("equiunet_assp_evo", width=4)), x,
                                Topology(space=2))


@pytest.mark.parametrize("name", sorted(
    ["equiunet", "equiunet_ref", "att_equiunet", "equiunet_assp_evo", "equiunet_assp_evocor",
     "equiunet_assp_evo_ref", "modified_unet", "att_unet", "r2unet", "r2attunet",
     "basic_unet", "segresnet", "segresnetvae", "highresnet", "vnet", "nnunet", "unet_tr"]))
def test_every_model_name_is_covered(name):
    """``check_covered`` accepts the model ``get_model`` builds for each of
    the 17 --model names (every --norm the family takes: BCNorm and
    BatchNorm too)."""
    for norm in ("group", "bcn", "batch") if name in ("modified_unet", "r2attunet") else (
            "group",):
        cfg = dict(_cfg(name, norm, width=4), patch_size=[32, 32, 32])
        model = UNETR(**UNETR_SMALL) if name == "unet_tr" else get_model(cfg)
        sp.check_covered(model)


def test_slab_context_raises_with_grad():
    """The Z-sharded path is eval only, as the JAX package's."""
    conv = Conv3d(4, 4, 3)
    with sp.sharded(sp.Slab(None, 0, (0, 8), 4, sp.BLOCK)), pytest.raises(RuntimeError, match="eval"):
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
