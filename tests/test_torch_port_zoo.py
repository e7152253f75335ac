"""The port's model zoo, first part, against the JAX package on the CPU:
the eight networks of the equiunet lines and the unet family (forward and
deep heads, fp32, atol = rtol = 1e-3), their weights carried both ways
(``state_dict_from_flax`` → strict ``load_state_dict``; the port's
``.pth`` → the JAX package's importer), the bf16 dtype flow
at every block output, BatchNorm's running statistics in training, every
norm and activation, WSConv3d/ConvAWS3d, EvoNorm's B0 and other S0 forms,
the pools and resizes, and the conv kernel's launches a forward. Widths
≤ 8, volumes ≤ 16³, the same numpy-seeded weights and inputs on both
sides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brats21_tpu.models import get_model as jax_get_model
from brats21_tpu.models import layers as jl
from brats21_tpu.utils.import_torch import load_torch_state_dict, state_dict_to_flax
from brats21_tpu_torch.models import get_model
from brats21_tpu_torch.models import layers as pl
from brats21_tpu_torch.ops.kernels import conv3d
from brats21_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_port_kernels import one_torch_thread  # noqa: F401  (autouse)

NAMES = ["equiunet", "equiunet_ref", "att_equiunet", "equiunet_assp_evo_ref",
         "modified_unet", "att_unet", "r2unet", "r2attunet"]
# the names the JAX package's importer takes (equiunet_assp_evo_ref has no rule)
IMPORTABLE = [n for n in NAMES if n != "equiunet_assp_evo_ref"]
NORMS = ["group", "batch", "instance", "bcn", "none"]
SIDE = 16


def _cfg(name, norm="group", width=8, act="relu"):
    return {"model": name, "width": width, "norm": norm, "act": act, "remat_mode": "none"}


def _random_variables(model, seed, side=SIDE):
    """Flax variables of ``model`` from numpy: kernels at 1/sqrt(fan_in),
    norm scales and running variances near 1, biases and running means
    near 0 (shapes from ``eval_shape``, no init run)."""
    return _fill(jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                jax.ShapeDtypeStruct((1, side, side, side, 4), jnp.float32)),
                 seed)


def _fill(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        if leaf == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if leaf in ("scale", "gamma", "var", "v", "estbn_scale", "running_var"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_from(variables, cfg):
    model = get_model(cfg)
    model.load_state_dict(state_dict_from_flax(
        variables["params"], cfg["model"], cfg["norm"], variables.get("batch_stats")),
        strict=True)
    return model


def _ncdhw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 4, 1, 2, 3)


def _heads(out):
    """Every head of a model output, the refinement pair's two first."""
    main, deeps = out
    return (list(main) if isinstance(main, (list, tuple)) else [main]) + list(deeps)


def _assert_heads_close(got, want, tol=1e-3):
    got, want = _heads(got), _heads(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.permute(0, 2, 3, 4, 1).detach().numpy(), np.asarray(w),
                                   atol=tol, rtol=tol, err_msg=f"head {i}")


# ------------------------------------------------------------ whole models

@pytest.mark.parametrize("name", NAMES)
def test_forward_and_deep_heads_match_jax(name, tmp_path):
    """fp32 forward and every deep head of each model within 1e-3 of the
    JAX model on the same weights (measured ≤ 2e-5); the port's ``.pth``
    imports into the JAX package leaf for leaf, running statistics
    included, through the ``load_torch_state_dict`` and
    ``state_dict_to_flax`` that ``import_checkpoint`` composes (with the
    ``eval_shape`` template for its ``model.init``, which takes 10-40 s
    of XLA compiles a name on the CPU)."""
    cfg = _cfg(name)
    jmodel = jax_get_model(cfg)
    variables = _random_variables(jmodel, seed=NAMES.index(name))
    model = _port_from(variables, cfg).eval()
    x = np.random.default_rng(100).standard_normal((1, SIDE, SIDE, SIDE, 4)).astype(np.float32)
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = model(_ncdhw(x))
        main_only = model(_ncdhw(x), with_deep=False)
    _assert_heads_close(got, want)
    assert main_only[1] == []
    if name not in IMPORTABLE:
        return
    pth = tmp_path / "best_model.pth"
    torch.save({"epoch": 1, "model": model.state_dict()}, pth)
    sd = load_torch_state_dict(str(pth))
    if "batch_stats" in variables:
        imported = dict(zip(("params", "batch_stats"), state_dict_to_flax(
            sd, name, variables["params"], variables["batch_stats"], norm="group")))
    else:
        imported = {"params": state_dict_to_flax(sd, name, variables["params"], norm="group")}
    assert sorted(imported) == sorted(variables)
    for tree in variables:
        want_leaves = dict(jax.tree_util.tree_leaves_with_path(variables[tree]))
        got_leaves = dict(jax.tree_util.tree_leaves_with_path(imported[tree]))
        assert set(got_leaves) == set(want_leaves)
        for path, leaf in want_leaves.items():
            np.testing.assert_array_equal(np.asarray(got_leaves[path]), leaf)


def test_unet_matches_jax():
    """The 2020 line's plain Unet (halved encoder mid-widths, no CLI name in
    either package) against the JAX class, fp32, within 1e-3."""
    from brats21_tpu.models.equiunet import Unet as JUnet
    from brats21_tpu_torch.models.equiunet import Unet
    jmodel = JUnet([8, 16, 32, 64], deep_supervision=True)
    variables = _random_variables(jmodel, seed=31)
    model = Unet([8, 16, 32, 64], deep_supervision=True).eval()
    model.load_state_dict(state_dict_from_flax(variables["params"], "equiunet"), strict=True)
    x = np.random.default_rng(32).standard_normal((1, SIDE, SIDE, SIDE, 4)).astype(np.float32)
    with torch.inference_mode():
        got = model(_ncdhw(x))
    _assert_heads_close(got, jax.jit(jmodel.apply)(variables, jnp.asarray(x)))


@pytest.mark.parametrize("name,norm", [(n, "group") for n in NAMES]
                         + [("equiunet", "batch"), ("att_equiunet", "batch"),
                            ("att_unet", "batch"), ("r2attunet", "none")])
def test_bf16_dtype_flow_matches_jax(name, norm):
    """With a bf16 input, every block's output has the JAX model's dtype
    (flax's intermediates, traced with ``eval_shape``): bf16 through the
    GroupNorm models, fp32 after any BatchNorm (``--norm batch``, and the
    unet family's attention gates, whose ``x · psi`` promotes the decoder),
    as ``nn.BatchNorm(dtype=float32)`` returns fp32."""
    cfg = _cfg(name, norm)
    jmodel = jax_get_model(cfg)
    variables = _random_variables(jmodel, seed=1)
    x = jax.ShapeDtypeStruct((1, SIDE, SIDE, SIDE, 4), jnp.bfloat16)
    _, state = jax.eval_shape(
        lambda v, x: jmodel.apply(v, x, capture_intermediates=True,
                                  mutable=["intermediates"]), variables, x)
    inter = state["intermediates"]
    model = _port_from(variables, cfg).eval()
    got = {}
    for child, module in model.named_children():
        module.register_forward_hook(
            lambda m, i, o, child=child: got.__setitem__(child, o.dtype))
    with torch.inference_mode():
        out = model(torch.zeros((1, 4, SIDE, SIDE, SIDE), dtype=torch.bfloat16))
    # flax names of the port's blocks: the recurrent models' RRCNNn are
    # flax's Convn, AttEquiUnet's Sequential bottom_2 ends in bottom_2_cbam
    rename = {"bottom_2": "bottom_2_cbam"} if name == "att_equiunet" else {}
    checked = 0
    for child, dtype in got.items():
        key = rename.get(child, child.replace("Up_RRCNN", "Up_conv").replace("RRCNN", "Conv"))
        if key.startswith("deep"):
            want = inter[key]["__call__"][0].dtype
        elif key in inter:
            want = inter[key]["__call__"][0].dtype
        else:
            continue
        assert str(dtype).split(".")[-1] == str(want), f"{child}: {dtype} vs {want}"
        checked += 1
    assert checked >= 10
    want_main = inter["__call__"][0][0]
    want_main = want_main[0] if isinstance(want_main, (list, tuple)) else want_main
    got_main = out[0][0] if isinstance(out[0], list) else out[0]
    assert str(got_main.dtype).split(".")[-1] == str(want_main.dtype)


@pytest.mark.parametrize("name", ["equiunet", "att_unet"])
def test_batchnorm_running_stats_in_training_match_jax(name):
    """``--norm batch`` in training (the JAX train step's mutable
    ``batch_stats``): the outputs within 1e-3, every running mean and
    variance within 1e-5 of flax's (biased batch variance, momentum 0.9);
    the attention gates' statistics stay as they were on both sides."""
    cfg = _cfg(name, "batch")
    jmodel = jax_get_model(cfg)
    variables = _random_variables(jmodel, seed=7)
    model = _port_from(variables, cfg).train()
    x = np.random.default_rng(8).standard_normal((2, SIDE, SIDE, SIDE, 4)).astype(np.float32)
    want, mutated = jax.jit(lambda v, x: jmodel.apply(v, x, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(_ncdhw(x))
    _assert_heads_close(got, want)
    after = state_dict_from_flax(variables["params"], name, "batch",
                                 jax.tree_util.tree_map(np.asarray, mutated["batch_stats"]))
    before = state_dict_from_flax(variables["params"], name, "batch", variables["batch_stats"])
    moved = 0
    for key, value in model.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(value.numpy(), after[key].numpy(), atol=1e-5, rtol=0,
                                       err_msg=key)
            frozen = key.startswith("Att")
            assert torch.equal(value, before[key]) == frozen, key
            moved += not frozen
    assert moved >= 20


def test_conv_kernel_launches_per_forward(monkeypatch):
    """The 3³ stride-1 dilation-1 convs go through the conv kernel's
    wrapper (on the CPU its plain version), the rest to ``F.conv3d``:
    15 a forward for Model 1 (8 encoder, ``bottom_2``, 6 decoder; the
    dilated ``bottom`` stays off), 26 with its RefUnet, 25 for
    EquiUnetASSPEvo's refinement variant, 17 for the plain and attention
    unets and 45 for the recurrent ones (each shared conv three times)."""
    calls = []
    plain = conv3d.conv3x3x3_plain
    monkeypatch.setattr(conv3d, "conv3x3x3_plain",
                        lambda x, w, b: calls.append(tuple(w.shape)) or plain(x, w, b))
    want = dict(equiunet=15, equiunet_ref=26, att_equiunet=15, equiunet_assp_evo_ref=25,
                modified_unet=17, att_unet=17, r2unet=45, r2attunet=45)
    for name, n in want.items():
        calls.clear()
        with torch.inference_mode():
            get_model(_cfg(name, width=4)).eval()(torch.zeros((1, 4, 8, 8, 8)),
                                                  with_deep=False)
        assert len(calls) == n, name
        if name.endswith("_ref"):
            # RefUnet's conv_d0: C_out = 3
            assert calls[-1] == (3, 3, 3, 4, 3)


@pytest.mark.parametrize("name", NAMES)
def test_get_model_builds_every_norm_and_act(name):
    """Each name builds at every ``--norm`` (and runs a 16³ forward) and
    every ``--act``; the unet family takes no dropout, the 2020 line's is
    element-wise."""
    for norm in NORMS:
        model = get_model(_cfg(name, norm, width=8))
        with torch.inference_mode():
            heads = _heads(model.eval()(torch.randn((1, 4, SIDE, SIDE, SIDE))))
        assert all(h.shape == (1, 3, SIDE, SIDE, SIDE) and torch.isfinite(h).all()
                   for h in heads)
    for act in pl._ACTS:
        get_model(_cfg(name, act=act, width=4))
    dropped = get_model({**_cfg(name), "dropout": 0.3})
    rates = {m.rate for m in dropped.modules() if isinstance(m, pl.Dropout)}
    if name in ("modified_unet", "att_unet", "r2unet", "r2attunet"):
        assert rates <= {0.0}
    elif name != "equiunet_assp_evo_ref":
        assert rates == {0.3}
        assert not any(m.channel_wise for m in dropped.modules() if isinstance(m, pl.Dropout))


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("norm,mode", [("group", "eval"), ("instance", "eval"),
                                       ("batch", "eval"), ("batch", "train"),
                                       ("bcn", "eval"), ("none", "eval")])
def test_norms_match_jax(norm, mode):
    """ConvBnRelu (conv3x3 → norm → act) with each norm against the JAX
    block, fp32, randomised affines and running statistics: within 1e-5;
    in train mode BatchNorm's moved statistics too. Without a norm the
    conv keeps its bias."""
    from brats21_tpu.models.equiunet import ConvBnRelu as JConvBnRelu
    from brats21_tpu_torch.models.equiunet import ConvBnRelu
    x = np.random.default_rng(3).standard_normal((2, 6, 5, 7, 8)).astype(np.float32)
    jblock = JConvBnRelu(16, "relu", norm)
    variables = _fill(jax.eval_shape(jblock.init, jax.random.PRNGKey(0), jnp.asarray(x)), 4)
    block = ConvBnRelu(8, 16, "relu", norm)
    sd = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        parts = [str(p.key) for p in path if str(p.key) not in ("params", "batch_stats",
                                                                 "BatchNorm_0", "Conv_0")]
        key = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
               "var": "running_var", "estbn_scale": "bn.weight",
               "estbn_bias": "bn.bias"}[parts[-1]]
        sd[".".join(parts[:-1] + [key])] = torch.from_numpy(
            leaf.transpose(4, 3, 0, 1, 2) if parts[-1] == "kernel" else leaf)
    if norm == "batch":
        sd["bn.num_batches_tracked"] = torch.tensor(0)
    block.load_state_dict(sd, strict=True)
    assert (block.conv.bias is None) == (norm != "none")
    if mode == "train":
        want, mutated = jblock.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        block.train()
    else:
        want = jblock.apply(variables, jnp.asarray(x))
        block.eval()
    with torch.no_grad():
        got = block(_ncdhw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    if mode == "train":
        stats = mutated["batch_stats"]["bn"]["BatchNorm_0"]
        np.testing.assert_allclose(block.bn.running_mean.numpy(), stats["mean"], atol=1e-6)
        np.testing.assert_allclose(block.bn.running_var.numpy(), stats["var"], atol=1e-6)


@pytest.mark.parametrize("act", sorted(jl._ACTS))
def test_activations_match_jax(act):
    x = 3.0 * np.random.default_rng(5).standard_normal((2, 3, 4, 5, 6)).astype(np.float32)
    want = np.asarray(jl.get_act(act)(jnp.asarray(x)))
    got = pl.get_act(act)(_ncdhw(x)).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("cls", ["WSConv3d", "ConvAWS3d"])
def test_weight_standardised_convs_match_jax(cls):
    x = np.random.default_rng(6).standard_normal((1, 7, 6, 5, 4)).astype(np.float32)
    jconv = getattr(jl, cls)(6, 3, dilation=2)
    variables = jax.eval_shape(jconv.init, jax.random.PRNGKey(1), jnp.asarray(x))
    if "buffers" in variables:
        variables = {"buffers": {"weight_gamma": np.ones(6, np.float32),
                                 "weight_beta": np.zeros(6, np.float32)}}
    rng = np.random.default_rng(7)
    kernel = (rng.standard_normal((3, 3, 3, 4, 6)) + 0.3).astype(np.float32)
    bias = (0.1 * rng.standard_normal(6)).astype(np.float32)
    variables = {**variables, "params": {"kernel": kernel, "bias": bias}}
    conv = getattr(pl, cls)(4, 6, 3, dilation=2)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(4, 3, 0, 1, 2)))
        conv.bias.copy_(torch.from_numpy(bias))
        got = conv(_ncdhw(x))
    want = jconv.apply(variables, jnp.asarray(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("form", ["B0-train", "B0-eval", "S0-v", "S0-linear",
                                  "S0-no-affine", "B0-linear"])
def test_evonorm_forms_match_jax(form):
    """EvoNorm3D's forms off the model's path, against the JAX layer: B0
    in training (the biased batch variance, its running_var moved with
    momentum 0.9) and in eval, S0 with the non-efficient ``v``, and
    ``non_linear=False``, each within 1e-5. ``affine=False``, where the JAX
    layer raises, equals the JAX layer at the identity affine."""
    from brats21_tpu.models.assp_evo import EvoNorm3D as JEvo
    from brats21_tpu_torch.models.assp_evo import EvoNorm3D
    version, kind = form.split("-", 1)
    kw = dict(version=version, efficient=kind != "v",
              non_linear=kind not in ("linear",), affine=kind != "no-affine")
    jkw = {**kw, "affine": True}
    x = (0.5 + np.random.default_rng(9).standard_normal((2, 5, 6, 4, 16))).astype(np.float32)
    jevo = JEvo(**jkw)
    variables = jevo.init(jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(10)
    if kind != "no-affine":
        variables = {**variables, "params": {
            k: (v + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in variables["params"].items()}}
    if "batch_stats" in variables:
        variables["batch_stats"] = {"running_var": (
            1.0 + 0.3 * rng.random((1, 1, 1, 1, 16))).astype(np.float32)}
    evo = EvoNorm3D(16, **kw)
    with torch.no_grad():
        for k, v in variables["params"].items():
            getattr(evo, k).copy_(torch.from_numpy(np.asarray(v)).reshape(1, -1, 1, 1, 1))
        if "batch_stats" in variables:
            evo.running_var.copy_(torch.from_numpy(
                variables["batch_stats"]["running_var"]).reshape(1, -1, 1, 1, 1))
    train = kind == "train"
    evo.train(train)
    if train:
        want, mutated = jevo.apply(variables, jnp.asarray(x), training=True,
                                   mutable=["batch_stats"])
    else:
        want = jevo.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = evo(_ncdhw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    if train:
        np.testing.assert_allclose(evo.running_var.reshape(-1).numpy(),
                                   np.asarray(mutated["batch_stats"]["running_var"]).ravel(),
                                   atol=1e-6)


def test_pools_resizes_and_dropout_match_jax():
    """Ceil-mode max pool on odd sizes (down to 1), average pool on sizes
    the window does not divide, the global max pool, an explicit-size
    trilinear resize, nearest ×2; and channel-wise dropout zeroing whole
    (sample, channel) maps at rate p with the survivors scaled by 1/(1−p)."""
    from brats21_tpu.models.unet_family import upsample_nearest as jnearest
    from brats21_tpu_torch.models.unet_family import upsample_nearest
    rng = np.random.default_rng(11)
    for shape in [(1, 5, 3, 1, 4), (2, 4, 7, 6, 3)]:
        x = rng.standard_normal(shape).astype(np.float32)
        for got, want in [
                (pl.max_pool3d(_ncdhw(x), ceil_mode=True), jl.max_pool3d(jnp.asarray(x),
                                                                        ceil_mode=True)),
                (pl.global_max_pool(_ncdhw(x))[:, :, None, None, None],
                 jl.global_max_pool(jnp.asarray(x))[:, None, None, None, :]),
                (pl.resize_trilinear(_ncdhw(x), (7, 4, 3)),
                 jl.resize_trilinear(jnp.asarray(x), (7, 4, 3))),
                (upsample_nearest(_ncdhw(x)), jnearest(jnp.asarray(x)))]:
            np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(want),
                                       atol=1e-6, rtol=1e-6)
    x = rng.standard_normal((1, 7, 6, 5, 2)).astype(np.float32)
    np.testing.assert_allclose(pl.avg_pool3d(_ncdhw(x)).permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(jl.avg_pool3d(jnp.asarray(x))), atol=1e-6)
    drop = pl.Dropout(0.5, channel_wise=True).train()
    y = drop(torch.ones((4, 32, 3, 3, 3)))
    per_map = y.reshape(4, 32, -1)
    assert ((per_map == 0).all(-1) | (per_map == 2.0).all(-1)).all()
    assert 0 < (per_map == 0).all(-1).sum() < 128
    assert torch.equal(drop.eval()(torch.ones(2, 3, 2, 2, 2)), torch.ones(2, 3, 2, 2, 2))


def test_inits_follow_the_reference():
    """kaiming_normal_fan_out's std is sqrt(2 / fan_out) with fan_out =
    C_out · k³, torch_default_conv's variance 1 / (3 · fan_in); a Conv3d
    with ``kernel_init`` starts with a zero bias, as flax's does; every
    name of ``init_by_name`` initialises and an unknown one raises."""
    torch.manual_seed(0)
    w = pl.kaiming_normal_fan_out(torch.empty(64, 32, 3, 3, 3))
    np.testing.assert_allclose(float(w.std()), np.sqrt(2 / (64 * 27)), rtol=0.02)
    w = pl.torch_default_conv(torch.empty(64, 32, 3, 3, 3))
    np.testing.assert_allclose(float(w.var()), 1 / (3 * 32 * 27), rtol=0.03)
    assert torch.count_nonzero(pl.Conv3d(4, 8, kernel_init=pl.kaiming_normal_fan_out).bias) == 0
    for name in ("normal", "xavier", "kaiming", "orthogonal", "torch_default"):
        assert torch.isfinite(pl.init_by_name(name)(torch.empty(8, 4, 3, 3, 3))).all()
    with pytest.raises(NotImplementedError):
        pl.init_by_name("nope")
