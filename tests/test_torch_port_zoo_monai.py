"""The port's model zoo, second part (the MONAI-backed names), against the
JAX package on the CPU: each of the seven networks' forward (nnunet's deep
heads, segresnetvae's ``(seg, vae_loss)``) in fp32 within atol = rtol =
1e-3 (the JAX package's whole-model tolerance,
``tests/test_full_model_parity.py:113``) from numpy-seeded flax weights
carried by ``state_dict_from_flax`` and loaded strictly; a reference-format
``.pth`` from the MONAI replicas of ``tests/test_import_zoo.py`` loaded
strictly through ``load_reference_pth`` and held to the JAX package's
import of the same file (nnunet's ``skip_layers`` duplicates, BatchNorm
running statistics, affine-less instance norms, segresnetvae's shared
decoder); the transposed conv's flip, exact GELU, ``upsample`` with
``align_corners=False``, VNet's train-mode dropout against
``model_uses_rng``, the auxiliary-loss branch of the deep-supervision loss
and the conv kernel's launches a forward. Small widths (``basic_unet`` w4,
``unet_tr`` built with hidden 48, 4 heads, MLP 96, feature size 8 at 32³;
the fixed-width nets at 16-32³) and ``eval_shape`` templates in place of
``model.init``."""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brats21_tpu.learning.train_state import model_uses_rng as jax_model_uses_rng
from brats21_tpu.models import get_model as jax_get_model
from brats21_tpu.models import layers as jl
from brats21_tpu.utils.import_torch import load_torch_state_dict, state_dict_to_flax
from brats21_tpu_torch.learning.train_state import model_uses_rng
from brats21_tpu_torch.models import get_model
from brats21_tpu_torch.models import layers as pl
from brats21_tpu_torch.models.unetr import UNETR
from brats21_tpu_torch.ops.kernels import conv3d
from brats21_tpu_torch.utils.weights import load_reference_pth, state_dict_from_flax
from test_torch_port_kernels import one_torch_thread  # noqa: F401  (autouse)

# name → (config, spatial side)
CASES = {
    "basic_unet": (dict(width=4, norm="instance", act="leakyrelu"), 16),
    "segresnet": (dict(norm="group"), 16),
    "segresnetvae": (dict(norm="group", patch_size=[32, 32, 32]), 32),
    "highresnet": (dict(norm="batch", act="relu"), 12),
    "vnet": (dict(act="elu"), 16),
    "nnunet": (dict(norm="instance"), 32),
    "unet_tr": (dict(norm="instance", patch_size=[32, 32, 32]), 32),
}
NAMES = list(CASES)
# stride-1 dilation-1 3³ convs a forward (the conv kernel's launches on a card)
LAUNCHES = dict(basic_unet=18, segresnet=25, segresnetvae=31, highresnet=7, vnet=0,
                nnunet=17, unet_tr=10)
UNETR_SMALL = dict(img_size=(32, 32, 32), feature_size=8, hidden_size=48, mlp_dim=96,
                   num_heads=4)


def _cfg(name):
    return {"model": name, "num_classes": 3, "dropout": 0.0, "remat_mode": "none",
            **CASES[name][0]}


def _port_model(name):
    if name == "unet_tr":
        return UNETR(**UNETR_SMALL)
    return get_model(_cfg(name))


@functools.lru_cache(maxsize=None)
def _jax(name):
    """(flax model, jitted eval apply, variable shapes) of ``name``."""
    if name == "unet_tr":
        from brats21_tpu.models.unetr import UNETR as JUNETR
        jmodel = JUNETR(num_classes=3, **UNETR_SMALL)
    else:
        jmodel = jax_get_model(_cfg(name))
    side = CASES[name][1]
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, side, side, side, 4), jnp.float32))
    apply = jax.jit(functools.partial(jmodel.apply, deterministic=True))
    return jmodel, apply, shapes


def _fill(shapes, seed):
    """Numpy weights for a flax variable tree: kernels at 1/sqrt(fan_in),
    scales and running variances near 1, the rest near 0."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        if leaf == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if leaf in ("scale", "var"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _input(name, seed=100):
    side = CASES[name][1]
    return np.random.default_rng(seed).standard_normal((1, side, side, side, 4)).astype(np.float32)


def _ncdhw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 4, 1, 2, 3)


def _outputs(out):
    """(heads, aux scalars) of a model output in either framework."""
    if isinstance(out, tuple) and isinstance(out[1], dict):
        return [out[0]], [out[1]["vae_loss"]]
    if isinstance(out, tuple):
        return [out[0], *out[1]], []
    return [out], []


def _assert_close(got, want, tol=1e-3):
    g_heads, g_aux = _outputs(got)
    w_heads, w_aux = _outputs(want)
    assert len(g_heads) == len(w_heads) and len(g_aux) == len(w_aux)
    for i, (g, w) in enumerate(zip(g_heads, w_heads)):
        np.testing.assert_allclose(g.permute(0, 2, 3, 4, 1).detach().numpy(), np.asarray(w),
                                   atol=tol, rtol=tol, err_msg=f"head {i}")
    for g, w in zip(g_aux, w_aux):
        np.testing.assert_allclose(float(g), float(w), atol=tol, rtol=tol, err_msg="vae_loss")


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name):
    """fp32, eval mode: every head (and the VAE loss) within 1e-3 of the
    JAX model on the same numpy-seeded weights, carried by
    ``state_dict_from_flax`` into a strict ``load_state_dict``."""
    _, apply, shapes = _jax(name)
    variables = _fill(shapes, seed=NAMES.index(name))
    model = _port_model(name)
    model.load_state_dict(state_dict_from_flax(
        variables["params"], name, CASES[name][0].get("norm"), variables.get("batch_stats")),
        strict=True)
    x = _input(name)
    with torch.inference_mode():
        got = model.eval()(_ncdhw(x))
    _assert_close(got, apply(variables, jnp.asarray(x)))


def _replica(name):
    """The MONAI 0.6.0 module graph of ``name`` (``tests/test_import_zoo.py``)."""
    import test_import_zoo as z
    if name == "basic_unet":
        return z.MBasicUNet([4 * 2 ** i for i in range(5)] + [4])
    if name == "segresnet":
        return z.MSegResNet()
    if name == "segresnetvae":
        return z.MSegResNetVAE(total_elements=16 * 2 ** 3)
    if name == "highresnet":
        return z.MHighResNet()
    if name == "vnet":
        return z.MVNet()
    if name == "nnunet":
        return z.MWrapperDynUNet()
    return z.MUNETR(hidden=48, mlp=96, heads=4, fs=8, patch=16, grid=2)


@pytest.mark.parametrize("name", NAMES)
def test_reference_pth_loads_strict_and_matches_jax(name, tmp_path):
    """A reference-format ``{"model": sd}`` of the MONAI module graph, every
    tensor random: ``load_reference_pth`` and a strict ``load_state_dict``
    take it (nnunet's ``net.skip_layers`` duplicates dropped after a check,
    basic_unet's affine-less instance norms as the identity, segresnetvae's
    shared decoder into both of the port's, BatchNorm statistics), and the
    port's forward matches the JAX package's forward on its own import of
    the file (``load_torch_state_dict`` + ``state_dict_to_flax``, the two
    calls of ``import_checkpoint``) within 1e-3."""
    from test_import_zoo import _randomize
    tm = _replica(name).eval()
    _randomize(tm, 20 + NAMES.index(name))
    path = tmp_path / "best_model.pth"
    torch.save({"model": tm.state_dict()}, path)
    sd = load_reference_pth(str(path))
    if name == "nnunet":
        assert not any(k.startswith("net.skip_layers.") for k in sd)
        assert any(k.startswith("net.skip_layers.") for k in tm.state_dict())
    model = _port_model(name)
    model.load_state_dict(sd, strict=True)
    _, apply, shapes = _jax(name)
    norm = CASES[name][0].get("norm") or "group"
    raw = load_torch_state_dict(str(path))
    if "batch_stats" in shapes:
        params, stats = state_dict_to_flax(raw, name, shapes["params"], shapes["batch_stats"],
                                           norm=norm)
        variables = {"params": params, "batch_stats": stats}
    else:
        variables = {"params": state_dict_to_flax(raw, name, shapes["params"], norm=norm)}
    x = _input(name, seed=101)
    with torch.inference_mode():
        got = model.eval()(_ncdhw(x))
    _assert_close(got, apply(variables, jnp.asarray(x)))


def test_skip_layer_duplicates_must_equal_their_canonical_tensor(tmp_path):
    """A ``net.skip_layers`` tensor that differs from the block it names is
    not MONAI's shared-module layout: the load raises."""
    from test_import_zoo import MWrapperDynUNet
    sd = MWrapperDynUNet().state_dict()
    key = next(k for k in sd if k.startswith("net.skip_layers.downsample."))
    sd[key] = sd[key] + 1.0
    torch.save({"model": sd}, tmp_path / "m.pth")
    with pytest.raises(ValueError, match="shared module"):
        load_reference_pth(str(tmp_path / "m.pth"))


def test_transposed_conv_kernel_carried_with_its_flip():
    """A 2³/s2 flax ConvTranspose with an odd-valued (asymmetric) kernel:
    ``state_dict_from_flax`` flips and transposes it so the port's
    ``ConvTranspose3d`` gives flax's output exactly."""
    from flax import linen as nn
    cin, cout = 3, 5
    kernel = (np.arange(8 * cin * cout, dtype=np.float32).reshape(2, 2, 2, cin, cout) * 2 + 1) / 64
    bias = np.linspace(-1, 1, cout).astype(np.float32)
    x = np.random.default_rng(3).standard_normal((1, 3, 4, 2, cin)).astype(np.float32)
    want = nn.ConvTranspose(cout, (2, 2, 2), strides=(2, 2, 2)).apply(
        {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x))
    sd = state_dict_from_flax({"upcat_4_upconv": {"kernel": kernel, "bias": bias}},
                              "basic_unet")
    deconv = pl.ConvTranspose3d(cin, cout)
    deconv.load_state_dict({"weight": sd["upcat_4.upsample.deconv.weight"],
                            "bias": sd["upcat_4.upsample.deconv.bias"]})
    with torch.inference_mode():
        got = deconv(_ncdhw(x)).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    # without the flip the output is another one
    unflipped = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 4, 0, 1, 2)))
    assert not torch.allclose(unflipped, sd["upcat_4.upsample.deconv.weight"])


def test_unetr_mlp_uses_exact_gelu():
    """The MLP's GELU is the erf form (``jax.nn.gelu(approximate=False)``),
    not ``layers.get_act("gelu")``'s tanh form, which differs by up to
    ~5e-4 on [-4, 4]."""
    from brats21_tpu_torch.models.unetr import MLP
    x = np.linspace(-4, 4, 801, dtype=np.float32)
    exact = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False))
    mlp = MLP(1, 1)
    with torch.no_grad():
        mlp.linear1.weight.fill_(1.0)
        mlp.linear1.bias.zero_()
        mlp.linear2.weight.fill_(1.0)
        mlp.linear2.bias.zero_()
        got = mlp(torch.from_numpy(x)[:, None])[:, 0].numpy()
        tanh = pl.get_act("gelu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, exact, atol=1e-6)
    assert np.abs(tanh - exact).max() > 1e-4


def test_upsample_align_corners_false_matches_jax():
    """Trilinear ×2 with ``align_corners=False`` (SegResNet's) on odd sizes
    down to 1, against the JAX package's interpolation matrices."""
    rng = np.random.default_rng(12)
    for shape in [(1, 3, 5, 1, 2), (2, 4, 7, 6, 3)]:
        x = rng.standard_normal(shape).astype(np.float32)
        got = pl.upsample(_ncdhw(x), 2, align_corners=False).permute(0, 2, 3, 4, 1).numpy()
        want = jl.upsample(jnp.asarray(x), 2, align_corners=False)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_vnet_train_dropout_follows_model_uses_rng(dropout):
    """VNet in training: with ``--dropout 0`` the JAX train step is
    deterministic (``model_uses_rng`` false), so its fixed 0.5 skip dropout
    is off, and the port's train-mode forward outside a generator equals
    the JAX forward with ``deterministic=True`` and batch statistics
    (1e-3); with a generator (``--dropout > 0``) the masks change the
    output. The port's ``model_uses_rng`` is the JAX package's."""
    for model_name in ("vnet", "segresnetvae", "nnunet"):
        for rate in (0.0, 0.3):
            cfg = SimpleNamespace(model=model_name, dropout=rate)
            assert model_uses_rng(cfg) == jax_model_uses_rng(cfg)
    cfg = {**_cfg("vnet"), "dropout": dropout}
    jmodel = jax_get_model(cfg)
    _, _, shapes = _jax("vnet")
    variables = _fill(shapes, seed=40)
    x = _input("vnet", seed=41)
    want, _ = jmodel.apply(variables, jnp.asarray(x), deterministic=True,
                           mutable=["batch_stats"])
    model = get_model(cfg)
    model.load_state_dict(state_dict_from_flax(variables["params"], "vnet", None,
                                               variables["batch_stats"]), strict=True)
    model.train()
    gen = (pl.step_generator(7, 0, torch.device("cpu"))
           if model_uses_rng(SimpleNamespace(**cfg)) else None)
    with torch.no_grad(), pl.stochastic(model, gen):
        got = model(_ncdhw(x))
    if dropout == 0.0:
        np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(want),
                                   atol=1e-3, rtol=1e-3)
    else:
        assert not np.allclose(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(want),
                               atol=1e-3, rtol=1e-3)
    assert all(m.generator is None and not m.deterministic
               for m in model.modules() if isinstance(m, pl.Dropout))


def test_aux_loss_is_added_after_the_mean():
    """``(seg, {"vae_loss": s})``: the criterion sees the seg alone and the
    scalar is added to its mean, as the JAX package's
    ``deep_supervision_loss`` does."""
    from brats21_tpu.learning.losses import deep_supervision_loss as jax_ds
    from brats21_tpu.learning.losses import make_criterion as jax_criterion
    from brats21_tpu_torch.learning.losses import deep_supervision_loss, make_criterion
    rng = np.random.default_rng(5)
    seg = rng.standard_normal((1, 8, 8, 8, 3)).astype(np.float32)
    tgt = (rng.random((1, 8, 8, 8, 3)) > 0.5).astype(np.float32)
    got = deep_supervision_loss(make_criterion({"criterion": "dice"}),
                                (_ncdhw(seg), {"vae_loss": torch.tensor(0.25)}), _ncdhw(tgt))
    want = jax_ds(jax_criterion({"criterion": "dice"}),
                  (jnp.asarray(seg), {"vae_loss": jnp.float32(0.25)}), jnp.asarray(tgt))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    plain = deep_supervision_loss(make_criterion({"criterion": "dice"}), _ncdhw(seg),
                                  _ncdhw(tgt))
    np.testing.assert_allclose(float(got) - float(plain), 0.25, rtol=1e-6)


def test_conv_kernel_launches_per_forward(monkeypatch):
    """Every stride-1 dilation-1 3³ conv of the seven names goes through
    the conv kernel's wrapper, narrow ones included (SegResNet's 8
    channels, UNETR's 16): 18 for basic_unet, 25 segresnet, 31
    segresnetvae (with its VAE branch), 7 highresnet (dilations 2 and 4 off
    it), 0 vnet (5³), 17 nnunet (its strided convs off it), 10 unet_tr."""
    calls = []
    plain = conv3d.conv3x3x3_plain
    monkeypatch.setattr(conv3d, "conv3x3x3_plain",
                        lambda x, w, b: calls.append(tuple(w.shape)) or plain(x, w, b))
    for name, n in LAUNCHES.items():
        calls.clear()
        side = CASES[name][1]
        with torch.inference_mode():
            _port_model(name).eval()(torch.zeros((1, 4, side, side, side)))
        assert len(calls) == n, f"{name}: {len(calls)} launches"


def test_bf16_forward_and_input_checks():
    """Each name runs a bf16 forward on the CPU (the train step's dtype) to
    finite heads of the input's size; nnunet refuses sizes that are not
    multiples of 32, unet_tr and segresnetvae any size but their patch,
    where the JAX models fail."""
    for name in NAMES:
        side = CASES[name][1]
        with torch.inference_mode():
            heads, _ = _outputs(_port_model(name).eval()(
                torch.randn((1, 4, side, side, side)).to(torch.bfloat16)))
        assert all(h.shape[2:] == (side,) * 3 and torch.isfinite(h.float()).all()
                   for h in heads), name
    for name, side in (("nnunet", 48), ("unet_tr", 48), ("segresnetvae", 16)):
        with pytest.raises(ValueError, match="sliding|eval_bucket"):
            _port_model(name).eval()(torch.zeros((1, 4, side, side, side)))


@pytest.mark.parametrize("name", ["nnunet", "unet_tr"])
def test_cli_trains_then_serves_as_the_jax_package_can(name, tmp_path):
    """The published widths through the CLIs on the CPU at a 32³ patch:
    one epoch of ``--optimizer novograd`` over two 30³ cases, then the run
    directory served as the JAX package can serve it — nnunet with
    ``--eval_bucket 32`` (at the default 8 the padded 32×32×24 case fails,
    as the JAX model's skip concatenation does), unet_tr through sliding
    windows of its patch (a full-volume forward fails on the position
    embedding, as in the JAX package)."""
    from brats21_tpu_torch.cli.main_inference import main as infer_main
    from brats21_tpu_torch.cli.main_train import main as train_main
    from brats21_tpu_torch.data.nifti import read_nifti
    from brats21_tpu_torch.data.synthetic import generate_synthetic_dataset
    data = tmp_path / "data"
    generate_synthetic_dataset(str(data), num_cases=2, shape=(30, 30, 20), seed=43)
    run = tmp_path / "runs"
    result = train_main([
        "--train_data_path", str(data), "--save_path", str(run), "--model", name,
        "--norm", "instance", "--criterion", "dice", "--optimizer", "novograd",
        "--learning_rate", "1e-3", "--fold", "None", "--epochs", "1", "--patch_size", "32",
        "32", "32", "--num_workers", "1", "--no_full_name", "--no_tensorboard",
        "--device", "cpu"])
    assert np.isfinite(result["train_loss"]) and result["global_step"] == 2
    base = ["--config", str(run / "config.yaml"), "--on", "test", "--input", str(data),
            "--device", "cpu"]
    with pytest.raises(ValueError, match="eval_bucket 32" if name == "nnunet" else "sliding"):
        infer_main(base + ["--output", str(tmp_path / "fails")])
    serve = (["--eval_bucket", "32"] if name == "nnunet" else
             ["--sliding_window_inference", "--sliding_window_size", "32", "32", "32"])
    infer_main(base + serve + ["--output", str(tmp_path / "out")])
    segs = sorted((tmp_path / "out" / "Inference_segmentations_test").glob("*.nii.gz"))
    assert len(segs) == 2
    for path in segs:
        labels = read_nifti(str(path)).data
        assert labels.shape == (30, 30, 20) and set(np.unique(labels)) <= {0, 1, 2, 4}


def test_nnunet_train_steps_with_novograd_match_jax():
    """The slice as a whole: two train steps of nnunet at its published
    widths (filters 32…320, instance norm; fp32, 32³) with the dice
    criterion over the main and three deep heads and ``--optimizer
    novograd`` (rate 0.01, weight decay 1e-4, cosine schedule; more than
    40 of its 79 tensors move by over 1e-3): the loss within 1e-4
    relative and every parameter within 1e-4 of the JAX package's
    ``make_train_step`` with its optimizer chain, from the same numpy
    weights."""
    from flax.core import FrozenDict
    from brats21_tpu.learning import losses as jlosses
    from brats21_tpu.learning.optimizers import make_optimizer as jax_make_optimizer
    from brats21_tpu.learning.train_state import TrainState as JaxState, make_train_step
    from brats21_tpu_torch.learning import losses as plosses
    from brats21_tpu_torch.learning.optimizers import make_optimizer
    from brats21_tpu_torch.learning.train_state import TrainState, TrainStep
    jmodel, _, shapes = _jax("nnunet")
    variables = _fill(shapes, seed=50)
    cfg = {**_cfg("nnunet"), "criterion": "dice"}
    model = _port_model("nnunet")
    model.load_state_dict(state_dict_from_flax(variables["params"], "nnunet", "instance"),
                          strict=True)
    ocfg = SimpleNamespace(
        optimizer="novograd", learning_rate=0.01, weight_decay=1e-4, decay_type="cosine",
        epochs=5, use_gc=False, use_gcnorm=False, normloss=False, normloss_factor=1e-4,
        gc_conv_only=False, adaptive_gradient_clipping=False, gradient_clipping=False,
        max_grad_norm=1.0, gradient_accumulation_iter=None, swa_start=None, swa_lr=5e-5,
        swa_anneal_epochs=10)
    tx = jax_make_optimizer(ocfg, 2)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JaxState(step=jnp.zeros([], jnp.int32), params=params, batch_stats=FrozenDict(),
                     opt_state=tx.init(params), swa_params=None,
                     swa_n=jnp.zeros([], jnp.int32), tx=tx, apply_fn=jmodel.apply)
    jstep = make_train_step(jlosses.make_criterion(cfg), use_amp=False)
    pstate = TrainState(model, make_optimizer(ocfg, model.parameters(), 2))
    pstep = TrainStep(plosses.make_criterion(cfg), use_amp=False)
    rng = np.random.default_rng(51)
    for t in range(2):
        img = rng.standard_normal((1, 32, 32, 32, 4)).astype(np.float32)
        seg = (rng.random((1, 32, 32, 32, 3)) > 0.55).astype(np.float32)
        state, jm = jstep(state, jnp.asarray(img), jnp.asarray(seg), jax.random.PRNGKey(0))
        pm = pstep(pstate, _ncdhw(img), _ncdhw(seg), t)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-4,
                                   err_msg=f"loss at step {t + 1}")
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, state.params), "nnunet",
                                "instance")
    start = state_dict_from_flax(variables["params"], "nnunet", "instance")
    moved = 0
    for key, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[key].numpy(), atol=1e-4, rtol=0,
                                   err_msg=key)
        moved += float((p - start[key]).abs().max()) > 1e-3
    assert moved > 40


def test_segresnetvae_validation_loss_adds_the_vae_term():
    """A validation case of segresnetvae (a target given): the engine's
    member loss is the criterion of the segmentation plus the VAE term of
    the same forward, plain and under TTA, as the JAX package's
    ``deep_supervision_loss`` of ``(seg, {"vae_loss": s})``."""
    from brats21_tpu_torch.learning.engine import Engine
    from brats21_tpu_torch.learning.losses import deep_supervision_loss, make_criterion
    cfg = SimpleNamespace(no_amp=True, num_classes=3, criterion="dice")
    crit = make_criterion({"criterion": "dice"})
    engine = Engine(cfg, torch.device("cpu"), criterion=crit)
    torch.manual_seed(4)
    model = _port_model("segresnetvae").eval()
    img = torch.randn((1, 32, 32, 32, 4))
    target = (torch.rand((1, 3, 32, 32, 32)) > 0.5).float()
    with torch.inference_mode():
        probs, loss = engine.member_probs(model, img, target=target)
        seg, aux = model(img.permute(0, 4, 1, 2, 3))
        want = deep_supervision_loss(crit, seg, target) + aux["vae_loss"]
        _, tta_loss = engine.member_probs(model, img, use_tta=True, target=target)
    assert probs.shape == (1, 32, 32, 32, 3)
    torch.testing.assert_close(loss, want, atol=1e-6, rtol=1e-6)
    assert torch.isfinite(tta_loss) and float(tta_loss) > float(aux["vae_loss"])
