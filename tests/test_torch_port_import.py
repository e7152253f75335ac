"""``python -m brats21_tpu_torch.cli.import_torch`` on the CPU: its flags
against the JAX package's ``cli/import_torch.py``; a reference-layout
``.pth`` (a ``model`` payload and an AveragedModel ``swa_model`` with its
``module.`` prefix and ``n_averaged``, written from port models) turned
into run directories, with and without ``--swa``; the plain one served by
the inference CLI from its ``config.yaml`` alone with labels equal to
``--import_pth`` of the file; and the imported weights carried by the JAX
package's ``state_dict_to_flax`` into its model, whose heads agree with the
port's within 1e-3 (the JAX package's whole-model tolerance)."""

import glob
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from brats21_tpu.cli.import_torch import build_parser as jax_build_parser
from brats21_tpu.models import get_model as jax_get_model
from brats21_tpu.utils.import_torch import state_dict_to_flax
from brats21_tpu_torch.cli import import_torch, main_inference
from brats21_tpu_torch.data.nifti import read_nifti
from brats21_tpu_torch.data.synthetic import generate_synthetic_dataset
from brats21_tpu_torch.learning.engine import forward_channels_last
from brats21_tpu_torch.models import get_model
from brats21_tpu_torch.utils.weights import load_reference_pth
from test_torch_port_kernels import one_torch_thread  # noqa: F401  (autouse)

CASE = (24, 28, 20)
# (--model, --norm) of the imported runs: the flagship, and a model whose
# BatchNorms carry running statistics
RUNS = [("equiunet_assp_evo", "group"), ("att_unet", "batch")]


def _flags(parser):
    return sorted(s for a in parser._actions for s in a.option_strings if s not in ("-h",
                                                                                    "--help"))


def test_flags_match_jax_cli():
    """The port's CLI takes the JAX package's flags, with its defaults."""
    ours, theirs = import_torch.build_parser(), jax_build_parser()
    assert _flags(ours) == _flags(theirs)
    for a, b in zip(sorted(ours._actions, key=lambda a: a.dest),
                    sorted(theirs._actions, key=lambda a: a.dest)):
        assert (a.dest, a.default, a.required) == (b.dest, b.default, b.required)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """Per (model, norm): a reference-layout .pth holding two port models'
    weights, one as ``model``, the other as an AveragedModel ``swa_model``."""
    root = tmp_path_factory.mktemp("import_pth")
    out = {}
    for i, (name, norm) in enumerate(RUNS):
        torch.manual_seed(70 + i)
        cfg = {"model": name, "width": 4, "norm": norm}
        plain, averaged = get_model(cfg), get_model(cfg)
        for m in (plain, averaged):              # running statistics off their init
            for b_name, b in m.named_buffers():
                if b_name.endswith("running_var"):
                    b.uniform_(0.5, 1.5)
                elif b_name.endswith("running_mean"):
                    b.uniform_(-0.5, 0.5)
        swa = {f"module.{k}": v for k, v in averaged.state_dict().items()}
        swa["n_averaged"] = torch.tensor(3)
        path = root / f"{name}.pth"
        torch.save({"model": plain.state_dict(), "swa_model": swa, "optimizer": {},
                    "epoch": 7, "best_value": 0.25}, path)
        out[name, norm] = path
    return out


def _import(path, out, name, norm, *extra):
    return import_torch.main(["--pth", str(path), "--out", str(out), "--model", name,
                              "--width", "4", "--norm", norm, *extra])


@pytest.mark.parametrize("swa", [False, True])
def test_run_directory_holds_the_payload(pth, tmp_path, swa):
    """config.yaml names the model; best_model.pth holds the chosen
    payload's weights exactly (``--swa``: the average, its prefix and
    ``n_averaged`` dropped), as the inference CLI's loader reads them."""
    name, norm = RUNS[0]
    run = _import(pth[RUNS[0]], tmp_path / "run", name, norm, *(["--swa"] if swa else []))
    cfg = yaml.safe_load(open(os.path.join(run, "config.yaml")))
    assert (cfg["model"], cfg["width"], cfg["norm"], cfg["swa_start"]) == (name, 4, norm, None)
    got = load_reference_pth(os.path.join(run, "best_model.pth"))
    want = load_reference_pth(str(pth[RUNS[0]]), prefer_swa=swa)
    other = load_reference_pth(str(pth[RUNS[0]]), prefer_swa=not swa)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    assert not torch.equal(got["out_conv.weight"], other["out_conv.weight"])


def test_wrong_architecture_fails_at_import(pth, tmp_path):
    """A checkpoint of another width fails the strict load at import time."""
    with pytest.raises(RuntimeError, match="size mismatch"):
        import_torch.main(["--pth", str(pth[RUNS[0]]), "--out", str(tmp_path / "run"),
                           "--model", "equiunet_assp_evo", "--width", "8"])
    assert not (tmp_path / "run").exists()


def _serve(config, data, out, *extra):
    main_inference.main(["--config", str(config), "--on", "test", "--input", str(data),
                         "--output", str(out), "--device", "cpu", "--num_workers", "1",
                         *extra])
    return {os.path.basename(p): read_nifti(p).data for p in sorted(
        glob.glob(str(out / "Inference_segmentations_test" / "*.nii.gz")))}


def test_imported_run_serves_like_import_pth(pth, tmp_path):
    """The imported run directory served by ``--config`` alone gives the
    same labels, voxel for voxel, as ``--import_pth`` of the .pth."""
    data = tmp_path / "data"
    generate_synthetic_dataset(str(data), num_cases=2, shape=CASE, seed=71)
    name, norm = RUNS[0]
    run = _import(pth[RUNS[0]], tmp_path / "run", name, norm)
    config = os.path.join(run, "config.yaml")
    got = _serve(config, data, tmp_path / "dir")
    want = _serve(config, data, tmp_path / "pth", "--import_pth", str(pth[RUNS[0]]))
    assert sorted(got) == sorted(want) == ["BraTS2021_00000.nii.gz", "BraTS2021_00001.nii.gz"]
    for key, labels in want.items():
        assert got[key].shape == CASE
        np.testing.assert_array_equal(got[key], labels)


@pytest.mark.parametrize("name,norm", RUNS)
def test_imported_weights_match_jax(pth, tmp_path, name, norm):
    """The run directory's weights through the JAX package's
    ``state_dict_to_flax`` into its model: every head within 1e-3 of the
    port's model served from the same file, fp32."""
    run = _import(pth[name, norm], tmp_path / "run", name, norm)
    sd = load_reference_pth(os.path.join(run, "best_model.pth"))
    cfg = {"model": name, "width": 4, "norm": norm, "remat_mode": "none"}
    jmodel = jax_get_model(cfg)
    x = np.random.default_rng(72).standard_normal((1, 16, 16, 16, 4)).astype(np.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct(x.shape, jnp.float32))
    sd_np = {k: v.numpy() for k, v in sd.items()}
    if "batch_stats" in shapes:
        params, stats = state_dict_to_flax(sd_np, name, shapes["params"], shapes["batch_stats"],
                                           norm=norm)
        variables = {"params": params, "batch_stats": stats}
    else:
        variables = {"params": state_dict_to_flax(sd_np, name, shapes["params"], norm=norm)}
    want = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x),
                        deterministic=True)
    model = get_model(cfg)
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = forward_channels_last(model.eval(), torch.from_numpy(x), with_deep=True)
    got_heads = [got[0], *got[1]]
    want_heads = [want[0], *want[1]]
    assert len(got_heads) == len(want_heads)
    for i, (g, w) in enumerate(zip(got_heads, want_heads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=1e-3,
                                   err_msg=f"head {i}")
