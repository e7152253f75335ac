"""The port's slice end to end on the CPU, against the JAX package's CLI,
and the guards: the port imports no JAX, and never runs on the CPU unasked."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from brats21_tpu.cli.main_inference import main as jax_infer_main
from brats21_tpu.data.nifti import read_nifti
from brats21_tpu_torch.cli.main_inference import main as port_infer_main
from brats21_tpu_torch.config import TrainConfig
from brats21_tpu_torch.data.synthetic import generate_synthetic_dataset
from brats21_tpu_torch.models import get_model
from test_torch_port_kernels import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def served_run(tmp_path_factory):
    """A w8 fp32 config.yaml, a .pth of the port's seeded model whose
    out_conv is scaled ×50 (so few voxels sit near the 0.5 threshold), and
    one synthetic test case."""
    root = tmp_path_factory.mktemp("port_e2e")
    generate_synthetic_dataset(str(root / "test"), num_cases=1, shape=(40, 48, 32),
                               seed=11, with_seg=False)
    TrainConfig(model="equiunet_assp_evo", width=8, no_amp=True).to_yaml(
        str(root / "config.yaml"))
    torch.manual_seed(5)
    model = get_model({"model": "equiunet_assp_evo", "width": 8})
    with torch.no_grad():
        model.out_conv.weight.mul_(50.0)
        model.out_conv.bias.mul_(50.0)
    torch.save({"model": model.state_dict()}, str(root / "best_model.pth"))
    return root


def _argv(root, out, *extra):
    return ["--config", str(root / "config.yaml"), "--import_pth",
            str(root / "best_model.pth"), "--on", "test", "--input",
            str(root / "test"), "--output", str(out), "--tta",
            "--cleaning_areas", "--cleaning_areas_threshold", "2",
            "--replace_value", "--replace_value_threshold", "3",
            "--num_workers", "1", *extra]


def test_cli_labels_match_jax_cli(served_run, tmp_path):
    """Same config, weights and case through both CLIs (TTA + both
    post-processing steps): equal shape and affine, BraTS labels, and the
    label maps agree on ≥ 99.9 % of voxels (measured: 100 %)."""
    port_infer_main(_argv(served_run, tmp_path / "port", "--device", "cpu"))
    jax_infer_main(_argv(served_run, tmp_path / "jax"))
    got_path, = glob.glob(str(tmp_path / "port" / "Inference_segmentations_test" / "*.nii.gz"))
    want_path, = glob.glob(str(tmp_path / "jax" / "Inference_segmentations_test" / "*.nii.gz"))
    assert os.path.basename(got_path) == os.path.basename(want_path)
    got, want = read_nifti(got_path), read_nifti(want_path)
    assert got.data.shape == want.data.shape == (40, 48, 32)
    np.testing.assert_array_equal(got.affine, want.affine)
    assert set(np.unique(got.data)) <= {0, 1, 2, 4}
    assert len(np.unique(want.data)) > 1            # not a trivial map
    agreement = (got.data == want.data).mean()
    assert agreement >= 0.999, f"label agreement {agreement:.5f}"


def test_cli_needs_cuda_unless_asked_for_cpu(served_run, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_infer_main(_argv(served_run, tmp_path / "out"))


@pytest.mark.parametrize("flag,match", [
    (["--sliding_window_inference"], "sliding"),
    (["--perform_staple"], "staple"),
    (["--watch"], "watch")])
def test_unported_flags_raise(served_run, tmp_path, flag, match):
    with pytest.raises(NotImplementedError, match=match):
        port_infer_main(_argv(served_run, tmp_path / "out", "--device", "cpu", *flag))


def test_on_val_raises(served_run, tmp_path):
    argv = _argv(served_run, tmp_path / "out", "--device", "cpu")
    argv[argv.index("test")] = "val"
    with pytest.raises(NotImplementedError, match="--on val"):
        port_infer_main(argv)


def test_port_imports_no_jax():
    """Every module of brats21_tpu_torch, and chip_smoke, imported in a
    fresh interpreter: no jax, flax or brats21_tpu module gets loaded."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import brats21_tpu_torch\n"
        "for m in pkgutil.walk_packages(brats21_tpu_torch.__path__, 'brats21_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'brats21_tpu'))\n"
        "print(len([n for n in sys.modules if n.startswith('brats21_tpu_torch')]))\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20
