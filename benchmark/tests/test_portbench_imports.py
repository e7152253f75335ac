"""The run's check for JAX: top-level module names compared whole; and the
reference imports nothing of the program or of JAX."""

import subprocess
import sys
import types

from portbench import harness
from portbench.manifest import BENCH_DIR, ROOT


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("jax", "jax.numpy", "jaxlib", "flax.linen", "brats21_tpu",
                 "brats21_tpu.models"):
        with monkeypatch.context() as m:
            m.setitem(sys.modules, name, types.ModuleType(name))
            assert harness.forbidden_modules() == [name]
    for name in ("brats21_tpu_torch", "brats21_tpu_torch.models", "jaxtyping", "flaxen"):
        with monkeypatch.context() as m:
            m.setitem(sys.modules, name, types.ModuleType(name))
            assert harness.forbidden_modules() == []


def test_reference_and_harness_import_nothing_of_the_program_or_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import reference.nets, reference.serve, reference.fp8, "
            "portbench.harness, portbench.hostload, portbench.model, portbench.trace, "
            "portbench.synthetic; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'brats21_tpu', 'brats21_tpu_torch'}); print(bad)"
            % (str(BENCH_DIR), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_without_a_card_the_run_fails_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload",
                          "assp_evo_w48.serve_tta", "--seed", str(2 ** 31 + 5), "--seconds",
                          "1", "--trace", "0"], capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT))
    assert out.returncode != 0 and out.stdout == ""
    assert "cuda" in out.stderr.lower()
