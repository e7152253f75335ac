"""The port's ``utils/profiling.py`` and ``utils/misc.py`` on the CPU:
the host allocator tuning and its opt-out, ``annotate`` and ``capture``
writing a Chrome trace, the trace server that stands in for JAX's profiler
server (idempotent, one capture answered), and ``misc`` against the JAX
package's."""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from brats21_tpu.utils import misc as jax_misc
from brats21_tpu.utils import profiling as jax_profiling
from brats21_tpu_torch.utils import misc, profiling
from test_torch_port_kernels import one_torch_thread  # noqa: F401  (autouse)


def test_tune_host_allocator_and_opt_out(monkeypatch):
    monkeypatch.delenv("BRATS21_NO_MALLOC_TUNE", raising=False)
    assert profiling.tune_host_allocator() is True
    assert jax_profiling.tune_host_allocator() is True
    monkeypatch.setenv("BRATS21_NO_MALLOC_TUNE", "1")
    assert profiling.tune_host_allocator() is False
    assert jax_profiling.tune_host_allocator() is False


def test_annotate_and_capture_write_a_trace(tmp_path):
    with profiling.capture(str(tmp_path)) as trace:
        with profiling.annotate("brats21_phase"):
            torch.ones(64).mul(2).sum()
    assert trace.path is not None and os.path.dirname(trace.path) == str(tmp_path)
    with open(trace.path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "brats21_phase" for e in events)
    # one window at a time: the lock is free again
    with profiling.capture(str(tmp_path)):
        with pytest.raises(RuntimeError, match="already running"):
            with profiling.capture(str(tmp_path)):
                pass


def _get(port, query):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{query}", timeout=30)


def test_trace_server_is_idempotent_and_answers_a_capture(monkeypatch, tmp_path):
    port = profiling.trace_server(0, str(tmp_path))
    assert port > 0
    assert profiling.trace_server(port + 1) == port
    monkeypatch.setenv("BRATS21_PROFILE_PORT", str(port + 2))
    assert profiling.maybe_enable_from_env() == port
    monkeypatch.delenv("BRATS21_PROFILE_PORT")
    assert profiling.maybe_enable_from_env() is None
    path = _get(port, "/capture?ms=50").read().decode()
    with open(path) as f:
        assert "traceEvents" in json.load(f)
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(port, "/capture?ms=-1")
    assert err.value.code == 500


@pytest.mark.parametrize("seq", [[1, [2, (3, 4)], [[5]]], 7, (), [[], [1]]])
def test_misc_matches_jax(seq):
    assert misc.flatten(seq) == jax_misc.flatten(seq)
    assert misc.apply_f(seq, lambda x: x * 10) == jax_misc.apply_f(seq, lambda x: x * 10)


def test_to_array_takes_tensors_to_host_numpy():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = misc.to_array(torch.from_numpy(x).requires_grad_())
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, jax_misc.to_array(x))
    np.testing.assert_array_equal(misc.to_array([1, 2]), jax_misc.to_array([1, 2]))
