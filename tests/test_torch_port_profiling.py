"""The port's ``utils/profiling.py`` and ``utils/misc.py`` on the CPU:
the host allocator tuning and its opt-out, the span recorder (nothing
recorded and no ``record_function`` entered without a profiler; parent,
case, thread and counts on ``time.time_ns`` under one; parentage on
another thread and the bounded buffer with recording switched on as a
profiler switches it), ``annotate`` and ``capture`` writing a Chrome
trace, the trace server that stands in for JAX's profiler server
(idempotent, one capture answered), and ``misc`` against the JAX
package's."""

import json
import os
import threading
import time
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


def _cpu_profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture
def ranges(monkeypatch):
    """The names of the ``record_function`` ranges entered."""
    entered = []
    record_function = torch.profiler.record_function

    def counted(name, *a, **k):
        entered.append(name)
        return record_function(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    return entered


def test_annotate_records_nothing_without_a_profiler(ranges):
    t0 = time.time_ns()
    with profiling.annotate("idle", case="c0", reads=1) as span:
        span.count("reads", 3)
        with profiling.annotate("inner"):
            pass
    assert profiling.spans(t0) == [] and ranges == []


def test_spans_under_a_profiler(ranges):
    t0 = time.time_ns()
    with _cpu_profiler():
        with profiling.annotate("outer", case="BraTS2021_00007", reads=1) as outer:
            outer.count("reads", 2)
            with profiling.annotate("inner") as inner:
                inner.count("forwards")
                inner.count("forwards")
        with profiling.annotate("elsewhere", case="BraTS2021_00008"):
            pass
    t1 = time.time_ns()
    got = {s.name: s for s in profiling.spans(t0)}
    assert set(got) == {"outer", "inner", "elsewhere"}
    o, i, e = got["outer"], got["inner"], got["elsewhere"]
    assert (o.parent, o.case, o.thread, o.counts) == (None, "BraTS2021_00007", "MainThread",
                                                      {"reads": 3})
    assert (i.parent, i.case, i.thread, i.counts) == (o.id, o.case, "MainThread",
                                                      {"forwards": 2})
    assert e.parent is None and e.case == "BraTS2021_00008" and len({o.id, i.id, e.id}) == 3
    assert t0 <= o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns <= e.start_ns <= e.end_ns <= t1
    # under a profiler the program did not start, no range enters its trace
    assert ranges == []


def _recording(monkeypatch):
    """Record as under a running profiler (what ``torch.profiler`` sets),
    without starting one."""
    monkeypatch.setattr(profiling, "_profiler_running", lambda: True)


def test_a_span_on_another_thread_has_its_own_parentage(monkeypatch):
    t0 = time.time_ns()

    def work():
        with profiling.annotate("worker.case", case="c1"):
            with profiling.annotate("worker.step"):
                pass

    _recording(monkeypatch)
    with profiling.annotate("main.case", case="c0"):
        t = threading.Thread(target=work, name="spans-worker")
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    got = {s.name: s for s in profiling.spans(t0)}
    assert got["worker.case"].parent is None and got["worker.case"].thread == "spans-worker"
    assert got["worker.step"].parent == got["worker.case"].id
    assert got["worker.step"].case == "c1"


def test_the_buffer_keeps_the_newest_spans(monkeypatch):
    n = profiling.SPANS_MAX + 10
    _recording(monkeypatch)
    for k in range(n):
        with profiling.annotate("s", k=k):
            pass
    got = profiling.spans()
    assert len(got) == profiling.SPANS_MAX
    assert [s.counts["k"] for s in got[:1] + got[-1:]] == [10, n - 1]


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
