"""The readers of the program's own spans (``portbench/program_spans.py``,
``metrics/post_idle_ms.serve.py``, ``post_host_reads.serve.py``,
``save_ms.py``): the card's idle time put down to the innermost main-thread
span on a synthetic trace, every idle nanosecond once; the per-case means;
None where the program recorded nothing or has no recorder. On the card
(``-m cuda``): under the harness's tracer, the program's spans put nothing
among the kernels, and the kernels are those of a run with spans off."""

from collections import Counter
from types import SimpleNamespace

import pytest

from portbench import manifest
from portbench import program_spans as ps
from portbench.trace import Spans, Trace

MS = 1_000_000      # one unit of the synthetic timeline: a millisecond


def _span(i, name, a, b, case=None, parent=None, thread="MainThread", **counts):
    from brats21_tpu_torch.utils.profiling import Span
    return Span(i, parent, case, thread, name, a * MS, b * MS, counts)


def _program():
    """Two cases on the main thread, their saves on the finish thread, and
    one case before the window (t0 = 0)."""
    return [
        _span(1, "eval.case", -100, -60, "early"),
        _span(2, "eval.case", 50, 500, "c0"),
        _span(3, "post.process", 250, 480, "c0", 2),
        _span(4, "post.components", 260, 400, "c0", 3, reads=7),
        _span(5, "post.replace", 400, 470, "c0", 3, reads=6),
        _span(6, "finish.save", 500, 700, "c0", thread="eval-finish"),
        _span(7, "eval.case", 600, 800, "c1"),
        _span(8, "post.process", 700, 780, "c1", 7),
        _span(9, "post.components", 700, 750, "c1", 8, reads=3),
        _span(10, "post.replace", 750, 780, "c1", 8, reads=6),
        _span(11, "finish.save", 800, 950, "c1", thread="eval-finish"),
    ]


def _trace():
    """Busy 250 of 1000 units: idle [0, 100), [200, 300), [400, 900), [950, 1000)."""
    return Trace(0, 1000 * MS, [("k", 100 * MS, 200 * MS), ("k", 300 * MS, 400 * MS),
                                ("k", 900 * MS, 950 * MS)])


@pytest.fixture
def ctx(monkeypatch):
    from brats21_tpu_torch.utils import profiling
    program = _program()
    monkeypatch.setattr(profiling, "spans",
                        lambda since_ns=0: [s for s in program if s.start_ns >= since_ns])
    hooked = Spans()
    hooked.items += [("MainThread", "eval_case", 45 * MS, 505 * MS),
                     ("MainThread", "eval_case", 595 * MS, 805 * MS)]
    notes = []
    return SimpleNamespace(trace=_trace(), spans=hooked,
                           run=SimpleNamespace(t0_ns=0, note=notes.append), notes=notes)


def _read(name, ctx):
    return manifest.metric_reader(name).read(ctx, name)


def test_idle_goes_to_the_innermost_main_thread_span(ctx):
    pieces = ps.idle_pieces(ctx.trace, ps.window_spans(ctx))
    table = ps.idle_by_name(pieces)
    want = {ps.OUTSIDE: 300, "eval.case": 240, "post.replace": 100, "post.components": 90,
            "post.process": 20}
    assert table == {k: v * MS / 1e9 for k, v in want.items()}
    assert list(table) == list(want)
    idle_ns = (ctx.trace.window_s - ctx.trace.busy_s) * 1e9
    assert sum(b - a for a, b, _ in pieces) == round(idle_ns) == 750 * MS
    # the pieces do not overlap
    assert all(p[1] <= q[0] for p, q in zip(pieces, pieces[1:]))
    # the harness's eval_case spans: 470 idle units, 20 of them outside program spans
    assert ps.overlap_s(pieces, [(a, b) for _, _, a, b in ctx.spans.items]) == (
        450 * MS / 1e9, 20 * MS / 1e9)


def test_innermost_cuts_a_child_at_its_parents_end():
    spans = [_span(1, "a", 0, 10), _span(2, "b", 5, 12, parent=1), _span(3, "c", 20, 30)]
    assert ps.innermost(spans) == [(0, 5 * MS, "a"), (5 * MS, 10 * MS, "b"),
                                   (20 * MS, 30 * MS, "c")]


def test_per_case_readers(ctx):
    assert _read("post_idle_ms.serve", ctx) == pytest.approx(105.0)
    assert _read("post_host_reads.serve", ctx) == 11.0
    assert _read("save_ms.serve", ctx) == pytest.approx(175.0)
    table, outside, hooked = ctx.notes
    assert "0.750000 s idle in the trace, 0.750000 s in the table" in table
    assert '"post.replace": 0.1' in table
    assert outside.endswith('{"before the first": 0.05, "between": 0.1, "after the last": 0.15}')
    assert "0.470000 s, 0.450000 s of it under program spans (95.74 %)" in hooked


@pytest.mark.parametrize("name", ["post_idle_ms.serve", "post_host_reads.serve",
                                  "save_ms.serve"])
def test_nothing_to_read_without_program_spans(ctx, monkeypatch, name):
    from brats21_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "spans", lambda since_ns=0: [])
    assert _read(name, ctx) is None
    monkeypatch.delattr(profiling, "spans")        # a program without the recorder
    assert _read(name, ctx) is None


@pytest.mark.cuda
def test_spans_put_nothing_among_the_traced_kernels(card, monkeypatch):
    import time

    import torch
    from portbench.trace import Tracer

    from brats21_tpu_torch.config import TrainConfig
    from brats21_tpu_torch.learning.engine import Engine
    from brats21_tpu_torch.learning.losses import make_criterion
    from brats21_tpu_torch.models import get_model
    from brats21_tpu_torch.utils import profiling

    cfg = TrainConfig(model="equiunet_assp_evo", width=48)
    engine = Engine(cfg, card, criterion=make_criterion(cfg))
    model = get_model(cfg).to(card).eval()
    img = torch.randn(1, 64, 64, 64, 4, device=card, dtype=torch.float16)

    def traced():
        tracer = Tracer(card)
        tracer.start()
        with torch.inference_mode(), profiling.annotate("eval.case", case="c0"):
            engine.member_probs(model, img)
        return tracer.stop()

    with torch.inference_mode():
        engine.member_probs(model, img)           # builds and warms the kernels
    t0 = time.time_ns()
    on = traced()
    names = {s.name for s in profiling.spans(t0)}
    assert names == {"eval.case", "eval.member"}
    monkeypatch.setattr(profiling, "_profiler_running", lambda: False)
    off = traced()
    kernels = Counter(n for n, _, _ in on.kernels)
    assert not [n for n in kernels if n in names or "annotation" in n], kernels
    assert kernels == Counter(n for n, _, _ in off.kernels)
