"""The serve path's spans on the CPU: ``Engine.evaluate`` over two
synthetic cases through the program's loader, EquiUnetASSPEvo at width 4,
16-combo TTA with cleaning and replacement, with the recorder switched on
as a running ``torch.profiler`` switches it (the profiler is not started
here: the recorder reads only its flag, which ``test_torch_port_profiling``
checks under a real profiler). Every span of the serve path
appears once a case with the case's patient id, on its thread and under its
parent; ``post.components`` counts one host read a connected-components
sweep and one for ``bincount``; and the labels written are byte-equal to a run with the recorder
off, which records nothing."""

import gzip
import os
import time
from collections import defaultdict

import pytest
import torch

from brats21_tpu_torch.config import TrainConfig
from brats21_tpu_torch.data.discovery import create_database, make_file_records
from brats21_tpu_torch.data.pipeline import make_records_loader
from brats21_tpu_torch.data.synthetic import generate_synthetic_dataset
from brats21_tpu_torch.learning.engine import Engine
from brats21_tpu_torch.learning.losses import make_criterion
from brats21_tpu_torch.models import get_model
from brats21_tpu_torch.ops import postprocess as P
from brats21_tpu_torch.utils import profiling
from test_torch_port_kernels import one_torch_thread  # noqa: F401  (autouse)

CFG = dict(model="equiunet_assp_evo", width=4, no_amp=True, wire="dense", num_workers=2)
POST = dict(cleaning_areas=True, cleaning_areas_threshold=20,
            replace_value=True, replace_value_threshold=300)
MODALITIES = ("t1", "t1ce", "flair", "t2")

#: span: (thread, parent span or None)
TABLE = {
    "eval.case": ("MainThread", None),
    "eval.put": ("MainThread", "eval.case"),
    "eval.member": ("MainThread", "eval.case"),
    "post.process": ("MainThread", "eval.case"),
    "post.components": ("MainThread", "post.process"),
    "post.replace": ("MainThread", "post.process"),
    "eval.seal": ("MainThread", "eval.case"),
    "eval.collect": ("MainThread", None),
    "finish.save": ("eval-finish", None),
}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Two cases served with the recorder off and on: (the spans recorded
    on, those recorded off, the masks given to connected components in
    order on, the labels on, those off, the patient ids)."""
    root = tmp_path_factory.mktemp("spans")
    data = str(root / "cases")
    generate_synthetic_dataset(data, num_cases=2, shape=(30, 28, 24), seed=5, with_seg=False)
    records = make_file_records(create_database(data, required_modality=MODALITIES),
                                with_seg=False)
    cfg = TrainConfig(**CFG)
    torch.manual_seed(3)
    model = get_model(cfg).eval()
    masks = []
    filter_components = P.filter_components

    def recording(volume, threshold):
        masks.append(volume != 0)
        return filter_components(volume, threshold)

    def serve(out):
        engine = Engine(cfg, torch.device("cpu"), criterion=make_criterion(cfg))
        engine.evaluate([model], make_records_loader(records, cfg), 0, use_tta=True,
                        save_seg=True, output_path=out, post_kwargs=POST)
        return {f: gzip.decompress(open(os.path.join(out, f), "rb").read())
                for f in sorted(os.listdir(out))}

    mp = pytest.MonkeyPatch()
    try:
        for k in ("BRATS21_EVAL_STAGES", "BRATS21_EVAL_PIPELINE", "BRATS21_SPARSE_WIRE"):
            mp.delenv(k, raising=False)
        mp.setattr(P, "filter_components", recording)
        t0 = time.time_ns()
        plain = serve(str(root / "plain"))
        t1 = time.time_ns()
        untraced = [s for s in profiling.spans(t0) if s.start_ns < t1]
        masks.clear()
        mp.setattr(profiling, "_profiler_running", lambda: True)
        traced = serve(str(root / "traced"))
        spans = profiling.spans(t1)
    finally:
        mp.undo()
    return spans, untraced, masks, traced, plain, [r["patient_id"] for r in records]


def test_every_span_once_a_case_on_its_thread_under_its_parent(served):
    spans, _, _, _, _, pids = served
    by_id = {s.id: s for s in spans}
    seen = defaultdict(list)
    for s in spans:
        seen[s.name].append(s)
        assert s.start_ns <= s.end_ns
    assert set(seen) == set(TABLE) | {"eval.wait_prep"}
    for name, (thread, parent) in TABLE.items():
        got = seen[name]
        assert sorted(s.case for s in got) == sorted(pids), name
        for s in got:
            assert s.thread == thread, name
            if parent is None:
                assert s.parent is None, name
            else:
                up = by_id[s.parent]
                assert up.name == parent and up.case == s.case, name
                assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns, name
    # the wait for each case, and the last that ends the loader
    waits = seen["eval.wait_prep"]
    assert len(waits) == len(pids) + 1
    assert all(s.thread == "MainThread" and s.parent is None and s.case is None
               for s in waits)


def _sweeps(mask: torch.Tensor) -> int:
    """The propagation sweeps of ``label_components`` on ``mask``, counted
    by its min-pools."""
    calls = []
    min_pool3 = P._min_pool3

    def counted(x):
        calls.append(1)
        return min_pool3(x)

    mp = pytest.MonkeyPatch()
    mp.setattr(P, "_min_pool3", counted)
    try:
        P.label_components(mask)
    finally:
        mp.undo()
    return len(calls)


def test_post_processing_counts_its_host_reads(served):
    spans, _, masks, _, _, pids = served
    components = sorted((s for s in spans if s.name == "post.components"),
                        key=lambda s: s.start_ns)
    assert len(components) == len(masks) == len(pids)
    for span, mask in zip(components, masks):
        assert span.counts == {"reads": _sweeps(mask) + 1}
        assert span.counts["reads"] >= 2
    # five label counts and one test of the replacement mask
    assert [s.counts for s in spans if s.name == "post.replace"] == [{"reads": 6}] * len(pids)


def test_spans_change_no_output_and_need_a_profiler(served):
    _, untraced, _, traced, plain, pids = served
    assert sorted(traced) == sorted(f"{p}.nii.gz" for p in pids)
    assert traced == plain
    assert untraced == []
