"""The port's pipelined evaluation on the CPU: its host stages
(``_IterStage``, ``_SinkStage``; the ten tests of
``tests/test_engine_stages.py`` mirrored, every thread join bounded), and
``Engine.evaluate`` against the JAX package's on ``tests/test_wire_eval.py``'s
setup (equiunet w4, three 16×16×8 cases with background, fp32, the JAX
weights carried across): dense and sparse wires, depths 1 and 3, staged and
inline, all byte-identical to each other and within 1e-5 of the JAX meters;
``BRATS21_EVAL_BUCKET``; ``batch_time``; the order of dispatches and
collects; and errors in a stage or the loader, after which no stage thread
is left."""

import gzip
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brats21_tpu.config import TrainConfig as JaxTrainConfig
from brats21_tpu.data.nifti import read_nifti
from brats21_tpu.learning.engine import Engine as JaxEngine
from brats21_tpu.learning.losses import make_criterion as jax_make_criterion
from brats21_tpu.models import get_model as jax_get_model
from brats21_tpu.parallel.mesh import make_mesh
from brats21_tpu_torch.config import TrainConfig
from brats21_tpu_torch.learning.engine import Engine, _IterStage, _SinkStage
from brats21_tpu_torch.learning.losses import make_criterion
from brats21_tpu_torch.models import get_model
from brats21_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_port_kernels import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_zoo import _fill

JOIN_S = 5.0
STAGE_THREADS = ("eval-prep", "eval-finish")


def _joined(stage) -> None:
    stage._t.join(timeout=JOIN_S)
    assert not stage._t.is_alive(), "stage thread still running"


def _stage_threads():
    return [t.name for t in threading.enumerate() if t.name in STAGE_THREADS]


# ------------------------------------------------------------------ stages

def test_iter_stage_maps_in_order():
    stage = _IterStage(iter(range(10)), lambda x: x * 2, depth=2)
    assert list(stage) == [x * 2 for x in range(10)]
    _joined(stage)


def test_iter_stage_propagates_fn_error():
    def fn(x):
        if x == 3:
            raise ValueError("poison")
        return x

    stage = _IterStage(iter(range(10)), fn, depth=2)
    got = []
    with pytest.raises(ValueError, match="poison"):
        for item in stage:
            got.append(item)
    assert got == [0, 1, 2]
    _joined(stage)


def test_iter_stage_propagates_source_error():
    def src():
        yield 1
        raise OSError("decode failed")

    stage = _IterStage(src(), lambda x: x, depth=2)
    with pytest.raises(OSError, match="decode failed"):
        list(stage)
    _joined(stage)


def test_iter_stage_abandoned_consumer_releases_producer():
    produced = []

    def src():
        for i in range(100):
            produced.append(i)
            yield i

    stage = _IterStage(src(), lambda x: x, depth=1)
    assert next(stage) == 0
    stage.close()
    t0 = time.time()
    _joined(stage)
    assert time.time() - t0 < JOIN_S
    # bounded queue: the producer never ran ahead unboundedly
    assert len(produced) < 100


def test_sink_stage_runs_in_submission_order():
    got = []
    sink = _SinkStage(lambda x: got.append(x), depth=2)
    for i in range(20):
        sink.submit(i)
    sink.join()
    assert got == list(range(20))
    _joined(sink)


def test_sink_stage_error_reraises_on_submit_or_join():
    calls = []

    def fn(x):
        calls.append(x)
        if x == 2:
            raise RuntimeError("writer failed")

    sink = _SinkStage(fn, depth=1)
    with pytest.raises(RuntimeError, match="writer failed"):
        for i in range(50):
            sink.submit(i)
            time.sleep(0.01)
    # the worker is not wedged; close() releases it
    sink.close()
    _joined(sink)


def test_sink_stage_join_reraises_late_error():
    def fn(x):
        if x == 4:
            raise RuntimeError("late failure")

    sink = _SinkStage(fn, depth=8)
    for i in range(5):
        sink.submit(i)        # fits the queue before the worker errors
    with pytest.raises(RuntimeError, match="late failure"):
        sink.join()
    _joined(sink)


def test_stages_compose():
    """prep → main → finish, as evaluate wires them."""
    finished = []
    sink = _SinkStage(lambda x: finished.append(x), depth=2)
    stage = _IterStage(iter(range(25)), lambda x: x + 100, depth=2)
    for item in stage:
        sink.submit(item)
    sink.join()
    assert finished == [x + 100 for x in range(25)]
    _joined(stage)
    _joined(sink)


def test_sink_stage_concurrent_with_main_thread_work():
    """The finish stage runs on its own thread, not the caller's."""
    seen_threads = set()

    def fn(x):
        seen_threads.add(threading.current_thread().name)
        time.sleep(0.005)

    sink = _SinkStage(fn, depth=4)
    main = threading.current_thread().name
    for i in range(10):
        sink.submit(i)
    sink.join()
    assert seen_threads == {"eval-finish"} and main not in seen_threads
    _joined(sink)


def test_sink_submit_after_close_raises():
    """submit after close() raises rather than drop the work (a NIfTI save)."""
    sink = _SinkStage(lambda x: None, depth=2)
    sink.close()
    with pytest.raises(RuntimeError, match="after close"):
        sink.submit(1)
    _joined(sink)


# --------------------------------------------------------------- evaluate

def _case_batches(n=3):
    """test_wire_eval.py's cases: random 16×16×8 images with a zeroed
    background band, random targets."""
    rng = np.random.default_rng(0)
    batches = []
    for i in range(n):
        img = rng.random((1, 16, 16, 8, 4)).astype(np.float32)
        img[:, : 3 + i] = 0.0
        seg = (rng.random((1, 16, 16, 8, 3)) > 0.6).astype(np.float32)
        batches.append({
            "img": img, "seg": seg, "patient_id": [f"wc{i}"],
            "foreground_start_coord": np.array([[0, 0, 0]]),
            "foreground_end_coord": np.array([[16, 16, 8]]),
            "original_shape": np.array([[16, 16, 8]]),
            "affine": np.eye(4)[None],
        })
    return batches


class _Loader:
    def __init__(self, batches, fail_at=None):
        self.batches, self.fail_at = batches, fail_at

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for i, b in enumerate(self.batches):
            if i == self.fail_at:
                raise OSError("decode failed")
            yield b


CFG = dict(model="equiunet", width=4, criterion="dice", no_amp=True)



@pytest.fixture(scope="module")
def setup():
    """The JAX engine's meters and labels (inline, dense) and the port's
    model with the same weights."""
    jcfg = JaxTrainConfig(**CFG, wire="dense")
    jmodel = jax_get_model(jcfg)
    batches = _case_batches()
    # flax's eager init of the model takes ~50 s here: weights from numpy
    variables = _fill(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                     jax.ShapeDtypeStruct(batches[0]["img"].shape,
                                                          jnp.float32)), seed=7)
    model = get_model(TrainConfig(**CFG))
    model.load_state_dict(state_dict_from_flax(variables["params"], "equiunet"), strict=True)
    engine = JaxEngine(jcfg, jmodel, jax_make_criterion(jcfg),
                       mesh=make_mesh(jax.devices()[:1], data=1, space=1))
    saved = {k: os.environ.pop(k, None) for k in ("BRATS21_EVAL_STAGES",
                                                  "BRATS21_SPARSE_WIRE",
                                                  "BRATS21_EVAL_PIPELINE")}
    os.environ["BRATS21_EVAL_STAGES"] = "0"
    try:
        import tempfile
        out = tempfile.mkdtemp(prefix="jax_eval_")
        meters = engine.evaluate([{"params": variables["params"]}], _Loader(batches), 0,
                                 save_seg=True, output_path=out)
        labels = {f: read_nifti(os.path.join(out, f)).data for f in sorted(os.listdir(out))}
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    return dict(model=model.eval(), batches=batches, jax_meters=meters, jax_labels=labels)


def _read_segs(out):
    # decompressed: the gzip header holds an mtime
    return {f: gzip.decompress(open(os.path.join(out, f), "rb").read())
            for f in sorted(os.listdir(out))}


def _run(setup, out, monkeypatch, wire="dense", depth=2, stages=True, loader=None,
         env=(), eval_bucket=8):
    monkeypatch.delenv("BRATS21_SPARSE_WIRE", raising=False)
    monkeypatch.delenv("BRATS21_EVAL_BUCKET", raising=False)
    monkeypatch.setenv("BRATS21_EVAL_PIPELINE", str(depth))
    monkeypatch.setenv("BRATS21_EVAL_STAGES", "1" if stages else "0")
    for k, v in env:
        monkeypatch.setenv(k, v)
    cfg = TrainConfig(**CFG, wire=wire, eval_bucket=eval_bucket)
    engine = Engine(cfg, torch.device("cpu"), criterion=make_criterion(cfg))
    meters = engine.evaluate([setup["model"]], loader or _Loader(setup["batches"]), 0,
                             save_seg=True, output_path=str(out))
    return meters, _read_segs(str(out))


def _meter_values(meters):
    return {k: np.asarray(m.avg) for k, m in meters.items()
            if k not in ("batch_time", "data_time")}


@pytest.fixture(scope="module")
def reference(setup, tmp_path_factory):
    """The port's case-serial run: dense, depth 1, inline."""
    out = tmp_path_factory.mktemp("ref")
    mp = pytest.MonkeyPatch()
    try:
        return (*_run(setup, out, mp, depth=1, stages=False), out)
    finally:
        mp.undo()


def test_reference_matches_jax(setup, reference):
    """The case-serial port against the JAX engine: meters within 1e-5,
    equal labels."""
    meters, segs, out = reference
    got, want = _meter_values(meters), _meter_values(setup["jax_meters"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)
    assert sorted(segs) == sorted(setup["jax_labels"])
    for f, want_labels in setup["jax_labels"].items():
        np.testing.assert_array_equal(read_nifti(str(out / f)).data, want_labels, err_msg=f)


@pytest.mark.parametrize("stages", [True, False], ids=["staged", "inline"])
@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("wire", ["dense", "sparse"])
def test_evaluate_variants_identical(setup, reference, tmp_path, monkeypatch, wire, depth,
                                     stages):
    """Every wire × depth × stage mode writes the reference's bytes and
    meters exactly, and is within 1e-5 of the JAX meters."""
    meters, segs = _run(setup, tmp_path, monkeypatch, wire=wire, depth=depth, stages=stages)
    ref_meters, ref_segs, _ = reference
    got = _meter_values(meters)
    for k, v in _meter_values(ref_meters).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for k, v in _meter_values(setup["jax_meters"]).items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=0, err_msg=k)
    assert sorted(segs) == sorted(ref_segs)
    for f in segs:
        assert segs[f] == ref_segs[f], f"saved NIfTI differs: {f}"
    assert len(meters["batch_time"].history) == len(meters["data_time"].history) == 3
    assert not _stage_threads()


def test_eval_bucket_env_overrides_config(setup, reference, tmp_path, monkeypatch):
    """BRATS21_EVAL_BUCKET beats cfg.eval_bucket (JAX engine.py:834-838),
    and a value that is no multiple of 8 is refused before any case."""
    cfg = TrainConfig(**CFG, eval_bucket=16)
    engine = Engine(cfg, torch.device("cpu"), criterion=make_criterion(cfg))
    monkeypatch.delenv("BRATS21_EVAL_BUCKET", raising=False)
    assert engine._eval_bucket() == 16
    monkeypatch.setenv("BRATS21_EVAL_BUCKET", "8")
    assert engine._eval_bucket() == 8
    monkeypatch.setenv("BRATS21_EVAL_BUCKET", "24")
    assert engine._eval_bucket() == 24
    for bad in ("12", "4"):
        monkeypatch.setenv("BRATS21_EVAL_BUCKET", bad)
        with pytest.raises(ValueError, match="multiple of 8"):
            engine.evaluate([setup["model"]], _Loader(setup["batches"]), 0)
    assert not _stage_threads()
    forced = _run(setup, tmp_path, monkeypatch, eval_bucket=16,
                  env=[("BRATS21_EVAL_BUCKET", "8")])
    ref_meters, ref_segs, _ = reference
    assert forced[1] == ref_segs
    for k, v in _meter_values(ref_meters).items():
        np.testing.assert_array_equal(_meter_values(forced[0])[k], v, err_msg=k)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_cases_in_flight(setup, tmp_path, monkeypatch, depth):
    """Up to ``depth`` cases are enqueued before the oldest is collected;
    card work and metrics run on the caller's thread, prep and the save on
    the stage threads."""
    events, threads = [], {}
    orig_case, orig_collect = Engine.eval_case, Engine._collect
    orig_prep, orig_save = Engine.prep_case, Engine._save_segmentation

    def eval_case(self, members, case, *a, **kw):
        events.append(("dispatch", case["batch"]["patient_id"][0]))
        threads.setdefault("eval_case", set()).add(threading.current_thread().name)
        return orig_case(self, members, case, *a, **kw)

    def collect(self, entry, n):
        events.append(("collect", entry["case"]["batch"]["patient_id"][0]))
        threads.setdefault("collect", set()).add(threading.current_thread().name)
        return orig_collect(self, entry, n)

    def prep(self, *a, **kw):
        threads.setdefault("prep", set()).add(threading.current_thread().name)
        return orig_prep(self, *a, **kw)

    def save(self, *a, **kw):
        threads.setdefault("save", set()).add(threading.current_thread().name)
        return orig_save(self, *a, **kw)

    monkeypatch.setattr(Engine, "eval_case", eval_case)
    monkeypatch.setattr(Engine, "_collect", collect)
    monkeypatch.setattr(Engine, "prep_case", prep)
    monkeypatch.setattr(Engine, "_save_segmentation", save)
    _run(setup, tmp_path, monkeypatch, depth=depth)
    ids = [f"wc{i}" for i in range(3)]
    want = []
    for i, pid in enumerate(ids):
        want.append(("dispatch", pid))
        if i + 1 >= depth:
            want.append(("collect", ids[i + 1 - depth]))
    want += [("collect", pid) for pid in ids[max(0, 3 - depth + 1):]]
    assert events == want
    main = threading.current_thread().name
    assert threads == {"eval_case": {main}, "collect": {main}, "prep": {"eval-prep"},
                       "save": {"eval-finish"}}


@pytest.mark.parametrize("stages", [True, False], ids=["staged", "inline"])
def test_finish_error_raises_and_leaves_no_thread(setup, tmp_path, monkeypatch, stages):
    calls = []
    orig = Engine._save_segmentation

    def save(self, batch, *a, **kw):
        calls.append(batch["patient_id"][0])
        if len(calls) == 2:
            raise RuntimeError("disk full")
        return orig(self, batch, *a, **kw)

    monkeypatch.setattr(Engine, "_save_segmentation", save)
    with pytest.raises(RuntimeError, match="disk full"):
        _run(setup, tmp_path, monkeypatch, stages=stages)
    assert calls[:2] == ["wc0", "wc1"]
    assert not _stage_threads()


@pytest.mark.parametrize("stages", [True, False], ids=["staged", "inline"])
def test_loader_error_raises_and_leaves_no_thread(setup, tmp_path, monkeypatch, stages):
    with pytest.raises(OSError, match="decode failed"):
        _run(setup, tmp_path, monkeypatch, loader=_Loader(setup["batches"], fail_at=2),
             stages=stages)
    assert not _stage_threads()
