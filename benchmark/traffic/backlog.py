"""A closed backlog of full-size cases served by ``Engine.evaluate``.

A hospital's or a challenge's queue: every case is on disk when the window
opens, and the loader hands the next one to the program as soon as its
prep stage asks, until the window ends. The pool holds ``pool_cases``
distinct cases made from the seed; the backlog cycles through them under
fresh patient IDs. The member is built as ``cli/main_inference.main``
builds it, from the configuration's training flags and the mix's
inference flags, with the seeded weights loaded by ``load_state_dict``.

The window serves through the loader that the program's
``make_records_loader`` returns, with the harness's span around each
item its dataset decodes, and hands out cases for ``--seconds``; the cases
in flight then drain. ``cases_per_s`` is every case handed out over the
seconds from the window's start until the last of them was written. Each
case's latency runs from the start of its decode to its label map
written (the per-layer ``case_latency_p90_s``).

Parameters (``traffic/<name>.json``): ``pool_cases``, ``case_shape``,
``inference_flags``, ``post`` (the reference's post-processing, the same
numbers as the flags) and ``check_cases`` (pool cases whose every served
copy is compared with the reference).
"""

from __future__ import annotations

import copy
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import nifti, synthetic, weights
from portbench.harness import Run, quantile
from portbench.model import count_flops, meta_network
from reference import fp8, nets, serve

#: cases in the backlog a second of window: more than any window serves
BACKLOG_PER_S = 20


class _Timed:
    """The program's dataset with the harness's decode span around each
    item: the case's latency starts when its decode starts."""

    def __init__(self, dataset, run: Run, started: Dict[str, float]):
        self.dataset, self.run, self.started = dataset, run, started

    @property
    def records(self):
        return self.dataset.records

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int):
        pid = self.dataset.records[idx]["patient_id"]
        self.started[pid] = time.perf_counter()
        with self.run.spans.span("decode"):
            return self.dataset[idx]


class Backlog:
    """The window's loader: the program's loader over the cycled records,
    handing out items until the deadline, then stopping (what it had
    decoded ahead is dropped). At the deadline it notes the host's load
    since the window's start."""

    def __init__(self, loader, run: Run, handed: List[str]):
        self.loader, self.run, self.handed = loader, run, handed

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        try:
            for item in it:
                if time.perf_counter() >= self.run.deadline:
                    self.run.mark_host("deadline")
                    return
                self.handed.append(item["patient_id"][0])
                yield item
        finally:
            it.close()


def _member_args(run: Run, pool_dir: str, run_dir: str, out_dir: str):
    from brats21_tpu_torch.cli.arguments import get_inference_args, get_train_args
    cfg = run.cell.config
    train_cfg = get_train_args(["--train_data_path", pool_dir, "--save_path", run_dir,
                                "--no_full_name", *cfg["cli"]])
    os.makedirs(train_cfg.save_path, exist_ok=True)
    config_yaml = os.path.join(train_cfg.save_path, "config.yaml")
    train_cfg.to_yaml(config_yaml)
    # --import_pth names the member's weights for the parser; the weights
    # themselves come from the seed through load_state_dict, where
    # load_member would read that file
    config_dict, _ = get_inference_args(
        ["--config", config_yaml, "--input", pool_dir, "--output", out_dir,
         "--import_pth", "seeded", *run.cell.traffic["inference_flags"],
         *(["--device", "cpu"] if run.device.type == "cpu" else [])])
    return list(config_dict.values())[0]


def setup(run: Run) -> Dict[str, Any]:
    from brats21_tpu_torch.cli.main_inference import post_kwargs_from_cfg
    from brats21_tpu_torch.config import TrainConfig
    from brats21_tpu_torch.data import native
    from brats21_tpu_torch.data.pipeline import discover_test_records, make_records_loader
    from brats21_tpu_torch.learning.engine import Engine, probe_wire_bandwidth
    from brats21_tpu_torch.learning.losses import make_criterion
    from brats21_tpu_torch.models import get_model
    from brats21_tpu_torch.ops import kernels
    from brats21_tpu_torch.parallel.mesh import init_topology

    tr, cfg = run.cell.traffic, run.cell.config
    pool_dir, out_dir = os.path.join(run.tmp, "cases"), os.path.join(run.tmp, "out")
    os.makedirs(pool_dir)
    with ThreadPoolExecutor(2) as bg:
        pool_f = bg.submit(run.timed("pool written", synthetic.write_pool), pool_dir, run.seed, tr["pool_cases"],
                           tr["case_shape"], False)
        native_f = bg.submit(run.timed("native loader loaded", native.library))
        cfg0 = _member_args(run, pool_dir, os.path.join(run.tmp, "member"), out_dir)
        topo = init_topology(cfg0.device)
        device = topo.device
        if device.type == "cuda":
            with run.stage("kernels built and launched"):
                kernels.warm_up(device)
        template = meta_network(cfg).state_dict()
        seeded = weights.seeded_state_dict(template, run.seed, device)
        model = get_model(cfg0)
        model.load_state_dict(seeded)
        model = model.to(device).eval()
        pool = pool_f.result()
        native_f.result()
    train_like = TrainConfig.from_dict(vars(cfg0))
    train_like.create_patient_dir = cfg0.create_patient_dir
    engine = Engine(train_like, device, criterion=make_criterion(train_like), topo=topo)
    eval_kw = dict(use_tta=bool(cfg0.tta), perform_staple=bool(cfg0.perform_staple),
                   staple_threshold=cfg0.staple_threshold,
                   post_kwargs=post_kwargs_from_cfg(cfg0), step_mode=f"metric_{cfg0.on}")
    records = discover_test_records(cfg0)
    state = dict(cfg0=cfg0, engine=engine, model=model, seeded=seeded, pool=pool,
                 records=records, eval_kw=eval_kw, out_dir=out_dir, started={},
                 finished={}, handed=[], eval_cases=[], device=device)
    _instrument(run, state)
    # warm-up: one pool case through the whole path, saved as in the window
    warm = copy.deepcopy(records[:1])
    warm[0]["patient_id"] = "BraTSWarmup_00000"
    with run.stage("warm-up case"):
        engine.evaluate([model], make_records_loader(warm, cfg0), 0, save_seg=True,
                        output_path=os.path.join(run.tmp, "warmup"), **eval_kw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    counts = native.take_counts()
    run.note(f"warm-up: native loads {counts['loads']}, numpy fallbacks {counts['fallbacks']}")
    if counts["fallbacks"]:
        raise RuntimeError("a case fell back to the numpy decode path")
    if device.type == "cuda":
        run.note(f"wire: {engine._resolve_wire()}; host link "
                 f"{probe_wire_bandwidth(device):.1f} MB/s (probe_wire_bandwidth)")
    state["started"].clear()
    state["finished"].clear()
    state["eval_cases"].clear()
    return state


HOOKED = ("eval_case", "_save_segmentation")


def _instrument(run: Run, state: Dict[str, Any]) -> None:
    """The harness's hooks on the engine instance, no more than the
    metrics need: a span around each case's enqueue on the main thread
    (the forwards counted, the card's idle time attributed) and the time
    its label map was written on the finish thread (the end of its
    latency). A method missing from the program stops the run."""
    engine, finished, cases = state["engine"], state["finished"], state["eval_cases"]
    missing = [name for name in HOOKED if not callable(getattr(engine, name, None))]
    if missing:
        raise AttributeError(f"the program's Engine has no {', '.join(missing)}: the "
                             "harness's hooks need a change")
    eval_case, save = engine.eval_case, engine._save_segmentation

    def eval_case_timed(members, case, *a, **k):
        cases.append(case["batch"]["patient_id"][0])
        with run.spans.span("eval_case"):
            return eval_case(members, case, *a, **k)

    def save_timed(batch, *a, **k):
        with run.spans.span("save"):
            out = save(batch, *a, **k)
        finished[batch["patient_id"][0]] = time.perf_counter()
        return out

    engine.eval_case = eval_case_timed
    engine._save_segmentation = save_timed


def window(run: Run, state: Dict[str, Any]) -> None:
    from brats21_tpu_torch.data.pipeline import make_records_loader
    records, cfg0 = state["records"], state["cfg0"]
    cycled = [dict(records[i % len(records)], patient_id=f"BraTS2021_{100000 + i:07d}")
              for i in range(int(BACKLOG_PER_S * run.seconds) + 20)]
    loader = make_records_loader(cycled, cfg0)
    if not hasattr(loader, "dataset"):
        raise AttributeError("the program's records loader has no dataset: the harness's "
                             "decode span needs a change")
    loader.dataset = _Timed(loader.dataset, run, state["started"])
    run.begin_window()
    meters = state["engine"].evaluate([state["model"]], Backlog(loader, run, state["handed"]),
                                      0, save_seg=True, output_path=state["out_dir"],
                                      **state["eval_kw"])
    run.end_window()
    state["meters"] = meters


def measure(run: Run, state: Dict[str, Any]) -> Dict[str, Any]:
    from brats21_tpu_torch.data import native
    tr = run.cell.traffic
    started, finished, handed = state["started"], state["finished"], state["handed"]
    done = [p for p in handed if p in finished]
    latencies = [finished[p] - started[p] for p in done]
    last = max((finished[p] for p in done), default=run.t_end)
    counts = native.take_counts()
    run.note(f"window: {len(handed)} cases handed out in {run.seconds:g} s, "
             f"{sum(finished[p] <= run.deadline for p in done)} written by then, the last "
             f"{last - run.t0:.3f} s after the start; native loads {counts['loads']}, "
             f"fallbacks {counts['fallbacks']}; launches {run.launches}")
    for name, values in (("latency", latencies),
                         *((span, run.spans.durations(span, run.t0_ns))
                           for span in ("decode", "eval_case", "save"))):
        if values:
            run.note("{} s over {} cases: min {:.3f} median {:.3f} p90 {:.3f} max {:.3f}".format(
                name, len(values), min(values), quantile(values, 0.5),
                quantile(values, 0.9), max(values)))
    e2e = {"cases_per_s": len(done) / (last - run.t0)}
    failed = len(handed) - len(done) + counts["fallbacks"]
    combos = 16 if state["cfg0"].tta else 1
    forwards = combos * len(state["eval_cases"])
    shape = _padded_shape(state)
    layer = dict(
        role="serve", forwards=forwards, network=run.cell.config,
        forward_shape=(1, 4, *shape), with_deep=False,
        model_flops=forwards * count_flops(run.cell.config, (1, 4, *shape), False),
        data_wait_s=list(state["meters"]["data_time"].history),
        decode_s=run.spans.durations("decode", run.t0_ns), latencies_s=latencies)
    return dict(attempted=len(handed), failed=failed, end_to_end=e2e, layer=layer)


def _padded_shape(state: Dict[str, Any]) -> tuple:
    """The volume each forward sees: a pool case cropped to its brain and
    padded as the engine pads it (multiples of 8, square for TTA)."""
    raw = next(iter(state["pool"].values()))["img"]
    box, _, _ = serve.crop_foreground(raw)
    size = [s.stop - s.start for s in box]
    size = [-(-s // 8) * 8 for s in size]
    if state["cfg0"].tta:
        size[0] = size[1] = max(size[0], size[1])
    return tuple(size)


def release(run: Run, state: Dict[str, Any]) -> None:
    for key in ("engine", "model"):
        state.pop(key, None)


def check(run: Run, state: Dict[str, Any], variant) -> List[tuple]:
    """Every served case read back: its shape, type, labels and affine
    (``malformed_cases``, exact); and each copy of ``check_cases`` pool
    cases drawn from the seed against the reference's probabilities for
    that case: ``label_margin``, the worst copy's
    :func:`reference.serve.label_margin` (how far from the threshold the
    reference's probabilities must move to give the copy's labels), and,
    reported beside it, ``label_mismatch`` (voxels labelled otherwise over
    the reference's tumour voxels). ``variant`` "control" puts the
    reference at fp8 in the program's place."""
    tr, limits = run.cell.traffic, run.cell.limits
    post = tr["post"]
    sample = check_sample(run.seed, sorted(state["pool"]), tr["check_cases"])
    refs = reference_probabilities(run, state, sample, None)
    got: Dict[str, List[np.ndarray]] = {pid: [] for pid in sample}
    malformed = 0
    for pid, pool_id in _copies(state).items():
        path = os.path.join(state["out_dir"], f"{pid}.nii.gz")
        if not os.path.exists(path):
            continue
        labels, affine = nifti.read(path)
        raw = state["pool"][pool_id]
        ok = (labels.shape == raw["img"].shape[:3] and labels.dtype == np.uint8
              and set(np.unique(labels).tolist()) <= {0, 1, 2, 4}
              and np.allclose(affine, raw["affine"]))
        malformed += not ok
        if ok and pool_id in got:
            got[pool_id].append(labels)
    if variant == "control":
        ctl = reference_probabilities(run, state, sample, fp8.round_e4m3)
        got = {p: [serve.finish(ctl[p][0] >= post.get("logit_threshold", 0.5), ctl[p][1],
                                post)[0]] for p in sample}
    margin, mismatch, compared, distinct = 0.0, 0.0, 0, 0
    for pool_id in sample:
        probs, geom = refs[pool_id]
        ref = serve.finish(probs >= post.get("logit_threshold", 0.5), geom, post)[0]
        tumour = max(int((ref != 0).sum()), 1)
        seen: Dict[bytes, float] = {}
        for labels in got[pool_id]:
            key = labels.tobytes()
            if key not in seen:
                seen[key] = serve.label_margin(labels, probs, geom, post)
            margin = max(margin, seen[key])
            mismatch = max(mismatch, float((labels != ref).sum()) / tumour)
            compared += 1
        distinct += len(seen)
    run.note(f"check: {compared} served copies ({distinct} distinct label maps) of "
             f"{len(sample)} pool cases against the reference")
    if compared == 0:
        margin = mismatch = float("inf")
    return [("malformed_cases", float(malformed), 0.0),
            ("label_margin", margin, limits.get("label_margin")),
            ("label_mismatch", mismatch, limits.get("label_mismatch"))]


def check_sample(seed: int, ids: List[str], k: int) -> List[str]:
    """The ``k`` pool cases, drawn from the seed, whose copies are compared."""
    rng = np.random.default_rng((seed, 7))
    return [ids[i] for i in sorted(rng.choice(len(ids), k, replace=False))]


def pool_index(pid: str, pool_size: int) -> int:
    """The pool case that served patient ``pid`` copies."""
    return (int(pid.rsplit("_", 1)[1]) - 100000) % pool_size


def _copies(state: Dict[str, Any]) -> Dict[str, str]:
    """Served patient id → its pool case's id, for every case handed out."""
    ids = [r["patient_id"] for r in state["records"]]
    return {pid: ids[pool_index(pid, len(ids))] for pid in state["handed"]}


def reference_probabilities(run: Run, state: Dict[str, Any], sample: List[str], quant
                            ) -> Dict[str, tuple]:
    """The reference's (TTA probabilities, geometry) of each pool case of
    ``sample`` (float32, TF32 off; GEMM operands rounded by ``quant`` where
    given)."""
    key = "reference" if quant is None else "control"
    cache = state.setdefault(key, {})
    missing = [p for p in sample if p not in cache]
    if missing:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = run.cell.config
        ref = nets.build(cfg["reference"]["network"], **cfg["reference"]["kwargs"])
        ref.load_state_dict(state["seeded"])
        ref = ref.to(state["device"]).eval()
        nets.set_quant(ref, quant)
        t0 = time.perf_counter()
        for pid in missing:
            cache[pid] = serve.probabilities(ref, state["pool"][pid]["img"], state["device"])
        run.note(f"reference ({key}): {len(missing)} case(s) in "
                 f"{time.perf_counter() - t0:.1f} s")
        del ref
        torch.cuda.empty_cache()
    return {p: cache[p] for p in sample}
