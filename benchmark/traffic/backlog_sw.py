"""A closed backlog of full-size cases served by ``Engine.evaluate`` through
sliding windows.

The backlog of :mod:`backlog` (its set-up, window and release, by import):
a pool of cases made from the seed, cycled under fresh patient IDs, the
member built as ``cli/main_inference.main`` builds it, here with
``--sliding_window_inference``. What differs is what a forward is: the
program's predictor call on a batch of ``sw_batch_size`` windows of
``roi`` (``(2, 4, 128, 128, 128)``), each TTA combo of a case stitching
the windows of the plan of its augmented volume; :func:`measure` counts
those calls, and the model FLOPs on the reference network at a window.
:func:`check` holds every served copy of ``check_cases`` pool cases to
``reference/serve_sw.py``'s probabilities by ``label_margin``, as
:mod:`backlog` holds its copies to ``reference/serve.py``'s, and by
``prob_rmse``, the probabilities themselves: those that each compared
case's first served copy produced in the window (kept by a hook on the
engine's ``member_probs``) against the reference's.

Parameters (``traffic/<name>.json``): :mod:`backlog`'s, and ``roi``,
``overlap``, ``sw_batch_size``.
"""

from __future__ import annotations

import math
import os
import time
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import manifest, nifti
from portbench.harness import Run, quantile
from portbench.model import count_flops
from reference import fp8, nets, serve, serve_sw
from reference import swin_unetr  # noqa: F401  (registers SwinUNETR in nets.NETWORKS)

backlog = manifest.load_module(Path(__file__).with_name("backlog.py"), "portbench_kind_backlog")
window = backlog.window
release = backlog.release
check_sample = backlog.check_sample
pool_index = backlog.pool_index


def setup(run: Run) -> Dict[str, Any]:
    """:mod:`backlog`'s set-up; then the seeded relative position bias
    tables multiplied by the configuration's ``bias_table_scale`` (1 where
    it has none), in the served model and in the state dict that the
    reference loads, before the window; then a hook on the engine's
    ``member_probs`` that keeps, on the card, the TTA-mean probabilities
    that the window's first served copy of each compared pool case
    produced."""
    state = backlog.setup(run)
    scale_bias_tables(state, float(run.cell.config.get("bias_table_scale", 1.0)))
    engine, cases, kept = state["engine"], state["eval_cases"], state.setdefault("probs", {})
    ids = [r["patient_id"] for r in state["records"]]
    compared = set(check_sample(run.seed, sorted(state["pool"]), run.cell.traffic["check_cases"]))
    if not callable(getattr(engine, "member_probs", None)):
        raise AttributeError("the program's Engine has no member_probs: the harness's "
                             "probability hook needs a change")
    member_probs = engine.member_probs

    def member_probs_kept(*a, **k):
        probs, loss = member_probs(*a, **k)
        pool_id = ids[pool_index(cases[-1], len(ids))] if cases else None
        if pool_id in compared and pool_id not in kept:
            kept[pool_id] = probs.detach().clone()
        return probs, loss

    engine.member_probs = member_probs_kept
    return state


def scale_bias_tables(state: Dict[str, Any], scale: float) -> None:
    """Every ``relative_position_bias_table`` times ``scale``: the served
    model's parameters in place, and ``state["seeded"]``'s entries, which
    the reference loads in :func:`check`."""
    if scale == 1.0:
        return
    key = "relative_position_bias_table"
    tables = [n for n in state["seeded"] if n.endswith(key)]
    params = dict(state["model"].named_parameters())
    if not tables or sorted(tables) != sorted(n for n in params if n.endswith(key)):
        raise KeyError(f"bias_table_scale: the program's {key}s are not the reference's")
    with torch.no_grad():
        for name in tables:
            state["seeded"][name] = state["seeded"][name] * scale
            params[name].copy_(state["seeded"][name])


def windows_a_case(run: Run, state: Dict[str, Any]) -> List[int]:
    """The windows of each combo's volume (the padded case, and with TTA its
    axis orders' permutations), by ``serve_sw.plan``."""
    shape = backlog._padded_shape(state)
    roi = run.cell.traffic["roi"]
    orders = [shape]
    if state["cfg0"].tta:
        orders = [shape] * 8 + [(shape[1], shape[2], shape[0])] * 8
    return [len(serve_sw.plan(s, roi, run.cell.traffic["overlap"])[1]) for s in orders]


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
    per_combo = windows_a_case(run, state)
    batch = int(tr["sw_batch_size"])
    cases = len(state["eval_cases"])
    calls = cases * sum(math.ceil(w / batch) for w in per_combo)
    roi = tuple(tr["roi"])
    run.note(f"{cases} cases enqueued: {calls} predictor calls of up to {batch} windows of "
             f"{roi} ({sum(per_combo)} windows a case)")
    layer = dict(
        role="serve", forwards=calls, network=run.cell.config,
        forward_shape=(batch, 4, *roi), with_deep=False,
        model_flops=cases * sum(per_combo) * count_flops(run.cell.config, (1, 4, *roi), False),
        data_wait_s=list(state["meters"]["data_time"].history),
        decode_s=run.spans.durations("decode", run.t0_ns), latencies_s=latencies)
    state["probs"] = {p: t[0].float().cpu().numpy() for p, t in state["probs"].items()}
    return dict(attempted=len(handed), failed=failed, end_to_end=e2e, layer=layer)


def check(run: Run, state: Dict[str, Any], variant) -> List[tuple]:
    """Every served case read back (``malformed_cases``, exact), and each
    copy of ``check_cases`` pool cases drawn from the seed against the
    reference's sliding-window TTA probabilities for that case:
    ``label_margin`` (``reference.serve.label_margin``) and ``prob_rmse``
    (:func:`prob_rmse` of the probabilities the window served, the worst
    compared case's), with ``label_mismatch`` reported beside them.
    ``variant`` "control" puts the reference at fp8 in the program's
    place."""
    tr, limits = run.cell.traffic, run.cell.limits
    post = tr["post"]
    sample = check_sample(run.seed, sorted(state["pool"]), tr["check_cases"])
    refs = reference_probabilities(run, state, sample, None)
    got: Dict[str, List[np.ndarray]] = {pid: [] for pid in sample}
    malformed = 0
    ids = [r["patient_id"] for r in state["records"]]
    for pid in state["handed"]:
        pool_id = ids[pool_index(pid, len(ids))]
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
    thresh = post.get("logit_threshold", 0.5)
    served = state["probs"]
    if variant == "control":
        ctl = reference_probabilities(run, state, sample, fp8.round_e4m3)
        got = {p: [serve.finish(ctl[p][0] >= thresh, ctl[p][1], post)[0]] for p in sample}
        served = {p: ctl[p][0] for p in sample}
    rmse = max((prob_rmse(served[p], *refs[p]) for p in sample if p in served),
               default=float("inf"))
    margin, mismatch, compared, distinct = 0.0, 0.0, 0, 0
    for pool_id in sample:
        probs, geom = refs[pool_id]
        ref = serve.finish(probs >= thresh, geom, post)[0]
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
            ("prob_rmse", rmse, limits.get("prob_rmse")),
            ("label_mismatch", mismatch, limits.get("label_mismatch"))]


def prob_rmse(served: np.ndarray, probs: np.ndarray, geom: Dict) -> float:
    """The root mean square, over the brain's voxels and the three
    channels, of the served TTA-mean probabilities less the reference's,
    both ``[X', Y', Z', 3]`` in the padded crop's space."""
    if served.shape != probs.shape:
        return float("inf")
    diff = (served - probs)[geom["brain"]]
    return float(np.sqrt(np.mean(np.square(diff, dtype=np.float64))))


def reference_probabilities(run: Run, state: Dict[str, Any], sample: List[str], quant
                            ) -> Dict[str, tuple]:
    """The reference's (sliding-window TTA probabilities, geometry) of each
    pool case of ``sample`` (float32, TF32 off; GEMM operands and module
    outputs rounded by ``quant`` where given)."""
    key = "reference" if quant is None else "control"
    cache = state.setdefault(key, {})
    missing = [p for p in sample if p not in cache]
    if missing:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg, tr = run.cell.config, run.cell.traffic
        ref = nets.build(cfg["reference"]["network"], **cfg["reference"]["kwargs"])
        ref.load_state_dict(state["seeded"])
        ref = ref.to(state["device"]).eval()
        nets.set_quant(ref, quant)
        t0 = time.perf_counter()
        for pid in missing:
            cache[pid] = serve_sw.probabilities(ref, state["pool"][pid]["img"], state["device"],
                                                tr["roi"], tr["overlap"])
        run.note(f"reference ({key}): {len(missing)} case(s) in "
                 f"{time.perf_counter() - t0:.1f} s")
        del ref
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return {p: cache[p] for p in sample}
