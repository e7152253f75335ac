"""The port's parallel paths (``brats21_tpu_torch/parallel``) on the CPU,
with real gloo ranks started by ``torch.distributed.run``
(``tests/torch_parallel_worker.py``), against the JAX package's serial
functions and the one-rank port on the same numpy inputs: the nodes'
striping, the data-parallel train step (Dice with ``batch=True``,
``dice_hd``, ``--norm batch``), TTA- and window-parallel probabilities,
case-parallel, TTA-striped (at one and two cases in flight) and
member-striped STAPLE evaluation, the merges across
nodes, the train CLI and the fold-parallel CLI on two ranks. One torch
thread a rank; every rendezvous and collective times out after 60 s and
every launch is bounded, so nothing can hang the run."""

import glob
import gzip
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brats21_tpu.config import TrainConfig as JaxTrainConfig
from brats21_tpu.learning import losses as jlosses
from brats21_tpu.learning.engine import Engine as JaxEngine
from brats21_tpu.learning.optimizers import make_optimizer as jax_make_optimizer
from brats21_tpu.models import get_model as jax_get_model
from brats21_tpu.parallel import multihost as jmultihost
from brats21_tpu.parallel.mesh import make_mesh
from brats21_tpu.utils.reporting import EvaluationReport as JaxReport
from brats21_tpu_torch.data import transforms as T
from brats21_tpu_torch.data.nifti import read_nifti
from brats21_tpu_torch.data.synthetic import generate_synthetic_dataset, make_case
from brats21_tpu_torch.learning import losses as plosses
from brats21_tpu_torch.learning.optimizers import make_optimizer
from brats21_tpu_torch.learning.train_state import TrainState, TrainStep
from brats21_tpu_torch.parallel import multihost
from test_torch_port_kernels import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_zoo import _cfg, _ncdhw, _port_from, _random_variables
from test_torch_port_zoo_train import _opt_cfg

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_parallel_worker.py"
ENV = {"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1", multihost.TIMEOUT_ENV: "60"}
METRICS = ["hausdorff_distance95"]


def _launch(job, out, nproc=2, nnodes=1, timeout=150, env=None):
    """Run the worker's ``job`` on ``nnodes`` × ``nproc`` gloo ranks (with
    ``env`` over :data:`ENV`); each rank's results, by global rank."""
    out.mkdir(parents=True, exist_ok=True)
    job = dict(job, out=str(out))
    torch.save(job, out / "job.pt")
    multihost.run_ranks([str(WORKER), str(out / "job.pt")], nproc, nnodes, timeout=timeout,
                        env={**ENV, **(env or {})}, cwd=str(REPO))
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(nproc * nnodes)]


# ------------------------------------------------------------ (a) striping

@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_node_striping_matches_jax(count):
    """process_shard (padded, wrap k += count + 1) and shard_eval_records
    (untrimmed) equal the JAX package's for 0-9 records on every index."""
    for n in range(10):
        records = [f"case{i}" for i in range(n)]
        for index in range(count):
            assert multihost.process_shard(records, index, count) == \
                jmultihost.process_shard(records, index, count), (n, index)
            assert multihost.shard_eval_records(records, index, count) == \
                jmultihost.shard_eval_records(records, index, count), (n, index)


@pytest.mark.parametrize("device,local_size,cards,want", [
    ("cpu", 1, None, "gloo"),
    ("cuda", 2, ["GPU-a", "GPU-a"], "gloo"),      # local ranks outnumber the card
    ("cuda", 1, ["GPU-a", "GPU-a"], "gloo"),      # two nodes of one host share it
    ("cuda", 1, ["GPU-a", "GPU-b"], "nccl")])     # a card a rank
def test_backend_rule(monkeypatch, device, local_size, cards, want):
    """nccl when every rank has a card of its own, else gloo: each rank
    posts its card's UUID to the rendezvous store (rank 0 here, the other
    rank's already posted)."""
    from types import SimpleNamespace
    import torch.distributed as dist
    from brats21_tpu_torch.parallel.mesh import choose_backend
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    store = dist.HashStore()
    if cards:
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda d: SimpleNamespace(uuid=cards[0]))
        store.set("brats21/card/1", cards[1])
    assert choose_backend(torch.device(device, 0) if device == "cuda" else torch.device("cpu"),
                          local_size, store, 0, 2) == want


# ------------------------------------------------------- one launch: (b-d)

STEP_CASES = {
    "dice": _cfg("equiunet_assp_evo", width=4) | {"criterion": "dice"},
    "dice_hd": _cfg("equiunet_assp_evo", width=4) | {"criterion": "dice_hd"},
    "norm_batch": _cfg("equiunet", "batch", width=4) | {"criterion": "dice"},
}
ROI = (16, 16, 8)


def _case(seed, shape=(36, 18, 9)):
    """One cropped, normalised case with a blobby three-channel target."""
    img, _ = make_case(shape, seed=seed)
    rng = np.random.default_rng(seed + 100)
    field = rng.standard_normal(img.shape[:3])
    for ax in range(3):
        field = (field + np.roll(field, 1, ax) + np.roll(field, -1, ax)) / 3
    brain = img.any(-1)
    seg = np.stack([field > t for t in (0.0, 0.2, 0.4)], -1) & brain[..., None]
    f_img, (f_seg,), start, end = T.crop_foreground(img, seg.astype(np.float32))
    f_img = T.normalize_intensity(f_img, nonzero=True, channel_wise=True)
    return {"img": f_img[None], "seg": f_seg[None], "patient_id": [f"case{seed}"],
            "foreground_start_coord": start[None], "foreground_end_coord": end[None],
            "original_shape": np.asarray(img.shape[:3])[None], "affine": np.eye(4)[None]}


EVAL_CFG = dict(model="equiunet_assp_evo", width=4, criterion="dice_hd", no_amp=True,
                additional_metrics=METRICS, sliding_window_size=list(ROI))
# mode: (members, cases' seeds, evaluate's keywords, environment,
#        (case-parallel, member-striped) as the engine should choose them)
EVAL_MODES = {"case_parallel": (1, (3, 4, 5), {}, {}, (True, False)),
              "staple": (2, (3,), {"perform_staple": True}, {}, (False, True)),
              "staple_serial": (2, (3,), {"perform_staple": True},
                                {"BRATS21_STAPLE_SERIAL": "1"}, (False, False)),
              "tta": (1, (4,), {"use_tta": True}, {}, (False, False)),
              "tta_depth1": (1, (4, 5), {"use_tta": True}, {"BRATS21_EVAL_PIPELINE": "1"},
                             (False, False)),
              "tta_depth2": (1, (4, 5), {"use_tta": True}, {"BRATS21_EVAL_PIPELINE": "2"},
                             (False, False))}


@pytest.fixture(scope="module")
def parallel_run(tmp_path_factory):
    """The inputs, and the worker's results of one 2-rank launch."""
    out = tmp_path_factory.mktemp("parallel_run")
    rng = np.random.default_rng(31)
    steps = {}
    for name, cfg in STEP_CASES.items():
        variables = _random_variables(jax_get_model(cfg), seed=32)
        steps[name] = dict(cfg=cfg, variables=variables, opt=vars(_opt_cfg()),
                           state_dict=_port_from(variables, cfg).state_dict(),
                           img=rng.standard_normal((4, 16, 16, 16, 4)).astype(np.float32),
                           seg=(rng.random((4, 16, 16, 16, 3)) > 0.55).astype(np.float32))
    cfg = _cfg("equiunet_assp_evo", width=4) | {"criterion": "dice_hd"}
    raw = _random_variables(jax_get_model(cfg), seed=35)
    members = [_random_variables(jax_get_model(cfg), seed=s) for s in (33, 34)]
    for v in members:        # output conv ×20: few voxels near the threshold
        v["params"]["out_conv"]["Conv_0"]["kernel"] = \
            v["params"]["out_conv"]["Conv_0"]["kernel"] * 20.0
    x = rng.standard_normal((1, 16, 16, 16, 4)).astype(np.float32)
    seg = (rng.random((1, 16, 16, 16, 3)) > 0.5).astype(np.float32)
    batches = {mode: [_case(s) for s in m[1]] for mode, m in EVAL_MODES.items()}
    job = dict(kinds=["ddp_steps", "sharded_inference", "engine_eval"],
               ddp_steps=dict(cases={k: {f: v[f] for f in ("cfg", "opt", "state_dict", "img",
                                                          "seg")}
                                     for k, v in steps.items()}),
               sharded_inference=dict(cfg=cfg, state_dict=_port_from(raw, cfg).state_dict(),
                                      x=x, seg=seg, roi=ROI),
               engine_eval=dict(train_cfg=EVAL_CFG, cfg=cfg,
                                members=[_port_from(v, cfg).state_dict() for v in members],
                                batches=batches, out=str(out / "engine"),
                                modes={m: (n, kw, env)
                                       for m, (n, _, kw, env, _) in EVAL_MODES.items()}))
    ranks = _launch(job, out)
    return dict(ranks=ranks, steps=steps, raw=raw, members=members, cfg=cfg, x=x, seg=seg,
                batches=batches, out=out)


def _jax_step(case):
    from flax.core import FrozenDict
    from brats21_tpu.learning.train_state import TrainState as JaxState, make_train_step
    cfg, variables = case["cfg"], case["variables"]
    jmodel = jax_get_model(cfg)
    tx = jax_make_optimizer(_opt_cfg(), 1)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = variables.get("batch_stats", FrozenDict())
    state = JaxState(step=jnp.zeros([], jnp.int32), params=params, batch_stats=stats,
                     opt_state=tx.init(params), swa_params=None,
                     swa_n=jnp.zeros([], jnp.int32), tx=tx, apply_fn=jmodel.apply)
    step = make_train_step(jlosses.make_criterion(cfg), use_amp=False,
                           has_batch_stats=bool(stats))
    state, m = step(state, jnp.asarray(case["img"]), jnp.asarray(case["seg"]),
                    jax.random.PRNGKey(0))
    variables = {"params": jax.tree_util.tree_map(np.asarray, state.params)}
    if stats:
        variables["batch_stats"] = jax.tree_util.tree_map(np.asarray, state.batch_stats)
    return float(m["loss"]), _port_from(variables, cfg).state_dict()


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_ddp_step_matches_one_rank_and_jax(parallel_run, name):
    """A 2-rank DDP step (batch 4, two samples a rank, fp32, width 4,
    16³, Ranger): the global batch's loss (the ranks' mean) within 1e-5
    relative of the 1-rank port step's and the JAX package's; every
    parameter (and BatchNorm's running statistics) within 1e-5 of the
    1-rank port's and 1e-4 of the JAX package's; the two ranks' equal. The
    ranks all-reduce Dice's batch sums and BatchNorm's statistics, so
    DDP's average of their gradients is the global batch's."""
    case = parallel_run["steps"][name]
    got = [r["ddp_steps"][name] for r in parallel_run["ranks"]]
    model = _port_from(case["variables"], case["cfg"])
    state = TrainState(model, make_optimizer(_opt_cfg(), model.parameters(), 1))
    one = TrainStep(plosses.make_criterion(case["cfg"]), use_amp=False)(
        state, _ncdhw(case["img"]), _ncdhw(case["seg"]))
    jloss, jparams = _jax_step(case)
    loss = np.mean([g["loss"] for g in got])
    np.testing.assert_allclose(loss, float(one["loss"]), rtol=1e-5)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    np.testing.assert_allclose(got[0]["grad_norm"], float(one["grad_norm"]), rtol=1e-5)
    moved = 0
    for key, want in model.state_dict().items():
        torch.testing.assert_close(got[0]["params"][key], got[1]["params"][key], rtol=0,
                                   atol=0)
        np.testing.assert_allclose(got[0]["params"][key].numpy(), want.numpy(), atol=1e-5,
                                   rtol=0, err_msg=key)
        if not key.endswith("num_batches_tracked"):     # no flax counterpart
            np.testing.assert_allclose(got[0]["params"][key].numpy(), jparams[key].numpy(),
                                       atol=1e-4, rtol=0, err_msg=key)
        moved += not torch.equal(want, case["state_dict"][key])
    assert moved > 20


@pytest.mark.parametrize("name", ["tta", "tta_target", "window", "window_tta"])
def test_sharded_tta_and_windows_match_jax_serial(parallel_run, name):
    """sharded_tta_probs (the 16 combos round-robin over 2 ranks; probs,
    and the loss with a target) and sharded_sliding_window (windows d::2 of
    a three-window grid; plain and under TTA) against the JAX package's
    serial tta_mean_probs / sliding_window_inference within 1e-5, and the
    port's serial ones within 1e-6 (the ranks' partial sums only reorder
    the additions)."""
    from brats21_tpu.ops.sliding_window import sliding_window_inference as jsw
    from brats21_tpu.ops.tta import main_head, tta_mean_probs as jtta
    from brats21_tpu_torch.learning.engine import forward_channels_last
    from brats21_tpu_torch.ops.sliding_window import sliding_window_inference
    from brats21_tpu_torch.ops.tta import tta_mean_probs
    cfg = parallel_run["cfg"]
    jmodel = jax_get_model(cfg)
    variables = jax.tree_util.tree_map(jnp.asarray, parallel_run["raw"])
    model = _port_from(parallel_run["raw"], cfg).eval()
    x, seg = parallel_run["x"], parallel_run["seg"]

    def japply(v):
        return jmodel.apply(variables, v)

    def papply(v, with_deep=False):
        return forward_channels_last(model, v, with_deep=with_deep)

    def jwindows(v):
        return jsw(v, ROI, lambda w: main_head(japply(w)), sw_batch_size=2)

    def pwindows(v):
        return sliding_window_inference(v, ROI, papply, sw_batch_size=2)

    xt = torch.from_numpy(x)
    with torch.inference_mode():
        if name == "tta":
            want, _ = jtta(japply, jnp.asarray(x))
            serial, _ = tta_mean_probs(papply, xt)
        elif name == "tta_target":
            want, wloss = jtta(japply, jnp.asarray(x), criterion=jlosses.make_criterion(cfg),
                               target=jnp.asarray(seg))
            serial, sloss = tta_mean_probs(lambda v: papply(v, True), xt,
                                           criterion=plosses.make_criterion(cfg),
                                           target=_ncdhw(seg))
        elif name == "window":
            want, serial = jax.nn.sigmoid(jwindows(jnp.asarray(x))), torch.sigmoid(pwindows(xt))
        else:
            want, _ = jtta(jwindows, jnp.asarray(x))
            serial, _ = tta_mean_probs(pwindows, xt)
    for r in parallel_run["ranks"]:
        got = r["sharded_inference"][name]
        if name == "window":
            got = torch.sigmoid(got)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got.numpy(), serial.numpy(), atol=1e-6, rtol=0)
        if name == "tta_target":
            loss = r["sharded_inference"]["tta_loss"]
            np.testing.assert_allclose(loss, float(wloss), rtol=1e-5)
            np.testing.assert_allclose(loss, float(sloss), rtol=1e-6)


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


@pytest.mark.parametrize("mode", sorted(EVAL_MODES))
def test_engine_parallel_modes_match_jax_serial(parallel_run, mode, tmp_path):
    """The engine on 2 ranks — cases striped (three cases, no TTA), a
    two-member STAPLE ensemble with its members striped, the same with
    ``BRATS21_STAPLE_SERIAL`` set (each rank runs both members), and the
    TTA combos striped (one case, and two cases at one and at two in
    flight) — against the JAX package's serial engine on one
    device (its member-striped STAPLE is not called): the loss within 1e-4
    relative, the metrics and report rows within 1e-5 (1e-4 under TTA: the
    ranks' partial sums reorder the 16-combo mean, which may move a voxel
    at the 0.5 threshold, and one voxel moves this case's ET Dice by
    1.4e-5), the label maps on ≥ 99.9 % of voxels; both ranks return the
    node's meters and rows, and each case is written once."""
    n_members, seeds, kw, _, parallel_mode = EVAL_MODES[mode]
    jcfg = JaxTrainConfig(**EVAL_CFG, wire="dense")
    jengine = JaxEngine(jcfg, jax_get_model(parallel_run["cfg"]),
                        jlosses.make_criterion(jcfg),
                        mesh=make_mesh(jax.devices()[:1], data=1, space=1))
    report = JaxReport()
    want = jengine.evaluate(parallel_run["members"][:n_members],
                            _Loader(parallel_run["batches"][mode]), 0, save_seg=True,
                            output_path=str(tmp_path), report=report, **kw)
    ids = sorted(f"case{s}" for s in seeds)
    tol = 1e-4 if kw.get("use_tta") else 1e-5
    for r in parallel_run["ranks"]:
        got = r["engine_eval"][mode]
        assert got["parallel_mode"] == parallel_mode
        np.testing.assert_allclose(got["meters"]["loss"][0], want["loss"].avg, rtol=1e-4)
        assert got["meters"]["loss"][1] == len(seeds)
        for k in ["dice"] + METRICS:
            np.testing.assert_allclose(got["meters"][k][0], want[k].avg, atol=tol, rtol=0,
                                       err_msg=k)
        assert sorted(got["rows"]) == sorted(report.rows) == ids
        for pid, row in report.rows.items():
            np.testing.assert_allclose([got["rows"][pid][c] for c in row], list(row.values()),
                                       atol=tol, rtol=0, err_msg=pid)
    saved = [r["engine_eval"]["saved"][mode] for r in parallel_run["ranks"]]
    assert sorted(saved[0] + saved[1]) == ids
    if mode != "case_parallel":
        assert saved[1] == []                   # local rank 0 writes
    out = parallel_run["out"] / "engine" / mode
    for pid in ids:
        got_seg = read_nifti(str(out / f"{pid}.nii.gz")).data
        want_seg = read_nifti(str(tmp_path / f"{pid}.nii.gz")).data
        assert got_seg.shape == want_seg.shape == (36, 18, 9)
        assert (got_seg == want_seg).mean() >= 0.999


def test_engine_tta_striped_depth_invariant(parallel_run):
    """Two cases' TTA combos striped over 2 ranks, with two cases in flight
    (case 2 enqueued, its combos' collectives issued, before case 1 is
    collected) and with one: the same meters, report rows and NIfTI bytes
    on both ranks, each case written once, by local rank 0."""
    out = parallel_run["out"] / "engine"
    segs = {}
    for mode in ("tta_depth1", "tta_depth2"):
        segs[mode] = {f.name: gzip.decompress(f.read_bytes())
                      for f in sorted((out / mode).glob("*.nii.gz"))}
        for r in parallel_run["ranks"]:
            assert r["engine_eval"]["saved"][mode] == (
                ["case4", "case5"] if r is parallel_run["ranks"][0] else [])
    assert sorted(segs["tta_depth1"]) == ["case4.nii.gz", "case5.nii.gz"]
    assert segs["tta_depth1"] == segs["tta_depth2"]
    for r in parallel_run["ranks"]:
        one, two = r["engine_eval"]["tta_depth1"], r["engine_eval"]["tta_depth2"]
        assert list(one["rows"]) == list(two["rows"]) == ["case4", "case5"]
        for pid, row in one["rows"].items():
            assert list(two["rows"][pid]) == list(row)
            np.testing.assert_array_equal(list(two["rows"][pid].values()), list(row.values()),
                                          err_msg=pid)
        assert sorted(one["meters"]) == sorted(two["meters"])
        for k, (avg, count) in one["meters"].items():
            np.testing.assert_array_equal(two["meters"][k][0], avg, err_msg=k)
            assert two["meters"][k][1] == count == 2


# ------------------------------------------------------- (e) across nodes

def test_merges_across_two_nodes(tmp_path):
    """Two nodes of one rank (c10d rendezvous on localhost), node 1's eval
    stripe empty, as tests/test_multihost.py holds the JAX package's:
    gather_objects in node order, merge_meters exact with count-0 stripes
    and keys unioned, merge_report_rows' union, any_rank, and each node's
    train and eval stripes."""
    ranks = _launch({"kinds": ["merges"], "merges": {}}, tmp_path, nproc=1, nnodes=2)
    for node, r in enumerate(ranks):
        got = r["merges"]
        assert got["nodes"] == 2
        assert got["gathered"] == [{"node": 0, "payload": [0]}, {"node": 1, "payload": [1, 1]}]
        np.testing.assert_allclose(got["meters"]["loss"][0], (0.5 + 3.0) / 3)
        assert got["meters"]["loss"][1] == 3
        np.testing.assert_allclose(got["meters"]["dice"][0], [0.2, 0.4, 0.6])
        assert got["meters"]["extra"] == (np.asarray(3.0), 1)
        assert sorted(got["rows"]) == ["case_0", "case_2"]
        assert got["rows"]["case_2"]["dice_WT"] == pytest.approx(0.3)
        assert got["any_rank"] is True and got["none_rank"] is False
        assert got["shard"] == jmultihost.process_shard(list(range(5)), node, 2)
        assert got["eval_shard"] == list(range(5))[node::2]


# ------------------------------------------------------------- (f, g) CLIs

@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_cli_data")
    generate_synthetic_dataset(str(root / "four"), num_cases=4, shape=(30, 28, 24), seed=41)
    generate_synthetic_dataset(str(root / "five"), num_cases=5, shape=(30, 28, 24), seed=42)
    return root


TRAIN_FLAGS = ["--model", "equiunet_assp_evo", "--width", "4", "--criterion", "dice_hd",
               "--optimizer", "ranger", "--learning_rate", "1e-3", "--epochs", "1",
               "--patch_size", "16", "16", "16", "--num_workers", "1", "--no_tensorboard",
               "--device", "cpu", "--no_amp"]


def test_train_cli_on_two_ranks(cli_data, tmp_path):
    """The train CLI under torchrun on 2 ranks, 2 steps of a node batch of
    2 (one sample a rank): one run directory (named on the primary's clock)
    with its config, log and checkpoints, the two ranks' parameters equal
    and equal to the checkpoint's, and each step's global loss (the ranks'
    mean) that of the one-process run within 1e-5 relative."""
    from brats21_tpu_torch.cli.main_train import main as train_main
    argv = ["--train_data_path", str(cli_data / "four"), "--fold", "None",
            "--batch_size", "2", *TRAIN_FLAGS]
    ranks = _launch({"kinds": ["train_cli"], "train_cli": {
        "argv": argv + ["--save_path", str(tmp_path / "two")]}}, tmp_path / "job")
    runs = [p for p in (tmp_path / "two").iterdir() if p.is_dir()]
    assert len(runs) == 1
    for name in ("config.yaml", "logfile.log", "best_model.pth", "last_model.pth"):
        assert (runs[0] / name).exists(), name
    got = [r["train_cli"] for r in ranks]
    assert len(got[0]["losses"]) == 2
    saved = torch.load(runs[0] / "last_model.pth", weights_only=True)["model"]
    for key, value in got[0]["params"].items():
        torch.testing.assert_close(value, got[1]["params"][key], rtol=0, atol=0)
        torch.testing.assert_close(value, saved[key], rtol=0, atol=0)
    one = train_main(argv + ["--save_path", str(tmp_path / "one")])
    np.testing.assert_allclose(got[0]["result"]["train_loss"], one["train_loss"], rtol=1e-5)


def test_fold_parallel_cli_on_two_ranks(cli_data, tmp_path):
    """main_train_folds on 2 ranks (folds 0, 2, 4 on rank 0 and 1, 3 on
    rank 1) writes the five fold_<f> directories with config.yaml and
    checkpoints; each fold's parameters equal a one-process run's (which
    loops all five), and folds 0 and 1 differ. Rank 0 sleeps past the
    collectives' timeout after its epoch, so rank 1 waits at the end longer
    than a barrier would, and the run still ends well."""
    from brats21_tpu_torch.cli.main_train_folds import main as folds_main
    argv = ["--train_data_path", str(cli_data / "five"), "--batch_size", "1",
            "--val_frequency", "1", *TRAIN_FLAGS]
    timeout = 10
    ranks = _launch({"kinds": ["folds_cli"], "folds_cli": {
        "argv": argv + ["--save_path", str(tmp_path / "two")], "sleep_s": timeout + 2}},
        tmp_path / "job", env={multihost.TIMEOUT_ENV: str(timeout)})
    assert [sorted(r["folds_cli"]["history"]) for r in ranks] == [[0, 2, 4], [1, 3]]
    assert ranks[1]["folds_cli"]["seconds"] > timeout
    folds_main(argv + ["--save_path", str(tmp_path / "one")])
    dirs = {}
    for side in ("two", "one"):
        base, = glob.glob(str(tmp_path / side / "*_folds"))
        dirs[side] = sorted(glob.glob(os.path.join(base, "fold_*")))
        assert [os.path.basename(d) for d in dirs[side]] == [f"fold_{f}" for f in range(5)]
        for d in dirs[side]:
            for name in ("config.yaml", "best_model.pth", "last_model.pth"):
                assert os.path.exists(os.path.join(d, name)), (d, name)
    params = []
    for two, one in zip(dirs["two"], dirs["one"]):
        a = torch.load(os.path.join(two, "last_model.pth"), weights_only=True)["model"]
        b = torch.load(os.path.join(one, "last_model.pth"), weights_only=True)["model"]
        for key in a:
            torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
        params.append(a)
    assert any(not torch.equal(params[0][k], params[1][k]) for k in params[0])
