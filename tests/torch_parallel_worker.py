"""One rank of the port's parallel tests (``test_torch_port_parallel.py``,
``test_torch_port_spatial.py``), started by ``torch.distributed.run`` on
the CPU with gloo:

    python -m torch.distributed.run --nproc_per_node 2 ... tests/torch_parallel_worker.py JOB

``JOB`` is a ``torch.save``d dict: ``kind`` names what to run, ``out`` the
folder where each rank writes ``rank<r>.pt``, ``space`` (1 unless given)
the ranks of a space row. The inputs (weights as the
port's state dicts, volumes as arrays) come made by the test, so this
process imports neither JAX nor the test's helpers.
"""

from __future__ import annotations

import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

torch.set_num_threads(1)

from brats21_tpu_torch.parallel import multihost  # noqa: E402
from brats21_tpu_torch.parallel.mesh import init_topology  # noqa: E402


def _ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _model(cfg, state_dict):
    """``get_model(cfg)``, or a UNETR of ``cfg["unetr"]``'s size, with the
    weights."""
    from brats21_tpu_torch.models import get_model
    from brats21_tpu_torch.models.unetr import UNETR
    model = UNETR(**cfg["unetr"]) if "unetr" in cfg else get_model(cfg)
    model.load_state_dict(state_dict, strict=True)
    return model


def ddp_steps(job, topo):
    """One data-parallel train step a case of ``job["cases"]``: each rank
    takes its slice of the batch; returns each case's loss and parameters."""
    from torch.nn.parallel import DistributedDataParallel
    from brats21_tpu_torch.learning import losses
    from brats21_tpu_torch.learning.optimizers import make_optimizer
    from brats21_tpu_torch.learning.train_state import TrainState, TrainStep
    out = {}
    for name, case in job["cases"].items():
        model = _model(case["cfg"], case["state_dict"])
        opt = make_optimizer(SimpleNamespace(**case["opt"]), model.parameters(), 1)
        state = TrainState(model, opt, ddp=DistributedDataParallel(
            model, broadcast_buffers=False, static_graph=True))
        step = TrainStep(losses.make_criterion(case["cfg"]), use_amp=False,
                         rank=topo.rank, sharded_over=topo.batch_group)
        part = topo.shard_batch(case["img"].shape[0])
        metrics = step(state, _ncdhw(case["img"][part]), _ncdhw(case["seg"][part]),
                       sharded=True)
        out[name] = dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                         params={k: v.clone() for k, v in model.state_dict().items()})
    return out


def sharded_inference(job, topo):
    """TTA- and window-parallel probabilities (and losses) of one volume."""
    from brats21_tpu_torch.learning.engine import forward_channels_last
    from brats21_tpu_torch.learning.losses import make_criterion
    from brats21_tpu_torch.ops.tta import tta_mean_probs
    from brats21_tpu_torch.parallel.distributed import (sharded_sliding_window,
                                                        sharded_tta_probs)
    model = _model(job["cfg"], job["state_dict"]).eval()
    local = (topo.local_group, topo.local_rank, topo.local_size)
    x = torch.from_numpy(job["x"])
    target = _ncdhw(job["seg"])
    criterion = make_criterion(job["cfg"])
    roi = job["roi"]

    def apply(v, with_deep=False):
        return forward_channels_last(model, v, with_deep=with_deep)

    def windows(v):
        return sharded_sliding_window(v, roi, apply, local, 3)

    with torch.inference_mode():
        probs, _ = sharded_tta_probs(apply, x, local)
        probs_t, loss_t = sharded_tta_probs(lambda v: apply(v, True), x, local,
                                            criterion=criterion, target=target)
        window = windows(x)
        window_tta, _ = tta_mean_probs(windows, x)
    return dict(tta=probs, tta_target=probs_t, tta_loss=float(loss_t), window=window,
                window_tta=window_tta)


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def engine_eval(job, topo):
    """The engine's case-parallel and member-striped STAPLE evaluations."""
    from brats21_tpu_torch.config import TrainConfig
    from brats21_tpu_torch.learning.engine import Engine
    from brats21_tpu_torch.learning.losses import make_criterion
    from brats21_tpu_torch.utils.reporting import EvaluationReport
    cfg = TrainConfig(**job["train_cfg"])
    engine = Engine(cfg, topo.device, criterion=make_criterion(cfg), topo=topo)
    members = [_model(job["cfg"], sd).eval() for sd in job["members"]]
    # a mode may name members of another model
    mode_members = {mode: [_model(cfg, sd).eval() for sd in sds]
                    for mode, (cfg, sds) in job.get("mode_members", {}).items()}
    out = {"saved": {}}
    save = engine._save_segmentation

    def record(batch, *args):
        out["saved"][mode].append(batch["patient_id"][0])
        return save(batch, *args)

    engine._save_segmentation = record
    choose = engine._parallel_mode

    def chosen(*args):
        out[mode]["parallel_mode"] = choose(*args)
        return out[mode]["parallel_mode"]

    engine._parallel_mode = chosen
    for mode, (n_members, kw, env) in job["modes"].items():
        out["saved"][mode], out[mode] = [], {}
        report = EvaluationReport()
        os.environ.update(env)
        try:
            meters = engine.evaluate(mode_members.get(mode, members)[:n_members],
                                     _Loader(job["batches"][mode]), 0,
                                     save_seg=True, output_path=os.path.join(job["out"], mode),
                                     report=report, **kw)
        finally:
            for key in env:
                del os.environ[key]
        out[mode].update(meters={k: (np.asarray(m.avg), m.count) for k, m in meters.items()
                                 if k not in ("batch_time", "data_time")},
                         rows=report.rows)
    return out


def merges(job, topo):
    """multihost's primitives across nodes, node 1's stripe empty."""
    from brats21_tpu_torch.utils.meter import AverageMeter
    from brats21_tpu_torch.utils.reporting import EvaluationReport
    node = multihost.process_index()
    gathered = multihost.gather_objects({"node": node, "payload": [node] * (node + 1)})
    meters = {"loss": AverageMeter("loss"), "dice": AverageMeter("dice")}
    if node == 0:
        meters["loss"].update(0.5)
        meters["loss"].update(1.5, n=2)
        meters["dice"].update(np.array([0.2, 0.4, 0.6]))
        meters["extra"] = AverageMeter("extra")
        meters["extra"].update(3.0)
    multihost.merge_meters(meters)
    report = EvaluationReport()
    if node == 0:
        report.add("case_0", {"dice": np.array([0.1, 0.2, 0.3])})
        report.add("case_2", {"dice": np.array([0.3, 0.2, 0.1])})
    multihost.merge_report_rows(report)
    return dict(gathered=gathered, nodes=multihost.process_count(),
                meters={k: (np.asarray(m.avg), m.count) for k, m in meters.items()},
                rows=report.rows, any_rank=multihost.any_rank(node == 1),
                none_rank=multihost.any_rank(False),
                shard=multihost.process_shard(list(range(5))),
                eval_shard=multihost.shard_eval_records(list(range(5))))


def train_cli(job, topo):
    """The train CLI, with each step's loss and the final parameters."""
    from brats21_tpu_torch.cli import main_train
    from brats21_tpu_torch.learning.train_state import TrainStep
    seen = {}
    call = TrainStep.__call__

    def probe(self, state, *args, **kw):
        metrics = call(self, state, *args, **kw)
        seen.setdefault("losses", []).append(float(metrics["loss"]))
        seen["state"] = state
        return metrics

    TrainStep.__call__ = probe
    try:
        result = main_train.main(job["argv"])
    finally:
        TrainStep.__call__ = call
    return dict(result=result, losses=seen["losses"],
                params={k: v.clone() for k, v in seen["state"].model.state_dict().items()})


def folds_cli(job, topo):
    """The fold-parallel CLI; the rank that holds the most folds sleeps
    ``sleep_s`` after each epoch, so the others wait longer for it at the
    end than a barrier's timeout allows."""
    import time
    from brats21_tpu_torch.cli import main_train_folds
    epoch = main_train_folds.train_folds_epoch

    def slow(folds, *args, **kw):
        losses = epoch(folds, *args, **kw)
        if topo.rank == 0:
            time.sleep(job["sleep_s"])
        return losses

    main_train_folds.train_folds_epoch = slow
    t0 = time.time()
    history = main_train_folds.main(job["argv"])
    return dict(history=history, seconds=time.time() - t0)


def spatial(job, topo):
    """The volume sharded over this rank's space row: the topology's axes,
    halo exchanges and sharded convs of X-sharded volumes (every rank's
    result gathered), single layers and the models' forwards on Z slabs,
    and the engine's member forward on a slab."""
    from brats21_tpu_torch.config import TrainConfig
    from brats21_tpu_torch.learning.engine import Engine
    from brats21_tpu_torch.learning.losses import make_criterion
    from brats21_tpu_torch.parallel import spatial as sp
    from brats21_tpu_torch.parallel.distributed import (halo_exchange, sharded_conv3d,
                                                        spatial_sharded_forward)
    r, n, group = topo.space_rank, topo.space, topo.space_group
    out = dict(axes=(topo.data_rank, topo.data_size, r, n),
               row=multihost.gather_objects(topo.rank, group), halo={}, conv={}, layers={},
               forward={})
    for key, (x, halo, sizes) in job["halo"].items():
        start = sum(sizes[:r])
        mine = torch.from_numpy(x)[:, :, start:start + sizes[r]]
        out["halo"][key] = halo_exchange(mine, halo, group, dim=2, sizes=sizes)
    for key, (x, w) in job["conv"].items():
        per = x.shape[2] // n
        mine = torch.from_numpy(x)[:, :, r * per:(r + 1) * per]
        y = sharded_conv3d(mine, torch.from_numpy(w), group)
        out["conv"][key] = sp.gather_planes(y, group, 2, [per] * n)
    for key, (module, x) in job["layers"].items():
        bounds = sp.slab_bounds(x.shape[4], n)
        slab = sp.Slab(group, r, tuple(bounds), x.shape[2], sp.BLOCK)
        mine = torch.from_numpy(x)[..., bounds[r]:bounds[r + 1]].contiguous(
            memory_format=torch.channels_last_3d)
        with torch.no_grad(), sp.sharded(slab):
            y = module.eval()(mine)
            if y.dim() == 5:
                y = sp.gather_planes(y, group, 4, slab.level(y)[1])
        out["layers"][key] = y
    for key, case in job["forward"].items():
        model = _model(case["cfg"], case["state_dict"]).eval()
        x = torch.from_numpy(case["x"])
        try:
            out["forward"][key] = dict(
                full=spatial_sharded_forward(model, x, topo, full_outputs=True, no_amp=True))
            if case.get("main", True):
                out["forward"][key]["main"] = spatial_sharded_forward(model, x, topo,
                                                                      no_amp=True)
        except ValueError as e:
            out["forward"][key] = dict(error=str(e))
    if "member" in job:
        m = job["member"]
        cfg = TrainConfig(**m["train_cfg"])
        engine = Engine(cfg, topo.device, criterion=make_criterion(cfg), topo=topo)
        model = _model(m["cfg"], m["state_dict"]).eval()
        with torch.inference_mode():
            probs, loss = engine.member_probs(model, torch.from_numpy(m["x"]),
                                              target=_ncdhw(m["seg"]), spatial=True)
        out["member"] = dict(probs=probs, loss=float(loss))
    return out


JOBS = dict(folds_cli=folds_cli, ddp_steps=ddp_steps, sharded_inference=sharded_inference,
            engine_eval=engine_eval, merges=merges, train_cli=train_cli, spatial=spatial)


def main(path):
    job = torch.load(path, weights_only=False)
    topo = init_topology("cpu", space=job.get("space", 1))
    out = {kind: JOBS[kind](job[kind], topo) for kind in job["kinds"]}
    torch.save(out, os.path.join(job["out"], f"rank{topo.rank}.pt"))
    multihost.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
