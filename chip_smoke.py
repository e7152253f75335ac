#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``brats21_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. build the hand-written kernels from the sources in this checkout (the
   CUDA conv, EvoNorm and EDT envelope, one nvcc each, all at once), and
   print each library's build time;
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the served case gives it, and time kernel, plain version and,
   where one exists, the one PyTorch call computing the same function,
   with each shape's launch plan (the conv's grid and split-K count,
   EvoNorm's blocks and channel vector);
3. hold the width-48 model on the card (kernels) against the same model on
   the CPU (plain versions), fp32;
4. the main path: the inference CLI (``--on test --cleaning_areas
   --replace_value``, bf16) on a synthetic 240×240×155 case with seeded
   random width-48 weights; the kernels' launch counters are zeroed just
   before and read just after, and must show one forward (14 convs, 21
   EvoNorms);
5. the same case through the CLI with ``--tta`` (16 forwards);
6. where one served case's time goes, stage by stage;
7. the EDT envelope kernels (the mask pass, the general pass) against
   their plain version, the scan, on every axis pass of ``edt_sq``: bit for
   bit over the train step's masks (3×128³ and its one batch of 12×128³),
   the full case's six masks (6×240×240×155) and hand-made edge lines;
   within rtol 1e-6 over a 240×240×155 mask with sampling (1, 1, 1.5);
   ``edt_sq`` against scipy on the host; each pass's time beside its bound;
8. the trainable conv3x3x3 and EvoNorm-S0 (``autograd.Function``s) against
   autograd of their plain versions on the card, at the train step's
   level-1 and level-4 shapes, bf16 and fp32;
9. the training path through the train CLI: EquiUnetASSPEvo w48, 128³
   patches, ``--criterion dice_hd --optimizer ranger --decay_type cosine
   --use_gc --remove_outliers``, one epoch over four synthetic 240×240×155
   cases; the counters are zeroed before each step's forward and read after
   it and after its backward and optimizer step (14 / 21 / 3 launches
   forward, none backward); then the inference CLI serves the trained
   ``best_model.pth``;
10. where one train step's time goes: forward, loss (of which the EDT
    maps), backward and optimizer, by CUDA events;
11. the train CLI with ``--criterion dice_boundary`` over two of phase 9's
    cases: the loader makes each case's distance map on the card (3 EDT
    launches a case, every EDT launch of the run), the steps launch 14 / 21
    / 0; a finite loss.

It prints the card's name and power limit, one ``{"kernels": [...]}`` JSON
line, and last ``{"ok": true, "device": {...}}``. It imports nothing of JAX.
Data and builds go under ``brats21_tpu_torch/_build/`` in this checkout.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SEED = 20211
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 CUDA
# cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# EvoNorm operations per element: x − mean, square, two adds (statistics);
# exp, add, reciprocal (sigmoid), three multiplies and an add (output)
EVONORM_OPS = 11
CASE_SHAPE = (240, 240, 155)
PATCH = (128, 128, 128)         # the train step's patch (arguments.py:52-53)
# EDT operations per output of one envelope pass. The function needs the
# O(n) lower envelope of parabolas (Felzenszwalb & Huttenlocher): per
# output at most two intersections (two squares, two adds, a subtract, a
# doubling, a divide each), the compares of its push and fill loops, and
# ((i − v)·s)² + f[v]; about 25. The kernel's O(n²) scan, 4 per candidate
# ((i − j)·s, its square, the add and the min), gives the scan bound kept
# beside it.
EDT_ENVELOPE_OPS = 25
EDT_SCAN_OPS = 4
# launches per train step: the EDT maps of the target and the three heads
# are one edt_sq batch (the mask pass and two general passes)
TRAIN_STEP_LAUNCHES = dict(conv3x3x3=14, evonorm_s0=21, edt_envelope=3)
# dice_boundary: no EDT in the step; the loader's one_hot2dist makes one
# edt_sq batch (3 channels, negative and positive) a case
BOUNDARY_STEP_LAUNCHES = dict(conv3x3x3=14, evonorm_s0=21)
EDT_LAUNCHES_PER_LOADED_CASE = 3
# per forward of EquiUnetASSPEvo w48: (level, C_in, C_out, count) of the 3³
# convs and (level, C, count) of the EvoNorms; level l is the padded case
# shape // 2**(l-1)
CONV_CALLS = [(1, 4, 48, 1), (1, 48, 48, 3), (2, 96, 96, 4), (3, 192, 192, 4),
              (4, 384, 384, 2)]
EVONORM_CALLS = [(1, 48, 4), (1, 24, 1), (2, 96, 4), (2, 48, 1), (2, 24, 1),
                 (3, 192, 4), (3, 96, 1), (3, 48, 1), (4, 384, 3), (4, 96, 1)]


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def time_ms(fn, iters: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` runs (CUDA events), after
    one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(ops: float, peak_ops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_conv(level_shape, dev) -> dict:
    """conv3x3x3 vs its plain version at the main path's shapes (bf16) and
    on a 40³ block (fp32)."""
    import torch
    import torch.nn.functional as F
    from brats21_tpu_torch.ops.kernels.conv3d import conv3x3x3, conv3x3x3_plain, conv_plan
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows, total = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                           ops_ms=0.0, bytes_ms=0.0, max_abs_err=0.0)
    for level, cin, cout, count in CONV_CALLS:
        d, h, w = level_shape(level)
        err32 = None
        for dtype, spatial in ((torch.float32, (40, 40, 40)), (torch.bfloat16, (d, h, w))):
            x = torch.randn((1, *spatial, cin), generator=gen, device=dev).to(dtype)
            wt = (torch.randn((3, 3, 3, cin, cout), generator=gen, device=dev)
                  / math.sqrt(27 * cin)).to(dtype)
            b = 0.1 * torch.randn((cout,), generator=gen, device=dev)
            y = conv3x3x3(x, wt, b)
            ref = conv3x3x3_plain(x.float(), wt.float(), b)
            err = (y.float() - ref).abs().max().item()
            tol = (1e-2 if dtype == torch.bfloat16 else 1e-4) * ref.abs().max().item()
            if not err <= tol:
                raise AssertionError(f"conv3x3x3 {cin}->{cout} {dtype} at {spatial}: "
                                     f"max |err| {err:.3g} > tol {tol:.3g}")
            if dtype != torch.bfloat16:
                err32 = err
                continue
            m = d * h * w
            ops = 2.0 * m * cout * 27 * cin
            nbytes = 2.0 * (m * cin + m * cout + 27 * cin * cout) + 4.0 * cout
            b_ms, _ = bound(ops, PEAK_BF16, nbytes)
            x_cl = x.permute(0, 4, 1, 2, 3)
            w_oi = wt.permute(4, 3, 0, 1, 2).contiguous()
            b_bf = b.to(dtype)
            plan = conv_plan(1, d, h, w, cin, cout)
            grid = [plan.bricks, plan.n_tiles, plan.splits]
            row = dict(shape=[1, d, h, w, cin, cout], count=count, grid=grid, max_abs_err=err,
                       tolerance=tol, max_abs_err_fp32_40cubed=err32,
                       ms=time_ms(lambda: conv3x3x3(x, wt, b)),
                       plain_ms=time_ms(lambda: conv3x3x3_plain(x, wt, b)),
                       library_ms=time_ms(lambda: F.conv3d(x_cl, w_oi, b_bf, padding=1)),
                       bound_ms=b_ms)
            rows.append(row)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                total[k] += count * row[k]
            total["ops_ms"] += count * ops / PEAK_BF16 * 1e3
            total["bytes_ms"] += count * nbytes / PEAK_BYTES * 1e3
            total["max_abs_err"] = max(total["max_abs_err"], err)
            log(f"conv3x3x3 {cin}->{cout} at {d}x{h}x{w}: grid {plan.bricks} bricks x "
                f"{plan.n_tiles} N tiles of {plan.bn} x split-K {plan.splits}; err {err:.3g} "
                f"(tol {tol:.3g}) kernel {row['ms']:.4f} ms, cuDNN {row['library_ms']:.4f} ms, "
                f"bound {b_ms:.4f} ms ({100 * b_ms / row['ms']:.1f} %), "
                f"plain {row['plain_ms']:.4f} ms")
            del x, wt, y, ref, x_cl, w_oi
    return dict(rows=rows, **total)


def check_evonorm(level_shape, dev) -> dict:
    """evonorm_s0 vs its plain version at the main path's shapes (bf16) and
    on a 40³ block (fp32)."""
    import torch
    from brats21_tpu_torch.ops.kernels.evonorm import evonorm_plan, evonorm_s0, evonorm_s0_plain
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows, total = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0,
                           bytes_ms=0.0, max_abs_err=0.0)
    for level, c, count in EVONORM_CALLS:
        d, h, w = level_shape(level)
        gamma = 1.0 + 0.1 * torch.randn((c,), generator=gen, device=dev)
        beta = 0.1 * torch.randn((c,), generator=gen, device=dev)
        err32 = None
        for dtype, spatial in ((torch.float32, (40, 40, 40)), (torch.bfloat16, (d, h, w))):
            x = (0.5 + 2.0 * torch.randn((1, *spatial, c), generator=gen,
                                         device=dev)).to(dtype)
            y = evonorm_s0(x, gamma, beta)
            ref = evonorm_s0_plain(x.float(), gamma, beta)
            diff = (y.float() - ref).abs()
            err = diff.max().item()
            if dtype == torch.bfloat16:
                # one bf16 rounding of the output: half an ulp, 2**-9 |ref|;
                # allow a full ulp
                ok = bool((diff <= 2.0 ** -8 * ref.abs() + 1e-6).all())
                tol = "2**-8*|ref|"
            else:
                tol = 1e-5
                ok = err <= tol
            if not ok:
                raise AssertionError(f"evonorm_s0 C={c} {dtype} at {spatial}: "
                                     f"max |err| {err:.3g} over tol {tol}")
            if dtype != torch.bfloat16:
                err32 = err
                continue
            m = d * h * w
            b_ms, _ = bound(EVONORM_OPS * m * c, PEAK_FP32, 4.0 * m * c + 8.0 * c)
            plan = evonorm_plan(1, m, c, x.element_size())
            row = dict(shape=[1, d, h, w, c], count=count,
                       blocks=dict(stats=plan.blocks, apply=plan.apply_blocks),
                       channels_per_thread=plan.vec, max_abs_err=err,
                       tolerance=tol, max_abs_err_fp32_40cubed=err32,
                       ms=time_ms(lambda: evonorm_s0(x, gamma, beta)),
                       plain_ms=time_ms(lambda: evonorm_s0_plain(x, gamma, beta)),
                       library_ms=None, bound_ms=b_ms)
            rows.append(row)
            for k in ("ms", "plain_ms", "bound_ms"):
                total[k] += count * row[k]
            total["ops_ms"] += count * EVONORM_OPS * m * c / PEAK_FP32 * 1e3
            total["bytes_ms"] += count * (4.0 * m * c + 8.0 * c) / PEAK_BYTES * 1e3
            total["max_abs_err"] = max(total["max_abs_err"], err)
            log(f"evonorm_s0 C={c} at {d}x{h}x{w}: grid {plan.blocks} stats / "
                f"{plan.apply_blocks} apply blocks, {plan.vec} channels a thread; "
                f"err {err:.3g} kernel {row['ms']:.4f} ms, "
                f"bound {b_ms:.4f} ms ({100 * b_ms / row['ms']:.1f} %), "
                f"plain {row['plain_ms']:.4f} ms")
            del x, y, ref, diff
    return dict(rows=rows, **total)


def check_model(dev) -> None:
    """EquiUnetASSPEvo w48 at 1×4×48³ fp32: card (kernels) vs CPU (plain)."""
    import copy

    import numpy as np
    import torch
    from brats21_tpu_torch.models import get_model
    torch.manual_seed(SEED)
    cpu_model = get_model({"model": "equiunet_assp_evo", "width": 48}).eval()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    x = np.random.default_rng(SEED).standard_normal((1, 4, 48, 48, 48)).astype(np.float32)
    xt = torch.from_numpy(x).contiguous(memory_format=torch.channels_last_3d)
    with torch.inference_mode():
        want, want_deeps = cpu_model(xt)
        got, got_deeps = gpu_model(xt.to(dev))
    for name, g, w_ in [("main", got, want)] + [
            (f"deep{i}", g, w_) for i, (g, w_) in enumerate(zip(got_deeps, want_deeps))]:
        g = g.float().cpu()
        if not torch.isfinite(g).all():
            raise AssertionError(f"model {name}: non-finite output on the card")
        if not torch.allclose(g, w_, atol=1e-3, rtol=1e-3):
            raise AssertionError(f"model {name}: card vs CPU max |diff| "
                                 f"{(g - w_).abs().max().item():.3g} > 1e-3")
        log(f"model w48 {name} {tuple(g.shape)}: card vs CPU max |diff| "
            f"{(g - w_).abs().max().item():.3g}")


def tf32_default() -> None:
    """Put TF32 back to PyTorch's default (on for cuDNN) before a CLI runs:
    the CLI must turn it off itself (:func:`check_tf32_off`)."""
    import torch
    torch.backends.cudnn.allow_tf32 = True


def check_tf32_off(cli: str) -> None:
    import torch
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError(f"the {cli} CLI ran on the card with TF32 on")


def run_cli(argv, dev) -> dict:
    """The inference CLI with the kernels' counters zeroed just before and
    read just after."""
    import torch
    from brats21_tpu_torch.cli.main_inference import main
    from brats21_tpu_torch.ops.kernels import conv3d, edt, evonorm
    mods = dict(conv3x3x3=conv3d, evonorm_s0=evonorm, edt_envelope=edt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tf32_default()
    for m in mods.values():
        m.launches = 0
    t0 = time.time()
    case_times = main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    check_tf32_off("inference")
    counts = {k: m.launches for k, m in mods.items()}
    return dict(wall_s=wall, case_s=case_times, launches=counts,
                peak_bytes=torch.cuda.max_memory_allocated(dev))


def stage_breakdown(model, data: Path, out: Path, dev) -> dict:
    """Where one served case's time goes (no TTA): the engine's own steps
    run one by one, each ended by a synchronise and timed on the host
    clock, then the device time of one forward by CUDA events."""
    import argparse

    import numpy as np
    import torch
    from brats21_tpu_torch.cli.main_inference import post_kwargs_from_cfg
    from brats21_tpu_torch.data.pipeline import make_test_loader
    from brats21_tpu_torch.learning.engine import Engine
    from brats21_tpu_torch.ops.postprocess import post_process
    cfg = argparse.Namespace(no_amp=False, num_classes=3, test_data_path=str(data),
                             num_workers=0, cleaning_areas=True, replace_value=True)
    engine = Engine(cfg, dev)
    stages = {}
    t = time.time()

    def mark(name):
        nonlocal t
        torch.cuda.synchronize()
        stages[name] = time.time() - t
        t = time.time()

    batch = next(iter(make_test_loader(cfg)))
    mark("decode_crop_normalise")
    with torch.inference_mode():
        padded, p_b, p_a = engine._pad_case(batch["img"][0], False)
        img = torch.from_numpy(padded.astype(np.float16)).to(dev)[None]
        mark("pad_copy_in")
        probs = engine.member_probs(model, img, False)
        mark("forward_sigmoid")
        fused = post_process(probs, **post_kwargs_from_cfg(cfg))
        mark("post_process")
        brain = (img != 0).any(dim=-1, keepdim=True)
        fused_np = (fused * brain.to(fused.dtype)).cpu().numpy()
        mark("seal_copy_out")
        engine._save_segmentation(batch, fused_np[0], p_b, p_a, str(out))
        mark("unpad_uncrop_save")
        forward_ms = time_ms(lambda: engine.member_probs(model, img, False), iters=3)
    return dict(stages_s=stages, forward_ms=forward_ms)


def _edt_passes(mask, sampling):
    """edt_sq's three passes over ``mask`` [N, *spatial]: (name, kernel,
    plain, input, sampling, axis) each, the input of a pass being the
    plain version's output of the pass before."""
    from brats21_tpu_torch.ops.kernels.edt import (envelope, envelope_mask,
                                                   envelope_mask_plain, envelope_plain)
    passes, f = [], mask
    for ax in range(3):
        kernel, plain = ((envelope_mask, envelope_mask_plain) if ax == 0
                         else (envelope, envelope_plain))
        passes.append(("mask" if ax == 0 else "general", kernel, plain, f,
                       sampling[ax], ax + 1))
        f = plain(f, sampling[ax], ax + 1)
    return passes


def check_edt(dev) -> dict:
    """The EDT envelope kernels (the mask pass and the general pass)
    against their plain version, the O(n²) scan, on every pass of edt_sq:
    bit for bit over the train step's masks (3×128³ and the step's one batch
    of 12×128³), the full case's six masks (6×240×240×155) and hand-made
    edge lines at unit sampling; within rtol 1e-6 over one 240×240×155
    mask at sampling (1, 1, 1.5), where parabolas within an ulp may be
    chosen otherwise. Each shape's pass is timed beside its byte bound, the
    plain version and the old scan's bound; edt_sq against scipy on the
    host."""
    import numpy as np
    import torch
    from scipy import ndimage
    from brats21_tpu_torch.ops.edt import edt_sq
    from brats21_tpu_torch.ops.kernels.edt import INF, envelope, envelope_plain
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows, max_err = [], 0.0
    for shape, sampling, p_true in (((3, *PATCH), (1.0, 1.0, 1.0), 0.7),
                                    ((12, *PATCH), (1.0, 1.0, 1.0), 0.7),
                                    ((6, *CASE_SHAPE), (1.0, 1.0, 1.0), 0.9),
                                    ((1, *CASE_SHAPE), (1.0, 1.0, 1.5), 0.9)):
        mask = torch.rand(shape, generator=gen, device=dev) < p_true
        exact = all(s == 1.0 for s in sampling)
        for name, kernel, plain, x, s, ax in _edt_passes(mask, sampling):
            got, want = kernel(x, s, ax), plain(x, s, ax)
            err = (got - want).abs().max().item()
            rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
            equal = torch.equal(got, want)
            if (exact or name == "mask") and not equal:
                raise AssertionError(f"edt {name} pass {shape} axis {ax}: not bit-equal to "
                                     f"the plain version (max |err| {err:.3g})")
            if not rel <= 1e-6:
                raise AssertionError(f"edt {name} pass {shape} axis {ax} sampling {s}: "
                                     f"max relative err {rel:.3g} > 1e-6")
            max_err = max(max_err, err)
            numel, n = x.numel(), shape[ax]
            in_bytes = x.element_size()
            b_ms, by = bound(EDT_ENVELOPE_OPS * numel, PEAK_FP32, (in_bytes + 4.0) * numel)
            scan_ms, _ = bound(EDT_SCAN_OPS * numel * n, PEAK_FP32, (in_bytes + 4.0) * numel)
            ms = time_ms(lambda: kernel(x, s, ax))
            plain_ms = time_ms(lambda: plain(x, s, ax), iters=2)
            rows.append(dict(shape=list(shape), pass_=name, axis=ax, n=n, sampling=s,
                             bit_equal=equal, max_abs_err=err, max_rel_err=rel, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                             scan_bound_ms=scan_ms))
            log(f"edt {name} pass {tuple(shape)} axis {ax} (n={n}) sampling {s}: "
                f"{'bit-equal' if equal else f'max rel err {rel:.3g} (tol rtol 1e-6)'}; "
                f"kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({by}, {100 * b_ms / ms:.1f} %), "
                f"plain {plain_ms:.3f} ms, O(n²) scan bound {scan_ms:.4f} ms")
            del got, want
        del mask
        torch.cuda.empty_cache()
    # hand-made edge lines: all-sentinel, a single zero, zeros at both ends
    for n in (1, 2, 155, 240):
        g = torch.full((5, n), INF, device=dev)
        g[1, 0] = g[2, n // 2] = g[3, n - 1] = 0.0
        g[4, 0] = g[4, n - 1] = 0.0
        for x, ax in ((g, 1), (g.t().contiguous(), 0)):
            if not torch.equal(envelope(x, 1.0, ax), envelope_plain(x, 1.0, ax)):
                raise AssertionError(f"edt edge lines n={n} axis {ax}: not bit-equal")
    log("edt edge lines (all-sentinel, one zero first/middle/last, zeros at both ends; "
        "n = 1, 2, 155, 240, both axes): bit-equal")
    one = (torch.rand((1, *PATCH), generator=gen, device=dev) > 0.3)
    got = edt_sq(one)[0].cpu().numpy()
    want = ndimage.distance_transform_edt(one[0].cpu().numpy()) ** 2
    if not np.allclose(got, want, rtol=1e-6, atol=1e-3):
        raise AssertionError(f"edt_sq vs scipy: max |err| {np.abs(got - want).max():.3g}")
    log(f"edt_sq 128³ vs scipy: max |err| {np.abs(got - want).max():.3g}")
    # the train step's one EDT batch: 12 masks of 128³, three passes
    step_rows = [r for r in rows if r["shape"][0] == 12]
    per_step = {k: sum(r[k] for r in step_rows)
                for k in ("ms", "plain_ms", "bound_ms", "scan_bound_ms")}
    case_rows = [r for r in rows if r["shape"][0] == 6]
    log(f"edt per train step (12×128³, 3 launches): kernel {per_step['ms']:.4f} ms, bound "
        f"{per_step['bound_ms']:.4f} ms; full case 6×240×240×155 edt_sq: kernel "
        f"{sum(r['ms'] for r in case_rows):.4f} ms, bound "
        f"{sum(r['bound_ms'] for r in case_rows):.4f} ms")
    return dict(rows=rows, max_abs_err=max_err, bound_by=step_rows[0]["bound_by"],
                full_case_ms=sum(r["ms"] for r in case_rows),
                full_case_bound_ms=sum(r["bound_ms"] for r in case_rows), **per_step)


def check_grads(dev) -> dict:
    """conv3x3x3 and evonorm_s0 through their autograd.Functions (kernel
    forward, plain backward) against autograd of their plain versions on
    the same card tensors, at the train step's level-1 and level-4 shapes,
    fp32 and bf16. The backwards launch no hand-written kernel."""
    import torch
    from brats21_tpu_torch.ops.kernels import conv3d, edt, evonorm
    from brats21_tpu_torch.ops.kernels.conv3d import Conv3x3x3Function, conv3x3x3_plain
    from brats21_tpu_torch.ops.kernels.evonorm import EvoNormS0Function, evonorm_s0_plain
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    out = {}
    d1, d4 = PATCH, tuple(s // 8 for s in PATCH)
    cases = [("conv3x3x3", d1, 48, 48), ("conv3x3x3", d4, 384, 384),
             ("evonorm_s0", d1, 48, None), ("evonorm_s0", d4, 384, None)]
    for name, spatial, c, cout in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((1, *spatial, c), generator=gen, device=dev).to(dtype)
            if name == "conv3x3x3":
                w = (torch.randn((3, 3, 3, c, cout), generator=gen, device=dev)
                     / (27 * c) ** 0.5).to(dtype)
                b = 0.1 * torch.randn((cout,), generator=gen, device=dev)
                fn, plain, grads = Conv3x3x3Function.apply, conv3x3x3_plain, ("dx", "dw", "dbias")
                args = [x, w, b]
                ct_shape = (1, *spatial, cout)
            else:
                x = x + 0.5
                g = 1.0 + 0.1 * torch.randn((c,), generator=gen, device=dev)
                b = 0.1 * torch.randn((c,), generator=gen, device=dev)
                fn, plain, grads = EvoNormS0Function.apply, evonorm_s0_plain, ("dx", "dgamma", "dbeta")
                args = [x, g, b]
                ct_shape = x.shape
            ct = torch.randn(ct_shape, generator=gen, device=dev).to(dtype)
            args = [a.detach().requires_grad_() for a in args]
            y = fn(*args)
            counts = (conv3d.launches, evonorm.launches, edt.launches)
            got = torch.autograd.grad(y, args, ct)
            torch.cuda.synchronize()
            if (conv3d.launches, evonorm.launches, edt.launches) != counts:
                raise AssertionError(f"{name}: the backward launched a hand-written kernel")
            want = torch.autograd.grad(plain(*args), args, ct)
            rel = 1e-2 if dtype == torch.bfloat16 else 1e-5
            errs = {}
            for gname, gg, ww in zip(grads, got, want):
                err = (gg.float() - ww.float()).abs().max().item()
                tol = rel * ww.float().abs().max().item() + 1e-6
                if not err <= tol:
                    raise AssertionError(f"{name} {gname} {dtype} at {spatial}: max |err| "
                                         f"{err:.3g} > {tol:.3g}")
                errs[gname] = err
            key = f"{name} {str(dtype)[6:]} {'x'.join(map(str, spatial))}x{c}"
            out[key] = errs
            log(f"{key} grads vs plain autograd: " + ", ".join(
                f"{k} {v:.3g}" for k, v in errs.items()))
            del x, args, y, got, want, ct
    return out


class StepProbe:
    """Wraps TrainStep's two halves for the training phase: zeroes the
    kernels' counters before each step's forward, reads them after it and
    after the backward and optimizer step, and records CUDA events around
    each step and the host clock at each step's start (the interval takes
    in the loader's wait)."""

    def __init__(self):
        import torch
        from brats21_tpu_torch.learning.train_state import TrainStep
        from brats21_tpu_torch.ops.kernels import conv3d, edt, evonorm
        self.mods = dict(conv3x3x3=conv3d, evonorm_s0=evonorm, edt_envelope=edt)
        self.forward, self.backward, self.events, self.host_t = [], [], [], []
        # launches made outside the steps' windows (the loader's threads)
        self.carried = dict.fromkeys(self.mods, 0)
        for m in self.mods.values():
            self.take(m)
        self.cls = TrainStep
        self.orig = (TrainStep.forward_loss, TrainStep.backward_update)
        probe = self

        def forward_loss(step, state, img, target):
            probe.host_t.append(time.time())
            for k, m in probe.mods.items():
                probe.carried[k] += probe.take(m)
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            out = probe.orig[0](step, state, img, target)
            probe.forward.append({k: m.launches for k, m in probe.mods.items()})
            probe.events.append([start])
            return out

        def backward_update(step, state, loss):
            before = {k: m.launches for k, m in probe.mods.items()}
            out = probe.orig[1](step, state, loss)
            probe.backward.append({k: m.launches - before[k] for k, m in probe.mods.items()})
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            probe.events[-1].append(end)
            return out

        TrainStep.forward_loss, TrainStep.backward_update = forward_loss, backward_update

    @staticmethod
    def take(mod) -> int:
        """Read and zero a wrapper's count; the EDT's under its lock, since
        the loader's threads launch it while a step runs."""
        if hasattr(mod, "take_launches"):
            return mod.take_launches()
        taken, mod.launches = mod.launches, 0
        return taken

    def close(self) -> None:
        self.cls.forward_loss, self.cls.backward_update = self.orig

    def step_ms(self) -> list:
        return [a.elapsed_time(b) for a, b in self.events]

    def total_launches(self) -> dict:
        """Every launch of the run: the steps' and those between them."""
        return {k: self.carried[k] + m.launches for k, m in self.mods.items()}


def run_training(data: Path, runs: Path, dev, criterion: str = "dice_hd") -> dict:
    """The train CLI on the card, probed step by step; returns launches per
    step and over the whole run, step times, the CLI wall, the peak memory
    and the run directory."""
    import statistics

    import torch
    from brats21_tpu_torch.cli.main_train import main as train_main
    argv = ["--train_data_path", str(data), "--save_path", str(runs), "--device", "0",
            "--model", "equiunet_assp_evo", "--width", "48", "--criterion", criterion,
            "--optimizer", "ranger", "--decay_type", "cosine", "--learning_rate", "3e-4",
            "--use_gc", "--remove_outliers", "--fold", "None", "--epochs", "1",
            "--num_workers", "2"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tf32_default()
    probe = StepProbe()
    t0 = time.time()
    try:
        result = train_main(argv)
        torch.cuda.synchronize()
    finally:
        probe.close()
    wall = time.time() - t0
    check_tf32_off("train")
    step_ms = probe.step_ms()
    run_dir, = [p for p in runs.iterdir() if p.is_dir()]
    host_ms = [1e3 * (b - a) for a, b in zip(probe.host_t, probe.host_t[1:])]
    return dict(result=result, wall_s=wall, steps=len(step_ms), step_ms=step_ms,
                step_ms_median_after_first=statistics.median(step_ms[1:]),
                host_interval_ms=host_ms,
                forward_launches=probe.forward, backward_launches=probe.backward,
                run_launches=probe.total_launches(),
                peak_bytes=torch.cuda.max_memory_allocated(dev), run_dir=str(run_dir))


def train_step_breakdown(dev, iters: int = 9) -> dict:
    """Where one train step's time goes on one 128³ batch (w48, bf16,
    dice_hd, Ranger with GC): forward, loss (of which the EDT maps: the
    target's and the three heads' in one batch, as the loss makes them),
    backward and optimizer, each between CUDA events (which take in the
    host's launch overhead); the median over ``iters`` steps after a warm-up
    step, and under ``range`` the least and the most."""
    import statistics
    from types import SimpleNamespace

    import torch
    from brats21_tpu_torch.learning.losses import deep_supervision_loss, make_criterion
    from brats21_tpu_torch.learning.optimizers import make_optimizer
    from brats21_tpu_torch.models import get_model
    cfg = SimpleNamespace(criterion="dice_hd", num_classes=3, optimizer="ranger",
                          learning_rate=3e-4, weight_decay=1e-5, decay_type="cosine",
                          epochs=1, use_gc=True, use_gcnorm=False, normloss=False,
                          normloss_factor=1e-4, gc_conv_only=False, swa_start=None)
    torch.manual_seed(SEED)
    model = get_model({"model": "equiunet_assp_evo", "width": 48}).to(dev).train()
    opt = make_optimizer(cfg, model.parameters(), 1)
    criterion = make_criterion(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    x = torch.randn((1, *PATCH, 4), generator=gen, device=dev).to(torch.bfloat16)
    x = x.permute(0, 4, 1, 2, 3)
    tgt = (torch.rand((1, *PATCH, 3), generator=gen, device=dev) > 0.7).float()
    tgt = tgt.permute(0, 4, 1, 2, 3)
    names = ("forward", "loss", "backward", "optimizer", "edt_maps")
    times = {k: [] for k in names}
    for it in range(iters + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        outputs = model(x)
        ev[1].record()
        loss = deep_supervision_loss(criterion, outputs, tgt)
        ev[2].record()
        opt.zero_grad()
        loss.backward()
        ev[3].record()
        opt.step()
        ev[4].record()
        with torch.no_grad():
            heads = [outputs[0]] + list(outputs[1])
            ev[5].record()
            criterion.maps(heads, tgt)
            ev[6].record()
        torch.cuda.synchronize()
        if it:
            for k, (a, b) in zip(names, ((0, 1), (1, 2), (2, 3), (3, 4), (5, 6))):
                times[k].append(ev[a].elapsed_time(ev[b]))
        del outputs, loss
    times["step"] = [sum(t) for t in zip(*(times[k] for k in names[:4]))]
    out = {k: statistics.median(v) for k, v in times.items()}
    out["range"] = {k: [min(v), max(v)] for k, v in times.items()}
    return out


def check_segmentation(path: Path) -> None:
    import numpy as np
    from brats21_tpu_torch.data.nifti import read_nifti
    seg = read_nifti(str(path)).data
    if seg.shape != CASE_SHAPE:
        raise AssertionError(f"{path.name}: shape {seg.shape} != {CASE_SHAPE}")
    labels = set(np.unique(seg).tolist())
    if not labels <= {0, 1, 2, 4}:
        raise AssertionError(f"{path.name}: labels {sorted(labels)} not in {{0,1,2,4}}")
    log(f"{path.name}: shape {seg.shape}, labels {sorted(labels)}, "
        f"{int((seg > 0).sum())} tumour voxels")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's kernels need a GPU",
              file=sys.stderr)
        return 1
    import brats21_tpu_torch  # noqa: F401 — fails outside the checkout
    from brats21_tpu_torch.config import TrainConfig
    from brats21_tpu_torch.data.pipeline import BraTSDataset
    from brats21_tpu_torch.data.synthetic import generate_synthetic_dataset
    from brats21_tpu_torch.data.transforms import shape_to_divisible
    from brats21_tpu_torch.models import get_model
    from brats21_tpu_torch.ops import kernels

    t_start = time.time()
    # fp32 references for the kernel and gradient checks; the CLIs turn
    # TF32 off themselves, which run_cli and run_training check
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    work = kernels.BUILD_DIR / "smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    # 1. build: one nvcc per CUDA source, all started together, while the
    # case is made
    t0 = time.time()
    sources = ("conv3x3x3.cu", "evonorm_s0.cu", "edt_envelope.cu")
    builds = [kernels.start_build(src) for src in sources]

    def finish(build):
        log_text = kernels.finish_build(build)
        return log_text, time.time() - t0

    with ThreadPoolExecutor(len(builds)) as pool:
        waits = [pool.submit(finish, build) for build in builds]
        data = work / "data"
        generate_synthetic_dataset(str(data), num_cases=1, shape=CASE_SHAPE, seed=SEED,
                                   with_seg=False)
        for src, wait in zip(sources, waits):
            log_text, seconds = wait.result()
            log(f"nvcc {src}: built in {seconds:.1f}s" if log_text else
                f"nvcc {src}: already built")
            for line in log_text.splitlines():
                if "registers" in line or "spill" in line or "error" in line:
                    log(f"ptxas: {line.strip()}")
    from brats21_tpu_torch.ops.kernels.conv3d import conv3x3x3
    from brats21_tpu_torch.ops.kernels.edt import envelope
    from brats21_tpu_torch.ops.kernels.evonorm import evonorm_s0
    conv3x3x3(torch.ones((1, 2, 2, 2, 8), device=dev, dtype=torch.bfloat16),
              torch.ones((3, 3, 3, 8, 8), device=dev, dtype=torch.bfloat16),
              torch.zeros(8, device=dev))
    evonorm_s0(torch.ones((1, 2, 2, 2, 8), device=dev), torch.ones(8, device=dev),
               torch.zeros(8, device=dev))
    envelope(torch.zeros((2, 8), device=dev))
    torch.cuda.synchronize()
    log(f"phase 1 build: {time.time() - t0:.1f}s")

    sample = BraTSDataset([{"patient_id": "probe", "img": sorted(
        str(p) for p in (data / "BraTS2021_00000").iterdir())}], with_seg=False)[0]
    padded = shape_to_divisible(sample["img"])[0].shape[:3]
    log(f"served case: {CASE_SHAPE} cropped to {sample['img'].shape[:3]}, padded {padded}")

    def level_shape(level):
        return tuple(s // 2 ** (level - 1) for s in padded)

    # 2. kernels vs plain versions
    t0 = time.time()
    conv = check_conv(level_shape, dev)
    evo = check_evonorm(level_shape, dev)
    torch.cuda.empty_cache()
    log(f"phase 2 kernels vs plain: {time.time() - t0:.1f}s")

    # 3. whole model, card vs CPU
    t0 = time.time()
    check_model(dev)
    log(f"phase 3 model card vs CPU: {time.time() - t0:.1f}s")

    # 4. main path through the CLI
    torch.manual_seed(SEED)
    model = get_model({"model": "equiunet_assp_evo", "width": 48})
    torch.save({"model": model.state_dict()}, work / "best_model.pth")
    TrainConfig(model="equiunet_assp_evo", width=48).to_yaml(str(work / "config.yaml"))
    base = ["--config", str(work / "config.yaml"), "--import_pth",
            str(work / "best_model.pth"), "--on", "test", "--input", str(data),
            "--device", "0", "--cleaning_areas", "--replace_value"]
    t0 = time.time()
    main_run = run_cli(base + ["--output", str(work / "out")], dev)
    seg_dir = work / "out" / "Inference_segmentations_test"
    check_segmentation(seg_dir / "BraTS2021_00000.nii.gz")
    want = dict(conv3x3x3=14, evonorm_s0=21, edt_envelope=0)
    if main_run["launches"] != want:
        raise AssertionError(f"main path launches {main_run['launches']} != {want}")
    log(f"phase 4 main path: CLI wall {main_run['wall_s']:.2f}s, case "
        f"{main_run['case_s'][0]:.3f}s, peak {main_run['peak_bytes'] / 2**30:.2f} GiB, "
        f"launches {main_run['launches']}")

    # 5. TTA through the CLI, same case
    t0 = time.time()
    tta_run = run_cli(base + ["--tta", "--output", str(work / "out_tta")], dev)
    check_segmentation(work / "out_tta" / "Inference_segmentations_test"
                       / "BraTS2021_00000.nii.gz")
    want_tta = {k: 16 * v for k, v in want.items()}
    if tta_run["launches"] != want_tta:
        raise AssertionError(f"TTA launches {tta_run['launches']} != {want_tta}")
    log(f"phase 5 TTA: CLI wall {tta_run['wall_s']:.2f}s, case "
        f"{tta_run['case_s'][0]:.3f}s, peak {tta_run['peak_bytes'] / 2**30:.2f} GiB, "
        f"launches {tta_run['launches']}")

    # 6. where the served case's time goes
    breakdown = stage_breakdown(model.to(dev).eval(), data, work / "out_stages", dev)
    log(f"phase 6 stages: {json.dumps(breakdown)}")
    del model
    torch.cuda.empty_cache()

    # 7. the EDT envelope kernel vs its plain version
    t0 = time.time()
    edt_res = check_edt(dev)
    torch.cuda.empty_cache()
    log(f"phase 7 EDT kernel vs plain: {time.time() - t0:.1f}s")

    # 8. trainable conv / EvoNorm grads vs plain autograd, and both kernels
    # timed at the train step's 128³ level shapes
    t0 = time.time()
    grads = check_grads(dev)
    torch.cuda.empty_cache()
    conv_train = check_conv(lambda level: tuple(s // 2 ** (level - 1) for s in PATCH), dev)
    evo_train = check_evonorm(lambda level: tuple(s // 2 ** (level - 1) for s in PATCH), dev)
    torch.cuda.empty_cache()
    log(f"phase 8 grads and train-shape kernels: {time.time() - t0:.1f}s")

    # 9. the training path through the CLI, then the trained weights served
    t0 = time.time()
    train_data = work / "train_data"
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda i: generate_synthetic_dataset(
            str(train_data), num_cases=1, shape=CASE_SHAPE, seed=SEED + 10, first_case=i),
            range(4)))
    log(f"phase 9 data: 4 cases of {CASE_SHAPE} in {time.time() - t0:.1f}s")
    train = run_training(train_data, work / "runs", dev)
    if train["steps"] < 4:
        raise AssertionError(f"training ran {train['steps']} steps, not 4")
    for i, (fwd, bwd) in enumerate(zip(train["forward_launches"], train["backward_launches"])):
        if fwd != TRAIN_STEP_LAUNCHES or any(bwd.values()):
            raise AssertionError(f"train step {i}: forward launches {fwd} (want "
                                 f"{TRAIN_STEP_LAUNCHES}), backward {bwd} (want none)")
    if train["run_launches"]["edt_envelope"] != train["steps"] * TRAIN_STEP_LAUNCHES[
            "edt_envelope"]:
        raise AssertionError(f"EDT launches over the run {train['run_launches']}: "
                             f"not {TRAIN_STEP_LAUNCHES['edt_envelope']} a step")
    if not math.isfinite(train["result"]["train_loss"]):
        raise AssertionError(f"train loss {train['result']['train_loss']}")
    run_dir = Path(train["run_dir"])
    served = run_cli(["--config", str(run_dir / "config.yaml"), "--import_pth",
                      str(run_dir / "best_model.pth"), "--on", "test", "--input", str(data),
                      "--device", "0", "--output", str(work / "out_trained")], dev)
    check_segmentation(work / "out_trained" / "Inference_segmentations_test"
                       / "BraTS2021_00000.nii.gz")
    # every step's count was checked equal above: the count per step
    train_launches = train["forward_launches"][0]
    log(f"phase 9 training: {train['steps']} steps, loss {train['result']['train_loss']:.4f}, "
        f"step {train['step_ms_median_after_first']:.1f} ms (median after the first; "
        f"all {[round(t, 1) for t in train['step_ms']]}; host clock between step starts "
        f"{[round(t, 1) for t in train['host_interval_ms']]}), CLI wall {train['wall_s']:.1f}s, "
        f"peak {train['peak_bytes'] / 2**30:.2f} GiB, launches per step "
        f"{train['forward_launches'][0]} forward, {train['backward_launches'][0]} backward; "
        f"served the trained best_model.pth in {served['wall_s']:.2f}s")

    # 10. where one train step's time goes
    t0 = time.time()
    torch.cuda.empty_cache()
    step_split = train_step_breakdown(dev)
    log(f"phase 10 train step split (ms): {json.dumps(step_split)} in {time.time() - t0:.1f}s")

    # 11. the boundary criterion through the train CLI: the loader makes
    # each case's distance map on the card, the steps launch no EDT
    t0 = time.time()
    torch.cuda.empty_cache()
    boundary_data = work / "boundary_data"
    boundary_data.mkdir()
    cases = sorted(p for p in train_data.iterdir() if p.is_dir())[:2]
    for case in cases:
        (boundary_data / case.name).symlink_to(case, target_is_directory=True)
    boundary = run_training(boundary_data, work / "runs_boundary", dev,
                            criterion="dice_boundary")
    if boundary["steps"] != len(cases):
        raise AssertionError(f"dice_boundary ran {boundary['steps']} steps, not {len(cases)}")
    for i, (fwd, bwd) in enumerate(zip(boundary["forward_launches"],
                                       boundary["backward_launches"])):
        if {k: fwd[k] for k in BOUNDARY_STEP_LAUNCHES} != BOUNDARY_STEP_LAUNCHES or any(
                bwd[k] for k in BOUNDARY_STEP_LAUNCHES):
            raise AssertionError(f"dice_boundary step {i}: forward launches {fwd}, backward "
                                 f"{bwd} (want {BOUNDARY_STEP_LAUNCHES}, none backward)")
    # every EDT launch of the run is the loader's: 3 a case
    want_edt = EDT_LAUNCHES_PER_LOADED_CASE * len(cases)
    if boundary["run_launches"]["edt_envelope"] != want_edt:
        raise AssertionError(f"dice_boundary run: {boundary['run_launches']['edt_envelope']} "
                             f"EDT launches, want {want_edt} (3 a loaded case, none a step)")
    if not math.isfinite(boundary["result"]["train_loss"]):
        raise AssertionError(f"dice_boundary train loss {boundary['result']['train_loss']}")
    log(f"phase 11 dice_boundary: {boundary['steps']} steps, loss "
        f"{boundary['result']['train_loss']:.4f}, steps "
        f"{[round(t, 1) for t in boundary['step_ms']]} ms, host clock between step starts "
        f"{[round(t, 1) for t in boundary['host_interval_ms']]} ms, CLI wall "
        f"{boundary['wall_s']:.1f}s, peak {boundary['peak_bytes'] / 2**30:.2f} GiB; "
        f"EDT launches {boundary['run_launches']['edt_envelope']} over the run (the loader's, "
        f"{EDT_LAUNCHES_PER_LOADED_CASE} a case), per step {boundary['forward_launches'][0]} "
        f"forward, {boundary['backward_launches'][0]} backward; in {time.time() - t0:.1f}s")

    kernel_rows = []
    for name, route, source, replaces, tolerance, res, res_train, ms_per in (
            ("conv3x3x3", "cuda", "brats21_tpu_torch/csrc/conv3x3x3.cu",
             "brats21_tpu/ops/pallas/conv3d_kernel.py:86",
             "bf16 1e-2*max|ref|, fp32 1e-4*max|ref| (fp32 reference, TF32 off)", conv,
             conv_train, "served forward"),
            ("evonorm_s0", "cuda", "brats21_tpu_torch/csrc/evonorm_s0.cu",
             "brats21_tpu/ops/pallas/evonorm_kernel.py:55",
             "bf16 2**-8*|ref| elementwise, fp32 1e-5 abs", evo, evo_train,
             "served forward"),
            ("edt_envelope", "cuda", "brats21_tpu_torch/csrc/edt_envelope.cu",
             "brats21_tpu/ops/pallas/edt_kernel.py:42",
             "bit-equal to the plain version at unit sampling; rtol 1e-6 at (1, 1, 1.5)",
             edt_res, None, "train step")):
        row = dict(name=name, route=route, source=source, replaces=replaces,
                   launches=train_launches[name], launches_per="train step",
                   steps=train["steps"], max_abs_err=res["max_abs_err"],
                   tolerance=tolerance, ms=res["ms"], plain_ms=res["plain_ms"],
                   bound_ms=res["bound_ms"],
                   bound_by=res.get("bound_by") or (
                       "operations" if res["ops_ms"] >= res["bytes_ms"] else "bytes"),
                   library_ms=res.get("library_ms"), ms_per=ms_per,
                   launches_by_path=dict(inference_case=main_run["launches"][name],
                                         train_step=train_launches[name]),
                   shapes=res["rows"])
        if "scan_bound_ms" in res:
            row["scan_bound_ms"] = res["scan_bound_ms"]
            row["full_case_edt_sq"] = dict(ms=res["full_case_ms"],
                                           bound_ms=res["full_case_bound_ms"])
            row["launches_by_path"]["boundary_loader_case"] = EDT_LAUNCHES_PER_LOADED_CASE
        if res_train is not None:
            row["train_step_shapes"] = {k: res_train[k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms", "rows") if k in res_train}
        kernel_rows.append(row)
    for run in (train, boundary):
        run.pop("forward_launches")
        run.pop("backward_launches")
    summary = dict(card=card, padded_case=list(padded), main_path=main_run,
                   tta=tta_run, stages=breakdown, grads_max_abs_err=grads, train=train,
                   trained_served=served, train_step_split_ms=step_split,
                   boundary=boundary,
                   total_s=time.time() - t_start)
    log("summary: " + json.dumps(summary))
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"kernels": kernel_rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
