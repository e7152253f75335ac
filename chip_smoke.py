#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``brats21_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. build the hand-written kernels from the sources in this checkout (the
   CUDA conv with nvcc, the Triton EvoNorm by its first launch);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the served case gives it, and time kernel, plain version and,
   where one exists, the one PyTorch call computing the same function;
3. hold the width-48 model on the card (kernels) against the same model on
   the CPU (plain versions), fp32;
4. the main path: the inference CLI (``--on test --cleaning_areas
   --replace_value``, bf16) on a synthetic 240×240×155 case with seeded
   random width-48 weights; the kernels' launch counters are zeroed just
   before and read just after, and must show one forward (14 convs, 21
   EvoNorms);
5. the same case through the CLI with ``--tta`` (16 forwards);
6. where one served case's time goes, stage by stage.

It prints the card's name and power limit, one ``{"kernels": [...]}`` JSON
line, and last ``{"ok": true, "device": {...}}``. It imports nothing of JAX.
Data and builds go under ``brats21_tpu_torch/_build/`` in this checkout.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time
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
    from brats21_tpu_torch.ops.kernels.conv3d import conv3x3x3, conv3x3x3_plain
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
            row = dict(shape=[1, d, h, w, cin, cout], count=count, max_abs_err=err,
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
            log(f"conv3x3x3 {cin}->{cout} at {d}x{h}x{w}: err {err:.3g} (tol {tol:.3g}) "
                f"kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
                f"cuDNN {row['library_ms']:.3f} ms, bound {b_ms:.3f} ms")
            del x, wt, y, ref, x_cl, w_oi
    return dict(rows=rows, **total)


def check_evonorm(level_shape, dev) -> dict:
    """evonorm_s0 vs its plain version at the main path's shapes (bf16) and
    on a 40³ block (fp32)."""
    import torch
    from brats21_tpu_torch.ops.kernels.evonorm import evonorm_s0, evonorm_s0_plain
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
            row = dict(shape=[1, d, h, w, c], count=count, max_abs_err=err,
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
            log(f"evonorm_s0 C={c} at {d}x{h}x{w}: err {err:.3g} "
                f"kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
                f"bound {b_ms:.3f} ms")
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


def run_cli(argv, dev) -> dict:
    """The inference CLI with the kernels' counters zeroed just before and
    read just after."""
    import torch
    from brats21_tpu_torch.cli.main_inference import main
    from brats21_tpu_torch.ops.kernels import conv3d, evonorm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    conv3d.launches = 0
    evonorm.launches = 0
    t0 = time.time()
    case_times = main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(conv3x3x3=conv3d.launches, evonorm_s0=evonorm.launches)
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
    os.environ.setdefault("TRITON_CACHE_DIR", str(kernels.BUILD_DIR / "triton"))

    # 1. build: nvcc in the background while Triton compiles and the case is made
    t0 = time.time()
    build = kernels.start_build("conv3x3x3.cu")
    from brats21_tpu_torch.ops.kernels.conv3d import conv3x3x3
    from brats21_tpu_torch.ops.kernels.evonorm import evonorm_s0
    for c in sorted({c for _, c, _ in EVONORM_CALLS}):
        evonorm_s0(torch.ones((1, 2, 2, 2, c), device=dev),
                   torch.ones(c, device=dev), torch.zeros(c, device=dev))
    data = work / "data"
    generate_synthetic_dataset(str(data), num_cases=1, shape=CASE_SHAPE, seed=SEED,
                               with_seg=False)
    ptxas = kernels.finish_build(build)
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"ptxas: {line.strip()}")
    conv3x3x3(torch.ones((1, 2, 2, 2, 8), device=dev, dtype=torch.bfloat16),
              torch.ones((3, 3, 3, 8, 8), device=dev, dtype=torch.bfloat16),
              torch.zeros(8, device=dev))
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
    want = dict(conv3x3x3=14, evonorm_s0=21)
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

    kernel_rows = []
    for name, route, source, replaces, tolerance, res in (
            ("conv3x3x3", "cuda", "brats21_tpu_torch/csrc/conv3x3x3.cu",
             "brats21_tpu/ops/pallas/conv3d_kernel.py:86",
             "bf16 1e-2*max|ref|, fp32 1e-4*max|ref| (fp32 reference, TF32 off)", conv),
            ("evonorm_s0", "triton", "brats21_tpu_torch/ops/kernels/evonorm.py",
             "brats21_tpu/ops/pallas/evonorm_kernel.py:55",
             "bf16 2**-8*|ref| elementwise, fp32 1e-5 abs", evo)):
        kernel_rows.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=main_run["launches"][name], max_abs_err=res["max_abs_err"],
            tolerance=tolerance,
            ms=res["ms"], plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
            bound_by="operations" if res["ops_ms"] >= res["bytes_ms"] else "bytes",
            library_ms=res.get("library_ms"), per_forward=True, shapes=res["rows"]))
    summary = dict(card=card, padded_case=list(padded), main_path=main_run,
                   tta=tta_run, stages=breakdown, total_s=time.time() - t_start)
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
