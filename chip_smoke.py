#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``brats21_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. build the hand-written kernels from the sources in this checkout (the
   CUDA conv, EvoNorm, EDT envelope, the glue passes and the window
   attention, one nvcc each, all at once), and print each library's build
   time;
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the served case gives it, and time kernel, plain version and,
   where one exists, the one PyTorch call computing the same function,
   with each shape's launch plan (the conv's grid and split-K count,
   EvoNorm's blocks and channel vector); the glue kernels (the ResidualSE
   gate with MaxAvgPool, the upsample with the skip concat) against the
   PyTorch calls they replace, each timed beside them, and the served w48
   forward through them (7 + 3 launches) timed against the composition;
3. hold the width-48 model on the card (kernels) against the same model on
   the CPU (plain versions), fp32; then each of the model zoo's eight names
   (``equiunet`` at 48³, the others at 32³) and three other norms
   (instance, batch, bcn), each with its launches a forward counted;
4. the main path: the inference CLI (``--on test --cleaning_areas
   --replace_value``, bf16) on a synthetic 240×240×155 case with seeded
   random width-48 weights; the kernels' launch counters are zeroed just
   before and read just after, and must show one forward (14 convs, 21
   EvoNorms, 7 ResidualSE gates and 3 upsamples of the glue). Every
   served, validated or ensembled EquiUnetASSPEvo forward of the later
   phases is counted with its 7 + 3 glue launches, every train step, slab
   and other model with none;
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
    / 0; a finite loss;
12. validation through the train CLI: ``--criterion dice_hd --fold 0
    --val_frequency 1 --epochs 1 --evaluate_end_training`` over phase 9's
    four cases and a fifth (fold 0: four train steps, one val case); a
    finite validation loss that decides ``best_model.pth``, the
    Evaluation reports and segmentations with and without TTA, and the
    launches of each val case (14 / 21 / 3 plain, 224 / 336 / 48 with TTA,
    the forward with its deep heads and the dice_hd loss's one EDT batch);
    then one val case split into its stages for plain, TTA and sliding
    windows, with the peak memory of the forward with deep heads;
13. the inference CLI ``--on val`` with the run's config and a two-member
    ensemble of different weights (its ``best_model.pth`` and phase 11's
    ``last_model.pth``), three times: sliding windows of 128³ in batches
    of 2, sliding × TTA, and STAPLE; each writes its report and its
    launches a case are checked (a member: 14 / 21 a window batch, the
    batches counted from ``dense_patch_starts`` of the case's padded
    shape, and 3 EDT launches for its loss); STAPLE's EM iterations and
    seconds a channel are printed, and it must iterate past its first step;
14. the Dockerfile's command: the inference CLI with the ENTRYPOINT's flags
    (``--on test --docker_test --tta --replace_value`` 300
    ``--cleaning_areas`` 20) and only ``--config`` of phase 12's run, no
    ``--import_pth``, on one flat case folder: its label map must equal
    the same run served with ``--import_pth`` of its ``best_model.pth``,
    voxel for voxel, with 224 / 336 / 0 launches a case;
15. ``--watch`` serving: a server thread with ``--watch_warmup`` at the
    cropped shape of the cases, ``--watch_interval 0.5`` and a stop file, on
    an empty folder; after its warm-up two w48 cases land one after the
    other (written elsewhere, renamed in), then a corrupt one: both are
    segmented (14 / 21 / 0 launches each), the first within 1.5× the
    second's seconds, and the corrupt case is quarantined after
    ``BRATS21_WATCH_MAX_ATTEMPTS`` (3) attempts;
16. Model 1's recipe (``--model equiunet --norm group --act relu --width
    48 --criterion dice --optimizer ranger --decay_type cosine
    --learning_rate 0.0003 --remove_outliers``) through the train CLI over
    phase 9's four cases at 128³ (15 / 0 / 0 launches a step forward, none
    backward), then its run directory served by ``--config`` alone on the
    240×240×155 case with both post-processing flags, plain and with
    ``--tta`` (15 and 240 conv launches a case); the conv kernel at Model
    1's 15 shapes of the served and of the 128³ train forward against its
    plain version and cuDNN, and at RefUnet's ``conv_d0`` (48 → 3);
17. ``--model att_unet --norm batch`` w48: two train steps at 128³ and one
    served case; the model's BatchNorm statistics move, the attention
    gates' do not, both equal in ``last_model.pth``; the conv launches on
    the kernel's fp32 path counted (everything after the first BatchNorm
    runs in fp32) and that path timed against cuDNN's fp32 conv;
18. the seven MONAI-backed names at their published widths (basic_unet
    w48, segresnet(vae), highresnet and vnet at 32³; nnunet and unet_tr
    at 64³), card vs CPU in fp32 as phase 3 holds the zoo, with the conv
    kernel's launches a forward (18, 25, 31, 7, 0, 17, 10);
19. nnunet at full width (filters 32…320, ``--norm instance``,
    ``--optimizer novograd``) through the train CLI at 128³: an
    uninterrupted 4-step run (17 conv launches a step); the same run in a
    subprocess sent a real SIGTERM once its log shows the first step's
    loss, which must exit 0 with a ``batch_cursor`` in its
    ``last_model.pth``; its ``--resume``, whose last-step loss and
    parameters are held to the uninterrupted run's (the tolerances
    ``RESUME_LOSS_RTOL``, ``RESUME_PARAM_SHARE``); the run directory
    served on the 240×240×155 case with ``--eval_bucket 32`` (the default
    bucket must raise, as the JAX model does); and the conv kernel at
    nnunet's 17 shapes, SegResNet's 8-channel and UNETR's 16-channel
    layers at 128³ against its plain version, its bound and cuDNN;
20. unet_tr at full width (ViT-B/16, feature size 16): 2 train steps at
    128³ (10 conv launches a step), one case served through windows of
    128³ (a full volume must raise); then 2 train steps of segresnetvae,
    whose loss must equal the criterion's mean plus its finite VAE term;
21. data-parallel training: ``python -m torch.distributed.run
    --nproc_per_node 2`` of the train CLI on the one card (backend gloo,
    printed), the flagship recipe of phase 9 with ``--batch_size 2`` (one
    sample a rank) for 4 steps, in fp32 (``--no_amp``) and in bf16, each
    held to the one-process run with batch 2: each step's loss (the ranks'
    mean) within ``DDP_LOSS_RTOL`` relative, the final parameters' distance
    within ``DDP_PARAM_SHARE`` of their movement, the two ranks' parameters
    equal; 14 / 21 / 3 launches a step forward on each rank, none
    backward; each rank's step ms and peak memory printed; beside them the
    loss of one batch of two against two batches of one, no collective, a
    second bf16 one-process run (the floors of the comparison), and each
    precision's one-process run with one sample's gradient left out, which
    must break the limits;
22. serving on 2 local ranks: the served case with ``--tta`` (8 combos a
    rank), phase 13's two-member sliding-window and STAPLE ensembles
    (windows, then members, striped) and two cases without TTA (one a
    rank); each rank's launches half of the one-process run's, each case
    written once, the labels equal to the one-process run's on ≥ 99.9 %
    of voxels (the share printed);
23. two nodes (two ``torch.distributed.run --nnodes 2`` with a c10d
    rendezvous on localhost, one rank each): ``--on val`` over two val
    cases striped over the nodes, its merged report rows equal to the
    one-process run's; then ``main_train_folds`` for one epoch at 128³
    over phase 12's five cases (folds 0, 2, 4 on node 0, 1 and 3 on node
    1), whose five fold directories the inference CLI serves as an
    ensemble;
24. the spatial axis: ``torch.distributed.run`` of two ranks of the card
    as one space row (gloo), phase 4's padded 200×200×136 case and seeded
    w48 weights Z-sharded over them (``spatial_sharded_forward``: slabs of
    72 and 64 planes, each conv's halo exchanged through the host), each
    rank's slab through B1 (on halo-extended slabs) and B2's split entry
    points (statistics, merged over the row in fp64, then apply): (a) bf16,
    the served label map held to one process's as closely as one process
    holds itself (the case in a batch of two against a batch of one,
    measured each run) and to the fp32 labels as closely as one process's
    bf16 labels are, the probabilities' differences printed; (b) fp32, every head within
    1e-4 of one process's; (c) ``Engine.evaluate`` on phase 12's val case
    with its target in fp32, the loss within 1e-3 relative of one
    process's and Dice printed; (d) each rank's launches a forward (14 B1, 21 + 21 split
    B2, none of B2's one-call path nor of the glue), peak memory and seconds beside one
    process's;
25. the eval pipeline: a backlog of six synthetic 240×240×155 cases served
    by the inference CLI with phase 4's member (``--cleaning_areas
    --replace_value``) (a) case-serial (``BRATS21_EVAL_STAGES=0
    BRATS21_EVAL_PIPELINE=1``), (b) with the defaults (prep and finish
    threads, two cases in flight, ``--wire auto``), (c) three in flight on
    ``--wire sparse``, and (d) with ``--tta`` on two of them under (a) and
    (b): every decompressed NIfTI byte-equal across (a)-(c) and across (d),
    labels ⊆ {0, 1, 2, 4}, 14 B1 and 21 B2 launches a case (224 / 336 with
    TTA); ``--on val`` on phase 12's run under (a) and (b) with equal meters
    and report rows and 3 B3 launches a case; a ``capture()`` of (b) whose
    trace holds B1's and B2's kernels, with the card's busy share of its
    window; a request to the ``BRATS21_PROFILE_PORT`` trace server during
    (d)(b), made once its first case is on the card, answered with a trace
    that holds B1's or B2's kernels; the wire each run's engine logged
    (dense under ``--wire auto``, sparse under ``--wire sparse``); the
    wall per case of (a)-(c), each case's ``batch_time`` and
    ``data_time``, and the MB/s behind ``auto``'s choice, beside the
    card's name and power limit;
26. the spatial axis for the rest of the model zoo: one
    ``torch.distributed.run`` of phase 24's two-rank space row whose ranks
    loop over the 14 names phase 24 does not run, each with seeded
    weights: the reference's own networks (``equiunet_ref``,
    ``att_equiunet``, ``equiunet_assp_evo_ref``, the unet family) at w48
    on phase 4's padded 200×200×136 case (slabs 72 + 64; 80 + 56 for the
    RefUnet names, whose four ceil-mode pools align the slabs at 16 and
    leave the last a partial block), the MONAI-backed seven at their
    published widths on its central 96³; each held to one process on the
    same weights and input: (a) bf16 labels flipping at most twice as many
    voxels from one process's as the lower of its own batch of two and
    phase 24's does, plus ``SPATIAL_LABEL_MARGIN``, and as close to the
    fp32 labels as phase 24 holds them; (b) fp32 heads (TF32 off on the
    ranks too), the main head within ``SPATIAL_FP32_ATOL`` at unit scale
    or ``ZOO_SPATIAL_FP32_FLOOR`` times one rounding's move, SegResNetVAE's
    VAE term within ``ZOO_SPATIAL_VAE_RTOL``; (c) each rank's B1 launches
    a forward, and B2's split for ``equiunet_assp_evo_ref``, equal to one
    process's count, none of B2's one-call path; (d) each rank's peak
    memory and seconds a forward beside one process's, and the phase's
    wall; (e) the same forwards with every halo left zero
    (:func:`halos_left_zero`), which must break the limits of (a) and (b);
27. Swin UNETR at its published sizes (feature size 48): B4, the window
    attention, against its plain version at a 128³ window's four stage
    grids, batch 2, both block kinds, bf16 within ``WINDOW_ATTN_REL_RMS``
    and fp32 within ``WINDOW_ATTN_F32_REL_RMS`` of the fp32 composition,
    each timed beside its bound and the plain composition; 2 train steps at
    128³ (20 B1 launches a step, none of B4); the run directory served
    through windows of 128³ with ``--tta`` (20 B1 and 8 B4 launches a
    predictor call of two windows). Every other path above launches no B4.

Phase 1 also builds the native case loader (``csrc/nifti_native.cc``, g++);
phase 6 times decode + crop + normalise on its path and on the numpy path
on the same case, and every case that phases 4-14, 16, 17, 19, 20 and 27 load must go
through it,
with no fallback to the numpy path; phase 15 counts its loads and the
corrupt case's fallbacks exactly.

Phase 8 also holds the conv's gradients with one weight applied three
times in a forward (R2Unet's recurrent block). Phases 2 and 7 also hold the conv and EvoNorm at the sliding window's
batches (2 × 128³) and the EDT on the validation loss's batch (12 masks of
the padded case) against their plain versions; phase 2 also holds B2's
split entry points (statistics, apply) and B1 at phase 24's slab shapes.

It prints the card's name and power limit, one ``{"kernels": [...]}`` JSON
line, and last ``{"ok": true, "device": {...}}``. It imports nothing of JAX.
Data and builds go under ``brats21_tpu_torch/_build/`` in this checkout.
``python3 chip_smoke.py --rank-worker SPEC`` is one rank of phases 21-24
and 26, started by ``torch.distributed.run``.
"""

from __future__ import annotations

import contextlib
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
WIDTH = 48                      # the published width (README.md:35-39)
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
# the glue kernels' launches a forward of EquiUnetASSPEvo with no autograd
# outside a slab (7 ResidualSE gates, 3 upsamples), and of every other
# forward: training, slabs and the other models keep PyTorch's calls
GLUE_FORWARD = dict(se_gate_pool=7, upsample_cat=3)
NO_GLUE = dict(se_gate_pool=0, upsample_cat=0)
# B4's launches (the window attention) in every forward but Swin UNETR's
# with no autograd: training and the other models take none
NO_B4 = dict(window_attn=0)
# launches per train step: the EDT maps of the target and the three heads
# are one edt_sq batch (the mask pass and two general passes)
TRAIN_STEP_LAUNCHES = dict(conv3x3x3=14, evonorm_s0=21, edt_envelope=3, **NO_GLUE, **NO_B4)
# dice_boundary: no EDT in the step; the loader's one_hot2dist makes one
# edt_sq batch (3 channels, negative and positive) a case
BOUNDARY_STEP_LAUNCHES = dict(conv3x3x3=14, evonorm_s0=21, **NO_GLUE, **NO_B4)
EDT_LAUNCHES_PER_LOADED_CASE = 3
# a served forward (no loss), and a validation case with dice_hd: the
# forward with its deep heads, and the loss's one EDT batch (the target and
# three heads, 12 masks of the case)
SERVED_FORWARD_LAUNCHES = dict(conv3x3x3=14, evonorm_s0=21, edt_envelope=0, **GLUE_FORWARD,
                               **NO_B4)
VAL_CASE_LAUNCHES = dict(SERVED_FORWARD_LAUNCHES, edt_envelope=3)
SW_ROI = (128, 128, 128)        # --sliding_window_size's default
SW_BATCH = 2                    # windows a forward (engine.py:459)
# per forward of EquiUnetASSPEvo w48: (level, C_in, C_out, count) of the 3³
# convs and (level, C, count) of the EvoNorms; level l is the padded case
# shape // 2**(l-1)
CONV_CALLS = [(1, 4, 48, 1), (1, 48, 48, 3), (2, 96, 96, 4), (3, 192, 192, 4),
              (4, 384, 384, 2)]
EVONORM_CALLS = [(1, 48, 4), (1, 24, 1), (2, 96, 4), (2, 48, 1), (2, 24, 1),
                 (3, 192, 4), (3, 96, 1), (3, 48, 1), (4, 384, 3), (4, 96, 1)]
# Model 1 (EquiUnet w48, "U-Net V1"): its 15 stride-1 dilation-1 3³ convs a
# forward, encoders 8, bottom_2 1 (768 concatenated channels), decoders 6
# (96, 192 and 384 concatenated channels); bottom's two dilation-2 convs
# stay on cuDNN
MODEL1_CONV_CALLS = [(1, 4, 48, 1), (1, 48, 48, 2), (1, 96, 48, 1), (2, 48, 96, 1),
                     (2, 96, 96, 1), (2, 192, 96, 1), (2, 96, 48, 1), (3, 96, 192, 1),
                     (3, 192, 192, 1), (3, 384, 192, 1), (3, 192, 96, 1), (4, 192, 384, 1),
                     (4, 384, 384, 1), (4, 768, 192, 1)]
# RefUnet's conv_d0 (48 -> the 3 logits): one N tile of 48, 45 of it empty
REFUNET_CONV_CALLS = [(1, 48, 3, 1)]
# the glue kernels a forward: (level, C, pool) of the ResidualSE gates
# (encoders 1-4, decoders 3-1) and (level, Cs, Cu) of the upsamples with
# their skip concats (decoders 3-1; low at level + 1)
GLUE_GATE_CALLS = [(1, 48, True), (2, 96, True), (3, 192, True), (4, 384, False),
                   (3, 192, False), (2, 96, False), (1, 48, False)]
GLUE_UPSAMPLE_CALLS = [(3, 96, 96), (2, 48, 48), (1, 24, 24)]
# the model zoo's launches a forward with deep heads (conv3x3x3, evonorm_s0):
# the conv kernel runs every stride-1 dilation-1 3³ conv, a RefUnet adds 11,
# a recurrent block runs its conv three times
ZOO_LAUNCHES = dict(equiunet=(15, 0), equiunet_ref=(26, 0), att_equiunet=(15, 0),
                    equiunet_assp_evo_ref=(25, 21), modified_unet=(17, 0), att_unet=(17, 0),
                    r2unet=(45, 0), r2attunet=(45, 0))
# phase 3: each name at 32³ (Model 1 at 48³), then three other norms
ZOO_CHECKS = [(name, "group", 48 if name == "equiunet" else 32) for name in ZOO_LAUNCHES] + [
    ("equiunet", "instance", 32), ("modified_unet", "batch", 32), ("att_equiunet", "bcn", 32)]
# Model 1's recipe (tests/test_cli_surface.py:121-128), and its launches a
# train step (conv, EvoNorm, EDT)
MODEL1_ARGS = ("--model", "equiunet", "--norm", "group", "--act", "relu", "--width", "48",
               "--criterion", "dice", "--optimizer", "ranger", "--decay_type", "cosine",
               "--learning_rate", "0.0003", "--remove_outliers")
MODEL1_STEP_LAUNCHES = dict(conv3x3x3=15, evonorm_s0=0, edt_envelope=0, **NO_GLUE,
                            **NO_B4)
# the --norm batch phase: the attention unet, whose gates' BatchNorms the
# JAX package never trains
BATCHNORM_ARGS = ("--model", "att_unet", "--norm", "batch", "--width", "48", "--criterion",
                  "dice", "--optimizer", "ranger", "--decay_type", "cosine",
                  "--learning_rate", "0.0003")
BATCHNORM_STEP_LAUNCHES = dict(conv3x3x3=17, evonorm_s0=0, edt_envelope=0, **NO_GLUE,
                               **NO_B4)
# the MONAI-backed names: the conv kernel runs every stride-1 dilation-1 3³
# conv, narrow ones included (SegResNet's 8 channels, UNETR's 16); VNet's
# convs are 5³ and 2³, HighResNet's dilated ones and every strided conv
# stay on cuDNN
MONAI_LAUNCHES = dict(basic_unet=18, segresnet=25, segresnetvae=31, highresnet=7, vnet=0,
                      nnunet=17, unet_tr=10)
# phase 18: (name, norm, act, side); nnunet needs a multiple of 32, unet_tr's
# and segresnetvae's input is their patch
MONAI_CHECKS = [("basic_unet", "instance", "leakyrelu", 32), ("segresnet", "group", "relu", 32),
                ("segresnetvae", "group", "relu", 32), ("highresnet", "batch", "relu", 32),
                ("vnet", "batch", "elu", 32), ("nnunet", "instance", "leakyrelu", 64),
                ("unet_tr", "instance", "relu", 64)]
# nnunet's 17 stride-1 3³ convs a forward at the levels of a patch: the input
# block, the downs' second convs, the bottleneck's, and the decoders' (the
# deepest takes the 640 concatenated channels)
NNUNET_CONV_CALLS = [(1, 4, 32, 1), (1, 32, 32, 2), (1, 64, 32, 1), (2, 64, 64, 2),
                     (2, 128, 64, 1), (3, 128, 128, 2), (3, 256, 128, 1), (4, 256, 256, 2),
                     (4, 512, 256, 1), (5, 320, 320, 2), (5, 640, 320, 1), (6, 320, 320, 1)]
# the narrowest layers: SegResNet's 8 channels (conv_init and the level-1
# ResBlocks, 5 a forward) and UNETR's 16 (encoder1 and decoder2, 4), at 128³
SEGRESNET_CONV_CALLS = [(1, 4, 8, 1), (1, 8, 8, 4)]
UNETR_CONV_CALLS = [(1, 4, 16, 1), (1, 16, 16, 2), (1, 32, 16, 1)]
# phase 19: nnunet as the nnU-Net layout trains it, with novograd
NNUNET_ARGS = ("--model", "nnunet", "--norm", "instance", "--criterion", "dice",
               "--optimizer", "novograd", "--decay_type", "cosine", "--learning_rate", "1e-3")
NNUNET_STEP_LAUNCHES = dict(conv3x3x3=17, evonorm_s0=0, edt_envelope=0, **NO_GLUE,
                            **NO_B4)
# the resumed run against the uninterrupted one (stated before the first
# chip run): the last step's loss within 1e-3 relative, and every tensor
# within 5 % of how far the uninterrupted run moved it (cuDNN's backward may
# sum in another order from run to run)
RESUME_LOSS_RTOL = 1e-3
RESUME_PARAM_SHARE = 0.05
# phase 21, 2 ranks (one sample each) against one process with batch 2:
# each step's loss relative to the one process's, and the distance of the
# final parameters from the one process's as a share of how far that run
# moved them from the seeded initial weights. fp32 (--no_amp) read at most
# 5.3e-6 and 1.42e-5 on the H100 (five runs of phase 21); its limits sit
# between those readings and what a lost gradient gives (one rank's left
# out of DDP's average, :func:`one_gradient_left_out`), which each run
# measures and must break the limits. bf16, the recipe's precision: the one
# process alone differs from run to run by up to 1.3e-3 in a step's loss
# (its backward sums in no fixed order; measured again each run), and a
# batch of one rounds otherwise than one of two (batch_split_noise); the
# two-rank run read at most 3.08e-3 and 0.0040 in six runs, so its limits
# are those readings with room.
DDP_LOSS_RTOL = dict(fp32=1e-4, bf16=5e-3)
DDP_PARAM_SHARE = dict(fp32=1e-3, bf16=1e-2)
# phase 24: the served case Z-sharded over a space row of two ranks of the
# card, against one process on the same weights: fp32 heads within 1e-4
# absolute, the val loss within 1e-3 relative (both stated before the first
# chip run). The val case runs in fp32: in bf16 its dice_hd loss, whose HD
# term follows every voxel that crosses the threshold, read 1.4e-4 to
# 1.2e-3 relative over three runs of phase 12's barely trained weights.
# bf16 labels: the CPU tests' 99.9 % of voxels cannot hold with random
# weights, where 8.7 % of the case's fp32 probabilities lie within 0.005 of
# the threshold: one process alone, the case in a batch of two against a
# batch of one, agrees on 99.829 % (its EvoNorm statistics sum in other
# blocks), and the sharded run read 99.859 % (NVIDIA H100 80GB HBM3, 700 W).
# So each run measures that floor and the sharded labels must reach it less
# SPATIAL_LABEL_MARGIN (readings 1.3e-5 apart between the batch's two
# samples), and must lie no further from the fp32 labels than one process's
# bf16 labels do, less SPATIAL_FP32_LABEL_MARGIN (readings 2e-5 apart). A
# forward launches on each rank 14 B1 (on halo-extended slabs; the 1x1s and
# dilated convs stay cuDNN) and 21 each of B2's split statistics and apply,
# none of B2's one-call path
SPATIAL_SPACE = 2
SPATIAL_FORWARD_LAUNCHES = dict(conv3x3x3=14, evonorm_s0=0, evonorm_s0_stats=21,
                                evonorm_s0_apply=21, **NO_GLUE, **NO_B4)
SPATIAL_LABEL_TARGET = 0.999
SPATIAL_LABEL_MARGIN = 5e-4
SPATIAL_FP32_LABEL_MARGIN = 1e-4
SPATIAL_FP32_ATOL = 1e-4
SPATIAL_LOSS_RTOL = 1e-3
# phase 26: every other --model name Z-sharded over the same space row of
# two ranks, against one process on the same seeded weights and input:
# (name, norm, act, input) — the reference's own networks at w48 on phase
# 4's padded case (200×200×136: slabs 72 + 64 at factor 8, 80 + 56 at the
# RefUnet's 16, its last slab a partial block), the MONAI-backed ones at
# their published widths on the case's central 96³ (nnunet: a multiple
# of 32; unet_tr and segresnetvae: their patch; 96³ rather than 128³ keeps
# the script within 150 s of its 461-506 s before phase 26: it read
# 667 s with 128³, the phase itself 99 s of it, on an NVIDIA H100 80GB
# HBM3 at 700 W)
ZOO_SPATIAL = [("equiunet_ref", "group", "relu", "case"),
               ("att_equiunet", "group", "relu", "case"),
               ("equiunet_assp_evo_ref", "group", "relu", "case"),
               ("modified_unet", "group", "relu", "case"), ("att_unet", "group", "relu", "case"),
               ("r2unet", "group", "relu", "case"), ("r2attunet", "group", "relu", "case"),
               ("basic_unet", "instance", "leakyrelu", "crop"),
               ("segresnet", "group", "relu", "crop"), ("segresnetvae", "group", "relu", "crop"),
               ("highresnet", "batch", "relu", "crop"), ("vnet", "batch", "elu", "crop"),
               ("nnunet", "instance", "leakyrelu", "crop"),
               ("unet_tr", "instance", "relu", "crop")]
ZOO_SPATIAL_CROP = 96
# their B1 launches a main-head forward (phases 3 and 18's counts; no VAE
# branch), and equiunet_assp_evo_ref's EvoNorms (its one-process forward
# also launches the glue, GLUE_FORWARD; no slab does)
ZOO_SPATIAL_LAUNCHES = dict(equiunet_ref=26, att_equiunet=15, equiunet_assp_evo_ref=25,
                            modified_unet=17, att_unet=17, r2unet=45, r2attunet=45,
                            basic_unet=18, segresnet=25, segresnetvae=25, highresnet=7, vnet=0,
                            nnunet=17, unet_tr=10)
ZOO_SPATIAL_EVONORMS = dict(equiunet_assp_evo_ref=21)
# the fp32 main head within SPATIAL_FP32_ATOL of one process's, times the
# head's largest magnitude where it exceeds 1 (phase 3's rule: with their
# default init the zoo's heads reach |10-100|), or within
# ZOO_SPATIAL_FP32_FLOOR times how far one process's own main head moves
# when its fp32 input moves by one rounding (a relative 2**-23, seeded), if
# that is wider: the attention unets amplify fp32 rounding in their fp32
# decoders (C6): r2attunet's sharded head read 0.0368 from one process's
# on a head of |96| (NVIDIA H100 80GB HBM3, 700 W), where the first term
# alone allows 0.0096, and lay within 1.1 of that floor, as every name's
# did; on the CPU (w8, 48³) the sharded heads read 1.4-2.6 times it. The
# second term was added after that reading, so each run also measures the
# limit's upper side: the same forwards with every halo left zero
# (halos_left_zero) must break it, and the label limit below.
ZOO_SPATIAL_FP32_FLOOR = 10.0
# bf16 labels: phase 24's method (one process's batch-of-two share less
# SPATIAL_LABEL_MARGIN) does not hold here: att_unet, segresnet and unet_tr
# read 0.05-0.15 % below their own batch of two (NVIDIA H100 80GB HBM3,
# 700 W), the sharded forward's slab shapes and merged statistics being
# another reordering of the sums, no smaller than the batch's. So the
# sharded labels may flip up to ZOO_SPATIAL_LABEL_FLIPS times the share of
# voxels that the lower of the name's batch of two and phase 24's flips,
# plus SPATIAL_LABEL_MARGIN
ZOO_SPATIAL_LABEL_FLIPS = 2.0
ZOO_SPATIAL_VAE_RTOL = 1e-3
# phase 25: the backlog served through the eval pipeline, and how many of
# its cases take --tta
PIPELINE_CASES = 6
PIPELINE_TTA_CASES = 2
# the trace server's window, asked for once the TTA run (d)(b) has launched
# its first kernel
TRACE_SERVER_MS = 2000
# EvoNorm's split: the statistics read x once (x − mean, square, two adds an
# element), the apply reads it again and writes the output (exp, add,
# reciprocal, three multiplies and an add)
EVONORM_STATS_OPS = 4
EVONORM_APPLY_OPS = 7
# phase 20: UNETR (ViT-B/16), served through windows of its patch, and
# SegResNetVAE with its VAE term
UNETR_ARGS = ("--model", "unet_tr", "--norm", "instance", "--criterion", "dice",
              "--optimizer", "adamw", "--decay_type", "cosine", "--learning_rate", "1e-4")
UNETR_STEP_LAUNCHES = dict(conv3x3x3=10, evonorm_s0=0, edt_envelope=0, **NO_GLUE,
                           **NO_B4)
SEGRESNETVAE_ARGS = ("--model", "segresnetvae", "--criterion", "dice", "--optimizer",
                     "adamw", "--decay_type", "cosine", "--learning_rate", "1e-4")
SEGRESNETVAE_STEP_LAUNCHES = dict(conv3x3x3=31, evonorm_s0=0, edt_envelope=0, **NO_GLUE,
                                  **NO_B4)
# phase 27: Swin UNETR (feature size 48) trained at 128³ and served through
# windows of 128³: B1 runs its 20 3³ convs a forward, B4 8 (4 stages × 2
# blocks) a forward with no autograd and none in a train step
SWIN_ARGS = ("--model", "swin_unetr", "--criterion", "dice", "--optimizer", "adamw",
             "--decay_type", "cosine", "--learning_rate", "1e-4")
SWIN_STEP_LAUNCHES = dict(conv3x3x3=20, evonorm_s0=0, edt_envelope=0, **NO_GLUE, **NO_B4)
SWIN_FORWARD_LAUNCHES = dict(SWIN_STEP_LAUNCHES, window_attn=8)
# B4 at a 128³ window's four stage grids (padded to multiples of the window
# of 7) with their heads; its error against the fp32 composition, relative
# RMS: bf16 as tests/test_torch_port_swin.py's B4_REL_RMS, fp32 as its
# B4_F32_REL_RMS; the softmax's exponentials a second of one H100 SXM (16 an
# SM a clock, as FlashAttention-3, Shah et al. 2024, gives the rate)
SWIN_STAGE_GRIDS = [((70, 70, 70), 3), ((35, 35, 35), 6), ((21, 21, 21), 12),
                    ((14, 14, 14), 24)]
WINDOW_ATTN_REL_RMS = 2.5e-3
WINDOW_ATTN_F32_REL_RMS = 1e-5
PEAK_EXP = 3.9e12


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


def enqueue_ms(fn, iters: int = 9) -> float:
    """Median host time to enqueue ``fn`` (no synchronise inside the
    timing), each run after the card has finished the one before."""
    import statistics

    import torch
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound(ops: float, peak_ops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_conv(level_shape, dev, batch: int = 1, calls=CONV_CALLS) -> dict:
    """conv3x3x3 vs its plain version at a path's shapes (bf16, ``batch``
    samples; ``calls`` as (level, C_in, C_out, count a forward)) and on a
    40³ block (fp32)."""
    import torch
    import torch.nn.functional as F
    from brats21_tpu_torch.ops.kernels.conv3d import conv3x3x3, conv3x3x3_plain, conv_plan
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows, total = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                           ops_ms=0.0, bytes_ms=0.0, max_abs_err=0.0)
    for level, cin, cout, count in calls:
        d, h, w = level_shape(level)
        err32 = None
        for dtype, spatial, b_ in ((torch.float32, (40, 40, 40), 1),
                                   (torch.bfloat16, (d, h, w), batch)):
            x = torch.randn((b_, *spatial, cin), generator=gen, device=dev).to(dtype)
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
            m = batch * d * h * w
            ops = 2.0 * m * cout * 27 * cin
            nbytes = 2.0 * (m * cin + m * cout + 27 * cin * cout) + 4.0 * cout
            b_ms, _ = bound(ops, PEAK_BF16, nbytes)
            x_cl = x.permute(0, 4, 1, 2, 3)
            w_oi = wt.permute(4, 3, 0, 1, 2).contiguous()
            b_bf = b.to(dtype)
            plan = conv_plan(batch, d, h, w, cin, cout)
            grid = [plan.bricks, plan.n_tiles, plan.splits]
            row = dict(shape=[batch, d, h, w, cin, cout], count=count, grid=grid, max_abs_err=err,
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
            log(f"conv3x3x3 {cin}->{cout} at {batch}x{d}x{h}x{w}: grid {plan.bricks} bricks x "
                f"{plan.n_tiles} N tiles of {plan.bn} x split-K {plan.splits}; err {err:.3g} "
                f"(tol {tol:.3g}) kernel {row['ms']:.4f} ms, cuDNN {row['library_ms']:.4f} ms, "
                f"bound {b_ms:.4f} ms ({100 * b_ms / row['ms']:.1f} %), "
                f"plain {row['plain_ms']:.4f} ms")
            del x, wt, y, ref, x_cl, w_oi
    return dict(rows=rows, **total)


def check_evonorm(level_shape, dev, batch: int = 1) -> dict:
    """evonorm_s0 vs its plain version at the main path's shapes (bf16,
    ``batch`` samples) and on a 40³ block (fp32)."""
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
        for dtype, spatial, b_ in ((torch.float32, (40, 40, 40), 1),
                                   (torch.bfloat16, (d, h, w), batch)):
            x = (0.5 + 2.0 * torch.randn((b_, *spatial, c), generator=gen,
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
            m = batch * d * h * w
            b_ms, _ = bound(EVONORM_OPS * m * c, PEAK_FP32, 4.0 * m * c + 8.0 * c)
            plan = evonorm_plan(batch, d * h * w, c, x.element_size())
            row = dict(shape=[batch, d, h, w, c], count=count,
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
            log(f"evonorm_s0 C={c} at {batch}x{d}x{h}x{w}: grid {plan.blocks} stats / "
                f"{plan.apply_blocks} apply blocks, {plan.vec} channels a thread; "
                f"err {err:.3g} kernel {row['ms']:.4f} ms, "
                f"bound {b_ms:.4f} ms ({100 * b_ms / row['ms']:.1f} %), "
                f"plain {row['plain_ms']:.4f} ms")
            del x, y, ref, diff
    return dict(rows=rows, **total)


def check_glue(level_shape, dev) -> dict:
    """The glue kernels at the served forward's calls (bf16) against the
    PyTorch calls the model made there, the next conv's copy into its
    layout included: the gate and max bit-equal, the mean and the upsample
    counted where they differ (at most one bf16 ulp); each timed beside
    that composition, with its bound (bytes). Then the w48 forward at the
    served shape through the kernels and through the composition, its
    launches counted and both timed."""
    import torch
    from brats21_tpu_torch.models import assp_evo, get_model
    from brats21_tpu_torch.models.layers import (from_kernel_layout, max_avg_pool,
                                                 to_kernel_layout, upsample)
    from brats21_tpu_torch.ops.kernels import conv3d, evonorm, glue
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    dtype = torch.bfloat16
    rows, total = [], dict(ms=0.0, composition_ms=0.0, bound_ms=0.0, differ=0)

    def differ(got, want, what):
        g, w = got.float(), want.float()
        if not bool(((g - w).abs() <= 2.0 ** -7 * w.abs() + 2.0 ** -133).all()):
            raise AssertionError(f"{what}: more than one bf16 ulp off PyTorch's calls")
        return int((g != w).sum())

    def add(row):
        rows.append(row)
        for k in ("ms", "composition_ms", "bound_ms", "differ"):
            total[k] += row[k]
        log(f"{row['kernel']} {row['shape']}: {row['differ']} elements differ from PyTorch's; "
            f"kernel {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({100 * row['bound_ms'] / row['ms']:.1f} %), composition "
            f"{row['composition_ms']:.4f} ms")

    for level, c, pool in GLUE_GATE_CALLS:
        d, h, w = level_shape(level)
        x = torch.randn((1, d, h, w, c), generator=gen, device=dev).to(dtype)
        s = torch.rand((1, c), generator=gen, device=dev).to(dtype)
        v = from_kernel_layout(x)

        def composition():
            y = v + v * s[:, :, None, None, None]
            return y, (to_kernel_layout(max_avg_pool(y)) if pool else None)

        y, pooled = glue.se_gate_pool(x, s, pool)
        want, want_pooled = composition()
        if not torch.equal(y, to_kernel_layout(want)):
            raise AssertionError(f"se_gate_pool at {x.shape}: the gate differs")
        n = 0
        if pool:
            if not torch.equal(pooled[..., :c], want_pooled[..., :c]):
                raise AssertionError(f"se_gate_pool at {x.shape}: the max differs")
            n = differ(pooled[..., c:], want_pooled[..., c:], f"mean at {tuple(x.shape)}")
        m = d * h * w * c
        add(dict(kernel="se_gate_pool", shape=[1, d, h, w, c], pool=pool, differ=n,
                 plan=glue.glue_plan((d // 2) * (h // 2) * (w // 2) if pool else d * h * w,
                                     (c,), 2).__dict__,
                 ms=time_ms(lambda: glue.se_gate_pool(x, s, pool)),
                 composition_ms=time_ms(composition),
                 bound_ms=bound(0.0, PEAK_BF16, 2.0 * (2.25 if pool else 2.0) * m)[0]))
        del x, v, y, pooled, want, want_pooled
    for level, cs, cu in GLUE_UPSAMPLE_CALLS:
        d, h, w = level_shape(level)
        skip = torch.randn((1, d, h, w, cs), generator=gen, device=dev).to(dtype)
        low = torch.randn((1, d // 2, h // 2, w // 2, cu), generator=gen, device=dev).to(dtype)

        def composition():
            return to_kernel_layout(torch.cat([from_kernel_layout(skip),
                                               upsample(from_kernel_layout(low))], dim=1))

        out, want = glue.upsample_cat(skip, low), composition()
        if not torch.equal(out[..., :cs], skip):
            raise AssertionError(f"upsample_cat at {skip.shape}: the skip differs")
        m = d * h * w
        add(dict(kernel="upsample_cat", shape=[1, d, h, w, cs, cu],
                 differ=differ(out[..., cs:], want[..., cs:], f"upsample at {tuple(skip.shape)}"),
                 plan=glue.glue_plan(m, (cs, cu), 2).__dict__,
                 ms=time_ms(lambda: glue.upsample_cat(skip, low)),
                 composition_ms=time_ms(composition),
                 bound_ms=bound(0.0, PEAK_BF16, 2.0 * (m * cs + m // 8 * cu + m * (cs + cu)))[0]))
        del skip, low, out, want
    torch.cuda.empty_cache()

    torch.manual_seed(SEED)
    model = get_model({"model": "equiunet_assp_evo", "width": WIDTH}).to(dev).eval()
    x = torch.randn((1, 4, *level_shape(1)), generator=gen, device=dev).to(dtype).contiguous(
        memory_format=torch.channels_last_3d)
    route = assp_evo.glue_route
    forward = {}
    with torch.inference_mode():
        counts = (glue.se_gate_pool_launches, glue.upsample_cat_launches, conv3d.launches,
                  evonorm.launches)
        got = model(x)
        launches = [a - b for a, b in zip((glue.se_gate_pool_launches,
                                           glue.upsample_cat_launches, conv3d.launches,
                                           evonorm.launches), counts)]
        if launches != [7, 3, 14, 21]:
            raise AssertionError(f"served forward: launches {launches} (glue gate, upsample, "
                                 "B1, B2), want [7, 3, 14, 21]")
        forward["glue_ms"] = time_ms(lambda: model(x), iters=3)
        forward["glue_host_ms"] = enqueue_ms(lambda: model(x))
        assp_evo.glue_route = lambda: False
        try:
            want = model(x)
            forward["composition_ms"] = time_ms(lambda: model(x), iters=3)
            forward["composition_host_ms"] = enqueue_ms(lambda: model(x))
        finally:
            assp_evo.glue_route = route
    heads = list(zip(output_heads(got), output_heads(want)))
    forward["heads_equal"] = all(torch.equal(g, w_) for g, w_ in heads)
    forward["max_abs_diff"] = max((g.float() - w_.float()).abs().max().item() for g, w_ in heads)
    log(f"served w48 forward: through the glue kernels {forward['glue_ms']:.3f} ms "
        f"({forward['glue_host_ms']:.3f} ms to enqueue), through the composition "
        f"{forward['composition_ms']:.3f} ms ({forward['composition_host_ms']:.3f}); heads equal "
        f"{forward['heads_equal']} (max |diff| {forward['max_abs_diff']:.3g}); launches "
        f"{launches} (glue gate, upsample, B1, B2)")
    del model, x, got, want
    torch.cuda.empty_cache()
    return dict(rows=rows, forward=forward, forward_launches=launches, **total)


def check_evonorm_split(level_shape, dev) -> dict:
    """B2's split entry points against their plain versions at a path's
    shapes (bf16) and on a 40³ block (fp32): the statistics kernel's
    (n, mean, M2) against the fp64 plain statistics (counts equal, the inv
    they give within one bf16 ulp, 2**-8 relative), the apply kernel on
    the plain statistics' inv against the plain apply (one bf16 ulp
    elementwise; fp32 1e-5)."""
    import torch
    from brats21_tpu_torch.ops.kernels.evonorm import (evonorm_plan, evonorm_s0_apply,
                                                       evonorm_s0_apply_plain,
                                                       evonorm_s0_stats,
                                                       evonorm_s0_stats_plain, inv_std)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    total = {part: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0,
                        max_abs_err=0.0) for part in ("stats", "apply")}
    rows = []
    for level, c, count in EVONORM_CALLS:
        d, h, w = level_shape(level)
        gamma = 1.0 + 0.1 * torch.randn((c,), generator=gen, device=dev)
        beta = 0.1 * torch.randn((c,), generator=gen, device=dev)
        errs32 = {}
        for dtype, spatial in ((torch.float32, (40, 40, 40)), (torch.bfloat16, (d, h, w))):
            x = (0.5 + 2.0 * torch.randn((1, *spatial, c), generator=gen, device=dev)).to(dtype)
            stats = evonorm_s0_stats(x, 8)
            ref = evonorm_s0_stats_plain(x, 8)
            inv_k, inv_p = inv_std(stats), inv_std(ref)
            std = (ref[..., 2] / ref[..., 0]).sqrt()
            errs = dict(
                inv_rel=((inv_k - inv_p).abs() / inv_p).max().item(),
                mean_per_std=((stats[..., 1] - ref[..., 1]).abs() / std).max().item(),
                m2_rel=((stats[..., 2] - ref[..., 2]).abs() / ref[..., 2]).max().item())
            if not (torch.equal(stats[..., 0], ref[..., 0]) and errs["inv_rel"] <= 2.0 ** -8):
                raise AssertionError(f"evonorm_s0_stats C={c} {dtype} at {spatial}: counts "
                                     f"{stats[..., 0].tolist()} vs {ref[..., 0].tolist()}, "
                                     f"{errs}")
            y = evonorm_s0_apply(x, inv_p, gamma, beta)
            want = evonorm_s0_apply_plain(x.float(), inv_p, gamma, beta)
            diff = (y.float() - want).abs()
            err = diff.max().item()
            ok = (bool((diff <= 2.0 ** -8 * want.abs() + 1e-6).all())
                  if dtype == torch.bfloat16 else err <= 1e-5)
            if not ok:
                raise AssertionError(f"evonorm_s0_apply C={c} {dtype} at {spatial}: max "
                                     f"|err| {err:.3g}")
            if dtype != torch.bfloat16:
                errs32 = dict(errs, apply_max_abs_err=err)
                continue
            m = d * h * w
            s_ms, _ = bound(EVONORM_STATS_OPS * m * c, PEAK_FP32, 2.0 * m * c)
            a_ms, _ = bound(EVONORM_APPLY_OPS * m * c, PEAK_FP32, 4.0 * m * c + 8.0 * c)
            plan = evonorm_plan(1, m, c, x.element_size())
            row = dict(shape=[1, d, h, w, c], count=count,
                       blocks=dict(stats=plan.blocks, apply=plan.apply_blocks),
                       stats_errors=errs, apply_max_abs_err=err, fp32_40cubed=errs32,
                       stats_ms=time_ms(lambda: evonorm_s0_stats(x, 8)),
                       stats_plain_ms=time_ms(lambda: evonorm_s0_stats_plain(x, 8)),
                       stats_bound_ms=s_ms,
                       apply_ms=time_ms(lambda: evonorm_s0_apply(x, inv_p, gamma, beta)),
                       apply_plain_ms=time_ms(
                           lambda: evonorm_s0_apply_plain(x, inv_p, gamma, beta)),
                       apply_bound_ms=a_ms)
            rows.append(row)
            for part, ops, nbytes in (("stats", EVONORM_STATS_OPS * m * c, 2.0 * m * c),
                                      ("apply", EVONORM_APPLY_OPS * m * c,
                                       4.0 * m * c + 8.0 * c)):
                t = total[part]
                t["ms"] += count * row[f"{part}_ms"]
                t["plain_ms"] += count * row[f"{part}_plain_ms"]
                t["bound_ms"] += count * row[f"{part}_bound_ms"]
                t["ops_ms"] += count * ops / PEAK_FP32 * 1e3
                t["bytes_ms"] += count * nbytes / PEAK_BYTES * 1e3
            total["stats"]["max_abs_err"] = max(total["stats"]["max_abs_err"], errs["inv_rel"])
            total["apply"]["max_abs_err"] = max(total["apply"]["max_abs_err"], err)
            log(f"evonorm_s0 split C={c} at 1x{d}x{h}x{w}: stats {row['stats_ms']:.4f} ms "
                f"(bound {s_ms:.4f}, plain {row['stats_plain_ms']:.4f}; inv rel err "
                f"{errs['inv_rel']:.3g}, mean/std {errs['mean_per_std']:.3g}, M2 rel "
                f"{errs['m2_rel']:.3g}), apply {row['apply_ms']:.4f} ms (bound {a_ms:.4f}, "
                f"plain {row['apply_plain_ms']:.4f}; err {err:.3g})")
            del x, y, want, diff
    for t in total.values():
        t["bound_by"] = "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes"
    return dict(rows=rows, **total)


def output_heads(out) -> list:
    """Every head of a model output: logits, ``(logits, [deep heads])``,
    ``([refined, logits], [deep heads])`` or ``(logits, {"vae_loss": s})``
    (the scalar last)."""
    import torch
    if isinstance(out, torch.Tensor):
        return [out]
    main, rest = out
    heads = list(main) if isinstance(main, list) else [main]
    return heads + (list(rest.values()) if isinstance(rest, dict) else list(rest))


def check_model(dev, name: str = "equiunet_assp_evo", norm: str = "group",
                side: int = 48, act: str = "relu") -> dict:
    """One model at w48 on 1×4×side³, fp32: the card (kernels) against the
    CPU (plain versions), and the kernels' launches in the card's forward.
    EquiUnetASSPEvo's heads are held within atol = rtol = 1e-3; the model
    zoo's within atol = rtol = 1e-3 of the CPU head divided by its largest
    magnitude. At w48 with their default init their heads reach |60-90|
    (the recurrent unets), where fp32 itself is off by ~1e-3 absolute on
    the CPU (against fp64, r2attunet's second head: 9.1e-4), so an
    absolute 1e-3 would test the rounding, not the kernels."""
    import copy

    import numpy as np
    import torch
    from brats21_tpu_torch.models import get_model
    from brats21_tpu_torch.ops.kernels import conv3d, evonorm
    torch.manual_seed(SEED)
    cpu_model = get_model({"model": name, "width": 48, "norm": norm, "act": act,
                           "patch_size": [side] * 3}).eval()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    x = np.random.default_rng(SEED).standard_normal((1, 4, side, side, side)).astype(np.float32)
    xt = torch.from_numpy(x).contiguous(memory_format=torch.channels_last_3d)
    with torch.inference_mode():
        want = cpu_model(xt)
        counts = (conv3d.launches, evonorm.launches)
        got = gpu_model(xt.to(dev))
        torch.cuda.synchronize()
        launches = (conv3d.launches - counts[0], evonorm.launches - counts[1])

    diffs, scales, elementwise = [], [], True
    for i, (g, w_) in enumerate(zip(output_heads(got), output_heads(want))):
        g = g.float().cpu()
        if not torch.isfinite(g).all():
            raise AssertionError(f"model {name} head {i}: non-finite output on the card")
        diff = (g - w_).abs().max().item()
        scale = 1.0 if name == "equiunet_assp_evo" else max(w_.abs().max().item(), 1.0)
        if not torch.allclose(g / scale, w_ / scale, atol=1e-3, rtol=1e-3):
            raise AssertionError(f"model {name} ({norm}) head {i}: card vs CPU max |diff| "
                                 f"{diff:.3g} over 1e-3 of the head's scale {scale:.3g}")
        elementwise &= bool(torch.allclose(g, w_, atol=1e-3, rtol=1e-3))
        diffs.append(diff)
        scales.append(scale)
    log(f"model {name} w48 --norm {norm} at {side}³: {len(diffs)} heads, card vs CPU max "
        f"|diff| {max(diffs):.3g} (heads' scales {[round(x, 1) for x in scales]}; within "
        f"atol = rtol = 1e-3 unscaled: {elementwise}); launches conv {launches[0]}, "
        f"EvoNorm {launches[1]}")
    return dict(max_abs_diff=max(diffs), head_scales=scales, unscaled_1e3=elementwise,
                launches=list(launches))


def tf32_default() -> None:
    """Put TF32 back to PyTorch's default (on for cuDNN) before a CLI runs:
    the CLI must turn it off itself (:func:`check_tf32_off`)."""
    import torch
    torch.backends.cudnn.allow_tf32 = True


def check_tf32_off(cli: str) -> None:
    import torch
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError(f"the {cli} CLI ran on the card with TF32 on")


class Tally:
    """The kernels' launch counters, read and zeroed by ``take`` (the EDT's
    under its lock, since a loader thread may launch it while the main
    thread reads; each glue entry point's own); ``total`` keeps every
    launch taken since the tally was made, which zeroes the counters."""

    def __init__(self):
        from brats21_tpu_torch.ops.kernels import conv3d, edt, evonorm, glue
        from brats21_tpu_torch.ops.kernels import window_attn as wa
        self.mods = dict(conv3x3x3=conv3d, evonorm_s0=evonorm, edt_envelope=edt,
                         se_gate_pool=(glue, "se_gate_pool_launches"),
                         upsample_cat=(glue, "upsample_cat_launches"), window_attn=wa)
        self.total = dict.fromkeys(self.mods, 0)
        self.take()
        self.total = dict.fromkeys(self.mods, 0)

    def take(self) -> dict:
        taken = {}
        for k, m in self.mods.items():
            if hasattr(m, "take_launches"):
                taken[k] = m.take_launches()
            else:
                m, attr = m if isinstance(m, tuple) else (m, "launches")
                taken[k] = getattr(m, attr)
                setattr(m, attr, 0)
            self.total[k] += taken[k]
        return taken


class CaseProbe:
    """Wraps ``Engine.eval_case`` for a CLI run: each case's launches (the
    tally taken at the case's start and again at its end), its mode, its
    padded shape and its seconds on the host clock, synchronised at both
    ends (the forwards, losses and fusion; not the metrics and the save);
    and each STAPLE channel's EM iterations and seconds."""

    def __init__(self, tally: Tally):
        import torch
        from brats21_tpu_torch.learning.engine import Engine
        from brats21_tpu_torch.ops import staple
        self.cases = []
        self.cls, self.orig = Engine, Engine.eval_case
        self.staple, self.orig_staple = staple, staple.staple_binary
        probe, staple_runs = self, []

        def staple_binary(decisions, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            out = probe.orig_staple(decisions, *args, **kw)
            torch.cuda.synchronize()
            staple_runs.append(dict(iterations=staple.last_iterations,
                                    seconds=time.time() - t0))
            return out

        def eval_case(engine, members, batch, use_tta=False, sliding=False, *args, **kw):
            torch.cuda.synchronize()
            tally.take()
            staple_runs.clear()
            t0 = time.time()
            out = probe.orig(engine, members, batch, use_tta, sliding, *args, **kw)
            torch.cuda.synchronize()
            probe.cases.append(dict(
                tta=bool(use_tta), sliding=bool(sliding), members=len(members),
                padded=list(out["fused"].shape[1:4]), seconds=time.time() - t0,
                launches=tally.take(), staple=list(staple_runs)))
            return out

        Engine.eval_case = eval_case
        staple.staple_binary = staple_binary

    def close(self) -> None:
        self.cls.eval_case = self.orig
        self.staple.staple_binary = self.orig_staple


def run_cli(argv, dev, env=(), probe: bool = True) -> dict:
    """The inference CLI with ``env`` set for the run and the kernels'
    counters zeroed just before and read just after; with ``probe`` each
    case's launches too (:class:`CaseProbe`, which synchronises around
    every case), without it nothing wrapped, so the eval pipeline overlaps
    as it does in service."""
    import os

    import torch
    from brats21_tpu_torch.cli.main_inference import main
    saved = {k: os.environ.get(k) for k, _ in env}
    os.environ.update(dict(env))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tf32_default()
    tally = Tally()
    case_probe = CaseProbe(tally) if probe else None
    t0 = time.time()
    try:
        meters = main(argv)
        torch.cuda.synchronize()
    finally:
        if case_probe is not None:
            case_probe.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.time() - t0
    check_tf32_off("inference")
    tally.take()
    counts = dict(tally.total)
    return dict(wall_s=wall, case_s=list(meters["batch_time"].history),
                data_time_s=list(meters["data_time"].history), launches=counts,
                cases=case_probe.cases if probe else None, loss=float(meters["loss"].avg),
                meters={k: (m.avg.tolist() if hasattr(m.avg, "tolist") else m.avg)
                        for k, m in meters.items() if k not in ("batch_time", "data_time")},
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
                             num_workers=0, cleaning_areas=True, replace_value=True,
                             criterion="dice")
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
        probs, _ = engine.member_probs(model, img)
        mark("forward_sigmoid")
        fused = post_process(probs, **post_kwargs_from_cfg(cfg))
        mark("post_process")
        brain = (img != 0).any(dim=-1, keepdim=True)
        fused_np = (fused * brain.to(fused.dtype)).cpu().numpy()
        mark("seal_copy_out")
        engine._save_segmentation(batch, fused_np[0], p_b, p_a, str(out))
        mark("unpad_uncrop_save")
        forward_ms = time_ms(lambda: engine.member_probs(model, img), iters=3)
    return dict(stages_s=stages, forward_ms=forward_ms)


def decode_paths(data: Path, repeats: int = 3) -> dict:
    """Decode + crop + normalise of the served case on the native loader's
    path and on the numpy path, in turns (native first, then numpy first,
    ...), host clock; and the largest difference of their images."""
    import numpy as np
    from brats21_tpu_torch.data.discovery import create_database, make_file_records
    from brats21_tpu_torch.data.pipeline import BraTSDataset
    rec, = make_file_records(create_database(str(data)), with_seg=False)
    ds = BraTSDataset([rec], with_seg=False)
    paths = dict(native=ds._getitem_native, numpy=ds._getitem_numpy)
    times, images = dict(native=[], numpy=[]), {}
    for i in range(repeats):
        for name in (("native", "numpy") if i % 2 == 0 else ("numpy", "native")):
            t = time.time()
            sample = paths[name](rec)
            times[name].append(time.time() - t)
            if sample is None:
                raise AssertionError("the native loader failed on the served case")
            images[name] = sample["img"]
    err = float(np.abs(images["native"] - images["numpy"]).max())
    if images["native"].shape != images["numpy"].shape or not err <= 1e-4:
        raise AssertionError(f"native vs numpy decode: shapes {images['native'].shape} / "
                             f"{images['numpy'].shape}, max |err| {err:.3g} > 1e-4")
    return dict(native_s=times["native"], numpy_s=times["numpy"], max_abs_err=err)


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


def check_edt(dev, padded) -> dict:
    """The EDT envelope kernels (the mask pass and the general pass)
    against their plain version, the O(n²) scan, on every pass of edt_sq:
    bit for bit over the train step's masks (3×128³ and the step's one batch
    of 12×128³), the full case's six masks (6×240×240×155), the validation
    loss's batch (12 masks of the ``padded`` case) and hand-made edge lines
    at unit sampling; within rtol 1e-6 over one 240×240×155
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
                                    ((12, *padded), (1.0, 1.0, 1.0), 0.9),
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
    def batch_sum(shape):
        """One edt_sq's three passes over ``shape``."""
        sel = [r for r in rows if r["shape"] == list(shape)]
        return {k: sum(r[k] for r in sel)
                for k in ("ms", "plain_ms", "bound_ms", "scan_bound_ms")}, sel[0]["bound_by"]

    # the train step's one EDT batch: 12 masks of 128³, three passes
    per_step, by = batch_sum((12, *PATCH))
    full_case, _ = batch_sum((6, *CASE_SHAPE))
    val_loss, _ = batch_sum((12, *padded))
    log(f"edt per train step (12×128³, 3 launches): kernel {per_step['ms']:.4f} ms, bound "
        f"{per_step['bound_ms']:.4f} ms; full case 6×240×240×155 edt_sq: kernel "
        f"{full_case['ms']:.4f} ms, bound {full_case['bound_ms']:.4f} ms; validation "
        f"loss batch 12×{'×'.join(map(str, padded))}: kernel {val_loss['ms']:.4f} ms, "
        f"bound {val_loss['bound_ms']:.4f} ms, plain {val_loss['plain_ms']:.2f} ms")
    return dict(rows=rows, max_abs_err=max_err, bound_by=by,
                full_case_ms=full_case["ms"], full_case_bound_ms=full_case["bound_ms"],
                val_loss_batch=val_loss, **per_step)


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
    # one conv applied three times with the same weights (R2Unet's
    # RecurrentBlock: x1 = conv(x), then x1 = conv(x + x1) twice): the
    # gradients of the weights add up over the three launches
    spatial, c = tuple(s // 4 for s in PATCH), 48
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((1, *spatial, c), generator=gen, device=dev).to(dtype)
        w = (torch.randn((3, 3, 3, c, c), generator=gen, device=dev) / (27 * c) ** 0.5).to(dtype)
        b = 0.1 * torch.randn((c,), generator=gen, device=dev)
        ct = torch.randn((1, *spatial, c), generator=gen, device=dev).to(dtype)
        args = [a.detach().requires_grad_() for a in (x, w, b)]

        def recurrent(fn):
            y = fn(*args)
            for _ in range(2):
                y = fn(args[0] + y, args[1], args[2])
            return y

        count = conv3d.launches
        got = torch.autograd.grad(recurrent(Conv3x3x3Function.apply), args, ct)
        torch.cuda.synchronize()
        if conv3d.launches - count != 3:
            raise AssertionError(f"shared conv: {conv3d.launches - count} launches, not 3")
        want = torch.autograd.grad(recurrent(conv3x3x3_plain), args, ct)
        rel = 2e-2 if dtype == torch.bfloat16 else 1e-5
        errs = {}
        for gname, gg, ww in zip(("dx", "dw", "dbias"), got, want):
            err = (gg.float() - ww.float()).abs().max().item()
            tol = rel * ww.float().abs().max().item() + 1e-6
            if not err <= tol:
                raise AssertionError(f"shared conv {gname} {dtype}: max |err| {err:.3g} > "
                                     f"{tol:.3g}")
            errs[gname] = err
        key = f"conv3x3x3 shared x3 {str(dtype)[6:]} {'x'.join(map(str, spatial))}x{c}"
        out[key] = errs
        log(f"{key} grads vs plain autograd: " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items()))
        del x, w, args, got, want, ct
    return out


class StepProbe:
    """Wraps TrainStep's two halves for the training phase: takes the
    tally before each step's forward (what was launched since, by the
    loader's threads or a val case, is the run's, not the step's), after
    it and after the backward and optimizer step, and records CUDA events
    around each step and the host clock at each step's start (the interval
    takes in the loader's wait)."""

    def __init__(self, tally: Tally):
        import torch
        from brats21_tpu_torch.learning.train_state import TrainStep
        self.tally = tally
        self.forward, self.backward, self.events, self.host_t = [], [], [], []
        self.losses = []
        self.cls = TrainStep
        self.orig = (TrainStep.forward_loss, TrainStep.backward_update)
        probe = self

        def forward_loss(step, state, img, target, *args):
            probe.state = state
            probe.host_t.append(time.time())
            tally.take()
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            out = probe.orig[0](step, state, img, target, *args)
            probe.forward.append(tally.take())
            probe.events.append([start])
            probe.losses.append(out[0].detach())
            return out

        def backward_update(step, state, loss):
            tally.take()
            out = probe.orig[1](step, state, loss)
            probe.backward.append(tally.take())
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            probe.events[-1].append(end)
            return out

        TrainStep.forward_loss, TrainStep.backward_update = forward_loss, backward_update

    def close(self) -> None:
        self.cls.forward_loss, self.cls.backward_update = self.orig

    def step_ms(self) -> list:
        return [a.elapsed_time(b) for a, b in self.events]

    def total_launches(self) -> dict:
        """Every launch of the run: the steps' and those between them."""
        self.tally.take()
        return dict(self.tally.total)


def run_training(data: Path, runs: Path, dev, criterion: str = "dice_hd",
                 extra=("--fold", "None"), model_args=None) -> dict:
    """The train CLI on the card, probed step by step and val case by val
    case; returns launches per step and over the whole run, each val
    case's launches, step times, the CLI wall, the peak memory and the run
    directory. ``model_args`` (model, norm, criterion, optimizer) default to
    the flagship recipe with ``criterion``."""
    import statistics

    import torch
    from brats21_tpu_torch.cli.main_train import main as train_main
    if model_args is None:
        model_args = ("--model", "equiunet_assp_evo", "--width", str(WIDTH), "--criterion",
                      criterion, "--optimizer", "ranger", "--decay_type", "cosine",
                      "--learning_rate", "3e-4", "--use_gc", "--remove_outliers")
    argv = ["--train_data_path", str(data), "--save_path", str(runs), "--device", "0",
            *model_args, "--epochs", "1", "--num_workers", "2",
            "--patch_size", *map(str, PATCH), "--no_tensorboard", *extra]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tf32_default()
    tally = Tally()
    probe = StepProbe(tally)
    cases = CaseProbe(tally)
    t0 = time.time()
    try:
        result = train_main(argv)
        torch.cuda.synchronize()
    finally:
        probe.close()
        cases.close()
    wall = time.time() - t0
    check_tf32_off("train")
    step_ms = probe.step_ms()
    run_dir, = [p for p in runs.iterdir() if p.is_dir()]
    host_ms = [1e3 * (b - a) for a, b in zip(probe.host_t, probe.host_t[1:])]
    return dict(result=result, wall_s=wall, steps=len(step_ms), step_ms=step_ms,
                step_losses=[float(v) for v in probe.losses], val_cases=cases.cases,
                step_ms_median_after_first=statistics.median(step_ms[1:] or step_ms),
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


def check_report(path: Path, rows: int) -> list:
    """An Evaluation report's CSV (and its xlsx beside it): ``rows`` rows,
    every value finite, Dice in [0, 1] and HD95 ≥ 0 in every channel."""
    import csv
    with open(path) as f:
        table = list(csv.reader(f))
    if len(table) != rows + 1 or not path.with_suffix(".xlsx").exists():
        raise AssertionError(f"{path.name}: {len(table) - 1} rows, want {rows}, and its xlsx")
    for row in table[1:]:
        for col, v in zip(table[0][1:], row[1:]):
            v = float(v)
            if not math.isfinite(v) or (col.startswith("Dice") and not 0 <= v <= 1) or (
                    col.startswith("Hausdorff") and v < 0):
                raise AssertionError(f"{path.name}: {row[0]} {col} = {v}")
    log(f"{path.name}: " + json.dumps([dict(zip(table[0], r)) for r in table[1:]]))
    return table


def val_case_split(run_dir: Path, out: Path, dev) -> dict:
    """Where one validation case's time goes (w48, bf16, dice_hd, the run's
    ``best_model.pth``, its fold-0 val case), each stage ended by a
    synchronise and timed on the host clock: the plain forward with its
    deep heads, its loss and of that the EDT maps, post-process and brain
    mask, Dice on the card, HD95 on the host, the report row, copy-out and
    save; TTA's forwards without and with the target, and the sliding
    window's forwards and loss. The peak memory of the plain forward with
    its deep heads."""
    import numpy as np
    import torch
    from brats21_tpu_torch.config import TrainConfig
    from brats21_tpu_torch.data.pipeline import make_train_val_loaders
    from brats21_tpu_torch.learning.engine import Engine, forward_channels_last
    from brats21_tpu_torch.learning.losses import deep_supervision_loss, make_criterion
    from brats21_tpu_torch.models import get_model
    from brats21_tpu_torch.ops.postprocess import post_process
    from brats21_tpu_torch.ops.sliding_window import sliding_window_inference
    from brats21_tpu_torch.ops.tta import main_head, tree_map
    from brats21_tpu_torch.utils.metrics import compute_case_metrics
    from brats21_tpu_torch.utils.reporting import EvaluationReport
    from brats21_tpu_torch.utils.weights import load_reference_pth
    cfg = TrainConfig.from_yaml(str(run_dir / "config.yaml"))
    model = get_model(cfg)
    model.load_state_dict(load_reference_pth(str(run_dir / "best_model.pth")))
    model = model.to(dev).eval()
    criterion = make_criterion(cfg)
    engine = Engine(cfg, dev, criterion=criterion)
    batch = next(iter(make_train_val_loaders(cfg, dev)[1]))
    stages = {}
    t = time.time()

    def mark(name):
        nonlocal t
        torch.cuda.synchronize()
        stages[name] = time.time() - t
        t = time.time()

    with torch.inference_mode():
        padded, p_b, p_a = engine._pad_case(batch["img"][0], False)
        img = torch.from_numpy(padded.astype(np.float16)).to(dev)[None]
        tgt_cl = torch.from_numpy(engine._pad_with(batch["seg"][0], p_b, p_a)).to(dev)[None]
        tgt_cl = tgt_cl.float()
        tgt = tgt_cl.permute(0, 4, 1, 2, 3)
        mark("pad_copy_in")
        torch.cuda.reset_peak_memory_stats(dev)
        out_tree = forward_channels_last(model, img.to(torch.bfloat16), with_deep=True)
        mark("forward_deep_heads")
        peak = torch.cuda.max_memory_allocated(dev)
        heads = tree_map(lambda h: h.permute(0, 4, 1, 2, 3), out_tree)
        loss = deep_supervision_loss(criterion, heads, tgt)
        mark("loss")
        criterion.maps([heads[0]] + list(heads[1]), tgt)
        mark("loss_edt_maps")
        fused = post_process(torch.sigmoid(main_head(out_tree).float()))
        fused = fused * (img != 0).any(dim=-1, keepdim=True).to(fused.dtype)
        mark("post_process_brain_mask")
        dice = compute_case_metrics(fused, tgt_cl, ["dice"])
        mark("dice_on_card")
        hd95 = compute_case_metrics(fused, tgt_cl, ["hausdorff_distance95"])
        mark("hd95_on_host")
        EvaluationReport().add(batch["patient_id"][0], {**dice, **hd95})
        mark("report_row")
        engine._save_segmentation(batch, fused[0].cpu().numpy(), p_b, p_a, str(out))
        mark("copy_out_save")
        # TTA and the sliding window, each after one untimed run (the
        # permuted and windowed shapes' first use): TTA's 16 forwards
        # without a target (main head only), then with it (deep heads and
        # 16 losses); the sliding window's stitched logits, then their loss
        for kw in (dict(use_tta=True), dict(sliding=True)):
            engine.member_probs(model, img, **kw)
        mark("warm_up_tta_sliding")
        engine.member_probs(model, img, use_tta=True)
        mark("tta_forward_no_target")
        engine.member_probs(model, img, use_tta=True, target=tgt)
        mark("tta_forward_deep_heads_loss")
        logits = sliding_window_inference(img.to(torch.bfloat16), SW_ROI,
                                          lambda w: forward_channels_last(model, w))
        mark("sliding_forward")
        deep_supervision_loss(criterion, logits.permute(0, 4, 1, 2, 3), tgt)
        mark("sliding_loss")
    return dict(stages_s=stages, loss=float(loss), dice=dice["Dice"].tolist(),
                hd95=hd95["Hausdorff_Distance95"].tolist(),
                forward_deep_heads_peak_bytes=peak)


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


def validation_phase(work: Path, train_data: Path, extra_case: Path, dev) -> tuple:
    """Phase 12: the train CLI with ``--fold 0 --val_frequency 1
    --evaluate_end_training`` over phase 9's four cases and a fifth, with
    its checks, then one val case's split. Returns the run, the split and
    the data directory."""
    import torch
    t0 = time.time()
    torch.cuda.empty_cache()
    val_data = work / "val_data"
    val_data.mkdir()
    for case in sorted(p for d in (train_data, extra_case) for p in d.iterdir()):
        (val_data / case.name).symlink_to(case, target_is_directory=True)
    val = run_training(val_data, work / "runs_val", dev, extra=(
        "--fold", "0", "--val_frequency", "1", "--evaluate_end_training",
        "--sliding_window_size", *map(str, SW_ROI)))
    if val["steps"] != 4:
        raise AssertionError(f"fold 0 of five cases ran {val['steps']} steps, not 4")
    for i, fwd in enumerate(val["forward_launches"]):
        if fwd != TRAIN_STEP_LAUNCHES:
            raise AssertionError(f"validation run, train step {i}: forward launches {fwd}")
    vres = val["result"]
    if not math.isfinite(vres["val_loss"]) or vres["best_value"] != vres["val_loss"]:
        raise AssertionError(f"validation loss {vres['val_loss']}, best {vres['best_value']}")
    val_dir = Path(val["run_dir"])
    if torch.load(val_dir / "best_model.pth", weights_only=True)["best_value"] != \
            vres["val_loss"]:
        raise AssertionError("best_model.pth was not written by the validation loss")
    # the epoch's validation, then the end-of-training evaluation without and with TTA
    if [c["tta"] for c in val["val_cases"]] != [False, False, True]:
        raise AssertionError(f"val cases {val['val_cases']}")
    for c in val["val_cases"]:
        want_case = {k: (16 if c["tta"] else 1) * v for k, v in VAL_CASE_LAUNCHES.items()}
        if c["launches"] != want_case:
            raise AssertionError(f"val case (tta={c['tta']}): launches {c['launches']} != "
                                 f"{want_case}")
    for suffix in ("", "_tta"):
        table = check_report(val_dir / f"Evaluation{suffix}.csv", rows=1)
        check_segmentation(val_dir / f"segmentations{suffix}" / f"{table[1][0]}.nii.gz")
    split = val_case_split(val_dir, work / "out_val_split", dev)
    log(f"phase 12 validation: {val['steps']} steps, train loss "
        f"{vres['train_loss']:.4f}, val loss {vres['val_loss']:.4f} (best_model.pth), end "
        f"dice {vres['eval_dice']:.4f} / TTA {vres['eval_tta_dice']:.4f}; val cases "
        f"{json.dumps(val['val_cases'])}; CLI wall {val['wall_s']:.1f}s, peak "
        f"{val['peak_bytes'] / 2**30:.2f} GiB; one val case split {json.dumps(split)}; "
        f"in {time.time() - t0:.1f}s")
    return val, split, val_data


def ensemble_phase(work: Path, run_dir: Path, other_run: Path, val_data: Path,
                   dev) -> dict:
    """Phase 13: the inference CLI ``--on val`` with the run's config and
    two members of the same architecture and different weights: the run's
    ``best_model.pth`` and another run's ``last_model.pth``. Sliding
    windows, sliding × TTA, and STAPLE, each case's launches checked
    against the members' forwards (the window batches from the case's own
    padded shape) and losses; STAPLE's EM must iterate past its first step
    on some channel, which it does only where the members disagree."""
    import torch
    from brats21_tpu_torch.ops.sliding_window import window_plan
    t0 = time.time()
    torch.cuda.empty_cache()
    ens = ["--config", str(run_dir / "config.yaml"), str(other_run / "config.yaml"),
           "--import_pth", str(run_dir / "best_model.pth"), str(other_run / "last_model.pth"),
           "--on", "val", "--train_data_path", str(val_data), "--device", "0",
           "--sliding_window_size", *map(str, SW_ROI)]
    ensemble = {}
    for mode, flags in (("sliding", ["--sliding_window_inference"]),
                        ("sliding_tta", ["--sliding_window_inference", "--tta"]),
                        ("staple", ["--perform_staple"])):
        out = work / f"out_{mode}"
        run = run_cli(ens + flags + ["--output", str(out)], dev)
        case, = run["cases"]
        if mode == "staple":
            member = dict(VAL_CASE_LAUNCHES)
        else:
            _, _, starts = window_plan(case["padded"], SW_ROI)
            batches = -(-len(starts) // SW_BATCH)
            member = {k: batches * v for k, v in SERVED_FORWARD_LAUNCHES.items()}
            member["edt_envelope"] = 3
            if mode == "sliding_tta":
                member = {k: 16 * v for k, v in member.items()}
            case["windows"], case["window_batches"] = len(starts), batches
        want_case = {k: case["members"] * v for k, v in member.items()}
        if case["members"] != 2 or case["launches"] != want_case or run["launches"] != \
                want_case:
            raise AssertionError(f"{mode}: {case['members']} members, case launches "
                                 f"{case['launches']}, run {run['launches']}, want {want_case}")
        if mode == "staple" and (len(case["staple"]) != 3 or max(
                r["iterations"] for r in case["staple"]) < 2):
            raise AssertionError(f"STAPLE over two members: {case['staple']}; the members "
                                 f"agree everywhere, or a channel was not fused")
        report, = out.glob("Evaluation_inference_val*.csv")
        table = check_report(report, rows=1)
        check_segmentation(out / "Inference_segmentations_val" / f"{table[1][0]}.nii.gz")
        ensemble[mode] = run
        log(f"phase 13 {mode}: case {run['case_s'][0]:.3f}s (members, losses and fusion "
            f"{case['seconds']:.3f}s), loss {run['loss']:.4f}, CLI wall {run['wall_s']:.1f}s, "
            f"peak {run['peak_bytes'] / 2**30:.2f} GiB, case {json.dumps(case)}")
    log(f"phase 13 ensemble on the val case: {time.time() - t0:.1f}s")
    return ensemble


def docker_phase(work: Path, run_dir: Path, case_dir: Path, dev) -> dict:
    """Phase 14: the Dockerfile's ENTRYPOINT flags with only ``--config``
    of a run directory, against the same run served with ``--import_pth``
    of its ``best_model.pth``: equal label maps, 224 / 336 / 0 launches a
    case."""
    import numpy as np
    from brats21_tpu_torch.data.nifti import read_nifti
    t0 = time.time()
    entrypoint = ["--on", "test", "--docker_test", "--input", str(case_dir), "--tta",
                  "--replace_value", "--replace_value_threshold", "300", "--cleaning_areas",
                  "--cleaning_areas_threshold", "20", "--config", str(run_dir / "config.yaml")]
    runs, labels = {}, {}
    want_case = {k: 16 * v for k, v in SERVED_FORWARD_LAUNCHES.items()}
    for mode, extra in (("run_directory", []),
                        ("import_pth", ["--import_pth", str(run_dir / "best_model.pth")])):
        out = work / f"out_docker_{mode}"
        run = run_cli(entrypoint + extra + ["--output", str(out)], dev)
        case, = run["cases"]
        if case["launches"] != want_case or not case["tta"]:
            raise AssertionError(f"phase 14 {mode}: case launches {case['launches']} != "
                                 f"{want_case}")
        seg = out / "Inference_segmentations_test" / f"{case_dir.name}.nii.gz"
        check_segmentation(seg)
        labels[mode] = read_nifti(str(seg)).data
        runs[mode] = dict(case_s=run["case_s"], wall_s=run["wall_s"], launches=case["launches"],
                          peak_bytes=run["peak_bytes"])
    same = int((labels["run_directory"] == labels["import_pth"]).sum())
    if same != labels["import_pth"].size:
        raise AssertionError(f"phase 14: the run directory's labels differ from --import_pth's "
                             f"on {labels['import_pth'].size - same} voxels")
    tumour = int((labels["import_pth"] > 0).sum())
    log(f"phase 14 Dockerfile command: labels equal to --import_pth's on all {same} voxels "
        f"({tumour} tumour); {json.dumps(runs)}; in {time.time() - t0:.1f}s")
    return dict(runs=runs, equal_voxels=same, tumour_voxels=tumour)


def watch_phase(work: Path, run_dir: Path, cropped, dev) -> dict:
    """Phase 15: ``--watch`` on an empty folder with ``--watch_warmup`` at
    the cases' cropped shape; two w48 cases land one after the other, then a
    corrupt one. Checks each case's launches, the first case's seconds
    within 1.5× the second's, and the corrupt case's quarantine."""
    import os
    import re
    import threading

    from brats21_tpu_torch.cli.main_inference import main
    from brats21_tpu_torch.data import native
    from brats21_tpu_torch.data.synthetic import generate_synthetic_dataset
    t0 = time.time()
    inbox, staging, out = work / "watch_in", work / "watch_staging", work / "watch_out"
    inbox.mkdir()
    stop = work / "watch_stop"
    max_attempts = int(os.environ.get("BRATS21_WATCH_MAX_ATTEMPTS", "3"))
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda i: generate_synthetic_dataset(
            str(staging), num_cases=1, shape=CASE_SHAPE, seed=SEED + 20, first_case=i,
            with_seg=False), (100, 101, 102)))
    cases = sorted(p.name for p in staging.iterdir())
    bad = cases[2]
    (staging / bad / f"{bad}_t1.nii.gz").write_bytes(b"this is not a nifti")
    logfile = out / "logfile_inference.log"

    def logged(pattern):
        return re.findall(pattern, logfile.read_text()) if logfile.exists() else []

    def wait_for(pred, what, timeout=120.0):
        t = time.time()
        while time.time() - t < timeout:
            if not thread.is_alive():
                raise AssertionError(f"phase 15: the server ended before {what}")
            if pred():
                return time.time() - t
            time.sleep(0.05)
        raise AssertionError(f"phase 15: no {what} within {timeout:.0f}s")

    def segmented(pid):
        return (out / "Inference_segmentations_test" / f"{pid}.nii.gz").exists()

    argv = ["--config", str(run_dir / "config.yaml"), "--on", "test", "--input", str(inbox),
            "--output", str(out), "--device", "0", "--watch", "--watch_interval", "0.5",
            "--watch_stop_file", str(stop), "--watch_warmup", *map(str, cropped)]
    tally = Tally()
    probe = CaseProbe(tally)
    leftover = native.take_counts()
    if leftover["loads"] or leftover["fallbacks"]:
        raise AssertionError(f"phase 15: native counts {leftover} left unchecked before it")
    errors = []

    def serve():
        try:
            main(argv)
        except BaseException as e:  # noqa: BLE001 — reported by the main thread
            errors.append(e)

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    try:
        wait_for(lambda: logged(r"warm-up for cropped shape .* done in ([\d.]+)s"), "warm-up")
        warmup_s = float(logged(r"warm-up for cropped shape .* done in ([\d.]+)s")[0])
        for pid in cases[:2]:
            os.rename(staging / pid, inbox / pid)
            wait_for(lambda: segmented(pid), f"segmentation of {pid}")
        os.rename(staging / bad, inbox / bad)
        wait_for(lambda: logged(rf"case {bad} failed (\d+)/\d+ attempts: permanently"),
                 "quarantine of the corrupt case")
        stop.touch()
        thread.join(timeout=60)
    finally:
        stop.touch()
        thread.join(timeout=60)
        probe.close()
    if thread.is_alive() or errors:
        raise AssertionError(f"phase 15: the server did not stop cleanly: {errors}")
    counts = native.take_counts()
    case_s = {pid: float(logged(rf"case {pid}: ([\d.]+)s")[-1]) for pid in cases[:2]}
    attempts = int(logged(rf"case {bad} failed (\d+)/\d+ attempts")[0])
    want = SERVED_FORWARD_LAUNCHES
    if [c["launches"] for c in probe.cases] != [want] * 3:
        raise AssertionError(f"phase 15: warm-up and watched case launches "
                             f"{[c['launches'] for c in probe.cases]}, want {want} each")
    if attempts != max_attempts or counts != dict(loads=3, fallbacks=2 * max_attempts):
        raise AssertionError(f"phase 15: corrupt case quarantined after {attempts} attempts "
                             f"(want {max_attempts}); native counts {counts}")
    first, second = (case_s[pid] for pid in cases[:2])
    if first > 1.5 * second:
        raise AssertionError(f"phase 15: the first case after the warm-up took {first:.3f}s, "
                             f"over 1.5× the second's {second:.3f}s")
    res = dict(warmup_s=warmup_s, case_s=[first, second],
               case_launches=probe.cases[1]["launches"],
               eval_case_s=[c["seconds"] for c in probe.cases], quarantine_attempts=attempts,
               native=counts, phase_s=time.time() - t0)
    log(f"phase 15 --watch: warm-up {warmup_s:.2f}s (its case {probe.cases[0]['seconds']:.3f}s "
        f"in eval_case); first watched case {first:.3f}s, second {second:.3f}s "
        f"(ratio {first / second:.3f}); the corrupt case quarantined after {attempts} "
        f"attempts; native {counts}; in {res['phase_s']:.1f}s")
    return res


class DtypeTally:
    """Counts the conv kernel's launches by input dtype (``--norm batch``
    runs every conv after the first BatchNorm in fp32, on the kernel's FMA
    tile path) while it is open."""

    def __init__(self):
        import torch
        from brats21_tpu_torch.ops.kernels import conv3d
        self.mod, self.orig = conv3d, conv3d.conv3x3x3
        self.counts = {"bf16": 0, "fp32": 0}
        tally = self

        def conv3x3x3(x, w, bias):
            before = conv3d.launches
            out = tally.orig(x, w, bias)
            tally.counts["bf16" if x.dtype == torch.bfloat16 else "fp32"] += (
                conv3d.launches - before)
            return out

        conv3d.conv3x3x3 = conv3x3x3

    def take(self) -> dict:
        counts, self.counts = self.counts, {"bf16": 0, "fp32": 0}
        return counts

    def close(self) -> None:
        self.mod.conv3x3x3 = self.orig


def model1_phase(work: Path, train_data: Path, data: Path, level_shape, dev) -> dict:
    """Phase 16: Model 1's recipe end to end. The train CLI with its flags
    over phase 9's four cases at 128³ (4 steps of 15 / 0 / 0 launches
    forward, none backward), then the inference CLI with only ``--config``
    of the run on the 240×240×155 case, plain and with ``--tta``, both with
    the post-processing flags (15 / 0 / 0 and 240 / 0 / 0 a case); and the
    conv kernel at Model 1's 15 shapes of the served forward and of the
    128³ train forward against its plain version and cuDNN."""
    t0 = time.time()
    train = run_training(train_data, work / "runs_model1", dev, model_args=MODEL1_ARGS)
    if train["steps"] != 4:
        raise AssertionError(f"Model 1 ran {train['steps']} steps, not 4")
    for i, (fwd, bwd) in enumerate(zip(train["forward_launches"], train["backward_launches"])):
        if fwd != MODEL1_STEP_LAUNCHES or any(bwd.values()):
            raise AssertionError(f"Model 1 step {i}: forward launches {fwd} (want "
                                 f"{MODEL1_STEP_LAUNCHES}), backward {bwd} (want none)")
    if not math.isfinite(train["result"]["train_loss"]):
        raise AssertionError(f"Model 1 train loss {train['result']['train_loss']}")
    run_dir = Path(train["run_dir"])
    if not (run_dir / "best_model.pth").is_file():
        raise AssertionError("Model 1: no best_model.pth in the run directory")
    serve = {}
    for mode, extra, per_case in (("plain", [], 1), ("tta", ["--tta"], 16)):
        out = work / f"out_model1_{mode}"
        run = run_cli(["--config", str(run_dir / "config.yaml"), "--on", "test", "--input",
                       str(data), "--device", "0", "--cleaning_areas", "--replace_value",
                       "--output", str(out), *extra], dev)
        case, = run["cases"]
        want = {k: per_case * v for k, v in MODEL1_STEP_LAUNCHES.items()}
        if case["launches"] != want:
            raise AssertionError(f"Model 1 served {mode}: launches {case['launches']} != {want}")
        check_segmentation(out / "Inference_segmentations_test" / "BraTS2021_00000.nii.gz")
        serve[mode] = dict(case_s=run["case_s"], wall_s=run["wall_s"],
                           launches=case["launches"], peak_bytes=run["peak_bytes"])
    conv_served = check_conv(level_shape, dev, calls=MODEL1_CONV_CALLS)
    conv_train = check_conv(lambda level: tuple(s // 2 ** (level - 1) for s in PATCH), dev,
                            calls=MODEL1_CONV_CALLS)
    conv_refunet = check_conv(level_shape, dev, calls=REFUNET_CONV_CALLS)
    import torch
    torch.cuda.empty_cache()
    for run in (train,):
        run.pop("forward_launches")
        run.pop("backward_launches")
    res = dict(train=train, serve=serve, conv_served=conv_served, conv_train=conv_train,
               conv_refunet_conv_d0=conv_refunet, phase_s=time.time() - t0)
    log(f"phase 16 Model 1 (equiunet w48): train {train['steps']} steps, loss "
        f"{train['result']['train_loss']:.4f}, steps {[round(t, 1) for t in train['step_ms']]} ms, "
        f"peak {train['peak_bytes'] / 2**30:.2f} GiB (no remat); served case plain "
        f"{serve['plain']['case_s'][0]:.3f}s (wall {serve['plain']['wall_s']:.2f}s), TTA "
        f"{serve['tta']['case_s'][0]:.3f}s (wall {serve['tta']['wall_s']:.2f}s); conv a served "
        f"forward {conv_served['ms']:.3f} ms (bound {conv_served['bound_ms']:.3f}, cuDNN "
        f"{conv_served['library_ms']:.3f}, plain {conv_served['plain_ms']:.3f}), a 128³ train "
        f"forward {conv_train['ms']:.3f} ms (bound {conv_train['bound_ms']:.3f}, cuDNN "
        f"{conv_train['library_ms']:.3f}); in {res['phase_s']:.1f}s")
    return res


def time_fp32_conv(dev, spatial, cin: int, cout: int) -> dict:
    """The conv kernel's fp32 path (the FMA tile kernel, where ``--norm
    batch`` sends every conv after the first BatchNorm) at one shape:
    against its plain version within 1e-4·max|ref|, timed beside cuDNN's
    fp32 ``F.conv3d`` (TF32 off) and the bound at the fp32 peak."""
    import torch
    import torch.nn.functional as F
    from brats21_tpu_torch.ops.kernels.conv3d import conv3x3x3, conv3x3x3_plain
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    x = torch.randn((1, *spatial, cin), generator=gen, device=dev)
    w = torch.randn((3, 3, 3, cin, cout), generator=gen, device=dev) / math.sqrt(27 * cin)
    b = 0.1 * torch.randn((cout,), generator=gen, device=dev)
    y, ref = conv3x3x3(x, w, b), conv3x3x3_plain(x, w, b)
    err = (y - ref).abs().max().item()
    if not err <= 1e-4 * ref.abs().max().item():
        raise AssertionError(f"conv3x3x3 fp32 {cin}->{cout} at {spatial}: max |err| {err:.3g}")
    m = math.prod(spatial)
    b_ms, by = bound(2.0 * m * cout * 27 * cin, PEAK_FP32,
                     4.0 * (m * cin + m * cout + 27 * cin * cout + cout))
    x_cl, w_oi = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2).contiguous()
    row = dict(shape=[1, *spatial, cin, cout], max_abs_err=err, bound_ms=b_ms, bound_by=by,
               ms=time_ms(lambda: conv3x3x3(x, w, b), iters=3),
               library_ms=time_ms(lambda: F.conv3d(x_cl, w_oi, b, padding=1), iters=3))
    log(f"conv3x3x3 fp32 {cin}->{cout} at 1x{'x'.join(map(str, spatial))}: err {err:.3g}, "
        f"kernel {row['ms']:.3f} ms, cuDNN fp32 {row['library_ms']:.3f} ms, bound "
        f"{b_ms:.3f} ms ({by})")
    del x, w, y, ref, x_cl, w_oi
    return row


def batchnorm_phase(work: Path, train_data: Path, data: Path, served_padded, dev) -> dict:
    """Phase 17: ``--model att_unet --norm batch`` w48, two train steps at
    128³ (17 conv launches a step), then one served case. The model's
    BatchNorm running statistics move, the attention gates' stay at their
    start (the JAX package calls the gates with running averages), both as
    the checkpoint holds them; and the share of conv launches that took the
    fp32 path (everything after the first BatchNorm runs in fp32)."""
    import torch
    from brats21_tpu_torch.learning.checkpoint import CheckpointManager
    from brats21_tpu_torch.utils.weights import load_reference_pth
    t0 = time.time()
    bn_data = work / "batchnorm_data"
    bn_data.mkdir()
    for case in sorted(p for p in train_data.iterdir() if p.is_dir())[:2]:
        (bn_data / case.name).symlink_to(case, target_is_directory=True)
    saved = {}
    orig_write = CheckpointManager._write

    def write(manager, name, state, epoch, value, *args):
        saved[name] = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()
                       if k.endswith(("running_mean", "running_var"))}
        return orig_write(manager, name, state, epoch, value, *args)

    CheckpointManager._write = write
    dtypes = DtypeTally()
    try:
        train = run_training(bn_data, work / "runs_batchnorm", dev, model_args=BATCHNORM_ARGS)
        train_dtypes = dtypes.take()
        run_dir = Path(train["run_dir"])
        out = work / "out_batchnorm"
        served = run_cli(["--config", str(run_dir / "config.yaml"), "--on", "test", "--input",
                          str(data), "--device", "0", "--output", str(out)], dev)
        served_dtypes = dtypes.take()
    finally:
        dtypes.close()
        CheckpointManager._write = orig_write
    if train["steps"] != 2:
        raise AssertionError(f"--norm batch ran {train['steps']} steps, not 2")
    for i, fwd in enumerate(train["forward_launches"]):
        if fwd != BATCHNORM_STEP_LAUNCHES:
            raise AssertionError(f"--norm batch step {i}: launches {fwd} != "
                                 f"{BATCHNORM_STEP_LAUNCHES}")
    if not math.isfinite(train["result"]["train_loss"]):
        raise AssertionError(f"--norm batch train loss {train['result']['train_loss']}")
    case, = served["cases"]
    if case["launches"] != BATCHNORM_STEP_LAUNCHES:
        raise AssertionError(f"--norm batch served launches {case['launches']}")
    check_segmentation(out / "Inference_segmentations_test" / "BraTS2021_00000.nii.gz")
    on_disk = load_reference_pth(str(run_dir / "last_model.pth"))
    moved = gates = 0
    for key, value in saved["last_model.pth"].items():
        if not torch.equal(on_disk[key], value):
            raise AssertionError(f"--norm batch: {key} differs between the model and its "
                                 "checkpoint")
        start = torch.zeros_like(value) if key.endswith("mean") else torch.ones_like(value)
        if key.startswith("Att"):
            gates += 1
            if not torch.equal(value, start):
                raise AssertionError(f"--norm batch: the gate statistic {key} moved")
        elif torch.equal(value, start):
            raise AssertionError(f"--norm batch: {key} did not move in training")
        else:
            moved += 1
    n_train = sum(train_dtypes.values())
    # the fp32 path at the level-1 shapes of the attention unet's decoder,
    # in the 128³ train step and the served case
    fp32_rows = [time_fp32_conv(dev, spatial, cin, 48)
                 for spatial in (PATCH, tuple(served_padded)) for cin in (48, 96)]
    torch.cuda.empty_cache()
    res = dict(steps=train["steps"], step_ms=train["step_ms"], fp32_conv=fp32_rows,
               train_loss=train["result"]["train_loss"], peak_bytes=train["peak_bytes"],
               moved_statistics=moved, frozen_gate_statistics=gates,
               conv_launches_train=train_dtypes, conv_launches_served=served_dtypes,
               fp32_share_train=train_dtypes["fp32"] / max(n_train, 1),
               served_case_s=served["case_s"], served_wall_s=served["wall_s"],
               phase_s=time.time() - t0)
    log(f"phase 17 --norm batch (att_unet w48): {train['steps']} steps "
        f"{[round(t, 1) for t in train['step_ms']]} ms, loss {res['train_loss']:.4f}, peak "
        f"{train['peak_bytes'] / 2**30:.2f} GiB; {moved} running statistics moved, {gates} gate "
        f"statistics unmoved, all equal in last_model.pth; conv launches by dtype: train "
        f"{train_dtypes}, served case {served_dtypes}; served case {served['case_s'][0]:.3f}s; "
        f"in {res['phase_s']:.1f}s")
    return res


def monai_zoo_phase(dev) -> dict:
    """Phase 18: the seven MONAI-backed names at their published widths,
    card against CPU in fp32 (each head within 1e-3 of its largest
    magnitude, as phase 3 holds the zoo), with the conv kernel's launches a
    forward."""
    import torch
    t0 = time.time()
    res = {}
    for name, norm, act, side in MONAI_CHECKS:
        r = res[name] = check_model(dev, name, norm, side, act)
        if r["launches"] != [MONAI_LAUNCHES[name], 0]:
            raise AssertionError(f"model {name}: launches {r['launches']} a forward, want "
                                 f"[{MONAI_LAUNCHES[name]}, 0]")
    torch.cuda.empty_cache()
    log(f"phase 18 MONAI-backed zoo card vs CPU: {time.time() - t0:.1f}s")
    return res


def cases_dir(work: Path, train_data: Path, name: str, n: int) -> Path:
    """A folder of links to the first ``n`` of phase 9's cases."""
    out = work / name
    out.mkdir()
    for case in sorted(p for p in train_data.iterdir() if p.is_dir())[:n]:
        (out / case.name).symlink_to(case, target_is_directory=True)
    return out


def check_step_launches(run: dict, want: dict, what: str) -> None:
    for i, (fwd, bwd) in enumerate(zip(run["forward_launches"], run["backward_launches"])):
        if fwd != want or any(bwd.values()):
            raise AssertionError(f"{what} step {i}: forward launches {fwd} (want {want}), "
                                 f"backward {bwd} (want none)")
    if not all(math.isfinite(v) for v in run["step_losses"]):
        raise AssertionError(f"{what}: step losses {run['step_losses']}")


def sigterm_run(train_data: Path, runs: Path) -> dict:
    """The train CLI in a subprocess, sent a real SIGTERM once its log shows
    the first step's loss (step 2 running): it must save a mid-epoch
    ``last_model.pth`` with a ``batch_cursor`` and exit 0."""
    import signal
    import threading

    import torch
    argv = [sys.executable, "-m", "brats21_tpu_torch.cli.main_train", "--train_data_path",
            str(train_data), "--save_path", str(runs), "--device", "0", *NNUNET_ARGS,
            "--epochs", "1", "--num_workers", "2", "--patch_size", *map(str, PATCH),
            "--no_tensorboard", "--fold", "None", "--log_train_interval", "1"]
    proc = subprocess.Popen(argv, cwd=str(Path(__file__).resolve().parent), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    lines, sent = [], {}

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if "Epoch: [1][1/" in line and not sent:
                sent["t"] = time.time()
                proc.send_signal(signal.SIGTERM)

    reader = threading.Thread(target=read, daemon=True)
    t0 = time.time()
    reader.start()
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=30)
    if not sent or rc != 0:
        raise AssertionError(f"SIGTERM run: signal sent {bool(sent)}, exit code {rc}; last "
                             f"lines: {lines[-15:]}")
    run_dir, = [p for p in runs.iterdir() if p.is_dir()]
    payload = torch.load(run_dir / "last_model.pth", map_location="cpu", weights_only=True)
    cursor = int(payload.get("batch_cursor", 0))
    if not cursor or int(payload["epoch"]) != 0:
        raise AssertionError(f"SIGTERM run: last_model.pth has epoch {payload['epoch']}, "
                             f"batch_cursor {cursor}; lines: {lines[-15:]}")
    stops = [ln for ln in lines if "preempted after epoch" in ln]
    log(f"phase 19 SIGTERM run: signal {sent['t'] - t0:.1f}s after start, exit 0 in "
        f"{time.time() - t0:.1f}s, last_model.pth epoch 0, batch_cursor {cursor}: {stops}")
    return dict(run_dir=str(run_dir), batch_cursor=cursor, exit_code=rc,
                signal_after_s=sent["t"] - t0, wall_s=time.time() - t0)


def compare_resumed(whole_dir: Path, resumed_dir: Path, cfg: dict) -> dict:
    """The resumed run's ``last_model.pth`` against the uninterrupted run's:
    every tensor within ``RESUME_PARAM_SHARE`` of the uninterrupted run's
    movement from the seeded initial weights."""
    import torch
    from brats21_tpu_torch.config import TrainConfig
    from brats21_tpu_torch.models import get_model
    torch.manual_seed(TrainConfig().seed)
    init = get_model(cfg).state_dict()
    whole = torch.load(whole_dir / "last_model.pth", map_location="cpu", weights_only=True)
    resumed = torch.load(resumed_dir / "last_model.pth", map_location="cpu",
                         weights_only=True)
    worst, moved = 0.0, 0
    for key, w in whole["model"].items():
        if not w.is_floating_point():
            continue
        move = (w - init[key]).norm().item()
        diff = (resumed["model"][key] - w).norm().item()
        moved += move > 0
        share = diff / max(move, 1e-12)
        if diff > RESUME_PARAM_SHARE * move + 1e-7:
            raise AssertionError(f"resumed {key}: |resumed - whole| {diff:.3g} over "
                                 f"{RESUME_PARAM_SHARE} of its movement {move:.3g}")
        worst = max(worst, share if move > 0 else 0.0)
    return dict(worst_share_of_movement=worst, tensors_moved=moved,
                epochs=(int(whole["epoch"]), int(resumed["epoch"])))


def nnunet_phase(work: Path, train_data: Path, data: Path, dev) -> dict:
    """Phase 19: nnunet at full width (filters 32…320, ``--norm instance``)
    through the train CLI at 128³ with ``--optimizer novograd``: an
    uninterrupted 4-step run; the same run in a subprocess stopped by a real
    SIGTERM mid-epoch (exit 0, ``batch_cursor`` in ``last_model.pth``); its
    ``--resume``, held to the uninterrupted run; then the run directory
    served on the 240×240×155 case as the JAX package serves nnunet
    (``--eval_bucket 32``; the default bucket fails the skip concatenation,
    as there); and the conv kernel at nnunet's 17 shapes and at SegResNet's
    and UNETR's narrow layers, at 128³, against its bound and cuDNN."""
    import torch
    t0 = time.time()
    torch.cuda.empty_cache()
    whole = run_training(train_data, work / "runs_nnunet", dev, model_args=NNUNET_ARGS)
    if whole["steps"] != 4:
        raise AssertionError(f"nnunet ran {whole['steps']} steps, not 4")
    check_step_launches(whole, NNUNET_STEP_LAUNCHES, "nnunet")
    whole["step_launches"] = whole["forward_launches"][0]
    stopped = sigterm_run(train_data, work / "runs_nnunet_sigterm")
    resumed = run_training(train_data, work / "runs_nnunet_sigterm", dev,
                           model_args=NNUNET_ARGS,
                           extra=("--fold", "None", "--resume",
                                  str(Path(stopped["run_dir"]) / "last_model.pth")))
    if resumed["steps"] != 4 - stopped["batch_cursor"] or resumed["result"][
            "global_step"] != 4:
        raise AssertionError(f"resume from batch {stopped['batch_cursor']}: "
                             f"{resumed['steps']} steps, global step "
                             f"{resumed['result']['global_step']}")
    check_step_launches(resumed, NNUNET_STEP_LAUNCHES, "nnunet resumed")
    loss_w, loss_r = whole["step_losses"][-1], resumed["step_losses"][-1]
    if not abs(loss_r - loss_w) <= RESUME_LOSS_RTOL * abs(loss_w):
        raise AssertionError(f"resumed last-step loss {loss_r} vs uninterrupted {loss_w}")
    held = compare_resumed(Path(whole["run_dir"]), Path(stopped["run_dir"]),
                           {"model": "nnunet", "norm": "instance"})
    out = work / "out_nnunet"
    base = ["--config", str(Path(whole["run_dir"]) / "config.yaml"), "--on", "test",
            "--input", str(data), "--device", "0"]
    try:
        run_cli(base + ["--output", str(work / "out_nnunet_bucket8")], dev)
    except ValueError as err:
        refused = str(err)
    else:
        raise AssertionError("nnunet served at --eval_bucket 8 on a padded case that is not "
                             "a multiple of 32")
    served = run_cli(base + ["--eval_bucket", "32", "--output", str(out)], dev)
    case, = served["cases"]
    if case["launches"] != NNUNET_STEP_LAUNCHES or any(s % 32 for s in case["padded"]):
        raise AssertionError(f"nnunet served case: launches {case['launches']}, padded "
                             f"{case['padded']}")
    check_segmentation(out / "Inference_segmentations_test" / "BraTS2021_00000.nii.gz")
    levels = lambda level: tuple(s // 2 ** (level - 1) for s in PATCH)  # noqa: E731
    conv = check_conv(levels, dev, calls=NNUNET_CONV_CALLS)
    conv_segresnet = check_conv(levels, dev, calls=SEGRESNET_CONV_CALLS)
    conv_unetr = check_conv(levels, dev, calls=UNETR_CONV_CALLS)
    torch.cuda.empty_cache()
    for run in (whole, resumed):
        run.pop("forward_launches")
        run.pop("backward_launches")
    res = dict(train=whole, sigterm=stopped, resumed=resumed, resume_held=held,
               refused_bucket8=refused, served=dict(
                   case_s=served["case_s"], wall_s=served["wall_s"], padded=case["padded"],
                   launches=case["launches"], peak_bytes=served["peak_bytes"]),
               conv_train_forward=conv, conv_segresnet_8ch=conv_segresnet,
               conv_unetr_16ch=conv_unetr, phase_s=time.time() - t0)
    log(f"phase 19 nnunet (novograd): steps {[round(t, 1) for t in whole['step_ms']]} ms "
        f"(median after the first {whole['step_ms_median_after_first']:.1f}), losses "
        f"{[round(v, 4) for v in whole['step_losses']]}, peak "
        f"{whole['peak_bytes'] / 2**30:.2f} GiB; SIGTERM at batch {stopped['batch_cursor']}, "
        f"resumed {resumed['steps']} steps, last loss {loss_r:.6f} vs {loss_w:.6f}, tensors "
        f"within {held['worst_share_of_movement']:.3g} of their movement; served case "
        f"{served['case_s'][0]:.3f}s (padded {case['padded']}, wall {served['wall_s']:.2f}s, "
        f"peak {served['peak_bytes'] / 2**30:.2f} GiB); conv a 128³ train forward "
        f"{conv['ms']:.3f} ms (bound {conv['bound_ms']:.3f}, cuDNN {conv['library_ms']:.3f}); "
        f"SegResNet 8-channel layers {conv_segresnet['ms']:.3f} ms (bound "
        f"{conv_segresnet['bound_ms']:.3f}, cuDNN {conv_segresnet['library_ms']:.3f}); UNETR "
        f"16-channel {conv_unetr['ms']:.3f} ms (bound {conv_unetr['bound_ms']:.3f}, cuDNN "
        f"{conv_unetr['library_ms']:.3f}); in {res['phase_s']:.1f}s")
    return res


def unetr_phase(work: Path, train_data: Path, data: Path, dev) -> dict:
    """Phase 20: unet_tr at full width (ViT-B/16: hidden 768, 12 layers, 12
    heads, MLP 3072; feature size 16) through the train CLI, 2 steps at
    128³, then one case served through sliding windows of 128³ (a full
    volume fails on the position embedding, as in the JAX package); and 2
    steps of segresnetvae, whose VAE term must be finite and added to the
    criterion's mean in every step."""
    import torch
    from brats21_tpu_torch.learning import train_state
    from brats21_tpu_torch.ops.sliding_window import window_plan
    t0 = time.time()
    torch.cuda.empty_cache()
    two = cases_dir(work, train_data, "two_cases", 2)
    train = run_training(two, work / "runs_unetr", dev, model_args=UNETR_ARGS)
    if train["steps"] != 2:
        raise AssertionError(f"unet_tr ran {train['steps']} steps, not 2")
    check_step_launches(train, UNETR_STEP_LAUNCHES, "unet_tr")
    train["step_launches"] = train["forward_launches"][0]
    run_dir = Path(train["run_dir"])
    base = ["--config", str(run_dir / "config.yaml"), "--on", "test", "--input", str(data),
            "--device", "0"]
    try:
        run_cli(base + ["--output", str(work / "out_unetr_full")], dev)
    except ValueError as err:
        refused = str(err)
    else:
        raise AssertionError("unet_tr served a full volume")
    out = work / "out_unetr"
    served = run_cli(base + ["--sliding_window_inference", "--sliding_window_size",
                             *map(str, PATCH), "--output", str(out)], dev)
    case, = served["cases"]
    _, _, starts = window_plan(case["padded"], PATCH)
    batches = -(-len(starts) // SW_BATCH)
    want = {k: batches * v for k, v in UNETR_STEP_LAUNCHES.items()}
    if case["launches"] != want:
        raise AssertionError(f"unet_tr served case: launches {case['launches']} != {want} "
                             f"({len(starts)} windows)")
    check_segmentation(out / "Inference_segmentations_test" / "BraTS2021_00000.nii.gz")

    vae_terms = []
    orig = train_state.deep_supervision_loss

    def loss_with_vae(criterion, outputs, target):
        total = orig(criterion, outputs, target)
        seg, aux = outputs
        crit = orig(criterion, seg, target)
        vae_terms.append((total.detach(), crit.detach(), aux["vae_loss"].detach()))
        return total

    train_state.deep_supervision_loss = loss_with_vae
    dtypes = DtypeTally()
    try:
        vae = run_training(two, work / "runs_segresnetvae", dev, model_args=SEGRESNETVAE_ARGS)
        vae_dtypes = dtypes.take()
    finally:
        dtypes.close()
        train_state.deep_supervision_loss = orig
    if vae["steps"] != 2 or len(vae_terms) != 2:
        raise AssertionError(f"segresnetvae: {vae['steps']} steps, {len(vae_terms)} losses")
    check_step_launches(vae, SEGRESNETVAE_STEP_LAUNCHES, "segresnetvae")
    vae["step_launches"] = vae["forward_launches"][0]
    terms = [(float(t), float(c), float(v)) for t, c, v in vae_terms]
    for total, crit, term in terms:
        if not (math.isfinite(term) and abs(total - (crit + term)) <= 1e-6 * max(1.0, abs(total))):
            raise AssertionError(f"segresnetvae loss {total} != criterion {crit} + VAE {term}")
    torch.cuda.empty_cache()
    for run in (train, vae):
        run.pop("forward_launches")
        run.pop("backward_launches")
    res = dict(train=train, refused_full_volume=refused, served=dict(
                   case_s=served["case_s"], wall_s=served["wall_s"], padded=case["padded"],
                   windows=len(starts), window_batches=batches, launches=case["launches"],
                   peak_bytes=served["peak_bytes"]),
               segresnetvae=dict(train=vae, loss_criterion_vae=terms,
                                 conv_launches_by_dtype=vae_dtypes),
               phase_s=time.time() - t0)
    log(f"phase 20 unet_tr (ViT-B/16): steps {[round(t, 1) for t in train['step_ms']]} ms, "
        f"losses {[round(v, 4) for v in train['step_losses']]}, peak "
        f"{train['peak_bytes'] / 2**30:.2f} GiB; served case {served['case_s'][0]:.3f}s through "
        f"{len(starts)} windows ({batches} batches, {case['launches']['conv3x3x3']} conv "
        f"launches; wall {served['wall_s']:.2f}s, peak {served['peak_bytes'] / 2**30:.2f} GiB); "
        f"segresnetvae steps {[round(t, 1) for t in vae['step_ms']]} ms, loss = criterion + "
        f"VAE {terms}, conv launches by dtype {vae_dtypes}, peak "
        f"{vae['peak_bytes'] / 2**30:.2f} GiB; in {res['phase_s']:.1f}s")
    return res


def check_window_attn(dev) -> dict:
    """B4 against its plain version at a 128³ window's four stage grids
    with their heads, batch 2 (a predictor call), both block kinds: in bf16
    within :data:`WINDOW_ATTN_REL_RMS` of the fp32 composition on the same
    bf16 inputs (the plain bf16 composition's error beside it), in fp32
    within :data:`WINDOW_ATTN_F32_REL_RMS` of the fp32 composition. Each
    launch is timed (bf16 and fp32) beside the plain bf16 composition and
    its bound: the largest of the products at the bf16 peak, the softmax's
    exponentials at :data:`PEAK_EXP`, and q, k, v and the output moved once."""
    import torch
    from brats21_tpu_torch.ops.kernels import window_attn as wa
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    rows, terms = [], dict(exponentials=0.0, operations=0.0, bytes=0.0)

    def rel_rms(got, want):
        return float((got.float() - want).square().mean().sqrt() / want.square().mean().sqrt())

    for grid, heads in SWIN_STAGE_GRIDS:
        qkv = torch.randn((SW_BATCH, *grid, 3, heads, wa.HEAD_DIM), generator=gen, device=dev)
        qkv[..., :2, :, :] *= 2.0          # scores of a few units, as trained attention has
        table = torch.randn(((2 * wa.WINDOW - 1) ** 3, heads), generator=gen, device=dev)
        bf = qkv.to(torch.bfloat16)
        ws, shifted = wa.window_geometry(grid)
        for shift in ((0, 0, 0), shifted):
            exact = wa.window_attn_plain(bf.float(), table, ws, shift)
            got = wa.window_attn(bf, table, ws, shift)
            err = rel_rms(got, exact)
            err_plain = rel_rms(wa.window_attn_plain(bf, table, ws, shift), exact)
            err32 = rel_rms(wa.window_attn(qkv, table, ws, shift),
                            wa.window_attn_plain(qkv, table, ws, shift))
            if not (err <= WINDOW_ATTN_REL_RMS and err32 <= WINDOW_ATTN_F32_REL_RMS):
                raise AssertionError(
                    f"B4 at {grid} x {heads} heads, shift {shift}: relative RMS bf16 {err:.3g} "
                    f"(limit {WINDOW_ATTN_REL_RMS}; the plain bf16 composition {err_plain:.3g}), "
                    f"fp32 {err32:.3g} (limit {WINDOW_ATTN_F32_REL_RMS})")
            n = math.prod(ws)
            pairs = SW_BATCH * heads * math.prod(grid) * n
            secs = dict(exponentials=pairs / PEAK_EXP,
                        operations=4.0 * pairs * wa.HEAD_DIM / PEAK_BF16,
                        bytes=4 * 2.0 * SW_BATCH * math.prod(grid) * heads * wa.HEAD_DIM
                        / PEAK_BYTES)
            for k, v in secs.items():
                terms[k] += v
            row = dict(grid=list(grid), heads=heads, shift=list(shift), rel_rms=err,
                       plain_rel_rms=err_plain, fp32_rel_rms=err32,
                       ms=time_ms(lambda: wa.window_attn(bf, table, ws, shift)),
                       fp32_ms=time_ms(lambda: wa.window_attn(qkv, table, ws, shift)),
                       plain_ms=time_ms(lambda: wa.window_attn_plain(bf, table, ws, shift), 2),
                       bound_ms=1e3 * max(secs.values()),
                       bound_by=max(secs, key=secs.get))
            rows.append(row)
            log(f"window_attn {grid} x {heads} heads, shift {shift}: relative RMS {err:.3g} "
                f"(plain bf16 {err_plain:.3g}, fp32 path {err32:.3g}); kernel {row['ms']:.4f} "
                f"ms, fp32 {row['fp32_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}), plain {row['plain_ms']:.3f} ms")
        del qkv, bf, table, exact, got
        torch.cuda.empty_cache()
    return dict(rows=rows, **{k: sum(r[k] for r in rows)
                              for k in ("ms", "fp32_ms", "plain_ms", "bound_ms")},
                bound_by=max(terms, key=terms.get),
                max_rel_rms=max(r["rel_rms"] for r in rows),
                max_fp32_rel_rms=max(r["fp32_rel_rms"] for r in rows))


def swin_phase(work: Path, train_data: Path, data: Path, dev) -> dict:
    """Phase 27: Swin UNETR (feature size 48, its published sizes) — B4
    against its plain version (:func:`check_window_attn`); 2 train steps at
    128³ through the train CLI (20 B1 launches a step forward, none of B4,
    none backward); the run directory served by the inference CLI through
    windows of 128³ with ``--tta`` and both post-processing flags, its
    launches a case counted from each TTA combo's window plan (20 B1 and 8
    B4 a predictor call of two windows)."""
    import torch
    from brats21_tpu_torch.ops import tta
    from brats21_tpu_torch.ops.sliding_window import window_plan
    t0 = time.time()
    torch.cuda.empty_cache()
    attn = check_window_attn(dev)
    two = cases_dir(work, train_data, "swin_cases", 2)
    train = run_training(two, work / "runs_swin", dev, model_args=SWIN_ARGS)
    if train["steps"] != 2:
        raise AssertionError(f"swin_unetr ran {train['steps']} steps, not 2")
    check_step_launches(train, SWIN_STEP_LAUNCHES, "swin_unetr")
    train["step_launches"] = train["forward_launches"][0]
    run_dir = Path(train["run_dir"])
    out = work / "out_swin"
    served = run_cli(["--config", str(run_dir / "config.yaml"), "--on", "test", "--input",
                      str(data), "--device", "0", "--sliding_window_inference",
                      "--sliding_window_size", *map(str, SW_ROI), "--tta", "--cleaning_areas",
                      "--replace_value", "--output", str(out)], dev)
    case, = served["cases"]
    calls = 0
    for axe, flip, angle in tta.COMBOS:
        shape = tta.aug_flip_rot(tta.aug_axes(torch.empty((1, *case["padded"], 0)), axe),
                                 flip, angle).shape[1:4]
        calls += -(-len(window_plan(shape, SW_ROI)[2]) // SW_BATCH)
    want = {k: calls * v for k, v in SWIN_FORWARD_LAUNCHES.items()}
    if case["launches"] != want or not case["tta"]:
        raise AssertionError(f"swin_unetr served case: launches {case['launches']} != {want} "
                             f"({calls} predictor calls over the 16 combos)")
    check_segmentation(out / "Inference_segmentations_test" / "BraTS2021_00000.nii.gz")
    torch.cuda.empty_cache()
    for key in ("forward_launches", "backward_launches"):
        train.pop(key)
    res = dict(window_attn=attn, train=train, served=dict(
                   case_s=served["case_s"], wall_s=served["wall_s"], padded=case["padded"],
                   predictor_calls=calls, launches=case["launches"],
                   peak_bytes=served["peak_bytes"]),
               phase_s=time.time() - t0)
    log(f"phase 27 swin_unetr: B4 a predictor call {attn['ms']:.3f} ms (fp32 "
        f"{attn['fp32_ms']:.3f}, bound {attn['bound_ms']:.3f}, plain {attn['plain_ms']:.3f}), "
        f"relative RMS at most {attn['max_rel_rms']:.3g} (fp32 {attn['max_fp32_rel_rms']:.3g}); "
        f"train steps {[round(t, 1) for t in train['step_ms']]} ms, losses "
        f"{[round(v, 4) for v in train['step_losses']]}, peak "
        f"{train['peak_bytes'] / 2**30:.2f} GiB, launches a step {train['step_launches']}; "
        f"served case with --tta {served['case_s'][0]:.3f}s, {calls} predictor calls, launches "
        f"{case['launches']}, peak {served['peak_bytes'] / 2**30:.2f} GiB; in "
        f"{res['phase_s']:.1f}s")
    return res


# ---------------------------------------------------------------------------
# phases 21-24: ranks under torch.distributed.run
# ---------------------------------------------------------------------------


def rank_worker(spec_path: str) -> int:
    """One rank of phases 21-24 (``--rank-worker SPEC``): runs the spec's
    CLI (or phase 24's spatial) jobs in turn with the kernels' counters probed,
    and writes this
    rank's results to ``<out>/rank<r>.json`` (and its final parameters of a
    train job to ``params_rank<r>.pt``)."""
    import torch
    from brats21_tpu_torch.learning.engine import Engine
    from brats21_tpu_torch.parallel import multihost
    from brats21_tpu_torch.parallel.mesh import init_topology
    spec = json.loads(Path(spec_path).read_text())
    topo = init_topology("0", space=spec.get("space", 1))
    dev = topo.device
    out = dict(rank=topo.rank, node=topo.node, local_rank=topo.local_rank,
               backend=topo.backend, device=str(dev), card=torch.cuda.get_device_name(dev),
               runs=[])
    saved: list = []
    save = Engine._save_segmentation

    def record(engine, batch, *args):
        saved.append(batch["patient_id"][0])
        return save(engine, batch, *args)

    Engine._save_segmentation = record
    # the evaluation's collectives (parallel/distributed.py), each timed
    # between synchronisations: gloo stages a CUDA tensor through the host
    from brats21_tpu_torch.parallel import distributed
    reduce, reduces = distributed.all_reduce_sum, []

    def timed_reduce(t, group):
        torch.cuda.synchronize()
        t0 = time.time()
        out = reduce(t, group)
        torch.cuda.synchronize()
        reduces.append((t.numel() * t.element_size(), time.time() - t0))
        return out

    distributed.all_reduce_sum = timed_reduce
    for job in spec["jobs"]:
        reduces.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        saved.clear()
        tally = Tally()
        t0 = time.time()
        if job["cli"] == "spatial":
            run = spatial_rank_job(job, topo, Path(spec["out"]))
        elif job["cli"] == "zoo_spatial":
            run = zoo_spatial_rank_job(job, topo)
        elif job["cli"] == "train":
            from brats21_tpu_torch.cli.main_train import main as cli
            probe = StepProbe(tally)
            try:
                result = cli(job["argv"])
                torch.cuda.synchronize()
            finally:
                probe.close()
            torch.save({k: v.detach().cpu() for k, v in probe.state.model.state_dict().items()},
                       Path(spec["out"]) / f"params_{job['name']}_rank{topo.rank}.pt")
            run = dict(result=result, step_ms=probe.step_ms(),
                       step_losses=[float(v) for v in probe.losses],
                       forward_launches=probe.forward, backward_launches=probe.backward,
                       run_launches=probe.total_launches())
        else:
            if job["cli"] == "folds":
                from brats21_tpu_torch.cli.main_train_folds import main as cli
            else:
                from brats21_tpu_torch.cli.main_inference import main as cli
            cases = CaseProbe(tally)
            try:
                result = cli(job["argv"])
                torch.cuda.synchronize()
            finally:
                cases.close()
            tally.take()
            run = dict(cases=cases.cases, run_launches=dict(tally.total),
                       case_s=list(result["batch_time"].history)
                       if job["cli"] == "infer" else None)
        run.update(name=job["name"], wall_s=time.time() - t0, saved=list(saved),
                   peak_bytes=torch.cuda.max_memory_allocated(dev),
                   all_reduce=dict(calls=len(reduces), bytes=sum(b for b, _ in reduces),
                                   seconds=sum(t for _, t in reduces)))
        out["runs"].append(run)
    Path(spec["out"], f"rank{topo.rank}.json").write_text(json.dumps(out))
    multihost.shutdown()
    return 0


def launch_ranks(work: Path, name: str, jobs: list, nproc: int = 2, nnodes: int = 1,
                 timeout: float = 600, space: int = 1) -> list:
    """``jobs`` on ``nnodes`` × ``nproc`` ranks of this card (one
    ``torch.distributed.run`` a node, all started together; ``space`` ranks
    a space row); each rank's results by global rank. Fails when a rank
    fails or outlives ``timeout``; every process started is stopped."""
    import torch
    from brats21_tpu_torch.parallel import multihost
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = work / name
    out.mkdir()
    spec = out / "spec.json"
    spec.write_text(json.dumps(dict(out=str(out), jobs=jobs, space=space)))
    repo = Path(__file__).resolve().parent
    t0 = time.time()
    outs = multihost.run_ranks([str(Path(__file__).resolve()), "--rank-worker", str(spec)],
                               nproc, nnodes, timeout=timeout, cwd=str(repo),
                               env={"OMP_NUM_THREADS": "2"})
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(nproc * nnodes)]
    for r in ranks:
        if r["backend"] != "gloo" or r["card"] != torch.cuda.get_device_name(0):
            raise AssertionError(f"{name}: rank {r['rank']} on {r['card']} with backend "
                                 f"{r['backend']}, want gloo on this card")
    log(f"{name}: {nnodes} node(s) × {nproc} rank(s) sharing one card, backend "
        f"{ranks[0]['backend']}, in {time.time() - t0:.1f}s; "
        f"rank lines: {[ln for o in outs for ln in o.splitlines() if '), backend ' in ln][:4]}")
    return ranks


def spatial_rank_job(job: dict, topo, out: Path) -> dict:
    """One rank of phase 24's space row: (a) the served case's bf16 main
    head Z-sharded over the row, after one untimed forward, with the
    kernels' counters zeroed just before and read just after, its seconds
    and peak memory; (b) every head in fp32; (c) ``Engine.evaluate`` on the
    val case with its target, in fp32. Rank 0 saves the heads and labels; each rank
    returns its checksums of them."""
    import numpy as np
    import torch
    from brats21_tpu_torch.config import TrainConfig
    from brats21_tpu_torch.data.pipeline import make_train_val_loaders
    from brats21_tpu_torch.learning.engine import Engine
    from brats21_tpu_torch.learning.losses import make_criterion
    from brats21_tpu_torch.models import get_model
    from brats21_tpu_torch.ops.kernels import conv3d, evonorm
    from brats21_tpu_torch.parallel.distributed import spatial_sharded_forward
    from brats21_tpu_torch.utils.weights import load_reference_pth
    dev = topo.device
    model = get_model({"model": "equiunet_assp_evo", "width": WIDTH})
    model.load_state_dict(load_reference_pth(job["weights"]))
    model = model.to(dev).eval()
    x = torch.from_numpy(np.load(job["case"])).to(dev)[None]
    with torch.inference_mode():
        spatial_sharded_forward(model, x, topo)                      # untimed first use
        torch.cuda.synchronize()
        spatial_counts(conv3d, evonorm, reset=True)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        logits = spatial_sharded_forward(model, x, topo)
        torch.cuda.synchronize()
        res = dict(forward_s=time.time() - t0,
                   forward_peak_bytes=torch.cuda.max_memory_allocated(dev),
                   launches=spatial_counts(conv3d, evonorm))
        labels = served_labels(logits, x)
        heads32 = spatial_sharded_forward(model, x.float(), topo, full_outputs=True,
                                          no_amp=True)
        heads32 = [heads32[0], *heads32[1]]
        torch.cuda.synchronize()
    res["checksums"] = [float(t.double().abs().sum()) for t in [logits, labels, *heads32]]
    if topo.space_rank == 0:
        torch.save(dict(logits=logits.cpu(), labels=labels.cpu(),
                        heads32=[h.cpu() for h in heads32]), out / "spatial_heads.pt")
    del logits, labels, heads32
    cfg = TrainConfig.from_yaml(job["val_config"])
    cfg.additional_metrics, cfg.no_amp = [], True
    val_model = get_model(cfg)
    val_model.load_state_dict(load_reference_pth(job["val_weights"]))
    val_model = val_model.to(dev).eval()
    engine = Engine(cfg, dev, criterion=make_criterion(cfg), topo=topo)
    torch.cuda.synchronize()
    t0 = time.time()
    meters = engine.evaluate([val_model], make_train_val_loaders(cfg, dev)[1], 0)
    torch.cuda.synchronize()
    res.update(val_s=time.time() - t0, val_loss=float(meters["loss"].avg),
               val_count=int(meters["loss"].count),
               val_dice=np.asarray(meters["dice"].avg, dtype=np.float64).tolist())
    return res


def served_labels(logits, img):
    """The served label map of a case's main-head logits: the fp32
    sigmoid, thresholded, zeroed outside the brain (the engine's fusion of
    one member), as BraTS labels 0/1/2/4 ``[X, Y, Z]`` uint8 on the host."""
    import torch
    from brats21_tpu_torch.data import transforms as T
    from brats21_tpu_torch.ops.postprocess import post_process
    fused = post_process(torch.sigmoid(logits.float()))
    fused = fused * (img != 0).any(dim=-1, keepdim=True).to(fused.dtype)
    return torch.from_numpy(T.change_label_3_to_4(T.multichannel_to_brats_labels(
        fused[0].cpu().numpy())).astype("uint8"))


def spatial_counts(conv3d, evonorm, reset: bool = False) -> dict:
    """The spatial path's launch counters (B1, B2's one call, its split
    statistics and apply, the glue's two entry points, B4), zeroed after
    the read with ``reset``."""
    from brats21_tpu_torch.ops.kernels import glue
    from brats21_tpu_torch.ops.kernels import window_attn as wa
    counts = dict(conv3x3x3=conv3d.launches, evonorm_s0=evonorm.launches,
                  evonorm_s0_stats=evonorm.stats_launches,
                  evonorm_s0_apply=evonorm.apply_launches,
                  se_gate_pool=glue.se_gate_pool_launches,
                  upsample_cat=glue.upsample_cat_launches, window_attn=wa.launches)
    if reset:
        conv3d.launches = evonorm.launches = evonorm.stats_launches = 0
        evonorm.apply_launches = wa.launches = 0
        glue.se_gate_pool_launches = glue.upsample_cat_launches = 0
    return counts


def spatial_phase(work: Path, case_img, val_run: Path, dev) -> dict:
    """Phase 24: the served case (w48, bf16, seeded weights of phase 4, the
    padded 200×200×136 case) Z-sharded over a space row of two ranks of the
    card (``spatial_sharded_forward``, 72 + 64 planes), each rank's slab
    through B1 and B2's split entry points, against the same weights in one
    process: (a) bf16 labels and probabilities, beside one process's own
    bf16 floor (the case as a batch of two) and the fp32 labels, (b) every
    head in fp32,
    (c) ``Engine.evaluate`` on phase 12's val case with its target in fp32
    (loss and Dice), (d) each rank's launches a forward, peak memory and seconds
    beside one process's."""
    import numpy as np
    import torch
    from brats21_tpu_torch.config import TrainConfig
    from brats21_tpu_torch.data.pipeline import make_train_val_loaders
    from brats21_tpu_torch.learning.engine import Engine, forward_channels_last
    from brats21_tpu_torch.learning.losses import make_criterion
    from brats21_tpu_torch.models import get_model
    from brats21_tpu_torch.ops.kernels import conv3d, evonorm
    from brats21_tpu_torch.ops.tta import main_head
    from brats21_tpu_torch.utils.weights import load_reference_pth
    t_phase = time.time()
    case = work / "spatial_case.npy"
    np.save(case, case_img.astype(np.float16))
    model = get_model({"model": "equiunet_assp_evo", "width": WIDTH})
    model.load_state_dict(load_reference_pth(str(work / "best_model.pth")))
    model = model.to(dev).eval()
    x = torch.from_numpy(np.load(case)).to(dev)[None]
    with torch.inference_mode():
        forward_channels_last(model, x.to(torch.bfloat16))          # untimed first use
        torch.cuda.synchronize()
        spatial_counts(conv3d, evonorm, reset=True)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        one_logits = main_head(forward_channels_last(model, x.to(torch.bfloat16)))
        torch.cuda.synchronize()
        one = dict(forward_s=time.time() - t0, peak_bytes=torch.cuda.max_memory_allocated(dev),
                   launches=spatial_counts(conv3d, evonorm, reset=True))
        one_probs = torch.sigmoid(one_logits.float())
        one_labels = served_labels(one_logits, x)
        # the floor: the same case as a batch of two in one process
        two_logits = main_head(forward_channels_last(
            model, x.repeat(2, 1, 1, 1, 1).to(torch.bfloat16)))
        two_labels = served_labels(two_logits[:1], x)
        two_probs = torch.sigmoid(two_logits[:1].float())
        del two_logits
        out32 = forward_channels_last(model, x.float(), with_deep=True)
        one_heads32 = [out32[0], *out32[1]]
        f32_labels = served_labels(out32[0], x)
    cfg = TrainConfig.from_yaml(str(val_run / "config.yaml"))
    cfg.additional_metrics, cfg.no_amp = [], True
    val_model = get_model(cfg)
    val_model.load_state_dict(load_reference_pth(str(val_run / "best_model.pth")))
    val_model = val_model.to(dev).eval()
    t0 = time.time()
    meters = Engine(cfg, dev, criterion=make_criterion(cfg)).evaluate(
        [val_model], make_train_val_loaders(cfg, dev)[1], 0)
    torch.cuda.synchronize()
    one.update(val_s=time.time() - t0, val_loss=float(meters["loss"].avg),
               val_dice=np.asarray(meters["dice"].avg, dtype=np.float64).tolist())
    del model, val_model, x, out32
    job = dict(cli="spatial", name="spatial", case=str(case),
               weights=str(work / "best_model.pth"), val_config=str(val_run / "config.yaml"),
               val_weights=str(val_run / "best_model.pth"))
    ranks = launch_ranks(work, "spatial", [job], space=SPATIAL_SPACE)
    runs = [r["runs"][0] for r in ranks]
    got = torch.load(work / "spatial" / "spatial_heads.pt")
    probs = torch.sigmoid(got["logits"].float())
    share = float((got["labels"] == one_labels).float().mean())
    floor = float((two_labels == one_labels).float().mean())
    share_f32 = float((got["labels"] == f32_labels).float().mean())
    one_f32 = float((one_labels == f32_labels).float().mean())
    near = float(((torch.sigmoid(one_heads32[0].float()) - 0.5).abs() < 0.005).float().mean())
    prob_diff = (probs - one_probs.cpu()).abs()
    floor_diff = (two_probs - one_probs).abs()
    heads_diff = [float((g - w.cpu()).abs().max()) for g, w in zip(got["heads32"], one_heads32)]
    loss_rel = [abs(r["val_loss"] - one["val_loss"]) / abs(one["val_loss"]) for r in runs]
    dice_diff = [max(abs(a - b) for a, b in zip(r["val_dice"], one["val_dice"])) for r in runs]
    res = dict(space=SPATIAL_SPACE, padded_case=list(case_img.shape[:3]),
               label_share=share, label_share_floor_batch_of_two=floor,
               label_share_margin=SPATIAL_LABEL_MARGIN, label_share_target=SPATIAL_LABEL_TARGET,
               label_share_vs_fp32=share_f32, one_process_label_share_vs_fp32=one_f32,
               fp32_label_margin=SPATIAL_FP32_LABEL_MARGIN, fp32_probs_within_0005_of_half=near,
               bf16_prob_max_abs_diff=float(prob_diff.max()),
               bf16_prob_mean_abs_diff=float(prob_diff.mean()),
               floor_prob_max_abs_diff=float(floor_diff.max()),
               floor_prob_mean_abs_diff=float(floor_diff.mean()),
               fp32_heads_max_abs_diff=heads_diff, fp32_atol=SPATIAL_FP32_ATOL,
               val_loss_rel=loss_rel, val_loss_rtol=SPATIAL_LOSS_RTOL,
               val_dice_max_abs_diff=dice_diff, one_process=one,
               launches_per_rank=[r["launches"] for r in runs],
               forward_s_per_rank=[r["forward_s"] for r in runs],
               peak_gib_per_rank=[r["forward_peak_bytes"] / 2**30 for r in runs],
               peak_gib_one=one["peak_bytes"] / 2**30,
               val_s_per_rank=[r["val_s"] for r in runs],
               val_loss_per_rank=[r["val_loss"] for r in runs],
               val_count_per_rank=[r["val_count"] for r in runs])
    del got, probs, prob_diff, floor_diff
    torch.cuda.empty_cache()
    if runs[0]["checksums"] != runs[1]["checksums"]:
        raise AssertionError(f"phase 24: the ranks' heads differ: {runs[0]['checksums']} vs "
                             f"{runs[1]['checksums']}")
    for r, run in enumerate(runs):
        if run["launches"] != SPATIAL_FORWARD_LAUNCHES:
            raise AssertionError(f"phase 24 rank {r}: launches a forward {run['launches']}, "
                                 f"want {SPATIAL_FORWARD_LAUNCHES}")
    if one["launches"]["conv3x3x3"] != 14 or one["launches"]["evonorm_s0"] != 21 or any(
            one["launches"][k] != v for k, v in GLUE_FORWARD.items()):
        raise AssertionError(f"phase 24 one process: launches {one['launches']}")
    if share < floor - SPATIAL_LABEL_MARGIN or share_f32 < one_f32 - SPATIAL_FP32_LABEL_MARGIN:
        raise AssertionError(
            f"phase 24 bf16: labels agree with one process on {share:.6f} of voxels (one "
            f"process's batch of two: {floor:.6f}, margin {SPATIAL_LABEL_MARGIN}), with the "
            f"fp32 labels on {share_f32:.6f} (one process {one_f32:.6f}, margin "
            f"{SPATIAL_FP32_LABEL_MARGIN})")
    if not all(math.isfinite(d) and d <= SPATIAL_FP32_ATOL for d in heads_diff):
        raise AssertionError(f"phase 24 fp32: heads differ from one process's by {heads_diff} "
                             f"(limit {SPATIAL_FP32_ATOL})")
    if not all(lr <= SPATIAL_LOSS_RTOL for lr in loss_rel) or \
            any(r["val_count"] != 1 for r in runs):
        raise AssertionError(f"phase 24 val: loss relative {loss_rel} (limit "
                             f"{SPATIAL_LOSS_RTOL}), counts {[r['val_count'] for r in runs]}")
    log(f"phase 24 Z-sharded over {SPATIAL_SPACE} ranks: bf16 labels equal to one process's on "
        f"{share:.6f} of voxels (a fixed {SPATIAL_LABEL_TARGET} would not hold; one process's "
        f"batch of two {floor:.6f}, margin {SPATIAL_LABEL_MARGIN}; {near:.4f} of fp32 "
        f"probabilities within 0.005 of 0.5), to the fp32 labels {share_f32:.6f} (one process "
        f"{one_f32:.6f}, margin {SPATIAL_FP32_LABEL_MARGIN}); probabilities max |diff| "
        f"{res['bf16_prob_max_abs_diff']:.3g} (mean {res['bf16_prob_mean_abs_diff']:.3g}; the "
        f"batch of two's {res['floor_prob_max_abs_diff']:.3g} / "
        f"{res['floor_prob_mean_abs_diff']:.3g}); "
        f"fp32 heads max |diff| {[f'{d:.3g}' for d in heads_diff]} (limit "
        f"{SPATIAL_FP32_ATOL}); val loss relative {[f'{v:.3g}' for v in loss_rel]} (limit "
        f"{SPATIAL_LOSS_RTOL}), Dice max |diff| {[f'{v:.3g}' for v in dice_diff]}; launches "
        f"a forward per rank {res['launches_per_rank']}; forward s per rank "
        f"{[round(v, 3) for v in res['forward_s_per_rank']]} vs one process "
        f"{one['forward_s']:.3f}; peak GiB per rank "
        f"{[round(v, 2) for v in res['peak_gib_per_rank']]} vs {res['peak_gib_one']:.2f}; "
        f"val case s per rank {[round(v, 2) for v in res['val_s_per_rank']]} vs "
        f"{one['val_s']:.2f}; in {time.time() - t_phase:.1f}s")
    return res


def zoo_spatial_inputs(case_img) -> dict:
    """Phase 26's inputs ``[X, Y, Z, 4]`` fp32: phase 4's padded case, and
    its central 96³ for the MONAI-backed names."""
    c = ZOO_SPATIAL_CROP
    starts = [(s - c) // 2 for s in case_img.shape[:3]]
    crop = case_img[starts[0]:starts[0] + c, starts[1]:starts[1] + c, starts[2]:starts[2] + c]
    return dict(case=case_img.astype("float32"), crop=crop.astype("float32"))


def zoo_spatial_model(name: str, norm: str, act: str, dev, weights=None):
    """``name`` at the published width with phase 26's seeded weights, or
    with ``weights`` (a state dict file; the model is then built without
    an init, on the meta device), in eval mode on ``dev``."""
    import torch
    from brats21_tpu_torch.models import get_model
    cfg = {"model": name, "width": WIDTH, "norm": norm, "act": act,
           "patch_size": [ZOO_SPATIAL_CROP] * 3}
    if weights is None:                      # initialised on the card, seeded
        torch.manual_seed(SEED + 26 + [z[0] for z in ZOO_SPATIAL].index(name))
        with torch.device(dev):
            return get_model(cfg).eval()
    with torch.device("meta"):
        model = get_model(cfg)
    model.load_state_dict(torch.load(weights, map_location=dev, weights_only=True),
                          strict=True, assign=True)
    return model.eval()


@contextlib.contextmanager
def halos_left_zero():
    """A planted fault for phase 26's upper readings: the Z-sharded path
    with every halo left zero (``spatial.exchange_planes`` pads a slab with
    zero planes instead of its neighbours'), as if each slab were a volume
    of its own; the merged statistics and gathers stay."""
    import torch.nn.functional as F
    from brats21_tpu_torch.parallel import spatial
    real = spatial.exchange_planes

    def zeros(x, lo, hi, group, dim, sizes):
        return F.pad(x, [0, 0] * (x.dim() - 1 - dim) + [lo, hi])

    spatial.exchange_planes = zeros
    try:
        yield
    finally:
        spatial.exchange_planes = real


def zoo_spatial_rank_job(job: dict, topo) -> dict:
    """One rank of phase 26's space row: each name Z-sharded over the row
    (``spatial_sharded_forward``) on its input, against one process's
    results saved by the phase (``job["names"][i]["ref"]``): (a) the bf16
    main head after one untimed forward, the kernels' counters zeroed just
    before it and read just after, its seconds and peak memory; its served
    labels' agreement with one process's bf16 labels, and with the fp32
    labels; (b) every head in fp32 (TF32 off, as the phase's one process
    runs), each head's max |diff| from one process's, and SegResNetVAE's
    VAE term; (c) the bf16 labels' agreement and the fp32 main head's max
    |diff| again with every halo left zero (:func:`halos_left_zero`)."""
    import numpy as np
    import torch
    from brats21_tpu_torch.ops.kernels import conv3d, evonorm
    from brats21_tpu_torch.parallel.distributed import spatial_sharded_forward
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = topo.device
    res = {}
    for case in job["names"]:
        name = case["name"]
        t_name = time.time()
        model = zoo_spatial_model(name, case["norm"], case["act"], dev, case["weights"])
        x = torch.from_numpy(np.load(case["x"])).to(dev)[None]
        ref = torch.load(case["ref"], weights_only=True)
        with torch.inference_mode():
            spatial_sharded_forward(model, x, topo)                  # untimed first use
            torch.cuda.synchronize()
            spatial_counts(conv3d, evonorm, reset=True)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.time()
            logits = spatial_sharded_forward(model, x, topo)
            torch.cuda.synchronize()
            out = dict(forward_s=time.time() - t0,
                       peak_bytes=torch.cuda.max_memory_allocated(dev),
                       launches=spatial_counts(conv3d, evonorm))
            labels = served_labels(logits, x)
            del logits
            full = spatial_sharded_forward(model, x.float(), topo, full_outputs=True,
                                           no_amp=True)
            with halos_left_zero():
                fault_labels = served_labels(spatial_sharded_forward(model, x, topo), x)
                fault_main = spatial_sharded_forward(model, x.float(), topo, no_amp=True)
            torch.cuda.synchronize()
        heads = output_heads(full)
        vae = [float(h) for h in heads if h.dim() == 0]
        heads = [h for h in heads if h.dim() > 0]
        out.update(
            fault_label_share=float((fault_labels == ref["labels"]).float().mean()),
            fault_label_share_vs_fp32=float((fault_labels == ref["labels32"]).float().mean()),
            fault_main_max_abs_diff=float((fault_main.cpu() - ref["heads32"][0]).abs().max()))
        del fault_labels, fault_main
        out.update(
            label_share=float((labels == ref["labels"]).float().mean()),
            label_share_vs_fp32=float((labels == ref["labels32"]).float().mean()),
            heads_max_abs_diff=[float((h.cpu() - w).abs().max()) for h, w in
                                zip(heads, ref["heads32"])],
            heads_finite=all(bool(torch.isfinite(h).all()) for h in heads),
            n_heads=len(heads), vae_loss=vae,
            checksum=float(heads[0].double().abs().sum()), name_s=time.time() - t_name)
        res[name] = out
        del model, x, full, heads, ref
        torch.cuda.empty_cache()
    return res


def zoo_spatial_phase(work: Path, case_img, floor_phase24: float, dev) -> dict:
    """Phase 26: every --model name phase 24 does not run, Z-sharded over a
    space row of two ranks of the card in one ``torch.distributed.run``
    launch (each name at its own slab alignment: 8, 16 with a RefUnet, whose
    last slab then holds a partial block, 32 for nnunet, 1 for highresnet),
    against one process on the same seeded weights and input: (a) bf16
    served labels flipping from one process's at most
    ZOO_SPATIAL_LABEL_FLIPS times the share of voxels that the lower of two
    floors measured this run flips (one process's batch of two against its
    batch of one, and phase 24's; a model without merged statistics may
    read 1 there), plus SPATIAL_LABEL_MARGIN; and as close to the fp32
    labels as one process's bf16 labels are, less
    SPATIAL_FP32_LABEL_MARGIN or three standard deviations of the share of
    voxels one more bf16 rounding flips, if wider; (b) fp32 heads, the main
    head within SPATIAL_FP32_ATOL at unit scale or ZOO_SPATIAL_FP32_FLOOR
    times one rounding's move, segresnetvae's VAE term within
    ZOO_SPATIAL_VAE_RTOL relative; (c) each rank's B1 launches a forward
    (and B2's split for equiunet_assp_evo_ref) equal to one process's
    count, none of B2's one-call path on a slab; (d) each rank's peak
    memory and seconds a forward beside one process's; (e) the limits'
    upper side: with every halo left zero (:func:`halos_left_zero`) each
    name's labels must fall below (a)'s share limit and its main head
    beyond (b)'s."""
    import numpy as np
    import torch
    from brats21_tpu_torch.learning.engine import forward_channels_last
    from brats21_tpu_torch.ops.kernels import conv3d, evonorm
    from brats21_tpu_torch.ops.tta import main_head
    t_phase = time.time()
    folder = work / "zoo_spatial_inputs"
    folder.mkdir()
    inputs = {}
    for key, arr in zoo_spatial_inputs(case_img).items():
        inputs[key] = folder / f"{key}.npy"
        np.save(inputs[key], arr)
    one, jobs = {}, []
    for name, norm, act, which in ZOO_SPATIAL:
        t_name = time.time()
        model = zoo_spatial_model(name, norm, act, dev)
        weights = folder / f"{name}.pt"
        torch.save(model.state_dict(), weights)
        x = torch.from_numpy(np.load(inputs[which])).to(dev)[None]
        with torch.inference_mode():
            forward_channels_last(model, x.to(torch.bfloat16))       # untimed first use
            torch.cuda.synchronize()
            spatial_counts(conv3d, evonorm, reset=True)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.time()
            logits = main_head(forward_channels_last(model, x.to(torch.bfloat16)))
            torch.cuda.synchronize()
            res = dict(forward_s=time.time() - t0,
                       peak_bytes=torch.cuda.max_memory_allocated(dev),
                       launches=spatial_counts(conv3d, evonorm, reset=True))
            labels = served_labels(logits, x)
            del logits
            two = main_head(forward_channels_last(
                model, x.repeat(2, 1, 1, 1, 1).to(torch.bfloat16)))
            labels_two = served_labels(two[:1], x)
            del two
            full = forward_channels_last(model, x.float(), with_deep=True)
            heads = output_heads(full)
            labels32 = served_labels(heads[0], x)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            nudged = x.float() * (1.0 + 2.0 ** -23 * torch.randn(x.shape, generator=gen,
                                                                   device=dev))
            fp32_floor = float((main_head(forward_channels_last(model, nudged))
                                - heads[0]).abs().max())
            del nudged
        vae = [float(h) for h in heads if h.dim() == 0]
        heads = [h.cpu() for h in heads if h.dim() > 0]
        ref = folder / f"{name}_ref.pt"
        torch.save(dict(heads32=heads, labels=labels, labels32=labels32), ref)
        res.update(floor=float((labels_two == labels).float().mean()), voxels=labels.numel(),
                   one_vs_fp32=float((labels == labels32).float().mean()),
                   vae_loss=vae, main_scale=max(float(heads[0].abs().max()), 1.0),
                   fp32_floor=fp32_floor, one_process_phase_s=time.time() - t_name,
                   input=list(x.shape[1:4]))
        one[name] = res
        jobs.append(dict(name=name, norm=norm, act=act, weights=str(weights),
                         x=str(inputs[which]), ref=str(ref)))
        del model, x, full, heads, labels, labels_two, labels32
        torch.cuda.empty_cache()
    t_one = time.time() - t_phase
    ranks = launch_ranks(work, "zoo_spatial", [dict(cli="zoo_spatial", name="zoo_spatial",
                                                    names=jobs)], space=SPATIAL_SPACE,
                         timeout=900)
    runs = [r["runs"][0] for r in ranks]
    res = dict(space=SPATIAL_SPACE, one_process_s=t_one, names={})
    failures = []
    for name, _, _, _ in ZOO_SPATIAL:
        mine = [run[name] for run in runs]
        ref = one[name]
        # ZOO_SPATIAL_LABEL_FLIPS times the flips of the lower of two floors
        # measured this run: this name's batch of two and phase 24's
        floor = min(ref["floor"], floor_phase24)
        limit = 1.0 - ZOO_SPATIAL_LABEL_FLIPS * (1.0 - floor) - SPATIAL_LABEL_MARGIN
        # phase 24's margin to the fp32 labels, or three standard deviations
        # of the count of voxels that one more bf16 rounding flips, if wider
        margin32 = max(SPATIAL_FP32_LABEL_MARGIN,
                       3.0 * math.sqrt((1.0 - ref["one_vs_fp32"]) / ref["voxels"]))
        main_limit = max(SPATIAL_FP32_ATOL * ref["main_scale"],
                         ZOO_SPATIAL_FP32_FLOOR * ref["fp32_floor"])
        want = dict(ref["launches"], evonorm_s0_stats=ref["launches"]["evonorm_s0"],
                    evonorm_s0_apply=ref["launches"]["evonorm_s0"], evonorm_s0=0, **NO_GLUE)
        row = dict(input=ref["input"], label_share=[m["label_share"] for m in mine],
                   label_floor_batch_of_two=ref["floor"], label_limit=limit,
                   label_share_vs_fp32=[m["label_share_vs_fp32"] for m in mine],
                   one_process_vs_fp32=ref["one_vs_fp32"], fp32_label_margin=margin32,
                   fp32_heads_max_abs_diff=[m["heads_max_abs_diff"] for m in mine],
                   fp32_main_limit=main_limit, fp32_floor_one_rounding=ref["fp32_floor"],
                   halos_zero_label_share=[m["fault_label_share"] for m in mine],
                   halos_zero_label_share_vs_fp32=[m["fault_label_share_vs_fp32"]
                                                   for m in mine],
                   halos_zero_main_max_abs_diff=[m["fault_main_max_abs_diff"] for m in mine],
                   vae_loss=[m["vae_loss"] for m in mine], vae_loss_one=ref["vae_loss"],
                   launches_per_rank=[m["launches"] for m in mine],
                   one_process_launches=ref["launches"],
                   forward_s_per_rank=[m["forward_s"] for m in mine],
                   forward_s_one=ref["forward_s"],
                   peak_gib_per_rank=[m["peak_bytes"] / 2**30 for m in mine],
                   peak_gib_one=ref["peak_bytes"] / 2**30)
        res["names"][name] = row
        glue_want = GLUE_FORWARD if name in ZOO_SPATIAL_EVONORMS else NO_GLUE
        if ref["launches"]["conv3x3x3"] != ZOO_SPATIAL_LAUNCHES[name] or \
                ref["launches"]["evonorm_s0"] != ZOO_SPATIAL_EVONORMS.get(name, 0) or any(
                    ref["launches"][k] != v for k, v in glue_want.items()):
            failures.append(f"phase 26 {name}: one process launched {ref['launches']}, "
                            f"want {ZOO_SPATIAL_LAUNCHES[name]} B1, "
                            f"{ZOO_SPATIAL_EVONORMS.get(name, 0)} B2 and glue {glue_want}")
        if mine[0]["checksum"] != mine[1]["checksum"] or not all(
                m["heads_finite"] and m["n_heads"] == len(mine[0]["heads_max_abs_diff"])
                for m in mine):
            failures.append(f"phase 26 {name}: the ranks' heads differ or are not "
                            f"finite: {[m['checksum'] for m in mine]}")
        for r, m in enumerate(mine):
            if m["launches"] != want:
                failures.append(f"phase 26 {name} rank {r}: launches a forward "
                                f"{m['launches']}, want {want} (one process "
                                f"{ref['launches']})")
            if m["label_share"] < limit or \
                    m["label_share_vs_fp32"] < ref["one_vs_fp32"] - margin32:
                failures.append(
                                f"phase 26 {name} rank {r} bf16: labels agree with one process's on "
                                f"{m['label_share']:.6f} of voxels (limit {limit:.6f}: one process's "
                                f"batch of two {ref['floor']:.6f}, phase 24's {floor_phase24:.6f}), with "
                                f"the fp32 labels on {m['label_share_vs_fp32']:.6f} (one process "
                                f"{ref['one_vs_fp32']:.6f}, margin {margin32:.3g})")
            if not m["heads_max_abs_diff"][0] <= main_limit:
                failures.append(f"phase 26 {name} rank {r} fp32: main head max |diff| "
                                f"{m['heads_max_abs_diff'][0]:.3g} (limit "
                                f"{main_limit:.3g})")
            if not (m["fault_label_share"] < limit and m["fault_main_max_abs_diff"] > main_limit):
                failures.append(f"phase 26 {name} rank {r}: with every halo left zero the "
                                f"labels agree on {m['fault_label_share']:.6f} (limit "
                                f"{limit:.6f}) and the fp32 main head reads "
                                f"{m['fault_main_max_abs_diff']:.3g} (limit {main_limit:.3g}): "
                                f"the limits cannot see a lost halo")
            for got, w in zip(m["vae_loss"], ref["vae_loss"]):
                if not abs(got - w) <= ZOO_SPATIAL_VAE_RTOL * abs(w):
                    failures.append(f"phase 26 {name} rank {r}: vae_loss {got} vs one "
                                    f"process {w}")
            if len(m["vae_loss"]) != len(ref["vae_loss"]):
                failures.append(f"phase 26 {name} rank {r}: VAE terms {m['vae_loss']} "
                                f"vs {ref['vae_loss']}")
        vae = (f"; vae_loss per rank {row['vae_loss']} vs one process {ref['vae_loss']}"
               if ref["vae_loss"] else "")
        log(f"phase 26 {name} {ref['input']}: bf16 labels equal to one process's on "
            f"{[round(v, 6) for v in row['label_share']]} of voxels (limit {limit:.6f}; "
            f"batch of two {ref['floor']:.6f}), to the fp32 labels "
            f"{[round(v, 6) for v in row['label_share_vs_fp32']]} (one process "
            f"{ref['one_vs_fp32']:.6f}, margin {margin32:.3g}); fp32 heads max |diff| rank 0 "
            f"{[f'{d:.3g}' for d in mine[0]['heads_max_abs_diff']]} (main limit "
            f"{main_limit:.3g}: one process's rounding floor {ref['fp32_floor']:.3g}){vae}; "
            f"every halo left zero: labels {[round(v, 6) for v in row['halos_zero_label_share']]}"
            f", to the fp32 labels "
            f"{[round(v, 6) for v in row['halos_zero_label_share_vs_fp32']]}, fp32 main "
            f"|diff| {[f'{v:.3g}' for v in row['halos_zero_main_max_abs_diff']]}; "
            f"launches a forward per rank {row['launches_per_rank']} (one process "
            f"{ref['launches']}); forward s per rank "
            f"{[round(v, 3) for v in row['forward_s_per_rank']]} vs {ref['forward_s']:.3f}; "
            f"peak GiB per rank {[round(v, 2) for v in row['peak_gib_per_rank']]} vs "
            f"{row['peak_gib_one']:.2f}")
    res["wall_s"] = time.time() - t_phase
    log(f"phase 26: {len(ZOO_SPATIAL)} names Z-sharded over {SPATIAL_SPACE} ranks in one "
        f"launch; one process's side {t_one:.1f}s "
        f"({ {n: round(v['one_process_phase_s'], 1) for n, v in one.items()} }), the ranks' "
        f"{sum(runs[0][n]['name_s'] for n in one):.1f}s (each name's on rank 0: "
        f"{ {n: round(runs[0][n]['name_s'], 1) for n in one} }); phase wall "
        f"{res['wall_s']:.1f}s")
    shutil.rmtree(folder, ignore_errors=True)
    if failures:
        raise AssertionError("phase 26: " + "; ".join(failures))
    return res


def label_share(a: Path, b: Path) -> float:
    """The share of voxels where two label maps agree."""
    from brats21_tpu_torch.data.nifti import read_nifti
    x, y = read_nifti(str(a)).data, read_nifti(str(b)).data
    if x.shape != y.shape:
        raise AssertionError(f"{a} {x.shape} vs {b} {y.shape}")
    return float((x == y).mean())


def batch_split_noise(dev) -> dict:
    """How far the dice_hd loss and its gradient for one batch of two 128³
    samples move when the batch is computed as two batches of one (what 2
    ranks do) instead of one batch of two, without any collective: the
    flagship w48 at its seeded initial weights, bf16 and fp32. In bf16 each
    weight's gradient is taken against its bf16 copy (the JAX package's
    casts), so it is rounded to bf16 once a batch: two batches of one round
    twice. The floor under phase 21's comparison of the two runs."""
    import torch
    from brats21_tpu_torch.learning.losses import deep_supervision_loss, make_criterion
    from brats21_tpu_torch.models import get_model
    torch.manual_seed(123)
    model = get_model({"model": "equiunet_assp_evo", "width": WIDTH}).to(dev).train()
    criterion = make_criterion({"criterion": "dice_hd"})
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn((2, 4, *PATCH), generator=gen).to(dev)
    seg = (torch.rand((2, 3, *PATCH), generator=gen) > 0.7).float().to(dev)
    out = {}
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        xc = x.to(dtype).contiguous(memory_format=torch.channels_last_3d)

        def loss(a, b):
            return deep_supervision_loss(criterion, model(xc[a:b]), seg[a:b])

        def grads():
            g = torch.cat([p.grad.reshape(-1) for p in model.parameters()
                           if p.grad is not None])
            model.zero_grad(set_to_none=True)
            return g

        whole = loss(0, 2)
        whole.backward()
        g_whole = grads()
        halves = [loss(0, 1), loss(1, 2)]
        for h in halves:
            (h / 2).backward()
        g_split = grads()
        whole, split = whole.item(), (halves[0].item() + halves[1].item()) / 2
        out[name] = dict(loss_relative=abs(whole - split) / abs(whole),
                         grad_relative=float((g_whole - g_split).norm() / g_whole.norm()))
    del model
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def one_gradient_left_out():
    """The fault phase 21's limits must catch, in one process: the train
    CLI's model detaches its outputs for every sample but the first, so a
    batch of two steps on the first sample's gradient alone, halved, as
    DDP's average is when one rank's gradient is lost, while the loss it
    reports is still the whole batch's."""
    import torch
    from brats21_tpu_torch.cli import main_train
    from brats21_tpu_torch.ops.tta import tree_map
    make = main_train.get_model

    def hook(module, inputs, out):
        return tree_map(lambda t: torch.cat([t[:1], t[1:].detach()]), out)

    def get_model(cfg):
        model = make(cfg)
        model.register_forward_hook(hook)
        return model

    main_train.get_model = get_model
    try:
        yield
    finally:
        main_train.get_model = make


def apart(got: dict, ref: dict, init: dict) -> tuple:
    """(distance of ``got``'s floating tensors from ``ref``'s as a share of
    ``ref``'s distance from ``init``, the worst tensor's share)."""
    move = diff = worst = 0.0
    for key, w in ref.items():
        if not w.is_floating_point():
            continue
        m = (w - init[key]).float().norm().item()
        d = (got[key] - w).float().norm().item()
        move, diff = move + m * m, diff + d * d
        worst = max(worst, d / m if m > 0 else 0.0)
    return math.sqrt(diff) / math.sqrt(move), worst


def ddp_phase(work: Path, train_data: Path, dev) -> dict:
    """Phase 21: the flagship recipe on 2 ranks of the card (one sample a
    rank) for 4 steps, held to the one-process run with batch 2: in fp32
    (``--no_amp``; B1's fp32 path), where the two runs differ by the order
    of float sums alone, and in bf16, the recipe's precision, where a batch
    of one and one of two round differently (:func:`batch_split_noise`).
    Beside them, each precision's one-process run with one sample's
    gradient left out (:func:`one_gradient_left_out`), which must break the
    limits, and a second bf16 one-process run, whose distance from the
    first is the floor under the bf16 comparison."""
    import torch
    from brats21_tpu_torch.models import get_model
    t0 = time.time()
    torch.cuda.empty_cache()
    noise = batch_split_noise(dev)
    extra = ("--fold", "None", "--batch_size", "2", "--epochs", "2")
    precisions = {"fp32": ("--no_amp",), "bf16": ()}
    one = {p: run_training(train_data, work / f"runs_ddp1_{p}", dev, extra=extra + flags)
           for p, flags in precisions.items()}
    again = run_training(train_data, work / "runs_ddp1_bf16_again", dev, extra=extra)
    with one_gradient_left_out():
        fault = {p: run_training(train_data, work / f"runs_ddp1_{p}_fault", dev,
                                 extra=extra + flags)
                 for p, flags in precisions.items()}
    base = ["--train_data_path", str(train_data), "--device", "0", "--model",
            "equiunet_assp_evo", "--width", str(WIDTH), "--criterion", "dice_hd",
            "--optimizer", "ranger", "--decay_type", "cosine", "--learning_rate", "3e-4",
            "--use_gc", "--remove_outliers", "--num_workers", "2", "--patch_size",
            *map(str, PATCH), "--no_tensorboard", *extra]
    ranks = launch_ranks(work, "ddp", [
        dict(cli="train", name=p, argv=base + ["--save_path", str(work / f"runs_ddp2_{p}"),
                                               *flags])
        for p, flags in precisions.items()])
    torch.manual_seed(123)                    # the CLI's default --seed
    init = get_model({"model": "equiunet_assp_evo", "width": WIDTH}).state_dict()

    def last(run):
        return torch.load(Path(run["run_dir"]) / "last_model.pth", map_location="cpu",
                          weights_only=True)["model"]

    def loss_rel(losses, ref):
        return [abs(a - b) / abs(b) for a, b in zip(losses, ref["step_losses"])]

    res = dict(batch_split_noise=noise, backend=ranks[0]["backend"])
    for k, p in enumerate(precisions):
        runs = [r["runs"][k] for r in ranks]
        check_step_launches(one[p], TRAIN_STEP_LAUNCHES, f"phase 21 one-process {p}")
        for r, run in zip(ranks, runs):
            check_step_launches(run, TRAIN_STEP_LAUNCHES, f"phase 21 {p} rank {r['rank']}")
            if len(run["step_losses"]) != 4:
                raise AssertionError(f"phase 21 {p} rank {r['rank']}: "
                                     f"{len(run['step_losses'])} steps")
        losses = [sum(v) / len(v) for v in zip(*(run["step_losses"] for run in runs))]
        rel = loss_rel(losses, one[p])
        params = [torch.load(work / "ddp" / f"params_{p}_rank{r}.pt", weights_only=True)
                  for r in range(2)]
        rank_diff = max((params[0][key].float() - params[1][key].float()).abs().max().item()
                        for key in params[0])
        whole = last(one[p])
        saved = torch.load(next((work / f"runs_ddp2_{p}").glob("*/last_model.pth")),
                           map_location="cpu", weights_only=True)["model"]
        for key in whole:
            if (saved[key] != params[0][key]).any():
                raise AssertionError(f"phase 21 {p}: the checkpoint's {key} is not rank 0's")
        share, worst = apart(params[0], whole, init)
        fault_rel = loss_rel(fault[p]["step_losses"], one[p])
        fault_share, _ = apart(last(fault[p]), whole, init)
        res[p] = dict(step_losses_two_ranks=losses, step_losses_one=one[p]["step_losses"],
                      loss_rel=rel, param_share_of_movement=share, worst_tensor_share=worst,
                      limits=dict(loss_rel=DDP_LOSS_RTOL[p], param_share=DDP_PARAM_SHARE[p]),
                      lost_gradient=dict(loss_rel=fault_rel, param_share=fault_share),
                      ranks_param_max_diff=rank_diff,
                      step_ms_per_rank=[run["step_ms"] for run in runs],
                      step_ms_one=one[p]["step_ms"],
                      peak_gib_per_rank=[run["peak_bytes"] / 2**30 for run in runs],
                      peak_gib_one=one[p]["peak_bytes"] / 2**30,
                      launches_per_step_per_rank=runs[0]["forward_launches"][0],
                      wall_s_per_rank=[run["wall_s"] for run in runs],
                      one_wall_s=one[p]["wall_s"])
        if p == "bf16":
            res[p]["one_process_run_to_run"] = dict(
                loss_rel=loss_rel(again["step_losses"], one[p]),
                param_share=apart(last(again), whole, init)[0])
        log(f"phase 21 DDP {p} (2 ranks, backend {res['backend']}): step losses {losses} vs "
            f"one process {one[p]['step_losses']} (relative {[f'{v:.2e}' for v in rel]}, "
            f"limit {DDP_LOSS_RTOL[p]}), parameters {share:.3g} of their movement apart "
            f"(limit {DDP_PARAM_SHARE[p]}; worst tensor {worst:.3g}), ranks' max |diff| "
            f"{rank_diff}; one gradient left out: relative "
            f"{[f'{v:.2e}' for v in fault_rel]}, parameters {fault_share:.3g} apart; "
            + (f"one process run to run: {json.dumps(res[p]['one_process_run_to_run'])}; "
               if p == "bf16" else "")
            + f"step ms per rank {[[round(t, 1) for t in r] for r in res[p]['step_ms_per_rank']]}"
            f" vs one process {[round(t, 1) for t in one[p]['step_ms']]}; peak GiB per rank "
            f"{[round(g, 2) for g in res[p]['peak_gib_per_rank']]} vs "
            f"{res[p]['peak_gib_one']:.2f}; launches a step per rank "
            f"{res[p]['launches_per_step_per_rank']}")
        if rank_diff != 0:
            raise AssertionError(f"phase 21 {p}: the ranks' parameters differ by {rank_diff}")
        if max(rel) > DDP_LOSS_RTOL[p] or share > DDP_PARAM_SHARE[p]:
            raise AssertionError(f"phase 21 {p}: loss relative {rel} (limit "
                                 f"{DDP_LOSS_RTOL[p]}), parameters {share:.3g} of their "
                                 f"movement apart (limit {DDP_PARAM_SHARE[p]})")
        if max(fault_rel) <= DDP_LOSS_RTOL[p] and fault_share <= DDP_PARAM_SHARE[p]:
            raise AssertionError(f"phase 21 {p}: a lost gradient stays within the limits "
                                 f"(loss relative {fault_rel}, parameters {fault_share:.3g} "
                                 "apart)")
    log(f"phase 21: batch of two vs two of one, no collective: {json.dumps(noise)}; in "
        f"{time.time() - t0:.1f}s")
    res["launches_per_step_per_rank"] = res["bf16"]["launches_per_step_per_rank"]
    return res


def serve_ranks_phase(work: Path, base: list, data: Path, run_dir: Path, other_run: Path,
                      val_data: Path, train_data: Path, tta_run: dict, ensemble: dict,
                      dev) -> dict:
    """Phase 22: the inference CLI on 2 local ranks: TTA combos, windows,
    STAPLE members and whole cases striped, each held to its one-process
    run (phases 5 and 13, and a two-case run here)."""
    t0 = time.time()
    two = cases_dir(work, train_data, "serve_two", 2)
    base_two = [str(two) if a == str(data) else a for a in base]
    one_cases = run_cli(base_two + ["--output", str(work / "out_cases1")], dev)
    ens = ["--config", str(run_dir / "config.yaml"), str(other_run / "config.yaml"),
           "--import_pth", str(run_dir / "best_model.pth"), str(other_run / "last_model.pth"),
           "--on", "val", "--train_data_path", str(val_data), "--device", "0",
           "--sliding_window_size", *map(str, SW_ROI)]
    out = {m: work / f"out_{m}_2r" for m in ("tta", "sliding", "staple", "cases")}
    jobs = [dict(cli="infer", name="tta", argv=base + ["--tta", "--output", str(out["tta"])]),
            dict(cli="infer", name="sliding",
                 argv=ens + ["--sliding_window_inference", "--output", str(out["sliding"])]),
            dict(cli="infer", name="staple",
                 argv=ens + ["--perform_staple", "--output", str(out["staple"])]),
            dict(cli="infer", name="cases", argv=base_two + ["--output", str(out["cases"])])]
    ranks = launch_ranks(work, "serve", jobs)
    refs = dict(tta=(tta_run, work / "out_tta" / "Inference_segmentations_test"),
                sliding=(ensemble["sliding"], work / "out_sliding" / "Inference_segmentations_val"),
                staple=(ensemble["staple"], work / "out_staple" / "Inference_segmentations_val"),
                cases=(one_cases, work / "out_cases1" / "Inference_segmentations_test"))
    res = {}
    for k, job in enumerate(jobs):
        name = job["name"]
        ref, ref_dir = refs[name]
        runs = [r["runs"][k] for r in ranks]
        saved = sorted(p for run in runs for p in run["saved"])
        files = sorted(f.name for f in (ref_dir).glob("*.nii.gz"))
        seg_dir = out[name] / ref_dir.name
        if saved != sorted(f[:-len(".nii.gz")] for f in files) or sorted(
                f.name for f in seg_dir.glob("*.nii.gz")) != files:
            raise AssertionError(f"phase 22 {name}: cases written {saved}, files "
                                 f"{sorted(f.name for f in seg_dir.glob('*.nii.gz'))}, "
                                 f"want each of {files} once")
        shares = [label_share(seg_dir / f, ref_dir / f) for f in files]
        got = [run["run_launches"] for run in runs]
        want = {kk: v // 2 for kk, v in ref["launches"].items()}
        if name == "sliding":
            # each rank's windows of each member (an odd count splits
            # unevenly: the ranks' sum is the whole), and on every rank the
            # members' losses of the stitched logits (3 EDT launches each)
            ok = all(sum(g[kk] for g in got) == ref["launches"][kk]
                     for kk in ("conv3x3x3", "evonorm_s0", *GLUE_FORWARD)) and all(
                g["edt_envelope"] == ref["launches"]["edt_envelope"] for g in got)
        else:
            ok = all(g == want for g in got)
        if not ok:
            raise AssertionError(f"phase 22 {name}: launches per rank {got}, one process "
                                 f"{ref['launches']}")
        if min(shares) < 0.999:
            raise AssertionError(f"phase 22 {name}: labels agree with the one-process run on "
                                 f"{shares} of voxels")
        res[name] = dict(launches_per_rank=got, one_process=ref["launches"],
                         all_reduce_per_rank=[run["all_reduce"] for run in runs],
                         label_share=shares, case_s_per_rank=[run["case_s"] for run in runs],
                         case_s_one=ref["case_s"], wall_s_per_rank=[r["wall_s"] for r in runs],
                         peak_gib_per_rank=[r["peak_bytes"] / 2**30 for r in runs],
                         saved_per_rank=[run["saved"] for run in runs])
        log(f"phase 22 {name}: launches per rank {got} (one process {ref['launches']}), "
            f"labels equal to the one-process run's on {min(shares):.6f} of voxels, case s "
            f"per rank {res[name]['case_s_per_rank']} vs {ref['case_s']}, all-reduces per "
            f"rank {res[name]['all_reduce_per_rank']}, written by rank "
            f"{res[name]['saved_per_rank']}")
    log(f"phase 22 serving on 2 ranks: {time.time() - t0:.1f}s")
    return res


def read_rows(path: Path) -> dict:
    """An Evaluation CSV's rows by patient id."""
    lines = [ln.split(",") for ln in path.read_text().splitlines() if ln]
    return {row[0]: [float(v) for v in row[1:]] for row in lines[1:]}


def nodes_phase(work: Path, run9_dir: Path, train_data: Path, val_data: Path, data: Path,
                dev) -> dict:
    """Phase 23: two nodes of one rank on this card: ``--on val`` with the
    val cases striped over the nodes, then ``main_train_folds``; the five
    fold directories served as an ensemble."""
    t0 = time.time()
    two = cases_dir(work, train_data, "val_two", 2)
    argv = ["--config", str(run9_dir / "config.yaml"), "--import_pth",
            str(run9_dir / "best_model.pth"), "--on", "val", "--val_data_path", str(two),
            "--device", "0"]
    one = run_cli(argv + ["--output", str(work / "out_val_1node")], dev)
    jobs = [dict(cli="infer", name="val", argv=argv + ["--output", str(work / "out_val_2n")])]
    ranks = launch_ranks(work, "nodes_val", jobs, nproc=1, nnodes=2)
    want_rows = read_rows(next((work / "out_val_1node").glob("Evaluation_inference_val*.csv")))
    got_rows = read_rows(next((work / "out_val_2n").glob("Evaluation_inference_val*.csv")))
    cases = [r["runs"][0]["saved"] for r in ranks]
    if sorted(got_rows) != sorted(want_rows) or len(want_rows) != 2 or sorted(
            cases[0] + cases[1]) != sorted(want_rows) or not all(cases):
        raise AssertionError(f"phase 23 --on val: rows {sorted(got_rows)} vs "
                             f"{sorted(want_rows)}, cases by node {cases}")
    row_diff = max(abs(a - b) for k in want_rows for a, b in zip(got_rows[k], want_rows[k]))
    if row_diff > 1e-6:
        raise AssertionError(f"phase 23 --on val: merged rows differ by {row_diff}")
    log(f"phase 23 --on val over 2 nodes: cases by node {cases}, merged rows equal to one "
        f"node's (max |diff| {row_diff}), launches by node "
        f"{[r['runs'][0]['run_launches'] for r in ranks]} vs one {one['launches']}")
    folds_argv = ["--train_data_path", str(val_data), "--save_path", str(work / "runs_folds"),
                  "--device", "0", "--model", "equiunet_assp_evo", "--width", str(WIDTH),
                  "--criterion", "dice_hd", "--optimizer", "ranger", "--decay_type", "cosine",
                  "--learning_rate", "3e-4", "--use_gc", "--remove_outliers", "--epochs", "1",
                  "--val_frequency", "1", "--num_workers", "2", "--patch_size",
                  *map(str, PATCH), "--no_tensorboard"]
    franks = launch_ranks(work, "nodes_folds", [dict(cli="folds", name="folds",
                                                      argv=folds_argv)], nproc=1, nnodes=2)
    base, = (work / "runs_folds").glob("*_folds")
    fold_dirs = sorted(base.glob("fold_*"))
    if [d.name for d in fold_dirs] != [f"fold_{f}" for f in range(5)] or not all(
            (d / n).exists() for d in fold_dirs for n in ("config.yaml", "best_model.pth")):
        raise AssertionError(f"phase 23 folds: {[d.name for d in fold_dirs]}")
    configs = [str(d / "config.yaml") for d in fold_dirs]
    served = run_cli(["--config", *configs, "--on", "test", "--input", str(data),
                      "--device", "0", "--output", str(work / "out_folds")], dev)
    case, = served["cases"]
    if case["members"] != 5 or served["launches"]["conv3x3x3"] != 5 * 14 or any(
            served["launches"][k] != 5 * v for k, v in GLUE_FORWARD.items()):
        raise AssertionError(f"phase 23 folds ensemble: {case['members']} members, launches "
                             f"{served['launches']}")
    check_segmentation(work / "out_folds" / "Inference_segmentations_test"
                       / "BraTS2021_00000.nii.gz")
    res = dict(val_rows_max_diff=row_diff, val_cases_by_node=cases,
               val_launches_by_node=[r["runs"][0]["run_launches"] for r in ranks],
               val_one_node_launches=one["launches"],
               folds_launches_by_node=[r["runs"][0]["run_launches"] for r in franks],
               folds_wall_s_by_node=[r["runs"][0]["wall_s"] for r in franks],
               folds_peak_gib_by_node=[r["runs"][0]["peak_bytes"] / 2**30 for r in franks],
               folds_val_cases_by_node=[len(r["runs"][0]["cases"]) for r in franks],
               ensemble_launches=served["launches"], ensemble_case_s=served["case_s"])
    log(f"phase 23 main_train_folds over 2 nodes: launches by node "
        f"{res['folds_launches_by_node']}, wall {res['folds_wall_s_by_node']} s, peak GiB "
        f"{res['folds_peak_gib_by_node']}; five fold directories served as an ensemble "
        f"(launches {served['launches']}, case {served['case_s']} s); in "
        f"{time.time() - t0:.1f}s")
    return res


def decompressed_segs(folder: Path) -> dict:
    import gzip
    return {p.name: gzip.decompress(p.read_bytes()) for p in sorted(folder.glob("*.nii.gz"))}


def kernel_busy(trace_path: str, wall_s: float) -> dict:
    """From a Chrome trace of ``torch.profiler``: the kernels' events by
    name, and the card's busy share of the window (the union of the
    kernels' intervals over the window's host seconds)."""
    from collections import Counter
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") == "kernel")
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    names = Counter(e["name"] for e in events if e.get("cat") == "kernel")
    return dict(kernels=len(spans), busy_s=busy / 1e6, busy_share=busy / 1e6 / wall_s,
                names=names)


def trace_request(port: int, ms: int, results: list, timeout: float = 60.0) -> None:
    """Ask the trace server on ``port`` for a capture of ``ms`` once the
    run has launched B1 (its first case is on the card) and the server
    listens (both polled every 0.1 s up to ``timeout``); the answer, or
    the error, goes to ``results``."""
    import urllib.error
    import urllib.request

    from brats21_tpu_torch.ops.kernels import conv3d
    t0, last = time.time(), None
    while conv3d.launches == 0 and time.time() - t0 < timeout:
        time.sleep(0.1)
    while time.time() - t0 < timeout:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/capture?ms={ms}",
                                        timeout=timeout) as r:
                results.append(r.read().decode())
            return
        except urllib.error.HTTPError as e:
            results.append(AssertionError(f"trace server: {e.code} {e.read().decode()}"))
            return
        except OSError as e:        # not listening yet
            last = e
            time.sleep(0.1)
    results.append(AssertionError(f"no trace from 127.0.0.1:{port}: {last}"))


def wire_chosen(out: Path) -> tuple:
    """(the wire, why) that the inference CLI's engine logged in ``out``."""
    import re
    found = re.findall(r"wire: (dense|sparse) \(([^)]*)\)",
                       (out / "logfile_inference.log").read_text())
    if len(found) != 1:
        raise AssertionError(f"{out}: {len(found)} wire decisions logged: {found}")
    return found[0]


def pipeline_phase(work: Path, member: tuple, val_run: Path, val_data: Path, card: str,
                   dev) -> dict:
    """Phase 25: a backlog of PIPELINE_CASES synthetic 240×240×155 cases
    served by the inference CLI with phase 4's member under (a) the
    case-serial path, (b) the defaults, (c) three cases in flight on the
    sparse wire, and (d) TTA on two of them under (a) and (b); the labels
    byte-equal across (a)-(c) and across (d), 14 B1 and 21 B2 launches a
    case; ``--on val`` on phase 12's run under (a) and (b) with equal
    meters and report rows; a ``capture()`` of (b) holding B1's and B2's
    kernels, with the card's busy share of its window; the wire each run's
    engine logged (dense under ``--wire auto``, sparse under ``--wire
    sparse``); and a request to the ``BRATS21_PROFILE_PORT`` server
    during (d)(b), made once its first case is on the card, answered with
    a trace that holds B1's or B2's kernels."""
    import os
    import re
    import socket
    import threading

    from brats21_tpu_torch.data.synthetic import generate_synthetic_dataset
    from brats21_tpu_torch.utils.profiling import capture
    t0 = time.time()
    backlog, tta_cases = work / "backlog", work / "backlog_tta"
    with ThreadPoolExecutor(PIPELINE_CASES) as pool:
        list(pool.map(lambda i: generate_synthetic_dataset(
            str(backlog), num_cases=1, shape=CASE_SHAPE, seed=SEED + 25, first_case=i,
            with_seg=False), range(200, 200 + PIPELINE_CASES)))
    cases = sorted(p.name for p in backlog.iterdir())
    tta_cases.mkdir()
    for pid in cases[:PIPELINE_TTA_CASES]:
        (tta_cases / pid).symlink_to(backlog / pid, target_is_directory=True)
    log(f"phase 25 data: {len(cases)} cases of {CASE_SHAPE} in {time.time() - t0:.1f}s")
    config, pth = member
    base = ["--config", str(config), "--import_pth", str(pth), "--on", "test", "--device", "0",
            "--cleaning_areas", "--replace_value"]
    serial = [("BRATS21_EVAL_STAGES", "0"), ("BRATS21_EVAL_PIPELINE", "1")]
    defaults = [("BRATS21_EVAL_STAGES", "1"), ("BRATS21_EVAL_PIPELINE", "2")]
    settings = dict(a=(serial, []), b=(defaults, []),
                    c=([("BRATS21_EVAL_STAGES", "1"), ("BRATS21_EVAL_PIPELINE", "3")],
                       ["--wire", "sparse"]))
    runs, segs, wires = {}, {}, {}
    for name, (env, flags) in settings.items():
        out = work / f"pipe_{name}"
        runs[name] = run_cli(base + flags + ["--input", str(backlog), "--output", str(out)],
                             dev, env, probe=False)
        segs[name] = decompressed_segs(out / "Inference_segmentations_test")
        wires[name] = wire_chosen(out)
    # (d) under (a) and (b); the trace server asked for a window during (d)(b)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    answers = []
    asker = threading.Thread(target=trace_request, args=(port, TRACE_SERVER_MS, answers),
                             daemon=True)
    for name, env in (("d_a", serial),
                      ("d_b", defaults + [("BRATS21_PROFILE_PORT", str(port))])):
        out = work / f"pipe_{name}"
        if name == "d_b":
            asker.start()
        runs[name] = run_cli(base + ["--tta", "--input", str(tta_cases), "--output",
                                     str(out)], dev, env, probe=False)
        segs[name] = decompressed_segs(out / "Inference_segmentations_test")
    asker.join(timeout=60)
    if asker.is_alive():
        raise AssertionError("phase 25: the trace server did not answer within 60 s")
    # (b) again under capture(): the trace holds B1's and B2's kernels
    with capture(str(work / "pipe_trace")) as trace:
        t_cap = time.time()
        traced = run_cli(base + ["--input", str(backlog), "--output",
                                 str(work / "pipe_b_traced")], dev, defaults, probe=False)
        cap_wall = time.time() - t_cap
    busy = kernel_busy(trace.path, cap_wall)
    # --on val on phase 12's run under (a) and (b)
    val_base = ["--config", str(val_run / "config.yaml"), "--import_pth",
                str(val_run / "best_model.pth"), "--on", "val", "--train_data_path",
                str(val_data), "--device", "0"]
    val, rows = {}, {}
    for name, env in (("a", serial), ("b", defaults)):
        out = work / f"pipe_val_{name}"
        val[name] = run_cli(val_base + ["--output", str(out)], dev, env, probe=False)
        report, = out.glob("Evaluation_inference_val*.csv")
        rows[name] = report.read_text().splitlines()
    # the checks
    n = len(cases)
    per_case = SERVED_FORWARD_LAUNCHES
    for name, run in runs.items():
        k = PIPELINE_TTA_CASES if name.startswith("d") else n
        mult = 16 if name.startswith("d") else 1
        want = {key: k * mult * v for key, v in per_case.items()}
        if run["launches"] != want:
            raise AssertionError(f"phase 25 ({name}): launches {run['launches']}, want {want}")
        if len(run["case_s"]) != k or len(segs[name]) != k:
            raise AssertionError(f"phase 25 ({name}): {len(run['case_s'])} batch_time "
                                 f"entries and {len(segs[name])} NIfTIs for {k} cases")
    if traced["launches"] != runs["b"]["launches"]:
        raise AssertionError(f"phase 25 traced (b): launches {traced['launches']}")
    for x, y in (("a", "b"), ("a", "c"), ("d_a", "d_b")):
        differ = [f for f in segs[x] if segs[y].get(f) != segs[x][f]]
        if sorted(segs[x]) != sorted(segs[y]) or differ:
            raise AssertionError(f"phase 25: the labels of ({x}) and ({y}) differ: {differ}")
    for f in segs["b"]:
        check_segmentation(work / "pipe_b" / "Inference_segmentations_test" / f)
    want_val = {key: v * len(val["a"]["case_s"])
                for key, v in VAL_CASE_LAUNCHES.items()}
    for name, run in val.items():
        if run["launches"] != want_val:
            raise AssertionError(f"phase 25 val ({name}): launches {run['launches']}, "
                                 f"want {want_val}")
    if val["a"]["meters"] != val["b"]["meters"] or rows["a"] != rows["b"]:
        raise AssertionError(f"phase 25 val: meters {val['a']['meters']} vs "
                             f"{val['b']['meters']}, rows {rows['a']} vs {rows['b']}")
    if not any("conv3x3x3" in k for k in busy["names"]) or not any(
            "evonorm" in k for k in busy["names"]):
        raise AssertionError(f"phase 25: the captured trace lacks B1 or B2: "
                             f"{sorted(busy['names'])[:20]}")
    if [w for w, _ in (wires["a"], wires["b"], wires["c"])] != ["dense", "dense", "sparse"] \
            or not wires["b"][1].startswith("--wire auto"):
        raise AssertionError(f"phase 25: the engines chose the wires {wires}")
    mbps = float(re.search(r"link ([0-9.]+) MB/s", wires["b"][1]).group(1))
    if len(answers) != 1 or not isinstance(answers[0], str):
        raise AssertionError(f"phase 25: the trace server answered {answers}")
    served = kernel_busy(answers[0], TRACE_SERVER_MS / 1e3)
    served_b1_b2 = {k: v for k, v in served["names"].items()
                    if "conv3x3x3" in k or "evonorm" in k}
    if not served_b1_b2:
        raise AssertionError(f"phase 25: the trace server's window holds no B1 or B2 "
                             f"kernel: {served['kernels']} kernels, "
                             f"{sorted(served['names'])[:20]}")
    res = dict(
        card=card, cases=n, wires={k: dict(zip(("wire", "why"), w)) for k, w in wires.items()},
        wire_auto=dict(chosen=wires["b"][0], mbps=mbps),
        wall_per_case_s={k: runs[k]["wall_s"] / n for k in "abc"},
        wall_s={k: run["wall_s"] for k, run in runs.items()},
        batch_time_s={k: run["case_s"] for k, run in runs.items()},
        data_time_s={k: run["data_time_s"] for k, run in runs.items()},
        launches={k: run["launches"] for k, run in runs.items()},
        traced_b=dict(wall_s=cap_wall, kernels=busy["kernels"], busy_s=busy["busy_s"],
                      busy_share=busy["busy_share"],
                      b1_b2_kernels=sorted(k for k in busy["names"]
                                           if "conv3x3x3" in k or "evonorm" in k)),
        val=dict(meters=val["a"]["meters"], rows=len(rows["a"]) - 1,
                 launches=val["a"]["launches"],
                 wall_s={k: v["wall_s"] for k, v in val.items()},
                 batch_time_s={k: v["case_s"] for k, v in val.items()}),
        trace_server=dict(path=answers[0], window_ms=TRACE_SERVER_MS,
                          kernels=served["kernels"], busy_share=served["busy_share"],
                          b1_b2_events=sum(served_b1_b2.values()),
                          b1_b2_kernels=sorted(served_b1_b2)),
        phase_s=time.time() - t0)
    os.remove(trace.path)
    log(f"phase 25 pipeline ({card}): wall per case (a) {res['wall_per_case_s']['a']:.3f}s, "
        f"(b) {res['wall_per_case_s']['b']:.3f}s, (c) {res['wall_per_case_s']['c']:.3f}s; "
        f"the engine's wire=auto chose {wires['b'][0]} at {mbps:.1f} MB/s; busy share of (b)'s captured window "
        f"{busy['busy_share']:.4f} ({busy['kernels']} kernels, {busy['busy_s']:.3f} of "
        f"{cap_wall:.3f}s); the trace server's {TRACE_SERVER_MS} ms window during (d)(b) "
        f"{served['kernels']} kernels, {sum(served_b1_b2.values())} of them B1 or B2; "
        f"labels byte-equal (a)-(c) and (d); val meters equal; "
        f"{json.dumps(res)}")
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's kernels need a GPU",
              file=sys.stderr)
        return 1
    import brats21_tpu_torch  # noqa: F401 — fails outside the checkout
    from brats21_tpu_torch.config import TrainConfig
    from brats21_tpu_torch.data import native
    from brats21_tpu_torch.data.pipeline import BraTSDataset
    from brats21_tpu_torch.data.synthetic import generate_synthetic_dataset
    from brats21_tpu_torch.data.transforms import shape_to_divisible
    from brats21_tpu_torch.models import get_model
    from brats21_tpu_torch.ops import kernels
    from brats21_tpu_torch.parallel import spatial

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
    sources = kernels.SOURCES
    builds = [kernels.start_build(src) for src in sources]

    def finish(build):
        log_text = kernels.finish_build(build)
        return log_text, time.time() - t0

    def build_native():
        if native.library() is None:
            raise AssertionError("the native case loader did not build or load")
        return time.time() - t0

    with ThreadPoolExecutor(len(builds) + 1) as pool:
        waits = [pool.submit(finish, build) for build in builds]
        native_wait = pool.submit(build_native)
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
        log(f"g++ {native.SOURCE}: loaded after {native_wait.result():.1f}s")
    kernels.warm_up(dev)          # one launch of each kernel
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
    # the sliding window's batches: 2 windows of 128³
    conv_sw = check_conv(lambda level: tuple(s // 2 ** (level - 1) for s in SW_ROI), dev,
                         batch=SW_BATCH)
    evo_sw = check_evonorm(lambda level: tuple(s // 2 ** (level - 1) for s in SW_ROI), dev,
                           batch=SW_BATCH)
    torch.cuda.empty_cache()
    # B2's split entry points and B1 at phase 24's slab shapes: rank 0's
    # slab of the padded case (72 of its 136 planes on 2 ranks), B1's with
    # one halo plane a side
    slab_z = spatial.slab_bounds(padded[2], SPATIAL_SPACE)[1]

    def slab_shape(level):
        d, h, _ = level_shape(level)
        return d, h, slab_z // 2 ** (level - 1)

    glue_res = check_glue(level_shape, dev)
    log(f"phase 2 glue kernels a served forward: {glue_res['ms']:.3f} ms (bound "
        f"{glue_res['bound_ms']:.3f}, the PyTorch calls they replace "
        f"{glue_res['composition_ms']:.3f}); {glue_res['differ']} elements differ")
    evo_split = check_evonorm_split(slab_shape, dev)
    conv_slab = check_conv(lambda level: (*slab_shape(level)[:2], slab_shape(level)[2] + 2),
                           dev)
    log(f"phase 2 at phase 24's slabs: B1 {conv_slab['ms']:.3f} ms a forward (bound "
        f"{conv_slab['bound_ms']:.3f}, cuDNN {conv_slab['library_ms']:.3f}); B2 split: stats "
        f"{evo_split['stats']['ms']:.3f} ms (bound {evo_split['stats']['bound_ms']:.3f}), "
        f"apply {evo_split['apply']['ms']:.3f} ms (bound {evo_split['apply']['bound_ms']:.3f})")
    log(f"phase 2 kernels vs plain: {time.time() - t0:.1f}s; per sliding-window batch "
        f"(2×128³): conv {conv_sw['ms']:.3f} ms (bound {conv_sw['bound_ms']:.3f}, cuDNN "
        f"{conv_sw['library_ms']:.3f}), EvoNorm {evo_sw['ms']:.3f} ms (bound "
        f"{evo_sw['bound_ms']:.3f})")

    # 3. whole models, card vs CPU: the flagship, then the model zoo's
    # eight names and three other norms, each forward's launches checked
    t0 = time.time()
    check_model(dev)
    zoo = {}
    for name, norm, side in ZOO_CHECKS:
        res = zoo[f"{name}/{norm}"] = check_model(dev, name, norm, side)
        if res["launches"] != list(ZOO_LAUNCHES[name]):
            raise AssertionError(f"model {name} ({norm}): launches {res['launches']} a forward, "
                                 f"want {list(ZOO_LAUNCHES[name])}")
    torch.cuda.empty_cache()
    log(f"phase 3 models card vs CPU: {time.time() - t0:.1f}s")

    # every case phases 4-14 load goes through the native loader
    native_counts = {}

    def take_native(phase, cli: bool) -> None:
        counts = native_counts[phase] = native.take_counts()
        if counts["fallbacks"] or (cli and not counts["loads"]):
            raise AssertionError(f"phase {phase}: native loads {counts['loads']}, "
                                 f"fallbacks {counts['fallbacks']}")

    native.take_counts()

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
    want = SERVED_FORWARD_LAUNCHES
    if main_run["launches"] != want:
        raise AssertionError(f"main path launches {main_run['launches']} != {want}")
    log(f"phase 4 main path: CLI wall {main_run['wall_s']:.2f}s, case "
        f"{main_run['case_s'][0]:.3f}s, peak {main_run['peak_bytes'] / 2**30:.2f} GiB, "
        f"launches {main_run['launches']}")
    take_native(4, cli=True)

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
    take_native(5, cli=True)

    # 6. where the served case's time goes
    breakdown = stage_breakdown(model.to(dev).eval(), data, work / "out_stages", dev)
    take_native(6, cli=False)
    breakdown["decode_crop_normalise_by_path"] = decode_paths(data)
    log(f"phase 6 stages: {json.dumps(breakdown)}")
    del model
    torch.cuda.empty_cache()

    # 7. the EDT envelope kernel vs its plain version
    t0 = time.time()
    edt_res = check_edt(dev, padded)
    torch.cuda.empty_cache()
    log(f"phase 7 EDT kernel vs plain: {time.time() - t0:.1f}s")
    take_native(7, cli=False)

    # 8. trainable conv / EvoNorm grads vs plain autograd, and both kernels
    # timed at the train step's 128³ level shapes
    t0 = time.time()
    grads = check_grads(dev)
    torch.cuda.empty_cache()
    conv_train = check_conv(lambda level: tuple(s // 2 ** (level - 1) for s in PATCH), dev)
    evo_train = check_evonorm(lambda level: tuple(s // 2 ** (level - 1) for s in PATCH), dev)
    torch.cuda.empty_cache()
    log(f"phase 8 grads and train-shape kernels: {time.time() - t0:.1f}s")
    take_native(8, cli=False)

    # 9. the training path through the CLI, then the trained weights served
    t0 = time.time()
    train_data = work / "train_data"
    extra_case = work / "extra_case"     # phase 12's fifth case
    with ThreadPoolExecutor(5) as pool:
        list(pool.map(lambda i: generate_synthetic_dataset(
            str(train_data if i < 4 else extra_case), num_cases=1, shape=CASE_SHAPE,
            seed=SEED + 10, first_case=i), range(5)))
    log(f"phase 9 data: 5 cases of {CASE_SHAPE} in {time.time() - t0:.1f}s")
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
    take_native(9, cli=True)

    # 10. where one train step's time goes
    t0 = time.time()
    torch.cuda.empty_cache()
    step_split = train_step_breakdown(dev)
    log(f"phase 10 train step split (ms): {json.dumps(step_split)} in {time.time() - t0:.1f}s")
    take_native(10, cli=False)

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
    take_native(11, cli=True)

    # 12. validation through the train CLI, then one val case's split
    val, val_split, val_data = validation_phase(work, train_data, extra_case, dev)
    take_native(12, cli=True)

    # 13. the inference CLI on the val case with a two-member ensemble
    # (phase 11's run: the same w48 architecture, other weights)
    ensemble = ensemble_phase(work, Path(val["run_dir"]), Path(boundary["run_dir"]),
                              val_data, dev)
    take_native(13, cli=True)

    # 14. the Dockerfile's command on phase 12's run directory
    docker = docker_phase(work, Path(val["run_dir"]), data / "BraTS2021_00000", dev)
    take_native(14, cli=True)
    log(f"native case loader, phases 4-14: {json.dumps(native_counts)}")

    # 15. --watch serving with a warm-up at the cases' cropped shape
    watch = watch_phase(work, Path(val["run_dir"]), sample["img"].shape[:3], dev)

    # 16. Model 1's recipe: train, then serve its run directory
    native.take_counts()
    model1 = model1_phase(work, train_data, data, level_shape, dev)
    take_native(16, cli=True)

    # 17. --norm batch: the attention unet's running statistics
    batchnorm = batchnorm_phase(work, train_data, data, padded, dev)
    take_native(17, cli=True)

    # 18. the MONAI-backed names card vs CPU
    monai = monai_zoo_phase(dev)

    # 19. nnunet with novograd: train, SIGTERM, resume, serve
    nnunet = nnunet_phase(work, train_data, data, dev)
    take_native(19, cli=True)

    # 20. unet_tr trained and served through windows; segresnetvae's VAE term
    unetr = unetr_phase(work, train_data, data, dev)
    take_native(20, cli=True)

    # 21. data-parallel training on 2 ranks of the card
    ddp = ddp_phase(work, train_data, dev)
    take_native(21, cli=True)

    # 22. serving on 2 local ranks (the one-process runs: phases 5 and 13)
    serve2 = serve_ranks_phase(work, base, data, Path(val["run_dir"]),
                               Path(boundary["run_dir"]), val_data, train_data, tta_run,
                               ensemble, dev)

    # 23. two nodes: --on val striped, fold-parallel training
    nodes = nodes_phase(work, run_dir, train_data, val_data, data, dev)

    # 24. the served case Z-sharded over a space row of two ranks
    spatial_res = spatial_phase(work, shape_to_divisible(sample["img"])[0],
                                Path(val["run_dir"]), dev)

    # 25. a backlog through the eval pipeline: stages, cases in flight, wires
    native.take_counts()
    pipeline = pipeline_phase(work, (work / "config.yaml", work / "best_model.pth"),
                              Path(val["run_dir"]), val_data, card, dev)
    take_native(25, cli=True)

    # 26. every other --model name Z-sharded over the space row
    zoo_spatial = zoo_spatial_phase(work, shape_to_divisible(sample["img"])[0],
                                    spatial_res["label_share_floor_batch_of_two"], dev)

    # 27. Swin UNETR: B4 against its plain version, trained, served through
    # windows with --tta
    swin = swin_phase(work, train_data, data, dev)
    take_native(27, cli=True)

    sliding_case, = ensemble["sliding"]["cases"]

    def launches_by_path(name: str) -> dict:
        """A kernel's launches on each path the script drove, each counted
        in its own run."""
        return dict(
            inference_case=main_run["launches"][name],
            train_step=train_launches[name],
            val_case=val["val_cases"][0]["launches"][name],
            val_case_tta=val["val_cases"][2]["launches"][name],
            sliding_window_case=sliding_case["launches"][name]
            // sliding_case["members"],
            docker_case_tta=docker["runs"]["run_directory"]["launches"][name],
            watched_case=watch["case_launches"][name],
            model1_train_step=MODEL1_STEP_LAUNCHES[name],
            model1_case=model1["serve"]["plain"]["launches"][name],
            model1_case_tta=model1["serve"]["tta"]["launches"][name],
            batchnorm_att_unet_train_step=BATCHNORM_STEP_LAUNCHES[name],
            nnunet_train_step=nnunet["train"]["step_launches"][name],
            nnunet_case=nnunet["served"]["launches"][name],
            unet_tr_train_step=unetr["train"]["step_launches"][name],
            unet_tr_case=unetr["served"]["launches"][name],
            segresnetvae_train_step=unetr["segresnetvae"]["train"][
                "step_launches"][name],
            ddp_train_step_per_rank=ddp["launches_per_step_per_rank"][name],
            **{f"two_ranks_{k}_per_rank": [r[name] for r in v["launches_per_rank"]]
               for k, v in serve2.items()},
            two_ranks_spatial_forward_per_rank=[
                r.get(name, 0) for r in spatial_res["launches_per_rank"]],
            two_ranks_zoo_spatial_forward_per_rank={
                model: [r.get(name, 0) for r in zrow["launches_per_rank"]]
                for model, zrow in zoo_spatial["names"].items()},
            pipeline_case=pipeline["launches"]["b"][name] // pipeline["cases"],
            pipeline_case_tta=pipeline["launches"]["d_b"][name]
            // PIPELINE_TTA_CASES,
            pipeline_val_case=pipeline["val"]["launches"][name]
            // len(pipeline["val"]["batch_time_s"]["a"]),
            swin_unetr_train_step=swin["train"]["step_launches"][name],
            swin_unetr_case_tta=swin["served"]["launches"][name])

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
                   launches_by_path=launches_by_path(name),
                   shapes=res["rows"])
        if name == "conv3x3x3":
            row["model1"] = {
                k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms", "library_ms",
                                      "max_abs_err", "rows")}
                for k, v in (("served_forward", model1["conv_served"]),
                             ("train_forward_128", model1["conv_train"]),
                             ("refunet_conv_d0_served", model1["conv_refunet_conv_d0"]))}
            row["fp32_launches_norm_batch"] = dict(
                train=batchnorm["conv_launches_train"],
                served_case=batchnorm["conv_launches_served"])
            row["fp32_path_shapes"] = batchnorm["fp32_conv"]
            row["monai_zoo_128"] = {
                k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms", "library_ms",
                                      "max_abs_err", "rows")}
                for k, v in (("nnunet_train_forward", nnunet["conv_train_forward"]),
                             ("segresnet_8ch_layers", nnunet["conv_segresnet_8ch"]),
                             ("unetr_16ch_layers", nnunet["conv_unetr_16ch"]))}
            row["monai_zoo_launches_a_forward"] = {
                k: v["launches"][0] for k, v in monai.items()}
            row["spatial_slab_shapes"] = {k: conv_slab[k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err", "rows")}
        if name == "evonorm_s0":
            # B2's split entry points, at phase 24's slab shapes, and their
            # launches a forward on each rank of phase 24's space row
            row["split"] = dict(
                evo_split, launches_per_rank={
                    part: [r[f"evonorm_s0_{part}"] for r in spatial_res["launches_per_rank"]]
                    for part in ("stats", "apply")},
                zoo_launches_per_rank={
                    model: {part: [r[f"evonorm_s0_{part}"] for r in zrow["launches_per_rank"]]
                            for part in ("stats", "apply")}
                    for model, zrow in zoo_spatial["names"].items()
                    if zrow["one_process_launches"]["evonorm_s0"]},
                sources="evonorm_s0_stats / evonorm_s0_apply in "
                        "brats21_tpu_torch/ops/kernels/evonorm.py",
                tolerance="stats: counts equal, inv within 2**-8 relative; apply: bf16 "
                          "2**-8*|ref| elementwise, fp32 1e-5 abs")
        if "scan_bound_ms" in res:
            row["scan_bound_ms"] = res["scan_bound_ms"]
            row["full_case_edt_sq"] = dict(ms=res["full_case_ms"],
                                           bound_ms=res["full_case_bound_ms"])
            row["launches_by_path"]["boundary_loader_case"] = EDT_LAUNCHES_PER_LOADED_CASE
        if res_train is not None:
            row["train_step_shapes"] = {k: res_train[k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms", "rows") if k in res_train}
            res_sw = conv_sw if name == "conv3x3x3" else evo_sw
            row["sliding_window_batch_shapes"] = {k: res_sw[k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms", "rows") if k in res_sw}
        else:
            row["val_loss_batch"] = res["val_loss_batch"]
        kernel_rows.append(row)
    for name in GLUE_FORWARD:
        res = [r for r in glue_res["rows"] if r["kernel"] == name]
        kernel_rows.append(dict(
            name=name, route="cuda", source="brats21_tpu_torch/csrc/glue3d.cu",
            replaces="none (XLA fusions in the JAX package)",
            launches_per="served forward", launches=main_run["launches"][name],
            launches_by_path=launches_by_path(name),
            tolerance="gate and max bit-equal; mean and upsample within one bf16 ulp",
            differ=sum(r["differ"] for r in res), ms=sum(r["ms"] for r in res),
            bound_ms=sum(r["bound_ms"] for r in res), bound_by="bytes",
            composition_ms=sum(r["composition_ms"] for r in res), ms_per="served forward",
            shapes=res))
    attn = swin["window_attn"]
    kernel_rows.append(dict(
        name="window_attn", route="cuda", source="brats21_tpu_torch/csrc/window_attn.cu",
        replaces="none (the JAX package has no Swin UNETR)",
        launches_per="served swin_unetr case (128³ windows in pairs, 16-combo TTA)",
        launches=swin["served"]["launches"]["window_attn"],
        launches_by_path=launches_by_path("window_attn"),
        tolerance=f"relative RMS of the fp32 composition: bf16 {WINDOW_ATTN_REL_RMS}, fp32 "
                  f"{WINDOW_ATTN_F32_REL_RMS}",
        max_rel_rms=attn["max_rel_rms"], max_fp32_rel_rms=attn["max_fp32_rel_rms"],
        ms=attn["ms"], fp32_ms=attn["fp32_ms"], plain_ms=attn["plain_ms"],
        bound_ms=attn["bound_ms"], bound_by=attn["bound_by"],
        ms_per="predictor call (2 windows of 128³: 8 launches)", shapes=attn["rows"]))
    for run in (train, boundary, val):
        run.pop("forward_launches")
        run.pop("backward_launches")
    summary = dict(card=card, padded_case=list(padded), main_path=main_run,
                   tta=tta_run, stages=breakdown, grads_max_abs_err=grads, train=train,
                   trained_served=served, train_step_split_ms=step_split,
                   boundary=boundary, validation=val, val_case_split=val_split,
                   ensemble=ensemble, native_loads=native_counts, docker=docker, watch=watch,
                   zoo_models=zoo, model1=model1, batchnorm=batchnorm, monai_zoo=monai,
                   nnunet=nnunet, unetr=unetr, ddp=ddp, serve_two_ranks=serve2,
                   two_nodes=nodes, spatial=spatial_res, pipeline=pipeline,
                   zoo_spatial=zoo_spatial, glue_forward=glue_res["forward"], swin=swin,
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
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(sys.argv[2]))
    sys.exit(main())
