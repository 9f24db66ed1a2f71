#!/usr/bin/env python3
"""Drive gim_tpu_torch's main path on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, `nvcc`
(sm_90a) and PyTorch built for CUDA. The kernels K2, K3 and K3's masked
variant run where the port's rule (`ops/kernels/forward_only.on_kernel`)
sends them: card tensors in inference mode, as every match call is; a
phase that compares them with the plain graph swaps the rule for one
that answers no (`swapped`).
Phases, each printing what it found:

1. environment: card name and power limit, torch / CUDA versions, TF32;
2. build: every kernel of the path, from the sources in the checkout;
3. kernel K1 (dsmax_stats, dsmax_argmax) against its plain PyTorch
   version at main-path shapes (8 pairs, L = S = 10816 coarse cells of
   832 px, C = 256, bf16; unmasked, masked, well separated) and on ragged
   bf16 cases through the wgmma path ((2, 1000, 1300, 256); (1, 70, 90,
   32); one partial f0 block against S = 10816, masked), with timings of
   kernel, plain version and `torch.bmm` of the same f0 f1^T, beside the
   card's bound (products, exp2s and bytes, whichever is largest); and
   K1's float32 kernels (dsmax_stats_f32, dsmax_argmax_f32: the SIMT
   kernel, S in chunks) at the same breadth: ragged (2, 1000, 1300, 256),
   (1, 70, 90, 32) masked, (1, 100, 11025, 256) masked and ZEB's shape
   (1, 11025, 11025, 256) with an 840 x 630 content mask, plus planted
   ties across a chunk border and a row-block border (exact), against
   their plain sweeps in the kernel's partial layout and the dense
   recipe, timed beside their FP32-FMA bound and `torch.bmm` in float32
   with TF32 off;
4. main path: `Matcher("gim_loftr")` at full width (ResNet-50 FPN, 4
   coarse and 1 fine (self, cross) pairs) with seeded random weights at
   the bench operating point (bf16, fused matching, 2048 matches): 3
   batches of 8 pairs at 832 x 832, one batch with content masks (832 x
   624 on the canvas), one identical-image batch; launch counts of every
   kernel read around this phase;
5. fused against dense matching on the card at 320 px in float32, TF32 off;
6. kernel K2 (refiner_block, the fused ConvRefiner block) against its
   plain version at the four main-path shapes of gim_roma and the four of
   gim_dkm in bf16 and on ragged cases (C 40 -> 56, widths 200 and 203;
   192 -> 144) in float32 and bf16, with timings of kernel, plain version
   and the plain-graph block (PyTorch's depthwise conv, BN, ReLU, 1x1
   conv) beside the bound; then K2's float32 kernel (3xTF32 1x1) on
   float32 edges (one row, one column, 1 x 1, C 7 -> 5, 192 -> 192) and
   at both heads' eight full shapes (C_out = C) against its plain version
   at TOL_F32, timed beside the float32 plain-graph block (TF32 off), its
   floor and its FP32-FMA figure;
7. kernel K3 (flash_attention) against its plain version on the strided
   q, k, v views of a qkv split at the ViT-L (2, 16, 2305, 64) and
   coordinate-decoder (2, 8, 2304, 128) shapes in bf16 and on ragged
   cases (contiguous and strided, float32 and bf16; float32 also at N = 1
   and 257), with `F.scaled_dot_product_attention`'s time on the same
   views as the library yardstick (the port never calls it); then K3's
   float32 kernel (3xTF32) at those two shapes against its plain version
   at TOL_ATTN_F32, timed beside SDPA in float32 (TF32 off), its floor and
   its FP32-FMA figure; then its masked variant (LightGlue's attention)
   against its plain version at TOL_ATTN_F32 on ragged, Nq != Nk, D = 128,
   no-valid-key and maskless cases, and at LightGlue's (1, 4, 2048, 64)
   and (16, 4, 2048, 64) with 5 % of the keys invalid, timed beside its
   plain version, its floor and SDPA in float32 with the same mask;
8. main path of gim_roma: `Matcher("gim_roma")` at full width (DINOv2
   ViT-L/14, VGG19-bn, GP, 5-block decoder, five ConvRefiners, 672 ->
   1344 px, 5000 balanced samples) at the operating point (bf16): one
   warm-up and 3 timed calls of 1 pair, one call with content masks; 32 K2
   and 29 K3 launches asserted per call; stage times and a profile;
9. gim_roma's kernels against its plain graph, float32, TF32 off, 224 ->
   448 px: 32 K2 and 29 K3 float32 launches, none on the plain graph;
   warp and certainty agree;
10. main path of gim_dkm: `Matcher("gim_dkm")` at full width (ResNet-50
   pyramid, GP and DFN at 1/32 and 1/16, five ConvRefiners) at its
   operating point (bf16) on 1 pair of 840 x 840
   canvases with content masks of 840 x 630 (the ZEB protocol: 660 x 880
   -> 1152 x 1536, 5000 balanced samples): one warm-up and 3 timed calls,
   one call without masks (aspect-pad); 32 K2 launches asserted per call;
   stage times and a profile;
11. gim_dkm's K2 against its plain graph, float32, TF32 off, 240 x 320
   -> 384 x 512: 32 K2 float32 launches, none on the plain graph; warp and
   certainty agree;
12. ZEB geometry on the card: `eval.zeb.pair_metrics` (5-point RANSAC with
   the MAGSAC preset, pose errors) on 4 ground-truth scenes of 8192 slots
   (2000-8192 valid, 30 % and 60 % outliers), against the same call on
   the CPU with the card's uniforms; ms, host syncs, launches and peak
   memory of one call at batch 1; root_sift's device match against the
   CPU on seeded descriptors;
13. the ZEB path: `eval.zeb.evaluate` with the full-width gim_loftr
   matcher in float32 with fused matching (K1's float32 kernels), 8192
   slots at threshold 0, on 8 in-memory pairs of 840^2 canvases at batch
   1; one launch of each float32 sweep per pair asserted; ms per pair
   split into match and pair_metrics; the dump read back;
14. main path of gim_lightglue: `Matcher("gim_lightglue")` at full width
   (SuperPoint, 256-d descriptors, NMS radius 3, 2048 keypoints forced;
   LightGlue, 9 layers of width 256 and 4 heads, filter threshold 0.1) in
   float32 with TF32 off: one warm-up and 3 timed calls of 1 pair of 840^2
   canvases with 840 x 630 content masks, then 3 timed calls at ZEB's
   sweep batch of 16 (or the largest batch that fits); ms per pair,
   pairs/s, peak memory, stage times and a profile; 36 launches a call of
   K3's masked variant asserted (LightGlue's attention), none of K1, K2 or
   K3 itself;
15. gim_lightglue on the card against the CPU, same weights, inputs and
   pad uniforms, full depth at 320 px and 256 keypoints, filter threshold
   0, float32, TF32 off: keypoints and valid flags, log-assignment and
   matches agree; the card's call makes 36 masked flash launches;
16. the ZEB path of gim_lightglue: `eval.zeb.evaluate` on 16 in-memory
   840^2 pairs at the batch phase 14 settled on, filter threshold 0, the
   MAGSAC preset; ms per pair split into match and pair_metrics; the dump
   read back; 36 masked flash launches a match call, no other kernel;
17. gim_loftr's training step (the training CLI's `Trainer`, float32, TF32
   off, 1024 fine slots, `fused_matching=True` in the config, which
   training bypasses) on one 840^2 pair whose image 1 is image 0 with its
   halves moved 8 and 24 px, with 20000 labels: 3 warm-up and 5 timed
   steps; ms per step, pairs/s, peak memory, forward / loss / backward /
   optimizer ms and peak memory (CUDA events), busy share (profiler), each
   step's losses finite; no kernel launch asserted;
18. the training step on the card against the CPU: same weights, batch
   (2 pairs at 128 px, 512 labels) and GT-padding draws, in float64 and in
   float32: losses, every gradient leaf, the parameters after the update
   and the BatchNorm statistics agree;
19. the training loop on the card: the CLI's `train_loop` on in-memory
   batches, 4 steps at 256 px with a save at 2, then a resume from the
   step-2 checkpoint to 4 that equals the uninterrupted run (torch's
   deterministic mode); `Matcher.from_checkpoint` loads the result and
   matches a pair; one step under a one-process NCCL group equals the same
   step without a group;
20-22. the training steps of gim_dkm (672^2), gim_roma (672^2, full
   ViT-L/14) and gim_lightglue (1024^2, 2048 keypoints) through the
   training CLI's `Trainer` at the JAX CLI's operating points, float32,
   TF32 off, 20000 labels: 3 warm-up and 5 timed steps, ms per step,
   pairs/s, peak memory, stage times (CUDA events at forward hooks) and a
   profile; no kernel launch asserted (a step is never in inference mode);
23. each of those steps on the card against the CPU at the CPU tests'
   sizes and tolerances (the dense heads in a float64 config and in
   float32, gim_lightglue in float32);
24. each head's `train_loop` with a save at 2: the step-2 checkpoint
   restores the run's state exactly, and a resume to step 4 (torch's
   deterministic mode) equals the uninterrupted run bit for bit, losses
   and state, for every head, with no deterministic-mode warning naming
   `grid_sampler_2d_backward`; `Matcher.from_checkpoint` loads the result;
25. K1, K2, K3 and K3's masked variant on the card with inputs that need
   a gradient: forward
   against the plain version, and a backward that raises;
26. the sampling backward (`ops.sampling.BilinearSample`) on the inputs of
   one gim_dkm step at 672^2 (local correlation, warps) and one
   gim_lightglue step at 1024^2 (`sample_descriptors`): the same bits in
   two runs, against `aten.grid_sampler_2d_backward` within 1e-4 of the
   largest magnitude in float32 and 1e-12 in float64, ms and peak memory
   of both; then phases 20-22's step times, which ran with it;
27. ZEB across two processes on the one card: this script twice with
   `--zeb-worker`, in a gloo group, each running phase 13's matcher on its
   strided share of phase 13's pairs, the rows gathered through the
   group's store; rank 0's dump equals phase 13's row for row; each
   process's ms per pair and peak memory;
28. the video factory on frames given as arrays (the card's machine has no
   cv2): the full-width segmenter on 4 frames of 640 x 360 (ms per frame,
   peak memory; one frame against the CPU), the per-pair labelling body
   `cli.video_preprocessor.label_pair` with the full-width gim_dkm at 840
   in float32, K2 on, on the masked frames (labels kept, ms per stage), the
   fundamental filter (1024 hypotheses) at the matcher's label count and
   at 8192 planted labels against the CPU with the card's uniforms, and
   `Propagator.propagate_pair` over planted stores at skips 10/20/40
   (about 5000 labels a pair on 1280-wide frames) with the compiled chain
   linker, asserted to be the one that ran;
29. the hloc layer's matching on the card (`hloc/pipeline.py`,
   `hloc/reconstruction.py`) on 6 rendered views of 1280 x 960 (a numpy
   texture on two planes, warped by plane homographies through
   `F.grid_sample`), 15 exhaustive pairs: SuperPoint at resize_max 1920
   with 2048 keypoints and LightGlue on every pair (full width, seeded
   random weights); gim_dkm at 672 with 8192 samples and the aggregator;
   the COLMAP database on arrays with the fundamental verification on the
   card; ms per image and per pair of each stage, the aggregation's ms on
   the host, peak memory; one pair card against CPU (SuperPoint,
   LightGlue's matches0 at resize_max 640, the verification with the
   card's uniforms); the dense stage runs on the plain graph first, then
   with K2: K2 launches per pair asserted, keypoints against the
   plain-graph run, and K2's float32 kernel at each input shape that run
   gave it against its plain version at TOL_F32, timed beside its floor
   and FP32-FMA figure (printed: the `refiner_block_f32` entry takes phase
   6's times);
30. SfM on the card: `hloc/mapper.incremental_mapping_native` on the
   60-camera synthetic database of the JAX package's envelope test (400
   points, 1770 verified pairs, 0.3 px), asserting its bounds; a second
   run equal bit for bit, under the profiler (busy share) with host syncs
   counted; stage ms per registration; `ba_steps`, PnP with fixed row
   indices and `triangulate_tracks` card against CPU in float64.
31. gim_roma and gim_dkm in float32 at full width: one `Matcher.match`
   call each (phase 8's and phase 10's inputs, the heads' default dtype,
   TF32 off) with the counters set to 0 just before: 32 K2 and 29 K3
   launches for gim_roma, 32 K2 for gim_dkm, no masked K3.

Any failed phase makes the script exit nonzero. On success the last two
lines are the kernels' JSON summary and {"ok": true, "device": ...}. Its
entries: `dsmax_stats`, `dsmax_argmax` (times from phase 3, launches
from phase 4) and their `_f32` (phase 3, launches from phase 13);
`refiner_block` and `flash_attention` (bf16: times from phases 6 and 7,
launches from phases 8 and 10); `refiner_block_f32` and
`flash_attention_f32` (float32: times from phases 6 and 7, launches from
phase 31); `lightglue_attention` (K3's masked variant: times from
phase 7 at the ZEB sweep's batch of 16, with `batch1_*` keys at batch 1;
launches a call from phase 14).
Exits nonzero without a result when CUDA is not available or the package
is not beside the script.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W); exp2 on the
# MUFU: 16 a clock per SM on 132 SMs at the 1.83 GHz that 989 TFLOP/s
# implies (132 SMs x 4 tensor cores x 1024 bf16 FLOP a clock)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAK_EX2 = 16 * 132 * PEAK_BF16_FLOPS / (132 * 4 * 1024)
# float32 outside the tensor cores (data sheet, 67 TFLOP/s): 132 SMs x 128
# FP32 lanes x 2 FLOP at the 1.98 GHz boost clock; phase 3 prints the rate
# that the card's own maximum SM clock gives
PEAK_F32_FLOPS = 66.9e12
FP32_LANES_PER_SM = 128
# TF32 on the tensor cores (data sheet, dense): the float32 kernels' 3xTF32
# products take three of these per multiply-add
PEAK_TF32_FLOPS = 495e12

BATCH, IMG = 8, 832
TOL_BF16, TOL_F32, MIN_AGREE = 1e-2, 1e-4, 0.999
# K2 / K3 against their plain versions: bf16 as the JAX package's bf16
# flash test (tests/test_pallas_kernels.py), float32 as its f32 tests
RTOL_BF16, ATOL_BF16, TOL_ATTN_F32 = 0.05, 0.02, 2e-4

# gim_roma at the operating point: the refiner blocks K2 runs, 8 hidden
# blocks each (coarse pass 672 px, upsample pass 1344 px, 2 images)
HIDDEN_BLOCKS = 8
REFINER_SHAPES = ((2, 144, 336, 336), (2, 24, 672, 672), (2, 144, 672, 672),
                  (2, 24, 1344, 1344))
# K3: (G, N, D) and launches per call -- DINOv2 ViT-L (2 images x 16 heads,
# 48^2 + 1 tokens) and the coordinate decoder (2 x 8 heads, 48^2 tokens)
FLASH_SHAPES = (((32, 2305, 64), 24), ((16, 2304, 128), 5))
# K3 f32's masked variant at LightGlue's attention: (B, H, N, D) at batch
# 1 and 16 (2048 keypoint slots, 4 heads of 64), 36 launches a call (9
# layers x 2 self + 2 cross directions), about 5 % of the slots invalid
LG_ATTN_SHAPES = ((1, 4, 2048, 64), (16, 4, 2048, 64))
LG_ATTN_PER_CALL, LG_ATTN_INVALID = 36, 0.05
ROMA_IMG = 672
ROMA_K2_PER_CALL = 4 * HIDDEN_BLOCKS
# gim_dkm at the operating point: hidden blocks 144 (scale 2) and 24
# (scale 1) wide, at 660 x 880 and 1152 x 1536, 2 images; the ZEB canvas
# (gim_tpu/data/zeb.py:48) and a landscape image's content on it
DKM_REFINER_SHAPES = ((2, 144, 330, 440), (2, 24, 660, 880),
                      (2, 144, 576, 768), (2, 24, 1152, 1536))
DKM_K2_PER_CALL = 4 * HIDDEN_BLOCKS
DKM_CANVAS, DKM_CONTENT = 840, (630, 840)     # (h, w) of the content
ROMA_K3_PER_CALL = sum(n for _, n in FLASH_SHAPES)
SWITCH_TOL = 1e-3     # warp (normalized coordinates) and certainty
BF16_SWEEPS = ("dsmax_stats", "dsmax_argmax")
F32_SWEEPS = ("dsmax_stats_f32", "dsmax_argmax_f32")
# ZEB evaluation of gim_loftr (gim_tpu/cli/zeb_eval.py defaults): float32,
# fused matching, batch 1 of 840^2 canvases (the 840 x 630 content of a
# landscape image: 79 of 105 coarse rows), 8192 match slots, the MAGSAC
# preset (2048 hypotheses, PROSAC on the match confidences)
ZEB_CANVAS, ZEB_CONTENT = DKM_CANVAS, DKM_CONTENT
ZEB_MATCHES, ZEB_PAIRS = 8192, 8
# ground-truth scenes of phase 12: (valid slots, inlier share); pixel noise
# 0.1 px against RANSAC's 0.5 px threshold. With noise near the threshold
# the IRLS refits reach other local optima under rounding alone, in the
# JAX package too (its jitted and eager runs), so card and CPU are held
# to one optimum only where the problem has one
ZEB_SCENES = ((8192, 0.7), (2000, 0.4), (5000, 0.7), (8192, 0.4))
ZEB_NOISE_PX = 0.1
POSE_MAX_DEG, POSE_DIFF_DEG, MASK_AGREE = 2.0, 0.5, 0.99
# gim_lightglue: the ZEB canvas and content at batch 1 (the demo's and
# ZEB's size) and at the 12-benchmark sweep's batch of 16
# (gim_tpu/cli/sweep.py:52); its card-against-CPU check at 320 px with 256
# keypoints, where keypoints, valid flags and matches agree on >= 99 % of
# slots (scores within float32 rounding can rank the other way round) and
# the log-assignment within 1e-3 where the keypoints agree
LG_BATCH, LG_ZEB_PAIRS = 16, 16
LG_CHECK_IMG, LG_CHECK_KPTS = 320, 256
LG_AGREE, LG_TOL = 0.99, 1e-3
# gim_loftr's training (gim_tpu/cli/train.py's operating point): float32,
# TF32 off, 1024 fine slots, one pair of 840^2 images with 20000 labels
TRAIN_IMG, TRAIN_MATCHES, TRAIN_LABELS = 840, 1024, 20000
TRAIN_WARMUP, TRAIN_STEPS = 3, 5
# training card against CPU (phase 18): 2 pairs at 128 px, 64 slots, 512
# labels, in float64 and in float32 at tests/test_torch_train_step.py's
# tolerances (gradient leaf, all leaves; BatchNorm statistics; share of
# the parameters within 1e-2 lr after the update; losses)
CHECK_IMG, CHECK_MATCHES, CHECK_LABELS = 128, 64, 512
CHECK_TOL = {"float64": dict(loss=1e-6, grad=(1e-4, 1e-4), stats=1e-6,
                             share=0.999),
             "float32": dict(loss=1e-4, grad=(5e-2, 3e-2), stats=1e-4,
                             share=0.98)}
# the training loop (phase 19): 4 steps at 256 px with a save at 2
LOOP_IMG, LOOP_MATCHES, LOOP_LABELS, LOOP_STEPS = 256, 256, 2048, 4
# the later heads' training (phases 20-22) at the JAX CLI's operating points
# (gim_tpu/cli/train.py:84-117): one pair of gim_dkm at 672^2 (h_resized =
# w_resized = 672), gim_roma at 672^2 (coarse_res 672, full ViT-L/14) and
# gim_lightglue at 1024^2 (2048 keypoints forced), 20000 labels each
HEAD_TRAIN_IMG = {"gim_dkm": 672, "gim_roma": 672, "gim_lightglue": 1024}
# card against CPU (phase 23): each head at the CPU tests' sizes and
# tolerances (tests/test_torch_{dkm,roma,lightglue}_train.py: loss rtol,
# gradient per leaf and over all leaves, running statistics of each leaf's
# largest magnitude, share of the parameters within 1e-2 lr)
HEAD_CHECK = {"gim_dkm": (64, 2, 64), "gim_roma": (56, 2, 64),
              "gim_lightglue": (64, 2, 128)}      # image, pairs, labels
HEAD_CHECK_TOL = {
    "gim_dkm": dict(loss=1e-4, grad=(0.5, 3e-2), stats=1e-3, share=0.95),
    "gim_roma": dict(loss=1e-5, grad=(0.2, 1.5e-2), stats=3e-4, share=0.98),
    "gim_lightglue": dict(loss=1e-5, grad=(2e-3, 1e-5), stats=0.0,
                          share=0.999)}
# the later heads' training loop (phase 24): 4 steps with a save at 2
HEAD_LOOP_IMG = {"gim_dkm": 256, "gim_roma": 224, "gim_lightglue": 256}
# the sampling backward (phase 26), of the largest magnitude: float32
# against aten's float32 backward (source coordinates up to 672 pixels
# carry a float32 rounding of 6.1e-5 pixels, so the bilinear weights carry
# about 1e-5; 1.53e-5 measured on the warp), float64 against aten's float64
SAMPLE_TOL_F32, SAMPLE_TOL_F64 = 1e-4, 1e-12
# the factory (phase 28): 1280 x 720 video, frames at the segmenter's 640
# (gim_tpu/models/semseg.py:152), matched by gim_dkm at 840 (the factory's
# img_size); the fundamental filter also at 8192 planted labels; planted
# stores of 5000 tracks a pair; the segmenter's card-against-CPU tolerance
FACTORY_VIDEO_W, FACTORY_VIDEO_H = 1280, 720
FACTORY_FRAME, FACTORY_FRAMES, FACTORY_IMG = (360, 640), 4, 840
FACTORY_PLANTED, FACTORY_TRACKS = 8192, 5000
SEG_TOL = 1e-4
# the hloc layer (phase 29) at the reference's hloc confs: 6 views of
# 1280 x 960 (15 exhaustive pairs); SuperPoint at resize_max 1920 with 2048
# keypoints (ref hloc/extract_features.py:29-40), LightGlue over them;
# gim_dkm at 672 with 8192 samples, cells of 8 px, max_error 2 px, 8192
# canonical keypoints at most (ref hloc/match_dense.py:25-40); its
# card-against-CPU check of SuperPoint and LightGlue at resize_max 640
HLOC_VIEWS, HLOC_WH = 6, (1280, 960)
HLOC_RESIZE, HLOC_KPTS = 1920, 2048
HLOC_DENSE_IMG, HLOC_SAMPLES, HLOC_CELL, HLOC_MAX_ERROR = 672, 8192, 8, 2.0
HLOC_MAX_KPS, HLOC_CHECK_RESIZE = 8192, 640
# SfM (phase 30) at the JAX package's envelope test (tests/test_mapper.py
# test_sixty_image_scene): 60 cameras, 400 points, 0.3 px noise, seed 1;
# its bounds; card against CPU in float64 to SFM_TOL relative
SFM_CAMS, SFM_POINTS, SFM_NOISE, SFM_SEED = 60, 400, 0.3, 1
SFM_CENTRE_TOL, SFM_STRUCT_TOL, SFM_MIN_POINTS, SFM_TOL = 0.08, 0.02, 200, 1e-9


def nvidia_smi(query: str = "name,power.limit", units: bool = True) -> str:
    fmt = "csv,noheader" + ("" if units else ",nounits")
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def refiner_block_params(C: int, C_out: int, dtype, g):
    """A random ConvRefiner block on the card (depthwise 5x5, BN with
    running statistics, ReLU, 1x1 C -> C_out) drawn from the generator `g`,
    and its folded K2 inputs in `dtype`."""
    import torch
    from torch import nn

    from gim_tpu_torch.ops.kernels.refiner import fold_block_params

    dev = g.device
    blk = nn.Sequential(
        nn.Conv2d(C, C, 5, padding=2, groups=C), nn.BatchNorm2d(C),
        nn.ReLU(), nn.Conv2d(C, C_out, 1)).to(dev)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, device=dev, generator=g)
                    / (p[0].numel() ** 0.5 if p.dim() > 1 else 4.0))
        blk[1].weight.add_(1.0)
        blk[1].running_mean.normal_(0.0, 0.1, generator=g)
        blk[1].running_var.uniform_(0.5, 1.5, generator=g)
    blk.eval().requires_grad_(False)
    folded = [t.to(dtype).contiguous()
              for t in fold_block_params(blk[0], blk[1], blk[3])]
    return blk, folded


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls after one warm-up, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_terms(flops: float, nbytes: float, exps: float = 0.0,
                peak: float = PEAK_BF16_FLOPS):
    """Least ms for each resource: products at `peak` (bf16 tensor cores by
    default; PEAK_F32_FLOPS for float32 FMA), MUFU exp2s and device-memory
    bytes."""
    return {"products": flops / peak * 1e3,
            "exp2": exps / PEAK_EX2 * 1e3, "bytes": nbytes / PEAK_BYTES * 1e3}


def bound(flops: float, nbytes: float, exps: float = 0.0,
          peak: float = PEAK_BF16_FLOPS):
    """Least ms: the largest of the terms, and whether operations
    (products, exp2s) or bytes set it."""
    terms = bound_terms(flops, nbytes, exps, peak)
    top = max(terms, key=terms.get)
    return terms[top], "bytes" if top == "bytes" else "operations"


def k2_f32_bounds(B: int, C: int, C_out: int, H: int, W: int):
    """K2's float32 kernel on (B, C, H, W) -> C_out: (floor ms, what sets
    it, FP32-FMA ms). The floor is the larger of the bytes (x read, out
    written, the parameters once) at PEAK_BYTES and the depthwise's FP32
    FMAs at PEAK_F32_FLOPS plus the 1x1's three TF32 products at
    PEAK_TF32_FLOPS; the FP32-FMA figure takes every FLOP at
    PEAK_F32_FLOPS (or the bytes, where larger)."""
    px = B * H * W
    dw, pw = 2.0 * px * 25 * C, 2.0 * px * C * C_out
    nbytes = 4.0 * px * (C + C_out) + 4.0 * (27 * C + C * C_out + C_out)
    ops_ms = (dw / PEAK_F32_FLOPS + 3 * pw / PEAK_TF32_FLOPS) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    floor = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                                "bytes")
    return floor[0], floor[1], max((dw + pw) / PEAK_F32_FLOPS * 1e3,
                                   bytes_ms)


def k3_f32_bounds(G: int, N: int, D: int):
    """K3's float32 kernel on G heads of (N, D): (floor ms, FP32-FMA ms).
    The floor is the three TF32 products of 4 G N^2 D FLOP at
    PEAK_TF32_FLOPS (exps and bytes are far below it); the FP32-FMA
    figure takes the 4 G N^2 D FLOP at PEAK_F32_FLOPS."""
    flops = 4.0 * G * N * N * D
    return 3 * flops / PEAK_TF32_FLOPS * 1e3, flops / PEAK_F32_FLOPS * 1e3


def sweep_costs(B: int, L: int, S: int, C: int, n_blocks: int,
                elt: int = 2, chunks: int = 1):
    """Work of each K1 sweep over (B, L, C) x (B, S, C) features of `elt`
    bytes: product FLOPs, exp2s, bytes (each input read once, each output
    written once: row partials over `chunks` chunks of S, column partials
    over `n_blocks` row blocks) of the stats and the argmax sweep. Stats
    take two exp2s per score (row side and column side); argmax none."""
    flops = 2.0 * B * L * S * C
    inputs = elt * B * (L + S) * C + 4.0 * B * (L + S)      # features, masks
    outputs = 2 * 4.0 * B * L * chunks + 2 * 4.0 * B * n_blocks * S
    return {"dsmax_stats": (flops, 2.0 * B * L * S, inputs + outputs),
            "dsmax_argmax": (flops, 0.0,
                             inputs + 4.0 * B * (L + S) + outputs)}


class Smoke:
    def __init__(self):
        self.failed: list[str] = []
        self.kernels: dict[str, dict] = {}
        self.card = ""
        self.dev = "cuda"     # phases 12-16 read it; main() needs CUDA
        self.lg_batch = LG_BATCH      # phase 14 settles it, 16 reads it
        self.zeb_dump = None          # phase 13 writes it, 27 reads it
        self.head_step_ms = {}        # phases 20-22 write them, 26 reads

    def phase(self, name, fn):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
            print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        except Exception:  # report every phase, fail at the end
            traceback.print_exc(file=sys.stdout)
            print(f"== {name}: FAILED", flush=True)
            self.failed.append(name)

    # -- 1 ------------------------------------------------------------------
    def environment(self):
        import torch

        from gim_tpu_torch.utils.device import set_tf32

        set_tf32(False)
        self.card = nvidia_smi()
        print(f"card: {self.card}")
        print(f"python {sys.version.split()[0]} torch {torch.__version__} "
              f"cuda {torch.version.cuda} device "
              f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} cudnn "
              f"{torch.backends.cudnn.allow_tf32}")

    # -- 2 ------------------------------------------------------------------
    def build(self):
        from gim_tpu_torch.ops.kernels.build import build_all

        t0 = time.perf_counter()
        logs = build_all()
        print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line or "Compiling" in line:
                    print(f"  {name}: {line.strip()}")

    # -- 3 ------------------------------------------------------------------
    def kernels_vs_plain(self):
        import torch

        from gim_tpu_torch.ops.kernels import dsmax as K

        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(0)
        B, L, C = BATCH, (IMG // 8) ** 2, 256
        hc = IMG // 8

        def feats(b, l, s, dtype):
            f0 = torch.randn(b, l, C, device=dev, generator=g) / C ** 0.25
            f1 = torch.randn(b, s, C, device=dev, generator=g) / C ** 0.25
            return f0.to(dtype), f1.to(dtype)

        def agreement(label, got, want, valid, tol, exact=False):
            jb, cf, mu = got
            wjb, wcf, wmu = want
            v = valid if valid is not None else torch.ones_like(wmu)
            n = int(v.sum())
            j_ok = (jb == wjb) & v
            j_share = float(j_ok.sum()) / n
            m_share = float(((mu == wmu) & v).sum()) / n
            both = j_ok & (wcf > 0)
            rel = float(((cf - wcf).abs() / wcf)[both].max())
            print(f"  {label}: rows {n}, j_best agrees {j_share:.6f}, mutual "
                  f"agrees {m_share:.6f}, max rel conf diff {rel:.3e} "
                  f"(limit {'exact' if exact else MIN_AGREE}, conf {tol})")
            need = 1.0 if exact else MIN_AGREE
            assert j_share >= need and m_share >= need and rel <= tol, label

        print("  (near-ties may flip under another summation order; the "
              "limits allow 0.1 % of rows for that)")
        # well separated: f1 is a permutation of f0 plus small noise
        f0 = torch.randn(B, L, C, device=dev, generator=g) / C ** 0.25
        perm = torch.randperm(L, device=dev, generator=g)
        f1 = f0[:, perm] + 0.05 * torch.randn(B, L, C, device=dev,
                                              generator=g) / C ** 0.25
        f0, f1 = f0.bfloat16(), f1.bfloat16()
        agreement("bf16 separated", K.dual_softmax_mutual(f0, f1, 0.1),
                  K.dual_softmax_mutual_plain(f0, f1, 0.1), None, TOL_BF16,
                  exact=True)

        f0, f1 = feats(B, L, L, torch.bfloat16)
        agreement("bf16 random", K.dual_softmax_mutual(f0, f1, 0.1),
                  K.dual_softmax_mutual_plain(f0, f1, 0.1), None, TOL_BF16)

        # ~25 % masked cells, plus one whole grid row and grid column
        grid = torch.rand(B, hc, hc, device=dev, generator=g) > 0.25
        grid[:, hc // 2, :] = False
        grid[:, :, hc // 3] = False
        m0 = grid.reshape(B, L)
        m1 = torch.roll(grid, 1, dims=0).reshape(B, L)
        print(f"  masked share {1 - float(m0.float().mean()):.3f}")
        agreement("bf16 masked", K.dual_softmax_mutual(f0, f1, 0.1, m0, m1),
                  K.dual_softmax_mutual_plain(f0, f1, 0.1, m0, m1), m0,
                  TOL_BF16)

        sms = torch.cuda.get_device_properties(0).multi_processor_count

        def chunks_of(f0, f1):
            return K.sweep_chunks(f0.dtype, f0.shape[0], f0.shape[1],
                                  f1.shape[1], sms)

        def sweeps(label, f0, f1, m0f, m1f, inv_t):
            """Each sweep against its plain version on the same inputs, in
            the kernel's layout (row partials over the wrapper's chunks of
            S, column partials over row blocks): log-domain statistics
            within 1e-3, indices on >= 99.9 % of row and column partials.
            Returns the two errors, the argmax sweep's terms and both
            sweeps' partials (kernel, plain)."""
            n = chunks_of(f0, f1)
            ks = K.stats_sweep(f0, f1, m0f, m1f, inv_t, n)
            ps = K.dsmax_stats_plain(f0, f1, m0f, m1f, inv_t, chunks=n)
            assert [k.shape for k in ks] == [p.shape for p in ps], label
            err_s = max(float((ks[0] - ps[0]).abs().max()),
                        float((ks[1].log() - ps[1].log()).abs().max()),
                        float((ks[2] - ps[2]).abs().max()),
                        float((ks[3].log() - ps[3].log()).abs().max()))
            rmax, rsum = K.merge_row_stats(ps[0], ps[1])
            rowterm = torch.where(m0f > 0, rmax + rsum.log(),
                                  0.0).contiguous()
            cmax = ps[2].amax(1)
            csum = (ps[3] * torch.exp(ps[2] - cmax[:, None])).sum(1)
            colterm = torch.where(m1f > 0, cmax + csum.clamp_min(1e-30).log(),
                                  0.0).contiguous()
            ka = K.argmax_sweep(f0, f1, m0f, m1f, colterm, rowterm, inv_t, n)
            pa = K.dsmax_argmax_plain(f0, f1, m0f, m1f, colterm, rowterm,
                                      inv_t, chunks=n)
            j_eq = ka[0] == pa[0]
            i_eq = ka[2] == pa[2]
            j_share = float(j_eq.float().mean())
            i_share = float(i_eq.float().mean())
            err_a = max(float((ka[1] - pa[1])[j_eq].abs().max()),
                        float((ka[3] - pa[3])[i_eq].abs().max()))
            print(f"  {label}: dsmax_stats max abs err of the log-domain "
                  f"statistics {err_s:.3e} (limit 1e-3); dsmax_argmax row "
                  f"index agrees {j_share:.6f}, column partial index agrees "
                  f"{i_share:.6f}, max abs err of the maxima {err_a:.3e} "
                  f"(limits {MIN_AGREE}, 1e-3); {ks[2].shape[1]} row blocks x "
                  f"{n} chunks of S")
            assert err_s <= 1e-3, label
            assert j_share >= MIN_AGREE and i_share >= MIN_AGREE, label
            assert err_a <= 1e-3, label
            return err_s, err_a, colterm, rowterm, (ka, pa)

        def timed(label, f0, f1, m0f, m1f, colterm, rowterm, inv_t,
                  plain=False):
            """Each sweep's ms beside its bound (products, exp2s, bytes)
            and torch.bmm of the same f0 f1^T; the plain versions' ms too
            when `plain`."""
            b, l, c = f0.shape
            s = f1.shape[1]
            n = -(-l // K.block_rows(f0.dtype))
            ch = chunks_of(f0, f1)
            f32 = f0.dtype == torch.float32
            peak = PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS
            t_lib = cuda_ms(lambda: torch.bmm(f0, f1.transpose(1, 2)), 10)
            out = {}
            for name, kfn, pfn in (
                    ("dsmax_stats",
                     lambda: K.stats_sweep(f0, f1, m0f, m1f, inv_t, ch),
                     lambda: K.dsmax_stats_plain(f0, f1, m0f, m1f, inv_t,
                                                 chunks=ch)),
                    ("dsmax_argmax",
                     lambda: K.argmax_sweep(f0, f1, m0f, m1f, colterm,
                                            rowterm, inv_t, ch),
                     lambda: K.dsmax_argmax_plain(f0, f1, m0f, m1f, colterm,
                                                  rowterm, inv_t,
                                                  chunks=ch))):
                flops, exps, nbytes = sweep_costs(b, l, s, c, n,
                                                  4 if f32 else 2, ch)[name]
                t_k = cuda_ms(kfn, 10)
                t_p = cuda_ms(pfn, 2) if plain else None
                terms = bound_terms(flops, nbytes, exps, peak)
                b_ms, b_by = bound(flops, nbytes, exps, peak)
                top = max(terms, key=terms.get)
                print(f"  {label} {name}{'_f32' if f32 else ''}: kernel "
                      f"{t_k:.3f} ms, "
                      f"{flops / t_k / 1e9:.1f} TFLOP/s, {t_k / b_ms:.2f}x "
                      f"its bound {b_ms:.3f} ms (set by {top}: products "
                      f"{terms['products']:.3f}, exp2 {terms['exp2']:.3f}, "
                      f"bytes {terms['bytes']:.3f}), {t_k / t_lib:.2f}x "
                      f"torch.bmm {t_lib:.3f} ms"
                      + (f", plain {t_p:.3f} ms" if plain else "")
                      + f" [{self.card}]")
                out[name] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=t_lib)
            return out

        # main-path shapes, masked inputs
        m0f, m1f = m0.float(), m1.float()
        inv_t = 10.0
        err_s, err_a, colterm, rowterm, _ = sweeps(
            f"bf16 masked {tuple(f0.shape)}", f0, f1, m0f, m1f, inv_t)

        def ragged_cases(kind, dtype, s_main, tol, gen):
            """Ragged cases: L and S not multiples of the kernels' blocks
            or tiles; C < 64 (bf16: a zero-filled 64-column box); one
            partial f0 block against the main path's S, masked. Each
            against the dense recipe and its plain sweeps; returns the
            timing arguments."""
            out = []
            for b, l, s, c, masked in ((2, 1000, 1300, 256, False),
                                       (1, 70, 90, 32, True),
                                       (1, 100, s_main, 256, True)):
                r0 = (torch.randn(b, l, c, device=dev, generator=gen)
                      / c ** 0.25).to(dtype)
                r1 = (torch.randn(b, s, c, device=dev, generator=gen)
                      / c ** 0.25).to(dtype)
                rm0 = rm1 = None
                if masked:
                    rm0 = torch.rand(b, l, device=dev, generator=gen) > 0.25
                    rm1 = torch.rand(b, s, device=dev, generator=gen) > 0.25
                label = (f"{kind} ragged {(b, l, s, c)}"
                         f"{' masked' if masked else ''}")
                agreement(label, K.dual_softmax_mutual(r0, r1, 0.1, rm0, rm1),
                          K.dual_softmax_mutual_plain(r0, r1, 0.1, rm0, rm1),
                          rm0, tol)
                rm0f = (torch.ones(b, l, device=dev) if rm0 is None
                        else rm0.float())
                rm1f = (torch.ones(b, s, device=dev) if rm1 is None
                        else rm1.float())
                _, _, ct, rt, _ = sweeps(label, r0, r1, rm0f, rm1f, inv_t)
                out.append((label, r0, r1, rm0f, rm1f, ct, rt))
            return out

        # ragged bf16 cases through the wgmma path (64-row tiles)
        ragged = ragged_cases("bf16", torch.bfloat16, L, TOL_BF16, g)

        # timings: main-path shapes, then the ragged cases
        main = timed(f"bf16 {tuple(f0.shape)} x {tuple(f1.shape)}", f0, f1,
                     m0f, m1f, colterm, rowterm, inv_t, plain=True)
        for name, t in main.items():
            self.kernels[name] = {
                "name": name, "route": "cuda",
                "source": "gim_tpu_torch/csrc/dsmax.cu",
                "replaces": ("gim_tpu/ops/pallas_kernels/dsmax.py:48"
                             if name == "dsmax_stats" else
                             "gim_tpu/ops/pallas_kernels/dsmax.py:80"),
                "launches": 0, "max_abs_err": err_s if name == "dsmax_stats"
                else err_a, **t}
        for label, *args in ragged:
            timed(label, *args, inv_t)
        t_all = cuda_ms(lambda: K.dual_softmax_mutual(f0, f1, 0.1, m0, m1), 5)
        t_dense = cuda_ms(lambda: K.dual_softmax_mutual_plain(
            f0, f1, 0.1, m0, m1), 2)
        print(f"  dual_softmax_mutual (2 sweeps + reductions) {t_all:.3f} ms, "
              f"dense plain {t_dense:.3f} ms [{self.card}]")
        block = K.block_rows(f0.dtype)
        n_blocks = -(-L // block)
        print(f"  partials: {4 * B * n_blocks * L * 4 / 1e6:.1f} MB for "
              f"{n_blocks} row blocks of {block}")
        self.k1_f32(feats, agreement, sweeps, timed, inv_t, chunks_of,
                    ragged_cases)

    def k1_f32(self, feats, agreement, sweeps, timed, inv_t, chunks_of,
               ragged_cases):
        """K1's float32 kernels (the ZEB path, phase 13) at the bf16
        cases' breadth: ragged shapes, masked and not, one partial f0 block
        against ZEB's S; planted ties across a chunk border and a row-block
        border; ZEB's shape, one pair of 840^2 canvases, 105^2 coarse
        cells, C = 256, the content mask of 840 x 630 (79 of 105 rows) on
        both images, timed."""
        import torch

        from gim_tpu_torch.ops.kernels import dsmax as K

        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(7)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        clock = nvidia_smi("clocks.max.sm", units=False)
        try:
            rate = sms * FP32_LANES_PER_SM * 2 * float(clock) * 1e6
            print(f"  FP32 FMA peak from the card's clock: {sms} SMs x "
                  f"{FP32_LANES_PER_SM} lanes x 2 x {clock} MHz = "
                  f"{rate / 1e12:.1f} TFLOP/s (bound uses "
                  f"{PEAK_F32_FLOPS / 1e12:.1f})")
        except ValueError:
            print(f"  FP32 FMA peak: clock not read ({clock})")
        hc = ZEB_CANVAS // 8
        L = hc * hc
        ragged = ragged_cases("f32", torch.float32, L, TOL_F32, g)

        self.k1_f32_ties(agreement, sweeps, inv_t, chunks_of, g)

        z0, z1 = feats(1, L, L, torch.float32)
        rows = -(-ZEB_CONTENT[0] // 8)
        zm = (torch.arange(L, device=z0.device) < rows * hc)[None]
        zmf = zm.float()
        n = chunks_of(z0, z1)
        n_rb = -(-L // K.block_rows(z0.dtype))
        print(f"  f32 ZEB grid: {n_rb} row blocks x {n} chunks of "
              f"{K.chunk_span(L, n)} columns = {n_rb * n} blocks on {sms} "
              f"SMs ({n_rb * n / sms:.3f} waves)")
        label = f"f32 ZEB {tuple(z0.shape)} masked ({rows} of {hc} rows)"
        agreement(label, K.dual_softmax_mutual(z0, z1, 0.1, zm, zm),
                  K.dual_softmax_mutual_plain(z0, z1, 0.1, zm, zm), zm,
                  TOL_F32)
        err_s, err_a, ct, rt, _ = sweeps(label, z0, z1, zmf, zmf, inv_t)
        for name, t in timed(label, z0, z1, zmf, zmf, ct, rt, inv_t,
                             plain=True).items():
            self.kernels[name + "_f32"] = {
                "name": name + "_f32", "route": "cuda",
                "source": "gim_tpu_torch/csrc/dsmax.cu",
                "replaces": ("gim_tpu/ops/pallas_kernels/dsmax.py:48"
                             if name == "dsmax_stats" else
                             "gim_tpu/ops/pallas_kernels/dsmax.py:80"),
                "launches": 0, "max_abs_err": err_s
                if name == "dsmax_stats" else err_a, **t}
        for label, *args in ragged:
            timed(label, *args, inv_t)

    def k1_f32_ties(self, agreement, sweeps, inv_t, chunks_of, g):
        """Planted ties through the float32 kernels, against the plain
        sweeps and the dense recipe, exact: a row whose two best columns
        lie in different chunks of S, and a column whose two best rows lie
        in different row blocks; both go to the first index."""
        import torch

        from gim_tpu_torch.ops.kernels import dsmax as K

        dev = torch.device("cuda")
        n, c = 1300, 256
        f0 = torch.randn(1, n, c, device=dev, generator=g) / c ** 0.25
        perm = torch.randperm(n, device=dev, generator=g)
        f1 = f0[:, perm] + 0.05 * torch.randn(1, n, c, device=dev,
                                              generator=g) / c ** 0.25
        ch = chunks_of(f0, f1)
        span = K.chunk_span(n, ch)
        i1, i2 = 5, 1000                  # row blocks 0 and 7
        j1 = next(j for j in range(100, n) if int(perm[j]) not in (i1, i2))
        j2 = next(j for j in range(j1 + span, n)
                  if int(perm[j]) not in (i1, i2))
        f0[:, i2] = f0[:, i1]
        f1[:, j2] = f1[:, j1]
        assert j1 // span != j2 // span and ch > 1, (ch, span, j1, j2)
        got = K.dual_softmax_mutual(f0, f1, 0.1)
        agreement(f"f32 planted ties (1, {n}, {n}, {c}): columns {j1}, {j2} "
                  f"in chunks {j1 // span}, {j2 // span} of {ch}; rows {i1}, "
                  f"{i2} in blocks {i1 // 128}, {i2 // 128}", got,
                  K.dual_softmax_mutual_plain(f0, f1, 0.1), None, TOL_F32,
                  exact=True)
        jb, _, mu = got
        row = int(perm[j1])
        col = int((perm == i1).nonzero()[0, 0])
        assert int(jb[0, row]) == j1 and bool(mu[0, row]), (row, j1)
        assert int(jb[0, i1]) == int(jb[0, i2]) == col, (i1, i2, col)
        assert bool(mu[0, i1]) and not bool(mu[0, i2]), (i1, i2)
        ones = torch.ones(1, n, device=dev)
        *_, (ka, pa) = sweeps("f32 planted ties", f0, f1, ones, ones, inv_t)
        k_row = K.merge_row_argmax(ka[0], ka[1])[0]
        p_row = K.merge_row_argmax(pa[0], pa[1])[0]
        ib_k = ka[2].gather(1, ka[3].argmax(1, keepdim=True))[:, 0]
        ib_p = pa[2].gather(1, pa[3].argmax(1, keepdim=True))[:, 0]
        assert torch.equal(k_row, p_row) and int(k_row[0, row]) == j1
        assert torch.equal(ib_k, ib_p) and int(ib_k[0, col]) == i1
        print(f"  f32 planted ties: row {row} -> column {j1} (not {j2}), "
              f"column {col} -> row {i1} (not {i2}), kernel and plain "
              f"sweeps identical on every row and column")

    # -- 4 ------------------------------------------------------------------
    def main_path(self):
        import torch

        from gim_tpu_torch.api import Matcher
        from gim_tpu_torch.config import GimConfig, LoFTRConfig
        from gim_tpu_torch.ops.kernels import dsmax as K

        dev = torch.device("cuda")
        cfg = GimConfig(loftr=LoFTRConfig(dtype="bfloat16",
                                          fused_matching=True,
                                          max_matches=2048))
        t0 = time.perf_counter()
        m = Matcher("gim_loftr", cfg, generator=torch.Generator()
                    .manual_seed(0), device="cuda")
        print(f"  matcher built in {time.perf_counter() - t0:.1f} s")
        g = torch.Generator(device=dev).manual_seed(1)
        shape = (BATCH, 3, IMG, IMG)
        batches = [(torch.rand(shape, device=dev, generator=g),
                    torch.rand(shape, device=dev, generator=g))
                   for _ in range(3)]
        sane = Matcher("gim_loftr", GimConfig(loftr=LoFTRConfig(
            dtype="bfloat16", fused_matching=True, max_matches=2048,
            match_threshold=0.0)), state_dict=m.model.state_dict(),
            device="cuda")

        def check(r):
            assert r.kpts0.shape == (BATCH, 2048, 2), r.kpts0.shape
            assert r.kpts1.shape == (BATCH, 2048, 2)
            for t in (r.kpts0, r.kpts1, r.conf):
                assert bool(torch.isfinite(t).all())

        for k in K.LAUNCHES:
            K.LAUNCHES[k] = 0
        calls = 0
        m.match(*batches[0])                      # warm-up
        calls += 1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for a, b in batches:
            t0 = time.perf_counter()
            r = m.match(a, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            calls += 1
            check(r)
            for k in BF16_SWEEPS:
                assert K.LAUNCHES[k] == calls, (k, K.LAUNCHES[k], calls)
        peak = torch.cuda.max_memory_allocated()

        # content masks: 832 x 624 content on the 832 x 832 canvas
        mask = torch.zeros(BATCH, IMG, IMG, dtype=torch.bool, device=dev)
        mask[:, :, :624] = True
        a, b = batches[0]
        r = m.match(a * mask[:, None], b * mask[:, None], mask0=mask,
                    mask1=mask)
        calls += 1
        check(r)
        rs = sane.match(a * mask[:, None], b * mask[:, None], mask0=mask,
                        mask1=mask)
        calls += 1
        check(rs)
        inside = rs.kpts0[rs.valid][:, 0] < 624 - 2 * 8
        print(f"  masked batch: {int(r.valid.sum())} valid at threshold "
              f"0.2, {int(rs.valid.sum())} at 0.0, all inside the content "
              f"border: {bool(inside.all())}")
        assert bool(inside.all()) and int(rs.valid.sum()) > 0

        # identical images: most valid matches pair a cell with itself
        r = sane.match(a, a)
        calls += 1
        check(r)
        d = (r.kpts1 - r.kpts0).abs()[r.valid]
        same = float((d < 4.0).all(-1).float().mean())
        print(f"  identical batch: {int(r.valid.sum())} valid matches, "
              f"share with i == j {same:.4f} (limit 0.9)")
        assert int(r.valid.sum()) >= 8 and same >= 0.9
        counts = {k: K.LAUNCHES[k] for k in BF16_SWEEPS}
        for k, n in counts.items():
            assert n == calls, (k, n, calls)
            self.kernels[k]["launches"] = n
        assert all(K.LAUNCHES[k] == 0 for k in F32_SWEEPS), K.LAUNCHES

        ms = statistics.median(times) * 1e3
        print(f"  main path: {calls} match calls, K1 launches {counts}")
        print(f"  batch {BATCH} x {IMG} px bf16 fused: median {ms:.2f} ms "
              f"per batch (runs {[round(t * 1e3, 2) for t in times]}), "
              f"{BATCH / (ms / 1e3):.3f} pairs/s, peak memory "
              f"{peak / 2**30:.2f} GiB [{self.card}]")
        self.stages(m, batches[1])
        self.profile(lambda: m.match(*batches[2]))
        self.upsample_forms(m, batches)

    def upsample_forms(self, m, batches):
        """`m.match` on this phase's batches with the FPN's upsampling as
        the port runs it (two products with interpolation operators,
        `backbone.upsample2x`, the JAX package's form) and with
        F.interpolate's bilinear kernel in its place, in the order port,
        interpolate, interpolate, port (a warm-up call before each): the
        measurement behind the port's one form."""
        import torch
        import torch.nn.functional as F

        from gim_tpu_torch.models.loftr import backbone as BB

        port = BB.upsample2x

        def interpolate(x):
            return F.interpolate(x, scale_factor=2, mode="bilinear",
                                 align_corners=True)

        times = {"matmul": [], "interpolate": []}
        try:
            for form in ("matmul", "interpolate", "interpolate", "matmul"):
                BB.upsample2x = port if form == "matmul" else interpolate
                m.match(*batches[0])
                torch.cuda.synchronize()
                for a, b in batches:
                    t0 = time.perf_counter()
                    m.match(a, b)
                    torch.cuda.synchronize()
                    times[form].append(time.perf_counter() - t0)
        finally:
            BB.upsample2x = port
        med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
        print(f"  FPN upsampling, batch {BATCH} x {IMG} px bf16: matrix "
              f"form (the port's) median {med['matmul']:.2f} ms per batch "
              f"(runs {[round(t * 1e3, 2) for t in times['matmul']]}), "
              f"F.interpolate {med['interpolate']:.2f} ms (runs "
              f"{[round(t * 1e3, 2) for t in times['interpolate']]}), "
              f"ratio {med['matmul'] / med['interpolate']:.4f} "
              f"[{self.card}]")

    def timed_call(self, m, args, mods):
        """One `m.match(*args)` with a CUDA event recorded where each of
        `mods` (name: module) starts and ends its forward, a list per name
        (a module that runs twice has four). Returns the events, the
        call's end event and the call's time on the card's stream."""
        import torch

        ev: dict[str, list] = {k: [] for k in mods}

        def mark(key):
            def hook(*_):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                ev[key].append(e)
            return hook

        handles = []
        for name, mod in mods.items():
            handles.append(mod.register_forward_pre_hook(mark(name)))
            handles.append(mod.register_forward_hook(mark(name)))
        try:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m.match(*args)
            end.record()
            torch.cuda.synchronize()
        finally:
            for h in handles:
                h.remove()
        return ev, end, start.elapsed_time(end)

    def print_stages(self, what, spans, total, rest):
        """Print `spans` (name: ms) of one call of `total` ms, the rest
        of the call under the name `rest`."""
        spans[rest] = total - sum(spans.values())
        print(f"  stages of {what}, {total:.2f} ms on the stream "
              f"[{self.card}]:")
        for name, t in spans.items():
            print(f"    {t:9.3f} ms  {t / total:6.3f}  {name}")

    def stages(self, m, batch):
        """Time on the card's stream between the start and end of each
        stage of one batch; the coarse matching is the gap between the
        coarse transformer and the fine windows."""
        model = m.model
        mods = {"backbone": model.backbone,
                "coarse transformer": model.loftr_coarse,
                "fine windows": model.fine_preprocess,
                "fine transformer": model.loftr_fine}
        ev, _, total = self.timed_call(m, batch, mods)
        spans = {name: ev[name][0].elapsed_time(ev[name][1])
                 for name in mods}
        spans["coarse matching (K1, top-k)"] = ev[
            "coarse transformer"][1].elapsed_time(ev["fine windows"][0])
        self.print_stages("one batch", spans, total,
                          "rest (input cast, expectation, coordinates)")

    def profile(self, fn, top: int = 20, long_window: bool = False):
        """Device time by kernel for one `fn()`. Informational: a profiler
        that cannot trace the card is reported, not a failed phase. With
        `long_window` only the device's activities are traced and no table
        by kernel is built, which cuts the post-processing of a window with
        many launches.

        The busy share is the union of the device activities' intervals
        (kernels, copies, sets; not the profiler's annotation ranges) over
        the host window, so time where two of them run at once counts
        once. Printed beside it: the plain sum of their times, the part of
        it that overlaps another activity, and the activities per stream.
        Returns (device launches, busy device ms, window ms), or None."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CUDA] + (
                    [] if long_window else [ProfilerActivity.CPU])) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            acts = sorted((e.start_ns(), e.end_ns(), e.device_resource_id())
                          for e in prof.profiler.kineto_results.events()
                          if e.device_type() == DeviceType.CUDA
                          and not e.is_user_annotation()
                          and e.end_ns() > e.start_ns())
            rows = []   # kernels only: operator rows repeat their time
            for e in (() if long_window else prof.key_averages()):
                t = e.self_device_time_total
                if (e.device_type == DeviceType.CUDA and t > 0
                        and not getattr(e, "is_user_annotation", False)):
                    rows.append((t, e.key, e.count))
        except Exception as e:  # noqa: BLE001
            print(f"  profile: not measured ({type(e).__name__}: {e})")
            return None
        if not acts:
            print("  profile: not measured (the profiler saw no device time)")
            return None
        busy = overlap = total = 0        # ns
        end = -1
        streams = collections.Counter()
        for a, b, stream in acts:
            total += b - a
            overlap += max(min(b, end) - a, 0)
            busy += max(b - max(a, end), 0)
            end = max(end, b)
            streams[stream] += 1
        rows.sort(reverse=True)
        print(f"  profile: {len(acts)} device activities, busy "
              f"{busy / 1e6:.2f} ms in a {wall * 1e3:.2f} ms window, busy "
              f"share {busy / 1e9 / wall:.3f}; their times sum to "
              f"{total / 1e6:.2f} ms, of which {overlap / 1e6:.2f} ms "
              f"overlap another; per stream {dict(streams)} [{self.card}]")
        for t, key, n in rows[:top]:
            print(f"    {t / 1e3:9.3f} ms  {n:5d}x  {key[:90]}")
        return len(acts), busy / 1e6, wall * 1e3

    # -- 5 ------------------------------------------------------------------
    def fused_vs_dense(self):
        import torch

        from gim_tpu_torch.api import Matcher
        from gim_tpu_torch.config import GimConfig, LoFTRConfig

        base = Matcher("gim_loftr", GimConfig(), generator=torch.Generator()
                       .manual_seed(0), device="cuda")
        g = torch.Generator(device="cuda").manual_seed(2)
        a = torch.rand(2, 3, 320, 320, device="cuda", generator=g)
        sets = {}
        for fused in (True, False):
            cfg = GimConfig(loftr=LoFTRConfig(fused_matching=fused,
                                              match_threshold=0.0,
                                              max_matches=512))
            mm = Matcher("gim_loftr", cfg, state_dict=base.model.state_dict(),
                         device="cuda")
            with torch.inference_mode():
                out = mm.model(a, a)
            v = out["valid"].cpu()
            ij = torch.stack([out["i_ids"].cpu(), out["j_ids"].cpu()], -1)
            sets[fused] = {(b, int(i), int(j)) for b in range(2)
                           for (i, j), ok in zip(ij[b].tolist(), v[b]) if ok}
        both = sets[True] & sets[False]
        union = sets[True] | sets[False]
        share = len(both) / max(len(union), 1)
        print(f"  320 px f32, TF32 off: fused {len(sets[True])} / dense "
              f"{len(sets[False])} valid, agreement {share:.4f} (limit 0.99)")
        assert len(union) >= 8 and share >= 0.99

    # -- 6 ------------------------------------------------------------------
    def refiner_vs_plain(self):
        import torch

        from gim_tpu_torch.models.dkm.blocks import _run_block
        from gim_tpu_torch.ops.kernels import refiner as K

        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(6)

        # ragged cases: C != C_out, H and W not tile multiples, an odd
        # width (rows not 16-byte aligned: element loads, not cp.async) and
        # the widest C with a wide C_out (the most shared memory)
        for shape, C_out in (((1, 40, 37, 200), 56), ((1, 40, 37, 203), 56),
                             ((1, 192, 21, 72), 144)):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(shape, device=dev, generator=g).to(dtype)
                _, f = refiner_block_params(shape[1], C_out, dtype, g)
                got = K.fused_dw_block(x, *f)
                want = K.fused_dw_block_plain(x.float(),
                                              *(t.float() for t in f))
                err = float((got.float() - want).abs().max())
                rtol, atol = ((TOL_F32, TOL_F32) if dtype == torch.float32
                              else (RTOL_BF16, ATOL_BF16))
                print(f"  {str(dtype)[6:]} ragged {shape} -> {C_out}: max abs "
                      f"err {err:.3e} (limit {atol} + {rtol} |plain|)")
                assert torch.allclose(got.float(), want, rtol=rtol,
                                      atol=atol), (shape, dtype)
        # float32 edges: one row, one column, C = 7 -> 5 (a partial chunk
        # and n tile), 192 -> 192 (the most shared memory)
        for shape, C_out in (((1, 24, 1, 37), 24), ((1, 24, 29, 1), 24),
                             ((1, 24, 1, 1), 24), ((2, 7, 9, 13), 5),
                             ((1, 192, 19, 40), 192)):
            x = torch.randn(shape, device=dev, generator=g)
            _, f = refiner_block_params(shape[1], C_out, torch.float32, g)
            got = K.fused_dw_block(x, *f)
            want = K.fused_dw_block_plain(x, *f)
            err = float((got - want).abs().max())
            print(f"  float32 edge {shape} -> {C_out}: max abs err "
                  f"{err:.3e} (limit {TOL_F32} + {TOL_F32} |plain|)")
            assert torch.allclose(got, want, rtol=TOL_F32, atol=TOL_F32), \
                shape

        max_err = 0.0
        by = set()
        grand = dict(ms=0.0, plain_ms=0.0, off_ms=0.0, bound_ms=0.0)
        for head, shapes in (("gim_roma", REFINER_SHAPES),
                             ("gim_dkm", DKM_REFINER_SHAPES)):
            tot = dict(ms=0.0, plain_ms=0.0, off_ms=0.0, bound_ms=0.0)
            for shape in shapes:
                B, C, H, W = shape
                x = torch.randn(shape, device=dev, generator=g).bfloat16()
                blk, f = refiner_block_params(C, C, torch.bfloat16, g)
                got = K.fused_dw_block(x, *f)
                plain = K.fused_dw_block_plain(x, *f)
                want = K.fused_dw_block_plain(x.float(),
                                              *(t.float() for t in f))
                torch.cuda.synchronize()
                err = float((got.float() - want).abs().max())
                err_p = float((got.float() - plain.float()).abs().max())
                ok = torch.allclose(got.float(), want, rtol=RTOL_BF16,
                                    atol=ATOL_BF16)
                del plain, want
                t_k = cuda_ms(lambda: K.fused_dw_block(x, *f), 10)
                t_p = cuda_ms(lambda: K.fused_dw_block_plain(x, *f), 10)
                t_off = cuda_ms(lambda: _run_block(blk, x, torch.bfloat16),
                                10)
                flops = 2.0 * B * H * W * (25 * C + C * C)
                nbytes = 2.0 * B * H * W * (C + C) + 2.0 * (27 * C + C * C)
                b_ms, b_by = bound(flops, nbytes)
                by.add(b_by)
                print(f"  {head} bf16 {shape} -> {C}: max abs err {err:.3e} "
                      f"against the plain version in float32 on the same "
                      f"inputs (limit {ATOL_BF16} + {RTOL_BF16} |plain|), "
                      f"{err_p:.3e} against the plain version in bf16")
                print(f"    kernel {t_k:.3f} ms ({nbytes / t_k / 1e6:.0f} "
                      f"GB/s, {t_k / b_ms:.2f}x its bound {b_ms:.3f} ms "
                      f"({b_by})), plain {t_p:.3f} ms, plain-graph block "
                      f"(PyTorch depthwise conv + BN + ReLU + 1x1) "
                      f"{t_off:.3f} ms [{self.card}]")
                assert ok, shape
                max_err = max(max_err, err)
                n = HIDDEN_BLOCKS
                tot["ms"] += n * t_k
                tot["plain_ms"] += n * t_p
                tot["off_ms"] += n * t_off
                tot["bound_ms"] += n * b_ms
                del x, got
            print(f"  per {head} call ({HIDDEN_BLOCKS} blocks at each "
                  f"shape): kernel {tot['ms']:.3f} ms, plain "
                  f"{tot['plain_ms']:.3f} ms, plain-graph blocks "
                  f"{tot['off_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms; "
                  f"kernel / bound {tot['ms'] / tot['bound_ms']:.2f} "
                  f"[{self.card}]")
            for k in grand:
                grand[k] += tot[k]
        # the JSON entry: one gim_roma call and one gim_dkm call together
        self.kernels["refiner_block"] = {
            "name": "refiner_block", "route": "cuda",
            "source": "gim_tpu_torch/csrc/refiner.cu",
            "replaces": "gim_tpu/ops/pallas_kernels/refiner.py:39",
            "launches": 0, "max_abs_err": max_err, "ms": grand["ms"],
            "plain_ms": grand["plain_ms"], "bound_ms": grand["bound_ms"],
            "bound_by": "bytes" if by == {"bytes"} else "operations",
            "library_ms": None}
        self.refiner_f32_full(g)

    def refiner_f32_full(self, g):
        """K2's float32 kernel at both heads' four full shapes (C_out = C):
        against its plain version at TOL_F32, timed beside the
        plain-graph block in float32 (PyTorch's convolutions, TF32 off)
        and both bounds. Writes the `refiner_block_f32` entry: one
        gim_roma and one gim_dkm call together (8 launches a shape)."""
        import torch

        from gim_tpu_torch.models.dkm.blocks import _run_block
        from gim_tpu_torch.ops.kernels import refiner as K

        max_err, by = 0.0, set()
        grand = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
        for head, shapes in (("gim_roma", REFINER_SHAPES),
                             ("gim_dkm", DKM_REFINER_SHAPES)):
            tot = dict(ms=0.0, plain_ms=0.0, off_ms=0.0, bound_ms=0.0,
                       fma_ms=0.0)
            for shape in shapes:
                B, C, H, W = shape
                x = torch.randn(shape, device=self.dev, generator=g)
                blk, f = refiner_block_params(C, C, torch.float32, g)
                got = K.fused_dw_block(x, *f)
                want = K.fused_dw_block_plain(x, *f)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                ok = torch.allclose(got, want, rtol=TOL_F32, atol=TOL_F32)
                del got, want
                t_k = cuda_ms(lambda: K.fused_dw_block(x, *f), 10)
                t_p = cuda_ms(lambda: K.fused_dw_block_plain(x, *f), 10)
                t_off = cuda_ms(lambda: _run_block(blk, x, torch.float32),
                                10)
                b_ms, b_by, fma = k2_f32_bounds(B, C, C, H, W)
                by.add(b_by)
                print(f"  {head} float32 {shape} -> {C}: max abs err "
                      f"{err:.3e} against the plain version on the same "
                      f"inputs (limit {TOL_F32} + {TOL_F32} |plain|)")
                print(f"    kernel {t_k:.3f} ms ({t_k / b_ms:.2f}x its floor "
                      f"{b_ms:.3f} ms ({b_by}), {t_k / fma:.2f}x the "
                      f"FP32-FMA figure {fma:.3f} ms), plain {t_p:.3f} ms, "
                      f"plain-graph block {t_off:.3f} ms "
                      f"({t_k / t_off:.3f}x) [{self.card}]")
                assert ok, shape
                max_err = max(max_err, err)
                for key, val in (("ms", t_k), ("plain_ms", t_p),
                                 ("off_ms", t_off), ("bound_ms", b_ms),
                                 ("fma_ms", fma)):
                    tot[key] += HIDDEN_BLOCKS * val
                del x
            print(f"  K2 float32 per {head} call ({HIDDEN_BLOCKS} blocks at "
                  f"each shape): kernel {tot['ms']:.3f} ms, floor "
                  f"{tot['bound_ms']:.3f} ms ({tot['ms'] / tot['bound_ms']:.2f}"
                  f"x), FP32-FMA figure {tot['fma_ms']:.3f} ms, plain "
                  f"{tot['plain_ms']:.3f} ms, plain-graph blocks "
                  f"{tot['off_ms']:.3f} ms ({tot['ms'] / tot['off_ms']:.3f}x)"
                  f" [{self.card}]")
            for k in grand:
                grand[k] += tot[k]
        self.kernels["refiner_block_f32"] = {
            "name": "refiner_block_f32", "route": "cuda",
            "source": "gim_tpu_torch/csrc/refiner.cu",
            "replaces": "gim_tpu/ops/pallas_kernels/refiner.py:39",
            "launches": 0, "max_abs_err": max_err, "ms": grand["ms"],
            "plain_ms": grand["plain_ms"], "bound_ms": grand["bound_ms"],
            "bound_by": "bytes" if by == {"bytes"} else "operations",
            "library_ms": None}

    # -- 7 ------------------------------------------------------------------
    def flash_vs_plain(self):
        import torch
        import torch.nn.functional as F

        from gim_tpu_torch.ops.kernels import flash as K

        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(7)

        def qkv(B, H, N, D, dtype, qscale):
            """q, k, v as the strided (B, H, N, D) views that a ViT block's
            qkv split gives (models/dinov2.py): row stride 3 H D."""
            t = torch.randn(B, N, 3, H, D, device=dev, generator=g)
            t[:, :, 0] *= qscale
            q, k, v = t.to(dtype).permute(2, 0, 3, 1, 4).unbind(0)
            return q, k, v

        for D in K.HEAD_DIMS:
            x = torch.randn(3, 1, 3, 157, D, device=dev, generator=g)
            q, k, v = x[0] * 3.0, x[1], x[2]
            got, want = K.flash_sdpa(q, k, v), K.flash_sdpa_plain(q, k, v)
            err = float((got - want).abs().max())
            print(f"  f32 ragged contiguous (1, 3, 157, {D}): max abs err "
                  f"{err:.3e} (limit {TOL_ATTN_F32} + {TOL_ATTN_F32} |plain|)")
            assert torch.allclose(got, want, rtol=TOL_ATTN_F32,
                                  atol=TOL_ATTN_F32)
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = qkv(2, 3, 157, D, dtype, 3.0)
                got = K.flash_sdpa(q, k, v)
                want = K.flash_sdpa_plain(q.float(), k.float(), v.float())
                err = float((got.float() - want).abs().max())
                rtol, atol = ((TOL_ATTN_F32, TOL_ATTN_F32)
                              if dtype == torch.float32
                              else (RTOL_BF16, ATOL_BF16))
                print(f"  {str(dtype)[6:]} ragged strided (2, 3, 157, {D}) "
                      f"views of qkv (2, 157, 3, 3, {D}): max abs err "
                      f"{err:.3e} (limit {atol} + {rtol} |plain|)")
                assert torch.allclose(got.float(), want, rtol=rtol,
                                      atol=atol)
            # float32 edges: one token, and phase 9's 257 (16^2 + 1)
            for N in (1, 257):
                q, k, v = qkv(2, 3, N, D, torch.float32, 3.0)
                got, want = K.flash_sdpa(q, k, v), K.flash_sdpa_plain(q, k, v)
                err = float((got - want).abs().max())
                print(f"  f32 strided (2, 3, {N}, {D}): max abs err "
                      f"{err:.3e} (limit {TOL_ATTN_F32} + {TOL_ATTN_F32} "
                      f"|plain|)")
                assert torch.allclose(got, want, rtol=TOL_ATTN_F32,
                                      atol=TOL_ATTN_F32), (N, D)
        self.flash_f32_full(qkv)
        self.flash_masked_vs_plain()

        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        max_err = 0.0
        by = set()
        for (G, N, D), n in FLASH_SHAPES:
            B, H = 2, G // 2
            q, k, v = qkv(B, H, N, D, torch.bfloat16, 2.0)
            got = K.flash_sdpa(q, k, v)
            plain = K.flash_sdpa_plain(q, k, v)
            want = K.flash_sdpa_plain(q.float(), k.float(), v.float())
            torch.cuda.synchronize()
            err = float((got.float() - want).abs().max())
            err_p = float((got.float() - plain.float()).abs().max())
            ok = torch.allclose(got.float(), want, rtol=RTOL_BF16,
                                atol=ATOL_BF16)
            merged = got.transpose(1, 2).reshape(B, N, H * D)
            view = merged.data_ptr() == got.data_ptr()
            del plain, want
            t_k = cuda_ms(lambda: K.flash_sdpa(q, k, v), 10)
            t_p = cuda_ms(lambda: K.flash_sdpa_plain(q, k, v), 10)
            t_l = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                          10)
            flops = 4.0 * G * N * N * D
            b_ms, b_by = bound(flops, 4.0 * G * N * D * 2)
            by.add(b_by)
            print(f"  bf16 strided ({B}, {H}, {N}, {D}): max abs err "
                  f"{err:.3e} against the plain version in float32 on the "
                  f"same inputs (limit {ATOL_BF16} + {RTOL_BF16} |plain|), "
                  f"{err_p:.3e} against the plain version in bf16 (bf16 "
                  f"scores); merge of the heads is a view: {view}")
            print(f"    kernel {t_k:.3f} ms ({flops / t_k / 1e9:.1f} TFLOP/s, "
                  f"{t_k / b_ms:.2f}x its bound {b_ms:.3f} ms ({b_by}), "
                  f"{t_k / t_l:.2f}x F.scaled_dot_product_attention "
                  f"{t_l:.3f} ms), plain {t_p:.3f} ms [{self.card}]")
            assert ok and view, (G, N, D)
            max_err = max(max_err, err)
            tot["ms"] += n * t_k
            tot["plain_ms"] += n * t_p
            tot["library_ms"] += n * t_l
            tot["bound_ms"] += n * b_ms
        print(f"  per gim_roma call (24 ViT-L + 5 decoder attentions): "
              f"kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
              f"library {tot['library_ms']:.3f} ms, bound "
              f"{tot['bound_ms']:.3f} ms; kernel / library "
              f"{tot['ms'] / tot['library_ms']:.3f} [{self.card}]")
        self.kernels["flash_attention"] = {
            "name": "flash_attention", "route": "cuda",
            "source": "gim_tpu_torch/csrc/flash.cu",
            "replaces": "gim_tpu/ops/pallas_kernels/flash.py:37",
            "launches": 0, "max_abs_err": max_err, "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if by == {"operations"} else "bytes",
            "library_ms": tot["library_ms"]}

    def flash_f32_full(self, qkv):
        """K3's float32 kernel at FLASH_SHAPES on the strided views of a
        qkv split: against its plain version at TOL_ATTN_F32, timed beside
        `F.scaled_dot_product_attention` on the same float32 views (TF32
        off; the port never calls it) and both bounds. Writes the
        `flash_attention_f32` entry: one gim_roma call (24 + 5 launches)."""
        import torch
        import torch.nn.functional as F

        from gim_tpu_torch.ops.kernels import flash as K

        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   fma_ms=0.0)
        max_err = 0.0
        for (G, N, D), n in FLASH_SHAPES:
            B, H = 2, G // 2
            q, k, v = qkv(B, H, N, D, torch.float32, 2.0)
            got = K.flash_sdpa(q, k, v)
            want = K.flash_sdpa_plain(q, k, v)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = torch.allclose(got, want, rtol=TOL_ATTN_F32,
                                atol=TOL_ATTN_F32)
            del got, want
            t_k = cuda_ms(lambda: K.flash_sdpa(q, k, v), 10)
            t_p = cuda_ms(lambda: K.flash_sdpa_plain(q, k, v), 10)
            t_l = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                          10)
            b_ms, fma = k3_f32_bounds(G, N, D)
            print(f"  f32 strided ({B}, {H}, {N}, {D}): max abs err "
                  f"{err:.3e} against the plain version on the same inputs "
                  f"(limit {TOL_ATTN_F32} + {TOL_ATTN_F32} |plain|)")
            print(f"    kernel {t_k:.3f} ms ({t_k / b_ms:.2f}x its floor "
                  f"{b_ms:.3f} ms (operations), {t_k / fma:.2f}x the "
                  f"FP32-FMA figure {fma:.3f} ms, {t_k / t_l:.3f}x "
                  f"F.scaled_dot_product_attention {t_l:.3f} ms), plain "
                  f"{t_p:.3f} ms [{self.card}]")
            assert ok, (G, N, D)
            max_err = max(max_err, err)
            for key, val in (("ms", t_k), ("plain_ms", t_p),
                             ("library_ms", t_l), ("bound_ms", b_ms),
                             ("fma_ms", fma)):
                tot[key] += n * val
        print(f"  K3 float32 per gim_roma call (24 ViT-L + 5 decoder "
              f"attentions): kernel {tot['ms']:.3f} ms, floor "
              f"{tot['bound_ms']:.3f} ms ({tot['ms'] / tot['bound_ms']:.2f}x),"
              f" FP32-FMA figure {tot['fma_ms']:.3f} ms, plain "
              f"{tot['plain_ms']:.3f} ms, library {tot['library_ms']:.3f} ms "
              f"({tot['ms'] / tot['library_ms']:.3f}x) [{self.card}]")
        self.kernels["flash_attention_f32"] = {
            "name": "flash_attention_f32", "route": "cuda",
            "source": "gim_tpu_torch/csrc/flash.cu",
            "replaces": "gim_tpu/ops/pallas_kernels/flash.py:37",
            "launches": 0, "max_abs_err": max_err, "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "operations", "library_ms": tot["library_ms"]}

    def flash_masked_vs_plain(self):
        """K3 f32's masked variant (LightGlue's attention) against its plain
        version at TOL_ATTN_F32: ragged edges, Nq != Nk, both head dims,
        invalid keys and queries, a batch item with no valid key (rows
        exactly 0), masks left out; then at LG_ATTN_SHAPES with
        LG_ATTN_INVALID of the keys invalid, on the views LightGlue hands
        it, timed against its plain version, its floor (three TF32 products
        of 4 B H N^2 D FLOP) and `F.scaled_dot_product_attention` in
        float32 with the same mask (TF32 off; the yardstick only, the port
        never calls it). Writes the `lightglue_attention` entry: one call
        (LG_ATTN_PER_CALL launches) at batch 16 under the keys every kernel
        has, at batch 1 under `batch1_*`."""
        import torch
        import torch.nn.functional as F

        from gim_tpu_torch.ops.kernels import flash as K

        dev = torch.device(self.dev)
        g = torch.Generator(device=dev).manual_seed(20)

        def views(B, H, Nq, Nk, D, invalid):
            """q, k, v as LightGlue's cross attention hands them: (B, H, N,
            D) views of a projection's (B, N, H D) rows; masks with
            `invalid` of the slots off (the last 1 % and random ones)."""
            def rows(N, s):
                t = torch.randn(B, N, H * D, device=dev, generator=g) * s
                return t.unflatten(-1, (H, D)).transpose(1, 2)

            def mask(N):
                m = torch.rand(B, N, device=dev, generator=g) >= invalid
                m[:, N - max(1, N // 100):] = False
                return m.contiguous()
            return (rows(Nq, 2.0), rows(Nk, 1.0), rows(Nk, 1.0), mask(Nq),
                    mask(Nk))

        def check(label, q, k, v, qv, kv):
            got = K.flash_sdpa_masked(q, k, v, qv, kv)
            want = K.flash_sdpa_masked_plain(q, k, v, qv, kv)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            B = q.shape[0]
            qk = (torch.ones(B, q.shape[2], dtype=torch.bool, device=dev)
                  if qv is None else qv)
            if kv is not None:
                qk = qk & kv.any(-1, keepdim=True)
            zero = bool((got.transpose(1, 2)[~qk] == 0).all())
            print(f"  f32 masked {label}: max abs err {err:.3e} (limit "
                  f"{TOL_ATTN_F32} + {TOL_ATTN_F32} |plain|), dropped rows "
                  f"exactly 0: {zero}")
            assert torch.allclose(got, want, rtol=TOL_ATTN_F32,
                                  atol=TOL_ATTN_F32) and zero, label
            return err

        max_err = 0.0
        for B, H, Nq, Nk, D in ((2, 3, 157, 157, 64), (2, 3, 100, 261, 64),
                                (1, 2, 130, 77, 128), (1, 1, 1, 33, 64)):
            q, k, v, qv, kv = views(B, H, Nq, Nk, D, 0.1)
            label = f"({B}, {H}, {Nq}, {D}) x {Nk} keys"
            max_err = max(max_err, check(label, q, k, v, qv, kv))
            if B == 2 and Nq == Nk:
                kv[1] = False
                qv[0, :40] = False
                check(label + ", item 1 no valid key", q, k, v, qv, kv)
                check(label + ", masks None", q, k, v, None, None)

        tot = {}
        for B, H, N, D in LG_ATTN_SHAPES:
            q, k, v, qv, kv = views(B, H, N, N, D, LG_ATTN_INVALID)
            label = (f"({B}, {H}, {N}, {D}), "
                     f"{float(1 - kv.float().mean()):.3f} of keys invalid")
            max_err = max(max_err, check(label, q, k, v, qv, kv))
            # the launches straight through the C entry, buffers made once:
            # at batch 1 the wrapper's host time (about 50 us a call) is
            # close to the kernel's and would be timed in its place
            shape, strides = K.masked_args(q, k, v, qv, kv)
            lib = K._lib()
            _, args = K.masked_launch(q, k, v, qv, kv, shape, strides)
            t_k = cuda_ms(lambda: lib.flash_attention_masked(*args), 10)
            t_p = cuda_ms(lambda: K.flash_sdpa_masked_plain(q, k, v, qv, kv),
                          10)
            mask = qv[:, None, :, None] & kv[:, None, None, :]
            t_l = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), 10)
            b_ms = 3 * 4.0 * B * H * N * N * D / PEAK_TF32_FLOPS * 1e3
            print(f"    kernel {t_k:.4f} ms ({t_k / b_ms:.2f}x its floor "
                  f"{b_ms:.4f} ms (operations), {t_k / t_l:.3f}x "
                  f"F.scaled_dot_product_attention {t_l:.4f} ms), plain "
                  f"{t_p:.4f} ms [{self.card}]")
            n = LG_ATTN_PER_CALL
            tot[B] = dict(ms=n * t_k, plain_ms=n * t_p, library_ms=n * t_l,
                          bound_ms=n * b_ms)
            print(f"  per LightGlue call at batch {B} ({n} launches): kernel "
                  f"{n * t_k:.3f} ms, floor {n * b_ms:.3f} ms, plain "
                  f"{n * t_p:.3f} ms, library {n * t_l:.3f} ms "
                  f"[{self.card}]")
        main = LG_ATTN_SHAPES[-1][0]
        self.kernels.setdefault("lightglue_attention", {}).update({
            "name": "lightglue_attention", "route": "cuda",
            "source": "gim_tpu_torch/csrc/flash.cu",
            "replaces": "none (the JAX package's XLA products)",
            "max_abs_err": max_err, "bound_by": "operations",
            "batch": main, **tot[main],
            **{f"batch{b}_{key}": val for b, d in tot.items() if b != main
               for key, val in d.items()}})

    # -- 8 ------------------------------------------------------------------
    def roma_main_path(self):
        import torch

        from gim_tpu_torch.api import Matcher
        from gim_tpu_torch.config import GimConfig, RoMaConfig
        from gim_tpu_torch.ops.kernels import flash, refiner

        dev = torch.device("cuda")
        counters = (refiner.LAUNCHES, flash.LAUNCHES)
        per_call = {"refiner_block": ROMA_K2_PER_CALL,
                    "flash_attention": ROMA_K3_PER_CALL}
        cfg = GimConfig(roma=RoMaConfig(dtype="bfloat16"))
        t0 = time.perf_counter()
        m = Matcher("gim_roma", cfg, generator=torch.Generator()
                    .manual_seed(0), device="cuda")
        print(f"  matcher built in {time.perf_counter() - t0:.1f} s")
        g = torch.Generator(device=dev).manual_seed(8)
        shape = (1, 3, ROMA_IMG, ROMA_IMG)
        pairs = [(torch.rand(shape, device=dev, generator=g),
                  torch.rand(shape, device=dev, generator=g))
                 for _ in range(3)]
        n = cfg.roma.num_samples

        def check(r):
            assert r.kpts0.shape == (1, n, 2), r.kpts0.shape
            assert r.kpts1.shape == (1, n, 2) and r.conf.shape == (1, n)
            for t in (r.kpts0, r.kpts1, r.conf):
                assert bool(torch.isfinite(t).all())

        for c in counters:
            for k in c:
                c[k] = 0
        calls = 0

        def counts():
            return {**refiner.LAUNCHES, **flash.LAUNCHES}

        def one(*args, **kw):
            nonlocal calls
            r = m.match(*args, **kw)
            torch.cuda.synchronize()
            calls += 1
            check(r)
            got = counts()
            for k, each in per_call.items():
                assert got[k] == calls * each, (k, got[k], calls, each)
            return r

        one(*pairs[0])                               # warm-up
        torch.cuda.reset_peak_memory_stats()
        times = []
        for a, b in pairs:
            t0 = time.perf_counter()
            r = one(a, b)
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        print(f"  valid matches per call: {int(r.valid.sum())} of {n}")

        # content masks: 672 x 504 content on the canvas (distort_aspect)
        mask = torch.zeros(1, ROMA_IMG, ROMA_IMG, dtype=torch.bool,
                           device=dev)
        mask[:, :, :ROMA_IMG * 3 // 4] = True
        a, b = pairs[0]
        r = one(a * mask[:, None], b * mask[:, None], mask0=mask,
                mask1=mask)
        v = r.valid[0]
        inside = bool((r.kpts0[0][v][:, 0] <= ROMA_IMG * 3 // 4).all()
                      and (r.kpts1[0][v][:, 0] <= ROMA_IMG * 3 // 4)
                      .all())
        print(f"  masked call: {int(v.sum())} valid, all inside the "
              f"content rectangle: {inside}")
        assert inside and int(v.sum()) > 0
        got = counts()
        for k in per_call:
            self.kernels[k]["launches"] = got[k]
        ms = statistics.median(times) * 1e3
        print(f"  main path: {calls} match calls, launches {got} "
              f"({ROMA_K2_PER_CALL} K2 and {ROMA_K3_PER_CALL} K3 per "
              f"call)")
        print(f"  1 pair at {ROMA_IMG} px -> {cfg.roma.upsample_res[0]} "
              f"px, bf16, both kernels on: median {ms:.2f} ms per pair "
              f"(runs {[round(t * 1e3, 2) for t in times]}), peak memory "
              f"{peak / 2**30:.2f} GiB [{self.card}]")
        self.roma_stages(m, pairs[1])
        self.profile(lambda: m.match(*pairs[2]))
        # the GP's solve (2304 x 2304, float32): one batched call against
        # one call per image, which the port makes
        A = torch.randn(2, 2304, 2304, device=dev, generator=g) / 48.0
        A = A @ A.transpose(1, 2) + torch.eye(2304, device=dev)
        rhs = torch.randn(2, 2304, 512, device=dev, generator=g)
        t_b = cuda_ms(lambda: torch.linalg.solve(A, rhs), 3)
        t_r = cuda_ms(lambda: [torch.linalg.solve(A[i], rhs[i])
                               for i in range(2)], 3)
        print(f"  GP solve (2, 2304, 2304) f32: batched {t_b:.3f} ms, one "
              f"call per image {t_r:.3f} ms [{self.card}]")

    def roma_stages(self, m, pair):
        """Time on the card's stream of each stage of one call; VGG and
        the decoder run once per pass."""
        model = m.model
        ev, end, total = self.timed_call(
            m, pair, {"vgg": model.encoder["cnn"], "dinov2": model.dinov2,
                      "decoder": model.decoder})
        vgg, dino, dec = ev["vgg"], ev["dinov2"], ev["decoder"]
        spans = {
            "coarse VGG19 (672 px)": vgg[0].elapsed_time(vgg[1]),
            "DINOv2 ViT-L/14 (K3)": dino[0].elapsed_time(dino[1]),
            "coarse decoder (GP, coordinate decoder K3, 5 refiners, K2)":
                dec[0].elapsed_time(dec[1]),
            "fine VGG19 (1344 px)": vgg[2].elapsed_time(vgg[3]),
            "fine decoder (4 refiners, K2)": dec[2].elapsed_time(dec[3]),
            "warp assembly and sampling": dec[3].elapsed_time(end),
        }
        self.print_stages("one call", spans, total, "rest (resizes, gaps)")

    # -- 9 ------------------------------------------------------------------
    def roma_kernels_vs_plain(self):
        import torch

        from gim_tpu_torch.api import Matcher
        from gim_tpu_torch.config import GimConfig, RoMaConfig
        from gim_tpu_torch.ops.kernels import flash, forward_only, refiner

        cfg = GimConfig(roma=RoMaConfig(coarse_res=224,
                                        upsample_res=(448, 448)))
        m = Matcher("gim_roma", cfg, generator=torch.Generator()
                    .manual_seed(0), device="cuda")
        g = torch.Generator(device="cuda").manual_seed(9)
        a = torch.rand(1, 3, 224, 224, device="cuda", generator=g)
        b = torch.roll(a, shifts=(9, 13), dims=(2, 3))
        def run(launches):
            before = refiner.LAUNCHES["refiner_block"], \
                flash.LAUNCHES["flash_attention"]
            with torch.inference_mode():
                o = m.model(a, b)
            torch.cuda.synchronize()
            after = refiner.LAUNCHES["refiner_block"], \
                flash.LAUNCHES["flash_attention"]
            ran = tuple(y - x for x, y in zip(before, after))
            assert ran == launches, (ran, launches)
            return o

        out = {True: run((ROMA_K2_PER_CALL, ROMA_K3_PER_CALL))}
        with swapped(forward_only, "on_kernel", lambda x: False):
            out[False] = run((0, 0))
        for i, name in enumerate(("warp", "cert")):
            d = (out[True][i] - out[False][i]).abs()
            if d.dim() == 4:
                d = d.amax(-1)
            share = float((d <= SWITCH_TOL).float().mean())
            print(f"  {name}: agree within {SWITCH_TOL} on {share:.6f} of "
                  f"pixels (limit {MIN_AGREE}), max diff {float(d.max()):.3e}")
            assert share >= MIN_AGREE, name
        print(f"  224 px -> 448 px, float32, TF32 off, the kernels (K2 + "
              f"K3) against the plain graph (PyTorch convolutions, plain "
              f"sdpa)")

    # -- 10 -----------------------------------------------------------------
    def dkm_main_path(self):
        import torch

        from gim_tpu_torch.api import Matcher
        from gim_tpu_torch.config import DKMConfig, GimConfig
        from gim_tpu_torch.ops.kernels import flash, refiner

        dev = torch.device("cuda")
        S = DKM_CANVAS
        h, w = DKM_CONTENT
        cfg = GimConfig(dkm=DKMConfig(dtype="bfloat16"))
        t0 = time.perf_counter()
        m = Matcher("gim_dkm", cfg, generator=torch.Generator()
                    .manual_seed(0), device="cuda")
        print(f"  matcher built in {time.perf_counter() - t0:.1f} s")
        g = torch.Generator(device=dev).manual_seed(10)
        mask = torch.zeros(1, S, S, dtype=torch.bool, device=dev)
        mask[:, :h, :w] = True
        shape = (1, 3, S, S)
        pairs = [(torch.rand(shape, device=dev, generator=g) * mask,
                  torch.rand(shape, device=dev, generator=g) * mask,
                  None, None, mask, mask) for _ in range(3)]
        n = cfg.dkm.num_samples

        for c in (refiner.LAUNCHES, flash.LAUNCHES):
            for k in c:
                c[k] = 0
        calls = 0

        def one(*args):
            """One match call: finite keypoints of the right shapes,
            inside the content rectangle (canvas width for the
            aspect-pad call), 32 K2 launches and no K3 one."""
            nonlocal calls
            r = m.match(*args)
            torch.cuda.synchronize()
            calls += 1
            assert r.kpts0.shape == (1, n, 2), r.kpts0.shape
            assert r.kpts1.shape == (1, n, 2) and r.conf.shape == (1, n)
            for t in (r.kpts0, r.kpts1, r.conf):
                assert bool(torch.isfinite(t).all())
            v = r.valid[0]
            # aspect-pad: the canvas right-padded to the model's w:h
            hh, ww = ((h, w) if args[4] is not None else
                      (S, round(S * cfg.dkm.w_resized
                                / cfg.dkm.h_resized)))
            for k in (r.kpts0[0][v], r.kpts1[0][v]):
                assert bool((k >= 0).all() and (k[:, 0] <= ww).all()
                            and (k[:, 1] <= hh).all())
            got = refiner.LAUNCHES["refiner_block"]
            assert got == calls * DKM_K2_PER_CALL, (got, calls)
            assert flash.LAUNCHES["flash_attention"] == 0
            return r

        one(*pairs[0])                               # warm-up
        torch.cuda.reset_peak_memory_stats()
        times = []
        for p in pairs:
            t0 = time.perf_counter()
            r = one(*p)
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        print(f"  valid matches per call: {int(r.valid.sum())} of {n}, "
              f"all inside the {w} x {h} content rectangle")
        assert int(r.valid.sum()) > 0

        # aspect-pad: no masks, the canvas right-padded to 840 x 1120
        a, b = pairs[0][:2]
        r = one(a, b, None, None, None, None)
        print(f"  call without masks (aspect-pad): "
              f"{int(r.valid.sum())} valid")
        assert int(r.valid.sum()) > 0
        got = refiner.LAUNCHES["refiner_block"]
        self.kernels["refiner_block"]["launches"] += got
        ms = statistics.median(times) * 1e3
        print(f"  main path: {calls} match calls, K2 launches {got} "
              f"({DKM_K2_PER_CALL} per call); the K2 entry's launches "
              f"now {self.kernels['refiner_block']['launches']} "
              f"(gim_roma's and gim_dkm's main paths)")
        print(f"  1 pair of {S} x {S} canvases ({w} x {h} content) -> "
              f"{cfg.dkm.h_resized} x {cfg.dkm.w_resized} -> "
              f"{cfg.dkm.upsample_res[0]} x {cfg.dkm.upsample_res[1]}, "
              f"bf16, K2 on: median {ms:.2f} ms per pair (runs "
              f"{[round(t * 1e3, 2) for t in times]}), peak memory "
              f"{peak / 2**30:.2f} GiB [{self.card}]")
        self.dkm_stages(m, pairs[1])
        self.profile(lambda: m.match(*pairs[2]))

    def dkm_stages(self, m, pair):
        """Time on the card's stream of each stage of one call; the
        encoder and the decoder run once per pass."""
        model = m.model
        ev, end, total = self.timed_call(
            m, pair, {"encoder": model.encoder, "decoder": model.decoder})
        enc, dec = ev["encoder"], ev["decoder"]
        c = m.cfg.dkm
        spans = {
            f"coarse encoder ({c.h_resized} x {c.w_resized})":
                enc[0].elapsed_time(enc[1]),
            "coarse decoder (GP and DFN at 1/32 and 1/16, 5 refiners; K2)":
                dec[0].elapsed_time(dec[1]),
            f"upsample encoder ({c.upsample_res[0]} x {c.upsample_res[1]})":
                enc[2].elapsed_time(enc[3]),
            "upsample decoder (4 refiners; K2)": dec[2].elapsed_time(dec[3]),
            "warp assembly and sampling": dec[3].elapsed_time(end),
        }
        self.print_stages("one call", spans, total,
                          "rest (input resizes, gaps)")

    # -- 11 -----------------------------------------------------------------
    def dkm_kernels_vs_plain(self):
        import torch

        from gim_tpu_torch.api import Matcher
        from gim_tpu_torch.config import DKMConfig, GimConfig
        from gim_tpu_torch.ops.kernels import forward_only, refiner

        cfg = GimConfig(dkm=DKMConfig(h_resized=240, w_resized=320,
                                      upsample_res=(384, 512)))
        m = Matcher("gim_dkm", cfg, generator=torch.Generator()
                    .manual_seed(0), device="cuda")
        g = torch.Generator(device="cuda").manual_seed(11)
        a = torch.rand(1, 3, 240, 320, device="cuda", generator=g)
        b = torch.roll(a, shifts=(9, 13), dims=(2, 3))
        def run(launches):
            before = refiner.LAUNCHES["refiner_block"]
            with torch.inference_mode():
                o = m.model(a, b)
            torch.cuda.synchronize()
            ran = refiner.LAUNCHES["refiner_block"] - before
            assert ran == launches, (ran, launches)
            return o

        out = {True: run(DKM_K2_PER_CALL)}
        with swapped(forward_only, "on_kernel", lambda x: False):
            out[False] = run(0)
        for i, name in enumerate(("warp", "cert")):
            d = (out[True][i] - out[False][i]).abs()
            if d.dim() == 4:
                d = d.amax(-1)
            share = float((d <= SWITCH_TOL).float().mean())
            print(f"  {name}: agree within {SWITCH_TOL} on {share:.6f} of "
                  f"pixels (limit {MIN_AGREE}), max diff {float(d.max()):.3e}")
            assert share >= MIN_AGREE, name
        print("  240 x 320 -> 384 x 512, float32, TF32 off, K2 against the "
              "plain graph (PyTorch convolutions)")

    # -- 12 -----------------------------------------------------------------
    def zeb_geometry(self):
        import warnings

        import numpy as np
        import torch

        from gim_tpu_torch.eval import zeb as E
        from gim_tpu_torch.geometry.ransac import draw_noise

        dev = torch.device(self.dev)
        n_hyp, _ = E.RANSAC_ZOO["MAGSAC"]
        rng = np.random.default_rng(12)
        scenes = [gt_scene(rng, ZEB_MATCHES, n, w, ZEB_NOISE_PX)
                  for n, w in ZEB_SCENES]
        host = [np.stack(x) for x in zip(*scenes)]    # p0 p1 valid K T
        conf = rng.random(host[0].shape[:2]).astype(np.float32)
        keys = [E.identifier_key(f"zeb_scene{i}#0#1")
                for i in range(len(scenes))]
        p0, p1, valid, K, Tm = (torch.from_numpy(a).to(dev) for a in host)
        c = torch.from_numpy(conf).to(dev)

        def call(sl):
            return E.pair_metrics(p0[sl], p1[sl], valid[sl], K[sl], K[sl],
                                  Tm[sl], keys[sl], 0.5, n_hyp, conf=c[sl])

        card = {k: v.cpu().numpy() for k, v in call(slice(None)).items()}
        # the CPU run takes the card's uniforms: each pair's generator on
        # the card, seeded from its key, drawn again and copied over
        gens = [torch.Generator(dev).manual_seed(E.seed_of(k)) for k in keys]
        noise = tuple(n.cpu() for n in draw_noise(gens, n_hyp, ZEB_MATCHES,
                                                  dev))
        t0 = time.perf_counter()
        cpu = E.pair_metrics(*(torch.from_numpy(a) for a in host[:4]),
                             torch.from_numpy(host[3]),
                             torch.from_numpy(host[4]), keys, 0.5, n_hyp,
                             conf=torch.from_numpy(conf), noise=noise)
        cpu = {k: v.numpy() for k, v in cpu.items()}
        print(f"  {len(scenes)} scenes of {ZEB_MATCHES} slots, {n_hyp} "
              f"hypotheses (MAGSAC preset), {ZEB_NOISE_PX} px noise; the "
              f"CPU run took {time.perf_counter() - t0:.1f} s")
        epi_ok = np.isclose(card["epi_errs"], cpu["epi_errs"], rtol=1e-4,
                            atol=1e-8)
        print(f"  epi_errs: card and CPU agree within rtol 1e-4 + atol "
              f"1e-8 on {epi_ok.mean():.6f} of slots (limit 1)")
        assert epi_ok.all()
        for b, (n, w) in enumerate(ZEB_SCENES):
            v = host[2][b]
            errs = [max(d["R_errs"][b], d["t_errs"][b]) for d in (card, cpu)]
            ok = [bool(np.isfinite(d["R_errs"][b])) for d in (card, cpu)]
            agree = float((card["inliers"][b] == cpu["inliers"][b])[v].mean())
            print(f"  scene {b} ({n} valid, {1 - w:.0%} outliers): max(R, t) "
                  f"error card {errs[0]:.4f} deg, CPU {errs[1]:.4f} deg "
                  f"(limits {POSE_MAX_DEG}, diff {POSE_DIFF_DEG}); "
                  f"success {ok}; inlier masks agree on {agree:.6f} of "
                  f"valid slots (limit {MASK_AGREE}); inliers "
                  f"{int(card['inliers'][b].sum())} / "
                  f"{int(cpu['inliers'][b].sum())}")
            assert ok[0] and ok[1], b
            assert max(errs) < POSE_MAX_DEG, b
            assert abs(errs[0] - errs[1]) < POSE_DIFF_DEG, b
            assert agree >= MASK_AGREE, b

        # ZEB's batch of 1: time, host syncs, launches and memory per call
        one = [slice(b, b + 1) for b in range(len(scenes))]
        call(one[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times = []
        for sl in one:
            t0 = time.perf_counter()
            call(sl)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                call(one[1])
                torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = [str(w.message) for w in caught
                 if "synchroniz" in str(w.message)]
        print(f"  pair_metrics, 1 pair of {ZEB_MATCHES} slots: median "
              f"{statistics.median(times):.2f} ms per call (runs "
              f"{[round(t, 2) for t in times]}), {len(syncs)} host syncs "
              f"per call, peak memory {peak / 2**30:.2f} GiB above the "
              f"inputs [{self.card}]")
        for msg in sorted(set(syncs)):
            print(f"    sync: {msg.splitlines()[0][:110]}")
        self.profile(lambda: call(one[2]), top=12)

        # root_sift's device half: the card against the CPU
        from gim_tpu_torch.models.root_sift import match_rootsift

        n = 4096
        d1 = rng.random((n, 128)).astype(np.float32) ** 4
        d1 = np.sqrt(d1 / d1.sum(1, keepdims=True))
        d0 = rng.random((n, 128)).astype(np.float32) ** 4
        d0 = np.sqrt(d0 / d0.sum(1, keepdims=True))
        src = rng.permutation(n)[:n // 2]
        d0[:n // 2] = d1[src] + 0.01 * rng.random((n // 2, 128))
        d0 = (d0 / np.linalg.norm(d0, axis=1, keepdims=True)).astype(
            np.float32)
        k = rng.uniform(0, 840, (n, 2)).astype(np.float32)
        v0, v1 = rng.random(n) > 0.05, rng.random(n) > 0.05
        args = (k, d0, v0, k, d1, v1)
        mc, cc = match_rootsift(*(torch.from_numpy(a).to(dev) for a in args))
        mh, ch = match_rootsift(*(torch.from_numpy(a) for a in args))
        same = bool(torch.equal(mc.cpu(), mh))
        print(f"  match_rootsift on {n} x 128 descriptors: "
              f"{int((mh >= 0).sum())} matches, card and CPU indices "
              f"identical: {same}, max conf diff "
              f"{float((cc.cpu() - ch).abs().max()):.2e}")
        assert same and int((mh >= 0).sum()) > n // 4

    # -- 13 -----------------------------------------------------------------
    def zeb_path(self):
        import tempfile

        import numpy as np
        import torch

        from gim_tpu_torch.cli.analysis import read_dump
        from gim_tpu_torch.eval import zeb as E
        from gim_tpu_torch.ops.kernels import dsmax as K

        n_hyp, use_conf = E.RANSAC_ZOO["MAGSAC"]
        m = zeb_matcher(self.dev)
        batches = zeb_batches()
        match_s, match_peak = [], []

        def match(batch):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            r = m.match(*zeb_args(batch))
            torch.cuda.synchronize()
            match_s.append(time.perf_counter() - t0)
            match_peak.append(torch.cuda.max_memory_allocated())
            assert r.kpts0.shape == (1, ZEB_MATCHES, 2)
            return r

        stamps = []

        def feed(bs):
            for b in bs:
                stamps.append(time.perf_counter())
                yield b
            stamps.append(time.perf_counter())

        for k in K.LAUNCHES:
            K.LAUNCHES[k] = 0
        E.evaluate(match, feed(batches[:1]), num_hypotheses=n_hyp,
                   use_conf=use_conf, progress=False)          # warm-up
        torch.cuda.synchronize()
        match_s.clear()
        match_peak.clear()
        stamps.clear()
        rows = E.evaluate(match, feed(batches[1:]), num_hypotheses=n_hyp,
                          use_conf=use_conf, progress=False)
        peak = torch.cuda.max_memory_allocated()   # the last pair, whole
        counts = dict(K.LAUNCHES)
        print(f"  K1 launches over {ZEB_PAIRS + 1} pairs (one warm-up): "
              f"{counts}")
        for k in F32_SWEEPS:
            assert counts[k] == ZEB_PAIRS + 1, (k, counts)
            self.kernels[k]["launches"] = counts[k]
        assert all(counts[k] == 0 for k in BF16_SWEEPS), counts

        pair_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        match_ms = [t * 1e3 for t in match_s]
        rest_ms = [p - q for p, q in zip(pair_ms, match_ms)]
        med = statistics.median(pair_ms)
        print(f"  gim_loftr f32, fused (K1 f32), {ZEB_MATCHES} slots at "
              f"threshold 0, {ZEB_PAIRS} pairs of {ZEB_CANVAS}^2 canvases "
              f"at batch 1, MAGSAC preset ({n_hyp} hypotheses): median "
              f"{med:.2f} ms per pair, of which match "
              f"{statistics.median(match_ms):.2f} ms and pair_metrics (with "
              f"the host copies of the rows) "
              f"{statistics.median(rest_ms):.2f} ms; "
              f"{1e3 / med:.3f} pairs/s; peak memory {peak / 2**30:.2f} GiB "
              f"per pair, {max(match_peak) / 2**30:.2f} GiB in the match "
              f"[{self.card}]")
        print(f"    per pair: total {[round(t, 2) for t in pair_ms]}, "
              f"match {[round(t, 2) for t in match_ms]}")

        n_valid = [len(r["epi_errs"]) for r in rows]
        for r in rows:
            assert np.isfinite(r["epi_errs"]).all() and len(r["epi_errs"]) > 0
        with tempfile.TemporaryDirectory() as d:
            path = E.write_dump(rows, d, "gim_loftr", "ZEB-memory", "smoke")
            det = read_dump(path)
            with open(path) as f:
                self.zeb_dump = f.read()          # phase 27 holds to it
        under5 = np.mean([max(float(a), float(b)) < 5.0 for a, b in
                          zip(det["R_errs"], det["t_errs"])])
        print(f"  dump: {len(det['R_errs'])} rows read back by "
              f"cli/analysis.read_dump; valid matches per pair {n_valid}; "
              f"share of pairs under 5 deg {under5:.3f} (seeded random "
              f"weights: no quality claim)")
        assert len(det["R_errs"]) == ZEB_PAIRS
        self.stages(m, zeb_args(batches[1]))
        self.profile(lambda: E.evaluate(match, iter(batches[1:2]),
                                        num_hypotheses=n_hyp,
                                        use_conf=use_conf, progress=False),
                     top=12)
        # informational: cuDNN's heuristics pick float32 algorithms (FFT
        # among them) without timing them; the port leaves
        # torch.backends.cudnn.benchmark at PyTorch's default (off)
        torch.backends.cudnn.benchmark = True
        try:
            match(batches[1])                       # autotunes each shape
            match_s.clear()
            for b in batches[1:4]:
                match(b)
        finally:
            torch.backends.cudnn.benchmark = False
        print(f"  match with torch.backends.cudnn.benchmark on (not the "
              f"port's setting): median "
              f"{statistics.median(match_s) * 1e3:.2f} ms per pair (runs "
              f"{[round(t * 1e3, 2) for t in match_s]}), peak "
              f"{max(match_peak) / 2**30:.2f} GiB [{self.card}]")

    # -- 14-16: gim_lightglue ---------------------------------------------
    @staticmethod
    def kernel_counts(reset: bool = False) -> dict:
        """Every kernel's launch count (K1's four sweeps, K2, K3); with
        `reset`, set them to 0 first."""
        from gim_tpu_torch.ops.kernels import dsmax, flash, refiner

        out = {}
        for c in (dsmax.LAUNCHES, refiner.LAUNCHES, flash.LAUNCHES):
            for k in c:
                if reset:
                    c[k] = 0
                out[k] = c[k]
        return out

    def lightglue_main_path(self):
        import torch

        from gim_tpu_torch.api import Matcher

        dev = torch.device(self.dev)
        S = ZEB_CANVAS
        h, w = ZEB_CONTENT
        t0 = time.perf_counter()
        m = Matcher("gim_lightglue", generator=torch.Generator()
                    .manual_seed(0), device=dev)
        print(f"  matcher built in {time.perf_counter() - t0:.1f} s")
        K = m.cfg.superpoint.max_num_keypoints
        g = torch.Generator(device=dev).manual_seed(14)
        mask = torch.zeros(1, S, S, dtype=torch.bool, device=dev)
        mask[:, :h, :w] = True

        def pairs(B):
            mk = mask.expand(B, S, S)
            return tuple(torch.rand((B, 3, S, S), device=dev, generator=g)
                         * mk[:, None] for _ in range(2)) + (None, None,
                                                             mk, mk)

        self.kernel_counts(reset=True)
        calls = 0

        def one(args):
            """One match call: finite outputs of the right shapes, every
            image-0 slot (a keypoint or a padded slot) inside the
            content."""
            nonlocal calls
            r = m.match(*args)
            torch.cuda.synchronize()
            calls += 1
            B = args[0].shape[0]
            assert r.kpts0.shape == (B, K, 2) and r.kpts1.shape == (B, K, 2)
            assert r.conf.shape == (B, K) and r.valid.shape == (B, K)
            for t in (r.kpts0, r.kpts1, r.conf):
                assert bool(torch.isfinite(t).all())
            k0 = r.kpts0
            assert bool((k0 > 0).all() and (k0[..., 0] < w + 0.5).all()
                        and (k0[..., 1] < h + 0.5).all())
            return r

        def timed(B, what):
            batch = [pairs(B) for _ in range(3)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for args in batch:
                t0 = time.perf_counter()
                r = one(args)
                times.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated()
            ms = statistics.median(times) * 1e3
            print(f"  {what}: {B} pair(s) of {S}^2 canvases ({w} x {h} "
                  f"content), float32, TF32 off: median {ms:.2f} ms per "
                  f"call, {ms / B:.2f} ms per pair, {B / (ms / 1e3):.3f} "
                  f"pairs/s (runs {[round(t * 1e3, 2) for t in times]}), "
                  f"peak memory {peak / 2**30:.2f} GiB; valid matches "
                  f"{r.valid.sum(1).tolist()[:4]} of {K} at threshold "
                  f"{m.cfg.lightglue.filter_threshold} [{self.card}]")
            return batch

        one(pairs(1))                                   # warm-up
        small = timed(1, "batch 1")
        B = LG_BATCH
        while True:
            try:
                one(pairs(B))                           # warm-up
                break
            except torch.cuda.OutOfMemoryError:
                if B == 1:
                    raise
                print(f"  batch {B} does not fit in the card's memory; "
                      f"trying {B // 2}")
                torch.cuda.empty_cache()
                B //= 2
        self.lg_batch = B
        big = timed(B, f"batch {B}" + ("" if B == LG_BATCH else
                                        f" (not {LG_BATCH}: out of memory)"))
        counts = self.kernel_counts()
        print(f"  main path: {calls} match calls; kernel launches {counts}")
        want = dict.fromkeys(counts, 0)
        want["lightglue_attention"] = LG_ATTN_PER_CALL * calls
        assert counts == want, counts
        self.kernels.setdefault("lightglue_attention", {})["launches"] = \
            LG_ATTN_PER_CALL
        self.lightglue_stages(m, small[1], "one call at batch 1")
        self.lightglue_stages(m, big[1], f"one call at batch {B}")
        self.profile(lambda: m.match(*small[2]))
        self.profile(lambda: m.match(*big[2]), top=12)

    def lightglue_stages(self, m, args, what):
        """Time on the card's stream of each stage of one call: SuperPoint's
        dense heads and the detection after them (NMS, borders, top-k,
        descriptor sampling), once per image; LightGlue's layers; its
        assignment and mutual filter."""
        lg = m.model.lightglue
        mods = {"superpoint": m.model.superpoint, "lightglue": lg,
                "first": lg.transformers[0], "last": lg.transformers[-1]}
        ev, _, total = self.timed_call(m, args, mods)
        sp, glue = ev["superpoint"], ev["lightglue"]
        spans = {
            "SuperPoint dense heads (2 images)":
                sp[0].elapsed_time(sp[1]) + sp[2].elapsed_time(sp[3]),
            "detection: NMS, borders, top-k, sampling (2 images)":
                sp[1].elapsed_time(sp[2]) + sp[3].elapsed_time(glue[0]),
            f"LightGlue's {len(lg.transformers)} layers":
                ev["first"][0].elapsed_time(ev["last"][1]),
            "assignment and filter": ev["last"][1].elapsed_time(glue[1]),
        }
        self.print_stages(what, spans, total,
                          "rest (position encoding, pad uniforms, gather)")

    # -- 15 -----------------------------------------------------------------
    def lightglue_card_vs_cpu(self):
        import torch

        from gim_tpu_torch.api import Matcher
        from gim_tpu_torch.config import (GimConfig, LightGlueConfig,
                                          SuperPointConfig)
        from gim_tpu_torch.models.superpoint import extract

        cfg = GimConfig(
            superpoint=SuperPointConfig(max_num_keypoints=LG_CHECK_KPTS),
            lightglue=LightGlueConfig(filter_threshold=0.0))
        cpu = Matcher("gim_lightglue", cfg, generator=torch.Generator()
                      .manual_seed(0), device="cpu")
        card = Matcher("gim_lightglue", cfg,
                       state_dict=cpu.model.state_dict(), device=self.dev)
        S, h = LG_CHECK_IMG, LG_CHECK_IMG * 3 // 4
        g = torch.Generator().manual_seed(15)
        mask = torch.zeros(2, S, S, dtype=torch.bool)
        mask[:, :h] = True
        imgs = [torch.rand((2, 3, S, S), generator=g) * mask[:, None]
                for _ in range(2)]
        noise = [torch.rand((2, LG_CHECK_KPTS, 2), generator=g)
                 for _ in range(2)]
        hw = torch.tensor([[h, S]] * 2, dtype=torch.float32)

        def run(model, dev):
            with torch.inference_mode():
                p = [extract(model.superpoint, im.to(dev), cfg.superpoint,
                             hw.to(dev), n.to(dev))
                     for im, n in zip(imgs, noise)]
                wh = hw.flip(-1).to(dev)
                out = model.lightglue(
                    p[0]["keypoints"], p[1]["keypoints"],
                    p[0]["descriptors"], p[1]["descriptors"], wh, wh,
                    p[0]["valid"], p[1]["valid"])
            return ([{k: v.cpu() for k, v in q.items()} for q in p],
                    {k: v.cpu() for k, v in out.items()})

        before = self.kernel_counts()["lightglue_attention"]
        (c0, c1), co = run(card.model, self.dev)
        ran = self.kernel_counts()["lightglue_attention"] - before
        assert ran == LG_ATTN_PER_CALL, ran
        (h0, h1), ho = run(cpu.model, "cpu")
        same = [(a["keypoints"] == b["keypoints"]).all(-1)
                & (a["valid"] == b["valid"]) for a, b in ((c0, h0), (c1, h1))]
        share = float(torch.cat(same, 1).float().mean())
        # rows and columns whose keypoints agree, dustbins included
        rows = torch.cat([same[0], torch.ones(2, 1, dtype=torch.bool)], 1)
        cols = torch.cat([same[1], torch.ones(2, 1, dtype=torch.bool)], 1)
        both = rows[:, :, None] & cols[:, None, :]
        la = float((co["log_assignment"] - ho["log_assignment"])
                   .abs()[both].max())
        v = h0["valid"]
        m_agree = float((co["matches0"] == ho["matches0"])[v].float().mean())
        n_match = int((ho["matches0"] >= 0).sum())
        print(f"  2 pairs at {S} px ({S} x {h} content), {LG_CHECK_KPTS} "
              f"keypoints, {cfg.lightglue.n_layers} layers of width "
              f"{cfg.lightglue.descriptor_dim}, threshold 0, float32, "
              f"TF32 off: keypoints and valid flags equal on {share:.4f} of "
              f"slots (limit {LG_AGREE}); log-assignment max diff {la:.2e} "
              f"where they agree (limit {LG_TOL}); matches0 equal on "
              f"{m_agree:.4f} of valid slots (limit {LG_AGREE}); "
              f"{n_match} matches on the CPU; the card's attention on the "
              f"masked flash kernel ({ran} launches)")
        assert share >= LG_AGREE and la <= LG_TOL and m_agree >= LG_AGREE
        assert n_match > 0 and int(v.sum()) > 0

    # -- 16 -----------------------------------------------------------------
    def lightglue_zeb_path(self):
        import tempfile

        import numpy as np
        import torch

        from gim_tpu_torch.api import Matcher
        from gim_tpu_torch.cli.analysis import read_dump
        from gim_tpu_torch.config import GimConfig, LightGlueConfig
        from gim_tpu_torch.eval import zeb as E

        n_hyp, use_conf = E.RANSAC_ZOO["MAGSAC"]
        B = self.lg_batch
        cfg = GimConfig(lightglue=LightGlueConfig(filter_threshold=0.0))
        m = Matcher("gim_lightglue", cfg, generator=torch.Generator()
                    .manual_seed(0), device=self.dev)
        rng = np.random.default_rng(16)
        pairs = [zeb_batch(rng, i) for i in range(LG_ZEB_PAIRS)]
        batches = [stack_batches(pairs[i:i + B])
                   for i in range(0, LG_ZEB_PAIRS, B)]
        match_s = []
        calls = 0

        def match(batch):
            nonlocal calls
            calls += 1
            t0 = time.perf_counter()
            r = m.match(*(batch[k] for k in ("color0", "color1", "scale0",
                                             "scale1", "mask0", "mask1")))
            torch.cuda.synchronize()
            match_s.append(time.perf_counter() - t0)
            return r

        self.kernel_counts(reset=True)
        E.evaluate(match, iter(batches[:1]), num_hypotheses=n_hyp,
                   use_conf=use_conf, progress=False)          # warm-up
        torch.cuda.synchronize()
        match_s.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rows = E.evaluate(match, iter(batches), num_hypotheses=n_hyp,
                          use_conf=use_conf, progress=False)
        total = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        counts = self.kernel_counts()
        want = dict.fromkeys(counts, 0)
        want["lightglue_attention"] = LG_ATTN_PER_CALL * calls
        assert counts == want, counts
        n = len(rows)
        match_ms = sum(match_s) * 1e3
        print(f"  gim_lightglue f32, threshold 0, {n} pairs of "
              f"{ZEB_CANVAS}^2 canvases in {len(batches)} batch(es) of {B}, "
              f"MAGSAC preset ({n_hyp} hypotheses): {total / n:.2f} ms per "
              f"pair, of which match {match_ms / n:.2f} ms and pair_metrics "
              f"(with the host copies of the rows) "
              f"{(total - match_ms) / n:.2f} ms; {n / (total / 1e3):.3f} "
              f"pairs/s; peak memory {peak / 2**30:.2f} GiB; "
              f"{LG_ATTN_PER_CALL} masked flash launches a call, no other "
              f"kernel [{self.card}]")
        n_valid = [len(r["epi_errs"]) for r in rows]
        with tempfile.TemporaryDirectory() as d:
            path = E.write_dump(rows, d, "gim_lightglue", "ZEB-memory",
                                "smoke")
            det = read_dump(path)
        print(f"  dump: {len(det['R_errs'])} rows read back by "
              f"cli/analysis.read_dump; valid matches per pair {n_valid} "
              f"(seeded random weights: no quality claim)")
        assert len(det["R_errs"]) == LG_ZEB_PAIRS == n
        assert sum(n_valid) > 0

    # -- 17-19: gim_loftr training -----------------------------------------
    def train_main_path(self):
        import numpy as np
        import torch

        from gim_tpu_torch.cli.train import Trainer
        from gim_tpu_torch.config import GimConfig, LoFTRConfig

        dev = torch.device(self.dev)
        cfg = GimConfig(loftr=LoFTRConfig(max_matches=TRAIN_MATCHES,
                                          fused_matching=True))
        S = TRAIN_IMG
        with torch.enable_grad():
            t0 = time.perf_counter()
            tr = Trainer(cfg, 1, 1, 1000, dev)
            print(f"  trainer built in {time.perf_counter() - t0:.1f} s")
            batch = train_batch(np.random.default_rng(17), 1, S,
                                TRAIN_LABELS, dev)
            self.kernel_counts(reset=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, times = [], []
            for i in range(TRAIN_WARMUP + TRAIN_STEPS):
                t0 = time.perf_counter()
                try:
                    logs = tr.step(batch)
                except torch.cuda.OutOfMemoryError:
                    print(f"  step {i + 1} does not fit in the card's "
                          f"memory:\n{torch.cuda.memory_summary()}")
                    raise
                torch.cuda.synchronize()
                if i >= TRAIN_WARMUP:
                    times.append(time.perf_counter() - t0)
                losses.append({k: float(v) for k, v in logs.items()})
            peak = torch.cuda.max_memory_allocated()
            counts = self.kernel_counts()
            for i, l in enumerate(losses):
                print(f"    step {i + 1}: loss {l['loss']:.6f} loss_c "
                      f"{l['loss_c']:.6f} loss_f {l['loss_f']:.6f}")
            assert all(np.isfinite(list(l.values())).all() for l in losses)
            print(f"  kernel launches over {len(losses)} steps: {counts}")
            assert not any(counts.values()), counts
            ms = statistics.median(times) * 1e3
            print(f"  training step, 1 pair of {S}^2, float32, TF32 off, "
                  f"{TRAIN_MATCHES} fine slots, {TRAIN_LABELS} labels: "
                  f"median {ms:.2f} ms per step (runs "
                  f"{[round(t * 1e3, 2) for t in times]}), "
                  f"{1e3 / ms:.4f} training pairs/s, peak memory "
                  f"{peak / 2**30:.2f} GiB [{self.card}]")
            self.train_stages(tr, batch)
            self.profile(lambda: tr.step(batch))

    def train_stages(self, tr, batch):
        """One step through the pieces `train.loop.loftr_train_step` is
        made of, with CUDA events and the peak memory of each stage:
        forward (the model, to its forward hook), loss (GT and losses),
        backward (`loop.backward`), optimizer (the clipped AdamW step and
        the schedule). Then the device's kernels in the forward and loss
        alone: which convolution algorithms cuDNN runs."""
        import torch

        from gim_tpu_torch.train import loop

        model, opt = tr.model, tr.optimizer
        ev = {k: torch.cuda.Event(enable_timing=True)
              for k in ("start", "forward", "loss", "backward", "optimizer")}
        peaks = {}

        def end(stage):
            ev[stage].record()
            peaks[stage] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()

        h = model.register_forward_hook(lambda *_: end("forward"))
        try:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            opt.zero_grad(set_to_none=False)
            ev["start"].record()
            loss, _ = loop.loftr_loss(model, batch)
            end("loss")
            loop.backward(loss, opt)
            end("backward")
            opt.step()
            tr.scheduler.step()
            end("optimizer")
            torch.cuda.synchronize()
        finally:
            h.remove()
        tr.step_count += 1
        total = ev["start"].elapsed_time(ev["optimizer"])
        print(f"  stages of one training step, {total:.2f} ms on the "
              f"stream, peak memory per stage above the "
              f"{base / 2**30:.2f} GiB held between steps [{self.card}]:")
        prev = "start"
        for k in ("forward", "loss", "backward", "optimizer"):
            t = ev[prev].elapsed_time(ev[k])
            print(f"    {t:9.3f} ms  {t / total:6.3f}  {k:10s} peak "
                  f"{peaks[k] / 2**30:6.2f} GiB")
            prev = k
        print(f"  forward and loss alone (cuDNN {torch.backends.cudnn.version()}"
              f", benchmark {torch.backends.cudnn.benchmark}):")
        self.profile(lambda: loop.loftr_loss(model, batch), top=12)

    def train_card_vs_cpu(self):
        import numpy as np
        import torch

        from gim_tpu_torch.config import LoFTRConfig, TrainerConfig
        from gim_tpu_torch.models.common import init_weights
        from gim_tpu_torch.models.loftr.model import padding_draws
        from gim_tpu_torch.train import loop

        cfg = LoFTRConfig(max_matches=CHECK_MATCHES)
        tcfg = TrainerConfig(canonical_bs=2, canonical_lr=1e-3,
                             warmup_steps=1)
        base = init_weights(loop.build_train_model(cfg),
                            torch.Generator().manual_seed(18))
        batch = train_batch(np.random.default_rng(18), 2, CHECK_IMG,
                            CHECK_LABELS, "cpu")
        uniform, gumbel = padding_draws(2, CHECK_MATCHES, CHECK_LABELS,
                                        "cpu")

        def run(dev, dtype):
            model = loop.build_train_model(cfg)
            model.load_state_dict(base.state_dict())
            model.to(device=dev, dtype=dtype)
            opt, sched = loop.make_optimizer(model.parameters(), tcfg, 1, 2,
                                             100)
            lr = sched.get_last_lr()[0]
            b = {k: v.to(dev, dtype if k.startswith("color") else None)
                 for k, v in batch.items()}
            with torch.enable_grad():
                logs = loop.loftr_train_step(model, opt, sched, b,
                                             uniform.to(dev, dtype),
                                             gumbel.to(dev, dtype))
            cpu = {k: v.detach().double().cpu()
                   for k, v in model.state_dict().items()}
            grads = {k: p.grad.double().cpu()
                     for k, p in model.named_parameters()}
            return {k: float(v) for k, v in logs.items()}, grads, cpu, lr

        for name, dtype in (("float64", torch.float64),
                            ("float32", torch.float32)):
            tol = CHECK_TOL[name]
            (lc, gc, sc, lr), (lg, gg, sg, _) = (run("cpu", dtype),
                                                 run(self.dev, dtype))
            rel = {k: abs(lg[k] - lc[k]) / abs(lc[k]) for k in lc}
            gerr = {k: float((gg[k] - gc[k]).norm() / gc[k].norm())
                    for k in gc}
            worst = max(gerr, key=gerr.get)
            gall = float(torch.sqrt(sum((gg[k] - gc[k]).square().sum()
                                        for k in gc)
                                    / sum(gc[k].square().sum() for k in gc)))
            stats = max(float((sg[k] - sc[k]).abs().max()
                              / sc[k].abs().max())
                        for k in sc if k.endswith(("running_mean",
                                                   "running_var")))
            d = torch.cat([(sg[k] - sc[k]).abs().ravel() for k in gc])
            share = float((d <= 1e-2 * lr).double().mean())
            print(f"  {name}, 2 pairs at {CHECK_IMG} px: losses card "
                  f"{lg['loss']:.8f} / CPU {lc['loss']:.8f} (worst rel "
                  f"{max(rel.values()):.2e}, limit {tol['loss']}); gradient "
                  f"worst leaf {gerr[worst]:.2e} ({worst}), all {gall:.2e} "
                  f"(limits {tol['grad']}); BatchNorm statistics "
                  f"{stats:.2e} of max (limit {tol['stats']}); parameters "
                  f"after the update within 1e-2 lr: {share:.5f} (limit "
                  f"{tol['share']}), max {float(d.max()) / lr:.4f} lr")
            assert max(rel.values()) <= tol["loss"]
            assert gerr[worst] <= tol["grad"][0] and gall <= tol["grad"][1]
            assert stats <= tol["stats"]
            assert share >= tol["share"] and float(d.max()) <= 2 * lr

    def train_loop_and_checkpoints(self):
        import tempfile

        import numpy as np
        import torch
        import torch.distributed as dist

        from gim_tpu_torch.api import Matcher
        from gim_tpu_torch.cli.train import Trainer, train_loop
        from gim_tpu_torch.config import GimConfig, LoFTRConfig
        from gim_tpu_torch.weights import port

        dev = torch.device(self.dev)
        cfg = GimConfig(loftr=LoFTRConfig(max_matches=LOOP_MATCHES))
        rng = np.random.default_rng(19)
        batches = [train_batch(rng, 1, LOOP_IMG, LOOP_LABELS, dev)
                   for _ in range(LOOP_STEPS)]

        def trainer(seed):
            return Trainer(cfg, 1, 1, 100, dev,
                           torch.Generator().manual_seed(seed))

        def state(tr):
            return ({k: v.clone() for k, v in tr.model.state_dict().items()},
                    {i: {k: v.clone() for k, v in st.items()}
                     for i, st in tr.optimizer.state_dict()["state"].items()},
                    tr.scheduler.state_dict()["last_epoch"], tr.step_count)

        def assert_equal(a, b, what):
            diff = max([float((a[0][k].double() - b[0][k].double()).abs()
                              .max()) for k in a[0]]
                       + [float((a[1][i][k].double() - b[1][i][k].double())
                                .abs().max())
                          for i in a[1] for k in a[1][i]])
            print(f"  {what}: largest difference {diff:.3g}, scheduler "
                  f"{a[2]} / {b[2]}, steps {a[3]} / {b[3]}")
            assert diff == 0.0 and a[2:] == b[2:], what

        with tempfile.TemporaryDirectory() as d, deterministic() as warned, \
                torch.enable_grad():
            da, db = os.path.join(d, "a"), os.path.join(d, "b")
            a = trainer(0)
            la = train_loop(a, iter(batches), LOOP_STEPS, ckpt_dir=da,
                            save_interval=2, log_interval=1)
            print(f"  uninterrupted: {sorted(os.listdir(da))}")
            b = trainer(1)            # other weights: the load must set all
            b.load(os.path.join(da, port.checkpoint_name(2)))
            lb = train_loop(b, iter(batches[2:]), LOOP_STEPS, ckpt_dir=db,
                            save_interval=2, log_interval=1)
            assert la[2:] == lb, (la[2:], lb)
            assert_equal(state(a), state(b), "resumed from step 2 against "
                         "the uninterrupted run at step 4")

            m = Matcher.from_checkpoint("gim_loftr", da, cfg, device=dev)
            for k, v in m.model.state_dict().items():
                assert torch.equal(v, a.model.state_dict()[k]), k
            with torch.no_grad():
                r = m.match(batches[0]["color0"], batches[0]["color1"])
            assert torch.isfinite(r.kpts1).all() and r.kpts1.shape == (
                1, LOOP_MATCHES, 2)
            print(f"  Matcher.from_checkpoint on the card: "
                  f"{int(r.valid.sum())} valid matches of {LOOP_MATCHES}")

            ckpt = os.path.join(da, port.checkpoint_name(2))
            plain = trainer(2)
            plain.load(ckpt)
            lp = plain.step(batches[2])
            dist.init_process_group("nccl", init_method="tcp://localhost:"
                                    f"{free_port()}", rank=0, world_size=1)
            try:
                grouped = trainer(3)
                grouped.load(ckpt)
                lg = grouped.step(batches[2])
            finally:
                dist.destroy_process_group()
            assert {k: float(v) for k, v in lp.items()} == {
                k: float(v) for k, v in lg.items()}, (lp, lg)
            assert_equal(state(plain), state(grouped), "one step under a "
                         "one-process NCCL group against no group")
        notes = sorted({str(w.message).splitlines()[0][:160]
                        for w in warned})
        for n in notes:
            print(f"  deterministic mode: {n}")

    # -- 20-25: the training of gim_dkm, gim_roma and gim_lightglue ---------
    def head_trainer(self, weight: str, cfg, seed: int | None = None):
        import torch

        from gim_tpu_torch.cli.train import Trainer

        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return Trainer(cfg, 1, 1, 1000, torch.device(self.dev), gen,
                       weight=weight)

    def head_train_main_path(self, weight: str):
        """Phases 20-22: the CLI's `Trainer` of `weight` at its operating
        point (`cli.train.head_config`), float32, TF32 off, one pair with
        TRAIN_LABELS labels: warm-up and timed steps, ms per step, pairs/s,
        peak memory, each step's losses finite, no kernel launched; the
        stage split (`head_train_stages`) and a profile of one step.
        Returns (trainer, batch)."""
        import numpy as np
        import torch

        from gim_tpu_torch.cli.train import head_config

        S = HEAD_TRAIN_IMG[weight]
        cfg = head_config(weight, S)
        with torch.enable_grad():
            t0 = time.perf_counter()
            tr = self.head_trainer(weight, cfg)
            n = sum(p.numel() for p in tr.model.parameters())
            print(f"  {weight} trainer built in {time.perf_counter() - t0:.1f}"
                  f" s, {n} parameters, all in the optimizer")
            batch = train_batch(np.random.default_rng(20), 1, S,
                                TRAIN_LABELS, self.dev)
            self.kernel_counts(reset=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, times = [], []
            for i in range(TRAIN_WARMUP + TRAIN_STEPS):
                t0 = time.perf_counter()
                try:
                    logs = tr.step(batch)
                except torch.cuda.OutOfMemoryError:
                    print(f"  step {i + 1} does not fit in the card's "
                          f"memory:\n{torch.cuda.memory_summary()}")
                    raise
                torch.cuda.synchronize()
                if i >= TRAIN_WARMUP:
                    times.append(time.perf_counter() - t0)
                losses.append({k: float(v) for k, v in logs.items()})
            peak = torch.cuda.max_memory_allocated()
            counts = self.kernel_counts()
            for i, l in enumerate(losses):
                print(f"    step {i + 1}: " + " ".join(
                    f"{k} {v:.6f}" for k, v in l.items()))
            assert all(np.isfinite(list(l.values())).all() for l in losses)
            print(f"  kernel launches over {len(losses)} steps: {counts}")
            assert not any(counts.values()), counts
            ms = statistics.median(times) * 1e3
            self.head_step_ms[weight] = ms
            print(f"  {weight} training step, 1 pair of {S}^2, float32, TF32 "
                  f"off, {TRAIN_LABELS} labels: median {ms:.2f} ms per step "
                  f"(runs {[round(t * 1e3, 2) for t in times]}), "
                  f"{1e3 / ms:.4f} training pairs/s, peak memory "
                  f"{peak / 2**30:.2f} GiB [{self.card}]")
            self.head_train_stages(tr, batch)
            self.profile(lambda: tr.step(batch), top=12)
        return tr, batch

    def head_train_stages(self, tr, batch):
        """One step of the trainer's head through the pieces its step is
        made of, with CUDA events and each stage's peak memory. gim_dkm and
        gim_roma: forward (`train_corresps`, to the decoder's forward
        hook), loss (`dense_warp_loss`), backward, optimizer.
        gim_lightglue: SuperPoint's dense forward of both images (to its
        second forward hook), the sparse stage (NMS, top-k, descriptor
        sampling; to LightGlue's pre-hook), LightGlue, loss (GT
        assignment, NLL, detector and descriptor losses), backward,
        optimizer."""
        import torch

        from gim_tpu_torch.train import loop
        from gim_tpu_torch.train.dense_losses import dense_loss
        from gim_tpu_torch.train.lightglue_loop import lightglue_loss

        model, opt = tr.model, tr.optimizer
        marks = Marks()
        hooks = []
        if tr.weight == "gim_lightglue":
            sp_calls = []

            def sp_end(*_):
                sp_calls.append(1)
                if len(sp_calls) == 2:
                    marks.end("superpoint")

            hooks = [model["superpoint"].register_forward_hook(sp_end),
                     model["lightglue"].register_forward_pre_hook(
                         lambda *_: marks.end("sparse")),
                     model["lightglue"].register_forward_hook(
                         lambda *_: marks.end("lightglue"))]
        else:
            hooks = [model.decoder.register_forward_hook(
                lambda *_: marks.end("forward"))]
        try:
            opt.zero_grad(set_to_none=False)
            marks.start()
            if tr.weight == "gim_lightglue":
                loss, _ = lightglue_loss(model, tr.cfg, batch)
            else:
                loss, _ = dense_loss(model, batch)
            marks.end("loss")
            loop.backward(loss, opt)
            marks.end("backward")
            opt.step()
            tr.scheduler.step()
            marks.end("optimizer")
        finally:
            for h in hooks:
                h.remove()
        tr.step_count += 1
        marks.report(f"{tr.weight} training step", self.card)

    def dkm_train_main_path(self):
        """Phase 20: training takes no kernel (a step is never in
        inference mode, and the ConvRefiner in train_mode does not
        fuse)."""
        self.head_train_main_path("gim_dkm")

    def roma_train_main_path(self):
        """Phase 21: no kernel either where DINOv2 runs under no_grad."""
        self.head_train_main_path("gim_roma")

    def lightglue_train_main_path(self):
        """Phase 22."""
        self.head_train_main_path("gim_lightglue")

    @staticmethod
    def head_check_config(weight: str, dtype: str):
        """The CPU tests' small configuration of `weight` (tests/
        test_torch_{dkm,roma,lightglue}_train.py) at full width, dense heads
        at config dtype `dtype`."""
        from gim_tpu_torch.cli.train import head_config
        from gim_tpu_torch.config import replace

        cfg = head_config(weight, HEAD_CHECK[weight][0])
        if weight == "gim_dkm":
            return replace(cfg, dkm=replace(cfg.dkm, dtype=dtype))
        if weight == "gim_roma":
            return replace(cfg, roma=replace(
                cfg.roma, coarse_res=56, dino_depth=2, num_decoder_blocks=1,
                dtype=dtype))
        return replace(
            cfg, superpoint=replace(cfg.superpoint, max_num_keypoints=64),
            lightglue=replace(cfg.lightglue, descriptor_dim=64, n_layers=3,
                              input_dim=256))

    def head_card_vs_cpu(self):
        """Phase 23: each head's step on the card against the CPU, same
        weights and batch, at the CPU tests' sizes; gim_dkm and gim_roma in
        float64 (config dtype; their float32 pins stay) and float32,
        gim_lightglue in float32 (its modules have no other dtype, as in
        the JAX package)."""
        import re

        import numpy as np
        import torch

        from gim_tpu_torch.cli.train import build_train_model
        from gim_tpu_torch.config import TrainerConfig
        from gim_tpu_torch.models.common import init_weights
        from gim_tpu_torch.train import loop

        # convolution biases before a train-mode BatchNorm: zero gradient
        # by construction, rounding on both sides
        before_bn = re.compile(r"(block1|hidden_blocks\.\d+)\.0\.bias$"
                               r"|rrb_[du]\.\d+\.conv2\.bias$"
                               r"|proj\.\d+\.0\.bias$")
        for weight in HEAD_CHECK:
            S, B, N = HEAD_CHECK[weight]
            tol = HEAD_CHECK_TOL[weight]
            base = init_weights(build_train_model(
                weight, self.head_check_config(weight, "float32")),
                torch.Generator().manual_seed(23)).state_dict()
            batch = train_batch(np.random.default_rng(23), B, S, N, "cpu")
            tcfg = TrainerConfig(canonical_bs=B, canonical_lr=1e-3,
                                 warmup_steps=1)

            def run(dev, dtype):
                tr = self.head_trainer(weight,
                                       self.head_check_config(weight, dtype))
                tr.model.load_state_dict(base)
                tr.model.to(dev)
                tr.optimizer, tr.scheduler = loop.make_optimizer(
                    tr.model.parameters(), tcfg, 1, B, 100)
                lr = tr.scheduler.get_last_lr()[0]
                with torch.enable_grad():
                    logs = tr.step({k: v.to(dev) for k, v in batch.items()})
                return ({k: float(v) for k, v in logs.items()},
                        {k: p.grad.double().cpu()
                         for k, p in tr.model.named_parameters()},
                        {k: v.double().cpu()
                         for k, v in tr.model.state_dict().items()}, lr)

            dtypes = (("float32",) if weight == "gim_lightglue"
                      else ("float64", "float32"))
            for dtype in dtypes:
                t0 = time.perf_counter()
                lc, gc, sc, lr = run("cpu", dtype)
                t1 = time.perf_counter()
                lg, gg, sg, _ = run(self.dev, dtype)
                print(f"  {weight} {dtype}: CPU step {t1 - t0:.1f} s, card "
                      f"step {time.perf_counter() - t1:.1f} s (host clock, "
                      f"build included)")
                rel = max(abs(lg[k] - lc[k]) / abs(lc[k]) for k in lc
                          if lc[k])
                total = float(torch.sqrt(sum(g.square().sum()
                                             for g in gc.values())))
                nil = [k for k in gc if before_bn.search(k)]
                nil_size = max([float(gg[k].norm()) / total for k in nil],
                               default=0.0)
                keep = [k for k in gc if k not in nil]
                gerr = {k: float((gg[k] - gc[k]).norm() / gc[k].norm())
                        if gc[k].any() else float(gg[k].norm())
                        for k in keep}
                worst = max(gerr, key=gerr.get)
                gall = float(torch.sqrt(
                    sum((gg[k] - gc[k]).square().sum() for k in keep)
                    / sum(gc[k].square().sum() for k in keep)))
                # a statistic that stays at zero (an encoder's in eval)
                # counts as agreeing when both sides hold zero
                stats = max([float((sg[k] - sc[k]).abs().max()
                                   / sc[k].abs().max().clamp_min(1e-30))
                             for k in sc if k.endswith(("running_mean",
                                                        "running_var"))],
                            default=0.0)
                d = torch.cat([(sg[k] - sc[k]).abs().ravel() for k in gc])
                share = float((d <= 1e-2 * lr).double().mean())
                print(f"  {weight} {dtype}, {B} pairs at {S} px: loss card "
                      f"{lg['loss']:.8f} / CPU {lc['loss']:.8f} (worst rel "
                      f"{rel:.2e}, limit {tol['loss']}); gradient worst leaf "
                      f"{gerr[worst]:.2e} ({worst}), all {gall:.2e} (limits "
                      f"{tol['grad']}), {len(nil)} zero by construction up "
                      f"to {nil_size:.1e} of the whole; statistics "
                      f"{stats:.2e} (limit {tol['stats']}); parameters "
                      f"within 1e-2 lr {share:.5f} (limit {tol['share']}), "
                      f"max {float(d.max()) / lr:.4f} lr")
                assert rel <= tol["loss"]
                assert gerr[worst] <= tol["grad"][0]
                assert gall <= tol["grad"][1] and nil_size < 1e-4
                assert stats <= tol["stats"]
                assert share >= tol["share"] and float(d.max()) <= 2 * lr

    def head_train_loop(self):
        """Phase 24: the CLI's `train_loop` for each head on in-memory
        batches (HEAD_LOOP_IMG; gim_roma's coarse_res cut to 224 and its
        DINOv2 to 2 blocks, whose seeded weights take seconds to draw on
        the host, full depth being phase 21's): 4 steps
        with a save at 2; a trainer of other weights loads the step-2
        checkpoint and holds exactly the uninterrupted run's step-2 state,
        then runs to 4 (torch's deterministic mode) and equals the
        uninterrupted run bit for bit, losses and state, for every head,
        with no deterministic-mode warning naming `grid_sampler_2d_backward`
        (the port's `ops.sampling.BilinearSample` takes its place);
        `Matcher.from_checkpoint` loads the step-4 file and matches a
        pair."""
        import tempfile

        import numpy as np
        import torch

        from gim_tpu_torch.api import Matcher
        from gim_tpu_torch.cli.train import head_config, train_loop
        from gim_tpu_torch.config import replace
        from gim_tpu_torch.weights import port

        def state(tr):
            return ({k: v.clone() for k, v in tr.model.state_dict().items()},
                    {i: {k: v.clone() for k, v in st.items()}
                     for i, st in tr.optimizer.state_dict()["state"].items()},
                    tr.scheduler.state_dict()["last_epoch"], tr.step_count)

        def largest_diff(a, b):
            return max([float((a[0][k].double() - b[0][k].double()).abs()
                              .max()) for k in a[0]]
                       + [float((a[1][i][k].double() - b[1][i][k].double())
                                .abs().max())
                          for i in a[1] for k in a[1][i]])

        for weight, S in HEAD_LOOP_IMG.items():
            cfg = head_config(weight, S)
            if weight == "gim_roma":       # the loop, not the trunk's depth
                cfg = replace(cfg, roma=replace(cfg.roma, coarse_res=S,
                                                dino_depth=2))
            rng = np.random.default_rng(24)
            batches = [train_batch(rng, 1, S, LOOP_LABELS, self.dev)
                       for _ in range(LOOP_STEPS)]
            with tempfile.TemporaryDirectory() as d, \
                    deterministic() as warned, torch.enable_grad():
                a = self.head_trainer(weight, cfg, 0)
                la = train_loop(a, iter(batches), 2, ckpt_dir=d,
                                save_interval=2, log_interval=1)
                at2 = state(a)
                la += train_loop(a, iter(batches[2:]), LOOP_STEPS,
                                 ckpt_dir=d, save_interval=2, log_interval=1)
                b = self.head_trainer(weight, cfg, 1)
                b.load(os.path.join(d, port.checkpoint_name(2)))
                diff = largest_diff(state(b), at2)
                assert diff == 0.0 and state(b)[2:] == at2[2:], diff
                lb = train_loop(b, iter(batches[2:]), LOOP_STEPS,
                                log_interval=1)
                after = largest_diff(state(a), state(b))
                worst = max(abs(x["loss"] - y["loss"]) / abs(x["loss"])
                            for x, y in zip(la[2:], lb))
                print(f"  {weight} at {S} px: {sorted(os.listdir(d))}; the "
                      f"step-2 checkpoint restores the run's state exactly; "
                      f"resumed to step {b.step_count}: losses "
                      f"{[round(x['loss'], 6) for x in lb]} against "
                      f"{[round(x['loss'], 6) for x in la[2:]]} (worst rel "
                      f"{worst:.2e}), largest state difference {after:.3g}"
                      f"{' (bit for bit)' if after == 0 else ''}")
                assert after == 0.0 and worst == 0.0, (after, worst)
                m = Matcher.from_checkpoint(weight, d, cfg, device=self.dev)
                sd = a.model.state_dict()
                for k, v in m.model.state_dict().items():
                    assert torch.equal(v, sd[k]), k
                with torch.no_grad():
                    r = m.match(batches[0]["color0"], batches[0]["color1"])
                assert (torch.isfinite(r.kpts0).all()
                        and torch.isfinite(r.kpts1).all())
                print(f"  Matcher.from_checkpoint({weight}) on the card: "
                      f"{int(r.valid.sum())} valid matches of "
                      f"{r.valid.shape[1]}")
            notes = sorted({str(w.message).splitlines()[0][:160]
                            for w in warned})
            for n in notes:
                print(f"  deterministic mode: {n}")
            assert not any("grid_sampler" in n for n in notes), notes

    def kernels_refuse_backward(self):
        """Phase 25: K1 (dual_softmax_mutual), K2 (fused_dw_block), K3
        (flash_sdpa) and its masked variant (flash_sdpa_masked) on the card
        with inputs that require a gradient: the
        forward agrees with the plain version (K1: indices on >= 99.9 % of
        rows and conf within TOL_F32; K2, K3 within TOL_F32 and
        TOL_ATTN_F32 of the largest magnitude) and `.backward()` raises
        `KernelBackwardError` naming the kernel, leaving no gradient."""
        import torch

        from gim_tpu_torch.ops.kernels import dsmax, flash, refiner
        from gim_tpu_torch.ops.kernels.forward_only import \
            KernelBackwardError

        dev = self.dev
        g = torch.Generator(device=dev).manual_seed(25)

        def rand(*shape, scale=1.0):
            return (scale * torch.randn(shape, generator=g, device=dev)
                    ).requires_grad_()

        cases = {
            "dual_softmax_mutual": (dsmax.dual_softmax_mutual,
                                    dsmax.dual_softmax_mutual_plain,
                                    (rand(2, 1000, 256, scale=0.06),
                                     rand(2, 1300, 256, scale=0.06)),
                                    (0.1,)),
            "refiner_block": (refiner.fused_dw_block,
                              refiner.fused_dw_block_plain,
                              (rand(2, 144, 64, 80), rand(144, 25, scale=0.2),
                               rand(144), rand(144, 144, scale=0.08),
                               rand(144)), ()),
            "flash_attention": (flash.flash_sdpa, flash.flash_sdpa_plain,
                                (rand(2, 8, 577, 64), rand(2, 8, 577, 64),
                                 rand(2, 8, 577, 64)), ()),
            "lightglue_attention": (
                flash.flash_sdpa_masked, flash.flash_sdpa_masked_plain,
                (rand(2, 4, 300, 64), rand(2, 4, 310, 64),
                 rand(2, 4, 310, 64)),
                (torch.rand(2, 300, device=dev, generator=g) > 0.1,
                 torch.rand(2, 310, device=dev, generator=g) > 0.1)),
        }
        for name, (kernel, plain, tensors, rest) in cases.items():
            with torch.enable_grad():
                got = kernel(*tensors, *rest)
            with torch.no_grad():
                want = plain(*(t.detach() for t in tensors), *rest)
            if name == "dual_softmax_mutual":
                agree = float((got[0] == want[0]).double().mean())
                err = float((got[1].detach() - want[1]).abs().max())
                out = got[1]
                print(f"  {name}: indices agree on {agree:.5f} of rows, conf "
                      f"within {err:.2e}")
                assert agree >= MIN_AGREE and err <= TOL_F32
            else:
                err = float((got.detach() - want).abs().max()
                            / want.abs().max())
                out = got
                print(f"  {name}: within {err:.2e} of the plain version's "
                      f"largest magnitude")
                assert err <= (TOL_F32 if name == "refiner_block"
                               else TOL_ATTN_F32)
            assert out.requires_grad
            try:
                with torch.enable_grad():
                    out.sum().backward()
            except KernelBackwardError as e:
                assert name in str(e), e
                print(f"    backward raises: {e}")
            else:
                raise AssertionError(f"a backward through {name} did not "
                                     "raise")
            assert all(t.grad is None for t in tensors)


    # -- 26-28: the sampling backward, ZEB across processes, the factory --
    def sampling_backward(self):
        """Phase 26: the port's bilinear-sampling backward
        (`ops.sampling.sample_backward`, through `BilinearSample`) on the
        inputs of one training step: gim_dkm at phase 20's point (its local
        correlation and its warps) and gim_lightglue at phase 22's
        (`sample_descriptors`), recorded as the step runs. For each call:
        two runs give the same bits, and the gradients agree with
        `aten.grid_sampler_2d_backward` (atomics) on the same output
        gradient, of their largest magnitude: in float32 within
        SAMPLE_TOL_F32, and run again in float64 within SAMPLE_TOL_F64.
        Both float32 backwards' errors against aten's float64 one are
        printed: at a source coordinate that is an exact integer the grid
        gradient jumps, and float32 and float64 may take either side. The
        ms and peak memory of both, summed over the step's calls of each
        kind; then phases 20-22's step times, which ran with this
        backward."""
        import numpy as np
        import torch

        from gim_tpu_torch.cli.train import head_config
        from gim_tpu_torch.ops import sampling

        calls = []
        real = sampling.BilinearSample.apply

        def record(image, grid, align, mode):
            names = {f.name for f in traceback.extract_stack()}
            kind = ("local correlation" if "local_correlation" in names
                    else "sample_descriptors"
                    if "sample_descriptors" in names else "warp")
            calls.append((kind, image.detach(), grid.detach(), align, mode))
            return real(image, grid, align, mode)

        for weight in ("gim_dkm", "gim_lightglue"):
            S = HEAD_TRAIN_IMG[weight]
            tr = self.head_trainer(weight, head_config(weight, S))
            batch = train_batch(np.random.default_rng(20), 1, S,
                                TRAIN_LABELS, self.dev)
            sampling.BilinearSample.apply = record
            try:
                with torch.enable_grad():
                    tr.step(batch)
            finally:
                del sampling.BilinearSample.apply
            del tr
        kinds = collections.defaultdict(list)
        for c in calls:
            kinds[c[0]].append(c)
        g = torch.Generator(device=self.dev).manual_seed(26)
        for kind, cs in kinds.items():
            tot = {"port": 0.0, "aten": 0.0}
            peak = {"port": 0, "aten": 0}
            # port, aten in float32 against aten's float64; port against
            # aten in float32; port against aten in float64
            worst = [0.0, 0.0, 0.0, 0.0]
            shapes = collections.Counter()
            for _, image, grid, align, mode in cs:
                N, C = image.shape[:2]
                gout = torch.randn((N, C, *grid.shape[1:3]), generator=g,
                                   device=self.dev)
                mode_i = {"zeros": 0, "border": 1}[mode]

                def port():
                    return sampling.sample_backward(image, grid, gout, align,
                                                    mode)

                def aten():
                    return torch.ops.aten.grid_sampler_2d_backward(
                        gout, image, grid, 0, mode_i, align, [True, True])

                a, b = port(), port()
                assert all(torch.equal(x, y) for x, y in zip(a, b)), kind
                want = aten()
                wide = (gout.double(), image.double(), grid.double())
                exact = torch.ops.aten.grid_sampler_2d_backward(
                    *wide, 0, mode_i, align, [True, True])
                port64 = sampling.sample_backward(wide[1], wide[2], wide[0],
                                                  align, mode)
                for x, y, z, x64 in zip(a, want, exact, port64):
                    scale = float(z.abs().max())
                    errs = [float((t.double() - z).abs().max()) / scale
                            for t in (x, y)]
                    errs.append(float((x - y).abs().max())
                                / float(y.abs().max()))
                    errs.append(float((x64 - z).abs().max()) / scale)
                    worst = [max(w, e) for w, e in zip(worst, errs)]
                    assert (errs[2] <= SAMPLE_TOL_F32
                            and errs[3] <= SAMPLE_TOL_F64), (
                        kind, tuple(image.shape), tuple(grid.shape), errs)
                del wide, exact, port64
                for name, fn in (("port", port), ("aten", aten)):
                    tot[name] += cuda_ms(fn, 3)
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    fn()
                    torch.cuda.synchronize()
                    peak[name] = max(peak[name],
                                     torch.cuda.max_memory_allocated() - base)
                shapes[(tuple(image.shape), tuple(grid.shape))] += 1
            print(f"  {kind}: {len(cs)} calls of one step, bit-identical in "
                  f"two runs; against aten's backward within {worst[2]:.2e} "
                  f"of the largest magnitude in float32 (limit "
                  f"{SAMPLE_TOL_F32:.0e}) and {worst[3]:.2e} in float64 "
                  f"(limit {SAMPLE_TOL_F64:.0e}); float32 against aten's "
                  f"float64, port {worst[0]:.2e}, aten {worst[1]:.2e}; "
                  f"backward "
                  f"{tot['port']:.3f} ms (port) against {tot['aten']:.3f} "
                  f"ms (aten), peak above the inputs "
                  f"{peak['port'] / 2**20:.1f} against "
                  f"{peak['aten'] / 2**20:.1f} MiB [{self.card}]")
            for (ish, gsh), n in sorted(shapes.items()):
                print(f"    image {ish}, grid {gsh}: {n}")
        calls.clear()
        print(f"  phases 20-22's median step, with this backward: "
              + ", ".join(f"{w} {ms:.2f} ms"
                          for w, ms in self.head_step_ms.items())
              + f" [{self.card}]")

    def zeb_two_processes(self):
        """Phase 27: ZEB across two processes on the one card. Each process
        (this script with `--zeb-worker`) joins a gloo group, builds phase
        13's gim_loftr (`zeb_matcher`), runs `eval.zeb.evaluate` on its
        strided share (`parallel.mesh.process_local_pairs`) of phase 13's
        pairs, then `gather_rows_multihost` and `barrier_multihost` (the
        group's store; no NCCL, which refuses two ranks on one card).
        Rank 0's dump must equal phase 13's one-process dump row for row;
        rank 1 writes none. Both processes' ms per pair and peaks."""
        import gc
        import tempfile

        import torch

        assert self.zeb_dump is not None, "phase 13 wrote no dump"
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  this process holds {torch.cuda.memory_reserved() / 2**30:.2f}"
              f" GiB of the card while the workers run "
              f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB in live "
              f"tensors)")
        port = free_port()
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--zeb-worker", str(r), str(port), d],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for r in range(2)]
            try:
                outs = [p.communicate(timeout=900)[0] for p in procs]
            finally:
                for p in procs:
                    p.kill()
            wall = time.perf_counter() - t0
            for r, (p, o) in enumerate(zip(procs, outs)):
                for line in o.strip().splitlines()[-6:]:
                    print(f"    rank {r}: {line}")
                assert p.returncode == 0, f"rank {r} exited {p.returncode}"
            stats = []
            for r in range(2):
                with open(os.path.join(d, f"rank{r}.json")) as f:
                    stats.append(json.load(f))
            dumps = [f for f in os.listdir(d) if f.endswith(".txt")]
            assert len(dumps) == 1, dumps                   # rank 0's only
            with open(os.path.join(d, dumps[0])) as f:
                got = f.read()
        for st in stats:
            print(f"  rank {st['rank']}: {st['pairs']} pairs, "
                  f"{st['ms_per_pair']:.2f} ms per pair, peak "
                  f"{st['peak_gib']:.2f} GiB [{self.card}]")
        print(f"  two processes on one card: {wall:.1f} s from spawn to "
              f"exit")
        want = self.zeb_dump
        if got != want:
            a = [l.split() for l in want.splitlines()]
            b = [l.split() for l in got.splitlines()]
            print(f"  rows differ from phase 13's: {len(a)} against "
                  f"{len(b)} lines")
            worst = 0.0
            for x, y in zip(a[1:], b[1:]):
                for u, v in zip(x[1:], y[1:]):
                    try:
                        worst = max(worst, abs(float(u) - float(v)))
                    except ValueError:
                        pass
            print(f"  largest difference in a numeric column: {worst:.4g} "
                  f"(cuDNN may pick another convolution algorithm when "
                  f"two processes share the card's memory)")
        assert got == want, "rank 0's dump differs from phase 13's"
        print(f"  rank 0's dump equals phase 13's one-process dump row for "
              f"row ({len(want.splitlines()) - 1} pairs)")

    def factory(self):
        """Phase 28: the video factory on the card, on frames given as
        arrays (the card's machine has no cv2): 4 frames of 640 x 360
        (1280 x 720 video at the segmenter's 640; vratio 2), a blocky
        texture moved 8 px a frame.
        - The full-width `SegmentationModel` (deep-stem dilated ResNet-50,
          PPM, 150 classes): ms per frame and peak memory; one frame
          against the CPU (logits within SEG_TOL of the largest
          magnitude, class maps equal where the top-two margin exceeds
          it).
        - The per-pair body `cli.video_preprocessor.label_pair` with the
          full-width `Matcher("gim_dkm")` at 840, float32, on the masked
          frames (masks from the segmenter on the card): labels kept and
          ms per stage.
        - `data.walk.onchip_fundamental_filter` (1024 hypotheses) at the
          label count the matcher gives and at 8192, on planted two-view
          labels, against the same call on the CPU with the card's
          uniforms (inlier masks on >= MASK_AGREE); ms per pair.
        - `Propagator.propagate_pair` over planted stores at skips
          10/20/40 (about 5000 labels a pair on 1280-wide frames) with
          the compiled chain linker, asserted to be the one that ran, and
          the filter on the card: labels kept and ms per stage."""
        import tempfile

        import numpy as np
        import torch

        from gim_tpu_torch import native
        from gim_tpu_torch.api import Matcher
        from gim_tpu_torch.cli.video_preprocessor import (
            label_pair, remove_static_matches)
        from gim_tpu_torch.data.synthetic import write_planted_label_stores
        from gim_tpu_torch.data.walk import (PropagationConfig, Propagator,
                                             onchip_fundamental_filter)
        from gim_tpu_torch.geometry.ransac import draw_noise
        from gim_tpu_torch.models.semseg import (MASKED_CLASSES,
                                                 build_segmenter)
        from gim_tpu_torch.ops.image import preprocess_image

        dev = self.dev
        rng = np.random.default_rng(28)
        h, w = FACTORY_FRAME
        tex = np.repeat(np.repeat(rng.integers(0, 256, (h // 4, w // 4 + 10,
                                                         3), np.uint8),
                                  4, 0), 4, 1)
        frames = [np.ascontiguousarray(tex[:, 8 * k:8 * k + w])
                  for k in range(FACTORY_FRAMES)]
        vratio = np.array([[FACTORY_VIDEO_W / w, FACTORY_VIDEO_H / h]],
                          np.float32)

        # the segmenter
        seg = build_segmenter(generator=torch.Generator().manual_seed(0),
                              device=dev)
        x = [torch.from_numpy(f).to(dev).permute(2, 0, 1)[None].float() / 255
             for f in frames]
        with torch.no_grad():
            seg(x[0])                                       # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ts = []
            for xi in x:
                t0 = time.perf_counter()
                logits = seg(xi)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        print(f"  segmenter (150 classes) on {len(frames)} frames of {w} x "
              f"{h}: median {statistics.median(ts):.2f} ms per frame (runs "
              f"{[round(t, 2) for t in ts]}), peak {peak / 2**30:.2f} GiB "
              f"[{self.card}]")
        cpu = build_segmenter(generator=torch.Generator().manual_seed(0),
                              device="cpu")
        with torch.no_grad():
            want = cpu(x[-1].cpu())
        got = logits.cpu()
        scale = float(want.abs().max())
        err = float((got - want).abs().max()) / scale
        top2 = want.topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > SEG_TOL * scale
        same = bool((got.argmax(1) == want.argmax(1))[clear].all())
        print(f"  card against CPU on one frame: logits within {err:.2e} of "
              f"the largest magnitude; class maps equal on the "
              f"{float(clear.double().mean()):.4f} of pixels whose top-two "
              f"margin exceeds {SEG_TOL:g}: {same}")
        assert got.shape == (1, 150, h, w) and err <= SEG_TOL and same
        del cpu

        classes = torch.tensor(list(MASKED_CLASSES.values()), device=dev)

        @torch.no_grad()
        def segment(rgb):          # frames at the segmenter's size
            t = torch.from_numpy(rgb).to(dev).permute(2, 0, 1)[None]
            return torch.isin(seg(t.float() / 255).argmax(1)[0],
                              classes).cpu().numpy()

        # the per-pair body with gim_dkm
        m = Matcher("gim_dkm", device=dev)

        @torch.no_grad()
        def match(rgb0, rgb1):
            p = [preprocess_image(r, FACTORY_IMG, 8, True, dev)
                 for r in (rgb0, rgb1)]
            r = m.match(p[0].color[None], p[1].color[None],
                        p[0].scale[None], p[1].scale[None],
                        p[0].mask[None], p[1].mask[None])
            return r.numpy_pair(0)

        for k in range(FACTORY_FRAMES - 1):
            st, t = {}, [time.perf_counter()]

            def mark(name):
                torch.cuda.synchronize()
                now = time.perf_counter()
                st[name] = round((now - t[0]) * 1e3, 2)
                t[0] = now

            out = label_pair(frames[k], frames[k + 1], match, vratio,
                             segment, device=dev, stages=mark)
            assert out is not None, "a mask covered a whole frame"
            labels, n = out
            assert labels.dtype == np.float32 and labels.shape[1:] == (4,)
            assert np.isfinite(labels).all()
            print(f"  pair {k}-{k + 1}{' (warm-up)' if k == 0 else ''}: "
                  f"{n} gim_dkm matches at {FACTORY_IMG}, {len(labels)} "
                  f"labels kept; ms per stage {st} [{self.card}]")

        # the fundamental filter, card against CPU
        masked = [f * ~segment(f)[..., None] for f in frames[:2]]
        k0, k1, _ = match(*masked)
        keep = remove_static_matches(k0, k1)
        n_match = int(keep.sum())
        for n in (n_match, FACTORY_PLANTED):
            p0, p1, _, _, _ = gt_scene(rng, n, n, 0.7, ZEB_NOISE_PX)
            M = 1 << int(np.ceil(np.log2(max(n, 8))))
            noise = draw_noise([torch.Generator(dev).manual_seed(n)], 1024,
                               M, dev)
            card = onchip_fundamental_filter(p0, p1, 0.5, device=dev,
                                             noise=noise)
            own = onchip_fundamental_filter(p0, p1, 0.5, device=dev)
            host = onchip_fundamental_filter(
                p0, p1, 0.5, device="cpu",
                noise=tuple(t.cpu() for t in noise))
            agree = float((card == host).mean())
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                onchip_fundamental_filter(p0, p1, 0.5, device=dev)
                ts.append((time.perf_counter() - t0) * 1e3)
            print(f"  fundamental filter, {n} planted labels (M = {M}): "
                  f"{int(card.sum())} kept on the card, masks agree with "
                  f"the CPU on {agree:.4f}; its own draws give the same "
                  f"mask: {bool(np.array_equal(own, card))}; median "
                  f"{statistics.median(ts):.2f} ms per pair [{self.card}]")
            assert np.array_equal(own, card) and agree >= MASK_AGREE
        t0 = time.perf_counter()
        kept = onchip_fundamental_filter(k0[keep], k1[keep], 0.5, device=dev)
        print(f"  on the matcher's {n_match} labels: {int(kept.sum())} kept "
              f"in {(time.perf_counter() - t0) * 1e3:.2f} ms")

        # propagation over planted stores
        spent = []

        def timed_filter(a, b, thr):
            t0 = time.perf_counter()
            keep = onchip_fundamental_filter(a, b, thr, device=dev)
            spent.append(((time.perf_counter() - t0) * 1e3, len(a),
                          int(keep.sum())))
            return keep

        with tempfile.TemporaryDirectory() as d:
            stores = write_planted_label_stores(
                os.path.join(d, "seq"), width=FACTORY_VIDEO_W,
                height=FACTORY_VIDEO_H, n_tracks=FACTORY_TRACKS)
            prop = Propagator({s: [st] for s, st in stores.items()},
                              FACTORY_VIDEO_W, PropagationConfig(),
                              os.path.join(d, "propagate"))
            for k in native.CALLS:
                native.CALLS[k] = 0
            for i0, i1 in ((0, 100), (10, 110), (20, 120)):
                spent.clear()
                t0 = time.perf_counter()
                out = prop.propagate_pair(i0, i1,
                                          ransac_filter=timed_filter)
                total = (time.perf_counter() - t0) * 1e3
                assert out is not None, (i0, i1)
                f_ms, n_in, n_kept = spent[0]
                print(f"  propagate_pair({i0}, {i1}): {n_in} chained labels, "
                      f"{n_kept} kept; chaining {total - f_ms:.2f} ms (host), "
                      f"filter {f_ms:.2f} ms (card) [{self.card}]")
        calls = dict(native.CALLS)
        print(f"  chain linker calls: {calls} (library "
              f"{native.library_path().name})")
        assert calls["compiled"] > 0 and calls["numpy"] == 0, calls

    # -- 29-30: the hloc layer -------------------------------------------
    def hloc_matching(self):
        """Phase 29: the hloc stages on arrays on the card (the card's
        machine has no cv2 and no h5py): sparse extraction and matching,
        dense matching and aggregation, the database with verification."""
        import tempfile

        import numpy as np
        import torch

        from gim_tpu_torch.api import Matcher, match_fn
        from gim_tpu_torch.config import GimConfig, LightGlueConfig
        from gim_tpu_torch.geometry.ransac import draw_noise
        from gim_tpu_torch.hloc import pipeline as P
        from gim_tpu_torch.hloc.mapper import read_database
        from gim_tpu_torch.hloc.reconstruction import (
            VERIFY_SEED, build_database_arrays, geometric_verification_onchip)
        from gim_tpu_torch.models.dkm import blocks as dkm_blocks
        from gim_tpu_torch.ops.image import preprocess_image
        from gim_tpu_torch.ops.kernels import forward_only, refiner
        from gim_tpu_torch.utils.profiling import StageTimer

        dev = self.dev
        W, H = HLOC_WH
        views = hloc_views(dev)
        names = [f"view{i}.png" for i in range(len(views))]
        pairs = P.pairs_from_exhaustive(names)
        timer = StageTimer()
        torch.cuda.reset_peak_memory_stats()

        # sparse: SuperPoint on every view, LightGlue on every pair
        sp = Matcher("gim_lightglue", device=dev)
        pre = {n: preprocess_image(v, HLOC_RESIZE, 8, True, dev)
               for n, v in zip(names, views)}

        def extract(matcher, p, pad_noise=None):
            f = P.superpoint_features(matcher, p.gray, p.resize_hw,
                                      p.scale.cpu().numpy(), pad_noise)
            f["image_size"] = np.array([W, H])
            return f

        extract(sp, pre[names[0]])                              # warm-up
        torch.cuda.synchronize()
        with timer.stage("sparse extract"):
            feats = {n: extract(sp, pre[n]) for n in names}
        P.lightglue_pair(sp, feats[names[0]], feats[names[1]], HLOC_KPTS)
        with timer.stage("sparse match"):
            sparse = {p: P.lightglue_pair(sp, feats[p[0]], feats[p[1]],
                                          HLOC_KPTS) for p in pairs}
        n_kpts = [len(f["keypoints"]) for f in feats.values()]
        n_sparse = [int((m0 >= 0).sum()) for m0, _ in sparse.values()]
        assert all(len(m0) == HLOC_KPTS for m0, _ in sparse.values())
        assert min(n_kpts) > 0

        # dense: gim_dkm at 672 with 8192 samples, then the aggregator
        dk = Matcher("gim_dkm", device=dev)
        cfg = P.dense_config(dk, HLOC_SAMPLES)
        assert cfg.dkm.num_samples == HLOC_SAMPLES != dk.cfg.dkm.num_samples
        dpre = {n: preprocess_image(v, HLOC_DENSE_IMG, 8, True, dev)
                for n, v in zip(names, views)}

        def dense(a, b):
            return P.dense_pair(dk, cfg, dpre[a].color, dpre[a].scale,
                                dpre[b].color, dpre[b].scale)

        dense(*pairs[0])                                        # warm-up
        before = refiner.LAUNCHES["refiner_block"]
        with swapped(forward_only, "on_kernel", lambda x: False), \
                timer.stage("dense match"):
            raw = {p: dense(*p) for p in pairs}
        assert refiner.LAUNCHES["refiner_block"] == before
        with timer.stage("aggregate (host)"):
            canonical, matches = P.aggregate_dense(
                raw, pairs, HLOC_CELL, HLOC_MAX_ERROR, HLOC_MAX_KPS)
        kp = {n: canonical[n][0] for n in names}
        for k0, k1, c in raw.values():
            assert np.isfinite(k0).all() and np.isfinite(k1).all()
            assert len(c) > 0 and (k0 >= 0).all() and (k1 >= 0).all()
        assert all(0 < len(k) <= HLOC_MAX_KPS for k in kp.values())

        # the database on arrays, each pair verified on the card
        geometric_verification_onchip(kp[pairs[0][0]], kp[pairs[0][1]],
                                      matches[pairs[0]][0], device=dev)
        with timer.stage("verify"):
            inl = {p: geometric_verification_onchip(
                kp[p[0]], kp[p[1]], matches[p][0], device=dev)
                for p in pairs}
        with tempfile.TemporaryDirectory() as d:
            db = os.path.join(d, "database.db")
            t0 = time.perf_counter()
            build_database_arrays(db, {n: (W, H) for n in names}, kp,
                                  [(a, b, matches[(a, b)][0])
                                   for a, b in pairs], device=dev)
            db_ms = (time.perf_counter() - t0) * 1e3
            cams, imgs, db_kpts, verified = read_database(db)
        assert len(cams) == 1 and sorted(imgs) == names
        for p in pairs:                       # the same draws: the same rows
            want = matches[p][0][inl[p]]
            got = verified.get(p, np.zeros((0, 2), np.uint32))
            assert np.array_equal(got, want.astype(np.uint32)), p
        peak = torch.cuda.max_memory_allocated()
        t = timer.times
        print(f"  {len(names)} views of {W} x {H}, {len(pairs)} pairs "
              f"[{self.card}]:")
        print(f"    SuperPoint at resize_max {HLOC_RESIZE} ({HLOC_KPTS} "
              f"keypoints): {t['sparse extract'] * 1e3 / len(names):.2f} ms "
              f"per image; valid keypoints {n_kpts}")
        print(f"    LightGlue (9 layers, threshold 0.1): "
              f"{t['sparse match'] * 1e3 / len(pairs):.2f} ms per pair; "
              f"matches {n_sparse}")
        print(f"    gim_dkm at {HLOC_DENSE_IMG} ({HLOC_SAMPLES} samples, "
              f"float32): {t['dense match'] * 1e3 / len(pairs):.2f} ms per "
              f"pair; valid samples {[len(r[2]) for r in raw.values()]}")
        print(f"    aggregation on the host (cell {HLOC_CELL}, max_error "
              f"{HLOC_MAX_ERROR}): {t['aggregate (host)'] * 1e3:.2f} ms for "
              f"{len(pairs)} pairs; canonical keypoints "
              f"{[len(k) for k in kp.values()]}; unique matches "
              f"{[len(m) for m, _ in matches.values()]}")
        print(f"    fundamental verification (2048 hypotheses): "
              f"{t['verify'] * 1e3 / len(pairs):.2f} ms per pair; inliers "
              f"{[int(v.sum()) for v in inl.values()]}; the database on "
              f"arrays {db_ms:.2f} ms, its verified rows equal the "
              f"verification's")
        print(f"    peak memory {peak / 2**30:.2f} GiB")
        print("    stage timer:\n      " + timer.report().replace(
            "\n", "\n      "))

        # one pair, card against CPU
        n0, n1 = pairs[0]
        cpu_cfg = GimConfig(lightglue=LightGlueConfig(filter_threshold=0.0))
        cpu = Matcher("gim_lightglue", cpu_cfg, device="cpu")
        card = Matcher("gim_lightglue", cpu_cfg,
                       state_dict=cpu.model.state_dict(), device=dev)
        g = torch.Generator().manual_seed(29)
        noise = torch.rand((1, cpu_cfg.superpoint.max_num_keypoints, 2),
                           generator=g)
        small = {n: preprocess_image(views[names.index(n)],
                                     HLOC_CHECK_RESIZE, 8, True, dev)
                 for n in (n0, n1)}
        # the same canvases (made on the card) into both
        fc = {n: extract(card, small[n], noise) for n in (n0, n1)}
        fh = {n: extract(cpu, small[n], noise) for n in (n0, n1)}
        for n in (n0, n1):
            # keypoints as sets (scores within float32 rounding can rank
            # the other way round, phase 15), descriptors where they agree
            a, b = ({tuple(k): i for i, k in enumerate(f["keypoints"])}
                    for f in (fc[n], fh[n]))
            shared = sorted(a.keys() & b.keys())
            share = len(shared) / max(len(a.keys() | b.keys()), 1)
            ia, ib = [a[k] for k in shared], [b[k] for k in shared]
            d = float(np.abs(fc[n]["descriptors"][:, ia]
                             - fh[n]["descriptors"][:, ib]).max())
            print(f"  SuperPoint card against CPU at resize_max "
                  f"{HLOC_CHECK_RESIZE}, {n}: {len(a)} / {len(b)} "
                  f"keypoints, shared {share:.4f} (limit {LG_AGREE}); "
                  f"descriptors max diff {d:.2e} where shared (limit "
                  f"{LG_TOL})")
            assert share >= LG_AGREE and d <= LG_TOL and len(shared), n
        mc, sc = P.lightglue_pair(card, fh[n0], fh[n1], HLOC_KPTS)
        mh, sh = P.lightglue_pair(cpu, fh[n0], fh[n1], HLOC_KPTS)
        m_agree = float((mc == mh).mean())
        print(f"  LightGlue card against CPU (threshold 0, the CPU's "
              f"features): matches0 equal on {m_agree:.4f} of slots (limit "
              f"{LG_AGREE}); {int((mh >= 0).sum())} matches on the CPU; "
              f"scores max diff {float(np.abs(sc - sh).max()):.2e}")
        assert m_agree >= LG_AGREE and int((mh >= 0).sum()) > 0
        # verification with the card's uniforms, on planted two-view
        # matches at this pair's match count (random weights give matches
        # with no geometry to verify)
        rng = np.random.default_rng(29)
        n = max(len(matches[(n0, n1)][0]), 64)
        p0, p1, _, _, _ = gt_scene(rng, n, n, 0.7, ZEB_NOISE_PX)
        ids = np.stack([np.arange(n), np.arange(n)], 1)
        M = 1 << int(np.ceil(np.log2(max(n, 8))))
        banks = draw_noise([torch.Generator(dev).manual_seed(VERIFY_SEED)],
                           2048, M, dev)
        vc = geometric_verification_onchip(p0, p1, ids, device=dev)
        vh = geometric_verification_onchip(
            p0, p1, ids, device="cpu", noise=tuple(b.cpu() for b in banks))
        agree = float((vc == vh).mean())
        print(f"  verification card against CPU on {n} planted matches "
              f"(M = {M}), the card's uniforms: masks agree on {agree:.4f} "
              f"(limit {MASK_AGREE}); {int(vc.sum())} / {int(vh.sum())} "
              f"inliers")
        assert agree >= MASK_AGREE and vc.sum() >= 0.6 * n

        # the dense stage with K2 (the kernel rule as it is); the blocks'
        # inputs are recorded on the way to the kernel's wrapper
        seen = collections.Counter()
        wrapper = dkm_blocks.fused_dw_block

        def recording(x, *f):
            seen[(tuple(x.shape), f[2].shape[0], x.dtype)] += 1
            return wrapper(x, *f)

        for k in refiner.LAUNCHES:
            refiner.LAUNCHES[k] = 0
        dkm_blocks.fused_dw_block = recording
        try:
            t0 = time.perf_counter()
            raw_on = {p: dense(*p) for p in pairs}
            on_ms = (time.perf_counter() - t0) * 1e3 / len(pairs)
        finally:
            dkm_blocks.fused_dw_block = wrapper
        k2 = refiner.LAUNCHES["refiner_block"]
        assert k2 == len(pairs) * DKM_K2_PER_CALL == sum(seen.values()), k2
        assert {dt for _, _, dt in seen} == {torch.float32}, seen
        self.refiner_f32(seen, len(pairs), k2)
        canon_on, _ = P.aggregate_dense(raw_on, pairs, HLOC_CELL,
                                        HLOC_MAX_ERROR, HLOC_MAX_KPS)
        shares = []
        for n in names:
            a = {tuple(x) for x in canon_on[n][0]}
            b = {tuple(x) for x in canonical[n][0]}
            shares.append(len(a & b) / max(len(a | b), 1))
        # one pair's samples slot by slot (phase 11's tolerance, pixels of
        # the 672 canvas)
        def one_pair():
            return match_fn(dk.name, cfg, dk.model, dpre[n0].color[None],
                            dpre[n1].color[None], dpre[n0].scale[None],
                            dpre[n1].scale[None], device=dev)

        with swapped(forward_only, "on_kernel", lambda x: False):
            out = {False: one_pair()}
        out[True] = one_pair()
        both = out[False].valid & out[True].valid
        dk0 = (out[False].kpts0 - out[True].kpts0).abs().amax(-1)
        dk1 = (out[False].kpts1 - out[True].kpts1).abs().amax(-1)
        tol = SWITCH_TOL * HLOC_DENSE_IMG
        slot = float(((out[False].valid == out[True].valid)
                      & (~both | ((dk0 <= tol) & (dk1 <= tol))))
                     .float().mean())
        print(f"  gim_dkm with K2 (the card's default): {k2} K2 "
              f"launches for {len(pairs)} pairs ({k2 // len(pairs)} per "
              f"pair), {on_ms:.2f} ms per pair against "
              f"{t['dense match'] * 1e3 / len(pairs):.2f} without "
              f"[{self.card}]; canonical keypoints shared with the "
              f"plain-graph run {[round(x, 4) for x in shares]} (limit "
              f"{MASK_AGREE}); one pair's samples agree within {tol:.3f} px "
              f"on {slot:.5f} of slots (limit {MIN_AGREE})")
        assert min(shares) >= MASK_AGREE and slot >= MIN_AGREE

    def refiner_f32(self, seen, calls: int, launches: int):
        """K2's float32 kernel at the inputs slice 8's dense stage gave it
        (`seen`: (shape, C_out, dtype) -> launches over `calls` calls): each
        shape on fresh random blocks against the plain version at TOL_F32,
        timed beside its floor and FP32-FMA figure. Printed only: the
        `refiner_block_f32` entry takes its times from phase 6 (the same
        shapes, gim_dkm's) and its launches from phase 31."""
        import torch

        from gim_tpu_torch.ops.kernels import refiner as K

        g = torch.Generator(device=self.dev).manual_seed(290)
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, fma_ms=0.0)
        for (shape, C_out, dtype), n in sorted(seen.items(),
                                               key=lambda kv: kv[0][:2]):
            B, C, H, W = shape
            x = torch.randn(shape, device=self.dev, generator=g).to(dtype)
            _, f = refiner_block_params(C, C_out, dtype, g)
            got = K.fused_dw_block(x, *f)
            want = K.fused_dw_block_plain(x, *f)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = torch.allclose(got, want, rtol=TOL_F32, atol=TOL_F32)
            del got, want
            t_k = cuda_ms(lambda: K.fused_dw_block(x, *f), 10)
            t_p = cuda_ms(lambda: K.fused_dw_block_plain(x, *f), 10)
            b_ms, b_by, fma = k2_f32_bounds(B, C, C_out, H, W)
            print(f"  K2 float32 {shape} -> {C_out} ({n // calls} launches "
                  f"per call): max abs err {err:.3e} against the plain "
                  f"version on the same inputs (limit {TOL_F32} + {TOL_F32} "
                  f"|plain|); kernel {t_k:.3f} ms, {t_k / b_ms:.2f}x its "
                  f"floor {b_ms:.3f} ms ({b_by}), FP32-FMA figure "
                  f"{fma:.3f} ms, plain {t_p:.3f} ms [{self.card}]")
            assert ok, shape
            for key, val in (("ms", t_k), ("plain_ms", t_p),
                             ("bound_ms", b_ms), ("fma_ms", fma)):
                tot[key] += n / calls * val
            del x
        print(f"  K2 float32 per dense call ({launches // calls} launches): "
              f"kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
              f"floor {tot['bound_ms']:.3f} ms "
              f"({tot['ms'] / tot['bound_ms']:.2f}x), FP32-FMA figure "
              f"{tot['fma_ms']:.3f} ms [{self.card}]")

    def sfm(self):
        """Phase 30: the native mapper on the card at the JAX package's
        envelope (tests/test_mapper.py test_sixty_image_scene)."""
        import tempfile
        import warnings

        import numpy as np
        import torch

        from gim_tpu_torch.hloc import mapper as M
        from gim_tpu_torch.hloc import triangulation as T
        from gim_tpu_torch.utils.profiling import StageTimer

        dev = self.dev
        names, cams, pts, K, wh, kpts, vis, order = sfm_scene(
            SFM_CAMS, SFM_POINTS, SFM_NOISE, SFM_SEED)
        with tempfile.TemporaryDirectory() as d:
            db = os.path.join(d, "database.db")
            n_pairs = write_sfm_db(db, names, K, wh, kpts, order)
            timer = StageTimer()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rec = M.incremental_mapping_native(db, verbose=False,
                                               device=dev, timer=timer)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            again = []
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    # the device's activities only, no table by kernel:
                    # ~150000 launches, whose CPU-side events and table
                    # took over a minute to post-process
                    prof = self.profile(lambda: again.append(
                        M.incremental_mapping_native(db, verbose=False,
                                                     device=dev)),
                        long_window=True)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if not again:               # the profiler failed: run it plain
                again.append(M.incremental_mapping_native(
                    db, verbose=False, device=dev))
            _, _, _, verified = M.read_database(db)
        syncs = [str(w.message) for w in caught
                 if "synchroniz" in str(w.message)]
        n_reg = rec.num_reg_images()
        C_est = np.array([-(R.T @ t) for R, t in
                          (rec.poses[n] for n in names)])
        C_gt = np.array([-(R.T @ t) for R, t in cams])
        sc, Rs, ts = align_similarity(C_est, C_gt)
        centre = float(np.linalg.norm((C_est @ (sc * Rs).T + ts) - C_gt,
                                      axis=-1).max())
        est = np.array([rec.xyz[pi] for pi in range(len(rec.track_obs))])
        gt = np.array([pts[vis[tr[0][0]][tr[0][1]]] for tr in rec.track_obs])
        sc, Rs, ts = align_similarity(est, gt)
        struct = float(np.median(np.linalg.norm(est @ (sc * Rs).T + ts - gt,
                                                axis=-1)))
        b = again[0]
        same = (list(b.poses) == list(rec.poses)
                and all(np.array_equal(x, y) for n in rec.poses
                        for x, y in zip(b.poses[n], rec.poses[n]))
                and np.array_equal(b.xyz, rec.xyz)
                and b.track_obs == rec.track_obs)
        regs = max(n_reg - 2, 1)
        t = timer.times
        print(f"  {SFM_CAMS} cameras, {SFM_POINTS} points, {n_pairs} "
              f"verified pairs, {SFM_NOISE} px: {n_reg} registered, "
              f"{rec.num_points3D()} points; centres within {centre:.5f} "
              f"after a similarity (limit {SFM_CENTRE_TOL}), structure "
              f"median {struct:.5f} (limit {SFM_STRUCT_TOL})")
        print(f"  {wall:.2f} s on the host clock, peak memory "
              f"{peak / 2**20:.1f} MiB [{self.card}]; init "
              f"{t['init'] * 1e3:.2f} ms once, then per registration "
              f"({regs}): PnP {t['pnp'] * 1e3 / regs:.2f}, triangulation "
              f"{t['triangulate'] * 1e3 / regs:.2f} (host), bundle "
              f"adjustment {t['bundle_adjust'] * 1e3 / regs:.2f}, filter "
              f"{t['filter'] * 1e3 / regs:.2f} (host) ms")
        print("  stage timer:\n    " + timer.report().replace("\n", "\n    "))
        print(f"  second run (profiled): {len(syncs)} host syncs, "
              f"{len(syncs) / regs:.1f} per registration; "
              + (f"{prof[0]} device activities, busy {prof[1]:.2f} of "
                 f"{prof[2]:.2f} ms, share {prof[1] / prof[2]:.4f}"
                 if prof else "busy share not measured")
              + f"; the same poses and points bit for bit: {same}")
        for msg in sorted(set(syncs))[:8]:
            print(f"    sync: {msg.splitlines()[0][:110]}")
        assert n_reg == SFM_CAMS and rec.num_points3D() > SFM_MIN_POINTS
        assert centre < SFM_CENTRE_TOL and struct < SFM_STRUCT_TOL
        assert n_pairs == len(verified) and same

        print(f"  (runs and profile done {time.perf_counter() - t0:.1f} s "
              f"after the first run started)")

        # card against CPU in float64, each on one fixed problem
        def rel(a, b):
            return float((a.cpu() - b).abs().max() / b.abs().max())

        f64 = torch.float64
        rng = np.random.default_rng(30)
        # bundle adjustment: the reconstruction's final state, perturbed
        pn = list(rec.poses)
        cmap = {n: i for i, n in enumerate(pn)}
        nk = {n: (kpts[n] - K[[0, 1], [2, 2]]) / K[[0, 1], [0, 1]]
              for n in names}
        obs = [(cmap[n], pi, nk[n][ki]) for pi, tr in
               enumerate(rec.track_obs) for n, ki in tr]
        R0 = np.stack([rec.poses[n][0] for n in pn])
        R0 = np.stack([r @ rodrigues(rng.normal(size=3) * 1e-3) for r in R0])
        args = [R0, np.stack([rec.poses[n][1] for n in pn])
                + rng.normal(size=(len(pn), 3)) * 1e-3,
                rec.xyz + rng.normal(size=rec.xyz.shape) * 1e-3,
                np.array([o[0] for o in obs]), np.array([o[1] for o in obs]),
                np.stack([o[2] for o in obs]), np.ones(len(obs)),
                (np.arange(len(pn)) > 0).astype(np.float64)]
        host = [torch.from_numpy(np.asarray(a)) for a in args]
        host = [a if a.dtype == torch.int64 else a.to(f64) for a in host]
        got = M.ba_steps(*(a.to(dev) for a in host))
        want = M.ba_steps(*host)
        ba = [rel(g, w) for g, w in zip(got, want)]
        # PnP with fixed row indices: the last registered view's 2D-3D
        # correspondences
        name = pn[-1]
        kis, pis = zip(*[(ki, pi) for pi, tr in enumerate(rec.track_obs)
                         for n, ki in tr if n == name])
        X = torch.from_numpy(rec.xyz[list(pis)]).to(f64)
        uv = torch.from_numpy(nk[name][list(kis)]).to(f64)
        w = torch.ones(len(X), dtype=f64)
        idx = torch.randint(len(X), (512, 6),
                            generator=torch.Generator().manual_seed(30))
        thr = 4.0 / K[0, 0]
        got = M.pnp_ransac_device(X.to(dev), uv.to(dev), w.to(dev),
                                  idx.to(dev), thr)
        want = M.pnp_ransac_device(X, uv, w, idx, thr)
        pnp = [rel(g, w_) for g, w_ in zip(got[:2], want[:2])]
        pnp_inl = bool(torch.equal(got[2].cpu(), want[2]))
        # triangulate_tracks: the ground-truth poses as a text model, the
        # verified matches' tracks
        model = T.TextModel(
            cameras={1: T.Camera(1, "PINHOLE", *wh, np.array(
                [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))},
            images={i + 1: T.Image(i + 1, M.rotmat_to_qvec(R), t, 1, n)
                    for i, (n, (R, t)) in enumerate(zip(names, cams))})
        n2i = {n: i + 1 for i, n in enumerate(names)}
        tracks = T.build_tracks(list(verified), verified, {})
        tc = T.triangulate_tracks(model, n2i, kpts, tracks, device=dev,
                                  dtype=f64)
        th = T.triangulate_tracks(model, n2i, kpts, tracks, device="cpu",
                                  dtype=f64)
        tri = float(np.abs(tc[0] - th[0]).max() / np.abs(th[0]).max())
        tri_ok = bool(np.array_equal(tc[1], th[1]))
        print(f"  float64 card against CPU (limit {SFM_TOL} relative): "
              f"ba_steps ({len(pn)} cameras, {len(rec.xyz)} points, "
              f"{len(obs)} observations, 12 iterations) R {ba[0]:.2e} t "
              f"{ba[1]:.2e} X {ba[2]:.2e}; PnP ({len(X)} correspondences, "
              f"512 fixed hypotheses) R {pnp[0]:.2e} t {pnp[1]:.2e}, "
              f"inliers equal {pnp_inl} ({int(want[3])}); "
              f"triangulate_tracks ({len(tracks)} tracks) {tri:.2e}, "
              f"validity equal {tri_ok} ({int(th[1].sum())} valid)")
        assert max(ba + pnp + [tri]) <= SFM_TOL and pnp_inl and tri_ok
        assert int(want[3]) >= 0.8 * len(X) and th[1].sum() > SFM_MIN_POINTS

    # -- 31 -----------------------------------------------------------------
    def dense_f32_main_path(self):
        """Phase 31: one `Matcher.match` call of gim_roma and one of gim_dkm
        at their default dtype (float32, as `cli/zeb_eval.build_matcher`
        builds them), full width, TF32 off, seeded random weights, on
        inputs of phases 8 and 10. The counters are set to 0 just before
        each call and read just after: 32 K2 and 29 K3 launches for
        gim_roma, 32 K2 for gim_dkm, no masked K3 for either. Their sums
        are the launches of the `refiner_block_f32` and
        `flash_attention_f32` entries."""
        import torch

        from gim_tpu_torch.api import Matcher
        from gim_tpu_torch.config import GimConfig
        from gim_tpu_torch.ops.kernels import flash, refiner

        cfg = GimConfig()
        assert cfg.roma.dtype == cfg.dkm.dtype == "float32"
        assert not (torch.backends.cuda.matmul.allow_tf32
                    or torch.backends.cudnn.allow_tf32)
        dev = torch.device(self.dev)
        g = torch.Generator(device=dev).manual_seed(31)
        R, S, (h, w) = ROMA_IMG, DKM_CANVAS, DKM_CONTENT
        mask = torch.zeros(1, S, S, dtype=torch.bool, device=dev)
        mask[:, :h, :w] = True
        runs = (
            ("gim_roma", cfg.roma.num_samples,
             (torch.rand(1, 3, R, R, device=dev, generator=g),
              torch.rand(1, 3, R, R, device=dev, generator=g)),
             {"refiner_block": ROMA_K2_PER_CALL,
              "flash_attention": ROMA_K3_PER_CALL}),
            ("gim_dkm", cfg.dkm.num_samples,
             (torch.rand(1, 3, S, S, device=dev, generator=g) * mask,
              torch.rand(1, 3, S, S, device=dev, generator=g) * mask,
              None, None, mask, mask),
             {"refiner_block": DKM_K2_PER_CALL, "flash_attention": 0}))
        total = collections.Counter()
        for head, n, args, per_call in runs:
            m = Matcher(head, cfg, generator=torch.Generator().manual_seed(0),
                        device=dev)
            for c in (refiner.LAUNCHES, flash.LAUNCHES):
                for k in c:
                    c[k] = 0
            r = m.match(*args)
            torch.cuda.synchronize()
            got = {**refiner.LAUNCHES, **flash.LAUNCHES}
            assert got == {**per_call, "lightglue_attention": 0}, (head, got)
            assert r.kpts0.shape == r.kpts1.shape == (1, n, 2), r.kpts0.shape
            assert r.conf.shape == (1, n)
            for t in (r.kpts0, r.kpts1, r.conf):
                assert bool(torch.isfinite(t).all())
            total.update(got)
            print(f"  {head} float32, one call: launches {got}, "
                  f"{int(r.valid.sum())} of {n} valid [{self.card}]")
            del m, r
            torch.cuda.empty_cache()
        for k in ("refiner_block", "flash_attention"):
            self.kernels.setdefault(k + "_f32", {"name": k + "_f32"})[
                "launches"] = total[k]


class Marks:
    """CUDA events at the ends of a step's stages, with each stage's peak
    memory above what was held at the start."""

    def __init__(self):
        self.names, self.events, self.peaks = [], [], []

    def start(self):
        import torch

        torch.cuda.synchronize()
        self.base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        self.first = torch.cuda.Event(enable_timing=True)
        self.first.record()

    def end(self, name: str):
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.names.append(name)
        self.events.append(ev)
        self.peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    def report(self, what: str, card: str):
        import torch

        torch.cuda.synchronize()
        total = self.first.elapsed_time(self.events[-1])
        print(f"  stages of one {what}, {total:.2f} ms on the stream, peak "
              f"memory per stage above the {self.base / 2**30:.2f} GiB held "
              f"at its start [{card}]:")
        prev = self.first
        for name, ev, peak in zip(self.names, self.events, self.peaks):
            t = prev.elapsed_time(ev)
            print(f"    {t:9.3f} ms  {t / total:6.3f}  {name:11s} peak "
                  f"{(peak - self.base) / 2**30:6.2f} GiB")
            prev = ev


@contextlib.contextmanager
def swapped(module, name: str, value):
    """module.name set to `value` for the block, restored after."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def stack_batches(batches: list[dict]) -> dict:
    """One batch of the pairs of `batches` (each a `zeb_batch`)."""
    import numpy as np

    return {k: (sum((b[k] for b in batches), []) if isinstance(v, list)
                else np.concatenate([b[k] for b in batches]))
            for k, v in batches[0].items()}


def gt_scene(rng, m: int, n_valid: int, inlier_share: float,
             noise_px: float, f: float = 600.0, im: int = 840):
    """A ground-truth two-view scene in pixels: random pose and 3D points
    projected through K, Gaussian noise, uniform outliers, the first
    n_valid of m slots valid. Returns p0, p1 (m, 2), valid (m,), K (3, 3),
    T_0to1 (4, 4), float32."""
    import numpy as np

    K = np.array([[f, 0, im / 2], [0, f, im / 2], [0, 0, 1.0]])
    r = rng.uniform(-0.25, 0.25, 3)
    th = np.linalg.norm(r)
    k = r / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx
    t = rng.standard_normal(3)
    t = 0.5 * t / np.linalg.norm(t)
    X = np.concatenate([rng.uniform(-3, 3, (m, 2)),
                        rng.uniform(4, 12, (m, 1))], -1)
    x0 = X @ K.T
    x1 = (X @ R.T + t) @ K.T
    p0 = x0[:, :2] / x0[:, 2:] + rng.standard_normal((m, 2)) * noise_px
    p1 = x1[:, :2] / x1[:, 2:] + rng.standard_normal((m, 2)) * noise_px
    out = rng.random(m) > inlier_share
    p1[out] = rng.uniform(0, im, (int(out.sum()), 2))
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return (p0.astype(np.float32), p1.astype(np.float32),
            np.arange(m) < n_valid, K.astype(np.float32),
            T.astype(np.float32))


def rodrigues(w):
    """(3,) axis-angle -> (3, 3) rotation, numpy."""
    import numpy as np

    th = float(np.linalg.norm(w))
    if th < 1e-15:
        return np.eye(3)
    k = np.asarray(w) / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx


def hloc_views(dev) -> list:
    """Phase 29's views without cv2: a numpy texture (blocks of 4 px and
    discs) as view 0, and views under five camera poses of the two-plane
    scene of `data/synthetic.py` (plane homographies, the left half of
    view 0 on the near plane), warped on the card by `F.grid_sample` with
    reflected borders. Returns (H, W, 3) uint8 arrays."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from gim_tpu_torch.data.synthetic import plane_homography

    W, H = HLOC_WH
    rng = np.random.default_rng(290)
    tex = np.repeat(np.repeat(rng.integers(0, 256, (H // 4, W // 4, 3)),
                              4, 0), 4, 1).astype(np.float32)
    yy, xx = np.mgrid[:H, :W]
    for _ in range(300):
        cx, cy, r = rng.uniform(0, W), rng.uniform(0, H), rng.uniform(4, 30)
        tex[(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] = rng.integers(0, 256, 3)
    base = torch.from_numpy(tex).to(dev).permute(2, 0, 1)[None]
    K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1.0]])
    n1, n2 = np.array([0.05, 0.02, -1.0]), np.array([-0.03, 0.06, -1.0])
    pix = np.stack([xx, yy, np.ones_like(xx)], -1).reshape(-1, 3).T

    def source(Hm):
        """Where each pixel of the view samples view 0 (dst -> src)."""
        q = np.linalg.inv(Hm) @ pix
        return (q[:2] / q[2:]).T.reshape(H, W, 2)

    out = [tex.astype(np.uint8)]
    for k in range(1, HLOC_VIEWS):
        R = rodrigues(rng.uniform(-0.05, 0.05, 3))
        t = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.2, 0.2),
                      rng.uniform(0.02, 0.1)])
        s1 = source(plane_homography(K, R, t, n1 / np.linalg.norm(n1),
                                     -4.0))
        s2 = source(plane_homography(K, R, t, n2 / np.linalg.norm(n2),
                                     -7.5))
        src = np.where((s1[..., :1] < W / 2), s1, s2)
        grid = torch.from_numpy(src / [W - 1, H - 1] * 2 - 1).float()
        img = F.grid_sample(base, grid.to(dev)[None], mode="bilinear",
                            padding_mode="reflection", align_corners=True)
        out.append(img[0].permute(1, 2, 0).round().clamp(0, 255)
                   .to(torch.uint8).cpu().numpy())
    return out


def look_at(eye, target):
    import numpy as np

    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(z, np.array([0.0, 1.0, 0.0]))
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])                      # world->cam rows
    return R, -R @ eye


def sfm_scene(n_cams: int, n_pts: int, noise_px: float, seed: int):
    """The synthetic SfM scene of the JAX package's mapper tests
    (tests/test_mapper.py `_make_scene`): cameras on an arc looking at a
    cloud of points, noisy projections, shuffled keypoint order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pts = rng.uniform([-1, -1, 4], [1, 1, 6], size=(n_pts, 3))
    K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    w, h = 640, 480
    cams = []
    for i in range(n_cams):
        ang = (i / max(n_cams - 1, 1) - 0.5) * 1.2
        eye = np.array([2.5 * np.sin(ang), 0.3 * np.sin(2 * ang),
                        5.0 - 2.5 * np.cos(ang)])
        cams.append(look_at(eye, np.array([0.0, 0.0, 5.0])))
    kpts, vis, order = {}, {}, {}
    names = [f"im{i}.png" for i in range(n_cams)]
    for name, (R, t) in zip(names, cams):
        y = pts @ R.T + t
        uv = (y[:, :2] / y[:, 2:]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
        uv = uv + rng.normal(0, noise_px, uv.shape)
        ok = ((y[:, 2] > 0.1) & (uv[:, 0] > 0) & (uv[:, 0] < w)
              & (uv[:, 1] > 0) & (uv[:, 1] < h))
        ids = np.nonzero(ok)[0]
        perm = rng.permutation(len(ids))
        kpts[name] = uv[ids][perm].astype(np.float32)
        vis[name] = ids[perm]                    # row -> world point id
        order[name] = {int(p): r for r, p in enumerate(ids[perm])}
    return names, cams, pts, K, (w, h), kpts, vis, order


def write_sfm_db(path, names, K, wh, kpts, order) -> int:
    """The scene's COLMAP database (tests/test_mapper.py `_write_db`):
    every pair sharing >= 8 points, verified. Returns the pair count."""
    import numpy as np

    from gim_tpu_torch.hloc.database import ColmapDB

    db = ColmapDB(str(path))
    cam = db.add_camera(1, *wh, np.array([K[0, 0], K[1, 1], K[0, 2],
                                          K[1, 2]]))
    ids = {n: db.add_image(n, cam) for n in names}
    for n in names:
        db.add_keypoints(ids[n], kpts[n] + 0.5)
    n_pairs = 0
    for i, n0 in enumerate(names):
        for n1 in names[i + 1:]:
            shared = sorted(set(order[n0]) & set(order[n1]))
            m = np.array([[order[n0][p], order[n1][p]] for p in shared],
                         np.uint32)
            if len(m) < 8:
                continue
            db.add_matches(ids[n0], ids[n1], m)
            db.add_two_view_geometry(ids[n0], ids[n1], m, config=3)
            n_pairs += 1
    db.close()
    return n_pairs


def align_similarity(A, B):
    """s, R, t minimizing ||s R A + t - B|| (Umeyama)."""
    import numpy as np

    muA, muB = A.mean(0), B.mean(0)
    Ac, Bc = A - muA, B - muB
    U, S, Vt = np.linalg.svd(Bc.T @ Ac / len(A))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / (Ac ** 2).mean(0).sum()
    return s, R, muB - s * R @ muA


def zeb_batch(rng, i: int) -> dict:
    """One ZEB batch (`data/zeb.batch_pairs` format) built in memory: an
    840^2 canvas holding 840 x 630 of blocky texture, and the same texture
    with its left half moved 8 px and its right half 24 px (two planes
    under a sideways move: R = I, t along -x), content masks, K."""
    import numpy as np

    S = ZEB_CANVAS
    h, w = ZEB_CONTENT
    tex = np.repeat(np.repeat(rng.random((3, h // 4 + 1, w // 4)), 4, 1),
                    4, 2)[:, :h].astype(np.float32)
    c0 = np.zeros((1, 3, S, S), np.float32)
    c0[0, :, :h, :w] = tex
    c1 = np.zeros_like(c0)
    half = w // 2
    c1[0, :, :h, 8:half] = tex[:, :, :half - 8]
    c1[0, :, :h, half + 24:w] = tex[:, :, half:w - 24]
    mask = np.zeros((1, S, S), bool)
    mask[0, :h, :w] = True
    K = np.array([[[600.0, 0, w / 2], [0, 600.0, h / 2], [0, 0, 1]]],
                 np.float32)
    T = np.eye(4, dtype=np.float32)[None].copy()
    T[0, 0, 3] = -1.0
    return {"color0": c0, "color1": c1, "mask0": mask, "mask1": mask,
            "scale0": np.ones((1, 2), np.float32),
            "scale1": np.ones((1, 2), np.float32), "K0": K, "K1": K,
            "T_0to1": T, "identifier": [f"zeb_memory#{i:04d}#{i:04d}s"],
            "covisible0": [0.5], "covisible1": [0.5]}


def zeb_batches() -> list[dict]:
    """Phase 13's ZEB_PAIRS + 1 in-memory pairs (the first a warm-up)."""
    import numpy as np

    rng = np.random.default_rng(13)
    return [zeb_batch(rng, i) for i in range(ZEB_PAIRS + 1)]


def zeb_args(batch: dict) -> tuple:
    return tuple(batch[k] for k in ("color0", "color1", "scale0", "scale1",
                                    "mask0", "mask1"))


def zeb_matcher(dev):
    """ZEB's gim_loftr (phases 13 and 27): full width, seeded weights,
    float32, fused matching (K1's float32 sweeps), ZEB_MATCHES slots at
    threshold 0."""
    import torch

    from gim_tpu_torch.api import Matcher
    from gim_tpu_torch.config import GimConfig, LoFTRConfig

    cfg = GimConfig(loftr=LoFTRConfig(
        fused_matching=True, max_matches=ZEB_MATCHES, match_threshold=0.0))
    return Matcher("gim_loftr", cfg, generator=torch.Generator()
                   .manual_seed(0), device=dev)


def train_batch(rng, B: int, S: int, n_labels: int, device) -> dict:
    """B training pairs of S^2 blocky texture: image 1 is image 0 with its
    left half moved 8 px and its right half 24 px (phase 13's two planes),
    and n_labels labels whose both ends lie inside the images."""
    import numpy as np
    import torch

    half = S // 2
    c0 = np.repeat(np.repeat(rng.random((B, 3, S // 4 + 1, S // 4 + 1)), 4,
                             2), 4, 3)[:, :, :S, :S].astype(np.float32)
    c1 = np.zeros_like(c0)
    c1[..., 8:half] = c0[..., :half - 8]
    c1[..., half + 24:] = c0[..., half:S - 24]
    left = rng.random((B, n_labels)) < (half - 8) / (S - 32)
    x0 = np.where(left, rng.uniform(0, half - 8, (B, n_labels)),
                  rng.uniform(half, S - 24, (B, n_labels)))
    y0 = rng.uniform(0, S, (B, n_labels))
    x1 = x0 + np.where(left, 8.0, 24.0)
    labels = np.stack([x0, y0, x1, y0], -1).astype(np.float32)
    valid = np.ones((B, n_labels), bool)
    return {k: torch.from_numpy(v).to(device) for k, v in
            (("color0", c0), ("color1", c1), ("labels", labels),
             ("label_valid", valid))}


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms (warnings recorded and yielded, not
    raised) and cuDNN's deterministic convolutions, restored after."""
    import warnings

    import torch

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    old = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            yield warned
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])
        torch.backends.cudnn.deterministic = old[2]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def zeb_worker(rank: int, port: int, out: str, dev: str = "cuda") -> int:
    """One process of phase 27: a gloo group of two at tcp://localhost:port,
    phase 13's matcher on this rank's strided share of phase 13's pairs,
    the rows gathered through the group's store, rank 0's dump and each
    rank's figures written to `out`."""
    import torch
    import torch.distributed as dist

    from gim_tpu_torch.eval import zeb as E
    from gim_tpu_torch.parallel.mesh import process_local_pairs
    from gim_tpu_torch.utils.device import set_tf32

    set_tf32(False)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        n_hyp, use_conf = E.RANSAC_ZOO["MAGSAC"]
        m = zeb_matcher(dev)
        mine = process_local_pairs(zeb_batches()[1:])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rows = E.evaluate(lambda b: m.match(*zeb_args(b)), iter(mine),
                          num_hypotheses=n_hyp, use_conf=use_conf,
                          progress=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rows = E.gather_rows_multihost(rows)
        E.barrier_multihost("chip_smoke_zeb")
        if rank == 0:
            E.write_dump(rows, out, "gim_loftr", "ZEB-memory", "smoke")
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "pairs": len(mine),
                       "ms_per_pair": dt * 1e3 / len(mine),
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30},
                      f)
        print(f"rank {rank}: {len(mine)} pairs, {len(rows)} rows gathered")
    finally:
        dist.destroy_process_group()
    return 0


def main() -> int:
    # phase 27 runs two more processes on the card beside this one: with
    # segments that grow and shrink, empty_cache hands back what earlier
    # phases cached even where a few small tensors stay live in a segment
    # (with fixed segments this process kept 19.4 GiB for 0.07 GiB of live
    # tensors after phase 26 on an H100 80GB, and a worker's cuDNN took
    # another algorithm)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    try:
        import gim_tpu_torch
    except ImportError:
        gim_tpu_torch = None
    if (gim_tpu_torch is None
            or Path(gim_tpu_torch.__file__).resolve().parents[1] != here):
        print("chip_smoke: gim_tpu_torch not found beside this script",
              file=sys.stderr)
        return 2

    if sys.argv[1:2] == ["--zeb-worker"]:          # phase 27's processes
        return zeb_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    torch.set_grad_enabled(False)   # inference; phases 17-26 enable it
    t0 = time.perf_counter()
    s = Smoke()
    s.phase("1 environment", s.environment)
    s.phase("2 build", s.build)
    if not s.failed:
        s.phase("3 K1 against its plain version", s.kernels_vs_plain)
        s.phase("4 main path", s.main_path)
        s.phase("5 fused against dense", s.fused_vs_dense)
        s.phase("6 K2 against its plain version", s.refiner_vs_plain)
        s.phase("7 K3 against its plain version", s.flash_vs_plain)
        s.phase("8 gim_roma main path", s.roma_main_path)
        s.phase("9 gim_roma kernels against the plain graph",
                s.roma_kernels_vs_plain)
        s.phase("10 gim_dkm main path", s.dkm_main_path)
        s.phase("11 gim_dkm K2 against the plain graph",
                s.dkm_kernels_vs_plain)
        s.phase("12 ZEB geometry on the card", s.zeb_geometry)
        s.phase("13 ZEB path", s.zeb_path)
        s.phase("14 gim_lightglue main path", s.lightglue_main_path)
        s.phase("15 gim_lightglue card against CPU",
                s.lightglue_card_vs_cpu)
        s.phase("16 gim_lightglue ZEB path", s.lightglue_zeb_path)
        s.phase("17 gim_loftr training step", s.train_main_path)
        s.phase("18 training card against CPU", s.train_card_vs_cpu)
        s.phase("19 training loop and checkpoints",
                s.train_loop_and_checkpoints)
        s.phase("20 gim_dkm training step", s.dkm_train_main_path)
        s.phase("21 gim_roma training step", s.roma_train_main_path)
        s.phase("22 gim_lightglue training step",
                s.lightglue_train_main_path)
        s.phase("23 later heads' training card against CPU",
                s.head_card_vs_cpu)
        s.phase("24 later heads' training loop and checkpoints",
                s.head_train_loop)
        s.phase("25 the kernels refuse a backward on the card",
                s.kernels_refuse_backward)
        s.phase("26 the sampling backward", s.sampling_backward)
        s.phase("27 ZEB across two processes on one card",
                s.zeb_two_processes)
        s.phase("28 the video factory", s.factory)
        s.phase("29 hloc matching on the card", s.hloc_matching)
        s.phase("30 SfM on the card", s.sfm)
        s.phase("31 gim_roma and gim_dkm in float32 at full width",
                s.dense_f32_main_path)
    if s.failed:
        print(f"chip_smoke: FAILED phases {s.failed}")
        return 1
    print(f"chip_smoke: all phases ok in {time.perf_counter() - t0:.1f} s")
    print(nvidia_smi())
    print(json.dumps({"kernels": list(s.kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
