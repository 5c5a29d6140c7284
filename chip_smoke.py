#!/usr/bin/env python3
"""Drive glass_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --phases 1,2,3

Phases:
  1. card and build: the card's name and power limit; build every CUDA
     kernel of the port from the sources in this checkout (one nvcc per
     source, started together).
  2. K1 (rotated RoIAlign, csrc/roi_align_rotated.cu) against its plain
     PyTorch version at the three poolers' main-path shapes (960x1600
     bucket, 100 rois, C=256), in float32 and bfloat16, then the edge cases
     of its work split (0 and 1 roi, every roi on the full 4x4 grid, a 6x6
     grid of more samples than a warp's table holds, C of one 16-byte
     vector).
  3. K2 (raw-image crop, csrc/crop_rois.cu) likewise: a 960x1600 image in
     uint8 with the normalization folded in and normalized in f32/bf16,
     100 rois, sampling ratios 1, 2 and 0; edge cases 0 and 1 roi, a
     ragged 32x100 output and a one-pixel-wide image; and grid_sample on
     the sampling-ratio-1 points as K2's yardstick of time (``library_ms``).
  4. the main path: GlassRunner on the ICDAR15 eval configuration (config +
     the eval protocol overrides), seeded random weights, bfloat16 compute,
     synthetic 720x1280 images through ``__call__``; the kernels' launch
     counters must rise during this phase.
  5. whole-path check: one full-size image through the port at float32
     (no TF32) on the card and on the CPU (plain versions), same weights.
  6. the evaluation path: ``python -m glass_tpu_torch.eval`` run in-process
     (``glass_tpu_torch.eval.main``) on the ICDAR15 eval configuration at
     bfloat16, with phase 4's seeded weights saved as a .pth, over a
     synthetic COCO-style set written into ``--out`` (8 scenes of 720x1280
     with words drawn from tests/test_learning_synthetic.py's glyphs, scaled
     up), ``--batch-size 4``, post-processing thresholds loosened so that a
     random model's words survive; once with the host merge and once with
     POST_PROCESSING.ON_DEVICE.  Prints img/s and det/E2E P/R/H of each run,
     the K1/K2 launches of each run (exactly 3 and 1 per image, or it fails),
     which polygon path the evaluator took, the host syncs per image
     (``torch.cuda.set_sync_debug_mode("warn")``) and the split of a
     pipelined ``eval_batch_call`` between model, fetch and host
     post-processing.  Checks that ``eval_batch_call`` at batch 4 with
     ASYNC_FETCH equals batch 1 bit for bit, and that the on-device merge on
     the card agrees with the same code on the CPU (each iteration from the
     CPU's state: the same survivors, boxes within 1e-3 px and 1e-3 degrees).
  7. K1b (the rotated RoIAlign backward, csrc/roi_align_rotated_backward.cu)
     against its plain PyTorch version at the training shapes (an 832x1440
     bucket, C=256, the box, mask and recognizer poolers with 512, 128 and
     8 rois) in float32 and bfloat16, beside K1's forward at the same
     shapes; edge cases 0 and 1 roi, rois straddling the border, 512 rois
     on one pixel, long rotated words on the recognizer's level (tiles
     on the direct path) and FeatPadV2's recognizer rois (8 and 64 word
     rois widened to the pool's aspect, forward and backward).  The f32
     output's tolerance is the bound of two
     reordered f32 sums (the kernels' atomics add in another order); the
     bf16 output is held to the plain f32 result rounded to bf16 within
     that bound plus one bf16 ulp.  Prints per case the direct-path tiles,
     the whole backward's time (output in the features' dtype), the time
     with an f32 output, the dense-output bound (the upstream gradient read
     and every packed row written once) and the touched-rows bound (a
     read-modify-write of every touched f32 row).
  8. the training path: ``python -m glass_tpu_torch.train`` run in-process
     (``glass_tpu_torch.train.main``) on the ICDAR15 finetune configuration
     at bfloat16 over a synthetic training set of phase 6's glyph scenes:
     20 steps at IMS_PER_BATCH 1 (every loss finite; K1, K1b and K2 launch
     3, 3 and 1 times a step), the checkpoint loaded by the port's
     GlassRunner, the host syncs of a step, one profiled step (device busy
     share; device time and launches per stage span), 20 steps on one fixed
     batch (the loss falls), 3 steps at IMS_PER_BATCH 4 (3, 3 and 4
     launches a step: one pooler launch over the batch, one crop launch an
     image), and one f32 step on the card against the same step on the CPU
     from the trainer's seeded iteration-0 weights.
  9. the inference variants, at full width in bfloat16 with phase 4's
     weights: phase 4's weights saved in the legacy layout (the recognizer
     registered as the mask head) and loaded by ``GlassRunner(model_path=)``
     (every tensor the file holds bit for bit, all 43 of the recognizer's);
     TPU.TWO_STAGE_INFERENCE beside one-stage serving on phase 4's images
     (``__call__`` and ``run_model`` medians, the histogram of stage-2 row
     counts, exactly 3 K1 and 1 K2 launches an image; with the character
     distributions fetched, detections equal, text ids equal up to each
     word's end before a knife-edge step, masks within one step of their
     fetch dtype), first at the config's thresholds (a random model fills
     all 100 rows) and then on four images at a raised
     ROI_HEADS.SCORE_THRESH_TEST each, picked from the image's one-stage
     scores for about 4, 12, 24 and 48 detections, so that stage 2 runs on
     the word buckets below 100 with (0, 0, 1, 1, 0) padding rows (at
     least two of them, or it fails);
     ``glass_tpu_torch.eval --tta`` on two of phase 6's scenes at the
     default TEST.AUG (18 views: s/image, the merged boxes an image, the
     largest view's bucket, peak memory, P/R/H, exactly 18*3 + 2 K1 and
     18 + 1 K2 launches an image); one image each through
     glass_finetune_textocr.yaml and glass_finetune_totaltext.yaml, served
     under tools/eval_glass.py's ICDAR15 protocol overrides as phase 4's
     config is (3 and 1 launches, finite outputs); and
     3 steps of glass_pretrain.yaml at its IMS_PER_BATCH 8 from a synthetic
     caffe2 R-50 trunk ``.pkl`` given as ``--weights`` (every trunk tensor
     set from it, every loss finite, s/step and peak memory).
 10. the model-family variants, at full width in bfloat16 from phase 4's
     weights (each option's own tensors seeded): FeatPadV2, the GC fusion
     types channel_mul and channel_concat, SimpleAttention, LocalOnly,
     Conv1x1, CNN_V2 and CTC, each through ``GlassRunner.__call__`` on 1 of
     phase 4's images after one warm-up (``__call__`` and ``run_model``
     medians, exactly 3 K1 and 1 K2 launches an image, finite outputs),
     and each option's recognizer in f32 on the card against the CPU from
     the card's features and detections of one image (phase 5's
     tolerances); ``aster_decode_beam`` (width 5) on the card against the
     CPU over phase 4's f32 encoder states (best-beam scores within 1e-3,
     and the card's beams, rescored on the CPU, within 1e-3 of the CPU's
     best); CTC and FeatPadV2 training through
     ``glass_tpu_torch.train.main``, 5 steps each of the finetune config at
     IMS_PER_BATCH 1 (every loss finite, 3, 3 and 1 K1, K1b and K2 launches
     a step, K1b's direct-path tiles by pooler, s/step, peak memory).
 11. distributed on one card (``glass_tpu_torch.parallel``; NCCL across two
     or more GPUs cannot run on one card and is not checked here):
     (a) ``python -m glass_tpu_torch.train --distributed`` in-process in a
     world-size-1 NCCL group, phase 8's config and images, 5 steps at
     IMS_PER_BATCH 1 with SEED 0, against the plain trainer with the same
     seed and against the plain trainer run again (the run-to-run floor:
     K1b and some backward kernels add with atomics): the first step's
     losses equal bit for bit; every step's losses and the final weights
     and BN statistics equal bit for bit when the plain trainer repeats
     itself bit for bit, else within 10x its run-to-run difference; s/step
     beside phase 8's and 3, 3 and 1 launches a step.  (b) two gloo ranks
     spawned on the one card at IMS_PER_BATCH 2 (one image a rank): one
     f32 ``make_parallel_train_step`` (no TF32) held to the same two-rank
     step on two gloo ranks on the CPU (the card's recorded draws and
     proposals) at phase 8's card-vs-CPU tolerances, then 3 bf16 steps of
     the ``Trainer`` in the group, after which the replicas' weights and
     statistics are bit-identical; per rank s/step, peak memory, the
     gradient all-reduce's ms a step (gloo through the host) and the K1,
     K1b and K2 launches (3, 3 and 1 a step).  (c) TPU.SERVE_DATA_PARALLEL
     with two replicas on the one card (a thread each) at b = 3 (one zero
     padding row) and b = 4 equals b = 1 serving bit for bit, with 3 K1 and
     1 K2 launches a row; with the card alone it is phase 4's one-model
     path, bit for bit.
 12. float16, remat and the chunked loop: (a) the fp16 builds of K1 (the
     three poolers at the eval and the training shapes), K1b (training
     shapes, phase 7's bound) and K2 (sampling ratios 1, 2 and 0, phase
     3's edge cases) against their plain versions, with grid_sample in fp16
     as K2's yardstick; (b) TPU.COMPUTE_DTYPE float16 serving on phase 4's
     config, weights and images (2 warm-up, 8 timed: ``__call__`` and
     ``run_model`` medians, peak memory beside phase 4's bf16, 3 K1 and 1
     K2 launches an image) and its stages against f32 on the card (the
     features, then the box head, the teacher-forced decoder and the mask
     head on fixed boxes fed the f32 features cast to fp16, at
     tests/test_bf16_serving_numerics.py's bounds, no non-finite value where
     f32 has none); (c) 5 fp16 training steps of phase 8's config at
     IMS_PER_BATCH 1 (finite losses, s/step, peak memory, launches), and
     step 0's gradients of the whole network against an f32 step of the
     same call with the draws and proposals replayed: the median over the
     gradients of fp16's relative L2 no larger than bf16's, and a control
     (fp16 with K1b's gradient halved) beyond it; (d) and (e) with the
     weights held (BASE_LR 0), so that each step is a deterministic function
     of what the loop feeds it: 10 iterations, CHECKPOINT_PERIOD 5, of K = 1
     twice, TRAIN_LOOP_STEPS 4 and TPU.REMAT_BACKBONE, each bit for bit
     K = 1's (the batch, priorities and iteration fed to each step, every
     step's metrics, the final weights and BN statistics, the checkpoints),
     and two wrong loops as controls (every step of a chunk fed its first
     batch; the next iteration's priorities) that the metrics must catch;
     s/step and host syncs a step for K = 4 and 1; remat's step 0
     gradients in f32 within REMAT_GRAD_L2 of the plain step's, its s/step,
     and each step's memory (``PeakProbe``: the peak of the forward and of
     the whole step above what the step starts with) beside the plain
     trainer's.  Phase 12's peaks count from what is allocated when each
     part starts, after the earlier trainers are let go.
 13. TPU.SERVE_BATCH_MODE="vmap", one batched program a batch: (a) K2 over
     4 distinct 960x1600 images in one launch (``crop_rois_batched``)
     against its plain twin at max |err| 0, in uint8 with the fold, f32,
     bf16 and fp16 at sampling ratio 1, bf16 at 2 and 0, and an edge case;
     bf16 equal to four one-image launches; timed beside grid_sample over
     the batch; (b) on phase 6's eval set at batch 4, in f32 (TF32 off) and
     bf16, vmap against map: staged on one batch (the batched detection and
     heads fed the map path's own features and detections, against the
     one-image stages; f32 at phase 5's staged tolerances; the decoder's
     zeroed steps those of a break per image, and with a break forced in
     one image; a witness, map's stages on the batch's own backbone
     features) and end to end (``eval_batch_call`` in each mode,
     detections paired by box; the counts held, and in f32 the shares of
     pairs with close boxes and the same text); the bf16 parting (the rule
     of PERF.md section 6): bf16 batched (B = 4) and per image (B = 1) against
     the f32 per-image yardstick at each FPN level and in the heads on
     identical rows (box head, recognizer encoder, teacher-forced decoder),
     and the host merge's rounds on map's, vmap's and the witness's
     predictions, with cuBLAS's reduced-precision bf16 reduction allowed
     and then not (phase 13 fails unless both read rounding by the rule:
     a regression guard); (c) the K1/K2 launches (3
     and 1 a batch in vmap, 12 and 4 in map), the host syncs and the peak
     memory of one batch in each mode; (d) ``eval_batch_call`` img/s of
     both modes in f32 and bf16 with the model / fetch / host split, the
     words, their lengths and the host merge's rows and rounds, and one
     profiled batch of each (device busy share); (e) two
     SERVE_DATA_PARALLEL replicas on the one card under vmap at b = 3 and
     4, bit for bit one replica's vmap program on the same rows.
 14. unused (the phases keep their numbers, which PERF.md cites).
 15. the released-checkpoint verification entry point: ``python -m
     glass_tpu_torch.tools.verify_released_checkpoint`` in-process
     (``main(argv)``) on phase 6's eval set (8 glyph scenes of 720x1280,
     the loosened thresholds, words as box polygons: MASK_INFERENCE off,
     since an RRC gt zip of the ICDAR dialect holds 4 points a word) at
     ``--batch-size 4`` in bfloat16, with the
     seeded weights saved as a released-like d2 file (``{"model":
     state_dict, "iteration": 0}``): (a) ``--dry-run`` with no expected
     value exits 0 and records the hmean; (b) ``--gt-zip`` set to (a)'s det
     zip with ``--expected-hmean 1.0 --tolerance 0.01`` exits 0 with pass
     true (the model scores itself); (c) the same at 0.5 exits 1 with pass
     false.  Prints each run's img/s (the CLI's bench log), the tensor count
     and the K1/K2 launches (exactly 2 and 1 per image).
 16. K3 (the binary rotated mask windows, csrc/paste_masks_rotated.cu):
     ``GlassRunner.__call__`` at bfloat16 with the serving cell's loosened
     thresholds on phase 4's images records what ``detector_postprocess``
     hands the runner's ``RotatedMaskPaster``; the paster's polygons must
     equal the host loop's (``rotated_masks_to_polygons``) on every image,
     at one K3 launch an image.  On the first image: K3's output in both
     forms against its plain version byte for byte (flags and foreground
     boxes included), its
     device time from a CUDA graph of 50 launches beside its byte bound
     (masks and table read, the windows, flags and boxes written, at 3.35
     TB/s),
     and the polygon step's time through the paster (with the native
     contour tracer, and with cv2 tracing K3's windows) and through the host
     loop; the knife-edge fallback share over every image; the words the
     tracer and cv2 traced (on the card's host the probe must admit the
     tracer: cv2 traces none of K3's words).  Every phase prints its
     seconds.

Prints, on the last two lines, a JSON object with one entry per kernel and
``{"ok": true, "device": {...}}``, and copies everything it prints into
``--out``/chip_smoke.log.  Any failure exits non-zero.

Rehearse phase 6 on the CPU (no card) at a small size with
``phase_eval(state_dict, out_dir, device="cpu", n_images=2, hw=(96, 128),
opts=[...small bucket...])``, and phase 8 with ``phase_train(out_dir,
device="cpu", n_images=3, hw=(96, 128), opts=[...small shapes...], steps=2,
steps_b4=1, overfit_steps=10, step_opts=[...])``, and phase 9 with
``phase_variants(state_dict, images, out_dir, device="cpu", opts=[...small
bucket...], eval_hw=(96, 128), n_timed=3, tta_opts=[TEST.AUG.MIN_SIZES
[64, 96], TEST.AUG.MAX_SIZE 128], train_opts=[...small shapes...],
steps=2)``, and phase 10 with ``phase_model_variants(state_dict, images,
out_dir, device="cpu", opts=[...small bucket...], train_opts=[...small
shapes...], steps=2, hw=(96, 128))``, and phase 11 with
``phase_distributed(state_dict, images, out_dir, device="cpu", n_images=4,
hw=(96, 128), opts=[...small shapes...], step_opts=[...], steps=2,
bf16_steps=2, serve_opts=[...small bucket...])``, and phase 12 (b)-(e) with
``phase_fp16_remat_loop(state_dict, images, out_dir, device="cpu",
opts=[...small bucket...], train_opts=[...small shapes...], n_timed=2,
steps=2, loop_iters=6, loop_k=3, loop_ckpt=2, n_images=3, hw=(96, 128),
train_dtype="bfloat16")``, and phase 13 (b)-(e) with
``phase_vmap(state_dict, out_dir, device="cpu", n_images=6, hw=(96, 128),
opts=[...small bucket...])``, and phase 15 with ``phase_verify(state_dict,
out_dir, device="cpu", n_images=2, hw=(96, 128), opts=[...small
bucket...])``; they take ``device`` for that alone.
"""

from __future__ import annotations

import argparse
import collections
import copy
import json
import math
import os
import pickle
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
ICDAR15 = os.path.join("configs", "glass_finetune_icdar15.yaml")
BUCKET_HW = (960, 1600)
STRIDES = (4, 8, 16, 32, 64)
N_ROIS = 100
N_IMAGES = 8      # distinct synthetic main-path images
N_TIMED = 24      # timed main-path images, after 2 warm-up
STAGES = ("glass.backbone", "glass.rpn", "glass.box_head", "glass.recognizer", "glass.mask_head")

# K1 poolers on the main path: (name, output, sampling ratio, bulk grid, single level)
POOLERS = (
    ("box", (7, 7), 2, 2, False),
    ("mask", (14, 14), 0, (1, 2), False),
    ("recognizer", (8, 32), 0, (2, 1), True),
)


def log(*args):
    print(*args, flush=True)


class Tee:
    """Standard output copied into a file (``--out``/chip_smoke.log): a
    run on a remote card may return only the end of its output."""

    def __init__(self, stream, path):
        self.stream, self.file = stream, open(path, "w")

    def write(self, text):
        self.file.write(text)
        return self.stream.write(text)

    def flush(self):
        self.file.flush()
        self.stream.flush()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean over ``iters`` back-to-back calls between two CUDA events: the
    device time plus whatever host work between launches it could not hide."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def kernel_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn`` (one kernel launch), replayed
    from a CUDA graph of ``iters`` back-to-back calls: the wrapper's host
    work (checks, allocation, the ctypes call) runs once at capture and not
    between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(stop) / iters


# ---------------------------------------------------------------------------
# synthetic inputs
# ---------------------------------------------------------------------------


def word_rois(rng: np.random.RandomState, n: int, h: int, w: int) -> np.ndarray:
    """Word-like rotated boxes over an h x w image: elongated, rotated, some
    hanging over the edges, up to five (one in eight) far larger than any
    48x56 tile of any level, and more than 16 whose adaptive grid exceeds
    the bulk grid."""
    cx = rng.uniform(-40, w + 40, n)
    cy = rng.uniform(-40, h + 40, n)
    bw = np.exp(rng.uniform(np.log(12), np.log(900), n))
    bh = np.exp(rng.uniform(np.log(8), np.log(140), n))
    ang = rng.uniform(-90, 90, n)
    ang[: n // 4] = 0.0
    rois = np.stack([cx, cy, bw, bh, ang], 1).astype(np.float32)
    k = min(5, n // 8)
    if k:
        rois[-k:, 2] = rng.uniform(3600, 4200, k)
        rois[-k:, 3] = rng.uniform(2000, 3200, k)
    return rois


def synthetic_image(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """A BGR uint8 scene: smooth background, noise and rotated text lines."""
    import cv2

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([
        90 + 60 * np.sin(xx / (37 + 20 * c) + c) * np.cos(yy / (53 + 11 * c)) for c in range(3)
    ], -1)
    img += rng.randn(h, w, 3).astype(np.float32) * 12
    img = np.clip(img, 0, 255).astype(np.uint8)
    words = ["GLASS", "text", "spotting", "H100", "rotated", "RoIAlign", "kernel", "2015"]
    for _ in range(24):
        layer = np.zeros_like(img)
        word = words[rng.randint(len(words))]
        scale = rng.uniform(0.8, 3.0)
        org = (int(rng.uniform(0, w * 0.8)), int(rng.uniform(40, h - 10)))
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        cv2.putText(layer, word, org, cv2.FONT_HERSHEY_SIMPLEX, scale, color, int(1 + scale * 2))
        m = cv2.getRotationMatrix2D(org, float(rng.uniform(-40, 40)), 1.0)
        layer = cv2.warpAffine(layer, m, (w, h))
        mask = layer.sum(-1) > 0
        img[mask] = layer[mask]
    return img


# ---------------------------------------------------------------------------
# bounds: bytes and operations the work needs on this run's data
# ---------------------------------------------------------------------------


def touched_rows(rows_meta, rois, levels, grid, out_hw) -> int:
    """Distinct feature rows the bilinear taps of in-bounds samples read."""
    from glass_tpu_torch.ops.roi_align_rotated import bilinear_plain

    ph_n, pw_n = out_hw
    m = rows_meta[levels.long()]
    scale, height, width, base = m[:, 0], m[:, 1], m[:, 2], m[:, 3].long()
    cx = rois[:, 0] * scale - 0.5
    cy = rois[:, 1] * scale - 0.5
    rw, rh = rois[:, 2] * scale, rois[:, 3] * scale
    th = rois[:, 4] * math.pi / 180.0
    c, s = torch.cos(th), torch.sin(th)
    g_h, g_w = grid[:, 0].float(), grid[:, 1].float()
    ph = torch.arange(ph_n, device=rois.device, dtype=torch.float32)
    pw = torch.arange(pw_n, device=rois.device, dtype=torch.float32)
    seen = []
    col = lambda t: t[:, None, None]  # noqa: E731
    for iy in range(int(grid[:, 0].max())):
        yy = (-rh[:, None] / 2.0 + ph[None] * (rh / ph_n)[:, None]) + ((iy + 0.5) * (rh / ph_n) / g_h)[:, None]
        for ix in range(int(grid[:, 1].max())):
            xx = (-rw[:, None] / 2.0 + pw[None] * (rw / pw_n)[:, None]) + ((ix + 0.5) * (rw / pw_n) / g_w)[:, None]
            y = (yy[:, :, None] * col(c) - xx[:, None, :] * col(s)) + col(cy)
            x = (yy[:, :, None] * col(s) + xx[:, None, :] * col(c)) + col(cx)
            (yi, xi, yi1, xi1), ws = bilinear_plain(y, x, col(height), col(width), 1.0)
            on = col((iy < grid[:, 0]) & (ix < grid[:, 1])) & ((ws[0] + ws[1] + ws[2] + ws[3]) > 0)
            wr, br = col(width.long()), col(base)
            for a, b in ((yi, xi), (yi, xi1), (yi1, xi), (yi1, xi1)):
                seen.append((br + a * wr + b)[on])
    return int(torch.unique(torch.cat(seen)).numel())


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build(out_dir):
    from glass_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    logs = _cuda.build_all()
    took = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "kernel_build.log"), "w") as f:
        for name, (sec, text) in logs.items():
            f.write(f"== {name} ({sec:.1f} s)\n{text}\n")
    for name, (sec, text) in logs.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"built {name} in {sec:.1f} s; {regs[-1] if regs else ''}")
    log(f"phase 1: kernels built in {took:.1f} s")
    return took


def _pyramid(rng, dtype):
    from glass_tpu_torch.ops.roi_align_rotated import pack_pyramid

    maps = [torch.from_numpy(rng.randn(BUCKET_HW[0] // s, BUCKET_HW[1] // s, 256).astype(np.float32))
            .cuda().to(dtype) for s in STRIDES]
    return maps, pack_pyramid(maps, [1.0 / s for s in STRIDES])


def pooler_inputs(name, rng, dtype, rois):
    """Packed features, levels and per-roi grid exactly as the model's
    pooler call builds them."""
    from glass_tpu_torch.ops import roi_align_rotated as ra

    _, out_hw, sr, bulk, single = next(p for p in POOLERS if p[0] == name)
    if single:
        fused = torch.from_numpy(rng.randn(BUCKET_HW[0] // 4, BUCKET_HW[1] // 4, 256)
                                 .astype(np.float32)).cuda().to(dtype)
        pyr = ra.pack_pyramid([fused], [0.25])
        levels = torch.zeros((rois.shape[0],), dtype=torch.int32, device="cuda")
    else:
        _, pyr = _pyramid(rng, dtype)
        levels = ra.assign_boxes_to_levels(rois, 2, 6)
    n_large = n_full = 0
    if sr > 0:
        grid = ra.fixed_grid(rois.shape[0], sr, "cuda")
    else:
        rh, rw = ra._scaled_extent(rois, pyr.meta, levels)
        grid = ra.split_grid(rh, rw, out_hw, bulk, 4, 16)
        bh, bw = ra._grid_pair(bulk)
        n_large = int(((torch.ceil(rh / out_hw[0]) > bh) | (torch.ceil(rw / out_hw[1]) > bw)).sum())
        n_full = int((grid != ra.adaptive_grid(rh, rw, out_hw, bulk)).any(1).sum())
    return pyr, levels, grid, out_hw, n_large, n_full


def _max_err(got, ref) -> float:
    return (got.float() - ref.float()).abs().max().item() if ref.numel() else 0.0


# significand bits after the leading one of each 2-byte compute dtype
ULP_BITS = {torch.bfloat16: 7, torch.float16: 10}


def _tolerance(ref, dtype, exact_tol):
    """f32/uint8: the kernel repeats the plain version's arithmetic in the
    same order (no FMA contraction), so ``exact_tol`` is never used up (the
    runs read 0); bf16 and fp16: both round one f32 accumulator, so one ulp
    of that dtype."""
    if dtype not in ULP_BITS:
        return exact_tol
    return 2.0 ** -ULP_BITS[dtype] * max(1.0, ref.float().abs().max().item() if ref.numel() else 0.0)


def k1_case(label, pyr, rois, levels, grid, out_hw, timed=True):
    from glass_tpu_torch.ops import roi_align_rotated as ra

    launch = lambda: ra.roi_align_rotated_packed(pyr.flat, pyr.meta, rois, levels, grid, out_hw)  # noqa: E731
    got = launch()
    ref = ra.roi_align_rotated_packed_plain(pyr.flat, pyr.meta, rois, levels, grid, out_hw)
    torch.cuda.synchronize()
    dtype = pyr.flat.dtype
    err, tol = _max_err(got, ref), _tolerance(ref, dtype, 1e-4)
    row = dict(pooler=label, dtype=str(dtype).split(".")[1], err=err, tol=tol)
    if timed and rois.shape[0]:
        elt, c = pyr.flat.element_size(), pyr.flat.shape[1]
        samples = int((grid[:, 0] * grid[:, 1]).sum()) * out_hw[0] * out_hw[1]
        nbytes = (touched_rows(pyr.meta, rois, levels, grid, out_hw) * c * elt
                  + rois.shape[0] * out_hw[0] * out_hw[1] * c * elt + rois.shape[0] * 7 * 4)
        b_ms, b_by = bound(nbytes, samples * c * 8)
        row.update(ms=kernel_ms(launch), call_ms=time_ms(launch, 50),
                   plain_ms=time_ms(lambda: ra.roi_align_rotated_packed_plain(
                       pyr.flat, pyr.meta, rois, levels, grid, out_hw), 3, 1),
                   bound_ms=b_ms, bound_by=b_by)
        log(f"K1 {label:16s} {out_hw} {row['dtype']:8s} R={rois.shape[0]:3d} max|err| {err:.3g} (tol {tol:.3g}) "
            f"kernel {row['ms']:.4f} ms (wrapper call {row['call_ms']:.4f} ms) plain {row['plain_ms']:.3f} ms "
            f"bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / row['ms']:.1f}% of it")
    else:
        log(f"K1 {label:16s} {out_hw} {row['dtype']:8s} R={rois.shape[0]:3d} max|err| {err:.3g} (tol {tol:.3g})")
    if not err <= tol:
        raise AssertionError(f"K1 {label} {dtype}: max|err| {err} > {tol}")
    return row


def phase_k1(rng, rois_np):
    """The three poolers at their main-path shapes, then the edge cases of
    the kernel's work split: no roi, one roi, every roi on the full 4x4
    grid (16 samples a bin), a 6x6 grid (36 samples, more than a warp's
    32-entry table), and C of one 16-byte vector."""
    from glass_tpu_torch.ops import roi_align_rotated as ra

    rois = torch.from_numpy(rois_np).cuda()
    rows, edge = [], []
    for name, *_ in POOLERS:
        for dtype in (torch.float32, torch.bfloat16):
            pyr, levels, grid, out_hw, n_large, n_full = pooler_inputs(name, rng, dtype, rois)
            log(f"K1 {name}: large rois {n_large} (budget 16, {n_full} on the full grid)")
            rows.append(k1_case(name, pyr, rois, levels, grid, out_hw))
    rng = np.random.RandomState(1)  # the edge cases draw apart from phase 3's inputs
    for dtype in (torch.float32, torch.bfloat16):
        pyr, levels, grid, out_hw, _, _ = pooler_inputs("mask", rng, dtype, rois)
        for n in (0, 1):
            edge.append(k1_case(f"mask R={n}", pyr, rois[:n], levels[:n], grid[:n], out_hw, timed=False))
        full = ra.fixed_grid(rois.shape[0], 4, "cuda")
        edge.append(k1_case("mask full grid", pyr, rois, levels, full, out_hw))
        edge.append(k1_case("mask 6x6 grid", pyr, rois, levels, ra.fixed_grid(rois.shape[0], 6, "cuda"),
                            out_hw, timed=False))
        narrow = torch.from_numpy(rng.randn(BUCKET_HW[0] // 4, BUCKET_HW[1] // 4, ra.vector_width(dtype))
                                  .astype(np.float32)).cuda().to(dtype)
        npyr = ra.pack_pyramid([narrow], [0.25])
        zeros = torch.zeros((rois.shape[0],), dtype=torch.int32, device="cuda")
        edge.append(k1_case(f"C={npyr.flat.shape[1]} recognizer", npyr, rois, zeros,
                            ra.fixed_grid(rois.shape[0], 2, "cuda"), (8, 32), timed=False))
    return rows, edge


def k2_sample_grid(rois, h, w, out_hw):
    """grid_sample's normalized (x, y) of K2's sampling-ratio-1 points (one
    sample per output pixel at the bin centre), (1, R * OH, OW, 2)."""
    oh, ow = out_hw
    cx, cy = rois[:, 0] - 0.5, rois[:, 1] - 0.5
    rw, rh = rois[:, 2], rois[:, 3]
    th = rois[:, 4] * math.pi / 180.0
    c, s = torch.cos(th)[:, None, None], torch.sin(th)[:, None, None]
    i = torch.arange(oh, device=rois.device, dtype=torch.float32)
    j = torch.arange(ow, device=rois.device, dtype=torch.float32)
    yy = (-rh[:, None] / 2.0 + (i[None] + 0.5) * (rh / oh)[:, None])[:, :, None]
    xx = (-rw[:, None] / 2.0 + (j[None] + 0.5) * (rw / ow)[:, None])[:, None, :]
    y = (yy * c - xx * s) + cy[:, None, None]
    x = (yy * s + xx * c) + cx[:, None, None]
    g = torch.stack([(2.0 * x + 1.0) / w - 1.0, (2.0 * y + 1.0) / h - 1.0], -1)
    return g.reshape(1, -1, ow, 2)


def k2_yardstick(image, rois):
    """Device time of torch.nn.functional.grid_sample (bilinear, zeros,
    align_corners=False) on the sampling-ratio-1 points of K2, in the
    image's dtype or in f32 where that is refused: an (H, W, 3) image and
    (R, 5) rois, or a batch, (B, H, W, 3) and (B, R, 5), in one call over
    the (B, 3, H, W) batch with a (B, R * 128, 128, 2) grid.  Its border
    rule is not detectron2's: a yardstick of time only, never called by
    the port."""
    import torch.nn.functional as F

    if image.dim() == 3:
        image, rois = image[None], rois[None]
    h, w = image.shape[1:3]
    for dtype in (image.dtype, torch.float32):
        inp = image.permute(0, 3, 1, 2).contiguous().to(dtype)
        g = torch.cat([k2_sample_grid(r, h, w, (128, 128)) for r in rois]).to(dtype)
        try:
            F.grid_sample(inp, g, mode="bilinear", padding_mode="zeros", align_corners=False)
        except RuntimeError as e:
            log(f"grid_sample refuses {dtype}: {e}")
            continue
        ms = kernel_ms(lambda: F.grid_sample(inp, g, mode="bilinear", padding_mode="zeros",
                                             align_corners=False))
        log(f"K2 yardstick grid_sample ({dtype}, {rois.shape[0]} x {rois.shape[1]} x 128 x 128 points): "
            f"{ms:.4f} ms")
        return ms
    raise AssertionError("grid_sample ran in no dtype")


def k2_case(label, image, rois, out_hw, sr, normalize, std, timed=True):
    from glass_tpu_torch.ops import crop as cr
    from glass_tpu_torch.ops.roi_align_rotated import adaptive_grid, fixed_grid

    h, w = image.shape[:2]
    launch = lambda: cr.crop_rois(image, rois, out_hw, sr, 2, normalize)  # noqa: E731
    got = launch()
    ref = cr.crop_rois_plain(image, rois, out_hw, sr, 2, normalize)
    torch.cuda.synchronize()
    err = _max_err(got, ref)
    tol = _tolerance(ref, image.dtype, 1e-4 * 255.0 / float(std.min()) if normalize else 1e-4)
    row = dict(input=label, sr=sr, err=err, tol=tol)
    if timed and rois.shape[0]:
        grid = fixed_grid(rois.shape[0], sr, "cuda") if sr > 0 else adaptive_grid(rois[:, 3], rois[:, 2], out_hw, 2)
        meta = torch.tensor([[1.0, h, w, 0.0]], device="cuda")
        levels = torch.zeros((rois.shape[0],), dtype=torch.int32, device="cuda")
        samples = int((grid[:, 0] * grid[:, 1]).sum()) * out_hw[0] * out_hw[1]
        nbytes = (touched_rows(meta, rois, levels, grid, out_hw) * 3 * image.element_size()
                  + got.numel() * got.element_size() + rois.numel() * 4)
        b_ms, b_by = bound(nbytes, samples * 3 * 8)
        row.update(ms=kernel_ms(launch), call_ms=time_ms(launch, 50),
                   plain_ms=time_ms(lambda: cr.crop_rois_plain(image, rois, out_hw, sr, 2, normalize), 3, 1),
                   bound_ms=b_ms, bound_by=b_by)
        log(f"K2 {label:14s} {out_hw} sr={sr} R={rois.shape[0]:3d} max|err| {err:.3g} (tol {tol:.3g}) "
            f"kernel {row['ms']:.4f} ms (wrapper call {row['call_ms']:.4f} ms) plain {row['plain_ms']:.3f} ms "
            f"bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / row['ms']:.1f}% of it")
    else:
        log(f"K2 {label:14s} {out_hw} sr={sr} R={rois.shape[0]:3d} max|err| {err:.3g} (tol {tol:.3g})")
    if not err <= tol:
        raise AssertionError(f"K2 {label} {out_hw} sr={sr}: max|err| {err} > {tol}")
    return row


def phase_k2(rng, rois_np):
    """uint8 with the fold, f32 and bf16 at sampling ratios 1, 2 and 0, then
    the edge cases of the work split: no roi, one roi, a ragged 32x100
    output (fewer columns than a block has threads, rows no multiple of a
    block's band) and a one-pixel-wide image (both taps of an image row are
    one pixel)."""
    h, w = BUCKET_HW
    rois = torch.from_numpy(rois_np).cuda()
    raw = torch.from_numpy(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).cuda()
    mean = torch.tensor([103.53, 116.28, 123.675], device="cuda")
    std = torch.tensor([57.375, 57.12, 58.395], device="cuda")
    norm32 = (raw.float() - mean) / std
    rows, edge = [], []
    images = (("uint8+fold", raw, (mean, std)), ("float32", norm32, None),
              ("bfloat16", norm32.to(torch.bfloat16), None))
    column = rois.clone()
    column[:, 0] = 0.5
    for label, image, normalize in images:
        for sr in (1, 2, 0):
            rows.append(k2_case(label, image, rois, (128, 128), sr, normalize, std))
        for n in (0, 1):
            edge.append(k2_case(label, image, rois[:n], (128, 128), 0, normalize, std, timed=False))
        edge.append(k2_case(label, image, rois, (32, 100), 2, normalize, std, timed=False))
        edge.append(k2_case(f"{label} W=1", image[:, :1].contiguous(), column, (16, 8), 2, normalize, std,
                            timed=False))
    lib_ms = {label: k2_yardstick(image, rois) for label, image, _ in images[1:]}
    for row in rows:
        if row["sr"] == 1 and row["input"] in lib_ms:
            row["library_ms"] = lib_ms[row["input"]]
    return rows, edge, lib_ms["bfloat16"]


def eval_cfg(dtype: str, config: str = ICDAR15, opts=()):
    """A shipped config (configs/glass_finetune_icdar15.yaml unless another
    is named) + tools/eval_glass.py's ICDAR15 protocol overrides (test
    sizes, thresholds, masks on, orientation not applied to boxes), then
    the compute dtype and opts."""
    from glass_tpu_torch.config import get_cfg

    cfg = get_cfg(config)
    cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.35
    cfg.INFERENCE_TH_TEST = 0.3
    cfg.INFERENCE_DETECTION_TH_TEST = 0.65
    cfg.POST_PROCESSING.TEXT_THRESHOLD = 0.3
    cfg.POST_PROCESSING.DETECT_THRESHOLD = 0.65
    cfg.INPUT.MIN_SIZE_TEST = 1000
    cfg.INPUT.MAX_SIZE_TEST = 1600
    cfg.MODEL.ROI_MASK_HEAD.MASK_INFERENCE = True
    cfg.MODEL.ROI_ORIENTATION_HEAD.APPLY_TO_BOXES = False
    cfg.merge_from_list(["TPU.COMPUTE_DTYPE", dtype, *opts])
    return cfg


def seeded_weights(image: np.ndarray) -> dict:
    """Seeded random weights with BN statistics calibrated on one image
    (f32, on the card)."""
    from glass_tpu_torch.inference.runner import calibrate_batch_norm_, random_init_
    from glass_tpu_torch.models import GlassArch, GlassRCNN

    arch = GlassArch.from_config(eval_cfg("float32"))
    model = random_init_(GlassRCNN(arch), seed=0).eval().cuda()
    h, w = image.shape[:2]
    padded = np.zeros(BUCKET_HW + (3,), np.float32)
    padded[:h, :w] = image
    calibrate_batch_norm_(model, torch.from_numpy(padded).cuda(), (h, w))
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def _stage_kernels(event):
    """(op, kernel name, µs) of every kernel launched under ``event``; op is
    the innermost profiled call that launched it (an aten op, or the stage
    span itself for the ctypes-launched K1/K2)."""
    out = [(event.name, k.name, k.duration) for k in event.kernels]
    for child in event.cpu_children:
        out += _stage_kernels(child)
    return out


def profile_model(runner, image, out_dir, call=None, name="profile_main_path.txt"):
    """torch.profiler over one model call (``runner.run_model(image)``, or
    ``call()``): device busy share, the kernels that take the most device
    time, and each stage span's kernels (count, device time, and the ops
    that launched them), written to ``out_dir``/``name``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call = call or (lambda: runner.run_model(image))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side copies of the stage spans (gpu_user_annotation) and the
    # profiler's own buffer requests are not device work
    not_work = set(STAGES) | {"Activity Buffer Request"}
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type)
              and e.key not in not_work]
    dev_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in events) / 1e3
    try:
        table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    except (AttributeError, KeyError):  # older profilers name the key after CUDA
        table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    n_device = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                   and e.name not in not_work)
    lines = []
    staged_ms = staged_n = 0
    for span in (e for e in prof.events() if e.device_type == DeviceType.CPU and e.name in STAGES):
        ks = _stage_kernels(span)
        ms = sum(k[2] for k in ks) / 1e3
        staged_ms += ms
        staged_n += len(ks)
        elem = [k for k in ks if "elementwise" in k[1]]
        by_op = collections.Counter()
        op_ms = collections.Counter()
        for op, _, us in ks:
            by_op[op] += 1
            op_ms[op] += us / 1e3
        top = ", ".join(f"{op} x{n} {op_ms[op]:.2f} ms" for op, n in by_op.most_common(5))
        lines.append(f"  {span.name:17s} {len(ks):5d} kernels {ms:8.3f} ms device; "
                     f"elementwise x{len(elem)} {sum(k[2] for k in elem) / 1e3:.3f} ms; by op: {top}")
    lines.append(f"  stages hold {staged_n} of {n_device} device records (kernels, copies) and "
                 f"{staged_ms:.3f} of {dev_ms:.3f} ms device time")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(table + "\n\nper stage span:\n" + "\n".join(lines) + "\n")
    top = sorted(events, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:8]
    log(f"profile (one model call, {wall_ms:.1f} ms wall): device busy {dev_ms:.1f} ms "
        f"= {100 * dev_ms / wall_ms:.1f}% of wall, {n_device} device records (kernels, copies)")
    for e in top:
        log(f"  {getattr(e, 'self_device_time_total', 0.0) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    log("profile per stage span:")
    for line in lines:
        log(line)
    return wall_ms, dev_ms


def phase_main(images, state_dict, n_timed, out_dir):
    """GlassRunner.__call__ at bf16 on the card: 2 warm-up images, then
    ``n_timed`` timed ones cycling through ``images``.  Spans around
    ``__call__`` and around its ``run_model`` (upload, device work, fetch)
    split each image's time into model and host (resize, post-processing)."""
    from glass_tpu_torch.inference import GlassRunner
    from glass_tpu_torch.ops import _cuda

    runner = GlassRunner(cfg=eval_cfg("bfloat16"), state_dict=state_dict, device="cuda")
    model_ms = []
    run_model = runner.run_model

    def timed_run_model(image, rid=None):
        t0 = time.perf_counter()
        out = run_model(image, rid)  # ends in the fetch to numpy, so the device is done
        model_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    runner.run_model = timed_run_model
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.LAUNCHES.clear()
    times, results = [], []
    for i in range(2 + n_timed):
        img = images[i % len(images)]
        t0 = time.perf_counter()
        preds = runner(img)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        results.append(preds)
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20
    runner.run_model = run_model
    n_img = len(times)
    log(f"main path launches over {n_img} images: {launches}")
    for k in ("roi_align_rotated", "crop_rois"):
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    total, model = np.asarray(times[2:]), np.asarray(model_ms[2:])
    host = total - model
    q = lambda a, p: float(np.percentile(a, p))  # noqa: E731
    log(f"main path ({card_line()}): {len(total)} timed images through __call__ (2 warm-up); "
        f"ms/image median {q(total, 50):.2f}, p75 {q(total, 75):.2f}, p90 {q(total, 90):.2f}, "
        f"max {total.max():.2f}; {1e3 / q(total, 50):.2f} img/s at the median; peak memory {peak:.0f} MiB")
    log(f"main path split: model (run_model) median {q(model, 50):.2f} ms, p75 {q(model, 75):.2f}, "
        f"p90 {q(model, 90):.2f}; host (resize, post-processing) median {q(host, 50):.2f} ms, "
        f"p90 {q(host, 90):.2f}")
    log(f"main path per image ms: {[round(t, 1) for t in times]}")
    valid = [len(r) for r in results]
    log(f"main path words after post-processing per image: {valid}")
    raw = runner.run_on_resized(images[0].astype(np.float32))
    raw_texts = runner.decode_texts(raw)[0] if len(raw) else []
    log(f"main path: {len(raw)} raw valid detections on image 0; first decoded texts {raw_texts[:6]}")
    profile_model(runner, images[0].astype(np.float32), out_dir)
    return dict(median_ms=q(total, 50), p75_ms=q(total, 75), p90_ms=q(total, 90), peak_mib=peak,
                launches=launches, n_images=n_img)


def _box_dist(a, b):
    """Per-row distance of rotated boxes: max over |dx|, |dy|, |dw|, |dh|
    (pixels) and the wrapped angle difference (degrees)."""
    d = np.abs(a[..., :4] - b[..., :4])
    ang = np.abs((a[..., 4] - b[..., 4] + 180.0) % 360.0 - 180.0)
    return np.maximum(d.max(-1), ang)


def _pair_rows(boxes_a, boxes_b):
    """One-to-one pairing of two detection sets by nearest box (greedy in
    a's row order): index into b for every row of a."""
    used, pair = np.zeros(len(boxes_b), bool), []
    for box in boxes_a:
        d = _box_dist(box[None], boxes_b)
        d[used] = np.inf
        j = int(np.argmin(d))
        used[j] = True
        pair.append(j)
    return np.asarray(pair, int)


# Phase 5 tolerances (PERF.md states them with their reasons).  Staged:
# each stage on both devices from the same inputs.
FEATURE_REL_TOL = 1e-3     # max|card - CPU| / max|CPU| per FPN level
BOX_ATOL, BOX_RTOL = 0.05, 1e-4
SCORE_ATOL = 1e-3
PROB_ATOL = 1e-3           # text step probabilities and mask probabilities
KNIFE_EDGE = 1e-4          # top-two margin under which a decoding step may flip
# End to end, each device from the image alone: the stages' differences
# compound (a box a fraction of a pixel off pools other samples).
E2E_BOX_ATOL, E2E_BOX_RTOL = 0.5, 1e-3
E2E_MASK_ATOL = 5e-2


def phase_whole(image, state_dict):
    """The f32 port (no TF32) on the card against the f32 port on the CPU
    (plain kernel versions), same weights, one full-size image.

    Staged: every CPU stage takes the card's inputs to that stage, so each
    stage's comparison sees only its own arithmetic (cuDNN vs CPU
    convolutions, kernels vs plain versions).  Then the whole path run
    independently on both: equal valid counts, and rows paired one to one
    by box that agree within the end-to-end tolerances."""
    from glass_tpu_torch.inference import GlassRunner
    from glass_tpu_torch.models import glass_rcnn as gr

    cfg = eval_cfg("float32")
    gpu_r = GlassRunner(cfg=cfg, state_dict=state_dict, device="cuda")
    cpu_r = GlassRunner(cfg=cfg, state_dict=state_dict, device="cpu")
    h, w = image.shape[:2]
    hw = (h, w)
    padded = np.zeros(BUCKET_HW + (3,), np.float32)
    padded[:h, :w] = image
    failed = []

    def check(name, ok, text):
        log(f"whole path {name}: {text} -> {'ok' if ok else 'FAILED'}")
        if not ok:
            failed.append(name)

    gm, cm = gpu_r.model, cpu_r.model
    with torch.inference_mode():
        norm = gr.preprocess(gm, torch.from_numpy(padded).cuda())
        feats = gr.backbone_features(gm, norm)
        cpu_feats = gr.backbone_features(cm, norm.cpu())
        for k in cpu_feats:
            rel = float((feats[k].cpu() - cpu_feats[k]).abs().max() / cpu_feats[k].abs().max())
            check(f"backbone {k}", rel <= FEATURE_REL_TOL, f"max|card-CPU| / max|CPU| {rel:.3g} (tol {FEATURE_REL_TOL})")
        fc = {k: v.cpu() for k, v in feats.items()}
        pyr, cpu_pyr = gr.pack_box_pyramid(gm, feats), gr.pack_box_pyramid(cm, fc)

        pb, _, pv = gr.rpn_proposals_single(gm, feats, hw)
        cb, _, cv = gr.rpn_proposals_single(cm, fc, hw)
        pb, pv, cb, cv = pb.cpu().numpy(), pv.cpu().numpy(), cb.numpy(), cv.numpy()
        n_far = -1
        if pv.sum() == cv.sum():
            d = _box_dist(pb[pv], cb[cv])
            n_far = int((d > BOX_ATOL + BOX_RTOL * np.abs(cb[cv][:, :4]).max(-1)).sum())
        log(f"whole path proposals from the card's features: valid card {int(pv.sum())} CPU {int(cv.sum())}, "
            f"rows whose box differs {n_far} (diagnostic; a top-k or NMS near-tie reorders them)")

        det = gr.detect_single_image(gm, feats, pyr, hw)
        cdet = gr.detect_single_image(cm, fc, cpu_pyr, hw)
        dv, cdv = det.valid.cpu().numpy(), cdet.valid.numpy()
        check("detections valid", int(dv.sum()) == int(cdv.sum()), f"card {int(dv.sum())} CPU {int(cdv.sum())}")
        db, ds = det.boxes.cpu().numpy()[dv], det.scores.cpu().numpy()[dv]
        cb, cs_ = cdet.boxes.numpy()[cdv], cdet.scores.numpy()[cdv]
        if len(db) == len(cb) and len(db):
            pair = _pair_rows(db, cb)
            d = _box_dist(db, cb[pair])
            box_ok = d <= BOX_ATOL + BOX_RTOL * np.abs(cb[pair][:, :4]).max(-1)
            score_err = np.abs(ds - cs_[pair])
            log(f"whole path detections: {int((pair != np.arange(len(pair))).sum())} of {len(pair)} rows "
                f"sit at another row on the CPU; max box diff {d.max():.3g}, max score diff {score_err.max():.3g}")
            check("detection boxes", bool(box_ok.all()),
                  f"{int((~box_ok).sum())} rows outside {BOX_ATOL} px + {BOX_RTOL} rel")
            check("detection scores", bool((score_err <= SCORE_ATOL).all()),
                  f"{int((score_err > SCORE_ATOL).sum())} rows outside {SCORE_ATOL}")

        # recognizer and mask head on the card's detection set (all rows)
        probs = gr.recognize_single_image(gm, feats, norm, det.boxes).cpu().numpy()
        cprobs = gr.recognize_single_image(cm, fc, norm.cpu(), det.boxes.cpu()).numpy()
        top2 = np.sort(cprobs, -1)[..., -2:]
        steps = ~np.cumsum(top2[..., 1] - top2[..., 0] < KNIFE_EDGE, axis=1).astype(bool)
        perr = float(np.abs(probs - cprobs)[steps].max())
        check("text probabilities", perr <= PROB_ATOL,
              f"max|card-CPU| {perr:.3g} over {int(steps.sum())} of {steps.size} steps before a knife edge (tol {PROB_ATOL})")
        same_ids = bool((probs.argmax(-1)[steps] == cprobs.argmax(-1)[steps]).all())
        check("text ids", same_ids, f"equal on every step before a knife edge: {same_ids}")
        masks = gr.mask_single_image(gm, pyr, det.boxes, det.classes).cpu().numpy()
        cmasks = gr.mask_single_image(cm, cpu_pyr, det.boxes.cpu(), det.classes.cpu()).numpy()
        merr = float(np.abs(masks - cmasks).max())
        check("mask probabilities", merr <= PROB_ATOL, f"max|card-CPU| {merr:.3g} (tol {PROB_ATOL})")

    # the whole path, each side on its own
    gpu = gpu_r.run_model(image.astype(np.float32))
    t0 = time.perf_counter()
    cpu = cpu_r.run_model(image.astype(np.float32))
    log(f"whole path: CPU run {time.perf_counter() - t0:.1f} s")
    gv, cv = np.nonzero(gpu["valid"])[0], np.nonzero(cpu["valid"])[0]
    check("end-to-end valid", len(gv) == len(cv), f"card {len(gv)} CPU {len(cv)}")
    if len(gv) == len(cv) and len(gv):
        pair = cv[_pair_rows(gpu["boxes"][gv], cpu["boxes"][cv])]
        a, b = gpu["boxes"][gv], cpu["boxes"][pair]
        box_d = _box_dist(a, b)
        box_ok = box_d <= E2E_BOX_ATOL + E2E_BOX_RTOL * np.abs(b[:, :4]).max(-1)
        score_d = np.abs(gpu["scores"][gv] - cpu["scores"][pair])
        mask_d = np.abs(gpu["mask_probs"][gv].astype(np.float32)
                        - cpu["mask_probs"][pair].astype(np.float32)).reshape(len(gv), -1).max(-1)
        same_text = np.all(gpu["text_ids"][gv] == cpu["text_ids"][pair], axis=1)
        log(f"whole path end to end: {int((pair != gv).sum())} of {len(gv)} rows sit at another row "
            f"on the CPU; identical text ids on {same_text.mean():.3f} of rows")
        check("end-to-end boxes", bool(box_ok.all()),
              f"max diff {box_d.max():.3g}, median {np.median(box_d):.3g}; {int((~box_ok).sum())} rows "
              f"outside {E2E_BOX_ATOL} px + {E2E_BOX_RTOL} rel")
        check("end-to-end scores", bool((score_d <= SCORE_ATOL).all()),
              f"max diff {score_d.max():.3g}, median {np.median(score_d):.3g} (tol {SCORE_ATOL})")
        check("end-to-end masks", bool((mask_d <= E2E_MASK_ATOL).all()),
              f"max diff {mask_d.max():.3g}, median {np.median(mask_d):.3g} (tol {E2E_MASK_ATOL})")
    if failed:
        raise AssertionError(f"whole path differs beyond tolerance in {failed}")


# ---------------------------------------------------------------------------
# phase 6: the evaluation path
# ---------------------------------------------------------------------------

# 7x5 glyphs of tests/test_learning_synthetic.py
GLYPHS = {
    "a": ["11111", "10001", "10001", "11111", "10001", "10001", "10001"],
    "b": ["11110", "10001", "11110", "10001", "10001", "10001", "11110"],
    "c": ["01110", "10000", "10000", "10000", "10000", "10000", "01110"],
    "d": ["00100", "00100", "01110", "00100", "00100", "00100", "00100"],
    "e": ["10001", "01010", "00100", "00100", "00100", "01010", "10001"],
    "f": ["00100", "01110", "10101", "00100", "00100", "00100", "00100"],
}
GLYPH_WORDS = ["ace", "bdf", "fab", "ecd", "bad", "cafe", "face", "deaf"]
# Thresholds loosened so that a random model's words survive (as
# tests/test_torch_slice.py does).
LOOSE_OPTS = ["POST_PROCESSING.VALID_CONFIDENCE", "0.05", "POST_PROCESSING.DETECT_THRESHOLD", "0.1",
              "POST_PROCESSING.TEXT_THRESHOLD", "0.0"]
MERGE_PX_TOL = MERGE_DEG_TOL = 1e-3


def render_word(word: str, scale: int) -> np.ndarray:
    import cv2

    img = np.zeros((7 * scale, 6 * len(word) * scale), np.uint8)
    for i, ch in enumerate(word):
        g = np.array([[int(c) for c in row] for row in GLYPHS[ch]], np.uint8)
        g = cv2.resize(g * 255, (5 * scale, 7 * scale), interpolation=cv2.INTER_NEAREST)
        img[:, i * 6 * scale: i * 6 * scale + 5 * scale] = g
    return img


def write_eval_set(root: str, n_images: int, hw, seed: int = 0, name: str = "synth_test",
                   train: bool = False) -> str:
    """A COCO-style set (``<root>/ds/<name>/annotations.json`` and its
    PNGs) of words on noisy backgrounds, one text line per band of the
    image, annotated with rotated_box, rec, angle, orientation and
    segmentation; returns the dataset yaml, which lists the set for
    evaluation, or with ``train`` for training."""
    import cv2

    h, w = hw
    rng = np.random.RandomState(seed)
    scale = max(1, h // 100)
    d = os.path.join(root, "ds", name)
    os.makedirs(d, exist_ok=True)
    images, anns = [], []
    for i in range(n_images):
        img = (rng.randint(30, 70, (h, w, 3))).astype(np.uint8)
        band = 7 * scale + 12 * scale
        for y0 in range(4 * scale, h - band, band):
            x0 = int(rng.randint(3 * scale, 20 * scale))
            while True:
                word = GLYPH_WORDS[rng.randint(len(GLYPH_WORDS))]
                glyph = render_word(word, scale)
                gh, gw = glyph.shape
                pad = max(2, scale)
                if x0 + gw + pad >= w:
                    break
                img[y0 - pad: y0 + gh + pad, x0 - pad: x0 + gw + pad] = 0
                img[y0: y0 + gh, x0: x0 + gw] = glyph[..., None]
                quad = [[x0 - pad, y0 - pad], [x0 + gw + pad, y0 - pad], [x0 + gw + pad, y0 + gh + pad],
                        [x0 - pad, y0 + gh + pad]]
                anns.append({"id": len(anns) + 1, "image_id": i + 1, "category_id": 1,
                             "bbox": [x0 - pad, y0 - pad, gw + 2 * pad, gh + 2 * pad], "rotated_box": quad,
                             "segmentation": [[c for pt in quad for c in pt]], "rec": word, "angle": 0,
                             "orientation": 0, "area": (gw + 2 * pad) * (gh + 2 * pad), "iscrowd": 0})
                x0 += gw + int(rng.randint(6 * scale, 40 * scale))
        cv2.imwrite(os.path.join(d, f"img_{i}.png"), img)
        images.append({"id": i + 1, "file_name": f"img_{i}.png", "height": h, "width": w})
    with open(os.path.join(d, "annotations.json"), "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": [{"id": 1, "name": "word"}]}, f)
    path = os.path.join(root, "datasets.yaml")
    with open(path, "w") as f:
        sets = f"DATASETS:\n  - {name}\nVAL_DATASETS: []\n" if train else f"DATASETS: []\nVAL_DATASETS:\n  - {name}\n"
        f.write(f"ROOT: {os.path.join(root, 'ds')}\n{sets}")
    return path


def same_predictions(a, b) -> list:
    """Fields of two post-processed prediction lists that are not equal bit
    for bit."""
    bad = []
    for n, (x, y) in enumerate(zip(a, b)):
        if x.image_size != y.image_size or sorted(x.get_fields()) != sorted(y.get_fields()):
            bad.append(f"image {n}: fields")
            continue
        for k, v in x.get_fields().items():
            w = y.get(k)
            if isinstance(v, list):
                ok = len(v) == len(w) and all(np.array_equal(p, q) for p, q in zip(v, w))
            else:
                ok = np.array_equal(np.asarray(v), np.asarray(w))
            if not ok:
                bad.append(f"image {n}: {k}")
    return bad + (["lengths"] if len(a) != len(b) else [])


class StageClock:
    """Wall time of the runner's batch stages, summed per stage: the model
    (``dispatch_batch``: upload, the per-image programs, the start of the
    fetch), the fetch (``collect_batch``: the wait for the copy, unpacking)
    and host post-processing (``_postprocess_chunk``), which holds
    ``detector_postprocess`` (rescale, mask polygons) and the merge
    (``merge_intersecting_boxes``, host or device); the rest of it is the
    filters, polygons and text decoding."""

    def __init__(self, spans=None):
        from glass_tpu_torch.inference import GlassRunner
        from glass_tpu_torch.postprocess import PostProcessorRotatedBoxes

        self.spans = spans or (
            (GlassRunner, "dispatch_batch", "model"), (GlassRunner, "collect_batch", "fetch"),
            (GlassRunner, "_postprocess_chunk", "host"),
            (GlassRunner, "_model_postprocess", "host: detector_postprocess"),
            (PostProcessorRotatedBoxes, "merge_intersecting_boxes", "host: merge"))
        self.ms, self.saved = collections.Counter(), []

    def __enter__(self):
        for cls, name, stage in self.spans:
            fn = getattr(cls, name)
            self.saved.append((cls, name, fn))

            def timed(*a, _fn=fn, _stage=stage, **k):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    self.ms[_stage] += (time.perf_counter() - t0) * 1e3

            setattr(cls, name, timed)
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self.saved:
            setattr(cls, name, fn)


class MergeCount:
    """The host merge's work (``merge_intersecting_boxes``): its calls,
    the rows they take in and give back, and the rounds that merged a pair
    (``_merge_rotated_boxes``, one a round)."""

    def __init__(self):
        self.calls = self.rows_in = self.rows_out = self.rounds = 0

    def __enter__(self):
        from glass_tpu_torch.postprocess import PostProcessorRotatedBoxes

        cls = PostProcessorRotatedBoxes
        self.saved = cls.merge_intersecting_boxes, cls.__dict__["_merge_rotated_boxes"]
        merge, pair = self.saved

        def counted_merge(pp, preds, *a, **k):
            self.calls += 1
            self.rows_in += len(preds)
            out = merge(pp, preds, *a, **k)
            self.rows_out += len(out)
            return out

        def counted_pair(owner, *a, **k):
            self.rounds += 1
            return pair.__func__(owner, *a, **k)

        cls.merge_intersecting_boxes = counted_merge
        cls._merge_rotated_boxes = classmethod(counted_pair)
        return self

    def __exit__(self, *exc):
        from glass_tpu_torch.postprocess import PostProcessorRotatedBoxes

        PostProcessorRotatedBoxes.merge_intersecting_boxes, PostProcessorRotatedBoxes._merge_rotated_boxes = self.saved

    def summary(self):
        return (f"host merge: {self.calls} calls, rows {self.rows_in} in and {self.rows_out} out, "
                f"{self.rounds} merging rounds")


def count_syncs(fn, device) -> tuple:
    """(syncs, {source line: count}) of the host syncs ``fn`` makes, from
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    if device.type != "cuda":
        fn()
        return 0, {}
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    where = collections.Counter(f"{os.path.relpath(w.filename)}:{w.lineno}" for w in syncs)
    return len(syncs), dict(where.most_common(8))


class MergeInputs:
    """Records the padded sets the post-processor hands to the on-device
    merge (``device_merge.merge_intersecting_boxes_device``), as numpy."""

    def __enter__(self):
        from glass_tpu_torch.postprocess import device_merge

        self.module, self.fn, self.sets = device_merge, device_merge.merge_intersecting_boxes_device, []

        def recorded(boxes, scores, valid, **kw):
            self.sets.append(tuple(t.cpu().numpy() for t in (boxes, scores, valid)))
            return self.fn(boxes, scores, valid, **kw)

        device_merge.merge_intersecting_boxes_device = recorded
        return self

    def __exit__(self, *exc):
        self.module.merge_intersecting_boxes_device = self.fn


def check_merge_card_vs_cpu(runner, sets, device):
    """The on-device merge on ``device`` against the same code on the CPU,
    one iteration at a time from the CPU's state (so that the two sides'
    rounding does not compound): the same survivors and boxes within 1e-3
    px / 1e-3 degrees at every step.  A set with a pair whose IoA lies
    within 1e-5 of the merge gate is reported and not held (it may merge on
    one side only).  The whole fixpoint's largest difference is reported."""
    from glass_tpu_torch.ops.iou_rotated import pairwise_ioa_rotated
    from glass_tpu_torch.postprocess.device_merge import merge_intersecting_boxes_device

    pp = runner.post_processor
    kw = dict(ioa_threshold=pp.merge_ioa_thresh, height_ratio_thresh=pp.pairs_height_ratio_thresh,
              max_angle_diff=pp.max_angle_diff, valid_score=pp.valid_score)

    def both(boxes, scores, valid, **extra):
        out = []
        for dev in (device, torch.device("cpu")):
            b, v = merge_intersecting_boxes_device(torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev),
                                                   torch.from_numpy(valid).to(dev), **kw, **extra)
            out.append((b.cpu().numpy(), v.cpu().numpy()))
        return out

    def box_diff(a, b):
        d = np.abs(a[:, :4] - b[:, :4]).max(1, initial=0.0)
        return np.maximum(d, np.abs((a[:, 4] - b[:, 4] + 180.0) % 360.0 - 180.0))

    worst, worst_fix, knife, steps, merged, failed = 0.0, 0.0, 0, 0, 0, []
    for n, (boxes, scores, valid) in enumerate(sets):
        ioa = pairwise_ioa_rotated(torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy()
        pairs = valid[:, None] & valid[None, :] & ~np.eye(len(boxes), dtype=bool)
        if (np.abs(ioa - kw["ioa_threshold"])[pairs] < 1e-5).any():
            knife += 1
            continue
        (gb, gv), (cb, cv) = both(boxes, scores, valid)
        worst_fix = max(worst_fix, float(box_diff(gb[cv], cb[cv]).max(initial=0.0)) if (gv == cv).all() else np.inf)
        b, v = boxes, valid
        for _ in range(8):
            (gb, gv), (cb, cv) = both(b, scores, v, max_iters=1)
            steps += 1
            d = float(box_diff(gb[cv], cb[cv]).max(initial=0.0))
            worst = max(worst, d)
            if not (gv == cv).all() or d > MERGE_PX_TOL:
                failed.append(f"image {n}: survivors equal {bool((gv == cv).all())}, max diff {d:.3g}")
                break
            if np.array_equal(cb, b) and np.array_equal(cv, v):
                break
            merged += int(v.sum() - cv.sum())
            b, v = cb, cv
    log(f"eval merge card vs CPU: {len(sets) - knife} sets held ({knife} with an IoA within 1e-5 of the gate), "
        f"{steps} iterations, {merged} boxes merged away; max step diff {worst:.3g} (tol {MERGE_PX_TOL} px / "
        f"{MERGE_DEG_TOL} deg); whole fixpoint max diff {worst_fix:.3g} (reported, not held)")
    if failed:
        raise AssertionError(f"on-device merge: card and CPU differ: {failed}")
    return worst


def phase_eval(state_dict, out_dir, device="cuda", n_images=N_IMAGES, hw=(720, 1280), opts=()):
    """The evaluation path through ``glass_tpu_torch.eval.main``, host merge
    then on-device merge, and the checks of the batched runner."""
    device = torch.device(device)
    root = os.path.join(out_dir, "eval")
    try:
        return _phase_eval(state_dict, root, device, n_images, hw, opts)
    finally:  # the images and the .pth are large; the results stay
        import shutil

        shutil.rmtree(os.path.join(root, "ds"), ignore_errors=True)
        for name in ("model.pth",):
            if os.path.exists(os.path.join(root, name)):
                os.remove(os.path.join(root, name))


def _phase_eval(state_dict, root, device, n_images, hw, opts):
    import cv2

    from glass_tpu_torch import eval as port_eval
    from glass_tpu_torch.inference import GlassRunner
    from glass_tpu_torch.native import polyclip_path
    from glass_tpu_torch.ops import _cuda

    ds_yaml = write_eval_set(root, n_images, hw)
    pth = os.path.join(root, "model.pth")
    torch.save(state_dict, pth)
    opts = ["TPU.COMPUTE_DTYPE", "bfloat16", *LOOSE_OPTS, *opts]
    common = ["--config", ICDAR15, "--datasets", ds_yaml, "--model", pth, "--device", str(device),
              "--batch-size", "4"]
    port_eval.main(common + ["--output", os.path.join(root, "warmup"), "--max-images", "4", *opts])
    card = card_line() if device.type == "cuda" else "CPU"
    runs = {}
    for merge in ("host", "device"):
        bench = os.path.join(root, f"bench_{merge}.jsonl")
        if os.path.exists(bench):
            os.remove(bench)
        run_opts = [*opts, "POST_PROCESSING.ON_DEVICE", str(merge == "device")]
        _cuda.LAUNCHES.clear()
        results = port_eval.main(common + ["--output", os.path.join(root, merge), "--bench-log", bench, *run_opts])
        launches = dict(_cuda.LAUNCHES)
        with open(bench) as f:
            last = [json.loads(line) for line in f][-1]
        res = results["synth_test"]
        runs[merge] = dict(img_s=last["done"] / last["elapsed_s"], results=res, launches=launches)
        prh = "; ".join(f"{k.split('_')[0].lower()} P {v['precision']:.4f} R {v['recall']:.4f} H {v['hmean']:.4f}"
                        for k, v in res.items())
        log(f"eval {merge} merge ({card}): {last['done']} images at batch 4 in {last['elapsed_s']:.3f} s, "
            f"{runs[merge]['img_s']:.3f} img/s (CLI loop, image reads included); {prh}; "
            f"K1/K2 launches {launches}")
        if device.type == "cuda":
            want = {"roi_align_rotated": 3 * last["done"], "crop_rois": last["done"]}
            got = {k: launches.get(k, 0) for k in want}
            if got != want:
                raise AssertionError(f"eval path launches {got}, expected 3 and 1 per image {want}")
    log(f"eval polygon path: {polyclip_path()}")

    images = [cv2.imread(os.path.join(root, "ds", "synth_test", f"img_{i}.png")) for i in range(n_images)]
    for merge in ("host", "device"):
        cfg = port_eval.setup(port_eval.parse_args(common + ["--output", os.path.join(root, "direct"), *opts,
                                                  "POST_PROCESSING.ON_DEVICE", str(merge == "device")]))
        runner = GlassRunner(cfg=cfg, state_dict=state_dict, device=device)
        runner.eval_batch_call(images[:4], batch_size=4)  # warm-up
        with StageClock() as clock:
            t0 = time.perf_counter()
            b4 = runner.eval_batch_call(images, batch_size=4)
            if device.type == "cuda":
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        if merge == "device":
            with MergeInputs() as merged:
                runner.eval_batch_call(images, batch_size=4)
            check_merge_card_vs_cpu(runner, merged.sets, device)
        b1 = runner.eval_batch_call(images, batch_size=1)
        bad = same_predictions(b4, b1)
        log(f"eval_batch_call {merge} merge ({card}): {n_images} images, batches of 4 pipelined (ASYNC_FETCH "
            f"{bool(cfg.TPU.ASYNC_FETCH)}): {wall:.2f} ms wall, {1e3 * n_images / wall:.3f} img/s; summed per "
            f"stage (model and fetch in the worker thread, the rest beside them): "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in clock.ms.items())
            + f"; words per image {[len(p) for p in b4]}")
        log(f"eval_batch_call batch 4 vs batch 1 ({merge} merge): "
            f"{'equal bit for bit' if not bad else 'DIFFERENT: ' + ', '.join(bad[:6])}")
        if bad:
            raise AssertionError(f"eval_batch_call batch 4 differs from batch 1 ({merge} merge): {bad}")
        syncs, where = count_syncs(lambda: runner.eval_batch_call(images[:4], batch_size=4), device)
        log(f"eval host syncs ({merge} merge): {syncs} over 4 images, {syncs / 4:.1f} per image; "
            f"most from {where}")
        runs[merge].update(direct_img_s=1e3 * n_images / wall, stage_ms=dict(clock.ms), syncs_per_image=syncs / 4)
    return runs


# ---------------------------------------------------------------------------
# phase 7: K1b, the rotated RoIAlign backward, at the training shapes
# ---------------------------------------------------------------------------

TRAIN_BUCKET_HW = (832, 1440)  # a 720x1280 image at short edge 810, padded to 32
# rois per image of the three poolers on the training path (ROI_HEADS 512,
# masks 512 * 0.25, recognizer words MAX_BATCH_SIZE 8)
TRAIN_ROIS = {"box": 512, "mask": 128, "recognizer": 8}


def _train_pooler_inputs(name, rng, dtype, rois):
    """Packed features, levels and grid at the training bucket, as the
    training forward builds them for one image."""
    from glass_tpu_torch.ops import roi_align_rotated as ra

    _, out_hw, sr, bulk, single = next(p for p in POOLERS if p[0] == name)
    h, w = TRAIN_BUCKET_HW
    if single:
        fused = torch.from_numpy(rng.randn(h // 4, w // 4, 256).astype(np.float32)).cuda().to(dtype)
        pyr = ra.pack_pyramid([fused], [0.25])
        levels = torch.zeros((rois.shape[0],), dtype=torch.int32, device=rois.device)
    else:
        sizes = [(-(-h // s), -(-w // s)) for s in STRIDES]
        maps = [torch.from_numpy(rng.randn(a, b, 256).astype(np.float32)).cuda().to(dtype) for a, b in sizes]
        pyr = ra.pack_pyramid(maps, [1.0 / s for s in STRIDES])
        levels = ra.assign_boxes_to_levels(rois, 2, 6)
    if sr > 0:
        grid = ra.fixed_grid(rois.shape[0], sr, rois.device)
    else:
        rh, rw = ra._scaled_extent(rois, pyr.meta, levels)
        grid = ra.split_grid(rh, rw, out_hw, bulk, 4, 16)
    return pyr, levels, grid, out_hw


def _row_contributions(meta, rois, levels, grid, out_hw, n_rows):
    """(n_rows,) how many taps of nonzero weight add into each packed row."""
    from glass_tpu_torch.ops.roi_align_rotated import plain_samples

    counts = torch.zeros(n_rows, dtype=torch.float32, device=rois.device)
    for idx, ws in plain_samples(meta, rois, levels, grid, out_hw):
        for i, w in zip(idx, ws):
            hit = i[w != 0]
            counts.index_add_(0, hit, torch.ones_like(hit, dtype=torch.float32))
    return counts


def _spacing(x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Spacing of ``dtype`` numbers at |x| (bf16: 8 significant bits; fp16:
    11, and never below its subnormal step 2^-24); 0 at 0."""
    _, e = torch.frexp(x.abs())
    step = torch.ldexp(torch.ones_like(x), e - 1 - ULP_BITS[dtype])
    if dtype == torch.float16:
        step = torch.clamp(step, min=2.0 ** -24)
    return torch.where(x == 0, torch.zeros_like(x), step)


def k1b_reference(meta, rois, levels, grid, out_hw, n_rows, grad_out):
    """K1b's plain f32 result, its per-element tolerance 2 n 2^-24 sum|w g|
    (n the row's contributions: the bound of two reordered f32 sums) and
    the contributions a row."""
    from glass_tpu_torch.ops import roi_align_rotated as ra

    ref = ra.roi_align_rotated_packed_backward_plain(grad_out, meta, rois, levels, grid, n_rows)
    mag = ra.roi_align_rotated_packed_backward_plain(grad_out.abs(), meta, rois, levels, grid, n_rows)
    counts = _row_contributions(meta, rois, levels, grid, out_hw, n_rows)
    return ref, 2.0 * counts[:, None] * 2.0 ** -24 * mag + 1e-30, counts


def k1b_excess(got, ref, tol) -> float:
    """How far K1b's output exceeds its bound (<= 0 passes): f32 within
    ``tol`` of the plain f32 result; bf16 or fp16 against that result
    rounded to the output's dtype, within ``tol`` plus one ulp of that dtype
    at the reference (two roundings of sums that differ may differ by one
    ulp)."""
    if got.dtype == torch.float32:
        return ((got - ref).abs() - tol).max().item()
    ref_b = ref.to(got.dtype).float()
    return ((got.float() - ref_b).abs() - tol - _spacing(ref.abs() + tol, got.dtype)).max().item()


def k1b_case(label, pyr, rois, levels, grid, out_hw, rng, timed=True, want_direct=False):
    """K1b against its plain version on one upstream gradient in the
    features' dtype, with an f32 output and, for bf16 features, a bf16
    output (``k1b_excess``).  Every tap must lie in its tile's footprint
    (stats[1] == 0)."""
    from glass_tpu_torch.ops import roi_align_rotated as ra

    dtype, c, n_rows = pyr.flat.dtype, pyr.flat.shape[1], pyr.flat.shape[0]
    grad_out = torch.from_numpy(rng.randn(rois.shape[0], *out_hw, c).astype(np.float32)).cuda().to(dtype)

    def launch(out_dtype=dtype, stats=False):
        return ra.roi_align_rotated_packed_backward(grad_out, pyr.meta, rois, levels, grid, n_rows,
                                                    out_dtype=out_dtype, return_stats=stats)

    got32, stats = launch(torch.float32, True)
    got = launch() if dtype != torch.float32 else got32
    ref, tol, counts = k1b_reference(pyr.meta, rois, levels, grid, out_hw, n_rows, grad_out)
    tile = ra.backward_tile(rois.shape[0], out_hw, torch.cuda.get_device_properties(0).multi_processor_count)
    plain_direct = ra.backward_direct_tiles(pyr.meta, rois, levels, grid, out_hw, tile)
    torch.cuda.synchronize()
    direct, escaped = stats.tolist()
    excess = max(k1b_excess(got32, ref, tol), k1b_excess(got, ref, tol)) if rois.shape[0] else 0.0
    err = max(_max_err(got32, ref), _max_err(got, ref.to(dtype)))
    rel_tol = float((tol.max()).item()) if rois.shape[0] else 0.0
    row = dict(pooler=label, dtype=str(dtype).split(".")[1], err=err, tol=rel_tol, rois=int(rois.shape[0]),
               direct=direct)
    text = (f"K1b {label:26s} {out_hw} {row['dtype']:8s} R={rois.shape[0]:3d} max|err| {err:.3g} "
            f"(per-element tol up to {rel_tol:.3g}; max contributions a row "
            f"{int(counts.max()) if rois.shape[0] else 0}); tiles of {tile[0]}x{tile[1]} bins, "
            f"{direct} on the direct path (plain count {plain_direct})")
    if timed and rois.shape[0]:
        rows_touched = touched_rows(pyr.meta, rois, levels, grid, out_hw)
        taps = int(counts.sum())
        g_bytes = grad_out.numel() * grad_out.element_size()
        old_ms, _ = bound(g_bytes + 2 * rows_touched * c * 4 + rois.numel() * 4, taps * c * 2)
        b_ms, b_by = bound(g_bytes + n_rows * c * got.element_size(), taps * c * 2)
        f32_ms = kernel_ms(lambda: launch(torch.float32))
        row.update(ms=kernel_ms(launch) if dtype != torch.float32 else f32_ms, f32_ms=f32_ms,
                   call_ms=time_ms(launch, 50),
                   plain_ms=time_ms(lambda: ra.roi_align_rotated_packed_backward_plain(
                       grad_out, pyr.meta, rois, levels, grid, n_rows), 3, 1),
                   bound_ms=b_ms, bound_by=b_by, old_bound_ms=old_ms, rows_touched=rows_touched, taps=taps)
        text += (f"; whole backward (out {row['dtype']}) {row['ms']:.4f} ms, f32 out {f32_ms:.4f} ms "
                 f"(wrapper call {row['call_ms']:.4f} ms) plain {row['plain_ms']:.3f} ms; dense-output "
                 f"bound {b_ms:.4f} ms ({b_by}: {n_rows}x{c} rows written), {100 * b_ms / row['ms']:.1f}% "
                 f"of it; old bound {old_ms:.4f} ms ({rows_touched} rows touched, {taps} taps), "
                 f"{100 * old_ms / row['ms']:.1f}% of it")
    log(text)
    if escaped:
        raise AssertionError(f"K1b {label} {dtype}: {escaped} taps fell outside their footprint")
    if want_direct and not direct:
        raise AssertionError(f"K1b {label} {dtype}: no tile took the direct path")
    if not excess <= 0.0:
        raise AssertionError(f"K1b {label} {dtype}: error exceeds the reordering bound by {excess}")
    return row


def phase_k1b(rng):
    """K1b (csrc/roi_align_rotated_backward.cu) against its plain version
    at the training shapes (an 832x1440 bucket, C = 256, the box, mask and
    recognizer poolers with 512, 128 and 8 rois) in f32 and bf16, K1's
    forward at the same shapes, then the edge cases: 0 and 1 roi, rois
    straddling the border (clamped taps), 512 rois on one pixel (every
    flush on the same rows; timed) and long rotated words on the
    recognizer's single level (tiles on the direct path), and FeatPadV2's
    widened word rois on that level, forward and backward."""
    from glass_tpu_torch.models.pooler_pad import feat_pad_v2_boxes

    h, w = TRAIN_BUCKET_HW
    fwd, bwd, edge = [], [], []
    for name, n in TRAIN_ROIS.items():
        rois = torch.from_numpy(word_rois(rng, n, h, w)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            pyr, levels, grid, out_hw = _train_pooler_inputs(name, rng, dtype, rois)
            fwd.append(k1_case(f"train {name}", pyr, rois, levels, grid, out_hw))
            bwd.append(k1b_case(f"train {name}", pyr, rois, levels, grid, out_hw, rng))
    erng = np.random.RandomState(2)
    border = np.stack([erng.uniform(-24, w + 24, 64), erng.uniform(-24, h + 24, 64),
                       erng.uniform(16, w * 0.6, 64), erng.uniform(12, h * 0.4, 64),
                       erng.uniform(-180, 180, 64)], 1).astype(np.float32)
    one_pixel = np.tile(np.array([[w / 2 + 0.3, h / 2 + 0.7, 2.0, 2.0, 0.0]], np.float32), (512, 1))
    long_words = np.array([[w / 2, h / 2, 3000.0, 900.0, 30.0],
                           [w / 2 + 100.0, h / 2 - 50.0, 2800.0, 800.0, -50.0]], np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        for name in ("box", "mask"):
            rois = torch.from_numpy(word_rois(erng, 8, h, w)).cuda()
            pyr, levels, grid, out_hw = _train_pooler_inputs(name, erng, dtype, rois)
            for n in (0, 1):
                edge.append(k1b_case(f"{name} R={n}", pyr, rois[:n], levels[:n], grid[:n], out_hw, erng,
                                     timed=False))
        for label, arr in (("box border-straddling", border), ("box one pixel x512", one_pixel)):
            rois = torch.from_numpy(arr).cuda()
            pyr, levels, grid, out_hw = _train_pooler_inputs("box", erng, dtype, rois)
            edge.append(k1b_case(label, pyr, rois, levels, grid, out_hw, erng, timed=arr is one_pixel))
        rois = torch.from_numpy(long_words).cuda()
        pyr, levels, grid, out_hw = _train_pooler_inputs("recognizer", erng, dtype, rois)
        edge.append(k1b_case("recognizer long words", pyr, rois, levels, grid, out_hw, erng, timed=False,
                             want_direct=True))
    # FeatPadV2: the recognizer pool takes word rois widened to its aspect
    # (up to 4x wider), drawn apart so the cases above keep their inputs
    frng = np.random.RandomState(3)
    rec_hw = next(p for p in POOLERS if p[0] == "recognizer")[1]
    for n in (TRAIN_ROIS["recognizer"], 64):
        rois = feat_pad_v2_boxes(torch.from_numpy(word_rois(frng, n, h, w)).cuda(), rec_hw)[0]
        for dtype in (torch.float32, torch.bfloat16):
            pyr, levels, grid, out_hw = _train_pooler_inputs("recognizer", frng, dtype, rois)
            fwd.append(k1_case(f"FeatPadV2 words R={n}", pyr, rois, levels, grid, out_hw, timed=False))
            edge.append(k1b_case(f"recognizer FeatPadV2 words R={n}", pyr, rois, levels, grid, out_hw, frng,
                                 timed=False))
    return fwd, bwd, edge


# ---------------------------------------------------------------------------
# phase 8: the training path
# ---------------------------------------------------------------------------

TRAIN_STEPS = 20       # ICDAR15 finetune config, IMS_PER_BATCH 1
TRAIN_STEPS_B4 = 3     # then IMS_PER_BATCH 4
OVERFIT_STEPS = 20     # one fixed batch, fixed draws
TRAIN_STAGES = ("glass.backbone", "glass.rpn_loss", "glass.rpn", "glass.box_head", "glass.recognizer",
                "glass.mask_head", "glass.backward", "glass.optimizer")
# SOLVER.BASE_LR for these short runs from random weights (the config's 0.01
# is for a pretrained trunk); the overfit loop uses it too
TRAIN_LR = "0.002"
# f32 step, card against CPU (PERF.md states them with their reasons):
STEP_LOSS_RTOL = 1e-3
STEP_HEAD_L2 = 1e-3
STEP_GRAD_L2 = 5e-2
STEP_BN_RTOL = 1e-3
HEADS = ("proposal_generator.", "roi_heads.box_predictor.", "roi_heads.mask_head.",
         "roi_heads.recognizer_head.decoder.")


class StepClock:
    """Wraps the trainer's ``train_step``: synchronizes after each step and
    keeps its wall time and its metrics as floats; ``after_step(i, model)``,
    when given, runs after step i."""

    def __init__(self, device, after_step=None):
        from glass_tpu_torch.train import trainer as trainer_mod

        self.mod, self.fn, self.device = trainer_mod, trainer_mod.train_step, device
        self.ms, self.metrics, self.after_step = [], [], after_step

    def __enter__(self):
        def timed(*a, **k):
            t0 = time.perf_counter()
            m = self.fn(*a, **k)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            self.metrics.append({key: float(v) for key, v in m.items()})
            if self.after_step is not None:
                self.after_step(len(self.metrics) - 1, a[0])
            return m

        self.mod.train_step = timed
        return self

    def __exit__(self, *exc):
        self.mod.train_step = self.fn


class RecordedDraws:
    """The priorities seam recording its draws (from a CPU generator) and
    replaying them in the same order, on any device."""

    def __init__(self, seed):
        self.generator = torch.Generator().manual_seed(seed)
        self.draws, self.replay = [], None

    def for_device(self, device, replay: bool):
        self.device, self.replay, self.pos = torch.device(device), replay, 0
        return self

    def uniform(self, site, image, shape):
        if not self.replay:
            self.draws.append(torch.rand(shape, generator=self.generator))
        u = self.draws[self.pos]
        self.pos += 1
        return u.to(self.device)


class RecordedProposals:
    """Records the card's training proposals and hands them to the CPU run,
    so the two steps sample the same rois (a near-tie of the RPN's scores
    may reorder the proposals of two devices, as phase 5 states)."""

    def __init__(self):
        from glass_tpu_torch.train import train_step as ts

        self.ts, self.fn, self.saved, self.replay, self.pos = ts, ts.select_proposals_single_image, [], False, 0

    def __enter__(self):
        def recorded(*a, **k):
            if self.replay:  # from the first recorded call again after ``pos = 0``
                out = self.saved[self.pos]
                self.pos += 1
                return tuple(v.to(a[0][0].device) for v in out)
            out = self.fn(*a, **k)
            self.saved.append(tuple(v.cpu() for v in out))
            return out

        self.ts.select_proposals_single_image = recorded
        return self

    def __exit__(self, *exc):
        self.ts.select_proposals_single_image = self.fn


def _span_kernels(prof, stages):
    """Per stage span: (device ms, kernel launches), every kernel attributed
    to the span whose host window holds the start of the op that launched
    it (on any thread: autograd runs the backward on its own)."""
    from torch.autograd import DeviceType

    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CPU and e.name in stages]
    out = {name: [0.0, 0] for name in stages}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        for name, t0, t1 in spans:
            if t0 <= e.time_range.start <= t1:
                out[name][0] += sum(k.duration for k in e.kernels) / 1e3
                out[name][1] += len(e.kernels)
                break
    return out


def profile_train_step(fn, out_dir):
    """torch.profiler over one training step: device busy share and each
    stage span's device time and launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    not_work = set(TRAIN_STAGES) | {"Activity Buffer Request"}
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA and e.name not in not_work]
    dev_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    per = _span_kernels(prof, TRAIN_STAGES)
    try:
        table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    except (AttributeError, KeyError):
        table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    lines = [f"  {n:17s} {c:6d} launches {ms:9.3f} ms device" for n, (ms, c) in per.items()]
    lines.append(f"  spans hold {sum(c for _, c in per.values())} of {len(dev)} device records and "
                 f"{sum(ms for ms, _ in per.values()):.3f} of {dev_ms:.3f} ms device time")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_train_step.txt"), "w") as f:
        f.write(table + "\n\nper stage span:\n" + "\n".join(lines) + "\n")
    log(f"train profile (one step, {wall_ms:.1f} ms wall, {card_line()}): device busy {dev_ms:.1f} ms "
        f"= {100 * dev_ms / wall_ms:.1f}% of wall, {len(dev)} device records")
    for line in lines:
        log(line)
    return wall_ms, dev_ms, per


def phase_train(out_dir, device="cuda", n_images=8, hw=(720, 1280), opts=(), steps=TRAIN_STEPS,
                steps_b4=TRAIN_STEPS_B4, overfit_steps=OVERFIT_STEPS, step_opts=()):
    """The training path through ``glass_tpu_torch.train.main`` and the
    checks of its step; see the module docstring."""
    device = torch.device(device)
    root = os.path.join(out_dir, "train")
    try:
        return _phase_train(root, device, n_images, hw, list(opts), steps, steps_b4, overfit_steps,
                            list(step_opts))
    finally:  # images and checkpoints are large; the logs stay
        import glob
        import shutil

        shutil.rmtree(os.path.join(root, "ds"), ignore_errors=True)
        for pth in glob.glob(os.path.join(root, "*", "*.pth")):
            os.remove(pth)


def _check_launches(launches, steps, images, what):
    want = {"roi_align_rotated": 3 * steps, "roi_align_rotated_backward": 3 * steps,
            "crop_rois": images * steps}
    got = {k: launches.get(k, 0) for k in want}
    log(f"train {what}: launches {got} over {steps} steps of {images} image(s) (want 3 K1, 3 K1b "
        f"a step, one K2 an image)")
    if got != want:
        raise AssertionError(f"train {what}: launches {got}, expected {want}")


def _phase_train(root, device, n_images, hw, opts, steps, steps_b4, overfit_steps, step_opts):
    from glass_tpu_torch import train as port_train
    from glass_tpu_torch.inference import GlassRunner
    from glass_tpu_torch.ops import _cuda
    from glass_tpu_torch.train.train_step import Priorities, batch_to_device, train_step

    card = card_line() if device.type == "cuda" else "CPU"
    ds_yaml = write_eval_set(root, n_images, hw, seed=3, name="synth_train", train=True)
    opts = ["TPU.COMPUTE_DTYPE", "bfloat16", "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0",
            "VIS_PERIOD", "0", "SOLVER.BASE_LR", TRAIN_LR, *opts]
    common = ["--config", ICDAR15, "--datasets", ds_yaml, "--device", str(device)]
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    # the CLI at IMS_PER_BATCH 1: the main path of this phase
    _cuda.LAUNCHES.clear()
    with StepClock(device) as clock:
        t0 = time.perf_counter()
        trainer = port_train.main(common + ["--output", os.path.join(root, "b1"), "--max-iter", str(steps), *opts])
        wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20 if cuda else 0.0
    if cuda:
        _check_launches(launches, steps, 1, "CLI at IMS_PER_BATCH 1")
    totals = [m["total_loss"] for m in clock.metrics]
    bad = [i for i, m in enumerate(clock.metrics) if not all(np.isfinite(v) for v in m.values())]
    ms = np.asarray(clock.ms[2:] or clock.ms)
    log(f"train CLI ({card}): {steps} steps at IMS_PER_BATCH 1 (bf16) in {wall:.1f} s; s/step median "
        f"{np.median(ms) / 1e3:.3f} (p90 {np.percentile(ms, 90) / 1e3:.3f}, first two {clock.ms[:2]} ms "
        f"excluded), {1e3 / np.median(ms):.2f} img/s; peak memory {peak:.0f} MiB; total loss per step "
        f"{[round(v, 3) for v in totals]}")
    if bad:
        raise AssertionError(f"train: non-finite losses at steps {bad}: {clock.metrics[bad[0]]}")
    log("train metrics at iteration 0: " + ", ".join(f"{k} {v:.4g}" for k, v in sorted(clock.metrics[0].items())))

    # the checkpoint: written, and the port's eval runner loads it
    ckpt_dir = os.path.join(root, "b1")
    with open(os.path.join(ckpt_dir, "last_checkpoint")) as f:
        pth = os.path.join(ckpt_dir, f.read().strip())
    runner = GlassRunner(model_path=pth, cfg=eval_cfg("bfloat16"), device=device)
    same = all(torch.equal(v.cpu(), trainer.model.state_dict()[k].cpu()) for k, v in runner.model.state_dict().items())
    image = synthetic_image(np.random.RandomState(5), *hw)
    preds = runner(image)
    log(f"train checkpoint {os.path.basename(pth)}: GlassRunner loads it (weights equal to the trainer's: "
        f"{same}) and returns {len(preds)} words on a {hw[0]}x{hw[1]} image")
    if not same:
        raise AssertionError("train: the checkpoint's weights differ from the trainer's")
    del runner

    # host syncs of one step and one profiled step, on a batch of the loader
    loader = iter(trainer.build_train_loader())
    host_batch = next(loader)
    batch = batch_to_device(host_batch, device)
    model, opt, tcfg = trainer.model, trainer.optimizer, trainer.tcfg

    def one_step(it=0):
        return train_step(model, opt, tcfg, batch, Priorities(0, it, device), it)

    one_step()
    syncs, where = count_syncs(one_step, device)
    log(f"train host syncs ({card}): {syncs} in one step; most from {where}")
    prof = profile_train_step(one_step, os.path.join(root, "profile")) if cuda else None

    # overfit one fixed batch with fixed draws
    fixed = []
    for _ in range(overfit_steps):
        m = one_step()
        fixed.append(float(m["total_loss"]))
    first, final = float(np.mean(fixed[:5])), float(np.mean(fixed[-5:]))
    last = {k: float(v) for k, v in m.items() if k.startswith("loss")}
    log(f"train overfit ({card}): {overfit_steps} steps on one batch at lr {TRAIN_LR}: total loss "
        f"{[round(v, 3) for v in fixed]}; mean of the first five {first:.4f}, of the last five {final:.4f}; "
        f"last step " + ", ".join(f"{k} {v:.3g}" for k, v in sorted(last.items())))
    if not (np.isfinite(fixed).all() and final < first):
        raise AssertionError(f"train: the loss did not fall on a fixed batch ({first} -> {final})")

    # IMS_PER_BATCH 4: BN over a batch, multi-image packing
    _cuda.LAUNCHES.clear()
    with StepClock(device) as clock4:
        port_train.main(common + ["--output", os.path.join(root, "b4"), "--max-iter", str(steps_b4),
                                  *opts, "SOLVER.IMS_PER_BATCH", "4"])
    launches4 = dict(_cuda.LAUNCHES)
    if cuda:
        _check_launches(launches4, steps_b4, 4, "CLI at IMS_PER_BATCH 4")
    ms4 = np.asarray(clock4.ms[1:] or clock4.ms)
    bad4 = [i for i, m in enumerate(clock4.metrics) if not all(np.isfinite(v) for v in m.values())]
    log(f"train CLI ({card}): {steps_b4} steps at IMS_PER_BATCH 4: s/step median {np.median(ms4) / 1e3:.3f} "
        f"(first excluded), {4e3 / np.median(ms4):.2f} img/s; total loss {[round(m['total_loss'], 3) for m in clock4.metrics]}")
    if bad4:
        raise AssertionError(f"train at IMS_PER_BATCH 4: non-finite losses at steps {bad4}")

    step = check_f32_step(ds_yaml, device, step_opts)
    return dict(launches=launches, median_s=float(np.median(ms)) / 1e3, peak_mib=peak, syncs=syncs,
                overfit=(first, final), b4_median_s=float(np.median(ms4)) / 1e3, profile=prof, step=step)


def check_f32_step(ds_yaml, device, step_opts):
    """One f32 training step on the card against the same step on the CPU
    (plain kernel versions): the same weights, the same batch, the same
    recorded draws and the card's proposals (``RecordedProposals``); no
    TF32.  Compares every loss, every parameter's gradient and the BN
    updates with the STEP_* tolerances.

    The weights are the trainer's seeded iteration-0 weights
    (``init_weights_``), where every head is far from saturation.  After
    the CLI's steps and the overfit loop the orientation head is saturated:
    its loss and gradient are then mostly the f32 rounding of ``1 - p``, and
    a relative tolerance on them measures that rounding, not the port."""
    from glass_tpu_torch.config import get_cfg, merge_from_dataset_config
    from glass_tpu_torch.data import DatasetManager
    from glass_tpu_torch.data.loader import build_train_loader
    from glass_tpu_torch.data.mapper import DatasetMapper
    from glass_tpu_torch.models import GlassArch, GlassRCNN
    from glass_tpu_torch.train.train_step import TrainConfig, batch_to_device, glass_train_forward
    from glass_tpu_torch.train.trainer import init_weights_

    cfg = get_cfg(ICDAR15)
    merge_from_dataset_config(cfg, ds_yaml)
    cfg.merge_from_list(["TPU.COMPUTE_DTYPE", "float32", "INPUT.MIN_SIZE_TRAIN", "(320, 320)",
                         "INPUT.MAX_SIZE_TRAIN", "576", "INPUT.ROTATION.ENABLED", "False", *step_opts])
    DatasetManager(cfg).register()
    records = DatasetManager.load(cfg.DATASETS.TRAIN[0])
    host = next(iter(build_train_loader(cfg, records, DatasetMapper(cfg, True, np.random.RandomState(0)), 1)))
    arch, tcfg = GlassArch.from_config(cfg), TrainConfig.from_config(cfg)
    state_dict = init_weights_(GlassRCNN(arch), max(int(cfg.SEED), 0)).state_dict()
    draws = RecordedDraws(11)
    out = []
    with RecordedProposals() as props:
        for n, dev in enumerate((device, torch.device("cpu"))):
            model = GlassRCNN(arch)
            model.load_state_dict(state_dict)
            model = model.to(dev).train()
            t0 = time.perf_counter()
            total, losses = glass_train_forward(model, tcfg, batch_to_device(host, dev),
                                                draws.for_device(dev, replay=n > 0))
            total.backward()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out.append(dict(
                losses={k: float(v.detach()) for k, v in losses.items()},
                grads={n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None},
                bn={k: v.detach().cpu() for k, v in model.state_dict().items() if "running_" in k},
                s=time.perf_counter() - t0))
            props.replay = True
    card, cpu = out
    failed, err = step_errors(card, cpu)
    log(f"train f32 step card vs CPU ({card_line() if device.type == 'cuda' else 'CPU'}): "
        f"image {tuple(host['images'].shape[1:3])}, "
        f"card {card['s']:.2f} s, CPU {cpu['s']:.2f} s; {err['text']} -> {'ok' if not failed else 'FAILED'}; "
        "CPU losses " + ", ".join(f"{k} {v:.4g}" for k, v in sorted(cpu["losses"].items()) if k.startswith("loss")))
    if failed:
        raise AssertionError(f"train f32 step: card and CPU differ: {failed}")
    return {k: v for k, v in err.items() if k != "text"}


def step_errors(card, cpu):
    """A training step on the card against the same step on the CPU (each
    a dict of losses, grads and bn): the failures at the STEP_*
    tolerances, and the errors."""
    failed = []
    loss_err = {k: abs(card["losses"][k] - v) / max(abs(v), 1e-6) for k, v in cpu["losses"].items()}
    worst_loss = max(loss_err, key=loss_err.get)
    if loss_err[worst_loss] > STEP_LOSS_RTOL:
        failed.append(f"loss {worst_loss} rel {loss_err[worst_loss]:.3g}")
    if set(card["grads"]) != set(cpu["grads"]):
        failed.append("gradient sets differ")
    errs = {}
    for n, g in cpu["grads"].items():
        want, got = g.numpy(), card["grads"][n].numpy()
        if np.abs(want).max() < 1e-6:
            errs[n] = (float(np.abs(got - want).max()), 1e-6)
        else:
            l2 = float(np.linalg.norm(got - want) / np.linalg.norm(want))
            errs[n] = (l2, STEP_HEAD_L2 if n.startswith(HEADS) else STEP_GRAD_L2)
    bad = {n: e for n, (e, tol) in errs.items() if e > tol}
    if bad:
        failed.append(f"{len(bad)} gradients beyond tolerance, e.g. {dict(list(bad.items())[:4])}")
    bn_err = max(float((card["bn"][k] - v).abs().max() / max(float(v.abs().max()), 1e-6)) for k, v in cpu["bn"].items())
    if bn_err > STEP_BN_RTOL:
        failed.append(f"BN updates rel {bn_err:.3g}")
    heads = max(e for n, (e, _) in errs.items() if n.startswith(HEADS))
    deep = sorted(errs.items(), key=lambda kv: -kv[1][0])[:3]
    text = (f"worst loss {worst_loss} rel {loss_err[worst_loss]:.3g} (tol {STEP_LOSS_RTOL}); {len(errs)} "
            f"gradients: heads max rel L2 {heads:.3g} (tol {STEP_HEAD_L2}), largest "
            f"{[(n, round(e, 5)) for n, (e, _) in deep]} (tol {STEP_GRAD_L2}); BN updates max rel "
            f"{bn_err:.3g} (tol {STEP_BN_RTOL})")
    return failed, dict(loss_rel=loss_err[worst_loss], head_l2=heads, worst_l2=deep[0][1][0], bn_rel=bn_err,
                        text=text)


# ---------------------------------------------------------------------------
# phase 9: the inference variants, the other shipped configs, the
# checkpoint formats
# ---------------------------------------------------------------------------

TEXTOCR = os.path.join("configs", "glass_finetune_textocr.yaml")
TOTALTEXT = os.path.join("configs", "glass_finetune_totaltext.yaml")
PRETRAIN = os.path.join("configs", "glass_pretrain.yaml")
N_TWO_STAGE = 8         # timed images per path (one-stage, two-stage), after one warm-up
N_COMPARED = 4          # images whose raw outputs two-stage and one-stage compare
N_BELOW_CAP = 4         # timed calls per path at each raised threshold
N_TTA_IMAGES = 1        # phase 6's scenes through eval --tta
PRETRAIN_STEPS = 3      # glass_pretrain.yaml at its IMS_PER_BATCH 8
REC, MASK = "roi_heads.recognizer_head.", "roi_heads.mask_head."
# caffe2 R-50 trunk: (blocks, bottleneck width, output width) per stage
C2_STAGES = {"res2": (3, 64, 256), "res3": (4, 128, 512), "res4": (6, 256, 1024), "res5": (3, 512, 2048)}


def caffe2_trunk(seed: int = 0) -> dict:
    """A synthetic caffe2 ImageNet R-50 trunk (``conv1_w``, ``res2_0_branch2a_w``,
    ``..._bn_s``, ``..._bn_b``), drawn as ``random_init_`` draws a model:
    He-scaled convolutions, BN scales near 1 (a quarter of that on the last
    BN of each residual branch), small biases."""
    rng = np.random.RandomState(seed)
    out = {}

    def put(key, shape):
        out[f"{key}_w"] = (rng.randn(*shape) * math.sqrt(2.0 / np.prod(shape[1:]))).astype(np.float32)
        scale = 0.25 if key.endswith("branch2c") else 1.0
        out[f"{key}_bn_s"] = (scale * (1.0 + 0.1 * rng.randn(shape[0]))).astype(np.float32)
        out[f"{key}_bn_b"] = (0.1 * rng.randn(shape[0])).astype(np.float32)

    put("res_conv1", (64, 3, 7, 7))
    out["conv1_w"] = out.pop("res_conv1_w")
    cin = 64
    for stage, (n, mid, cout) in C2_STAGES.items():
        for i in range(n):
            first = cin if i == 0 else cout
            put(f"{stage}_{i}_branch2a", (mid, first, 1, 1))
            put(f"{stage}_{i}_branch2b", (mid, mid, 3, 3))
            put(f"{stage}_{i}_branch2c", (cout, mid, 1, 1))
            if i == 0:
                put(f"{stage}_{i}_branch1", (cout, first, 1, 1))
        cin = cout
    return out


def legacy_layout(state_dict: dict) -> dict:
    """A port state dict in the legacy RecognizerROIHeadsV2 layout: the
    recognizer registered as the mask head, and so no conv mask head."""
    return {(MASK + k[len(REC):] if k.startswith(REC) else k): v
            for k, v in state_dict.items() if not k.startswith(MASK)}


def _launch_check(what, launches, want):
    got = {k: launches.get(k, 0) for k in want}
    log(f"variants {what}: launches {got} (want {want})")
    if got != want:
        raise AssertionError(f"variants {what}: launches {got}, expected {want}")


def phase_variants(state_dict, images, out_dir, device="cuda", opts=(), eval_hw=(720, 1280),
                   n_timed=N_TWO_STAGE, tta_opts=(), train_opts=(), steps=PRETRAIN_STEPS):
    """The inference variants on the card at full width, bf16, phase 4's
    weights: checkpoint formats, two-stage serving beside one-stage, TTA
    through the eval CLI, TextOCR and Total-Text serving (under the ICDAR15
    protocol overrides of ``eval_cfg``), and
    glass_pretrain.yaml's training from a caffe2 trunk.  ``opts``,
    ``tta_opts`` and ``train_opts`` cut the sizes for a CPU rehearsal."""
    device = torch.device(device)
    root = os.path.join(out_dir, "variants")
    os.makedirs(root, exist_ok=True)
    try:
        return _phase_variants(state_dict, images, root, device, list(opts), eval_hw, n_timed,
                               list(tta_opts), list(train_opts), steps)
    finally:  # images, weights and checkpoints are large; the logs stay
        import glob
        import shutil

        for d in glob.glob(os.path.join(root, "*", "ds")):
            shutil.rmtree(d, ignore_errors=True)
        for f in glob.glob(os.path.join(root, "**", "*.pth"), recursive=True) + [os.path.join(root, "R-50.pkl")]:
            if os.path.exists(f):
                os.remove(f)


def _phase_variants(state_dict, images, root, device, opts, eval_hw, n_timed, tta_opts, train_opts, steps):
    from glass_tpu_torch import eval as port_eval
    from glass_tpu_torch.inference import GlassRunner
    from glass_tpu_torch.inference import runner as runner_mod
    from glass_tpu_torch.inference import tta as tta_mod
    from glass_tpu_torch.ops import _cuda
    from glass_tpu_torch.postprocess import PostProcessorRotatedBoxes
    from glass_tpu_torch.train import cli as train_cli
    from glass_tpu_torch.train.trainer import Trainer

    cuda = device.type == "cuda"
    card = card_line() if cuda else "CPU"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    start = time.perf_counter()
    out = {}

    # 1. checkpoint formats: the legacy layout through the runner's loader
    legacy = os.path.join(root, "legacy.pth")
    torch.save(legacy_layout(state_dict), legacy)
    runner = GlassRunner(model_path=legacy, cfg=eval_cfg("bfloat16", opts=opts), device=device)
    got = runner.model.state_dict()
    held = [k for k in state_dict if not k.startswith(MASK)]
    differ = [k for k in held if not torch.equal(got[k].cpu(), state_dict[k])]
    rec = [k for k in held if k.startswith(REC)]
    log(f"variants legacy layout: GlassRunner(model_path=legacy.pth) holds {len(held) - len(differ)} of the "
        f"{len(held)} tensors the file holds bit for bit ({len(rec)} recognizer tensors, read from "
        f"{MASK}*); the {len(state_dict) - len(held)} conv mask head tensors are not in that layout")
    if differ or len(rec) != 43:
        raise AssertionError(f"legacy layout: {len(differ)} tensors differ, e.g. {differ[:4]}; {len(rec)} recognizer")
    del runner

    # 2. two-stage against one-stage on the ICDAR15 eval config: at the
    # config's thresholds, where a random model fills all D = 100 rows, then
    # at a raised ROI_HEADS.SCORE_THRESH_TEST per image, picked from its
    # one-stage scores, so that stage 2 runs on word buckets below D with
    # padding rows
    paths = {"one-stage": eval_cfg("bfloat16", opts=opts),
             "two-stage": eval_cfg("bfloat16", opts=[*opts, "TPU.TWO_STAGE_INFERENCE", "True"])}
    caps = collections.Counter()
    heads = runner_mod.glass_heads_stage

    def counted(model, feats, norm, pyr, boxes, *a, **k):
        caps[int(boxes.shape[0])] += 1
        return heads(model, feats, norm, pyr, boxes, *a, **k)

    def serve(name, cfg, served, n):
        """``n`` timed ``__call__`` of ``served`` in turn after one warm-up:
        medians of the call and of ``run_model``, each call's detection
        count and scores, stage 2's row counts; 3 K1 and 1 K2 launches a
        call."""
        runner = GlassRunner(cfg=cfg, state_dict=state_dict, device=device)
        run_model, model_ms, dets = runner.run_model, [], []

        def timed_run_model(image, rid=None):
            t0 = time.perf_counter()
            res = run_model(image, rid)
            model_ms.append((time.perf_counter() - t0) * 1e3)
            dets.append(res["scores"][res["valid"]])
            return res

        runner.run_model = timed_run_model
        runner(served[-1])  # warm-up
        model_ms.clear()
        dets.clear()
        caps.clear()
        sync()
        _cuda.LAUNCHES.clear()
        call_ms = []
        for i in range(n):
            t0 = time.perf_counter()
            runner(served[i % len(served)])
            sync()
            call_ms.append((time.perf_counter() - t0) * 1e3)
        launches = dict(_cuda.LAUNCHES)
        if cuda:
            _launch_check(name, launches, {"roi_align_rotated": 3 * n, "crop_rois": n})
        return dict(call_ms=float(np.median(call_ms)), call_p90=float(np.percentile(call_ms, 90)),
                    model_ms=float(np.median(model_ms)), dets=list(dets), caps=dict(sorted(caps.items())))

    timing, below = {}, []
    runner_mod.glass_heads_stage = counted
    try:
        for name, cfg in paths.items():
            r = timing[name] = serve(name, cfg, images, n_timed)
            log(f"variants {name} ({card}): {n_timed} images through __call__: median {r['call_ms']:.2f} ms "
                f"(p90 {r['call_p90']:.2f}), run_model median {r['model_ms']:.2f} ms"
                + (f"; stage-2 rows per image {r['caps']}" if name == "two-stage" else ""))
        # one image per word bucket b, about halfway between b and the one below
        d = paths["one-stage"].TEST.DETECTIONS_PER_IMAGE
        buckets = sorted(paths["two-stage"].TPU.WORD_BUCKETS)
        targets = [(lo + b + 1) // 2 for lo, b in zip([0] + buckets, buckets) if b < d]
        for image, scores, target in zip(images, timing["one-stage"]["dets"], targets):
            uniq = np.unique(scores)[::-1]
            k = max([j for j in range(1, len(uniq)) if (scores >= uniq[j - 1]).sum() <= target], default=1)
            thresh = f"{(float(uniq[k - 1]) + float(uniq[k])) / 2:.9g}"
            raised = {name: cfg.clone() for name, cfg in paths.items()}
            for cfg in raised.values():
                cfg.merge_from_list(["MODEL.ROI_HEADS.SCORE_THRESH_TEST", thresh])
            r = {name: serve(f"{name} at SCORE_THRESH_TEST {thresh}", cfg, [image], N_BELOW_CAP)
                 for name, cfg in raised.items()}
            n = len(r["two-stage"]["dets"][0])
            below.append(dict(thresh=float(thresh), n=n, caps=r["two-stage"]["caps"],
                              model_ms={name: v["model_ms"] for name, v in r.items()},
                              call_ms={name: v["call_ms"] for name, v in r.items()},
                              compared=compare_two_stage(raised, state_dict, [image], device)))
            log(f"variants two-stage below the cap ({card}): SCORE_THRESH_TEST {thresh}, {n} detections, "
                f"stage-2 rows {r['two-stage']['caps']} over {N_BELOW_CAP} calls; run_model median "
                f"{r['two-stage']['model_ms']:.2f} ms (one-stage {r['one-stage']['model_ms']:.2f}), __call__ "
                f"median {r['two-stage']['call_ms']:.2f} ms (one-stage {r['one-stage']['call_ms']:.2f})")
    finally:
        runner_mod.glass_heads_stage = heads
    padded = sorted({c for b in below for c in b["caps"] if b["n"] < c < d})
    log(f"variants two-stage: word buckets run below D = {d} with padding rows: {padded}")
    if len(padded) < 2:
        raise AssertionError(f"two-stage: stage 2 ran with padding rows at {padded}, want two buckets below {d}")
    out["timing"] = {name: (r["call_ms"], r["model_ms"]) for name, r in timing.items()}
    out["caps"] = timing["two-stage"]["caps"]
    out["below_cap"] = below
    out["two_stage"] = compare_two_stage(paths, state_dict, images[:N_COMPARED], device)

    # 3. TTA through the eval CLI on phase 6's scenes
    tta_root = os.path.join(root, "tta")
    ds_yaml = write_eval_set(tta_root, N_TTA_IMAGES, eval_hw)
    pth = os.path.join(root, "model.pth")
    torch.save(state_dict, pth)
    common = ["--config", ICDAR15, "--datasets", ds_yaml, "--model", pth, "--device", str(device), "--tta"]
    cli_opts = ["TPU.COMPUTE_DTYPE", "bfloat16", *LOOSE_OPTS, *opts, *tta_opts]
    cfg = port_eval.setup(port_eval.parse_args(common + ["--output", os.path.join(tta_root, "cfg"), *cli_opts]))
    n_views = len(cfg.TEST.AUG.MIN_SIZES) * (2 if cfg.TEST.AUG.FLIP else 1)
    probe = GlassRunner(cfg=cfg, state_dict=state_dict, device=device)
    h, w = eval_hw
    views = []
    for short in cfg.TEST.AUG.MIN_SIZES:
        scale = min(short / min(h, w), cfg.TEST.AUG.MAX_SIZE / max(h, w))
        views.append(probe._pick_bucket(int(h * scale + 0.5), int(w * scale + 0.5)))
    del probe
    port_eval.main(common + ["--output", os.path.join(tta_root, "warmup"), "--max-images", "1", *cli_opts])
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _cuda.LAUNCHES.clear()
    spans = ((GlassRunner, "run_on_resized", "views (model, fetch)"), (tta_mod, "nms_rotated_np", "merge (host NMS)"),
             (GlassRunner, "forward_with_given_boxes", "heads on the merged boxes"),
             (PostProcessorRotatedBoxes, "__call__", "post-processing"))
    merged, given = [], GlassRunner.forward_with_given_boxes

    def counted_given(self, image, instances):
        merged.append(len(instances))
        return given(self, image, instances)

    GlassRunner.forward_with_given_boxes = counted_given
    try:
        with StageClock(spans) as clock:
            t0 = time.perf_counter()
            res = port_eval.main(common + ["--output", os.path.join(tta_root, "run"), *cli_opts])["synth_test"]
            sync()
            tta_s = (time.perf_counter() - t0) / N_TTA_IMAGES
    finally:
        GlassRunner.forward_with_given_boxes = given
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20 if cuda else 0.0
    prh = "; ".join(f"{k.split('_')[0].lower()} P {v['precision']:.4f} R {v['recall']:.4f} H {v['hmean']:.4f}"
                    for k, v in res.items())
    log(f"variants TTA ({card}): eval --tta on {N_TTA_IMAGES} scenes of {h}x{w}, {n_views} views an image "
        f"(short sides {list(cfg.TEST.AUG.MIN_SIZES)}, max {cfg.TEST.AUG.MAX_SIZE}, flip {cfg.TEST.AUG.FLIP}): "
        f"{tta_s:.3f} s/image (CLI loop, image reads included); merged boxes through the given-boxes pass "
        f"{merged} (of DETECTIONS_PER_IMAGE {cfg.TEST.DETECTIONS_PER_IMAGE}); largest view's bucket "
        f"{max(views, key=lambda b: b[0] * b[1])}; peak memory {peak:.0f} MiB; {prh}")
    log("variants TTA split, s/image: " + ", ".join(f"{k} {v / 1e3 / N_TTA_IMAGES:.3f}" for k, v in clock.ms.items())
        + f"; the rest (reads, evaluator) {tta_s - sum(clock.ms.values()) / 1e3 / N_TTA_IMAGES:.3f}")
    if cuda:
        _launch_check("TTA", launches, {"roi_align_rotated": (3 * n_views + 2) * N_TTA_IMAGES,
                                        "crop_rois": (n_views + 1) * N_TTA_IMAGES})
    out["tta"] = dict(s_per_image=tta_s, peak_mib=peak, results=res, views=views, merged=merged)

    # 4. the other shipped configs: TextOCR and Total-Text serving
    image = images[0]
    for config in (TEXTOCR, TOTALTEXT):
        runner = GlassRunner(model_path=pth, cfg=eval_cfg("bfloat16", config=config, opts=[*LOOSE_OPTS, *opts]),
                             device=device)
        runner(image)  # warm-up
        sync()
        _cuda.LAUNCHES.clear()
        raw = runner.run_model(image.astype(np.float32))
        launches = dict(_cuda.LAUNCHES)
        finite = all(np.isfinite(np.asarray(v, np.float32)).all() for v in raw.values())
        preds = runner(image)
        log(f"variants {os.path.basename(config)} under the ICDAR15 eval protocol overrides ({card}): "
            f"{int(raw['valid'].sum())} raw detections, "
            f"{len(preds)} words after post-processing; outputs finite {finite}; orientation head "
            f"{runner.arch.orientation_on}")
        if cuda:
            _launch_check(os.path.basename(config), launches, {"roi_align_rotated": 3, "crop_rois": 1})
        if not finite or not np.isfinite(np.asarray(preds.pred_boxes)).all():
            raise AssertionError(f"{config}: non-finite outputs")
        del runner

    # 5. glass_pretrain.yaml from a caffe2 trunk, at its IMS_PER_BATCH 8
    train_root = os.path.join(root, "pretrain")
    pkl = os.path.join(root, "R-50.pkl")
    trunk = caffe2_trunk()
    with open(pkl, "wb") as f:
        pickle.dump(trunk, f)
    ds_yaml = write_eval_set(train_root, 8, eval_hw, seed=3, name="synth_train", train=True)
    args = train_cli.parse_args([
        "--config", PRETRAIN, "--datasets", ds_yaml, "--output", os.path.join(train_root, "out"),
        "--weights", pkl, "--max-iter", str(steps), "--device", str(device),
        "TPU.COMPUTE_DTYPE", "bfloat16", "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0",
        "VIS_PERIOD", "0", "SOLVER.BASE_LR", TRAIN_LR, *train_opts])
    cfg = train_cli.setup(args)
    trainer = Trainer(cfg, device=device)  # loads MODEL.WEIGHTS = --weights
    sd = trainer.model.state_dict()
    want = {"backbone.bottom_up.stem.conv1": "res_conv1"}
    for stage, (n, _, _) in C2_STAGES.items():
        for i in range(n):
            for c2, ours in (("branch2a", "conv1"), ("branch2b", "conv2"), ("branch2c", "conv3"), ("branch1", "shortcut")):
                if f"{stage}_{i}_{c2}_w" in trunk:
                    want[f"backbone.bottom_up.{stage}.{i}.{ours}"] = f"{stage}_{i}_{c2}"
    trunk["res_conv1_w"] = trunk["conv1_w"]
    unset = []
    for ours, c2 in want.items():
        c = len(trunk[f"{c2}_bn_s"])
        for suffix, ref in ((".weight", trunk[f"{c2}_w"]), (".norm.weight", trunk[f"{c2}_bn_s"]),
                            (".norm.bias", trunk[f"{c2}_bn_b"]), (".norm.running_mean", np.zeros(c, np.float32)),
                            (".norm.running_var", np.ones(c, np.float32))):
            if not np.array_equal(sd[ours + suffix].cpu().numpy(), ref):
                unset.append(ours + suffix)
    log(f"variants pretrain: --weights R-50.pkl (synthetic caffe2 trunk) set {5 * len(want) - len(unset)} of "
        f"the {5 * len(want)} trunk tensors it holds")
    if unset:
        raise AssertionError(f"pretrain: trunk tensors not loaded from the .pkl: {unset[:5]}")
    trainer.resume_or_load(resume=False)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _cuda.LAUNCHES.clear()
    with StepClock(device) as clock:
        trainer.train(max_iter=steps)
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20 if cuda else 0.0
    ims = int(cfg.SOLVER.IMS_PER_BATCH)
    if cuda:
        _check_launches(launches, steps, ims, f"pretrain at IMS_PER_BATCH {ims}")
    ms = np.asarray(clock.ms[1:] or clock.ms)
    bad = [i for i, m in enumerate(clock.metrics) if not all(np.isfinite(v) for v in m.values())]
    log(f"variants pretrain ({card}): {steps} steps of glass_pretrain.yaml at IMS_PER_BATCH {ims} (bf16, "
        f"recognizer MAX_BATCH_SIZE {cfg.MODEL.ROI_RECOGNIZER_HEAD.MAX_BATCH_SIZE}): s/step median "
        f"{np.median(ms) / 1e3:.3f} (first excluded; all {[round(t / 1e3, 3) for t in clock.ms]}), "
        f"{ims * 1e3 / np.median(ms):.2f} img/s; peak memory {peak:.0f} MiB; total loss "
        f"{[round(m['total_loss'], 3) for m in clock.metrics]}")
    if bad or len(clock.metrics) != steps:
        raise AssertionError(f"pretrain: non-finite losses at steps {bad}")
    out["pretrain"] = dict(median_s=float(np.median(ms)) / 1e3, peak_mib=peak)
    log(f"phase 9: {time.perf_counter() - start:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 10: the model-family variants
# ---------------------------------------------------------------------------

_RH = "MODEL.ROI_RECOGNIZER_HEAD."
CTC_OPTS = [_RH + "RECOGNIZER_HEAD.DECODER.NAME", "CTC", _RH + "LABELS_TYPE", "ctc"]
FEATPAD_OPTS = [_RH + "RECOGNIZER_HEAD.POOLER_PAD.NAME", "FeatPadV2"]
# each option that changes the serving model
MODEL_VARIANTS = {
    "FeatPadV2": FEATPAD_OPTS,
    "channel_mul": ["MODEL.HYBRID_FUSION.FUSION_TYPE", "channel_mul"],
    "channel_concat": ["MODEL.HYBRID_FUSION.FUSION_TYPE", "channel_concat"],
    "SimpleAttention": ["MODEL.HYBRID_FUSION.NAME", "SimpleAttention"],
    "LocalOnly": ["MODEL.HYBRID_FUSION.NAME", "LocalOnly"],
    "Conv1x1": ["MODEL.HYBRID_FUSION.NAME", "Conv1x1"],
    "CNN_V2": [_RH + "RECOGNIZER_HEAD.BACKBONE.NAME", "CNN_V2"],
    "CTC": CTC_OPTS,
}
N_VARIANT_IMAGES = 1      # timed __call__ per option, after one warm-up
VARIANT_TRAIN_STEPS = 5   # CTC and FeatPadV2 training, IMS_PER_BATCH 1
BEAM_WIDTH = 5
BEAM_SCORE_ATOL = 1e-3    # best-beam log-probability, card against CPU (f32)


def variant_weights(state_dict, cfg) -> dict:
    """Phase 4's weights for an option's model: every tensor whose name and
    shape it shares, the option's own (a fusion module's, CNN_V2's conv3,
    the CTC head: all in the fusion module or the recognizer head) from
    ``random_init_`` at seed 1."""
    from glass_tpu_torch.inference.runner import random_init_
    from glass_tpu_torch.models import GlassArch, GlassRCNN

    model = GlassRCNN(GlassArch.from_config(cfg))
    random_init_(model.roi_heads.fusion_net, seed=1)
    random_init_(model.roi_heads.recognizer_head, seed=1)
    own = model.state_dict()
    return {k: (state_dict[k] if k in state_dict and state_dict[k].shape == v.shape else v).clone()
            for k, v in own.items()}


class DirectTiles:
    """Sums, per pooler output size, the bin tiles that K1b sent to its
    direct path (the kernel's stats, added up on the device and read once
    at the end); the launch and its count are the wrapper's own."""

    def __enter__(self):
        from glass_tpu_torch.ops import roi_align_rotated as ra

        self.ra, self.fn, self.sums = ra, ra.roi_align_rotated_packed_backward, {}

        def counted(grad_out, *a, **k):
            grad, stats = self.fn(grad_out, *a, return_stats=True, **k)
            key = "x".join(str(int(s)) for s in grad_out.shape[1:3])
            self.sums[key] = self.sums.get(key, 0) + stats[0]
            return grad

        ra.roi_align_rotated_packed_backward = counted
        return self

    def __exit__(self, *exc):
        self.ra.roi_align_rotated_packed_backward = self.fn

    def counts(self) -> dict:
        return {k: int(v) for k, v in self.sums.items()}


def beam_rescore(unit, x, tokens):
    """Each row's total log-probability of ``tokens`` under the decoder, as
    ``aster_decode_beam`` scores a beam: teacher-forced, the steps after the
    first ``eos`` adding nothing."""
    from glass_tpu_torch.models.beam_search import EOS_INDEX
    from glass_tpu_torch.models.recognizer import aster_decode_train

    tokens = tokens.long()
    targets = torch.cat([torch.zeros_like(tokens[:, :1]), tokens], dim=1)
    logits = aster_decode_train(unit, x, targets, tokens.shape[1])
    logp = torch.log_softmax(logits.float(), dim=-1).gather(-1, tokens[..., None])[..., 0]
    eos = (tokens == EOS_INDEX).int()
    after = (torch.cumsum(eos, dim=1) - eos) > 0
    return torch.where(after, torch.zeros_like(logp), logp).sum(dim=1)


def phase_model_variants(state_dict, images, out_dir, device="cuda", opts=(), train_opts=(),
                         steps=VARIANT_TRAIN_STEPS, hw=(720, 1280)):
    """The model-family variants on the card at full width, bf16, phase 4's
    weights (each option's own tensors seeded): each option that changes the
    serving model through ``GlassRunner.__call__``; each option's recognizer
    in f32 on the card against the CPU from the same features and
    detections; CTC and FeatPadV2 training through
    ``glass_tpu_torch.train.main``; ``aster_decode_beam`` on the card against
    the CPU.  ``opts``, ``train_opts`` and ``hw`` cut the sizes for a CPU
    rehearsal."""
    device = torch.device(device)
    root = os.path.join(out_dir, "model_variants")
    os.makedirs(root, exist_ok=True)
    try:
        return _phase_model_variants(state_dict, images, root, device, list(opts), list(train_opts),
                                     steps, hw)
    finally:  # images and checkpoints are large; the logs stay
        import glob
        import shutil

        shutil.rmtree(os.path.join(root, "ds"), ignore_errors=True)
        for f in glob.glob(os.path.join(root, "**", "*.pth"), recursive=True):
            os.remove(f)


def _variant_recognizer_check(name, cfg32, weights, base, device):
    """One option's recognizer in f32 on the card and on the CPU from the
    card's features and detections (``base``): text probabilities and ids
    on every step before a knife edge (ASTER feeds a step's choice to the
    rest of its row; CTC's steps are independent), at phase 5's tolerances."""
    from glass_tpu_torch.models import GlassArch, GlassRCNN
    from glass_tpu_torch.models import glass_rcnn as gr

    cpu_model = GlassRCNN(GlassArch.from_config(cfg32)).eval()
    cpu_model.load_state_dict(weights)
    models = [copy.deepcopy(cpu_model).to(device), cpu_model]
    arch = cpu_model.arch
    feats, norm, boxes = base
    with torch.inference_mode():
        probs = gr.recognize_single_image(models[0], feats, norm, boxes).cpu().numpy()
        cprobs = gr.recognize_single_image(models[1], {k: v.cpu() for k, v in feats.items()}, norm.cpu(),
                                           boxes.cpu()).numpy()
    top2 = np.sort(cprobs, -1)[..., -2:]
    edge = top2[..., 1] - top2[..., 0] < KNIFE_EDGE
    steps = ~edge if arch.recognizer_decoder == "CTC" else ~np.cumsum(edge, axis=1).astype(bool)
    perr = float(np.abs(probs - cprobs)[steps].max())
    same = bool((probs.argmax(-1)[steps] == cprobs.argmax(-1)[steps]).all())
    ok = perr <= PROB_ATOL and same
    log(f"variants {name} recognizer card vs CPU (f32, {probs.shape}): max|card-CPU| {perr:.3g} over "
        f"{int(steps.sum())} of {steps.size} steps before a knife edge (tol {PROB_ATOL}); ids equal {same} "
        f"-> {'ok' if ok else 'FAILED'}")
    return ok, perr


def _phase_model_variants(state_dict, images, root, device, opts, train_opts, steps, hw):
    from glass_tpu_torch import train as port_train
    from glass_tpu_torch.inference import GlassRunner
    from glass_tpu_torch.models import glass_rcnn as gr
    from glass_tpu_torch.models.beam_search import aster_decode_beam
    from glass_tpu_torch.ops import _cuda

    cuda = device.type == "cuda"
    card = card_line() if cuda else "CPU"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    start = time.perf_counter()
    launches = collections.Counter()
    failed, out = [], {"serving": {}, "train": {}}

    # the f32 features and detections every option's recognizer check starts
    # from (the options change the recognizer alone), and the beam's input
    base_runner = GlassRunner(cfg=eval_cfg("float32", opts=opts), state_dict=state_dict, device=device)
    bm = base_runner.model
    image = images[0]
    h, w = image.shape[:2]
    bh, bw = base_runner._pick_bucket(h, w)
    padded = np.zeros((bh, bw, 3), np.float32)
    padded[:h, :w] = image
    with torch.inference_mode():
        norm = gr.preprocess(bm, torch.from_numpy(padded).to(device))
        feats = gr.backbone_features(bm, norm)
        det = gr.detect_single_image(bm, feats, gr.pack_box_pyramid(bm, feats), (h, w))
        enc = gr.recognizer_encode(bm, feats, norm, det.boxes).float()
    base = (feats, norm, det.boxes)

    # 1. serving, per option
    for name, vopts in MODEL_VARIANTS.items():
        cfg = eval_cfg("bfloat16", opts=[*opts, *vopts])
        weights = variant_weights(state_dict, cfg)
        runner = GlassRunner(cfg=cfg, state_dict=weights, device=device)
        run_model, model_ms, raws = runner.run_model, [], []

        def timed_run_model(img, rid=None, run_model=run_model, model_ms=model_ms, raws=raws):
            t0 = time.perf_counter()
            res = run_model(img, rid)
            model_ms.append((time.perf_counter() - t0) * 1e3)
            raws.append(res)
            return res

        runner.run_model = timed_run_model
        sync()
        _cuda.LAUNCHES.clear()
        runner(images[-1])  # warm-up
        sync()
        model_ms.clear()
        raws.clear()
        call_ms, preds = [], []
        for img in images[:N_VARIANT_IMAGES]:
            t0 = time.perf_counter()
            preds.append(runner(img))
            sync()
            call_ms.append((time.perf_counter() - t0) * 1e3)
        got = dict(_cuda.LAUNCHES)
        launches.update(got)
        n = N_VARIANT_IMAGES + 1
        if cuda:
            _launch_check(f"{name} serving", got, {"roi_align_rotated": 3 * n, "crop_rois": n})
        finite = all(np.isfinite(np.asarray(v, np.float32)).all() for r in raws for v in r.values()) and all(
            np.isfinite(np.asarray(p.pred_boxes)).all() for p in preds)
        texts = runner.decode_texts(preds[0])[0] if len(preds[0]) else []
        log(f"variants {name} ({card}): {N_VARIANT_IMAGES} images through __call__ (bf16, one warm-up): "
            f"__call__ median {np.median(call_ms):.2f} ms, run_model median {np.median(model_ms):.2f} ms; "
            f"text fields {[tuple(v.shape) for k, v in raws[0].items() if k.startswith('text')]}; "
            f"{int(raws[0]['valid'].sum())} raw detections, {len(preds[0])} words; texts {texts[:4]}; "
            f"outputs finite {finite}")
        if not finite:
            failed.append(f"{name} serving: non-finite outputs")
        ok, perr = _variant_recognizer_check(name, eval_cfg("float32", opts=[*opts, *vopts]), weights, base,
                                             device)
        if not ok:
            failed.append(f"{name} recognizer card vs CPU")
        out["serving"][name] = dict(call_ms=float(np.median(call_ms)), model_ms=float(np.median(model_ms)),
                                    card_vs_cpu=perr)
        del runner
    log(f"variants serving and recognizer checks: {time.perf_counter() - start:.1f} s")

    # 2. beam search over the f32 encoder states of phase 4's model
    unit = bm.roi_heads.recognizer_head.aster
    cpu_unit = GlassRunner(cfg=eval_cfg("float32", opts=opts), state_dict=state_dict,
                           device="cpu").model.roi_heads.recognizer_head.aster
    num_steps = bm.arch.max_word_len + 1
    with torch.inference_mode():
        t0 = time.perf_counter()
        tok, score = aster_decode_beam(unit, enc, num_steps, BEAM_WIDTH)
        sync()
        beam_ms = (time.perf_counter() - t0) * 1e3
        ctok, cscore = aster_decode_beam(cpu_unit, enc.cpu(), num_steps, BEAM_WIDTH)
        rescored = beam_rescore(cpu_unit, enc.cpu(), tok.cpu())
    tok, score = tok.cpu(), score.cpu()
    same_rows = int((tok == ctok).all(dim=1).sum())
    d_score = float((score - cscore).abs().max())
    d_best = float((rescored - cscore).abs().max())
    ok = d_score <= BEAM_SCORE_ATOL and d_best <= BEAM_SCORE_ATOL
    log(f"variants beam search ({card}): aster_decode_beam width {BEAM_WIDTH}, {num_steps} steps over "
        f"{tuple(enc.shape)} encoder states (f32) in {beam_ms:.1f} ms; tokens equal on {same_rows} of "
        f"{len(tok)} rows; max|card - CPU| best score {d_score:.3g}; the card's beams rescored on the CPU lie "
        f"{d_best:.3g} from the CPU's best (tol {BEAM_SCORE_ATOL}) -> {'ok' if ok else 'FAILED'}")
    if not ok:
        failed.append("beam search card vs CPU")
    out["beam"] = dict(ms=beam_ms, same_rows=same_rows, rows=len(tok), d_score=d_score, d_best=d_best)
    del base_runner, bm, feats, norm, det, enc, base

    # 3. CTC and FeatPadV2 training through the CLI at IMS_PER_BATCH 1
    ds_yaml = write_eval_set(root, 4, hw, seed=4, name="synth_train", train=True)
    common = ["--config", ICDAR15, "--datasets", ds_yaml, "--device", str(device)]
    topts = ["TPU.COMPUTE_DTYPE", "bfloat16", "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0",
             "VIS_PERIOD", "0", "SOLVER.BASE_LR", TRAIN_LR, *train_opts]
    for name in ("CTC", "FeatPadV2"):
        if cuda:
            sync()
            torch.cuda.reset_peak_memory_stats()
        _cuda.LAUNCHES.clear()
        with StepClock(device) as clock, DirectTiles() as direct:
            port_train.main(common + ["--output", os.path.join(root, name), "--max-iter", str(steps), *topts,
                                      *MODEL_VARIANTS[name]])
        got = dict(_cuda.LAUNCHES)
        launches.update(got)
        if cuda:
            _check_launches(got, steps, 1, f"{name} training")
        peak = torch.cuda.max_memory_allocated() / 2**20 if cuda else 0.0
        ms = np.asarray(clock.ms[2:] or clock.ms)
        bad = [i for i, m in enumerate(clock.metrics) if not all(np.isfinite(v) for v in m.values())]
        tiles = direct.counts()
        log(f"variants {name} training ({card}): {steps} steps at IMS_PER_BATCH 1 (bf16): s/step median "
            f"{np.median(ms) / 1e3:.3f} (first two excluded; all {[round(t / 1e3, 3) for t in clock.ms]}); peak "
            f"memory {peak:.0f} MiB; loss_decoder {[round(m['loss_decoder'], 3) for m in clock.metrics]}; total "
            f"{[round(m['total_loss'], 3) for m in clock.metrics]}; K1b direct-path tiles over the run by pooler "
            f"{tiles} (K1b's stats read once at the end)")
        if bad or len(clock.metrics) != steps:
            failed.append(f"{name} training: non-finite losses at steps {bad}")
        out["train"][name] = dict(median_s=float(np.median(ms)) / 1e3, peak_mib=peak, direct=tiles)
    out["launches"] = dict(launches)
    log(f"phase 10: {time.perf_counter() - start:.1f} s; launches {dict(launches)}")
    if failed:
        raise AssertionError(f"phase 10 failed: {failed}")
    return out


def served(runner, image):
    """``run_model``'s raw output for the resized image ``runner(image)``
    serves."""
    got, run = [], runner.run_model
    runner.run_model = lambda resized, rid=None: got.append(run(resized, rid)) or got[-1]
    try:
        runner(image)
    finally:
        del runner.run_model
    return got[0]


def compare_two_stage(paths, state_dict, images, device):
    """Raw outputs of two-stage against one-stage serving, the full
    character distributions fetched (TPU.TEXT_EMIT probs): detections
    equal; text ids equal on every step up to each row's end-of-word before
    a knife-edge step (a top-two margin under three times the largest
    probability difference on agreeing steps, and at least 1e-4, as
    tests/test_torch_slice.py's rule); masks within one step of their fetch
    dtype."""
    from glass_tpu_torch.inference import GlassRunner

    runners = {}
    for name, cfg in paths.items():
        cfg = cfg.clone()
        cfg.merge_from_list(["TPU.TEXT_EMIT", "probs"])
        runners[name] = GlassRunner(cfg=cfg, state_dict=state_dict, device=device)
    fetch = runners["one-stage"].arch.mask_fetch_dtype
    mask_step = 1.0 / 255 if fetch == "uint8" else (2.0 ** -11 if fetch == "float16" else 2.0 ** -24)
    det_same, worst_box, worst_score, pairs = True, 0.0, 0.0, []
    for image in images:
        one, two = served(runners["one-stage"], image), served(runners["two-stage"], image)
        same = all(np.array_equal(one[k], two[k]) for k in ("valid", "boxes", "scores", "classes", "orientations"))
        det_same &= same
        if np.array_equal(one["valid"], two["valid"]):
            v = one["valid"]
            worst_box = max(worst_box, float(_box_dist(one["boxes"][v], two["boxes"][v]).max(initial=0.0)))
            worst_score = max(worst_score, float(np.abs(one["scores"][v] - two["scores"][v]).max(initial=0.0)))
        else:
            raise AssertionError("two-stage: the valid detections differ from one-stage")
        pairs.append((one, two))
    if not det_same:
        log(f"variants two-stage vs one-stage: stage 1 is not bit-equal (cuDNN's algorithm choice); held to "
            f"phase 5's bounds: boxes {worst_box:.3g} (tol {BOX_ATOL} px), scores {worst_score:.3g} (tol {SCORE_ATOL})")
        if worst_box > BOX_ATOL or worst_score > SCORE_ATOL:
            raise AssertionError("two-stage: stage 1 differs from one-stage beyond phase 5's bounds")
    gp = np.concatenate([t["text_probs"][o["valid"]] for o, t in pairs])
    wp = np.concatenate([o["text_probs"][o["valid"]] for o, t in pairs])
    ids = wp.argmax(-1)
    upto_eos = np.cumsum(ids == 0, axis=1) - (ids == 0) == 0
    agree = gp.argmax(-1) == ids
    prob_diff = float(np.abs(gp - wp).max(-1)[upto_eos & agree].max(initial=0.0))
    knife = max(KNIFE_EDGE, 3 * prob_diff)
    top2 = np.sort(wp, -1)[..., -2:]
    before = ~np.cumsum(top2[..., 1] - top2[..., 0] < knife, axis=1).astype(bool)
    held = upto_eos & before
    flips = int((~agree & held).sum())
    mask_diff = max(float(np.abs(o["mask_probs"][o["valid"]].astype(np.float32)
                                 - t["mask_probs"][o["valid"]].astype(np.float32)).max(initial=0.0))
                    for o, t in pairs)
    log(f"variants two-stage vs one-stage ({len(images)} images, {len(gp)} words): detections bit-equal {det_same}; "
        f"text ids differ on {flips} of {int(held.sum())} steps held (up to the end of word, before a knife edge "
        f"under {knife:.3g}; {int((upto_eos & ~before).sum())} steps past one; largest probability difference on "
        f"agreeing steps {prob_diff:.3g}); mask probabilities max diff {mask_diff:.3g} (one {fetch} step "
        f"{mask_step:.3g})")
    if flips or mask_diff > mask_step:
        raise AssertionError(f"two-stage differs from one-stage: {flips} text steps, mask diff {mask_diff}")
    return dict(det_same=det_same, flips=flips, knife=knife, mask_diff=mask_diff)


# ---------------------------------------------------------------------------
# phase 11: distributed on one card
# ---------------------------------------------------------------------------

DIST_STEPS = 5          # 11(a): IMS_PER_BATCH 1, plain and --distributed in a world-size-1 group
DIST_BF16_STEPS = 3     # 11(b): two gloo ranks on the one card at IMS_PER_BATCH 2
DIST_RANKS = 2
DIST_DEADLINE_S = 300   # each launch of ranks; they are killed past it
DIST_SERVE_BATCHES = (3, 4)


def f32_step_cfg(ds_yaml, step_opts, ims_per_batch=1):
    """check_f32_step's configuration: the finetune config in f32 at a
    320-576 px training size, no rotation."""
    from glass_tpu_torch.config import get_cfg, merge_from_dataset_config

    cfg = get_cfg(ICDAR15)
    merge_from_dataset_config(cfg, ds_yaml)
    cfg.merge_from_list(["TPU.COMPUTE_DTYPE", "float32", "INPUT.MIN_SIZE_TRAIN", "(320, 320)",
                         "INPUT.MAX_SIZE_TRAIN", "576", "INPUT.ROTATION.ENABLED", "False",
                         "SOLVER.IMS_PER_BATCH", str(ims_per_batch), *step_opts])
    return cfg


def dist_rank(root, host, init_path, ds_yaml, step_opts, trainer_argv, bf16_steps, mode, device):
    """One rank of phase 11(b) (spawned, in a gloo group): one f32
    ``make_parallel_train_step`` on its row of the global batch with its
    recorded draws (``mode`` "card" records the proposals, "cpu" replays
    the card's), then on the card ``bf16_steps`` steps of the ``Trainer``
    in the group; writes ``<root>/<mode>_rank<r>.pt``."""
    import torch.distributed as dist

    from glass_tpu_torch.models import GlassArch, GlassRCNN
    from glass_tpu_torch.parallel import mesh
    from glass_tpu_torch.train.optimizer import build_optimizer
    from glass_tpu_torch.train.train_step import TrainConfig, batch_to_device

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    r = mesh.rank()
    device = torch.device(device)
    cfg = f32_step_cfg(ds_yaml, step_opts, DIST_RANKS)
    model = GlassRCNN(GlassArch.from_config(cfg))
    model.load_state_dict(torch.load(init_path, weights_only=True))
    model = model.to(device).train()
    opt = build_optimizer(cfg, model)
    batch = batch_to_device(mesh.shard_batch(host, r, DIST_RANKS), device)
    props_path = os.path.join(root, f"proposals{r}.pt")
    with RecordedProposals() as props:
        if mode == "cpu":
            props.saved, props.replay = torch.load(props_path, weights_only=False), True
        t0 = time.perf_counter()
        metrics = mesh.make_parallel_train_step(dist.group.WORLD)(
            model, opt, TrainConfig.from_config(cfg), batch, RecordedDraws(11 + r).for_device(device, False), 0)
        if device.type == "cuda":
            torch.cuda.synchronize()
        s = time.perf_counter() - t0
    if mode == "card":
        torch.save(props.saved, props_path)
    res = dict(losses={k: float(v) for k, v in metrics.items()}, s=s)
    if r == 0:
        torch.save(dict(losses=res["losses"], s=s,
                        grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                        bn={k: v.detach().cpu() for k, v in model.state_dict().items() if "running_" in k}),
                   os.path.join(root, f"{mode}_step.pt"))
    del model, opt, batch
    if mode == "card":
        res.update(dist_bf16_steps(trainer_argv, bf16_steps, device))
    torch.save(res, os.path.join(root, f"{mode}_rank{r}.pt"))


def dist_bf16_steps(trainer_argv, steps, device):
    """``steps`` steps of the ``Trainer`` of ``trainer_argv`` in the group:
    s/step, peak memory, the gradient all-reduce's ms a step, the kernel
    launches and whether the replicas agree bit for bit afterwards."""
    from glass_tpu_torch.ops import _cuda
    from glass_tpu_torch.parallel import mesh
    from glass_tpu_torch.train.cli import load_cfg, parse_args
    from glass_tpu_torch.train.trainer import Trainer

    trainer = Trainer(load_cfg(parse_args(trainer_argv)), device=device)
    reduce_ms, inner = [], mesh._flat_all_reduce_mean
    cuda = device.type == "cuda"

    def timed(tensors, group):  # from the end of this rank's backward, the wait for the other included
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner(tensors, group)
        if cuda:
            torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)

    mesh._flat_all_reduce_mean = timed
    _cuda.LAUNCHES.clear()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    try:
        with StepClock(device) as clock:
            trainer.train(max_iter=steps)
    finally:
        mesh._flat_all_reduce_mean = inner
    n_bytes = 4 * (sum(p.numel() for p in trainer.model.parameters())
                   + sum(v.numel() for k, v in trainer.model.state_dict().items() if "running_" in k))
    return dict(ms=clock.ms, metrics=clock.metrics, reduce_ms=reduce_ms, reduce_mib=n_bytes / 2**20,
                peak_mib=torch.cuda.max_memory_allocated() / 2**20 if cuda else 0.0,
                launches=dict(_cuda.LAUNCHES),
                agree=mesh.replicas_agree(list(trainer.model.state_dict().values())))


def phase_distributed(state_dict, images, out_dir, device="cuda", n_images=8, hw=(720, 1280), opts=(),
                      step_opts=(), steps=DIST_STEPS, bf16_steps=DIST_BF16_STEPS, serve_opts=(),
                      phase8=None):
    """Phase 11, distributed on one card; see the module docstring.
    ``opts``, ``step_opts``, ``serve_opts``, ``hw`` and the step counts cut
    the sizes for a CPU rehearsal (``device="cpu"``: gloo ranks on the
    CPU, the card-only checks skipped)."""
    device = torch.device(device)
    root = os.path.join(out_dir, "distributed")
    os.makedirs(root, exist_ok=True)
    try:
        return _phase_distributed(state_dict, images, root, device, n_images, hw, list(opts), list(step_opts),
                                  steps, bf16_steps, list(serve_opts), phase8)
    finally:  # images, checkpoints and gradients are large; the logs stay
        import glob
        import shutil

        shutil.rmtree(os.path.join(root, "ds"), ignore_errors=True)
        for f in glob.glob(os.path.join(root, "**", "*.pt*"), recursive=True):
            os.remove(f)


def _phase_distributed(state_dict, images, root, device, n_images, hw, opts, step_opts, steps, bf16_steps,
                       serve_opts, phase8):
    cuda = device.type == "cuda"
    card = card_line() if cuda else "CPU"
    ds_yaml = write_eval_set(root, n_images, hw, seed=3, name="synth_train", train=True)
    launches = collections.Counter()
    a = dist_world1(root, ds_yaml, device, opts, steps, phase8, launches)
    b = dist_two_ranks(root, ds_yaml, device, opts, step_opts, bf16_steps, launches)
    c = dist_serving(state_dict, images, device, serve_opts, launches)
    log(f"phase 11 launches ({card}): {dict(launches)}")
    return dict(launches=dict(launches), a=a, b=b, c=c)


class IdentityProbe:
    """Wraps the parallel step's flat all-reduce: records, per call,
    whether it returned every tensor bit for bit (what it must do in a
    one-rank group)."""

    def __init__(self):
        from glass_tpu_torch.parallel import mesh

        self.mesh, self.inner, self.same = mesh, mesh._flat_all_reduce_mean, []

    def __enter__(self):
        def probed(tensors, group):
            before = [t.clone() for t in tensors]
            self.inner(tensors, group)
            self.same.append(all(torch.equal(a, b) for a, b in zip(before, tensors)))

        self.mesh._flat_all_reduce_mean = probed
        return self

    def __exit__(self, *exc):
        self.mesh._flat_all_reduce_mean = self.inner


def _rel_l2(x, y) -> float:
    num = sum(float((x[k].double() - v.double()).pow(2).sum()) for k, v in y.items())
    den = sum(float(v.double().pow(2).sum()) for v in y.values())
    return math.sqrt(num / max(den, 1e-300))


def dist_world1(root, ds_yaml, device, opts, steps, phase8, launches):
    """11(a): ``python -m glass_tpu_torch.train --distributed`` in a
    world-size-1 group (NCCL on the card) against the plain trainer with the
    same seed, and the plain trainer run again (the floor of run-to-run
    differences: K1b and some backward kernels add with atomics)."""
    from glass_tpu_torch import train as port_train
    from glass_tpu_torch.ops import _cuda
    from glass_tpu_torch.parallel import mesh

    cuda = device.type == "cuda"
    card = card_line() if cuda else "CPU"
    # SEED 0: the config's -1 leaves the augmentations unseeded
    opts = ["TPU.COMPUTE_DTYPE", "bfloat16", "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0",
            "VIS_PERIOD", "0", "SOLVER.BASE_LR", TRAIN_LR, "SEED", "0", *opts]
    runs = {}
    for name in ("plain", "distributed", "plain_again"):
        env = {}
        if name == "distributed":
            env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
                   "MASTER_PORT": str(mesh.free_port())}
        os.environ.update(env)
        _cuda.LAUNCHES.clear()
        try:
            with StepClock(device) as clock, IdentityProbe() as probe:
                trainer = port_train.main(
                    ["--config", ICDAR15, "--datasets", ds_yaml, "--device", str(device), "--output",
                     os.path.join(root, name), "--max-iter", str(steps)] + (["--distributed"] if env else [])
                    + opts)
        finally:
            for k in env:
                os.environ.pop(k)
        if env:
            launches.update(_cuda.LAUNCHES)
            if cuda:
                _check_launches(dict(_cuda.LAUNCHES), steps, 1, "--distributed in a world-size-1 NCCL group")
        runs[name] = dict(losses=clock.metrics, ms=clock.ms, identity=probe.same,
                          state={k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()})
        del trainer

    plain, dist_, again = runs["plain"], runs["distributed"], runs["plain_again"]
    same_losses = dist_["losses"] == plain["losses"]
    same_first = dist_["losses"][0] == plain["losses"][0]
    same_state = all(torch.equal(v, plain["state"][k]) for k, v in dist_["state"].items())
    diff, floor = _rel_l2(dist_["state"], plain["state"]), _rel_l2(again["state"], plain["state"])
    identity = dist_["identity"]
    median = {k: float(np.median(np.asarray(v["ms"][2:] or v["ms"]))) / 1e3 for k, v in runs.items()}
    p8 = f"{phase8['median_s']:.3f}" if phase8 else "not run in this call"
    log(f"dist (a) ({card}): {steps} steps at IMS_PER_BATCH 1 (bf16), --distributed in a world-size-1 "
        f"{'NCCL' if cuda else 'gloo'} group against the plain trainer: the step's all-reduce returned its "
        f"input bit for bit at {sum(identity)} of {len(identity)} steps; losses bit-identical at step 0 "
        f"{same_first}, at every step {same_losses}; final weights and BN statistics bit-identical "
        f"{same_state}, rel L2 {diff:.3g}; the plain trainer against itself rel L2 {floor:.3g} (bit-identical "
        f"{floor == 0}); s/step median distributed {median['distributed']:.3f}, plain {median['plain']:.3f} "
        f"and {median['plain_again']:.3f} (phase 8: {p8}); total loss "
        f"{[round(m['total_loss'], 4) for m in dist_['losses']]}")
    if not same_first or len(identity) != steps or not all(identity) or plain["identity"]:
        raise AssertionError(f"dist (a): step 0 losses equal {same_first}, all-reduce identity {identity}")
    if floor == 0 and not (same_losses and same_state):
        raise AssertionError("dist (a): the plain trainer repeats itself bit for bit, the distributed one differs")
    if diff > 10 * floor:
        raise AssertionError(f"dist (a): distributed vs plain rel L2 {diff} beyond 10x the run-to-run floor {floor}")
    return dict(same_losses=same_losses, same_state=same_state, diff=diff, floor=floor, median_s=median)


def dist_two_ranks(root, ds_yaml, device, opts, step_opts, bf16_steps, launches):
    """11(b): two gloo ranks on the one card, then the same f32 step on two
    gloo ranks on the CPU."""
    from glass_tpu_torch.data import DatasetManager
    from glass_tpu_torch.data.loader import build_train_loader
    from glass_tpu_torch.data.mapper import DatasetMapper
    from glass_tpu_torch.models import GlassArch, GlassRCNN
    from glass_tpu_torch.parallel import mesh
    from glass_tpu_torch.train.trainer import init_weights_

    cuda = device.type == "cuda"
    card = card_line() if cuda else "CPU"
    cfg = f32_step_cfg(ds_yaml, step_opts, DIST_RANKS)
    DatasetManager(cfg).register()
    records = DatasetManager.load(cfg.DATASETS.TRAIN[0])
    host = next(iter(build_train_loader(cfg, records, DatasetMapper(cfg, True, np.random.RandomState(0)),
                                        DIST_RANKS)))
    init_path = os.path.join(root, "init.pth")
    torch.save(init_weights_(GlassRCNN(GlassArch.from_config(cfg)), max(int(cfg.SEED), 0)).state_dict(),
               init_path)
    trainer_argv = ["--config", ICDAR15, "--datasets", ds_yaml, "--output", os.path.join(root, "b"),
                    "--device", str(device), "TPU.COMPUTE_DTYPE", "bfloat16", "SOLVER.CHECKPOINT_PERIOD",
                    "0", "TEST.EVAL_PERIOD", "0", "VIS_PERIOD", "0", "SOLVER.BASE_LR", TRAIN_LR, "SEED", "0", *opts,
                    "SOLVER.IMS_PER_BATCH", str(DIST_RANKS)]
    t0 = time.perf_counter()
    # both card ranks on the one card (cuda:0), each spawned CPU rank on half the cores
    card_dev = torch.device("cuda", 0) if cuda else device
    for mode, dev, threads in (("card", card_dev, None), ("cpu", "cpu", max(1, (os.cpu_count() or 2) // 2))):
        mesh.launch(dist_rank, DIST_RANKS, args=(root, host, init_path, ds_yaml, step_opts, trainer_argv,
                                                 bf16_steps, mode, str(dev)),
                    device=dev, backend="gloo", timeout_s=DIST_DEADLINE_S, deadline_s=DIST_DEADLINE_S,
                    threads=threads)
        log(f"dist (b): {DIST_RANKS} {mode} ranks done at {time.perf_counter() - t0:.1f} s")
    ranks = [torch.load(os.path.join(root, f"card_rank{r}.pt"), weights_only=False) for r in range(DIST_RANKS)]
    cpu_ranks = [torch.load(os.path.join(root, f"cpu_rank{r}.pt"), weights_only=False) for r in range(DIST_RANKS)]
    failed, err = step_errors(torch.load(os.path.join(root, "card_step.pt"), weights_only=False),
                              torch.load(os.path.join(root, "cpu_step.pt"), weights_only=False))
    log(f"dist (b) f32 step, {DIST_RANKS} gloo ranks on {card} against {DIST_RANKS} gloo ranks on the CPU "
        f"(rank 0's averaged gradients and BN statistics): image {tuple(host['images'].shape[1:3])}, step "
        f"{[round(x['s'], 2) for x in ranks]} s on the card, {[round(x['s'], 2) for x in cpu_ranks]} s on "
        f"the CPU; {err['text']} -> {'ok' if not failed else 'FAILED'}")
    if failed:
        raise AssertionError(f"dist (b): the card's 2-rank f32 step differs from the CPU's: {failed}")
    for r, x in enumerate(ranks):
        ms = np.asarray(x["ms"][1:] or x["ms"])
        red = np.asarray(x["reduce_ms"][1:] or x["reduce_ms"])
        log(f"dist (b) rank {r} ({card}): {bf16_steps} bf16 steps of the Trainer at IMS_PER_BATCH "
            f"{DIST_RANKS} (one image a rank): s/step median {np.median(ms) / 1e3:.3f} (first excluded; all "
            f"{[round(v / 1e3, 3) for v in x['ms']]}); peak memory {x['peak_mib']:.0f} MiB; gradient "
            f"all-reduce over gloo through the host (not NCCL), one flat f32 buffer of "
            f"{x['reduce_mib']:.0f} MiB: median {np.median(red):.1f} ms a step (the wait for the other rank "
            f"included; all {[round(v, 1) for v in x['reduce_ms']]}); launches {x['launches']}; total loss "
            f"{[round(m['total_loss'], 4) for m in x['metrics']]}")
        launches.update(x["launches"])
        if cuda:
            _check_launches(x["launches"], bf16_steps, 1, f"rank {r} of {DIST_RANKS} gloo ranks")
    agree = all(x["agree"] for x in ranks) and ranks[0]["metrics"] == ranks[1]["metrics"]
    log(f"dist (b): after {bf16_steps} bf16 steps the replicas' weights and statistics are bit-identical: {agree}")
    if not agree:
        raise AssertionError("dist (b): the replicas differ after the bf16 steps")
    return dict(step=err, ranks=[{k: x[k] for k in ("ms", "reduce_ms", "peak_mib", "launches")} for x in ranks])


def dist_serving(state_dict, images, device, serve_opts, launches):
    """11(c): TPU.SERVE_DATA_PARALLEL with two replicas on the one card
    against b = 1 serving, bit for bit; with the card alone it is phase
    4's one-model path."""
    from glass_tpu_torch.inference import GlassRunner
    from glass_tpu_torch.ops import _cuda

    cuda = device.type == "cuda"
    card = card_line() if cuda else "CPU"
    base = GlassRunner(cfg=eval_cfg("bfloat16", opts=serve_opts), state_dict=state_dict, device=device)
    cfg = eval_cfg("bfloat16", opts=["TPU.SERVE_DATA_PARALLEL", "True", *serve_opts])
    one = GlassRunner(cfg=cfg, state_dict=state_dict, device=device)
    two = GlassRunner(cfg=cfg, state_dict=state_dict, device=device, serve_devices=[device, device])
    if one.replicas != [one.model] or len(two.replicas) != 2:
        raise AssertionError(f"dist (c): {len(one.replicas)} replicas on the one card, {len(two.replicas)} asked 2")
    imgs = [im.astype(np.float32) for im in images[:max(DIST_SERVE_BATCHES)]]
    want = [base.run_on_resized(im) for im in imgs]
    _cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    diffs = {b: same_predictions(two.run_batch_on_resized(imgs[:b]), want[:b]) for b in DIST_SERVE_BATCHES}
    wall = time.perf_counter() - t0
    got = dict(_cuda.LAUNCHES)
    launches.update(got)
    rows = sum(-(-b // 2) * 2 for b in DIST_SERVE_BATCHES)
    one_diff = same_predictions(one.run_batch_on_resized(imgs), want)
    log(f"dist (c) ({card}): SERVE_DATA_PARALLEL, two replicas on the one card (one thread each) at b = "
        f"{list(DIST_SERVE_BATCHES)} in {wall:.2f} s: fields differing from b = 1 serving {diffs}; one card "
        f"alone: one replica, fields differing {one_diff}; launches {got} over {rows} rows (padding rows "
        f"included)")
    if any(diffs.values()) or one_diff:
        raise AssertionError(f"dist (c): data-parallel serving differs from b = 1: {diffs}, {one_diff}")
    if cuda and got != {"roi_align_rotated": 3 * rows, "crop_rois": rows}:
        raise AssertionError(f"dist (c): launches {got} over {rows} rows")
    return dict(launches=got)


# ---------------------------------------------------------------------------
# phase 12: float16, remat and the chunked loop
# ---------------------------------------------------------------------------


def phase12_kernels(rng):
    """12(a): the fp16 builds of K1 (the three poolers at the eval and the
    training shapes), K1b (the training shapes, phase 7's bound) and K2
    (the normalized fp16 image, sampling ratios 1, 2 and 0, and phase 3's
    edge cases), each against its plain version; grid_sample in fp16 as
    K2's yardstick."""
    f16 = torch.float16
    k1, k1b, k2 = [], [], []
    rois = torch.from_numpy(word_rois(rng, N_ROIS, *BUCKET_HW)).cuda()
    for name, *_ in POOLERS:
        pyr, levels, grid, out_hw, _, _ = pooler_inputs(name, rng, f16, rois)
        k1.append(k1_case(name, pyr, rois, levels, grid, out_hw))
    h, w = TRAIN_BUCKET_HW
    for name, n in TRAIN_ROIS.items():
        trois = torch.from_numpy(word_rois(rng, n, h, w)).cuda()
        pyr, levels, grid, out_hw = _train_pooler_inputs(name, rng, f16, trois)
        k1.append(k1_case(f"train {name}", pyr, trois, levels, grid, out_hw))
        k1b.append(k1b_case(f"train {name}", pyr, trois, levels, grid, out_hw, rng))
    bh, bw = BUCKET_HW
    raw = torch.from_numpy(rng.randint(0, 256, (bh, bw, 3)).astype(np.uint8)).cuda()
    mean = torch.tensor([103.53, 116.28, 123.675], device="cuda")
    std = torch.tensor([57.375, 57.12, 58.395], device="cuda")
    image = ((raw.float() - mean) / std).to(f16)
    for sr in (1, 2, 0):
        k2.append(k2_case("float16", image, rois, (128, 128), sr, None, std))
    column = rois.clone()
    column[:, 0] = 0.5
    edge = [k2_case("float16", image, rois[:n], (128, 128), 0, None, std, timed=False) for n in (0, 1)]
    edge.append(k2_case("float16", image, rois, (32, 100), 2, None, std, timed=False))
    edge.append(k2_case("float16 W=1", image[:, :1].contiguous(), column, (16, 8), 2, None, std, timed=False))
    lib_ms = k2_yardstick(image, rois)
    k2[0]["library_ms"] = lib_ms
    for label, rows in (("K1 eval", k1[:3]), ("K1 train", k1[3:]), ("K1b train", k1b), ("K2 sr 1", k2[:1])):
        ms, b_ms = sum(r["ms"] for r in rows), sum(r["bound_ms"] for r in rows)
        log(f"phase 12 (a) fp16 {label}: {ms:.4f} ms, bound {b_ms:.4f} ms ({100 * b_ms / ms:.1f}%), plain "
            f"{sum(r['plain_ms'] for r in rows):.3f} ms ({card_line()})")
    return dict(k1=k1, k1b=k1b, k2=k2 + edge, k2_lib_ms=lib_ms)


FP16_TIMED = 8          # 12(b): fp16 images through __call__ after 2 warm-up
FP16_STEPS = 5          # 12(c): fp16 training steps at IMS_PER_BATCH 1
LOOP_ITERS, LOOP_K, LOOP_CKPT = 10, 4, 5   # 12(d), (e): 10 iterations, TRAIN_LOOP_STEPS 4, checkpoint every 5
STAGE_REL_TOL, STAGE_PROB_TOL = 0.05, 0.15  # tests/test_bf16_serving_numerics.py's bounds
REMAT_GRAD_L2 = STEP_HEAD_L2  # 12(d): the remat step's f32 gradients against the plain step's, rel L2
LOOP_FAULTS = ("first_batch", "next_priorities")  # 12(e)'s controls: wrong loops the check must fail


def _digest(batch: dict) -> tuple:
    """A batch's fingerprint: each tensor's name, shape and f64 sum."""
    return tuple((k, tuple(v.shape), float(v.double().sum())) for k, v in sorted(batch.items())
                 if torch.is_tensor(v))


def _next_priorities(p):
    """The priorities of the next iteration (its seed plus one)."""
    from glass_tpu_torch.train.train_step import Priorities

    q = Priorities(0, 0, p.device)
    q.generator.manual_seed(p.generator.initial_seed() + 1)
    return q


class LoopClock:
    """Wraps ``mesh.make_parallel_train_scan``, which the trainer's loop
    runs each chunk through (one step a chunk at K = 1): each chunk's wall
    time (a synchronize after it), each step's metrics, and what the loop
    fed each step (its iteration, its priorities' seed, its batch's
    ``_digest``), read once a chunk.  ``fault`` plants a wrong loop, for
    12(e)'s controls: "first_batch" feeds every step of a chunk the chunk's
    first batch, "next_priorities" the next iteration's priorities."""

    def __init__(self, device, fault=None):
        from glass_tpu_torch.parallel import mesh

        self.mesh, self.fn, self.device, self.fault = mesh, mesh.make_parallel_train_scan, device, fault
        self.chunks, self.metrics, self.fed = [], [], []

    def __enter__(self):
        def make(step):
            scan = self.fn(step)

            def timed(model, optimizer, tcfg, batches, priorities, iterations):
                if self.fault == "first_batch":
                    batches = [batches[0]] * len(batches)
                elif self.fault == "next_priorities":
                    priorities = [_next_priorities(p) for p in priorities]
                self.fed += [(it, p.generator.initial_seed(), _digest(b))
                             for it, p, b in zip(iterations, priorities, batches)]
                t0 = time.perf_counter()
                out = scan(model, optimizer, tcfg, batches, priorities, iterations)
                if self.device.type == "cuda":
                    torch.cuda.synchronize()
                n = len(iterations)
                self.chunks.append((n, (time.perf_counter() - t0) * 1e3))
                host = {key: v.tolist() for key, v in out.items()}
                self.metrics += [{key: v[j] for key, v in host.items()} for j in range(n)]
                return out

            return timed

        self.mesh.make_parallel_train_scan = make
        return self

    def __exit__(self, *exc):
        self.mesh.make_parallel_train_scan = self.fn


class PeakProbe:
    """Memory of each training step on the card, in MiB: allocated when its
    forward starts, the peak of the forward, of forward and backward and of
    the whole step (the SGD update included), and what is still allocated
    after the backward and after the update.  It wraps
    ``train_step.glass_train_forward`` and ``GlassOptimizer.step``."""

    def __init__(self):
        from glass_tpu_torch.train import train_step as ts
        from glass_tpu_torch.train.optimizer import GlassOptimizer

        self.ts, self.forward, self.opt, self.update = ts, ts.glass_train_forward, GlassOptimizer, GlassOptimizer.step
        self.steps = []

    @staticmethod
    def _read():
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() / 2**20, torch.cuda.memory_allocated() / 2**20

    def __enter__(self):
        def forward(*a, **k):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            row = dict(start=torch.cuda.memory_allocated() / 2**20)
            out = self.forward(*a, **k)
            row["forward_peak"], row["after_forward"] = self._read()
            self.steps.append(row)
            return out

        def update(opt, iteration):
            row = self.steps[-1]
            row["backward_peak"], row["after_backward"] = self._read()
            lr = self.update(opt, iteration)
            row["step_peak"], row["after_step"] = self._read()
            return lr

        self.ts.glass_train_forward, self.opt.step = forward, update
        return self

    def __exit__(self, *exc):
        self.ts.glass_train_forward, self.opt.step = self.forward, self.update


def stage_heads(model, feats, norm, boxes, targets):
    """Box logits and deltas on fixed proposals, teacher-forced decoder
    logits and mask probabilities on fixed boxes, as f32 tensors."""
    from glass_tpu_torch.models import glass_rcnn as gr
    from glass_tpu_torch.models.recognizer import aster_decode_train
    from glass_tpu_torch.ops.roi_align_rotated import multilevel_pool

    arch, rh = model.arch, model.roi_heads
    pyr = gr.pack_box_pyramid(model, feats)
    pooled = multilevel_pool(pyr, gr._min_level(model), boxes, (arch.box_pooler_resolution,) * 2,
                             arch.box_pooler_sampling_ratio, arch.pool_max_sampling_ratio,
                             arch.pool_bulk_sampling_ratio, arch.pool_large_roi_budget)
    logits, deltas, _ = rh.box_predictor(rh.box_head(pooled).to(torch.float32))
    enc = gr.recognizer_encode(model, feats, norm, boxes).to(torch.float32)
    tf = aster_decode_train(rh.recognizer_head.aster, enc, targets, arch.max_word_len + 1)
    masks = gr.mask_single_image(model, pyr, boxes, torch.zeros(boxes.shape[0], dtype=torch.int32,
                                                               device=boxes.device))
    return dict(box_logits=logits, box_deltas=deltas, decoder_logits=tf, mask_probs=masks.float())


def fp16_stage_deltas(state_dict, image, device, opts=()):
    """12(b): the fp16 stages against f32 on the device, each head on the
    fixed inputs of the f32 backbone's features cast to fp16 (as
    tests/test_torch_float16.py holds them on the CPU): features 5 %
    relative, box logits and deltas and decoder logits 5 % relative, mask
    probabilities 0.15; no non-finite value in fp16 where f32 has none."""
    from glass_tpu_torch.inference import GlassRunner
    from glass_tpu_torch.models import glass_rcnn as gr

    rng = np.random.RandomState(12)
    h, w = image.shape[:2]
    n = 16
    boxes = torch.from_numpy(np.stack([rng.uniform(100, w - 100, n), rng.uniform(50, h - 50, n),
                                       rng.uniform(40, 300, n), rng.uniform(12, 60, n),
                                       rng.uniform(-30, 30, n)], 1).astype(np.float32)).to(device)
    models = {dt: GlassRunner(cfg=eval_cfg(dt, opts=opts), state_dict=state_dict, device=device).model
              for dt in ("float32", "float16")}
    targets = torch.from_numpy(rng.randint(2, 60, (n, models["float32"].arch.max_word_len + 2))
                               .astype(np.int32)).to(device)
    padded = np.zeros((-(-h // 32) * 32, -(-w // 32) * 32, 3), np.float32)
    padded[:h, :w] = image
    out = {}
    with torch.inference_mode():
        f32 = models["float32"]
        norm32 = gr.preprocess(f32, torch.from_numpy(padded).to(device))
        feats32 = gr.backbone_features(f32, norm32)
        for dt, m in models.items():
            norm = gr.preprocess(m, torch.from_numpy(padded).to(device))
            own = gr.backbone_features(m, norm)
            fixed = {k: v.to(m.arch.torch_dtype) for k, v in feats32.items()}
            out[dt] = dict({f"feature {k}": v.float() for k, v in own.items()},
                           **stage_heads(m, fixed, norm, boxes, targets))
    errs, nonfinite = {}, {}
    for k, want in out["float32"].items():
        got = out["float16"][k]
        bad16, bad32 = int((~torch.isfinite(got)).sum()), int((~torch.isfinite(want)).sum())
        nonfinite[k] = (bad16, bad32)
        d = (got - want).abs().max().item()
        errs[k] = d if k == "mask_probs" else d / max(want.abs().max().item(), 1e-6)
    worse = {k: v for k, v in nonfinite.items() if v[0] and not v[1]}
    over = {k: v for k, v in errs.items() if v > (STAGE_PROB_TOL if k == "mask_probs" else STAGE_REL_TOL)}
    log(f"fp16 (b) stage deltas against f32 on the device ({len(boxes)} fixed boxes): "
        + ", ".join(f"{k} {v:.4g}" for k, v in errs.items())
        + f"; non-finite (fp16, f32) per stage {nonfinite} -> {'ok' if not (worse or over) else 'FAILED'}")
    if worse or over:
        raise AssertionError(f"fp16 stage deltas: beyond the bounds {over}; non-finite in fp16 only {worse}")
    return dict(errs=errs, nonfinite=nonfinite)


def _reset_peak(device) -> int:
    """Reset the peak-memory counter; returns the bytes already allocated
    (earlier phases' live tensors), which ``_peak_mib`` leaves out, so that
    phase 12's peaks read like phases 4 and 8's, taken with nothing
    allocated before them."""
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak_mib(device, base) -> float:
    return (torch.cuda.max_memory_allocated() - base) / 2**20 if device.type == "cuda" else 0.0


def serve_timed(cfg, state_dict, images, device, n_timed):
    """``GlassRunner.__call__`` on 2 warm-up images then ``n_timed``:
    medians of ``__call__`` and ``run_model`` (ms), peak memory (MiB), the
    kernels' launches and the outputs' finiteness."""
    from glass_tpu_torch.inference import GlassRunner
    from glass_tpu_torch.ops import _cuda

    runner = GlassRunner(cfg=cfg, state_dict=state_dict, device=device)
    run_model, model_ms = runner.run_model, []

    def timed_run_model(image, rid=None):
        t0 = time.perf_counter()
        out = run_model(image, rid)
        model_ms.append((time.perf_counter() - t0) * 1e3)
        finite.append(all(np.isfinite(np.asarray(v, np.float32)).all() for k, v in out.items()
                          if isinstance(v, np.ndarray) and v.dtype.kind == "f"))
        return out

    finite, times = [], []
    runner.run_model = timed_run_model
    cuda = device.type == "cuda"
    base = _reset_peak(device)
    _cuda.LAUNCHES.clear()
    for i in range(2 + n_timed):
        t0 = time.perf_counter()
        runner(images[i % len(images)])
        if cuda:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return dict(call_ms=float(np.median(times[2:])), model_ms=float(np.median(model_ms[2:])),
                peak_mib=_peak_mib(device, base), launches=dict(_cuda.LAUNCHES), finite=all(finite),
                n=len(times))


def train_run(root, name, ds_yaml, device, opts, steps, fault=None, probe=False, keep_trainer=False):
    """``glass_tpu_torch.train.main`` for ``steps`` iterations under a
    ``LoopClock`` (with ``fault``): per-step metrics, what each step was
    fed, per-step ms (a chunk's mean), peak memory, launches, the final
    state, the checkpoints, with ``probe`` the ``PeakProbe`` rows and with
    ``keep_trainer`` the trainer."""
    import contextlib
    import gc
    import signal

    from glass_tpu_torch import train as port_train
    from glass_tpu_torch.ops import _cuda

    # a trainer's SIGTERM/SIGINT handler holds it (and its weights, momentum
    # and gradients on the card) until the next trainer replaces the
    # handler: let the last one go first, or it is in this run's base and
    # freed during the run, and the run's peak reads low by its size
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.signal(signal.SIGINT, signal.default_int_handler)
    gc.collect()
    base = _reset_peak(device)
    _cuda.LAUNCHES.clear()
    clock = LoopClock(device, fault)
    peaks = PeakProbe() if probe else contextlib.nullcontext()
    out = os.path.join(root, name)
    with clock, peaks:
        t0 = time.perf_counter()
        trainer = port_train.main(["--config", ICDAR15, "--datasets", ds_yaml, "--device", str(device),
                                   "--output", out, "--max-iter", str(steps), *opts])
        wall = time.perf_counter() - t0
    return dict(metrics=clock.metrics, fed=clock.fed, step_ms=[ms / n for n, ms in clock.chunks for _ in range(n)],
                wall_s=wall, launches=dict(_cuda.LAUNCHES), chunks=[n for n, _ in clock.chunks],
                peak_mib=_peak_mib(device, base), trainer=trainer if keep_trainer else None,
                probe=peaks.steps if probe else None,
                state={k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()},
                ckpts=sorted(f for f in os.listdir(out) if f.endswith(".pth")))


def _median_s(run, skip=2):
    ms = run["step_ms"][skip:] or run["step_ms"]
    return float(np.median(ms)) / 1e3


def _mean_s(run, first):
    """Mean s/step from iteration ``first`` on (a chunk boundary)."""
    return float(np.mean(run["step_ms"][first:])) / 1e3


def phase_fp16_remat_loop(state_dict, images, out_dir, device="cuda", main=None, train=None, opts=(),
                          train_opts=(), n_timed=FP16_TIMED, steps=FP16_STEPS, loop_iters=LOOP_ITERS,
                          loop_k=LOOP_K, loop_ckpt=LOOP_CKPT, n_images=8, hw=(720, 1280),
                          train_dtype="float16"):
    """Phase 12 (b)-(e); see the module docstring.  ``opts``,
    ``train_opts``, the counts and ``hw`` cut the sizes for a CPU rehearsal
    (``device="cpu"``, where the card-only checks are skipped and
    ``train_dtype`` bfloat16 stands in for fp16 training, whose convolution
    backward the CPU runs through a reference path)."""
    device = torch.device(device)
    root = os.path.join(out_dir, "fp16_remat_loop")
    os.makedirs(root, exist_ok=True)
    try:
        return _phase_fp16_remat_loop(state_dict, images, root, device, main, train, list(opts),
                                      list(train_opts), n_timed, steps, loop_iters, loop_k, loop_ckpt,
                                      n_images, hw, train_dtype)
    finally:  # images and checkpoints are large; the logs stay
        import glob
        import shutil

        shutil.rmtree(os.path.join(root, "ds"), ignore_errors=True)
        for f in glob.glob(os.path.join(root, "**", "*.pth"), recursive=True):
            os.remove(f)


def _phase_fp16_remat_loop(state_dict, images, root, device, main, train, opts, train_opts, n_timed,
                           steps, loop_iters, loop_k, loop_ckpt, n_images, hw, train_dtype):
    cuda = device.type == "cuda"
    card = card_line() if cuda else "CPU"
    launches = collections.Counter()
    res = {}

    # (b) serving in fp16: phase 4's config, weights and images
    srv = serve_timed(eval_cfg("float16", opts=opts), state_dict, images, device, n_timed)
    launches.update(srv["launches"])
    p4 = (f"phase 4 (bf16): __call__ {main['median_ms']:.2f} ms, peak {main['peak_mib']:.0f} MiB"
          if main else "phase 4 not run in this call")
    log(f"fp16 (b) serving ({card}): {n_timed} timed images after 2 warm-up: __call__ median "
        f"{srv['call_ms']:.2f} ms, run_model median {srv['model_ms']:.2f} ms, peak {srv['peak_mib']:.0f} MiB; "
        f"{p4}; launches {srv['launches']}; outputs finite {srv['finite']}")
    if not srv["finite"]:
        raise AssertionError("fp16 serving: non-finite outputs")
    # K1 and K2 as the other phases count them (K3's launches are phase 16's)
    got = {k: srv["launches"].get(k, 0) for k in ("roi_align_rotated", "crop_rois")}
    if cuda and got != {"roi_align_rotated": 3 * srv["n"], "crop_rois": srv["n"]}:
        raise AssertionError(f"fp16 serving: launches {srv['launches']} over {srv['n']} images")
    res["serve"] = {k: v for k, v in srv.items() if k != "launches"}
    res["stages"] = fp16_stage_deltas(state_dict, images[0], device, opts)

    ds_yaml = write_eval_set(root, n_images, hw, seed=3, name="synth_train", train=True)
    base = ["SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0", "VIS_PERIOD", "0",
            "SOLVER.BASE_LR", TRAIN_LR, "SEED", "0", *train_opts]

    # (c) training in fp16: phase 8's config, no loss scaling (as glass_tpu)
    c = train_run(root, "fp16", ds_yaml, device, base + ["TPU.COMPUTE_DTYPE", train_dtype], steps)
    launches.update(c["launches"])
    bad = [i for i, m in enumerate(c["metrics"]) if not all(np.isfinite(v) for v in m.values())]
    p8 = f"{train['median_s']:.3f} s/step, peak {train['peak_mib']:.0f} MiB" if train else "not run in this call"
    log(f"fp16 (c) training ({card}, {train_dtype}): {steps} steps at IMS_PER_BATCH 1: s/step median "
        f"{_median_s(c):.3f}, peak {c['peak_mib']:.0f} MiB (phase 8, bf16: {p8}); total loss per step "
        f"{[round(m['total_loss'], 4) for m in c['metrics']]}; launches {c['launches']}")
    if bad:
        raise AssertionError(f"fp16 training: non-finite losses at steps {bad}: {c['metrics'][bad[0]]}")
    if cuda:
        _check_launches(c["launches"], steps, 1, "fp16")
    res["fp16_train"] = dict(median_s=_median_s(c), peak_mib=c["peak_mib"], losses=c["metrics"])
    del c
    # (c) and (d): step 0's gradients of the whole network against f32
    res["grads"] = grad_check(ds_yaml, device, base, train_dtype)

    # (d) and (e) with the weights held (BASE_LR 0): each step's forward is
    # then a function of its batch and priorities alone, and deterministic
    frozen = base + ["SOLVER.BASE_LR", "0.0", "TPU.COMPUTE_DTYPE", "bfloat16",
                     "SOLVER.CHECKPOINT_PERIOD", str(loop_ckpt)]
    chunked_opts = frozen + ["TPU.TRAIN_LOOP_STEPS", str(loop_k)]
    one = train_run(root, "k1", ds_yaml, device, frozen, loop_iters, probe=cuda)
    runs = dict(again=train_run(root, "k1_again", ds_yaml, device, frozen, loop_iters),
                chunked=train_run(root, f"k{loop_k}", ds_yaml, device, chunked_opts, loop_iters,
                                  keep_trainer=True),
                remat=train_run(root, "remat", ds_yaml, device, frozen + ["TPU.REMAT_BACKBONE", "True"],
                                loop_iters, probe=cuda))
    for fault in LOOP_FAULTS:
        runs[fault] = train_run(root, fault, ds_yaml, device, chunked_opts, loop_iters, fault=fault)
    launches.update(runs["chunked"]["launches"])
    launches.update(runs["remat"]["launches"])
    same = {name: _same_run(r, one) for name, r in runs.items()}
    for name, d in same.items():
        log(f"loop and remat ({card}, bf16, BASE_LR 0, {loop_iters} iterations, CHECKPOINT_PERIOD {loop_ckpt}): "
            f"{name} against K = 1: {d['text']}")
    sound = [n for n in ("again", "chunked", "remat") if not same[n]["equal"]]
    caught = [f for f in LOOP_FAULTS if not same[f]["metrics_equal"]]
    if sound or caught != list(LOOP_FAULTS):
        raise AssertionError(f"loop/remat: differ from K = 1: {sound}; controls caught by the losses: "
                             f"{caught} of {LOOP_FAULTS}")
    chunked, remat = runs["chunked"], runs["remat"]
    syncs = {k: _loop_syncs(chunked["trainer"], device, k) for k in (loop_k, 1)}
    first = chunked["chunks"][0]  # after the first chunk, as K = 1 from the same iteration
    mean_s = {"chunked": _mean_s(chunked, first), "k1": _mean_s(one, first),
              "k1_again": _mean_s(runs["again"], first)}
    log(f"loop (e) ({card}): TRAIN_LOOP_STEPS {loop_k}: chunks {chunked['chunks']}, checkpoints "
        f"{chunked['ckpts']}; mean s/step from iteration {first}: K = {loop_k} {mean_s['chunked']:.3f}, "
        f"K = 1 {mean_s['k1']:.3f} and {mean_s['k1_again']:.3f} (a synchronize a chunk); host syncs a step "
        f"in a chunk of {loop_k} {syncs[loop_k]:.2f}, of 1 {syncs[1]:.2f}; launches {chunked['launches']}")
    if cuda:
        _check_launches(chunked["launches"], loop_iters, 1, f"TRAIN_LOOP_STEPS {loop_k}")
        _check_launches(remat["launches"], loop_iters, 1, "remat")
    res["loop"] = dict(mean_s=mean_s, syncs_per_step=syncs, ckpts=chunked["ckpts"], chunks=chunked["chunks"],
                       controls={f: same[f]["worst_rel"] for f in LOOP_FAULTS})
    peak = {k: max((r["step_peak"] - r["start"] for r in run["probe"] or []), default=0.0)
            for k, run in (("plain", one), ("remat", remat))}
    fwd = {k: max((r["forward_peak"] - r["start"] for r in run["probe"] or []), default=0.0)
           for k, run in (("plain", one), ("remat", remat))}
    log(f"remat (d) ({card}, bf16): s/step median remat {_median_s(remat):.3f}, plain {_median_s(one):.3f}; "
        f"peak over {loop_iters} steps (weights and momentum included) remat {remat['peak_mib']:.0f} MiB, plain "
        f"{one['peak_mib']:.0f} MiB; largest peak above a step's start: over the step remat {peak['remat']:.0f} "
        f"MiB, plain {peak['plain']:.0f} MiB; over the forward remat {fwd['remat']:.0f} MiB, plain "
        f"{fwd['plain']:.0f} MiB")
    for k, run in (("plain", one), ("remat", remat)):
        for i, r in enumerate(run["probe"] or []):
            log(f"  remat (d) {k} step {i} MiB: " + ", ".join(f"{key} {v:.0f}" for key, v in r.items()))
    res["remat"] = dict(median_s={"remat": _median_s(remat), "plain": _median_s(one)},
                        peak_mib={"remat": remat["peak_mib"], "plain": one["peak_mib"]}, step_peak_mib=peak,
                        forward_peak_mib=fwd,
                        probe={"plain": one["probe"], "remat": remat["probe"]})
    log(f"phase 12 launches ({card}): {dict(launches)}")
    res["launches"] = dict(launches)
    return res


def _same_run(run, ref) -> dict:
    """``run`` against the K = 1 run ``ref``, both with the weights held:
    what each step was fed, its metrics, the final state (weights, BN
    statistics, every buffer) and the checkpoints, each bit for bit, and
    the largest relative difference of a step's total loss."""
    fed = run["fed"] == ref["fed"]
    metrics = run["metrics"] == ref["metrics"]
    state = set(run["state"]) == set(ref["state"]) and all(torch.equal(v, ref["state"][k])
                                                           for k, v in run["state"].items())
    ckpts = run["ckpts"] == ref["ckpts"]
    rel = [abs(a["total_loss"] - b["total_loss"]) / max(abs(b["total_loss"]), 1e-6)
           for a, b in zip(run["metrics"], ref["metrics"])]
    n_diff = sum(a != b for a, b in zip(run["metrics"], ref["metrics"]))
    worst = max(rel, default=0.0)
    return dict(equal=fed and metrics and state and ckpts, metrics_equal=metrics, worst_rel=worst,
                text=(f"fed the same {fed}; metrics bit-identical {metrics} ({n_diff} of {len(rel)} steps "
                      f"differ, total loss worst rel {worst:.3g}); final state bit-identical {state}; "
                      f"checkpoints {run['ckpts']} the same {ckpts}"))


def grad_check(ds_yaml, device, opts, low="float16"):
    """12(c) and (d): step 0 of phase 8's config on one loader batch, from
    the trainer's seeded weights, with the draws and the proposals of a
    first f32 step replayed into every other (``RecordedDraws``,
    ``RecordedProposals``), so every step samples the same rois: f32 again
    (the card's own run-to-run floor: K1b and some backward kernels add with
    atomics), f32 with remat, bf16, ``low`` (fp16) and, as the control,
    ``low`` with K1b's gradient halved.  Each parameter's gradient against
    the first f32 step in relative L2, leaving out the few that two f32
    steps disagree on beyond REMAT_GRAD_L2 (rounding noise).  Fails unless
    the remat step's losses and BN statistics equal f32's bit for bit and
    each of its gradients lies within REMAT_GRAD_L2, and, on the card, the
    median over the gradients of ``low`` lies no further from f32 than
    bf16's and the control's beyond it.  On the CPU ``low`` is bf16 (its
    fp16 convolution backward takes minutes)."""
    import contextlib
    import dataclasses

    from glass_tpu_torch.config import get_cfg, merge_from_dataset_config
    from glass_tpu_torch.data import DatasetManager
    from glass_tpu_torch.data.loader import build_train_loader
    from glass_tpu_torch.data.mapper import DatasetMapper
    from glass_tpu_torch.models import GlassArch, GlassRCNN
    from glass_tpu_torch.ops import roi_align_rotated as ra
    from glass_tpu_torch.train.train_step import TrainConfig, batch_to_device, glass_train_forward
    from glass_tpu_torch.train.trainer import init_weights_

    @contextlib.contextmanager
    def halved_k1b():
        backward = ra.RoIAlignRotatedFunction.backward

        def halved(ctx, grad_out):
            grad, *rest = backward(ctx, grad_out)
            return (grad * 0.5, *rest)

        ra.RoIAlignRotatedFunction.backward = staticmethod(halved)
        try:
            yield
        finally:
            ra.RoIAlignRotatedFunction.backward = staticmethod(backward)

    cfg = get_cfg(ICDAR15)
    merge_from_dataset_config(cfg, ds_yaml)
    cfg.merge_from_list(list(opts))
    DatasetManager(cfg).register()
    records = DatasetManager.load(cfg.DATASETS.TRAIN[0])
    host = next(iter(build_train_loader(cfg, records, DatasetMapper(cfg, True, np.random.RandomState(0)), 1)))
    arch, tcfg = GlassArch.from_config(cfg), TrainConfig.from_config(cfg)
    state = init_weights_(GlassRCNN(dataclasses.replace(arch, compute_dtype="float32")),
                          max(int(cfg.SEED), 0)).state_dict()
    runs = [("f32", "float32", False, False), ("f32 again", "float32", False, False),
            ("f32 remat", "float32", True, False), ("bf16", "bfloat16", False, False),
            (low, low, False, False), (f"{low} with K1b halved", low, False, True)]
    draws, out = RecordedDraws(11), {}
    with RecordedProposals() as props:
        for i, (name, dt, remat, halve) in enumerate(runs):
            model = GlassRCNN(dataclasses.replace(arch, compute_dtype=dt, remat_backbone=remat))
            model.load_state_dict(state)
            model = model.to(device).train()
            props.pos = 0
            with halved_k1b() if halve else contextlib.nullcontext():
                total, losses = glass_train_forward(model, tcfg, batch_to_device(host, device),
                                                    draws.for_device(device, replay=i > 0))
                total.backward()
            out[name] = dict(
                losses={k: float(v.detach()) for k, v in losses.items()},
                grads={n: p.grad.detach().float().cpu() for n, p in model.named_parameters()
                       if p.grad is not None},
                bn={k: v.detach().cpu() for k, v in model.state_dict().items() if "running_" in k})
            props.replay = True
            del model, total, losses
    ref = out.pop("f32")
    names = list(ref["grads"])

    def rel_l2(run):
        return {n: float((run["grads"][n] - ref["grads"][n]).norm() / max(float(ref["grads"][n].norm()), 1e-30))
                for n in names}

    # a gradient the card's two f32 steps disagree on beyond REMAT_GRAD_L2 is
    # rounding noise (a bias that a softmax cannot see)
    floor = rel_l2(out["f32 again"])
    noise = sorted(n for n, e in floor.items() if e > REMAT_GRAD_L2)
    held = [n for n in names if n not in noise]
    log(f"grads (c)/(d): {len(noise)} of {len(names)} gradients are rounding noise (f32 against f32 beyond "
        f"{REMAT_GRAD_L2}), held to finiteness alone: {[(n, round(floor[n], 3)) for n in noise]}")
    readings = {}
    for name, run in out.items():
        if set(run["grads"]) != set(names):
            raise AssertionError(f"grad check: {name} has another set of gradients")
        errs = rel_l2(run)
        finite = all(bool(torch.isfinite(g).all()) for g in run["grads"].values())
        worst = sorted(((n, errs[n]) for n in held), key=lambda kv: -kv[1])
        q = np.quantile([errs[n] for n in held], [0.5, 0.9])
        groups = {g: float(np.median([errs[n] for n in held if n.startswith(g)]))
                  for g in ("backbone.bottom_up.", "backbone.fpn", "proposal_generator.", "roi_heads.")}
        loss_rel = max(abs(v - ref["losses"][k]) / max(abs(ref["losses"][k]), 1e-6) for k, v in run["losses"].items())
        readings[name] = dict(median=float(q[0]), p90=float(q[1]), max=worst[0][1], groups=groups, finite=finite,
                              loss_rel=loss_rel, losses_equal=run["losses"] == ref["losses"],
                              bn_equal=all(torch.equal(v, ref["bn"][k]) for k, v in run["bn"].items()))
        log(f"grads (c)/(d) ({card_line() if device.type == 'cuda' else 'CPU'}): step 0, {name} against f32 "
            f"over {len(held)} gradients: rel L2 median {q[0]:.3g}, 90th percentile {q[1]:.3g}, max "
            f"{worst[0][1]:.3g} {[(n, round(e, 5)) for n, e in worst[:3]]}; medians by part "
            f"{ {g: round(v, 4) for g, v in groups.items()} }; finite {finite}; losses worst rel {loss_rel:.3g}, "
            f"bit-identical {readings[name]['losses_equal']}; BN statistics bit-identical {readings[name]['bn_equal']}")
    r, bf, lo, ctl = readings["f32 remat"], readings["bf16"], readings[low], readings[f"{low} with K1b halved"]
    failed = []
    if len(noise) > len(names) // 100:
        failed.append(f"{len(noise)} gradients differ between two f32 steps beyond {REMAT_GRAD_L2}")
    if not (r["losses_equal"] and r["bn_equal"] and r["max"] <= REMAT_GRAD_L2):
        failed.append(f"remat: losses equal {r['losses_equal']}, BN equal {r['bn_equal']}, max {r['max']:.3g}")
    # fp16 carries three more mantissa bits than bf16: its step may not lie
    # further from f32 than bf16's, gradient by gradient in the median
    if device.type == "cuda" and not (lo["finite"] and lo["median"] <= bf["median"]):
        failed.append(f"{low}: finite {lo['finite']}, median {lo['median']:.3g} beyond bf16's {bf['median']:.3g}")
    if device.type == "cuda" and ctl["median"] <= bf["median"]:
        failed.append(f"the control passes: median {ctl['median']:.3g}, bf16's {bf['median']:.3g}")
    if failed:
        raise AssertionError(f"grad check: {failed}")
    return readings


def _loop_syncs(trainer, device, loop_k) -> float:
    """Host syncs a step of one chunk of ``loop_k`` steps through
    ``make_parallel_train_scan`` (the loader's batches, the trainer's own
    step), read from ``set_sync_debug_mode``."""
    from glass_tpu_torch.parallel import mesh
    from glass_tpu_torch.train.train_step import Priorities, batch_to_device, train_step

    loader = iter(trainer.build_train_loader())
    batches = [batch_to_device(next(loader), device) for _ in range(loop_k)]
    scan = mesh.make_parallel_train_scan(train_step)
    its = list(range(loop_k))
    syncs, _ = count_syncs(lambda: scan(trainer.model, trainer.optimizer, trainer.tcfg, batches,
                                        [Priorities(0, i, device) for i in its], its), device)
    return syncs / loop_k


# ---------------------------------------------------------------------------
# phase 13: TPU.SERVE_BATCH_MODE="vmap", one batched program a batch
# ---------------------------------------------------------------------------

VMAP_BATCH = 4
# 13(b), vmap against map (the bounds PERF.md section 6 states for phase
# 13): detections an image may differ by this many (staged and
# end to end; a random model's top-k and NMS meet near-ties that rounding
# flips), at least this share of the staged detections, paired by box, lie
# within phase 5's staged tolerances (f32); bf16: the staged heads' mask
# probabilities within this, and at least this share of their rows read
# the same text
VMAP_VALID_DIFF = {"float32": 2, "bfloat16": 5}
VMAP_F32_DET_SHARE = 0.9
VMAP_BF16_MASK_ATOL = 0.15
VMAP_BF16_SAME_TEXT = 0.75
# f32 end to end (each mode's eval_batch_call on its own), of the
# detections paired by box: at least this share within E2E_BOX_ATOL px, and
# at least this share reading the same text
VMAP_F32_E2E_BOX_SHARE = 0.93
VMAP_F32_E2E_TEXT_SHARE = 0.85
VMAP_SERVE_BATCHES = (3, 4)  # 13(e): two replicas, one padding row at 3


def k2_batched_case(label, images, rois, sr, normalize, timed=True):
    """13(a): one launch of K2 over a batch against its plain twin (each
    image's plain crop), max |err| 0; timed like phase 3's cases."""
    from glass_tpu_torch.ops import crop as cr
    from glass_tpu_torch.ops.roi_align_rotated import adaptive_grid, fixed_grid

    b, h, w = images.shape[:3]
    out_hw = (128, 128)
    launch = lambda: cr.crop_rois_batched(images, rois, out_hw, sr, 2, normalize)  # noqa: E731
    got = launch()
    ref = cr.crop_rois_batched_plain(images, rois, out_hw, sr, 2, normalize)
    torch.cuda.synchronize()
    err = _max_err(got, ref)
    row = dict(input=f"{label} B={b}", sr=sr, err=err, tol=0.0)
    if timed:
        meta = torch.tensor([[1.0, h, w, 0.0]], device="cuda")
        levels = torch.zeros((rois.shape[1],), dtype=torch.int32, device="cuda")
        rows = samples = 0
        for r in rois:
            grid = fixed_grid(r.shape[0], sr, "cuda") if sr > 0 else adaptive_grid(r[:, 3], r[:, 2], out_hw, 2)
            samples += int((grid[:, 0] * grid[:, 1]).sum()) * out_hw[0] * out_hw[1]
            rows += touched_rows(meta, r, levels, grid, out_hw)
        nbytes = rows * 3 * images.element_size() + got.numel() * got.element_size() + rois.numel() * 4
        b_ms, b_by = bound(nbytes, samples * 3 * 8)
        row.update(ms=kernel_ms(launch), call_ms=time_ms(launch, 50),
                   plain_ms=time_ms(lambda: cr.crop_rois_batched_plain(images, rois, out_hw, sr, 2, normalize), 3, 1),
                   bound_ms=b_ms, bound_by=b_by)
        log(f"K2 batched {row['input']:18s} sr={sr} R={rois.shape[1]} an image max|err| {err:.3g} (tol 0) kernel "
            f"{row['ms']:.4f} ms (wrapper call {row['call_ms']:.4f} ms) plain {row['plain_ms']:.3f} ms bound "
            f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / row['ms']:.1f}% of it")
    else:
        log(f"K2 batched {row['input']:18s} sr={sr} R={rois.shape[1]} an image max|err| {err:.3g} (tol 0)")
    if err != 0:
        raise AssertionError(f"K2 batched {label} sr={sr}: max|err| {err} against the plain twin")
    return row, got


def phase13_k2(rng):
    """13(a): K2 over B = 4 distinct images in one launch against its plain
    twin: uint8 with the fold, f32, bf16 and fp16 at sampling ratio 1, bf16
    at 2 and 0, and an image-edge case (B = 2, one roi each); the bf16 case
    also equals four one-image launches; grid_sample over the batch in
    bf16 as the yardstick."""
    from glass_tpu_torch.ops import crop as cr

    h, w = BUCKET_HW
    rois = torch.from_numpy(np.stack([word_rois(rng, N_ROIS, h, w) for _ in range(VMAP_BATCH)])).cuda()
    raw = torch.from_numpy(rng.randint(0, 256, (VMAP_BATCH, h, w, 3)).astype(np.uint8)).cuda()
    mean = torch.tensor([103.53, 116.28, 123.675], device="cuda")
    std = torch.tensor([57.375, 57.12, 58.395], device="cuda")
    norm32 = (raw.float() - mean) / std
    cases = (("uint8+fold", raw, (mean, std), (1,)), ("float32", norm32, None, (1,)),
             ("bfloat16", norm32.to(torch.bfloat16), None, (1, 2, 0)),
             ("float16", norm32.to(torch.float16), None, (1,)))
    rows = []
    for label, images, normalize, srs in cases:
        for sr in srs:
            row, got = k2_batched_case(label, images, rois, sr, normalize)
            rows.append(row)
            if label == "bfloat16" and sr == 1:
                one = [cr.crop_rois(images[i], rois[i], (128, 128), 1, 2) for i in range(VMAP_BATCH)]
                if not all(torch.equal(got[i], o) for i, o in enumerate(one)):
                    raise AssertionError("K2 batched bf16: differs from one-image launches")
                log("K2 batched bf16 sr=1: equal bit for bit to four one-image launches")
    rows.append(k2_batched_case("bfloat16 edge", norm32[:2].to(torch.bfloat16), rois[:2, :1], 0, None,
                                timed=False)[0])
    lib_ms = k2_yardstick(norm32.to(torch.bfloat16), rois)
    main = next(r for r in rows if r["input"] == f"bfloat16 B={VMAP_BATCH}" and r["sr"] == 1)
    main["library_ms"] = lib_ms
    log(f"phase 13 (a) K2 over {VMAP_BATCH} images, bf16 sr 1: {main['ms']:.4f} ms, bound {main['bound_ms']:.4f} ms "
        f"({100 * main['bound_ms'] / main['ms']:.1f}%), plain {main['plain_ms']:.3f} ms, grid_sample "
        f"{lib_ms:.4f} ms ({card_line()})")
    return rows


class RawPredictions:
    """Records the raw instances (every valid row, before post-processing)
    of each batch a runner's ``collect_batch`` returns."""

    def __init__(self, runner):
        self.runner, self.images = runner, []

    def __enter__(self):
        collect = self.runner.collect_batch

        def recorded(dispatched, rid=None):
            out = collect(dispatched, rid)
            self.images.extend(out)
            return out

        self.runner.collect_batch = recorded
        return self

    def __exit__(self, *exc):
        del self.runner.collect_batch


def _break_rule(probs, eos=0):
    """The steps an image's greedy decoder zeroes: every step after the
    first at whose end each of the image's rows has emitted eos.  probs
    (D, steps, V) -> (D, steps) bool."""
    done = np.cumsum(probs.argmax(-1) == eos, axis=1) > 0
    broke = np.cumsum(np.all(done, axis=0)) > 0
    return np.broadcast_to(np.concatenate([[False], broke[:-1]]), done.shape)


def forced_break(model, feats, norm, boxes, raw_images=None):
    """13(b): ``recognize_batch`` with its decoder's inputs made to call
    for a break in image 0 alone, on a copy of ``model``, as
    tests/test_torch_vmap_serving.py::test_decoder_breaks_per_image makes
    them: the GRU's candidate state follows the attention context alone
    and the eos logit is the state's projection on a sign vector u, and
    the encoder states are u (+ noise) on image 0's rows and -u on the
    others', so that every row of image 0 emits eos at the first step and
    no other row ever does.  A break per image zeroes image 0's later
    steps and none of the others'; one break over the batch zeroes none.
    Returns a failure, or None."""
    from glass_tpu_torch.models import glass_rcnn as gr

    forced = copy.deepcopy(model)
    head = forced.roi_heads.recognizer_head
    unit = head.aster
    c, y = unit.gru.hidden_size, unit.tgt_embedding.weight.shape[1]
    b, d = boxes.shape[:2]
    gen = torch.Generator().manual_seed(5)
    u = torch.where(torch.rand(c, generator=gen) < 0.5, -1.0, 1.0)
    with torch.no_grad():
        for p in (unit.gru.weight_ih_l0, unit.gru.weight_hh_l0, unit.gru.bias_ih_l0, unit.gru.bias_hh_l0,
                  unit.fc.weight):
            p.zero_()
        unit.gru.weight_ih_l0[2 * c:, y:] = 10.0 * torch.eye(c)
        unit.fc.weight[0] = 0.1 * u
        unit.fc.bias.copy_(0.1 * torch.randn(unit.fc.bias.shape, generator=gen))
    sign = torch.full((b,), -1.0)
    sign[0] = 1.0
    steps_in = 32  # the encoder's steps
    enc = sign[:, None, None, None] * u + 0.01 * torch.randn((b, d, steps_in, c), generator=gen)
    enc = enc.reshape(b * d, steps_in, c).to(boxes.device)
    head.encode = lambda x: enc.to(x.dtype)
    probs = gr.recognize_batch(forced, feats, norm, boxes, raw_images).float().cpu().numpy()
    zero = probs.max(-1) == 0
    want = np.zeros_like(zero)
    want[0, :, 1:] = True
    if not np.array_equal(zero, want) or not all(np.array_equal(zero[i], _break_rule(probs[i])) for i in range(b)):
        return (f"decoder with a break forced in image 0: zeroed steps per image "
                f"{[int(z.sum()) for z in zero]}, expected {[int(w.sum()) for w in want]}")
    return None


def _text_agreement(boxes_a, valid_a, ids_a, boxes_b, valid_b, ids_b):
    """Per image, a's valid detections paired by box with b's: (pairs,
    pairs within E2E_BOX_ATOL px, pairs reading the same ids at every
    step), summed over the images.  Each argument is indexed by image."""
    pairs = near = same = 0
    for ba, va, ia, bb, vb, ib in zip(boxes_a, valid_a, ids_a, boxes_b, valid_b, ids_b):
        k = int(min(va.sum(), vb.sum()))
        if not k:
            continue
        a, b = ba[va][:k], bb[vb]
        pair = _pair_rows(a, b)
        near += int((_box_dist(a, b[pair]) <= E2E_BOX_ATOL).sum())
        same += int(np.all(ia[va][:k] == ib[vb][pair], axis=-1).sum())
        pairs += k
    return pairs, near, same


def staged_modes(runner, images, f32):
    """13(b), staged: each stage of the batched program fed the map path's
    own inputs to that stage, against the one-image stage, on one batch:
    ``detect_batch`` on the per-image FPN maps stacked against
    ``detect_single_image`` (the detections paired by box), then the
    recognizer and the mask head over the batch on the per-image
    detections against ``recognize_single_image`` and
    ``mask_single_image``.  What differs is the batched arithmetic alone
    (the RPN head's convolutions over the batch, the heads' over B * D
    rows).  f32 is held to phase 5's staged tolerances: the heads on the
    same boxes within 1e-3 (text and mask probabilities) with text ids
    equal before a knife edge; of the detections, paired by box, at least
    VMAP_F32_DET_SHARE within 0.05 px + 1e-4 relative and 1e-3 in score,
    and the counts within VMAP_VALID_DIFF: a random model's RPN top-k and
    NMS meet near-ties that the batch's rounding may flip, and a flipped
    pick is another box (at the decode clamp, thousands of pixels away).
    bf16 is held to VMAP_VALID_DIFF and VMAP_BF16_*.

    The decoder's break, in both dtypes: the steps the batched decoder
    zeroes are exactly those its own ids call for under a break per image
    (``_break_rule``); in f32 they are also exactly the one-image
    decoder's, unless a knife edge (a step of the one-image decoder whose
    top two lie within KNIFE_EDGE) comes before the one-image break.

    The witness (reported): the one-image stages run on the batch's own
    backbone features, which differ from the per-image ones by the batch's
    rounding (reported as max |diff| / max |map| over the FPN levels).
    Paired by box, the same text is counted between vmap's stages on the
    batch's features and map, the witness and map, and vmap and the
    witness: if the witness parts from map as vmap does, the parting is
    the backbone's rounding, not the batched stages.  Returns (failures,
    summary)."""
    from glass_tpu_torch.models import glass_rcnn as gr

    model = runner.model
    dev = next(model.parameters()).device
    sizes = [im.shape[:2] for im in images]
    bucket = tuple(max(v) for v in zip(*(runner._pick_bucket(*sz) for sz in sizes)))
    padded = torch.zeros((len(images),) + bucket + (3,), dtype=torch.uint8)
    for i, im in enumerate(images):
        padded[i, :im.shape[0], :im.shape[1]] = torch.from_numpy(im)
    padded = padded.to(dev)
    raw = f32  # the eval path's uint8 upload crops the raw image under f32 compute
    size_t = torch.tensor(sizes, dtype=torch.float32, device=dev)

    def one_image_stages(feats_of):
        dets, probs, masks = [], [], []
        for i, hw in enumerate(sizes):
            f = feats_of(i)
            pyr = gr.pack_box_pyramid(model, f)
            d = gr.detect_single_image(model, f, pyr, hw)
            dets.append(d)
            probs.append(gr.recognize_single_image(model, f, norms[i], d.boxes, padded[i] if raw else None))
            masks.append(gr.mask_single_image(model, pyr, d.boxes, d.classes))
        return dets, probs, masks

    with torch.inference_mode():
        norms = [gr.preprocess(model, padded[i]) for i in range(len(images))]
        feats1 = [gr.backbone_features(model, n) for n in norms]
        det1, probs1, masks1 = one_image_stages(lambda i: feats1[i])
        norm = torch.stack(norms)
        own = gr.backbone_features(model, norm)
        feats = {k: torch.cat([f[k] for f in feats1]) for k in own}
        feat_rel = max(float((own[k] - feats[k]).abs().max() / feats[k].abs().max()) for k in own)
        pyr = gr.pack_box_pyramid(model, feats)
        detb = gr.detect_batch(model, feats, pyr, size_t)
        boxes = torch.stack([d.boxes for d in det1])
        probsb = gr.recognize_batch(model, feats, norm, boxes, padded if raw else None).cpu().numpy()
        masksb = gr.mask_batch(model, pyr, boxes, torch.stack([d.classes for d in det1])).cpu().numpy()
        # the witness, and vmap's stages on the batch's own features
        detw, probsw, _ = one_image_stages(lambda i: {k: v[i:i + 1] for k, v in own.items()})
        detv = gr.detect_batch(model, own, gr.pack_box_pyramid(model, own), size_t)
        probsv = gr.recognize_batch(model, own, norm, detv.boxes, padded if raw else None).cpu().numpy()
        forced = forced_break(model, feats, norm, boxes, padded if raw else None)
    failed, counts, box_d, score_d, same, rows = [forced] if forced else [], [], [0.0], [0.0], 0, 0
    prob_d, mask_d, close, paired, excused, broke = [0.0], [0.0], 0, 0, [], collections.Counter()
    for i, d in enumerate(det1):
        v1, vb = d.valid.cpu().numpy(), detb.valid[i].cpu().numpy()
        counts.append((int(v1.sum()), int(vb.sum())))
        if abs(int(v1.sum()) - int(vb.sum())) > VMAP_VALID_DIFF["float32" if f32 else "bfloat16"]:
            failed.append(f"image {i}: {counts[-1]} detections (map, vmap)")
        k = int(min(v1.sum(), vb.sum()))
        if k:
            a, b = detb.boxes[i].cpu().numpy()[vb][:k], d.boxes.cpu().numpy()[v1]
            pair = _pair_rows(a, b)
            dist = _box_dist(a, b[pair])
            sd = np.abs(detb.scores[i].cpu().numpy()[vb][:k] - d.scores.cpu().numpy()[v1][pair])
            ok = (dist <= BOX_ATOL + BOX_RTOL * np.abs(b[pair][:, :4]).max(-1)) & (sd <= SCORE_ATOL)
            close += int(ok.sum())
            paired += k
            box_d.append(float(np.median(dist)))
            score_d.append(float(np.median(sd)))
        # the heads on the same boxes, every row
        p1, pb = probs1[i].cpu().numpy(), probsb[i]
        zero1, zerob = p1.max(-1) == 0, pb.max(-1) == 0
        for name, p, z in (("vmap", pb, zerob), ("map", p1, zero1), ("vmap on its own features", probsv[i],
                                                                      probsv[i].max(-1) == 0)):
            if not np.array_equal(z, _break_rule(p)):
                failed.append(f"image {i}: the {name} decoder's zeroed steps are not those of a break per image")
            broke[name] += int(z.any())
        top2 = np.sort(p1, -1)[..., -2:]
        edge = (top2[..., 1] - top2[..., 0] < KNIFE_EDGE) & ~zero1
        steps = ~np.cumsum(edge, axis=1).astype(bool)
        prob_d.append(float(np.abs(pb - p1)[steps].max()))
        mask_d.append(float(np.abs(masksb[i] - masks1[i].cpu().numpy()).max()))
        row_same = np.all(pb.argmax(-1) == p1.argmax(-1), axis=-1)
        same += int(row_same.sum())
        rows += len(row_same)
        if f32:
            ids_ok = bool((pb.argmax(-1)[steps] == p1.argmax(-1)[steps]).all())
            if not np.array_equal(zerob, zero1):
                first_break = int(np.argmax(zero1[0])) if zero1.any() else zero1.shape[1]
                if edge[:, :first_break].any():
                    excused.append(i)
                else:
                    failed.append(f"image {i}: the batched decoder zeroes other steps than the one-image one")
            if prob_d[-1] > PROB_ATOL or mask_d[-1] > PROB_ATOL or not ids_ok:
                failed.append(f"image {i}: text probs {prob_d[-1]:.3g}, masks {mask_d[-1]:.3g}, ids before a "
                              f"knife edge equal {ids_ok}")
        elif mask_d[-1] > VMAP_BF16_MASK_ATOL:
            failed.append(f"image {i}: masks {mask_d[-1]:.3g}")
    share = same / max(rows, 1)
    det_share = close / max(paired, 1)
    if f32 and det_share < VMAP_F32_DET_SHARE:
        failed.append(f"{det_share:.3f} of paired detections within the tolerances (bound {VMAP_F32_DET_SHARE})")
    if not f32 and share < VMAP_BF16_SAME_TEXT:
        failed.append(f"{share:.3f} of rows read the same text (bound {VMAP_BF16_SAME_TEXT})")

    def sets(dets, probs):
        return ([t.boxes.cpu().numpy() for t in dets], [t.valid.cpu().numpy() for t in dets],
                [np.asarray(p.cpu().numpy() if torch.is_tensor(p) else p).argmax(-1) for p in probs])

    m = sets(det1, probs1)
    w = sets(detw, probsw)
    v = sets([gr.Detections(*(t[i] for t in detv)) for i in range(len(sizes))], list(probsv))
    witness = {}
    for name, (a, b) in (("vmap~map", (v, m)), ("witness~map", (w, m)), ("vmap~witness", (v, w))):
        n, _, t = _text_agreement(*a, *b)
        witness[name] = t / max(n, 1)
    summary = (f"staged on one batch: the batch's backbone against the per-image ones {feat_rel:.3g} (reported); "
               f"detections (map, vmap) {counts}, of {paired} paired {det_share:.3f} within 0.05 px + 1e-4 rel and "
               f"1e-3 in score (median box diff {max(box_d):.3g}, score diff {max(score_d):.3g} at most an image); "
               f"heads on the same {rows} rows: text probabilities {max(prob_d):.3g} before a knife edge, masks "
               f"{max(mask_d):.3g}, same text on {share:.3f} of rows; the decoder breaks per image in both modes "
               f"(images whose decoder broke before its last step: {dict(broke)} of {len(sizes)}; with a break "
               f"forced in image 0 alone: {'as a break per image' if not forced else 'FAILED'})"
               + (f", equal to map's except images {excused} (a knife edge before map's break)" if f32 else "")
               + "; witness (map's one-image stages on the batch's backbone features), same text of paired "
               + ", ".join(f"{k} {x:.3f}" for k, x in witness.items()))
    return failed, summary


def end_to_end_modes(raw_map, raw_vmap):
    """13(b), end to end: each mode's eval_batch_call on its own, the raw
    detections of each image paired by box.  A random model's top-k, NMS
    and near-flat character distributions turn the rounding of the
    batch's convolutions into other picks, so beyond the detection counts
    (VMAP_VALID_DIFF) f32 holds shares (VMAP_F32_E2E_*) and bf16 is
    reported (``staged_modes`` holds the arithmetic).  Returns the counts,
    the share of pairs within E2E_BOX_ATOL px, the share reading the same
    text, and a summary."""
    counts = [(len(m), len(v)) for m, v in zip(raw_map, raw_vmap)]

    def fields(images):
        boxes = [np.asarray(p.pred_boxes) for p in images]
        ids = "pred_text_ids" if images[0].has("pred_text_ids") else "pred_text_prob"
        texts = [np.asarray(p.get(ids)) for p in images]
        if ids == "pred_text_prob":
            texts = [t.argmax(-1) for t in texts]
        return boxes, [np.ones(len(b), bool) for b in boxes], texts

    pairs, near, same = _text_agreement(*fields(raw_vmap), *fields(raw_map))
    box_share, text_share = near / max(pairs, 1), same / max(pairs, 1)
    text = (f"end to end: detections (map, vmap) per image {counts}; of {pairs} paired rows, boxes within "
            f"{E2E_BOX_ATOL} px on {box_share:.3f}, the same text on {text_share:.3f}")
    return counts, box_share, text_share, text


# 13(b), the bf16 parting (the rule of PERF.md section 6): the batched bf16
# distance from the f32 yardstick is rounding when it is at most this many
# times the per-image bf16 distance, at every FPN level and in every head
PARTING_RATIO = 1.5


def _rel_dist(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref|, in f32."""
    ref = ref.float()
    return float((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def witness_program(model, imgs, hws) -> dict:
    """The witness as a serving program: the batch's one backbone call,
    then map's one-image stages on each image's slice of its features."""
    from glass_tpu_torch.models import glass_rcnn as gr

    norm = gr.preprocess(model, imgs)
    feats = gr.backbone_features(model, norm)
    raw = imgs.dtype == torch.uint8 and model.arch.torch_dtype == torch.float32
    outs = []
    for i in range(imgs.shape[0]):
        f = {k: v[i:i + 1] for k, v in feats.items()}
        pyr = gr.pack_box_pyramid(model, f)
        out = dict(gr.detect_batch(model, f, pyr, (int(hws[i][0]), int(hws[i][1])))._asdict())
        out.update(gr.glass_heads_batch(model, f, norm[i:i + 1], pyr, out["boxes"], out["classes"],
                                        imgs[i:i + 1] if raw else None))
        outs.append({k: v[0] for k, v in out.items()})
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def parting_distances(m32, m16, padded, sizes) -> dict:
    """13(b), Part 0: bf16 against the f32 yardstick (per-image calls, TF32
    off), batched (B = 4) and per image (B = 1), as max |diff| / max |f32|:
    each FPN level of the backbone on the batch's images, then the heads on
    identical rows (the yardstick's features cast to bf16, the yardstick's
    proposals and detections): the box head and predictor over the
    proposals, the recognizer's encoder states over the detections, and its
    decoder's character probabilities teacher-forced on the yardstick's
    greedy ids.  Returns {name: (batched, per image)}."""
    from glass_tpu_torch.models import glass_rcnn as gr
    from glass_tpu_torch.models.recognizer import aster_decode_greedy, aster_decode_train
    from glass_tpu_torch.ops.roi_align_rotated import multilevel_pool

    b = padded.shape[0]
    out = {}
    with torch.inference_mode():
        n32 = [gr.preprocess(m32, padded[i]) for i in range(b)]
        f32 = [gr.backbone_features(m32, n) for n in n32]
        n16 = gr.preprocess(m16, padded)
        fb = gr.backbone_features(m16, n16)
        f1 = [gr.backbone_features(m16, n16[i]) for i in range(b)]
        for k in fb:
            ref = torch.cat([f[k] for f in f32])
            out[k] = (_rel_dist(fb[k], ref), _rel_dist(torch.cat([f[k] for f in f1]), ref))

        feats32 = {k: torch.cat([f[k] for f in f32]) for k in fb}
        feats16 = {k: v.to(torch.bfloat16) for k, v in feats32.items()}
        props = torch.stack([gr.rpn_proposals_single(m32, f32[i], sizes[i])[0] for i in range(b)])
        p = props.shape[1]
        arch = m32.arch

        def pooled(model, feats):
            return multilevel_pool(
                gr.pack_box_pyramid(model, feats), gr._min_level(model), props.reshape(-1, 5),
                (arch.box_pooler_resolution,) * 2, arch.box_pooler_sampling_ratio, arch.pool_max_sampling_ratio,
                arch.pool_bulk_sampling_ratio, arch.pool_large_roi_budget, rois_per_image=p)

        def box_head(model, x):
            rh = model.roi_heads
            return torch.cat([t for t in rh.box_predictor(rh.box_head(x).to(torch.float32)) if t is not None], -1)

        x32, x16 = pooled(m32, feats32), pooled(m16, feats16)
        ref = torch.cat([box_head(m32, x32[i * p:(i + 1) * p]) for i in range(b)])
        out["box head"] = (_rel_dist(box_head(m16, x16), ref),
                           _rel_dist(torch.cat([box_head(m16, x16[i * p:(i + 1) * p]) for i in range(b)]), ref))

        boxes = torch.stack([gr.detect_single_image(m32, f32[i], gr.pack_box_pyramid(m32, f32[i]), sizes[i]).boxes
                             for i in range(b)])
        d = boxes.shape[1]
        enc32 = torch.cat([gr.recognizer_encode(m32, f32[i], n32[i], boxes[i]) for i in range(b)])
        encb = gr.recognizer_encode_batch(m16, feats16, n16, boxes)
        enc1 = torch.cat([gr.recognizer_encode(m16, {k: v[i:i + 1] for k, v in feats16.items()}, n16[i], boxes[i])
                          for i in range(b)])
        out["recognizer encoder"] = (_rel_dist(encb, enc32), _rel_dist(enc1, enc32))

        steps = arch.max_word_len + 1
        aster32, aster16 = m32.roi_heads.recognizer_head.aster, m16.roi_heads.recognizer_head.aster
        rows = [slice(i * d, (i + 1) * d) for i in range(b)]
        ids = torch.cat([aster_decode_greedy(aster32, enc32[r].float(), steps).argmax(-1) for r in rows])
        targets = torch.cat([torch.zeros_like(ids[:, :1]), ids], 1)  # step i feeds step i - 1's id

        def text(aster, enc, r):
            return torch.softmax(aster_decode_train(aster, enc.float(), targets[r], steps), -1)

        ref = torch.cat([text(aster32, enc32[r], r) for r in rows])
        per = torch.cat([text(aster16, enc1[r], r) for r in rows])
        out["recognizer decoder"] = (_rel_dist(text(aster16, encb, slice(None)), ref), _rel_dist(per, ref))
    return out


def bf16_parting(r32, r16, images, batch, device, served=None) -> tuple:
    """13(b), Part 0: the bf16 parting of vmap from map, held to the rule
    PERF.md states (PARTING_RATIO), with cuBLAS's reduced-precision bf16
    reduction allowed (PyTorch's default) and then, in the same call, not
    allowed (the control).  Each setting: ``parting_distances`` on the
    batch, and the host merge's (rows in, rounds) on each serving program's
    predictions over every scene (map, vmap, and the witness: map's
    one-image stages on the batch's backbone features); ``served`` gives
    map's and vmap's under the default setting when they were counted
    already.  Returns (lines, {setting: rounding by the rule})."""
    sizes = [im.shape[:2] for im in batch]
    bucket = tuple(max(v) for v in zip(*(r16._pick_bucket(*sz) for sz in sizes)))
    padded = torch.zeros((len(batch),) + bucket + (3,), dtype=torch.uint8)
    for i, im in enumerate(batch):
        padded[i, :im.shape[0], :im.shape[1]] = torch.from_numpy(im)
    padded = padded.to(device)
    matmul = torch.backends.cuda.matmul
    default = matmul.allow_bf16_reduced_precision_reduction
    lines, verdicts = [], {}
    try:
        for allowed in (default, not default):
            matmul.allow_bf16_reduced_precision_reduction = allowed
            dist = parting_distances(r32.model, r16.model, padded, sizes)
            rounds = dict(served or {}) if allowed == default else {}
            for name in [n for n in ("map", "vmap", "witness") if n not in rounds]:
                r16.cfg.TPU.SERVE_BATCH_MODE = "map" if name == "witness" else name
                if name == "witness":
                    r16.batch_model_fn = lambda: (lambda imgs, hws: witness_program(r16.model, imgs, hws))
                try:
                    with MergeCount() as merge:
                        r16.eval_batch_call(images, batch_size=VMAP_BATCH)
                finally:
                    r16.__dict__.pop("batch_model_fn", None)
                rounds[name] = (merge.rows_in, merge.rounds)
            verdicts[allowed] = all(bt <= PARTING_RATIO * pi for bt, pi in dist.values())
            lines.append(
                f"allow_bf16_reduced_precision_reduction={allowed}: bf16 against the f32 per-image yardstick, "
                "max|diff|/max|f32| batched (B = 4) / per image (B = 1): "
                + "; ".join(f"{k} {bt:.3g} / {pi:.3g} ({bt / max(pi, 1e-30):.2f}x)" for k, (bt, pi) in dist.items())
                + "; host merge (rows in, merging rounds) over the " + f"{len(images)} scenes: "
                + ", ".join(f"{k} {v}" for k, v in rounds.items())
                + f" -> {'rounding' if verdicts[allowed] else 'NOT within'} {PARTING_RATIO}x at every level and head")
    finally:
        matmul.allow_bf16_reduced_precision_reduction = default
    return lines, verdicts


def phase_vmap(state_dict, out_dir, device="cuda", n_images=N_IMAGES, hw=(720, 1280), opts=()):
    """Phase 13 (b)-(e) on phase 6's eval set (written into ``--out``)."""
    device = torch.device(device)
    root = os.path.join(out_dir, "vmap")
    try:
        return _phase_vmap(state_dict, root, device, n_images, hw, opts)
    finally:  # the images are large
        import shutil

        shutil.rmtree(os.path.join(root, "ds"), ignore_errors=True)


def _phase_vmap(state_dict, root, device, n_images, hw, opts):
    import cv2

    from glass_tpu_torch.inference import GlassRunner
    from glass_tpu_torch.inference.runner import shortest_edge_size
    from glass_tpu_torch.ops import _cuda

    write_eval_set(root, n_images, hw)
    images = [cv2.imread(os.path.join(root, "ds", "synth_test", f"img_{i}.png")) for i in range(n_images)]
    cuda = device.type == "cuda"
    card = card_line() if cuda else "CPU"
    launches, failed, out = collections.Counter(), [], {}

    def runner(dtype, *extra, **kw):
        cfg = eval_cfg(dtype, opts=[*LOOSE_OPTS, *opts, *extra])
        return GlassRunner(cfg=cfg, state_dict=state_dict, device=device, **kw)

    def serve(r, mode, imgs):
        """eval_batch_call at batch 4 in ``mode``: predictions, raw rows, s
        and the stage split (model, fetch, host)."""
        r.cfg.TPU.SERVE_BATCH_MODE = mode
        _cuda.LAUNCHES.clear()
        with StageClock() as clock, RawPredictions(r) as raw:
            t0 = time.perf_counter()
            preds = r.eval_batch_call(imgs, batch_size=VMAP_BATCH)
            if cuda:
                torch.cuda.synchronize()
            took = time.perf_counter() - t0
        launches.update(_cuda.LAUNCHES)
        return preds, raw.images, took, dict(clock.ms)

    # (b) staged on one batch (the eval path's resize); (b) end to end and
    # (d): a warm-up batch of each mode's model program, then each mode's
    # eval_batch_call over the 8 scenes.
    # f32 and bf16: in f32 the two modes' predictions agree, so the host
    # stages cost the same; in bf16 they part (a random model), and the
    # host merge's cost follows the predictions.
    rate, runners = {}, {}
    for dtype in ("float32", "bfloat16"):
        f32 = dtype == "float32"
        r = runners[dtype] = runner(dtype, *(["TPU.TEXT_EMIT", "probs"] if f32 else []))
        sizes = [shortest_edge_size(*im.shape[:2], r.min_target_size, r.max_target_size) for im in images]
        batch = [cv2.resize(im, (nw, nh)) for im, (nh, nw) in zip(images[:VMAP_BATCH], sizes)]
        bad, staged = staged_modes(r, batch, f32=f32)
        for mode in ("map", "vmap"):  # warm-up: the model program alone; the host stages need none
            r.cfg.TPU.SERVE_BATCH_MODE = mode
            r.run_batch_on_resized(batch)
        raw, timed, merged = {}, {}, {}
        for mode in ("map", "vmap"):
            with MergeCount() as merge:
                preds, raw[mode], took, split = serve(r, mode, images)
            merged[mode] = (merge.rows_in, merge.rounds)
            lengths = [len(t) for p in preds if len(p) for t in r.decode_texts(p)[0]]
            timed[mode] = (n_images / took, split, [len(p) for p in preds],
                           f"raw rows {[len(p) for p in raw[mode]]}, mean word length "
                           f"{np.mean(lengths) if lengths else 0.0:.2f}; {merge.summary()}")
        rate[dtype] = {mode: t[0] for mode, t in timed.items()}
        counts, box_share, text_share, e2e = end_to_end_modes(raw["map"], raw["vmap"])
        if any(abs(a - b) > VMAP_VALID_DIFF[dtype] for a, b in counts):
            bad.append(f"end-to-end detections (map, vmap) {counts}")
        if f32 and (box_share < VMAP_F32_E2E_BOX_SHARE or text_share < VMAP_F32_E2E_TEXT_SHARE):
            bad.append(f"end to end, boxes within {E2E_BOX_ATOL} px on {box_share:.3f} (bound "
                       f"{VMAP_F32_E2E_BOX_SHARE}), the same text on {text_share:.3f} (bound {VMAP_F32_E2E_TEXT_SHARE})")
        failed += [f"(b) {dtype} {b}" for b in bad]
        bounds = (f"detections within {VMAP_VALID_DIFF[dtype]}, " + (
            f"{VMAP_F32_DET_SHARE} of the staged ones within tolerance, end to end {VMAP_F32_E2E_BOX_SHARE} of "
            f"the pairs' boxes and {VMAP_F32_E2E_TEXT_SHARE} of their texts" if f32 else
            f"masks {VMAP_BF16_MASK_ATOL}, same text on {VMAP_BF16_SAME_TEXT} of the staged rows"))
        log(f"phase 13 (b) {dtype} ({card}), vmap against map: {staged}; {e2e} (bounds: {bounds}) -> "
            f"{'ok' if not bad else 'FAILED ' + str(bad)}")
        for mode, (img_s, split, words, merge) in timed.items():
            log(f"phase 13 (d) {dtype} {mode} ({card}): eval_batch_call over {n_images} scenes at batch "
                f"{VMAP_BATCH}: {img_s:.3f} img/s; " + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items())
                + f"; words {words}; {merge}")
    r16 = r
    t0 = time.perf_counter()
    lines, verdicts = bf16_parting(runners["float32"], r16, images, batch, device, served=merged)
    for line in lines:
        log(f"phase 13 (b) bf16 parting ({card}), {line}")
    log(f"phase 13 (b) bf16 parting: {time.perf_counter() - t0:.1f} s")
    failed += [f"(b) bf16 parting with allow_bf16_reduced_precision_reduction={k}: batched beyond "
               f"{PARTING_RATIO}x the per-image distance" for k, ok in verdicts.items() if not ok]
    del runners

    # (c) launches and host syncs of one batch, (d) the device share
    for mode in ("map", "vmap"):
        r16.cfg.TPU.SERVE_BATCH_MODE = mode
        _cuda.LAUNCHES.clear()
        r16.run_batch_on_resized(batch)
        got = dict(_cuda.LAUNCHES)
        launches.update(got)
        per = 1 if mode == "vmap" else VMAP_BATCH
        want = {"roi_align_rotated": 3 * per, "crop_rois": per}
        peak = float("nan")
        if cuda:  # above what is allocated when the batch starts (earlier phases' runners included)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            r16.run_batch_on_resized(batch)
            peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        syncs, where = count_syncs(lambda: r16.run_batch_on_resized(batch), device)
        wall_ms = dev_ms = float("nan")
        if cuda:
            wall_ms, dev_ms = profile_model(None, None, root, call=lambda: r16.run_batch_on_resized(batch),
                                            name=f"profile_{mode}_batch.txt")
        out[mode] = dict(img_s=rate["bfloat16"][mode], img_s_f32=rate["float32"][mode], launches=got, syncs=syncs,
                         model_ms=wall_ms, device_ms=dev_ms, peak_mib=peak)
        log(f"phase 13 (c) {mode} ({card}): one batch of {VMAP_BATCH}: peak memory {peak:.0f} MiB above the start (bf16, "
            f"run_batch_on_resized); launches {got}, host syncs {syncs} "
            f"({syncs / VMAP_BATCH:.2f} an image; most from {where}); one profiled batch (run_batch_on_resized) "
            f"{wall_ms:.1f} ms wall, device busy {dev_ms:.1f} ms = {100 * dev_ms / wall_ms:.1f}%")
        if cuda and got != want:
            failed.append(f"(c) {mode} launches {got}, expected {want}")

    # (e) two replicas on the one device under vmap: each replica's rows
    # equal one replica's vmap program on the same rows, bit for bit
    two = runner("bfloat16", "TPU.SERVE_DATA_PARALLEL", "True", "TPU.SERVE_BATCH_MODE", "vmap",
                 serve_devices=[device, device])
    if len(two.replicas) != 2:
        raise AssertionError(f"13 (e): {len(two.replicas)} replicas, asked 2")
    r16.cfg.TPU.SERVE_BATCH_MODE = "vmap"
    program = r16.batch_model_fn()
    resized = [im.astype(np.float32) for im in batch]
    _cuda.LAUNCHES.clear()
    dp = {b: finish_fetch_dispatch(two, resized[:b]) for b in VMAP_SERVE_BATCHES}
    got = dict(_cuda.LAUNCHES)
    launches.update(got)
    diffs = {}
    bucket = tuple(max(v) for v in zip(*(r16._pick_bucket(*sz) for sz in sizes[:VMAP_BATCH])))
    for b, fields in dp.items():
        padded = torch.zeros((2 * -(-b // 2),) + bucket + (3,), dtype=torch.float32, device=device)
        hws = np.ones((padded.shape[0], 2), np.int32)
        for i, im in enumerate(resized[:b]):
            padded[i, :im.shape[0], :im.shape[1]] = torch.from_numpy(im).to(device)
            hws[i] = im.shape[:2]
        k = padded.shape[0] // 2
        with torch.inference_mode():
            halves = [program(padded[s:s + k], hws[s:s + k]) for s in (0, k)]
        want = {key: torch.cat([h[key] for h in halves])[:b].cpu().numpy() for key in halves[0]}
        diffs[b] = [key for key in fields if not np.array_equal(fields[key], want[key])]
    rows = sum(2 * -(-b // 2) for b in VMAP_SERVE_BATCHES)
    log(f"phase 13 (e) ({card}): SERVE_DATA_PARALLEL under vmap, two replicas on the one device at b = "
        f"{list(VMAP_SERVE_BATCHES)}: fields differing from one replica's vmap program on the same rows {diffs}; "
        f"launches {got} over {len(VMAP_SERVE_BATCHES)} batches ({rows} rows, padding included)")
    if any(diffs.values()):
        failed.append(f"(e) data-parallel vmap differs: {diffs}")
    want = {"roi_align_rotated": 3 * 2 * len(VMAP_SERVE_BATCHES), "crop_rois": 2 * len(VMAP_SERVE_BATCHES)}
    if cuda and got != want:
        failed.append(f"(e) launches {got}, expected {want}")
    log(f"phase 13 ({card}): eval_batch_call at batch {VMAP_BATCH}, img/s map / vmap: bf16 "
        f"{rate['bfloat16']['map']:.3f} / {rate['bfloat16']['vmap']:.3f}, f32 {rate['float32']['map']:.3f} / "
        f"{rate['float32']['vmap']:.3f}; host syncs a batch map {out['map']['syncs']}, vmap {out['vmap']['syncs']}")
    if failed:
        raise AssertionError(f"phase 13: {failed}")
    out["launches"] = dict(launches)
    return out


# 15: the released-checkpoint verification entry point
VERIFY_RUNS = (  # (run, --expected-hmean, exit code, pass): (a) records, (b) passes, (c) fails
    ("a", None, 0, True),
    ("b", "1.0", 0, True),
    ("c", "0.5", 1, False),
)


def phase_verify(state_dict, out_dir, device="cuda", n_images=N_IMAGES, hw=(720, 1280), opts=()):
    """Phase 15: ``python -m glass_tpu_torch.tools.verify_released_checkpoint``
    in-process (``main(argv)``) on phase 6's eval set at batch 4 in bf16,
    with the seeded weights saved as a released-like d2 file: (a)
    ``--dry-run`` with no expected value, (b) ``--gt-zip`` set to (a)'s det
    zip at an expected hmean of 1.0 (the model scores itself), (c) the same
    at 0.5, which must fail with exit 1.  Words are written as box polygons
    (MASK_INFERENCE off), so K1 runs the box and recognizer poolers."""
    root = os.path.join(out_dir, "verify")
    try:
        return _phase_verify(state_dict, root, torch.device(device), n_images, hw, opts)
    finally:  # the images and the .pth are large; the reports stay
        import shutil

        shutil.rmtree(os.path.join(root, "ds"), ignore_errors=True)
        if os.path.exists(os.path.join(root, "released_like.pth")):
            os.remove(os.path.join(root, "released_like.pth"))


def _phase_verify(state_dict, root, device, n_images, hw, opts):
    from glass_tpu_torch import eval as port_eval
    from glass_tpu_torch.ops import _cuda
    from glass_tpu_torch.tools import verify_released_checkpoint as verify

    t0 = time.perf_counter()
    ds_yaml = write_eval_set(root, n_images, hw)
    pth = os.path.join(root, "released_like.pth")
    torch.save({"model": state_dict, "iteration": 0}, pth)
    common = ["--dry-run", "--checkpoint", pth, "--config", ICDAR15, "--datasets", ds_yaml,
              "--batch-size", "4", "--device", str(device)]
    # Box polygons, not mask polygons: (b) and (c) read (a)'s det zip as
    # their gt, and the ICDAR dialect of an RRC gt zip holds 4 points a word.
    # A random model's mask contours carry hundreds to thousands of points,
    # and scoring them against themselves took 105 s a run on the H100's host
    # (the exact clipper is quadratic in the points of a pair).
    opts = ["TPU.COMPUTE_DTYPE", "bfloat16", *LOOSE_OPTS, "MODEL.ROI_MASK_HEAD.MASK_INFERENCE", "False", *opts]
    gt_zip = os.path.join(root, "a", "synth_test_det.zip")
    inner = port_eval.main

    def eval_with_bench_log(argv):  # the CLI loop's img/s, as phase 6 reads it
        with open(bench, "w"):
            pass
        return inner(["--bench-log", bench, *argv])

    card = card_line() if device.type == "cuda" else "CPU"
    runs, failed = {}, []
    _cuda.LAUNCHES.clear()
    port_eval.main = eval_with_bench_log
    try:
        for name, expected, want_rc, want_pass in VERIFY_RUNS:
            out = os.path.join(root, name)
            bench = os.path.join(root, f"bench_{name}.jsonl")
            gate = [] if expected is None else ["--gt-zip", gt_zip, "--expected-hmean", expected,
                                                "--tolerance", "0.01"]
            rc = verify.main([*common, *gate, "--output", out, *opts])
            with open(os.path.join(out, "verification_report.json")) as f:
                report = json.load(f)
            with open(bench) as f:
                last = [json.loads(line) for line in f][-1]
            runs[name] = dict(rc=rc, measured_hmean=report["measured_hmean"], diff=report.get("diff"),
                              passed=report["pass"], img_s=last["done"] / last["elapsed_s"], images=last["done"])
            log(f"phase 15 ({name}) expected {expected}: exit {rc}, pass {report['pass']}, measured hmean "
                f"{report['measured_hmean']:.4f}, diff {report.get('diff')}; eval {last['done']} images at "
                f"batch 4, {runs[name]['img_s']:.3f} img/s (CLI loop, image reads included; {card})")
            if rc != want_rc or report["pass"] is not want_pass:
                failed.append(f"({name}) exit {rc} pass {report['pass']}, want exit {want_rc} pass {want_pass}")
    finally:
        port_eval.main = inner
    launches = dict(_cuda.LAUNCHES)
    n_tensors = verify.count_tensors(pth)
    seconds = time.perf_counter() - t0
    log(f"phase 15 ({card}): {seconds:.1f} s; released-like checkpoint {n_tensors} tensors; "
        f"K1/K2 launches {launches}")
    if device.type == "cuda":
        done = sum(r["images"] for r in runs.values())
        want = {"roi_align_rotated": 2 * done, "crop_rois": done}  # no mask pooler without masks
        got = {k: launches.get(k, 0) for k in want}
        if got != want:
            failed.append(f"launches {got}, expected 2 and 1 per image {want}")
    if failed:
        raise AssertionError(f"phase 15: {failed}")
    return {"launches": launches, "runs": runs, "n_tensors": n_tensors, "s": seconds}


def finish_fetch_dispatch(runner, images) -> dict:
    """``dispatch_batch`` then the fetch: the raw fields (B, D, ...)."""
    from glass_tpu_torch.inference.runner import finish_fetch

    with torch.inference_mode():
        fetch, _ = runner.dispatch_batch(images)
    return finish_fetch(fetch)


def phase_k3(images, state_dict, n_images=4, device="cuda", opts=()):
    """Phase 16: K3 on the word sets of serving images (see the module's
    docstring).  On the CPU (a rehearsal) the paster runs K3's plain
    version and the card's launches and times are skipped."""
    import cv2

    from glass_tpu_torch.inference import GlassRunner
    from glass_tpu_torch.ops import _cuda
    from glass_tpu_torch.ops import paste_masks_rotated as k3
    from glass_tpu_torch.postprocess import paste
    from glass_tpu_torch.utils import trace

    cuda = torch.device(device).type == "cuda"
    runner = GlassRunner(cfg=eval_cfg("bfloat16", opts=[*LOOSE_OPTS, *opts]), state_dict=state_dict,
                         device=device)
    paster, seen = runner.mask_paster or paste.RotatedMaskPaster("cpu"), []

    def recording(masks, boxes, shape, threshold=0.5):
        seen.append((np.array(masks), np.array(boxes), tuple(shape), threshold))
        return paster(masks, boxes, shape, threshold)

    runner.mask_paster = recording
    runner(images[0])  # warm-up: the kernel's build, the paster's buffers and host form
    seen.clear()
    _cuda.LAUNCHES.clear()
    trace.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for img in images[:n_images]:
            runner(img)
    counts = trace.totals()
    launches = _cuda.LAUNCHES[k3.KERNEL]
    form = paste.host_form()
    native_words = counts.get("glass.post.polygons.native_words", 0)
    cv2_words = counts.get("glass.post.polygons.cv2_words", 0)
    log(f"K3: host cv2 form {form} ({'float' if form == k3.FORM_FLOAT else 'fixed'}); "
        f"{launches} launches over {n_images} images; words on the card "
        f"{counts.get('glass.post.polygons.device_words', 0)}, re-warped on the host "
        f"{counts.get('glass.post.polygons.fallback_words', 0)}; contours: native tracer "
        f"{'admitted' if paste.native_contours() is not None else 'refused'} (cv2 {cv2.__version__}), "
        f"words traced natively {native_words}, by cv2 {cv2_words}")
    if cuda and launches != n_images:
        raise AssertionError(f"K3: {launches} launches over {n_images} images, expected one an image")
    if cuda and (cv2_words or not native_words):
        raise AssertionError(f"K3: cv2 traced {cv2_words} words and the native tracer {native_words}; "
                             "the probe must admit the tracer on the card's host")
    step_ms, cv2_step_ms, loop_ms = [], [], []
    for masks, boxes, shape, thr in seen:
        t0 = time.perf_counter()
        got = paster(masks, boxes, shape, thr)
        t1 = time.perf_counter()
        want = paste.rotated_masks_to_polygons(masks, boxes, shape, thr)
        t2 = time.perf_counter()
        tracer, paste.native_contours = paste.native_contours, lambda: None
        try:
            by_cv2 = paster(masks, boxes, shape, thr)
        finally:
            paste.native_contours = tracer
        t3 = time.perf_counter()
        step_ms.append((t1 - t0) * 1e3)
        loop_ms.append((t2 - t1) * 1e3)
        cv2_step_ms.append((t3 - t2) * 1e3)
        for i, (a, b, c) in enumerate(zip(got, want, by_cv2)):
            for x in (a, c):
                if (x is None) != (b is None) or (x is not None and not np.array_equal(x, b)):
                    raise AssertionError(f"K3: word {i}'s polygon differs from the host loop's")
    log(f"K3: polygons equal the host loop's on {len(seen)} images ({sum(len(s[0]) for s in seen)} words); "
        f"polygon step through the paster {', '.join(f'{v:.1f}' for v in step_ms)} ms, the paster with cv2's "
        f"contours {', '.join(f'{v:.1f}' for v in cv2_step_ms)} ms, host loop "
        f"{', '.join(f'{v:.1f}' for v in loop_ms)} ms")
    words = counts.get("glass.post.polygons.device_words", 0)
    fallback = counts.get("glass.post.polygons.fallback_words", 0)
    log(f"K3: knife-edge fallback {fallback} of {words} words on the card "
        f"({100 * fallback / max(words, 1):.1f} %)")
    if not cuda:
        return None

    masks, boxes, shape, thr = seen[0]
    win, fwd, inv = paste.word_windows(boxes, shape, masks.shape[1:])
    keep = (win[:, 2] > win[:, 0]) & (win[:, 3] > win[:, 1])
    w, h = win[keep, 2] - win[keep, 0], win[keep, 3] - win[keep, 1]
    sizes = (w * h + 15) // 16 * 16
    geo = np.stack([np.cumsum(sizes) - sizes, w, h], 1)
    n = int(keep.sum())
    m_t = torch.from_numpy(masks[keep].astype(np.float32))
    dev = [m_t.cuda(), torch.from_numpy(inv[keep]).cuda(), torch.from_numpy(geo).cuda(),
           torch.from_numpy(k3.tile_table(geo)).cuda()]
    out = torch.zeros(int(sizes.sum()), dtype=torch.uint8, pin_memory=True)
    flags = torch.zeros(n, dtype=torch.int32, pin_memory=True)
    no_fg = torch.tensor([[k3.NO_FG, k3.NO_FG, -1, -1]] * n, dtype=torch.int32, device="cuda")
    fg = no_fg.clone()
    rows, err = [], 0
    for f in (k3.FORM_FLOAT, k3.FORM_FIXED):
        out.zero_()
        flags.zero_()
        fg.copy_(no_fg)
        k3.paste_binarize(*dev, fg, f, thr, paste.KNIFE_EDGE, out, flags, torch.cuda.current_stream())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, want_flags, want_fg = k3.paste_binarize_plain(m_t, torch.from_numpy(inv[keep]),
                                                            torch.from_numpy(geo), f, thr, paste.KNIFE_EDGE)
        plain_ms = (time.perf_counter() - t0) * 1e3
        bad = int((out != want).sum()) + int((flags != want_flags).sum()) + int((fg.cpu() != want_fg).sum())
        err = max(err, bad)
        ms = kernel_ms(lambda: k3.paste_binarize(*dev, fg, f, thr, paste.KNIFE_EDGE, out, flags,
                                                 torch.cuda.current_stream()))
        nbytes = n * masks.shape[1] * masks.shape[2] * 4 + n * (48 + 24 + 4 + 32) + len(dev[3]) * 8 + int(sizes.sum())
        b_ms, b_by = bound(nbytes, 0.0)
        rows.append(dict(form=f, err=bad, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
        log(f"K3 form {f}: {n} words, {int((w * h).sum())} window pixels, {len(dev[3])} tiles; "
            f"bytes, flags and boxes off the plain version {bad}; kernel {ms:.4f} ms, plain {plain_ms:.0f} ms, "
            f"byte bound {b_ms:.4f} ms ({nbytes} B at 3.35 TB/s), {100 * b_ms / ms:.1f}% of it")
    if err:
        raise AssertionError(f"K3: {err} bytes, flags or box numbers differ from the plain version")
    return dict(rows=[r for r in rows if r["form"] == form], launches=launches, n_images=n_images,
                step_ms=step_ms, cv2_step_ms=cv2_step_ms, loop_ms=loop_ms)


def kernel_entry(name, source, replaces, launches, rows):
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations",
        "library_ms": None,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11,12,13,15,16")
    ap.add_argument("--out", default="chip_smoke_out", help="directory for the build log and the profile table")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU")
        sys.exit(2)
    os.makedirs(args.out, exist_ok=True)
    sys.stdout = Tee(sys.stdout, os.path.join(args.out, "chip_smoke.log"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import glass_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = card_line()
    log(card)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    rng = np.random.RandomState(0)
    rois_np = word_rois(rng, N_ROIS, *BUCKET_HW)
    k1_rows = k2_rows = k1b_rows = None
    main = train = variants = distributed = fp16 = vmap = verified = k3 = None
    seconds, lap = {}, [time.perf_counter()]

    def mark(n):  # the seconds of phase n, from the end of the one before
        now = time.perf_counter()
        seconds[n] = round(now - lap[0], 1)
        lap[0] = now

    if 1 in phases:
        phase_build(args.out)
        mark(1)
    if 2 in phases:
        k1_rows, k1_edge = phase_k1(rng, rois_np)
        mark(2)
    if 3 in phases:
        k2_rows, k2_edge, k2_lib_ms = phase_k2(rng, rois_np)
        mark(3)
    if phases & {4, 5, 6, 9, 10, 11, 12, 13, 15, 16}:
        images = [synthetic_image(np.random.RandomState(100 + i), 720, 1280) for i in range(N_IMAGES)]
        state_dict = seeded_weights(images[0])
        mark("weights")
        if 4 in phases:
            main = phase_main(images, state_dict, N_TIMED, args.out)
            mark(4)
        if 5 in phases:
            phase_whole(images[0], state_dict)
            mark(5)
        if 6 in phases:
            phase_eval(state_dict, args.out)
            mark(6)
        if 9 in phases:
            phase_variants(state_dict, images, args.out)
            mark(9)
        if 10 in phases:
            variants = phase_model_variants(state_dict, images, args.out)
            mark(10)
    if 7 in phases:
        k1_train_rows, k1b_rows, k1b_edge = phase_k1b(np.random.RandomState(7))
        mark(7)
    if 8 in phases:
        train = phase_train(args.out)
        mark(8)
    if 11 in phases:
        distributed = phase_distributed(state_dict, images, args.out, phase8=train)
        mark(11)
        log(f"phase 11: {seconds[11]} s")
    if 12 in phases:
        fp16 = dict(kernels=phase12_kernels(np.random.RandomState(12)))
        fp16.update(phase_fp16_remat_loop(state_dict, images, args.out, main=main, train=train))
        mark(12)
        log(f"phase 12: {seconds[12]} s")
    if 13 in phases:
        vmap = dict(k2=phase13_k2(np.random.RandomState(13)))
        vmap.update(phase_vmap(state_dict, args.out))
        mark(13)
        log(f"phase 13: {seconds[13]} s")
    if 15 in phases:
        verified = phase_verify(state_dict, args.out)
        mark(15)
    if 16 in phases:
        k3 = phase_k3(images, state_dict)
        mark(16)
    log(f"seconds by phase (in the order run; 'weights' is the seeded model of phases 4-6, 9-13 and 15): {seconds}, "
        f"{sum(seconds.values()):.1f} in all")

    kernels = []
    # the main paths' launches: K1 and K2 from phase 4's serving, K1b from
    # phase 8's training, each with phase 10's (the variants' serving and
    # training) and phase 11's (distributed training and serving)
    launches = collections.Counter((main or {}).get("launches", {}))
    launches["roi_align_rotated_backward"] = (train or {}).get("launches", {}).get("roi_align_rotated_backward", 0)
    launches.update((variants or {}).get("launches", {}))
    launches.update((distributed or {}).get("launches", {}))
    launches.update((fp16 or {}).get("launches", {}))
    launches.update((vmap or {}).get("launches", {}))
    launches.update((verified or {}).get("launches", {}))
    fp16_rows = (fp16 or {}).get("kernels", {})
    per_image = (main or {}).get("n_images", 1)
    if k1_rows:
        rows = [r for r in k1_rows if r["dtype"] == "bfloat16"]
        entry = kernel_entry("roi_align_rotated", "glass_tpu_torch/csrc/roi_align_rotated.cu",
                             "glass_tpu/ops/pallas_roi_align.py:33",
                             launches.get("roi_align_rotated", 0), rows)
        entry["max_abs_err"] = max(r["err"] for r in k1_rows + k1_edge + fp16_rows.get("k1", []))
        kernels.append(entry)
    if k2_rows:
        rows = [r for r in k2_rows if r["input"] == "bfloat16" and r["sr"] == 1]
        entry = kernel_entry("crop_rois", "glass_tpu_torch/csrc/crop_rois.cu",
                             "glass_tpu/ops/pallas_crop.py:77", launches.get("crop_rois", 0), rows)
        entry["max_abs_err"] = max(r["err"] for r in k2_rows + k2_edge + fp16_rows.get("k2", [])
                                   + (vmap or {}).get("k2", []))
        entry["library_ms"] = k2_lib_ms
        kernels.append(entry)
    if k1b_rows:
        rows = [r for r in k1b_rows if r["dtype"] == "bfloat16"]
        entry = kernel_entry("roi_align_rotated_backward",
                             "glass_tpu_torch/csrc/roi_align_rotated_backward.cu",
                             "glass_tpu/ops/roi_align_rotated.py:375 (autodiff of the packed pooler)",
                             launches.get("roi_align_rotated_backward", 0), rows)
        entry["max_abs_err"] = max(r["err"] for r in k1b_rows + k1b_edge + fp16_rows.get("k1b", []))
        kernels.append(entry)
    if k3:
        entry = kernel_entry("paste_masks_rotated", "glass_tpu_torch/csrc/paste_masks_rotated.cu",
                             "none (the host's cv2.warpAffine and threshold a word)", k3["launches"],
                             k3["rows"])
        entry["bound_by"] = "bytes"
        kernels.append(entry)
    log(f"kernel times are per image at the main-path shapes (bfloat16; K1 summed over its "
        f"three poolers); launches over phase 4's {per_image} main-path images, phase 8's training "
        f"steps, phase 10's serving and training, phase 11's distributed training and serving, "
        f"phase 12's fp16 serving and training, remat and chunked training, phase 13's vmap and "
        f"map serving and phase 15's three verification runs (K3: "
        f"its launches over phase 16's images, its time on phase 16's first image); max_abs_err over every dtype's case (phase 12's fp16 ones and phase 13's "
        f"batched K2 included), on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
