#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sais_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent-csrc DIR]

Phases, each of which fails the run:

1. device: a CUDA device must be present; prints its name and power limit
   (nvidia-smi) and the torch / CUDA versions.
2. build: compiles every kernel of kernels/csrc with nvcc for sm_90a, one
   nvcc process per source, all started together; prints ptxas registers
   and spills per source.  The flash libraries (K2, K3) must not spill, and
   cuobjdump -sass must show a TF32 HMMA in each of their kernels (K2's
   forward, K3's dq and dk / dv), their products' 3xTF32 route.  The
   key-tiled attention kernels past 256 tokens (long_attention_sm90_kernel
   in K1's and K8's libraries, attention_bwd_rows_sm90_kernel and
   attention_bwd_cols_sm90_kernel in K6's) must show wgmma (HGMMA) and no
   mma.sync HMMA.16816 in their SASS, and no spill in their ptxas report.
3. K1 (fused_vit_block) at ViT-S/16 widths, batch 256, bf16: the CUDA
   kernel against its plain PyTorch version at L = 197 and at L = 208 with
   keys >= 197 masked; CUDA-event times of the kernel, the plain version
   and one composition of PyTorch library calls (layer_norm, linear,
   scaled_dot_product_attention, gelu); the least time the card could take;
   each of K1's seven launches' device time and its four GEMMs' TFLOP/s
   (torch.profiler), which must all run on the wgmma + TMA GEMM.
4. K2 (flash_attention), f32, H = 4, Dh = 96: the CUDA kernel against its
   plain version (out and lse) at (B*S, L) = (8, 2001), the reference's
   2000-frame cap plus CLS, and (132, 301), full-length 10 s windows at
   30 fps, with masked tails that differ per element and one element with
   every key masked (its output must be exactly 0); CUDA-event times of
   the kernel, the plain version and scaled_dot_product_attention with the
   additive mask, at the steps path's shape and at (8, 2001); the least
   time the card could take (3xTF32, with the f32 FFMA bound beside it);
   out and lse of the kernel and of the plain version against a float64
   evaluation.  Then prototypes_forward at (8, 1, 2000, 384)
   in auto mode must take K2 (one launch per layer) and agree with the
   dense path.
5. gesture path at full width: random ViT-S/16 and one fold of the 4-layer
   temporal model + prototypes (fixed torch.Generator seeds), 300
   synthetic 480x640 frames (10 s at 30 fps, numpy seed 0):
   FeatureExtractor.extract_array (bf16, batch 256) then
   GestureDecoder.decode over 3 TTA offsets, CSV to a temporary directory.
   K1 must launch exactly 12 times per frame batch and K2 not at all (the
   16-token windows stay dense); features and probabilities are checked
   against the same path through the plain version.  Extraction frames/s
   is the median of three timed runs after a warm-up at the same shapes.
   Then host extraction (`extract --exact-preprocess --norm half`): the
   same 300 frames cropped, resized and normalized on the host CPU, the
   normalized frames copied to the card and the ViT on K1 (12 launches a
   batch), against the device route under the same normalization (bitwise
   expected; the limit, were they not, the plain version's 5e-2);
   frames/s of both routes; whether the frame pump built (it falls back
   to OpenCV's Python binding where OpenCV's C++ headers are missing).
6. flow path at full width (`pipeline -mod RGB-Flow` without the video
   I/O): random RAFT 'things' weights (raft_init, 32 iterations) and the
   gesture path's ViT-S/16 and fold, 300 synthetic 480x640 frames (one
   random texture of 8-pixel cells moving 2 pixels a frame, numpy seed 0):
   FlowExtractor.extract_video over them (jump 15: 19 pairs, two batches
   of 8 and a tail of 3 padded to 8; bf16 encoders, the rest of RAFT in
   float32, then the device renderer, preprocess and the ViT on K1), then
   GestureDecoder(-mod RGB-Flow) over the gesture path's RGB features and
   these flow features.  Checks: RAFT alone in float32 against float64 on
   the card (one pair at 240x320, 3 iterations; rtol 1e-3, atol 2e-3);
   the device renderer within 1 uint8 level of the host renderer on the
   path's flow fields; the flow features against the same rendered frames
   through K1's plain version and against the staged route (host
   rendering, then FeatureExtractor.extract_array; both 5e-2 of the
   largest value); K1 launches 12 times per ViT batch; window
   probabilities on the card against the same decoder on the CPU (1e-2).
   Prints RAFT's ms per pair at batch 8 by CUDA events, split into
   encoders, correlation pyramid, update loop and upsampling, its
   TFLOP/s against the operations counted from the conv shapes, the
   path's pairs/s (host clock, median of three after a warm-up), its peak
   device memory and the share of its device time that RAFT and the ViT
   take (torch.profiler ranges).
7. steps path at full width (`steps --stride-divisor 4096 --flash on`):
   StepRecognizer over a synthetic 20,000-frame feature track (11.1 min at
   30 fps, numpy seed 0): 132 windows x 3 TTA offsets of 301 / 298 / 295
   tokens, CSV to a temporary directory.  K2 must launch exactly 12 times
   (4 layers x 3 TTA) and K1 not at all; window probabilities are checked
   against the same path through K2's plain version (on the CPU) and
   against the dense path.  Wall time is the median of three after a
   warm-up at the same shapes.
8. K3 (flash_attention_bwd), f32, H = 4, Dh = 96: the CUDA kernel against
   its plain version (dq, dk, dv) at (B*S, L) = (132, 301), the steps
   shape, (8, 2001) with masked tails that differ per element and one
   element with every key masked (its cotangent is zero, as
   flash_attention's backward makes it, and its dq, dk, dv must be exactly
   0), and (2, 8193), the long training step; out and lse come from K2 on
   the same inputs, the cotangent from a fixed seed; both are also
   printed against a float64 evaluation of the same formulas.  CUDA-event
   times of the kernel, the plain version and the backward of
   scaled_dot_product_attention (f32, additive mask; forward + backward
   minus forward); the least time the card could take (3xTF32, with the
   f32 FFMA bound beside it).  With `--parent-csrc DIR`, the earlier
   tree's K2 and K3 (its 3xTF32 products run into the running sums) are
   timed beside this tree's in turns at these shapes (K2 at the first
   two), their outputs within 1e-4 of this tree's largest value.
9. training path at full width (`train --segments ... -bc -e 2 -bs 32
   -lr 0.1 --flash on` without the CSV and H5 I/O): a synthetic in-memory
   feature store (16 videos x 3,000 frames x 384, numpy seed 0) and
   segments table (24 segments of 45-150 frames per video, two classes),
   build_segment_dataset(fold 0, balanced), segment_batches loaders and
   PrototypeTrainer.fit(2 epochs) from fixed torch.Generator seeds.  K3
   must launch exactly 4 x (train batches) and K2 4 x (train batches +
   3 x (val + test batches)); the per-epoch losses must agree with the
   same fit on the CPU (plain versions) within 1e-3; the saved fold
   (params.pkl) read back by the port's loader must decode to the same
   window probabilities as the in-memory model.  Then one train step at
   the JAX package's bench_seq_train shape (b 2, 8192 frames + CLS,
   max_positions 8192, flash on): K2 and K3 launch 4 times each, the loss
   and every gradient agree with the dense path on the card (frame_pos,
   whose rows are single-token gradients that a ReLU flip at rounding
   level moves, in the norm; the dense path against itself under 1e-7
   input noise is printed beside it); median step time of five after a
   warm-up, for both paths.  Then `flash_crossover`: prototypes_forward
   (batch 2, inference mode) on K2 against the dense path at 301, 512,
   1024, 2001 and 8193 tokens, median of five CUDA-event runs each, and
   the length from which flash is faster.
10. skill path at full width (`train --dataset vua-ease -d NH_02 -il -bc
   -e 2 -bs 8 -lr 0.1` and `assess`, without the CSV and H5 I/O): a
   synthetic stitch table (numpy seed 0: 48 videos x 6 stitches x the
   three RACE / EASE pairs, maj in {0, 1, 2}, explanation rows for the
   low-skill stitches) and 384-d features of 6,000 frames a video (RGB
   and flow, in memory); build_ease_dataset -> skill_batches ->
   PrototypeTrainer(use_importance=True).fit from fixed torch.Generator
   seeds, with --flash on (K3 exactly 4 x train batches, K2 4 x (train
   batches + 3 x eval batches)) and dense (no launch), and on the CPU;
   epoch losses flash vs dense and card vs CPU within 1e-3; one -il step's
   loss (1e-5 relative) and every parameter gradient flash vs dense (1e-3
   of its largest value, frame_pos in the norm); the -il step's median
   ms; one epoch of `-d NH_02+ND_02` (linearB) with the same launch rule;
   then SkillAssessor over the trained fold on the USC_inference table and
   the inference rows of 4 videos (96 segments), -mod RGB and RGB-Flow,
   flash and dense: K2 exactly 4 x segments x 3 TTA x modalities, the
   probabilities, the importance (of its largest value) and the flash
   path's CLS attention row against row 0 of the dense (f+1, f+1) matrix
   within 1e-4, importance of length f; segments/s (host clock, median of
   three after a warm-up) and one profiled assess's idle share, each
   beside the card's name and power limit.
11. K4 (fused_block_fwd_train), K5 (fused_block_bwd_mlp) and K6
   (fused_block_bwd_attn), bf16, D = 384, 6 heads of 64, MLP 1536: each
   CUDA kernel against its plain version (out and x1; dx1 and the f32 MLP
   weight gradients; dx and the f32 attention weight gradients) at the
   pretrain step's shapes (B, L) = (128, 197) and (512, 37) and at (64,
   208) with keys >= 197 masked, each without and with branch scales (a
   quarter of them 0); CUDA-event times with the scales of the kernel, its
   plain version and the PyTorch library composition (K4: layer_norm,
   linear, SDPA, gelu; K5 and K6: the autograd backward of the MLP and
   attention halves, forward + backward minus forward); the least time the
   card could take; K4's seven launches as for K1.  K5 and K6 also run
   twice on the same inputs at every shape and must agree to the bit;
   `k5_profile` and `k6_profile` print each launch of one call (device
   time, kernel name), the products' TFLOP/s and the attention backward's
   share of K6 at (128, 197) and (512, 37), and fail unless every product
   ran the wgmma + TMA GEMM (none the mma.sync template) and a call makes
   at most 11 (K5) and 12 (K6) launches.
12. long blocks, past the register attention's 256 tokens: K1, K4, K5, K6
   and K8 at (B, L, valid, D) = (128, 785, 785, 384), the vits8 step's
   global crops, (64, 785, 785, 768), the vitb8 geometry, (32, 257, 257,
   384), (16, 1025, 1025, 384) and (32, 800, 785, 384), keys >= 785
   masked as the JAX package pads them: each CUDA kernel against its
   plain version (2e-2 of its largest value) and run twice, bitwise
   equal; K8 against K1 on a reference-initialized block (cosine >
   0.9999, max relative < 0.02); CUDA-event times of each kernel, its
   plain version and its library composition, and the least time; at
   (128, 785) `k1_profile`, `k5_profile` and `k6_profile`, whose
   attention launches must run the key-tiled wgmma kernels
   (long_attention_sm90_kernel; attention_bwd_rows_sm90_kernel and
   attention_bwd_cols_sm90_kernel, K6's ten launches), with the TFLOP/s
   of the flops each needs and of those it executes.  With `--parent-csrc
   DIR`, the earlier tree's K1 and K6 are timed beside this tree's at
   (128, 785, 384) and (64, 785, 768), in turns, their outputs within 2e-2
   of this tree's largest value (the plain versions' limit).
13. K7 (dino_head_loss), the DINO last layer + loss: the CUDA kernel
   against its plain version (loss and center 1e-4 relative; dhs, dvs,
   dgs 1e-2 of the plain version's largest value; dgs exactly 0 under
   norm_last_layer; two runs bitwise equal) at the pretrain step's shape
   (640 / 128 rows, bottleneck 256, out_dim 65536) with norm_last_layer
   both ways, at the CLI's default batch 256 (2560 / 512 rows) and at a
   ragged (25, 10) shape; at batch 64 and 256, CUDA-event times of the
   kernel, the plain version and the unfused composition
   (`plain_head_loss`, forward and autograd backward), the least time the
   card could take, and `k7_profile`: each of a call's 11 launches with
   its device time and the products' TFLOP/s, failing unless every
   product ran `gemm_sm90_kernel`, none the kernels it replaced
   (grad_h_kernel, grad_v_kernel, stats_kernel), and a call makes at most
   14 launches.  With `--parent-csrc DIR` (an earlier tree's
   kernels/csrc), its K1, K6, K7 and K8 are built and timed beside this
   tree's, in turns: K1 at (256, 197), K6 at (128, 197) (both bitwise
   equal to this tree's, whose code there is unchanged), K7 at both
   batches and K8 at its shape.
14. pretrain path at full width (`pretrain -bs 64` without the video
   I/O): DINOTrainer(ViT-S/16, out_dim 65536, 2 global crops at 224 + 8
   local at 96, drop path 0.1, adamw, fused blocks, fused loss) from
   fixed seeds, 64 synthetic 480x640 frames (numpy seed 0), border crop
   and multi_crop_batch on the card; one warm-up step, then five steps
   (host clock, loss fetched each step; img/s from the median).  K4, K5
   and K6 must launch exactly 24 times a step (12 blocks x 2 crop groups),
   K1 12 (the teacher) and K7 once; every loss finite; one step's loss and
   every parameter gradient, with the same weights, crops and drop-path
   draws, against the same step through the plain versions on the card
   (loss 1e-3 relative, each gradient 5e-2 of its largest value); the
   loss with fused_loss=False printed beside it.  Then the same for
   `pretrain --arch vits8` (ViT-S/8: 785 + 145 tokens, the globals on
   the key-tiled attention); both print the median step ms, img/s, and a
   profiled step's device busy time and idle share beside the card.
   Then `pretrain -bs 64 --use-bn-in-head` at the ViT-S/16 defaults: the
   student on K4-K6, the teacher on K1, the BatchNorm head and the loss
   plain (K7 never, as in the JAX package); five steps: K4-K6 exactly 24
   launches a step, K1 12, K7 0, losses finite, both heads' BatchNorm
   running statistics moving; the median step ms printed beside the K7
   step's; one step's loss and gradients, the kernels against their
   plain versions on the card, and one step at batch 16 (drop path 0) on
   the card against the same step on the CPU (the kernels' plain
   versions there) from the same weights and crops, each also for a
   control, the head without BatchNorm (the plain head and loss, the
   same weights and draws): loss 1e-3 relative; each gradient alone,
   the BatchNorm scales and biases included, in max|diff| / max|value|
   (and card against CPU in ||diff|| / ||value|| too) 5e-2 under the
   control, 1e-1 (kernels against plain) and 1.5e-1 / 1.25e-1 (card
   against CPU) under the BatchNorm head, which reads about 10x the
   control; the magnification of rounding by the student's first
   BatchNorm's backward (||dx|| / ||what it leaves||) printed beside
   them; the new running statistics 5e-2 of their largest value; the
   three gradients that train-mode BatchNorm makes exactly 0,
   head.mlp.0 / 1.bias and backbone.norm.bias, 5e-2 of the step's
   largest gradient.
15. K8 (fused_vit_block_int8), the W8A8 block, at (256, 197, 384): the
   CUDA kernel against its plain version (2e-2 of its largest value), two
   runs bitwise equal, and against K1 on the same inputs (cosine >
   0.9999, max relative < 0.02, JAX's limits; the reading at the K1
   phase's weights printed beside it); CUDA-event times of the kernel, of
   K1 in the same call, the plain version and a torch._int_mm
   composition; the least time the card could take; `k8_profile`: each
   of a call's 8 launches with its device time and the products' TOP/s,
   failing unless every product ran `gemm_sm90_kernel` (its int8 mode),
   no launch the mma.sync gemm_i8_kernel or quant_rows_kernel<float>, and
   a call makes at most 10 launches.
16. W8A8 encoder: 256 synthetic 480x640 frames through preprocess_batch
   and vit_features(bf16 ViT-S/16, quant="int8"): K8 must launch 12 times
   and K1 not at all; mean CLS cosine against the K1 path >= 0.999;
   frames/s beside the bf16 path's (median of three after a warm-up).
17. classification path at full width (`train -t MIL --dataset
   vua-gestures -d 1_vs_2 -bc -e 2 -bs 32 --flash on` and the other reps
   branches, without the CSV and H5 I/O): a synthetic VUA gesture-timestamp
   CSV (numpy seed 0: 40 videos x 60 gestures, Paths with either
   separator, an object Gesture column with multi-label and empty cells)
   read by `read_segments`, 6,000 x 384 features a video and a flow row
   every 15 frames, in memory; vua_gestures_tables(fold 0) ->
   segment_batches -> ClassificationTrainer(MIL) for 2 epochs from fixed
   seeds with --flash on (K3 exactly 4 a train batch, K2 4 a train batch +
   12 an eval batch: MIL reads RGB only, the clip encoder stays dense),
   dense (no launch) and on the CPU, epoch losses flash against dense and
   dense against the CPU within 1e-3; K2's signed error at the first
   layer against the dense path (and each against float64), and the
   dense fit again with that signed
   error (and with unbiased noise of its size, and of 1e-8) in every
   layer's attention output, printed beside them; the MIL step's median ms and
   the device time of one step (queued behind a spin kernel); a
   Prototypes fit on `--dataset segments --split-policy per-gesture-video
   -mod RGB-Flow --flash on` (8 and 24 launches a train and an eval
   batch: two modalities, flow windows of 2-16 tokens) and the same fit
   dense, epoch losses within 1e-3; one
   -t MIL step at -dim 128 and at -dim 768 (head widths 32 and 192) flash
   against dense (4 launches of each kernel; loss 1e-5 relative, each
   gradient 1e-3 of its largest dense value, frame_pos in the norm); a
   `--no-self-attention` fit (no launch); then K2 and K3 alone at (B*S, H,
   L, Dh) = (32, 4, 129, 32) and (32, 4, 129, 192) against their plain
   versions (1e-4 of the largest value; three elements with masked keys
   inside the valid range; the all-masked element exactly 0), with CUDA-event times beside SDPA's, the device time a call (the
   calls queued behind a spin kernel) and the bound, and at Dh 50 (packed
   into 52-wide buffers) against the plain version.  The signed-error
   line also holds K2's and the dense path's errors against the same
   attention in float64 (signed and mean |error|); K2's signed error must
   be within 2x of the dense path's.  Beside it K3's dq, dk and dv at the
   same layer against float64, with the dense path's autograd, and the
   3xTF32 sums alone in the tf32_sum_probe micro-kernel (P V's sum over
   128 keys with p in [0, 1) and v of one sign, as K2 ran it, with p or v
   exact in TF32, with the three products apart, without the tie and on
   FFMA; q' K^T's sum over a width of 96 with and without the tie and on
   FFMA), each's signed error against float64.
18. raw-video path at the published widths (`train --dataset vua-ease -d
   NH_02 --data-type raw -e 2` through the CLI): a synthetic stitch table
   (numpy seed 3: 6 videos x 3 stitches x the three RACE / EASE pairs)
   written as a CSV, uint8 frames of 480x640 served from memory (a pool
   of numpy-seeded frames) in place of the JPEG reader; --encoder R3D
   (R3D-18 at float32 on cuDNN with TF32 off, 16 x 112 x 112 snippets,
   batch 8, lr 1e-4) and --encoder ViT (ViT-S/16 at float32, 16 frames of
   224 x 224 a snippet, batch 2), 3-way TTA at val / test, each on the
   card, and its first epoch on the CPU: epoch losses within 1e-3.  The device resize of a
   snippet's crops against numpy's half-pixel bilinear on the same input
   (bitwise expected, limit an ulp at 1); R3D's features of 8 snippets on the card against its float32
   CPU run (1e-4 of the largest); `r3d_profile` (the convolutions'
   kernels); the frozen step's ms and snippets/s (median of five) and one
   --unfreeze-encoder step with its peak memory for each encoder; one
   -mod RGB-Flow step (R3D, raw + raw_flow features summed).  No TPU
   kernel is on this path.
19. serve path at full width (`serve` / `request`, after the flow path):
   the daemon of cli/serve.py on a Unix socket in a thread over the
   gesture path's models (ViT-S/16 on K1, bf16, batch 256; one fold of the
   4-layer temporal model, 3 TTA offsets) and 300 frames of 480x640 a
   video.  The card machine has no OpenCV, so the phase replaces the
   daemon's video reader with frames held in memory (printed; the files
   under <tmp>/videos/ are placeholders).  One RGB daemon: warm-up, ping,
   request A, a ping during A, request B while A is in flight (B's host
   decode starts on the prefetch path), stats, shutdown (drains); each
   CSV equals, as text, GestureDecoder.decode over
   FeatureExtractor.extract_array of the same frames in this process; K1
   launches 12 times a frame batch a request, K2 never.  One RGB-Flow
   daemon: warmup_flow(480, 640), one flow request whose CSV equals the
   in-process FlowExtractor -> GestureDecoder route.  Prints the warm-up
   times, each request's seconds and frames/s, ping latency, p50 / p95
   from stats.  Then eval / attention on the card against the same calls
   on the CPU: the weighted k-NN over 50,000 x 384 train and 10,000 test
   features (20 classes; top-1 / top-5 within 0.05 points, the rows whose
   vote differs printed), the linear probe (10 epochs; weights within
   1e-4 of their largest value), cls_attention_maps and
   vit_intermediate_layers(n=4) at ViT-S/16, 224 px, batch 32, float32
   (1e-4), and zoo.create("vitb8")'s forward pass.
20. parallel: `extract --data-parallel` (300 frames through
   FeatureExtractor.extract_video, the video reader, frame pump and
   feature store replaced by in-memory stand-ins), `pretrain --data-parallel` (2 steps of batch
   64, ViT-S/16 + out_dim 65536) and `train --seq-parallel 1` (2 epochs
   of -bs 32 over 16 in-memory videos) through the port's CLI, each a
   group of one NCCL rank, against the same command without the flag:
   extract bitwise, pretrain's parameters 5e-2 of their largest value,
   train's epoch losses 1e-3; the launches of each (K1 24; K4-K6 48, K1
   24, K7 2; K2 and K3).  Two NCCL ranks on the one card (what NCCL
   says, printed).  The 4-rank ring in one process at (2, 4, 8193, 96)
   (`ring_in_one_process`: every rank's K2 / K3 step in turn) against
   whole-sequence K2 / K3, 1e-4 of the largest value; K7 on two shards
   of batch 32 summed against K7 at batch 64 (the K7 phase's limits);
   the time of one NCCL all-reduce of the ViT-S/16 DINO student's flat
   gradient buffer at world size 1.
21. prints the total time, the card, the kernels line (JSON) and, last,
   the device line (JSON).  K1's launches there add the gesture, host
   extraction, flow and serve paths' to the teacher's in the three
   pretrain runs; K4-K7's add the three pretrain runs'; K2's and K3's add the skill and classification paths'
   to the training path's; each adds the parallel phase's CLI runs'.

It also prints torch.profiler tables (device time per kernel, device idle
share) of K1 calls, K2 calls, one extraction, one decode, one steps run,
K3 calls, one long train step (with K2's and K3's shares), one assess,
K4-K6 calls,
K7 and K8 calls (per launch), one pretrain step of each arch (with K4's,
K5's, K6's, K1's and K7's shares, read from profiler ranges: K1 and K4
share their kernels' names) and one flow extraction (RAFT's and the ViT's
shares).
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16, at 700 W (data sheet)
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores
PEAK_TF32_FLOPS = 494.7e12   # H100 SXM dense TF32 (K2 and K3's route)
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
# the kernel torch.cuda._sleep launches: _profile's marker between calls
MARKER = "spin_kernel"
# the host's kernel launch calls, as torch.profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
# spin launches that open every profiler window (`_profile_window`)
PROFILE_PAD = 256


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call of fn: the calls are enqueued behind a
    50 ms spin kernel, so they run back to back on the device whatever the
    host's launch rate, and CUDA events time them there."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    # full-precision float32 products in the plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# The flash kernels' products must run on the tensor cores in TF32: each
# function of these libraries whose name holds the fragment needs a TF32
# HMMA in its SASS, and the libraries must not spill.
FLASH_KERNELS = {"flash_attention": ("flash_fwd_kernel",),
                 "flash_attention_bwd": ("flash_bwd_dq_kernel",
                                         "flash_bwd_dkv_kernel")}


def _sass(name):
    """{function: its SASS lines} of one built library (cuobjdump -sass)."""
    from sais_tpu_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed on {name}: {out.stderr}")
    funcs, current = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            current = line.split("Function :")[1].strip()
            funcs[current] = []
        elif current is not None:
            funcs[current].append(line)
    return funcs


def _named(funcs, name, frag):
    found = {f: v for f, v in funcs.items() if frag in f}
    check(bool(found), f"{name}: no kernel named {frag}")
    return sorted(found.items())


def check_tf32_sass(name, fragments):
    """cuobjdump -sass of one built library: prints the TF32 HMMA and FFMA
    count of every kernel named by `fragments` and fails unless each has a
    TF32 HMMA."""
    funcs = _sass(name)
    for frag in fragments:
        for func, lines in _named(funcs, name, frag):
            hmma = sum("HMMA" in line and "TF32" in line for line in lines)
            ffma = sum("FFMA" in line for line in lines)
            print(f"  {name}: {func}: {hmma} TF32 HMMA, {ffma} FFMA",
                  flush=True)
            check(hmma > 0, f"{func} has no TF32 HMMA instruction")


# the attention kernels' reach: up to 256 tokens the register kernels
# (kernels/csrc/vit_block_common.cuh), past them the key-tiled ones on
# wgmma + TMA (attention_sm90.cuh, fused_block_bwd_attn.cu)
SHORT_ATT_LEN = 256
LONG_ATTENTION = "long_attention_sm90_kernel"
LONG_ATTENTION_BWD = ("attention_bwd_rows_sm90_kernel",
                      "attention_bwd_cols_sm90_kernel")

# The key-tiled attention kernels past 256 tokens must run their products
# on wgmma (HGMMA in the SASS, no mma.sync HMMA.16816), and must not spill.
ATTENTION_SASS = {"fused_vit_block": (LONG_ATTENTION,),
                  "fused_vit_block_int8": (LONG_ATTENTION,),
                  "fused_block_bwd_attn": LONG_ATTENTION_BWD}


def kernel_ptxas(log):
    """{entry function: [its ptxas -v lines]} of one source's build log."""
    out, current = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1]
            out[current] = []
        elif current is not None:
            out[current].append(line.strip())
    return out


def check_wgmma_sass(name, fragments, log):
    """Every kernel of `name` named by `fragments`: HGMMA and no
    HMMA.16816 in its SASS, and (where this run built the library, `log`)
    no spill in its ptxas report."""
    funcs = _sass(name)
    report = kernel_ptxas(log) if log is not None else {}
    for frag in fragments:
        for func, lines in _named(funcs, name, frag):
            hgmma = sum("HGMMA" in line for line in lines)
            hmma = sum("HMMA.16816" in line for line in lines)
            ptxas = [x for f, v in report.items() if f in func or func in f
                     for x in v if "registers" in x or "spill" in x]
            print(f"  {name}: {frag}: {hgmma} HGMMA, {hmma} HMMA.16816; "
                  + ("; ".join(ptxas) if log is not None
                     else "library cached, built by an earlier run"),
                  flush=True)
            check(hgmma > 0 and hmma == 0,
                  f"{func}: products not on wgmma ({hgmma} HGMMA, {hmma} "
                  f"HMMA.16816)")
            spills = [x for x in ptxas if "spill stores" in x and
                      " 0 bytes spill stores, 0 bytes spill loads" not in x]
            check(log is None or (ptxas and not spills),
                  f"{func} spills registers: {spills or 'no ptxas report'}")


def phase_build():
    from sais_tpu_torch.kernels import _build
    t0 = time.time()
    # with the classification phase's probe of the 3xTF32 sums
    logs = _build.build(_build.SOURCES + ("tf32_sum_probe",))
    print(f"build: {len(logs)} source(s) compiled in "
          f"{time.time() - t0:.1f} s", flush=True)
    spilled = []
    for name, log in logs.items():
        spills = [line.strip() for line in log.splitlines()
                  if "spill stores" in line
                  and " 0 bytes spill stores, 0 bytes spill loads" not in line]
        for line in log.splitlines():
            if "entry function" in line or "registers" in line:
                print(f"  {name}: {line.strip()}")
        print(f"  {name}: {len(spills)} kernel(s) with spills"
              + "".join(f"; {line}" for line in spills), flush=True)
        if name in FLASH_KERNELS and spills:
            spilled.append(name)
    for name, fragments in FLASH_KERNELS.items():
        check_tf32_sass(name, fragments)
    check(not spilled, f"{', '.join(spilled)} spill registers")
    for name, fragments in ATTENTION_SASS.items():
        check_wgmma_sass(name, fragments, logs.get(name))


def k1_inputs(b, l, d, heads, mlp, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    shapes = [(d, 3 * d), (3 * d,), (d, d), (d,), (d, mlp), (mlp,),
              (mlp, d), (d,), (d,), (d,), (d,), (d,)]
    ws = [0.05 * torch.randn(s, generator=g) for s in shapes]
    ws[8] += 1.0
    ws[10] += 1.0
    x = torch.randn((b, l, d), generator=g)
    dev = dict(device="cuda", dtype=torch.bfloat16)
    return x.to(**dev), [w.to(**dev) for w in ws]


def library_block(x, lib_w, heads, valid_len, eps):
    """The same block as one composition of PyTorch library calls (the
    yardstick; the port never calls these for K1)."""
    import torch
    import torch.nn.functional as F
    (qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b, ln1_s, ln1_b,
     ln2_s, ln2_b) = lib_w
    b, l, d = x.shape
    y = F.layer_norm(x, (d,), ln1_s, ln1_b, eps)
    q, k, v = F.linear(y, qkv_w, qkv_b).view(b, l, 3, heads,
                                             d // heads).permute(2, 0, 3, 1, 4)
    mask = None
    if valid_len < l:
        mask = (torch.arange(l, device=x.device) < valid_len)[None, :]
    ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    x1 = x + F.linear(ctx.transpose(1, 2).reshape(b, l, d), proj_w, proj_b)
    y = F.layer_norm(x1, (d,), ln2_s, ln2_b, eps)
    h = F.gelu(F.linear(y, fc1_w, fc1_b), approximate="tanh")
    return x1 + F.linear(h, fc2_w, fc2_b)


def k1_bound_ms(b, l, d, mlp, weight_bytes):
    flops = 2 * b * l * d * (3 * d + d + 2 * mlp) + 4 * b * l * l * d
    nbytes = 2 * (2 * b * l * d) + weight_bytes
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def launch_split(fn, name, labels, flops, limit, extra=(), unit="TFLOP/s",
                 forbid=("gemm_kernel",), expect=(), executed=()):
    """Profiles five calls of fn (one call of a kernel's wrapper) and prints
    the device time of each of its launches, labelled in order by
    `labels`, with the rate (`unit`, 1e12 a second) of those in `flops`
    (label -> flops or integer operations) and of those in `extra` (other
    labelled work, e.g. K6's attention backward; beside it the rate of the
    operations its design executes, `executed`).  Fails unless a call
    makes exactly len(labels) launches, no more than `limit`, every
    product in `flops` ran on the wgmma + TMA kernel (`gemm_sm90_kernel`),
    no launch ran a kernel named by `forbid` (the mma.sync template
    `gemm_kernel`, or a kernel the redesign removed) and each label of
    `expect` (label -> kernel name fragment) ran the kernel it names.
    Returns {label: ms}."""
    check(len(labels) <= limit, f"{name}: {len(labels)} launches a call, "
          f"target <= {limit}")
    _, _, got = _profile(fn, name, 5, per_launch=len(labels))
    split, parts = {}, []
    for label, (kernel, us) in zip(labels, got["per_launch"]):
        for frag in forbid:
            check(frag not in kernel, f"{name}: {label} ran {kernel}, which "
                  f"this design no longer has ({frag})")
        split[label] = us / 1e3
        short = kernel.replace("(anonymous namespace)::", "").replace(
            "void ", "").replace("sm90::", "").split("(")[0]
        part = f"{label} [{short}] {us / 1e3:.4f} ms"
        if label in flops:
            check("gemm_sm90_kernel" in kernel,
                  f"{name}: {label} ran {kernel}, not the wgmma GEMM")
        want = dict(expect).get(label)
        check(want is None or want in short,
              f"{name}: {label} ran {kernel}, not {want}")
        work = dict(flops, **dict(extra)).get(label)
        done = dict(executed).get(label)
        if work is not None and done is not None:
            part += (f" ({work / us / 1e6:.1f} {unit} needed, "
                     f"{done / us / 1e6:.1f} executed)")
        elif work is not None:
            part += f" ({work / us / 1e6:.1f} {unit})"
        parts.append(part)
    gemm_ms = sum(split[k] for k in flops)
    total = sum(split.values())
    print(f"{name} per launch ({len(labels)} a call, target <= {limit}): "
          f"{', '.join(parts)}; GEMMs {gemm_ms:.4f} ms "
          f"({sum(flops.values()) / gemm_ms / 1e9:.1f} {unit}), all "
          f"{total:.4f} ms", flush=True)
    return split


BLOCK_LAUNCHES = ("LN1", "qkv", "attention", "proj", "LN2", "fc1", "fc2")


def block_launch_split(fn, name, b, l, d, mlp):
    """K1's or K4's seven launches at (b, l) (`launch_split`), the
    attention on the register kernel up to 256 tokens (4 L^2 D flops an
    image, executed once), on the key-tiled one past them (the same 4 L^2 D
    needed, 6 L^2 D executed: S in both sweeps)."""
    m = b * l
    att = 4 * b * l * l * d
    long = l > SHORT_ATT_LEN
    launch_split(fn, f"{name} (B, L) = ({b}, {l})", BLOCK_LAUNCHES,
                 {"qkv": 6 * m * d * d, "proj": 2 * m * d * d,
                  "fc1": 2 * m * d * mlp, "fc2": 2 * m * mlp * d},
                 len(BLOCK_LAUNCHES), extra={"attention": att},
                 expect={"attention": LONG_ATTENTION if long
                         else "attention_kernel<"},
                 executed={"attention": att * 3 // 2 if long else att})


# K5's and K6's launches a call, in order, and the targets they are held to
K5_LAUNCHES = ("prep", "fc1", "dh", "dy", "ln_bwd", "dW2", "dW1", "sum")
K6_LAUNCHES = ("prep", "qkv", "dctx", "attention_bwd", "dWproj", "dWqkv",
               "dy", "ln_bwd", "sum")
# past 256 tokens the attention backward is two launches, key-tiled
K6_LONG_LAUNCHES = ("prep", "qkv", "dctx", "attention_bwd_rows",
                    "attention_bwd_cols", "dWproj", "dWqkv", "dy", "ln_bwd",
                    "sum")
K5_MAX_LAUNCHES, K6_MAX_LAUNCHES = 11, 12


def bwd_launch_split(k5, k6, b, l, d, mlp):
    """`k5_profile` and `k6_profile`: the launches of one K5 and one K6 call
    at (b, l), the products' TFLOP/s and the attention backward's share of
    K6 (its 12 L^2 D flops an image, the ones the function needs: past 256
    tokens 8 L^2 D of them in the query-row launch, s, dp, ctx and dq, and
    4 L^2 D in the key-column launch, dk and dv; both designs execute 20
    L^2 D: s and dp twice, ctx, dq, then s^T, dp^T, dv, dk, past 256
    tokens 12 L^2 D in the query-row launch and 8 in the key-column
    one)."""
    m = b * l
    prod = 2 * m * d * mlp
    launch_split(k5, f"k5_profile (B, L) = ({b}, {l})", K5_LAUNCHES,
                 dict.fromkeys(("fc1", "dh", "dy", "dW2", "dW1"), prod),
                 K5_MAX_LAUNCHES)
    att = 4 * b * l * l * d
    if l > SHORT_ATT_LEN:
        labels, extra = K6_LONG_LAUNCHES, {"attention_bwd_rows": 2 * att,
                                           "attention_bwd_cols": att}
        executed = {"attention_bwd_rows": 3 * att,
                    "attention_bwd_cols": 2 * att}
        expect = dict(zip(("attention_bwd_rows", "attention_bwd_cols"),
                          LONG_ATTENTION_BWD))
    else:
        labels, extra = K6_LAUNCHES, {"attention_bwd": 3 * att}
        executed = {"attention_bwd": 5 * att}
        expect = {"attention_bwd": "attention_bwd_kernel<"}
    split = launch_split(
        k6, f"k6_profile (B, L) = ({b}, {l})", labels,
        {"qkv": 6 * m * d * d, "dctx": 2 * m * d * d,
         "dWproj": 2 * m * d * d, "dWqkv": 6 * m * d * d,
         "dy": 6 * m * d * d}, K6_MAX_LAUNCHES, extra=extra, expect=expect,
        executed=executed)
    att_ms = sum(split[k] for k in extra)
    print(f"k6_profile (B, L) = ({b}, {l}): attention backward "
          f"{att_ms:.4f} ms, {100 * att_ms / sum(split.values()):.1f}% of "
          f"the call", flush=True)


def phase_k1(parent=None):
    """Phase 3; `parent`: a ParentKernels to time beside K1 at (256,
    197), where both trees run the same code (outputs bitwise equal)."""
    import torch
    from sais_tpu_torch.kernels.fused_mha import (fused_vit_block,
                                                  vit_block_reference)
    b, d, heads, mlp, valid = 256, 384, 6, 1536, 197
    result = {}
    worst = 0.0
    for l in (197, 208):
        x, ws = k1_inputs(b, l, d, heads, mlp, seed=l)
        kw = dict(num_heads=heads, valid_len=valid, eps=1e-6)
        out = fused_vit_block(x, *ws, **kw)
        torch.cuda.synchronize()
        ref = vit_block_reference(x, *ws, **kw)
        diff = (out[:, :valid].float() - ref[:, :valid].float()).abs()
        err, scale = diff.max().item(), ref[:, :valid].float().abs().max().item()
        # Limit 2e-2 * max|ref|: the two round at the same points and differ
        # only in summation order, which moves a bf16 result by an ulp or
        # two (2**-8 relative); 2e-2 leaves room for that at the largest
        # values and catches any wrong tile, mask or rounding point.
        print(f"K1 L={l} valid={valid}: max|kernel-plain| {err:.6g}, "
              f"max|plain| {scale:.6g}, mean|diff| "
              f"{diff.mean().item():.3g}", flush=True)
        check(math.isfinite(err) and err <= 2e-2 * scale,
              f"K1 disagrees with its plain version at L={l}: {err} > "
              f"2e-2 * {scale}")
        worst = max(worst, err)
        if l != valid:
            continue
        lib_w = [w.t().contiguous() if w.dim() == 2 else w for w in ws]
        lib_err = (library_block(x, lib_w, heads, valid, 1e-6).float()
                   - ref.float()).abs().max().item()
        ms = cuda_time_ms(lambda: fused_vit_block(x, *ws, **kw))
        plain_ms = cuda_time_ms(lambda: vit_block_reference(x, *ws, **kw),
                                iters=5, warmup=1)
        library_ms = cuda_time_ms(
            lambda: library_block(x, lib_w, heads, valid, 1e-6))
        weight_bytes = sum(w.numel() * w.element_size() for w in ws)
        bound_ms, bound_by, flops, nbytes = k1_bound_ms(b, l, d, mlp,
                                                        weight_bytes)
        print(f"K1 B={b} L={l} D={d}: kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
              f"library {library_ms:.4f} ms (max|lib-plain| {lib_err:.3g}); "
              f"bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.1f} "
              f"GFLOP, {nbytes / 1e6:.1f} MB), kernel at "
              f"{100 * bound_ms / ms:.1f}% of the bound", flush=True)
        result = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                      bound_ms=bound_ms, bound_by=bound_by)
        block_launch_split(lambda: fused_vit_block(x, *ws, **kw),
                           "k1_profile", b, l, d, mlp)
        if parent is not None:
            parent.compare("K1", (b, l, d), lambda: parent.k1(x, ws, **kw),
                           lambda: fused_vit_block(x, *ws, **kw), {0: 0.0})
        del x, ws, out, ref, diff
    result["max_abs_err"] = worst
    return result


def k2_inputs(b, l, seed, masked):
    """q, k, v (b, 4, l, 96) on the card; with `masked`, element i keeps
    l - (37 i mod l) keys and the last element none."""
    import torch
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((b, 4, l, 96), generator=g).cuda()
               for _ in range(3))
    valid = [l] * b
    if masked:
        valid = [l - (37 * i) % l for i in range(b - 1)] + [0]
    mask = (torch.arange(l)[None, :]
            >= torch.tensor(valid)[:, None]).cuda()
    return q, k, v, mask, valid


def flash_bound_ms(flops, nbytes):
    """(bound ms, bound by, f32 FFMA bound ms) of an f32 flash kernel whose
    products run in 3xTF32: three TF32 products per f32 product at the
    TF32 peak, against the bytes at the memory rate; beside it the bound
    of the same work on f32 FFMA (the route before the tensor cores)."""
    t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes",
            1e3 * max(flops / PEAK_F32_FLOPS, t_bytes))


def k2_bound_ms(b, h, l, dh, valid):
    """Least time for K2 on this data: 4 Dh flops for each (query, valid
    key) pair at the card's f32-accurate rate, both products in 3xTF32
    (three TF32 products at the TF32 peak), against q, k, v, the bias read
    once and out, lse written once.  -> (bound ms, bound by, flops, bytes,
    f32 FFMA bound ms, bound ms of the route K2 takes: q' K^T in 3xTF32,
    P V on f32 FFMA).  The last two are for information only."""
    flops = 4 * h * l * dh * sum(valid)
    nbytes = 4 * (4 * b * h * l * dh + b * l + b * h * l)
    bound, by, ffma = flash_bound_ms(flops, nbytes)
    t_route = max(1.5 * flops / PEAK_TF32_FLOPS + 0.5 * flops
                  / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
    return bound, by, flops, nbytes, ffma, 1e3 * t_route


def _fwd_f64(q, k, v, bias):
    """K2's formulas evaluated in float64 on the card (elements with a
    valid key): the yardstick of accuracy for the kernel and its plain
    version."""
    import torch
    q, k, v = (t.double() for t in (q, k, v))
    s = torch.einsum("bhld,bhmd->bhlm", q * q.shape[-1] ** -0.5, k)
    s = s + bias.double()[:, None, None, :]
    lse = torch.logsumexp(s, -1)
    return torch.einsum("bhlm,bhmd->bhld", torch.exp(s - lse[..., None]),
                        v), lse


def phase_k2():
    import numpy as np
    import torch
    import torch.nn.functional as F
    from sais_tpu_torch.config import ModelConfig, TemporalConfig
    from sais_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_fwd, flash_attention_reference,
        key_bias)
    from sais_tpu_torch.models.full_model import (full_model_init,
                                                  prototypes_forward,
                                                  prototypes_init)
    from sais_tpu_torch.models.heads import prototype_probs

    worst = 0.0
    for b, l in ((8, 2001), (132, 301)):
        q, k, v, mask, valid = k2_inputs(b, l, seed=l, masked=True)
        bias = key_bias(mask)
        out = flash_attention(q, k, v, mask)
        _, lse = flash_attention_fwd(q, k, v, bias)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_reference(q, k, v, bias)
        ref[-1] = 0.0      # flash_attention's all-masked element
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        lerr = (lse[:-1] - ref_lse[:-1]).abs().max().item()
        lscale = max(1.0, ref_lse[:-1].abs().max().item())
        zero = torch.count_nonzero(out[-1]).item()
        x_out, x_lse = _fwd_f64(q[:-1], k[:-1], v[:-1], bias[:-1])
        f64 = (f"out kernel-f64 {(out[:-1].double() - x_out).abs().max():.3g}"
               f", plain-f64 {(ref[:-1].double() - x_out).abs().max():.3g}; "
               f"lse kernel-f64 {(lse[:-1].double() - x_lse).abs().max():.3g}"
               f", plain-f64 "
               f"{(ref_lse[:-1].double() - x_lse).abs().max():.3g}")
        del x_out, x_lse
        # Limits: both compute in f32 and differ only in summation order
        # and the online rescaling, a few f32 ulps: 1e-4 of the largest
        # value.  The all-masked element is exactly 0 and its lse -1e30.
        print(f"K2 (B*S, L) = ({b}, {l}), keys kept {valid[:3]}..."
              f"{valid[-2:]}: max|out-plain| {err:.4g} (max|plain| "
              f"{scale:.4g}), max|lse-plain| {lerr:.4g} (max|lse| "
              f"{lscale:.4g}), nonzero outputs of the all-masked element "
              f"{zero}; {f64}", flush=True)
        check(math.isfinite(err) and err <= 1e-4 * scale,
              f"K2 out disagrees at L={l}: {err} > 1e-4 * {scale}")
        check(math.isfinite(lerr) and lerr <= 1e-4 * lscale,
              f"K2 lse disagrees at L={l}: {lerr} > 1e-4 * {lscale}")
        check(zero == 0, f"all-masked element has {zero} nonzero outputs")
        check(bool((lse[-1] == ref_lse[-1]).all()),
              "all-masked element's lse differs from the plain version")
        worst = max(worst, err)
        del q, k, v, out, ref, lse, ref_lse

    # Times at the steps path's shape (its keys are all valid, the mask
    # is all False as GestureDecoder passes it) and at (8, 2001) masked.
    result = {}
    for b, l, masked in ((132, 301, False), (8, 2001, True)):
        q, k, v, mask, valid = k2_inputs(b, l, seed=b, masked=masked)
        bias = key_bias(mask)
        lib_mask = bias[:, None, None, :]
        ms = cuda_time_ms(lambda: flash_attention(q, k, v, mask))
        plain_ms = cuda_time_ms(
            lambda: flash_attention_reference(q, k, v, bias), iters=5,
            warmup=1)
        library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=lib_mask))
        lib_err = (F.scaled_dot_product_attention(
            q, k, v, attn_mask=lib_mask)[:b - 1]
            - flash_attention(q, k, v, mask)[:b - 1]).abs().max().item()
        bound_ms, bound_by, flops, nbytes, ffma_ms, route_ms = k2_bound_ms(
            b, 4, l, 96, valid)
        print(f"K2 B*S={b} H=4 L={l} Dh=96{' masked' if masked else ''}: "
              f"kernel {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, library (SDPA, f32 additive mask) "
              f"{library_ms:.4f} ms (max|lib-kernel| {lib_err:.3g}); bound "
              f"{bound_ms:.4f} ms by {bound_by}, both products in 3xTF32 "
              f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), kernel at "
              f"{100 * bound_ms / ms:.1f}% of the bound; for information: "
              f"K2's route (q' K^T in 3xTF32, P V on f32 FFMA) "
              f"{route_ms:.4f} ms, both on f32 FFMA {ffma_ms:.4f} ms",
              flush=True)
        if not result:
            result = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
            _profile(lambda: flash_attention(q, k, v, mask), "k2_profile",
                     5)
        del q, k, v
    result["max_abs_err"] = worst

    # Auto mode on the card: a 2001-token window takes K2.
    cfg = ModelConfig(modalities="RGB")
    dense_cfg = ModelConfig(modalities="RGB",
                            temporal=TemporalConfig(use_flash=False))
    model = full_model_init(torch.Generator().manual_seed(3), cfg).cuda()
    protos = prototypes_init(torch.Generator().manual_seed(4), 3)[1].cuda()
    rgb = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (8, 1, 2000, 384)).astype(np.float32)).cuda()
    rgb_mask = torch.zeros((8, 1, 2001), dtype=torch.bool).cuda()
    with torch.inference_mode():
        flash_attention.launches = 0
        out = prototypes_forward(model, cfg, rgb, rgb_mask)
        torch.cuda.synchronize()
        auto_launches = flash_attention.launches
        dense = prototypes_forward(model, dense_cfg, rgb, rgb_mask)
        perr = (prototype_probs(out.video_rep, protos)
                - prototype_probs(dense.video_rep, protos)).abs().max().item()
    print(f"auto mode, prototypes_forward (8, 1, 2000, 384): K2 launches "
          f"{auto_launches}, attention {tuple(out.attn.shape)}, max|prob "
          f"flash - dense| {perr:.3g}", flush=True)
    check(auto_launches == cfg.temporal.num_layers,
          f"auto mode launched K2 {auto_launches} times at 2001 tokens, "
          f"expected {cfg.temporal.num_layers}")
    check(tuple(out.attn.shape) == (8, 2001), "flash path attention shape")
    # Limit 5e-4: the JAX package's own flash-vs-dense limit
    # (tests/test_flash_wiring.py).
    check(perr <= 5e-4, f"auto-mode probabilities differ from dense: {perr}")
    return result


def _profile_window(fn, steps: int, per_launch: int):
    """One torch.profiler window over `steps` calls of fn -> (profiler,
    wall us, launch calls of fn on the host, kernel records of fn's
    launches on the device, spin records dropped)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # The profiler drops the first device records of a window: none
        # early in the process, 6 to 23 after some minutes of work (card
        # probes).  Spin launches take that loss before the calls.
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            if per_launch:
                # a marker launch before every call (and after the last)
                # brackets each call's launches on the device timeline
                torch.cuda._sleep(1)
            fn()
        if per_launch:
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # every launch call on the host has one kernel record on the device in
    # a window the profiler kept whole (copies are not counted either side;
    # the spin launches, pad and markers, are not counted)
    spins = PROFILE_PAD + (steps + 1 if per_launch else 0)
    launched = sum(1 for e in prof.events() if e.device_type == DeviceType.CPU
                   and e.name in LAUNCH_CALLS) - spins
    kept = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))
               and MARKER not in e.name)
    dropped = spins - sum(1 for e in prof.events()
                          if e.device_type == DeviceType.CUDA
                          and MARKER in e.name)
    return prof, wall_us, launched, kept, dropped


def _profile(fn, name: str, steps: int, shares=None, ranges=(),
             per_launch: int = 0):
    """torch.profiler over `steps` calls of fn: prints the per-kernel table
    and the device's busy time (the union of its kernel and copy
    intervals) against the host's wall time.  `shares`: label -> kernel
    name fragment, whose summed device time is printed as a share of the
    busy time; `ranges`: names of record_function ranges whose device time
    is printed the same way.  `per_launch`: the number of device launches
    one call of fn makes, in a fixed order; their names and mean device
    times go to got["per_launch"] (the run fails if the calls differ).
    Each window opens with PROFILE_PAD spin launches, which take the
    profiler's loss of a window's first device records.  A window that
    still kept fewer kernel records of fn's launches than the host made
    launch calls is taken again, up to three windows; the one that kept
    most is read, with its count printed beside its readings, and the run
    fails if it lacks more than max(2, 2%) of them or holds no device
    time.  Returns (busy us, wall us, {label: us})."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(3):
        w = _profile_window(fn, steps, per_launch)
        if best is None or w[3] - w[2] > best[3] - best[2]:
            best = w
        if w[3] >= w[2]:
            break
        print(f"{name}: the profiler kept {w[3]} kernel records of {w[2]} "
              f"launches", flush=True)
    prof, wall_us, launched, kept, dropped = best
    check(launched - kept <= max(2, launched // 50),
          f"{name}: the profiler kept {kept} kernel records of {launched} "
          f"launches in its best of three windows")
    kept_note = ("" if kept >= launched else
                 f", {kept} kernel records of {launched} launches kept")
    if dropped:
        kept_note += f", {dropped} spin records dropped"
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and MARKER not in e.name)
    busy_us, end = 0.0, -math.inf
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    check(busy_us > 0, f"{name}: no device time in the window")
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=25)
    print(f"{name} ({steps} calls): device busy {busy_us:.0f} us of "
          f"{wall_us:.0f} us wall ({100 * (1 - busy_us / wall_us):.1f}% "
          f"idle{kept_note})\n{table}", flush=True)
    got = {}
    for label, frag in (shares or {}).items():
        got[label] = sum(e.time_range.end - e.time_range.start
                         for e in prof.events()
                         if e.device_type == DeviceType.CUDA
                         and frag in e.name)
        print(f"{name}: {label} {got[label]:.0f} us, "
              f"{100 * got[label] / busy_us:.1f}% of device busy time",
              flush=True)
    if per_launch:
        events = sorted((e.time_range.start, e.time_range.end, e.name)
                        for e in prof.events()
                        if e.device_type == DeviceType.CUDA)
        # The profiler can lose launches of its window, at its start and
        # elsewhere; counted from the window's end, a loss shifted which
        # launch each label read.  The markers cut the timeline into calls:
        # a call is read only when it lies between two markers and holds
        # exactly per_launch launches, so a lost launch drops its call and
        # cannot shift a label, while a wrapper that makes more or fewer
        # launches leaves no call to read.
        calls, seg = [], None
        for e in events:
            if MARKER in e[2]:
                if seg is not None:
                    calls.append(seg)
                seg = []
            elif seg is not None:
                seg.append(e)
        whole = [c for c in calls if len(c) == per_launch]
        check(len(whole) >= steps - 2,
              f"{name}: {len(whole)} of {steps} calls read whole, expected "
              f"{per_launch} launches a call; launches between markers: "
              f"{[len(c) for c in calls]}")
        got["per_launch"] = []
        for i in range(per_launch):
            names = {c[i][2] for c in whole}
            check(len(names) == 1, f"{name}: launch {i} of a call ran "
                  f"different kernels: {sorted(names)}")
            got["per_launch"].append((names.pop(), sum(
                c[i][1] - c[i][0] for c in whole) / len(whole)))
    averages = prof.key_averages()
    for label in ranges:
        # a range can appear twice (its CPU event and its annotation on the
        # device timeline); the entry that carries the kernels' time counts
        entries = [e for e in averages if e.key == label] or [None]
        e = max(entries, key=lambda e: 0.0 if e is None else getattr(
            e, "device_time_total", getattr(e, "cuda_time_total", 0.0)))
        us = 0.0 if e is None else getattr(
            e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
        got[label] = us
        print(f"{name}: {label} {us:.0f} us of device time in "
              f"{0 if e is None else e.count} calls, "
              f"{100 * us / busy_us:.1f}% of device busy time", flush=True)
    return busy_us, wall_us, got


def phase_main_path(nframes: int):
    import numpy as np
    import torch
    from sais_tpu_torch.config import ModelConfig, PipelineConfig
    from sais_tpu_torch.infer.pipeline import FeatureExtractor, GestureDecoder
    from sais_tpu_torch.infer.postprocess import write_rows_csv
    from sais_tpu_torch.kernels.flash_attention import flash_attention
    from sais_tpu_torch.kernels.fused_mha import fused_vit_block
    from sais_tpu_torch.models.full_model import (full_model_init,
                                                  prototypes_init)
    from sais_tpu_torch.models.vit import vit_forward_fused, vit_init
    from sais_tpu_torch.ops.preprocess import preprocess_batch

    cfg = PipelineConfig(model=ModelConfig(modalities="RGB"))
    vit = vit_init(torch.Generator().manual_seed(0), cfg.vit)
    fold = (full_model_init(torch.Generator().manual_seed(1), cfg.model),
            prototypes_init(torch.Generator().manual_seed(2), 2)[1])
    frames = np.random.default_rng(0).integers(
        0, 256, (nframes, 480, 640, 3), dtype=np.uint8)
    fx = FeatureExtractor(vit, cfg, batch_size=256)
    dec = GestureDecoder([fold], cfg)
    # warm-up at the same shapes: pinned host buffers of both batch sizes,
    # cuBLAS handles, first launches
    dec.decode("smoke", fx.extract_array(frames))
    torch.cuda.synchronize()

    fused_vit_block.launches = flash_attention.launches = 0
    t0 = time.perf_counter()
    feats = fx.extract_array(frames)
    t1 = time.perf_counter()
    rows = dec.decode("smoke", feats)
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "Custom_inference_gestures.csv")
        write_rows_csv(rows, csv)
        csv_ok = os.path.getsize(csv) > 0
    t2 = time.perf_counter()
    launches, k2_launches = fused_vit_block.launches, flash_attention.launches

    # Two more extractions, for the median: the host's staging copy of raw
    # frames varies from run to run on a shared host.
    extract_s = [t1 - t0]
    for _ in range(2):
        t = time.perf_counter()
        fx.extract_array(frames)
        extract_s.append(time.perf_counter() - t)
    median_s = sorted(extract_s)[1]
    batches = math.ceil(nframes / fx.batch_size)
    print(f"main path: {nframes} frames of 480x640, {batches} batches: "
          f"extract {median_s:.4f} s median of "
          f"{', '.join(f'{s:.4f}' for s in extract_s)} "
          f"({nframes / median_s:.1f} frames/s), decode + CSV "
          f"{t2 - t1:.4f} s, {len(rows)} intervals; K1 launches {launches}, "
          f"K2 launches {k2_launches}", flush=True)
    check(launches == 12 * batches,
          f"K1 launched {launches} times on the main path, expected "
          f"{12 * batches}")
    check(k2_launches == 0,
          f"K2 launched {k2_launches} times on 16-token gesture windows")
    check(csv_ok, "no CSV written")
    check(feats.shape == (nframes, 384) and np.isfinite(feats).all(),
          f"features {feats.shape} not finite / wrong shape")
    probs = dec.window_probs("smoke", feats)
    nwin = (nframes - 15) // 15 + 1
    check(probs.shape == (nwin, 2) and np.isfinite(probs).all(),
          f"window probabilities {probs.shape} not finite / wrong shape")
    check(np.abs(probs.sum(-1) - 1).max() <= 1e-5,
          "window probabilities do not sum to 1")

    # The same extraction through K1's plain version on the card.
    plain = []
    with torch.inference_mode():
        for i in range(0, nframes, fx.batch_size):
            x = preprocess_batch(
                torch.from_numpy(frames[i:i + fx.batch_size]).cuda(),
                cfg.preprocess, torch.bfloat16)
            with _Annotated(plain=True):
                plain.append(vit_forward_fused(fx.model, x))
    plain = torch.cat(plain).cpu().numpy()
    ferr, fscale = np.abs(feats - plain).max(), np.abs(plain).max()
    perr = np.abs(probs - dec.window_probs("smoke", plain)).max()
    # Limits: CLS features after 12 bf16 blocks, 5e-2 of the largest value
    # (a few bf16 ulps carried through the depth); window probabilities,
    # which average 3 TTA offsets of a float32 model, within 1e-2.
    print(f"main path vs plain version: max|feature diff| {ferr:.5g} "
          f"(max|feature| {fscale:.5g}, corr "
          f"{np.corrcoef(feats.ravel(), plain.ravel())[0, 1]:.6f}), "
          f"max|prob diff| {perr:.3g}", flush=True)
    check(ferr <= 5e-2 * fscale, f"features differ: {ferr} > 5e-2 * {fscale}")
    check(perr <= 1e-2, f"window probabilities differ by {perr}")
    _profile(lambda: fx.extract_array(frames), "extract_profile", 1)
    _profile(lambda: dec.decode("smoke", feats), "decode_profile", 1)
    return launches, feats


class _MemoryReader:
    """Stands in for io.video.VideoReader in the serve phase: the card
    machine has no OpenCV, so the daemon's decode reads frames kept in
    memory under the video's path (its file a placeholder)."""

    videos = {}

    def __init__(self, path):
        self._frames = self.videos[path]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    fps = 30.0

    def frames(self):
        yield from self._frames

    def batches(self, batch_size):
        for i in range(0, len(self._frames), batch_size):
            yield self._frames[i:i + batch_size]


def _serve_daemon(svc, sock):
    """serve(svc) on a Unix socket in a thread, its log lines printed;
    returns the thread once the socket is open."""
    import threading
    from sais_tpu_torch.cli.serve import serve
    t = threading.Thread(target=serve, args=(svc, sock), kwargs={
        "log": lambda line: print(f"serve daemon: {line}", flush=True)},
        daemon=True)
    t.start()
    deadline = time.time() + 60
    while not os.path.exists(sock) and time.time() < deadline:
        time.sleep(0.05)
    check(os.path.exists(sock), "the serve daemon did not open its socket")
    return t


def phase_serve(card: str, nframes: int = 300):
    """`serve` / `request` at full width: the daemon of cli/serve.py over
    the gesture path's models (ViT-S/16 on K1, bf16, batch 256; one fold
    of the 4-layer temporal model, 3 TTA offsets), 300 frames of 480x640 a
    video.  One RGB daemon answers ping, request A, request B sent while A
    is in flight (B's host decode starts on the prefetch path), a ping
    during A, stats and a shutdown that drains; K1 launches 12 times a
    frame batch a request and K2 never.  One RGB-Flow daemon, after
    warmup_flow(480, 640), answers a flow request.  Each request is held
    against the in-process route on the same frames
    (FeatureExtractor.extract_array, FlowExtractor.extract_video,
    GestureDecoder.window_probs, then GestureDecoder.decode): the reps
    that reached the daemon's decoder within 1e-3 of their max |value|,
    its window probabilities within 1e-3, and its CSV equal as text.  The
    randomly initialised decoder's probabilities sit near 1/2, where
    every window's entropy passes the default 0.66 (ln 2 = 0.693), so no
    row would be written; both routes decode with an entropy threshold of
    1.0, which keeps every window, so each CSV has rows to compare.
    Returns K1's launches."""
    import threading

    import numpy as np
    import torch
    from sais_tpu_torch.cli.serve import DecodeService, request
    from sais_tpu_torch.config import (ModelConfig, PipelineConfig,
                                       PostprocessConfig)
    from sais_tpu_torch.infer import pipeline
    from sais_tpu_torch.infer.postprocess import write_rows_csv
    from sais_tpu_torch.kernels.flash_attention import flash_attention
    from sais_tpu_torch.kernels.fused_mha import fused_vit_block
    from sais_tpu_torch.models.full_model import (full_model_init,
                                                  prototypes_init)
    from sais_tpu_torch.models.raft import raft_init
    from sais_tpu_torch.models.vit import vit_init

    post = PostprocessConfig(entropy_threshold=1.0)
    cfg = PipelineConfig(model=ModelConfig(modalities="RGB"),
                         postprocess=post)
    fcfg = PipelineConfig(model=ModelConfig(modalities="RGB-Flow"),
                          postprocess=post)
    vit = vit_init(torch.Generator().manual_seed(0), cfg.vit)
    fold = (full_model_init(torch.Generator().manual_seed(1), cfg.model),
            prototypes_init(torch.Generator().manual_seed(2), 2)[1])
    ffold = (full_model_init(torch.Generator().manual_seed(4), fcfg.model),
             prototypes_init(torch.Generator().manual_seed(5), 2)[1])
    raft = raft_init(torch.Generator().manual_seed(3), fcfg.raft)
    rng = np.random.default_rng(0)
    frames = {"A": rng.integers(0, 256, (nframes, 480, 640, 3), np.uint8),
              "B": rng.integers(0, 256, (nframes, 480, 640, 3), np.uint8),
              "F": np.stack(texture_frames(nframes))}
    batches = math.ceil(nframes / 256)
    saved = (pipeline.VideoReader, pipeline.FeatureExtractor._pump)
    pipeline.VideoReader = _MemoryReader
    pipeline.FeatureExtractor._pump = lambda self, path: None
    print("serve: the card machine has no OpenCV, so this phase replaces "
          "the daemon's video reader (infer.pipeline.VideoReader, and the "
          "frame pump) with frames held in memory under each video's path; "
          "the files under <tmp>/videos/ are empty placeholders", flush=True)
    root = tempfile.mkdtemp(prefix="serve_")
    try:
        os.makedirs(os.path.join(root, "videos"))
        for name, f in frames.items():
            path = os.path.join(root, "videos", f"{name}.mp4")
            open(path, "wb").close()
            _MemoryReader.videos[path] = f

        seen = {}   # video -> what the daemon's decoder was given

        def trace_decoder(dec):
            decode, window_probs = dec.decode, dec.window_probs

            def traced_decode(video, rgb_reps, flow_reps=None):
                seen[video] = {"rgb": rgb_reps, "flow": flow_reps}
                return decode(video, rgb_reps, flow_reps)

            def traced_probs(video, rgb_reps, flow_reps=None):
                probs = window_probs(video, rgb_reps, flow_reps)
                seen.setdefault(video, {})["probs"] = probs
                return probs

            dec.decode, dec.window_probs = traced_decode, traced_probs

        errs = {}

        def hold_to_reference(name, dec_cfg, dec_fold, flow=None):
            """The request's reps, probabilities and CSV against the
            in-process route on the same frames."""
            fx = pipeline.FeatureExtractor(vit, dec_cfg, batch_size=256)
            rgb = fx.extract_array(frames[name])
            dec = pipeline.GestureDecoder([dec_fold], dec_cfg)
            got = seen.get(name, {})
            check("probs" in got, f"serve: request {name} never reached "
                  "the decoder")
            pairs = [("rgb", got["rgb"], rgb)]
            if flow is not None:
                pairs.append(("flow", got["flow"], flow))
            for what, a, b in pairs:
                check(a is not None and a.shape == b.shape
                      and np.isfinite(a).all(),
                      f"serve: request {name}'s {what} reps "
                      f"{None if a is None else a.shape} vs {b.shape}")
                err = float(np.abs(a - b).max())
                errs[f"{name} {what}"] = err
                check(err <= 1e-3 * float(np.abs(b).max()),
                      f"serve: request {name}'s {what} reps differ from "
                      f"the in-process route by {err:.3g}")
            probs = dec.window_probs(name, rgb, flow)
            check(got["probs"].shape == probs.shape and len(probs) > 0,
                  f"serve: request {name}'s window probabilities "
                  f"{got['probs'].shape} vs {probs.shape}")
            err = float(np.abs(got["probs"] - probs).max())
            errs[f"{name} probs"] = err
            check(err <= 1e-3, f"serve: request {name}'s window "
                  f"probabilities differ by {err:.3g} (limit 1e-3)")
            rows = dec.decode(name, rgb, flow)
            check(len(rows) > 0 and res[name]["intervals"] == len(rows),
                  f"serve: request {name} wrote {res[name]['intervals']} "
                  f"intervals, the in-process route {len(rows)}")
            path = os.path.join(root, f"{name}_reference.csv")
            write_rows_csv(rows, path)
            with open(path) as f, open(res[name]["csv"]) as g:
                check(g.read() == f.read(),
                      f"serve: request {name}'s CSV differs from the "
                      "in-process route's")

        # the RGB daemon
        svc = DecodeService(root, cfg, vit, [fold], batch_size=256)
        trace_decoder(svc.decoder)
        t0 = time.perf_counter()
        svc.warmup()
        warm_s = time.perf_counter() - t0
        b_opened, a_started = threading.Event(), threading.Event()
        prefetched, streams = [], []
        start_prefetch, decode_video = svc.start_prefetch, svc.decode_video

        def traced_prefetch(video):
            stream = start_prefetch(video)
            prefetched.append((video, stream is not None))
            b_opened.set()
            return stream

        def traced_decode(video, use_flow=False, rgb_stream=None):
            streams.append((video, rgb_stream is not None))
            if video == "A":   # A holds the card until B is queued
                a_started.set()
                b_opened.wait(60)
            return decode_video(video, use_flow, rgb_stream=rgb_stream)

        svc.start_prefetch, svc.decode_video = traced_prefetch, traced_decode
        sock = os.path.join(root, "rgb.sock")
        daemon = _serve_daemon(svc, sock)
        check(request(sock, {"cmd": "ping"}, timeout=60).get("pong"),
              "serve: no pong")
        fused_vit_block.launches = flash_attention.launches = 0
        res = {}
        ta = threading.Thread(target=lambda: res.update(
            A=request(sock, {"video": "A"}, timeout=600)))
        ta.start()
        check(a_started.wait(120), "serve: request A never started")
        t0 = time.perf_counter()
        pong = request(sock, {"cmd": "ping"}, timeout=60)
        ping_s = time.perf_counter() - t0
        tb = threading.Thread(target=lambda: res.update(
            B=request(sock, {"video": "B"}, timeout=600)))
        tb.start()
        ta.join(600)
        tb.join(600)
        k1, k2 = fused_vit_block.launches, flash_attention.launches
        stats = request(sock, {"cmd": "stats"}, timeout=60)
        check(request(sock, {"cmd": "shutdown"}, timeout=60).get("bye"),
              "serve: shutdown not acknowledged")
        daemon.join(120)
        check(not daemon.is_alive(), "serve: the daemon did not stop")
        check(pong.get("pong"), "serve: no pong during request A")
        for name in ("A", "B"):
            check(res.get(name, {}).get("ok"),
                  f"serve: request {name} failed: {res.get(name)}")
        check(("B", True) in prefetched and ("B", True) in streams,
              f"serve: B did not take the prefetch path ({prefetched}, "
              f"{streams})")
        check(k1 == 2 * 12 * batches and k2 == 0,
              f"serve: K1 launched {k1} times (expected {2 * 12 * batches})"
              f", K2 {k2} times (expected 0) over requests A and B")
        for name in ("A", "B"):
            hold_to_reference(name, cfg, fold)

        # the RGB-Flow daemon
        fsvc = DecodeService(root, fcfg, vit, [ffold], raft=raft,
                             batch_size=256)
        trace_decoder(fsvc.decoder)
        fsvc.warmup()
        t0 = time.perf_counter()
        fsvc.warmup_flow(480, 640)
        flow_warm_s = time.perf_counter() - t0
        fsock = os.path.join(root, "flow.sock")
        fdaemon = _serve_daemon(fsvc, fsock)
        fused_vit_block.launches = 0
        res["F"] = request(fsock, {"video": "F", "flow": True}, timeout=600)
        fk1 = fused_vit_block.launches
        check(request(fsock, {"cmd": "shutdown"}, timeout=60).get("bye"),
              "serve: the flow daemon's shutdown not acknowledged")
        fdaemon.join(120)
        check(res["F"].get("ok"), f"serve: the flow request failed: "
              f"{res['F']}")
        flow_reps = pipeline.FlowExtractor(raft, vit, fcfg).extract_video(
            None, frame_source=iter(frames["F"]))
        hold_to_reference("F", fcfg, ffold, flow_reps)
    finally:
        pipeline.VideoReader, pipeline.FeatureExtractor._pump = saved
        _MemoryReader.videos.clear()
        shutil.rmtree(root, ignore_errors=True)
    line = "; ".join(
        f"{name} {r['seconds']:.2f} s ({r['frames'] / r['seconds']:.1f} "
        f"frames/s, {r['intervals']} intervals)" for name, r in res.items())
    print(f"serve: warm-up {warm_s:.2f} s (RGB), flow warm-up at 480x640 "
          f"{flow_warm_s:.2f} s; requests {line}; ping during A "
          f"{1e3 * ping_s:.1f} ms; stats p50 {stats['p50_s']} s, p95 "
          f"{stats['p95_s']} s over {stats['requests']} requests; K1 "
          f"launches {k1} (A and B), {fk1} (F), K2 {k2}; max |daemon - "
          f"in-process|: "
          f"{', '.join(f'{k} {v:.3g}' for k, v in errs.items())}; {card}",
          flush=True)
    return k1 + fk1


def phase_eval_attention(card: str):
    """eval / attention on the card, each reading against the same call on
    the CPU: the weighted k-NN over 50,000 x 384 train and 10,000 test
    features (20 classes, numpy seed 0; top-1 / top-5 within 0.05 points,
    the rows whose vote differs printed), the linear probe for 10 epochs
    (weights within 1e-4 of their largest value), cls_attention_maps and
    vit_intermediate_layers(n=4) at ViT-S/16, 224 px, batch 32, float32
    (1e-4 of the largest value), and zoo.create("vitb8")'s forward pass on
    the card."""
    import numpy as np
    import torch
    from sais_tpu_torch.config import ViTConfig
    from sais_tpu_torch.eval.attention_viz import cls_attention_maps
    from sais_tpu_torch.eval.probes import (knn_classifier, knn_votes,
                                            train_linear_probe)
    from sais_tpu_torch.models import zoo
    from sais_tpu_torch.models.vit import (vit_features, vit_init,
                                           vit_intermediate_layers)

    rng = np.random.default_rng(0)
    centers = rng.standard_normal((20, 384)).astype(np.float32)
    ytr, yte = rng.integers(0, 20, 50000), rng.integers(0, 20, 10000)
    # class means 0.15 a dimension under unit noise: a hard vote
    xtr = (0.15 * centers[ytr] + rng.standard_normal(
        (50000, 384))).astype(np.float32)
    xte = (0.15 * centers[yte] + rng.standard_normal(
        (10000, 384))).astype(np.float32)
    acc, secs, votes = {}, {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        acc[dev] = knn_classifier(xtr, ytr, xte, yte, k=20, device=dev)
        secs[dev] = time.perf_counter() - t0
        votes[dev] = knn_votes(xtr, ytr, xte, k=20, device=dev)
    differ = int((votes["cuda"].argmax(1) != votes["cpu"].argmax(1)).sum())
    print(f"eval: k-NN (50,000 x 384 train, 10,000 test, 20 classes, k 20) "
          f"card top-1 {acc['cuda'][0]:.2f} top-5 {acc['cuda'][1]:.2f} in "
          f"{secs['cuda']:.3f} s; CPU top-1 {acc['cpu'][0]:.2f} top-5 "
          f"{acc['cpu'][1]:.2f} in {secs['cpu']:.3f} s; {differ} of 10,000 "
          f"rows vote differently; {card}", flush=True)
    # Limit: 0.05 points, 5 of the 10,000 rows: a vote flips where two
    # similarities tie at float32 rounding
    for i, name in enumerate(("top-1", "top-5")):
        check(abs(acc["cuda"][i] - acc["cpu"][i]) <= 0.05,
              f"k-NN {name} differs: card {acc['cuda'][i]}, CPU "
              f"{acc['cpu'][i]}")
    probe = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        probe[dev] = train_linear_probe(xtr, ytr, xte, yte, num_classes=20,
                                        epochs=10, device=dev)
        secs[dev] = time.perf_counter() - t0
    werr = np.abs(probe["cuda"]["w"] - probe["cpu"]["w"]).max()
    wscale = np.abs(probe["cpu"]["w"]).max()
    print(f"eval: linear probe, 10 epochs: card top-1 "
          f"{probe['cuda']['top1']:.2f} in {secs['cuda']:.2f} s, CPU "
          f"{probe['cpu']['top1']:.2f} in {secs['cpu']:.2f} s; max|w card "
          f"- w CPU| {werr:.3g} (max|w| {wscale:.3g})", flush=True)
    # Limit: 1e-4 of the largest weight (float32 on both, 1,960 SGD steps)
    check(werr <= 1e-4 * wscale, f"linear probe weights differ: {werr} > "
          f"1e-4 * {wscale}")

    vit = vit_init(torch.Generator().manual_seed(0), ViTConfig()).eval()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (32, 224, 224, 3)).astype(np.float32))
    card_vit = vit_init(torch.Generator().manual_seed(0),
                        ViTConfig()).cuda().eval()
    xc = x.cuda()
    t0 = time.perf_counter()
    maps = cls_attention_maps(card_vit, xc)
    with torch.inference_mode():
        layers = [t.cpu() for t in vit_intermediate_layers(card_vit, xc, 4)]
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    ref_maps = cls_attention_maps(vit, x)
    with torch.inference_mode():
        ref_layers = vit_intermediate_layers(vit, x, 4)
    errs = [(np.abs(maps - ref_maps).max(), np.abs(ref_maps).max())] + [
        ((a - b).abs().max().item(), b.abs().max().item())
        for a, b in zip(layers, ref_layers)]
    print(f"attention: ViT-S/16 at 224, batch 32, float32: CLS maps "
          f"{maps.shape} and 4 intermediate layers on the card in "
          f"{card_s:.3f} s; max|card - CPU| (max|CPU|): "
          f"{', '.join(f'{e:.3g} ({m:.3g})' for e, m in errs)}", flush=True)
    # Limit: 1e-4 of the largest value (float32 on both, TF32 off)
    for e, m in errs:
        check(e <= 1e-4 * m, f"attention outputs differ: {e} > 1e-4 * {m}")
    model, zcfg = zoo.create("vitb8")
    with torch.inference_mode():
        feats = vit_features(model.cuda().eval(), xc[:2])
    check(tuple(feats.shape) == (2, zcfg.embed_dim)
          and bool(torch.isfinite(feats).all()),
          f"zoo.create('vitb8') forward: {tuple(feats.shape)} not finite / "
          f"wrong shape")
    print(f"zoo: create('vitb8') ({zcfg.depth} blocks, {zcfg.embed_dim} "
          f"wide, patch {zcfg.patch_size}) forward on the card: "
          f"{tuple(feats.shape)}", flush=True)


def texture_frames(nframes: int, h: int = 480, w: int = 640, step: int = 2,
                   seed: int = 0):
    """`nframes` views of one random texture of 8-pixel cells moving `step`
    pixels to the left a frame (numpy only: no cv2 on the card's
    machine)."""
    import numpy as np
    width = w + step * nframes
    cells = np.random.default_rng(seed).integers(
        0, 256, (h // 8, width // 8 + 1, 3), dtype=np.uint8)
    base = np.repeat(np.repeat(cells, 8, axis=0), 8, axis=1)
    return [base[:, step * i:step * i + w] for i in range(nframes)]


def raft_flops(model, h: int, w: int, iters: int):
    """Operations one pair needs at h x w (multiples of 8), counted from the
    conv shapes as 2 * cin * cout * kh * kw per output pixel: the feature
    encoder on both frames and the context encoder on the first, the
    all-pairs correlation (2 * N^2 * D over N = h/8 * w/8 pixels), `iters`
    passes of the update block's convolutions and the mask head once.
    The lookup, the GRU's gates and the upsampling are elementwise and not
    counted."""
    import torch.nn as nn

    def conv(c, scale):
        kh, kw = c.kernel_size
        return (2 * c.in_channels * c.out_channels * kh * kw
                * (h // scale) * (w // scale))

    def encoder(enc):
        total = conv(enc.conv1, 2) + conv(enc.conv2, 8)
        for i, scale in ((1, 2), (2, 4), (3, 8)):
            for blk in getattr(enc, f"layer{i}"):
                total += conv(blk.conv1, scale) + conv(blk.conv2, scale)
                if blk.downsample is not None:
                    total += conv(blk.downsample[0], scale)
        return total

    upd = model.update_block
    loop = [m for part in (upd.encoder, upd.gru, upd.flow_head)
            for m in part.modules() if isinstance(m, nn.Conv2d)]
    n = (h // 8) * (w // 8)
    return {"encoders": 2 * encoder(model.fnet) + encoder(model.cnet),
            "correlation": 2 * n * n * model.cfg.feature_dim,
            "update loop": iters * sum(conv(c, 8) for c in loop),
            "upsampling": conv(upd.mask[0], 8) + conv(upd.mask[2], 8)}


def raft_split_ms(model, cfg, a, b, iters: int):
    """CUDA-event ms of RAFT's stages on one batch of pairs (a, b: uint8 on
    the card) and of the whole forward, with the pipeline's dtypes."""
    import torch
    from sais_tpu_torch.models import raft as r
    bf16 = torch.bfloat16
    with torch.inference_mode(), r.full_f32():
        out = {"encoders": cuda_time_ms(
            lambda: r.encode(model, a, b, cfg, bf16), iters=5, warmup=1)}
        f1, f2, net, inp = r.encode(model, a, b, cfg, bf16)
        out["correlation"] = cuda_time_ms(
            lambda: r.corr_pyramid(f1, f2, cfg.corr_levels), iters=5,
            warmup=1)
        pyramid = r.corr_pyramid(f1, f2, cfg.corr_levels)
        out["update loop"] = cuda_time_ms(
            lambda: r.refine(model, pyramid, net, inp, cfg.corr_radius,
                             iters), iters=3, warmup=1)
        net, flow = r.refine(model, pyramid, net, inp, cfg.corr_radius,
                             iters)
        out["upsampling"] = cuda_time_ms(
            lambda: r.upsample_flow(flow,
                                    model.update_block.upsample_mask(net)),
            iters=5, warmup=1)
        del pyramid
        out["whole"] = cuda_time_ms(
            lambda: r.raft_forward(model, a, b, cfg, iters, bf16), iters=3,
            warmup=1)
    return out


def phase_flow(rgb_feats, card: str, nframes: int = 300):
    """The flow path: RAFT -> flow rendering -> ViT (K1) -> RGB-Flow
    decoding, at full width (phase 6 of the module docstring)."""
    import contextlib
    import copy

    import numpy as np
    import torch
    from sais_tpu_torch.config import ModelConfig, PipelineConfig
    from sais_tpu_torch.infer.pipeline import FlowExtractor, GestureDecoder
    from sais_tpu_torch.kernels.fused_mha import fused_vit_block
    from sais_tpu_torch.models import raft as raft_mod
    from sais_tpu_torch.models.full_model import (full_model_init,
                                                  prototypes_init)
    from sais_tpu_torch.models.vit import vit_forward_fused, vit_init
    from sais_tpu_torch.ops.flow_viz import (flow_to_rgb_device,
                                             flow_to_rgb_uint8)
    from sais_tpu_torch.ops.preprocess import preprocess_batch

    cfg = PipelineConfig(model=ModelConfig(modalities="RGB-Flow"))
    raft = raft_mod.raft_init(torch.Generator().manual_seed(3), cfg.raft)
    vit = vit_init(torch.Generator().manual_seed(0), cfg.vit)
    frames = texture_frames(nframes)
    jump = cfg.window.flow_jump_factor
    npairs = len(range(0, nframes - jump, jump))
    dev = torch.device("cuda")

    # 1. RAFT alone, float32 against float64 on the card.
    model = copy.deepcopy(raft).to(dev).eval()
    a = torch.from_numpy(np.ascontiguousarray(frames[0][:240, :320]))
    b = torch.from_numpy(np.ascontiguousarray(frames[jump][:240, :320]))
    a, b = a[None].to(dev), b[None].to(dev)
    with torch.inference_mode():
        f32 = raft_mod.raft_forward(model, a, b, iters=3).double()
        f64 = raft_mod.raft_forward(copy.deepcopy(model).double(), a, b,
                                    iters=3, compute_dtype=torch.float64)
    err = (f32 - f64).abs()
    print(f"flow: RAFT f32 vs f64 on the card at 240x320, 3 iterations: "
          f"max|diff| {err.max().item():.4g} (max|flow| "
          f"{f64.abs().max().item():.4g}), worst ratio to the limit "
          f"{(err / (2e-3 + 1e-3 * f64.abs())).max().item():.4g}",
          flush=True)
    # Limit: rtol 1e-3, atol 2e-3, the JAX package's own against the
    # golden torch RAFT (tests/test_raft_parity.py).
    check(bool((err <= 2e-3 + 1e-3 * f64.abs()).all()),
          "RAFT float32 differs from float64 beyond rtol 1e-3, atol 2e-3")
    # Printed, not checked: the pipeline's bf16 encoders, and TF32 in every
    # float32 convolution and product with cuDNN in the loop (what PyTorch
    # would do by default), against the same float64 evaluation.
    with torch.inference_mode():
        bf16 = raft_mod.raft_forward(model, a, b, iters=3,
                                     compute_dtype=torch.bfloat16).double()
    saved = (raft_mod.full_f32, raft_mod.without_cudnn,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        raft_mod.full_f32 = raft_mod.without_cudnn = contextlib.nullcontext
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with torch.inference_mode():
            tf32 = raft_mod.raft_forward(model, a, b, iters=3).double()
    finally:
        (raft_mod.full_f32, raft_mod.without_cudnn,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    print(f"flow: against the same float64 evaluation, bf16 encoders "
          f"max|diff| {(bf16 - f64).abs().max().item():.4g}, TF32 "
          f"everywhere max|diff| {(tf32 - f64).abs().max().item():.4g}",
          flush=True)

    # The path: warm-up, then the counted run and two more for the median.
    fx = FlowExtractor(raft, vit, cfg)
    fx.extract_video(None, frame_source=iter(frames))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_vit_block.launches = 0
    times = []
    t0 = time.perf_counter()
    reps = fx.extract_video(None, frame_source=iter(frames))
    times.append(time.perf_counter() - t0)
    launches = fused_vit_block.launches
    peak = torch.cuda.max_memory_allocated()
    for _ in range(2):
        t0 = time.perf_counter()
        fx.extract_video(None, frame_source=iter(frames))
        times.append(time.perf_counter() - t0)
    median_s = sorted(times)[1]
    pair_batch = fx.auto_pair_batch(480, 640)
    batches = math.ceil(npairs / pair_batch)
    print(f"{card}: flow path: {nframes} frames of 480x640, {npairs} pairs "
          f"(jump {jump}) in {batches} batches of {pair_batch}: "
          f"{median_s:.4f} s median of "
          f"{', '.join(f'{t:.4f}' for t in times)} "
          f"({npairs / median_s:.2f} pairs/s, host clock), peak device "
          f"memory {peak / 2**30:.2f} GiB; K1 launches {launches}",
          flush=True)
    check(launches == 12 * batches,
          f"K1 launched {launches} times on the flow path, expected "
          f"{12 * batches}")
    check(reps.shape == (npairs, 384) and np.isfinite(reps).all(),
          f"flow features {reps.shape} not finite / wrong shape")

    # 2.-4. The renderers, K1 against its plain version, fused against
    # staged.  The staged route is `extract`'s: flow fields to the host,
    # the host renderer, then extract_array.
    stack = np.stack(frames)
    fields = fx.flow_fields(stack)
    host_rgb = np.stack([flow_to_rgb_uint8(f) for f in fields])
    staged = fx._features.extract_array(host_rgb)
    dev_rgb = flow_to_rgb_device(torch.from_numpy(fields).to(dev))
    rdiff = np.abs(dev_rgb.cpu().numpy().astype(int) - host_rgb.astype(int))
    plain = []
    with torch.inference_mode(), _Annotated(plain=True):
        for i in range(0, npairs, fx._features.batch_size):
            x = preprocess_batch(dev_rgb[i:i + fx._features.batch_size],
                                 cfg.preprocess, torch.bfloat16)
            plain.append(vit_forward_fused(fx._features.model, x))
    plain = torch.cat(plain).cpu().numpy()
    kerr, kscale = np.abs(reps - plain).max(), np.abs(plain).max()
    serr, sscale = np.abs(reps - staged).max(), np.abs(staged).max()
    print(f"flow: device renderer vs host renderer on the path's {npairs} "
          f"flow fields (max|flow| {np.abs(fields).max():.4g}): max "
          f"{rdiff.max()} level(s), {100 * (rdiff == 0).mean():.4f}% equal; "
          f"flow features vs K1's plain version max|diff| {kerr:.5g} "
          f"(max {kscale:.5g}); fused vs staged route max|diff| {serr:.5g} "
          f"(max {sscale:.5g})", flush=True)
    check(rdiff.max() <= 1, f"renderers differ by {rdiff.max()} levels")
    # Limits: the gesture path's feature limit, 5e-2 of the largest value
    # (12 bf16 blocks; a colour one level off moves the staged route).
    check(kerr <= 5e-2 * kscale, f"flow features differ from K1's plain "
          f"version: {kerr} > 5e-2 * {kscale}")
    check(serr <= 5e-2 * sscale, f"fused and staged routes differ: {serr} "
          f"> 5e-2 * {sscale}")

    # 6. RGB-Flow decoding on the card against the CPU.
    fold = (full_model_init(torch.Generator().manual_seed(1), cfg.model),
            prototypes_init(torch.Generator().manual_seed(2), 2)[1])
    probs = GestureDecoder([fold], cfg).window_probs("smoke", rgb_feats,
                                                     reps)
    ref = GestureDecoder([fold], cfg, device="cpu").window_probs(
        "smoke", rgb_feats, reps)
    nwin = (len(rgb_feats) - 15) // 15 + 1
    perr = np.abs(probs - ref).max()
    print(f"flow: RGB-Flow window probabilities {probs.shape}, card vs "
          f"CPU max|diff| {perr:.3g}", flush=True)
    check(probs.shape == (nwin, 2) and np.isfinite(probs).all(),
          f"RGB-Flow probabilities {probs.shape} not finite / wrong shape")
    check(perr <= 1e-2, f"RGB-Flow probabilities differ by {perr}")

    # RAFT's time, split, and its rate against the counted operations.
    starts = np.arange(0, nframes - jump, jump)[:pair_batch]
    a = torch.from_numpy(stack[starts]).to(dev)
    b = torch.from_numpy(stack[starts + jump]).to(dev)
    del stack, fields, host_rgb, dev_rgb
    split = raft_split_ms(fx.raft, cfg.raft, a, b, cfg.raft.iters)
    flops = raft_flops(fx.raft, 480, 640, cfg.raft.iters)
    total = sum(flops.values())
    whole = split["whole"] / pair_batch
    print(f"{card}: RAFT at 480x640, batch {pair_batch}, "
          f"{cfg.raft.iters} iterations: {whole:.4f} ms per pair "
          f"({split['whole']:.3f} ms a batch), "
          f"{total / 1e12:.4f} TFLOP per pair, "
          f"{total / (whole * 1e-3) / 1e12:.2f} TFLOP/s; " + "; ".join(
              f"{k} {split[k] / pair_batch:.4f} ms per pair "
              f"({flops[k] / 1e9:.1f} GFLOP, "
              f"{flops[k] / (split[k] / pair_batch * 1e-3) / 1e12:.2f} "
              f"TFLOP/s)" for k in flops), flush=True)
    del a, b
    # Why the update loop runs without cuDNN: its heuristics give this
    # float32 convolution an FFT algorithm.
    conv = fx.raft.update_block.encoder.conv
    x = torch.randn((pair_batch, conv.in_channels, 60, 80), device=dev)
    with torch.inference_mode(), raft_mod.full_f32():
        t_cudnn = cuda_time_ms(lambda: conv(x), iters=3, warmup=1)
        with raft_mod.without_cudnn():
            t_gemm = cuda_time_ms(lambda: conv(x), iters=3, warmup=1)
    print(f"{card}: flow: the motion encoder's {conv.in_channels} -> "
          f"{conv.out_channels} 3x3 float32 convolution at batch "
          f"{pair_batch}: cuDNN {t_cudnn:.3f} ms, im2col + cuBLAS "
          f"{t_gemm:.3f} ms", flush=True)
    del x

    fx._features.features = _Ranged("ViT", fx._features.features, None)
    busy, _, got = _profile(
        lambda: fx.extract_video(None, frame_source=iter(frames)),
        "flow_profile", 1, ranges=("ViT",))
    print(f"{card}: flow: the ViT (preprocess + 12 K1 blocks) "
          f"{100 * got['ViT'] / busy:.2f}% of the flow path's device busy "
          f"time", flush=True)
    del fx, model
    torch.cuda.empty_cache()
    return launches


def phase_steps(nframes: int):
    import dataclasses

    import numpy as np
    import torch
    from sais_tpu_torch.config import (ModelConfig, PipelineConfig,
                                       TemporalConfig)
    from sais_tpu_torch.data.tasks import step_window_config
    from sais_tpu_torch.infer.pipeline import GestureDecoder
    from sais_tpu_torch.infer.postprocess import write_rows_csv
    from sais_tpu_torch.infer.skill import StepRecognizer
    from sais_tpu_torch.kernels.flash_attention import flash_attention
    from sais_tpu_torch.kernels.fused_mha import fused_vit_block
    from sais_tpu_torch.models.full_model import (full_model_init,
                                                  prototypes_init)

    # `steps --stride-divisor 4096 --flash on --fps 30`: stride 1, windows
    # of 300 / 297 / 294 frames + CLS over the 3 TTA offsets
    cfg = PipelineConfig(
        model=ModelConfig(modalities="RGB", nclasses=3,
                          temporal=TemporalConfig(use_flash=True)),
        window=dataclasses.replace(step_window_config(30.0),
                                   stride_divisor=4096))
    fold = (full_model_init(torch.Generator().manual_seed(1), cfg.model),
            prototypes_init(torch.Generator().manual_seed(2), 3)[1])
    feats = np.random.default_rng(0).standard_normal(
        (nframes, 384)).astype(np.float32)
    rec = StepRecognizer(GestureDecoder([fold], cfg), fps=30.0)
    rec.recognize("steps", feats)     # warm-up at the same shapes
    torch.cuda.synchronize()

    fused_vit_block.launches = flash_attention.launches = 0
    t0 = time.perf_counter()
    rows = rec.recognize("steps", feats)
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "steps_steps.csv")
        write_rows_csv(rows, csv, rec.columns)
        with open(csv) as f:
            csv_lines = len(f.readlines())
    wall = [time.perf_counter() - t0]
    launches, k1_launches = flash_attention.launches, fused_vit_block.launches
    for _ in range(2):
        t = time.perf_counter()
        rec.recognize("steps", feats)
        wall.append(time.perf_counter() - t)
    median_s = sorted(wall)[1]
    nwin = (nframes - 300) // 150 + 1
    print(f"steps path: {nframes} frames, {len(rows)} windows x 3 TTA of "
          f"301 / 298 / 295 tokens: {median_s:.4f} s median of "
          f"{', '.join(f'{s:.4f}' for s in wall)} (CSV included in the "
          f"first); K2 launches {launches}, K1 launches {k1_launches}",
          flush=True)
    check(launches == 12, f"K2 launched {launches} times on the steps "
          "path, expected 12 (4 layers x 3 TTA)")
    check(k1_launches == 0, f"K1 launched {k1_launches} times on steps")
    check(len(rows) == nwin and csv_lines == nwin + 1,
          f"{len(rows)} step rows / {csv_lines} CSV lines, expected {nwin}")
    probs = np.array([[r[c] for c in rec.class_names] for r in rows])
    check(np.isfinite(probs).all() and np.abs(probs.sum(1) - 1).max() < 1e-5,
          "step probabilities not finite or not summing to 1")

    def step_probs(cfg, device):
        dec = GestureDecoder([fold], cfg, device=device)
        return np.array([[r[c] for c in rec.class_names] for r in
                         StepRecognizer(dec, fps=30.0).recognize("steps",
                                                                 feats)])

    # The same path through K2's plain version (the decoder on the CPU),
    # and the dense path on the card.
    t = time.perf_counter()
    plain = step_probs(cfg, "cpu")
    plain_s = time.perf_counter() - t
    dense_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, temporal=dataclasses.replace(cfg.model.temporal,
                                                use_flash=False)))
    dense = step_probs(dense_cfg, None)
    perr, derr = np.abs(probs - plain).max(), np.abs(probs - dense).max()
    # Limits: 1e-4 against the plain version (f32 on both sides, summation
    # order only); 5e-4 against the dense path, the JAX package's own
    # flash-vs-dense limit (tests/test_flash_wiring.py).
    print(f"steps path vs plain version (CPU, {plain_s:.1f} s): max|prob "
          f"diff| {perr:.3g}; vs dense path: {derr:.3g}; same argmax "
          f"{int((probs.argmax(1) == plain.argmax(1)).sum())}/{nwin}",
          flush=True)
    check(perr <= 1e-4, f"steps probabilities differ from plain: {perr}")
    check(derr <= 5e-4, f"steps probabilities differ from dense: {derr}")
    _profile(lambda: rec.recognize("steps", feats), "steps_profile", 1)
    return launches


def k3_bound_ms(b, h, l, dh, valid):
    """Least time for K3 on this data: five products of 2 Dh flops for
    each (query, valid key) pair, against q, k, v, out, dO, lse and the
    bias read once and dq, dk, dv written once.  -> (bound ms, bound by,
    flops, bytes, f32 FFMA bound ms)."""
    flops = 10 * h * l * dh * sum(valid)
    nbytes = 4 * (8 * b * h * l * dh + b * l + b * h * l)
    bound, by, ffma = flash_bound_ms(flops, nbytes)
    return bound, by, flops, nbytes, ffma


# (B*S, L, masked): the steps shape, the reference's 2000-frame cap + CLS,
# and the long training step
K3_SHAPES = ((132, 301, False), (8, 2001, True), (2, 8193, False))
LONG_FRAMES = 8192   # bench.py:297 bench_seq_train, b = 2


def _bwd_f64(q, k, v, bias, out, lse, do):
    """K3's formulas evaluated in float64 on the card: the yardstick of
    accuracy for both the kernel and its plain version."""
    import torch
    q, k, v, out, lse, do = (t.double() for t in (q, k, v, out, lse, do))
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhld,bhmd->bhlm", q * scale, k)
    if bias is not None:
        s = s + bias.double()[:, None, None, :]
    p = torch.exp(s - lse[..., None])
    del s
    dp = torch.einsum("bhld,bhmd->bhlm", do, v)
    ds = p * (dp - (do * out).sum(-1)[..., None])
    del dp
    return (torch.einsum("bhlm,bhmd->bhld", ds, k) * scale,
            torch.einsum("bhlm,bhld->bhmd", ds, q * scale),
            torch.einsum("bhlm,bhld->bhmd", p, do))


def phase_k3():
    import torch
    import torch.nn.functional as F
    from sais_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_fwd, key_bias)

    result = {}
    worst = 0.0
    for b, l, masked in K3_SHAPES:
        q, k, v, mask, valid = k2_inputs(b, l, seed=l + 1, masked=masked)
        bias = key_bias(mask) if masked else None
        out, lse = flash_attention_fwd(q, k, v, bias)
        do = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            l)).cuda()
        if masked:
            do[-1] = 0.0    # flash_attention's backward zeroes this element
        got = flash_attention_bwd(q, k, v, bias, out, lse, do)
        again = flash_attention_bwd(q, k, v, bias, out, lse, do)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K3 is not bitwise repeatable at (B*S, L) = ({b}, {l})")
        del again
        ref = flash_attention_bwd_reference(q, k, v, bias, out, lse, do)
        exact = _bwd_f64(q, k, v, bias, out, lse, do)
        errs = []
        for name, g, r, x in zip(("dq", "dk", "dv"), got, ref, exact):
            err = (g - r).abs().max().item()
            scale = r.abs().max().item()
            errs.append(f"{name} {err:.4g} (max {scale:.4g}; kernel-f64 "
                        f"{(g.double() - x).abs().max().item():.3g}, "
                        f"plain-f64 {(r.double() - x).abs().max().item():.3g})")
            # Limit: both compute in f32 and differ only in summation order
            # (a few ulps): 1e-4 of the largest plain value.
            check(math.isfinite(err) and err <= 1e-4 * scale,
                  f"K3 {name} disagrees at (B*S, L) = ({b}, {l}): {err} > "
                  f"1e-4 * {scale}")
            if masked:
                zero = torch.count_nonzero(g[-1]).item()
                check(zero == 0, f"K3 {name} of the all-masked element has "
                      f"{zero} nonzero values")
            worst = max(worst, err)
        del ref, exact
        ms = cuda_time_ms(lambda: flash_attention_bwd(q, k, v, bias, out,
                                                      lse, do),
                          iters=10 if l > 5000 else 20)
        plain_ms = cuda_time_ms(lambda: flash_attention_bwd_reference(
            q, k, v, bias, out, lse, do), iters=3, warmup=1)
        # library yardstick: SDPA's backward in f32 with the additive mask,
        # timed as forward + backward minus forward
        lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lib_mask = None if bias is None else bias[:, None, None, :]

        def lib_fwd():
            return F.scaled_dot_product_attention(lq, lk, lv,
                                                  attn_mask=lib_mask)

        def lib_fwd_bwd():
            torch.autograd.grad(lib_fwd(), (lq, lk, lv), do)

        with torch.no_grad():
            lib_fwd_ms = cuda_time_ms(lib_fwd, iters=10)
        library_ms = cuda_time_ms(lib_fwd_bwd, iters=10) - lib_fwd_ms
        bound_ms, bound_by, flops, nbytes, ffma_ms = k3_bound_ms(
            b, 4, l, 96, valid)
        print(f"K3 B*S={b} H=4 L={l} Dh=96{' masked' if masked else ''} "
              f"(two runs bitwise equal; faster than plain "
              f"{ms < plain_ms}, than SDPA's backward {ms < library_ms}): "
              f"{', '.join(errs)}; kernel {ms:.4f} ms ({flops / ms / 1e9:.2f}"
              f" TFLOP/s of the 10 Dh-a-pair work), plain {plain_ms:.4f} ms, "
              f"library (SDPA backward, f32, additive mask) {library_ms:.4f}"
              f" ms (forward {lib_fwd_ms:.4f} ms); bound {bound_ms:.4f} ms "
              f"by {bound_by} in 3xTF32 ({flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB; f32 FFMA bound {ffma_ms:.4f} ms), "
              f"kernel at {100 * bound_ms / ms:.1f}% of the bound",
              flush=True)
        if not result:
            result = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
            _profile(lambda: flash_attention_bwd(q, k, v, bias, out, lse,
                                                 do), "k3_profile", 5)
        del q, k, v, out, lse, do, got, lq, lk, lv
        torch.cuda.empty_cache()
    result["max_abs_err"] = worst
    return result


class _ArrayStore:
    """In-memory stand-in for the H5 FeatureStore: read_video(name)."""

    def __init__(self, videos):
        self.videos = videos

    def read_video(self, name):
        return self.videos[name]


def _synthetic_training_data():
    """16 videos x 3,000 frames of 384-d f32 features (numpy seed 0) and 24
    labeled segments of 45-150 frames per video, two gesture classes."""
    import numpy as np
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((16, 3000, 384)).astype(np.float32)
    videos = {f"vid{i:02d}": feats[i] for i in range(16)}
    segments = []
    for name in videos:
        for _ in range(24):
            span = int(rng.integers(45, 151))
            start = int(rng.integers(1, 3000 - span))
            segments.append({"Video": name, "StartFrame": start,
                             "EndFrame": start + span,
                             "Gesture": "G" + str(int(rng.integers(1, 3)))})
    return _ArrayStore(videos), segments


def _fit(store, ds, cfg, device):
    """PrototypeTrainer.fit(2 epochs) as `train -bs 32 -lr 0.1` runs it on
    fold 0; returns (trainer, result, [(phase, epoch loss), ...])."""
    import torch
    from sais_tpu_torch.config import TrainConfig
    from sais_tpu_torch.data.collate import segment_batches
    from sais_tpu_torch.models.full_model import (full_model_init,
                                                  prototypes_init)
    from sais_tpu_torch.train.loop import PrototypeTrainer

    model = full_model_init(torch.Generator().manual_seed(0), cfg.model)
    keys, protos = prototypes_init(torch.Generator().manual_seed(1),
                                   len(ds.classes))
    trainer = PrototypeTrainer(cfg.model, TrainConfig(lr=0.1, batch_size=32),
                               model, keys, protos, device=device)
    losses = []
    run_epoch = trainer.run_epoch

    def recording(batches, train):
        loss, m = run_epoch(batches, train)
        losses.append(loss)
        return loss, m

    trainer.run_epoch = recording

    def loader(rows, train):
        return lambda epoch=0: segment_batches(
            rows, store, ds.classes, cfg.window, 32, shuffle=train,
            seed=epoch, tta=not train)

    loaders = {ph: loader(ds.frames[ph], ph == "train")
               for ph in ("train", "val", "test")}
    result = trainer.fit(loaders, nepochs=2, log=lambda line: None)
    return trainer, result, losses


def phase_train():
    import dataclasses

    import numpy as np
    import torch
    from sais_tpu_torch.cli.main import load_fold
    from sais_tpu_torch.config import (ModelConfig, PipelineConfig,
                                       TemporalConfig)
    from sais_tpu_torch.data.datasets import build_segment_dataset
    from sais_tpu_torch.infer.pipeline import GestureDecoder
    from sais_tpu_torch.kernels.flash_attention import (flash_attention,
                                                        flash_attention_bwd)
    from sais_tpu_torch.models.full_model import FullModel
    from sais_tpu_torch.train.checkpoint import save_training_result

    # (a) the train path, fold 0, 2 epochs, --flash on
    cfg = PipelineConfig(model=ModelConfig(
        modalities="RGB", temporal=TemporalConfig(use_flash=True)))
    store, segments = _synthetic_training_data()
    ds = build_segment_dataset(segments, 0, balance=True)
    nb = {ph: math.ceil(len(rows) / 32) for ph, rows in ds.frames.items()}
    flash_attention.launches = flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    trainer, result, losses = _fit(store, ds, cfg, None)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    train_k2 = k2 = flash_attention.launches
    train_k3 = k3 = flash_attention_bwd.launches
    train_batches = 2 * nb["train"]
    eval_batches = 2 * (nb["val"] + nb["test"])
    print(f"train path: {len(segments)} segments, classes {ds.classes}, "
          f"rows train/val/test {[len(ds.frames[p]) for p in nb]}, batches "
          f"a epoch {nb}; fit of 2 epochs {fit_s:.4f} s on the card, best "
          f"epoch {result['best_epoch']}; K2 launches {k2}, K3 launches "
          f"{k3}", flush=True)
    check(k3 == 4 * train_batches,
          f"K3 launched {k3} times, expected 4 x {train_batches}")
    check(k2 == 4 * (train_batches + 3 * eval_batches),
          f"K2 launched {k2} times, expected 4 x ({train_batches} + 3 x "
          f"{eval_batches})")
    check(all(math.isfinite(x) for x in losses), "non-finite epoch loss")
    t0 = time.perf_counter()
    _, cpu_result, cpu_losses = _fit(store, ds, cfg, "cpu")
    cpu_s = time.perf_counter() - t0
    diff = float(np.max(np.abs(np.subtract(losses, cpu_losses))))
    print(f"train path epoch losses (train, val, test per epoch): card "
          f"{[round(x, 6) for x in losses]}, CPU plain versions "
          f"{[round(x, 6) for x in cpu_losses]} ({cpu_s:.1f} s); max|diff| "
          f"{diff:.3g}", flush=True)
    # Limit 1e-3: f32 on both sides, two epochs of SGD carry the summation
    # order differences of every step.
    check(diff <= 1e-3, f"card and CPU epoch losses differ by {diff}")

    with tempfile.TemporaryDirectory() as tmp:
        save_training_result(os.path.join(tmp, "Fold_0"), result)
        model, protos = load_fold(os.path.join(tmp, "Fold_0"), cfg)
    mem = FullModel(cfg.model)
    mem.load_state_dict(result["model"])
    dense = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, temporal=dataclasses.replace(cfg.model.temporal,
                                                use_flash=None)))
    feats = store.read_video("vid00")
    p_disk = GestureDecoder([(model, protos)], dense).window_probs("v", feats)
    p_mem = GestureDecoder([(mem, result["prototypes"])], dense).window_probs(
        "v", feats)
    perr = float(np.abs(p_disk - p_mem).max())
    print(f"saved fold (params.pkl) decodes {p_disk.shape} window "
          f"probabilities, max|diff| from the in-memory model {perr:.3g}",
          flush=True)
    check(p_disk.shape == ((3000 - 15) // 15 + 1, 2)
          and np.isfinite(p_disk).all(),
          f"decoded probabilities {p_disk.shape}")
    check(perr <= 1e-6, f"saved fold decodes differently: {perr}")
    del trainer

    # (b) one train step at the bench_seq_train shape (bench.py:297-351)
    b, l = 2, LONG_FRAMES
    rng = np.random.default_rng(1)
    batch = {"rgb": rng.standard_normal((b, 1, l, 384)).astype(np.float32),
             "rgb_mask": np.zeros((b, 1, l + 1), bool),
             "label_cols": np.arange(b, dtype=np.int32) % 2,
             "labels": np.arange(b, dtype=np.int32) % 2}

    def long_trainer(use_flash):
        from sais_tpu_torch.config import TrainConfig
        from sais_tpu_torch.models.full_model import (full_model_init,
                                                      prototypes_init)
        from sais_tpu_torch.train.loop import PrototypeTrainer
        mcfg = ModelConfig(modalities="RGB", temporal=TemporalConfig(
            use_flash=use_flash, max_positions=l))
        keys, protos = prototypes_init(torch.Generator().manual_seed(2), 2)
        return PrototypeTrainer(
            mcfg, TrainConfig(lr=0.1),
            full_model_init(torch.Generator().manual_seed(0), mcfg), keys,
            protos)

    def grads(tr):
        named = dict(tr.model.named_parameters(), prototypes=tr.prototypes)
        # parameters the loss does not reach (linear2) have no gradient
        return {n: torch.zeros_like(p) if p.grad is None
                else p.grad.detach().clone() for n, p in named.items()}

    flash_tr = long_trainer(True)
    flash_attention.launches = flash_attention_bwd.launches = 0
    loss = float(flash_tr.train_step(batch)[0])
    torch.cuda.synchronize()
    k2, k3 = flash_attention.launches, flash_attention_bwd.launches
    g_flash = grads(flash_tr)
    dense_tr = long_trainer(False)
    torch.cuda.reset_peak_memory_stats()
    dense_loss = float(dense_tr.train_step(batch)[0])
    dense_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    g_dense = grads(dense_tr)
    rel = abs(loss - dense_loss) / abs(dense_loss)

    def gaps(ga, gb):
        """name -> (max|a - b| / max|b|, ||a - b|| / ||b||)"""
        return {n: ((ga[n] - gb[n]).abs().max().item()
                    / max(gb[n].abs().max().item(), 1e-30),
                    (ga[n] - gb[n]).norm().item()
                    / max(gb[n].norm().item(), 1e-30)) for n in gb}

    gap = gaps(g_flash, g_dense)
    # The dense path against itself with its input moved by 1e-7 relative
    # noise (the size of f32 rounding): where a ReLU pre-activation lies
    # that close to 0 the unit flips, and the gradient jumps.  The
    # per-frame rows of frame_pos are single-token quantities, so a flip
    # moves a row by about 1e-3 of its size whatever the attention does.
    nudged = dict(batch, rgb=(batch["rgb"] * (1 + 1e-7 * rng.standard_normal(
        batch["rgb"].shape))).astype(np.float32))
    floor_tr = long_trainer(False)
    floor_tr.train_step(nudged)
    floor = gaps(grads(floor_tr), g_dense)
    del floor_tr
    worst = max((v[0], n) for n, v in gap.items() if n != "frame_pos")
    print(f"long train step (b {b}, {l} frames + CLS): K2 launches {k2}, K3 "
          f"launches {k3}; loss flash {loss:.8f} dense {dense_loss:.8f} "
          f"(rel diff {rel:.3g}); dense step peak memory {dense_peak:.1f} "
          f"GiB; worst gradient max|flash-dense| / max|dense| {worst[0]:.3g}"
          f" ({worst[1]}); frame_pos max-relative {gap['frame_pos'][0]:.3g},"
          f" norm-relative {gap['frame_pos'][1]:.3g}; dense against itself "
          f"under 1e-7 input noise: frame_pos max-relative "
          f"{floor['frame_pos'][0]:.3g}, worst other "
          f"{max(v[0] for n, v in floor.items() if n != 'frame_pos'):.3g}",
          flush=True)
    for n, (mx, nr) in sorted(gap.items()):
        print(f"  grad {n}: max-relative {mx:.3g}, norm-relative {nr:.3g}")
    check(k2 == 4 and k3 == 4, f"long step launched K2 {k2}, K3 {k3} times")
    check(rel <= 1e-5, f"long-step loss differs from dense: {rel}")
    # Limit 1e-3 of the largest dense gradient: f32 on both sides, only
    # the summation order over 8193 keys differs.  frame_pos is held in
    # the norm instead (see the noise line above).
    check(worst[0] <= 1e-3, f"gradient {worst[1]} differs from dense: "
          f"{worst[0]}")
    check(gap["frame_pos"][1] <= 1e-3,
          f"frame_pos gradient differs from dense: {gap['frame_pos']}")
    del g_flash, g_dense

    def step_ms(tr):
        tr.train_step(batch)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t = time.perf_counter()
            tr.train_step(batch)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
        return sorted(times)[2], times

    flash_ms, flash_all = step_ms(flash_tr)
    dense_ms, dense_all = step_ms(dense_tr)
    print(f"long train step: flash {flash_ms:.2f} ms median of "
          f"{', '.join(f'{t:.2f}' for t in flash_all)}; dense {dense_ms:.2f}"
          f" ms median of {', '.join(f'{t:.2f}' for t in dense_all)}",
          flush=True)
    del dense_tr
    torch.cuda.empty_cache()
    flash_crossover()
    _profile(lambda: flash_tr.train_step(batch), "train_step_profile", 2,
             shares={"K2": "flash_fwd_kernel", "K3": "flash_bwd_"})
    return train_k2, train_k3


# ---------------------------------------------------------------------------
# The skill path: `train --dataset vua-ease` and `assess`
# ---------------------------------------------------------------------------

SKILL_RACES = (("Needle Handling", "# Repositions"),
               ("Needle Driving", "Driving Sequence"),
               ("Needle Withdrawal", "Wrist Rotation"))


def _synthetic_ease_data(nvideos: int = 48, stitches: int = 6,
                         nframes: int = 6000):
    """A VUA_EASE_Stitch_Paths-schema table (numpy seed 0): nvideos x
    stitches x the three RACE / EASE pairs, maj in {0, 1, 2}; explanation
    rows (six relative spans) for the low-skill stitches; 384-d f32
    features of nframes frames a video, RGB and flow, in memory."""
    import numpy as np
    rng = np.random.default_rng(0)
    rows, expl = [], []
    for v in range(nvideos):
        for s in range(stitches):
            start = int(rng.integers(1, nframes - 900))
            entry = start + int(rng.integers(40, 300))
            wd = entry + int(rng.integers(60, 300))
            wd_end = wd + int(rng.integers(90, 250))
            for race, ease in SKILL_RACES:
                maj = int(rng.integers(0, 3))
                rows.append({
                    "File": v + 1, "Stitch": s,
                    "Path": f"C:\\EASE\\vid{v:02d}",
                    "videoname": f"case{v:02d}", "Anatomy":
                    "Posterior" if s % 2 else "Anterior", "RACE": race,
                    "EASE": ease, "maj": maj,
                    "Needle Handling Start Frame": start,
                    "Needle Entry Start Frame": entry,
                    "Needle Withdrawal Start Frame": wd,
                    "Needle Withdrawal End Frame": wd_end})
                if maj != 2:
                    e = {"File Number": v + 1, "Stitch": s, "Hospital": "USC",
                         "Suturing Phase": "N" + race.split()[1][0]}
                    for n in range(1, 7):
                        a = int(rng.integers(0, 100))
                        e[f"Start{n} Frame"] = float(a)
                        e[f"End{n} Frame"] = float(a + rng.integers(5, 40))
                    expl.append(e)
    feats = rng.standard_normal((2, nvideos, nframes, 384)).astype(np.float32)
    rgb = {f"vid{v:02d}": feats[0, v] for v in range(nvideos)}
    flow = {f"vid{v:02d}": feats[1, v] for v in range(nvideos)}
    return rows, expl, _ArrayStore(rgb), _ArrayStore(flow)


def _skill_trainer(data, domain, cfg, device, importance=True):
    """The PrototypeTrainer(use_importance=...) and loaders of `train
    --dataset vua-ease -d <domain> [-il] -bc -bs 8 -lr 0.1` on fold 0,
    from fixed seeds; returns (trainer, loaders, batches a phase, tables,
    classes)."""
    import dataclasses

    import torch
    from sais_tpu_torch.config import TrainConfig
    from sais_tpu_torch.data.skill import build_ease_dataset, skill_batches
    from sais_tpu_torch.models.full_model import (full_model_init,
                                                  prototypes_init)
    from sais_tpu_torch.train.loop import PrototypeTrainer
    rows, expl, store, _ = data
    frames, classes = build_ease_dataset(rows, domain, 0, balance=True,
                                         explanations=[expl],
                                         importance_loss=importance)
    multi = "+" in domain
    nclasses = len(classes) * (2 if multi else 1)
    mcfg = dataclasses.replace(cfg.model, nclasses=nclasses,
                               importance_head=importance, multi_task=multi)
    model = full_model_init(torch.Generator().manual_seed(0), mcfg)
    keys, protos = prototypes_init(torch.Generator().manual_seed(1), nclasses)
    trainer = PrototypeTrainer(mcfg, TrainConfig(lr=0.1, batch_size=8,
                                                 importance_loss=importance),
                               model, keys, protos, device=device)

    def loader(phase):
        return lambda epoch=0: skill_batches(
            frames[phase], store, None, classes, domain, phase, 8,
            shuffle=phase == "train", importance_loss=importance, seed=epoch,
            tta=phase != "train")

    loaders = {ph: loader(ph) for ph in ("train", "val", "test")
               if frames[ph]}
    nb = {ph: math.ceil(len(frames[ph]) / 8) for ph in loaders}
    return trainer, loaders, nb, frames, classes


def _skill_fit(data, domain, cfg, device, nepochs=2):
    """`_skill_trainer`'s fit of nepochs; returns (trainer, result, epoch
    losses, batches a phase, tables, classes)."""
    trainer, loaders, nb, frames, classes = _skill_trainer(data, domain, cfg,
                                                           device)
    losses = []
    run_epoch = trainer.run_epoch

    def recording(batches, train):
        loss, m = run_epoch(batches, train)
        losses.append(loss)
        return loss, m

    trainer.run_epoch = recording
    result = trainer.fit(loaders, nepochs=nepochs, log=lambda line: None)
    return trainer, result, losses, nb, frames, classes


def phase_skill(card: str):
    """`train --dataset vua-ease -il` (dense and --flash on, card and CPU),
    one epoch of `-d NH_02+ND_02`, and `assess` over the trained fold
    (USC_inference and inference rows of 4 videos, -mod RGB and RGB-Flow,
    flash and dense); returns the K2 and K3 launches of the driven runs."""
    import dataclasses

    import numpy as np
    import torch
    from sais_tpu_torch.config import (ModelConfig, PipelineConfig,
                                       TemporalConfig)
    from sais_tpu_torch.data.skill import ease_inference_table, with_video
    from sais_tpu_torch.infer.skill import SkillAssessor
    from sais_tpu_torch.kernels.flash_attention import (flash_attention,
                                                        flash_attention_bwd)
    from sais_tpu_torch.models.full_model import FullModel

    t0 = time.perf_counter()
    data = _synthetic_ease_data()
    print(f"skill path data: {len(data[0])} stitch rows, {len(data[1])} "
          f"explanation rows, 48 videos x 6000 frames x 384 "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    def config(use_flash, modalities="RGB"):
        return PipelineConfig(model=ModelConfig(
            modalities=modalities, temporal=TemporalConfig(
                use_flash=use_flash)))

    # (a) `train --dataset vua-ease -d NH_02 -il -bc -e 2 -bs 8 -lr 0.1`
    k2 = k3 = 0
    fits = {}
    for mode, use_flash in (("flash", True), ("dense", None)):
        flash_attention.launches = flash_attention_bwd.launches = 0
        t = time.perf_counter()
        tr, result, losses, nb, frames, classes = _skill_fit(
            data, "NH_02", config(use_flash), None)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        fk2, fk3 = flash_attention.launches, flash_attention_bwd.launches
        fits[mode] = (tr, result, losses)
        train_b = 2 * nb["train"]
        eval_b = 2 * (nb.get("val", 0) + nb.get("test", 0))
        print(f"skill fit ({mode}): rows train/val/test "
              f"{[len(frames[p]) for p in ('train', 'val', 'test')]}, "
              f"classes {classes}, {train_b} train and {eval_b} eval batches "
              f"in 2 epochs: {fit_s:.4f} s, best epoch "
              f"{result['best_epoch']}, losses "
              f"{[round(x, 6) for x in losses]}; K2 launches {fk2}, K3 "
              f"launches {fk3}; {card}", flush=True)
        check(all(math.isfinite(x) for x in losses),
              f"skill fit ({mode}): non-finite epoch loss {losses}")
        if mode == "flash":
            check(fk3 == 4 * train_b,
                  f"skill fit: K3 launched {fk3} times, expected 4 x "
                  f"{train_b}")
            check(fk2 == 4 * (train_b + 3 * eval_b),
                  f"skill fit: K2 launched {fk2} times, expected 4 x "
                  f"({train_b} + 3 x {eval_b})")
            k2, k3 = k2 + fk2, k3 + fk3
        else:
            check(fk2 == fk3 == 0, f"dense skill fit launched K2 {fk2}, "
                  f"K3 {fk3} times on windows of at most 129 tokens")
    ldiff = float(np.max(np.abs(np.subtract(fits["flash"][2],
                                            fits["dense"][2]))))
    t = time.perf_counter()
    _, _, cpu_losses, _, _, _ = _skill_fit(data, "NH_02", config(True),
                                           "cpu")
    cpu_s = time.perf_counter() - t
    cdiff = float(np.max(np.abs(np.subtract(fits["flash"][2], cpu_losses))))
    # Limits 1e-3: f32 on both sides; two epochs of SGD carry the
    # summation-order differences of every step (the training phase's
    # card-vs-CPU limit).
    print(f"skill fit epoch losses: flash vs dense max|diff| {ldiff:.3g}; "
          f"card vs CPU (plain versions, {cpu_s:.1f} s) max|diff| "
          f"{cdiff:.3g}", flush=True)
    check(ldiff <= 1e-3, f"skill fit: flash and dense losses differ {ldiff}")
    check(cdiff <= 1e-3, f"skill fit: card and CPU losses differ {cdiff}")

    # one -il step, flash against dense, from the same weights and batch
    rows, expl, store, flow_store = data
    from sais_tpu_torch.data.skill import skill_batches
    batch = next(skill_batches(frames["train"], store, None, classes,
                               "NH_02", "train", 8, True,
                               importance_loss=True, seed=7))
    check(batch["importance"].any(), "the -il batch has no importance "
          "target")

    def step_grads(use_flash):
        tr = _skill_trainer(data, "NH_02", config(use_flash), None)[0]
        loss = float(tr.train_step(batch)[0])
        named = dict(tr.model.named_parameters(), prototypes=tr.prototypes)
        return tr, loss, {n: p.grad.detach().clone() for n, p in
                          named.items() if p.grad is not None}

    ftr, floss, fg = step_grads(True)
    dtr, dloss, dg = step_grads(None)
    gaps = {n: ((fg[n] - dg[n]).abs().max().item()
                / max(dg[n].abs().max().item(), 1e-30),
                (fg[n] - dg[n]).norm().item() / max(dg[n].norm().item(),
                                                    1e-30)) for n in dg}
    worst = max((v[0], n) for n, v in gaps.items() if n != "frame_pos")
    print(f"skill -il step: loss flash {floss:.8f} dense {dloss:.8f}; "
          f"{len(dg)} gradients, worst max|flash - dense| / max|dense| "
          f"{worst[0]:.3g} ({worst[1]}); importance.weight "
          f"{gaps['importance.weight'][0]:.3g}; frame_pos norm-relative "
          f"{gaps['frame_pos'][1]:.3g}", flush=True)
    check(set(fg) == set(dg) and "importance.weight" in dg,
          "the -il step's gradients miss the importance head")
    check(abs(floss - dloss) <= 1e-5 * abs(dloss),
          f"skill -il step loss differs: {floss} vs {dloss}")
    # Limit 1e-3 of the largest dense gradient (f32, summation order);
    # frame_pos, whose rows are single-token sums that a ReLU flip at
    # rounding level moves, in the norm (the training phase's rule).
    check(worst[0] <= 1e-3, f"skill -il gradient {worst[1]} differs: "
          f"{worst[0]}")
    check(gaps["frame_pos"][1] <= 1e-3,
          f"skill -il frame_pos gradient differs: {gaps['frame_pos']}")

    def step_ms(tr):
        tr.train_step(batch)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t = time.perf_counter()
            tr.train_step(batch)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
        return sorted(times)[2]

    print(f"skill -il train step (batch 8): flash {step_ms(ftr):.3f} ms, "
          f"dense {step_ms(dtr):.3f} ms median of 5; {card}", flush=True)
    del ftr, dtr

    # (b) one epoch of `-d NH_02+ND_02 -il --flash on` (linearB)
    flash_attention.launches = flash_attention_bwd.launches = 0
    mtr, _, mlosses, mnb, _, _ = _skill_fit(data, "NH_02+ND_02",
                                            config(True), None, nepochs=1)
    torch.cuda.synchronize()
    mk2, mk3 = flash_attention.launches, flash_attention_bwd.launches
    train_b = mnb["train"]
    eval_b = mnb.get("val", 0) + mnb.get("test", 0)
    print(f"skill fit NH_02+ND_02 (1 epoch): losses "
          f"{[round(x, 6) for x in mlosses]}, {len(mtr.prototype_keys)} "
          f"prototypes; K2 launches {mk2}, K3 launches {mk3}", flush=True)
    check(mtr.model.linearB is not None and all(
        math.isfinite(x) for x in mlosses), "multi-task fit failed")
    check(mk3 == 4 * train_b and mk2 == 4 * (train_b + 3 * eval_b),
          f"multi-task fit launched K2 {mk2}, K3 {mk3} times")
    k2, k3 = k2 + mk2, k3 + mk3
    del mtr

    # (c) `assess` over the trained fold: USC_inference and inference rows
    # of 4 videos, -mod RGB and RGB-Flow, flash and dense
    model = FullModel(fits["flash"][0].model_cfg)
    model.load_state_dict(fits["flash"][1]["model"])
    protos = fits["flash"][1]["prototypes"]
    videos = ["vid44", "vid45", "vid46", "vid47"]
    table = with_video(rows)
    phases = {"USC_inference": ease_inference_table(table, "USC_inference",
                                                    "NH_02"),
              "inference": table}
    work = [(ph, v, [r for r in tab if r["Video"] == v])
            for ph, tab in phases.items() for v in videos]
    nseg = sum(len(w[2]) for w in work)

    def assess(assessor, use_flow):
        return [assessor.assess_segments(
            store.read_video(v), flow_store.read_video(v) if use_flow
            else None, segs, phase=ph, videoname=v) for ph, v, segs in work]

    arts = {}
    for mods in ("RGB", "RGB-Flow"):
        nmod = 2 if mods == "RGB-Flow" else 1
        for mode, use_flash in (("flash", True), ("dense", None)):
            cfg = config(use_flash, mods)
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, importance_head=True))
            assessor = SkillAssessor(model, protos, cfg)
            flash_attention.launches = 0
            arts[mods, mode] = assess(assessor, nmod == 2)
            torch.cuda.synchronize()
            launches = flash_attention.launches
            if mode == "flash":
                check(launches == 4 * nseg * 3 * nmod,
                      f"assess ({mods}, flash) launched K2 {launches} "
                      f"times, expected 4 x {nseg} x 3 x {nmod}")
                k2 += launches
            else:
                check(launches == 0, f"dense assess launched K2 {launches} "
                      "times")
            if mods == "RGB":
                walls = []
                for _ in range(4):       # a warm-up, then three timed
                    t = time.perf_counter()
                    assess(assessor, False)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t)
                med = sorted(walls[1:])[1]
                print(f"assess ({mode}, -mod RGB): {nseg} segments x 3 TTA "
                      f"in {med:.4f} s median of "
                      f"{', '.join(f'{w:.4f}' for w in walls[1:])}: "
                      f"{nseg / med:.1f} segments/s; {card}", flush=True)
                if mode == "dense":
                    busy, wall, _ = _profile(
                        lambda: assess(assessor, False), "assess_profile", 1)
                    print(f"assess (dense, -mod RGB) profiled: device busy "
                          f"{busy / 1e3:.3f} ms of {wall / 1e3:.3f} ms, "
                          f"{100 * (1 - busy / wall):.1f}% idle; {card}",
                          flush=True)
    for mods in ("RGB", "RGB-Flow"):
        perr = ierr = aerr = 0.0
        for fa, da, (_, _, segs) in zip(arts[mods, "flash"],
                                        arts[mods, "dense"], work):
            for t in range(3):
                perr = max(perr, float(np.abs(np.stack(fa["probs"][t])
                                              - np.stack(da["probs"][t]))
                                       .max()))
            for seg, fi, di, fatt, datt in zip(segs, fa["importance"],
                                               da["importance"],
                                               fa["attention"],
                                               da["attention"]):
                f = len(di)
                check(datt.shape == (f + 1, f + 1) and fatt.shape == (f + 1,)
                      and fi.shape == (f,),
                      f"assess artifacts: dense attention {datt.shape}, "
                      f"flash {fatt.shape}, importance {fi.shape}, f {f}")
                ierr = max(ierr, float(np.abs(fi - di).max()
                                       / max(np.abs(di).max(), 1e-30)))
                aerr = max(aerr, float(np.abs(fatt - datt[0]).max()))
        # Limits 1e-4 (probabilities, the CLS attention row; importance
        # relative to its largest value): f32 on both sides, K2's 3xTF32
        # keeps f32 accuracy.
        print(f"assess ({mods}) flash vs dense: max|prob diff| {perr:.3g}, "
              f"importance {ierr:.3g} of max, CLS attention row "
              f"{aerr:.3g}", flush=True)
        check(perr <= 1e-4, f"assess ({mods}) probabilities differ {perr}")
        check(ierr <= 1e-4, f"assess ({mods}) importance differs {ierr}")
        check(aerr <= 1e-4, f"assess ({mods}) CLS attention differs {aerr}")
        probs = np.stack(arts[mods, "dense"][0]["probs"][0])
        check(np.isfinite(probs).all() and np.abs(probs.sum(1) - 1).max()
              <= 1e-5, "assess probabilities not finite / not summing to 1")
    return k2, k3


# ---------------------------------------------------------------------------
# The classification path: `train -t MIL` and the other reps branches
# ---------------------------------------------------------------------------

# gesture cells of the synthetic VUA timestamp table and their shares: the
# reference's integer labels, a padded one, a multi-label cell and an
# empty cell (both dropped by the cleanup)
GESTURE_CELLS = (("1", 0.3), ("2", 0.25), ("7", 0.12), ("13", 0.1),
                 (" 2", 0.05), ("3", 0.08), ("1,2", 0.05), ("", 0.05))


def _synthetic_gesture_data(nvideos: int = 40, per_video: int = 60,
                            nframes: int = 6000):
    """A VUA gesture-timestamp CSV (numpy seed 0): nvideos x per_video
    gestures of 30-150 frames, Paths with either separator, the Gesture
    column an object column with multi-label and empty cells, read back
    by `read_segments`; 384-d f32 features of nframes frames a video and
    flow rows every 15 frames, in memory."""
    import csv

    import numpy as np
    from sais_tpu_torch.data.datasets import read_segments
    rng = np.random.default_rng(0)
    cells, shares = zip(*GESTURE_CELLS)
    rows = []
    for v in range(nvideos):
        path = (f"C:\\VUA\\videos\\vid{v:02d}" if v % 2
                else f"/data/VUA/videos/vid{v:02d}")
        for _ in range(per_video):
            start = int(rng.integers(1, nframes - 160))
            rows.append({"Path": path, "StartFrame": start,
                         "EndFrame": start + int(rng.integers(30, 151)),
                         "Gesture": cells[int(rng.choice(len(cells),
                                                         p=shares))]})
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gestures.csv")
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        rows = read_segments(path)
    rgb = rng.standard_normal((nvideos, nframes, 384)).astype(np.float32)
    flow = rng.standard_normal((nvideos, nframes // 15, 384)).astype(
        np.float32)
    return (rows, _ArrayStore({f"vid{v:02d}": rgb[v] for v in range(nvideos)}),
            _ArrayStore({f"vid{v:02d}": flow[v] for v in range(nvideos)}))


def _cls_config(use_flash, modalities="RGB", rep_dim=384, **kw):
    from sais_tpu_torch.config import (ModelConfig, PipelineConfig,
                                       TemporalConfig)
    return PipelineConfig(model=ModelConfig(
        rep_dim=rep_dim, modalities=modalities, **kw,
        temporal=TemporalConfig(rep_dim=rep_dim, use_flash=use_flash)))


def _task_fit(frames, classes, stores, cfg, device, task="MIL",
              nepochs=2, attn_error=None):
    """`cmd_train`'s fold loop for one fold from fixed seeds, batch 32, lr
    0.1: ClassificationTrainer.run_epoch over train / val / test for
    nepochs (MIL), or PrototypeTrainer.fit (Prototypes).  `attn_error`
    (mode, shift, noise): every frame-encoder layer's attention output
    scaled by 1 + shift ("signed"), or by 1 + noise * N(0, 1) drawn per
    value from a fixed seed ("noise"), on its way into out_proj.
    Returns (trainer, epoch losses, batches a phase, wall seconds)."""
    import dataclasses

    import torch
    from sais_tpu_torch.config import TrainConfig
    from sais_tpu_torch.data.collate import segment_batches
    from sais_tpu_torch.models.full_model import (full_model_init,
                                                  prototypes_init)
    from sais_tpu_torch.train.classification import ClassificationTrainer
    from sais_tpu_torch.train.loop import PrototypeTrainer
    store, flow_store = stores
    mcfg = dataclasses.replace(cfg.model, nclasses=len(classes))
    model = full_model_init(torch.Generator().manual_seed(0), mcfg)
    if attn_error is not None:
        mode, shift, noise = attn_error
        gens = {}

        def move(module, args):
            x = args[0]
            if mode == "signed":
                return (x * (1 + shift),)
            g = gens.setdefault(x.device, torch.Generator(
                device=x.device).manual_seed(5))
            return (x * (1 + noise * torch.randn(
                x.shape, generator=g, device=x.device)),)

        for layer in model.frame_encoder.layers:
            layer.self_attn.out_proj.register_forward_pre_hook(move)
    tcfg = TrainConfig(lr=0.1, batch_size=32)
    if mcfg.modalities == "RGB":
        flow_store = None

    def loader(phase):
        train = phase == "train"
        return lambda epoch=0: segment_batches(
            frames[phase], store, classes, cfg.window, 32, shuffle=train,
            seed=epoch, tta=not train, flow_store=flow_store)

    loaders = {ph: loader(ph) for ph in ("train", "val", "test")
               if frames[ph]}
    nb = {ph: math.ceil(len(frames[ph]) / 32) for ph in loaders}
    losses = []
    t0 = time.perf_counter()
    if task == "Prototypes":
        keys, protos = prototypes_init(torch.Generator().manual_seed(1),
                                       len(classes))
        trainer = PrototypeTrainer(mcfg, tcfg, model, keys, protos,
                                   device=device)
        run_epoch = trainer.run_epoch

        def recording(batches, train):
            loss, m = run_epoch(batches, train)
            losses.append(loss)
            return loss, m

        trainer.run_epoch = recording
        trainer.fit(loaders, nepochs=nepochs, log=lambda line: None)
    else:
        trainer = ClassificationTrainer(mcfg, tcfg, model, task=task,
                                        device=device)
        for epoch in range(nepochs):
            for phase, make in loaders.items():
                losses.append(trainer.run_epoch(make(epoch),
                                                phase == "train")[0])
    if trainer.device.type == "cuda":
        torch.cuda.synchronize()
    return trainer, losses, nb, time.perf_counter() - t0


def _mha_f64(x, w, bias, heads, mask):
    """The first layer's attention in float64 on the card, as the dense
    path computes it (temporal.multihead_attention) up to out_proj: x (B,
    L, D), the in-projection w (3D, D) and bias (3D,), the key padding
    mask (B, L) True = pad.  Returns (B, L, D), out_proj's input."""
    import torch
    b, l, d = x.shape
    dh = d // heads
    qkv = torch.nn.functional.linear(x.double(), w.double(), bias.double())
    q, k, v = (t.reshape(b, l, heads, dh).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    logits = torch.einsum("bhld,bhmd->bhlm", q * dh ** -0.5, k)
    if mask is not None:
        logits = logits.masked_fill(mask[:, None, None, :], float("-inf"))
    out = torch.einsum("bhlm,bhmd->bhld", torch.softmax(logits, -1), v)
    return out.transpose(1, 2).reshape(b, l, d)


def k2_signed_error(frames, classes, stores, batch):
    """K2's output at the first frame-encoder layer of the MIL model (its
    input the same on both paths, from the same weights) against the
    dense path's attention output on the card, and each against the same
    attention in float64: {"shift", "noise"}: mean((K2 - dense) *
    sign(dense)) and mean|K2 - dense|, each over the mean |dense|;
    {path: (signed, mean |error|)} for "K2" and "dense" against float64,
    over the mean |f64|."""
    import torch
    from sais_tpu_torch.models import temporal
    got, inputs = {}, {}
    orig = temporal.encoder_layer
    heads = _cls_config(None).model.temporal.num_heads
    for mode, use_flash in (("flash", True), ("dense", None)):
        tr = _task_fit({"train": [], "val": [], "test": []}, classes, stores,
                       _cls_config(use_flash), None, nepochs=0)[0]
        first = tr.model.frame_encoder.layers[0]

        def keep(module, args, mode=mode):
            got[mode] = args[0].detach().double()

        def layer(x, lyr, cfg, mask, *a, mode=mode, first=first, **kw):
            if lyr is first and mode not in inputs:
                inputs[mode] = (x.detach(), mask)
            return orig(x, lyr, cfg, mask, *a, **kw)

        first.self_attn.out_proj.register_forward_pre_hook(keep)
        w = (first.self_attn.in_proj_weight.detach(),
             first.self_attn.in_proj_bias.detach())
        temporal.encoder_layer = layer
        try:
            with torch.no_grad():
                tr.loss_fn(tr.model, tr._device_batch(batch))
        finally:
            temporal.encoder_layer = orig
        del tr
    x, mask = inputs["dense"]
    check(torch.equal(x, inputs["flash"][0]), "the first layer's input "
          "differs between the flash and dense paths")
    with torch.no_grad():
        ref = _mha_f64(x, *w, heads, mask)
    d, dense = got["flash"] - got["dense"], got["dense"]
    scale = dense.abs().mean()
    out = {"shift": ((d * dense.sign()).mean() / scale).item(),
           "noise": (d.abs().mean() / scale).item()}
    scale64 = ref.abs().mean()
    for name, y in (("K2", got["flash"]), ("dense", got["dense"])):
        e = y - ref
        out[name] = (((e * ref.sign()).mean() / scale64).item(),
                     (e.abs().mean() / scale64).item())
    out["inputs"] = (x, w, mask, heads)
    return out


def _signed(y, ref):
    """(mean((y - ref) sign(ref)), mean|y - ref|), each over mean|ref|."""
    scale = ref.abs().mean()
    e = y.double() - ref
    return (((e * ref.sign()).mean() / scale).item(),
            (e.abs().mean() / scale).item())


def k3_signed_error(x, w, mask, heads):
    """K3's dq, dk and dv at the MIL fit's first layer (its q, k, v from
    the in-projection of that layer's input, out and lse from K2, a
    cotangent from seed 11) and the dense f32 path's (autograd of the
    plain attention on the card), each against float64 from the float64
    forward: {name: {path: (signed, mean |error|) of the mean |f64|}}."""
    import torch
    from sais_tpu_torch.kernels.flash_attention import (flash_attention_bwd,
                                                        flash_attention_fwd,
                                                        key_bias)
    b, l, d = x.shape
    dh = d // heads
    with torch.no_grad():
        qkv = torch.nn.functional.linear(x, *w)
    q, k, v = (t.reshape(b, l, heads, dh).transpose(1, 2).contiguous()
               for t in qkv.split(d, dim=-1))
    bias = key_bias(mask)
    out, lse = flash_attention_fwd(q, k, v, bias)
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(11)
                     ).cuda()
    got = {"K3": flash_attention_bwd(q, k, v, bias, out, lse, do)}
    qd, kd, vd = (t.detach().clone().requires_grad_() for t in (q, k, v))
    s = torch.einsum("bhld,bhmd->bhlm", qd * dh ** -0.5, kd)
    y = torch.einsum("bhlm,bhmd->bhld",
                     torch.softmax(s + bias[:, None, None, :], -1), vd)
    got["dense"] = torch.autograd.grad(y, (qd, kd, vd), do)
    with torch.no_grad():
        o64, l64 = _fwd_f64(q, k, v, bias)
        ref = _bwd_f64(q, k, v, bias, o64, l64, do)
    return {name: {path: _signed(g[i], ref[i]) for path, g in got.items()}
            for i, name in enumerate(("dq", "dk", "dv"))}


def _rna_tf32(x):
    """x rounded to TF32, ties away (flash_tf32.cuh rna_tf32)."""
    import torch
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


# The probe's cases (kernels/csrc/tf32_sum_probe.cu): name, probe mode,
# and which operand is rounded to TF32 before the call.  P V's operands
# are p in [0, 1) and v of one sign, q' K^T's both of either sign.
PV_CASES = (("K2's earlier P V, mma3<kKeysTie>", 0, None),
            ("p exact in TF32", 0, "a"), ("v exact in TF32", 0, "b"),
            ("three products apart, summed in f32 RN", 1, None),
            ("no unbias", 2, None), ("f32 FFMA", 3, None))
QK_CASES = (("K2's q' K^T, mma3<kWidth>", 2, None),
            ("with unbias (kWidthTie)", 0, None), ("f32 FFMA", 3, None))


def tf32_sum_bias(card, tiles=8192):
    """The 3xTF32 sums of K2 alone, in the tf32_sum_probe micro-kernel
    (16 x K by K x 8 a warp): P V's over 128 keys (16 k-steps), p uniform
    in [0, 1), v = +|N(0, 1)| and -|N(0, 1)|, in each of PV_CASES; q' K^T's
    over a head width of 96 (12 k-steps), both N(0, 1), in each of
    QK_CASES.  Each against float64 on the same (rounded) inputs: the mean
    signed error over the mean |value| (its sign the value's), also per
    k-step, and the share of the first case's signed error that a case
    removes.  -> {(sum, sign, case): signed error}."""
    import ctypes
    import torch
    from sais_tpu_torch.kernels import _build
    lib = _build.load("tf32_sum_probe")
    lib.tf32_sum_probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    g = torch.Generator().manual_seed(17)
    p = torch.rand((tiles, 16, 128), generator=g).cuda()
    mag = torch.randn((tiles, 128, 8), generator=g).abs().cuda()
    qs = torch.randn((tiles, 16, 96), generator=g).cuda()
    ks = torch.randn((tiles, 96, 8), generator=g).cuda()
    runs = [("P V", "+", p, mag, PV_CASES), ("P V", "-", p, -mag, PV_CASES),
            ("q' K^T", "+-", qs, ks, QK_CASES)]
    result = {}
    for what, sign, a0, b0, cases in runs:
        kdim = a0.shape[-1]
        base = None
        for name, mode, exact in cases:
            a = _rna_tf32(a0) if exact == "a" else a0
            b = _rna_tf32(b0) if exact == "b" else b0
            c = torch.empty((tiles, 16, 8), device="cuda")
            rc = lib.tf32_sum_probe(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                    tiles, kdim, mode,
                                    torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"tf32_sum_probe mode {mode} failed: {rc}")
            torch.cuda.synchronize()
            signed, mean_abs = _signed(c, torch.einsum(
                "tik,tkj->tij", a.double(), b.double()))
            base = signed if base is None else base
            print(f"3xTF32 sum probe, {what} ({sign}), {kdim // 8} k-steps, "
                  f"{name}: signed error {signed:.4g} of the mean |value| "
                  f"({signed / (kdim // 8):.4g} a k-step), mean |error| "
                  f"{mean_abs:.4g}; share of the first case's signed error "
                  f"removed {1 - signed / base:.3f}; {card}", flush=True)
            result[(what, sign, name)] = signed
    return result


def _grad_gaps(ga, gb):
    """name -> (max|a - b| / max|b|, ||a - b|| / ||b||)"""
    return {n: ((ga[n] - gb[n]).abs().max().item()
                / max(gb[n].abs().max().item(), 1e-30),
                (ga[n] - gb[n]).norm().item()
                / max(gb[n].norm().item(), 1e-30)) for n in gb}


def k23_widths(card: str):
    """K2 and K3 at (B*S, H, L, Dh) = (32, 4, 129, 32) and (32, 4, 129,
    192), the -dim 128 and -dim 768 MIL batches' attention (17-129 tokens
    a gesture window), masked tails that differ per element, three
    elements with masked keys inside the valid range as well and one
    element with every key masked: each against its plain version
    (PERF.md §2's limits, 1e-4 of the largest plain value), CUDA-event
    times beside SDPA's and the bound.  Then Dh 50, which the wrapper
    packs into 52-wide aligned buffers, against the plain version."""
    import torch
    import torch.nn.functional as F
    from sais_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_fwd, flash_attention_reference, key_bias)
    b, h, l = 32, 4, 129
    out_rows = {}
    for dh in (32, 192, 50):
        g = torch.Generator().manual_seed(dh)
        q, k, v, do = (torch.randn((b, h, l, dh), generator=g).cuda()
                       for _ in range(4))
        valid = [l - (37 * i) % l for i in range(b - 1)] + [0]
        mask = torch.arange(l)[None, :] >= torch.tensor(valid)[:, None]
        # elements 1-3: masked keys inside the valid range too (a key
        # mask that is not a suffix)
        mask[1:4, 5:100:3] = True
        valid = (~mask).sum(1).tolist()
        mask = mask.cuda()
        bias = key_bias(mask)
        out = flash_attention(q, k, v, mask)
        fwd, lse = flash_attention_fwd(q, k, v, bias)
        ref, ref_lse = flash_attention_reference(q, k, v, bias)
        ref0 = ref.clone()
        ref0[-1] = 0.0
        do[-1] = 0.0
        got = flash_attention_bwd(q, k, v, bias, fwd, lse, do)
        want = flash_attention_bwd_reference(q, k, v, bias, fwd, lse, do)
        torch.cuda.synchronize()
        errs = {"out": ((out - ref0).abs().max().item(),
                        ref0.abs().max().item()),
                "lse": ((lse[:-1] - ref_lse[:-1]).abs().max().item(),
                        max(1.0, ref_lse[:-1].abs().max().item()))}
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            errs[name] = ((x - y).abs().max().item(), y.abs().max().item())
        for name, (err, scale) in errs.items():
            check(math.isfinite(err) and err <= 1e-4 * scale,
                  f"K2/K3 {name} at Dh {dh}: {err} > 1e-4 * {scale}")
        check(torch.count_nonzero(out[-1]).item() == 0
              and all(torch.count_nonzero(x[-1]).item() == 0 for x in got),
              f"Dh {dh}: the all-masked element is not exactly 0")
        line = ", ".join(f"{n} {e:.3g} (max {s:.3g})"
                         for n, (e, s) in errs.items())
        if dh == 50:
            print(f"K2/K3 (B*S, H, L, Dh) = ({b}, {h}, {l}, {dh}), packed "
                  f"to 52: {line}", flush=True)
            continue
        lib_mask = bias[:, None, None, :]
        k2_ms = cuda_time_ms(lambda: flash_attention_fwd(q, k, v, bias))
        k2_plain = cuda_time_ms(lambda: flash_attention_reference(
            q, k, v, bias), iters=5, warmup=1)
        k2_lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=lib_mask))
        k3_ms = cuda_time_ms(lambda: flash_attention_bwd(
            q, k, v, bias, fwd, lse, do))
        k3_plain = cuda_time_ms(lambda: flash_attention_bwd_reference(
            q, k, v, bias, fwd, lse, do), iters=5, warmup=1)
        lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))

        def lib_fwd():
            return F.scaled_dot_product_attention(lq, lk, lv,
                                                  attn_mask=lib_mask)

        with torch.no_grad():
            lib_fwd_ms = cuda_time_ms(lib_fwd)
        k3_lib = cuda_time_ms(lambda: torch.autograd.grad(
            lib_fwd(), (lq, lk, lv), do)) - lib_fwd_ms
        k2b = k2_bound_ms(b, h, l, dh, valid)
        k3b = k3_bound_ms(b, h, l, dh, valid)
        # device time a call: at these sizes the CUDA-event times above
        # can read the host's launch rate instead
        k2_dev = cuda_device_ms(lambda: flash_attention_fwd(q, k, v, bias))
        k3_dev = cuda_device_ms(lambda: flash_attention_bwd(
            q, k, v, bias, fwd, lse, do))
        out_rows[dh] = dict(k2=(k2_ms, k2b[0], k2b[1], k2_plain, k2_lib),
                            k3=(k3_ms, k3b[0], k3b[1], k3_plain, k3_lib))
        line += (f"; device time a call K2 {k2_dev:.4f} ms, K3 "
                 f"{k3_dev:.4f} ms")
        print(f"K2/K3 (B*S, H, L, Dh) = ({b}, {h}, {l}, {dh}): {line}; K2 "
              f"{k2_ms:.4f} ms (bound {k2b[0]:.4f} by {k2b[1]}, plain "
              f"{k2_plain:.4f}, SDPA {k2_lib:.4f}); K3 {k3_ms:.4f} ms "
              f"(bound {k3b[0]:.4f} by {k3b[1]}, plain {k3_plain:.4f}, "
              f"SDPA backward {k3_lib:.4f}); {card}", flush=True)
        del q, k, v, do, lq, lk, lv
    torch.cuda.empty_cache()
    return out_rows


def phase_classification(card: str):
    """`train -t MIL --dataset vua-gestures -d 1_vs_2 -bc -e 2 -bs 32
    --flash on` (fold 0; flash, dense and on the CPU; the dense fit again
    with K2's signed error), a Prototypes fit on `--dataset segments
    --split-policy per-gesture-video -mod RGB-Flow --flash on` and dense,
    one -t MIL step at -dim 128 and at -dim 768 (K2 / K3 at
    head widths 32 and 192 against the dense path), a `--no-self-attention`
    fit, and K2 / K3 alone at those widths; returns the K2 and K3
    launches of the driven runs."""
    import numpy as np
    import torch
    from sais_tpu_torch.data.collate import segment_batches
    from sais_tpu_torch.data.reference_datasets import (
        clean_gesture_timestamps, per_gesture_video_split,
        vua_gestures_tables)
    from sais_tpu_torch.kernels.flash_attention import (flash_attention,
                                                        flash_attention_bwd)

    t0 = time.perf_counter()
    rows, store, flow_store = _synthetic_gesture_data()
    tables, classes = vua_gestures_tables(rows, "1_vs_2", 0, balance=True)
    frames = {ph: [dict(r, Gesture=str(r["Gesture"])) for r in tables[ph]]
              for ph in ("train", "val", "test")}
    classes = [str(c) for c in classes]
    print(f"classification path data: {len(rows)} gesture rows, 40 videos "
          f"x 6000 frames x 384 and 400 flow rows a video "
          f"({time.perf_counter() - t0:.1f} s); vua-gestures 1_vs_2 fold 0 "
          f"rows train/val/test {[len(frames[p]) for p in frames]}, classes "
          f"{classes}", flush=True)
    check(classes == ["1", "2"], f"vua-gestures 1_vs_2 classes {classes}")
    stores = (store, None)

    # (a) the MIL fit: flash (K2 / K3), dense, and on the CPU
    k2 = k3 = 0
    fits = {}
    for mode, use_flash, device in (("flash", True, None),
                                    ("dense", None, None),
                                    ("CPU", True, "cpu")):
        flash_attention.launches = flash_attention_bwd.launches = 0
        tr, losses, nb, fit_s = _task_fit(frames, classes, stores,
                                          _cls_config(use_flash), device)
        fk2, fk3 = flash_attention.launches, flash_attention_bwd.launches
        fits[mode] = (tr, losses)
        train_b = 2 * nb["train"]
        eval_b = 2 * (nb.get("val", 0) + nb.get("test", 0))
        print(f"MIL fit ({mode}): {train_b} train and {eval_b} eval "
              f"batches in 2 epochs, {fit_s:.4f} s; losses "
              f"{[round(x, 6) for x in losses]}; K2 launches {fk2}, K3 "
              f"launches {fk3}; {card}", flush=True)
        check(all(math.isfinite(x) for x in losses),
              f"MIL fit ({mode}): non-finite epoch loss {losses}")
        if mode == "flash":
            # m = 1: MIL reads RGB only; the clip encoder stays dense
            check(fk3 == 4 * train_b, f"MIL fit: K3 launched {fk3} times, "
                  f"expected 4 x {train_b}")
            check(fk2 == 4 * train_b + 12 * eval_b,
                  f"MIL fit: K2 launched {fk2} times, expected 4 x "
                  f"{train_b} + 12 x {eval_b}")
            k2, k3 = k2 + fk2, k3 + fk3
        elif mode == "dense":
            check(fk2 == fk3 == 0, f"dense MIL fit launched K2 {fk2}, K3 "
                  f"{fk3} times")
    def gap(x, y):
        return float(np.max(np.abs(np.subtract(fits[x][1], fits[y][1]))))

    batch = next(segment_batches(frames["train"], store, classes,
                                 _cls_config(True).window, 32, True, seed=7))
    # Where flash and dense part: K2's output at the first encoder layer
    # (the same input on both paths, from the same weights) against the
    # dense path's, as a signed share of its mean |value|; then the dense
    # fit again with every frame-encoder layer's attention output moved by
    # that share, and by unbiased noise of K2's mean |error|
    errs = k2_signed_error(frames, classes, stores, batch)
    shift, noise = errs["shift"], errs["noise"]
    k3errs = k3_signed_error(*errs.pop("inputs"))
    print("K3 at the MIL fit's first layer against float64 (signed, mean "
          "|error|, of the mean |value|): " + "; ".join(
              f"{n} K3 {e['K3'][0]:.3g}, {e['K3'][1]:.3g}, dense f32 "
              f"{e['dense'][0]:.3g}, {e['dense'][1]:.3g} (K3 "
              f"{abs(e['K3'][0]) / max(abs(e['dense'][0]), 1e-300):.3g}x)"
              for n, e in k3errs.items()) + f"; {card}", flush=True)
    tf32_sum_bias(card)
    # and with unbiased noise of 1e-8: 1 + 1e-8 N(0, 1) rounds to 1 in
    # f32 except where N < -2.98 or > 5.96, so about 0.15% of the values
    # move by one ulp (the fit's sensitivity to any change of rounding)
    for mode, amp in (("signed", noise), ("noise", noise), ("1e-8", 1e-8)):
        fits[mode] = (None, _task_fit(
            frames, classes, stores, _cls_config(None), None,
            attn_error=("signed" if mode == "signed" else "noise", shift,
                        amp))[1])
    # Limits 1e-3: f32 on both sides; two epochs of SGD carry the
    # differences of every step (the training phase's limit)
    print(f"MIL fit epoch losses: flash vs dense max|diff| "
          f"{gap('flash', 'dense'):.3g}; dense (card) vs CPU "
          f"{gap('dense', 'CPU'):.3g}; flash vs CPU "
          f"{gap('flash', 'CPU'):.3g}.  K2 at the first layer against the "
          f"dense path: signed error {shift:.3g}, mean |error| {noise:.3g} "
          f"of the mean |value|; the dense fit with that signed error in "
          f"every layer's attention: losses "
          f"{[round(x, 6) for x in fits['signed'][1]]}, vs flash "
          f"{gap('signed', 'flash'):.3g}, vs dense "
          f"{gap('signed', 'dense'):.3g}; with unbiased noise of that size: "
          f"vs dense {gap('noise', 'dense'):.3g}; with unbiased noise of "
          f"1e-8: losses {[round(x, 6) for x in fits['1e-8'][1]]}, vs "
          f"dense {gap('1e-8', 'dense'):.3g}.  Against the same "
          f"attention in float64 (signed, mean |error|, of the mean "
          f"|value|): K2 {errs['K2'][0]:.3g}, {errs['K2'][1]:.3g}; dense "
          f"f32 {errs['dense'][0]:.3g}, {errs['dense'][1]:.3g}", flush=True)
    # K2's signed error against float64 within 2x of the dense path's
    check(abs(errs["K2"][0]) <= 2 * abs(errs["dense"][0]),
          f"K2's signed error {errs['K2'][0]:.3g} is more than 2x the dense "
          f"path's {errs['dense'][0]:.3g}")
    check(gap("flash", "dense") <= 1e-3,
          f"MIL fit: flash and dense losses differ {gap('flash', 'dense')}")
    check(gap("dense", "CPU") <= 1e-3,
          f"MIL fit: card and CPU losses differ {gap('dense', 'CPU')}")

    def step_ms(tr):
        tr.train_step(batch)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t = time.perf_counter()
            tr.train_step(batch)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
        return sorted(times)[2]

    flash_ms, dense_ms = (step_ms(fits[m][0]) for m in ("flash", "dense"))
    # the device time of one step, its launches queued behind a spin
    # kernel (the batch already on the card, so the step enqueues without
    # waiting): what the step would take if the host kept up
    cuda_batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    busy_ms = cuda_device_ms(lambda: fits["flash"][0].train_step(cuda_batch),
                             iters=1, warmup=2)
    print(f"MIL train step (batch 32, {batch['rgb'].shape[2] + 1} tokens): "
          f"flash {flash_ms:.3f} ms, dense {dense_ms:.3f} ms median of 5; "
          f"device time of a flash step {busy_ms:.3f} ms "
          f"({100 * (1 - busy_ms / flash_ms):.1f}% idle); {card}",
          flush=True)
    del fits

    # (b) Prototypes on --dataset segments --split-policy per-gesture-video
    # -mod RGB-Flow --flash on: flow windows of 2-16 tokens (a segment
    # with no flow row keeps one masked slot beside the CLS) on K2 / K3,
    # and the same fit dense
    segs = clean_gesture_timestamps(rows, int_labels=False)
    pframes = dict(zip(("train", "val", "test"),
                       per_gesture_video_split(segs, 0, balance=True)))
    pclasses = sorted({r["Gesture"] for r in segs})
    flash_attention.launches = flash_attention_bwd.launches = 0
    _, plosses, pnb, pfit_s = _task_fit(
        pframes, pclasses, (store, flow_store),
        _cls_config(True, "RGB-Flow"), None, task="Prototypes")
    pk2, pk3 = flash_attention.launches, flash_attention_bwd.launches
    dlosses = _task_fit(pframes, pclasses, (store, flow_store),
                        _cls_config(None, "RGB-Flow"), None,
                        task="Prototypes")[1]
    pdiff = float(np.max(np.abs(np.subtract(plosses, dlosses))))
    train_b = 2 * pnb["train"]
    eval_b = 2 * (pnb.get("val", 0) + pnb.get("test", 0))
    print(f"Prototypes fit (per-gesture-video, RGB-Flow, flash): rows "
          f"train/val/test {[len(pframes[p]) for p in pframes]}, classes "
          f"{pclasses}, {pfit_s:.4f} s, losses "
          f"{[round(x, 6) for x in plosses]}; K2 launches {pk2}, K3 "
          f"launches {pk3}; dense losses {[round(x, 6) for x in dlosses]}, "
          f"max|flash - dense| {pdiff:.3g}; {card}", flush=True)
    check(all(math.isfinite(x) for x in plosses),
          f"RGB-Flow fit: non-finite loss {plosses}")
    check(pdiff <= 1e-3, f"RGB-Flow fit: flash and dense losses differ "
          f"{pdiff}")
    check(pk3 == 8 * train_b and pk2 == 8 * train_b + 24 * eval_b,
          f"RGB-Flow fit launched K2 {pk2}, K3 {pk3} times; expected "
          f"{8 * train_b + 24 * eval_b} and {8 * train_b}")
    k2, k3 = k2 + pk2, k3 + pk3

    # (c) one -t MIL step at -dim 128 and -dim 768 (head widths 32 and
    # 192), flash against dense from the same weights and batch
    rng = np.random.default_rng(3)
    few = sorted({r["Video"] for r in frames["train"]})[:8]
    few_rows = [r for r in frames["train"] if r["Video"] in few][:32]
    for dim in (128, 768):
        dstore = _ArrayStore({v: rng.standard_normal((6000, dim)).astype(
            np.float32) for v in few})
        dbatch = next(segment_batches(few_rows, dstore, classes,
                                      _cls_config(True).window, 32, False))
        result = {}
        for mode, use_flash in (("flash", True), ("dense", False)):
            tr = _task_fit({"train": [], "val": [], "test": []}, classes,
                           (dstore, None), _cls_config(use_flash,
                                                       rep_dim=dim),
                           None, nepochs=0)[0]
            flash_attention.launches = flash_attention_bwd.launches = 0
            loss, _ = tr.loss_fn(tr.model, tr._device_batch(dbatch))
            loss.backward()
            torch.cuda.synchronize()
            result[mode] = (loss.item(), {
                n: p.grad.detach().clone()
                for n, p in tr.model.named_parameters()
                if p.grad is not None}, flash_attention.launches,
                flash_attention_bwd.launches)
            del tr
        (floss, fg, fk2, fk3), (dloss, dg, dk2, dk3) = (result["flash"],
                                                        result["dense"])
        gaps = _grad_gaps(fg, dg)
        worst = max((v[0], n) for n, v in gaps.items() if n != "frame_pos")
        print(f"MIL step at -dim {dim} (head width {dim // 4}, batch 32, "
              f"{dbatch['rgb'].shape[2] + 1} tokens): loss flash "
              f"{floss:.8f} dense {dloss:.8f}; K2 launches {fk2}, K3 {fk3} "
              f"(dense {dk2}, {dk3}); worst gradient max|flash - dense| / "
              f"max|dense| {worst[0]:.3g} ({worst[1]}); frame_pos "
              f"norm-relative {gaps['frame_pos'][1]:.3g}", flush=True)
        check(fk2 == fk3 == 4 and dk2 == dk3 == 0,
              f"-dim {dim} step launched K2 {fk2}, K3 {fk3} (dense {dk2}, "
              f"{dk3})")
        check(set(fg) == set(dg), "-dim step: gradients differ in members")
        check(abs(floss - dloss) <= 1e-5 * abs(dloss),
              f"-dim {dim} step loss differs: {floss} vs {dloss}")
        # the long step's rule: 1e-3 of the largest dense gradient,
        # frame_pos in the norm
        check(worst[0] <= 1e-3, f"-dim {dim} gradient {worst[1]} differs: "
              f"{worst[0]}")
        check(gaps["frame_pos"][1] <= 1e-3,
              f"-dim {dim} frame_pos gradient differs: {gaps['frame_pos']}")
        k2, k3 = k2 + fk2, k3 + fk3
        del dstore

    # (d) a --no-self-attention MIL fit under --flash on: no encoder, so
    # neither kernel runs
    flash_attention.launches = flash_attention_bwd.launches = 0
    _, nlosses, _, nfit_s = _task_fit(
        frames, classes, stores, _cls_config(True, self_attention=False),
        None, nepochs=1)
    nk2, nk3 = flash_attention.launches, flash_attention_bwd.launches
    print(f"--no-self-attention MIL fit (1 epoch): {nfit_s:.4f} s, losses "
          f"{[round(x, 6) for x in nlosses]}; K2 launches {nk2}, K3 "
          f"launches {nk3}", flush=True)
    check(nk2 == nk3 == 0 and all(math.isfinite(x) for x in nlosses),
          f"--no-self-attention fit: K2 {nk2}, K3 {nk3}, losses {nlosses}")

    k23_widths(card)
    return k2, k3


CROSSOVER_LENGTHS = (301, 512, 1024, 2001, 8193)


def flash_crossover():
    """prototypes_forward (batch 2, inference mode, max_positions 8192) on
    the flash path (K2) against the dense path at each length of
    CROSSOVER_LENGTHS, median of five CUDA-event runs after a warm-up each;
    prints one `flash_crossover` JSON line whose `crossing` is the first
    length from which flash is faster at every longer length measured."""
    import numpy as np
    import torch
    from sais_tpu_torch.config import ModelConfig, TemporalConfig
    from sais_tpu_torch.models.full_model import (full_model_init,
                                                  prototypes_forward)

    def config(use_flash):
        return ModelConfig(modalities="RGB", temporal=TemporalConfig(
            use_flash=use_flash, max_positions=CROSSOVER_LENGTHS[-1] - 1))

    model = full_model_init(torch.Generator().manual_seed(5),
                            config(True)).cuda()
    rng = np.random.default_rng(6)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    flash_ms, dense_ms = [], []
    for l in CROSSOVER_LENGTHS:
        rgb = torch.from_numpy(rng.standard_normal(
            (2, 1, l - 1, 384)).astype(np.float32)).cuda()
        mask = torch.zeros((2, 1, l), dtype=torch.bool, device="cuda")
        for use_flash, times in ((True, flash_ms), (False, dense_ms)):
            cfg = config(use_flash)
            runs = []
            with torch.inference_mode():
                prototypes_forward(model, cfg, rgb, mask)
                for _ in range(5):
                    start.record()
                    prototypes_forward(model, cfg, rgb, mask)
                    end.record()
                    torch.cuda.synchronize()
                    runs.append(start.elapsed_time(end))
            times.append(sorted(runs)[2])
        del rgb, mask
    torch.cuda.empty_cache()
    faster = [f < d for f, d in zip(flash_ms, dense_ms)]
    crossing = next((l for i, l in enumerate(CROSSOVER_LENGTHS)
                     if all(faster[i:])), None)
    print("flash_crossover " + json.dumps({
        "lengths": list(CROSSOVER_LENGTHS), "batch": 2,
        "flash_ms": flash_ms, "dense_ms": dense_ms, "crossing": crossing}),
        flush=True)


# ---------------------------------------------------------------------------
# K4, K5, K6: the ViT block's training kernels
# ---------------------------------------------------------------------------

# (B, L, valid): the pretrain step's global and local crop groups, and one
# masked shape (keys >= 197 of 208 masked, as the JAX package pads rows)
TRAIN_SHAPES = ((128, 197, 197), (512, 37, 37), (64, 208, 197))


def train_scales(b, l, seed):
    """Per-image branch scales in {0, 1/0.9} (about a quarter dropped, image
    0's attention branch and image 1's MLP branch among them), (B, L, 1)
    bf16 on the card."""
    import torch
    g = torch.Generator().manual_seed(seed)
    keep = (torch.rand((2, b), generator=g) < 0.75).float()
    keep[0, 0] = keep[1, 1] = 0.0
    return [(k / 0.9).to(torch.bfloat16)[:, None, None].expand(b, l, 1)
            .contiguous().cuda() for k in keep]


def train_bounds(b, l, d, mlp):
    """Least times of K4, K5, K6 on (B, L, D): the products the JAX bodies
    execute per image (K4 24 L D^2 + 4 L^2 D, K5 40 L D^2, K6 22 L D^2 + 12
    L^2 D; MLP 4 D) at the bf16 peak, against the bytes each must move: its
    bf16 activations and branch scales read and written once, its bf16
    weights read once, its f32 weight gradients written once."""
    assert mlp == 4 * d
    act, scale = 2 * b * l * d, 2 * b * l
    w_mlp = 2 * d * mlp + mlp + 3 * d          # fc1, fc2, LN2 elements
    w_attn = 4 * d * d + 4 * d + 2 * d         # qkv, proj, LN1 elements
    out = {}
    for name, flops, nbytes in (
            ("K4", 24 * b * l * d * d + 4 * b * l * l * d,
             3 * act + 2 * scale + 2 * (w_mlp + w_attn)),
            ("K5", 40 * b * l * d * d, 3 * act + scale + 6 * w_mlp),
            ("K6", 22 * b * l * d * d + 12 * b * l * l * d,
             3 * act + scale + 6 * w_attn)):
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        out[name] = (1e3 * max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes", flops,
                     nbytes)
    return out


def library_mlp_half(x1, lib_w, eps):
    """out = x1 + fc2(gelu_tanh(fc1(LN2(x1)))) as PyTorch library calls."""
    import torch.nn.functional as F
    fc1_w, fc1_b, fc2_w, fc2_b, ln2_s, ln2_b = lib_w
    y = F.layer_norm(x1, (x1.shape[-1],), ln2_s, ln2_b, eps)
    h = F.gelu(F.linear(y, fc1_w, fc1_b), approximate="tanh")
    return x1 + F.linear(h, fc2_w, fc2_b)


def library_attn_half(x, lib_w, heads, valid_len, eps):
    """x1 = x + proj(SDPA(qkv(LN1(x)))) as PyTorch library calls."""
    import torch
    import torch.nn.functional as F
    qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b = lib_w
    b, l, d = x.shape
    y = F.layer_norm(x, (d,), ln1_s, ln1_b, eps)
    q, k, v = F.linear(y, qkv_w, qkv_b).view(b, l, 3, heads,
                                             d // heads).permute(2, 0, 3, 1, 4)
    mask = None
    if valid_len < l:
        mask = (torch.arange(l, device=x.device) < valid_len)[None, :]
    ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    return x + F.linear(ctx.transpose(1, 2).reshape(b, l, d), proj_w, proj_b)


def library_bwd_ms(fn, inputs, cot):
    """Backward time of a library composition: forward + backward minus
    forward, CUDA events."""
    import torch
    leaves = [t.detach().clone().requires_grad_() for t in inputs]

    def fwd():
        return fn(*leaves)

    def fwd_bwd():
        torch.autograd.grad(fwd(), leaves, cot)

    with torch.no_grad():
        fwd_ms = cuda_time_ms(fwd, iters=10)
    return cuda_time_ms(fwd_bwd, iters=10) - fwd_ms


def phase_train_kernels(parent=None):
    """Phase 9: K4, K5 and K6 at the pretrain shapes; `parent`: a
    ParentKernels to time beside K6 at (128, 197), where both trees run
    the same code (outputs bitwise equal)."""
    import torch
    from sais_tpu_torch.kernels.fused_mha import (
        block_bwd_attn_reference, block_bwd_mlp_reference,
        fused_block_bwd_attn, fused_block_bwd_mlp, fused_block_fwd_train,
        vit_block_train_reference)
    d, heads, mlp, eps = 384, 6, 1536, 1e-6
    worst = {"K4": 0.0, "K5": 0.0, "K6": 0.0}
    result = {}
    for b, l, valid in TRAIN_SHAPES:
        x, ws = k1_inputs(b, l, d, heads, mlp, seed=l + 3)
        mlp_w, attn_w = ws[4:8] + ws[10:12], ws[0:4] + ws[8:10]
        dout = torch.randn(x.shape, generator=torch.Generator().manual_seed(
            l)).to("cuda", torch.bfloat16)
        kw = dict(num_heads=heads, valid_len=valid, eps=eps)
        for scaled in (False, True):
            s1, s2 = train_scales(b, l, l) if scaled else (None, None)
            got = fused_block_fwd_train(x, *ws, s1=s1, s2=s2, **kw)
            torch.cuda.synchronize()
            ref = vit_block_train_reference(x, *ws, s1=s1, s2=s2, **kw)
            x1 = ref[1]
            checks = [("K4", n, a[:, :valid], r[:, :valid]) for n, a, r in
                      zip(("out", "x1"), got, ref)]
            got = fused_block_bwd_mlp(x1, dout, *mlp_w, eps=eps, s2=s2)
            again = fused_block_bwd_mlp(x1, dout, *mlp_w, eps=eps, s2=s2)
            torch.cuda.synchronize()
            # fixed-order sums, no atomics: two runs agree to the bit
            check(all(torch.equal(u, v) for u, v in zip(got, again)),
                  f"K5 differs between two runs at ({b}, {l}, {valid})")
            ref = block_bwd_mlp_reference(x1, dout, *mlp_w, eps=eps, s2=s2)
            dx1 = ref[0]
            checks += [("K5", n, a, r) for n, a, r in zip(
                ("dx1", "dfc1_w", "dfc1_b", "dfc2_w", "dfc2_b", "dln2_s",
                 "dln2_b"), got, ref)]
            got = fused_block_bwd_attn(x, dx1, *attn_w, s1=s1, **kw)
            again = fused_block_bwd_attn(x, dx1, *attn_w, s1=s1, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(u, v) for u, v in zip(got, again)),
                  f"K6 differs between two runs at ({b}, {l}, {valid})")
            ref = block_bwd_attn_reference(x, dx1, *attn_w, s1=s1, **kw)
            checks += [("K6", n, a, r) for n, a, r in zip(
                ("dx", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b", "dln1_s",
                 "dln1_b"), got, ref)]
            del again
            line = []
            for kernel, name, a, r in checks:
                err = (a.float() - r.float()).abs().max().item()
                scale = r.float().abs().max().item()
                line.append(f"{name} {err:.3g}/{scale:.3g}")
                # Limit 2e-2 * max|plain|: the two round at the same points
                # and sum in another order, which moves a bf16 value by an
                # ulp or two (2**-8) and an f32 sum over B*L rows by less.
                check(math.isfinite(err) and err <= 2e-2 * scale,
                      f"{kernel} {name} disagrees with its plain version at "
                      f"(B, L, valid) = ({b}, {l}, {valid}), scaled "
                      f"{scaled}: {err} > 2e-2 * {scale}")
                worst[kernel] = max(worst[kernel], err)
            print(f"K4-K6 (B, L, valid) = ({b}, {l}, {valid})"
                  f"{' scaled' if scaled else ''}: max|kernel-plain| / "
                  f"max|plain|: {', '.join(line)}; K5 and K6 bitwise equal "
                  "in two runs", flush=True)
        del got, ref, checks
        if valid != l:
            del x, ws, x1, dx1, dout
            continue
        # times with branch scales, as the pretrain step runs them
        s1, s2 = train_scales(b, l, l)
        kw = dict(num_heads=heads, valid_len=valid, eps=eps)
        runs = {
            "K4": (lambda: fused_block_fwd_train(x, *ws, s1=s1, s2=s2, **kw),
                   lambda: vit_block_train_reference(x, *ws, s1=s1, s2=s2,
                                                     **kw)),
            "K5": (lambda: fused_block_bwd_mlp(x1, dout, *mlp_w, eps=eps,
                                               s2=s2),
                   lambda: block_bwd_mlp_reference(x1, dout, *mlp_w, eps=eps,
                                                   s2=s2)),
            "K6": (lambda: fused_block_bwd_attn(x, dx1, *attn_w, s1=s1, **kw),
                   lambda: block_bwd_attn_reference(x, dx1, *attn_w, s1=s1,
                                                    **kw))}
        lib_w = [w.t().contiguous() if w.dim() == 2 else w for w in ws]
        library = {
            "K4": cuda_time_ms(lambda: library_block(x, lib_w, heads, valid,
                                                     eps)),
            "K5": library_bwd_ms(
                lambda a, *w: library_mlp_half(a, w, eps),
                [x1] + lib_w[4:8] + lib_w[10:12], dout),
            "K6": library_bwd_ms(
                lambda a, *w: library_attn_half(a, w, heads, valid, eps),
                [x] + lib_w[0:4] + lib_w[8:10], dx1)}
        bounds = train_bounds(b, l, d, mlp)
        for name, (kernel, plain) in runs.items():
            ms = cuda_time_ms(kernel)
            plain_ms = cuda_time_ms(plain, iters=3, warmup=1)
            bound_ms, bound_by, flops, nbytes = bounds[name]
            print(f"{name} B={b} L={l} D={d} scaled: kernel {ms:.4f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} "
                  f"ms, library {library[name]:.4f} ms; bound "
                  f"{bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.1f} "
                  f"GFLOP, {nbytes / 1e6:.1f} MB), kernel at "
                  f"{100 * bound_ms / ms:.1f}% of the bound", flush=True)
            if (b, l) == (128, 197):
                result[name] = dict(ms=ms, plain_ms=plain_ms,
                                    library_ms=library[name],
                                    bound_ms=bound_ms, bound_by=bound_by)
        block_launch_split(runs["K4"][0], "k4_profile", b, l, d, mlp)
        bwd_launch_split(runs["K5"][0], runs["K6"][0], b, l, d, mlp)
        if parent is not None and (b, l) == (128, 197):
            parent.compare("K6", (b, l, d), lambda: parent.k6(
                x, dx1, attn_w, s1, **kw), runs["K6"][0],
                dict.fromkeys(range(7), 0.0))
        if (b, l) == (128, 197):
            _profile(lambda: [fn() for fn, _ in runs.values()],
                     "k4_k5_k6_profile", 3)
        del x, ws, x1, dx1, dout
        torch.cuda.empty_cache()
    for name in result:
        result[name]["max_abs_err"] = worst[name]
    return result


# ---------------------------------------------------------------------------
# K1, K4, K5, K6, K8 past 256 tokens: the key-tiled attention
# ---------------------------------------------------------------------------

# (B, L, valid, D): the vits8 step's global crops (128 of 785 tokens,
# ViT-S widths), the vitb8 geometry (ViT-B widths), the first length past
# the register kernels' reach, a length past 1024, and one masked shape
# (keys >= 785 of 800 masked, as the JAX package pads rows to 16)
LONG_SHAPES = ((128, 785, 785, 384), (64, 785, 785, 768),
               (32, 257, 257, 384), (16, 1025, 1025, 384),
               (32, 800, 785, 384))


def phase_long_blocks(parent=None):
    """Phase 11: K1, K4, K5, K6 and K8 at LONG_SHAPES against their plain
    versions (2e-2 of the plain version's largest value, as at 197 tokens;
    K8 also against K1 at a reference-initialized block, JAX's limits),
    each run twice and bitwise equal; ms, bound, plain and library ms of
    each; k1_profile, k5_profile and k6_profile at (128, 785), which must
    name the key-tiled attention kernels.  `parent`: a ParentKernels whose
    K1 and K6 are timed beside this tree's at the two 785-token shapes of
    ViT-S and ViT-B widths (outputs within the plain limit).  Returns {(B,
    L, valid, D): {kernel: numbers}}."""
    import torch
    from sais_tpu_torch.config import ViTConfig
    from sais_tpu_torch.kernels import fused_mha as fm
    from sais_tpu_torch.models.vit import block_weights_bf16, vit_init
    eps = 1e-6
    out = {}
    for b, l, valid, d in LONG_SHAPES:
        heads, mlp = d // 64, 4 * d
        x, ws = k1_inputs(b, l, d, heads, mlp, seed=l + d)
        mlp_w, attn_w = ws[4:8] + ws[10:12], ws[0:4] + ws[8:10]
        s1, s2 = train_scales(b, l, l)
        dout = torch.randn(x.shape, generator=torch.Generator().manual_seed(
            l)).to("cuda", torch.bfloat16)
        kw = dict(num_heads=heads, valid_len=valid, eps=eps)
        # K8 at a block as the reference initializes it and unit-normal
        # tokens (JAX's int8 test; the K8 phase's reading)
        w8 = [w.detach().cuda() for w in block_weights_bf16(vit_init(
            torch.Generator().manual_seed(0), ViTConfig(
                patch_size=8, embed_dim=d, depth=1,
                num_heads=heads)).blocks[0])]
        x8 = torch.randn((b, l, d), generator=torch.Generator().manual_seed(
            1)).to("cuda", torch.bfloat16)
        x1 = fm.vit_block_train_reference(x, *ws, s1=s1, s2=s2, **kw)[1]
        dx1 = fm.block_bwd_mlp_reference(x1, dout, *mlp_w, eps=eps, s2=s2)[0]
        runs = {
            "K1": (lambda: fm.fused_vit_block(x, *ws, **kw),
                   lambda: fm.vit_block_reference(x, *ws, **kw)),
            "K4": (lambda: fm.fused_block_fwd_train(x, *ws, s1=s1, s2=s2,
                                                    **kw),
                   lambda: fm.vit_block_train_reference(x, *ws, s1=s1, s2=s2,
                                                        **kw)),
            "K5": (lambda: fm.fused_block_bwd_mlp(x1, dout, *mlp_w, eps=eps,
                                                  s2=s2),
                   lambda: fm.block_bwd_mlp_reference(x1, dout, *mlp_w,
                                                      eps=eps, s2=s2)),
            "K6": (lambda: fm.fused_block_bwd_attn(x, dx1, *attn_w, s1=s1,
                                                   **kw),
                   lambda: fm.block_bwd_attn_reference(x, dx1, *attn_w,
                                                       s1=s1, **kw)),
            "K8": (lambda: fm.fused_vit_block_int8(x8, *w8, **kw),
                   lambda: fm.vit_block_int8_reference(x8, *w8, **kw))}
        line = []
        for name, (kernel, plain) in runs.items():
            got, again = kernel(), kernel()
            torch.cuda.synchronize()
            got = (got,) if isinstance(got, torch.Tensor) else got
            again = (again,) if isinstance(again, torch.Tensor) else again
            # fixed-order sums, no atomics: two runs agree to the bit
            check(all(torch.equal(u, v) for u, v in zip(got, again)),
                  f"{name} differs between two runs at ({b}, {l}, {valid}, "
                  f"{d})")
            ref = plain()
            ref = (ref,) if isinstance(ref, torch.Tensor) else ref
            worst = 0.0
            for i, (a, r) in enumerate(zip(got, ref)):
                if name in ("K1", "K4", "K8"):   # rows past valid: padding
                    a, r = a[:, :valid], r[:, :valid]
                err = (a.float() - r.float()).abs().max().item()
                scale = r.float().abs().max().item()
                # Limit 2e-2 * max|plain|: the same rounding points summed
                # in another order (an ulp or two of bf16); for K8 one int8
                # step at a quantizer tie
                check(math.isfinite(err) and err <= 2e-2 * scale,
                      f"{name} output {i} disagrees with its plain version "
                      f"at (B, L, valid, D) = ({b}, {l}, {valid}, {d}): "
                      f"{err} > 2e-2 * {scale}")
                worst = max(worst, err / scale)
            line.append(f"{name} {worst:.3g}")
            out.setdefault((b, l, valid, d), {})[name] = {"rel_err": worst}
            del got, again, ref
        k8 = fm.fused_vit_block_int8(x8, *w8, **kw)[:, :valid].float()
        bf = fm.fused_vit_block(x8, *w8, **kw)[:, :valid].float()
        cos = (torch.dot(k8.ravel(), bf.ravel())
               / (k8.norm() * bf.norm())).item()
        rel = ((k8 - bf).abs().max() / bf.abs().max()).item()
        del k8, bf
        check(cos > 0.9999 and rel < 0.02, f"K8 too far from K1 at ({b}, "
              f"{l}, {valid}, {d}): cosine {cos}, max relative {rel}")
        print(f"long blocks (B, L, valid, D) = ({b}, {l}, {valid}, {d}): "
              f"max|kernel-plain| / max|plain| {', '.join(line)}; each run "
              f"twice, bitwise equal; K8 against K1 cosine {cos:.7f}, max "
              f"relative {rel:.4g}", flush=True)

        # times with branch scales, as the pretrain step runs them
        lib_w = [w.t().contiguous() if w.dim() == 2 else w for w in ws]
        library = {
            "K1": lambda: library_block(x, lib_w, heads, valid, eps),
            "K4": lambda: library_block(x, lib_w, heads, valid, eps),
            "K5": lambda: library_bwd_ms(
                lambda a, *w: library_mlp_half(a, w, eps),
                [x1] + lib_w[4:8] + lib_w[10:12], dout),
            "K6": lambda: library_bwd_ms(
                lambda a, *w: library_attn_half(a, w, heads, valid, eps),
                [x] + lib_w[0:4] + lib_w[8:10], dx1),
            "K8": lambda: library_block_int8(x8, w8, heads, valid, eps)}
        weight_bytes = sum(w.numel() * w.element_size() for w in ws)
        bounds = train_bounds(b, l, d, mlp)
        bounds["K1"] = k1_bound_ms(b, l, d, mlp, weight_bytes)
        k8b = k8_bound_ms(b, l, d, mlp, weight_bytes)
        bounds["K8"] = (k8b[0], k8b[1], k8b[3], k8b[4])
        for name, (kernel, plain) in runs.items():
            ms = cuda_time_ms(kernel, iters=10, warmup=2)
            plain_ms = cuda_time_ms(plain, iters=2, warmup=1)
            lib = library[name]
            lib_ms = lib() if name in ("K5", "K6") else cuda_time_ms(
                lib, iters=10, warmup=2)
            bound_ms, bound_by = bounds[name][:2]
            print(f"long {name} (B, L, valid, D) = ({b}, {l}, {valid}, {d}): "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                  f"{lib_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by}, "
                  f"kernel at {100 * bound_ms / ms:.1f}% of the bound",
                  flush=True)
            out[(b, l, valid, d)][name].update(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)
        if parent is not None and (l, valid) == (785, 785):
            # the earlier tree's key-tiled kernels, with branch scales as
            # the pretrain step runs K6
            for name, old in (("K1", lambda: parent.k1(x, ws, **kw)),
                              ("K6", lambda: parent.k6(x, dx1, attn_w, s1,
                                                       **kw))):
                kernel = runs[name][0]
                outs = 1 if name == "K1" else 7
                t = parent.compare(name, (b, l, d), old, kernel,
                                   dict.fromkeys(range(outs), 2e-2))
                out[(b, l, valid, d)][name]["parent_ms"] = t[0]
        if (b, l, d) == (128, 785, 384):
            block_launch_split(runs["K1"][0], "k1_profile", b, l, d, mlp)
            bwd_launch_split(runs["K5"][0], runs["K6"][0], b, l, d, mlp)
        del x, ws, x1, dx1, dout, x8, w8, runs, library
        torch.cuda.empty_cache()
    return out


class ParentKernels:
    """K1, K6, K7 and K8 as an earlier tree built them (`--parent-csrc
    DIR`: that tree's kernels/csrc, with this tree's C ABI for them:
    fused_vit_block_fwd, fused_block_bwd_attn(_workspace),
    dino_head_loss(_workspace) and fused_vit_block_int8(_workspace), as
    of PR 9's tree), built here into a temporary directory and timed
    beside this tree's kernels on the same card, in turns (earlier, this,
    this, earlier)."""

    def __init__(self, csrc):
        import ctypes
        from sais_tpu_torch.kernels import _build
        self.tmp = tempfile.mkdtemp(prefix="parent_kernels_")
        procs = {}
        for name in ("fused_vit_block", "fused_block_bwd_attn",
                     "dino_head_loss", "fused_vit_block_int8",
                     "flash_attention", "flash_attention_bwd"):
            out = os.path.join(self.tmp, f"{name}.so")
            procs[name] = (out, subprocess.Popen(
                [_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                 "-shared", "-Xcompiler", "-fPIC", "-o", out,
                 os.path.join(csrc, f"{name}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        self.libs = {}
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for name, (out, proc) in procs.items():
            log, _ = proc.communicate()
            check(proc.returncode == 0, f"parent {name}.cu: nvcc failed\n{log}")
            self.libs[name] = ctypes.CDLL(out)
        k7, k8 = self.libs["dino_head_loss"], self.libs["fused_vit_block_int8"]
        k7.dino_head_loss_workspace.argtypes = [i32] * 4
        k7.dino_head_loss_workspace.restype = ctypes.c_size_t
        k7.dino_head_loss.argtypes = [ptr] * 16 + [i32] * 5 + [f32] * 3 + [
            ptr]
        k8.fused_vit_block_int8_workspace.argtypes = [i32] * 3
        k8.fused_vit_block_int8_workspace.restype = ctypes.c_size_t
        k8.fused_vit_block_int8.argtypes = [ptr] * 15 + [i32] * 6 + [f32, ptr]
        k1 = self.libs["fused_vit_block"]
        k1.fused_vit_block_fwd.argtypes = [ptr] * 17 + [i32] * 6 + [f32, ptr]
        k6 = self.libs["fused_block_bwd_attn"]
        k6.fused_block_bwd_attn_workspace.argtypes = [i32] * 3
        k6.fused_block_bwd_attn_workspace.restype = ctypes.c_size_t
        k6.fused_block_bwd_attn.argtypes = [ptr] * 25 + [i32] * 5 + [f32, ptr]
        i64 = ctypes.c_longlong
        k2 = self.libs["flash_attention"]
        k2.flash_attention_fwd.argtypes = [ptr] * 6 + [i32] * 5 + [
            i64] * 12 + [f32, i32, ptr]
        k3 = self.libs["flash_attention_bwd"]
        k3.flash_attention_bwd.argtypes = [ptr] * 10 + [i32] * 5 + [
            i64] * 21 + [f32, ptr]
        print(f"parent K1, K2, K3, K6, K7 and K8 built from {csrc}",
              flush=True)

    def k2(self, q, k, v, bias):
        """The earlier K2 (flash_attention_fwd, this tree's C ABI) on
        operands that keep its row rule; (out, lse)."""
        import torch
        b, h, lq, dh = q.shape
        out = torch.empty((b, lq, h, dh), dtype=torch.float32,
                          device=q.device).transpose(1, 2)
        lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
        rc = self.libs["flash_attention"].flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, lq, k.shape[2], dh, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], dh ** -0.5,
            0, torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"parent K2 launch failed ({rc})")
        return out, lse

    def k3(self, q, k, v, bias, do, lse, delta):
        """The earlier K3 (flash_attention_bwd, the same C ABI); (dq, dk,
        dv)."""
        import torch
        b, h, lq, dh = q.shape
        grads = [torch.empty((b, t.shape[2], h, dh), dtype=torch.float32,
                             device=q.device).transpose(1, 2)
                 for t in (q, k, v)]
        rc = self.libs["flash_attention_bwd"].flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            *(g.data_ptr() for g in grads), b, h, lq, k.shape[2], dh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3], *(st for g in grads for st in g.stride()[:3]),
            dh ** -0.5, torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"parent K3 launch failed ({rc})")
        return grads

    def k1(self, x, ws, num_heads, valid_len, eps):
        import torch
        b, l, d = x.shape
        mlp = ws[4].shape[1]
        out = torch.empty_like(x)
        bufs = [torch.empty(shape, dtype=x.dtype, device=x.device) for shape
                in ((b * l, d), (b * l, max(3 * d, mlp)), (b * l, d))]
        rc = self.libs["fused_vit_block"].fused_vit_block_fwd(
            *(t.data_ptr() for t in (x, *ws, out, *bufs)), b, l, d,
            num_heads, mlp, valid_len, eps,
            torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"parent K1 launch failed ({rc})")
        return out

    def k6(self, x, dx1, attn_w, s1, num_heads, valid_len, eps):
        import torch
        lib = self.libs["fused_block_bwd_attn"]
        b, l, d = x.shape
        rows = b * l
        bf = dict(dtype=torch.bfloat16, device=x.device)
        f32 = dict(dtype=torch.float32, device=x.device)
        dx = torch.empty_like(x)
        grads = [torch.empty(w.shape, **f32) for w in attn_w]
        bufs = [torch.empty((rows, d), **bf) for _ in range(4)] + [
            torch.empty((rows, 3 * d), **bf) for _ in range(2)] + [
            torch.empty((rows, d), **f32), torch.empty((2 * rows,), **f32),
            torch.empty((lib.fused_block_bwd_attn_workspace(b, l, d),),
                        **f32)]
        if s1 is None:
            bufs[1] = None   # buf_dbr is only written with s1
        rc = lib.fused_block_bwd_attn(
            *(None if t is None else t.data_ptr() for t in (
                x, dx1, s1, *attn_w, dx, *grads, *bufs)),
            b, l, d, num_heads, valid_len, eps,
            torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"parent K6 launch failed ({rc})")
        return (dx, *grads)

    def k7(self, hs, ht, vs, vt, gs, gt, center, tt, sel, c, *, student_temp,
           inv_norm, use_g):
        import torch
        lib = self.libs["dino_head_loss"]
        (rs, db), rt, k = hs.shape, ht.shape[0], vs.shape[1]
        e = lambda *shape: torch.empty(  # noqa: E731
            shape, dtype=torch.float32, device=hs.device)
        out = [e(), e(k), e(rs, db), e(db, k), e(k)]
        ws = e(lib.dino_head_loss_workspace(rs, rt, db, k))
        inv_ts = 1.0 / student_temp
        rc = lib.dino_head_loss(
            *(t.data_ptr() for t in (hs, ht, vs, vt, gs, gt, center, tt, sel,
                                     c, *out, ws)),
            rs, rt, db, k, int(use_g), inv_ts, inv_ts * inv_norm, inv_norm,
            torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"parent K7 launch failed ({rc})")
        return out

    def k8(self, x, ws, num_heads, valid_len, eps):
        import torch
        lib = self.libs["fused_vit_block_int8"]
        b, l, d = x.shape
        mlp = ws[4].shape[1]
        out = torch.empty_like(x)
        work = torch.empty(
            (lib.fused_vit_block_int8_workspace(b * l, d, mlp),),
            dtype=torch.uint8, device=x.device)
        rc = lib.fused_vit_block_int8(
            *(t.data_ptr() for t in (x, *ws, out, work)), b, l, d, num_heads,
            mlp, valid_len, eps, torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"parent K8 launch failed ({rc})")
        return out

    @staticmethod
    def compare(name, shape, old, new, limits):
        """The earlier kernel's outputs within `limits` (output index ->
        fraction of this tree's largest value) of this tree's, then both
        timed in turns; returns (earlier ms, this ms), the means."""
        import torch
        outs = [(u,) if isinstance(u, torch.Tensor) else u
                for u in (old(), new())]
        for i, (u, v) in enumerate(zip(*outs)):
            err = (u.float() - v.float()).abs().max().item()
            scale = v.float().abs().max().item()
            check(err <= limits[i] * scale, f"parent {name} disagrees with "
                  f"this tree's at {shape}: output {i} {err} > "
                  f"{limits[i]} * {scale}")
        t = [cuda_time_ms(fn) for fn in (old, new, new, old)]
        print(f"parent_compare {name} {shape}: earlier {t[0]:.4f} / "
              f"{t[3]:.4f} ms, this tree {t[1]:.4f} / {t[2]:.4f} ms (in "
              f"turns: earlier, this, this, earlier), "
              f"{(t[0] + t[3]) / (t[1] + t[2]):.2f}x", flush=True)
        return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def parent_k23(parent):
    """K2 and K3 as the earlier tree built them beside this tree's, in
    turns, at PERF.md's K2 / K3 shapes: K2 at (132, 301) and (8, 2001)
    masked, K3 at those and at (2, 8193); outputs within 1e-4 of this
    tree's largest value (both f32; the earlier tree's products carry the
    signed error that this one repairs).  Returns {name: (earlier ms,
    this ms)}."""
    import torch
    from sais_tpu_torch.kernels.flash_attention import (
        _delta, flash_attention_bwd, flash_attention_fwd, key_bias)
    times = {}
    for b, l, masked in K3_SHAPES:
        q, k, v, mask, _ = k2_inputs(b, l, seed=l + 5, masked=masked)
        bias = key_bias(mask) if masked else None
        shape = (b, 4, l, 96)
        if l < 5000:
            times[f"K2 {shape}"] = ParentKernels.compare(
                "K2", shape, lambda: parent.k2(q, k, v, bias),
                lambda: flash_attention_fwd(q, k, v, bias), (1e-4, 1e-4))
        out, lse = flash_attention_fwd(q, k, v, bias)
        do = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            l)).cuda()
        delta = _delta(out, do)
        times[f"K3 {shape}"] = ParentKernels.compare(
            "K3", shape, lambda: parent.k3(q, k, v, bias, do, lse, delta),
            lambda: flash_attention_bwd(q, k, v, bias, out, lse, do),
            (1e-4, 1e-4, 1e-4))
        del q, k, v, out, lse, do
        torch.cuda.empty_cache()
    return times


class _Ranged:
    """`fn` called inside a profiler range named `label`.  It stands in for
    a kernel wrapper in its module, so its `launches` reads and writes the
    wrapper's own count."""

    def __init__(self, label, fn, counter):
        self.label, self.fn, self.counter = label, fn, counter

    @property
    def launches(self):
        return self.counter.launches

    @launches.setter
    def launches(self, n):
        self.counter.launches = n

    def __call__(self, *args, **kwargs):
        from torch.profiler import record_function
        with record_function(self.label):
            return self.fn(*args, **kwargs)


class _Annotated:
    """Within the block, K1, K4, K5, K6 and K7 run under profiler ranges
    named after them (K1's and K4's kernels share names), and `plain=True`
    routes the same path through the plain versions instead; restored on
    exit."""

    def __init__(self, plain=False):
        self.plain = plain

    def __enter__(self):
        from sais_tpu_torch.kernels import dino_head_loss, fused_mha
        from sais_tpu_torch.models import vit
        fns = {"fused_block_fwd_train": ("K4",
                                         fused_mha.vit_block_train_reference),
               "fused_block_bwd_mlp": ("K5",
                                       fused_mha.block_bwd_mlp_reference),
               "fused_block_bwd_attn": ("K6",
                                        fused_mha.block_bwd_attn_reference)}
        self.saved = [(fused_mha, n, getattr(fused_mha, n)) for n in fns]
        self.saved.append((vit, "fused_vit_block", vit.fused_vit_block))
        for name, (label, plain) in fns.items():
            kernel = getattr(fused_mha, name)
            setattr(fused_mha, name, _Ranged(
                label, plain if self.plain else kernel, kernel))
        k7 = dino_head_loss.fused_loss_and_grads
        self.saved.append((dino_head_loss, "fused_loss_and_grads", k7))
        dino_head_loss.fused_loss_and_grads = _Ranged(
            "K7", dino_head_loss.fused_loss_and_grads_reference if self.plain
            else k7, k7)
        k1 = vit.fused_vit_block
        vit.fused_vit_block = _Ranged(
            "K1", fused_mha.vit_block_reference if self.plain else k1, k1)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


# ---------------------------------------------------------------------------
# K7: the fused DINO last layer + loss
# ---------------------------------------------------------------------------

PEAK_INT8_OPS = 1979e12      # H100 SXM dense int8, at 700 W (data sheet)


def k7_inputs(batch, n_global, n_local, db, k, seed, device="cuda"):
    """Unit-row bf16 hs / ht, f32 v, g and center, and the pair structure
    of a DINO step, on `device` (also the CUDA tests' inputs)."""
    import torch
    from sais_tpu_torch.kernels.dino_head_loss import build_pair_structure
    g = torch.Generator().manual_seed(seed)
    rs, rt = (n_global + n_local) * batch, n_global * batch

    def unit(n):
        h = torch.randn((n, db), generator=g)
        return (h / h.norm(dim=-1, keepdim=True)).bfloat16()

    sel, c = build_pair_structure(batch, n_global, n_local)
    out = [unit(rs), unit(rt), torch.randn((db, k), generator=g),
           torch.randn((db, k), generator=g),
           1.0 + 0.1 * torch.randn((k,), generator=g),
           1.0 + 0.1 * torch.randn((k,), generator=g),
           0.01 * torch.randn((k,), generator=g), torch.from_numpy(sel),
           torch.from_numpy(c)]
    return [t.to(device) for t in out]


def k7_bound_ms(rs, rt, db, k, input_bytes, output_bytes):
    """Least time for K7: the bf16 products the function needs, s = hs ws
    (rs rows), tl = ht wt (rt rows), dh_s = dl ws^T and dw = hs^T dl, 2 db
    k (3 rs + rt) flops (the pair sums are one or two additions a row,
    gathered; the kernel's recomputation of s and tl is its own overhead),
    against its inputs read once and its outputs written once."""
    flops = 2 * db * k * (3 * rs + rt)
    nbytes = input_bytes + output_bytes
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


# (batch, n_global, n_local, db, out_dim, norm_last_layer): the pretrain
# step's shape both ways, the CLI's default batch (256: 512 teacher rows),
# and a small ragged one
K7_SHAPES = ((64, 2, 8, 256, 65536, True), (64, 2, 8, 256, 65536, False),
             (256, 2, 8, 256, 65536, True), (5, 2, 3, 256, 1024, True))


# K7's launches a call, in order, and the target they are held to
K7_LAUNCHES = ("pair_index", "normalize", "stats_teacher", "stats_student",
               "merge", "dl", "dw", "dv", "dh", "sum", "loss")
K7_MAX_LAUNCHES = 14


def k7_launch_split(fn, rs, rt, db, k):
    """`k7_profile`: the launches of one K7 call, the products' TFLOP/s
    (2 db k flops a row of each: s twice, tl, dw, dh_s); fails unless every
    product ran `gemm_sm90_kernel` and no launch ran the kernels it
    replaced (grad_h_kernel, grad_v_kernel, stats_kernel)."""
    row = 2 * db * k
    launch_split(fn, f"k7_profile (rs, rt) = ({rs}, {rt})", K7_LAUNCHES,
                 {"stats_teacher": row * rt, "stats_student": row * rs,
                  "dl": row * rs, "dw": row * rs, "dh": row * rs},
                 K7_MAX_LAUNCHES,
                 forbid=("grad_h_kernel", "grad_v_kernel", "stats_kernel"))


def phase_k7(parent=None):
    """Phase 10; `parent`: a ParentKernels to time beside K7 at the
    pretrain step's batch 64 and at the CLI's default 256."""
    import torch
    from sais_tpu_torch.kernels.dino_head_loss import (
        fused_loss_and_grads, fused_loss_and_grads_reference)
    from sais_tpu_torch.train.dino import plain_head_loss
    worst, result = 0.0, {}
    for batch, ng, nl, db, k, norm_last in K7_SHAPES:
        hs, ht, vs, vt, gs, gt, center, sel, c = k7_inputs(batch, ng, nl, db,
                                                           k, seed=k + ng)
        rs, rt = hs.shape[0], ht.shape[0]
        kw = dict(student_temp=0.1, inv_norm=1.0 / (batch * ng * (ng + nl - 1)),
                  use_g=not norm_last)
        args = (hs, ht, vs, vt, gs, gt, center, 0.04, sel, c)
        got = fused_loss_and_grads(*args, **kw)
        again = fused_loss_and_grads(*args, **kw)
        torch.cuda.synchronize()
        ref = fused_loss_and_grads_reference(*args, **kw)
        line = []
        for name, a, r in zip(("loss", "center", "dhs", "dvs", "dgs"), got,
                              ref):
            err = (a - r).abs().max().item()
            scale = r.abs().max().item()
            line.append(f"{name} {err:.3g}/{scale:.3g}")
            # Limits: loss and center 1e-4 relative (f32 sums in another
            # order); dhs, dvs, dgs 1e-2 of the plain version's largest
            # value (a bf16 rounding of dl may land on the other side of a
            # tie: one ulp of one element of dl).
            rel = 1e-4 if name in ("loss", "center") else 1e-2
            check(math.isfinite(err) and err <= rel * scale,
                  f"K7 {name} disagrees with its plain version at (rs, rt, "
                  f"db, k) = ({rs}, {rt}, {db}, {k}), norm_last "
                  f"{norm_last}: {err} > {rel} * {scale}")
            worst = max(worst, err)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        zero_dg = (not norm_last) or torch.count_nonzero(got[4]).item() == 0
        print(f"K7 (rs, rt, db, k) = ({rs}, {rt}, {db}, {k}) norm_last "
              f"{norm_last}: max|kernel-plain| / max|plain|: "
              f"{', '.join(line)}; two runs bitwise equal {same}", flush=True)
        check(same, "K7 is not deterministic: two runs differ")
        check(zero_dg, "K7 dg is not 0 under norm_last_layer")
        del got, again, ref
        if not norm_last or k != 65536:   # timed: batch 64 and 256
            del hs, ht, vs, vt, gs, gt, center, sel, c
            continue
        ms = cuda_time_ms(lambda: fused_loss_and_grads(*args, **kw))
        plain_ms = cuda_time_ms(
            lambda: fused_loss_and_grads_reference(*args, **kw), iters=3,
            warmup=1)
        leaves = [t.detach().float().clone().requires_grad_()
                  for t in (hs, vs)]

        def lib_fwd():
            return plain_head_loss(leaves[0], leaves[1], gs, ht, vt, gt,
                                   center, 0.04, n_global=ng, n_local=nl,
                                   student_temp=0.1,
                                   norm_last_layer=norm_last)[0]

        def lib_fwd_bwd():
            torch.autograd.grad(lib_fwd(), leaves)

        library_ms = cuda_time_ms(lib_fwd_bwd, iters=10)
        in_bytes = sum(t.numel() * t.element_size()
                       for t in (hs, ht, vs, vt, gs, gt, center, sel, c))
        out_bytes = 4 * (1 + k + rs * db + db * k + k)
        bound_ms, bound_by, flops, nbytes = k7_bound_ms(rs, rt, db, k,
                                                        in_bytes, out_bytes)
        print(f"K7 (rs, rt, db, k) = ({rs}, {rt}, {db}, {k}): kernel "
              f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, library (plain_head_loss: cuBLAS last "
              f"layer + regroup + dino_loss, forward and autograd backward) "
              f"{library_ms:.4f} "
              f"ms; bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.1f} "
              f"GFLOP, {nbytes / 1e6:.1f} MB), kernel at "
              f"{100 * bound_ms / ms:.1f}% of the bound", flush=True)
        if not result:   # the pretrain step's batch goes into the kernels line
            result = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        # temp_t on the card already: a call makes only K7's launches
        tt = torch.full((1,), 0.04, device="cuda")
        targs = args[:7] + (tt,) + args[8:]
        k7_launch_split(lambda: fused_loss_and_grads(*targs, **kw), rs, rt,
                        db, k)
        if parent is not None:
            parent.compare(
                "K7", (rs, rt, db, k),
                lambda: parent.k7(*targs, **kw),
                lambda: fused_loss_and_grads(*targs, **kw),
                (1e-4, 1e-4, 1e-2, 1e-2, 1e-2))
        del hs, ht, vs, vt, gs, gt, center, sel, c, leaves
        torch.cuda.empty_cache()
    result["max_abs_err"] = worst
    return result


def phase_pretrain(card: str, batch: int = 64, arch: str = "vits16"):
    """`pretrain --arch <arch>` at full width: the zoo's backbone (vits16:
    197 tokens a global crop; vits8: 785), DINO head out_dim 65536, 2
    global crops at 224 + 8 local at 96, batch 64, adamw, drop path 0.1,
    the student on K4-K6, the teacher on K1, the last layer and loss on
    K7.  Returns (launches of K4, K5, K6, K1, K7 over five steps, median
    step seconds)."""
    import numpy as np
    import torch
    from sais_tpu_torch.kernels.dino_head_loss import fused_loss_and_grads
    from sais_tpu_torch.kernels.fused_mha import (fused_block_bwd_attn,
                                                  fused_block_bwd_mlp,
                                                  fused_block_fwd_train,
                                                  fused_vit_block)
    from sais_tpu_torch.models import zoo
    from sais_tpu_torch.ops.augment import (center_border_crop,
                                            multi_crop_batch)
    from sais_tpu_torch.train.dino import DINOConfig, DINOTrainer

    vit_cfg = zoo.config(arch)
    cfg = DINOConfig(out_dim=65536, batch_size=batch, n_global_crops=2,
                     n_local_crops=8, drop_path_rate=0.1)
    counters = (fused_block_fwd_train, fused_block_bwd_mlp,
                fused_block_bwd_attn, fused_vit_block, fused_loss_and_grads)
    t0 = time.perf_counter()
    trainer = DINOTrainer(vit_cfg, cfg, niter_per_ep=1000,
                          generator=torch.Generator().manual_seed(0),
                          optimizer="adamw", fused_blocks=True)
    check(trainer.fused_loss, "DINOTrainer on the card did not default to "
          "the fused loss (K7)")
    frames = np.random.default_rng(0).integers(
        0, 256, (batch, 480, 640, 3), dtype=np.uint8)
    images = torch.from_numpy(np.ascontiguousarray(
        center_border_crop(frames))).cuda().float() / 255.0
    gen = torch.Generator(device="cuda").manual_seed(0)
    crops = multi_crop_batch(gen, images, 2, 8, 224, 96)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    g, l = crops
    check(tuple(g.shape) == (2 * batch, 224, 224, 3)
          and tuple(l.shape) == (8 * batch, 96, 96, 3)
          and bool(torch.isfinite(g).all() and torch.isfinite(l).all()),
          f"crops {tuple(g.shape)} / {tuple(l.shape)} not finite / wrong")
    tokens = [(s // vit_cfg.patch_size) ** 2 + 1 for s in (224, 96)]
    print(f"pretrain {arch}: ViT patch {vit_cfg.patch_size}, D "
          f"{vit_cfg.embed_dim}, depth {vit_cfg.depth} + DINO head (out_dim "
          f"65536), batch "
          f"{batch}: crops {tuple(g.shape)} + {tuple(l.shape)} ({tokens[0]} "
          f"+ {tokens[1]} tokens); set-up {setup_s:.1f} s", flush=True)

    losses = [trainer.step(g, l)]    # warm-up
    torch.cuda.synchronize()
    times, per_step = [], []
    for c in counters:
        c.launches = 0
    for _ in range(5):
        before = [c.launches for c in counters]
        t = time.perf_counter()
        losses.append(trainer.step(g, l))   # the loss is fetched
        times.append(time.perf_counter() - t)
        per_step.append([c.launches - b0 for c, b0 in zip(counters, before)])
    launches = [c.launches for c in counters]
    step_s = sorted(times)[2]
    print(f"pretrain {arch}: 5 steps "
          f"{', '.join(f'{1e3 * t:.2f}' for t in times)}"
          f" ms (median {1e3 * step_s:.2f} ms, {batch / step_s:.1f} img/s); "
          f"losses {[round(x, 5) for x in losses]}; launches a step "
          f"(K4, K5, K6, K1, K7) {per_step[0]}, over the 5 steps {launches}",
          flush=True)
    check(all(math.isfinite(x) for x in losses), "non-finite pretrain loss")
    check(all(p == [24, 24, 24, 12, 1] for p in per_step),
          f"launches a step {per_step}, expected K4, K5, K6 24, K1 12 and "
          "K7 1")

    # one step's loss and gradients, kernels against plain versions, from
    # the same weights, crops and drop-path draws (no update in between)
    temp = float(trainer.temp_sched[0])

    def grads(plain):
        gen = torch.Generator(device="cuda").manual_seed(123)
        with _Annotated(plain=plain):
            loss, _ = trainer.loss_and_grads(g, l, temp, gen)
        out = {n: p.grad.detach().clone()
               for n, p in trainer.student.named_parameters()
               if p.grad is not None}
        return loss.item(), out

    loss_k, grad_k = grads(False)
    t = time.perf_counter()
    loss_p, grad_p = grads(True)
    plain_s = time.perf_counter() - t
    rel = abs(loss_k - loss_p) / abs(loss_p)
    gaps = {n: (grad_k[n] - grad_p[n]).abs().max().item()
            / max(grad_p[n].abs().max().item(), 1e-30) for n in grad_p}
    worst = sorted(gaps.items(), key=lambda kv: kv[1])[-3:]
    print(f"pretrain {arch} step, kernels vs plain versions on the card "
          f"(plain "
          f"{plain_s:.1f} s): loss {loss_k:.6f} vs {loss_p:.6f} (rel "
          f"{rel:.3g}); {len(gaps)} gradients, worst max|diff| / max|plain| "
          f"{', '.join(f'{n} {v:.3g}' for n, v in worst)}", flush=True)
    # Limits: the loss within 1e-3 relative; each gradient within 5e-2 of
    # its largest value (12 bf16 blocks, the gesture path's feature limit).
    check(rel <= 1e-3, f"pretrain loss differs from the plain path: {rel}")
    check(set(gaps) == set(grad_k), "kernel and plain paths differ in "
          "which parameters get a gradient")
    check(worst[-1][1] <= 5e-2, f"gradient {worst[-1][0]} differs from the "
          f"plain path: {worst[-1][1]}")
    # the same step with the plain head and loss (fused_loss=False), printed
    # beside it; JAX's own fused-vs-XLA limit is 5e-3 relative
    # (tests/test_dino_fused_loss.py)
    trainer.fused_loss = False
    loss_u, _ = grads(False)
    trainer.fused_loss = True
    print(f"pretrain {arch} step, K7 vs fused_loss=False on the card: loss "
          f"{loss_k:.6f} vs {loss_u:.6f} (rel "
          f"{abs(loss_k - loss_u) / abs(loss_u):.3g}; JAX's limit 5e-3)",
          flush=True)
    for p in trainer.student.parameters():
        p.grad = None

    with _Annotated():
        busy_us, wall_us, _ = _profile(
            lambda: trainer.step(g, l), f"pretrain_step_profile {arch}", 1,
            ranges=("K4", "K5", "K6", "K1", "K7"))
    print(f"pretrain {arch} ({card}): step {1e3 * step_s:.2f} ms median, "
          f"{batch / step_s:.1f} img/s; a profiled step: device busy "
          f"{busy_us / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall, "
          f"{100 * (1 - busy_us / wall_us):.1f}% idle", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return launches, step_s


def phase_pretrain_bn(card: str, k7_step_s: float, batch: int = 64):
    """`pretrain -bs 64 --use-bn-in-head` at the ViT-S/16 defaults: the
    DINOConfig cmd_pretrain builds from those flags (out_dim 65536, 2 x
    224 + 8 x 96 crops, adamw, drop path 0.1), the student on K4-K6, the
    teacher on K1, the BatchNorm head and the loss plain (K7 never: the
    JAX package refuses the fused loss with this head).  Five steps:
    exact launches, finite losses, both BatchNorm states moving; then one
    step's gradients, the kernels against their plain versions, and one
    step (at batch 16, drop path 0) on the card against the same step on
    the CPU from the same weights and crops, each beside a control
    without BatchNorm held to the pretrain phase's limits.  Returns the
    launches of K4, K5, K6, K1 and K7."""
    import copy
    import dataclasses

    import numpy as np
    import torch
    from sais_tpu_torch.kernels.dino_head_loss import fused_loss_and_grads
    from sais_tpu_torch.kernels.fused_mha import (fused_block_bwd_attn,
                                                  fused_block_bwd_mlp,
                                                  fused_block_fwd_train,
                                                  fused_vit_block)
    from sais_tpu_torch.models import zoo
    from sais_tpu_torch.ops.augment import (center_border_crop,
                                            multi_crop_batch)
    from sais_tpu_torch.train.dino import DINOConfig, DINOTrainer

    vit_cfg = zoo.config("vits16")
    cfg = DINOConfig(out_dim=65536, batch_size=batch, n_local_crops=8,
                     drop_path_rate=0.1, use_bn_in_head=True)
    trainer = DINOTrainer(vit_cfg, cfg, niter_per_ep=1000,
                          generator=torch.Generator().manual_seed(0),
                          optimizer="adamw")
    check(trainer.fused_blocks and not trainer.fused_loss,
          "the BatchNorm head's trainer did not take K4-K6 / K1 with the "
          "plain head and loss")
    frames = np.random.default_rng(1).integers(
        0, 256, (batch, 480, 640, 3), dtype=np.uint8)
    images = torch.from_numpy(np.ascontiguousarray(
        center_border_crop(frames))).cuda().float() / 255.0
    g, l = multi_crop_batch(torch.Generator(device="cuda").manual_seed(1),
                            images, 2, 8, 224, 96)
    bn0 = [{k: v.clone() for k, v in st.items()}
           for st in trainer.student_bn + trainer.teacher_bn]
    losses = [trainer.step(g, l)]     # warm-up
    torch.cuda.synchronize()
    counters = (fused_block_fwd_train, fused_block_bwd_mlp,
                fused_block_bwd_attn, fused_vit_block, fused_loss_and_grads)
    for c in counters:
        c.launches = 0
    times, per_step = [], []
    for _ in range(5):
        before = [c.launches for c in counters]
        t = time.perf_counter()
        losses.append(trainer.step(g, l))
        times.append(time.perf_counter() - t)
        per_step.append([c.launches - b0 for c, b0 in zip(counters, before)])
    launches = [c.launches for c in counters]
    step_s = sorted(times)[2]
    moved = [max((a[k] - b[k]).abs().max().item() for k in ("mean", "var"))
             for a, b in zip(trainer.student_bn + trainer.teacher_bn, bn0)]
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"pretrain vits16 --use-bn-in-head ({card}): 5 steps "
          f"{', '.join(f'{1e3 * t:.2f}' for t in times)} ms (median "
          f"{1e3 * step_s:.2f} ms, {batch / step_s:.1f} img/s) beside the "
          f"K7 step's {1e3 * k7_step_s:.2f} ms; losses "
          f"{[round(x, 5) for x in losses]}; launches a step (K4, K5, K6, "
          f"K1, K7) {per_step[0]}; BatchNorm running statistics moved by "
          f"{[round(x, 5) for x in moved]} (student 1, 2, teacher 1, 2); "
          f"peak memory {mem:.2f} GiB", flush=True)
    check(all(math.isfinite(x) for x in losses),
          f"non-finite BatchNorm pretrain loss {losses}")
    check(all(p == [24, 24, 24, 12, 0] for p in per_step),
          f"BatchNorm pretrain launches a step {per_step}, expected K4, "
          "K5, K6 24, K1 12 and K7 0")
    check(all(m > 0 for m in moved), f"a BatchNorm state did not move: "
          f"{moved}")

    # The same two comparisons with a control: the head without BatchNorm
    # (use_bn_in_head off; the plain head and loss, as the BatchNorm
    # head's), the same backbone and head weights, crops and draws, read
    # by the same measure.  One candidate cause of a larger gap under
    # BatchNorm is printed beside them: its backward removes from the
    # gradient of its normalized output, dx, the mean over the rows and
    # the projection on the normalized input, and a rounding error in dx
    # grows by ||dx|| / ||what is left|| on the way to the backbone.
    control = DINOTrainer(vit_cfg, dataclasses.replace(
        cfg, use_bn_in_head=False), niter_per_ep=1000,
        generator=torch.Generator().manual_seed(0), optimizer="adamw",
        fused_loss=False)
    for name in ("student", "teacher"):
        getattr(control, name).load_state_dict(
            {k: v for k, v in getattr(trainer, name).state_dict().items()
             if ".bn." not in k})
    control.center = trainer.center.clone()
    temp = float(trainer.temp_sched[0])
    # train-mode BatchNorm makes these gradients exactly 0 (a bias that
    # the batch mean removes): both sides hold rounding noise there, read
    # against the step's largest gradient instead of their own
    zero = ("head.mlp.0.bias", "head.mlp.1.bias", "backbone.norm.bias")

    def kernels_vs_plain(tr):
        # one step's loss and gradients, the kernels against their plain
        # versions on the card, from the same weights, crops and drop-path
        # draws (the pretrain phase's check)
        def grads(plain):
            gen = torch.Generator(device="cuda").manual_seed(123)
            with _Annotated(plain=plain):
                loss, _ = tr.loss_and_grads(g, l, temp, gen)
            return loss.item(), {n: p.grad.detach().clone()
                                 for n, p in tr.student.named_parameters()
                                 if p.grad is not None}

        (lk, gk), (lp, gp) = grads(False), grads(True)
        for p in tr.student.parameters():
            p.grad = None
        return abs(lk - lp) / abs(lp), gk, gp

    kp = {}
    for name, tr in (("BatchNorm", trainer), ("control", control)):
        rel, gk, gp = kernels_vs_plain(tr)
        check(set(gk) == set(gp), f"{name}: kernel and plain paths differ "
              "in which parameters get a gradient")
        gaps = {n: v[0] for n, v in _grad_gaps(gk, gp).items()
                if n not in zero}
        kp[name] = (rel, sorted(gaps.items(), key=lambda kv: kv[1])[-3:])
        del gk, gp
    del control
    torch.cuda.empty_cache()
    print(f"pretrain --use-bn-in-head step, kernels vs plain versions on the "
          f"card, worst max|diff| / max|plain| of each gradient: "
          + "; ".join(f"{name}: loss rel {rel:.3g}, "
                      + ", ".join(f"{n} {v:.3g}" for n, v in worst)
                      for name, (rel, worst) in kp.items()), flush=True)
    # Limits: the loss 1e-3 relative; each gradient 5e-2 of its largest
    # value under the control (the pretrain phase's limit; it read
    # 0.0076), 1e-1 under the BatchNorm head (it read 0.0766, 10x the
    # control; PERF.md §6, PR 16)
    for name, limit in (("BatchNorm", 1e-1), ("control", 5e-2)):
        rel, worst = kp[name]
        check(rel <= 1e-3, f"{name} pretrain loss, kernels vs plain: {rel}")
        check(worst[-1][1] <= limit, f"{name}: gradient {worst[-1][0]}, "
              f"kernels vs plain: {worst[-1][1]}")

    # one step, card against CPU, from the same weights and crops (16
    # images, no drop path): the fused backbone on both, K4-K6 and K1 on
    # the card, their plain versions on the CPU; the BatchNorm head and
    # the control
    from sais_tpu_torch.models import dino_head
    magnified = []
    orig_bn = dino_head._batch_norm

    def watched(h, bn, *a, **kw):
        out, state = orig_bn(h, bn, *a, **kw)
        if not magnified and h.device.type == "cuda" and out.requires_grad:
            h32 = h.detach().float()
            xhat = ((h32 - h32.mean(0))
                    * torch.rsqrt(h32.var(0, unbiased=False) + 1e-5))
            scale = bn.scale.detach().float()

            def hook(grad):
                dx = grad.float() * scale
                left = dx - dx.mean(0) - xhat * (dx * xhat).mean(0)
                magnified.append((dx.norm() / left.norm()).item())

            out.register_hook(hook)
        return out, state

    nets = {}
    for use_bn in (True, False):
        sub = dataclasses.replace(cfg, batch_size=16, drop_path_rate=0.0,
                                  use_bn_in_head=use_bn)
        for dev in ("cuda", "cpu"):
            tr = DINOTrainer(vit_cfg, sub, niter_per_ep=1000,
                             generator=torch.Generator().manual_seed(0),
                             fused_blocks=True, fused_loss=False, device=dev)
            for name in ("student", "teacher"):
                getattr(tr, name).load_state_dict(
                    {k: v for k, v in getattr(trainer, name).state_dict()
                     .items() if use_bn or ".bn." not in k})
            if use_bn:
                tr.student_bn = copy.deepcopy(_to_dev(trainer.student_bn,
                                                      dev))
                tr.teacher_bn = copy.deepcopy(_to_dev(trainer.teacher_bn,
                                                      dev))
            tr.center = trainer.center.to(dev)
            gi, li = g[:32].to(dev), l[:128].to(dev)
            t = time.perf_counter()
            dino_head._batch_norm = watched
            try:
                loss, _ = tr.loss_and_grads(gi, li, float(tr.temp_sched[0]),
                                            None)
            finally:
                dino_head._batch_norm = orig_bn
            grads = {n: p.grad.detach().cpu().float()
                     for n, p in tr.student.named_parameters()
                     if p.grad is not None}
            states = ([{k: v.cpu() for k, v in st.items()}
                       for st in tr._next_bn[0]] if use_bn else [])
            nets[use_bn, dev] = (loss.item(), grads, states,
                                 time.perf_counter() - t)
            del tr
    readings = {}
    for use_bn in (True, False):
        (lk, gk, sk, _), (lc, gc, sc, cpu_s) = (nets[use_bn, "cuda"],
                                                nets[use_bn, "cpu"])
        check(set(gk) == set(gc), "card and CPU differ in which parameters "
              "get a gradient")
        top = max(x.abs().max().item() for x in gc.values())
        noise = max(max(gk[n].abs().max().item(), gc[n].abs().max().item())
                    for n in zero) / top if use_bn else 0.0
        gaps = {n: v for n, v in _grad_gaps(gk, gc).items()
                if not (use_bn and n in zero)}
        st_gap = max((max((a[k] - b[k]).abs().max().item()
                          / max(b[k].abs().max().item(), 1e-30)
                          for a, b in zip(sk, sc) for k in ("mean", "var"))
                      if sk else 0.0), 0.0)
        readings[use_bn] = (abs(lk - lc) / abs(lc), gaps, noise, st_gap,
                            cpu_s)
    for use_bn in (True, False):
        rel, gaps, noise, st_gap, cpu_s = readings[use_bn]
        by_max = sorted(gaps.items(), key=lambda kv: kv[1][0])[-3:]
        by_norm = sorted(gaps.items(), key=lambda kv: kv[1][1])[-3:]
        bn_t = {n: v for n, v in gaps.items() if ".bn." in n}
        print(f"pretrain step at batch 16, card vs CPU, "
              f"{'--use-bn-in-head' if use_bn else 'control (no BatchNorm)'}"
              f" (CPU {cpu_s:.1f} s): loss rel {rel:.3g}; {len(gaps)} "
              f"gradients, worst max|diff| / max|CPU| "
              f"{', '.join(f'{n} {v[0]:.3g}' for n, v in by_max)}; worst "
              f"||diff|| / ||CPU|| "
              f"{', '.join(f'{n} {v[1]:.3g}' for n, v in by_norm)}"
              + (f"; the BatchNorm scales and biases at most "
                 f"{max(v[0] for v in bn_t.values()):.3g} / "
                 f"{max(v[1] for v in bn_t.values()):.3g}; the three "
                 f"gradients BatchNorm makes 0 at most {noise:.3g} of the "
                 f"largest gradient; student BatchNorm states {st_gap:.3g}; "
                 f"the student's first BatchNorm's backward, ||dx|| / "
                 f"||what it leaves|| {magnified[0]:.3g}"
                 if use_bn else ""), flush=True)
    # Limits: the loss 1e-3 relative (the pretrain phase's).  Each
    # gradient alone, the BatchNorm scales and biases included, in
    # max|diff| / max|CPU| and in ||diff|| / ||CPU||: 5e-2 under the
    # control (it read 0.0103 and 0.0081), 1.5e-1 and 1.25e-1 under the
    # BatchNorm head (it read 0.107 and 0.0928: 10-11x the control, as the
    # kernels against their plain versions read 10x; why is open, PERF.md
    # §7).  The BatchNorm arithmetic itself is held to 1e-4 against the
    # JAX package in float32 (tests/test_torch_dino_bn.py).
    for use_bn, lmax, lnorm in ((True, 1.5e-1, 1.25e-1),
                                (False, 5e-2, 5e-2)):
        rel, gaps = readings[use_bn][:2]
        name = "BatchNorm" if use_bn else "control"
        worst_max = max(gaps.items(), key=lambda kv: kv[1][0])
        worst_norm = max(gaps.items(), key=lambda kv: kv[1][1])
        check(rel <= 1e-3, f"{name} pretrain loss card vs CPU: {rel}")
        check(worst_max[1][0] <= lmax, f"{name}: gradient {worst_max[0]} "
              f"card vs CPU: max-relative {worst_max[1][0]}")
        check(worst_norm[1][1] <= lnorm, f"{name}: gradient "
              f"{worst_norm[0]} card vs CPU: norm-relative "
              f"{worst_norm[1][1]}")
    noise, st_gap = readings[True][2:4]
    # the three exact zeros 5e-2 of the step's largest gradient; the new
    # running statistics average bf16 activations, 5e-2
    check(noise <= 5e-2, f"gradients BatchNorm makes 0 read {noise} of the "
          "largest")
    check(st_gap <= 5e-2, f"BatchNorm states card vs CPU: {st_gap}")
    del trainer
    torch.cuda.empty_cache()
    return launches


def _to_dev(states, dev):
    return [{k: v.to(dev) for k, v in st.items()} for st in states]


def phase_host_extract(nframes: int = 300):
    """The gesture path's extraction once more with `extract
    --exact-preprocess --norm half`: crop, resize and normalize on the host
    CPU, the normalized frames copied to the card, the ViT on K1; against
    the device route under the same normalization (bitwise expected: the
    same PIL-exact integer resample and float32 normalize on both).  The
    frame pump is built (or falls back, saying so) as `extract` would.
    Returns K1's launches in the host route's run."""
    import dataclasses

    import numpy as np
    import torch
    from sais_tpu_torch.config import ModelConfig, PipelineConfig
    from sais_tpu_torch.infer.pipeline import FeatureExtractor
    from sais_tpu_torch.io import native_loader
    from sais_tpu_torch.kernels.fused_mha import fused_vit_block
    from sais_tpu_torch.models.vit import vit_init

    if native_loader.ensure_built():
        print("frame pump: built", flush=True)
    else:
        print(f"frame pump: not built ({native_loader._failed}); "
              "extract_video falls back to OpenCV's Python binding",
              flush=True)
    cfg = PipelineConfig(model=ModelConfig(modalities="RGB"))
    cfg = dataclasses.replace(cfg, preprocess=dataclasses.replace(
        cfg.preprocess, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)))
    vit = vit_init(torch.Generator().manual_seed(0), cfg.vit)
    frames = np.random.default_rng(0).integers(
        0, 256, (nframes, 480, 640, 3), dtype=np.uint8)
    host = FeatureExtractor(vit, cfg, batch_size=256, exact_preprocess=True)
    dev = FeatureExtractor(vit, cfg, batch_size=256)
    host.extract_array(frames[:8])       # warm-up
    torch.cuda.synchronize()
    fused_vit_block.launches = 0
    t = time.perf_counter()
    got = host.extract_array(frames)
    host_s = time.perf_counter() - t
    launches = fused_vit_block.launches
    t = time.perf_counter()
    want = dev.extract_array(frames)
    dev_s = time.perf_counter() - t
    diff = np.abs(got - want).max()
    # where the two routes' normalized frames part
    from sais_tpu_torch.ops.preprocess import preprocess_batch
    x_host = host.preprocess_host(frames[:64])
    x_dev = preprocess_batch(torch.from_numpy(frames[:64]).cuda(),
                             cfg.preprocess, torch.float32).cpu()
    x_diff = (x_host - x_dev).abs().max().item()
    x_parts = torch.count_nonzero(x_host != x_dev).item() / x_host.numel()
    batches = math.ceil(nframes / 256)
    print(f"host extraction (--exact-preprocess --norm half): {nframes} "
          f"frames of 480x640 in {host_s:.4f} s ({nframes / host_s:.1f} "
          f"frames/s; the device route {nframes / dev_s:.1f} frames/s); K1 "
          f"launches {launches}; features "
          f"{'bitwise equal to' if diff == 0 else f'max|diff| {diff:.3g} from'}"
          f" the device route's (max|feature| {np.abs(want).max():.4g}); "
          f"normalized frames max|diff| {x_diff:.3g}, {100 * x_parts:.2f}% "
          f"of the values differ", flush=True)
    check(launches == 12 * batches, f"K1 launched {launches} times on the "
          f"host route, expected {12 * batches}")
    check(got.shape == (nframes, 384) and np.isfinite(got).all(),
          "host-route features not finite / wrong shape")
    # Limit: bitwise (the same resample and normalize); were they not, the
    # gesture path's limit against the plain version (5e-2 of the largest
    # value, 12 bf16 blocks) would hold
    check(diff <= 5e-2 * np.abs(want).max(), f"host route differs {diff}")
    return launches


def _raw_table(nvideos: int = 6, stitches: int = 3):
    """A VUA_EASE_Stitch_Paths-schema table (numpy seed 3) for the raw
    path: nvideos x stitches x the three RACE / EASE pairs, maj in {0, 1,
    2}, every span long enough for 16-frame snippets."""
    import numpy as np
    rng = np.random.default_rng(3)
    rows = []
    for v in range(nvideos):
        for s_ in range(stitches):
            start = int(rng.integers(50, 1500))
            entry = start + int(rng.integers(40, 300))
            wd = entry + int(rng.integers(60, 300))
            for race, ease in SKILL_RACES:
                rows.append({
                    "File": v + 1, "Stitch": s_,
                    "Path": f"C:\\EASE\\vid{v:02d}",
                    "videoname": f"case{v:02d}", "Anatomy": "Anterior",
                    "RACE": race, "EASE": ease,
                    "maj": int(rng.integers(0, 3)),
                    "Needle Handling Start Frame": start,
                    "Needle Entry Start Frame": entry,
                    "Needle Withdrawal Start Frame": wd,
                    "Needle Withdrawal End Frame": wd + int(
                        rng.integers(90, 250))})
    return rows


def _memory_frames(h: int = 480, w: int = 640, pool: int = 48):
    """A frame source (video, indices, modality) -> (T, h, w, 3) uint8
    served from memory: a pool of numpy-seeded frames, picked by video,
    modality and frame number."""
    import zlib

    import numpy as np
    frames = np.random.default_rng(4).integers(0, 256, (pool, h, w, 3),
                                               dtype=np.uint8)

    def load(video, indices, modality="RGB"):
        base = zlib.crc32(f"{video}/{modality}".encode())
        return frames[[(base + int(i)) % pool for i in indices]]

    return load


def _numpy_bilinear(x, oh, ow):
    """Half-pixel bilinear in numpy float32 (no antialiasing, edge taps
    clamped), columns then rows: the resize of data.raw.process_snippet."""
    import numpy as np
    for axis, n_out in ((2, ow), (1, oh)):
        n_in = x.shape[axis]
        fx = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        s_ = np.floor(fx).astype(np.int64)
        f = fx - s_
        f[(s_ < 0) | (s_ >= n_in - 1)] = 0
        s_ = np.clip(s_, 0, n_in - 1)
        shape = [1] * x.ndim
        shape[axis] = n_out
        x = (np.take(x, s_, axis) * (1 - f).astype(np.float32).reshape(shape)
             + np.take(x, np.minimum(s_ + 1, n_in - 1), axis)
             * f.astype(np.float32).reshape(shape))
    return x


def phase_raw(card: str):
    """`train --dataset vua-ease --data-type raw` through the CLI at the
    published widths: --encoder R3D (R3D-18, 16 x 112 x 112 snippets,
    batch 8) and --encoder ViT (ViT-S/16 at float32, 16 frames of 224 x
    224 a snippet, batch 2), 2 epochs each, 3-way TTA at val / test, on
    the card, and the first epoch on the CPU (epoch losses within 1e-3,
    the training phase's limit), frames of 480 x 640 served from memory; R3D's features
    on the card against its float32 CPU run within 1e-4 of the largest
    (COMPONENTS C4 / C9); the device resize against numpy's half-pixel
    bilinear; one --unfreeze-encoder step for each encoder and one -mod
    RGB-Flow step; snippets/s and the step ms of each encoder."""
    import csv as csv_lib

    import numpy as np
    import torch
    from sais_tpu_torch.cli import main as cli
    from sais_tpu_torch.config import ModelConfig, TrainConfig, ViTConfig
    from sais_tpu_torch.data import raw
    from sais_tpu_torch.data.skill import with_video
    from sais_tpu_torch.models.full_model import full_model_init
    from sais_tpu_torch.models.r3d import r3d18_features, r3d18_init
    from sais_tpu_torch.models.vit import vit_init
    from sais_tpu_torch.train.classification import (ClassificationTrainer,
                                                     RawClassificationTrainer)
    src = _memory_frames()
    rows = _raw_table()

    # the device resize against numpy's, on the same float crop (the
    # card's x / 255 is a multiply by the reciprocal, an ulp from numpy's
    # division, so the resize is held on its own input)
    snip = src("vid00", np.arange(16), "RGB")
    crop = (torch.from_numpy(snip).cuda()[:, 48:48 + 384, 64:64 + 512]
            .float() / 255.0)
    got = raw.resize_linear(crop, 112, 112).cpu().numpy()
    want = _numpy_bilinear(crop.cpu().numpy(), 112, 112)
    rdiff = float(np.abs(got - want).max())
    print(f"raw snippet resize on the card (16 x 384 x 512 crops -> 112): "
          f"{'bitwise equal to' if rdiff == 0 else f'max|diff| {rdiff:.3g} from'}"
          f" numpy's half-pixel bilinear", flush=True)
    # Limit 2**-23 (an ulp at 1): both sum a0 x[s] + a1 x[s + 1] in float32
    check(rdiff <= 2 ** -23, f"device resize differs from numpy's: {rdiff}")

    orig_src = raw.jpeg_frame_source
    orig_run = ClassificationTrainer.run_epoch
    record = []

    def run(self, batches, train):
        loss, m = orig_run(self, batches, train)
        record.append(loss)
        return loss, m

    raw.jpeg_frame_source = lambda root, dataset="VUA": src
    ClassificationTrainer.run_epoch = run
    fits = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            csv = os.path.join(tmp, "VUA_EASE_Stitch_Paths.csv")
            with open(csv, "w", newline="") as f:
                w = csv_lib.DictWriter(f, fieldnames=list(rows[0]))
                w.writeheader()
                w.writerows(rows)
            for enc, width, bs, lr in (("R3D", 112, 8, "1e-4"),
                                       ("ViT", 224, 2, "0.1")):
                for dev in ("cuda", "cpu"):
                    record.clear()
                    t = time.perf_counter()
                    cli.main(["train", "-p", tmp, "--segments", csv,
                              "--dataset", "vua-ease", "-d", "NH_02",
                              "--data-type", "raw", "--encoder", enc,
                              "--raw-width", str(width), "-e",
                              "2" if dev == "cuda" else "1", "-bs",
                              str(bs), "-lr", lr, "--device", dev])
                    fits[enc, dev] = (list(record), time.perf_counter() - t)
    finally:
        raw.jpeg_frame_source = orig_src
        ClassificationTrainer.run_epoch = orig_run
    for enc in ("R3D", "ViT"):
        (card_l, card_s), (cpu_l, cpu_s) = fits[enc, "cuda"], fits[enc, "cpu"]
        # the CPU fits the first epoch only (constant-lr SGD, the epoch's
        # shuffle seeded by its index: the same epoch as the card's first)
        gap = float(np.max(np.abs(np.subtract(card_l[:len(cpu_l)], cpu_l))))
        print(f"raw fit --encoder {enc}: epoch losses on the card "
              f"{[round(x, 6) for x in card_l]} ({card_s:.1f} s), on the "
              f"CPU {[round(x, 6) for x in cpu_l]} ({cpu_s:.1f} s); "
              f"max|diff| {gap:.3g}", flush=True)
        check(len(card_l) >= 4 and all(math.isfinite(x) for x in card_l)
              and 2 * len(cpu_l) == len(card_l),
              f"raw fit {enc}: epoch losses {card_l}, on the CPU {cpu_l}")
        # Limit 1e-3: the training phase's (f32 on both sides, two epochs)
        check(gap <= 1e-3, f"raw fit {enc}: card and CPU differ {gap}")

    # R3D's features on the card against its float32 CPU run (rows with a
    # Video column and a maj of NH_02's classes, as the dataset gives them)
    direct = [r for r in with_video(rows) if r["maj"] in (0, 2)][:8]
    r3d = r3d18_init(torch.Generator().manual_seed(5))
    batch = raw.collate_raw(direct, src, [0, 2], "NH_02", "train",
                            device=torch.device("cuda"))
    clips = batch["raw"][:, 0]
    with torch.no_grad():
        fc = r3d18_features(r3d.cuda(), clips).cpu()
        fh = r3d18_features(r3d.cpu(), clips.cpu())
    ferr, fscale = (fc - fh).abs().max().item(), fh.abs().max().item()
    print(f"R3D-18 features (8 x 16 x 112 x 112) card vs CPU float32: "
          f"max|diff| {ferr:.3g} (max|feature| {fscale:.4g})", flush=True)
    check(ferr <= 1e-4 * fscale, f"R3D features differ: {ferr}")
    r3d.cuda()
    with torch.no_grad():
        _profile(lambda: r3d18_features(r3d, clips), "r3d_profile", 1)

    # step times, frozen; one unfrozen step a encoder; one RGB-Flow step
    vcfg = ViTConfig()
    for enc, bs, width in (("R3D", 8, 112), ("ViT", 2, 224)):
        mcfg = ModelConfig(nclasses=2, data_type="raw", modalities="RGB",
                           rep_dim=512 if enc == "R3D" else 384)
        b = raw.collate_raw(direct[:bs], src, [0, 2], "NH_02", "train",
                            width=width, encoder_type=enc,
                            device=torch.device("cuda"))
        for frozen in (True, False):
            encoder = (r3d18_init(torch.Generator().manual_seed(5))
                       if enc == "R3D" else
                       vit_init(torch.Generator().manual_seed(5), vcfg))
            tr = RawClassificationTrainer(
                mcfg, TrainConfig(lr=1e-4), full_model_init(
                    torch.Generator().manual_seed(0), mcfg), encoder,
                encoder_type=enc, freeze_encoder=frozen)
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(5 if frozen else 3):
                t = time.perf_counter()
                loss, _ = tr.train_step(b)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            step_s = sorted(times)[len(times) // 2]
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"raw {enc} {'frozen' if frozen else 'unfrozen'} step, "
                  f"batch {bs} ({card}): {1e3 * step_s:.2f} ms "
                  f"({bs / step_s:.2f} snippets/s; steps "
                  f"{', '.join(f'{1e3 * x:.2f}' for x in times)} ms); loss "
                  f"{loss.item():.5f}; peak memory {mem:.2f} GiB",
                  flush=True)
            check(math.isfinite(loss.item()), f"raw {enc} step loss {loss}")
            del tr, encoder
            torch.cuda.empty_cache()
    mcfg = ModelConfig(nclasses=2, data_type="raw", rep_dim=512,
                       modalities="RGB-Flow")
    fb = raw.collate_raw(direct, src, [0, 2], "NH_02", "train",
                         use_flow=True, device=torch.device("cuda"),
                         fps_table={f"vid{v:02d}": 30.0 for v in range(6)})
    tr = RawClassificationTrainer(
        mcfg, TrainConfig(lr=1e-4), full_model_init(
            torch.Generator().manual_seed(0), mcfg),
        r3d18_init(torch.Generator().manual_seed(5)))
    loss, _ = tr.train_step(fb)
    print(f"raw -mod RGB-Flow R3D step (raw + raw_flow "
          f"{tuple(fb['raw_flow'].shape)}): loss {loss.item():.5f}",
          flush=True)
    check(math.isfinite(loss.item()), f"raw RGB-Flow step loss {loss}")
    del tr
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# K8: the W8A8 ViT block
# ---------------------------------------------------------------------------

def library_block_int8(x, ws, heads, valid_len, eps):
    """The W8A8 block as PyTorch library calls (the yardstick, never called
    by the port): per-call weight and per-token activation quantization,
    torch._int_mm for the four products, layer_norm, SDPA, gelu."""
    import torch
    import torch.nn.functional as F
    from sais_tpu_torch.kernels.fused_mha import quant_rows, quantize_weight
    (qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b, ln1_s, ln1_b,
     ln2_s, ln2_b) = ws
    b, l, d = x.shape

    def mm(y32, w, bias):
        q, s = quant_rows(y32)
        wq, wsc = quantize_weight(w)
        return torch._int_mm(q, wq).float() * s * wsc + bias.float()

    y = F.layer_norm(x.float(), (d,), ln1_s.float(), ln1_b.float(), eps)
    qkv = mm(y.reshape(-1, d), qkv_w, qkv_b).bfloat16()
    q, k, v = qkv.view(b, l, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    mask = None
    if valid_len < l:
        mask = (torch.arange(l, device=x.device) < valid_len)[None, :]
    ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    ctx = ctx.transpose(1, 2).reshape(-1, d).float()
    x1 = x + mm(ctx, proj_w, proj_b).bfloat16().view(b, l, d)
    y = F.layer_norm(x1.float(), (d,), ln2_s.float(), ln2_b.float(), eps)
    h = F.gelu(mm(y.reshape(-1, d), fc1_w, fc1_b), approximate="tanh")
    return x1 + mm(h, fc2_w, fc2_b).bfloat16().view(b, l, d)


def k8_bound_ms(b, l, d, mlp, weight_bytes):
    """Least time for K8: the four int8 products (2 B L (4 D^2 + 2 D MLP)
    integer operations at the int8 peak) plus the bf16 attention (4 B L^2 D
    at the bf16 peak), against x read and out written once in bf16 and the
    bf16 weights read once."""
    int_ops = 2 * b * l * (4 * d * d + 2 * d * mlp)
    att_flops = 4 * b * l * l * d
    nbytes = 2 * (2 * b * l * d) + weight_bytes
    t_ops = int_ops / PEAK_INT8_OPS + att_flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", int_ops,
            att_flops, nbytes)


# K8's launches a call, in order, and the target they are held to
K8_LAUNCHES = ("weight_max_LN1", "weights", "qkv", "attention",
               "ctx_quant", "proj", "LN2", "mlp")
K8_MAX_LAUNCHES = 10


def k8_launch_split(fn, b, l, d, mlp):
    """`k8_profile`: the launches of one K8 call, the products' TOP/s (the
    MLP's 4 B L D MLP operations the function needs; its launch executes 6,
    fc1 twice); fails unless every product ran `gemm_sm90_kernel` (its
    int8 mode) and no launch ran the mma.sync int8 GEMM or the f32 row
    quantizer this design removed."""
    m = b * l
    launch_split(fn, f"k8_profile (B, L) = ({b}, {l})", K8_LAUNCHES,
                 {"qkv": 6 * m * d * d, "proj": 2 * m * d * d,
                  "mlp": 4 * m * d * mlp}, K8_MAX_LAUNCHES, unit="TOP/s",
                 forbid=("gemm_i8_kernel", "quant_rows_kernel<float>"))


def phase_k8(parent=None):
    """Phase 12; `parent`: a ParentKernels to time beside K8."""
    import torch
    from sais_tpu_torch.config import ViTConfig
    from sais_tpu_torch.kernels.fused_mha import (fused_vit_block,
                                                  fused_vit_block_int8,
                                                  vit_block_int8_reference)
    from sais_tpu_torch.models.vit import block_weights_bf16, vit_init
    b, l, d, heads, mlp, valid = 256, 197, 384, 6, 1536, 197
    # a ViT-S/16 block as the reference initializes it and unit-normal
    # tokens, as JAX's own int8 test takes them (tests/test_int8_block.py)
    model = vit_init(torch.Generator().manual_seed(0), ViTConfig())
    ws = [w.detach().cuda() for w in block_weights_bf16(model.blocks[0])]
    x = torch.randn((b, l, d), generator=torch.Generator().manual_seed(1)).to(
        "cuda", torch.bfloat16)
    kw = dict(num_heads=heads, valid_len=valid, eps=1e-6)
    out = fused_vit_block_int8(x, *ws, **kw)
    again = fused_vit_block_int8(x, *ws, **kw)
    torch.cuda.synchronize()
    # int32 sums, exact maxima, per-row LayerNorm in a fixed order
    check(torch.equal(out, again), "K8 is not deterministic: two runs differ")
    del again
    ref = vit_block_int8_reference(x, *ws, **kw)
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    bf = fused_vit_block(x, *ws, **kw).float()
    got = out.float()
    cos = (torch.dot(got.ravel(), bf.ravel())
           / (got.norm() * bf.norm())).item()
    rel = ((got - bf).abs().max() / bf.abs().max()).item()
    lib_err = (library_block_int8(x, ws, heads, valid, 1e-6).float()
               - ref.float()).abs().max().item()
    # the same reading at the K1 phase's weights (std 0.05, further from a
    # trained block's than the reference init), printed only
    x_k1, ws_k1 = k1_inputs(b, l, d, heads, mlp, seed=l)
    got_k1 = fused_vit_block_int8(x_k1, *ws_k1, **kw).float()
    bf_k1 = fused_vit_block(x_k1, *ws_k1, **kw).float()
    cos_k1 = (torch.dot(got_k1.ravel(), bf_k1.ravel())
              / (got_k1.norm() * bf_k1.norm())).item()
    rel_k1 = ((got_k1 - bf_k1).abs().max() / bf_k1.abs().max()).item()
    del x_k1, ws_k1, got_k1, bf_k1
    print(f"K8 (B, L, D) = ({b}, {l}, {d}): max|kernel-plain| {err:.4g} "
          f"(max|plain| {scale:.4g}), two runs bitwise equal; against K1 on "
          f"the same inputs: cosine "
          f"{cos:.7f}, max relative {rel:.4g} (checked; at the K1 phase's "
          f"weights, not checked: cosine {cos_k1:.7f}, max relative "
          f"{rel_k1:.4g}); max|library-plain| {lib_err:.4g}", flush=True)
    # Limits: 2e-2 of the plain version's largest value (a LayerNorm or
    # softmax summed in another order may move a value across a
    # quantizer's tie: one int8 step); against K1 JAX's own limits
    # (tests/test_int8_block.py): cosine > 0.9999, max relative < 0.02.
    check(math.isfinite(err) and err <= 2e-2 * scale,
          f"K8 disagrees with its plain version: {err} > 2e-2 * {scale}")
    check(cos > 0.9999 and rel < 0.02,
          f"K8 too far from K1: cosine {cos}, max relative {rel}")
    ms = cuda_time_ms(lambda: fused_vit_block_int8(x, *ws, **kw))
    plain_ms = cuda_time_ms(lambda: vit_block_int8_reference(x, *ws, **kw),
                            iters=3, warmup=1)
    library_ms = cuda_time_ms(
        lambda: library_block_int8(x, ws, heads, valid, 1e-6))
    weight_bytes = sum(w.numel() * w.element_size() for w in ws)
    bound_ms, bound_by, int_ops, att_flops, nbytes = k8_bound_ms(
        b, l, d, mlp, weight_bytes)
    print(f"K8 B={b} L={l} D={d}: kernel {ms:.4f} ms "
          f"({int_ops / ms / 1e9:.1f} TOP/s int8), plain {plain_ms:.4f} ms, "
          f"library (torch._int_mm, layer_norm, SDPA, gelu) {library_ms:.4f}"
          f" ms; bound {bound_ms:.4f} ms by {bound_by} ({int_ops / 1e9:.1f} "
          f"G int8 ops + {att_flops / 1e9:.1f} GFLOP bf16, "
          f"{nbytes / 1e6:.1f} MB), kernel at {100 * bound_ms / ms:.1f}% of "
          f"the bound", flush=True)
    k1_ms = cuda_time_ms(lambda: fused_vit_block(x, *ws, **kw))
    print(f"K8 against K1 in the same call, (B, L) = ({b}, {l}): K8 "
          f"{ms:.4f} ms, K1 {k1_ms:.4f} ms", flush=True)
    k8_launch_split(lambda: fused_vit_block_int8(x, *ws, **kw), b, l, d, mlp)
    if parent is not None:
        parent.compare("K8", (b, l, d), lambda: parent.k8(x, ws, **kw),
                       lambda: fused_vit_block_int8(x, *ws, **kw), (2e-2,))
    del x, ws, out, ref, bf, got
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)


def phase_int8_encoder(nframes: int = 256):
    """The W8A8 encoder at full width: 256 synthetic 480x640 frames (numpy
    seed 0) on the card -> preprocess_batch -> vit_features(bf16 ViT-S/16,
    quant="int8"); frames/s beside the bf16 path's."""
    import numpy as np
    import torch
    from sais_tpu_torch.config import PipelineConfig
    from sais_tpu_torch.kernels.fused_mha import (fused_vit_block,
                                                  fused_vit_block_int8)
    from sais_tpu_torch.models.vit import vit_features, vit_init
    from sais_tpu_torch.ops.preprocess import preprocess_batch

    cfg = PipelineConfig()
    model = vit_init(torch.Generator().manual_seed(0), cfg.vit).to(
        "cuda", torch.bfloat16).requires_grad_(False)
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (nframes, 480, 640, 3), dtype=np.uint8)).cuda()

    def encode(quant):
        with torch.inference_mode():
            x = preprocess_batch(frames, cfg.preprocess, torch.bfloat16)
            return vit_features(model, x, quant=quant)

    encode("int8")    # warm-up at the same shapes
    torch.cuda.synchronize()
    fused_vit_block.launches = fused_vit_block_int8.launches = 0
    feats = encode("int8")
    torch.cuda.synchronize()
    k8, k1 = fused_vit_block_int8.launches, fused_vit_block.launches
    ref = encode(None)
    cos = torch.nn.functional.cosine_similarity(feats, ref, dim=-1)

    def rate(quant):
        times = []
        for _ in range(3):
            t = time.perf_counter()
            encode(quant)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return nframes / sorted(times)[1], times

    fps8, t8 = rate("int8")
    fps16, t16 = rate(None)
    print(f"W8A8 encoder: {nframes} frames of 480x640 on the card: K8 "
          f"launches {k8}, K1 launches {k1}; CLS {tuple(feats.shape)}, mean "
          f"cosine against the K1 path {cos.mean().item():.6f} (min "
          f"{cos.min().item():.6f}); {fps8:.1f} frames/s int8 (median of "
          f"{', '.join(f'{1e3 * t:.2f}' for t in t8)} ms) vs {fps16:.1f} "
          f"bf16 (median of {', '.join(f'{1e3 * t:.2f}' for t in t16)} ms)",
          flush=True)
    check(k8 == 12 and k1 == 0,
          f"W8A8 encoder launched K8 {k8} and K1 {k1} times, expected 12, 0")
    check(tuple(feats.shape) == (nframes, 384)
          and bool(torch.isfinite(feats).all()),
          f"W8A8 features {tuple(feats.shape)} not finite / wrong shape")
    # Limit: mean CLS cosine >= 0.999 against the bf16 K1 path (JAX reports
    # 0.9997 against f32, tests/test_int8_block.py:5).
    check(cos.mean().item() >= 0.999,
          f"W8A8 CLS features too far from the K1 path: {cos.mean().item()}")
    del model, frames
    torch.cuda.empty_cache()
    return k8


class _MemStore:
    """In-memory stand-in for io.feature_store.FeatureStore (the card
    machine has no h5py): one dict of videos per store path."""

    files = {}

    def __init__(self, path, mode="r"):
        self.videos = _MemStore.files.setdefault(path, {})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        pass

    def __contains__(self, name):
        return name in self.videos

    def write_video(self, video, reps, attrs=None):
        self.videos[video] = reps

    def read_video(self, video):
        return self.videos[video]


class _MemVideo:
    """In-memory stand-in for io.video.VideoReader over `frames` (the card
    machine has no OpenCV)."""

    frames_u8 = None

    def __init__(self, path):
        self.frame_count = len(_MemVideo.frames_u8)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def frames(self):
        yield from _MemVideo.frames_u8

    def batches(self, batch_size):
        f = _MemVideo.frames_u8
        for i in range(0, len(f), batch_size):
            yield f[i:i + batch_size]


def _nccl_two_ranks_one_card():
    """Two NCCL ranks on cuda:0 in two processes (a FileStore rendezvous),
    one all-reduce; returns what happened, in one line.  NCCL refuses a
    second rank on a card that holds one."""
    script = (
        "import os, sys, tempfile, torch, torch.distributed as dist\n"
        "import torch.multiprocessing as mp\n"
        "def run(rank, path):\n"
        "    torch.cuda.set_device(0)\n"
        "    dist.init_process_group('nccl', store=dist.FileStore(path, 2),"
        " rank=rank, world_size=2)\n"
        "    x = torch.ones(4, device='cuda')\n"
        "    dist.all_reduce(x)\n"
        "    torch.cuda.synchronize()\n"
        "    print('rank', rank, 'all-reduce gave', x[0].item(), flush=True)\n"
        "    dist.destroy_process_group()\n"
        "if __name__ == '__main__':\n"
        "    mp.spawn(run, nprocs=2, args=(os.path.join(tempfile.mkdtemp(),"
        " 's'),))\n")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "two_ranks.py")   # spawn re-imports it
        with open(path, "w") as f:
            f.write(script)
        try:
            out = subprocess.run([sys.executable, path], capture_output=True,
                                 text=True, timeout=120)
        except subprocess.TimeoutExpired:
            return "no answer in 120 s (killed)"
    text = (out.stdout + out.stderr).splitlines()
    keep = [line.strip() for line in text
            if "Duplicate GPU" in line or "ncclInvalidUsage" in line
            or "all-reduce gave" in line or "Error" in line][:3]
    return f"exit {out.returncode}: " + " | ".join(keep or text[-2:])


def _ring_check(card):
    """The 4-rank ring in one process (`ring_in_one_process`: every rank's
    step in turn, the chunks handed on in a list) at the long training
    step's (2, 4, 8193, 96), against whole-sequence K2 and K3 on the same
    inputs: out, lse, dq, dk and dv within 1e-4 of their largest value
    (the K2 / K3 phases' limit).  -> (K2, K3) launches of the check."""
    import torch
    from sais_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_fwd, key_bias)
    from sais_tpu_torch.parallel.sequence import ring_in_one_process
    b, l = 2, LONG_FRAMES + 1
    q, k, v, mask, _ = k2_inputs(b, l, seed=29, masked=False)
    mask[1, l - 700:] = True    # a ragged element as well
    bias = key_bias(mask)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(31)
                     ).cuda()
    flash_attention.launches = flash_attention_bwd.launches = 0
    ring = ring_in_one_process(q, k, v, bias, 4, do)
    torch.cuda.synchronize()
    launches = (flash_attention.launches, flash_attention_bwd.launches)
    out, lse = flash_attention_fwd(q, k, v, bias)
    whole = (out, lse) + tuple(flash_attention_bwd(q, k, v, bias, out, lse,
                                                   do))
    errs = {}
    for name, x, y in zip(("out", "lse", "dq", "dk", "dv"), ring, whole):
        errs[name] = ((x - y).abs().max().item(), y.abs().max().item())
    print(f"4-rank ring in one process at (2, 4, {l}, 96) (element 1's "
          f"last 700 keys masked): K2 {launches[0]} and K3 {launches[1]} "
          f"launches (16 each); against whole-sequence K2 / K3: "
          + ", ".join(f"{n} max|diff| {e:.3g} (max {s:.3g})"
                      for n, (e, s) in errs.items()) + f"; {card}",
          flush=True)
    check(launches == (16, 16), f"ring launches {launches}")
    for name, (err, scale) in errs.items():
        check(math.isfinite(err) and err <= 1e-4 * scale,
              f"4-rank ring {name} differs: {err} > 1e-4 * {scale}")
    del q, k, v, do, ring, whole
    torch.cuda.empty_cache()
    return launches


def _k7_two_shards(card):
    """K7 on two shards of batch 32 (the pretrain step's crops, out_dim
    65536), normalized by the global batch as make_fused_dino_loss_dp does
    it, summed as the all-reduce sums them (loss, dv, dg; the center's
    mean of the shards; dh_s concatenated in the image-major order),
    against K7 at batch 64: the K7 phase's limits (loss and center 1e-4
    relative; dhs, dvs, dgs 1e-2 of the batch-64 largest value)."""
    import torch
    from sais_tpu_torch.kernels.dino_head_loss import (build_pair_structure,
                                                       fused_loss_and_grads)
    ng, nl, db, k = 2, 8, 256, 65536
    hs, ht, vs, vt, gs, gt, center, sel, c = k7_inputs(64, ng, nl, db, k, 37)
    n_terms = ng * (ng + nl - 1)
    kw = dict(student_temp=0.1, inv_norm=1.0 / (64 * n_terms), use_g=True)
    whole = fused_loss_and_grads(hs, ht, vs, vt, gs, gt, center, 0.04, sel,
                                 c, **kw)
    sel32, c32 = (torch.from_numpy(t).cuda()
                  for t in build_pair_structure(32, ng, nl))
    parts = []
    for s in range(2):
        hs_s = torch.cat([hs[s * 32 * ng:(s + 1) * 32 * ng],
                          hs[64 * ng + s * 32 * nl:64 * ng
                             + (s + 1) * 32 * nl]])
        ht_s = ht[s * 32 * ng:(s + 1) * 32 * ng]
        parts.append(fused_loss_and_grads(hs_s, ht_s, vs, vt, gs, gt, center,
                                          0.04, sel32, c32, **kw))
    (l0, b0, h0, v0, g0), (l1, b1, h1, v1, g1) = parts
    dh = torch.cat([h0[:32 * ng], h1[:32 * ng], h0[32 * ng:],
                    h1[32 * ng:]])
    got = (l0 + l1, (b0 + b1) / 2, dh, v0 + v1, g0 + g1)
    torch.cuda.synchronize()
    errs = {}
    for name, x, y in zip(("loss", "center", "dhs", "dvs", "dgs"), got,
                          whole):
        diff = (x.float() - y.float()).abs().max().item()
        errs[name] = (diff, y.float().abs().max().item())
    print("K7 on two shards of batch 32, summed, against K7 at batch 64: "
          + ", ".join(f"{n} max|diff| {e:.3g} (max {s:.3g})"
                      for n, (e, s) in errs.items()) + f"; {card}",
          flush=True)
    for name in ("loss", "center"):
        e, s = errs[name]
        check(e <= 1e-4 * s, f"K7 shards {name}: {e} > 1e-4 * {s}")
    for name in ("dhs", "dvs", "dgs"):
        e, s = errs[name]
        check(e <= 1e-2 * s, f"K7 shards {name}: {e} > 1e-2 * {s}")


def _allreduce_ms(card):
    """One NCCL all-reduce (SUM) of the ViT-S/16 DINO student's flat f32
    gradient buffer (backbone + head, out_dim 65536), world size 1, by
    CUDA events (median of 20 after warm-up)."""
    import torch
    import torch.distributed as dist
    from sais_tpu_torch.config import ViTConfig
    from sais_tpu_torch.models.dino_head import DINOHead
    from sais_tpu_torch.models.vit import VisionTransformer
    n = sum(p.numel() for p in VisionTransformer(ViTConfig()).parameters())
    n += sum(p.numel() for p in DINOHead(384, 65536).parameters())
    flat = torch.ones(n, device="cuda")
    ms = cuda_time_ms(lambda: dist.all_reduce(flat))
    print(f"NCCL all-reduce of the ViT-S/16 student's flat gradient buffer "
          f"({n} floats, {4 * n / 1e6:.1f} MB), world size "
          f"{dist.get_world_size()}: {ms:.4f} ms; {card}", flush=True)
    return ms


def phase_parallel(card: str):
    """The parallel flags on the card, world size 1 over NCCL (one H100),
    and the multi-rank arithmetic in one process; returns the launches of
    the driven runs {K1, K2, K3, K4, K5, K6, K7}."""
    import dataclasses
    import glob as glob_lib
    import numpy as np
    import torch
    from sais_tpu_torch.cli import main as cli
    from sais_tpu_torch.infer import pipeline
    from sais_tpu_torch.io import feature_store, video as video_io
    from sais_tpu_torch.kernels.dino_head_loss import fused_loss_and_grads
    from sais_tpu_torch.kernels.flash_attention import (flash_attention,
                                                        flash_attention_bwd)
    from sais_tpu_torch.kernels.fused_mha import (fused_block_bwd_attn,
                                                  fused_block_bwd_mlp,
                                                  fused_block_fwd_train,
                                                  fused_vit_block)
    from sais_tpu_torch.parallel import distributed
    from sais_tpu_torch.train.loop import PrototypeTrainer
    counters = {"K1": fused_vit_block, "K2": flash_attention,
                "K3": flash_attention_bwd, "K4": fused_block_fwd_train,
                "K5": fused_block_bwd_mlp, "K6": fused_block_bwd_attn,
                "K7": fused_loss_and_grads}
    total = dict.fromkeys(counters, 0)

    def zero():
        for f in counters.values():
            f.launches = 0

    def read():
        got = {n: f.launches for n, f in counters.items()}
        for n, v in got.items():
            total[n] += v
        return got

    print(f"two NCCL ranks on one card: {_nccl_two_ranks_one_card()}",
          flush=True)

    frames = np.random.default_rng(0).integers(0, 256, (300, 480, 640, 3),
                                               dtype=np.uint8)
    # the card machine has no h5py and no OpenCV: the feature store, the
    # video readers and the frame pump are replaced by in-memory stand-ins
    # (the video file an empty placeholder); extract_video itself runs
    saved = (feature_store.FeatureStore, video_io.VideoReader,
             pipeline.VideoReader, pipeline.FeatureExtractor._pump)
    feature_store.FeatureStore = _MemStore
    video_io.VideoReader = pipeline.VideoReader = _MemVideo
    pipeline.FeatureExtractor._pump = lambda self, path: None
    _MemVideo.frames_u8 = frames
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # (a) extract --data-parallel (every card: one) against extract
            os.makedirs(os.path.join(tmp, "videos"), exist_ok=True)
            open(os.path.join(tmp, "videos", "smoke.mp4"), "w").close()
            base = ["extract", "-f", "smoke", "-p", tmp, "--random-init",
                    "--force"]
            reps = {}
            for flags in ([], ["--data-parallel"]):
                zero()
                t = time.perf_counter()
                cli.main(base + flags)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
                got = read()
                reps[bool(flags)] = _MemStore.files[
                    feature_store.rgb_store_path(tmp)]["smoke"].copy()
                print(f"extract {' '.join(flags) or '(one card)'}: 300 "
                      f"frames of 480x640, {dt:.2f} s with the build and "
                      f"cuBLAS set-up; K1 launches {got['K1']}; {card}",
                      flush=True)
                check(got["K1"] == 12 * 2, f"extract launched K1 "
                      f"{got['K1']} times, expected 12 x 2 batches")
            diff = float(np.abs(reps[True] - reps[False]).max())
            print(f"extract --data-parallel (NCCL, world size 1) against "
                  f"the one-card path: max|diff| {diff:.3g} (bitwise "
                  f"expected)", flush=True)
            check(diff == 0.0, f"extract --data-parallel differs: {diff}")

            # (b) pretrain --data-parallel: 2 steps of batch 64 at ViT-S/16
            # + out_dim 65536 (K4-K6, K1 the teacher, K7) against pretrain
            os.replace(os.path.join(tmp, "videos", "smoke.mp4"),
                       os.path.join(tmp, "videos", "v.mp4"))
            _MemVideo.frames_u8 = frames[:128]
            ckpt = {}
            for flags in ([], ["--data-parallel"]):
                for old in glob_lib.glob(os.path.join(tmp, "pretrain",
                                                      "ckpt", "*")):
                    os.unlink(old)
                zero()
                t = time.perf_counter()
                cli.main(["pretrain", "-p", tmp, "-bs", "64", "-e", "1",
                          "--loader-threads", "2"] + flags)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
                got = read()
                ckpt[bool(flags)] = torch.load(
                    os.path.join(tmp, "pretrain", "ckpt", "1.pt"),
                    map_location="cpu", weights_only=False)
                print(f"pretrain {' '.join(flags) or '(one card)'}: 2 steps "
                      f"of batch 64, {dt:.2f} s; launches " + ", ".join(
                          f"{n} {v}" for n, v in got.items()) + f"; {card}",
                      flush=True)
                check(all(got[n] == 48 for n in ("K4", "K5", "K6"))
                      and got["K1"] == 24 and got["K7"] == 2,
                      f"pretrain {flags} launches {got}")
            worst = max(
                (ckpt[True]["student"][n].float()
                 - w.float()).abs().max().item()
                / max(w.float().abs().max().item(), 1e-30)
                for n, w in ckpt[False]["student"].items())
            print(f"pretrain --data-parallel (NCCL, world size 1) against "
                  f"the one-card path: worst parameter max|diff| / max|value| "
                  f"after 2 steps {worst:.3g}", flush=True)
            # limit: the pretrain phase's 5e-2 of a gradient's largest
            # value, on the parameters after two steps
            check(worst <= 5e-2, f"pretrain --data-parallel differs: {worst}")

            # (c) train --seq-parallel 1 (the ring on K2 / K3) against
            # train --flash on, 2 epochs of -bs 32 over 16 videos
            store, segments = _synthetic_training_data()
            _MemStore.files[feature_store.rgb_store_path(tmp)] = \
                store.videos
            import csv as csv_lib
            seg_csv = os.path.join(tmp, "segments.csv")
            with open(seg_csv, "w", newline="") as f:
                w = csv_lib.DictWriter(f, fieldnames=list(segments[0]))
                w.writeheader()
                w.writerows(segments)
            orig_run = PrototypeTrainer.run_epoch
            record = []

            def run(self, batches, train):
                loss, m = orig_run(self, batches, train)
                record.append(loss)
                return loss, m

            PrototypeTrainer.run_epoch = run
            fits = {}
            try:
                for flags in (["--flash", "on"], ["--seq-parallel", "1"]):
                    record.clear()
                    zero()
                    cli.main(["train", "-p", tmp, "--segments", seg_csv,
                              "-bc", "-e", "2", "-bs", "32", "-lr", "0.1",
                              "--nfolds", "1"] + flags)
                    torch.cuda.synchronize()
                    got = read()
                    fits[flags[0]] = list(record)
                    print(f"train {' '.join(flags)}: epoch losses "
                          f"{[round(x, 6) for x in record]}; K2 launches "
                          f"{got['K2']}, K3 {got['K3']}; {card}", flush=True)
                    check(got["K2"] > 0 and got["K3"] > 0,
                          f"train {flags} launched K2 {got['K2']}, K3 "
                          f"{got['K3']} times")
            finally:
                PrototypeTrainer.run_epoch = orig_run
            gap = float(np.max(np.abs(np.subtract(fits["--flash"],
                                                  fits["--seq-parallel"]))))
            print(f"train --seq-parallel 1 (NCCL) against --flash on: "
                  f"max|epoch loss diff| {gap:.3g}", flush=True)
            # limit: the training phase's 1e-3 for f32 fits
            check(gap <= 1e-3, f"train --seq-parallel 1 differs: {gap}")
    finally:
        (feature_store.FeatureStore, video_io.VideoReader,
         pipeline.VideoReader, pipeline.FeatureExtractor._pump) = saved

    # (d) the ring of 4 ranks in one process; K7 on two shards; the time
    # of one all-reduce of the student's gradients (world size 1)
    _ring_check(card)
    _k7_two_shards(card)
    box = []
    distributed.run_ranks(lambda: box.append(_allreduce_ms(card)), 1,
                          "cuda")
    return total


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    try:
        import sais_tpu_torch  # noqa: F401
    except ImportError:
        fail("the sais_tpu_torch package is not beside this script")
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent-csrc", metavar="DIR",
                        help="an earlier tree's kernels/csrc: time its K1, "
                        "K2, K3, K6, K7 and K8 beside this tree's")
    args = parser.parse_args()
    t_start = time.time()
    card = phase_device()
    phase_build()
    parent = ParentKernels(args.parent_csrc) if args.parent_csrc else None
    k1 = phase_k1(parent)
    k2 = phase_k2()
    launches, rgb_feats = phase_main_path(nframes=300)
    host_launches = phase_host_extract(nframes=300)
    flow_launches = phase_flow(rgb_feats, card)
    serve_launches = phase_serve(card)
    phase_eval_attention(card)
    phase_steps(nframes=20000)
    k3 = phase_k3()
    if parent:
        parent_k23(parent)
    k2_launches, k3_launches = phase_train()
    skill_k2, skill_k3 = phase_skill(card)
    k2_launches += skill_k2
    k3_launches += skill_k3
    train_k = phase_train_kernels(parent)
    phase_long_blocks(parent)
    k7 = phase_k7(parent)
    # launches of K4, K5, K6, K1, K7 on the three pretrain paths
    vits16, vits8 = phase_pretrain(card), phase_pretrain(card, arch="vits8")
    bn = phase_pretrain_bn(card, vits16[1])
    pretrain_launches = [a + b + c for a, b, c in zip(vits16[0], vits8[0],
                                                      bn)]
    k8 = phase_k8(parent)
    k8_launches = phase_int8_encoder()
    cls_k2, cls_k3 = phase_classification(card)
    k2_launches += cls_k2
    k3_launches += cls_k3
    phase_raw(card)
    par = phase_parallel(card)
    k2_launches += par["K2"]
    k3_launches += par["K3"]
    pretrain_launches = [a + par[k] for a, k in zip(
        pretrain_launches, ("K4", "K5", "K6", "K1", "K7"))]
    kernels = [{
        "name": "fused_vit_block", "route": "cuda",
        "source": "sais_tpu_torch/kernels/csrc/fused_vit_block.cu",
        "replaces": "sais_tpu/kernels/fused_mha.py:117",
        "launches": (launches + host_launches + flow_launches
                     + serve_launches + pretrain_launches[3]),
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "sais_tpu_torch/kernels/csrc/flash_attention.cu",
        "replaces": "sais_tpu/kernels/flash_attention.py:50",
        "launches": k2_launches, "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"]}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "sais_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "sais_tpu/kernels/flash_attention.py:89, :120",
        "launches": k3_launches, "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"]}]
    for (name, source, replaces), launches in zip((
            ("fused_block_fwd_train", "fused_vit_block.cu", ":421"),
            ("fused_block_bwd_mlp", "fused_block_bwd_mlp.cu", ":475"),
            ("fused_block_bwd_attn", "fused_block_bwd_attn.cu",
             ":531, :630")), pretrain_launches):
        k = train_k[{"fused_block_fwd_train": "K4",
                     "fused_block_bwd_mlp": "K5",
                     "fused_block_bwd_attn": "K6"}[name]]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"sais_tpu_torch/kernels/csrc/{source}",
            "replaces": f"sais_tpu/kernels/fused_mha.py{replaces}",
            "launches": launches, "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"]})
    for name, source, replaces, k, launches in (
            ("dino_head_loss", "dino_head_loss.cu",
             "sais_tpu/kernels/dino_head_loss.py:95, :131", k7,
             pretrain_launches[4]),
            ("fused_vit_block_int8", "fused_vit_block_int8.cu",
             "sais_tpu/kernels/fused_mha.py:186", k8, k8_launches)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"sais_tpu_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    print(f"total {time.time() - t_start:.1f} s (the parent tree's final "
          f"run on an H100 80GB HBM3 at 700 W: 495.4 s, PERF.md §6)",
          flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
