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
   forward, K3's dq and dk / dv), their products' 3xTF32 route.
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
   f32 FFMA bound beside it).
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
10. K4 (fused_block_fwd_train), K5 (fused_block_bwd_mlp) and K6
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
11. K7 (dino_head_loss), the DINO last layer + loss: the CUDA kernel
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
   kernels/csrc), its K7 and K8 are built and timed beside this tree's,
   in turns, at both batches and at K8's shape.
12. pretrain path at full width (`pretrain -bs 64` without the video
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
   loss with fused_loss=False printed beside it.
13. K8 (fused_vit_block_int8), the W8A8 block, at (256, 197, 384): the
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
14. W8A8 encoder: 256 synthetic 480x640 frames through preprocess_batch
   and vit_features(bf16 ViT-S/16, quant="int8"): K8 must launch 12 times
   and K1 not at all; mean CLS cosine against the K1 path >= 0.999;
   frames/s beside the bf16 path's (median of three after a warm-up).
15. prints the kernels line (JSON), then, last, the device line (JSON).

It also prints torch.profiler tables (device time per kernel, device idle
share) of K1 calls, K2 calls, one extraction, one decode, one steps run,
K3 calls, one long train step (with K2's and K3's shares), K4-K6 calls,
K7 and K8 calls (per launch), one pretrain step (with K4's, K5's, K6's,
K1's and K7's shares, read from profiler ranges: K1 and K4 share their
kernels' names) and one flow extraction (RAFT's and the ViT's shares).
"""

from __future__ import annotations

import json
import math
import os
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


def check_tf32_sass(name, fragments):
    """cuobjdump -sass of one built library: prints the TF32 HMMA and FFMA
    count of every kernel named by `fragments` and fails unless each has a
    TF32 HMMA."""
    from sais_tpu_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed on {name}: {out.stderr}")
    funcs, current = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            current = line.split("Function :")[1].strip()
            funcs[current] = [0, 0]
        elif current is not None:
            funcs[current][0] += "HMMA" in line and "TF32" in line
            funcs[current][1] += "FFMA" in line
    for frag in fragments:
        found = {f: c for f, c in funcs.items() if frag in f}
        check(bool(found), f"{name}: no kernel named {frag} in the SASS")
        for func, (hmma, ffma) in sorted(found.items()):
            print(f"  {name}: {func}: {hmma} TF32 HMMA, {ffma} FFMA",
                  flush=True)
            check(hmma > 0, f"{func} has no TF32 HMMA instruction")


def phase_build():
    from sais_tpu_torch.kernels import _build
    t0 = time.time()
    logs = _build.build()
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
                 forbid=("gemm_kernel",)):
    """Profiles five calls of fn (one call of a kernel's wrapper) and prints
    the device time of each of its launches, labelled in order by
    `labels`, with the rate (`unit`, 1e12 a second) of those in `flops`
    (label -> flops or integer operations) and of those in `extra` (other
    labelled work, e.g. K6's attention backward).  Fails unless a call
    makes exactly len(labels) launches, no more than `limit`, every
    product in `flops` ran on the wgmma + TMA kernel (`gemm_sm90_kernel`)
    and no launch ran a kernel named by `forbid` (the mma.sync template
    `gemm_kernel`, or a kernel the redesign removed).  Returns {label:
    ms}."""
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
        work = dict(flops, **dict(extra)).get(label)
        if work is not None:
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
    """K1's or K4's seven launches at (b, l) (`launch_split`)."""
    m = b * l
    launch_split(fn, f"{name} (B, L) = ({b}, {l})", BLOCK_LAUNCHES,
                 {"qkv": 6 * m * d * d, "proj": 2 * m * d * d,
                  "fc1": 2 * m * d * mlp, "fc2": 2 * m * mlp * d},
                 len(BLOCK_LAUNCHES))


# K5's and K6's launches a call, in order, and the targets they are held to
K5_LAUNCHES = ("prep", "fc1", "dh", "dy", "ln_bwd", "dW2", "dW1", "sum")
K6_LAUNCHES = ("prep", "qkv", "dctx", "attention_bwd", "dWproj", "dWqkv",
               "dy", "ln_bwd", "sum")
K5_MAX_LAUNCHES, K6_MAX_LAUNCHES = 11, 12


def bwd_launch_split(k5, k6, b, l, d, mlp):
    """`k5_profile` and `k6_profile`: the launches of one K5 and one K6 call
    at (b, l), the products' TFLOP/s and the attention backward's share of
    K6 (its 12 L^2 D flops an image, the ones the function needs)."""
    m = b * l
    prod = 2 * m * d * mlp
    launch_split(k5, f"k5_profile (B, L) = ({b}, {l})", K5_LAUNCHES,
                 dict.fromkeys(("fc1", "dh", "dy", "dW2", "dW1"), prod),
                 K5_MAX_LAUNCHES)
    split = launch_split(
        k6, f"k6_profile (B, L) = ({b}, {l})", K6_LAUNCHES,
        {"qkv": 6 * m * d * d, "dctx": 2 * m * d * d,
         "dWproj": 2 * m * d * d, "dWqkv": 6 * m * d * d,
         "dy": 6 * m * d * d}, K6_MAX_LAUNCHES,
        extra={"attention_bwd": 12 * b * l * l * d})
    print(f"k6_profile (B, L) = ({b}, {l}): attention_bwd "
          f"{split['attention_bwd']:.4f} ms, "
          f"{100 * split['attention_bwd'] / sum(split.values()):.1f}% of "
          f"the call", flush=True)


def phase_k1():
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
    key) pair, against q, k, v, the bias read once and out, lse written
    once.  -> (bound ms, bound by, flops, bytes, f32 FFMA bound ms)."""
    flops = 4 * h * l * dh * sum(valid)
    nbytes = 4 * (4 * b * h * l * dh + b * l + b * h * l)
    bound, by, ffma = flash_bound_ms(flops, nbytes)
    return bound, by, flops, nbytes, ffma


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
        bound_ms, bound_by, flops, nbytes, ffma_ms = k2_bound_ms(
            b, 4, l, 96, valid)
        print(f"K2 B*S={b} H=4 L={l} Dh=96{' masked' if masked else ''}: "
              f"kernel {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, library (SDPA, f32 additive mask) "
              f"{library_ms:.4f} ms (max|lib-kernel| {lib_err:.3g}); bound "
              f"{bound_ms:.4f} ms by {bound_by} in 3xTF32 ({flops / 1e9:.2f}"
              f" GFLOP, {nbytes / 1e6:.1f} MB; f32 FFMA bound "
              f"{ffma_ms:.4f} ms), kernel at {100 * bound_ms / ms:.1f}% of "
              f"the bound", flush=True)
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
    Returns (busy us, wall us, {label: us})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not (per_launch and MARKER in e.name))
    busy_us, end = 0.0, -math.inf
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=25)
    print(f"{name} ({steps} calls): device busy {busy_us:.0f} us of "
          f"{wall_us:.0f} us wall ({100 * (1 - busy_us / wall_us):.1f}% "
          f"idle)\n{table}", flush=True)
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
        torch.cuda.synchronize()
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
        print(f"K3 B*S={b} H=4 L={l} Dh=96{' masked' if masked else ''}: "
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


def phase_train_kernels():
    """Phase 9: K4, K5 and K6 at the pretrain shapes."""
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
        if (b, l) == (128, 197):
            _profile(lambda: [fn() for fn, _ in runs.values()],
                     "k4_k5_k6_profile", 3)
        del x, ws, x1, dx1, dout
        torch.cuda.empty_cache()
    for name in result:
        result[name]["max_abs_err"] = worst[name]
    return result


class ParentKernels:
    """K7 and K8 as an earlier tree built them (`--parent-csrc DIR`: that
    tree's kernels/csrc, with this tree's C ABI for them:
    dino_head_loss(_workspace) and fused_vit_block_int8(_workspace), as
    of PR 9's tree), built here into a temporary directory and timed
    beside this tree's kernels on the same card, in turns (earlier, this,
    this, earlier)."""

    def __init__(self, csrc):
        import ctypes
        from sais_tpu_torch.kernels import _build
        self.tmp = tempfile.mkdtemp(prefix="parent_kernels_")
        procs = {}
        for name in ("dino_head_loss", "fused_vit_block_int8"):
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
        print(f"parent K7 and K8 built from {csrc}", flush=True)

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


def phase_pretrain(batch: int = 64):
    """`pretrain` at full width: ViT-S/16, DINO head out_dim 65536, 2 global
    crops at 224 + 8 local at 96, batch 64, adamw, drop path 0.1, the
    student on K4-K6, the teacher on K1, the last layer and loss on K7."""
    import numpy as np
    import torch
    from sais_tpu_torch.config import ViTConfig
    from sais_tpu_torch.kernels.dino_head_loss import fused_loss_and_grads
    from sais_tpu_torch.kernels.fused_mha import (fused_block_bwd_attn,
                                                  fused_block_bwd_mlp,
                                                  fused_block_fwd_train,
                                                  fused_vit_block)
    from sais_tpu_torch.ops.augment import (center_border_crop,
                                            multi_crop_batch)
    from sais_tpu_torch.train.dino import DINOConfig, DINOTrainer

    cfg = DINOConfig(out_dim=65536, batch_size=batch, n_global_crops=2,
                     n_local_crops=8, drop_path_rate=0.1)
    counters = (fused_block_fwd_train, fused_block_bwd_mlp,
                fused_block_bwd_attn, fused_vit_block, fused_loss_and_grads)
    t0 = time.perf_counter()
    trainer = DINOTrainer(ViTConfig(), cfg, niter_per_ep=1000,
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
    print(f"pretrain: ViT-S/16 + DINO head (out_dim 65536), batch {batch}: "
          f"crops {tuple(g.shape)} + {tuple(l.shape)}; set-up "
          f"{setup_s:.1f} s", flush=True)

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
    print(f"pretrain: 5 steps {', '.join(f'{1e3 * t:.2f}' for t in times)}"
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
    print(f"pretrain step, kernels vs plain versions on the card (plain "
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
    print(f"pretrain step, K7 vs fused_loss=False on the card: loss "
          f"{loss_k:.6f} vs {loss_u:.6f} (rel "
          f"{abs(loss_k - loss_u) / abs(loss_u):.3g}; JAX's limit 5e-3)",
          flush=True)
    for p in trainer.student.parameters():
        p.grad = None

    with _Annotated():
        _profile(lambda: trainer.step(g, l), "pretrain_step_profile", 1,
                 ranges=("K4", "K5", "K6", "K1", "K7"))
    del trainer
    torch.cuda.empty_cache()
    return launches, step_s


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
                        help="an earlier tree's kernels/csrc: time its K7 "
                        "and K8 beside this tree's in phases 10 and 12")
    args = parser.parse_args()
    t_start = time.time()
    card = phase_device()
    phase_build()
    k1 = phase_k1()
    k2 = phase_k2()
    launches, rgb_feats = phase_main_path(nframes=300)
    flow_launches = phase_flow(rgb_feats, card)
    phase_steps(nframes=20000)
    k3 = phase_k3()
    k2_launches, k3_launches = phase_train()
    train_k = phase_train_kernels()
    parent = ParentKernels(args.parent_csrc) if args.parent_csrc else None
    k7 = phase_k7(parent)
    pretrain_launches, _ = phase_pretrain()
    k8 = phase_k8(parent)
    k8_launches = phase_int8_encoder()
    kernels = [{
        "name": "fused_vit_block", "route": "cuda",
        "source": "sais_tpu_torch/kernels/csrc/fused_vit_block.cu",
        "replaces": "sais_tpu/kernels/fused_mha.py:117",
        "launches": launches + flow_launches,
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
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
