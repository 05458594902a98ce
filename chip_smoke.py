#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sais_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run:

1. device: a CUDA device must be present; prints its name and power limit
   (nvidia-smi) and the torch / CUDA versions.
2. build: compiles every kernel of kernels/csrc with nvcc for sm_90a.
3. K1 (fused_vit_block) at ViT-S/16 widths, batch 256, bf16: the CUDA
   kernel against its plain PyTorch version at L = 197 and at L = 208 with
   keys >= 197 masked; CUDA-event times of the kernel, the plain version
   and one composition of PyTorch library calls (layer_norm, linear,
   scaled_dot_product_attention, gelu); the least time the card could take.
4. main path at full width: random ViT-S/16 and one fold of the 4-layer
   temporal model + prototypes (fixed torch.Generator seeds), 300
   synthetic 480x640 frames (10 s at 30 fps, numpy seed 0):
   FeatureExtractor.extract_array (bf16, batch 256) then
   GestureDecoder.decode over 3 TTA offsets, CSV to a temporary directory.
   The K1 launch count must be exactly 12 per frame batch; features and
   probabilities are checked against the same path through the plain
   version.  Extraction frames/s is the median of three timed runs after
   a warm-up at the same shapes.
5. prints the kernels line (JSON), then, last, the device line (JSON).

It also prints torch.profiler tables (device time per kernel, device idle
share) of K1 calls, of one extraction and of one decode.
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
PEAK_BYTES = 3.35e12         # H100 SXM HBM3


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


def phase_build():
    from sais_tpu_torch.kernels import _build
    t0 = time.time()
    logs = _build.build()
    print(f"build: {len(logs)} source(s) compiled in "
          f"{time.time() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "entry function" in line or "registers" in line:
                print(f"  {name}: {line.strip()}")


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
        _profile(lambda: fused_vit_block(x, *ws, **kw), "k1_profile", 5)
        del x, ws, out, ref, diff
    result["max_abs_err"] = worst
    return result


def _profile(fn, name: str, steps: int):
    """torch.profiler over `steps` calls of fn: prints the per-kernel table
    and the device's busy time (the union of its kernel and copy
    intervals) against the host's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
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


def phase_main_path(nframes: int):
    import numpy as np
    import torch
    from sais_tpu_torch.config import ModelConfig, PipelineConfig
    from sais_tpu_torch.infer.pipeline import FeatureExtractor, GestureDecoder
    from sais_tpu_torch.infer.postprocess import write_gestures_csv
    from sais_tpu_torch.kernels.fused_mha import (fused_vit_block,
                                                  vit_block_reference)
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

    fused_vit_block.launches = 0
    t0 = time.perf_counter()
    feats = fx.extract_array(frames)
    t1 = time.perf_counter()
    rows = dec.decode("smoke", feats)
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "Custom_inference_gestures.csv")
        write_gestures_csv(rows, csv)
        csv_ok = os.path.getsize(csv) > 0
    t2 = time.perf_counter()
    launches = fused_vit_block.launches

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
          f"{t2 - t1:.4f} s, {len(rows)} intervals; K1 launches {launches}",
          flush=True)
    check(launches == 12 * batches,
          f"K1 launched {launches} times on the main path, expected "
          f"{12 * batches}")
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
            plain.append(vit_forward_fused(fx.model, x,
                                           block=vit_block_reference))
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
    return launches


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
    t_start = time.time()
    card = phase_device()
    phase_build()
    k1 = phase_k1()
    launches = phase_main_path(nframes=300)
    kernels = [{
        "name": "fused_vit_block", "route": "cuda",
        "source": "sais_tpu_torch/kernels/csrc/fused_vit_block.cu",
        "replaces": "sais_tpu/kernels/fused_mha.py:117",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"]}]
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
