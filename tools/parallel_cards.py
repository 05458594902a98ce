#!/usr/bin/env python3
"""The port's parallel paths across cards (sais_tpu_torch.parallel over
NCCL, one process a card):

    python3 tools/parallel_cards.py [--cards N] [--phases ring,dino,...]

(default: every card, every phase)

1. ring attention at the long training step's (2, 4, 8193, 96), one key
   chunk a card (`sequence.ring_attention`: K2 on each visiting chunk,
   the chunks passed on by batch_isend_irecv; the backward ring on K3),
   against whole-sequence K2 / K3 on card 0 (1e-4 of the largest value,
   the K2 / K3 limit); CUDA-event times of the ring's forward and of its
   forward + backward on each card, beside whole-sequence K2 and K2 + K3
   on one card;
2. one NCCL all-reduce (SUM) of the ViT-S/16 DINO student's flat f32
   gradient buffer (176.1 MB) over the cards;
3. two data-parallel DINO steps (ViT-S/16 + out_dim 65536, 2 x 224 + 8 x
   96 crops, the global batch 64 split over the cards, adamw without
   warm-up; K4-K6, K1, K7 under make_fused_dino_loss_dp) against the same
   steps on card 0 alone: the losses (1e-3 relative), the first step's
   gradients and the parameters after it whose gradient is above
   rounding level (5e-2 of the tensor's largest value, the pretrain
   phase's limit; `dino_phase` says how the rounding level is read); the
   median step time of five on both;
4. data-parallel extraction (FeatureExtractor(mesh), ViT-S/16 on K1,
   bf16, batch 256 a card, 300 frames of 480x640 a card) frames/s beside
   one card's, the features against one card's (bitwise expected: each
   card runs the one-card kernel on its rows).

Prints the card's name and power limit beside every number.  Fails if a
check fails.  Needs CUDA and at least two cards.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _events_ms(fn, iters=5, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def _say(*a):
    import torch.distributed as dist
    if dist.get_rank() == 0:
        print(*a, flush=True)


def _fail(msg):
    raise SystemExit(f"FAIL: {msg}")


def _max_over_ranks(x: float) -> float:
    import torch
    import torch.distributed as dist
    t = torch.tensor([x], device="cuda")
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.item()


def ring_phase(card, n):
    import torch
    import torch.distributed as dist
    from sais_tpu_torch.kernels.flash_attention import (flash_attention_bwd,
                                                        flash_attention_fwd,
                                                        key_bias)
    from sais_tpu_torch.parallel import mesh as M
    from sais_tpu_torch.parallel.sequence import (ring_attention, seq_group,
                                                  seq_mesh)
    b, h, l, dh = 2, 4, 8193, 96
    g = torch.Generator().manual_seed(41)
    q, k, v, do = (torch.randn((b, h, l, dh), generator=g).cuda()
                   for _ in range(4))
    mask = torch.zeros((b, l), dtype=torch.bool)
    mask[1, l - 700:] = True
    pad = (-l) % n
    bias = key_bias(torch.nn.functional.pad(mask, (0, pad), value=True)
                    .cuda())
    qp, kp, vp, dop = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                       for t in (q, k, v, do))
    mesh = seq_mesh(n)
    group = seq_group(mesh)
    r, lloc = dist.get_rank(group), (l + pad) // n
    part = slice(r * lloc, (r + 1) * lloc)
    ql, kl, vl = (t[:, :, part].contiguous().requires_grad_()
                  for t in (qp, kp, vp))
    bl, dol = bias[:, part].contiguous(), dop[:, :, part].contiguous()

    def fwd():
        with torch.no_grad():
            return ring_attention(ql, kl, vl, bl, group, n)

    def fwd_bwd():
        out = ring_attention(ql, kl, vl, bl, group, n)
        return torch.autograd.grad(out, (ql, kl, vl), dol)

    out = ring_attention(ql, kl, vl, bl, group, n)
    grads = torch.autograd.grad(out, (ql, kl, vl), dol)
    got = [M.all_gather(t.detach().contiguous(), group, dim=2)[:, :, :l]
           for t in (out,) + tuple(grads)]
    ring_fwd = _max_over_ranks(_events_ms(fwd))
    ring_all = _max_over_ranks(_events_ms(fwd_bwd))
    if r == 0:
        bw = key_bias(mask.cuda())
        o, lse = flash_attention_fwd(q, k, v, bw)
        want = [o] + list(flash_attention_bwd(q, k, v, bw, o, lse, do))
        errs = [((x - y).abs().max().item(), y.abs().max().item())
                for x, y in zip(got, want)]
        one_fwd = _events_ms(lambda: flash_attention_fwd(q, k, v, bw))
        one_all = _events_ms(lambda: flash_attention_bwd(
            q, k, v, bw, *flash_attention_fwd(q, k, v, bw), do))
        print(f"ring attention over {n} cards at ({b}, {h}, {l}, {dh}) "
              f"(element 1's last 700 keys masked): " + ", ".join(
                  f"{nm} max|diff| {e:.3g} (max {s:.3g})" for nm, (e, s)
                  in zip(("out", "dq", "dk", "dv"), errs))
              + f"; forward {ring_fwd:.4f} ms, forward + backward "
              f"{ring_all:.4f} ms (slowest card, median of 5); one card "
              f"whole-sequence K2 {one_fwd:.4f} ms, K2 + K3 {one_all:.4f} "
              f"ms; {card}", flush=True)
        for nm, (e, s) in zip(("out", "dq", "dk", "dv"), errs):
            if not e <= 1e-4 * s:
                _fail(f"ring {nm} differs: {e} > 1e-4 * {s}")
    dist.barrier()


def allreduce_phase(card, n):
    import torch
    import torch.distributed as dist
    from sais_tpu_torch.config import ViTConfig
    from sais_tpu_torch.models.dino_head import DINOHead
    from sais_tpu_torch.models.vit import VisionTransformer
    count = sum(p.numel() for p in VisionTransformer(ViTConfig()).parameters())
    count += sum(p.numel() for p in DINOHead(384, 65536).parameters())
    flat = torch.ones(count, device="cuda")
    ms = _max_over_ranks(_events_ms(lambda: dist.all_reduce(flat), 20, 3))
    _say(f"NCCL all-reduce of the ViT-S/16 student's flat gradient buffer "
         f"({count} floats, {4 * count / 1e6:.1f} MB) over {n} cards: "
         f"{ms:.4f} ms (slowest card, median of 20), "
         f"{2 * (n - 1) / n * 4 * count / ms / 1e6:.1f} GB/s bus; {card}")


def _dino(mesh, batch):
    import torch
    from sais_tpu_torch.models import zoo
    from sais_tpu_torch.train.dino import DINOConfig, DINOTrainer
    # adamw, the CLI's default optimizer, without warm-up so that both
    # steps move every weight by about lr
    cfg = DINOConfig(batch_size=batch, drop_path_rate=0.0, warmup_epochs=0)
    return DINOTrainer(zoo.config("vits16"), cfg, niter_per_ep=1000,
                       generator=torch.Generator().manual_seed(0),
                       mesh=mesh)


def _first_grads(tr, crops):
    """The student's gradients of the first step (the whole batch's, summed
    over the ranks under a mesh), without an update: name -> CPU f32."""
    import torch
    from sais_tpu_torch.parallel.mesh import data_sharding
    globals_, locals_ = crops
    if tr.dp is not None:
        sh = data_sharding(tr.mesh)
        globals_ = globals_[sh.rows(globals_.shape[0])]
        locals_ = locals_[sh.rows(locals_.shape[0])]
    tr.loss_and_grads(globals_, locals_, float(tr.temp_sched[0]),
                      torch.Generator(device="cuda").manual_seed(0))
    out = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
           .detach().float().cpu() for n, p in tr.student.named_parameters()}
    for p in tr.student.parameters():
        p.grad = None
    return out


def _two_steps(tr, crops):
    """(losses of two steps, the student's parameters after each)."""
    loss, params = [], []
    for _ in range(2):
        loss.append(tr.step(*crops))
        params.append({n: p.detach().float().cpu()
                       for n, p in tr.student.named_parameters()})
    return loss, params


def dino_phase(card, n):
    """Data-parallel DINO against one card, under adamw.

    What the cards compute is the gradient: the first step's gradients
    are held to one card's, each tensor within 5e-2 of its largest
    |gradient| (the pretrain phase's limit), beside the same reading for
    one card with the images in another order (the same loss, its sums
    in another order).  adamw's first step then moves each weight by
    about lr times the sign of its gradient, so an element whose gradient
    is at rounding level (the key bias's is zero in exact arithmetic) may
    step either way in two runs that differ only in summation order.  The
    rounding level of a tensor is the larger of the two runs' max|grad
    difference| from one card's; after the first step, the elements above
    10x it are held to 5e-2 of the tensor's largest value.  After the
    second step every gradient has moved with the first step's noise:
    the worst tensors are printed beside the permuted run's, with their
    share of elements at rounding level."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from sais_tpu_torch.ops.augment import multi_crop_batch
    from sais_tpu_torch.parallel.mesh import make_mesh
    frames = np.random.default_rng(0).integers(0, 256, (64, 240, 320, 3),
                                               dtype=np.uint8)
    images = torch.from_numpy(frames).cuda().float() / 255.0
    crops = multi_crop_batch(torch.Generator(device="cuda").manual_seed(1),
                             images, 2, 8, 224, 96)
    tr = _dino(make_mesh(), 64)
    g_dp = _first_grads(tr, crops)
    loss, p_dp = _two_steps(tr, crops)
    step_ms = _max_over_ranks(_events_ms(lambda: tr.step(*crops), 5, 1))
    del tr
    torch.cuda.empty_cache()
    if dist.get_rank() == 0:
        one = _dino(None, 64)
        g_one = _first_grads(one, crops)
        one_loss, p_one = _two_steps(one, crops)
        one_ms = _events_ms(lambda: one.step(*crops), 5, 1)
        del one
        torch.cuda.empty_cache()
        order = torch.randperm(64, generator=torch.Generator().manual_seed(2))
        permuted = tuple(x.reshape(64, -1, *x.shape[1:])[order.cuda()]
                         .reshape(x.shape) for x in crops)
        perm = _dino(None, 64)
        g_perm = _first_grads(perm, permuted)
        perm_loss, p_perm = _two_steps(perm, permuted)
        del perm
        torch.cuda.empty_cache()

        def dev(a, b):
            return (a - b).abs().max().item()

        grad_dp = grad_perm = (0.0, "")
        held, rows = (0.0, ""), []
        for name, g in g_one.items():
            gmax = max(g.abs().max().item(), 1e-30)
            e_dp, e_perm = dev(g_dp[name], g), dev(g_perm[name], g)
            grad_dp = max(grad_dp, (e_dp / gmax, name))
            grad_perm = max(grad_perm, (e_perm / gmax, name))
            above = g.abs() > 10 * max(e_dp, e_perm)
            first = p_one[0][name]
            if above.any():
                held = max(held, ((p_dp[0][name] - first).abs()[above].max()
                                  .item() / max(first.abs().max().item(),
                                                1e-30), name))
            scale = max(p_one[1][name].abs().max().item(), 1e-30)
            rows.append((dev(p_dp[1][name], p_one[1][name]) / scale,
                         dev(p_perm[1][name], p_one[1][name]) / scale,
                         name, gmax, e_dp, e_perm,
                         1.0 - above.float().mean().item()))
        rows.sort(reverse=True)
        rel = max(abs(a - b) / abs(b) for a, b in zip(loss, one_loss))
        print(f"DINO steps, ViT-S/16 + out_dim 65536, global batch 64 over "
              f"{n} cards ({64 // n} images a card), adamw without warm-up: "
              f"losses {loss} against one card's {one_loss} (worst rel "
              f"{rel:.3g}; one card, images permuted: {perm_loss}); step "
              f"{step_ms:.2f} ms (slowest card, median of 5) against one "
              f"card's {one_ms:.2f} ms; {card}", flush=True)
        print(f"  first step's gradients, worst max|diff| / max|grad| of a "
              f"tensor: over the cards {grad_dp[0]:.3g} ({grad_dp[1]}; "
              f"limit 5e-2), one card permuted {grad_perm[0]:.3g} "
              f"({grad_perm[1]}); after the first step, elements above 10x "
              f"their tensor's rounding level: worst max|diff| / max|value| "
              f"{held[0]:.3g} ({held[1]}; limit 5e-2)", flush=True)
        print("  after the second step, the worst tensors, max|diff| / "
              "max|value| from one card's: over the cards | one card "
              "permuted; first step's max|grad|, max|grad diff| over the "
              "cards | permuted, share of elements at or below 10x the "
              "larger", flush=True)
        for d, dperm, name, gmax, e_dp, e_perm, low in rows[:8]:
            print(f"  {name}: {d:.3g} | {dperm:.3g}; max|grad| {gmax:.3g}, "
                  f"diff {e_dp:.3g} | {e_perm:.3g}, at rounding level "
                  f"{100 * low:.2f}%", flush=True)
        print(f"  tensors over 5e-2 after the second step: over the cards "
              f"{sum(r[0] > 5e-2 for r in rows)}, one card permuted "
              f"{sum(r[1] > 5e-2 for r in rows)}, of {len(rows)}",
              flush=True)
        if not rel <= 1e-3:
            _fail(f"DINO loss differs: {loss} vs {one_loss}")
        if not grad_dp[0] <= 5e-2:
            _fail(f"DINO gradients differ: {grad_dp}")
        if not held[0] <= 5e-2:
            _fail(f"DINO parameters above rounding level differ: {held}")
    dist.barrier()


def extract_phase(card, n):
    import copy
    import numpy as np
    import torch
    import torch.distributed as dist
    from sais_tpu_torch.config import PipelineConfig
    from sais_tpu_torch.infer.pipeline import FeatureExtractor
    from sais_tpu_torch.models.vit import vit_init
    from sais_tpu_torch.parallel.mesh import make_mesh
    cfg = PipelineConfig()
    vit = vit_init(torch.Generator().manual_seed(0), cfg.vit)
    frames = np.random.default_rng(0).integers(
        0, 256, (300 * n, 480, 640, 3), dtype=np.uint8)
    fx = FeatureExtractor(copy.deepcopy(vit), cfg, batch_size=256 * n,
                          mesh=make_mesh())

    def timed(ex):
        ex.extract_array(frames)
        torch.cuda.synchronize()
        runs = []
        for _ in range(3):
            t = time.perf_counter()
            out = ex.extract_array(frames)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t)
        return out, sorted(runs)[1]

    feats, dt = timed(fx)
    dt = _max_over_ranks(dt)
    if dist.get_rank() == 0:
        one, one_dt = timed(FeatureExtractor(vit, cfg, batch_size=256))
        diff = float(np.abs(feats - one).max())
        print(f"extraction over {n} cards: {len(frames)} frames of 480x640 "
              f"in {dt:.3f} s ({len(frames) / dt:.1f} frames/s, slowest "
              f"card, median of 3) against one card's {one_dt:.3f} s "
              f"({len(frames) / one_dt:.1f} frames/s); features "
              f"max|diff| {diff:.3g} from one card's; {card}", flush=True)
        if diff != 0.0:
            _fail(f"extraction over cards differs: {diff}")
    dist.barrier()


PHASES = {"ring": ring_phase, "allreduce": allreduce_phase,
          "dino": dino_phase, "extract": extract_phase}


def body(card, n, names):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    for phase in (PHASES[name] for name in names):
        t = time.time()
        phase(card, n)
        _say(f"{phase.__name__}: {time.time() - t:.1f} s")


def main():
    import argparse
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        raise SystemExit("needs CUDA and at least two cards")
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cards", type=int, default=torch.cuda.device_count())
    p.add_argument("--phases", default=",".join(PHASES),
                   help="comma-separated, of " + ", ".join(PHASES))
    args = p.parse_args()
    n, names = args.cards, args.phases.split(",")
    unknown = set(names) - set(PHASES)
    if unknown:
        p.error(f"unknown phases {sorted(unknown)}")
    card = _card()
    print(card, flush=True)
    from sais_tpu_torch.kernels import _build
    _build.build()
    from sais_tpu_torch.parallel.distributed import run_ranks
    t = time.time()
    run_ranks(body, n, "cuda", card, n, names)
    print(f"total {time.time() - t:.1f} s over {n} cards", flush=True)


if __name__ == "__main__":
    main()
