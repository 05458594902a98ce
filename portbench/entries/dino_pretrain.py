"""DINO pre-training: `DINOTrainer.step_async` in a closed loop with one
step in flight, each step's loss fetched after the next is enqueued, as
`pretrain` runs it; on several cards every rank steps on its block of
the batch (`--data-parallel`).

Traffic: `batch` images a step (the whole batch, over every rank) from
a pool of `pool_frames` uint8 frames of `frame_height` x `frame_width`
drawn from the seed on the device (`frames.draw`, `frame_grid` and
`frame_octaves`).  Each step of the window picks its frames from the
pool and makes its crops with the program's
`ops.augment.multi_crop_batch`, from a generator seeded with the seed
and the step, as `pretrain` does.  The units are images.

`correct`: set-up builds the trainer once, from weights drawn on the
device (the teacher is the student plus small noise, as a teacher some
way into training differs from its student), resumed at `start_epoch`,
and runs its first three steps through `step()` on crops that the
benchmark makes itself, so that the reference can make the same ones
(per image `n_global_crops` random resized crops to the global size and
`n_local_crops` to the local size, area fractions in `global_scale` /
`local_scale`, aspect ratio log-uniform in [3/4, 4/3], a horizontal flip
with probability one half, normalized, image-major rows).  After the
window the reference (`reference.dino.step`) follows them from the same
weights and crops.  Compared: each step's loss, the first step's
gradient as AdamW got it (its first moment over 1 - beta1) by the worst
leaf's norm gap and by the worst leaf's distance, the change of the
student and of the teacher over the three steps (worst leaf's norm gap)
and the center after them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench import compare, flops, frames, weights
from portbench.reference import dino as ref_dino
from portbench.reference.precision import float32_exact

FIRST_STEPS = 3
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
TEACHER_NOISE = 0.002


def head_rule(name, shapes):
    if name.endswith("bias"):
        return ("zeros",)
    if name.endswith("last_g"):
        return ("ones",)
    return ("normal", 0.02)


def student_rule(name, shapes):
    if name.startswith("backbone."):
        return weights.vit_rule(name[len("backbone."):])
    return head_rule(name, shapes)


def crops(gen, images, n_crops, size, scale):
    """n_crops random resized crops of every image (B, 3, H, W) float,
    image-major rows -> (B * n_crops, size, size, 3) normalized."""
    b, _, h, w = images.shape
    n = b * n_crops
    dev = images.device

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)

    area = u(*scale)
    ratio = torch.exp(u(math.log(3 / 4), math.log(4 / 3)))
    # crop width and height as fractions of the frame's
    cw = torch.sqrt(area * ratio * h / w).clamp(max=1.0)
    ch = torch.sqrt(area / ratio * w / h).clamp(max=1.0)
    cx = (1 - cw) * (2 * u(0, 1) - 1)
    cy = (1 - ch) * (2 * u(0, 1) - 1)
    flip = torch.where(u(0, 1) < 0.5, -1.0, 1.0)
    theta = torch.zeros((n, 2, 3), device=dev)
    theta[:, 0, 0] = cw * flip
    theta[:, 0, 2] = cx
    theta[:, 1, 1] = ch
    theta[:, 1, 2] = cy
    grid = F.affine_grid(theta, (n, 3, size, size), align_corners=False)
    src = images.repeat_interleave(n_crops, dim=0)
    x = F.grid_sample(src, grid, mode="bilinear", align_corners=False)
    x = x.permute(0, 2, 3, 1)
    return ((x - torch.tensor(MEAN, device=dev))
            / torch.tensor(STD, device=dev)).contiguous()


class Cell:
    def __init__(self, spec, seed, device, mesh=None):
        self.cfg, self.tr, self.cell = spec["config"], spec["traffic"], \
            spec["cell"]
        self.seed, self.device, self.mesh = seed, device, mesh
        self.attempted = self.failed = 0
        self.i = 0
        self.pending = None
        self.losses = []
        self._ref = None
        d = dict(self.cfg["dino"])
        v = dict(self.cfg["vit"], mlp_dim=int(self.cfg["vit"]["embed_dim"]
                                             * self.cfg["vit"]["mlp_ratio"]))
        self.image_flops = flops.dino_image(v, d)

    def _trainer(self):
        from sais_tpu_torch.config import ViTConfig
        from sais_tpu_torch.train.dino import DINOConfig, DINOTrainer
        d = self.cfg["dino"]
        keys = [f.name for f in DINOConfig.__dataclass_fields__.values()]
        dcfg = DINOConfig(**{k: d[k] for k in keys if k in d},
                          batch_size=self.tr["batch"])
        return DINOTrainer(ViTConfig(**self.cfg["vit"]), dcfg,
                           niter_per_ep=d["niter_per_ep"],
                           generator=torch.Generator().manual_seed(0),
                           optimizer=d["optimizer"], mesh=self.mesh,
                           device=self.device)

    def _crop_batches(self, gen):
        """The first steps' crops, made by the benchmark."""
        tr, d = self.tr, self.cfg["dino"]
        out = []
        for _ in range(FIRST_STEPS):
            pick = torch.randint(0, tr["pool_frames"], (tr["batch"],),
                                 generator=gen, device=self.device)
            src = self.frames[pick].permute(0, 3, 1, 2).float() / 255.0
            out.append((crops(gen, src, d["n_global_crops"],
                              d["global_size"], tr["global_scale"]),
                        crops(gen, src, d["n_local_crops"], d["local_size"],
                              tr["local_scale"])))
        return out

    def _window_batch(self):
        """The window's crops: frames picked from the pool, then
        `multi_crop_batch` with a generator of this seed and step."""
        from sais_tpu_torch.ops.augment import multi_crop_batch
        d = self.cfg["dino"]
        pick = torch.from_numpy(self.rng.integers(
            0, self.tr["pool_frames"], self.tr["batch"])).to(self.device)
        images = self.frames[pick].float() / 255.0
        gen = torch.Generator(device=self.device).manual_seed(
            (self.seed * 1_000_003 + self.i) % 2 ** 63)
        return multi_crop_batch(gen, images, d["n_global_crops"],
                                d["n_local_crops"], d["global_size"],
                                d["local_size"])

    def setup(self):
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.rng = np.random.default_rng(self.seed)
        self.trainer = tr = self._trainer()
        self.parts.mark("trainer (its own weights on the CPU)")
        shapes = weights.module_shapes(tr.student)
        s0 = weights.draw(shapes, student_rule, gen)
        noise = weights.draw(shapes, lambda n, s: ("normal", TEACHER_NOISE),
                             gen)
        t0 = {n: s0[n] + noise[n] if not n.endswith("last_g") else s0[n]
              for n in s0}
        del noise
        weights.load(tr.student, s0)
        weights.load(tr.teacher, t0)
        d = self.cfg["dino"]
        self.start = tr.step_idx = d["start_epoch"] * d["niter_per_ep"]
        self.parts.mark("weights")
        f = self.tr
        self.frames = frames.draw(gen, f["pool_frames"], f["frame_height"],
                                  f["frame_width"], f["frame_grid"],
                                  f["frame_octaves"])
        self.batches = self._crop_batches(gen)
        self.parts.mark("frames, crops")
        self.s0 = {n: t.to("cpu", copy=True) for n, t in s0.items()}
        self.t0 = {n: t.to("cpu", copy=True) for n, t in t0.items()}
        del s0, t0
        for k in range(FIRST_STEPS):
            self.step()
            self.finish()
            if k == 0:
                b1 = 0.9
                self.g1 = {n: (m / (1 - b1)).cpu()
                           for n, m in tr.opt_state["mu"].items()}
        self.s3 = {n: p.detach().to("cpu", copy=True) for n, p in
                   tr.student.named_parameters()}
        self.t3 = {n: p.detach().to("cpu", copy=True) for n, p in
                   tr.teacher.named_parameters()}
        self.c3 = tr.center.detach().to("cpu", copy=True)
        self.first_losses = list(self.losses)
        # the window's feed once, so that its shapes are warm
        self.step()
        self.finish()
        self.attempted = 0
        self.parts.mark("first steps, snapshots, warm-up")

    def step(self) -> float:
        if self.i < FIRST_STEPS:
            g, loc = self.batches[self.i]
        else:
            g, loc = self._window_batch()
        loss = self.trainer.step_async(g, loc)
        if self.pending is not None:
            self._fetch()
        self.pending = loss
        self.i += 1
        self.attempted += 1
        return float(self.tr["batch"])

    def _fetch(self):
        loss = float(self.pending)
        self.losses.append(loss)
        self.failed += int(not np.isfinite(loss))
        self.pending = None

    def finish(self) -> float:
        if self.pending is not None:
            self._fetch()
        return 0.0

    def useful_flops(self, units: float) -> float:
        return units * self.image_flops

    def release(self):
        del self.trainer

    def _rank(self):
        if self.mesh is None:
            return 0, 1, None
        import torch.distributed as dist

        def all_sum(t):
            t = t.contiguous()
            dist.all_reduce(t)
            return t
        return dist.get_rank(), dist.get_world_size(), all_sum

    def reference(self, rnd=None):
        """The reference's three steps on this rank's rows; (losses, first
        gradients, student, teacher, center) after them."""
        d = dict(self.cfg["dino"])
        rank, n, all_sum = self._rank()
        dev = self.device
        s = {k: t.to(dev) for k, t in self.s0.items()}
        t = {k: v.to(dev) for k, v in self.t0.items()}
        center = torch.zeros(d["out_dim"], device=dev)
        opt = ref_dino.fresh_opt(s, d["norm_last_layer"])
        losses, g1 = [], None
        ng, nl = d["n_global_crops"], d["n_local_crops"]
        per = self.tr["batch"] // n
        with float32_exact():
            for k in range(FIRST_STEPS):
                g, loc = self.batches[k]
                idx = self.start + k
                loss, grads, s, t, center, opt = ref_dino.step(
                    s, t, center, opt,
                    g[rank * per * ng:(rank + 1) * per * ng],
                    loc[rank * per * nl:(rank + 1) * per * nl], idx,
                    idx * n + rank, self.cfg["vit"], d, self.tr["batch"],
                    chunk=self.cell["ref_chunk"], rnd=rnd, all_sum=all_sum)
                losses.append(loss)
                if k == 0:
                    g1 = {k2: v.cpu() for k2, v in grads.items()}
        return (losses, g1, {k: v.cpu() for k, v in s.items()},
                {k: v.cpu() for k, v in t.items()}, center.cpu())

    def check(self, got=None):
        """got: (losses, first gradients, student, teacher, center after
        three steps) in the program's place (a control); default the
        program's own."""
        if self._ref is None:
            self._ref = self.reference()
        losses, g1, s3, t3, c3 = self._ref
        if self._rank()[0] != 0:
            return []
        if got is None:
            got = (self.first_losses, self.g1, self.s3, self.t3, self.c3)
        p_loss, p_g1, p_s3, p_t3, p_c3 = got
        quiet = compare.quiet_leaves(g1)
        lim = self.cell["limits"]
        keep = list(g1)
        return [
            ("loss_gap", max(compare.rel_gap(a, r)
                             for a, r in zip(p_loss, losses)),
             lim["loss_gap"]),
            ("grad_gap", compare.norm_gap({k: p_g1[k] for k in keep}, g1,
                                          quiet), lim["grad_gap"]),
            ("grad_dist", compare.dist_gap({k: p_g1[k] for k in keep}, g1,
                                           quiet), lim["grad_dist"]),
            ("change_gap", compare.norm_gap(
                {k: p_s3[k] - self.s0[k] for k in keep},
                {k: s3[k] - self.s0[k] for k in keep}, quiet),
             lim["change_gap"]),
            ("teacher_change_gap", compare.norm_gap(
                {k: p_t3[k] - self.t0[k] for k in keep},
                {k: t3[k] - self.t0[k] for k in keep}, quiet),
             lim["teacher_change_gap"]),
            ("center_gap", float((p_c3 - c3).norm() / c3.norm()),
             lim["center_gap"])]

    def control(self):
        """The reference with every product's operands in float8 e4m3 (the
        step below the blocks' stated bf16) in the program's place."""
        from portbench.reference.precision import fp8_e4m3
        return self.check(self.reference(rnd=fp8_e4m3))
