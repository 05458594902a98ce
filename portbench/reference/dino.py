"""DINO's training step (main_dino.py `train_one_epoch`, DINOLoss,
DINOHead; utils.py cosine_scheduler, clip_gradients,
cancel_gradients_last_layer), float32, on the crops the benchmark made:

- the student (ViT with stochastic depth, then the head) over every crop,
  the teacher over the global crops without gradient;
- the DINO loss: the teacher's softmax of (t - center) / temp against the
  student's log-softmax of s / 0.1, over every pair of a global crop and
  another crop, averaged over the images of the whole batch;
- per-tensor gradient clipping, the last layer's gradient cancelled during
  the first epochs, AdamW with the scheduled lr and weight decay (no
  decay on biases and other 1-d tensors), the teacher's EMA with the
  scheduled momentum, the center's EMA of the teacher's batch mean.

The student's stochastic depth draws per-image survivor scales from a
generator seeded with the step (the same draws as the program makes:
`drop_path_draws`).  The batch runs in chunks of images with the
gradients accumulated, so that float32 fits; with `all_sum` (a sum over
every rank) each rank runs its own images and the sums span the batch.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import vit as ref_vit
from portbench.reference.precision import Round, linear, mm

Weights = Dict[str, torch.Tensor]


def cosine_at(base: float, final: float, epochs: int, niter: int,
              warmup_epochs: int, i: int, start_warmup: float = 0.0
              ) -> float:
    """utils.cosine_scheduler(...)[i]."""
    warmup = warmup_epochs * niter
    if i < warmup:
        return start_warmup + (base - start_warmup) * i / max(warmup - 1, 1)
    n = epochs * niter - warmup
    return final + 0.5 * (base - final) * (
        1 + math.cos(math.pi * (i - warmup) / n))


def schedule(d: dict, batch: int, i: int) -> Tuple[float, float, float,
                                                    float, int]:
    """(lr, weight decay, teacher momentum, teacher temperature, epoch) of
    iteration i."""
    niter, epochs = d["niter_per_ep"], d["epochs"]
    lr = cosine_at(d["lr"] * batch / 256.0, d["min_lr"], epochs, niter,
                   d["warmup_epochs"], i)
    wd = cosine_at(d["weight_decay"], d["weight_decay_end"], epochs, niter,
                   0, i)
    mom = cosine_at(d["momentum_teacher"], 1.0, epochs, niter, 0, i)
    epoch = i // niter
    w = d["warmup_teacher_temp_epochs"]
    temp = (d["warmup_teacher_temp"] + (d["teacher_temp"]
            - d["warmup_teacher_temp"]) * epoch / max(w - 1, 1)
            if epoch < w else d["teacher_temp"])
    return lr, wd, mom, temp, epoch


def drop_path_draws(generator: torch.Generator, rate: float, depth: int,
                    b: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Two (B,) survivor scales a block, floor(keep + U) / keep at
    keep = 1 - rate * i / (depth - 1) (vision_transformer.py drop_path)."""
    out = []
    for i in range(depth):
        keep = 1.0 - rate * i / max(depth - 1, 1)
        pair = []
        for _ in range(2):
            u = torch.rand((b,), generator=generator, dtype=torch.float32,
                           device=generator.device)
            pair.append(torch.floor(keep + u) / keep)
        out.append(tuple(pair))
    return out


def head(w: Weights, x: torch.Tensor, norm_last_layer: bool,
         rnd: Round = None) -> torch.Tensor:
    """DINOHead: three linears with GELU between, L2 row normalisation,
    the weight-normed last layer (one unit column a prototype, times g
    unless norm_last_layer)."""
    for i in range(3):
        x = linear(x, w[f"head.mlp.{i}.weight"], w[f"head.mlp.{i}.bias"],
                   rnd)
        if i < 2:
            x = F.gelu(x)
    x = F.normalize(x, dim=-1, p=2)
    v = w["head.last_v"]
    wn = v / v.norm(dim=0, keepdim=True)
    if not norm_last_layer:
        wn = wn * w["head.last_g"]
    return mm(x, wn, rnd)


def _backbone(w: Weights) -> Weights:
    return {k[len("backbone."):]: t for k, t in w.items()
            if k.startswith("backbone.")}


def step(student: Weights, teacher: Weights, center: torch.Tensor,
         opt: dict, globals_: torch.Tensor, locals_: torch.Tensor,
         index: int, draw_seed: int, vcfg: dict, d: dict, batch: int,
         chunk: int = 8, rnd: Round = None,
         all_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """One step over this rank's crops (image-major rows: img0's crops,
    then img1's, ...) of a batch of `batch` images.  Returns (loss, the
    gradients as the optimizer gets them, student, teacher, center, opt)
    with the new state."""
    ng, nl = d["n_global_crops"], d["n_local_crops"]
    lr, wd, mom, temp, epoch = schedule(d, batch, index)
    nll = d["norm_last_layer"]
    b = globals_.shape[0] // ng
    gen = torch.Generator(device=globals_.device).manual_seed(draw_seed)
    sg = drop_path_draws(gen, d["drop_path_rate"], vcfg["depth"], b * ng)
    sl = drop_path_draws(gen, d["drop_path_rate"], vcfg["depth"], b * nl)
    trainable = {n: t for n, t in student.items()
                 if not (nll and n == "head.last_g")}
    params = {n: t.detach().clone().requires_grad_(True)
              for n, t in trainable.items()}
    s_w = {**student, **params}
    n_terms = ng * (ng + nl - 1)
    loss_sum = torch.zeros((), device=center.device)
    center_sum = torch.zeros_like(center)
    for c0 in range(0, b, chunk):
        c1 = min(b, c0 + chunk)
        g = globals_[c0 * ng:c1 * ng]
        loc = locals_[c0 * nl:c1 * nl]
        with torch.no_grad():
            t_out = head(teacher, ref_vit.features(_backbone(teacher), g,
                                                   vcfg, rnd=rnd), nll, rnd)
            center_sum += t_out.sum(0)
            q = torch.softmax((t_out - center) / temp, -1).reshape(
                c1 - c0, ng, -1)
        cut = [(x[c0 * ng:c1 * ng], y[c0 * ng:c1 * ng]) for x, y in sg]
        s_g = head(s_w, ref_vit.features(_backbone(s_w), g, vcfg, cut, rnd),
                   nll, rnd).reshape(c1 - c0, ng, -1)
        cut = [(x[c0 * nl:c1 * nl], y[c0 * nl:c1 * nl]) for x, y in sl]
        s_l = head(s_w, ref_vit.features(_backbone(s_w), loc, vcfg, cut,
                                         rnd), nll, rnd).reshape(
            c1 - c0, nl, -1)
        logp = torch.log_softmax(
            torch.cat([s_g, s_l], 1) / d["student_temp"], -1)
        per_image = -(q.sum(1) * logp.sum(1)).sum(-1)
        for iq in range(ng):
            per_image = per_image + (q[:, iq] * logp[:, iq]).sum(-1)
        part = per_image.sum() / (batch * n_terms)
        part.backward()
        loss_sum += part.detach()
    grads = {n: p.grad.detach() for n, p in params.items()}
    if all_sum is not None:
        loss_sum = all_sum(loss_sum)
        center_sum = all_sum(center_sum)
        grads = {n: all_sum(g) for n, g in grads.items()}
    with torch.no_grad():
        for n, g in grads.items():
            coef = d["clip_grad"] / (g.norm() + 1e-6)
            if coef < 1:
                grads[n] = g * coef
        if epoch < d["freeze_last_layer_epochs"]:
            for n in ("head.last_v", "head.last_g"):
                if n in grads:
                    grads[n] = torch.zeros_like(grads[n])
        count = opt["count"] + 1
        c1_, c2_ = 1 - 0.9 ** count, 1 - 0.999 ** count
        mu, nu, new_student = {}, {}, dict(student)
        for n, g in grads.items():
            mu[n] = 0.9 * opt["mu"][n] + 0.1 * g
            nu[n] = 0.999 * opt["nu"][n] + 0.001 * g * g
            upd = (mu[n] / c1_) / ((nu[n] / c2_).sqrt() + 1e-8)
            p = student[n]
            decay = wd if p.dim() > 1 else 0.0
            new_student[n] = p - lr * upd - lr * decay * p
        new_teacher = {n: mom * teacher[n] + (1 - mom) * new_student[n]
                       for n in teacher}
        new_center = center * d["center_momentum"] + (
            center_sum / (ng * batch)) * (1 - d["center_momentum"])
    opt = {"count": count, "mu": mu, "nu": nu}
    return (float(loss_sum), grads, new_student, new_teacher, new_center,
            opt)


def fresh_opt(student: Weights, norm_last_layer: bool) -> dict:
    zeros = {n: torch.zeros_like(t) for n, t in student.items()
             if not (norm_last_layer and n == "head.last_g")}
    return {"count": 0, "mu": zeros,
            "nu": {n: torch.zeros_like(t) for n, t in zeros.items()}}
