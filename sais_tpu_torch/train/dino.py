"""DINO self-distillation pre-training (dino-main/main_dino.py, utils.py).

Counterpart of `sais_tpu/train/dino.py`, in eager PyTorch on one device
(the card unless `device='cpu'`):

- student / teacher pairs of (ViT backbone + DINOHead), the teacher an EMA
  of the student with a cosine momentum schedule 0.996 -> 1
  (main_dino.py:563-567, 452-456);
- the DINO loss (main_dino.py:581-634) in its 3-pass form, teacher
  centering with a warmed-up temperature, the center an EMA (0.9) of the
  teacher's batch mean;
- cosine lr / wd schedules with linear warmup (utils.py:187-199), base lr
  scaled by batch / 256 (main_dino.py:440);
- per-parameter gradient clipping at 3.0 (utils.clip_gradients) and the
  last layer's gradient cancelled during the first freeze_last_layer epochs;
- unit-lr optimizers (own copies of optax's `adamw(1.0, weight_decay=0)`,
  `sgd(1.0, momentum=0.9)` and `lars(1.0)`), the scheduled lr and the
  decoupled weight decay on tensors of rank > 1 applied outside them
  (`p + lr u - lr wd p`, utils.py:202-212);
- stochastic depth on the student (drop_path_rate 0.1), per-step draws
  from a generator seeded with the step index.

With `fused_blocks` (the default on the card at batch >= 32) the student
backbone runs on K4 / K5 / K6 (`vit_features_trainable_fused`) and the
teacher on K1 (`vit_forward_fused`), at any zoo geometry (the patch-8
ones' 785-token global crops on the kernels' key-tiled attention);
otherwise both run the plain bf16 path (`vit_forward_train`).  With
`fused_loss` (the default on the card, JAX's auto rule) the head's
bottleneck runs per resolution group and the weight-normed last layer and
the loss run as K7
(`kernels.dino_head_loss.FusedDinoLoss`), which keeps the (rows, out_dim)
logits out of device memory; otherwise the head and loss are plain
PyTorch.  With `use_bn_in_head` both heads run their BatchNorms in train
mode over all their rows at once (the student's every crop, the
teacher's globals), the plain head and loss always; the running
statistics (`student_bn`, `teacher_bn`) leave the gradient, are never
EMA'd, and travel in `state()`.

With a `mesh` (data parallel, JAX's sharded jit step) each rank takes
its block of the crops (whole images, image-major) and runs the
backbones on them; K7 runs on its rows under `make_fused_dino_loss_dp`
(the loss and the batch center summed over the ranks, dh_s local), the
plain loss and a BatchNorm head take their sums over every rank's rows,
and the gradients are summed in one flat buffer before the clipping
(`parallel.mesh.DataParallel`).  Every rank applies the same update and
the same teacher EMA.  The batch must divide over the shards.

Crops are batched per resolution group, image-major ([img0 crop0, img0
crop1, ...], `ops.augment.multi_crop_batch`'s layout), so the backbone runs
twice a step (globals, locals).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import numpy as np
import torch
import torch.nn as nn

from sais_tpu_torch import DeviceLike, resolve_device
from sais_tpu_torch.config import ViTConfig
from sais_tpu_torch.kernels.dino_head_loss import (build_pair_structure,
                                                   make_fused_dino_loss,
                                                   make_fused_dino_loss_dp)
from sais_tpu_torch.models.dino_head import (dino_head_bn_init,
                                             dino_head_bottleneck,
                                             dino_head_init,
                                             dino_last_layer)
from sais_tpu_torch.models.vit import (vit_features_trainable_fused,
                                       vit_forward_fused, vit_forward_train,
                                       vit_init)

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DINOConfig:
    """Defaults = reference argparse defaults (main_dino.py:47-142)."""

    out_dim: int = 65536
    n_global_crops: int = 2
    n_local_crops: int = 8
    global_size: int = 224
    local_size: int = 96
    student_temp: float = 0.1
    warmup_teacher_temp: float = 0.04
    teacher_temp: float = 0.04
    warmup_teacher_temp_epochs: int = 0
    center_momentum: float = 0.9
    momentum_teacher: float = 0.996
    lr: float = 0.0005            # scaled by batch/256
    min_lr: float = 1e-6
    warmup_epochs: int = 10
    weight_decay: float = 0.04
    weight_decay_end: float = 0.4
    clip_grad: float = 3.0
    freeze_last_layer_epochs: int = 1
    epochs: int = 100
    batch_size: int = 64
    norm_last_layer: bool = True
    drop_path_rate: float = 0.1   # student only (main_dino.py:111, 369)
    use_bn_in_head: bool = False


def cosine_scheduler(base: float, final: float, epochs: int,
                     niter_per_ep: int, warmup_epochs: int = 0,
                     start_warmup_value: float = 0.0) -> np.ndarray:
    """utils.cosine_scheduler (dino-main/utils.py:187-199)."""
    warmup_iters = warmup_epochs * niter_per_ep
    if warmup_iters > epochs * niter_per_ep:
        raise ValueError(
            f"warmup_epochs={warmup_epochs} exceeds epochs={epochs}; "
            "reduce warmup (the CLI clamps it to min(10, nepochs // 10))")
    warmup = np.linspace(start_warmup_value, base, warmup_iters)
    iters = np.arange(epochs * niter_per_ep - warmup_iters)
    sched = final + 0.5 * (base - final) * (
        1 + np.cos(np.pi * iters / max(len(iters), 1)))
    return np.concatenate([warmup, sched])


def teacher_temp_schedule(cfg: DINOConfig, epochs: int) -> np.ndarray:
    """DINOLoss teacher temp: linear warmup then constant
    (main_dino.py:594-599)."""
    w = cfg.warmup_teacher_temp_epochs
    return np.concatenate([
        np.linspace(cfg.warmup_teacher_temp, cfg.teacher_temp, w),
        np.full(max(epochs - w, 0), cfg.teacher_temp)])


def dino_loss(student_out: Sequence[torch.Tensor],
              teacher_out: Sequence[torch.Tensor], center: torch.Tensor,
              teacher_temp: float, student_temp: float = 0.1,
              total: Optional[Callable] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DINOLoss.forward (main_dino.py:601-621): (loss, batch center mean).

    student_out: list over crops of (B, K) logits; teacher_out: list over
    global crops.  The reference's double loop sums -q_iq . logp_v over
    every pair with v != iq; this is the same sum in 3 passes:
    -(sum_iq q_iq) . (sum_v logp_v) + sum_iq q_iq . logp_iq.

    total: turns a sum over these images into one over the whole batch (a
    data-parallel rank's `DataParallel.total`): the mean over images and
    the batch center then span every rank's."""
    q = [torch.softmax((t.float() - center) / teacher_temp, -1).detach()
         for t in teacher_out]
    logp = [torch.log_softmax(s.float() / student_temp, -1)
            for s in student_out]
    s_sum = sum(logp[1:], logp[0])
    q_sum = sum(q[1:], q[0])
    per_elem = -q_sum * s_sum
    for iq in range(len(q)):
        per_elem = per_elem + q[iq] * logp[iq]
    n_terms = len(q) * (len(student_out) - 1)
    teacher = torch.cat([t.detach().float() for t in teacher_out], 0)
    if total is None:
        return per_elem.sum(-1).mean() / n_terms, teacher.mean(0)
    count = total(torch.tensor([float(per_elem.shape[0]),
                                float(teacher.shape[0])],
                               device=teacher.device))
    return (total(per_elem.sum(-1).sum()) / (count[0] * n_terms),
            total(teacher.sum(0)) / count[1])


def plain_head_loss(hs, vs, gs, ht, vt, gt, center, teacher_temp, *,
                    n_global: int, n_local: int, student_temp: float,
                    norm_last_layer: bool = True,
                    total: Optional[Callable] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unfused counterpart of K7, with its arguments (hs, vs, gs, ht,
    vt, gt, center, temp_t): the bf16 last layers of student and teacher
    on the bottleneck outputs (rows image-major, globals first; ht holds
    the global crops), the regroup into one (B, out_dim) logit block per
    crop, `dino_loss`.  The (rows, out_dim) logits are materialised."""

    def regroup(o, n):   # image-major rows -> one (B, K) per crop
        return list(o.reshape(o.shape[0] // n, n, o.shape[-1])
                    .transpose(0, 1))

    s_out = dino_last_layer(hs, vs, gs, norm_last_layer)
    t_out = dino_last_layer(ht, vt, gt, norm_last_layer)
    n_gr = ht.shape[0]
    souts = regroup(s_out[:n_gr], n_global)
    if s_out.shape[0] > n_gr:
        souts += regroup(s_out[n_gr:], n_local)
    return dino_loss(souts, regroup(t_out, n_global), center, teacher_temp,
                     student_temp, total)


def update_center(center: torch.Tensor, batch_center: torch.Tensor,
                  momentum: float = 0.9) -> torch.Tensor:
    """EMA center update (main_dino.py:624-634)."""
    return center * momentum + batch_center * (1 - momentum)


@torch.no_grad()
def ema_update(teacher: nn.Module, student: nn.Module,
               momentum: float) -> None:
    """EMA teacher update in place (main_dino.py:563-567)."""
    for t, s in zip(teacher.parameters(), student.parameters()):
        t.copy_(t * momentum + s * (1.0 - momentum))


def clip_gradients_per_param(grads: Tensors, clip: float) -> Tensors:
    """utils.clip_gradients (utils.py:132-142): each tensor scaled on its
    own when its norm exceeds clip."""
    out = {}
    for name, g in grads.items():
        coef = torch.clamp(clip / (torch.linalg.vector_norm(g) + 1e-6),
                           max=1.0)
        out[name] = g * coef
    return out


def cancel_last_layer_grads(grads: Tensors, cancel: bool) -> Tensors:
    """utils.cancel_gradients_last_layer: zero the head's last layer while
    `cancel` holds."""
    keep = 0.0 if cancel else 1.0
    out = dict(grads)
    for name in ("head.last_v", "head.last_g"):
        out[name] = grads[name] * keep
    return out


# ---------------------------------------------------------------------------
# Unit-lr optimizers: own copies of optax's update rules, with the state a
# dict of tensors keyed by parameter name.  `update` returns the updates to
# be scaled by the scheduled lr (optax's scale_by_learning_rate(1.0) sign
# included).
# ---------------------------------------------------------------------------

class Optimizer(NamedTuple):
    init: Callable[[Tensors], Dict[str, Any]]
    update: Callable[[Tensors, Dict[str, Any], Tensors],
                     Tuple[Tensors, Dict[str, Any]]]


def _zeros(params: Tensors) -> Tensors:
    return {n: torch.zeros_like(p) for n, p in params.items()}


def adamw(b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8) -> Optimizer:
    """optax.adamw(1.0, weight_decay=0): scale_by_adam, no decay, -1."""

    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(grads, state, params):
        count = state["count"] + 1
        c1 = np.float32(1 - np.float32(b1) ** count)
        c2 = np.float32(1 - np.float32(b2) ** count)
        mu, nu, out = {}, {}, {}
        for n, g in grads.items():
            mu[n] = (1 - b1) * g + b1 * state["mu"][n]
            nu[n] = (1 - b2) * g * g + b2 * state["nu"][n]
            out[n] = -((mu[n] / float(c1))
                       / (torch.sqrt(nu[n] / float(c2)) + eps))
        return out, {"count": count, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def sgd(momentum: float = 0.9) -> Optimizer:
    """optax.sgd(1.0, momentum): trace (t = g + momentum t), then -1."""

    def init(params):
        return {"trace": _zeros(params)}

    def update(grads, state, params):
        trace = {n: g + momentum * state["trace"][n]
                 for n, g in grads.items()}
        return {n: -t for n, t in trace.items()}, {"trace": trace}

    return Optimizer(init, update)


def lars(trust_coefficient: float = 0.001, momentum: float = 0.9
         ) -> Optimizer:
    """optax.lars(1.0): weight decay 0, trust ratio coef ||p|| / ||u||
    (1 where either norm is 0) on every tensor, -1, then a momentum
    trace."""

    def init(params):
        return {"trace": _zeros(params)}

    def update(grads, state, params):
        trace = {}
        for n, g in grads.items():
            pn = torch.linalg.vector_norm(params[n])
            un = torch.linalg.vector_norm(g)
            ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                                trust_coefficient * pn / un)
            trace[n] = -(g * ratio) + momentum * state["trace"][n]
        return dict(trace), {"trace": trace}

    return Optimizer(init, update)


OPTIMIZERS = {"adamw": adamw, "sgd": sgd, "lars": lars}


def _to_device(obj, device):
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_device(v, device) for v in obj]
    return obj


def fused_loss_auto(cfg: DINOConfig, device: torch.device,
                    dp_size: int = 1) -> bool:
    """JAX's auto rule for the fused last layer + loss (K7), with the card
    in place of the TPU: on a CUDA device, without the BatchNorm head, at
    out_dim a multiple of 128, the batch dividing over `dp_size` shards."""
    return (device.type == "cuda" and not cfg.use_bn_in_head
            and cfg.out_dim % 128 == 0 and cfg.batch_size % dp_size == 0)


class DINOTrainer:
    """Student / teacher DINO training, one optimization step at a time."""

    def __init__(self, vit_cfg: ViTConfig, cfg: DINOConfig,
                 niter_per_ep: int, generator: torch.Generator,
                 optimizer: str = "adamw", mesh: Any = None,
                 fused_blocks: Optional[bool] = None,
                 fused_loss: Optional[bool] = None,
                 device: DeviceLike = None):
        """generator: a CPU generator for the initial weights (backbone,
        then head).  fused_blocks: the student backbone on K4 / K5 / K6 and
        the teacher on K1; default on a CUDA device at batch >= 32, as the
        JAX package does on a TPU.  fused_loss: the last layer and loss on
        K7 (its plain version on the CPU); default `fused_loss_auto`."""
        if fused_loss and cfg.use_bn_in_head:
            raise ValueError(
                "fused_loss is incompatible with use_bn_in_head: the "
                "fused path bottlenecks the resolution groups separately, "
                "but BN batch stats must span every student row jointly "
                "(the reference's single head(torch.cat(...)) call)")
        if optimizer not in OPTIMIZERS:
            raise ValueError(optimizer)
        self.device = resolve_device(device)
        if fused_blocks is None:
            fused_blocks = (cfg.batch_size >= 32
                            and self.device.type == "cuda")
        self.fused_blocks = fused_blocks
        self.mesh, self.dp = mesh, None
        dp_size = 1
        if mesh is not None:
            from sais_tpu_torch.parallel import mesh as mesh_lib
            self.dp = mesh_lib.DataParallel(mesh, mesh)
            dp_size = self.dp.shards
        if fused_loss is None:
            fused_loss = fused_loss_auto(cfg, self.device, dp_size)
        self.fused_loss = bool(fused_loss)
        if cfg.batch_size % dp_size:
            raise ValueError(
                f"fused DINO loss under a {dp_size}-shard mesh needs "
                f"batch_size % {dp_size} == 0, got {cfg.batch_size}; pass "
                "fused_loss=False" if self.fused_loss else
                f"DINO pre-training under a {dp_size}-shard mesh needs "
                f"batch_size % {dp_size} == 0, got {cfg.batch_size}")
        self.local_batch = cfg.batch_size // dp_size
        self.cfg = cfg
        self.vit_cfg = vit_cfg
        student = nn.ModuleDict({
            "backbone": vit_init(generator, vit_cfg),
            "head": dino_head_init(generator, vit_cfg.embed_dim, cfg.out_dim,
                                   use_bn=cfg.use_bn_in_head)})
        self.student = student.to(self.device)
        if mesh is not None:
            mesh_lib.replicate(self.student, mesh)
        self.teacher = copy.deepcopy(self.student).requires_grad_(False)
        self.center = torch.zeros((cfg.out_dim,), device=self.device)
        # BatchNorm running statistics, each network's from its own
        # forwards (None without the BatchNorm head)
        self.student_bn = self.teacher_bn = None
        if cfg.use_bn_in_head:
            self.student_bn = dino_head_bn_init(self.student["head"])
            self.teacher_bn = dino_head_bn_init(self.teacher["head"])
        self._next_bn = None

        scaled_lr = cfg.lr * cfg.batch_size / 256.0
        self.lr_sched = cosine_scheduler(scaled_lr, cfg.min_lr, cfg.epochs,
                                         niter_per_ep, cfg.warmup_epochs)
        self.wd_sched = cosine_scheduler(cfg.weight_decay,
                                         cfg.weight_decay_end, cfg.epochs,
                                         niter_per_ep)
        self.mom_sched = cosine_scheduler(cfg.momentum_teacher, 1.0,
                                          cfg.epochs, niter_per_ep)
        self.temp_sched = teacher_temp_schedule(cfg, cfg.epochs)
        self.niter_per_ep = niter_per_ep
        self.step_idx = 0
        self.optimizer = OPTIMIZERS[optimizer]()
        self.opt_state = self.optimizer.init(self._params())
        if self.fused_loss:
            sel, cnt = build_pair_structure(self.local_batch,
                                            cfg.n_global_crops,
                                            cfg.n_local_crops)
            self._pairs = (torch.from_numpy(sel).to(self.device),
                           torch.from_numpy(cnt).to(self.device))
            n_crops = cfg.n_global_crops + cfg.n_local_crops
            if self.dp is not None:
                self._fused_op = make_fused_dino_loss_dp(
                    cfg.student_temp, self.local_batch, cfg.n_global_crops,
                    n_crops, self.dp.total, dp_size,
                    norm_last_layer=cfg.norm_last_layer)
            else:
                self._fused_op = make_fused_dino_loss(
                    cfg.student_temp, cfg.batch_size, cfg.n_global_crops,
                    n_crops, norm_last_layer=cfg.norm_last_layer)

    def _params(self) -> Tensors:
        return dict(self.student.named_parameters())

    # -- forward -----------------------------------------------------------

    def _backbone(self, net, crops, generator):
        rate = self.cfg.drop_path_rate
        if self.fused_blocks:
            return vit_features_trainable_fused(net["backbone"], crops, rate,
                                                generator)
        return vit_forward_train(net["backbone"], crops, rate, generator)

    def _backbone_infer(self, net, crops):
        # the teacher gets no gradient, so it takes the inference kernel
        # (K1, no x1 written) on the fused path
        if self.fused_blocks:
            return vit_forward_fused(net["backbone"], crops)
        return vit_forward_train(net["backbone"], crops)

    def bottlenecks(self, globals_, locals_, generator=None):
        """(hs, ht): the student's bottleneck outputs of every crop and the
        teacher's of the global crops (under no_grad), rows image-major,
        globals first.  The backbones run per resolution group, the
        head's MLP once on all their bf16 features, as under the
        reference's autocast (MultiCropWrapper, utils.py:595-631).  With
        the BatchNorm head that one call is what makes the batch
        statistics span every crop; the heads' new running statistics
        wait in `_next_bn` for the step to take them."""
        cfg = self.cfg
        feats = [self._backbone(self.student, globals_, generator)]
        if locals_ is not None and cfg.n_local_crops:
            feats.append(self._backbone(self.student, locals_, generator))
        total = None if self.dp is None else self.dp.total
        hs = dino_head_bottleneck(self.student["head"],
                                  torch.cat(feats).to(torch.bfloat16),
                                  self.student_bn, total=total)
        with torch.no_grad():
            ht = dino_head_bottleneck(
                self.teacher["head"],
                self._backbone_infer(self.teacher, globals_).to(
                    torch.bfloat16), self.teacher_bn, total=total)
        if self.student_bn is not None:
            (hs, sbn), (ht, tbn) = hs, ht
            self._next_bn = ([{k: v.detach() for k, v in st.items()}
                              for st in sbn], tbn)
        return hs, ht

    def head_loss(self, hs, ht, teacher_temp):
        """(loss, batch center) from the bottleneck outputs: the last
        layers and the loss in one `FusedDinoLoss` call (K7, JAX
        `fused_loss_fn`) with `fused_loss`, else `plain_head_loss`."""
        cfg = self.cfg
        head, t_head = self.student["head"], self.teacher["head"]
        args = (hs, head.last_v, head.last_g, ht, t_head.last_v,
                t_head.last_g, self.center, teacher_temp)
        if not self.fused_loss:
            return plain_head_loss(
                *args, n_global=cfg.n_global_crops,
                n_local=cfg.n_local_crops, student_temp=cfg.student_temp,
                norm_last_layer=cfg.norm_last_layer,
                total=None if self.dp is None else self.dp.total)
        exp_rows = ((cfg.n_global_crops + cfg.n_local_crops)
                    * self.local_batch)
        if hs.shape[0] != exp_rows:
            raise ValueError(
                f"fused DINO loss built for batch {cfg.batch_size} "
                f"({exp_rows} student rows) but the step got {hs.shape[0]} "
                "rows; pass crops of the configured batch size or construct "
                "with fused_loss=False")
        return self._fused_op(*args, *self._pairs)

    # -- checkpointable state (utils.restart_from_checkpoint) ---------------

    def state(self) -> Dict[str, Any]:
        out = {"student": self.student.state_dict(),
               "teacher": self.teacher.state_dict(),
               "center": self.center, "opt_state": self.opt_state,
               "step_idx": self.step_idx}
        if self.student_bn is not None:
            out["student_bn"] = self.student_bn
            out["teacher_bn"] = self.teacher_bn
        return out

    def load_state(self, state: Dict[str, Any]) -> None:
        """Takes a state of `state()`.  As in the JAX package, BatchNorm
        running statistics in `state` replace the trainer's whether or not
        it has the BatchNorm head, and a state without them keeps the
        trainer's own, both without a word (reference behaviours kept
        for parity, ROADMAP.md Queue 3)."""
        self.student.load_state_dict(state["student"])
        self.teacher.load_state_dict(state["teacher"])
        self.center = state["center"].to(self.device)
        self.opt_state = _to_device(state["opt_state"], self.device)
        self.step_idx = int(state["step_idx"])
        if "student_bn" in state:
            self.student_bn = _to_device(list(state["student_bn"]),
                                         self.device)
            self.teacher_bn = _to_device(list(state["teacher_bn"]),
                                         self.device)

    # -- steps -------------------------------------------------------------

    def loss_and_grads(self, globals_: torch.Tensor,
                       locals_: Optional[torch.Tensor], teacher_temp: float,
                       generator: torch.Generator
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The step's forward and backward without the update: (loss,
        teacher batch center), the student's gradients left in .grad.
        `generator` draws the student's stochastic depth."""
        for p in self.student.parameters():
            p.grad = None
        loss, batch_center = self.head_loss(
            *self.bottlenecks(globals_, locals_, generator), teacher_temp)
        if self.dp is None:
            loss.backward()
        else:
            self.dp.backward(loss, list(self.student.parameters()))
        return loss, batch_center

    def step_async(self, globals_: torch.Tensor,
                   locals_: Optional[torch.Tensor]) -> torch.Tensor:
        """One optimization step without fetching the loss: returns the
        loss on the device, for the caller to fetch one step later
        (`check_loss`) so the host prepares the next batch meanwhile.

        globals_: (n_global*B, H, W, 3) normalized crops, image-major rows;
        locals_: (n_local*B, h, w, 3) or None; the whole batch's, of which
        a rank of a mesh takes its block."""
        cfg = self.cfg
        i = min(self.step_idx, len(self.lr_sched) - 1)
        epoch = i // self.niter_per_ep
        lr, wd = float(self.lr_sched[i]), float(self.wd_sched[i])
        momentum = float(self.mom_sched[i])
        temp = float(self.temp_sched[min(epoch, len(self.temp_sched) - 1)])
        seed = self.step_idx
        if self.dp is not None:
            # this rank's images; its own stochastic-depth draws
            from sais_tpu_torch.parallel.mesh import data_sharding
            sh = data_sharding(self.mesh)
            globals_ = globals_[sh.rows(globals_.shape[0])]
            if locals_ is not None:
                locals_ = locals_[sh.rows(locals_.shape[0])]
            seed = self.step_idx * sh.count + sh.index
        globals_ = globals_.to(self.device)
        locals_ = None if locals_ is None else locals_.to(self.device)
        # per-step stochastic-depth draws
        gen = torch.Generator(device=self.device).manual_seed(seed)

        params = self._params()
        loss, batch_center = self.loss_and_grads(globals_, locals_, temp,
                                                 gen)
        with torch.no_grad():
            # parameters the loss does not reach (last_g under
            # norm_last_layer) have a zero gradient, as in JAX
            grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                     for n, p in params.items()}
            grads = clip_gradients_per_param(grads, cfg.clip_grad)
            grads = cancel_last_layer_grads(
                grads, epoch < cfg.freeze_last_layer_epochs)
            updates, self.opt_state = self.optimizer.update(
                grads, self.opt_state, params)
            for n, p in params.items():
                decay = lr * wd * float(p.dim() > 1)
                p.copy_(p + lr * updates[n] - decay * p)
                p.grad = None
            ema_update(self.teacher, self.student, momentum)
            self.center = update_center(self.center, batch_center,
                                        cfg.center_momentum)
        if self._next_bn is not None:
            self.student_bn, self.teacher_bn = self._next_bn
            self._next_bn = None
        self.step_idx += 1
        return loss.detach()

    @staticmethod
    def check_loss(loss) -> float:
        """Fetch and validate a loss from step_async (the reference aborts
        on a non-finite loss, main_dino.py:539-541)."""
        loss = float(loss)
        if not np.isfinite(loss):
            raise FloatingPointError(f"DINO loss is {loss}, stopping training")
        return loss

    def step(self, globals_: torch.Tensor,
             locals_: Optional[torch.Tensor]) -> float:
        """One synchronous optimization step (dispatch + loss fetch)."""
        return self.check_loss(self.step_async(globals_, locals_))
