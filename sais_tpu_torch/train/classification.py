"""MIL and ClassificationHead task trainers on stored reps (reference task
dispatch, perform_training.py:112-153).

Counterpart of `sais_tpu/train/classification.py` (`make_weighted_loss`,
`ClassificationTrainer`):

- MIL: the frame encoder, the clip encoder and the gated-attention head,
  CrossEntropy (calcLoss, prepare_miscellaneous.py:62-83);
- ClassificationHead: cls_head logits over the CLS track, the
  single-modality head's per-snippet logits mean-pooled over snippets;
  BCEWithLogits when nclasses == 1, else CrossEntropy
  (perform_training.py:138-153);
- plain SGD over every model parameter; val and test run 3-way TTA, the
  loss the mean of the per-augment losses and the metrics on the mean of
  the per-augment logits (perform_training.py:141-149, calcMetrics
  prepare_miscellaneous.py:171-173).

`RawClassificationTrainer` trains the ClassificationHead task on raw
video snippets through an R3D-18 or ViT encoder (`data.raw`), frozen by
default.  Eager PyTorch, one device a process (the card unless
`device='cpu'`).  With a `mesh` each rank takes its block of the batch
padded with 'weight' rows, the loss is the masked mean over the whole
padded batch from sums over the ranks, and the gradients are summed in
one flat buffer (`parallel.mesh.DataParallel`; JAX's jit over the mesh,
classification.py:122).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from sais_tpu_torch import DeviceLike, resolve_device
from sais_tpu_torch.config import ModelConfig, TrainConfig
from sais_tpu_torch.models.full_model import (FullModel, _cls_head,
                                              classification_forward,
                                              mil_forward)
from sais_tpu_torch.train import metrics as metrics_lib
from sais_tpu_torch.train.losses import _bce_with_logits

Batch = Dict[str, Any]
TASKS = ("MIL", "ClassificationHead")


def make_weighted_loss(logits_fn: Callable[[FullModel, Dict], torch.Tensor],
                       nclasses: int, total: Optional[Callable] = None):
    """loss_fn(model, batch) -> (loss, logits): CE (or BCEWithLogits when
    nclasses == 1) of logits_fn's logits against batch['labels'], with an
    optional batch['weight'] (B,) 0 / 1 that drops padded rows from the
    loss and its gradients (sum(per * weight) / max(sum(weight), 1)).
    total: turns a sum over these rows into one over the whole batch (a
    data-parallel rank's `DataParallel.total`)."""
    total = total or (lambda x: x)

    def loss_fn(model: FullModel, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = logits_fn(model, batch)
        labels = batch["labels"]
        weight = batch.get("weight")
        if nclasses == 1:
            per = _bce_with_logits(logits.reshape(-1),
                                   labels.to(logits.dtype).reshape(-1))
        else:
            logp = torch.log_softmax(logits, dim=-1)
            per = -logp.gather(1, labels.long()[:, None])[:, 0]
        if weight is None:
            return per.mean(), logits
        weight = weight.to(per.dtype)
        return (total((per * weight).sum())
                / total(weight.sum()).clamp(min=1.0), logits)

    return loss_fn


class ClassificationTrainer:
    """Trainer for task='MIL' or task='ClassificationHead'."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 model: FullModel, task: str = "MIL", mesh: Any = None,
                 device: DeviceLike = None):
        if task not in TASKS:
            raise ValueError(f"task {task!r} is not one of {TASKS}")
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.task = task
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optimizer = torch.optim.SGD(self.model.parameters(),
                                         lr=train_cfg.lr)
        self.mesh = mesh
        self.dp = None
        if mesh is not None:
            from sais_tpu_torch.parallel import mesh as mesh_lib
            self.dp = mesh_lib.DataParallel(mesh, mesh)
            mesh_lib.replicate(self.model, mesh)
        self.loss_fn = make_weighted_loss(
            self._logits, model_cfg.nclasses,
            None if self.dp is None else self.dp.total)

    def _logits(self, model: FullModel, b: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        if self.task == "MIL":
            return mil_forward(model, self.model_cfg, b["rgb"],
                               b.get("rgb_mask"))[0]
        logits = classification_forward(model, self.model_cfg, b.get("rgb"),
                                        b.get("rgb_mask"), b.get("flow"),
                                        b.get("flow_mask"))
        # the single-modality head's per-snippet logits (B, S, C)
        # (prepare_model.py:426-428), pooled over snippets for the
        # batch-level loss as the RGB-Flow branch does (:440)
        return logits.mean(dim=1) if logits.dim() == 3 else logits

    def _device_batch(self, batch: Batch) -> Dict[str, torch.Tensor]:
        batch = {k: v for k, v in batch.items() if k != "tta"}
        if self.dp is not None:
            batch = self.dp.shard(batch)
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def _params(self) -> List[torch.nn.Parameter]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def _rows(self, logits: torch.Tensor) -> torch.Tensor:
        return logits if self.dp is None else self.dp.rows(logits)

    def train_step(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """One SGD step; returns (loss, pre-update logits of the padded
        batch's rows), detached."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, logits = self.loss_fn(self.model, self._device_batch(batch))
        if self.dp is None:
            loss.backward()
        else:
            self.dp.backward(loss, self._params())
        self.optimizer.step()
        return loss.detach(), self._rows(logits.detach())

    @torch.no_grad()
    def eval_step(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        loss, logits = self.loss_fn(self.model, self._device_batch(batch))
        return loss, self._rows(logits)

    def run_epoch(self, batches: Iterable[Batch], train: bool
                  ) -> Tuple[float, Dict[str, float]]:
        """One pass; returns (mean loss over rows, metrics): logits_metrics
        of the epoch's logits (the TTA logit mean at val / test)."""
        losses: List[float] = []
        sizes: List[int] = []
        all_logits: List[np.ndarray] = []
        all_labels: List[np.ndarray] = []
        for batch in batches:
            n = len(batch["labels"])
            if train:
                loss, logits = self.train_step(batch)
                loss, logits = float(loss), logits.cpu().numpy()[:n]
            elif "tta" in batch:
                steps = [self.eval_step(v) for v in batch["tta"]]
                loss = float(np.mean([float(l) for l, _ in steps]))
                logits = np.mean(np.stack([lg.cpu().numpy()[:n]
                                           for _, lg in steps]), axis=0)
            else:
                loss, logits = self.eval_step(batch)
                loss, logits = float(loss), logits.cpu().numpy()[:n]
            losses.append(loss * n)
            sizes.append(n)
            all_logits.append(logits)
            all_labels.append(np.asarray(batch["labels"]))
        m: Dict[str, float] = {}
        if all_labels and sum(sizes):
            m = metrics_lib.logits_metrics(
                [np.concatenate(all_logits)], np.concatenate(all_labels),
                self.model_cfg.nclasses)
        m["loss"] = sum(losses) / max(sum(sizes), 1)
        return m["loss"], m

    def snapshot(self) -> Dict[str, torch.Tensor]:
        """The model's state_dict, copied to the host."""
        return {k: v.detach().cpu().clone()
                for k, v in self.model.state_dict().items()}


def r3d_head_logits(model: FullModel, feats: torch.Tensor) -> torch.Tensor:
    """getR3Dreps (prepare_model.py:232-244): per-snippet features (B, S,
    512) plus the per-snippet-index positional embedding, then
    cls_head(relu(.)) a snippet, mean-pooled over snippets."""
    reps = feats + model.frame_pos[:feats.shape[1]].to(feats.dtype)[None]
    return _cls_head(model)(torch.relu(reps)).mean(dim=1)


class RawClassificationTrainer(ClassificationTrainer):
    """ClassificationHead training on RAW video snippets
    (run_experiments.py '-fe', prepare_model.py:112-124; JAX
    `RawClassificationTrainer`).

    - R3D: per-snippet encoder features, `r3d_head_logits`;
    - ViT: per-frame features (B, S, T, D) through
      `classification_forward` with an all-False mask, the per-snippet
      logits mean-pooled over snippets;
    - RGB-Flow: the two streams' features summed (prepare_model.py:
      436-440).

    freeze_encoder=True (the reference's '-fe'): the encoder runs under
    torch.no_grad and the optimizer holds only the head and temporal
    parameters.  freeze_encoder=False (the reference CLI's default
    without -fe): one SGD over the model and the encoder, the encoder
    inside the gradient.  The encoder (`models.r3d.R3D18` or a float32
    `models.vit.VisionTransformer`) is moved to the trainer's device."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 model: FullModel, encoder: torch.nn.Module,
                 encoder_type: str = "R3D", mesh: Any = None,
                 freeze_encoder: bool = True, device: DeviceLike = None):
        super().__init__(model_cfg, train_cfg, model,
                         task="ClassificationHead", mesh=mesh, device=device)
        if encoder_type not in ("R3D", "ViT"):
            raise ValueError(f"encoder_type {encoder_type!r}")
        self.encoder_type = encoder_type
        self.freeze_encoder = freeze_encoder
        self.encoder = encoder.to(self.device)
        self.encoder.requires_grad_(not freeze_encoder)
        if mesh is not None:
            from sais_tpu_torch.parallel.mesh import replicate
            replicate(self.encoder, mesh)
        if not freeze_encoder:
            self.optimizer = torch.optim.SGD(
                [*self.model.parameters(), *self.encoder.parameters()],
                lr=train_cfg.lr)

    def encode(self, raw: torch.Tensor) -> torch.Tensor:
        """(B, S, T, H, W, 3) normalized snippets -> (B, S, 512) for R3D,
        (B, S, T, D) for the ViT."""
        from sais_tpu_torch.models.r3d import r3d18_features
        from sais_tpu_torch.models.vit import vit_features
        b, s = raw.shape[:2]
        if self.encoder_type == "R3D":
            flat = raw.reshape((b * s,) + tuple(raw.shape[2:]))
            return r3d18_features(self.encoder, flat).reshape(b, s, -1)
        t = raw.shape[2]
        flat = raw.reshape((b * s * t,) + tuple(raw.shape[3:]))
        return vit_features(self.encoder, flat).reshape(b, s, t, -1)

    def _logits(self, model: FullModel, b: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        grad = (contextlib.nullcontext() if not self.freeze_encoder
                else torch.no_grad())
        with grad:
            feats = self.encode(b["raw"])
            if "raw_flow" in b:
                feats = feats + self.encode(b["raw_flow"])
        if self.encoder_type == "R3D":
            return r3d_head_logits(model, feats)
        mask = torch.zeros(feats.shape[:2] + (feats.shape[2] + 1,),
                           dtype=torch.bool, device=feats.device)
        logits = classification_forward(model, self.model_cfg, feats, mask)
        return logits.mean(dim=1) if logits.dim() == 3 else logits

    def encoder_snapshot(self) -> Dict[str, torch.Tensor]:
        """The encoder's state_dict, copied to the host."""
        return {k: v.detach().cpu().clone()
                for k, v in self.encoder.state_dict().items()}
