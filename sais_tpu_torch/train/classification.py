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

Eager PyTorch on one device (the card unless `device='cpu'`).  The raw
-video trainer (R3D or ViT snippets) and data-parallel training wait for
their slices.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Tuple

import numpy as np
import torch

from sais_tpu_torch import DeviceLike, resolve_device
from sais_tpu_torch.config import ModelConfig, TrainConfig
from sais_tpu_torch.models.full_model import (FullModel,
                                              classification_forward,
                                              mil_forward)
from sais_tpu_torch.train import metrics as metrics_lib
from sais_tpu_torch.train.losses import _bce_with_logits

Batch = Dict[str, Any]
TASKS = ("MIL", "ClassificationHead")


def make_weighted_loss(logits_fn: Callable[[FullModel, Dict], torch.Tensor],
                       nclasses: int):
    """loss_fn(model, batch) -> (loss, logits): CE (or BCEWithLogits when
    nclasses == 1) of logits_fn's logits against batch['labels'], with an
    optional batch['weight'] (B,) 0 / 1 that drops padded rows from the
    loss and its gradients (sum(per * weight) / max(sum(weight), 1))."""

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
        return (per * weight).sum() / weight.sum().clamp(min=1.0), logits

    return loss_fn


class ClassificationTrainer:
    """Trainer for task='MIL' or task='ClassificationHead'."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 model: FullModel, task: str = "MIL", mesh: Any = None,
                 device: DeviceLike = None):
        if task not in TASKS:
            raise ValueError(f"task {task!r} is not one of {TASKS}")
        if mesh is not None:
            raise NotImplementedError(
                "data-parallel training (mesh) is not ported yet; it comes "
                "with the parallelism slice (ROADMAP.md Queue 1, "
                "'Parallelism, on torch.distributed')")
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.task = task
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optimizer = torch.optim.SGD(self.model.parameters(),
                                         lr=train_cfg.lr)
        self.loss_fn = make_weighted_loss(self._logits, model_cfg.nclasses)

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
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items() if k != "tta"}

    def train_step(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """One SGD step; returns (loss, pre-update logits), detached."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, logits = self.loss_fn(self.model, self._device_batch(batch))
        loss.backward()
        self.optimizer.step()
        return loss.detach(), logits.detach()

    @torch.no_grad()
    def eval_step(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.loss_fn(self.model, self._device_batch(batch))

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
