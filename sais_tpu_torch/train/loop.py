"""Training loop: prototype (NCE) training with early stopping.

Counterpart of `sais_tpu/train/loop.py` (`PrototypeTrainer`), reference
semantics (train.py:46-96, prepare_model.py:555-567,
perform_training.py:49-227):

- plain SGD (no momentum) over the model parameters AND the prototype
  matrix jointly;
- per-epoch phases train / val / test; early stop once the val loss has
  failed to improve max_patience consecutive epochs; the best snapshot
  (parameters + prototypes) is kept from the best-val-loss epoch;
- the NCE prototype loss, plus, with use_importance (`-il`), the
  reference's importance loss at train steps only (loop.py:98-131,
  perform_training.py:127-130); a batch's primary_domain (multi-task '+'
  domains) routes its rows through linear / linearB; a train step's metric
  probabilities come from the pre-update prototypes (loop.py:136-139); val
  and test run 3-way TTA, with the loss the mean of the per-augment losses
  and the probabilities the mean of the per-augment softmaxes
  (loop.py:189-202);
- a non-finite loss raises FloatingPointError.

Eager PyTorch, one device a process (the card unless `device='cpu'`).
The temporal encoder's flash path is differentiable (K2 forward, K3
backward), so `resolve_flash` applies in training as in inference.

- `mesh` (data parallel): each rank takes its block of the batch padded
  with 'weight' rows; the loss is JAX's masked mean over the whole padded
  batch (loop.py:100-115), from sums over the ranks, and the gradients
  are summed in one flat buffer (`parallel.mesh.DataParallel`).
- `seq_mesh` (sequence parallel): the frame encoder runs as a ring over
  the mesh's 'seq' axis (`parallel.sequence`); on a ('data', 'seq') mesh
  with 'data' > 1 each data row of the mesh takes its block of the batch
  and runs its own ring.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, \
    Tuple

import numpy as np
import torch
import torch.nn as nn

from sais_tpu_torch import DeviceLike, resolve_device
from sais_tpu_torch.config import ModelConfig, TrainConfig
from sais_tpu_torch.models.full_model import FullModel, prototypes_forward
from sais_tpu_torch.models.heads import (nce_loss, prototype_probs,
                                         prototype_similarities)
from sais_tpu_torch.train import metrics as metrics_lib
from sais_tpu_torch.train.losses import importance_loss_reference

Batch = Dict[str, Any]


class PrototypeTrainer:
    """Prototypes-task trainer (the reference's main training mode)."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 model: FullModel, prototype_keys: Sequence[str],
                 prototypes: torch.Tensor, mesh: Any = None,
                 use_importance: Optional[bool] = None, seq_mesh: Any = None,
                 device: DeviceLike = None):
        """use_importance: add the importance loss at train steps (None:
        train_cfg.importance_loss); the model needs its importance head."""
        if mesh is not None and seq_mesh is not None:
            raise ValueError(
                "pass either mesh (data parallel) or seq_mesh (sequence "
                "parallel); for both at once build one seq_mesh(n_seq, "
                "n_data) — its 'data' axis shards the batches")
        self.use_importance = (train_cfg.importance_loss
                               if use_importance is None else use_importance)
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.prototype_keys = list(prototype_keys)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.prototypes = nn.Parameter(
            prototypes.detach().to(self.device, torch.float32).clone())
        self.optimizer = torch.optim.SGD(
            [*self.model.parameters(), self.prototypes], lr=train_cfg.lr)
        self.mesh, self.seq_mesh = mesh, seq_mesh
        self._encoder_fn = None
        self.dp = None
        if mesh is not None or seq_mesh is not None:
            from sais_tpu_torch.parallel import mesh as mesh_lib
            batch_mesh = mesh
            if seq_mesh is not None:
                from sais_tpu_torch.parallel.sequence import ring_encoder_fn
                self._encoder_fn = ring_encoder_fn(
                    seq_mesh, model_cfg.temporal, shard_batch=False)
                if mesh_lib.axis_size(seq_mesh, mesh_lib.DATA_AXIS) > 1:
                    batch_mesh = seq_mesh
            self.dp = mesh_lib.DataParallel(mesh or seq_mesh, batch_mesh)
            mesh_lib.replicate(self.model, mesh or seq_mesh)
            mesh_lib.replicate(self.prototypes, mesh or seq_mesh)

    # -- steps ----------------------------------------------------------------

    def _device_batch(self, batch: Batch) -> Dict[str, torch.Tensor]:
        batch = {k: v for k, v in batch.items() if k != "tta"}
        if self.dp is not None:
            batch = self.dp.shard(batch)
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def _loss(self, b: Dict[str, torch.Tensor], with_importance: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        out = prototypes_forward(self.model, self.model_cfg, b.get("rgb"),
                                 b.get("rgb_mask"), b.get("flow"),
                                 b.get("flow_mask"), b.get("primary_domain"),
                                 encoder_fn=self._encoder_fn)
        weight = b.get("weight")
        total = None if self.dp is None else self.dp.total
        labels = b.get("labels")
        if weight is None:
            loss = nce_loss(out.video_rep, self.prototypes, b["label_cols"])
        else:
            # padded batches: the masked mean over real rows (loop.py:
            # 100-115), its sums over every rank's rows
            logp = torch.log_softmax(prototype_similarities(
                out.video_rep, self.prototypes), -1)
            picked = logp.gather(1, b["label_cols"].long()[:, None])[:, 0]
            weight = weight.to(picked.dtype)
            loss = -total((picked * weight).sum()) / torch.clamp(
                total(weight.sum()), min=1.0)
            if labels is not None:
                # padded rows must not count as low-skill (label 0)
                labels = torch.where(weight > 0, labels,
                                     torch.full_like(labels, -1))
        if with_importance:
            loss = loss + importance_loss_reference(
                out.importances, b["importance"], b["ipad"], labels,
                weight=weight, total=total)
        return loss, out.video_rep

    def _probs(self, reps: torch.Tensor) -> torch.Tensor:
        probs = prototype_probs(reps, self.prototypes)
        return probs if self.dp is None else self.dp.rows(probs)

    def train_step(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """One SGD step; returns (loss, probabilities under the pre-update
        prototypes, the padded batch's rows), both detached on the
        device."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, reps = self._loss(self._device_batch(batch),
                                self.use_importance)
        if self.dp is None:
            loss.backward()
        else:
            self.dp.backward(loss, [*self.model.parameters(),
                                    self.prototypes])
        with torch.no_grad():
            probs = self._probs(reps)
        self.optimizer.step()
        return loss.detach(), probs

    @torch.no_grad()
    def eval_step(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        loss, reps = self._loss(self._device_batch(batch), False)
        return loss, self._probs(reps)

    # -- epochs ---------------------------------------------------------------

    def run_epoch(self, batches: Iterable[Batch], train: bool
                  ) -> Tuple[float, Dict[str, float]]:
        """One pass; returns (mean loss, metrics).  Metrics follow
        calcNCEMetrics (probabilities against label columns)."""
        losses: List[float] = []
        sizes: List[int] = []
        all_probs: List[np.ndarray] = []
        all_cols: List[np.ndarray] = []
        for batch in batches:
            cols = np.asarray(batch["label_cols"])
            if train:
                loss, probs = self.train_step(batch)
                loss, probs = float(loss), probs.cpu().numpy()[:len(cols)]
            elif "tta" in batch:
                # 3-way TTA at val / test (perform_training.py:126-128,
                # 161-204): mean of the per-augment losses and of the
                # per-augment prototype softmaxes
                steps = [self.eval_step(v) for v in batch["tta"]]
                loss = float(np.mean([float(l) for l, _ in steps]))
                probs = np.mean(np.stack([p.cpu().numpy()[:len(cols)]
                                          for _, p in steps]), axis=0)
            else:
                loss, probs = self.eval_step(batch)
                loss, probs = float(loss), probs.cpu().numpy()[:len(cols)]
            if not np.isfinite(loss):
                raise FloatingPointError(f"training loss is {loss}, stopping")
            losses.append(loss * len(cols))
            sizes.append(len(cols))
            all_probs.append(probs)
            all_cols.append(cols)
        mean_loss = sum(losses) / max(sum(sizes), 1)
        m: Dict[str, float] = {}
        if all_cols:
            cols = np.concatenate(all_cols)
            m = metrics_lib.prototype_metrics(
                [np.concatenate(all_probs)],
                [self.prototype_keys[c] for c in cols], self.prototype_keys)
        m["loss"] = mean_loss
        return mean_loss, m

    def snapshot(self) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """(model state_dict, prototypes), copied to the host."""
        return ({k: v.detach().cpu().clone()
                 for k, v in self.model.state_dict().items()},
                self.prototypes.detach().cpu().clone())

    def fit(self, loaders: Dict[str, Callable[..., Iterable[Batch]]],
            nepochs: Optional[int] = None,
            log: Callable[[str], None] = print) -> Dict[str, Any]:
        """Epoch loop with early stopping (train.py:46-96).

        loaders: phase -> callable yielding the phase's batches; a callable
        that takes an argument receives the 0-based epoch index, the
        per-epoch shuffle seed.  Returns {'model' (state_dict),
        'prototypes', 'metrics' (val history), 'best_epoch'}."""
        nepochs = nepochs or self.train_cfg.nepochs
        tracker = metrics_lib.MetricsTracker()
        min_loss = float("inf")
        patience = 1
        best = None
        best_epoch = 0
        epoch = 1
        while epoch <= nepochs and patience <= self.train_cfg.max_patience:
            for phase, make in loaders.items():
                takes_epoch = len(inspect.signature(make).parameters) >= 1
                batches = make(epoch - 1) if takes_epoch else make()
                loss, m = self.run_epoch(batches, phase == "train")
                log(metrics_lib.format_metrics(phase, m))
                if phase == "val":
                    tracker.update(m)
                    if loss < min_loss:
                        min_loss = loss
                        patience = 1
                        best_epoch = epoch
                        best = self.snapshot()
                    else:
                        patience += 1
            epoch += 1
        if best is None:
            best = self.snapshot()
        return {"model": best[0], "prototypes": best[1],
                "metrics": tracker.history, "best_epoch": best_epoch}
