"""Encoder evaluation probes (reference: dino-main/eval_knn.py,
eval_linear.py; counterpart of `sais_tpu/eval/probes.py`).

- weighted k-NN (eval_knn.knn_classifier:139-183): l2-normalized
  features, cosine similarity, top-k neighbours, exp(sim / T) vote
  weights (T = 0.07), top-1 / top-5 accuracy;
- linear probe (eval_linear.py): one linear layer trained with SGD and a
  cosine learning rate on frozen features.

The products run on `device` (the card unless the caller passes "cpu");
the rankings are read on the host with numpy, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sais_tpu_torch import DeviceLike, resolve_device


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def knn_votes(train_features: np.ndarray, train_labels: np.ndarray,
              test_features: np.ndarray, k: int = 20,
              temperature: float = 0.07, chunk: int = 1024,
              num_classes: int = 0, device: DeviceLike = None) -> np.ndarray:
    """The weighted votes (n_test, classes) of the k nearest train rows by
    cosine similarity, exp(sim / T) each (eval_knn.knn_classifier's
    probs).  The train features are normalized once; the test features
    go through in chunks of `chunk` rows."""
    dev = resolve_device(device)
    num_classes = max(num_classes, int(train_labels.max()) + 1)
    train_f = _l2n(torch.as_tensor(train_features, dtype=torch.float32,
                                   device=dev))
    train_l = torch.as_tensor(train_labels, dtype=torch.long, device=dev)
    votes = []
    with torch.inference_mode():
        for i in range(0, len(test_features), chunk):
            tf = torch.as_tensor(test_features[i:i + chunk],
                                 dtype=torch.float32, device=dev)
            dist, idx = torch.topk(_l2n(tf) @ train_f.T, k, dim=1)
            weights = torch.exp(dist / temperature)           # (B, k)
            one_hot = F.one_hot(train_l[idx], num_classes).float()
            votes.append((one_hot * weights[..., None]).sum(1).cpu())
    return torch.cat(votes).numpy()


def knn_classifier(train_features: np.ndarray, train_labels: np.ndarray,
                   test_features: np.ndarray, test_labels: np.ndarray,
                   k: int = 20, temperature: float = 0.07,
                   chunk: int = 1024, device: DeviceLike = None
                   ) -> Tuple[float, float]:
    """Weighted k-NN accuracy (top-1, top-5) in percent, eval_knn's
    semantics; the classes are ranked on the host by numpy."""
    num_classes = int(max(train_labels.max(), test_labels.max())) + 1
    probs = knn_votes(train_features, train_labels, test_features, k,
                      temperature, chunk, num_classes, device)
    order = np.argsort(-probs, axis=1)
    top1 = int(np.sum(order[:, 0] == test_labels))
    top5 = int(np.sum(np.any(order[:, :min(5, k)] == test_labels[:, None],
                             axis=1)))
    total = len(test_labels)
    return 100.0 * top1 / total, 100.0 * top5 / total


def eval_linear_features(intermediate_tokens: List[torch.Tensor],
                         avgpool: bool = False) -> torch.Tensor:
    """The reference linear-probe features (eval_linear.py:166-170): the
    CLS token of the n last blocks, concatenated; with `avgpool` the mean
    of the last block's patch tokens interleaved with it, in torch's
    layout `cat((cls[..., None], avg[..., None]), -1).reshape(B, -1)`
    ([cls_0, avg_0, cls_1, avg_1, ...]), which exists only for n == 1
    (ValueError otherwise, where torch.cat fails).

    intermediate_tokens: n (B, 1 + N, D) tensors, earliest first
    (`vit_intermediate_layers`)."""
    cls = torch.cat([t[:, 0] for t in intermediate_tokens], dim=-1)
    if not avgpool:
        return cls
    if len(intermediate_tokens) != 1:
        raise ValueError("avgpool_patchtokens requires n_last_blocks == 1 "
                         "(eval_linear.py:169 torch.cat shape constraint)")
    avg = intermediate_tokens[-1][:, 1:].mean(dim=1)
    return torch.stack([cls, avg], dim=-1).reshape(cls.shape[0], -1)


def probe_features_from_images(model, images: torch.Tensor,
                               n_last_blocks: int = 4,
                               avgpool: bool = False) -> np.ndarray:
    """(B, H, W, 3) normalized images -> the linear probe's features, from
    the float32 ViT on its device.  ViT-S defaults (n = 4, no avgpool,
    eval_linear.py:256-259); ViT-B takes n = 1, avgpool=True."""
    from sais_tpu_torch.models.vit import vit_intermediate_layers
    with torch.inference_mode():
        toks = vit_intermediate_layers(model, images, n=n_last_blocks)
        return eval_linear_features(toks, avgpool=avgpool).cpu().numpy()


def cosine_decay(lr: float, step: int, steps: int) -> float:
    """optax.cosine_decay_schedule(lr, steps) at `step` (alpha 0): lr *
    (1 + cos(pi * min(step, steps) / steps)) / 2, in float32."""
    frac = np.float32(min(step, steps)) / np.float32(steps)
    return float(np.float32(lr) * np.float32(
        0.5 * (1.0 + math.cos(math.pi * float(frac)))))


def train_linear_probe(train_features: np.ndarray, train_labels: np.ndarray,
                       test_features: np.ndarray, test_labels: np.ndarray,
                       num_classes: int, epochs: int = 20,
                       batch_size: int = 256, lr: float = 0.01,
                       seed: int = 0, device: DeviceLike = None
                       ) -> Dict[str, object]:
    """Linear probe on frozen features (eval_linear.py's recipe): zero
    init, mean cross-entropy, SGD with momentum 0.9 (optax.sgd: m = g +
    0.9 m, p -= lr_t m) and a cosine decay over the real step count, no
    weight decay.  Batches follow numpy's permutation from `seed`; a short
    last batch wraps around to the permutation's start.  Returns
    {"top1": percent, "w": (D, C), "b": (C,)} (numpy)."""
    dev = resolve_device(device)
    d = train_features.shape[1]
    w = torch.zeros((d, num_classes), dtype=torch.float32, device=dev,
                    requires_grad=True)
    b = torch.zeros((num_classes,), dtype=torch.float32, device=dev,
                    requires_grad=True)
    mw, mb = torch.zeros_like(w), torch.zeros_like(b)
    n = len(train_features)
    batch_size = min(batch_size, n)   # a set smaller than a batch trains
    steps = -(-n // batch_size) * epochs   # the loop's real step count
    feats = torch.as_tensor(train_features, dtype=torch.float32, device=dev)
    labels = torch.as_tensor(train_labels, dtype=torch.long, device=dev)
    rng = np.random.default_rng(seed)
    step = 0
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n, batch_size):
            sel = order[i:i + batch_size]
            if len(sel) < batch_size:
                sel = np.concatenate([sel, order[:batch_size - len(sel)]])
            sel = torch.as_tensor(sel, device=dev)
            loss = F.cross_entropy(feats[sel] @ w + b, labels[sel])
            gw, gb = torch.autograd.grad(loss, (w, b))
            rate = cosine_decay(lr, step, steps)
            with torch.no_grad():
                for p, m, g in ((w, mw, gw), (b, mb, gb)):
                    m.mul_(0.9).add_(g)
                    p.sub_(rate * m)
            step += 1
    with torch.no_grad():
        logits = (torch.as_tensor(test_features, dtype=torch.float32,
                                  device=dev) @ w + b).cpu().numpy()
    acc = float(np.mean(np.argmax(logits, 1) == test_labels)) * 100
    return {"top1": acc, "w": w.detach().cpu().numpy(),
            "b": b.detach().cpu().numpy()}
