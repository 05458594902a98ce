"""Faults planted in the program underneath a run, to show that its
comparison catches them (`tests/test_portbench_faults.py` on the CPU) and
to read what each fault makes of the numbers compared at a cell's own size
(`controls.py --fault`).  Each is a context manager that patches the
port's code in this process and restores it on exit."""

from __future__ import annotations

import contextlib
import importlib

import torch


@contextlib.contextmanager
def _patched(module: str, attr: str, make):
    mod = importlib.import_module(module.rsplit(":", 1)[0])
    owner = mod
    if ":" in module:
        owner = getattr(mod, module.rsplit(":", 1)[1])
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


# -- extraction ---------------------------------------------------------------

def extract_answer_altered():
    """One frame of every batch gets another frame's features."""
    def make(orig):
        def broken(model, images, *a, **kw):
            out = orig(model, images, *a, **kw).clone()
            out[0] = out[-1]
            return out
        return broken
    return _patched("sais_tpu_torch.infer.pipeline", "vit_features", make)


def extract_half_batch():
    """The ViT runs on the first half of every batch; the rest repeat it."""
    def make(orig):
        def broken(model, images, *a, **kw):
            h = max(1, images.shape[0] // 2)
            return orig(model, images[:h], *a, **kw).repeat(
                2, 1)[:images.shape[0]]
        return broken
    return _patched("sais_tpu_torch.infer.pipeline", "vit_features", make)


# -- temporal training ------------------------------------------------------

def temporal_state_unchanged():
    """The step computes its loss and gradients but updates nothing."""
    def make(orig):
        def broken(self, batch):
            self.optimizer.step = lambda *a, **kw: None
            return orig(self, batch)
        return broken
    return _patched("sais_tpu_torch.train.loop:PrototypeTrainer",
                    "train_step", make)


def temporal_half_batch():
    """The loss is the mean over the first half of the batch's videos."""
    def make(orig):
        def broken(reps, prototypes, cols):
            h = reps.shape[0] // 2
            return orig(reps[:h], prototypes, cols[:h])
        return broken
    return _patched("sais_tpu_torch.train.loop", "nce_loss", make)


def temporal_answer_altered():
    """The step's probabilities come back for the wrong videos."""
    def make(orig):
        def broken(self, reps):
            return orig(self, reps).flip(0)
        return broken
    return _patched("sais_tpu_torch.train.loop:PrototypeTrainer", "_probs",
                    make)


# -- DINO ---------------------------------------------------------------------

def dino_state_unchanged():
    """The step runs whole, then its student, teacher, center and
    optimizer state are put back."""
    def make(orig):
        def broken(self, g, loc):
            keep = ({n: p.detach().clone()
                     for n, p in self.student.named_parameters()},
                    {n: p.detach().clone()
                     for n, p in self.teacher.named_parameters()},
                    self.center.clone(), self.opt_state)
            loss = orig(self, g, loc)
            with torch.no_grad():
                for net, saved in ((self.student, keep[0]),
                                   (self.teacher, keep[1])):
                    for n, p in net.named_parameters():
                        p.copy_(saved[n])
            self.center, self.opt_state = keep[2], keep[3]
            return loss
        return broken
    return _patched("sais_tpu_torch.train.dino:DINOTrainer", "step_async",
                    make)


def dino_half_batch():
    """The second half of the batch's images is replaced by the first half
    (every crop), so the loss is the mean over the first half."""
    def make(orig):
        def broken(self, g, loc):
            cfg = self.cfg
            out = []
            for x, n in ((g, cfg.n_global_crops), (loc, cfg.n_local_crops)):
                b = x.shape[0] // n
                h = (b // 2) * n
                x = x.clone()
                x[h:2 * h] = x[:h]
                out.append(x)
            return orig(self, *out)
        return broken
    return _patched("sais_tpu_torch.train.dino:DINOTrainer", "step_async",
                    make)


def dino_answer_altered():
    """The loss terms miscounted: the sum over the pairs of a global crop
    and another crop divided by n_global x n_crops, not n_global x
    (n_crops - 1), so the loss and its gradients come out 10% low at 2 + 8
    crops."""
    def make(orig):
        def broken(self, hs, ht, temp):
            loss, center = orig(self, hs, ht, temp)
            n = self.cfg.n_global_crops + self.cfg.n_local_crops
            return loss * (n - 1) / n, center
        return broken
    return _patched("sais_tpu_torch.train.dino:DINOTrainer", "head_loss",
                    make)


def exchange_left_out():
    """Every rank keeps its own gradients: the all-reduce is skipped."""
    return _patched("sais_tpu_torch.parallel.mesh", "all_reduce_grads",
                    lambda orig: (lambda params, group=None: None))


FAULTS = {
    "extract": {"answer_altered": extract_answer_altered,
                "half_batch": extract_half_batch},
    "temporal_train": {"state_unchanged": temporal_state_unchanged,
                       "half_batch": temporal_half_batch,
                       "answer_altered": temporal_answer_altered},
    "dino_pretrain": {"state_unchanged": dino_state_unchanged,
                      "half_batch": dino_half_batch,
                      "answer_altered": dino_answer_altered,
                      "exchange_left_out": exchange_left_out},
}
