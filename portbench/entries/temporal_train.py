"""Long-window prototype training on stored frame representations:
`PrototypeTrainer.train_step` in a closed loop, each step's loss and
probabilities fetched to the host as `run_epoch` fetches them.

Traffic: `batch` videos a step, `videos` distinct videos of representations
(normal, drawn from the seed, held on the host), their lengths
`min_frames`..`max_frames` spaced evenly (every seed trains the same
lengths, grouped into batches in its own order), each batch padded to
`pad_frames` plus the CLS slot and masked.  The units are the valid frame
tokens stepped.

`correct`: set-up builds the trainer once from the drawn weights and runs
its first three steps through `step()` on three batches of different
videos; after the window the reference follows those three steps from the
same weights.  Compared: each step's loss and probabilities, the first
step's gradient as SGD got it (left in `.grad` after the step), the
change of the parameters over the three steps (both by the worst leaf's
norm gap), and that no parameter the loss does not reach moved.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import compare, flops, weights
from portbench.reference import temporal as ref_temporal
from portbench.reference.precision import float32_exact

FIRST_STEPS = 3


def _host(module, prototypes):
    out = {n: p.detach().cpu().clone() for n, p in module.named_parameters()}
    out["prototypes"] = prototypes.detach().cpu().clone()
    return out


class Cell:
    def __init__(self, spec, seed, device, mesh=None):
        self.cfg, self.tr, self.cell = spec["config"], spec["traffic"], \
            spec["cell"]
        self.seed, self.device = seed, device
        self.attempted = self.failed = 0
        self.i = 0
        self._ref = None

    def _model_config(self):
        from sais_tpu_torch.config import ModelConfig, TemporalConfig
        return ModelConfig(**self.cfg["model"], temporal=TemporalConfig(
            **self.cfg["temporal"]))

    def _data(self, gen):
        tr = self.tr
        n, f, d = tr["videos"], tr["pad_frames"], self.cfg["model"]["rep_dim"]
        lengths = np.linspace(tr["min_frames"], tr["max_frames"],
                              n).round().astype(int)
        rng = np.random.default_rng(self.seed)
        lengths = lengths[rng.permutation(n)]
        reps = torch.randn((n, f, d), generator=gen, device=self.device)
        reps *= (torch.arange(f, device=self.device)[None, :]
                 < torch.as_tensor(lengths, device=self.device)[:, None]
                 )[..., None]
        reps = reps.cpu().numpy()
        labels = rng.integers(0, self.cfg["model"]["nclasses"], size=n)
        self.batches, self.valid = [], []
        for i in range(0, n, tr["batch"]):
            rows = slice(i, i + tr["batch"])
            mask = np.zeros((tr["batch"], 1, f + 1), bool)
            for j, m in enumerate(lengths[rows]):
                mask[j, 0, m + 1:] = True
            self.batches.append({
                "rgb": reps[rows][:, None], "rgb_mask": mask,
                "label_cols": labels[rows].astype(np.int32),
                "labels": labels[rows].astype(np.int32)})
            self.valid.append(lengths[rows])
        self.step_flops = [flops.temporal_train_step(
            v + 1, d, self.cfg["temporal"]["ffn_dim"],
            self.cfg["temporal"]["num_layers"], self.cfg["model"]["proj_dim"])
            for v in self.valid]

    def setup(self):
        from sais_tpu_torch.config import TrainConfig
        from sais_tpu_torch.models.full_model import FullModel
        from sais_tpu_torch.train.loop import PrototypeTrainer
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        mcfg = self._model_config()
        with torch.device(self.device):
            model = FullModel(mcfg)
        self.parts.mark("model")
        shapes = weights.module_shapes(model)
        shapes["prototypes"] = (mcfg.nclasses, mcfg.proj_dim)
        self.w0 = weights.draw(shapes, weights.temporal_rule, gen)
        weights.load(model, self.w0)
        self.parts.mark("weights")
        self.trainer = PrototypeTrainer(
            mcfg, TrainConfig(lr=self.cfg["train"]["lr"],
                              batch_size=self.tr["batch"]), model,
            [str(c) for c in range(mcfg.nclasses)], self.w0["prototypes"],
            device=self.device)
        self.parts.mark("trainer")
        self._data(gen)
        self.parts.mark("representations, batches")
        tr = self.trainer
        self.first = {"loss": [], "probs": []}
        self.p0 = _host(tr.model, tr.prototypes)
        for k in range(FIRST_STEPS):
            self.step()
            if k == 0:
                # the gradients the optimizer got, left in .grad until the
                # next step's zero_grad
                self.g1 = {n: (torch.zeros_like(p) if p.grad is None
                               else p.grad).detach().to("cpu", copy=True)
                           for n, p in tr.model.named_parameters()}
                self.g1["prototypes"] = tr.prototypes.grad.detach().to(
                    "cpu", copy=True)
        self.p3 = _host(tr.model, tr.prototypes)
        self.attempted = 0
        self.parts.mark("first steps, snapshots")

    def step(self) -> float:
        b = self.i % len(self.batches)
        loss, probs = self.trainer.train_step(self.batches[b])
        loss, probs = float(loss), probs.cpu().numpy()
        if self.i < FIRST_STEPS:
            self.first["loss"].append(loss)
            self.first["probs"].append(probs)
        self.i += 1
        self.attempted += 1
        self.failed += int(not np.isfinite(loss))
        return float(self.valid[b].sum())

    def finish(self) -> float:
        return 0.0

    def useful_flops(self, units: float) -> float:
        per_token = sum(self.step_flops) / sum(v.sum() for v in self.valid)
        return units * per_token

    def release(self):
        del self.trainer

    def reference(self, tf32: bool = False):
        """The reference's first steps from the drawn weights: (losses,
        probabilities, first gradients, leaves after the last step)."""
        lr = self.cfg["train"]["lr"]
        dev = self.device
        batches = [{k: torch.as_tensor(v).to(dev) for k, v in b.items()}
                   for b in self.batches[:FIRST_STEPS]]
        w0 = {n: t.to(dev) for n, t in self.p0.items()}
        with float32_exact(tf32), ref_temporal.math_attention():
            steps, final = ref_temporal.train_steps(
                w0, w0["prototypes"], self.cfg["temporal"], batches, lr)
        return ([s[0] for s in steps], [s[1].cpu().numpy() for s in steps],
                {n: g.cpu() for n, g in steps[0][2].items()},
                {n: t.cpu() for n, t in final.items()})

    def check(self, got=None):
        """got: (losses, probabilities, first gradients, leaves after three
        steps) in the program's place (a control); default the
        program's own."""
        if self._ref is None:
            self._ref = self.reference()
        losses, probs, grad, final = self._ref
        if got is None:
            got = (self.first["loss"], self.first["probs"], self.g1, self.p3)
        g_loss, g_probs, g_grad, g_final = got
        quiet = compare.quiet_leaves(grad)
        keep = list(grad)
        unused = max(float((g_final[n] - self.p0[n]).abs().max())
                     for n in g_final if n not in grad)
        lim = self.cell["limits"]
        return [
            ("loss_gap", max(compare.rel_gap(a, r)
                             for a, r in zip(g_loss, losses)),
             lim["loss_gap"]),
            ("probs_gap", max(float(np.abs(p - r).max())
                              for p, r in zip(g_probs, probs)),
             lim["probs_gap"]),
            ("grad_gap", compare.norm_gap({n: g_grad[n] for n in keep},
                                          grad, quiet), lim["grad_gap"]),
            ("change_gap", compare.norm_gap(
                {n: g_final[n] - self.p0[n] for n in keep},
                {n: final[n] - self.p0[n] for n in keep}, quiet),
             lim["change_gap"]),
            ("unreached_moved", unused, 0.0)]

    def control(self):
        """The reference in TF32 (float32 with TF32 off is what the
        configuration states) in the program's place."""
        losses, probs, grad, final = self.reference(tf32=True)
        full = dict(self.p0)
        full.update(final)
        return self.check((losses, probs, grad, full))
