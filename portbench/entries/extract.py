"""DINO feature extraction: `FeatureExtractor.extract_video` over videos
whose resized uint8 crops come as the native frame pump hands them over
(batches of the extraction batch size, the last one short), features
gathered to the host per video.

Traffic: `batch`, `frame_size`, `pool_frames` (distinct frames drawn from
the seed by `frames.draw` with `frame_grid` and `frame_octaves`, held on
the host), `video_frames` (the lengths of the videos;
every seed runs the same lengths in its own order, each batch from its
own place in the pool), `keep_per_video` (rows of each video kept for the
comparison).

`correct`: the CLS features of a seeded sample of the window's frames
against the reference ViT in float32 on the same frames and weights,
`feat_bias` = |the mean over the frames of (f - ref) . ref / ||ref||^2|,
the features' error along the reference, signed, averaged.  A frame's
error in bf16 is mostly rounding that averages out; W8A8 (the control)
shrinks every frame's features alike and reads five times higher, where
a frame's own relative error reads only 2.5 times higher (PERF.md).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import compare, flops, frames, weights
from portbench.reference import vit as ref_vit
from portbench.reference.precision import float32_exact


class Cell:
    def __init__(self, spec, seed, device, mesh=None):
        self.cfg, self.tr, self.cell = spec["config"], spec["traffic"], \
            spec["cell"]
        self.seed, self.device = seed, device
        self.attempted = self.failed = 0
        self.kept_idx, self.kept_feats = [], []
        self._in_window = False
        self._ref = None
        v = self.cfg["vit"]
        self.frame_flops = flops.vit_forward(
            flops.vit_tokens(v["image_size"], v["patch_size"]),
            v["embed_dim"], v["depth"], int(v["embed_dim"] * v["mlp_ratio"]),
            v["patch_size"] ** 2 * v["in_channels"])

    # -- set-up ---------------------------------------------------------------

    def program(self):
        """The port's extractor around the drawn weights."""
        from sais_tpu_torch.config import (PipelineConfig, PreprocessConfig,
                                           ViTConfig)
        from sais_tpu_torch.infer.pipeline import FeatureExtractor
        from sais_tpu_torch.models.vit import VisionTransformer
        vcfg = ViTConfig(**self.cfg["vit"])
        with torch.device(self.device):
            model = VisionTransformer(vcfg)
        weights.load(model, self.weights)
        pre = PreprocessConfig(**self.cfg["preprocess"])
        pcfg = PipelineConfig(vit=vcfg, preprocess=pre,
                              compute_dtype=self.cfg["extract_dtype"])
        return FeatureExtractor(model, pcfg, batch_size=self.tr["batch"],
                                device=self.device)

    def setup(self):
        from sais_tpu_torch.models.vit import VisionTransformer
        from sais_tpu_torch.config import ViTConfig
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        with torch.device("meta"):
            shapes = weights.module_shapes(VisionTransformer(
                ViTConfig(**self.cfg["vit"])))
        self.weights = weights.draw(shapes, weights.vit_rule, gen)
        self.ex = self.program()
        self.parts.mark("weights, extractor")
        tr = self.tr
        self.pool = frames.draw(gen, tr["pool_frames"], tr["frame_size"],
                                tr["frame_size"], tr["frame_grid"],
                                tr["frame_octaves"]).cpu().numpy()
        self.rng = np.random.default_rng(self.seed)
        self.order = []
        self.parts.mark("frame pool")
        # every distinct video length once (each tail batch shape)
        for n in sorted(set(self.tr["video_frames"])):
            self._video(n)
        self._in_window = True
        self.parts.mark("warm-up videos")

    # -- the window ---------------------------------------------------------

    def _video(self, n: int) -> int:
        from sais_tpu_torch.infer.pipeline import _HostStream
        bs, pool = self.tr["batch"], self.pool
        starts, sizes = [], []
        for i in range(0, n, bs):
            size = min(bs, n - i)
            starts.append(int(self.rng.integers(0, len(pool) - size + 1)))
            sizes.append(size)
        batches = (pool[o:o + m] for o, m in zip(starts, sizes))
        stream = _HostStream(
            batches, lambda b: self.ex.features_resized(
                torch.from_numpy(np.ascontiguousarray(b))), lambda: None)
        feats = self.ex.extract_video("", stream=stream)
        if self._in_window:
            self.attempted += n
            self.failed += int(n - feats.shape[0]) + int(
                (~np.isfinite(feats).all(axis=1)).sum())
            rows = self.rng.choice(n, size=min(n, self.tr["keep_per_video"]),
                                   replace=False)
            pool_idx = np.concatenate([o + np.arange(m)
                                       for o, m in zip(starts, sizes)])
            self.kept_idx.append(pool_idx[rows])
            self.kept_feats.append(feats[rows])
        return n

    def step(self) -> float:
        if not self.order:
            self.order = list(self.rng.permutation(self.tr["video_frames"]))
        return float(self._video(int(self.order.pop())))

    def finish(self) -> float:
        return 0.0

    def useful_flops(self, units: float) -> float:
        return units * self.frame_flops

    def release(self):
        del self.ex

    # -- the comparison -------------------------------------------------------

    def reference_features(self, idx: np.ndarray, block: int = 256
                           ) -> torch.Tensor:
        pre = self.cfg["preprocess"]
        out = []
        with torch.no_grad(), float32_exact():
            for i in range(0, len(idx), block):
                frames = torch.from_numpy(self.pool[idx[i:i + block]]).to(
                    self.device)
                x = ref_vit.normalize_uint8(frames, pre["mean"], pre["std"])
                out.append(ref_vit.features(self.weights, x,
                                            self.cfg["vit"]).cpu())
        return torch.cat(out)

    def sample(self):
        idx = np.concatenate(self.kept_idx)
        feats = np.concatenate(self.kept_feats)
        pick = np.random.default_rng(self.seed + 1).choice(
            len(idx), size=min(len(idx), self.cell["check_frames"]),
            replace=False)
        return idx[pick], torch.from_numpy(feats[pick])

    def check(self, feats=None):
        idx, prog = self.sample()
        feats = prog if feats is None else feats
        if self._ref is None:
            self._ref = self.reference_features(idx)
        return [("feat_bias", compare.feature_bias(feats, self._ref),
                 self.cell["limits"]["feat_bias"])]

    def control(self):
        """The numbers of the program's own lower-precision path, W8A8
        blocks (K8), on the same sampled frames; call before release()."""
        from sais_tpu_torch.models.vit import vit_features
        from sais_tpu_torch.ops.preprocess import normalize_batch
        idx, _ = self.sample()
        out = []
        with torch.no_grad():
            for i in range(0, len(idx), self.tr["batch"]):
                frames = torch.from_numpy(
                    self.pool[idx[i:i + self.tr["batch"]]]).to(self.device)
                x = normalize_batch(frames, self.ex.cfg.preprocess,
                                    self.ex.dtype)
                out.append(vit_features(self.ex.model, x,
                                        quant="int8").float().cpu())
        return self.check(torch.cat(out))
