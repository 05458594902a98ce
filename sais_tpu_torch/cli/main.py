"""Command line of the port: `extract`, `decode` and `pipeline -mod RGB`,
with the flags of `sais` (sais_tpu/cli/main.py).

  python -m sais_tpu_torch.cli.main pipeline -f <video> -p <root> -mod RGB \
      --random-init

reads <root>/videos/<video>.mp4, writes DINO features to
<root>/results/ViT_SelfSupervised_ImageNet_RepsAndLabels.h5 and the
gesture intervals to <root>/results/Custom_inference_gestures.csv.
Everything runs on the card (`--device cuda`, the default) unless
`--device cpu` is given.

Checkpoints: --dino-weights takes the reference
dino_deitsmall16_pretrain.pth; --params-dir takes reference folds
(Fold_<i>/params.zip + prototypes.zip).  --random-init runs freshly
initialized models from fixed seeds.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch

from sais_tpu_torch.config import PipelineConfig


def _pipeline_config(args) -> PipelineConfig:
    cfg = PipelineConfig()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, modalities=args.modalities,
                                       nclasses=args.nclasses),
        compute_dtype=args.dtype)


def _load_vit(args, cfg):
    from sais_tpu_torch.models.vit import VisionTransformer, vit_init
    from sais_tpu_torch.port.weights import load_dino_weights
    if args.dino_weights:
        model = VisionTransformer(cfg.vit)
        model.load_state_dict(load_dino_weights(args.dino_weights))
        return model
    if not args.random_init:
        sys.exit("need --dino-weights or --random-init")
    return vit_init(torch.Generator().manual_seed(0), cfg.vit)


def _load_folds(args, cfg):
    from sais_tpu_torch.models.full_model import (FullModel, full_model_init,
                                                  prototypes_init)
    from sais_tpu_torch.port.weights import (full_model_params_from_reference,
                                             load_checkpoint,
                                             prototypes_from_reference)
    if not args.params_dir:
        if not args.random_init:
            sys.exit("need --params-dir or --random-init")
        model = full_model_init(torch.Generator().manual_seed(1), cfg.model)
        _, protos = prototypes_init(torch.Generator().manual_seed(2),
                                    args.nclasses, cfg.model.proj_dim)
        return [(model, protos)]
    folds = []
    for fold in range(args.nfolds):
        d = os.path.join(args.params_dir, f"Fold_{fold}")
        if os.path.exists(os.path.join(d, "params.pkl")):
            sys.exit(f"{d} holds a fold trained by the JAX package "
                     "(params.pkl), which only the JAX package reads; "
                     "decode it with `sais decode`, or pass reference "
                     "folds (params.zip + prototypes.zip)")
        model = FullModel(cfg.model)
        model.load_state_dict(full_model_params_from_reference(
            load_checkpoint(os.path.join(d, "params.zip"))))
        _, protos = prototypes_from_reference(
            load_checkpoint(os.path.join(d, "prototypes.zip")))
        folds.append((model, protos))
    return folds


def _check_modalities(args):
    if args.modalities != "RGB":
        raise NotImplementedError(
            f"-mod {args.modalities}: the flow stream (RAFT, flow "
            "rendering) is not ported yet; use -mod RGB")


def cmd_extract(args):
    from sais_tpu_torch.infer.pipeline import FeatureExtractor
    from sais_tpu_torch.io.feature_store import FeatureStore, rgb_store_path
    _check_modalities(args)
    cfg = _pipeline_config(args)
    store = rgb_store_path(args.path)
    if not args.force and os.path.exists(store):
        with FeatureStore(store) as fs:
            if args.videoname in fs.videos():
                print(f"{args.videoname}: reps exist, skipping (--force to "
                      "redo)")
                return
    fx = FeatureExtractor(_load_vit(args, cfg), cfg,
                          batch_size=args.batch_size, device=args.device)
    t0 = time.time()
    reps = fx.extract_video(os.path.join(args.path, "videos",
                                         args.videoname + ".mp4"))
    dt = time.time() - t0
    with FeatureStore(store, "a") as fs:
        fs.write_video(args.videoname, reps)
    print(f"extracted {reps.shape} in {dt:.1f}s "
          f"({reps.shape[0] / dt:.0f} frames/s)")


def cmd_decode(args):
    from sais_tpu_torch.infer.pipeline import GestureDecoder
    from sais_tpu_torch.infer.postprocess import write_gestures_csv
    from sais_tpu_torch.io.feature_store import FeatureStore, rgb_store_path
    _check_modalities(args)
    cfg = _pipeline_config(args)
    folds = _load_folds(args, cfg)
    with FeatureStore(rgb_store_path(args.path)) as fs:
        rgb = fs.read_video(args.videoname)
    dec = GestureDecoder(folds, cfg, device_batch=args.batch_size,
                         device=args.device)
    rows = dec.decode(args.videoname, rgb)
    out = os.path.join(args.path, "results")
    os.makedirs(out, exist_ok=True)
    dest = os.path.join(out, "Custom_inference_gestures.csv")
    write_gestures_csv(rows, dest)
    print(f"wrote {len(rows)} gesture intervals to {dest}")


def cmd_pipeline(args):
    t0 = time.time()
    cmd_extract(args)
    cmd_decode(args)
    print(f"total {time.time() - t0:.1f}s")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sais_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in [("extract", cmd_extract), ("decode", cmd_decode),
                     ("pipeline", cmd_pipeline)]:
        sp = sub.add_parser(name)
        sp.set_defaults(fn=fn)
        sp.add_argument("-f", "--videoname", required=True)
        sp.add_argument("-p", "--path", default=".")
        sp.add_argument("--dino-weights")
        sp.add_argument("--params-dir",
                        help="reference folds: Fold_<i>/params.zip and "
                             "prototypes.zip")
        sp.add_argument("--random-init", action="store_true")
        sp.add_argument("--nfolds", type=int, default=1)
        sp.add_argument("--nclasses", type=int, default=2)
        sp.add_argument("-mod", "--modalities", default="RGB",
                        help="RGB (the flow stream is not ported yet)")
        sp.add_argument("-bs", "--batch-size", type=int, default=256)
        sp.add_argument("--dtype", default="bfloat16",
                        choices=["bfloat16", "float32"])
        sp.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
        sp.add_argument("--force", action="store_true",
                        help="re-extract features that already exist")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
