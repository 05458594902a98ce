"""Command line of the port: `extract`, `decode`, `pipeline -mod RGB` and
`steps`, with the flags of `sais` (sais_tpu/cli/main.py).

  python -m sais_tpu_torch.cli.main pipeline -f <video> -p <root> -mod RGB \
      --random-init

reads <root>/videos/<video>.mp4, writes DINO features to
<root>/results/ViT_SelfSupervised_ImageNet_RepsAndLabels.h5 and the
gesture intervals to <root>/results/Custom_inference_gestures.csv
(`decode --save-artifacts` also writes the per-window reps, probabilities
and attention under <root>/params/Fold_0).

  python -m sais_tpu_torch.cli.main steps -f <video> -p <root> -mod RGB \
      --random-init --stride-divisor 4096 --flash on

recognizes steps over full-length 10 s / 5 s windows of the stored
features (stride 1) with the temporal attention on K2, and writes
<root>/results/<video>_steps.csv.  Everything runs on the card
(`--device cuda`, the default) unless `--device cpu` is given.

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
    temporal = cfg.model.temporal
    if args.flash != "auto":
        temporal = dataclasses.replace(temporal, use_flash=args.flash == "on")
    if args.max_positions:
        # beyond the reference's 2000-slot pos-emb table
        # (prepare_model.py:67), for full-length windows past the cap
        temporal = dataclasses.replace(temporal,
                                       max_positions=args.max_positions)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, modalities=args.modalities,
                                       nclasses=args.nclasses,
                                       temporal=temporal),
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
        sd = full_model_params_from_reference(
            load_checkpoint(os.path.join(d, "params.zip")))
        # the checkpoint's own table length, as the JAX package takes it
        model = FullModel(dataclasses.replace(
            cfg.model, temporal=dataclasses.replace(
                cfg.model.temporal, max_positions=len(sd["frame_pos"]))))
        model.load_state_dict(sd)
        _, protos = prototypes_from_reference(
            load_checkpoint(os.path.join(d, "prototypes.zip")))
        folds.append((model, protos))
    return folds


def _check_ported(args):
    if args.modalities != "RGB":
        raise NotImplementedError(
            f"-mod {args.modalities}: the flow stream (RAFT, flow "
            "rendering) is not ported yet; use -mod RGB")
    if args.seq_parallel:
        raise NotImplementedError(
            f"--seq-parallel {args.seq_parallel}: sequence-parallel ring "
            "attention is not ported yet; one card runs full-length "
            "windows on K2 (--flash on)")


def cmd_extract(args):
    from sais_tpu_torch.infer.pipeline import FeatureExtractor
    from sais_tpu_torch.io.feature_store import FeatureStore, rgb_store_path
    _check_ported(args)
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
    from sais_tpu_torch.infer.postprocess import write_rows_csv
    from sais_tpu_torch.io.feature_store import FeatureStore, rgb_store_path
    _check_ported(args)
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
    write_rows_csv(rows, dest)
    print(f"wrote {len(rows)} gesture intervals to {dest}")
    if args.save_artifacts:
        # reps_and_labels_<phase> / attention_<phase> (train.py:113-119)
        from sais_tpu_torch.train.checkpoint import save_inference_artifacts
        art = dec.inference_artifacts(args.videoname, rgb)
        save_inference_artifacts(
            os.path.join(args.path, "params", "Fold_0"), "Custom_inference",
            {"reps": art["reps"], "probs": art["probs"],
             "videonames": art["videonames"]},
            attention=art["attention"])
        print("wrote inference artifacts under params/Fold_0")


def cmd_steps(args):
    """Sub-phase (step) recognition over a full-length video: 10 s / 5 s
    sliding windows (prepare_dataset.py:459-486), fold-ensembled."""
    from sais_tpu_torch.data.tasks import step_window_config
    from sais_tpu_torch.infer.pipeline import GestureDecoder
    from sais_tpu_torch.infer.postprocess import write_rows_csv
    from sais_tpu_torch.infer.skill import StepRecognizer
    from sais_tpu_torch.io.feature_store import FeatureStore, rgb_store_path
    _check_ported(args)
    args.nclasses = 3    # the step classes NH / ND / NW
    cfg = _pipeline_config(args)
    window = step_window_config(args.fps)
    if args.stride_divisor:
        window = dataclasses.replace(window,
                                     stride_divisor=args.stride_divisor)
    cfg = dataclasses.replace(cfg, window=window)
    folds = _load_folds(args, cfg)
    with FeatureStore(rgb_store_path(args.path)) as fs:
        rgb = fs.read_video(args.videoname)
    rec = StepRecognizer(GestureDecoder(folds, cfg, device=args.device),
                         fps=args.fps)
    rows = rec.recognize(args.videoname, rgb)
    dest = os.path.join(args.path, "results", f"{args.videoname}_steps.csv")
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    write_rows_csv(rows, dest, rec.columns)
    print(f"wrote {len(rows)} step windows to {dest}")


def cmd_pipeline(args):
    t0 = time.time()
    cmd_extract(args)
    cmd_decode(args)
    print(f"total {time.time() - t0:.1f}s")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sais_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in [("extract", cmd_extract), ("decode", cmd_decode),
                     ("pipeline", cmd_pipeline), ("steps", cmd_steps)]:
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
        sp.add_argument("--save-artifacts", action="store_true",
                        help="decode: also write the reps_and_labels / "
                             "attention artifacts under params/Fold_0")
        sp.add_argument("--flash", default="auto",
                        choices=["auto", "on", "off"],
                        help="flash attention (K2) in the temporal encoder; "
                             "auto = on a CUDA device for windows of >= 512 "
                             "tokens.  When it runs, saved attention "
                             "artifacts hold the CLS-query row instead of "
                             "the full (L, L) matrix")
        sp.add_argument("--seq-parallel", type=int, default=0, metavar="N",
                        help="not ported yet (sequence-parallel ring "
                             "attention); any N > 0 is refused")
        sp.add_argument("--stride-divisor", type=int, default=None,
                        help="steps: per-window frame subsampling divisor "
                             "(reference span // 10); 4096 gives stride 1, "
                             "full-length windows")
        sp.add_argument("--fps", type=float, default=20.0,
                        help="steps: video fps for the 10 s / 5 s windows "
                             "(prepare_dataset.py:471-473)")
        sp.add_argument("--max-positions", type=int, default=0, metavar="N",
                        help="temporal pos-emb table size (default: the "
                             "reference's 2000); raise it for windows of "
                             "more than 2000 frames")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
