"""Command line of the port: `extract`, `flow`, `decode`, `pipeline`,
`steps`, `assess`, `train` and `pretrain`, with the flags of `sais`
(sais_tpu/cli/main.py).

  python -m sais_tpu_torch.cli.main pipeline -f <video> -p <root> \
      -mod RGB-Flow --random-init

reads <root>/videos/<video>.mp4, writes DINO features to
<root>/results/ViT_SelfSupervised_ImageNet_RepsAndLabels.h5, RAFT flow
features (RAFT over frame pairs --flow-jump frames apart, the flow
rendered to RGB, then the ViT) to
<root>/results/ViT_SelfSupervised_ImageNet_FlowRepsAndLabels.h5 and the
gesture intervals to <root>/results/Custom_inference_gestures.csv
(`-mod RGB` skips the flow stream; `flow --save-flows` also writes the
rendered flows as <root>/flows/<video>/flows_%08d.jpg; `decode
--save-artifacts` writes the per-window reps, probabilities and attention
under <root>/params/Fold_0).

  python -m sais_tpu_torch.cli.main steps -f <video> -p <root> -mod RGB \
      --random-init --stride-divisor 4096 --flash on

recognizes steps over full-length 10 s / 5 s windows of the stored
features (stride 1) with the temporal attention on K2, and writes
<root>/results/<video>_steps.csv.

  python -m sais_tpu_torch.cli.main train -p <root> --segments segs.csv \
      -bc -e 50 -bs 2 -lr 0.1 --flash auto

trains the Prototypes task on the stored features of the segments
(Video / StartFrame / EndFrame / Gesture) with the reference's fold-video
split, one fold per --nfolds, and writes <root>/params/Fold_<k>/params.pkl,
prototypes.pkl and metrics.pkl in the JAX package's layout
(`--split-policy per-gesture-video / louo / instance`: the reference's
other splits; `--dataset vua-gestures -d X_vs_Y` (else Top4) and `dvc-ucl`:
the gesture-timestamp tables, Path / StartFrame / EndFrame / Gesture;
`-t MIL / ClassificationHead`: the classification tasks, -e epochs
without early stopping; `-mod Flow / RGB-Flow` read the flow store;
`--no-self-attention`: snippets are plain frame means; `-dim`: the
features' width).

  python -m sais_tpu_torch.cli.main train -p <root> --dataset vua-ease \
      --segments VUA_EASE_Stitch_Paths.csv -d NH_02 -il \
      --explanations expl1.csv expl2.csv -bc -e 50 -bs 2

trains skill assessment over EASE stitch annotations (`-d A+B`: one model
over two domains, the second through the linearB head; `--domains`: one
model per domain under params/<domain>/Fold_<k>; `-il`: the frame
importance loss; `-bg` / `-sg` with `--meta`: surgeon / patient group
balancing; `--dataset vua-ease-stitch` (`-tf`): the NH / ND / NW sub-phase
task); `-mod Flow` / `RGB-Flow` read the flow store.

  python -m sais_tpu_torch.cli.main assess -f <video> -p <root> \
      --segments VUA_EASE_Stitch_Paths.csv --phase USC_inference -d NH_02 \
      --params-dir <root>/params --nclasses 2

assesses skill over the video's stitch segments with every fold and
writes <root>/results/<video>_skill_fold<k>.csv and, under
<root>/params/Fold_<k>, reps_and_labels_<phase>.pkl, attention_<phase>.pkl
and importance_<phase>.pkl (the reference's inference artifacts).

  python -m sais_tpu_torch.cli.main pretrain -p <root> -bs 64 -e 100

DINO self-supervised pre-training of a ViT-S/16 (--arch: also the patch-8
ViT-S/8 and ViT-B/8, 785 tokens a global crop, and ViT-B/16) over the frames
of every <root>/videos/*.mp4 (--source flows: the rendered flow images of
every <root>/flows/<video>/; border crop, globally shuffled batches,
multi-crop augmentation on the device), the student backbone on K4-K6 and
the teacher on K1; restartable checkpoints under <root>/pretrain/ckpt and
per-epoch log lines in <root>/pretrain/log.txt.

Everything runs on the card (`--device cuda`, the default) unless
`--device cpu` is given.

Checkpoints: --dino-weights takes the reference
dino_deitsmall16_pretrain.pth; --raft-weights a RAFT 'things' checkpoint
(princeton-vl or ptlflow); --params-dir takes folds trained by either
package (Fold_<i>/params.pkl + prototypes.pkl) or reference folds
(Fold_<i>/params.zip + prototypes.zip).  --random-init runs freshly
initialized models from fixed seeds.

Commands and options that are not ported yet are refused, and the message
names the ROADMAP.md item, by its title, that brings them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Optional

import numpy as np
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


def _load_raft(args, cfg):
    """RAFT: --raft-weights (a plain state_dict or a ptlflow-style
    {'state_dict': ...} wrapper) or, only with --random-init, random
    weights, which make meaningless flow."""
    from sais_tpu_torch.models.raft import RAFT, raft_init
    from sais_tpu_torch.port.weights import (load_checkpoint,
                                             raft_state_from_reference)
    if args.raft_weights:
        model = RAFT(cfg.raft)
        model.load_state_dict(raft_state_from_reference(
            load_checkpoint(args.raft_weights)))
        return model.eval()
    if not args.random_init:
        sys.exit("need --raft-weights or --random-init")
    return raft_init(torch.Generator().manual_seed(3), cfg.raft)


# the members decoding does not read (the MIL task's)
_MIL_MEMBERS = ("clip_cls", "clip_pos", "clip_encoder", "attentionA",
                "attentionB", "attention_modules", "final_modules")


def load_fold(d: str, cfg):
    """(FullModel, prototypes) of one fold directory: params.pkl +
    prototypes.pkl written by `train` (either package; the JAX pytree), or
    the reference's params.zip + prototypes.zip.  The model keeps the
    checkpoint's own positional-table length, and has the importance and
    linearB heads exactly when the checkpoint has them, as the JAX package
    does.  A fold without the clip and MIL members (the port's Prototypes
    folds before it carried them) loads with those members zero."""
    from sais_tpu_torch.models.full_model import FullModel
    from sais_tpu_torch.port.weights import (full_model_params_from_jax,
                                             full_model_params_from_reference,
                                             load_checkpoint,
                                             prototypes_from_reference)
    from sais_tpu_torch.train.checkpoint import load_training_result
    if os.path.exists(os.path.join(d, "params.pkl")):
        res = load_training_result(d)
        sd = full_model_params_from_jax(res["params"])
        protos = torch.as_tensor(np.asarray(res["prototypes"], np.float32))
    else:
        sd = full_model_params_from_reference(
            load_checkpoint(os.path.join(d, "params.zip")))
        _, protos = prototypes_from_reference(
            load_checkpoint(os.path.join(d, "prototypes.zip")))
    mcfg = dataclasses.replace(
        cfg.model, importance_head="importance.weight" in sd,
        multi_task="linearB.weight" in sd,
        temporal=dataclasses.replace(
            cfg.model.temporal, max_positions=len(sd["frame_pos"])))
    if "cls_head.weight" in sd:
        mcfg = dataclasses.replace(mcfg, data_type="raw",
                                   nclasses=len(sd["cls_head.weight"]))
    nmil = len({k.split(".")[1] for k in sd
                if k.startswith("final_modules.")})
    if nmil:
        mcfg = dataclasses.replace(mcfg, n_attention_classes=nmil)
    model = FullModel(mcfg)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    # a fold the port wrote before it carried the clip encoder and the MIL
    # modules has only the Prototypes path's members, which decoding reads
    absent = [k for k in missing if k.split(".")[0] not in _MIL_MEMBERS]
    if absent or unexpected:
        raise RuntimeError(f"fold {d}: missing {absent}, unexpected "
                           f"{unexpected}")
    with torch.no_grad():
        for name in missing:
            model.get_parameter(name).zero_()
    return model, protos


def _load_folds(args, cfg):
    from sais_tpu_torch.models.full_model import (full_model_init,
                                                  prototypes_init)
    if not args.params_dir:
        if not args.random_init:
            sys.exit("need --params-dir or --random-init")
        model = full_model_init(torch.Generator().manual_seed(1), cfg.model)
        _, protos = prototypes_init(torch.Generator().manual_seed(2),
                                    args.nclasses, cfg.model.proj_dim)
        return [(model, protos)]
    return [load_fold(os.path.join(args.params_dir, f"Fold_{fold}"), cfg)
            for fold in range(args.nfolds)]


def _check_ported(args):
    if args.seq_parallel:
        raise NotImplementedError(
            f"--seq-parallel {args.seq_parallel}: sequence-parallel ring "
            "attention is not ported yet (ROADMAP.md Queue 1, "
            "'Parallelism, on torch.distributed'); one card runs "
            "full-length windows on K2 (--flash on)")
    if args.data_parallel:
        raise NotImplementedError(
            "--data-parallel: data-parallel extraction and training are not "
            "ported yet; they come with torch.distributed DDP (ROADMAP.md "
            "Queue 1, 'Parallelism, on torch.distributed'); one card runs "
            "without it")


def _apply_flow_jump(cfg, args, video_path: Optional[str] = None):
    """Resolve --flow-jump into cfg.window.flow_jump_factor for every
    consumer: flow extraction and the window -> flow row mapping of
    decode / steps must agree on the stride.  'auto' is fps // 2 of the
    source video (extract_representations.py:437-463)."""
    if not args.flow_jump:
        return cfg
    if args.flow_jump == "auto":
        if video_path is None or not os.path.exists(video_path):
            sys.exit("--flow-jump auto needs the source video to read fps "
                     f"from ({video_path or 'no path available'} not "
                     "found); pass an explicit stride")
        from sais_tpu_torch.io.video import VideoReader
        with VideoReader(video_path) as r:
            jump = max(int(r.fps // 2), 1)
        print(f"flow jump {jump} (fps {2 * jump})")
    else:
        jump = int(args.flow_jump)
    return dataclasses.replace(cfg, window=dataclasses.replace(
        cfg.window, flow_jump_factor=jump))


def _reconcile_flow_jump(cfg, args, videoname: str):
    """Adopt or validate the pair stride `flow` recorded in the flow store:
    the store's rows are indexed frame // jump at the extraction stride, so
    decoding at another stride would gather the wrong flow rows.  With no
    --flow-jump the stored stride is adopted; a contradicting one exits."""
    from sais_tpu_torch.io.feature_store import FeatureStore, flow_store_path
    if cfg.model.modalities == "RGB":
        return cfg
    path = flow_store_path(args.path)
    if not os.path.exists(path):
        return cfg
    with FeatureStore(path) as fs:
        stored = fs.video_attr(videoname, "flow_jump")
    if stored is None:      # a store without the attr: trust the flags
        return cfg
    stored = int(stored)
    if cfg.window.flow_jump_factor == stored:
        args.flow_jump = str(stored)
        return cfg
    if args.flow_jump:
        sys.exit(f"--flow-jump {cfg.window.flow_jump_factor} contradicts "
                 f"the stride {videoname}'s flow reps were extracted at "
                 f"({stored}); re-extract with `flow --force --flow-jump "
                 f"{cfg.window.flow_jump_factor}` or pass --flow-jump "
                 f"{stored}")
    print(f"flow jump {stored} (recorded by extraction)")
    args.flow_jump = str(stored)
    return dataclasses.replace(cfg, window=dataclasses.replace(
        cfg.window, flow_jump_factor=stored))


def _already_extracted(store_path: str, videoname: str) -> bool:
    """Skip a video whose reps exist (extract_representations.py:485)."""
    from sais_tpu_torch.io.feature_store import FeatureStore
    if not os.path.exists(store_path):
        return False
    with FeatureStore(store_path) as fs:
        return videoname in fs


def _video_path(args) -> str:
    return os.path.join(args.path, "videos", args.videoname + ".mp4")


def _read_flow(args, cfg, required: bool):
    """The flow reps of the video when the modalities use flow: None for
    -mod RGB, and also when the store is absent unless `required`."""
    from sais_tpu_torch.io.feature_store import FeatureStore, flow_store_path
    path = flow_store_path(args.path)
    if cfg.model.modalities == "RGB" or not (required
                                             or os.path.exists(path)):
        return None
    with FeatureStore(path) as fs:
        return fs.read_video(args.videoname)


def cmd_extract(args):
    from sais_tpu_torch.infer.pipeline import FeatureExtractor
    from sais_tpu_torch.io.feature_store import FeatureStore, rgb_store_path
    _check_ported(args)
    cfg = _pipeline_config(args)
    store = rgb_store_path(args.path)
    if not args.force and _already_extracted(store, args.videoname):
        print(f"{args.videoname}: reps exist, skipping (--force to redo)")
        return
    fx = FeatureExtractor(_load_vit(args, cfg), cfg,
                          batch_size=args.batch_size, device=args.device)
    t0 = time.time()
    reps = fx.extract_video(_video_path(args))
    dt = time.time() - t0
    with FeatureStore(store, "a") as fs:
        fs.write_video(args.videoname, reps)
    print(f"extracted {reps.shape} in {dt:.1f}s "
          f"({reps.shape[0] / dt:.0f} frames/s)")


def cmd_flow(args):
    """RAFT flow -> flow RGB -> DINO flow reps (reference main.sh:18, 24),
    streamed from the video; the pair stride is kept in the store."""
    from sais_tpu_torch.infer.pipeline import FlowExtractor
    from sais_tpu_torch.io.feature_store import FeatureStore, flow_store_path
    _check_ported(args)
    cfg = _pipeline_config(args)
    store = flow_store_path(args.path)
    if not args.force and _already_extracted(store, args.videoname):
        print(f"{args.videoname}: flow reps exist, skipping (--force to "
              "redo)")
        return
    raft = _load_raft(args, cfg)
    vit = _load_vit(args, cfg)
    cfg = _apply_flow_jump(cfg, args, _video_path(args))
    fx = FlowExtractor(raft, vit, cfg, pair_batch=args.flow_batch,
                       iters=args.flow_iters, device=args.device)
    save_dir = (os.path.join(args.path, "flows", args.videoname)
                if args.save_flows else None)
    t0 = time.time()
    reps = fx.extract_video(_video_path(args), save_flow_dir=save_dir)
    dt = time.time() - t0
    with FeatureStore(store, "a") as fs:
        fs.write_video(args.videoname, reps,
                       attrs={"flow_jump": cfg.window.flow_jump_factor})
    print(f"extracted flow reps {reps.shape} in {dt:.1f}s")


def cmd_decode(args):
    from sais_tpu_torch.infer.pipeline import GestureDecoder
    from sais_tpu_torch.infer.postprocess import write_rows_csv
    from sais_tpu_torch.io.feature_store import FeatureStore, rgb_store_path
    _check_ported(args)
    cfg = _apply_flow_jump(_pipeline_config(args), args, _video_path(args))
    cfg = _reconcile_flow_jump(cfg, args, args.videoname)
    folds = _load_folds(args, cfg)
    with FeatureStore(rgb_store_path(args.path)) as fs:
        rgb = fs.read_video(args.videoname)
    flow = _read_flow(args, cfg, required=False)
    dec = GestureDecoder(folds, cfg, device_batch=args.batch_size,
                         device=args.device)
    rows = dec.decode(args.videoname, rgb, flow)
    out = os.path.join(args.path, "results")
    os.makedirs(out, exist_ok=True)
    dest = os.path.join(out, "Custom_inference_gestures.csv")
    write_rows_csv(rows, dest)
    print(f"wrote {len(rows)} gesture intervals to {dest}")
    if args.save_artifacts:
        # reps_and_labels_<phase> / attention_<phase> (train.py:113-119)
        from sais_tpu_torch.train.checkpoint import save_inference_artifacts
        art = dec.inference_artifacts(args.videoname, rgb, flow)
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
    cfg = _apply_flow_jump(cfg, args, _video_path(args))
    cfg = _reconcile_flow_jump(cfg, args, args.videoname)
    folds = _load_folds(args, cfg)
    with FeatureStore(rgb_store_path(args.path)) as fs:
        rgb = fs.read_video(args.videoname)
    flow = _read_flow(args, cfg, required=True)
    rec = StepRecognizer(GestureDecoder(folds, cfg, device=args.device),
                         fps=args.fps)
    rows = rec.recognize(args.videoname, rgb, flow)
    dest = os.path.join(args.path, "results", f"{args.videoname}_steps.csv")
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    write_rows_csv(rows, dest, rec.columns)
    print(f"wrote {len(rows)} step windows to {dest}")


# the key that carries a segments row's label in the CSV through `assess`
_ROW_LABEL = "\0row"


def cmd_assess(args):
    """Skill assessment over annotated stitch segments (-f video):
    EASE-domain probabilities + frame-importance + CLS attention, exported
    in the reference's inference-artifact layout (train.py:113-121)."""
    from sais_tpu_torch.data.datasets import read_segments
    from sais_tpu_torch.data.reference_datasets import vua_ease_window
    from sais_tpu_torch.data.skill import (EASE_INFERENCE_PHASES,
                                           ease_inference_table, with_video)
    from sais_tpu_torch.infer.postprocess import write_rows_csv
    from sais_tpu_torch.infer.skill import SkillAssessor
    from sais_tpu_torch.io.feature_store import FeatureStore, rgb_store_path
    from sais_tpu_torch.train.checkpoint import save_inference_artifacts
    _check_ported(args)
    if not args.segments:
        sys.exit("assess needs --segments <csv> (stitch rows, or StartFrame "
                 "/ EndFrame / RACE)")
    cfg = _apply_flow_jump(_pipeline_config(args), args, _video_path(args))
    cfg = _reconcile_flow_jump(cfg, args, args.videoname)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, importance_head=True))
    folds = _load_folds(args, cfg)
    # each row keeps its line number in the CSV, the label pandas gives it
    segments = [dict(r, **{_ROW_LABEL: i}) for i, r in
                enumerate(read_segments(args.segments))]
    if segments and "Path" in segments[0]:
        segments = with_video(segments)
    if (args.phase in EASE_INFERENCE_PHASES and segments
            and {"RACE", "EASE", "maj"} <= set(segments[0])):
        # reference phase-table selection for cross-hospital inference
        # (prepare_dataset.py:304-380): RACE/EASE filter, maj remap, and
        # the phase's sampling/balancing — applied over the WHOLE stitch
        # CSV (the per-video sampling depends on every video's rows)
        # before restricting to this video
        segments = ease_inference_table(segments, args.phase, args.domain)
    rows = [r for r in segments if str(r["Video"]) == args.videoname]
    if not rows:
        sys.exit(f"no segments for video {args.videoname} in "
                 f"{args.segments}")
    if "StartFrame" not in rows[0]:
        # stitch-schema CSV (per-RACE frame columns): derive the
        # race-specific windows exactly like the reference
        # (getStartAndEndFrame; data/reference_datasets.vua_ease_window)
        spans = [vua_ease_window(r["RACE"], r) for r in rows]
        if any(isinstance(v, float) for span in spans for v in span):
            spans = [tuple(float(v) for v in span) for span in spans]
        rows = [dict(r, StartFrame=a, EndFrame=b)
                for r, (a, b) in zip(rows, spans)]
    labels = [r.pop(_ROW_LABEL) for r in rows]
    with FeatureStore(rgb_store_path(args.path)) as fs:
        rgb = fs.read_video(args.videoname)
    flow = _read_flow(args, cfg, required=True)
    assessor = None
    for fold, (model, protos) in enumerate(folds):
        if assessor is None:
            assessor = SkillAssessor(model, protos, cfg, device=args.device)
        else:
            assessor.set_fold(model, protos)
        art = assessor.assess_segments(
            rgb, flow, rows, phase=args.phase, videoname=args.videoname,
            # reference flow-jump selection per phase unless the user
            # explicitly overrode the stride
            flow_jump=(cfg.window.flow_jump_factor if args.flow_jump
                       else None))
        savepath = os.path.join(args.path, "params", f"Fold_{fold}")
        save_inference_artifacts(
            savepath, args.phase,
            {"reps": art["reps"], "probs": art["probs"],
             "videonames": [args.videoname] * len(rows)},
            attention=art["attention"],
            importance=art["importance"] or None)
        mean_probs = np.mean([np.stack(art["probs"][t])
                              for t in sorted(art["probs"])], axis=0)
        out = [dict(r, **{f"prob_{c}": p[c] for c in range(len(p))})
               for r, p in zip(rows, mean_probs)]
        dest = os.path.join(args.path, "results",
                            f"{args.videoname}_skill_fold{fold}.csv")
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        write_rows_csv(out, dest, index=labels)
        print(f"fold {fold}: wrote {dest} + artifacts under {savepath}")


def _check_train_ported(args):
    """`train` runs every branch of the JAX package on stored reps; the
    raw-video path comes with a later slice (ROADMAP.md Queue 1)."""
    _check_ported(args)
    if args.data_type != "reps":
        raise NotImplementedError(
            f"--data-type {args.data_type}: not ported yet; raw-video "
            "training (R3D / ViT snippets) comes with the raw-video path "
            "(ROADMAP.md Queue 1, 'The rest')")
    if not args.segments:
        sys.exit("train needs --segments <csv> (Video, StartFrame, "
                 "EndFrame, Gesture)")


def _skill_dataset(args, segments, fold: int):
    """The EASE skill or stitch branch's SegmentDataset for one fold, with
    the JAX package's checks and messages for bad flag combinations
    (sais_tpu/cli/main.py:541-600)."""
    from sais_tpu_torch.data.datasets import SegmentDataset, read_segments
    if args.dataset == "vua-ease-stitch":
        # VUA_EASE_Stitch sub-phase recognition branch
        # (prepare_dataset.py:428-568): same annotations, label = EASE
        # domain (NH vs ND vs NW)
        from sais_tpu_torch.data.reference_datasets import stitch_phase_tables
        frames, classes = stitch_phase_tables(
            segments, fold, training_fraction=args.training_fraction)
        return SegmentDataset(frames, list(classes), list(classes))
    # VUA_EASE skill branch (prepare_dataset.py:63-426): RACE/EASE
    # filters, 0.9/0.1 fold split, explanation-derived importance
    from sais_tpu_torch.data.skill import build_ease_dataset
    if args.balance_groups and args.single_group:
        sys.exit("-bg and -sg are mutually exclusive "
                 "(prepare_dataset.py:281-287 asserts this)")
    if (args.balance_groups or args.single_group) \
            and not args.balance_classes:
        sys.exit("-bg/-sg require -bc: the reference applies group "
                 "balancing/restriction only inside the "
                 "balance==True branch (prepare_dataset.py:281-291)")
    meta = None
    use_group = args.balance_groups or args.single_group
    if use_group:
        from sais_tpu_torch.data.reference_datasets import prepare_usc_meta
        if not args.meta:
            sys.exit("--balance-groups/--single-group need --meta <csv>")
        meta = prepare_usc_meta(read_segments(args.meta))
    explanations = ([read_segments(p) for p in args.explanations]
                    if args.importance_loss else None)
    frames, classes = build_ease_dataset(
        segments, args.domain, fold, balance=args.balance_classes,
        explanations=explanations, importance_loss=args.importance_loss,
        meta=meta, group=args.group if use_group else None,
        group_val=args.single_group)
    return SegmentDataset(frames, [str(c) for c in classes], classes)


def _gesture_dataset(args, segments, fold: int):
    """The gesture-timestamp branches (prepare_dataset.py:1283-1395,
    :1396-1500): vua-gestures (-d X_vs_Y, else Top4) and dvc-ucl, the
    Gesture labels as str and the classes in their int order."""
    from sais_tpu_torch.data.datasets import SegmentDataset
    from sais_tpu_torch.data.reference_datasets import (dvc_ucl_tables,
                                                        vua_gestures_tables)
    if args.dataset == "vua-gestures":
        frames, classes = vua_gestures_tables(
            segments, args.domain if "_vs_" in args.domain else "Top4",
            fold, balance=args.balance_classes)
    else:
        frames, classes = dvc_ucl_tables(segments, fold,
                                         balance=args.balance_classes)
    return SegmentDataset(
        {ph: [dict(r, Gesture=str(r["Gesture"])) for r in frames[ph]]
         for ph in ("train", "val", "test")}, [str(c) for c in classes])


def _policy_dataset(args, segments, fold: int):
    """--dataset segments under a named reference split policy
    (data/reference_datasets.py); the classes are the whole table's."""
    from sais_tpu_torch.data.datasets import SegmentDataset, _unique
    from sais_tpu_torch.data.reference_datasets import (
        instance_split, leave_one_user_out_split, per_gesture_video_split)
    classes = sorted(_unique(r["Gesture"] for r in segments))
    if args.split_policy == "per-gesture-video":
        parts = per_gesture_video_split(segments, fold,
                                        balance=args.balance_classes)
    elif args.split_policy == "louo":
        parts = leave_one_user_out_split(segments, fold)
    else:
        parts = instance_split(segments, balance=args.balance_classes)
    return SegmentDataset(dict(zip(("train", "val", "test"), parts)),
                          classes)


def cmd_train(args):
    """Training over domains x folds (run_experiments.py:85-116): per fold,
    the dataset's split and class balancing, then -t Prototypes:
    PrototypeTrainer with early stopping, the best snapshot saved under
    params/[<domain>/]Fold_<k>; -t MIL / ClassificationHead: nepochs
    epochs of ClassificationTrainer, no early stopping, the last model
    saved with the fold's fresh prototypes, as the JAX package does."""
    if args.domains:
        # reference -domains loop (run_experiments.py:44,85-90): one
        # invocation trains every domain; artifacts nest per domain
        for dom in args.domains:
            print(f"Domain: {dom}")
            cmd_train(argparse.Namespace(**{
                **vars(args), "domains": None, "domain": dom,
                "params_subdir": dom if len(args.domains) > 1 else None}))
        return
    from sais_tpu_torch.config import TrainConfig
    from sais_tpu_torch.data.collate import segment_batches
    from sais_tpu_torch.data.datasets import (build_segment_dataset,
                                              read_segments)
    from sais_tpu_torch.data.skill import skill_batches
    from sais_tpu_torch.io.feature_store import (FeatureStore,
                                                 flow_store_path,
                                                 rgb_store_path)
    from sais_tpu_torch.models.full_model import (full_model_init,
                                                  prototypes_init)
    from sais_tpu_torch.train.checkpoint import save_training_result
    from sais_tpu_torch.train.classification import ClassificationTrainer
    from sais_tpu_torch.train.loop import PrototypeTrainer
    from sais_tpu_torch.train.metrics import format_metrics
    _check_train_ported(args)
    skill_mode = args.dataset == "vua-ease"
    stitch_mode = args.dataset == "vua-ease-stitch"
    if args.training_fraction < 1 and not stitch_mode:
        sys.exit("-tf only applies to --dataset vua-ease-stitch (and the "
                 "library-level NS_vs_VUA tables): the reference subsamples "
                 "the train split only in those branches "
                 "(prepare_dataset.py:549, :703)")
    if args.importance_loss:
        if not skill_mode:
            sys.exit("--importance-loss requires --dataset vua-ease "
                     "(explanations are EASE stitch annotations)")
        if not args.explanations:
            sys.exit("--importance-loss needs --explanations <csv> [...]")
    cfg = _pipeline_config(args)
    segments = read_segments(args.segments)
    use_flow = cfg.model.modalities != "RGB"
    store = FeatureStore(rgb_store_path(args.path))
    flow_store = (FeatureStore(flow_store_path(args.path)) if use_flow
                  else None)
    try:
        for fold in range(args.nfolds):
            print(f"Fold: {fold}")
            if skill_mode or stitch_mode:
                ds = _skill_dataset(args, segments, fold)
            elif args.dataset in ("vua-gestures", "dvc-ucl"):
                ds = _gesture_dataset(args, segments, fold)
            elif args.split_policy == "fold-video":
                ds = build_segment_dataset(segments, fold,
                                           balance=args.balance_classes)
            else:
                ds = _policy_dataset(args, segments, fold)
            # multi-task '+' domains double the label space (+2 offset for
            # the second domain, prepare_dataset.py:2156-2158)
            multi = skill_mode and "+" in args.domain
            nclasses = len(ds.classes) * (2 if multi else 1)
            mcfg = dataclasses.replace(
                cfg.model, nclasses=nclasses,
                importance_head=args.importance_loss, multi_task=multi,
                self_attention=not args.no_self_attention)
            if args.rep_dim:
                mcfg = dataclasses.replace(
                    mcfg, rep_dim=args.rep_dim, temporal=dataclasses.replace(
                        mcfg.temporal, rep_dim=args.rep_dim))
            # random init from fixed seeds: model 2k, prototypes 2k + 1
            model = full_model_init(torch.Generator().manual_seed(2 * fold),
                                    mcfg)
            keys, protos = prototypes_init(
                torch.Generator().manual_seed(2 * fold + 1), nclasses,
                mcfg.proj_dim)
            tcfg = TrainConfig(lr=args.lr, nepochs=args.nepochs,
                               batch_size=args.batch_size,
                               importance_loss=args.importance_loss)

            def loader(rows, phase):
                # the epoch index seeds the per-epoch reshuffle; val and
                # test carry the 3-way TTA variants
                train = phase == "train"
                if skill_mode:
                    return lambda epoch=0: skill_batches(
                        rows, store, flow_store, ds.skill_classes,
                        args.domain, phase, args.batch_size, train,
                        importance_loss=args.importance_loss, seed=epoch,
                        tta=not train)
                if stitch_mode:
                    return lambda epoch=0: skill_batches(
                        rows, store, flow_store, ds.skill_classes,
                        "NH_vs_ND_vs_NW", phase, args.batch_size, train,
                        seed=epoch, tta=not train, branch="stitch",
                        label_fn=lambda r: ds.skill_classes.index(r["EASE"]))
                return lambda epoch=0: segment_batches(
                    rows, store, ds.classes, cfg.window, args.batch_size,
                    shuffle=train, seed=epoch, tta=not train,
                    flow_store=flow_store)

            loaders = {ph: loader(ds.frames[ph], ph)
                       for ph in ("train", "val", "test") if ds.frames[ph]}
            subdir = getattr(args, "params_subdir", None)
            savepath = os.path.join(args.path, "params",
                                    *((subdir,) if subdir else ()),
                                    f"Fold_{fold}")
            if args.task == "Prototypes":
                trainer = PrototypeTrainer(mcfg, tcfg, model, keys, protos,
                                           device=args.device)
                result = trainer.fit(loaders, nepochs=args.nepochs)
                save_training_result(savepath, result)
                print(f"saved fold {fold} (best epoch "
                      f"{result['best_epoch']}) to {savepath}")
                continue
            trainer = ClassificationTrainer(mcfg, tcfg, model,
                                            task=args.task,
                                            device=args.device)
            for epoch in range(args.nepochs):
                for phase, make in loaders.items():
                    _, m = trainer.run_epoch(make(epoch), phase == "train")
                    print(format_metrics(phase, m))
            save_training_result(savepath, {"model": trainer.snapshot(),
                                            "prototypes": protos})
            print(f"saved fold {fold} to {savepath}")
    finally:
        store.close()
        if flow_store is not None:
            flow_store.close()


def _check_pretrain_ported(args):
    """`pretrain` runs the video or flow-image source with the fused
    student backbone and, on the card, the fused last layer + loss (K7);
    what it refuses is listed in ROADMAP.md with the slice that brings
    it."""
    if args.data_parallel:
        raise NotImplementedError(
            "--data-parallel: data-parallel pre-training is not ported yet; "
            "it comes with torch.distributed DDP and K7's per-shard wrapper "
            "(ROADMAP.md Queue 1, 'Parallelism, on torch.distributed')")
    if args.use_bn_in_head:
        raise NotImplementedError(
            "--use-bn-in-head: the BatchNorm DINO head is not ported yet; "
            "it comes with its own slice (ROADMAP.md Queue 1, 'The "
            "BatchNorm DINO head')")


def cmd_pretrain(args):
    """DINO self-supervised pre-training over surgical video frames
    (reference dino-main/main_dino.py train path, VUA fine-tuning recipe):
    frames stream from every mp4 under <root>/videos (--source flows: the
    rendered flows_%08d.jpg of every <root>/flows/<video>, the reference's
    --optical_flow_to_reps mode, main_dino.py:254-257), augmentation is
    the device multi-crop pipeline, checkpoints resume transparently."""
    import glob

    from sais_tpu_torch import resolve_device
    from sais_tpu_torch.io.shuffle_stream import FrameShuffleStream
    from sais_tpu_torch.io.video import VideoReader, read_frame_dir
    from sais_tpu_torch.models import zoo
    from sais_tpu_torch.ops.augment import (center_border_crop,
                                            multi_crop_batch)
    from sais_tpu_torch.train.checkpoint import CheckpointManager
    from sais_tpu_torch.train.dino import DINOConfig, DINOTrainer
    from sais_tpu_torch.utils.logging import MetricLogger
    _check_pretrain_ported(args)
    if args.source == "flows":
        videos = sorted(d for d in glob.glob(
            os.path.join(args.path, "flows", "*")) if os.path.isdir(d))
        if not videos:
            sys.exit(f"no flow dirs under {os.path.join(args.path, 'flows')}")
    else:
        videos = sorted(glob.glob(os.path.join(args.path, "videos",
                                               "*.mp4")))
        if not videos:
            sys.exit(f"no videos under {os.path.join(args.path, 'videos')}")
    bs = args.batch_size
    dcfg = DINOConfig(out_dim=args.out_dim, epochs=args.nepochs,
                      batch_size=bs, n_local_crops=args.local_crops,
                      warmup_epochs=min(10, max(args.nepochs // 10, 0)),
                      drop_path_rate=args.drop_path)
    vit_cfg = zoo.config(args.arch)
    device = resolve_device(args.device)

    def _frame_count(v):
        if args.source == "flows":
            return len(glob.glob(os.path.join(v, "*.jpg")))
        with VideoReader(v) as r:
            return r.frame_count

    def _source(v):
        if args.source == "flows":
            return lambda: read_frame_dir(v)

        def it():
            with VideoReader(v) as r:
                yield from r.frames()
        return it

    # steps an epoch from the total frame count
    niter = max(sum(_frame_count(v) for v in videos) // bs, 1)
    trainer = DINOTrainer(vit_cfg, dcfg, niter_per_ep=niter,
                          generator=torch.Generator().manual_seed(0),
                          optimizer=args.optimizer, device=device)
    outdir = os.path.join(args.path, "pretrain")
    mgr = CheckpointManager(os.path.join(outdir, "ckpt"))
    start_epoch, state = mgr.restore_latest(trainer.state())
    if start_epoch is not None:
        trainer.load_state(state)
        print(f"resumed from epoch {start_epoch}")
    log_path = os.path.join(outdir, "log.txt")
    hf, wf = (0.8, 0.7) if args.crop_policy == "gronau" else (0.8, 0.8)

    def _border(frame):
        # SurgDataset border removal, on the loader thread (slicing only)
        return center_border_crop(frame[None], hf, wf, args.trim_right)[0]

    for epoch in range(start_epoch or 0, args.nepochs):
        logger = MetricLogger(jsonl_path=log_path)
        pending = None   # one step in flight: step k's loss is fetched
        # after step k + 1 is enqueued
        stream = FrameShuffleStream(
            [_source(v) for v in videos], bs,
            buffer_frames=args.shuffle_buffer, workers=args.loader_threads,
            seed=epoch, transform=_border)
        with stream:
            for bi, batch in enumerate(stream.batches(drop_last=True)):
                gen = torch.Generator(device=device).manual_seed(
                    hash((epoch, bi)) % (2 ** 31))
                frames = torch.from_numpy(batch).to(device).float() / 255.0
                g, l = multi_crop_batch(gen, frames, dcfg.n_global_crops,
                                        dcfg.n_local_crops, dcfg.global_size,
                                        dcfg.local_size)
                loss_dev = trainer.step_async(g, l)
                if pending is not None:
                    logger.update(loss=trainer.check_loss(pending))
                pending = loss_dev
        if pending is not None:
            logger.update(loss=trainer.check_loss(pending))
        mgr.save(epoch + 1, trainer.state())
        logger.write_epoch(epoch)
        print(f"epoch {epoch}: loss {logger.meters['loss'].global_avg:.4f}")
    print(f"pretraining done; checkpoints in {outdir}")


def cmd_pipeline(args):
    t0 = time.time()
    cmd_extract(args)
    if args.modalities != "RGB":
        cmd_flow(args)
    cmd_decode(args)
    print(f"total {time.time() - t0:.1f}s")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sais_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in [("extract", cmd_extract), ("flow", cmd_flow),
                     ("decode", cmd_decode),
                     ("pipeline", cmd_pipeline), ("steps", cmd_steps),
                     ("assess", cmd_assess), ("train", cmd_train),
                     ("pretrain", cmd_pretrain)]:
        sp = sub.add_parser(name)
        sp.set_defaults(fn=fn)
        sp.add_argument("-f", "--videoname",
                        required=name not in ("train", "pretrain"))
        sp.add_argument("-p", "--path", default=".")
        sp.add_argument("--dino-weights")
        sp.add_argument("--raft-weights",
                        help="RAFT 'things' checkpoint (a state_dict or "
                             "{'state_dict': ...})")
        sp.add_argument("--flow-batch", type=int, default=None,
                        help="RAFT pair batch (default: auto by resolution)")
        sp.add_argument("--flow-iters", type=int, default=None,
                        help="RAFT GRU iterations (default 32, the 'things' "
                             "evaluation setting)")
        sp.add_argument("--flow-jump", default=None,
                        help="flow pair stride: frames, or 'auto' = "
                             "fps // 2 (extract_representations.py:437-463)")
        sp.add_argument("--save-flows", action="store_true",
                        help="flow: also write the rendered flow images as "
                             "flows/<video>/flows_%%08d.jpg (the reference "
                             "saveFlows layout; read by `pretrain --source "
                             "flows`)")
        sp.add_argument("--params-dir",
                        help="trained folds: Fold_<i>/params.pkl and "
                             "prototypes.pkl (either package's `train`), "
                             "or reference Fold_<i>/params.zip and "
                             "prototypes.zip")
        sp.add_argument("--random-init", action="store_true")
        sp.add_argument("--nfolds", type=int, default=1)
        sp.add_argument("--nclasses", type=int, default=2)
        sp.add_argument("-mod", "--modalities", default="RGB",
                        choices=["RGB", "Flow", "RGB-Flow"],
                        help="streams the temporal model reads (train "
                             "--dataset segments: RGB only, training it on "
                             "flow is not ported yet)")
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
        sp.add_argument("--phase", default="inference",
                        help="assess: the phase whose sampling policy, flow "
                             "jump and EASE table apply, and the artifact "
                             "suffix (reps_and_labels_<phase> etc., "
                             "train.py:113-121)")
        # training flags (run_experiments.py:19-46 equivalents)
        sp.add_argument("--segments",
                        help="train: CSV with Video/StartFrame/EndFrame/"
                             "Gesture, or EASE stitch rows (--dataset "
                             "vua-ease / vua-ease-stitch); assess: the "
                             "stitch or segment rows to assess")
        sp.add_argument("-lr", "--lr", type=float, default=0.1)
        sp.add_argument("-e", "--nepochs", type=int, default=50)
        sp.add_argument("-bc", "--balance-classes", action="store_true")
        sp.add_argument("-t", "--task", default="Prototypes",
                        choices=["Prototypes", "MIL", "ClassificationHead"],
                        help="train: the task head; MIL and "
                             "ClassificationHead train nepochs epochs "
                             "without early stopping")
        sp.add_argument("--split-policy", default="fold-video",
                        choices=["fold-video", "per-gesture-video", "louo",
                                 "instance"],
                        help="train --dataset segments: the reference "
                             "split policy (data/reference_datasets.py)")
        sp.add_argument("--dataset", default="segments",
                        choices=["segments", "vua-ease", "vua-ease-stitch",
                                 "vua-gestures", "dvc-ucl"],
                        help="vua-ease: EASE stitch-annotation skill branch; "
                             "vua-ease-stitch: sub-phase (NH/ND/NW) "
                             "recognition over the same annotations; "
                             "vua-gestures/dvc-ucl: gesture-timestamp "
                             "classification branches")
        sp.add_argument("-tf", "--training-fraction", type=float, default=1.0,
                        help="subsample the train split to this fraction "
                             "(run_experiments.py -tf; sample(random_state=0)"
                             ", prepare_dataset.py:549,703)")
        sp.add_argument("--no-self-attention", action="store_true",
                        help="disable the temporal transformer: snippets "
                             "become plain frame means — equivalent to the "
                             "reference CLI WITHOUT -sa "
                             "(prepare_model.py:296-301). Our default "
                             "matches the reference's published commands "
                             "(-sa on). No -sa short alias on purpose: its "
                             "polarity here would be inverted.")
        sp.add_argument("-bg", "--balance-groups", action="store_true",
                        help="balance surgeon/patient groups within classes "
                             "(balanceGroups, prepare_dataset.py:190-213)")
        sp.add_argument("--meta", help="surgeon/patient meta CSV for -bg/-sg")
        sp.add_argument("-sg", "--single-group", nargs="?",
                        const="ProstateLarge60ml", default=None,
                        help="restrict the train split to one group value "
                             "of --group (run_experiments.py:100-103; bare "
                             "-sg uses the reference's hardcoded "
                             "ProstateLarge60ml)")
        sp.add_argument("--group", default="Caseload Group",
                        help="meta column for group balancing")
        sp.add_argument("-dim", "--rep-dim", type=int, default=None,
                        help="representation dim override "
                             "(run_experiments.py -dim; default 384 for "
                             "ViT reps, 512 for the R3D raw path)")
        sp.add_argument("--domains", nargs="+", default=None,
                        help="train several domains in one invocation "
                             "(run_experiments.py -domains); artifacts "
                             "nest under params/<domain>/Fold_<k>")
        sp.add_argument("-d", "--domain", default="NH_02",
                        help="EASE domain, e.g. NH_02 or NH_02+ND_02 "
                             "(run_experiments.py -d)")
        sp.add_argument("-il", "--importance-loss", action="store_true",
                        help="add the frame-importance BCE to the NCE loss "
                             "(run_experiments.py:36, perform_training.py"
                             ":127-130)")
        sp.add_argument("--explanations", nargs="*",
                        help="EASE explanation CSVs (prepare_dataset.py"
                             ":65-77) for --importance-loss")
        sp.add_argument("-dt", "--data-type", default="reps",
                        choices=["reps", "raw"],
                        help="train: reps (raw is not ported yet)")
        # pretraining flags (main_dino.py argparse equivalents)
        sp.add_argument("--out-dim", type=int, default=65536)
        sp.add_argument("--local-crops", type=int, default=8)
        sp.add_argument("--source", default="videos",
                        choices=["videos", "flows"],
                        help="pretrain input: decoded video frames, or the "
                             "rendered flow images of `flow --save-flows`")
        sp.add_argument("--crop-policy", default="default",
                        choices=["default", "gronau"],
                        help="pretrain border removal: 0.8/0.8 center crop, "
                             "or 0.8/0.7 for Gronau videos "
                             "(main_dino.py getCropDims)")
        sp.add_argument("--trim-right", type=int, default=0,
                        help="extra right-hand pixel trim after the border "
                             "crop (VUA_Lab/AFB timer overlay: 130, "
                             "main_dino.py:306-308)")
        sp.add_argument("--arch", default="vits16",
                        help="pretrain backbone geometry: vits16 / vits8 / "
                             "vitb16 / vitb8 or their dino_* aliases (the "
                             "patch-8 ones: 785 tokens a global crop)")
        sp.add_argument("--loader-threads", type=int, default=4,
                        help="parallel decode threads feeding the shuffle "
                             "buffer")
        sp.add_argument("--shuffle-buffer", type=int, default=1024,
                        help="frames held in the shuffle reservoir")
        sp.add_argument("--optimizer", default="adamw",
                        choices=["adamw", "sgd", "lars"])
        sp.add_argument("--drop-path", type=float, default=0.1,
                        help="pretrain: student stochastic-depth rate "
                             "(main_dino.py --drop_path_rate)")
        sp.add_argument("--use-bn-in-head", action="store_true",
                        help="not ported yet (the BatchNorm DINO head)")
        sp.add_argument("--data-parallel", type=int, nargs="?", const=-1,
                        default=0, metavar="M",
                        help="not ported yet (refused)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
