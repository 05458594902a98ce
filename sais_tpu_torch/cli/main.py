"""Command line of the port: every subcommand of `sais`
(sais_tpu/cli/main.py) with its flags.

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

  python -m sais_tpu_torch.cli.main serve -p <root> --params-dir <dir> \
      --dino-weights <pth> --socket /tmp/sais.sock
  python -m sais_tpu_torch.cli.main request -f <video> --socket ...

keeps the models resident on the card and answers each request with
<root>/results/<video>_gestures.csv (`--rpc ping|stats|shutdown`: the
control calls; `-mod RGB-Flow --flow-jump N --flow-warmup 480x640`: flow
requests).  `eval --segments labels.csv` runs the k-NN and linear probes
over the stored features, `attention --image <png>` / `-f <video>` the
last block's CLS attention maps / overlay video, and `port --params-dir
<dir>` converts folds between params.zip and params.pkl (`--verify`,
`--record`, `--record-all`: the golden digests of real checkpoints).

The parallel options keep the JAX package's meaning on torch.distributed,
one process per device:

- `--data-parallel [N]` (extract, flow, pipeline, serve, train, pretrain):
  N devices of this host (bare: all of them; on `--device cpu`, N gloo
  processes, bare one).  The command runs in N spawned ranks (cuda:i over
  NCCL) that meet through a FileStore in a temporary directory; each
  batch is split over them and rank 0 writes the H5, CSV, checkpoints and
  logs.  serve: rank 0 owns the socket and sends each batch to the others.
- `--seq-parallel N` (decode, steps, pipeline's decode, train): ring
  attention over N ranks; with train `--data-parallel M` the two make one
  (M, N) ('data', 'seq') mesh.
- `--num-slices S` (train): a ('dcn', 'data', 'model') mesh, the ranks
  split in S blocks in order (hosts, as torchrun numbers them).
- `--init-distributed` (train): join the group a launcher set up through
  env:// (torchrun: MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE,
  LOCAL_RANK) instead of spawning, e.g.
  `torchrun --nnodes 2 --nproc-per-node 8 ... -m sais_tpu_torch.cli.main
  train ... --init-distributed --num-slices 2`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
import tempfile
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
    if args.norm == "half":
        # timm ViT_Supervised_ImageNet normalization, 0.5 / 0.5 a channel
        # (extract_representations.py:152-156)
        cfg = dataclasses.replace(cfg, preprocess=dataclasses.replace(
            cfg.preprocess, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)))
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


def load_fold(d: str, cfg):
    """(FullModel, prototypes) of one fold directory: params.pkl +
    prototypes.pkl written by `train` (either package; the JAX pytree), or
    the reference's params.zip + prototypes.zip (`port.weights.
    full_model_from_state` builds the model)."""
    from sais_tpu_torch.port.weights import (full_model_from_state,
                                             full_model_params_from_jax,
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
    return full_model_from_state(sd, cfg.model, f"fold {d}"), protos


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


def _writer() -> bool:
    """Whether this process writes the command's files and prints its
    results: the only one, or rank 0 of a parallel run."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _say(*a, **kw) -> None:
    if _writer():
        print(*a, **kw)


def _extract_mesh(args):
    """The data mesh over every rank (--data-parallel on extract, flow,
    pipeline and serve shards frame / pair batches over the ranks)."""
    if not args.data_parallel:
        return None
    from sais_tpu_torch.parallel.mesh import make_mesh
    return make_mesh()


def _seq_mesh_from_args(args, with_data: bool = False):
    """--seq-parallel N -> a ('data', 'seq') mesh over every rank, or None;
    with_data (train): --data-parallel M folds into its 'data' axis."""
    n = args.seq_parallel or 0
    if n <= 0:
        return None
    import torch.distributed as dist
    from sais_tpu_torch.parallel.sequence import seq_mesh
    return seq_mesh(n, n_data=dist.get_world_size() // n if with_data
                    else 1)


def _train_meshes(args):
    """(data mesh, seq mesh) of `train` (JAX cli/main.py:525-540):
    --seq-parallel (with --data-parallel folded in), else --num-slices
    over hosts, else --data-parallel."""
    if args.seq_parallel:
        return None, _seq_mesh_from_args(args, with_data=True)
    if args.num_slices > 1:
        from sais_tpu_torch.parallel.distributed import multislice_mesh
        return multislice_mesh(args.num_slices), None
    if args.data_parallel or args.init_distributed:
        from sais_tpu_torch.parallel.mesh import make_mesh
        return make_mesh(), None
    return None, None


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


def cmd_frames(args):
    """mp4 -> <root>/images/<video>/frames_%08d.jpg (video_to_frames.sh)."""
    from sais_tpu_torch.io.video import dump_frames
    out = os.path.join(args.path, "images", args.videoname)
    n = dump_frames(os.path.join(args.path, "videos", args.videoname + ".mp4"),
                    out)
    print(f"wrote {n} frames to {out}")


def cmd_paths(args):
    """The reference's path manifests under <root>/paths
    (generate_paths.py)."""
    from sais_tpu_torch.io.manifests import write_manifests
    write_manifests(args.path, [args.videoname])
    print(f"wrote manifests under {os.path.join(args.path, 'paths')}")


def cmd_extract(args):
    from sais_tpu_torch.infer.pipeline import FeatureExtractor
    from sais_tpu_torch.io.feature_store import FeatureStore, rgb_store_path
    cfg = _pipeline_config(args)
    store = rgb_store_path(args.path)
    if not args.force and _already_extracted(store, args.videoname):
        print(f"{args.videoname}: reps exist, skipping (--force to redo)")
        return
    fx = FeatureExtractor(_load_vit(args, cfg), cfg,
                          batch_size=args.batch_size, device=args.device,
                          exact_preprocess=args.exact_preprocess,
                          mesh=_extract_mesh(args))
    t0 = time.time()
    reps = fx.extract_video(_video_path(args))
    dt = time.time() - t0
    if _writer():
        with FeatureStore(store, "a") as fs:
            fs.write_video(args.videoname, reps)
    _say(f"extracted {reps.shape} in {dt:.1f}s "
         f"({reps.shape[0] / dt:.0f} frames/s)")


def cmd_flow(args):
    """RAFT flow -> flow RGB -> DINO flow reps (reference main.sh:18, 24),
    streamed from the video; the pair stride is kept in the store."""
    from sais_tpu_torch.infer.pipeline import FlowExtractor
    from sais_tpu_torch.io.feature_store import FeatureStore, flow_store_path
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
                       iters=args.flow_iters, device=args.device,
                       mesh=_extract_mesh(args))
    save_dir = None
    if args.save_flows:
        # every rank takes the staged route that saving needs (their
        # collectives must match); only rank 0 saves where it was asked
        save_dir = (os.path.join(args.path, "flows", args.videoname)
                    if _writer() else tempfile.mkdtemp(prefix="sais_flows_"))
    t0 = time.time()
    try:
        reps = fx.extract_video(_video_path(args), save_flow_dir=save_dir)
    finally:
        if save_dir is not None and not _writer():
            shutil.rmtree(save_dir, ignore_errors=True)
    dt = time.time() - t0
    if _writer():
        with FeatureStore(store, "a") as fs:
            fs.write_video(args.videoname, reps,
                           attrs={"flow_jump": cfg.window.flow_jump_factor})
    _say(f"extracted flow reps {reps.shape} in {dt:.1f}s")


def cmd_decode(args):
    from sais_tpu_torch.infer.pipeline import GestureDecoder
    from sais_tpu_torch.infer.postprocess import write_rows_csv
    from sais_tpu_torch.io.feature_store import FeatureStore, rgb_store_path
    cfg = _apply_flow_jump(_pipeline_config(args), args, _video_path(args))
    cfg = _reconcile_flow_jump(cfg, args, args.videoname)
    folds = _load_folds(args, cfg)
    with FeatureStore(rgb_store_path(args.path)) as fs:
        rgb = fs.read_video(args.videoname)
    flow = _read_flow(args, cfg, required=False)
    dec = GestureDecoder(folds, cfg, device_batch=args.batch_size,
                         device=args.device,
                         seq_mesh=_seq_mesh_from_args(args))
    rows = dec.decode(args.videoname, rgb, flow)
    if args.save_artifacts:
        art = dec.inference_artifacts(args.videoname, rgb, flow)
    if not _writer():
        return
    out = os.path.join(args.path, "results")
    os.makedirs(out, exist_ok=True)
    dest = os.path.join(out, "Custom_inference_gestures.csv")
    write_rows_csv(rows, dest)
    print(f"wrote {len(rows)} gesture intervals to {dest}")
    if args.save_artifacts:
        # reps_and_labels_<phase> / attention_<phase> (train.py:113-119)
        from sais_tpu_torch.train.checkpoint import save_inference_artifacts
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
    rec = StepRecognizer(GestureDecoder(
        folds, cfg, device=args.device,
        seq_mesh=_seq_mesh_from_args(args)), fps=args.fps)
    rows = rec.recognize(args.videoname, rgb, flow)
    if not _writer():
        return
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


def _check_train_args(args):
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


def _raw_trainer(args, cfg, mcfg, tcfg, fold: int, skill_mode: bool,
                 mesh=None):
    """The raw-video branch's trainer (sais_tpu/cli/main.py:660-700):
    `--dataset vua-ease` only; rep_dim 512 for R3D; the encoder from seed
    5 (an R3D-18, or the pipeline's ViT at float32), frozen unless
    --unfreeze-encoder."""
    from sais_tpu_torch.models.full_model import full_model_init
    from sais_tpu_torch.train.classification import RawClassificationTrainer
    if not skill_mode:
        sys.exit("--data-type raw requires --dataset vua-ease")
    mcfg = dataclasses.replace(
        mcfg, data_type="raw",
        rep_dim=512 if args.encoder == "R3D" else cfg.model.rep_dim)
    model = full_model_init(torch.Generator().manual_seed(2 * fold), mcfg)
    if args.encoder == "R3D":
        from sais_tpu_torch.models.r3d import r3d18_init
        encoder = r3d18_init(torch.Generator().manual_seed(5))
    else:
        from sais_tpu_torch.models.vit import vit_init
        encoder = vit_init(torch.Generator().manual_seed(5), cfg.vit)
    return RawClassificationTrainer(
        mcfg, tcfg, model, encoder, encoder_type=args.encoder,
        freeze_encoder=not args.unfreeze_encoder, device=args.device,
        mesh=mesh)


def _encoder_to_jax(encoder_type: str, sd):
    from sais_tpu_torch.port.weights import (r3d18_params_to_jax,
                                             vit_params_to_jax)
    return (r3d18_params_to_jax(sd) if encoder_type == "R3D"
            else vit_params_to_jax(sd))


def _fit_epochs(trainer, loaders, nepochs: int) -> None:
    """nepochs epochs over train / val / test without early stopping, the
    metrics of each phase printed."""
    from sais_tpu_torch.train.metrics import format_metrics
    for epoch in range(nepochs):
        for phase, make in loaders.items():
            _, m = trainer.run_epoch(make(epoch), phase == "train")
            _say(format_metrics(phase, m))


def _save_fold(savepath: str, result) -> None:
    """A fold's params.pkl / prototypes.pkl / metrics.pkl, from rank 0."""
    from sais_tpu_torch.train.checkpoint import save_training_result
    if _writer():
        save_training_result(savepath, result)


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
            _say(f"Domain: {dom}")
            cmd_train(argparse.Namespace(**{
                **vars(args), "domains": None, "domain": dom,
                "params_subdir": dom if len(args.domains) > 1 else None}))
        return
    from sais_tpu_torch.config import TrainConfig
    from sais_tpu_torch.data import raw
    from sais_tpu_torch.data.collate import segment_batches
    from sais_tpu_torch.data.datasets import (build_segment_dataset,
                                              read_segments)
    from sais_tpu_torch.data.skill import skill_batches
    from sais_tpu_torch.io.feature_store import (FeatureStore,
                                                 flow_store_path,
                                                 rgb_store_path)
    from sais_tpu_torch.models.full_model import (full_model_init,
                                                  prototypes_init)
    from sais_tpu_torch.train.classification import ClassificationTrainer
    from sais_tpu_torch.train.loop import PrototypeTrainer
    _check_train_args(args)
    mesh, smesh = _train_meshes(args)
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
    raw_mode = args.data_type == "raw"
    # raw mode reads JPEG frame directories, not feature stores
    store = None if raw_mode else FeatureStore(rgb_store_path(args.path))
    flow_store = (FeatureStore(flow_store_path(args.path))
                  if use_flow and not raw_mode else None)
    try:
        for fold in range(args.nfolds):
            _say(f"Fold: {fold}")
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

            if raw_mode:
                trainer = _raw_trainer(args, cfg, mcfg, tcfg, fold,
                                       skill_mode, mesh)

                def loader(rows, phase, device=trainer.device):
                    # the reference loader always pairs RGB with flow
                    # JPEGs in the dual-stream raw path
                    train = phase == "train"
                    src = raw.jpeg_frame_source(args.path, dataset="VUA")
                    return lambda epoch=0: raw.raw_batches(
                        rows, src, ds.skill_classes, args.domain, phase,
                        args.batch_size, train, width=args.raw_width,
                        encoder_type=args.encoder, use_flow=use_flow,
                        seed=epoch, tta=not train, device=device)

            loaders = {ph: loader(ds.frames[ph], ph)
                       for ph in ("train", "val", "test") if ds.frames[ph]}
            subdir = getattr(args, "params_subdir", None)
            savepath = os.path.join(args.path, "params",
                                    *((subdir,) if subdir else ()),
                                    f"Fold_{fold}")
            if raw_mode:
                _fit_epochs(trainer, loaders, args.nepochs)
                result = {"model": trainer.snapshot(), "prototypes": protos}
                if not trainer.freeze_encoder:
                    # the JAX package saves the joint {model, encoder}
                    # tree of an unfrozen encoder
                    result["encoder"] = _encoder_to_jax(
                        args.encoder, trainer.encoder_snapshot())
                _save_fold(savepath, result)
                _say(f"saved fold {fold} to {savepath}")
                continue
            if args.task == "Prototypes":
                trainer = PrototypeTrainer(mcfg, tcfg, model, keys, protos,
                                           mesh=mesh, seq_mesh=smesh,
                                           device=args.device)
                result = trainer.fit(loaders, nepochs=args.nepochs, log=_say)
                _save_fold(savepath, result)
                _say(f"saved fold {fold} (best epoch "
                     f"{result['best_epoch']}) to {savepath}")
                continue
            trainer = ClassificationTrainer(mcfg, tcfg, model,
                                            task=args.task, mesh=mesh,
                                            device=args.device)
            _fit_epochs(trainer, loaders, args.nepochs)
            _save_fold(savepath, {"model": trainer.snapshot(),
                                  "prototypes": protos})
            _say(f"saved fold {fold} to {savepath}")
    finally:
        if store is not None:
            store.close()
        if flow_store is not None:
            flow_store.close()


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
                      drop_path_rate=args.drop_path,
                      use_bn_in_head=args.use_bn_in_head)
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
    mesh = None
    if args.data_parallel:
        from sais_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh()
    trainer = DINOTrainer(vit_cfg, dcfg, niter_per_ep=niter,
                          generator=torch.Generator().manual_seed(0),
                          optimizer=args.optimizer, mesh=mesh, device=device)
    outdir = os.path.join(args.path, "pretrain")
    mgr = CheckpointManager(os.path.join(outdir, "ckpt"))
    start_epoch, state = mgr.restore_latest(trainer.state())
    if start_epoch is not None:
        trainer.load_state(state)
        _say(f"resumed from epoch {start_epoch}")
    log_path = os.path.join(outdir, "log.txt")
    hf, wf = (0.8, 0.7) if args.crop_policy == "gronau" else (0.8, 0.8)

    def _border(frame):
        # SurgDataset border removal, on the loader thread (slicing only)
        return center_border_crop(frame[None], hf, wf, args.trim_right)[0]

    for epoch in range(start_epoch or 0, args.nepochs):
        # every rank runs the same stream and crops; each steps on its
        # block of them (DINOTrainer), rank 0 keeps the log and checkpoints
        logger = MetricLogger(jsonl_path=log_path if _writer() else None)
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
        if _writer():
            mgr.save(epoch + 1, trainer.state())
            logger.write_epoch(epoch)
        _say(f"epoch {epoch}: loss {logger.meters['loss'].global_avg:.4f}")
    _say(f"pretraining done; checkpoints in {outdir}")


def cmd_pipeline(args):
    import torch.distributed as dist
    t0 = time.time()
    cmd_extract(args)
    if args.modalities != "RGB":
        cmd_flow(args)
    if dist.is_initialized():
        dist.barrier()   # every rank reads the stores that rank 0 wrote
    cmd_decode(args)
    print(f"total {time.time() - t0:.1f}s")


def cmd_serve(args):
    """Long-lived decode daemon (cli/serve.py): the models stay resident
    on the card and {"video": name} requests are answered over a Unix
    socket."""
    from sais_tpu_torch.cli import serve as serve_lib
    cfg = _pipeline_config(args)
    if args.flow_jump == "auto":
        sys.exit("serve decodes many videos with one window config; pass "
                 "an explicit --flow-jump stride (the daemon extracts flow "
                 "per request at that same stride, so pairing and window "
                 "mapping always agree -- but per-video fps//2 parity "
                 "needs one daemon per fps group)")
    cfg = _apply_flow_jump(cfg, args)
    vit = _load_vit(args, cfg)
    folds = _load_folds(args, cfg)
    raft = None if cfg.model.modalities == "RGB" else _load_raft(args, cfg)
    mesh = _extract_mesh(args)
    svc = serve_lib.DecodeService(
        args.path, cfg, vit, folds, raft, batch_size=args.batch_size,
        exact_preprocess=args.exact_preprocess, pair_batch=args.flow_batch,
        flow_iters=args.flow_iters, device=args.device, mesh=mesh)
    if mesh is not None and not _writer():
        # --data-parallel: rank 0 owns the socket and sends each rank its
        # block of every batch
        svc.follow()
        return
    if mesh is not None:
        svc.lead()
    try:
        print("warming up...")
        svc.warmup()
        if args.flow_warmup:
            # one or more HxW resolutions: a deployment serving several
            # camera formats warms the flow path at each
            for res in args.flow_warmup.split(","):
                h, w = (int(x) for x in res.strip().split("x"))
                print(f"warming up the flow path at {h}x{w}...")
                svc.warmup_flow(h, w)
        serve_lib.serve(svc, args.socket)
    finally:
        if mesh is not None:
            svc.release()


def cmd_request(args):
    """Client of a running `serve` daemon."""
    import json
    from sais_tpu_torch.cli.serve import request
    if not args.rpc and not args.videoname:
        sys.exit("request: -f <videoname> or --rpc <cmd> is required")
    payload = ({"cmd": args.rpc} if args.rpc
               else {"video": args.videoname,
                     "flow": args.modalities != "RGB"})
    print(json.dumps(request(args.socket, payload)))


def cmd_eval(args):
    """Encoder probes over stored features: weighted k-NN and a linear
    probe (eval_knn.py / eval_linear.py).  Labels come from a CSV with
    Video and Label columns (StartFrame / EndFrame optional), features
    from the RGB store; train and test hold disjoint videos (fold 0 of
    the fold-video split)."""
    from sais_tpu_torch.data.datasets import fold_video_split, read_segments
    from sais_tpu_torch.eval.probes import knn_classifier, train_linear_probe
    from sais_tpu_torch.io.feature_store import FeatureStore, rgb_store_path
    rows = read_segments(args.segments)
    videos = list(dict.fromkeys(r["Video"] for r in rows))
    train_v, val_v, _ = fold_video_split(videos, fold=0)
    train_v = set(train_v) | set(val_v)
    feats, labels, is_train = [], [], []
    with FeatureStore(rgb_store_path(args.path)) as fs:
        for row in rows:
            reps = fs.read_video(row["Video"])
            s = int(row.get("StartFrame", 0))
            e = int(row.get("EndFrame", len(reps)))
            # clamped to the stored rep count, so that a frame-count drift
            # cannot misalign features and labels
            s = max(0, min(s, len(reps)))
            e = max(s, min(e, len(reps)))
            if e == s:
                continue
            feats.append(reps[s:e])
            labels.append(np.full(e - s, row["Label"]))
            is_train.append(np.full(e - s, row["Video"] in train_v))
    feats = np.concatenate(feats)
    names = sorted(set(np.concatenate(labels).tolist()))
    y = np.asarray([names.index(v) for v in np.concatenate(labels)])
    tr = np.concatenate(is_train)
    if tr.all() or not tr.any():
        sys.exit("eval needs labels from at least two videos so train and "
                 "test can hold disjoint videos")
    top1, top5 = knn_classifier(feats[tr], y[tr], feats[~tr], y[~tr], k=20,
                                device=args.device)
    lin = train_linear_probe(feats[tr], y[tr], feats[~tr], y[~tr],
                             num_classes=len(names), epochs=10,
                             device=args.device)
    print(f"knn top1 {top1:.2f} top5 {top5:.2f} | linear top1 "
          f"{lin['top1']:.2f}")


def cmd_port(args):
    """Checkpoints between the reference's torch layout and the pickles
    both packages read.

    --params-dir with params.zip / prototypes.zip -> params.pkl /
    prototypes.pkl (the reverse where only the .pkl files exist).
    --verify CKPT --kind vit|raft|full: probe a real reference checkpoint
    against its recorded digest (port/verify.py); --record CKPT writes the
    digest; --record-all DIR records every checkpoint found there by its
    published name."""
    import pickle
    from sais_tpu_torch.port import verify as verify_lib
    if args.record_all:
        found = verify_lib.discover_checkpoints(args.record_all)
        if not found:
            sys.exit(f"no checkpoints discovered under {args.record_all}; "
                     "expected dino_deitsmall16_pretrain.pth, a "
                     "*raft*.ckpt, and/or Fold_*/params.zip")
        for kind in ("vit", "raft", "full"):
            if kind in found:
                dest = verify_lib.record(found[kind], kind,
                                         golden_dir=args.golden_dir,
                                         device=args.device)
                sha = verify_lib.file_sha256(found[kind])[:16]
                print(f"{kind}: recorded {dest} from {found[kind]} "
                      f"(sha256 {sha}…)")
            else:
                print(f"{kind}: NOT FOUND — fetch from "
                      f"{verify_lib.CHECKPOINT_URLS[kind]}")
        print("commit the recorded .npz digests; `port --verify <ckpt> "
              "--kind <kind>` then asserts <=1e-3 agreement anywhere")
        return
    if args.verify or args.record:
        ckpt = args.verify or args.record
        if not args.kind:
            sys.exit("port --verify/--record needs --kind {vit,raft,full}")
        if args.record:
            dest = verify_lib.record(ckpt, args.kind,
                                     golden_dir=args.golden_dir,
                                     device=args.device)
            print(f"recorded golden digest {dest} "
                  f"(sha256 {verify_lib.file_sha256(ckpt)[:16]}…)")
        else:
            errs = verify_lib.verify(ckpt, args.kind,
                                     golden_dir=args.golden_dir,
                                     device=args.device)
            for name, err in errs.items():
                print(f"{args.kind}/{name}: max|Δ| = {err:.3e} "
                      f"(tol {verify_lib.ATOL})")
            print(f"port verified: {ckpt}")
        return
    from sais_tpu_torch.port.weights import (full_model_params_from_torch,
                                             load_checkpoint,
                                             prototypes_from_torch)
    from sais_tpu_torch.train.checkpoint import (export_torch_prototypes,
                                                 export_torch_state_dict,
                                                 load_training_result)
    d = args.params_dir
    if not any(os.path.exists(os.path.join(d, f))
               for f in ("params.zip", "params.pkl")):
        d = os.path.join(d, "Fold_0")
    if os.path.exists(os.path.join(d, "params.zip")):
        params = full_model_params_from_torch(
            load_checkpoint(os.path.join(d, "params.zip")))
        _, protos = prototypes_from_torch(
            load_checkpoint(os.path.join(d, "prototypes.zip")))
        with open(os.path.join(d, "params.pkl"), "wb") as f:
            pickle.dump(params, f)
        with open(os.path.join(d, "prototypes.pkl"), "wb") as f:
            pickle.dump(protos, f)
        print(f"converted torch -> native under {d}")
    else:
        res = load_training_result(d)
        protos = np.asarray(res["prototypes"])
        sd = export_torch_state_dict(res["params"])
        pd_ = export_torch_prototypes(
            [str(i) for i in range(protos.shape[0])], protos)
        torch.save({k: torch.tensor(v) for k, v in sd.items()},
                   os.path.join(d, "params.zip"))
        torch.save({k: torch.tensor(v) for k, v in pd_.items()},
                   os.path.join(d, "prototypes.zip"))
        print(f"converted native -> torch under {d}")


def cmd_attention(args):
    """DINO CLS-attention visualization (the reference's dino-main tools),
    the float32 ViT on the card.

    --image <path>: per-head heatmap PNGs (and mass-threshold masks with
    --attn-threshold), as visualize_attention.py:179-213.
    -f <videoname>: an attention-overlay mp4, as video_generation.py."""
    from sais_tpu_torch import resolve_device
    from sais_tpu_torch.ops.preprocess import preprocess_batch
    cfg = _pipeline_config(args)
    device = resolve_device(args.device)
    model = _load_vit(args, cfg).float().to(device).eval()
    outdir = os.path.join(args.path, "results")
    os.makedirs(outdir, exist_ok=True)
    if args.image:
        from PIL import Image
        from sais_tpu_torch.eval.attention_viz import (cls_attention_maps,
                                                       save_attention_pngs,
                                                       threshold_masks,
                                                       upsample_maps)
        img = np.array(Image.open(args.image).convert("RGB"))
        x = preprocess_batch(torch.from_numpy(img[None]).to(device),
                             cfg.preprocess, torch.float32)
        maps = cls_attention_maps(model, x)
        stem = os.path.splitext(os.path.basename(args.image))[0]
        prefix = os.path.join(outdir, f"{stem}_attn")
        paths = save_attention_pngs(maps, prefix, cfg.vit.patch_size)
        if args.attn_threshold is not None:
            masks = upsample_maps(threshold_masks(maps, args.attn_threshold),
                                  cfg.vit.patch_size)
            for h in range(masks.shape[1]):
                mp = f"{prefix}_mask_th{args.attn_threshold}_head{h}.png"
                Image.fromarray(
                    (masks[0, h] * 255).astype(np.uint8)).save(mp)
                paths.append(mp)
        print(f"wrote {len(paths)} maps under {prefix}_*.png")
        return
    if not args.videoname:
        sys.exit("attention: --image <path> or -f <videoname> is required")
    from sais_tpu_torch.eval.video_generation import attention_video
    dest = os.path.join(outdir, f"{args.videoname}_attention.mp4")
    n = attention_video(model, _video_path(args), dest, pre=cfg.preprocess,
                        batch_size=args.batch_size, alpha=args.alpha,
                        threshold=args.attn_threshold)
    print(f"wrote {n} frames to {dest}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sais_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in [("frames", cmd_frames), ("paths", cmd_paths),
                     ("extract", cmd_extract), ("flow", cmd_flow),
                     ("decode", cmd_decode), ("pipeline", cmd_pipeline),
                     ("assess", cmd_assess), ("steps", cmd_steps),
                     ("train", cmd_train), ("pretrain", cmd_pretrain),
                     ("eval", cmd_eval), ("port", cmd_port),
                     ("serve", cmd_serve), ("request", cmd_request),
                     ("attention", cmd_attention)]:
        sp = sub.add_parser(name)
        sp.set_defaults(fn=fn)
        sp.add_argument("-f", "--videoname",
                        required=(name not in ("train", "pretrain", "eval",
                                               "port", "serve", "request",
                                               "attention")))
        sp.add_argument("--socket", default="/tmp/sais.sock",
                        help="serve / request: the daemon's Unix socket")
        sp.add_argument("--rpc", choices=["ping", "shutdown", "stats"],
                        help="request: a control call")
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
        # attention visualization (visualize_attention.py /
        # video_generation.py equivalents)
        sp.add_argument("--image", default=None,
                        help="attention: visualize one image instead of a "
                             "video (per-head heatmap PNGs, reference "
                             "visualize_attention.py --image_path)")
        sp.add_argument("--attn-threshold", type=float, default=None,
                        help="attention: also write the mass-threshold "
                             "masks keeping this fraction of attention "
                             "(visualize_attention.py --threshold, "
                             "reference value 0.6); on videos, masks the "
                             "heat overlay")
        sp.add_argument("--alpha", type=float, default=0.5,
                        help="attention video: overlay blend weight "
                             "(video_generation.py default)")
        sp.add_argument("--flow-warmup", default=None, metavar="HxW[,HxW...]",
                        help="serve: run the fused flow path once at "
                             "these video resolutions (e.g. 240x320) so the "
                             "first flow request pays no warm-up; every "
                             "other command ignores it")
        sp.add_argument("--params-dir",
                        help="trained folds: Fold_<i>/params.pkl and "
                             "prototypes.pkl (either package's `train`), "
                             "or reference Fold_<i>/params.zip and "
                             "prototypes.zip")
        sp.add_argument("--verify", default=None, metavar="CKPT",
                        help="port: probe a real reference checkpoint "
                             "against the committed golden digest "
                             "(needs --kind)")
        sp.add_argument("--record", default=None, metavar="CKPT",
                        help="port: record the golden digest from a "
                             "verified checkpoint (needs --kind)")
        sp.add_argument("--record-all", default=None, metavar="DIR",
                        help="port: discover the three published "
                             "checkpoints under DIR by name and record "
                             "every golden digest in one run")
        sp.add_argument("--kind", choices=["vit", "raft", "full"],
                        default=None,
                        help="port --verify/--record: checkpoint family")
        sp.add_argument("--golden-dir", default=None,
                        help="port: override the golden digest directory")
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
        sp.add_argument("--exact-preprocess", action="store_true",
                        help="extract: crop, resize and normalize on the "
                             "host CPU (PIL-exact, as the device route), "
                             "then copy normalized frames to the device; "
                             "native decode off (the reference transform "
                             "stack's parity route; slower)")
        sp.add_argument("--norm", default="imagenet",
                        choices=["imagenet", "half"],
                        help="feature-extraction normalization: imagenet "
                             "stats for ViT_SelfSupervised_* encoders, "
                             "half = 0.5/0.5 for the timm "
                             "ViT_Supervised_ImageNet variant "
                             "(extract_representations.py:145-162)")
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
                        help="decode / steps / train: ring attention over "
                             "an N-rank 'seq' mesh (one process a device); "
                             "each window's time axis split over the ranks")
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
                        help="raw: train on 16-frame JPEG snippets with a "
                             "frozen encoder (prepare_dataset.py:1795-1990)")
        sp.add_argument("--encoder", default="R3D", choices=["R3D", "ViT"],
                        help="raw-path encoder (run_experiments.py -m)")
        sp.add_argument("--raw-width", type=int, default=112,
                        help="raw snippet resize width (R3D default 112)")
        sp.add_argument("--unfreeze-encoder", action="store_true",
                        help="raw path: train the R3D/ViT encoder jointly "
                             "with the head (the reference CLI default "
                             "without -fe; our default matches -fe = "
                             "frozen, prepare_model.py:112-124)")
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
                        help="BatchNorm1d after each hidden head linear "
                             "(main_dino.py --use_bn_in_head, default off); "
                             "runs the plain head and loss")
        sp.add_argument("--data-parallel", type=int, nargs="?", const=-1,
                        default=0, metavar="M",
                        help="extract / flow / pipeline / serve / train / "
                             "pretrain: split batches over M devices of "
                             "this host, one process each (bare: all; "
                             "--device cpu: M gloo processes, bare 1); with "
                             "train --seq-parallel N the two make one (M, "
                             "N) ('data', 'seq') mesh")
        sp.add_argument("--num-slices", type=int, default=1,
                        help="train over S hosts with a ('dcn', 'data', "
                             "'model') mesh: the ranks split in S blocks "
                             "in order")
        sp.add_argument("--init-distributed", action="store_true",
                        help="train: join the process group a launcher "
                             "(torchrun) describes in the environment, "
                             "instead of spawning one process a device")
    return p


def _devices(args) -> Optional[int]:
    """Devices of this host for the parallel flags: the card count, or
    None on the CPU (any number of gloo processes)."""
    return None if args.device == "cpu" else torch.cuda.device_count()


def _dp_count(args) -> int:
    """--data-parallel -> ranks: bare = every device (one on the CPU), N
    = N, with JAX's refusal past the devices there are."""
    dp, avail = args.data_parallel, _devices(args)
    if dp < 0:
        return avail or 1
    if avail is not None and dp > avail:
        raise SystemExit(f"--data-parallel {dp} exceeds the {avail} "
                         "available devices")
    return dp


def _ranks(args) -> int:
    """How many ranks the command runs in; 0: no process group."""
    cmd = args.fn.__name__
    seq, dp = args.seq_parallel or 0, args.data_parallel or 0
    if cmd == "cmd_train":
        if seq > 0:
            avail = _devices(args)
            n_data = 1
            if dp:
                n_data = dp if dp > 0 else max((avail or seq) // seq, 1)
            if avail is not None and seq * n_data > avail:
                raise SystemExit(
                    f"--seq-parallel {seq} x --data-parallel {n_data} "
                    f"exceeds the {avail} available devices")
            return seq * n_data
        if args.num_slices > 1:
            return _dp_count(args) if dp else (_devices(args) or 1)
        return _dp_count(args) if dp else 0
    if cmd in ("cmd_decode", "cmd_steps"):
        return seq
    if cmd == "cmd_pipeline" and dp and seq:
        n = _dp_count(args)
        if n != seq:
            raise SystemExit(f"pipeline runs extract and decode in one "
                             f"group: --data-parallel {n} and --seq-parallel "
                             f"{seq} must agree")
        return n
    if cmd == "cmd_pipeline" and seq:
        return seq
    if cmd in ("cmd_extract", "cmd_flow", "cmd_pipeline", "cmd_serve",
               "cmd_pretrain") and dp:
        n = _dp_count(args)
        if cmd == "cmd_pretrain" and args.batch_size % n:
            # at the CLI, not mid-epoch: every loader batch is -bs frames
            sys.exit(f"-bs {args.batch_size} does not divide over the "
                     f"{n}-device mesh; use a multiple of {n}")
        return n
    return 0


def _rank_entry(args) -> None:
    """A spawned rank: the command, with the host's CPU threads shared
    out over the ranks (never more than the process already has)."""
    import torch.distributed as dist
    if args.device == "cpu":
        share = (os.cpu_count() or 1) // dist.get_world_size()
        torch.set_num_threads(max(1, min(torch.get_num_threads(), share)))
    args.fn(args)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from sais_tpu_torch.parallel import distributed
    device_type = "cpu" if args.device == "cpu" else "cuda"
    if args.init_distributed:
        distributed.initialize(device_type)
        args.fn(args)
        return
    n = _ranks(args)
    if n:
        distributed.run_ranks(_rank_entry, n, device_type, args)
    else:
        args.fn(args)


if __name__ == "__main__":
    main()
