"""Gloo ranks for the port's parallel tests: `run(fn, n, *args)` runs the
module-level fn(tmp, *args) in n spawned CPU processes that form one
torch.distributed group (a FileStore under the test's tmp_path), and
returns what rank 0 stored with `keep`.  Imports no jax: the ranks load
only torch and the port."""

from __future__ import annotations

import os
import pickle
from typing import Any, Callable

import torch


def keep(tmp: str, obj: Any) -> None:
    """Store a picklable result of rank 0 for the test to read."""
    import torch.distributed as dist
    if dist.get_rank() == 0:
        with open(os.path.join(tmp, "rank0.pkl"), "wb") as f:
            pickle.dump(obj, f)


def _entry(fn: Callable, tmp: str, threads: int, args) -> None:
    torch.set_num_threads(threads)
    fn(tmp, *args)


def run(fn: Callable, n: int, tmp, *args: Any) -> Any:
    from sais_tpu_torch.parallel.distributed import run_ranks
    tmp = str(tmp)
    run_ranks(_entry, n, "cpu", fn, tmp, 1, args)
    path = os.path.join(tmp, "rank0.pkl")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        out = pickle.load(f)
    os.unlink(path)
    return out


def cli(tmp: str, argv, pipeline_config=None, zoo=None) -> None:
    """A rank's run of the port's CLI command `argv` (as one of the ranks
    `main` spawns), with the CLI's PipelineConfig replaced by
    `pipeline_config` and zoo entries {name: ViTConfig} by `zoo`, in this
    process."""
    from sais_tpu_torch.cli import main as cli_main
    from sais_tpu_torch.models import zoo as zoo_lib
    saved = cli_main.PipelineConfig, dict(zoo_lib.CONFIGS)
    if pipeline_config is not None:
        cli_main.PipelineConfig = lambda: pipeline_config
    zoo_lib.CONFIGS.update(zoo or {})
    try:
        cli_main._rank_entry(cli_main.build_parser().parse_args(argv))
    finally:   # a world of one runs in the test's own process
        cli_main.PipelineConfig = saved[0]
        zoo_lib.CONFIGS.clear()
        zoo_lib.CONFIGS.update(saved[1])


# -- rank bodies of tests/test_torch_parallel.py ------------------------------

def mesh_layout(tmp: str) -> None:
    """4 ranks: the meshes' shapes, names, sizes, each rank's shard of 16
    rows, and the errors; rank 0 keeps every rank's view."""
    import numpy as np
    import torch.distributed as dist
    from sais_tpu_torch.config import MeshConfig
    from sais_tpu_torch.parallel import distributed as D
    from sais_tpu_torch.parallel import mesh as M
    view = {}
    ms = D.multislice_mesh(2)
    view["ms"] = (tuple(ms.mesh_dim_names), tuple(ms.shape),
                  D.is_multislice(ms), M.data_parallel_size(ms),
                  ms.mesh.reshape(-1).tolist(),
                  M.shard_batch(np.arange(16.0).reshape(16, 1), ms)
                  .ravel().tolist(), tuple(D.batch_sharding(ms)))
    mp = D.multislice_mesh(2, model_parallel=2)
    view["ms_mp"] = tuple(mp.shape)
    dm = M.make_mesh(MeshConfig(model_parallel=2))
    view["dm"] = (tuple(dm.mesh_dim_names), tuple(dm.shape),
                  M.data_parallel_size(dm), not D.is_multislice(dm))
    errors = []
    for fn in (lambda: D.multislice_mesh(3),
               lambda: D.multislice_mesh(2, model_parallel=3),
               lambda: M.make_mesh(MeshConfig(data_parallel=3))):
        try:
            fn()
        except ValueError as e:
            errors.append(str(e))
    view["errors"] = errors
    views = [None] * dist.get_world_size()
    dist.all_gather_object(views, view)
    keep(tmp, views)


def _model(cfg, sd):
    from sais_tpu_torch.models.full_model import FullModel
    model = FullModel(cfg)
    model.load_state_dict(sd)
    return model


def prototype_fit(tmp: str, kind: str, cfg, sd, keys, protos, batches,
                  lr: float, use_importance: bool = False) -> None:
    """PrototypeTrainer on a mesh (`kind`: 'data', 'multislice', 'seq',
    'seq2x2'), one train epoch over `batches`, then one eval pass; rank 0
    keeps (train loss, eval loss, eval probs, prototypes, state_dict)."""
    import torch
    from sais_tpu_torch.config import TrainConfig
    from sais_tpu_torch.parallel import distributed as D
    from sais_tpu_torch.parallel import mesh as M
    from sais_tpu_torch.parallel import sequence as S
    from sais_tpu_torch.train.loop import PrototypeTrainer
    mesh = seq = None
    if kind == "data":
        mesh = M.make_mesh()
    elif kind == "multislice":
        mesh = D.multislice_mesh(2)
    elif kind == "seq":
        seq = S.seq_mesh(2)
    else:
        seq = S.seq_mesh(2, n_data=2)
    tr = PrototypeTrainer(cfg, TrainConfig(lr=lr), _model(cfg, sd), keys,
                          torch.as_tensor(protos), mesh=mesh, seq_mesh=seq,
                          use_importance=use_importance, device="cpu")
    loss, _ = tr.run_epoch(iter(batches), train=True)
    eval_loss, m = tr.run_epoch(iter(batches[:1]), train=False)
    _, probs = tr.eval_step(batches[0])
    keep(tmp, (loss, eval_loss, probs[:len(batches[0]["label_cols"])].numpy(),
               tr.prototypes.detach().numpy(),
               {k: v.numpy() for k, v in tr.model.state_dict().items()}))


def mil_fit(tmp: str, cfg, sd, batches, lr: float) -> None:
    """ClassificationTrainer(MIL) on a 2-rank data mesh: a train epoch and
    an eval epoch (TTA); rank 0 keeps the losses and the state_dict."""
    from sais_tpu_torch.config import TrainConfig
    from sais_tpu_torch.parallel import mesh as M
    from sais_tpu_torch.train.classification import ClassificationTrainer
    tr = ClassificationTrainer(cfg, TrainConfig(lr=lr), _model(cfg, sd),
                               task="MIL", mesh=M.make_mesh(), device="cpu")
    train, val = batches
    losses = [tr.run_epoch(iter(train), True)[0],
              tr.run_epoch(iter(val), False)[0]]
    keep(tmp, (losses, {k: v.numpy()
                        for k, v in tr.model.state_dict().items()}))


def dino_steps(tmp: str, vit_cfg, dcfg, state, crops, fused: bool) -> None:
    """DINOTrainer on a data mesh of every rank (sgd), one step a crop
    pair; rank 0 keeps (losses, student state_dict, center, BN state)."""
    import torch
    from sais_tpu_torch.parallel import mesh as M
    from sais_tpu_torch.port.weights import dino_state_from_jax
    from sais_tpu_torch.train import dino
    tr = dino.DINOTrainer(vit_cfg, dcfg, 2, torch.Generator().manual_seed(0),
                          optimizer="sgd", device="cpu", fused_blocks=False,
                          fused_loss=fused, mesh=M.make_mesh())
    sd = dino_state_from_jax(state)
    tr.student.load_state_dict(sd["student"])
    tr.teacher.load_state_dict(sd["teacher"])
    tr.center = sd["center"]
    losses = [tr.step(torch.as_tensor(g), torch.as_tensor(l))
              for g, l in crops]
    keep(tmp, (losses, {k: v.detach().numpy()
                        for k, v in tr.student.state_dict().items()},
               tr.center.numpy(),
               None if tr.student_bn is None else
               [{k: v.numpy() for k, v in st.items()}
                for st in tr.student_bn]))


def extract_frames(tmp: str, vit_sd, cfg, frames, batch_size: int,
                   flow=None) -> None:
    """FeatureExtractor (or, with flow = (raft state, iters, pair batch),
    FlowExtractor.flow_fields) on a data mesh of every rank; rank 0 keeps
    the result and the batch the extractor chose."""
    from sais_tpu_torch.infer.pipeline import FeatureExtractor, FlowExtractor
    from sais_tpu_torch.models.vit import VisionTransformer
    from sais_tpu_torch.parallel import mesh as M
    vit = VisionTransformer(cfg.vit)
    vit.load_state_dict(vit_sd)
    if flow is None:
        fx = FeatureExtractor(vit, cfg, batch_size=batch_size, device="cpu",
                              mesh=M.make_mesh())
        keep(tmp, (fx.extract_array(frames), fx.batch_size))
        return
    from sais_tpu_torch.models.raft import RAFT
    raft_sd, iters, pair_batch = flow
    raft = RAFT(cfg.raft)
    raft.load_state_dict(raft_sd)
    fx = FlowExtractor(raft, vit, cfg, pair_batch=pair_batch, iters=iters,
                       device="cpu", mesh=M.make_mesh())
    keep(tmp, (fx.flow_fields(frames), fx.pair_batch))


def dino_loss_dp(tmp: str, arrs, b, ng, nl, temp_s, temp_t,
                 norm_last) -> None:
    """make_fused_dino_loss_dp on this rank's images (a data mesh of every
    rank), its backward under DataParallel; rank 0 keeps (loss, center,
    dh_s of every rank in image-major order, dv, dg)."""
    import torch
    import torch.distributed as dist
    from sais_tpu_torch.kernels.dino_head_loss import (
        build_pair_structure, make_fused_dino_loss_dp)
    from sais_tpu_torch.parallel import mesh as M
    mesh = M.make_mesh()
    dp = M.DataParallel(mesh, mesh)
    hs, ht, vs, vt, gs, gt, center = (torch.tensor(a) for a in arrs)
    sh = M.data_sharding(mesh)
    bl = b // sh.count
    i = sh.index
    local = torch.cat([hs[i * bl * ng:(i + 1) * bl * ng],
                       hs[b * ng + i * bl * nl:b * ng + (i + 1) * bl * nl]])
    local.requires_grad_()
    vs.requires_grad_()
    gs.requires_grad_()
    sel, c = (torch.from_numpy(t) for t in build_pair_structure(bl, ng, nl))
    op = make_fused_dino_loss_dp(temp_s, bl, ng, ng + nl, dp.total,
                                 sh.count, norm_last)
    loss, bc = op(local, vs, gs, ht[i * bl * ng:(i + 1) * bl * ng], vt, gt,
                  center, temp_t, sel, c)
    dp.backward(loss, [vs, gs])
    parts = [torch.empty_like(local) for _ in range(sh.count)]
    dist.all_gather(parts, local.grad.contiguous())
    dh = torch.cat([p[:bl * ng] for p in parts]
                   + [p[bl * ng:] for p in parts])
    keep(tmp, (loss.item(), bc.numpy(), dh.numpy(), vs.grad.numpy(),
               gs.grad.numpy()))


def dino_odd(tmp: str, vit_cfg, dcfg) -> None:
    """A fused DINOTrainer on a 2-rank mesh with a batch that does not
    divide: raises."""
    import torch
    from sais_tpu_torch.parallel import mesh as M
    from sais_tpu_torch.train import dino
    dino.DINOTrainer(vit_cfg, dcfg, 2, torch.Generator(), device="cpu",
                     fused_loss=True, mesh=M.make_mesh())


def launch(tmp: str, argv, port: int, pipeline_config=None) -> None:
    """Two processes that join one group through env:// (as torchrun
    starts them) and run the CLI with --init-distributed."""
    import torch.multiprocessing as mp
    mp.spawn(_env_rank, nprocs=2, join=True,
             args=(argv, port, pipeline_config))


def _env_rank(rank: int, argv, port: int, pipeline_config) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from sais_tpu_torch.cli import main as cli_main
    if pipeline_config is not None:
        cli_main.PipelineConfig = lambda: pipeline_config
    try:
        cli_main.main(argv)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


# -- rank bodies of tests/test_torch_sequence_parallel.py and test_torch_tp --

def ring_encoder(tmp: str, cfg, sd, cases, n_seq: int, n_data: int = 1,
                 grad_w=None) -> None:
    """The frame encoder of a FullModel(cfg) with state `sd` as a ring over
    an (n_data, n_seq) mesh, on each (x, mask) of `cases`; with grad_w,
    the gradients of sum(out * grad_w) of the first case (loss / N
    backward, then summed over the ranks).  Rank 0 keeps [(out, CLS row)
    per case] (+ {name: gradient})."""
    import torch
    import torch.distributed as dist
    from sais_tpu_torch.parallel import mesh as M
    from sais_tpu_torch.parallel.sequence import (
        encoder_forward_seq_parallel, seq_mesh)
    enc = _model(cfg, sd).frame_encoder
    mesh = seq_mesh(n_seq, n_data)
    outs = []
    for x, mask in cases:
        x = torch.as_tensor(x)
        mask = None if mask is None else torch.as_tensor(mask)
        with torch.no_grad():
            out, cls = encoder_forward_seq_parallel(enc, x, cfg.temporal,
                                                    mask, mesh)
        outs.append((out.numpy(), cls.numpy()))
    grads = None
    if grad_w is not None:
        x, mask = cases[0]
        out, _ = encoder_forward_seq_parallel(
            enc, torch.as_tensor(x), cfg.temporal,
            None if mask is None else torch.as_tensor(mask), mesh)
        loss = (out * torch.as_tensor(grad_w)).sum()
        params = list(enc.parameters())
        (loss / dist.get_world_size()).backward()
        M.all_reduce_grads(params)
        grads = {n: p.grad.numpy() for n, p in enc.named_parameters()}
    keep(tmp, (outs, grads))


def ring_rows(tmp: str, q, k, v, bias) -> None:
    """ring_attention on each rank's chunk of (B, H, L, Dh) q, k, v and
    (B, L) bias over a 'seq' mesh of every rank, gathered."""
    import torch
    from sais_tpu_torch.parallel import mesh as M
    from sais_tpu_torch.parallel.sequence import (ring_attention, seq_group,
                                                  seq_mesh)
    import torch.distributed as dist
    n = dist.get_world_size()
    mesh = seq_mesh(n)
    group = seq_group(mesh)
    r = dist.get_rank(group)
    q, k, v, bias = (torch.as_tensor(t) for t in (q, k, v, bias))
    part = slice(r * q.shape[2] // n, (r + 1) * q.shape[2] // n)
    out = ring_attention(q[:, :, part], k[:, :, part], v[:, :, part],
                         bias[:, part], group, n)
    keep(tmp, M.all_gather(out.contiguous(), group, dim=2).numpy())


def seq_decode(tmp: str, cfg, folds, rgb, n_seq: int) -> None:
    """GestureDecoder(seq_mesh) window probabilities of `rgb` reps over an
    n_seq ring, and the refusal of use_flash=False with a seq_mesh."""
    import dataclasses
    from sais_tpu_torch.infer.pipeline import GestureDecoder
    from sais_tpu_torch.parallel.sequence import seq_mesh
    mesh = seq_mesh(n_seq)
    dec = GestureDecoder(folds, cfg, device="cpu", seq_mesh=mesh)
    probs = dec.window_probs("v", rgb, None)
    off = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, temporal=dataclasses.replace(cfg.model.temporal,
                                                use_flash=False)))
    try:
        GestureDecoder(folds, off, device="cpu", seq_mesh=mesh)
        refused = None
    except ValueError as e:
        refused = str(e)
    keep(tmp, (probs, refused))


def tp_features(tmp: str, vit_sd, vit_cfg, images, n_model: int) -> None:
    """tp_vit_features over a ('data', 'model') mesh of every rank with
    model size n_model; rank 0 keeps the (B, D) features."""
    import torch
    from sais_tpu_torch.config import MeshConfig
    from sais_tpu_torch.models.vit import VisionTransformer
    from sais_tpu_torch.parallel.mesh import make_mesh
    from sais_tpu_torch.parallel.tp import (put_tp_params,
                                            shard_vit_params_tp,
                                            tp_vit_features)
    model = VisionTransformer(vit_cfg)
    model.load_state_dict(vit_sd)
    mesh = make_mesh(MeshConfig(model_parallel=n_model))
    local = put_tp_params(shard_vit_params_tp(model, n_model), mesh)
    keep(tmp, tp_vit_features(local, torch.as_tensor(images), model,
                              mesh).numpy())
