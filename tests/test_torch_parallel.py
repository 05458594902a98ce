"""The port's data parallelism on torch.distributed (`parallel.mesh`,
`parallel.distributed`, the trainers' and extractors' `mesh`, the CLI's
parallel flags) against the JAX package on the conftest's 8 virtual CPU
devices: the port runs as 2-4 gloo ranks spawned from the test
(`tests/torch_ranks.py`, a FileStore under tmp_path), the JAX side as the
JAX tests run it.  Tolerances are the JAX tests': 1e-5 for multislice
and data-parallel Prototypes training (test_multislice.py:78) and for
extraction (test_extract_parallel.py:36), 1e-4 for RAFT's flow fields
there and for the DINO step's loss and parameters against the port's own
one-process step; against JAX's DINO step, the single-device port tests'
limits (tests/test_torch_dino.py)."""

import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sais_tpu import config as jconfig
from sais_tpu.models import full_model as jfm
from sais_tpu.parallel import distributed as jdist
from sais_tpu.parallel import mesh as jmesh
from sais_tpu_torch import config as tconfig
from sais_tpu_torch.parallel import mesh as mesh_lib
from sais_tpu_torch.port.weights import full_model_params_from_jax

from tests import torch_ranks

DIM = 32


def _cfgs(**kw):
    temporal = dict(rep_dim=DIM, num_layers=1, num_heads=2, ffn_dim=64,
                    max_positions=16)
    base = dict(rep_dim=DIM, modalities="RGB", **kw)
    return (jconfig.ModelConfig(**base, temporal=jconfig.TemporalConfig(
        **temporal)), tconfig.ModelConfig(**base, temporal=tconfig.
                                          TemporalConfig(**temporal)))


def _init(jcfg, seed=0):
    params = jax.tree.map(np.asarray, jfm.full_model_init(
        jax.random.key(seed), jcfg))
    keys, protos = jfm.prototypes_init(jax.random.key(seed + 1), 2)
    return params, keys, np.asarray(protos)


def _batches(n, b, seed=0, importance=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cols = (np.arange(b) % 2).astype(np.int32)
        mask = np.zeros((b, 1, 6), bool)
        mask[::2, 0, 4:] = True
        batch = {"rgb": rng.normal(size=(b, 1, 5, DIM)).astype(np.float32),
                 "rgb_mask": mask, "label_cols": cols, "labels": cols}
        if importance:
            batch["importance"] = rng.random((b, 1, 5)).astype(np.float32)
            batch["ipad"] = mask
        out.append(batch)
    return out


def test_pad_helpers_match_jax():
    """pad_to_multiple and pad_batch_with_weight: the same arrays as JAX's,
    leaves of a nested batch and an existing weight kept."""
    rng = np.random.default_rng(0)
    batch = {"x": rng.normal(size=(5, 3)).astype(np.float32),
             "y": {"z": np.arange(5)}, "w": [np.ones((5, 2))]}
    for mult in (1, 4, 8):
        got = mesh_lib.pad_to_multiple(batch, mult)
        want = jmesh.pad_to_multiple(batch, mult)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g, np.asarray(w))
    flat = {"x": batch["x"], "weight": np.asarray([1, 1, 0, 1, 1],
                                                  np.float32)}
    for b in (batch, flat):
        b = {k: v for k, v in b.items() if k != "y" and k != "w"}
        got = mesh_lib.pad_batch_with_weight(b, 4)
        want = jmesh.pad_batch_with_weight(b, 4)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_meshes_and_sharding_match_jax(tmp_path):
    """4 gloo ranks: multislice_mesh(2) is ('dcn', 'data', 'model') (2, 2,
    1) over ranks in order, its data-parallel size 4, each rank holding 4
    contiguous rows of 16 as JAX's batch sharding gives each device of the
    same 4-device mesh; model_parallel=2 makes (2, 1, 2); make_mesh(model
    2) is (data 2, model 2); the bad splits raise JAX's errors."""
    views = torch_ranks.run(torch_ranks.mesh_layout, 4, tmp_path)
    jms = jdist.multislice_mesh(2, devices=jax.devices()[:4])
    xs = jax.device_put(jnp.arange(16.0).reshape(16, 1),
                        jdist.batch_sharding(jms))
    jshards = {s.device.id: np.asarray(s.data).ravel().tolist()
               for s in xs.addressable_shards}
    jorder = [d.id for d in np.asarray(jms.devices).reshape(-1)]
    for rank, view in enumerate(views):
        names, shape, multi, dp, ranks, rows, sharding = view["ms"]
        assert names == tuple(jms.axis_names) and multi
        assert shape == tuple(jms.devices.shape) == (2, 2, 1)
        assert dp == jdist.data_parallel_size(jms) == 4
        assert ranks == [0, 1, 2, 3] and sharding == (rank, 4)
        assert rows == jshards[jorder[rank]]
        assert view["ms_mp"] == tuple(jdist.multislice_mesh(
            2, model_parallel=2, devices=jax.devices()[:4]).devices.shape)
        assert view["dm"] == (("data", "model"), (2, 2), 2, True)
    errors = views[0]["errors"]
    for i, fn in enumerate((
            lambda: jdist.multislice_mesh(3, devices=jax.devices()[:4]),
            lambda: jdist.multislice_mesh(2, model_parallel=3,
                                          devices=jax.devices()[:4]),
            lambda: jmesh.make_mesh(jconfig.MeshConfig(data_parallel=3),
                                    devices=jax.devices()[:4]))):
        with pytest.raises(ValueError) as info:
            fn()
        assert errors[i] == str(info.value)


def _jax_trainer(jcfg, params, keys, protos, lr, mesh=None, **kw):
    from sais_tpu.train.loop import PrototypeTrainer as JaxTrainer
    return JaxTrainer(jcfg, jconfig.TrainConfig(lr=lr),
                      jax.tree.map(jnp.asarray, params), keys,
                      jnp.asarray(protos), mesh=mesh, **kw)


@pytest.mark.parametrize("kind,n,b,importance", [
    ("multislice", 4, 8, False), ("data", 4, 6, False),
    ("data", 2, 5, True)])
def test_data_parallel_training_matches_jax(tmp_path, kind, n, b,
                                            importance):
    """PrototypeTrainer on n gloo ranks (a multislice mesh as in
    test_multislice.py, or a data mesh over a ragged batch padded with
    weight-0 rows, with and without the importance loss) against JAX's
    trainer on the same mesh of n virtual devices: the train and eval
    losses, the eval probabilities, the prototypes and every parameter
    after a train epoch within 1e-5 (1e-4 with the importance loss, the
    port's -il trainer limit, tests/test_torch_skill.py)."""
    tol = 1e-4 if importance else 1e-5
    jcfg, cfg = _cfgs(importance_head=importance)
    params, keys, protos = _init(jcfg)
    batches = _batches(2, b, importance=importance)
    devs = jax.devices()[:n]
    mesh = (jdist.multislice_mesh(2, devices=devs) if kind == "multislice"
            else jmesh.make_mesh(jconfig.MeshConfig(), devices=devs))
    jtr = _jax_trainer(jcfg, params, keys, protos, 0.1, mesh=mesh,
                       use_importance=importance)
    jl, _ = jtr.run_epoch(iter(batches), train=True)
    jel, _ = jtr.run_epoch(iter(batches[:1]), train=False)
    sd = full_model_params_from_jax(params)
    loss, eval_loss, probs, gprotos, state = torch_ranks.run(
        torch_ranks.prototype_fit, n, tmp_path, kind, cfg, sd, keys,
        protos, batches, 0.1, importance)
    assert abs(loss - jl) < tol and abs(eval_loss - jel) < tol
    _, _, jprobs = jtr._eval_step(jtr.state, jtr._device_batch(batches[0]))
    np.testing.assert_allclose(probs, np.asarray(jprobs)[:b], atol=tol)
    np.testing.assert_allclose(gprotos, np.asarray(jtr.state.prototypes),
                               atol=tol)
    want = full_model_params_from_jax(jax.tree.map(np.asarray,
                                                   jtr.state.model))
    for name, p in state.items():
        np.testing.assert_allclose(p, want[name].numpy(), atol=tol,
                                   err_msg=name)


def test_mil_data_parallel_matches_jax(tmp_path):
    """ClassificationTrainer(MIL) on 2 gloo ranks against JAX's on a
    2-device mesh: a ragged train batch (3 rows, padded with a weight-0
    row) and a TTA eval batch; losses and every parameter within 1e-4 (the
    port's MIL trainer limit, tests/test_torch_classification.py)."""
    from sais_tpu.train.classification import ClassificationTrainer as JCT
    jcfg, cfg = _cfgs()
    params, _, _ = _init(jcfg, seed=3)
    rng = np.random.default_rng(4)

    def batch(b):
        cols = (np.arange(b) % 2).astype(np.int32)
        mask = np.zeros((b, 2, 7), bool)
        mask[1, :, 5:] = True
        return {"rgb": (rng.normal(size=(b, 2, 6, DIM))
                        + np.where(cols == 0, .5, -.5)[:, None, None, None]
                        ).astype(np.float32), "rgb_mask": mask,
                "label_cols": cols, "labels": cols}

    val = batch(4)
    val["tta"] = [batch(4) for _ in range(3)]
    batches = ([batch(3), batch(4)], [val])
    mesh = jmesh.make_mesh(jconfig.MeshConfig(), devices=jax.devices()[:2])
    jtr = JCT(jcfg, jconfig.TrainConfig(lr=0.2), jax.tree.map(jnp.asarray,
                                                                params),
              task="MIL", mesh=mesh)
    want = [jtr.run_epoch(iter(batches[0]), True)[0],
            jtr.run_epoch(iter(batches[1]), False)[0]]
    losses, state = torch_ranks.run(torch_ranks.mil_fit, 2, tmp_path, cfg,
                                    full_model_params_from_jax(params),
                                    batches, 0.2)
    np.testing.assert_allclose(losses, want, atol=1e-4)
    ref = full_model_params_from_jax(jax.tree.map(np.asarray, jtr.params))
    for name, p in state.items():
        np.testing.assert_allclose(p, ref[name].numpy(), atol=1e-4,
                                   err_msg=name)


TINY_VIT = dict(image_size=32, patch_size=16, embed_dim=64, depth=2,
                num_heads=2)


@pytest.mark.parametrize("fused", [True, False])
def test_dino_data_parallel_matches_jax(tmp_path, fused):
    """DINOTrainer on a 2-rank data mesh, two sgd steps of batch 4 (two
    images a rank): with fused_loss K7's plain version under
    make_fused_dino_loss_dp (loss and center summed over the shards, dv /
    dg summed, dh_s local), without it the BatchNorm head and the plain
    loss, their sums over both ranks' rows.  Against the port's own
    one-process step from the same weights: losses 1e-4 relative; the
    bf16 backbone rounds each rank's weight gradients before they are
    summed, so the rest is held to the single-device port's limits
    against JAX, as against JAX's DINOTrainer on a 2-device mesh
    (make_fused_dino_loss_dp in interpret mode, or its sharded jit):
    losses 2e-3 relative there; with K7 the center 1e-4 of its largest
    value here, 1e-3 there, and every parameter 1e-3 (sgd,
    tests/test_torch_dino.py); with the BatchNorm head, which magnifies
    rounding, parameters 2e-3, the center and the running means 5e-3,
    the running variances 1e-2 (tests/test_torch_dino_bn.py)."""
    from sais_tpu.config import ViTConfig as JViT
    from sais_tpu.train import dino as jdino
    from sais_tpu_torch.port.weights import dino_state_from_jax
    from sais_tpu_torch.train import dino as tdino
    base = dict(out_dim=128, batch_size=4, n_local_crops=2, global_size=32,
                local_size=16, epochs=1, warmup_epochs=0,
                freeze_last_layer_epochs=0, drop_path_rate=0.0,
                lr=0.0025 * 256 / 4, use_bn_in_head=not fused)
    jt = jdino.DINOTrainer(JViT(**TINY_VIT), jdino.DINOConfig(**base), 2,
                           jax.random.key(0), optimizer="sgd",
                           fused_blocks=False, fused_loss=fused,
                           mesh=jmesh.make_mesh(jconfig.MeshConfig(),
                                                devices=jax.devices()[:2]))
    jt.student = jax.tree.map(
        lambda a: a + 0.02 * jax.random.normal(jax.random.key(a.size),
                                               a.shape), jt.student)
    jt.teacher = jax.tree.map(jnp.copy, jt.student)
    state = jax.tree.map(np.asarray, jt.state())
    state["center"] = np.random.default_rng(9).standard_normal(
        128).astype(np.float32) * 0.1
    jt.center = jnp.asarray(state["center"])
    rng = np.random.default_rng(1)
    crops = [(rng.standard_normal((8, 32, 32, 3)).astype(np.float32),
              rng.standard_normal((8, 16, 16, 3)).astype(np.float32))
             for _ in range(2)]
    vit, dcfg = tconfig.ViTConfig(**TINY_VIT), tdino.DINOConfig(**base)
    losses, sd, center, bn = torch_ranks.run(
        torch_ranks.dino_steps, 2, tmp_path, vit, dcfg, state, crops, fused)
    one = tdino.DINOTrainer(vit, dcfg, 2, torch.Generator().manual_seed(0),
                            optimizer="sgd", device="cpu",
                            fused_blocks=False, fused_loss=fused)
    start = dino_state_from_jax(state)
    one.student.load_state_dict(start["student"])
    one.teacher.load_state_dict(start["teacher"])
    one.center = start["center"]
    ref = [one.step(torch.as_tensor(g), torch.as_tensor(l))
           for g, l in crops]
    jref = [jt.step(jnp.asarray(g), jnp.asarray(l)) for g, l in crops]
    np.testing.assert_allclose(losses, ref, rtol=1e-4)
    np.testing.assert_allclose(losses, jref, rtol=2e-3)

    def close(got, want, tol, name):
        assert np.abs(got - want).max() <= tol * np.abs(want).max(), name

    close(center, one.center.numpy(), 1e-4 if fused else 5e-3, "center")
    close(center, np.asarray(jt.center), 1e-3 if fused else 5e-3,
          "center (JAX)")
    jsd = dino_state_from_jax(jax.tree.map(np.asarray, jt.state()))
    for name, p in one.student.state_dict().items():
        close(sd[name], p.detach().numpy(), 1e-3 if fused else 2e-3, name)
        close(sd[name], jsd["student"][name].numpy(),
              1e-3 if fused else 2e-3, name)
    if not fused:
        for got, want in zip(bn, one.student_bn):
            for k, rel in (("mean", 5e-3), ("var", 1e-2)):
                close(got[k], want[k].numpy(), rel, f"bn {k}")


@pytest.mark.parametrize("norm_last", [True, False])
def test_fused_dino_loss_dp_matches_jax(tmp_path, norm_last):
    """make_fused_dino_loss_dp on 2 gloo ranks (K7's plain version on
    each rank's 2 images, the loss and center summed, dv / dg summed by
    all_reduce_grads, dh_s local and gathered in image-major order) at the
    JAX package's test shapes (B 4, 2 + 3 crops, bottleneck 128, out_dim
    512): against the one-process make_fused_dino_loss, loss, center and
    every gradient within 1e-4 (of the largest value); against JAX's
    make_fused_dino_loss_dp on a 2-device mesh (interpret mode), the K7
    limits of tests/test_torch_dino_loss.py (loss 1e-5 relative, center
    1e-4 of its largest value, gradients rtol 2e-2 / atol 5e-5)."""
    from sais_tpu.kernels import dino_head_loss as jloss
    from sais_tpu_torch.kernels import dino_head_loss as tloss
    b, ng, nl, db, k, temp_s, temp_t = 4, 2, 3, 128, 512, 0.1, 0.07
    rng = np.random.default_rng(5)

    def unit(n):
        h = rng.standard_normal((n, db)).astype(np.float32)
        h /= np.linalg.norm(h, axis=-1, keepdims=True)
        return np.asarray(torch.from_numpy(h).bfloat16().float())

    arrs = (unit((ng + nl) * b), unit(ng * b),
            rng.standard_normal((db, k)).astype(np.float32),
            rng.standard_normal((db, k)).astype(np.float32),
            (1 + .1 * rng.standard_normal(k)).astype(np.float32),
            (1 + .1 * rng.standard_normal(k)).astype(np.float32),
            (.01 * rng.standard_normal(k)).astype(np.float32))
    got = torch_ranks.run(torch_ranks.dino_loss_dp, 2, tmp_path, arrs, b,
                          ng, nl, temp_s, temp_t, norm_last)
    hs, ht, vs, vt, gs, gt, center = (torch.tensor(a) for a in arrs)
    hs.requires_grad_()
    vs.requires_grad_()
    gs.requires_grad_()
    sel, c = (torch.from_numpy(t) for t in
              tloss.build_pair_structure(b, ng, nl))
    loss, bc = tloss.make_fused_dino_loss(temp_s, b, ng, ng + nl, norm_last)(
        hs, vs, gs, ht, vt, gt, center, temp_t, sel, c)
    loss.backward()
    one = (loss.item(), bc.numpy(), hs.grad.numpy(), vs.grad.numpy(),
           gs.grad.numpy())
    fn = jloss.make_fused_dino_loss_dp(
        temp_s, b // 2, ng, ng + nl,
        jmesh.make_mesh(jconfig.MeshConfig(), devices=jax.devices()[:2]),
        norm_last_layer=norm_last)
    j = [jnp.asarray(a) for a in arrs]
    n_gr = ng * b

    def jloss_fn(hs_g, hs_l, vs_, gs_):
        return fn(hs_g, hs_l, vs_, gs_, j[1], j[3], j[5], j[6],
                  jnp.float32(temp_t))

    args = (j[0][:n_gr], j[0][n_gr:], j[2], j[4])
    jl, jbc = jloss_fn(*args)
    jgrads = jax.grad(lambda *a: jloss_fn(*a)[0], argnums=(0, 1, 2, 3))(
        *args)
    jref = (float(jl), np.asarray(jbc),
            np.concatenate([np.asarray(jgrads[0]), np.asarray(jgrads[1])]),
            np.asarray(jgrads[2]), np.asarray(jgrads[3]))
    assert abs(got[0] - one[0]) <= 1e-4 * abs(one[0])
    assert abs(got[0] - jref[0]) <= 1e-5 * abs(jref[0])
    for name, g, o, w in zip(("center", "dhs", "dvs", "dgs"), got[1:],
                             one[1:], jref[1:]):
        assert np.abs(g - o).max() <= 1e-4 * max(np.abs(o).max(), 1e-30), \
            name
        if name == "center":
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), name
        else:
            np.testing.assert_allclose(g, w, rtol=2e-2, atol=5e-5,
                                       err_msg=name)


def test_dino_data_parallel_needs_a_divisible_batch(tmp_path):
    """A batch that does not divide over the shards is refused with JAX's
    error (train/dino.py:389-394)."""
    from sais_tpu_torch.train import dino as tdino
    with pytest.raises(Exception, match="batch_size % 2 == 0, got 3"):
        torch_ranks.run(torch_ranks.dino_odd, 2, tmp_path,
                        tconfig.ViTConfig(**TINY_VIT), tdino.DINOConfig(
                            out_dim=128, batch_size=3, n_local_crops=2))


def _f32_cfgs():
    import dataclasses
    vit = dict(image_size=224, patch_size=16, embed_dim=64, depth=1,
               num_heads=2)
    j = dataclasses.replace(jconfig.PipelineConfig(),
                            vit=jconfig.ViTConfig(**vit),
                            compute_dtype="float32")
    t = dataclasses.replace(tconfig.PipelineConfig(),
                            vit=tconfig.ViTConfig(**vit),
                            compute_dtype="float32")
    return j, t


def test_feature_extractor_data_parallel_matches_jax(tmp_path):
    """FeatureExtractor on 2 gloo ranks (each a block of every frame batch,
    gathered in order; batch 5 rounds to 4) against JAX's on a 2-device
    mesh, float32, 11 frames of 120x160: within 1e-5."""
    from sais_tpu.infer.pipeline import FeatureExtractor as JFX
    from sais_tpu.models.vit import vit_init
    from sais_tpu_torch.port.weights import vit_params_from_jax
    jcfg, cfg = _f32_cfgs()
    params = vit_init(jax.random.key(0), jcfg.vit)
    frames = np.random.default_rng(0).integers(0, 255, (11, 120, 160, 3),
                                               dtype=np.uint8)
    mesh = jmesh.make_mesh(jconfig.MeshConfig(), devices=jax.devices()[:2])
    jfx = JFX(params, jcfg, batch_size=5, use_native_decode=False, mesh=mesh)
    want = jfx.extract_array(frames)
    got, batch = torch_ranks.run(
        torch_ranks.extract_frames, 2, tmp_path,
        vit_params_from_jax(jax.tree.map(np.asarray, params)), cfg, frames,
        5)
    assert batch == jfx.batch_size == 4
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_flow_extractor_data_parallel_matches_jax(tmp_path):
    """FlowExtractor.flow_fields on 2 gloo ranks (pair batch 3 rounds to
    2; 2 pairs at jump 15, RAFT at 2 iterations, 48x64) against JAX's on
    a 2-device mesh, float32: within 1e-4 (test_extract_parallel.py)."""
    from sais_tpu.infer.pipeline import FlowExtractor as JFlow
    from sais_tpu.models.raft import raft_init
    from sais_tpu.models.vit import vit_init
    from sais_tpu_torch.port.weights import (raft_state_from_jax,
                                             vit_params_from_jax)
    jcfg, cfg = _f32_cfgs()
    raft = raft_init(jax.random.key(1), jcfg.raft)
    vit = vit_init(jax.random.key(0), jcfg.vit)
    frames = np.random.default_rng(1).integers(0, 255, (40, 48, 64, 3),
                                               dtype=np.uint8)
    mesh = jmesh.make_mesh(jconfig.MeshConfig(), devices=jax.devices()[:2])
    jfx = JFlow(raft, vit, jcfg, pair_batch=3, iters=2, mesh=mesh)
    want = jfx.flow_fields(frames)
    got, pair_batch = torch_ranks.run(
        torch_ranks.extract_frames, 2, tmp_path,
        vit_params_from_jax(jax.tree.map(np.asarray, vit)), cfg, frames, 8,
        (raft_state_from_jax(jax.tree.map(np.asarray, raft)), 2, 3))
    assert pair_batch == jfx.pair_batch == 2
    assert got.shape == want.shape == (2, 48, 64, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# -- the CLI -----------------------------------------------------------------

def _tiny_pipeline():
    import dataclasses
    _, t = _f32_cfgs()
    return dataclasses.replace(t, model=tconfig.ModelConfig(
        rep_dim=64, modalities="RGB", temporal=tconfig.TemporalConfig(
            rep_dim=64, num_layers=1, num_heads=2, ffn_dim=64,
            max_positions=64)))


def _video(root, name="vid", n=20, seed=0):
    import cv2
    os.makedirs(os.path.join(root, "videos"), exist_ok=True)
    w = cv2.VideoWriter(os.path.join(root, "videos", name + ".mp4"),
                        cv2.VideoWriter_fourcc(*"mp4v"), 30, (160, 120))
    rng = np.random.default_rng(seed)
    for _ in range(n):
        w.write(rng.integers(0, 255, (120, 160, 3), dtype=np.uint8))
    w.release()


def _reps(root, name="vid"):
    from sais_tpu_torch.io.feature_store import FeatureStore, rgb_store_path
    with FeatureStore(rgb_store_path(str(root))) as fs:
        return fs.read_video(name)


def test_cli_extract_data_parallel_matches_one_process(tmp_path):
    """`extract --data-parallel 2 --device cpu --exact-preprocess` (2 gloo
    ranks, rank 0 writing the H5) stores the reps the one-process extract
    stores, within 1e-5; every rank decodes the video, each runs its block
    of a batch."""
    from sais_tpu_torch.cli import main as cli
    _video(tmp_path)
    argv = ["extract", "-f", "vid", "-p", str(tmp_path), "--random-init",
            "--device", "cpu", "--exact-preprocess", "-bs", "6",
            "--dtype", "float32"]
    torch_ranks.run(torch_ranks.cli, 2, tmp_path / "r",
                    argv + ["--data-parallel", "2"], _tiny_pipeline())
    sharded = _reps(tmp_path)
    old = cli.PipelineConfig
    cli.PipelineConfig = _tiny_pipeline
    try:
        cli.main(argv + ["--force"])
    finally:
        cli.PipelineConfig = old
    assert sharded.shape == (20, 64)
    np.testing.assert_allclose(sharded, _reps(tmp_path), atol=1e-5)


@pytest.mark.parametrize("cmd", ["flow", "pipeline"])
def test_cli_flow_and_pipeline_data_parallel(tmp_path, cmd):
    """`flow --data-parallel 2 --save-flows` (RAFT's pairs split over 2
    gloo ranks, the rendered flows saved by rank 0 only; 2 iterations)
    and `pipeline --data-parallel 2` store the flow reps / write the
    gesture CSV the one-process command does: reps within 1e-4 (RAFT's
    limit), the CSV's numbers within 1e-5."""
    import csv
    from sais_tpu_torch.cli import main as cli
    from sais_tpu_torch.io.feature_store import FeatureStore, flow_store_path
    _video(tmp_path, n=40)
    argv = [cmd, "-f", "vid", "-p", str(tmp_path), "--random-init",
            "--device", "cpu", "--dtype", "float32", "--force",
            "--exact-preprocess", "-bs", "6"]
    argv += (["--flow-iters", "2", "--flow-jump", "15", "--save-flows"]
             if cmd == "flow" else [])

    def result():
        if cmd == "flow":
            with FeatureStore(flow_store_path(str(tmp_path))) as fs:
                return fs.read_video("vid")
        with open(tmp_path / "results" /
                  "Custom_inference_gestures.csv") as f:
            return list(csv.DictReader(f))

    torch_ranks.run(torch_ranks.cli, 2, tmp_path / "r",
                    argv + ["--data-parallel", "2"], _tiny_pipeline())
    got = result()
    if cmd == "flow":
        assert sorted(os.listdir(tmp_path / "flows" / "vid")) == [
            "flows_00000000.jpg", "flows_00000001.jpg"]
    old = cli.PipelineConfig
    cli.PipelineConfig = _tiny_pipeline
    try:
        cli.main(argv)
    finally:
        cli.PipelineConfig = old
    want = result()
    if cmd == "flow":
        assert got.shape == want.shape == (2, 64)
        np.testing.assert_allclose(got, want, atol=1e-4)
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in w:
            try:
                assert abs(float(g[k]) - float(w[k])) <= 1e-5, k
            except ValueError:
                assert g[k] == w[k], k


def _train_root(root, nvideos=6):
    import csv
    from sais_tpu_torch.io.feature_store import FeatureStore, rgb_store_path
    rng = np.random.default_rng(2)
    rows = []
    with FeatureStore(rgb_store_path(str(root)), "a") as fs:
        for v in range(nvideos):
            fs.write_video(f"v{v}", rng.standard_normal((400, 64)).astype(
                np.float32))
            for _ in range(6):
                s = int(rng.integers(1, 300))
                rows.append({"Video": f"v{v}", "StartFrame": s,
                             "EndFrame": s + int(rng.integers(20, 90)),
                             "Gesture": "AB"[int(rng.integers(2))]})
    path = os.path.join(str(root), "segs.csv")
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return path


def _fold(root):
    from sais_tpu_torch.train.checkpoint import load_training_result
    return load_training_result(os.path.join(str(root), "params", "Fold_0"))


@pytest.mark.parametrize("flags,n", [
    (["--data-parallel", "2"], 2),
    (["--data-parallel", "4", "--num-slices", "2"], 4),
    (["--seq-parallel", "2", "--data-parallel", "2"], 4),
    (["-t", "MIL", "--data-parallel", "2"], 2)])
def test_cli_train_parallel_matches_one_process(tmp_path, flags, n):
    """`train` on n gloo ranks (a data mesh, a two-slice mesh, a 2 x 2
    ('data', 'seq') mesh, MIL on a data mesh) saves the fold the
    one-process `train` saves: every parameter and the prototypes within
    1e-5 (1e-4 for MIL)."""
    from sais_tpu_torch.cli import main as cli
    segs = _train_root(tmp_path)
    argv = ["train", "-p", str(tmp_path), "--segments", segs, "-e", "1",
            "-bs", "5", "--device", "cpu"] + [f for f in flags
                                              if f in ("-t", "MIL")]
    par = [f for f in flags if f not in ("-t", "MIL")]
    torch_ranks.run(torch_ranks.cli, n, tmp_path / "r", argv + par,
                    _tiny_pipeline())
    got = _fold(tmp_path)
    old = cli.PipelineConfig
    cli.PipelineConfig = _tiny_pipeline
    try:
        cli.main(argv)
    finally:
        cli.PipelineConfig = old
    want = _fold(tmp_path)
    tol = 1e-4 if "MIL" in flags else 1e-5
    for g, w in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(want["params"])):
        np.testing.assert_allclose(g, w, atol=tol)
    np.testing.assert_allclose(got["prototypes"], want["prototypes"],
                               atol=tol)


def test_cli_train_init_distributed(tmp_path):
    """`train --init-distributed` in two processes that meet through
    env:// on localhost (as torchrun starts them) trains on a data mesh of
    both and saves the one-process fold within 1e-5."""
    from sais_tpu_torch.cli import main as cli
    segs = _train_root(tmp_path)
    argv = ["train", "-p", str(tmp_path), "--segments", segs, "-e", "1",
            "-bs", "5", "--device", "cpu"]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch_ranks.launch(str(tmp_path), argv + ["--init-distributed"], port,
                       _tiny_pipeline())
    got = _fold(tmp_path)
    old = cli.PipelineConfig
    cli.PipelineConfig = _tiny_pipeline
    try:
        cli.main(argv)
    finally:
        cli.PipelineConfig = old
    want = _fold(tmp_path)
    for g, w in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(want["params"])):
        np.testing.assert_allclose(g, w, atol=1e-5)


def test_cli_pretrain_data_parallel(tmp_path):
    """`pretrain --data-parallel 2 --device cpu` (a depth-1 patch-32 ViT in
    the zoo): one epoch of two steps on 2 gloo ranks writes the checkpoint
    and the log from rank 0, and its student (sgd) equals the one-process
    run's within 1e-3 of the student's largest value (the bf16 backbone
    rounds each rank's weight gradients before they are summed; the sgd
    limit of tests/test_torch_dino.py, over the whole student because
    the zero-initialized biases have moved by about 1e-6 only)."""
    from sais_tpu_torch.cli import main as cli
    from sais_tpu_torch.models import zoo
    _video(tmp_path, n=16)
    tiny = tconfig.ViTConfig(image_size=224, patch_size=32, embed_dim=64,
                             depth=1, num_heads=1)
    argv = ["pretrain", "-p", str(tmp_path), "-bs", "8", "--out-dim", "32",
            "--local-crops", "2", "--device", "cpu", "--loader-threads",
            "1", "-e", "1", "--drop-path", "0", "--optimizer", "sgd"]
    torch_ranks.run(torch_ranks.cli, 2, tmp_path / "r",
                    argv + ["--data-parallel", "2"], None, {"vits16": tiny})
    ckpt = tmp_path / "pretrain" / "ckpt" / "1.pt"
    assert ckpt.exists() and (tmp_path / "pretrain" / "log.txt").exists()
    got = torch.load(ckpt, weights_only=False)["student"]
    os.unlink(ckpt)
    saved = dict(zoo.CONFIGS)
    zoo.CONFIGS["vits16"] = tiny
    try:
        cli.main(argv)
    finally:
        zoo.CONFIGS.clear()
        zoo.CONFIGS.update(saved)
    want = torch.load(ckpt, weights_only=False)["student"]
    top = max(w.float().abs().max().item() for w in want.values())
    for name, w in want.items():
        err = (got[name].float() - w.float()).abs().max().item()
        assert err <= 1e-3 * top, name


def test_cli_parallel_exits(tmp_path, monkeypatch):
    """The CLI's own refusals, before any rank starts: --data-parallel past
    the cards there are (JAX's message), --seq-parallel x --data-parallel
    past them, a -bs that does not divide over the pretrain mesh, and a
    pipeline whose extract and decode groups differ."""
    from sais_tpu_torch.cli import main as cli
    monkeypatch.setattr(cli, "_devices", lambda args: 2)
    root = ["-p", str(tmp_path / "absent")]
    for argv, match in (
            (["extract", "-f", "v", "--data-parallel", "3"],
             "--data-parallel 3 exceeds the 2 available devices"),
            (["train", "--segments", "s.csv", "--seq-parallel", "2",
              "--data-parallel", "2"],
             "--seq-parallel 2 x --data-parallel 2 exceeds the 2"),
            (["pretrain", "-bs", "7", "--data-parallel"],
             "-bs 7 does not divide over the 2-device mesh; use a multiple "
             "of 2"),
            (["pipeline", "-f", "v", "--data-parallel", "2",
              "--seq-parallel", "1"], "must agree")):
        with pytest.raises(SystemExit, match=match):
            cli.main(argv + root)
    assert not (tmp_path / "absent").exists()


def test_cli_serve_data_parallel(tmp_path):
    """`serve --data-parallel 2 --device cpu`: rank 0 owns the socket and
    sends rank 1 its block of every frame batch, which rank 1 runs; a
    request's CSV equals the one-process decode of the same video, then
    shutdown lets both ranks return."""
    import csv as csv_lib
    from sais_tpu_torch.cli.serve import request
    _video(tmp_path, n=40)
    sock = str(tmp_path / "s.sock")
    argv = ["serve", "-p", str(tmp_path), "--random-init", "--device",
            "cpu", "--exact-preprocess", "-bs", "6", "--dtype", "float32",
            "--socket", sock, "--data-parallel", "2"]
    done = []
    t = threading.Thread(target=lambda: done.append(torch_ranks.run(
        torch_ranks.cli, 2, tmp_path / "r", argv, _tiny_pipeline())))
    t.start()
    for _ in range(600):
        if os.path.exists(sock):
            try:
                if request(sock, {"cmd": "ping"}, timeout=5).get("pong"):
                    break
            except OSError:
                pass
        time.sleep(0.1)
    resp = request(sock, {"video": "vid"}, timeout=120)
    request(sock, {"cmd": "shutdown"}, timeout=30)
    t.join(timeout=120)
    assert resp["ok"] and resp["frames"] == 40, resp
    assert done and not t.is_alive()
    with open(resp["csv"]) as f:
        served = list(csv_lib.DictReader(f))
    from sais_tpu_torch.cli import main as cli
    old = cli.PipelineConfig
    cli.PipelineConfig = _tiny_pipeline
    try:
        cli.main(["pipeline", "-f", "vid", "-p", str(tmp_path),
                  "--random-init", "--device", "cpu", "--exact-preprocess",
                  "-bs", "6", "--dtype", "float32", "--force"])
    finally:
        cli.PipelineConfig = old
    with open(tmp_path / "results" / "Custom_inference_gestures.csv") as f:
        want = list(csv_lib.DictReader(f))
    assert len(want) == len(served) == resp["intervals"]
    for g, w in zip(served, want):
        assert g.keys() == w.keys()
        for k in w:
            try:
                assert abs(float(g[k]) - float(w[k])) <= 1e-5, k
            except ValueError:
                assert g[k] == w[k], k
