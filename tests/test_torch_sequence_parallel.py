"""The port's ring attention (`parallel.sequence`) on gloo ranks spawned
from the test (`tests/torch_ranks.py`) against the JAX package on the
conftest's 8 virtual CPU devices: the dense encoder is the oracle, as in
tests/test_sequence_parallel.py, with its limits (2e-5 on the encoder
output, 1e-6 / 1e-5 on the CLS row, 5e-4 on the parameter gradients).
K2 / K3 run as their plain versions here (CPU tensors); the ring of n
ranks in one process (`ring_in_one_process`) is held to whole-sequence
attention.  JAX's VMEM local-chunk tests (`_vmem_chunk_tokens`) have no
counterpart: the port's kernels take any length."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sais_tpu import config as jconfig
from sais_tpu.models import full_model as jfm
from sais_tpu.models.temporal import encoder_forward
from sais_tpu_torch import config as tconfig
from sais_tpu_torch.port.weights import full_model_params_from_jax

from tests import torch_ranks

DIM = 32


def _cfgs(layers=2, positions=64):
    t = dict(rep_dim=DIM, num_layers=layers, num_heads=2, ffn_dim=64,
             max_positions=positions)
    return (jconfig.ModelConfig(rep_dim=DIM, modalities="RGB",
                                temporal=jconfig.TemporalConfig(**t)),
            tconfig.ModelConfig(rep_dim=DIM, modalities="RGB",
                                temporal=tconfig.TemporalConfig(**t)))


def _params(jcfg, seed):
    return jax.tree.map(np.asarray, jfm.full_model_init(
        jax.random.key(seed), jcfg))


def _ragged_mask(rng, b, l):
    mask = np.zeros((b, l), bool)
    for i in range(b):
        mask[i, rng.integers(2, l + 1):] = True
    return mask


def test_ring_encoder_matches_jax_dense(tmp_path):
    """4 gloo ranks: the ring encoder at 37 tokens (ragged over the ring,
    ragged masks) and at 40 without a mask, against JAX's dense encoder:
    the output within 2e-5, the CLS row within 1e-6 / 1e-5 of row 0 of the
    dense attention."""
    rng = np.random.default_rng(0)
    jcfg, cfg = _cfgs()
    params = _params(jcfg, 0)
    cases = [(rng.normal(size=(3, 37, DIM)).astype(np.float32),
              _ragged_mask(rng, 3, 37)),
             (rng.normal(size=(2, 40, DIM)).astype(np.float32), None)]
    outs, _ = torch_ranks.run(torch_ranks.ring_encoder, 4, tmp_path, cfg,
                              full_model_params_from_jax(params), cases, 4)
    for (x, mask), (out, cls) in zip(cases, outs):
        want, attn = encoder_forward(
            params["frame_encoder"], jnp.asarray(x), jcfg.temporal,
            None if mask is None else jnp.asarray(mask))
        np.testing.assert_allclose(out, np.asarray(want), atol=2e-5,
                                   rtol=2e-5)
        np.testing.assert_allclose(cls, np.asarray(attn[:, 0, :]),
                                   atol=1e-6, rtol=1e-5)


def test_ring_gradients_match_jax_dense(tmp_path):
    """The backward ring (K3's plain version on each visiting chunk, dk /
    dv travelling home) on 4 gloo ranks: every encoder parameter's
    gradient of sum(out * w) within 5e-4 of jax.grad of the dense
    encoder (21 tokens, ragged masks)."""
    rng = np.random.default_rng(1)
    jcfg, cfg = _cfgs()
    params = _params(jcfg, 3)
    x = rng.normal(size=(2, 21, DIM)).astype(np.float32)
    mask = _ragged_mask(rng, 2, 21)
    w = rng.normal(size=(2, 21, DIM)).astype(np.float32)
    _, grads = torch_ranks.run(torch_ranks.ring_encoder, 4, tmp_path, cfg,
                               full_model_params_from_jax(params),
                               [(x, mask)], 4, 1, w)

    def loss(enc):
        out, _ = encoder_forward(enc, jnp.asarray(x), jcfg.temporal,
                                 jnp.asarray(mask))
        return jnp.sum(out * w)

    genc = jax.grad(loss)(jax.tree.map(jnp.asarray,
                                       params["frame_encoder"]))
    # the gradients in the port's layout: a full tree with the encoder's
    tree = dict(params, frame_encoder=jax.tree.map(np.asarray, genc))
    want = full_model_params_from_jax(tree)
    for name, g in grads.items():
        np.testing.assert_allclose(g, want["frame_encoder." + name].numpy(),
                                   atol=5e-4, rtol=5e-4, err_msg=name)


def test_ring_on_data_seq_mesh_and_all_masked_rows(tmp_path):
    """A 2 x 2 ('data', 'seq') mesh: each data row of the mesh takes its
    block of the batch and runs its own ring (20 tokens), within 2e-5 of
    JAX's dense encoder; ring_attention on 4 ranks gives exactly 0 for a
    batch row whose keys are all masked on every rank, and non-zero rows
    elsewhere."""
    rng = np.random.default_rng(2)
    jcfg, cfg = _cfgs(layers=1)
    params = _params(jcfg, 2)
    x = rng.normal(size=(2, 20, DIM)).astype(np.float32)
    mask = _ragged_mask(rng, 2, 20)
    outs, _ = torch_ranks.run(torch_ranks.ring_encoder, 4, tmp_path, cfg,
                              full_model_params_from_jax(params),
                              [(x, mask)], 2, 2)
    want, _ = encoder_forward(params["frame_encoder"], jnp.asarray(x),
                              jcfg.temporal, jnp.asarray(mask))
    np.testing.assert_allclose(outs[0][0], np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    q, k, v = (rng.normal(size=(2, 2, 16, 8)).astype(np.float32)
               for _ in range(3))
    bias = np.zeros((2, 16), np.float32)
    bias[1] = -1e30
    out = torch_ranks.run(torch_ranks.ring_rows, 4, tmp_path, q, k, v, bias)
    assert np.all(out[1] == 0.0) and np.any(out[0] != 0.0)


@pytest.mark.parametrize("n", [1, 3, 4])
def test_ring_in_one_process_matches_whole_sequence(n):
    """The schedule of n ranks in one process (every rank's forward and
    backward step in turn, the chunks handed on in a list; 37 tokens,
    masked tails, an element whose last 30 keys are masked) against K2 /
    K3's plain versions over the whole sequence (themselves held to the
    Pallas kernels in tests/test_torch_flash.py and
    test_torch_flash_bwd.py): out, lse, dq, dk, dv within 2e-5 of their
    largest value."""
    from sais_tpu_torch.kernels.flash_attention import (flash_attention_bwd,
                                                        flash_attention_fwd,
                                                        key_bias)
    from sais_tpu_torch.parallel.sequence import ring_in_one_process
    g = torch.Generator().manual_seed(n)
    q, k, v, do = (torch.randn((2, 3, 37, 16), generator=g)
                   for _ in range(4))
    mask = torch.zeros((2, 37), dtype=torch.bool)
    mask[1, 7:] = True
    bias = key_bias(mask)
    got = ring_in_one_process(q, k, v, bias, n, do)
    out, lse = flash_attention_fwd(q, k, v, bias)
    whole = (out, lse) + tuple(flash_attention_bwd(q, k, v, bias, out, lse,
                                                   do))
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, whole):
        assert (a - b).abs().max() <= 2e-5 * b.abs().max(), name


def _decoder_inputs(seed=4):
    import sais_tpu.config as jc
    jcfg, cfg = _cfgs(layers=2, positions=32)
    jp = dataclasses.replace(jc.PipelineConfig(), model=jcfg)
    tp = dataclasses.replace(tconfig.PipelineConfig(), model=cfg)
    params = _params(jcfg, seed)
    _, protos = jfm.prototypes_init(jax.random.key(seed + 1), 2)
    rgb = np.random.default_rng(seed).normal(size=(90, DIM)).astype(
        np.float32)
    return jp, tp, params, np.asarray(protos), rgb


def test_gesture_decoder_seq_parallel_matches_jax(tmp_path):
    """GestureDecoder(seq_mesh) over a 2-rank ring (16-frame windows, 3
    TTA offsets) against JAX's dense GestureDecoder: the window
    probabilities within 1e-5; with use_flash=False (--flash off) the
    seq_mesh is refused with JAX's message."""
    from sais_tpu.infer.pipeline import GestureDecoder as JDecoder
    from sais_tpu_torch.models.full_model import FullModel
    jp, tp, params, protos, rgb = _decoder_inputs()
    model = FullModel(tp.model)
    model.load_state_dict(full_model_params_from_jax(params))
    probs, refused = torch_ranks.run(torch_ranks.seq_decode, 2, tmp_path,
                                     tp, [(model, torch.tensor(protos))],
                                     rgb, 2)
    want = JDecoder([(jax.tree.map(jnp.asarray, params),
                      jnp.asarray(protos))], jp).window_probs("v", rgb,
                                                              None)
    np.testing.assert_allclose(probs, np.asarray(want), atol=1e-5)
    off = dataclasses.replace(jp, model=dataclasses.replace(
        jp.model, temporal=dataclasses.replace(jp.model.temporal,
                                               use_flash=False)))
    from sais_tpu.parallel.sequence import seq_mesh as jseq_mesh
    with pytest.raises(ValueError) as info:
        JDecoder([(params, protos)], off, seq_mesh=jseq_mesh(
            2, devices=jax.devices()[:2]))
    assert refused == str(info.value)


@pytest.mark.parametrize("kind,n", [
    ("seq", 2), pytest.param("seq2x2", 4, marks=pytest.mark.slow)])
def test_seq_parallel_training_matches_jax(tmp_path, kind, n):
    """PrototypeTrainer(seq_mesh) on a 2-rank ring, and on a 2 x 2
    ('data', 'seq') mesh (slow, as JAX marks its seq x data sweep): a
    train epoch over two batches of 6 (ragged masks) and an eval pass
    against JAX's trainer on the same mesh of virtual devices: losses,
    eval probabilities, prototypes and every parameter within 2e-5."""
    from sais_tpu.parallel.sequence import seq_mesh as jseq_mesh
    from sais_tpu.train.loop import PrototypeTrainer as JaxTrainer
    jcfg, cfg = _cfgs(layers=1, positions=16)
    params = _params(jcfg, 5)
    keys, protos = jfm.prototypes_init(jax.random.key(6), 2)
    protos = np.asarray(protos)
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(2):
        cols = (np.arange(6) % 2).astype(np.int32)
        mask = np.zeros((6, 1, 11), bool)
        mask[::2, 0, 8:] = True
        batches.append({"rgb": rng.normal(size=(6, 1, 10, DIM)).astype(
            np.float32), "rgb_mask": mask, "label_cols": cols,
            "labels": cols})
    mesh = jseq_mesh(2, n_data=n // 2, devices=jax.devices()[:n])
    jtr = JaxTrainer(jcfg, jconfig.TrainConfig(lr=0.1),
                     jax.tree.map(jnp.asarray, params), keys,
                     jnp.asarray(protos), seq_mesh=mesh)
    jl, _ = jtr.run_epoch(iter(batches), train=True)
    jel, _ = jtr.run_epoch(iter(batches[:1]), train=False)
    loss, eval_loss, probs, gprotos, state = torch_ranks.run(
        torch_ranks.prototype_fit, n, tmp_path, kind, cfg,
        full_model_params_from_jax(params), keys, protos, batches, 0.1)
    assert abs(loss - jl) < 2e-5 and abs(eval_loss - jel) < 2e-5
    _, _, jprobs = jtr._eval_step(jtr.state, jtr._device_batch(batches[0]))
    np.testing.assert_allclose(probs, np.asarray(jprobs)[:6], atol=2e-5)
    np.testing.assert_allclose(gprotos, np.asarray(jtr.state.prototypes),
                               atol=2e-5)
    want = full_model_params_from_jax(jax.tree.map(np.asarray,
                                                   jtr.state.model))
    for name, p in state.items():
        np.testing.assert_allclose(p, want[name].numpy(), atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("cmd", ["decode", "steps"])
def test_cli_seq_parallel(tmp_path, cmd):
    """`decode --seq-parallel 2` and `steps --seq-parallel 2` (2 gloo
    ranks, rank 0 writing the CSV) write the CSV the one-process command
    writes, its numbers within 1e-5."""
    import csv
    from sais_tpu_torch.cli import main as cli
    from sais_tpu_torch.io.feature_store import FeatureStore, rgb_store_path
    _, tp, _, _, _ = _decoder_inputs()
    tp = dataclasses.replace(tp, model=dataclasses.replace(
        tp.model, temporal=dataclasses.replace(tp.model.temporal,
                                               use_flash=True)))
    rng = np.random.default_rng(8)
    with FeatureStore(rgb_store_path(str(tmp_path)), "a") as fs:
        fs.write_video("vid", rng.normal(size=(600, DIM)).astype(
            np.float32))
    argv = [cmd, "-f", "vid", "-p", str(tmp_path), "--random-init",
            "--device", "cpu", "-mod", "RGB"]
    dest = tmp_path / "results" / ("Custom_inference_gestures.csv"
                                   if cmd == "decode" else "vid_steps.csv")
    torch_ranks.run(torch_ranks.cli, 2, tmp_path / "r",
                    argv + ["--seq-parallel", "2"], tp)
    with open(dest) as f:
        ring = list(csv.DictReader(f))
    old = cli.PipelineConfig
    cli.PipelineConfig = lambda: tp
    try:
        cli.main(argv)
    finally:
        cli.PipelineConfig = old
    with open(dest) as f:
        one = list(csv.DictReader(f))
    assert len(ring) == len(one)
    for a, b in zip(ring, one):
        assert a.keys() == b.keys()
        for key in b:
            try:
                assert abs(float(a[key]) - float(b[key])) <= 1e-5, key
            except ValueError:
                assert a[key] == b[key], key
