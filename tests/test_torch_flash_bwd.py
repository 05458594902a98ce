"""K3 (the flash-attention backward of sais_tpu_torch.kernels.
flash_attention) and the differentiable flash path against the JAX package
on the CPU.  The JAX side runs its Pallas kernels in interpret mode, as
tests/test_flash_attention.py does; the port's wrappers run their plain
versions because the tensors lie on the CPU.  The CUDA kernel is held
against the plain version on the card in tests/test_torch_cuda.py."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sais_tpu.config import ModelConfig as JModelConfig
from sais_tpu.config import TemporalConfig as JTemporalConfig
from sais_tpu.kernels import flash_attention as jfa
from sais_tpu.models import full_model as jfm
from sais_tpu.models.temporal import encoder_forward as jax_encoder
from sais_tpu_torch.config import ModelConfig, TemporalConfig
from sais_tpu_torch.kernels.flash_attention import (
    FlashAttention, flash_attention, flash_attention_bwd,
    flash_attention_fwd, flash_attention_packed, split_heads)
from sais_tpu_torch.models import full_model as tfm
from sais_tpu_torch.models.temporal import encoder_forward
from sais_tpu_torch.port.weights import full_model_params_from_jax


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in shapes)


def _tail_mask(b, l, all_masked=None):
    """Element i keeps l - 7 i keys; `all_masked` names an element with
    every key masked."""
    mask = np.zeros((b, l), bool)
    for i in range(b):
        mask[i, l - 7 * i:] = True
    if all_masked is not None:
        mask[all_masked] = True
    return mask


def _t(*arrays, grad=False):
    return tuple(torch.tensor(a, requires_grad=grad) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _padded_like_jax(arrays, bias, l):
    """The padding `flash_attention` applies before `_run_fwd` /
    `_run_bwd`: L to the block step (blocks clamped to the 128-aligned
    length) with -1e30 keys and zero rows, Dh to 128 lanes."""
    lmax = max(l + (-l) % 128, 128)
    step = math.lcm(min(512, lmax), min(512, lmax))
    lp = l + (-l) % step
    pad = [np.pad(x, [(0, 0), (0, 0), (0, lp - l), (0, 128 - x.shape[-1])])
           for x in arrays]
    return pad, np.pad(bias, [(0, 0), (0, lp - l)],
                       constant_values=-1e30), lp


@pytest.mark.parametrize("l,dh", [(37, 96), (130, 64)])
def test_bwd_plain_version_matches_run_bwd(l, dh):
    """K3's plain version against `_run_bwd` in interpret mode, both fed
    the out and lse of their own forward, on inputs padded as
    `flash_attention` pads them (the -1e30 pad keys and zero pad queries
    add exactly 0 wherever a row has a valid key).  Masked tails differ
    per element.  Limit 2e-4, the JAX package's own backward limit
    (tests/test_flash_attention.py:74): f32, summation order only."""
    b, h = 3, 4
    q, k, v, do = _arrays(l, *[(b, h, l, dh)] * 4)
    bias = np.where(_tail_mask(b, l), -1e30, 0.0).astype(np.float32)
    (qp, kp, vp, dop), bp, lp = _padded_like_jax((q, k, v, do), bias, l)
    scale = dh ** -0.5
    jout, jlse = jfa._run_fwd(*_j(qp, kp, vp, bp), scale, lp, lp, True)
    ref = jfa._run_bwd(*_j(qp, kp, vp, bp), jout, jlse, jnp.asarray(dop),
                       scale, lp, lp, True)
    out, lse = flash_attention_fwd(*_t(q, k, v, bias))
    got = flash_attention_bwd(*_t(q, k, v, bias), out, lse,
                              torch.tensor(do))
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.shape == (b, h, l, dh)
        np.testing.assert_allclose(g.numpy(), np.asarray(r)[:, :, :l, :dh],
                                   rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("l,dh", [(37, 96), (130, 64)])
def test_flash_attention_grad_matches_jax(l, dh):
    """Gradients of `flash_attention` (the port's autograd Function, K3's
    plain version here) against jax.grad of the JAX `flash_attention`
    (its custom VJP, Pallas kernels in interpret mode), with masked tails
    and one all-masked element.  Limit 2e-4 (as above)."""
    b, h = 3, 4
    q, k, v, cot = _arrays(l + 1, *[(b, h, l, dh)] * 4)
    mask = _tail_mask(b, l, all_masked=1)

    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, jnp.asarray(mask), interpret=True)
        return jnp.sum(out * cot)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*_j(q, k, v))
    tq, tk, tv = _t(q, k, v, grad=True)
    flash_attention(tq, tk, tv, torch.tensor(mask)).backward(
        torch.tensor(cot))
    for name, g, r in zip("qkv", (tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4,
                                   atol=2e-4, err_msg=name)
        assert not g[1].any()


def test_all_masked_element_gives_zero_output_and_gradients():
    """The contract of flash_attention.py:496-504: an element whose keys
    are all masked gives zeros, and its dq, dk, dv are exactly 0, through
    both the unpacked and the packed Function; the other elements' are
    not."""
    b, h, l, dh = 3, 2, 40, 64
    q, k, v, cot = _arrays(5, *[(b, h, l, dh)] * 4)
    mask = torch.tensor(_tail_mask(b, l, all_masked=2))
    tq, tk, tv = _t(q, k, v, grad=True)
    out = flash_attention(tq, tk, tv, mask)
    assert torch.count_nonzero(out[2]) == 0
    out.backward(torch.tensor(cot))
    for g in (tq.grad, tk.grad, tv.grad):
        assert torch.count_nonzero(g[2]) == 0 and g[:2].abs().max() > 0
    qkv = torch.tensor(np.concatenate(
        [x.transpose(0, 2, 1, 3).reshape(b, l, h * dh) for x in (q, k, v)],
        -1), requires_grad=True)
    packed = flash_attention_packed(qkv, h, mask)
    torch.testing.assert_close(packed, out.detach(), rtol=0, atol=1e-6)
    packed.backward(torch.tensor(cot))
    assert torch.count_nonzero(qkv.grad[2]) == 0


def _dense(q, k, v, bias):
    s = torch.einsum("bhld,bhmd->bhlm", q * q.shape[-1] ** -0.5, k)
    if bias is not None:
        s = s + bias[:, None, None, :]
    return torch.einsum("bhlm,bhmd->bhld", torch.softmax(s, -1), v)


@pytest.mark.parametrize("lq,lk", [(50, 50), (33, 70)])
def test_function_gradients_match_dense_autograd(lq, lk):
    """`FlashAttention.apply` (plain K2 forward, plain K3 backward from the
    explicit formula) against PyTorch autograd of dense attention with the
    same additive bias, Lq = Lk and Lq != Lk.  Limit 1e-5: f32 on both
    sides, the same products in another order."""
    b, h, dh = 2, 3, 32
    q, cq = _arrays(1, (b, h, lq, dh), (b, h, lq, dh))
    k, v = _arrays(2, (b, h, lk, dh), (b, h, lk, dh))
    bias = np.where(_tail_mask(b, lk), -1e30, 0.0).astype(np.float32)
    grads = []
    for fn in (lambda *a: FlashAttention.apply(*a, False), _dense):
        tq, tk, tv = _t(q, k, v, grad=True)
        out = fn(tq, tk, tv, torch.tensor(bias))
        out.backward(torch.tensor(cq))
        grads.append((out.detach(), tq.grad, tk.grad, tv.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_packed_gradient_is_one_projection_buffer():
    """`flash_attention_packed` returns the gradient of the whole (B, L, 3 D)
    projection as one contiguous buffer, equal to the gradient through
    split views and the unpacked Function."""
    b, l, h, dh = 2, 45, 4, 16
    (x,) = _arrays(3, (b, l, 3 * h * dh))
    (cot,) = _arrays(4, (b, h, l, dh))
    mask = torch.tensor(_tail_mask(b, l))
    grads = []
    for packed in (True, False):
        qkv = torch.tensor(x, requires_grad=True)
        out = (flash_attention_packed(qkv, h, mask) if packed
               else flash_attention(*split_heads(qkv, h), mask))
        out.backward(torch.tensor(cot))
        grads.append(qkv.grad)
    assert grads[0].is_contiguous() and grads[0].shape == (b, l, 3 * h * dh)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-7)


def test_encoder_gradient_step_flash_vs_dense_and_jax():
    """A gradient through the port's flash encoder (K2 / K3 plain versions)
    against its dense encoder and against jax.grad of the JAX flash
    encoder (interpret mode): 1 layer, D 64, 4 heads, L 140 with a masked
    tail, the loss of tests/test_flash_attention.py:74-94.  Limits 5e-4
    relative, 5e-5 absolute, the JAX package's flash-vs-dense limits."""
    tcfg = dict(rep_dim=64, num_layers=1, num_heads=4, ffn_dim=96)
    jcfg = JModelConfig(rep_dim=64, modalities="RGB",
                        temporal=JTemporalConfig(**tcfg))
    cfg = ModelConfig(rep_dim=64, modalities="RGB",
                      temporal=TemporalConfig(**tcfg))
    jparams = jfm.full_model_init(jax.random.key(8), jcfg)
    (x,) = _arrays(9, (2, 140, 64))
    mask = np.zeros((2, 140), bool)
    mask[0, 120:] = True

    def jloss(enc):
        out, _ = jax_encoder(enc, jnp.asarray(x), jcfg.temporal,
                             jnp.asarray(mask), use_flash=True,
                             interpret=True)
        return jnp.sum(jnp.where(jnp.asarray(mask)[..., None], 0.0, out) ** 2)

    jgrad = jax.grad(jloss)(jparams["frame_encoder"])
    jgrad_sd = full_model_params_from_jax(dict(jparams,
                                               frame_encoder=jgrad))
    grads = {}
    for use_flash in (True, False):
        model = tfm.FullModel(cfg)
        model.load_state_dict(full_model_params_from_jax(jparams))
        out, _ = encoder_forward(model.frame_encoder, torch.tensor(x),
                                 cfg.temporal, torch.tensor(mask),
                                 use_flash=use_flash)
        (torch.where(torch.tensor(mask)[..., None], 0.0, out) ** 2).sum(
        ).backward()
        grads[use_flash] = {n: p.grad for n, p in model.named_parameters()
                            if n.startswith("frame_encoder.")}
    for name, g in grads[True].items():
        np.testing.assert_allclose(g.numpy(), grads[False][name].numpy(),
                                   rtol=5e-4, atol=5e-5, err_msg=name)
        np.testing.assert_allclose(g.numpy(), jgrad_sd[name].numpy(),
                                   rtol=5e-4, atol=5e-5, err_msg=name)


def test_cpu_gradient_runs_plain_versions_without_counting():
    """On CPU tensors the Function's passes are the plain versions: no
    launch is counted, and the gradient equals the explicit formula's."""
    q, k, v, cot = _arrays(6, *[(1, 2, 20, 64)] * 4)
    tq, tk, tv = _t(q, k, v, grad=True)
    before = flash_attention_bwd.launches
    out = flash_attention(tq, tk, tv)
    out.backward(torch.tensor(cot))
    assert flash_attention_bwd.launches == before
    want = flash_attention_bwd(*_t(q, k, v), None, out.detach(),
                               flash_attention_fwd(*_t(q, k, v))[1],
                               torch.tensor(cot))
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
