"""The port's RAFT (`sais_tpu_torch.models.raft`) against the JAX package's
on the CPU, from the same weights: the golden reference-layout state_dict
(`tests/golden/torch_raft.py`) read by `raft_params_from_torch` on the JAX
side and by `raft_state_from_reference` on the port's, or a JAX `raft_init`
carried across by `raft_state_from_jax`.  The f32 limit is the JAX
package's own against the golden torch RAFT (rtol 1e-3, atol 2e-3,
tests/test_raft_parity.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sais_tpu.config import RAFTConfig as JaxRAFTConfig
from sais_tpu.models import raft as jraft
from sais_tpu_torch.config import RAFTConfig
from sais_tpu_torch.models.raft import (RAFT, corr_lookup, corr_pyramid,
                                        pad_to_multiple_of_8, raft_forward,
                                        unpad)
from sais_tpu_torch.port.weights import (raft_state_from_jax,
                                         raft_state_from_reference)
from tests.golden.torch_raft import random_raft_state_dict

RTOL, ATOL = 1e-3, 2e-3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    """(reference state_dict, JAX params, port model) from one seed."""
    sd = random_raft_state_dict(torch.Generator().manual_seed(0))
    model = RAFT(RAFTConfig())
    model.load_state_dict(raft_state_from_reference(sd))
    return sd, jraft.raft_params_from_torch(sd), model.eval()


def _pair(h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32),
            rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32))


def _jax_flow(params, a, b, cfg, iters, dtype=jnp.float32):
    fn = jax.jit(lambda p, x, y: jraft.raft_forward(
        p, x, y, cfg, iters=iters, compute_dtype=dtype))
    return np.asarray(fn(params, a, b))


def _port_flow(model, a, b, iters, dtype=torch.float32, cfg=None):
    with torch.inference_mode():
        return raft_forward(model, torch.from_numpy(a), torch.from_numpy(b),
                            cfg, iters=iters, compute_dtype=dtype).numpy()


@pytest.fixture(scope="module")
def f32_cases(weights):
    """JAX's f32 flow at 64x72 (iters 2 and 3) and 72x88 (feature maps 9x11:
    odd, so pooling floors), shared by the f32 and bf16 tests."""
    _, params, _ = weights
    out = {}
    for h, w, iters in ((64, 72, 2), (64, 72, 3), (72, 88, 2)):
        a, b = _pair(h, w, seed=h + iters)
        out[(h, w, iters)] = (a, b, _jax_flow(params, a, b, JaxRAFTConfig(),
                                              iters))
    return out


@pytest.mark.parametrize("case", [(64, 72, 2), (64, 72, 3), (72, 88, 2)])
def test_raft_forward_f32_matches_jax(weights, f32_cases, case):
    _, _, model = weights
    a, b, ref = f32_cases[case]
    got = _port_flow(model, a, b, case[2])
    assert got.shape == ref.shape == (1, case[0], case[1], 2)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_raft_bf16_encoders_match_jax(weights, f32_cases):
    """Encoders in bf16 (the pipeline's default compute dtype), the rest in
    f32, against JAX's same split: within 5e-2 of the largest flow value
    (measured: 0.55-0.65% of it; JAX folds the batch norms into bf16
    convolution weights, the port applies them after the convolution)."""
    _, params, model = weights
    a, b, _ = f32_cases[(64, 72, 2)]
    ref = _jax_flow(params, a, b, JaxRAFTConfig(), 2, jnp.bfloat16)
    got = _port_flow(model, a, b, 2, torch.bfloat16)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 5e-2 * scale


def test_raft_independent_dims_and_degenerate_levels():
    """hidden_dim 96, context_dim 160 (the context split is at hidden_dim,
    the GRU gates take 96 + 160 + 128 channels) at 32x40: feature maps
    4x5, so the pyramid's levels are 4x5, 2x2, 1x1 and 0x0 (one pixel
    wide, then empty), at the f32 limit.  Weights: JAX's raft_init
    carried across by raft_state_from_jax."""
    jcfg = JaxRAFTConfig(hidden_dim=96, context_dim=160)
    params = jraft.raft_init(jax.random.key(0), jcfg)
    model = RAFT(RAFTConfig(hidden_dim=96, context_dim=160))
    model.load_state_dict(raft_state_from_jax(_np_tree(params)))
    a, b = _pair(32, 40, seed=5)
    pyramid = corr_pyramid(torch.ones(1, 8, 4, 5), torch.ones(1, 8, 4, 5), 4)
    assert [tuple(c.shape[2:]) for c in pyramid] == [(4, 5), (2, 2), (1, 1),
                                                    (0, 0)]
    ref = _jax_flow(params, a, b, jcfg, 2)
    got = _port_flow(model.eval(), a, b, 2)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_raft_refuses_small_and_zero_iters(weights):
    _, params, model = weights
    img = np.zeros((1, 32, 40, 3), np.uint8)
    with pytest.raises(NotImplementedError, match="small"):
        jraft.raft_forward(params, img, img, JaxRAFTConfig(small=True))
    with pytest.raises(NotImplementedError, match="small"):
        _port_flow(model, img, img, None, cfg=RAFTConfig(small=True))
    with pytest.raises(ValueError, match="iters >= 1"):
        jraft.raft_forward(params, img, img, JaxRAFTConfig(), iters=0)
    with pytest.raises(ValueError, match="iters >= 1"):
        _port_flow(model, img, img, 0)


def test_lookup_matches_jax_gather():
    """The radius lookup alone against JAX's gather mode (the one with
    grid_sample's semantics) at random coordinates, a quarter of them
    outside the level, on a pyramid with a one-pixel-wide level."""
    rng = np.random.default_rng(1)
    b, h, w, d = 2, 6, 9, 16
    f1 = rng.standard_normal((b, h, w, d)).astype(np.float32)
    f2 = rng.standard_normal((b, h, w, d)).astype(np.float32)
    coords = rng.uniform(-3, 12, (b, h, w, 2)).astype(np.float32)
    jpyr = jraft.corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    ref = np.asarray(jraft.corr_lookup(jpyr, jnp.asarray(coords), 4,
                                       mode="gather"))
    tpyr = corr_pyramid(torch.from_numpy(f1).permute(0, 3, 1, 2),
                        torch.from_numpy(f2).permute(0, 3, 1, 2), 4)
    assert [tuple(c.shape[2:]) for c in tpyr] == [(6, 9), (3, 4), (1, 2),
                                                 (0, 1)]
    for jc, tc in zip(jpyr, tpyr):
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                                   atol=1e-5)
    got = corr_lookup(tpyr, torch.from_numpy(coords).permute(0, 3, 1, 2), 4)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,w", [(50, 70), (64, 72), (57, 8)])
def test_pad_and_unpad_match_jax(h, w):
    img = np.random.default_rng(h).integers(
        0, 256, (2, h, w, 3)).astype(np.float32)
    ref, jpads = jraft.pad_to_multiple_of_8(jnp.asarray(img))
    got, pads = pad_to_multiple_of_8(torch.from_numpy(img))
    assert pads == tuple(jpads)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    flow = np.array(ref)[..., :2]
    np.testing.assert_array_equal(
        unpad(torch.from_numpy(flow), pads).numpy(),
        np.asarray(jraft.unpad(jnp.asarray(flow), jpads)))
    assert unpad(got, pads).shape == img.shape


def test_raft_state_from_jax_round_trip():
    """JAX's raft_init through raft_state_from_jax gives JAX's flow, and
    raft_params_from_torch of that state_dict is the same pytree."""
    params = _np_tree(jraft.raft_init(jax.random.key(2), JaxRAFTConfig()))
    sd = raft_state_from_jax(params)
    back = _np_tree(jraft.raft_params_from_torch(sd))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(x, y)
    model = RAFT(RAFTConfig())
    model.load_state_dict(sd)
    a, b = _pair(40, 48, seed=2)
    np.testing.assert_allclose(
        _port_flow(model.eval(), a, b, 2),
        _jax_flow(params, a, b, JaxRAFTConfig(), 2), rtol=RTOL, atol=ATOL)


def test_raft_state_from_reference_takes_wrappers_and_norm3(weights):
    """A ptlflow-style {'state_dict': ...} with 'model.' prefixes, the third
    norms under norm3 only and num_batches_tracked entries loads to the
    same state_dict as the plain one."""
    sd, _, model = weights
    wrapped = {}
    for k, v in sd.items():
        wrapped["model." + k.replace(".downsample.1.", ".norm3.")] = v
        if k.endswith("running_var"):
            wrapped["model." + k.replace("running_var",
                                         "num_batches_tracked")] = \
                torch.tensor(7)
    got = raft_state_from_reference({"state_dict": wrapped})
    ref = model.state_dict()
    assert set(got) == set(ref)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0)


@pytest.mark.slow
@pytest.mark.parametrize("h,w,iters", [(128, 128, 3), (136, 152, 2)])
def test_raft_matches_jax_at_parity_sizes(weights, h, w, iters):
    """The JAX parity tests' sizes (tests/test_raft_parity.py), fnet 16x16
    and 17x19."""
    _, params, model = weights
    a, b = _pair(h, w, seed=h)
    np.testing.assert_allclose(
        _port_flow(model, a, b, iters),
        _jax_flow(params, a, b, JaxRAFTConfig(), iters), rtol=RTOL,
        atol=ATOL)
