"""The port's tensor-parallel ViT forward (`parallel.tp`) on gloo ranks
spawned from the test (`tests/torch_ranks.py`) against the JAX package's
single-device `vit_features`, at tests/test_tensor_parallel.py's limit
(2e-5), and its parameter shards against JAX's `shard_vit_params_tp`."""

import numpy as np
import pytest

import jax

from sais_tpu.config import ViTConfig as JViT
from sais_tpu.models.vit import vit_features, vit_init
from sais_tpu.parallel.tp import shard_vit_params_tp as jshard
from sais_tpu_torch.config import ViTConfig
from sais_tpu_torch.models.vit import VisionTransformer
from sais_tpu_torch.parallel.tp import shard_vit_params_tp
from sais_tpu_torch.port.weights import vit_params_from_jax

from tests import torch_ranks


def _pair(seed, **kw):
    params = vit_init(jax.random.key(seed), JViT(**kw))
    sd = vit_params_from_jax(jax.tree.map(np.asarray, params))
    return params, sd, ViTConfig(**kw)


@pytest.mark.parametrize("n_model", [2, 4])
def test_shards_match_jax(n_model):
    """Every block's shards equal JAX's (its (in, out) layout transposed
    to torch's (out, in)): qkv heads, the output projection's rows, the
    MLP's columns and rows, the two output biases divided by the shards."""
    kw = dict(image_size=32, patch_size=8, embed_dim=64, depth=2,
              num_heads=4)
    params, sd, cfg = _pair(0, **kw)
    model = VisionTransformer(cfg)
    model.load_state_dict(sd)
    got = shard_vit_params_tp(model, n_model)
    want = jshard(params, JViT(**kw), n_model)
    for i in range(n_model):
        for blk, (g, w) in enumerate(zip(got[i], want["blocks"])):
            pairs = {"qkv_w": w["attn"]["qkv_w"][i].T,
                     "qkv_b": w["attn"]["qkv_b"][i],
                     "proj_w": w["attn"]["proj_w"][i].T,
                     "proj_b": w["attn"]["proj_b"][i],
                     "fc1_w": w["mlp"]["fc1_w"][i].T,
                     "fc1_b": w["mlp"]["fc1_b"][i],
                     "fc2_w": w["mlp"]["fc2_w"][i].T,
                     "fc2_b": w["mlp"]["fc2_b"][i]}
            for name, ref in pairs.items():
                np.testing.assert_allclose(g[name].numpy(), np.asarray(ref),
                                           rtol=1e-7, atol=1e-8,
                                           err_msg=f"{blk} {name}")


@pytest.mark.parametrize("n_model,kw,images", [
    (2, dict(image_size=32, patch_size=8, embed_dim=64, depth=2,
             num_heads=4), 8),
    pytest.param(4, dict(image_size=16, patch_size=8, embed_dim=64, depth=1,
                         num_heads=4), 4, marks=pytest.mark.slow)])
def test_tp_vit_matches_single_device(tmp_path, n_model, kw, images):
    """tp_vit_features on 4 gloo ranks, (data 2, model 2) with 8 images
    and (data 1, model 4, slow as in JAX) with 4: within 2e-5 of JAX's
    single-device vit_features."""
    params, sd, cfg = _pair(n_model, **kw)
    x = np.asarray(jax.random.uniform(jax.random.key(n_model + 1),
                                      (images, kw["image_size"],
                                       kw["image_size"], 3)))
    want = vit_features(params, x, JViT(**kw))
    got = torch_ranks.run(torch_ranks.tp_features, 4, tmp_path, sd, cfg, x,
                          n_model)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
