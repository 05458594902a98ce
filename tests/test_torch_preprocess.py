"""Port preprocessing (sais_tpu_torch.ops.preprocess) against the JAX
package: the crop, PIL-exact fixed-point resize and normalize must give
bitwise the same float32 images."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sais_tpu.config import PreprocessConfig as JaxPreprocessConfig
from sais_tpu.ops.preprocess import preprocess_batch as jax_preprocess
from sais_tpu_torch.config import PreprocessConfig
from sais_tpu_torch.ops.preprocess import (center_crop_bounds,
                                           preprocess_batch)


@pytest.mark.parametrize("h,w,resize", [
    (48, 64, 32),     # downscale
    (101, 77, 224),   # upscale, odd sizes (crop rounding)
    (240, 320, 224),  # downscale to the model size
    (20, 30, 40),     # upscale, non-square crop
])
def test_preprocess_bitwise_equal_to_jax(h, w, resize):
    rng = np.random.default_rng(h * w)
    frames = rng.integers(0, 256, (3, h, w, 3), dtype=np.uint8)
    ref = np.asarray(jax_preprocess(jnp.asarray(frames),
                                    JaxPreprocessConfig(resize=resize)))
    got = preprocess_batch(torch.from_numpy(frames),
                           PreprocessConfig(resize=resize)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_preprocess_bf16_is_rounded_float32():
    rng = np.random.default_rng(1)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 40, 50, 3),
                                           dtype=np.uint8))
    cfg = PreprocessConfig(resize=24)
    np.testing.assert_array_equal(
        preprocess_batch(frames, cfg, torch.bfloat16).float().numpy(),
        preprocess_batch(frames, cfg).to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("size,frac", [(101, 0.7), (480, 0.8), (77, 0.8)])
def test_center_crop_bounds_match_jax(size, frac):
    from sais_tpu.ops.preprocess import center_crop_bounds as jax_bounds
    assert center_crop_bounds(size, frac) == jax_bounds(size, frac)
