"""The operation and byte counts against hand counts: ViT-S/16 at about
9.2 GFLOP a frame, DINO's ViT-S/8 image, and the kernels' bounds at the
shapes of PERF.md's kernel table."""

import pytest
import torch

from portbench import flops, registry, trace

PEAKS = trace.PEAKS


def bound_ms(k, cap):
    km = registry.module("kernels", k)
    f, b = km.work(cap)
    return 1e3 * max(f / PEAKS[km.PEAK], b / PEAKS["hbm_bytes_per_s"]), f


def test_vits16_frame():
    # 196 patches of 768 values, 197 tokens, 12 blocks of D 384, MLP 1536
    want = (2 * 196 * 768 * 384 + 12 * (24 * 197 * 384 ** 2
                                        + 4 * 197 ** 2 * 384))
    got = flops.vit_forward(flops.vit_tokens(224, 16), 384, 12, 1536, 768)
    assert got == want
    assert abs(got / 1e9 - 9.197) < 1e-3


def test_dino_vits8_image():
    vit = dict(embed_dim=384, depth=12, mlp_dim=1536, patch_size=8,
               in_channels=3)
    d = dict(global_size=224, local_size=96, n_global_crops=2,
             n_local_crops=8, head_hidden=2048, head_bottleneck=256,
             out_dim=65536)
    g = flops.vit_forward(785, 384, 12, 1536, 192)
    loc = flops.vit_forward(145, 384, 12, 1536, 192)
    head = 2 * (384 * 2048 + 2048 * 2048 + 2048 * 256)
    last = 2 * 256 * 65536
    want = 3 * (2 * g + 8 * loc) + 2 * g + (head + last) * (3 * 10 + 2)
    assert flops.dino_image(vit, d) == want
    assert 510e9 < want < 525e9


def test_temporal_step_counts_valid_tokens_only():
    one = flops.temporal_train_step([101], 384, 2048, 4, 256)
    fwd = 4 * (8 * 101 * 384 ** 2 + 4 * 101 * 384 * 2048
               + 4 * 101 ** 2 * 384) + 2 * 384 * 256
    assert one == 3 * fwd


def test_k1_bound_at_the_table_shape():
    weights = 2 * (384 * 1152 + 1152 + 384 * 384 + 384 + 384 * 1536 + 1536
                   + 1536 * 384 + 384 + 4 * 384)
    ms, f = bound_ms("k1", (256, 197, 384, 1536, 197, 2, weights))
    assert abs(ms - 0.1959) < 5e-4


@pytest.mark.parametrize("k,shape,gflop", [
    ("k4", (128, 197, 384, 1536), 96.9), ("k5", (128, 197, 384, 1536), 148.7),
    ("k6", (128, 197, 384), 104.7), ("k4", (128, 785, 384, 1536), 476.8),
    ("k6", (128, 785, 384), 689.4)])
def test_training_block_flops(k, shape, gflop):
    _, f = bound_ms(k, shape)
    assert abs(f / 1e9 - gflop) < 0.06


@pytest.mark.parametrize("rs,rt,gflop", [(640, 128, 68.7),
                                         (2560, 512, 274.9)])
def test_k7_flops(rs, rt, gflop):
    _, f = bound_ms("k7", (rs, rt, 256, 65536, 1))
    assert abs(f / 1e9 - gflop) < 0.06


@pytest.mark.parametrize("k,ms", [("k2", 0.1114), ("k3", 0.2785)])
def test_flash_bounds_unmasked(k, ms):
    got, _ = bound_ms(k, ((132, 4, 301, 96), 301, None))
    assert abs(got - ms) < 5e-4


def test_flash_counts_valid_pairs_only():
    bias = torch.zeros(2, 10)
    bias[1, 4:] = -1e30
    _, f = bound_ms("k2", ((2, 4, 10, 8), 10, bias))
    assert f == 4 * 4 * 8 * (10 ** 2 + 4 ** 2)
