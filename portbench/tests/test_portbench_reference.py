"""Each reference against the port's plain path at a tiny size: a run of
each cell on the CPU, where the port's kernels run their plain PyTorch
versions, comes out correct under limits read at that size; and the
reference ViT alone against the port's float32 parity path."""

import time

import pytest
import torch

from portbench import harness, weights
from portbench.reference import vit as ref_vit
from portbench.tests import tiny


@pytest.mark.parametrize("workload", ["extract.vits16.b256",
                                      "train.temporal.l2000",
                                      "pretrain.vits8.b64"])
def test_cell_is_correct_against_the_plain_path(workload):
    spec = tiny.spec(workload)
    r = harness.run_cell(spec, 2 ** 31 + 17, 0.5, False, torch.device("cpu"),
                         time.perf_counter())
    line = harness.result_line(spec, r, False, "cpu", 1)
    assert line["correct"], line["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(line)[-1] == "compared"


@pytest.mark.parametrize("size,patch", [(32, 16), (32, 8), (16, 8)])
def test_reference_vit_matches_the_port_float32_path(size, patch):
    from sais_tpu_torch.config import ViTConfig
    from sais_tpu_torch.models.vit import VisionTransformer, vit_forward
    cfg = dict(image_size=32, patch_size=patch, embed_dim=64, depth=2,
               num_heads=2, mlp_ratio=4.0, qkv_bias=True,
               layernorm_eps=1e-6, in_channels=3)
    model = VisionTransformer(ViTConfig(**cfg))
    gen = torch.Generator().manual_seed(3)
    w = weights.draw(weights.module_shapes(model), weights.vit_rule, gen)
    weights.load(model, w)
    x = torch.randn(3, size, size, 3, generator=gen)
    with torch.no_grad():
        got = ref_vit.features(w, x, cfg)
        want = vit_forward(model, x)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_drawn_weights_follow_their_rules():
    gen = torch.Generator().manual_seed(0)
    w = weights.draw({"a.weight": (400, 300), "a.bias": (7,),
                      "norm.weight": (5,)}, weights.vit_rule, gen)
    assert abs(float(w["a.weight"].std()) - 0.02) < 1e-3
    assert float(w["a.bias"].abs().max()) == 0.0
    assert float((w["norm.weight"] - 1).abs().max()) == 0.0
    again = weights.draw({"a.weight": (400, 300), "a.bias": (7,),
                          "norm.weight": (5,)}, weights.vit_rule,
                         torch.Generator().manual_seed(0))
    assert torch.equal(w["a.weight"], again["a.weight"])
