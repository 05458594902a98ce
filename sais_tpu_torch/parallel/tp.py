"""Tensor-parallel ViT forward: Megatron-style sharding over a mesh's
'model' axis.  Counterpart of `sais_tpu/parallel/tp.py`.

Attention heads and MLP hidden units are split column-wise over the model
ranks, the output projections row-wise, with one all-reduce (SUM over the
'model' group) after attention and one after the MLP in each block; the
'data' axis splits the batch at the same time (a 2-D mesh).  The output
projections' biases are divided by the number of shards, since every
shard adds its copy before the sum, as in JAX.

As in JAX's `_tp_block` the block runs in plain float32 ops with exact
GELU (the float32 `vit_forward`'s arithmetic), not on the fused kernels.
A library path: no command reaches it.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from sais_tpu_torch.models.vit import (VisionTransformer, _layer_norm,
                                       prepare_tokens)
from sais_tpu_torch.parallel import mesh as mesh_lib
from sais_tpu_torch.parallel.mesh import MODEL_AXIS

Shard = Dict[str, torch.Tensor]


def shard_vit_params_tp(model: VisionTransformer, n_model: int
                        ) -> List[List[Shard]]:
    """Split every block's attention heads and MLP hidden units over
    n_model shards: [shard][block] -> {qkv_w, qkv_b, proj_w, proj_b,
    fc1_w, fc1_b, fc2_w, fc2_b, ln1_s, ln1_b, ln2_s, ln2_b}, torch Linear
    layout (out, in), float32.  The patch embedding, tokens and final norm
    stay in `model`, replicated."""
    cfg = model.cfg
    h = cfg.num_heads
    if h % n_model or cfg.mlp_dim % n_model:
        raise ValueError(f"{h} heads and MLP width {cfg.mlp_dim} must "
                         f"divide over {n_model} model shards")
    d, dh = cfg.embed_dim, cfg.head_dim
    shards: List[List[Shard]] = [[] for _ in range(n_model)]
    for blk in model.blocks:
        a, m = blk.attn, blk.mlp
        qkv_w = a.qkv.weight.detach().float().reshape(3, h, dh, d)
        qkv_b = a.qkv.bias.detach().float().reshape(3, h, dh)
        proj_w = a.proj.weight.detach().float().reshape(d, h, dh)
        for i, (qw, qb, pw, f1w, f1b, f2w) in enumerate(zip(
                qkv_w.chunk(n_model, 1), qkv_b.chunk(n_model, 1),
                proj_w.chunk(n_model, 1),
                m.fc1.weight.detach().float().chunk(n_model, 0),
                m.fc1.bias.detach().float().chunk(n_model, 0),
                m.fc2.weight.detach().float().chunk(n_model, 1))):
            shards[i].append({
                "ln1_s": blk.norm1.weight.detach().float(),
                "ln1_b": blk.norm1.bias.detach().float(),
                "ln2_s": blk.norm2.weight.detach().float(),
                "ln2_b": blk.norm2.bias.detach().float(),
                "qkv_w": qw.reshape(-1, d).contiguous(),
                "qkv_b": qb.reshape(-1).contiguous(),
                "proj_w": pw.reshape(d, -1).contiguous(),
                # added once per shard, then summed: divided over shards
                "proj_b": a.proj.bias.detach().float() / n_model,
                "fc1_w": f1w.contiguous(), "fc1_b": f1b.contiguous(),
                "fc2_w": f2w.contiguous(),
                "fc2_b": m.fc2.bias.detach().float() / n_model})
    return shards


def put_tp_params(tp_params: List[List[Shard]], mesh,
                  device=None) -> List[Shard]:
    """This rank's shard (by its 'model' coordinate), on `device`."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    mine = tp_params[coord.get(MODEL_AXIS, 0)]
    return [{k: v.to(device) for k, v in blk.items()} for blk in mine]


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    return x


def _tp_block(x: torch.Tensor, p: Shard, num_heads_local: int,
              head_dim: int, eps: float, group) -> torch.Tensor:
    """One transformer block on a model shard, float32."""
    b, n, _ = x.shape
    y = _layer_norm(x, p["ln1_s"], p["ln1_b"], eps)
    qkv = F.linear(y, p["qkv_w"], p["qkv_b"]).reshape(
        b, n, 3, num_heads_local, head_dim)
    q, k, v = qkv.unbind(2)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * head_dim ** -0.5
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhnm,bmhd->bnhd", w, v).reshape(b, n, -1)
    x = x + _psum(F.linear(o, p["proj_w"], p["proj_b"]), group)
    y = _layer_norm(x, p["ln2_s"], p["ln2_b"], eps)
    hdn = F.gelu(F.linear(y, p["fc1_w"], p["fc1_b"]))
    return x + _psum(F.linear(hdn, p["fc2_w"], p["fc2_b"]), group)


@torch.no_grad()
def tp_vit_features(tp_params: List[Shard], images: torch.Tensor,
                    model: VisionTransformer, mesh) -> torch.Tensor:
    """Tensor- and data-parallel ViT forward over a ('data', 'model')
    mesh: images (B, H, W, 3), the same on every rank, B divisible by the
    data axis; tp_params this rank's shard (`put_tp_params`); `model`
    gives the replicated token preparation and final norm.  Returns the
    CLS features (B, D) float32 on every rank."""
    cfg = model.cfg
    n_model = mesh_lib.axis_size(mesh, MODEL_AXIS)
    h_loc = cfg.num_heads // n_model
    group = mesh_lib.axis_group(mesh, (MODEL_AXIS,))
    images = mesh_lib.shard_batch(images, mesh)
    x = prepare_tokens(model, images.float())
    for p in tp_params:
        x = _tp_block(x, p, h_loc, cfg.head_dim, cfg.layernorm_eps, group)
    x = _layer_norm(x, model.norm.weight, model.norm.bias,
                    cfg.layernorm_eps)
    return mesh_lib.all_gather(x[:, 0].contiguous(),
                               mesh_lib.batch_group(mesh))
