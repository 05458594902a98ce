"""Sequence (context) parallelism: ring attention over a mesh's 'seq' axis.
Counterpart of `sais_tpu/parallel/sequence.py`.

The time axis of the temporal encoder is split over the ranks of the
'seq' axis.  Everything but attention acts per token, so each rank runs
the projections, LayerNorms and the feed-forward on its own chunk, and
attention runs as a RING: each rank holds one K / V / key-bias chunk,
the chunks move to rank + 1 (`dist.batch_isend_irecv`, the next chunk's
exchange posted before the current chunk's math), and every rank folds
each visiting chunk into its running state.  No rank ever holds the whole
sequence's scores.

- Forward: each visiting chunk goes through K2 (`flash_attention_fwd`:
  out and the chunk's row logsumexp; its plain version for CPU tensors),
  and the results merge by logsumexp as `_flash_ring_fwd_impl` does
  (sequence.py:110-146): acc = acc * exp(m - m') + o_c * exp(lse_c - m').
- Backward: a second ring (`RingAttention`, a torch.autograd.Function).
  With the GLOBAL row logsumexp saved from the forward, each chunk's
  probabilities are the true softmax values, so each chunk goes through
  K3 (`flash_attention_bwd`) as it stands: dq accumulates at home, dk and
  dv accumulate in f32 and travel with their chunk, home again after n
  steps.
- The export artifact, the last layer's head-averaged CLS-query row, is a
  collective softmax: the CLS query (position 0, on ring rank 0) is
  broadcast, each rank scores its own keys, and the row's max and sum are
  all-reduced (MAX, then SUM).

A rank's ring step is a function of its local tensors and the chunk it
holds (`ring_fwd_step`, `ring_bwd_step`); the exchange is a separate call
(`_rotate`), so the schedule of n ranks can also run in one process
(chip_smoke.py's `parallel` phase).

JAX's VMEM local chunking (`_ring_local_chunk`, sequence.py:95) has no
counterpart: K2 and K3 stream K and V from device memory and take any
length, so a rank's chunk of any length is one kernel call.

On a ('data', 'seq') mesh each data row of the mesh runs its own ring
over its batch shard; the ring's collectives run over the 'seq' group
only.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sais_tpu_torch.config import TemporalConfig
from sais_tpu_torch.kernels.flash_attention import (flash_attention_bwd,
                                                    flash_attention_fwd)
from sais_tpu_torch.parallel import mesh as mesh_lib

SEQ_AXIS = "seq"
DATA_AXIS = mesh_lib.DATA_AXIS

_NEG_INF = -1e30


def _dist():
    import torch.distributed as dist
    return dist


def seq_mesh(n_seq: int, n_data: int = 1,
             ranks: Optional[Sequence[int]] = None):
    """('data', 'seq') mesh: batches split over 'data', time over 'seq'.
    A ring's ranks are consecutive (the inner axis), so on one host its
    hops stay between neighbouring cards."""
    ranks = list(range(_dist().get_world_size()) if ranks is None
                 else ranks)
    if n_seq * n_data != len(ranks):
        raise ValueError(f"mesh {n_data}x{n_seq} != {len(ranks)} devices")
    return mesh_lib.mesh_from_ranks(
        np.asarray(ranks).reshape(n_data, n_seq), (DATA_AXIS, SEQ_AXIS))


def seq_group(mesh, axis_name: str = SEQ_AXIS):
    return mesh_lib.axis_group(mesh, (axis_name,))


# -- the exchange --------------------------------------------------------------

def _rotate(tensors: Sequence[torch.Tensor], group) -> "_Exchange":
    """Post the send of `tensors` (packed in one buffer) to the next rank
    of the group and the receive of the previous rank's; `.wait()` gives
    the received tensors, shaped like these."""
    return _Exchange(tensors, group)


class _Exchange:
    def __init__(self, tensors, group):
        dist = _dist()
        self.shapes = [(t.shape, t.dtype) for t in tensors]
        send = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        self.recv = torch.empty_like(send)
        ranks = dist.get_process_group_ranks(group)
        i = ranks.index(dist.get_rank())
        nxt, prv = ranks[(i + 1) % len(ranks)], ranks[(i - 1) % len(ranks)]
        self.send = send
        self.reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, nxt, group),
            dist.P2POp(dist.irecv, self.recv, prv, group)])

    def wait(self) -> List[torch.Tensor]:
        for r in self.reqs:
            r.wait()
        out, offset = [], 0
        for shape, dtype in self.shapes:
            n = int(np.prod(shape, dtype=np.int64))
            out.append(self.recv[offset:offset + n].view(shape).to(dtype))
            offset += n
        return out


# -- a rank's ring steps -------------------------------------------------------

class RingState(NamedTuple):
    """A rank's running online-softmax state: row max m, denominator l
    (B, H, L, 1) and the rescaled accumulator acc (B, H, L, Dh), f32."""

    m: torch.Tensor
    l: torch.Tensor
    acc: torch.Tensor


def ring_init(q: torch.Tensor) -> RingState:
    b, h, lq, dh = q.shape
    kw = dict(dtype=torch.float32, device=q.device)
    return RingState(torch.full((b, h, lq, 1), _NEG_INF, **kw),
                     torch.zeros((b, h, lq, 1), **kw),
                     torch.zeros((b, h, lq, dh), **kw))


def ring_fwd_step(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                  bc: torch.Tensor, state: RingState) -> RingState:
    """Fold one visiting K / V / bias chunk into a rank's state: K2 on the
    chunk (out, lse), merged by logsumexp."""
    o_c, lse_c = flash_attention_fwd(q, kc, vc, bc)
    lse_c = lse_c[..., None]
    m_new = torch.maximum(state.m, lse_c)
    alpha = torch.exp(state.m - m_new)
    w_c = torch.exp(lse_c - m_new)
    return RingState(m_new, state.l * alpha + w_c,
                     state.acc * alpha + o_c.float() * w_c)


def ring_finish(state: RingState, dtype=torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, global row lse (B, H, L)) from a rank's final state."""
    l_safe = torch.clamp(state.l, min=1e-30)
    return ((state.acc / l_safe).to(dtype),
            (state.m + torch.log(l_safe))[..., 0].contiguous())


def ring_bwd_step(q, kc, vc, bc, out, lse, do, dq, dkc, dvc
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One chunk of the backward ring: K3 on the chunk with the global
    lse; dq accumulates at home, dk / dv (f32) with the chunk."""
    dq_c, dk_c, dv_c = flash_attention_bwd(q, kc, vc, bc, out, lse, do)
    return dq + dq_c, dkc + dk_c, dvc + dv_c


def ring_forward(q, k, v, bias, group, n: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward ring on this rank: (out, global lse)."""
    state = ring_init(q)
    kc, vc, bc = k, v, bias
    for step in range(n):
        ex = _rotate((kc, vc, bc), group) if step + 1 < n else None
        state = ring_fwd_step(q, kc, vc, bc, state)
        if ex is not None:
            kc, vc, bc = ex.wait()
    return ring_finish(state, q.dtype)


def ring_backward(q, k, v, bias, out, lse, do, group, n: int):
    """The backward ring on this rank: (dq, dk, dv), dk / dv back home."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkc = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dvc = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    kc, vc, bc = k, v, bias
    for _ in range(n):
        dq, dkc, dvc = ring_bwd_step(q, kc, vc, bc, out, lse, do, dq, dkc,
                                     dvc)
        if n > 1:
            kc, vc, bc, dkc, dvc = _rotate((kc, vc, bc, dkc, dvc),
                                           group).wait()
    return dq.to(q.dtype), dkc.to(k.dtype), dvc.to(v.dtype)


class RingAttention(torch.autograd.Function):
    """apply(q, k, v, bias, group, n): a rank's attention output (B, H,
    Lloc, Dh) over every rank's keys; q, k, v this rank's chunk, bias (B,
    Lloc) f32 its keys' additive bias.  Backward: the second ring."""

    @staticmethod
    def forward(ctx, q, k, v, bias, group, n):
        q, k, v = (t.contiguous() for t in (q, k, v))
        out, lse = ring_forward(q, k, v, bias, group, n)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.group, ctx.n = group, n
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv = ring_backward(q, k, v, bias, out, lse, do.contiguous(),
                                   ctx.group, ctx.n)
        return dq, dk, dv, None, None, None


def _any_valid(bias: torch.Tensor, group) -> torch.Tensor:
    """(B,) f32: 1 where a batch row has a valid key on any rank."""
    valid = (bias > _NEG_INF * 0.5).any(-1).float()
    if group is not None:
        valid = valid.clone()
        _dist().all_reduce(valid, group=group)
    return (valid > 0).float()


def ring_attention(q, k, v, bias, group, n: int) -> torch.Tensor:
    """Ring attention on a rank's chunks (JAX `_ring_attention_local`):
    q, k, v (B, H, Lloc, Dh), bias (B, Lloc) f32 (0 valid, -1e30 pad).  A
    batch row whose keys are all masked on every rank gives zeros (the
    flash kernel's rule)."""
    out = RingAttention.apply(q, k, v, bias, group, n)
    return out * _any_valid(bias, group)[:, None, None, None].to(out.dtype)


@torch.no_grad()
def ring_cls_row(q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor,
                 group) -> torch.Tensor:
    """The head-averaged CLS-query attention row, sequence-sharded (JAX
    `_ring_cls_row_local`): the CLS query (global position 0) is on ring
    rank 0 and reaches every rank with one SUM; each rank scores it
    against its own keys; the softmax's max and sum are all-reduced.
    Returns this rank's (B, Lloc) piece of the (B, L) row."""
    dist = _dist()
    dh = q.shape[-1]
    first = dist.get_rank(group) == 0
    # a contiguous copy: q is a view of the projection, and a collective
    # writes the tensor's storage in place
    q0 = (q[:, :, 0, :].float().contiguous() if first
          else torch.zeros(q.shape[:2] + q.shape[3:], dtype=torch.float32,
                           device=q.device))
    dist.all_reduce(q0, group=group)
    q0 = q0 * dh ** -0.5
    logits = torch.einsum("bhd,bhmd->bhm", q0, k.float())
    logits = logits + bias[:, None, :]
    m = logits.amax(-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    p = torch.exp(logits - m[..., None])
    denom = p.sum(-1)
    dist.all_reduce(denom, group=group)
    return (p / denom[..., None]).mean(dim=1)


# -- the encoder ---------------------------------------------------------------

def _encoder_local(encoder, x: torch.Tensor, bias: torch.Tensor,
                   cfg: TemporalConfig, group, n: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The post-norm encoder stack on a rank's chunk: x (B, Lloc, D), bias
    (B, Lloc) f32 -> (x, the last layer's CLS row piece (B, Lloc))."""
    from sais_tpu_torch.models.temporal import _layer_norm
    from sais_tpu_torch.kernels.flash_attention import split_heads
    cls_row = None
    layers = list(encoder.layers)
    eps = cfg.layernorm_eps
    for i, layer in enumerate(layers):
        mha = layer.self_attn
        b, lloc, d = x.shape
        qkv = F.linear(x, mha.in_proj_weight, mha.in_proj_bias)
        q, k, v = split_heads(qkv, cfg.num_heads)
        y = ring_attention(q, k, v, bias, group, n)
        y = mha.out_proj(y.transpose(1, 2).reshape(b, lloc, d))
        if i == len(layers) - 1:
            cls_row = ring_cls_row(q, k, bias, group)
        x = _layer_norm(x + y, layer.norm1.weight, layer.norm1.bias, eps)
        h = layer.linear2(torch.relu(layer.linear1(x)))
        x = _layer_norm(x + h, layer.norm2.weight, layer.norm2.bias, eps)
    return x, cls_row


def encoder_forward_seq_parallel(
        encoder, x: torch.Tensor, cfg: TemporalConfig,
        key_padding_mask: Optional[torch.Tensor], mesh,
        axis_name: str = SEQ_AXIS, shard_batch: bool = True
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence-parallel twin of models.temporal.encoder_forward.

    x: (B, L, D), the same on every rank of the ring; key_padding_mask
    (B, L) bool (True = pad).  L is padded to a multiple of the ring size
    with masked keys; each rank runs its chunk and the outputs are
    gathered.  Returns (output (B, L, D), the last layer's head-averaged
    CLS attention row (B, L)) on every rank.

    shard_batch: on a mesh whose 'data' axis is larger than 1 and divides
    B, each data row of the mesh takes its block of B and the results are
    gathered over 'data' (JAX's batch_axis); a trainer whose batches are
    already sharded passes False.  A B that does not divide stays whole
    on every row."""
    group = seq_group(mesh, axis_name)
    n = mesh_lib.axis_size(mesh, axis_name)
    b, l, d = x.shape
    if key_padding_mask is None:
        key_padding_mask = torch.zeros((b, l), dtype=torch.bool,
                                       device=x.device)
    n_data = mesh_lib.axis_size(mesh, DATA_AXIS)
    data_group = None
    if shard_batch and n_data > 1 and b % n_data == 0:
        data_group = mesh_lib.axis_group(mesh, (DATA_AXIS,))
        rows = mesh_lib.BatchSharding(_dist().get_rank(data_group),
                                      n_data).rows(b)
        x, key_padding_mask = x[rows], key_padding_mask[rows]
    pad = (-l) % n
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        key_padding_mask = F.pad(key_padding_mask, (0, pad), value=True)
    bias = torch.where(key_padding_mask, _NEG_INF, 0.0).float()
    lloc = x.shape[1] // n
    r = _dist().get_rank(group)
    part = slice(r * lloc, (r + 1) * lloc)
    out, cls_row = _encoder_local(encoder, x[:, part], bias[:, part], cfg,
                                  group, n)
    out = mesh_lib.all_gather(out, group, dim=1)
    cls_row = mesh_lib.all_gather(cls_row, group, dim=1)
    if data_group is not None:
        out = mesh_lib.all_gather(out, data_group)
        cls_row = mesh_lib.all_gather(cls_row, data_group)
    return out[:, :l], cls_row[:, :l]


def ring_encoder_fn(mesh, cfg: TemporalConfig, axis_name: str = SEQ_AXIS,
                    shard_batch: bool = True) -> Callable:
    """`temporal_features`'s encoder_fn that runs the ring instead of the
    dense or flash encoder (JAX `_ring_encoder_fn`): the heads and pooling
    stay in full_model, so the sequence-parallel path cannot drift from
    the dense one."""
    return lambda encoder, x, mask: encoder_forward_seq_parallel(
        encoder, x, cfg, mask, mesh, axis_name, shard_batch=shard_batch)


def seq_parallel_temporal_features(model, reps, pad_mask, cfg, mesh,
                                   axis_name: str = SEQ_AXIS):
    """models.full_model.temporal_features with the ring encoder; the
    attention artifact is the CLS row (B*S, F+1)."""
    from sais_tpu_torch.models.full_model import temporal_features
    return temporal_features(model, reps, pad_mask, cfg,
                             encoder_fn=ring_encoder_fn(mesh, cfg.temporal,
                                                        axis_name))


def seq_parallel_prototypes_forward(model, cfg, rgb=None, rgb_mask=None,
                                    flow=None, flow_mask=None,
                                    primary_domain=None, *, mesh,
                                    axis_name: str = SEQ_AXIS):
    """models.full_model.prototypes_forward with the frame encoder
    sequence-sharded; every head's behaviour is inherited."""
    from sais_tpu_torch.models.full_model import prototypes_forward
    return prototypes_forward(model, cfg, rgb, rgb_mask, flow, flow_mask,
                              primary_domain,
                              encoder_fn=ring_encoder_fn(mesh, cfg.temporal,
                                                         axis_name))


def ring_in_one_process(q, k, v, bias, n: int,
                        do: Optional[torch.Tensor] = None):
    """The schedule of an n-rank ring run by one process: the sequence
    (padded with masked keys to a multiple of n) cut into n chunks, every
    rank's `ring_fwd_step` (and, given the cotangent `do`,
    `ring_bwd_step`) called in turn, the chunks handed to rank + 1 in a
    list after each step.  Returns (out, lse) over the whole sequence, and
    (dq, dk, dv) with `do`: what n ranks compute, for holding the ring
    against whole-sequence K2 / K3 on one card."""
    b, h, l, dh = q.shape
    pad = (-l) % n
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        bias = F.pad(bias, (0, pad), value=_NEG_INF)
        if do is not None:
            do = F.pad(do, (0, 0, 0, pad))
    qs, ks, vs = (list(t.chunk(n, 2)) for t in (q, k, v))
    bs = list(bias.chunk(n, 1))
    qs, ks, vs = ([t.contiguous() for t in ts] for ts in (qs, ks, vs))
    bs = [t.contiguous() for t in bs]
    states = [ring_init(qr) for qr in qs]
    chunks = list(zip(ks, vs, bs))
    for _ in range(n):
        states = [ring_fwd_step(qs[r], *chunks[r], states[r])
                  for r in range(n)]
        chunks = [chunks[(r - 1) % n] for r in range(n)]
    outs, lses = zip(*(ring_finish(st) for st in states))
    out, lse = torch.cat(outs, 2)[:, :, :l], torch.cat(lses, 2)[:, :, :l]
    if do is None:
        return out, lse
    dos = [t.contiguous() for t in do.chunk(n, 2)]
    dqs = [torch.zeros_like(t) for t in qs]
    carry = [(kr, vr, br, torch.zeros_like(kr), torch.zeros_like(vr))
             for kr, vr, br in zip(ks, vs, bs)]
    for _ in range(n):
        for r in range(n):
            kc, vc, bc, dkc, dvc = carry[r]
            dqs[r], dkc, dvc = ring_bwd_step(qs[r], kc, vc, bc, outs[r],
                                             lses[r], dos[r], dqs[r], dkc,
                                             dvc)
            carry[r] = (kc, vc, bc, dkc, dvc)
        carry = [carry[(r - 1) % n] for r in range(n)]
    dk = torch.cat([c[3] for c in carry], 2)[:, :, :l]
    dv = torch.cat([c[4] for c in carry], 2)[:, :, :l]
    return out, lse, torch.cat(dqs, 2)[:, :, :l], dk, dv
