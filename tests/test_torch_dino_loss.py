"""K7 in the port against the JAX package: the plain version of the fused
DINO last layer + loss against the Pallas kernel in interpret mode, the
autograd Function against autograd of the plain head + `dino_loss`, the
pair structure, the refusals, and DINOTrainer(fused_loss=True) steps
against the JAX trainer from the same weights.

Shapes are the JAX package's own test shapes (B 4, 2 + 3 crops,
bottleneck 128, out_dim 512), inputs from numpy seeds.  Limits: the loss
1e-5 relative, the gradients rtol 2e-2 / atol 5e-5 (the limits of
tests/test_dino_fused_loss.py: dl is rounded to bf16, and a rounding that
lands on the other side of a bf16 tie moves one element by an ulp).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sais_tpu.kernels import dino_head_loss as jloss
from sais_tpu.train import dino as jdino
from sais_tpu_torch.config import ViTConfig
from sais_tpu_torch.kernels import dino_head_loss as tloss
from sais_tpu_torch.models.dino_head import dino_head_forward
from sais_tpu_torch.port.weights import dino_state_from_jax
from sais_tpu_torch.train import dino as tdino

B, NG, NL = 4, 2, 3
DB, K = 128, 512
RS, RT = (NG + NL) * B, NG * B
TEMP_T, TEMP_S = 0.07, 0.1
INV_NORM = 1.0 / (B * NG * (NG + NL - 1))


def _inputs(seed):
    """hs, ht (unit rows, bf16-exact), vs, vt, gs, gt, center as f32
    numpy arrays."""
    rng = np.random.default_rng(seed)

    def unit_rows(n):
        h = rng.standard_normal((n, DB)).astype(np.float32)
        h /= np.linalg.norm(h, axis=-1, keepdims=True)
        return np.asarray(torch.from_numpy(h).bfloat16().float())

    return (unit_rows(RS), unit_rows(RT),
            rng.standard_normal((DB, K)).astype(np.float32),
            rng.standard_normal((DB, K)).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32),
            (0.01 * rng.standard_normal(K)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("norm_last", [True, False])
def test_plain_version_matches_pallas_kernel(norm_last):
    hs, ht, vs, vt, gs, gt, center = _inputs(0)
    sel, c = jloss.build_pair_structure(B, NG, NL)
    ref = jloss._fused_loss_and_grads(
        jnp.asarray(hs, jnp.bfloat16), jnp.asarray(ht, jnp.bfloat16),
        jnp.asarray(vs), jnp.asarray(vt), jnp.asarray(gs), jnp.asarray(gt),
        jnp.asarray(center), jnp.float32(TEMP_T), jnp.asarray(sel),
        jnp.asarray(c), student_temp=TEMP_S, inv_norm=INV_NORM,
        use_g=not norm_last, interpret=True)
    got = tloss.fused_loss_and_grads(
        _t(hs), _t(ht), _t(vs), _t(vt), _t(gs), _t(gt), _t(center), TEMP_T,
        _t(sel), _t(c), student_temp=TEMP_S, inv_norm=INV_NORM,
        use_g=not norm_last)
    assert tloss.fused_loss_and_grads.launches == 0   # CPU: plain version
    np.testing.assert_allclose(_np(got[0]), _np(ref[0]), rtol=1e-5)
    # the center within 1e-4 of its largest value: the column norms are
    # summed in another order (float64 here), so one bf16 rounding of w may
    # land on the other side of a tie and move a column by 2**-8 of one term
    bc, ref_bc = _np(got[1]), _np(ref[1])
    assert np.abs(bc - ref_bc).max() <= 1e-4 * np.abs(ref_bc).max()
    for name, a, r in zip(("dhs", "dvs", "dgs"), got[2:], ref[2:]):
        assert a.shape == r.shape, name
        np.testing.assert_allclose(_np(a), _np(r), rtol=2e-2, atol=5e-5,
                                   err_msg=name)
    if norm_last:
        assert not got[4].any()


@pytest.mark.parametrize("norm_last", [True, False])
def test_function_matches_autograd_of_plain_head_and_loss(norm_last):
    """Against `plain_head_loss` (the trainer's fused_loss=False path):
    loss and center 1e-5; the gradients of hs, vs and gs within the bf16
    limits above; the teacher inputs get no gradient."""
    arrs = _inputs(1)
    sel, c = map(_t, jloss.build_pair_structure(B, NG, NL))
    op = tloss.make_fused_dino_loss(TEMP_S, B, NG, NG + NL,
                                    norm_last_layer=norm_last)

    def run(fn):
        hs, ht, vs, vt, gs, gt, center = (_t(a).requires_grad_()
                                          for a in arrs)
        loss, bc = fn(hs, vs, gs, ht, vt, gt, center)
        loss.backward()
        return loss, bc, (hs, vs, gs, ht, vt, gt)

    loss_f, bc_f, leaves_f = run(
        lambda hs, vs, gs, ht, vt, gt, center: op(
            hs, vs, gs, ht, vt, gt, center, TEMP_T, sel, c))
    loss_r, bc_r, leaves_r = run(
        lambda *a: tdino.plain_head_loss(
            *a, TEMP_T, n_global=NG, n_local=NL, student_temp=TEMP_S,
            norm_last_layer=norm_last))
    np.testing.assert_allclose(_np(loss_f), _np(loss_r), rtol=1e-5)
    np.testing.assert_allclose(_np(bc_f), _np(bc_r), rtol=1e-5, atol=1e-6)
    assert not bc_f.requires_grad
    # under norm_last_layer the plain composition never reads gs
    n_grads = 2 if norm_last else 3
    for name, a, r in zip(("hs", "vs", "gs"), leaves_f[:n_grads],
                          leaves_r[:n_grads]):
        np.testing.assert_allclose(_np(a.grad), _np(r.grad), rtol=2e-2,
                                   atol=5e-5, err_msg=name)
    if norm_last:
        assert not leaves_f[2].grad.any() and leaves_r[2].grad is None
    for leaf in leaves_f[3:]:
        assert leaf.grad is None


def test_pair_structure_equals_jax():
    for args in ((4, 2, 3), (3, 2, 8), (5, 2, 0), (2, 3, 2)):
        sel, c = tloss.build_pair_structure(*args)
        jsel, jc = jloss.build_pair_structure(*args)
        np.testing.assert_array_equal(sel, jsel)
        np.testing.assert_array_equal(c, jc)


def test_out_dim_refusal():
    arrs = [_t(a) for a in _inputs(2)]
    sel, c = map(_t, jloss.build_pair_structure(B, NG, NL))
    with pytest.raises(ValueError, match="multiple of 128"):
        tloss.fused_loss_and_grads(
            arrs[0], arrs[1], arrs[2][:, :200], arrs[3][:, :200],
            arrs[4][:200], arrs[5][:200], arrs[6][:200], TEMP_T, sel, c,
            student_temp=TEMP_S, inv_norm=INV_NORM, use_g=False)


TINY = dict(image_size=32, patch_size=16, embed_dim=64, depth=2,
            num_heads=2)


def _cfgs(**kw):
    base = dict(out_dim=128, batch_size=4, n_local_crops=2, global_size=32,
                local_size=16, epochs=1, warmup_epochs=0,
                freeze_last_layer_epochs=0, drop_path_rate=0.0,
                weight_decay=0.04, weight_decay_end=0.1)
    base.update(kw)
    return jdino.DINOConfig(**base), tdino.DINOConfig(**base)


def _crops(seed, b=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2 * b, 32, 32, 3)).astype(np.float32),
            rng.standard_normal((2 * b, 16, 16, 3)).astype(np.float32))


@pytest.mark.parametrize("optimizer,lr", [("sgd", 0.0025), ("adamw", 1e-4)])
def test_fused_loss_trainer_steps_match_jax(optimizer, lr):
    """Two DINOTrainer(fused_loss=True) steps on the CPU (plain backbone,
    plain K7) against JAX's DINOTrainer(fused_loss=True) from the same
    weights and crops, within test_trainer_steps_match_jax's limits: 2e-3
    relative on the losses, 1e-3 of the largest value on the center and on
    sgd-updated parameters, 2 lr a step on adamw-updated ones.  The sgd lr
    is half that test's: the two sides' gradients differ by about 1% (XLA
    and PyTorch round bf16 at other places, and K7 rounds dl), so the
    updates stay near 0.5% of the weights."""
    from sais_tpu.config import ViTConfig as JViTConfig
    jcfg, tcfg = _cfgs(lr=lr * 256 / 4)
    jt = jdino.DINOTrainer(JViTConfig(**TINY), jcfg, 2, jax.random.key(0),
                           optimizer=optimizer, fused_blocks=False,
                           fused_loss=True)
    assert jt.fused_loss
    jt.student = jax.tree.map(
        lambda a: a + 0.02 * jax.random.normal(jax.random.key(a.size),
                                               a.shape), jt.student)
    jt.teacher = jax.tree.map(jnp.copy, jt.student)
    state = jax.tree.map(np.asarray, jt.state())
    state["center"] = np.random.default_rng(9).standard_normal(
        128).astype(np.float32) * 0.1
    jt.center = jnp.asarray(state["center"])
    tt = tdino.DINOTrainer(ViTConfig(**TINY), tcfg, 2,
                           torch.Generator().manual_seed(0),
                           optimizer=optimizer, device="cpu",
                           fused_blocks=False, fused_loss=True)
    assert tt.fused_loss
    sd = dino_state_from_jax(state)
    tt.student.load_state_dict(sd["student"])
    tt.teacher.load_state_dict(sd["teacher"])
    tt.center = sd["center"]
    lrs = []
    for step in range(2):
        g, l = _crops(step)
        lrs.append(float(jt.lr_sched[step]))
        ref = jt.step(jnp.asarray(g), jnp.asarray(l))
        got = tt.step(_t(g), _t(l))
        assert abs(got - ref) <= 2e-3 * abs(ref), (step, got, ref)
    ref_c = _np(jt.center)
    assert np.abs(_np(tt.center) - ref_c).max() <= 1e-3 * np.abs(ref_c).max()
    ref_sd = dino_state_from_jax(jax.tree.map(np.asarray, jt.state()))
    tol = 2 * 1.0013 * sum(lrs)
    for n, p in tt.student.named_parameters():
        r = ref_sd["student"][n].numpy()
        err = np.abs(p.detach().numpy() - r).max()
        limit = (1e-3 * np.abs(r).max() if optimizer == "sgd" else tol)
        assert err <= limit, (n, err, limit)


def test_fused_loss_trainer_refusals_and_auto_rule():
    _, tcfg = _cfgs()
    kw = dict(generator=torch.Generator(), device="cpu", fused_blocks=False)
    with pytest.raises(ValueError, match="use_bn_in_head"):
        tdino.DINOTrainer(ViTConfig(**TINY),
                          tdino.DINOConfig(use_bn_in_head=True), 2,
                          fused_loss=True, **kw)
    tr = tdino.DINOTrainer(ViTConfig(**TINY), tcfg, 2, fused_loss=True, **kw)
    g, l = _crops(0, b=2)
    with pytest.raises(ValueError, match="fused DINO loss"):
        tr.step(_t(g), _t(l))
    # the auto rule takes K7 on the card only
    assert not tdino.DINOTrainer(ViTConfig(**TINY), tcfg, 2, **kw).fused_loss
    assert tdino.fused_loss_auto(tcfg, torch.device("cuda"))
    assert not tdino.fused_loss_auto(tcfg, torch.device("cpu"))
    assert not tdino.fused_loss_auto(
        tdino.DINOConfig(out_dim=200), torch.device("cuda"))
    assert not tdino.fused_loss_auto(
        tdino.DINOConfig(use_bn_in_head=True), torch.device("cuda"))


def test_fused_loss_trainer_at_cli_batch():
    """DINOTrainer(fused_loss=True) on the CPU at the CLI's default batch,
    256 (2 + 2 crops: 512 teacher rows, two windows of the kernel's
    teacher probabilities), against fused_loss=False from the same weights
    and crops: the loss within 1e-5 relative and each student gradient
    within 2e-2 of its largest value (dl is rounded to bf16 on the fused
    path only)."""
    _, tcfg = _cfgs(batch_size=256)
    tr = tdino.DINOTrainer(ViTConfig(**TINY), tcfg, 2,
                           torch.Generator().manual_seed(0), device="cpu",
                           fused_blocks=False, fused_loss=True)
    g, l = (_t(a) for a in _crops(5, b=256))

    def run(fused):
        tr.fused_loss = fused
        loss, _ = tr.loss_and_grads(g, l, TEMP_T, None)
        return loss.item(), {n: p.grad.clone()
                             for n, p in tr.student.named_parameters()
                             if p.grad is not None}

    (loss_f, grads_f), (loss_p, grads_p) = run(True), run(False)
    assert abs(loss_f - loss_p) <= 1e-5 * abs(loss_p)
    # under norm_last_layer the plain path never reads head.last_g; the
    # fused path gives it a zero gradient
    assert grads_p.keys() <= grads_f.keys()
    for n, a in grads_f.items():
        r = grads_p.get(n, torch.zeros_like(a))
        err = (a - r).abs().max().item()
        assert err <= 2e-2 * r.abs().max().item() + 1e-12, (n, err)


def test_fused_head_matches_plain_head_forward():
    """The fused path's bottleneck + last layer equals dino_head_forward's
    logits on the same rows: the loss through K7's plain version and the
    loss of those logits agree within 1e-5, and so does the center."""
    from sais_tpu_torch.models.dino_head import (dino_head_bottleneck,
                                                 dino_head_init)
    head = dino_head_init(torch.Generator().manual_seed(3), 48, 256,
                          hidden=64, bottleneck=128)
    rng = np.random.default_rng(4)
    feats = _t(rng.standard_normal((RS, 48))).bfloat16()
    tfeats = _t(rng.standard_normal((RT, 48))).bfloat16()
    center = _t(0.01 * rng.standard_normal(256))
    sel, c = map(_t, tloss.build_pair_structure(B, NG, NL))
    with torch.no_grad():
        loss, bc = tloss.make_fused_dino_loss(TEMP_S, B, NG, NG + NL)(
            dino_head_bottleneck(head, feats), head.last_v, head.last_g,
            dino_head_bottleneck(head, tfeats), head.last_v, head.last_g,
            center, TEMP_T, sel, c)
        s_out = dino_head_forward(head, feats)
        t_out = dino_head_forward(head, tfeats)

        def regroup(o, n):
            return list(o.reshape(o.shape[0] // n, n, -1).transpose(0, 1))

        ref, ref_bc = tdino.dino_loss(
            regroup(s_out[:NG * B], NG) + regroup(s_out[NG * B:], NL),
            regroup(t_out, NG), center, TEMP_T, TEMP_S)
    np.testing.assert_allclose(_np(loss), _np(ref), rtol=1e-5)
    # both normalize the columns with `normed_w`; the center's sums run in
    # another order (crop-major after the regroup)
    assert np.abs(_np(bc) - _np(ref_bc)).max() <= 1e-5 * np.abs(
        _np(ref_bc)).max()


# ---------------------------------------------------------------------------
# K7's card decomposition (csrc/dino_head_loss.cu on the wgmma GEMM of
# csrc/gemm_sm90.cuh) emulated in PyTorch and held against the Pallas kernel.
# ---------------------------------------------------------------------------

TILE = 192   # out_dim columns of a GEMM tile


def _card_splits(rows, cols, k):
    """dh_s's split of K = out_dim (gemm_sm90.cuh, wgrad_splits): about 132
    blocks over the (rows / 128) x (cols / 192) output tiles, whole 64-wide
    k tiles a split.  Returns the splits' column bounds."""
    tiles = -(-rows // 128) * -(-cols // 192)
    ktiles = -(-k // 64)
    want = max(1, min(132 // tiles, ktiles))
    per = -(-ktiles // want) * 64
    return [(a, min(a + per, k)) for a in range(0, k, per)]


def _row_stats(x):
    """Per 192-column tile, each row's (max, sum exp(x - max)); merged in
    tile order: lse = m + log(max(sum_i l_i exp(m_i - m), 1e-30))."""
    tiles = [x[:, a:a + TILE] for a in range(0, x.shape[1], TILE)]
    m = torch.stack([t.amax(1) for t in tiles], 1)
    l_ = torch.stack([torch.exp(t - t.amax(1, keepdim=True)).sum(1)
                      for t in tiles], 1)
    top = m.amax(1, keepdim=True)
    return top + torch.log(torch.clamp(
        (l_ * torch.exp(m - top)).sum(1, keepdim=True), min=1e-30))


def k7_in_card_order(hs, ht, vs, vt, gs, gt, center, temp_t, sel, c, *,
                     student_temp, inv_norm, use_g):
    """Steps 3-11 of dino_head_loss.cu in f32: tile statistics merged in
    tile order, q = exp(ts - lse_t), the center from 64-row halves' column
    sums, qbar over each row's pairs in ascending teacher order, the loss
    from (64-row half, tile) partials, dl stored in bf16, dw = hs^T dl then
    dv and dg over 8 row parts in order, dh_s as split partials summed in
    split order."""
    inv_ts, inv_tt = 1.0 / student_temp, 1.0 / temp_t
    hs, ht = hs.bfloat16().float(), ht.bfloat16().float()
    ws, us, ns = tloss.normed_w(vs, gs, use_g)
    wsb = ws.bfloat16().float()
    wtb = tloss.normed_w(vt, gt, use_g)[0].bfloat16().float()
    rs, rt = hs.shape[0], ht.shape[0]
    tl = ht @ wtb
    ts = (tl - center.reshape(1, -1)) * inv_tt
    q = torch.exp(ts - _row_stats(ts))
    halves = [tl[a:a + 64].sum(0) for a in range(0, rt, 64)]
    center_b = torch.stack(halves).sum(0) / rt
    s = (hs @ wsb) * inv_ts
    lse_s = _row_stats(s)
    qbar = torch.zeros_like(s)
    for r in range(rs):
        for t in torch.nonzero(sel[r])[:, 0].tolist():   # ascending
            qbar[r] += sel[r, t] * q[t]
    term = -qbar * s
    loss_parts = [term[a:a + 64, b:b + TILE].sum() for a in range(0, rs, 64)
                  for b in range(0, s.shape[1], TILE)]
    loss = (torch.stack(loss_parts).sum()
            + (c.reshape(-1, 1) * lse_s).sum()) * inv_norm
    p = torch.exp(s - lse_s)
    dl = ((c.reshape(-1, 1) * p - qbar) * (inv_ts * inv_norm)).bfloat16()
    dl = dl.float()
    dw = hs.t() @ dl
    du = dw * gs.reshape(1, -1) if use_g else dw
    parts = du.shape[0] // 8
    sud = sum((us * du)[i * parts:(i + 1) * parts].sum(0) for i in range(8))
    dgs = (sum((us * dw)[i * parts:(i + 1) * parts].sum(0) for i in range(8))
           if use_g else torch.zeros_like(sud))
    dvs = (du - us * sud) / ns
    dhs = sum(dl[:, a:b] @ wsb[:, a:b].t()
              for a, b in _card_splits(rs, hs.shape[1], s.shape[1]))
    return loss, center_b, dhs, dvs, dgs


@pytest.mark.parametrize("norm_last", [True, False])
@pytest.mark.parametrize("k", [K, 640])
def test_card_decomposition_matches_pallas_kernel(norm_last, k):
    """K7's card decomposition against _fused_loss_and_grads(interpret=True)
    at the card's limits (loss and center 1e-4 relative; dhs, dvs, dgs
    1e-2 of the largest value; dgs exactly 0 under norm_last_layer), at
    out_dims that leave a ragged last tile of 128 and 64 columns."""
    hs, ht, vs, vt, gs, gt, center = _inputs(5)
    if k != K:
        rng = np.random.default_rng(6)
        vs, vt = (rng.standard_normal((DB, k)).astype(np.float32)
                  for _ in range(2))
        gs, gt = ((1.0 + 0.1 * rng.standard_normal(k)).astype(np.float32)
                  for _ in range(2))
        center = (0.01 * rng.standard_normal(k)).astype(np.float32)
    sel, c = jloss.build_pair_structure(B, NG, NL)
    ref = jloss._fused_loss_and_grads(
        jnp.asarray(hs, jnp.bfloat16), jnp.asarray(ht, jnp.bfloat16),
        jnp.asarray(vs), jnp.asarray(vt), jnp.asarray(gs), jnp.asarray(gt),
        jnp.asarray(center), jnp.float32(TEMP_T), jnp.asarray(sel),
        jnp.asarray(c), student_temp=TEMP_S, inv_norm=INV_NORM,
        use_g=not norm_last, interpret=True)
    got = k7_in_card_order(
        _t(hs), _t(ht), _t(vs), _t(vt), _t(gs), _t(gt), _t(center), TEMP_T,
        _t(sel), _t(c), student_temp=TEMP_S, inv_norm=INV_NORM,
        use_g=not norm_last)
    for name, a, r in zip(("loss", "center", "dhs", "dvs", "dgs"), got, ref):
        a, r = _np(a), _np(r)
        assert a.shape == r.shape, name
        rel = 1e-4 if name in ("loss", "center") else 1e-2
        assert np.abs(a - r).max() <= rel * np.abs(r).max(), name
    if norm_last:
        assert not got[4].any()
