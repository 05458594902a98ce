"""K7 `fused_loss_and_grads`: DINO's weight-normed last layer and loss,
forward and backward, without the (rows, out_dim) logits in memory."""

TARGETS = ["sais_tpu_torch.kernels.dino_head_loss:fused_loss_and_grads"]
PEAK = "bf16_flops"


def _bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def capture(hs, ht, vs, vt, gs, gt, center, *rest, **kw):
    rs, db = hs.shape
    k = vs.shape[1]
    # outputs: loss, the batch center (k), dh_s (rs, db), dv (db, k) and
    # dg (k), all f32
    out = 4 * (1 + k + rs * db + db * k + k)
    return rs, ht.shape[0], db, k, _bytes(hs, ht, vs, vt, gs, gt, center) + out


def work(cap):
    """2 db K (3 rs + rt): the student's logits, its two gradients' products
    and the teacher's logits; inputs read and outputs written once."""
    rs, rt, db, k, nbytes = cap
    return 2 * db * k * (3 * rs + rt), nbytes
