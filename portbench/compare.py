"""The numbers that decide `correct`, worked out from the program's
outputs and the reference's."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Set

import torch

Leaves = Dict[str, torch.Tensor]


QKV = ("qkv.weight", "qkv.bias", "in_proj_weight", "in_proj_bias")


def split_qkv(leaves: Leaves) -> Leaves:
    """Joint q, k, v projections as three leaves each: the key's bias has
    no gradient under softmax (its effect cancels), so as a part of one
    leaf it would carry that leaf's rounding noise into the comparison."""
    out = {}
    for n, t in leaves.items():
        if n.endswith(QKV):
            for part, piece in zip("qkv", t.chunk(3, dim=0)):
                out[f"{n}.{part}"] = piece
        else:
            out[n] = t
    return out


def norms(leaves: Leaves) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in leaves.items()}


def quiet_leaves(ref_grads: Leaves) -> Set[str]:
    """Leaves whose reference gradient is under a thousandth of the median
    leaf's: they move by round-off alone (a key bias under softmax, a
    parameter the loss does not reach)."""
    n = norms(split_qkv(ref_grads))
    med = statistics.median(n.values())
    return {k for k, v in n.items() if v < 1e-3 * med}


def norm_gap(prog: Leaves, ref: Leaves, skip: Iterable[str] = ()) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    skip = set(skip)
    prog = split_qkv(prog)
    rn = {k: v for k, v in norms(split_qkv(ref)).items() if k not in skip}
    med = statistics.median(rn.values())
    worst = 0.0
    for k, r in rn.items():
        p = float(prog[k].double().norm())
        worst = max(worst, abs(p - r) / max(r, med))
    return worst


def dist_gap(prog: Leaves, ref: Leaves, skip: Iterable[str] = ()) -> float:
    """The worst leaf's distance ||p - r|| over the reference's norm of
    that leaf or of the median leaf, whichever is larger: unlike a gap of
    norms, it sees a gradient that points elsewhere.  Only for outputs of
    the same step from the same state, which differ by rounding alone."""
    skip = set(skip)
    prog = split_qkv(prog)
    ref = {k: v for k, v in split_qkv(ref).items() if k not in skip}
    rn = norms(ref)
    med = statistics.median(rn.values())
    return max(float((prog[k].double() - r.double()).norm()) / max(rn[k], med)
               for k, r in ref.items())


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def feature_bias(x: torch.Tensor, ref: torch.Tensor) -> float:
    """|mean over the rows of (x - ref) . ref / ||ref||^2|: the rows' error
    along the reference, signed, averaged over the rows."""
    x, ref = x.double(), ref.double()
    return float((((x - ref) * ref).sum(-1) / (ref * ref).sum(-1)).mean()
                 .abs())
