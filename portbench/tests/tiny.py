"""The cells at a size a CPU test can hold: the committed configuration,
traffic and cell files with their sizes cut, and limits read off the plain
paths at that size (the port's plain PyTorch versions of its kernels run
on the CPU)."""

from __future__ import annotations

import copy

from portbench import registry

TINY = {
    "extract.vits16.b256": {
        "config": {"vit": {"image_size": 32, "embed_dim": 64, "depth": 2,
                           "num_heads": 2},
                   "preprocess": {"resize": 32}},
        "traffic": {"batch": 8, "frame_size": 32, "pool_frames": 64,
                    "video_frames": [20, 12], "keep_per_video": 20},
        "cell": {"check_frames": 1000, "trace_steps": 2,
                 "limits": {"feat_bias": 1e-3}}},
    "train.temporal.l2000": {
        "config": {"temporal": {"rep_dim": 32, "ffn_dim": 64,
                                "max_positions": 40, "flash_min_len": 16},
                   "model": {"rep_dim": 32, "proj_dim": 16}},
        "traffic": {"batch": 4, "videos": 16, "min_frames": 10,
                    "max_frames": 40, "pad_frames": 40},
        "cell": {"trace_steps": 2,
                 "limits": {"loss_gap": 1e-5, "probs_gap": 1e-5,
                            "grad_gap": 1e-4, "change_gap": 1e-4}}},
    "pretrain.vits8.b64": {
        "config": {"vit": {"image_size": 32, "embed_dim": 64, "depth": 2,
                           "num_heads": 2},
                   "dino": {"out_dim": 256, "global_size": 32,
                            "local_size": 16, "n_local_crops": 2,
                            "niter_per_ep": 10, "epochs": 4,
                            "warmup_epochs": 1, "start_epoch": 2}},
        "traffic": {"batch": 4, "pool_frames": 6, "frame_height": 48,
                    "frame_width": 64},
        "cell": {"trace_steps": 2, "ref_chunk": 3,
                 "limits": {"loss_gap": 5e-3, "grad_gap": 5e-2,
                            "grad_dist": 0.1, "change_gap": 5e-2,
                            "teacher_change_gap": 5e-2,
                            "center_gap": 5e-2}}},
}


def _merge(dst, src):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


def spec(workload: str, chips: int = 1) -> dict:
    """The cell at its tiny size; with `chips` > 1 on that many ranks, each
    with the one-card batch."""
    s = copy.deepcopy(registry.cell_spec(workload))
    _merge(s, TINY[workload])
    s["workload"]["chips"] = chips
    s["traffic"]["batch"] *= chips
    return s
