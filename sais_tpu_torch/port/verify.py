"""Checkpoint verification: a real reference checkpoint loads and
reproduces fixed probe outputs (`port --verify`; counterpart of
`sais_tpu/port/verify.py`).

The reference loads three pretrained artifacts
(extract_representations.py:181-203, 267; prepare_model.py:521-530): the
DINO ViT-S/16 backbone `dino_deitsmall16_pretrain.pth`, a ptlflow RAFT
'things' checkpoint, and each fold's SAIS `params.zip` + `prototypes.zip`.

1. `port --record CKPT --kind vit|raft|full` runs a deterministic probe
   through the port's model (float32, on `device`) and writes the outputs,
   the file's SHA-256 and its name to a golden digest `<kind>.npz` (the
   port's own `port/golden/` unless --golden-dir says otherwise).
2. `port --verify CKPT --kind ...` checks the file's SHA-256 against the
   digest first (a wrong or corrupted download fails before any numerics
   run), then each probe output within ATOL.

The probe inputs come from the JAX package's numpy seeds and the digests
have the same names and layout, so a digest either package recorded
verifies in the other.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sais_tpu_torch import DeviceLike, resolve_device

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")

# Where the reference checkpoints are published (provenance only: the
# hashes are pinned by --record on the machine that first verifies one)
CHECKPOINT_URLS = {
    "vit": ("https://dl.fbaipublicfiles.com/dino/"
            "dino_deitsmall16_pretrain/dino_deitsmall16_pretrain.pth"),
    "raft": "ptlflow model zoo: model='raft', ckpt='things'",
    "full": "SAIS training output params.zip (per fold)",
}

ATOL = 1e-3  # end-to-end port tolerance of a float32 probe


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _probe_rng() -> np.random.Generator:
    return np.random.default_rng(20260819)


def probe_images(n: int = 2, size: int = 224) -> np.ndarray:
    """The ViT's probe batch: ImageNet-normalized (n, size, size, 3)."""
    r = _probe_rng()
    u8 = (r.uniform(size=(n, size, size, 3)) * 255).astype(np.uint8)
    x = u8.astype(np.float32) / 255.0
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    return (x - mean) / std


def probe_frame_pair(h: int = 224, w: int = 224
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """RAFT's probe pair, uint8: a 5x5 box-blurred noise image and the same
    image shifted by (dy, dx) = (4, 2)."""
    from numpy.lib.stride_tricks import sliding_window_view
    r = _probe_rng()
    base = r.uniform(0, 255, size=(1, h + 8, w + 8, 3))
    sm = sliding_window_view(base[0], (5, 5), axis=(0, 1)).mean(axis=(-2, -1))
    img1 = sm[:h, :w]
    img2 = sm[4:4 + h, 2:2 + w]
    return img1[None].astype(np.uint8), img2[None].astype(np.uint8)


def probe_window(dim: int = 384, frames: int = 15) -> Dict[str, np.ndarray]:
    """The temporal model's probe: one batch of 2 windows of frame reps."""
    r = _probe_rng()
    return {"rgb": r.normal(size=(2, 1, frames, dim)).astype(np.float32),
            "rgb_mask": np.zeros((2, 1, frames + 1), bool)}


# per-kind probes: checkpoint path -> {output name: float32 array}

def _run_vit(path: str, device: torch.device) -> Dict[str, np.ndarray]:
    from sais_tpu_torch.config import ViTConfig
    from sais_tpu_torch.models.vit import VisionTransformer, vit_features
    from sais_tpu_torch.port.weights import load_dino_weights
    model = VisionTransformer(ViTConfig())
    model.load_state_dict(load_dino_weights(path))
    with torch.inference_mode():
        feats = vit_features(model.to(device), torch.from_numpy(
            probe_images()).to(device))
    return {"features": feats.cpu().numpy().astype(np.float32)}


def _run_raft(path: str, device: torch.device) -> Dict[str, np.ndarray]:
    from sais_tpu_torch.config import RAFTConfig
    from sais_tpu_torch.models.raft import RAFT, raft_forward
    from sais_tpu_torch.port.weights import (load_checkpoint,
                                             raft_state_from_reference)
    model = RAFT(RAFTConfig())
    model.load_state_dict(raft_state_from_reference(load_checkpoint(path)))
    img1, img2 = (torch.from_numpy(x).to(device) for x in probe_frame_pair())
    with torch.inference_mode():
        flow = raft_forward(model.to(device).eval(), img1, img2, iters=12)
    return {"flow": flow.cpu().numpy().astype(np.float32)}


def _run_full(path: str, device: torch.device) -> Dict[str, np.ndarray]:
    """A SAIS fullModel params.zip; a prototypes.zip beside it adds the
    prototype probabilities."""
    from sais_tpu_torch.config import ModelConfig
    from sais_tpu_torch.models.full_model import prototypes_forward
    from sais_tpu_torch.models.heads import prototype_probs
    from sais_tpu_torch.port.weights import (full_model_from_state,
                                             full_model_params_from_reference,
                                             load_checkpoint,
                                             prototypes_from_reference)
    sd = full_model_params_from_reference(load_checkpoint(path))
    cfg = ModelConfig(modalities="RGB",
                      importance_head="importance.weight" in sd)
    model = full_model_from_state(sd, cfg, path).to(device).eval()
    batch = probe_window()
    with torch.inference_mode():
        out = prototypes_forward(
            model, cfg, torch.from_numpy(batch["rgb"]).to(device),
            torch.from_numpy(batch["rgb_mask"]).to(device))
        res = {"video_rep": out.video_rep.cpu().numpy().astype(np.float32)}
        proto_path = os.path.join(os.path.dirname(path), "prototypes.zip")
        if os.path.exists(proto_path):
            _, protos = prototypes_from_reference(load_checkpoint(proto_path))
            res["probs"] = prototype_probs(
                out.video_rep, protos.to(device)).cpu().numpy().astype(
                    np.float32)
    return res


_RUNNERS = {"vit": _run_vit, "raft": _run_raft, "full": _run_full}


def discover_checkpoints(root: str) -> Dict[str, str]:
    """Checkpoint kinds -> files under `root`, by their published names
    (`port --record-all`): vit = a *.pth with 'dino' in its name, raft =
    *raft*.{ckpt,pth,pt}, full = params.zip (at root or under Fold_*/)."""
    found: Dict[str, str] = {}
    for dirpath, _dirs, files in sorted(os.walk(root)):
        for f in sorted(files):
            p = os.path.join(dirpath, f)
            low = f.lower()
            if "vit" not in found and low.endswith(".pth") and "dino" in low:
                found["vit"] = p
            elif ("raft" not in found and "raft" in low
                    and low.endswith((".ckpt", ".pth", ".pt"))):
                found["raft"] = p
            elif "full" not in found and low == "params.zip":
                found["full"] = p
    return found


def golden_path(kind: str, golden_dir: Optional[str] = None) -> str:
    return os.path.join(golden_dir or GOLDEN_DIR, f"{kind}.npz")


def _probe(path: str, kind: str, device: DeviceLike):
    if kind not in _RUNNERS:
        raise ValueError(f"unknown kind {kind!r}; use one of {list(_RUNNERS)}")
    return _RUNNERS[kind](path, resolve_device(device))


def record(path: str, kind: str, golden_dir: Optional[str] = None,
           device: DeviceLike = None) -> str:
    """Run the probe and write the golden digest; returns its path."""
    outputs = _probe(path, kind, device)
    dest = golden_path(kind, golden_dir)
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    np.savez_compressed(
        dest, __sha256__=np.array(file_sha256(path)),
        __source__=np.array(os.path.basename(path)), **outputs)
    return dest


def verify(path: str, kind: str, golden_dir: Optional[str] = None,
           atol: float = ATOL, device: DeviceLike = None) -> Dict[str, float]:
    """Probe the checkpoint and check it against its recorded digest.

    Returns {output name: max |error|}.  Raises FileNotFoundError when no
    digest has been recorded, ValueError on a SHA-256 mismatch (a wrong
    or corrupted file: no numerics run) and AssertionError past `atol`."""
    if kind not in _RUNNERS:
        raise ValueError(f"unknown kind {kind!r}; use one of {list(_RUNNERS)}")
    gpath = golden_path(kind, golden_dir)
    if not os.path.exists(gpath):
        raise FileNotFoundError(
            f"no golden digest at {gpath}; run `port --record {path} "
            f"--kind {kind}` on a machine with the verified checkpoint "
            f"first ({CHECKPOINT_URLS[kind]})")
    golden = np.load(gpath, allow_pickle=False)
    want_sha = str(golden["__sha256__"])
    got_sha = file_sha256(path)
    if got_sha != want_sha:
        raise ValueError(
            f"checkpoint SHA256 mismatch: golden was recorded from "
            f"{golden['__source__']} ({want_sha[:16]}…), this file is "
            f"{got_sha[:16]}… — wrong or corrupted download")
    outputs = _probe(path, kind, device)
    errs: Dict[str, float] = {}
    for name in outputs:
        err = float(np.max(np.abs(outputs[name] - golden[name])))
        errs[name] = err
        if not err <= atol:
            raise AssertionError(
                f"port drift on {kind}/{name}: max|Δ|={err:.3e} > {atol}")
    return errs
