"""Long-lived decode service (counterpart of `sais_tpu/cli/serve.py`).

Keeps the weights resident on the card, and warms every kernel, cuBLAS
handle and cuDNN choice once, so that a request pays only its compute.
Protocol: JSON lines over a Unix domain socket --

  request:  {"video": "<name>"}            # <root>/videos/<name>.mp4
            {"video": "...", "flow": true} # RGB and flow streams
            {"cmd": "ping"} | {"cmd": "stats"} | {"cmd": "shutdown"}
  response: {"ok": true, "csv": ..., "intervals": N, "frames": F,
             "seconds": t}
            {"ok": false, "error": "..."}

Each request writes <root>/results/<name>_gestures.csv.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from sais_tpu_torch import DeviceLike


class DecodeService:
    """The models of one deployment, resident on `device` (the card unless
    the caller passes "cpu"): the feature extractor, the flow extractor
    when RAFT weights are given, and the fold ensemble's decoder."""

    def __init__(self, root: str, cfg, vit, folds, raft=None,
                 batch_size: int = 256, exact_preprocess: bool = False,
                 pair_batch: Optional[int] = None,
                 flow_iters: Optional[int] = None,
                 device: DeviceLike = None, mesh=None):
        """mesh (`serve --data-parallel`): the extractors split each batch
        over the mesh's ranks; rank 0 runs the daemon (`lead`) and sends
        each other rank its block of every batch, on which that rank, in
        `follow`, makes the same call."""
        from sais_tpu_torch.infer.pipeline import (FeatureExtractor,
                                                   FlowExtractor,
                                                   GestureDecoder)
        self.root = root
        self.cfg = cfg
        self.extractor = FeatureExtractor(vit, cfg, batch_size=batch_size,
                                          device=device,
                                          exact_preprocess=exact_preprocess,
                                          mesh=mesh)
        self.flow = (FlowExtractor(raft, vit, cfg, pair_batch=pair_batch,
                                   iters=flow_iters, device=device,
                                   mesh=mesh)
                     if raft is not None else None)
        self.decoder = GestureDecoder(folds, cfg, device_batch=512,
                                      device=device)
        # what a sharded call runs on: the owner (the extractor, or the
        # flow extractor) and the FeatureExtractor that shards for it
        self._owners = [(self.extractor, self.extractor)]
        if self.flow is not None:
            self._owners.append((self.flow, self.flow._features))

    # -- serve --data-parallel ----------------------------------------------

    def lead(self) -> None:
        """On rank 0: every sharded call first sends each other rank its
        block (`_scatter`)."""
        for _, sharder in self._owners:
            sharder.scatter = self._scatter

    def _scatter(self, owner, method: str, blocks, rows: int) -> None:
        import torch.distributed as dist
        from sais_tpu_torch.parallel.mesh import broadcast_object
        which = [o for o, _ in self._owners].index(owner)
        sharder = self._owners[which][1]
        broadcast_object((which, method, rows, [(tuple(x.shape), x.dtype)
                                                for x in blocks[0]]))
        ranks = sharder.mesh.mesh.reshape(-1).tolist()
        for rank, block in zip(ranks[1:], blocks[1:]):
            for x in block:   # one rank's block on this card at a time
                dist.send(sharder._to_device(x).contiguous(), rank)

    def follow(self) -> None:
        """On the other ranks: receive this rank's block of each call rank
        0 makes, and make it, until rank 0 sends None (`release`)."""
        import torch.distributed as dist
        from sais_tpu_torch.parallel.mesh import broadcast_object
        while (msg := broadcast_object(None)) is not None:
            which, method, rows, specs = msg
            owner, sharder = self._owners[which]
            block = [torch.empty(shape, dtype=dtype, device=sharder.device)
                     for shape, dtype in specs]
            src = int(sharder.mesh.mesh.reshape(-1)[0])
            for x in block:
                dist.recv(x, src)
            sharder.run_block(owner, method, block, rows)

    def release(self) -> None:
        """On rank 0, after the daemon stops: let the followers return."""
        from sais_tpu_torch.parallel.mesh import broadcast_object
        for _, sharder in self._owners:
            sharder.scatter = None
        broadcast_object(None)

    def warmup(self) -> None:
        """Run, against zeros, every shape a request runs, so that the
        first request builds no kernel and creates no cuBLAS handle: the
        extractor's batch on its route (normalized frames with
        exact_preprocess, else the frame pump's resized crops; OpenCV's
        fallback decode preprocesses at the video's own resolution, which
        is not known here), and the decoder at device_batch, the window
        count of every full chunk (eager PyTorch runs a video's last chunk
        at its own size, which is not known here either)."""
        ex = self.extractor
        size = self.cfg.preprocess.resize
        if ex.exact_preprocess:
            ex.features_normalized(torch.zeros(
                (ex.batch_size, size, size, 3), device=ex.device))
        else:
            ex.features_resized(torch.zeros(
                (ex.batch_size, size, size, 3), dtype=torch.uint8,
                device=ex.device))
        win = self.cfg.window
        d = self.cfg.model.rep_dim
        use_flow = "Flow" in self.cfg.model.modalities
        wb = self.decoder.device_batch
        reps = np.zeros((win.duration_frames + (wb - 1) * win.hop_frames, d),
                        np.float32)
        flow = (np.zeros((max(len(reps) // win.flow_jump_factor, 1), d),
                         np.float32) if use_flow else None)
        self.decoder.window_probs("warmup", reps, flow)
        if ex.device.type == "cuda":
            torch.cuda.synchronize()

    def warmup_flow(self, height: int, width: int) -> None:
        """Run the fused flow path (RAFT, the device renderer and the ViT)
        once at a video resolution, at the pair batch `auto_pair_batch`
        picks for it, so that the first flow request at that resolution
        pays no cuDNN choice and no kernel build.  Not part of warmup():
        flow shapes follow the incoming video."""
        if self.flow is None:
            return
        pb = self.flow.auto_pair_batch(height, width)
        z = torch.zeros((pb, height, width, 3), dtype=torch.uint8,
                        device=self.flow.device)
        self.flow.fused(z, z)
        if self.flow.device.type == "cuda":
            torch.cuda.synchronize()

    def _video_path(self, video: str) -> str:
        # the name comes off the socket: nothing that could leave
        # <root>/videos or <root>/results
        if os.path.basename(video) != video or video in ("", ".", ".."):
            raise ValueError(f"invalid video name: {video!r}")
        return os.path.join(self.root, "videos", video + ".mp4")

    def start_prefetch(self, video: str):
        """Start the host decode of a queued request while another one
        holds the card, or None: a bad name or path surfaces its own error
        from decode_video, which this only runs ahead of."""
        try:
            return self.extractor.open_stream(self._video_path(video))
        except Exception:
            return None

    def decode_video(self, video: str, use_flow: bool = False,
                     rgb_stream=None) -> dict:
        from sais_tpu_torch.infer.postprocess import write_rows_csv
        t0 = time.time()
        try:
            path = self._video_path(video)
        except Exception:
            if rgb_stream is not None:   # join its producer
                rgb_stream.close()
            raise
        rgb = self.extractor.extract_video(path, stream=rgb_stream)
        flow_reps = None
        if use_flow and self.flow is not None:
            flow_reps = self.flow.extract_video(path)
        rows = self.decoder.decode(video, rgb, flow_reps)
        out = os.path.join(self.root, "results")
        os.makedirs(out, exist_ok=True)
        dest = os.path.join(out, f"{video}_gestures.csv")
        write_rows_csv(rows, dest)
        return {"ok": True, "csv": dest, "intervals": len(rows),
                "frames": int(rgb.shape[0]),
                "seconds": round(time.time() - t0, 2)}


def _percentile(values, q: float) -> float:
    if not values:
        return 0.0
    s = sorted(values)
    i = min(int(q * (len(s) - 1) + 0.5), len(s) - 1)
    return s[i]


def serve(service: DecodeService, socket_path: str, log=print) -> None:
    """Accept loop, one worker thread a connection.

    Decodes run one at a time behind a lock (one video on the card at a
    time: interleaved batches would not finish sooner), while `ping`,
    `stats` and `shutdown` answer at once from any connection.  One
    queued decode starts its host decode while it waits (a bounded
    buffer), so request B's decode on the host overlaps request A's work
    on the card.  `stats` gives the decodes' seconds and their waits from
    arrival to the decode lock (p50, p95).  `shutdown` lets the decodes
    in flight finish and answer first; a client that vanishes leaves the
    daemon serving."""
    if os.path.exists(socket_path):
        os.unlink(socket_path)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(socket_path)
    srv.listen(16)
    log(f"sais serve: listening on {socket_path}")
    stop = threading.Event()
    decode_lock = threading.Lock()
    prefetch_slot = threading.Semaphore(1)   # one queued pre-decode
    active = [0]                             # requests being answered
    active_cv = threading.Condition()
    latencies: deque = deque(maxlen=10000)   # bounded: a long-lived daemon
    waits: deque = deque(maxlen=10000)       # arrival -> the decode lock
    lat_lock = threading.Lock()

    def answer(req: dict) -> dict:
        arrived = time.perf_counter()
        if req.get("cmd") == "shutdown":
            stop.set()
            return {"ok": True, "bye": True}
        if req.get("cmd") == "ping":
            return {"ok": True, "pong": True}
        if req.get("cmd") == "stats":
            with lat_lock:
                lat, wait = sorted(latencies), sorted(waits)
            return {"ok": True, "requests": len(lat),
                    "p50_s": round(_percentile(lat, 0.5), 3),
                    "p95_s": round(_percentile(lat, 0.95), 3),
                    "queue_p50_s": round(_percentile(wait, 0.5), 3),
                    "queue_p95_s": round(_percentile(wait, 0.95), 3),
                    "busy": decode_lock.locked()}
        # another decode in flight: start this one's host decode now
        stream = None
        if decode_lock.locked() and prefetch_slot.acquire(blocking=False):
            stream = service.start_prefetch(str(req.get("video", "")))
            if stream is None:
                prefetch_slot.release()
        try:
            with decode_lock:
                with lat_lock:
                    waits.append(time.perf_counter() - arrived)
                resp = service.decode_video(req["video"],
                                            bool(req.get("flow", False)),
                                            rgb_stream=stream)
        finally:
            if stream is not None:
                prefetch_slot.release()
        with lat_lock:
            latencies.append(resp["seconds"])
            lat = list(latencies)
        log(f"decode {req.get('video')}: {resp['seconds']:.2f}s "
            f"(n={len(lat)} p50={_percentile(lat, 0.5):.2f}s "
            f"p95={_percentile(lat, 0.95):.2f}s)")
        return resp

    def handle(conn):
        try:
            with conn, conn.makefile("rw") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    with active_cv:
                        active[0] += 1
                    try:
                        resp = answer(json.loads(line))
                    except Exception as e:   # report it, keep serving
                        resp = {"ok": False,
                                "error": f"{type(e).__name__}: {e}"}
                    try:
                        f.write(json.dumps(resp) + "\n")
                        f.flush()
                    finally:
                        with active_cv:
                            active[0] -= 1
                            active_cv.notify_all()
                    if stop.is_set():
                        break
        except OSError as e:
            # the client went away mid-request (a timeout, Ctrl-C)
            log(f"client connection error ({e}); still serving")

    srv.settimeout(0.25)   # poll the stop flag between accepts
    try:
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            threading.Thread(target=handle, args=(conn,),
                             daemon=True).start()
    finally:
        srv.close()
        # drain the requests in flight (a decode can take minutes); idle
        # connections waiting on a line hold no request and are not waited
        # for
        with active_cv:
            active_cv.wait_for(lambda: active[0] == 0, timeout=900)
            if active[0]:
                log(f"shutdown with {active[0]} request(s) still in flight")
        if os.path.exists(socket_path):
            os.unlink(socket_path)


def request(socket_path: str, payload: dict, timeout: float = 600.0) -> dict:
    """One-shot client: send a request line, read the response line."""
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(timeout)
    c.connect(socket_path)
    with c, c.makefile("rw") as f:
        f.write(json.dumps(payload) + "\n")
        f.flush()
        return json.loads(f.readline())
