"""The port's decode daemon (`sais_tpu_torch/cli/serve.py`) on the CPU: the
same answer as the JAX package's DecodeService from the same weights and
video, and the protocol cases of tests/test_serve.py (round trip, warm-up,
a ping during a decode, a shutdown that drains, a client that vanishes, a
queued request's prefetch, a pre-opened stream, concurrent load).  Every
socket wait has a timeout of its own."""

import os
import re
import socket
import threading
import time

import numpy as np
import pytest
import torch

import jax

from sais_tpu import config as jconfig
from sais_tpu.cli.serve import DecodeService as JaxService
from sais_tpu.models.full_model import full_model_init as jax_model_init
from sais_tpu.models.full_model import prototypes_init as jax_protos_init
from sais_tpu.models.vit import vit_init as jax_vit_init
from sais_tpu_torch import config as tconfig
from sais_tpu_torch.cli.serve import DecodeService, request, serve
from sais_tpu_torch.infer.pipeline import FeatureExtractor
from sais_tpu_torch.models.full_model import FullModel
from sais_tpu_torch.models.vit import VisionTransformer
from sais_tpu_torch.port.weights import (full_model_params_from_jax,
                                         vit_params_from_jax)
from tests.test_torch_pipeline import _synth_video, tiny_cfg

SOCKET_WAIT = 10.0    # seconds a socket may take to appear or to answer


def _weights():
    """(JAX vit params, JAX folds, port ViT, port folds), the same values."""
    jcfg, tcfg = tiny_cfg(jconfig), tiny_cfg(tconfig)
    vparams = jax_vit_init(jax.random.key(0), jcfg.vit)
    vit = VisionTransformer(tcfg.vit)
    vit.load_state_dict(vit_params_from_jax(vparams))
    params = jax_model_init(jax.random.key(1), jcfg.model)
    _, protos = jax_protos_init(jax.random.key(2), 2)
    model = FullModel(tcfg.model)
    model.load_state_dict(full_model_params_from_jax(params))
    return (vparams, [(params, protos)], vit,
            [(model, torch.tensor(np.asarray(protos)))])


def _service(root, batch_size=32):
    _, _, vit, folds = _weights()
    return DecodeService(str(root), tiny_cfg(tconfig), vit, folds,
                         batch_size=batch_size, device="cpu")


def _videos(root, frames):
    os.makedirs(os.path.join(root, "videos"), exist_ok=True)
    for name, n in frames.items():
        _synth_video(os.path.join(root, "videos", f"{name}.mp4"), nframes=n)


def _start(svc, sock, log=lambda s: None):
    t = threading.Thread(target=serve, args=(svc, sock),
                         kwargs={"log": log}, daemon=True)
    t.start()
    deadline = time.time() + SOCKET_WAIT
    while not os.path.exists(sock) and time.time() < deadline:
        time.sleep(0.02)
    assert os.path.exists(sock), "the daemon did not open its socket"
    return t


def _rpc(sock, payload, timeout=SOCKET_WAIT):
    return request(sock, payload, timeout=timeout)


def _stop(sock, t):
    assert _rpc(sock, {"cmd": "shutdown"})["bye"]
    t.join(timeout=SOCKET_WAIT)
    assert not t.is_alive()


def test_decode_service_matches_jax(tmp_path):
    """One mp4 through both packages' DecodeService from the same weights:
    features within 1e-4, window probabilities within 1e-3 and the
    gestures CSV equal as text."""
    _videos(str(tmp_path), {"vid": 90})
    vparams, jfolds, vit, tfolds = _weights()
    jroot, troot = tmp_path / "jax", tmp_path / "port"
    for r in (jroot, troot):
        os.makedirs(r)
        os.symlink(tmp_path / "videos", r / "videos")
    jsvc = JaxService(str(jroot), tiny_cfg(jconfig), vparams, jfolds,
                      batch_size=32)
    tsvc = DecodeService(str(troot), tiny_cfg(tconfig), vit, tfolds,
                         batch_size=32, device="cpu")
    path = str(tmp_path / "videos" / "vid.mp4")
    jreps = jsvc.extractor.extract_video(path)
    treps = tsvc.extractor.extract_video(path)
    np.testing.assert_allclose(treps, jreps, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        tsvc.decoder.window_probs("vid", jreps),
        jsvc.decoder.window_probs("vid", jreps, None), rtol=0, atol=1e-3)
    jres, tres = jsvc.decode_video("vid"), tsvc.decode_video("vid")
    assert tres["ok"] and tres["frames"] == jres["frames"] == 90
    assert tres["intervals"] == jres["intervals"]
    with open(jres["csv"]) as a, open(tres["csv"]) as b:
        assert b.read() == a.read()
    assert tres["csv"] == str(troot / "results" / "vid_gestures.csv")


def test_serve_roundtrip(tmp_path):
    _videos(str(tmp_path), {"vid": 90})
    sock = str(tmp_path / "s.sock")
    t = _start(_service(tmp_path), sock)
    assert _rpc(sock, {"cmd": "ping"})["pong"]
    resp = _rpc(sock, {"video": "vid"}, timeout=60)
    assert resp["ok"] and resp["frames"] == 90
    assert os.path.exists(resp["csv"])
    # a bad video is reported and the daemon goes on serving
    bad = _rpc(sock, {"video": "nope"})
    assert not bad["ok"] and "FileNotFoundError" in bad["error"]
    # names that would leave <root>/videos are refused before any access
    for evil in ("../videos/vid", "/etc/passwd"):
        resp = _rpc(sock, {"video": evil})
        assert not resp["ok"] and "ValueError" in resp["error"]
    assert _rpc(sock, {"cmd": "ping"})["pong"]
    _stop(sock, t)
    assert not os.path.exists(sock)


def test_warmup_runs_the_extractor_and_decode_path(tmp_path):
    """warmup() drives the extractor's batch on its route and the decoder
    at device_batch, the shape of every full chunk; warmup_flow is a no-op
    without RAFT."""
    svc = _service(tmp_path, batch_size=8)
    seen = {"probs": [], "features": []}
    orig_probs = svc.decoder.window_probs
    orig_feats = svc.extractor.features_resized

    def probs(video, reps, flow=None):
        seen["probs"].append(len(reps))
        return orig_probs(video, reps, flow)

    def feats(frames):
        seen["features"].append(tuple(frames.shape))
        return orig_feats(frames)

    svc.decoder.window_probs = probs
    svc.extractor.features_resized = feats
    svc.warmup()
    win = svc.cfg.window
    assert seen["features"] == [(8, 32, 32, 3)]
    assert seen["probs"] == [win.duration_frames + 511 * win.hop_frames]
    svc.warmup_flow(32, 40)


def _slow(svc, seconds, started):
    def slow_decode(video, use_flow=False, rgb_stream=None):
        started.set()
        time.sleep(seconds)
        return {"ok": True, "csv": "", "intervals": 0, "frames": 0,
                "seconds": seconds}
    svc.decode_video = slow_decode


def test_ping_answers_while_decode_in_flight(tmp_path):
    svc = _service(tmp_path)
    started = threading.Event()
    _slow(svc, 2.0, started)
    sock = str(tmp_path / "s.sock")
    t = _start(svc, sock)
    result = {}
    dt = threading.Thread(
        target=lambda: result.update(_rpc(sock, {"video": "vid"})))
    dt.start()
    assert started.wait(SOCKET_WAIT)
    t0 = time.time()
    assert _rpc(sock, {"cmd": "ping"})["pong"]
    assert time.time() - t0 < 1.0          # answered during the decode
    stats = _rpc(sock, {"cmd": "stats"})
    assert stats["ok"] and stats["busy"]
    dt.join(timeout=SOCKET_WAIT)
    assert result.get("ok")
    _stop(sock, t)


def test_shutdown_drains_inflight_decode(tmp_path):
    svc = _service(tmp_path)
    started = threading.Event()
    _slow(svc, 1.5, started)
    sock = str(tmp_path / "s.sock")
    t = _start(svc, sock)
    result = {}
    dt = threading.Thread(
        target=lambda: result.update(_rpc(sock, {"video": "vid"})))
    dt.start()
    assert started.wait(SOCKET_WAIT)
    assert _rpc(sock, {"cmd": "shutdown"})["bye"]
    t.join(timeout=SOCKET_WAIT)       # serve() waits for the decode
    assert not t.is_alive()
    dt.join(timeout=SOCKET_WAIT)
    assert result.get("ok"), result   # the client in flight got its answer


def test_serve_survives_client_disconnect(tmp_path):
    sock = str(tmp_path / "s.sock")
    t = _start(_service(tmp_path), sock)
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(SOCKET_WAIT)
    c.connect(sock)
    c.sendall(b'{"video": "missing"}\n')
    c.close()                         # gone before the answer is written
    time.sleep(0.3)
    assert _rpc(sock, {"cmd": "ping"})["pong"]
    assert _rpc(sock, {"cmd": "stats"})["ok"]
    _stop(sock, t)


def test_queued_request_prefetches_host_decode(tmp_path):
    """While A holds the decode lock, B's host decode starts and B's
    decode consumes that stream, with the full video's frames; `stats`
    reports B's wait for the lock."""
    root = str(tmp_path)
    _videos(root, {"vid_a": 60, "vid_b": 90})
    svc = _service(tmp_path)
    events = []
    a_started = threading.Event()
    orig_decode, orig_prefetch = svc.decode_video, svc.start_prefetch

    def traced_decode(video, use_flow=False, rgb_stream=None):
        events.append(("decode", video, rgb_stream is not None))
        if video == "vid_a":
            a_started.set()
            time.sleep(1.5)       # keep the card busy while B arrives
        return orig_decode(video, use_flow, rgb_stream=rgb_stream)

    def traced_prefetch(video):
        events.append(("prefetch", video, a_started.is_set()))
        return orig_prefetch(video)

    svc.decode_video = traced_decode
    svc.start_prefetch = traced_prefetch
    sock = str(tmp_path / "s.sock")
    t = _start(svc, sock)
    res_a, res_b = {}, {}
    ta = threading.Thread(target=lambda: res_a.update(
        _rpc(sock, {"video": "vid_a"}, timeout=60)))
    ta.start()
    assert a_started.wait(SOCKET_WAIT)
    tb = threading.Thread(target=lambda: res_b.update(
        _rpc(sock, {"video": "vid_b"}, timeout=60)))
    tb.start()
    ta.join(timeout=60)
    tb.join(timeout=60)
    assert res_a.get("ok") and res_b.get("ok"), (res_a, res_b)
    assert res_b["frames"] == 90
    assert ("prefetch", "vid_b", True) in events
    assert ("decode", "vid_b", True) in events
    # B waited for the lock while A decoded
    stats = _rpc(sock, {"cmd": "stats"})
    assert 0 <= stats["queue_p50_s"] <= stats["queue_p95_s"]
    assert stats["queue_p95_s"] > 0
    _stop(sock, t)


def test_extract_video_consumes_preopened_stream(tmp_path):
    """extract_video(stream=open_stream(...)) equals the cold path bit for
    bit, on the frame pump's route (where it builds) and on OpenCV's."""
    path = str(tmp_path / "v.mp4")
    _synth_video(path, nframes=70)
    _, _, vit, _ = _weights()
    for exact in (False, True):
        ex = FeatureExtractor(vit, tiny_cfg(tconfig), batch_size=32,
                              device="cpu", exact_preprocess=exact)
        cold = ex.extract_video(path)
        warm = ex.extract_video(path, stream=ex.open_stream(path))
        assert cold.shape == (70, 64)
        np.testing.assert_array_equal(cold, warm)


def test_open_stream_propagates_decode_errors(tmp_path, monkeypatch):
    """A decode failure past opening reaches the caller; the producer is
    joined either way."""
    from sais_tpu_torch.infer import pipeline

    path = str(tmp_path / "v.mp4")
    _synth_video(path, nframes=40)

    class Broken(pipeline.VideoReader):
        def batches(self, batch_size):
            yield from super().batches(batch_size)
            raise OSError("corrupt stream")

    monkeypatch.setattr(pipeline, "VideoReader", Broken)
    _, _, vit, _ = _weights()
    ex = FeatureExtractor(vit, tiny_cfg(tconfig), batch_size=16,
                          device="cpu", exact_preprocess=True)
    stream = ex.open_stream(path)
    with pytest.raises(OSError, match="corrupt"):
        ex.extract_video(path, stream=stream)


def test_serve_under_concurrent_load(tmp_path):
    """Four clients at once: each gets its own video's answer, at most one
    prefetch stream is ever open, and the daemon logs each latency with
    the running p50 / p95 that stats reports."""
    root = str(tmp_path)
    nframes = {"vid_a": 45, "vid_b": 60, "vid_c": 75, "vid_d": 30}
    _videos(root, nframes)
    svc = _service(tmp_path)
    open_streams, max_open = [0], [0]
    lock = threading.Lock()
    orig_prefetch = svc.start_prefetch

    def traced_prefetch(video):
        s = orig_prefetch(video)
        if s is None:
            return None
        with lock:
            open_streams[0] += 1
            max_open[0] = max(max_open[0], open_streams[0])
        orig_close = s.close

        def close():
            with lock:
                open_streams[0] -= 1
            orig_close()

        s.close = close
        return s

    svc.start_prefetch = traced_prefetch
    logs = []
    sock = str(tmp_path / "s.sock")
    t = _start(svc, sock, log=logs.append)
    results = {}

    def client(name):
        results[name] = _rpc(sock, {"video": name}, timeout=120)

    threads = [threading.Thread(target=client, args=(n,)) for n in nframes]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    for name, n in nframes.items():
        assert results[name].get("ok"), results[name]
        assert results[name]["frames"] == n, (name, results[name])
        assert os.path.exists(results[name]["csv"])
    assert max_open[0] <= 1 and open_streams[0] == 0
    lat = [ln for ln in logs if re.search(r"p50=\d", ln)]
    assert len(lat) == 4, logs
    assert re.search(r"decode vid_\w: \d+\.\d+s \(n=4 p50=\d+\.\d+s "
                     r"p95=\d+\.\d+s\)", lat[-1]), lat[-1]
    stats = _rpc(sock, {"cmd": "stats"})
    assert stats["requests"] == 4
    assert 0 < stats["p50_s"] <= stats["p95_s"]
    _stop(sock, t)
