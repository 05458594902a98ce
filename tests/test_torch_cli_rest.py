"""The commands and the flag the port refused until its last module slice
(`eval`, `port`, `serve`, `request`, `attention`, and `--flow-warmup` on
`serve` and on every other command) now run through the port's CLI on the
CPU, at the tiny geometry of tests/test_torch_pipeline.py.  Each case
replaces the refusal case of the same name in
`test_refusals_name_roadmap_items_that_exist`."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from sais_tpu_torch import config as tconfig
from tests.test_torch_pipeline import _synth_video, tiny_cfg

SOCKET_WAIT = 20.0


def _daemon(argv):
    """The CLI's `serve` in a thread; returns (thread, socket path) once the
    socket is open."""
    from sais_tpu_torch.cli import main as cli
    sock = argv[argv.index("--socket") + 1]
    t = threading.Thread(target=cli.main, args=(argv,), daemon=True)
    t.start()
    deadline = time.time() + SOCKET_WAIT
    while not os.path.exists(sock) and time.time() < deadline:
        time.sleep(0.05)
    assert os.path.exists(sock), "serve did not open its socket"
    return t


def _request(capsys, *argv):
    from sais_tpu_torch.cli import main as cli
    cli.main(["request", *argv])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _run_case(case, root, capsys, monkeypatch):
    from sais_tpu_torch.cli import main as cli
    from sais_tpu_torch.cli import serve as serve_mod
    cpu = ["-p", str(root), "--device", "cpu"]
    sock = str(root / "s.sock")
    os.makedirs(root / "videos")
    _synth_video(str(root / "videos" / "v.mp4"), nframes=30)
    if case == "eval":
        from tests.test_torch_eval import _eval_root
        csv = _eval_root(root, {f"v{i}": 30 + 5 * i for i in range(4)})
        cli.main(["eval", "--segments", csv, *cpu])
        assert capsys.readouterr().out.startswith("knn top1 ")
    elif case == "port":
        from sais_tpu_torch.models.full_model import (full_model_init,
                                                      prototypes_init)
        from sais_tpu_torch.train.checkpoint import save_training_result
        cfg = tiny_cfg(tconfig).model
        fold = root / "params" / "Fold_0"
        save_training_result(str(fold), {
            "model": full_model_init(torch.Generator().manual_seed(0),
                                     cfg).state_dict(),
            "prototypes": prototypes_init(torch.Generator().manual_seed(1),
                                          2)[1]})
        cli.main(["port", "--params-dir", str(root / "params"), *cpu])
        assert (fold / "params.zip").exists()
        assert (fold / "prototypes.zip").exists()
    elif case in ("serve", "serve --flow-warmup 48x64"):
        flow = case != "serve"
        seen = []
        orig = serve_mod.DecodeService.warmup_flow

        def warmup_flow(self, h, w):
            seen.append((h, w, self.flow is not None))
            orig(self, h, w)

        monkeypatch.setattr(serve_mod.DecodeService, "warmup_flow",
                            warmup_flow)
        extra = (["-mod", "RGB-Flow", "--flow-jump", "3", "--flow-iters",
                  "1", "--flow-batch", "2", "--flow-warmup", "48x64"]
                 if flow else [])
        t = _daemon(["serve", "--random-init", "--socket", sock, "-bs", "8",
                     *cpu, *extra])
        assert _request(capsys, "--rpc", "ping", "--socket",
                        sock)["pong"]
        if flow:
            assert seen == [(48, 64, True)]
            resp = _request(capsys, "-f", "v", "-mod", "RGB-Flow",
                            "--socket", sock)
            assert resp["ok"] and resp["frames"] == 30, resp
        assert _request(capsys, "--rpc", "shutdown", "--socket",
                        sock)["bye"]
        t.join(timeout=SOCKET_WAIT)
        assert not t.is_alive()
    elif case == "request":
        t = _daemon(["serve", "--random-init", "--socket", sock, "-bs", "8",
                     *cpu])
        resp = _request(capsys, "-f", "v", "--socket", sock)
        assert resp["ok"] and resp["frames"] == 30, resp
        assert os.path.exists(root / "results" / "v_gestures.csv")
        stats = _request(capsys, "--rpc", "stats", "--socket", sock)
        assert stats["requests"] == 1 and not stats["busy"]
        assert _request(capsys, "--rpc", "shutdown", "--socket",
                        sock)["bye"]
        t.join(timeout=SOCKET_WAIT)
        with pytest.raises(SystemExit, match="-f <videoname> or --rpc"):
            cli.main(["request", "--socket", sock])
    elif case == "attention":
        from PIL import Image
        Image.fromarray(np.zeros((40, 56, 3), np.uint8)).save(root / "i.png")
        cli.main(["attention", "--image", str(root / "i.png"),
                  "--random-init", *cpu])
        assert len(os.listdir(root / "results")) == 4   # one map a head
    elif case == "extract --flow-warmup 48x64":
        from sais_tpu_torch.io.feature_store import (FeatureStore,
                                                     rgb_store_path)
        cli.main(["extract", "-f", "v", "--random-init", "--flow-warmup",
                  "48x64", "-bs", "8", *cpu])
        with FeatureStore(rgb_store_path(str(root))) as fs:
            assert fs.read_video("v").shape == (30, 64)
    else:
        raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "eval", "port", "serve", "request", "attention",
    "serve --flow-warmup 48x64", "extract --flow-warmup 48x64"])
def test_retired_refusals_now_run(case, tmp_path, capsys, monkeypatch):
    """Each command the port refused until this slice runs end to end on
    the CPU (the configuration patched tiny)."""
    from sais_tpu_torch.cli import main as cli
    cfg = tiny_cfg(tconfig)
    monkeypatch.setattr(cli, "PipelineConfig", lambda: cfg)
    _run_case(case, tmp_path, capsys, monkeypatch)
