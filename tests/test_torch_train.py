"""The port's Prototypes training slice against the JAX package on the CPU:
the NCE loss, the pandas-free segment datasets and collation, the
sklearn-free metrics, PrototypeTrainer (steps, fit, patience, abort),
params.pkl folds in both directions and the `train` command.  The JAX
trainer's flash path runs its Pallas kernels in interpret mode."""

import pickle

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from sais_tpu import config as jconfig
from sais_tpu.data import collate as jcollate
from sais_tpu.data import datasets as jdatasets
from sais_tpu.models import full_model as jfm
from sais_tpu.models import heads as jheads
from sais_tpu.train import metrics as jmetrics
from sais_tpu.train.loop import PrototypeTrainer as JaxTrainer
from sais_tpu_torch import config as tconfig
from sais_tpu_torch.data import collate, datasets
from sais_tpu_torch.models import heads
from sais_tpu_torch.models.full_model import (FullModel, full_model_init,
                                              prototypes_init)
from sais_tpu_torch.port.weights import full_model_params_from_jax
from sais_tpu_torch.train import metrics
from sais_tpu_torch.train.checkpoint import (load_training_result,
                                             save_training_result)
from sais_tpu_torch.train.loop import PrototypeTrainer

DIM = 64
TEMP = dict(rep_dim=DIM, num_layers=2, num_heads=4, ffn_dim=128,
            max_positions=32)


def test_nce_loss_and_label_columns_match_jax():
    """nce_loss within 1e-6 of the JAX loss (f32, the same formula); a label
    matching no prototype key maps to column 0, as the reference's argmax
    of an all-False row does."""
    rng = np.random.default_rng(0)
    reps = rng.standard_normal((7, 256)).astype(np.float32)
    protos = rng.random((3, 256)).astype(np.float32)
    cols = np.array([0, 2, 1, 1, 0, 2, 2], np.int32)
    ref = float(jheads.nce_loss(jnp.asarray(reps), jnp.asarray(protos),
                                jnp.asarray(cols)))
    got = float(heads.nce_loss(torch.tensor(reps), torch.tensor(protos),
                               torch.tensor(cols)))
    assert abs(got - ref) <= 1e-6
    labels, keys = ["2", 1, "x", 0, "0"], ["0", "1", "2"]
    got_cols = heads.labels_to_prototype_columns(labels, keys)
    np.testing.assert_array_equal(
        got_cols, jheads.labels_to_prototype_columns(labels, keys))
    assert list(got_cols) == [2, 1, 0, 0, 0]


@pytest.mark.parametrize("names", ["str", "int"])
def test_fold_video_split_matches_jax(names):
    """The same lists in the same order for folds 0-5: the same random
    calls and the same set expressions (whose order the process's hashes
    decide, here shared by both)."""
    cases = [f"video_{i}" if names == "str" else 100 + 7 * i
             for i in range(17)]
    for fold in range(6):
        assert datasets.fold_video_split(cases, fold) == \
            jdatasets.fold_video_split(cases, fold)


def _segments(seed=0, nvideos=9, per_video=10, classes=("A", "B", "C")):
    rng = np.random.default_rng(seed)
    rows = []
    for v in range(nvideos):
        for _ in range(per_video):
            start = int(rng.integers(1, 400))
            rows.append({"Video": f"v{v}", "StartFrame": start,
                         "EndFrame": start + int(rng.integers(20, 120)),
                         "Gesture": classes[int(rng.choice(
                             len(classes), p=[0.5, 0.3, 0.2][:len(classes)]
                             if len(classes) == 3 else None))]})
    return rows


def _records(df):
    return df.to_dict("records")


def test_balance_classes_matches_pandas():
    """DataFrame.sample(n, replace=False, random_state=0) per class: the
    same rows in the same order as the JAX package with pandas."""
    rows = _segments(1)
    df = pd.DataFrame(rows)
    for labels in (["A", "B", "C"], ["C", "A"]):
        ref = jdatasets.balance_classes(df, "Gesture", labels)
        assert datasets.balance_classes(rows, "Gesture", labels) == \
            _records(ref)


@pytest.mark.parametrize("balance", [True, False])
def test_build_segment_dataset_matches_jax(balance):
    rows = _segments(2)
    for fold in (0, 3):
        ref = jdatasets.build_segment_dataset(pd.DataFrame(rows), fold,
                                              balance=balance)
        got = datasets.build_segment_dataset(rows, fold, balance=balance)
        assert got.classes == ref.classes
        for phase in ("train", "val", "test"):
            assert got.frames[phase] == _records(ref.frames[phase]), phase


def test_read_segments_types_columns_like_pandas(tmp_path):
    path = tmp_path / "segs.csv"
    pd.DataFrame({"Video": ["a", "b", "a"], "StartFrame": [1, 5, 9],
                  "EndFrame": [40, 60, 80], "Gesture": [2, 10, 2],
                  "Score": [0.5, 1.0, 2.25]}).to_csv(path)
    got = datasets.read_segments(str(path))
    ref = _records(pd.read_csv(path))
    assert got == ref
    assert [type(v) for v in got[0].values()] == [int, str, int, int, int,
                                                  float]


class _Store:
    def __init__(self, videos):
        self.videos = videos

    def read_video(self, name):
        return self.videos[name]


def test_segment_batches_match_jax():
    """Shuffled, bucketed batches with the 3-way TTA variants: the same
    arrays as JAX segment_batches (RGB only)."""
    rows = _segments(3, nvideos=4, per_video=5)
    rng = np.random.default_rng(4)
    store = _Store({f"v{v}": rng.standard_normal((600, 8)).astype(
        np.float32) for v in range(4)})
    classes = sorted({r["Gesture"] for r in rows})
    wcfg = tconfig.WindowConfig()
    ref = list(jcollate.segment_batches(
        pd.DataFrame(rows), store, None, classes, jconfig.WindowConfig(), 6,
        True, seed=3, use_flow=False, tta=True))
    got = list(collate.segment_batches(rows, store, classes, wcfg, 6, True,
                                       seed=3, tta=True))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert len(g["tta"]) == len(r["tta"]) == 3
        for gv, rv in zip([g] + g["tta"], [r] + r["tta"]):
            assert set(gv) - {"tta"} == set(rv) - {"tta"}
            for key in ("rgb", "rgb_mask", "label_cols", "labels"):
                np.testing.assert_array_equal(gv[key], rv[key], key)
                assert gv[key].dtype == rv[key].dtype


def test_prototype_metrics_match_sklearn_fuzz():
    """Accuracy, macro precision / recall (zero_division=0) and ROC-AUC
    (binary on the last column, one-vs-rest macro for more classes, ties
    at average ranks, NaN where sklearn raises) against the JAX package's
    sklearn metrics, on random probabilities with ties, single-class and
    three-class label draws.  Limit 1e-9 (float64 on both sides)."""
    rng = np.random.default_rng(29)
    for case in range(200):
        b = int(rng.integers(1, 12))
        k = int(rng.integers(2, 5))
        keys = [str(i) for i in range(k)]
        labels = [int(rng.integers(0, k)) for _ in range(b)]
        if case % 5 == 0:
            labels = [labels[0]] * b                  # one class present
        raw = rng.random((int(rng.choice([1, 3])), b, k)).round(1) + 0.05
        tta = list(raw / raw.sum(-1, keepdims=True))
        ref = jmetrics.prototype_metrics(tta, labels, keys)
        got = metrics.prototype_metrics(tta, labels, keys)
        assert got.keys() == ref.keys()
        for name in ref:
            if np.isnan(ref[name]):
                assert np.isnan(got[name]), (case, name)
            else:
                assert abs(got[name] - ref[name]) <= 1e-9, (case, name)
    three = [np.array([[.2, .3, .5], [.6, .2, .2], [.1, .8, .1],
                       [.3, .3, .4]])]
    got = metrics.prototype_metrics(three, [2, 0, 1, 1], ["0", "1", "2"])
    assert got == pytest.approx(jmetrics.prototype_metrics(
        three, [2, 0, 1, 1], ["0", "1", "2"]))


def _cfgs(use_flash):
    jcfg = jconfig.ModelConfig(rep_dim=DIM, modalities="RGB",
                               temporal=jconfig.TemporalConfig(
                                   **TEMP, use_flash=use_flash))
    cfg = tconfig.ModelConfig(rep_dim=DIM, modalities="RGB",
                              temporal=tconfig.TemporalConfig(
                                  **TEMP, use_flash=use_flash))
    return jcfg, cfg


def _batches(n, b=6, f=20, seed=0, tta=False):
    """Two classes that differ in their mean feature; ragged masks."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cols = rng.integers(0, 2, b).astype(np.int32)
        variants = []
        for _ in range(3 if tta else 1):
            base = np.where(cols[:, None, None, None] == 0, 0.5, -0.5)
            rgb = (base + rng.normal(size=(b, 1, f, DIM))).astype(np.float32)
            mask = np.zeros((b, 1, f + 1), bool)
            for i in range(b):
                mask[i, 0, f + 1 - 3 * i:] = True
            variants.append({"rgb": rgb, "rgb_mask": mask,
                             "label_cols": cols, "labels": cols})
        batch = dict(variants[0])
        if tta:
            batch["tta"] = variants
        out.append(batch)
    return out


def _trainer_pair(use_flash, lr=0.1, max_patience=5):
    jcfg, cfg = _cfgs(use_flash)
    jparams = jfm.full_model_init(jax.random.key(0), jcfg)
    keys, jprotos = jfm.prototypes_init(jax.random.key(1), 2)
    protos = np.asarray(jprotos)
    model = FullModel(cfg)
    model.load_state_dict(full_model_params_from_jax(jparams))
    jtr = JaxTrainer(jcfg, jconfig.TrainConfig(lr=lr,
                                               max_patience=max_patience),
                     jparams, keys, jnp.asarray(protos))
    tr = PrototypeTrainer(cfg, tconfig.TrainConfig(lr=lr,
                                                   max_patience=max_patience),
                          model, keys, torch.tensor(protos), device="cpu")
    return jtr, tr


@pytest.mark.parametrize("use_flash", [False, True])
def test_trainer_steps_match_jax(use_flash):
    """Three SGD steps from the same parameters (carried across by
    full_model_params_from_jax): the same losses and metrics each step and
    the same parameters and prototypes after, within 1e-4 (f32 on both
    sides, summation order only), on the dense path and with flash
    attention (K2 / K3 plain versions here, the Pallas kernels in
    interpret mode there)."""
    jtr, tr = _trainer_pair(use_flash)
    for batch in _batches(3):
        jl, jm = jtr.run_epoch([batch], train=True)
        gl, gm = tr.run_epoch([batch], train=True)
        assert abs(gl - jl) <= 1e-4
        for name in ("acc", "precision", "recall"):
            assert gm[name] == pytest.approx(jm[name], abs=1e-6)
    want = full_model_params_from_jax(jax.tree.map(np.asarray,
                                                   jtr.state.model))
    for name, p in tr.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose(tr.prototypes.detach().numpy(),
                               np.asarray(jtr.state.prototypes), atol=1e-4)


def test_fit_matches_jax():
    """fit over train and TTA val loaders that take the epoch index: the
    same val history (loss within 1e-4, the metrics) and best epoch as the
    JAX trainer."""
    jtr, tr = _trainer_pair(False, lr=0.5)
    train = _batches(2, seed=1)
    val = _batches(1, seed=2, tta=True)
    loaders = {"train": lambda epoch=0: iter(train),
               "val": lambda epoch=0: iter(val)}
    ref = jtr.fit(loaders, nepochs=3, log=lambda s: None)
    got = tr.fit(loaders, nepochs=3, log=lambda s: None)
    assert got["best_epoch"] == ref["best_epoch"]
    assert got["metrics"].keys() == ref["metrics"].keys()
    np.testing.assert_allclose(got["metrics"]["loss"],
                               ref["metrics"]["loss"], atol=1e-4)
    for name in ("acc", "auc", "precision", "recall"):
        np.testing.assert_allclose(got["metrics"][name],
                                   ref["metrics"][name], atol=1e-6)
    np.testing.assert_allclose(got["prototypes"].numpy(),
                               np.asarray(ref["prototypes"]), atol=1e-4)


def test_fit_patience_and_best_snapshot():
    """lr 0: the val loss never improves after epoch 1, so with patience 3
    the loop runs 4 epochs (tests/test_training.py:69), and the best
    snapshot is the epoch-1 state; loaders that take an argument get the
    epoch index."""
    _, tr = _trainer_pair(False, lr=0.0, max_patience=3)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    batches = _batches(1)
    seen, logs = [], []

    def make(epoch):
        seen.append(epoch)
        return iter(batches)

    result = tr.fit({"train": make, "val": lambda: iter(batches)},
                    nepochs=50, log=logs.append)
    assert len([l for l in logs if l.startswith("val_")]) == 4
    assert seen == [0, 1, 2, 3] and result["best_epoch"] == 1
    assert len(result["metrics"]["loss"]) == 4
    for name, p in result["model"].items():
        torch.testing.assert_close(p, before[name], rtol=0, atol=0)


def test_nonfinite_loss_aborts():
    _, tr = _trainer_pair(False)
    with torch.no_grad():
        tr.prototypes.fill_(float("nan"))
    with pytest.raises(FloatingPointError):
        tr.run_epoch(iter(_batches(1)), train=True)


def _write_store(root, videos, frames, dim, seed=0):
    from sais_tpu_torch.io.feature_store import FeatureStore, rgb_store_path
    rng = np.random.default_rng(seed)
    with FeatureStore(rgb_store_path(str(root)), "a") as fs:
        for v in videos:
            fs.write_video(v, rng.standard_normal((frames, dim)).astype(
                np.float32))


def test_port_fold_decodes_like_jax_cli(tmp_path, capsys):
    """A fold the port saved (params.pkl in the JAX layout) decoded by `sais
    decode --params-dir --save-artifacts` (the JAX CLI, on the CPU) and by
    the port's decode: the same gestures CSV text and window
    probabilities within 1e-3 (the end-to-end limit, port/verify.py:55).
    Full-width temporal model, the CLIs' default configuration."""
    from sais_tpu.cli.main import main as jax_main
    from sais_tpu_torch.cli.main import main as port_main
    _write_store(tmp_path, ["vid"], 90, 384)
    cfg = tconfig.ModelConfig(modalities="RGB")
    model = full_model_init(torch.Generator().manual_seed(0), cfg)
    keys, protos = prototypes_init(torch.Generator().manual_seed(1), 2)
    tr = PrototypeTrainer(cfg, tconfig.TrainConfig(lr=0.5), model, keys,
                          protos, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"rgb": rng.standard_normal((4, 1, 16, 384)).astype(np.float32),
             "rgb_mask": np.zeros((4, 1, 17), bool),
             "label_cols": np.array([0, 1, 0, 1], np.int32)}
    loss, _ = tr.run_epoch([batch], train=True)
    sd, trained = tr.snapshot()
    save_training_result(str(tmp_path / "params" / "Fold_0"),
                         {"model": sd, "prototypes": trained,
                          "metrics": {"loss": [loss]}})
    assert load_training_result(str(tmp_path / "params" / "Fold_0"))[
        "metrics"] == {"loss": [loss]}
    out = {}
    for name, run in (("port", port_main), ("jax", jax_main)):
        extra = ["--device", "cpu"] if name == "port" else []
        run(["decode", "-f", "vid", "-p", str(tmp_path), "-mod", "RGB",
             "--params-dir", str(tmp_path / "params"), "--save-artifacts",
             *extra])
        csv = tmp_path / "results" / "Custom_inference_gestures.csv"
        with open(tmp_path / "params" / "Fold_0"
                  / "reps_and_labels_Custom_inference.pkl", "rb") as f:
            probs = pickle.load(f)["probs"]     # TTA augment -> (W, 2)
        out[name] = (csv.read_text(), np.stack([probs[t] for t in
                                                sorted(probs)]))
    assert "gesture intervals" in capsys.readouterr().out
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1].shape == out["jax"][1].shape == (3, 6, 2)
    np.testing.assert_allclose(out["port"][1], out["jax"][1], atol=1e-3)


def _tiny_pipeline_cfg():
    return tconfig.PipelineConfig(model=tconfig.ModelConfig(
        rep_dim=DIM, modalities="RGB",
        temporal=tconfig.TemporalConfig(**TEMP)))


def test_cli_train_on_cpu_and_refusals(tmp_path, monkeypatch, capsys):
    """`train --segments ... -bc -e 2 -bs 4 --device cpu` on a tiny H5
    store (a tiny temporal model in place of the full width): writes
    params/Fold_<k>/params.pkl, prototypes.pkl and metrics.pkl for each
    fold, which the port's decode reads back; `--split-policy louo`, `-t
    MIL` and `-mod RGB-Flow` (over a flow store) run and save their fold
    (held to the JAX CLI in tests/test_torch_classification.py, with
    `--dataset vua-gestures` and `dvc-ucl`); `--data-type raw` without
    `--dataset vua-ease` exits as the JAX CLI does (the raw path itself is
    held to the JAX CLI in tests/test_torch_raw.py)."""
    from sais_tpu_torch.cli import main as cli
    monkeypatch.setattr(cli, "PipelineConfig", _tiny_pipeline_cfg)
    videos = [f"v{i}" for i in range(10)]
    _write_store(tmp_path, videos, 500, DIM)
    rows = _segments(5, nvideos=10, per_video=6, classes=("A", "B"))
    for i, r in enumerate(rows):
        r["Subject"] = f"U{i % 4}"     # the louo split's users
    segs = tmp_path / "segs.csv"
    pd.DataFrame(rows).to_csv(segs, index=False)
    base = ["train", "-p", str(tmp_path), "--segments", str(segs),
            "--device", "cpu"]
    cli.main(base + ["-bc", "-e", "2", "-bs", "4", "--nfolds", "2",
                     "--flash", "on"])
    out = capsys.readouterr().out
    assert "saved fold 1" in out and "val_loss" in out
    for fold in (0, 1):
        res = load_training_result(str(tmp_path / "params" / f"Fold_{fold}"))
        assert set(res) == {"params", "prototypes", "metrics"}
        assert res["prototypes"].shape == (2, 256)
        assert len(res["params"]["frame_encoder"]["layers"]) == 2
    cli.main(["decode", "-f", "v0", "-p", str(tmp_path), "--device", "cpu",
              "--params-dir", str(tmp_path / "params"), "--nfolds", "2"])
    assert "gesture intervals" in capsys.readouterr().out
    from sais_tpu_torch.io.feature_store import FeatureStore, flow_store_path
    rng = np.random.default_rng(1)
    with FeatureStore(flow_store_path(str(tmp_path)), "a") as fs:
        for v in videos:
            fs.write_video(v, rng.standard_normal((30, DIM)).astype(
                np.float32))
    for flags in (["--split-policy", "louo"], ["-t", "MIL"],
                  ["-mod", "RGB-Flow"]):
        cli.main(base + ["-e", "1", "-bs", "4", *flags])
        assert "saved fold 0" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="requires --dataset vua-ease"):
        cli.main(base + ["-dt", "raw"])
