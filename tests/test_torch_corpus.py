"""The port's procedural corpus and demo (pitchvis_tpu_torch/train/corpus.py)
and its copy of the logistic diagnostic (train/logistic.py) against the JAX
package's: the font and the corpus are the same bytes at a seed, the
logistic fit the same numbers. train_demo runs end to end on the CPU at a
tiny size and writes under its own directory only: the JAX package's
committed evidence (artifacts/TRAIN_DEMO*.json, artifacts/train_demo*/) is
never its target."""

import json
import os

import numpy as np
import pytest

from pitchvis_tpu.train import corpus as j_corpus
from pitchvis_tpu.train import logistic as j_logistic
from pitchvis_tpu.train.dataset import center_vqt_samples
from pitchvis_tpu_torch.train import corpus as t_corpus
from pitchvis_tpu_torch.train import logistic as t_logistic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build")


def test_font_bytes_equal(tmp_path):
    assert t_corpus.build_training_font(str(tmp_path / "t.sf2"), seed=0) == j_corpus.build_training_font(
        str(tmp_path / "j.sf2"), seed=0)
    assert (tmp_path / "t.sf2").read_bytes() == (tmp_path / "j.sf2").read_bytes()
    t_corpus.build_training_font(str(tmp_path / "t1.sf2"), seed=1)
    assert (tmp_path / "t1.sf2").read_bytes() != (tmp_path / "t.sf2").read_bytes()


def test_corpus_bytes_equal(tmp_path):
    tp = t_corpus.build_midi_corpus(str(tmp_path / "t"), 3, 20.0, seed=0)
    jp = j_corpus.build_midi_corpus(str(tmp_path / "j"), 3, 20.0, seed=0)
    assert [os.path.basename(p) for p in tp] == [os.path.basename(p) for p in jp]
    for a, b in zip(tp, jp):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    rng_t, rng_j = np.random.default_rng(9), np.random.default_rng(9)
    assert t_corpus.generate_piece(rng_t, 30.0, [0, 24], [48]) == j_corpus.generate_piece(rng_j, 30.0, [0, 24], [48])


def _samples():
    rng = np.random.default_rng(11)
    pos, neg = [], []
    for _ in range(40):
        key = int(rng.integers(45, 100))
        vqt = rng.random(84).astype(np.float32) * 2.0
        idx = key - 33
        vqt[max(0, idx - 1) : idx + 2] += 25.0
        p, n = center_vqt_samples({key: 1.0}, vqt, 1, 7)
        pos += p
        neg += n
    return pos, neg


def test_logistic_fit_equal():
    """fit on centered samples (the JAX test's) gives the same weights,
    intercept, confusion matrix, accuracy and MCC."""
    pos, neg = _samples()
    a, b = j_logistic.fit(pos, neg, seed=0), t_logistic.fit(pos, neg, seed=0)
    np.testing.assert_array_equal(a.weights, b.weights)
    np.testing.assert_array_equal(a.confusion, b.confusion)
    assert (a.intercept, a.accuracy, a.mcc) == (b.intercept, b.accuracy, b.mcc)
    assert b.accuracy >= 0.9
    conf = np.array([[7, 2], [1, 5]])
    assert t_logistic.matthews_corrcoef(conf) == j_logistic.matthews_corrcoef(conf)


def test_tiny_train_demo_writes_its_own_directory_only(tmp_path):
    """Font -> corpus -> host route (native synthesis, the VQT on the CPU)
    -> one epoch -> checkpoint, in tmp_path: a finite loss, the metrics file,
    a checkpoint, and nothing new under artifacts/ or as the port's metrics
    copies (a run below demo scale makes none)."""
    artifacts = os.path.join(ROOT, "artifacts")

    def listing():
        return {os.path.join(d, f): os.path.getmtime(os.path.join(d, f))
                for d, _, fs in os.walk(artifacts) for f in fs}

    before = listing()
    copies = [os.path.join(BUILD, n) for n in ("TRAIN_DEMO_TORCH.json", "TRAIN_DEMO_TORCH_TUNED.json")]
    copies_before = {p: os.path.getmtime(p) for p in copies if os.path.exists(p)}
    out = str(tmp_path / "demo")
    report = t_corpus.train_demo(out_dir=out, n_files=2, seconds_per_file=4.0, epochs=1, n_workers=2,
                                 device="cpu")
    assert report["n_frames"] > 0 and np.isfinite(report["metrics"]["epoch_loss"]).all()
    with open(os.path.join(out, "metrics.json")) as f:
        assert json.load(f)["n_frames"] == report["n_frames"]
    assert os.listdir(os.path.join(out, "ckpt"))
    assert np.load(os.path.join(out, "data.npy")).size == report["n_frames"] * (252 + 128)
    assert listing() == before
    assert {p: os.path.getmtime(p) for p in copies if os.path.exists(p)} == copies_before


def _fake_demo(monkeypatch):
    calls = []

    def fake_train_demo(**kw):
        calls.append(kw)
        return {"n_frames": 1, "metrics": {"f1_micro": 0.0, "accuracy": 0.0}}

    monkeypatch.setattr(t_corpus, "train_demo", fake_train_demo)
    return calls


@pytest.mark.parametrize("argv, out, copy", [
    ([], "train_demo_torch", "TRAIN_DEMO_TORCH.json"),
    (["--tuned"], "train_demo_torch", "TRAIN_DEMO_TORCH_TUNED.json"),
    (["--quick", "--tuned"], "train_demo_torch", None),
    (["--files", "4"], "train_demo_torch", None),
    (["--full"], "train_demo_torch_full", "TRAIN_DEMO_TORCH_FULLSCALE.json"),
    (["--full", "--files", "8"], "train_demo_torch_full", None),
    (["--full", "--reference-hparams"], "train_demo_torch_full_ref", "TRAIN_DEMO_TORCH_FULLSCALE_REF.json"),
])
def test_cli_writes_under_build_only(monkeypatch, argv, out, copy):
    """The CLI's presets as the JAX package's, with every output directory
    and metrics copy under build/ (listed in .gitignore), never artifacts/."""
    calls = _fake_demo(monkeypatch)
    assert t_corpus.main(argv) == 0
    kw = calls[-1]
    assert kw["out_dir"] == os.path.join(BUILD, out)
    assert kw["metrics_copy"] == (os.path.join(BUILD, copy) if copy else None)
    with pytest.raises(SystemExit):
        t_corpus.main(["--reference-hparams"])


def test_library_call_auto_copy_goes_under_build(monkeypatch, tmp_path):
    """train_demo's metrics_copy="auto": a demo-scale library call copies its
    report to DEMO_ROOT/TRAIN_DEMO_TORCH[_TUNED].json (build/ of the
    checkout, here a temporary directory), a smaller one nowhere."""
    import pitchvis_tpu_torch.train.dataset as ds
    import pitchvis_tpu_torch.train.train as tr

    assert t_corpus.DEMO_ROOT == BUILD
    row = 252 + 128
    monkeypatch.setattr(t_corpus, "DEMO_ROOT", str(tmp_path))
    monkeypatch.setattr(t_corpus, "build_training_font", lambda *a, **kw: [0])
    monkeypatch.setattr(t_corpus, "build_midi_corpus", lambda *a, **kw: [])
    monkeypatch.setattr(ds, "generate_dataset", lambda *a, **kw: np.zeros(row * 8, np.float32))
    monkeypatch.setattr(tr, "train", lambda *a, **kw: (None, {"f1_micro": 0.0, "accuracy": 0.0}))
    for tuned, name in ((True, "TRAIN_DEMO_TORCH_TUNED.json"), (False, "TRAIN_DEMO_TORCH.json")):
        t_corpus.train_demo(out_dir=str(tmp_path / f"t{tuned}"), tuned=tuned)
        assert (tmp_path / name).exists(), name
        (tmp_path / name).unlink()
    t_corpus.train_demo(out_dir=str(tmp_path / "toy"), n_files=4)
    assert not list(tmp_path.glob("*.json"))
