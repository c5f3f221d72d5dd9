"""The port's ML stage (pitchvis_tpu_torch/models/pitch_mlp.py, ml_system.py,
the ML branch of derived_stages, ``ml_model=`` on both entry points, convert.py's
PitchMLP parameters) against the JAX package's on the same inputs, on the
CPU.

Budgets:
- the model on the same inputs and weights: outputs within atol 1e-5,
  logits within 1e-4 of the largest |logit| (the same products summed in
  another order; measured 1e-6 and 5e-7 when this was written);
- an entry point with ml_model against the JAX package's on the same audio: the
  histories (smoothed spectra) within the analysis budget of
  tests/test_torch_pipeline.py, atol 1e-3 dB, and ml_midi within atol 1e-4
  (measured some 1e-6: the history's 4e-5 dB through a small random model);
- an entry point against its own stage applied by hand: atol 1e-6, as the JAX
  package's tests/test_runtime.py holds it.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pitchvis_tpu.models.ml_system import MlState as JaxMlState
from pitchvis_tpu.models.ml_system import init_ml_state_batch as jax_init_ml_state_batch
from pitchvis_tpu.models.ml_system import ml_step as jax_ml_step
from pitchvis_tpu.models.ml_system import ml_step_batch as jax_ml_step_batch
from pitchvis_tpu.models.pipeline import StreamingPipeline as JaxPipeline
from pitchvis_tpu.models.pitch_mlp import PitchMLP as JaxPitchMLP
from pitchvis_tpu.models.pitch_mlp import infer_window as jax_infer_window
from pitchvis_tpu.runtime.server import StreamServer as JaxServer
from pitchvis_tpu_torch import CompactOutputs, ServeOutputs, StreamingPipeline, StreamServer
from pitchvis_tpu_torch.convert import (
    pipeline_state_from_numpy,
    pipeline_state_to_numpy,
    pitch_mlp_params_from_numpy,
    pitch_mlp_params_to_numpy,
    server_state_from_numpy,
    ANALYSIS_LEAVES,
)
from pitchvis_tpu_torch.core.config import TRAIN_VQT_PARAMETERS
from pitchvis_tpu_torch.models.analysis import AnalysisOutputs
from pitchvis_tpu_torch.models.ml_system import MlState, init_ml_state_batch, ml_step, ml_step_batch
from pitchvis_tpu_torch.models.pipeline import derived_stages
from pitchvis_tpu_torch.models.pitch_mlp import N_MIDI, PitchMLP, infer_window, pooled_width
from pitchvis_tpu_torch.runtime.checkpoint import restore_server, save_server_state

from conftest import SMALL_PARAMS
from torch_port_helpers import jax_native_lib, seeded_analysis_outputs, streams, to_port  # noqa: F401

OUT_ATOL = 1e-5
LOGIT_REL = 1e-4
HISTORY_ATOL = 1e-3
ENTRY_MIDI_ATOL = 1e-4
MANUAL_ATOL = 1e-6

NB = SMALL_PARAMS.n_buckets
T = 3
HOP = int(SMALL_PARAMS.sr / 60.0)
DT = HOP / SMALL_PARAMS.sr
TUNED_CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "artifacts", "train_demo_tuned", "ckpt")


def jax_model(input_bins, mlp_size, mlp_layers, seed=0):
    model = JaxPitchMLP(input_bins=input_bins, mlp_size=mlp_size, mlp_layers=mlp_layers)
    return model, model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1, input_bins)))


def port_model(jm, jp):
    """The port's PitchMLP with the flax model's hyperparameters and weights."""
    model = PitchMLP(input_bins=jm.input_bins, mlp_size=jm.mlp_size, mlp_layers=jm.mlp_layers,
                     dropout=jm.dropout, device="cpu")
    model.load_state_dict(pitch_mlp_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))
    return model


def jax_logits(jm, jp, x):
    """The flax model's last Dense outputs (before the sigmoid)."""
    _, inter = jm.apply(jp, jnp.asarray(x), capture_intermediates=True, mutable=["intermediates"])
    return np.asarray(inter["intermediates"][f"Dense_{jm.mlp_layers + 1}"]["__call__"][0])


def assert_model_close(jm, jp, tm, x, what=""):
    jo = np.asarray(jm.apply(jp, jnp.asarray(x)))
    with torch.no_grad():
        to = tm(torch.from_numpy(x)).numpy()
        tl = tm.logits(torch.from_numpy(x)).numpy()
    jl = jax_logits(jm, jp, x)
    np.testing.assert_allclose(to, jo, atol=OUT_ATOL, err_msg=f"outputs {what}")
    assert np.abs(tl - jl).max() <= LOGIT_REL * np.abs(jl).max(), f"logits {what}: {np.abs(tl - jl).max()}"
    return jo, to


SMALL_ML = (T * NB, 32, 2)


@pytest.fixture(scope="module")
def small_ml():
    """(flax model, its params, the port's model with the same weights) at
    SMALL_PARAMS' bins, T=3, mlp 32: the JAX runtime tests' model."""
    jm, jp = jax_model(*SMALL_ML)
    return jm, jp, port_model(jm, jp)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [(3 * 48, 64, 2), (5 * 252, 1024, 2)], ids=["small", "full"])
def test_forward_and_logits_match_flax(width):
    """At tests/test_ml.py's small width (n_buckets 48, T 3, mlp 64) and the
    trained checkpoints' full width (252 bins, T 5, mlp 1024, 2 layers), on
    seeded spectra-like inputs (0-40 dB) and in (B, L) and (B, 1, L)."""
    jm, jp = jax_model(*width)
    tm = port_model(jm, jp)
    x = np.random.default_rng(1).uniform(0.0, 40.0, (6, 1, width[0])).astype(np.float32)
    jo, _ = assert_model_close(jm, jp, tm, x)
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x[:, 0])).numpy(), jo, atol=OUT_ATOL)
    assert jo.shape == (6, N_MIDI)


def test_conv_pool_dims_match_reference():
    """train.py:76-79: O_conv = (L-5)/2 + 1, O_pool = (O_conv-2)/2 + 1,
    16*O_pool features into the first Linear, as flax's Dense_0."""
    L = 5 * 252
    o_conv = (L - 5) // 2 + 1
    o_pool = (o_conv - 2) // 2 + 1
    jm, jp = jax_model(L, 64, 1)
    tm = PitchMLP(input_bins=L, mlp_size=64, mlp_layers=1, device="cpu")
    assert pooled_width(L) == o_pool
    assert tm.dense[0].in_features == 16 * o_pool == jp["params"]["Dense_0"]["kernel"].shape[0]
    assert tuple(tm.conv.weight.shape) == (16, 1, 5)
    # an odd pooled width drops the last conv position, as flax's VALID pool
    for L in (3 * 48, 3 * 48 + 2, 101):
        jm, jp = jax_model(L, 16, 1)
        x = np.random.default_rng(L).uniform(0.0, 40.0, (2, 1, L)).astype(np.float32)
        assert_model_close(jm, jp, port_model(jm, jp), x, f"L={L}")


def test_input_width_must_match():
    tm = PitchMLP(input_bins=3 * 48, mlp_size=16, mlp_layers=1, device="cpu")
    with pytest.raises(ValueError, match="model configured for 144"):
        tm(torch.zeros(2, 1, 3 * 48 + 1))


def test_infer_window_matches_jax(small_ml):
    jm, jp, tm = small_ml
    frames = np.random.default_rng(2).uniform(0.0, 40.0, (3, T, NB)).astype(np.float32)
    want = np.asarray(jax_infer_window(jp, jm, jnp.asarray(frames)))
    with torch.no_grad():
        got = infer_window(None, tm, torch.from_numpy(frames)).numpy()
        # under an explicit state_dict, the module's own weights unused
        other = PitchMLP(input_bins=T * NB, mlp_size=32, mlp_layers=2, seed=5, device="cpu")
        got_params = infer_window(tm.state_dict(), other, torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, want, atol=OUT_ATOL)
    np.testing.assert_array_equal(got_params, got)


def test_train_flag_not_module_mode():
    """A module left in .train() mode serves deterministically: dropout
    applies only with train=True. With it, a hidden unit is kept with
    probability 1 - rate and scaled by 1/(1 - rate) (flax's Dropout)."""
    tm = PitchMLP(input_bins=3 * 48, mlp_size=256, mlp_layers=1, dropout=0.25, device="cpu").train()
    x = torch.from_numpy(np.random.default_rng(3).uniform(0.0, 40.0, (64, 3 * 48)).astype(np.float32))
    seen = []
    hook = tm.dense[-1].register_forward_pre_hook(lambda mod, args: seen.append(args[0].detach().clone()))
    with torch.no_grad():
        a, b = tm(x), tm(x)
        tm.eval()
        c = tm(x)
        tm.train()
        d = tm(x, train=True, generator=torch.Generator().manual_seed(0))
    hook.remove()
    assert torch.equal(a, b) and torch.equal(a, c) and not torch.equal(a, d)
    clean, dropped = seen[0], seen[3]
    live = clean > 0
    kept = dropped[live] != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.02  # 64 x 256 units: 4 sigma is 0.014
    torch.testing.assert_close(dropped[live][kept], clean[live][kept] / 0.75, rtol=1e-6, atol=0)
    assert (dropped[~live] == 0).all()


def test_init_is_flax_lecun_normal():
    """Kernels: std within 5% of 1/sqrt(fan_in) (lecun-normal, truncated at
    two standard deviations), no value beyond the truncation; biases zero.
    The same seed gives the same weights; another seed others."""
    tm = PitchMLP(device="cpu")
    layers = [(tm.conv, 5)] + [(d, d.in_features) for d in tm.dense]
    for layer, fan_in in layers:
        w = layer.weight.detach().double()
        target = 1.0 / np.sqrt(fan_in)
        assert abs(float(w.std()) / target - 1.0) < 0.05 or w.numel() < 100, (layer, float(w.std()), target)
        assert float(w.abs().max()) <= 2.0 * target / 0.87962566103423978 + 1e-7
        assert float(layer.bias.detach().abs().max()) == 0.0
    # the conv kernel has 80 values: its std is checked against flax's
    # draw statistics over many seeds instead
    stds = [float(PitchMLP(input_bins=144, mlp_size=8, mlp_layers=0, seed=s, device="cpu").conv.weight.detach().std())
            for s in range(40)]
    assert abs(np.mean(stds) * np.sqrt(5) - 1.0) < 0.05
    same = PitchMLP(device="cpu").state_dict()
    assert all(torch.equal(v, same[k]) for k, v in tm.state_dict().items())
    other = PitchMLP(seed=1, device="cpu").state_dict()
    assert not torch.equal(other["dense.0.weight"], same["dense.0.weight"])


# ---------------------------------------------------------------------------
# the committed trained checkpoint, on real spectra
# ---------------------------------------------------------------------------


def chord_spectra(n_hops=24):
    """Four streams of three-note chords (sines at MIDI keys) through the
    port's pipeline at TRAIN_VQT_PARAMETERS: (chords, (4, n_hops, 252)
    smoothed spectra)."""
    chords = [(57, 61, 64), (48, 52, 55), (62, 66, 69), (45, 57, 64)]
    p = TRAIN_VQT_PARAMETERS
    hop = int(p.sr / 60.0)
    t = np.arange(n_hops * hop) / p.sr
    sig = np.zeros((len(chords), n_hops * hop), np.float32)
    for b, keys in enumerate(chords):
        for k in keys:
            sig[b] += 0.1 * np.sin(2 * np.pi * 440.0 * 2.0 ** ((k - 69) / 12) * t)
    pipe = StreamingPipeline(len(chords), p, path="pallas", device="cpu")
    frames = [pipe.step(sig[:, h * hop : (h + 1) * hop], hop / p.sr).analysis.x_vqt_smoothed.numpy()
              for h in range(n_hops)]
    return chords, np.stack(frames, 1)


def test_trained_checkpoint_matches_jax():
    """artifacts/train_demo_tuned/ckpt read through the JAX package's
    load_checkpoint (orbax), carried over by convert.py, and run by both
    packages on the last T frames of real smoothed spectra: outputs and
    logits within the model budget, and the same top-3 MIDI keys, which
    are the chords' keys."""
    from pitchvis_tpu.train.train import TrainConfig, load_checkpoint

    with open(os.path.join(TUNED_CKPT, "train_meta.json")) as f:
        cfg = TrainConfig(**json.load(f)["config"])
    jp = load_checkpoint(TUNED_CKPT, cfg)
    jm = JaxPitchMLP(input_bins=cfg.t_window * cfg.n_buckets, mlp_size=cfg.mlp_size, mlp_layers=cfg.mlp_layers)
    tm = port_model(jm, jp)
    chords, spectra = chord_spectra()
    x = spectra[:, -cfg.t_window :].reshape(len(chords), 1, -1)
    jo, to = assert_model_close(jm, jp, tm, x, "trained checkpoint")
    top_j, top_t = np.argsort(-jo, 1)[:, :3], np.argsort(-to, 1)[:, :3]
    np.testing.assert_array_equal(np.sort(top_t, 1), np.sort(top_j, 1))
    np.testing.assert_array_equal(np.sort(top_t, 1), np.sort(np.array(chords), 1))


# ---------------------------------------------------------------------------
# convert.py and ml_system
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mlp_layers", [0, 1, 3])
def test_params_round_trip(mlp_layers):
    """flax tree -> state_dict -> flax tree is exact at any mlp_layers, and
    the port's model under the converted weights matches flax's."""
    jm, jp = jax_model(2 * 40, 24, mlp_layers, seed=mlp_layers)
    tree = jax.tree.map(np.asarray, jp)
    sd = pitch_mlp_params_from_numpy(tree, device="cpu")
    assert len(sd) == 2 * (mlp_layers + 3)
    back = pitch_mlp_params_to_numpy(sd)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    tm = PitchMLP(input_bins=80, mlp_size=24, mlp_layers=mlp_layers, device="cpu")
    tm.load_state_dict(sd)
    x = np.random.default_rng(4).uniform(0.0, 40.0, (3, 1, 80)).astype(np.float32)
    assert_model_close(jm, jp, tm, x)


def test_ml_step_batch_matches_jax(small_ml):
    """Six hops of seeded smoothed spectra through both packages' batched
    stage (B=4) and the per-stream ml_step: histories equal (a shift and an
    append), outputs within the model budget."""
    jm, jp, tm = small_ml
    rng = np.random.default_rng(5)
    js = jax_init_ml_state_batch(4, T, NB)
    ts = init_ml_state_batch(4, T, NB, device="cpu")
    one_j, one_t = JaxMlState.init(T, NB), MlState.init(T, NB, device="cpu")
    for _ in range(6):
        x = rng.uniform(0.0, 40.0, (4, NB)).astype(np.float32)
        js, jo = jax_ml_step_batch(jm, jp, js, jnp.asarray(x))
        with torch.no_grad():
            ts, to = ml_step_batch(tm, None, ts, torch.from_numpy(x))
            one_t, o1 = ml_step(tm, None, one_t, torch.from_numpy(x[0]))
        one_j, j1 = jax_ml_step(jm, jp, one_j, jnp.asarray(x[0]))
        np.testing.assert_array_equal(ts.history.numpy(), np.asarray(js.history))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=OUT_ATOL)
        np.testing.assert_array_equal(one_t.history.numpy(), np.asarray(one_j.history))
        np.testing.assert_allclose(o1.numpy(), np.asarray(j1), atol=OUT_ATOL)
    assert tuple(ts.history.shape) == (4, T, NB)


def test_derived_stages_ml_matches_jax(small_ml):
    """derived_stages' ML branch on the same analysis outputs, beside the
    LED stage; a model without its history raises."""
    from pitchvis_tpu.models.analysis import AnalysisOutputs as JaxAnalysisOutputs
    from pitchvis_tpu.models.pipeline import derived_stages as jax_derived_stages

    jm, jp, tm = small_ml
    a = seeded_analysis_outputs(3, NB, 7)
    dt = np.full(3, DT, np.float32)
    jml, jmidi, jled, _, _ = jax_derived_stages(
        SMALL_PARAMS.range, JaxAnalysisOutputs(**{k: jnp.asarray(v) for k, v in a.items()}), jnp.asarray(dt),
        ml_model=jm, ml_params=jp, ml_state=jax_init_ml_state_batch(3, T, NB), with_led=True)
    outputs = AnalysisOutputs(**{k: torch.from_numpy(v.copy()) for k, v in a.items()})
    with torch.no_grad():
        tml, tmidi, tled, _, _ = derived_stages(
            to_port(SMALL_PARAMS.range), outputs, torch.from_numpy(dt),
            ml_model=tm, ml_params=tm.state_dict(), ml_state=init_ml_state_batch(3, T, NB, device="cpu"),
            with_led=True)
    np.testing.assert_array_equal(tml.history.numpy(), np.asarray(jml.history))
    np.testing.assert_allclose(tmidi.numpy(), np.asarray(jmidi), atol=OUT_ATOL)
    assert tled.shape == (3, NB, 3)
    with pytest.raises(ValueError, match="ML history"):
        derived_stages(to_port(SMALL_PARAMS.range), outputs, torch.from_numpy(dt), ml_model=tm)


# ---------------------------------------------------------------------------
# the pipeline with ml_model against the JAX pipeline's
# ---------------------------------------------------------------------------


def tone_chunks(n_hops, seed=1):
    """(n_hops, 2, HOP) chunks of two streams of seeded sines and noise."""
    sig = streams(2, n_hops * HOP, SMALL_PARAMS.sr, seed=seed)
    return np.stack([sig[:, h * HOP : (h + 1) * HOP] for h in range(n_hops)])


def port_pipeline(tm, sd=None, **kw):
    return StreamingPipeline(2, to_port(SMALL_PARAMS), path="pallas", ml_model=tm, ml_params=sd, ml_t_window=T,
                             device="cpu", **kw)


def test_pipeline_with_ml_matches_jax(small_ml):
    """StreamingPipeline(ml_model=, ml_params=) against the JAX pipeline on
    the same audio (sines and noise, three streams) for 8 hops: the ML
    history within the analysis budget, ml_midi within the entry-point budget,
    and equal (MANUAL_ATOL) to ml_step_batch applied by hand to the port's
    own smoothed spectra. The pipeline serves its own frozen copy: training
    the caller's module afterwards changes nothing it serves."""
    jm, jp, tm = small_ml
    sd = pitch_mlp_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    caller = PitchMLP(input_bins=T * NB, mlp_size=32, mlp_layers=2, seed=9, device="cpu")
    jpipe = JaxPipeline(3, SMALL_PARAMS, path="pallas", ml_model=jm, ml_params=jp, ml_t_window=T)
    tpipe = StreamingPipeline(3, to_port(SMALL_PARAMS), path="pallas", ml_model=caller, ml_params=sd,
                              ml_t_window=T, device="cpu")
    assert tpipe.ml_model is not caller and not tpipe.ml_model.training
    assert not any(p.requires_grad for p in tpipe.ml_model.parameters())
    with torch.no_grad():
        caller.dense[0].weight.mul_(3.0)  # the caller goes on training its module
    manual = init_ml_state_batch(3, T, NB, device="cpu")
    sig = streams(3, 8 * HOP, SMALL_PARAMS.sr, seed=2)
    for h in range(8):
        chunk = sig[:, h * HOP : (h + 1) * HOP]
        jo = jpipe.step(chunk, DT)
        to = tpipe.step(chunk, DT)
        assert to.ml_midi.shape == (3, N_MIDI) and to.ml_midi.grad_fn is None
        np.testing.assert_allclose(tpipe.state.ml.history.numpy(), np.asarray(jpipe.state.ml.history),
                                   atol=HISTORY_ATOL)
        np.testing.assert_allclose(to.ml_midi.numpy(), np.asarray(jo.ml_midi), atol=ENTRY_MIDI_ATOL)
        with torch.no_grad():
            manual, want = ml_step_batch(tm, None, manual, to.analysis.x_vqt_smoothed)
        np.testing.assert_allclose(to.ml_midi.numpy(), want.numpy(), atol=MANUAL_ATOL)
    np.testing.assert_array_equal(tpipe.state.ml.history.numpy(), manual.history.numpy())


def test_fused_multi_hop(small_ml):
    """tests/test_stream.py::test_fused_multi_hop: step_multi carries the ML
    history hop by hop (mlp_layers=1, with the LED stage), as the JAX
    pipeline's scan does; and K=0 returns empty outputs of the right
    shapes."""
    jm, jp = jax_model(T * NB, 32, 1)
    tm = port_model(jm, jp)
    chunks = tone_chunks(4)
    multi = port_pipeline(tm, with_led=True)
    seq = port_pipeline(tm, with_led=True)
    m_out = multi.step_multi(chunks, DT)
    for i in range(4):
        s_out = seq.step(chunks[i], DT)
    np.testing.assert_allclose(m_out.ml_midi[-1].numpy(), s_out.ml_midi.numpy(), atol=MANUAL_ATOL)
    np.testing.assert_array_equal(m_out.led[-1].numpy(), s_out.led.numpy())
    jmulti = JaxPipeline(2, SMALL_PARAMS, ml_model=jm, ml_params=jp, ml_t_window=T, with_led=True, path="pallas")
    j_out = jmulti.step_multi(chunks, DT)
    np.testing.assert_allclose(m_out.ml_midi.numpy(), np.asarray(j_out.ml_midi), atol=ENTRY_MIDI_ATOL)
    empty = multi.step_multi(chunks[:0], DT)
    assert tuple(empty.ml_midi.shape) == (0, 2, N_MIDI)
    assert torch.equal(multi.state.ml.history, seq.state.ml.history)


def test_rebuild_rejects_layout_change_with_ml_model(small_ml):
    """tests/test_stream.py::test_rebuild_rejects_layout_change_with_ml_model:
    a range change with a model attached raises up front (the JAX message);
    a layout-preserving rebuild keeps the history and goes on serving. On
    the server too."""
    _, _, tm = small_ml
    pipe = port_pipeline(tm)
    pipe.step(tone_chunks(1)[0], DT)
    wider = dataclasses.replace(SMALL_PARAMS, range=dataclasses.replace(SMALL_PARAMS.range, octaves=3))
    with pytest.raises(ValueError, match="ML"):
        pipe.rebuild(to_port(wider))
    history = pipe.state.ml.history
    pipe.rebuild(to_port(dataclasses.replace(SMALL_PARAMS, quality=1.3)))
    assert pipe.state.ml.history is history
    out = pipe.step(np.zeros((2, 368), np.float32), 368 / SMALL_PARAMS.sr)
    assert out.ml_midi.shape == (2, N_MIDI)
    srv = StreamServer(2, to_port(SMALL_PARAMS), buffer_seconds=1.0, ml_model=tm, ml_t_window=T, device="cpu")
    try:
        with pytest.raises(ValueError, match="ML"):
            srv.rebuild(to_port(wider))
        srv.rebuild(to_port(dataclasses.replace(SMALL_PARAMS, quality=1.3)))
        assert srv.ml_state.history.shape == (2, T, NB)
    finally:
        srv.close()


def test_pipeline_reset_clears_the_ml_row(small_ml):
    _, _, tm = small_ml
    pipe = port_pipeline(tm)
    for c in tone_chunks(8):
        pipe.step(c, DT)
    before = pipe.state.ml.history.clone()
    assert before[0].abs().max() > 0
    pipe.reset_stream(0)
    assert pipe.state.ml.history[0].abs().max() == 0
    assert torch.equal(pipe.state.ml.history[1], before[1])


def test_pipeline_state_carries_the_history(small_ml):
    """convert.pipeline_state_to_numpy / _from_numpy carry ml_history: a
    pipeline resumed from it gives the same next hop."""
    _, _, tm = small_ml
    pipe = port_pipeline(tm)
    chunks = tone_chunks(4)
    for c in chunks[:3]:
        pipe.step(c, DT)
    arrays = pipeline_state_to_numpy(pipe.state)
    assert arrays["ml_history"].shape == (2, T, NB)
    resumed = port_pipeline(tm)
    resumed.state = pipeline_state_from_numpy(arrays, device="cpu")
    assert torch.equal(resumed.step(chunks[3], DT).ml_midi, pipe.step(chunks[3], DT).ml_midi)


# ---------------------------------------------------------------------------
# the server with ml_model against the JAX server's (tests/test_runtime.py)
# ---------------------------------------------------------------------------


def tone(n, phase=0.0):
    """tests/test_runtime.py's tone: a sine on bin 30, amplitude 0.1."""
    f = SMALL_PARAMS.range.min_freq * 2.0 ** (30.0 / SMALL_PARAMS.range.buckets_per_octave)
    return (0.1 * np.sin(2 * np.pi * f * (np.arange(n) / SMALL_PARAMS.sr + phase))).astype(np.float32)


def serve(srv, n_hops=3):
    """tests/test_runtime.py::_serve: 0.8 s of tone on stream 0, then n_hops
    hops of a further hop of it each, dt 1/60."""
    n0 = int(SMALL_PARAMS.sr * 0.8)
    srv.push(0, tone(n0))
    phase = n0 / SMALL_PARAMS.sr
    outs = []
    for _ in range(n_hops):
        srv.push(0, tone(HOP, phase))
        phase += HOP / SMALL_PARAMS.sr
        outs.append(srv.step(dt=1.0 / 60.0)[0])
    return outs


@pytest.mark.usefixtures("jax_native_lib")
def test_ml_history_carries_like_manual_stepping(small_ml):
    """tests/test_runtime.py::test_ml_history_carries_like_manual_stepping:
    the server's ML stage equals ml_step_batch applied hop by hop to its own
    smoothed spectra (atol 1e-6, the history exactly), and the JAX server's
    within the entry-point budget."""
    jm, jp, tm = small_ml
    srv = StreamServer(2, to_port(SMALL_PARAMS), buffer_seconds=1.0, ml_model=tm, ml_t_window=T, device="cpu")
    jsrv = JaxServer(2, SMALL_PARAMS, buffer_seconds=1.0, ml_model=jm, ml_params=jp, ml_t_window=T)
    try:
        outs, jouts = serve(srv), serve(jsrv)
        assert isinstance(outs[-1], ServeOutputs)
        ml = init_ml_state_batch(2, T, NB, device="cpu")
        with torch.no_grad():
            for out in outs:
                ml, midi = ml_step_batch(tm, None, ml, out.analysis.x_vqt_smoothed)
        np.testing.assert_allclose(outs[-1].ml_midi.numpy(), midi.numpy(), atol=MANUAL_ATOL)
        np.testing.assert_array_equal(srv.ml_state.history.numpy(), ml.history.numpy())
        np.testing.assert_allclose(srv.ml_state.history.numpy(), np.asarray(jsrv.ml_state.history),
                                   atol=HISTORY_ATOL)
        for out, jout in zip(outs, jouts):
            np.testing.assert_allclose(out.ml_midi.numpy(), np.asarray(jout.ml_midi), atol=ENTRY_MIDI_ATOL)
    finally:
        srv.close()
        jsrv.close()


def test_step_multi_with_stages_matches_single_hops(small_ml):
    """tests/test_runtime.py::test_step_multi_with_stages_matches_single_hops:
    the ML history and the ball fades advance per hop inside step_multi, and
    per_hop=True gives each hop's ML outputs."""
    _, _, tm = small_ml
    kw = dict(buffer_seconds=1.0, ml_model=tm, ml_t_window=T, with_viewer=True, with_led=True, device="cpu")
    single = StreamServer(2, to_port(SMALL_PARAMS), max_catchup_hops=0, **kw)
    multi = StreamServer(2, to_port(SMALL_PARAMS), **kw)
    per_hop = StreamServer(2, to_port(SMALL_PARAMS), **kw)
    try:
        n0 = int(SMALL_PARAMS.sr * 0.8)
        for srv in (single, multi, per_hop):
            srv.push(0, tone(n0))
            srv.step(dt=DT)
        phase = n0 / SMALL_PARAMS.sr
        singles = []
        for _ in range(3):
            c = tone(HOP, phase)
            phase += HOP / SMALL_PARAMS.sr
            for srv in (single, multi, per_hop):
                srv.push(0, c)
            singles.append(single.step(dt=DT)[0])
        out_m, _ = multi.step_multi(3)
        outs_p, _ = per_hop.step_multi(3, per_hop=True)
        np.testing.assert_allclose(out_m.ml_midi.numpy(), singles[-1].ml_midi.numpy(), atol=MANUAL_ATOL)
        np.testing.assert_allclose(out_m.viewer.balls.rgba.numpy(), singles[-1].viewer.balls.rgba.numpy(),
                                   atol=MANUAL_ATOL)
        np.testing.assert_array_equal(out_m.led.numpy(), singles[-1].led.numpy())
        for got, want in zip(outs_p, singles):
            np.testing.assert_allclose(got.ml_midi.numpy(), want.ml_midi.numpy(), atol=MANUAL_ATOL)
        assert torch.equal(multi.ml_state.history, single.ml_state.history)
    finally:
        for srv in (single, multi, per_hop):
            srv.close()


def test_reset_clears_ml_and_ball_rows(small_ml):
    """tests/test_runtime.py::test_reset_clears_ml_and_ball_rows."""
    from pitchvis_tpu_torch.models.viewer import BallState

    _, _, tm = small_ml
    srv = StreamServer(2, to_port(SMALL_PARAMS), buffer_seconds=1.0, ml_model=tm, ml_t_window=T,
                       with_viewer=True, device="cpu")
    try:
        serve(srv)
        assert srv.ml_state.history[0].abs().max() > 0
        srv.reset_stream(0)
        assert srv.ml_state.history[0].abs().max() == 0
        fresh = BallState.init(1, NB, device="cpu")
        assert torch.equal(srv.balls_state.scale[0], fresh.scale[0])
    finally:
        srv.close()


def test_fetch_led_advances_the_history(small_ml):
    """fetch="led" returns CompactOutputs without ml_midi, but the history
    advances as under fetch="full" with the LED stage."""
    _, _, tm = small_ml
    kw = dict(buffer_seconds=1.0, ml_model=tm, ml_t_window=T, device="cpu")
    compact = StreamServer(2, to_port(SMALL_PARAMS), fetch="led", **kw)
    full = StreamServer(2, to_port(SMALL_PARAMS), with_led=True, **kw)
    try:
        outs_c, outs_f = serve(compact), serve(full)
        assert isinstance(outs_c[-1], CompactOutputs) and not hasattr(outs_c[-1], "ml_midi")
        assert torch.equal(outs_c[-1].led, outs_f[-1].led)
        assert compact.ml_state.history[0].abs().max() > 0
        assert torch.equal(compact.ml_state.history, full.ml_state.history)
    finally:
        compact.close()
        full.close()


def test_restart_drill_with_fused_stages(small_ml, tmp_path):
    """tests/test_runtime.py::test_restart_drill_with_fused_stages: the ML
    history survives save_server_state -> restore_server; the restored
    server's next hop equals the uninterrupted one's (the port restores
    exactly: torch.equal, where the JAX test allows 1e-5); a checkpoint with
    a history demands the model back."""
    _, _, tm = small_ml
    kw = dict(buffer_seconds=1.0, ml_model=tm, ml_t_window=T, with_viewer=True, with_led=True, device="cpu")
    srv = StreamServer(2, to_port(SMALL_PARAMS), **kw)
    n0 = int(SMALL_PARAMS.sr * 0.8)
    srv.push(0, tone(n0))
    for _ in range(3):
        srv.step(dt=DT)
    save_server_state(str(tmp_path / "ck"), srv)
    chunk = tone(HOP, n0 / SMALL_PARAMS.sr)
    srv.push(0, chunk)
    want, _ = srv.step(dt=DT)
    srv.close()
    with pytest.raises(ValueError, match="ml_model"):
        restore_server(str(tmp_path / "ck"), device="cpu")
    srv2 = restore_server(str(tmp_path / "ck"), ml_model=tm, ml_params=tm.state_dict(), device="cpu")
    try:
        assert srv2.ingest == "delta" and srv2.with_led and srv2.with_viewer and srv2._ml_t == T
        srv2.push(0, chunk)
        got, _ = srv2.step(dt=DT)
        assert isinstance(got, ServeOutputs)
        assert torch.equal(got.ml_midi, want.ml_midi)
        assert torch.equal(got.viewer.balls.rgba, want.viewer.balls.rgba)
        assert torch.equal(got.analysis.peaks, want.analysis.peaks)
    finally:
        srv2.close()


@pytest.mark.usefixtures("jax_native_lib")
def test_jax_server_with_ml_carried_into_port(small_ml):
    """convert.server_state_from_numpy with the JAX server's ML history: the
    port server continues it, ml_midi within the entry-point budget; a history
    for a server without the ML stage (or none for one with it) raises."""
    jm, jp, tm = small_ml
    jsrv = JaxServer(2, SMALL_PARAMS, buffer_seconds=1.0, path="pallas", ml_model=jm, ml_params=jp, ml_t_window=T)
    srv = StreamServer(2, to_port(SMALL_PARAMS), buffer_seconds=1.0, path="pallas", ml_model=tm, ml_t_window=T,
                       device="cpu")
    try:
        serve(jsrv)
        analysis = {k: np.asarray(getattr(jsrv.analysis_state, k)) for k in ANALYSIS_LEAVES}
        with pytest.raises(ValueError, match="ml_history"):
            server_state_from_numpy(srv, jsrv.rings.export_state(), analysis, window=np.asarray(jsrv._window))
        server_state_from_numpy(srv, jsrv.rings.export_state(), analysis, window=np.asarray(jsrv._window),
                                ml_history=np.asarray(jsrv.ml_state.history))
        phase = int(SMALL_PARAMS.sr * 0.8) / SMALL_PARAMS.sr + 3 * HOP / SMALL_PARAMS.sr
        for _ in range(3):
            c = tone(HOP, phase)
            phase += HOP / SMALL_PARAMS.sr
            jsrv.push(0, c)
            srv.push(0, c)
            jo, _ = jsrv.step(dt=DT)
            to, _ = srv.step(dt=DT)
            np.testing.assert_allclose(to.ml_midi.numpy(), np.asarray(jo.ml_midi), atol=ENTRY_MIDI_ATOL)
    finally:
        jsrv.close()
        srv.close()
