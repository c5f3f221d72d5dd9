"""The port's synth package (pitchvis_tpu_torch/synth/) against the JAX
package's: the same MIDI and SF2 bytes and parses, the NumPy SoundFont
engine against tests/golden/synth_golden.npz and the JAX package's engine,
the native engines (the port's own build of its copies of the C++ sources)
against the JAX package's, and the additive synthesizer's native voice loop
against its NumPy reference. The two packages run the same Python and C++
code on the same inputs, so the tolerances are zero unless stated."""

import dataclasses
import os

import numpy as np
import pytest

import pitchvis_tpu.synth.engine as j_engine
import pitchvis_tpu.synth.engine_native as j_native_engine
import pitchvis_tpu.synth.midi as j_midi
import pitchvis_tpu.synth.sf2 as j_sf2
import pitchvis_tpu.synth.synthesizer as j_synth
import pitchvis_tpu_torch.synth.engine as t_engine
import pitchvis_tpu_torch.synth.engine_native as t_native_engine
import pitchvis_tpu_torch.synth.midi as t_midi
import pitchvis_tpu_torch.synth.sf2 as t_sf2
import pitchvis_tpu_torch.synth.synthesizer as t_synth
from pitchvis_tpu_torch.runtime import native as t_native
from pitchvis_tpu_torch.utils import host_build

from tests.golden_synth import GOLDEN_PATH, NOTES, SECONDS, SR
from torch_port_helpers import jax_native_lib  # noqa: F401 (fixture)

MIDI_NOTES = [(0.0, 1.23, 0, 57, 110), (0.51, 0.97, 0, 64, 90), (1.83, 0.77, 1, 45, 100), (0.2, 0.5, 9, 38, 80)]


def _same_dataclass(a, b, what):
    """Two dataclass objects of the two packages with equal fields (arrays
    equal, nested dataclasses field by field)."""
    assert type(a).__name__ == type(b).__name__, what
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            _same_dataclass(x, y, f"{what}.{f.name}")
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f"{what}.{f.name}")
        elif isinstance(x, list) and x and dataclasses.is_dataclass(x[0]):
            assert len(x) == len(y), f"{what}.{f.name}"
            for i, (u, v) in enumerate(zip(x, y)):
                _same_dataclass(u, v, f"{what}.{f.name}[{i}]")
        else:
            assert x == y, f"{what}.{f.name}: {x!r} != {y!r}"


def test_midi_bytes_and_parse_equal(tmp_path):
    kw = dict(tempo_bpm=97.0, programs={0: 24, 1: 48})
    j_midi.write_midi(str(tmp_path / "j.mid"), MIDI_NOTES, **kw)
    t_midi.write_midi(str(tmp_path / "t.mid"), MIDI_NOTES, **kw)
    jb, tb = (tmp_path / "j.mid").read_bytes(), (tmp_path / "t.mid").read_bytes()
    assert jb == tb
    a, b = j_midi.load_midi(str(tmp_path / "j.mid")), t_midi.load_midi(str(tmp_path / "j.mid"))
    _same_dataclass(a, b, "MidiFile")
    assert a.get_length() == b.get_length()
    assert [dataclasses.astuple(m) for m in a.messages] == [dataclasses.astuple(m) for m in b.messages]


def _sample(n=400):
    t = np.arange(n)
    return 0.7 * np.sin(2 * np.pi * t / 50) + 0.2 * np.sin(4 * np.pi * t / 50)


def _multi_specs():
    rng = np.random.default_rng(5)
    return [
        {"program": p, "name": f"p{p}", "sample": (0.4 * rng.standard_normal(300)).astype(np.float32),
         "sample_rate": SR, "root_key": 60 + p % 12, "loop": bool(p % 2),
         "instrument_gens": [(j_sf2.GEN_ATTACK_VOL_ENV, -1200 + 10 * p), (j_sf2.GEN_SUSTAIN_VOL_ENV, 100 + p)]}
        for p in (0, 19, 48)
    ]


def test_sf2_bytes_and_structures_equal(tmp_path):
    """write_minimal_sf2 and write_multi_sf2 write the same bytes; the same
    file parses to the same presets, instruments, regions (their generator
    tables with the SF2 and GS defaults applied), samples and wave data."""
    j_sf2.write_minimal_sf2(str(tmp_path / "j1.sf2"), _sample(), SR, root_key=69, loop=True)
    t_sf2.write_minimal_sf2(str(tmp_path / "t1.sf2"), _sample(), SR, root_key=69, loop=True)
    j_sf2.write_multi_sf2(str(tmp_path / "j2.sf2"), _multi_specs(), name="multi")
    t_sf2.write_multi_sf2(str(tmp_path / "t2.sf2"), _multi_specs(), name="multi")
    for name in ("1", "2"):
        assert (tmp_path / f"j{name}.sf2").read_bytes() == (tmp_path / f"t{name}.sf2").read_bytes()
        path = str(tmp_path / f"j{name}.sf2")
        a, b = j_sf2.SoundFont.from_file(path), t_sf2.SoundFont.from_file(path)
        np.testing.assert_array_equal(a.wave_data, b.wave_data)
        assert len(a.presets) == len(b.presets) and len(a.instruments) == len(b.instruments)
        for kind in ("presets", "instruments"):
            for x, y in zip(getattr(a, kind), getattr(b, kind)):
                assert len(x.regions) == len(y.regions), kind
                for rx, ry in zip(x.regions, y.regions):
                    np.testing.assert_array_equal(rx.gs, ry.gs, err_msg=kind)
        for sx, sy in zip(a.sample_headers, b.sample_headers):
            assert dataclasses.astuple(sx) == dataclasses.astuple(sy)


def _golden_scene(mod_sf2, mod_midi, d):
    path = os.path.join(d, "golden.sf2")
    mod_sf2.write_minimal_sf2(path, _sample(), SR, root_key=69, loop=True)  # tests/golden_synth.py's font
    mpath = os.path.join(d, "golden.mid")
    mod_midi.write_midi(mpath, NOTES)
    return mod_sf2.SoundFont.from_file(path), mod_midi.load_midi(mpath)


def _render(engine_mod, font, midi, n):
    synth = engine_mod.Synthesizer(font, engine_mod.SynthesizerSettings(SR, enable_reverb_and_chorus=True))
    seq = engine_mod.MidiFileSequencer(synth)
    seq.play(midi)
    left, right = np.zeros(n, np.float32), np.zeros(n, np.float32)
    seq.render(left, right)
    return left, right


def test_numpy_engine_matches_golden_and_jax(tmp_path):
    """The port's NumPy engine renders the golden scenario within the JAX
    golden test's atol 1e-6 (tests/test_engine_golden.py), and equal to the
    JAX package's engine on the same font and MIDI (the same code)."""
    n = int(SECONDS * SR)
    font, midi = _golden_scene(t_sf2, t_midi, str(tmp_path))
    left, right = _render(t_engine, font, midi, n)
    with np.load(GOLDEN_PATH) as z:
        np.testing.assert_allclose(left, z["left"], atol=1e-6)
        np.testing.assert_allclose(right, z["right"], atol=1e-6)
        assert np.abs(z["left"]).max() > 0.01
    (tmp_path / "jax").mkdir()
    jfont, jmidi = _golden_scene(j_sf2, j_midi, str(tmp_path / "jax"))
    jl, jr = _render(j_engine, jfont, jmidi, n)
    np.testing.assert_array_equal(left, jl)
    np.testing.assert_array_equal(right, jr)


def test_native_engine_matches_jax_native(tmp_path, jax_native_lib):
    """The port's build of its copy of synth_engine.cpp against the JAX
    package's native library: the sequencer's stereo render and the whole
    training loop (pv_train_synthesize: AGC'd stream and label snapshots)
    equal."""
    n = int(SECONDS * SR)
    font, midi = _golden_scene(t_sf2, t_midi, str(tmp_path))
    jfont = j_sf2.SoundFont.from_file(str(tmp_path / "golden.sf2"))
    jmidi = j_midi.load_midi(str(tmp_path / "golden.mid"))
    out = {}
    for key, mod, f, m in (("port", t_native_engine, font, midi), ("jax", j_native_engine, jfont, jmidi)):
        seq = mod.NativeSequencer(mod.NativeSynthesizer(f, SR, enable_reverb_and_chorus=True))
        seq.play(m)
        left, right = np.zeros(n, np.float32), np.zeros(n, np.float32)
        seq.render(left, right)
        stream, labels = mod.synthesize_labeled(f, m, sample_rate=SR, chunk=441, step_chunks=3)
        out[key] = (left, right, stream, labels)
    for i in range(3):
        np.testing.assert_array_equal(out["port"][i], out["jax"][i])
    assert out["port"][3] == out["jax"][3] and len(out["port"][3]) > 0
    with np.load(GOLDEN_PATH) as z:  # the JAX engine's own budget against the golden
        assert np.abs(out["port"][0] - z["left"]).max() < 1e-4


def _additive(mod, midi, n, chunk=441, plain=False):
    synth = mod.Synthesizer(SR)
    if plain:
        synth.render = synth.render_plain
    seq = mod.MidiFileSequencer(synth)
    seq.play(midi)
    out, right = np.zeros(n, np.float32), np.zeros(chunk, np.float32)
    keys = []
    for i in range(0, n, chunk):
        seq.render(out[i : i + chunk], right)
        keys.append(sorted((v.key, round(v.current_mix_gain_left, 12)) for v in synth.get_active_voices()))
    return out, keys


def test_additive_synth_native_matches_jax_and_plain(tmp_path, jax_native_lib):
    """The additive synthesizer: the port's render (pv_synth_render in its
    native library) equals the JAX package's (the same loop in the JAX
    native library), voices and mix gains included; its NumPy reference
    (render_plain, float64 voices) is within 1e-6 of it."""
    path = str(tmp_path / "a.mid")
    j_midi.write_midi(path, MIDI_NOTES[:3], programs={0: 0, 1: 33})
    n = int(2.8 * SR) // 441 * 441
    port, port_keys = _additive(t_synth, t_midi.load_midi(path), n)
    jax, jax_keys = _additive(j_synth, j_midi.load_midi(path), n)
    np.testing.assert_array_equal(port, jax)
    assert port_keys == jax_keys
    plain, plain_keys = _additive(t_synth, t_midi.load_midi(path), n, plain=True)
    np.testing.assert_allclose(port, plain, atol=1e-6)
    assert [[k for k, _ in s] for s in plain_keys] == [[k for k, _ in s] for s in port_keys]
    assert np.abs(port).max() > 0.05


def test_timbres_and_key_to_freq_equal():
    assert t_synth._FAMILY_TIMBRES.keys() == j_synth._FAMILY_TIMBRES.keys()
    for k, v in j_synth._FAMILY_TIMBRES.items():
        _same_dataclass(v, t_synth._FAMILY_TIMBRES[k], f"timbre {k}")
    _same_dataclass(j_synth._DEFAULT_TIMBRE, t_synth._DEFAULT_TIMBRE, "default timbre")
    assert [t_synth.key_to_freq(k) for k in range(128)] == [j_synth.key_to_freq(k) for k in range(128)]


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No fallback: when the port's native libraries cannot be built, the
    SoundFont engine and the additive synthesizer's render raise instead of
    running another code path."""
    def broken(name):
        raise RuntimeError(f"g++ failed for native/{name}.cpp")

    monkeypatch.setattr(host_build, "library_path", broken)
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "_synth_lib", None)
    font, midi = _golden_scene(t_sf2, t_midi, str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        t_native_engine.NativeSynthesizer(font, SR)
    synth = t_synth.Synthesizer(SR)
    synth.note_on(0, 60, 100)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        synth.render(np.zeros(64, np.float32), np.zeros(64, np.float32))


def test_synth_render_checks_its_buffers():
    """runtime/native.py::synth_render raises on arrays the native loop
    cannot write through, before calling it."""
    ok = [np.zeros(2, np.float64) for _ in range(9)]
    with pytest.raises(ValueError, match="mix"):
        t_native.synth_render(np.zeros(8, np.float64), 22050.0, *ok, np.zeros((2, 3)))
    bad = list(ok)
    bad[1] = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="per-voice"):
        t_native.synth_render(np.zeros(8, np.float32), 22050.0, *bad, np.zeros((2, 3)))
