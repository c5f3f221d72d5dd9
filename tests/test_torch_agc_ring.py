"""The port's AGC and ring buffer against the JAX package, bit for bit.

XLA on the CPU contracts the AGC update into two fused multiply-adds; the
port's plain version computes exactly those (ops/agc.py::fma_f32) and its
CUDA kernel calls __fmaf_rn, so gains and samples agree exactly. The
kernel's ring and signal modes (one launch a push, one launch a batch of
signals) run only on the card; here NumPy emulations of their
decompositions are held to the plain versions, and the wrappers' checks run
before any library is loaded."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from pitchvis_tpu.ops.agc import agc_chunk as jax_agc_chunk
from pitchvis_tpu.ops.agc import agc_init as jax_agc_init
from pitchvis_tpu.train import device_dataset as jax_dd
from pitchvis_tpu.stream.ring import RingState as JRing
from pitchvis_tpu.stream.ring import ring_push as jax_ring_push
from pitchvis_tpu.stream.ring import ring_window as jax_ring_window
from pitchvis_tpu_torch.core.config import AgcParameters
from pitchvis_tpu_torch.ops import agc
from pitchvis_tpu_torch.ops.agc import agc_chunk, agc_init, agc_ring_push, agc_signal, agc_signal_plain, fma_f32
from pitchvis_tpu_torch.train.device_dataset import TRAIN_AGC, agc_signal_device
from pitchvis_tpu_torch.stream.ring import RingState, ring_push, ring_push_plain, ring_window
from pitchvis_tpu_torch.utils import nvcc

from torch_port_helpers import agc_signal_kernel_emulation, ring_push_kernel_emulation


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _chunk(rng, b, t):
    scale = rng.uniform(0.002, 1.0, (b, 1))
    return (rng.standard_normal((b, t)) * scale).astype(np.float32)


def test_agc_bitwise_over_hops():
    rng = np.random.default_rng(0)
    b, t = 16, 367
    jg = jnp.ones(b, jnp.float32)
    tg = torch.ones(b)
    for hop in range(6):
        ch = _chunk(rng, b, t)
        ch[3] *= 1e-6  # energy far below 1e-6: frozen
        jg, jout = jax_agc_chunk(jg, jnp.asarray(ch))
        tg, tout = agc_chunk(tg, torch.from_numpy(ch))
        np.testing.assert_array_equal(_bits(tg.numpy()), _bits(jg), err_msg=f"gain, hop {hop}")
        np.testing.assert_array_equal(_bits(tout.numpy()), _bits(jout), err_msg=f"samples, hop {hop}")
    assert float(tg[3]) == 1.0


def test_fma_f32_rounds_once():
    """A case where rounding a*b + c first to float64 lands exactly halfway
    between two float32 values: a single rounding (the hardware's fused
    multiply-add) goes down, a double rounding would go to even (up)."""
    a = torch.tensor([1 + 2.0**-18], dtype=torch.float32)
    b = torch.tensor([2.0**-24 * (1 - 2.0**-18)], dtype=torch.float32)
    c = torch.tensor([1 + 2.0**-23], dtype=torch.float32)
    naive = (a.double() * b.double() + c.double()).float()
    assert float(naive) == 1 + 2.0**-22
    assert float(fma_f32(a, b, c)) == 1 + 2.0**-23
    # and agrees with numpy's float64 path wherever that is exact
    rng = np.random.default_rng(1)
    x = rng.uniform(-2, 2, (3, 1000)).astype(np.float32)
    want = (x[0].astype(np.float64) * x[1] + x[2]).astype(np.float32)
    got = fma_f32(*(torch.from_numpy(v) for v in x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_ring_rejects_oversized_requests():
    r = RingState.init(2, 64, device="cpu")
    with pytest.raises(ValueError):
        ring_push(r, torch.zeros(2, 65))
    with pytest.raises(ValueError):
        ring_window(r, 65)


ROW_KINDS = ("clean", "nan", "inf", "-inf", "silent")


def _spoil(ch, row, kind):
    """Row ``row`` of chunk ``ch`` made one of ROW_KINDS (in place)."""
    t = ch.shape[1]
    if kind == "silent":
        ch[row] = 0.0
    elif kind != "clean" and t:
        ch[row, min(17, t - 1)] = {"nan": np.nan, "inf": np.inf, "-inf": -np.inf}[kind]


def _random_ring(rng, b, length):
    buf = (rng.standard_normal((b, length)) * 0.1).astype(np.float32)
    gain = rng.uniform(0.1, 2.1, b).astype(np.float32)
    return buf, gain


# (T, kind of row 2 in the second chunk); an id without a T is at the default hop
RING_CASES = [(t, kind) for t in (0, 1, 3, 367, 1000) for kind in ROW_KINDS]


@pytest.mark.parametrize(
    "t, bad", RING_CASES, ids=[kind if t == 367 else f"{kind}-t{t}" for t, kind in RING_CASES])
def test_ring_push_matches_jax(t, bad):
    """ring_push on the CPU (ring_push_plain) against the JAX package's
    ring_push over four hops from a random ring, with row 2 of the second
    chunk clean, carrying a NaN, +Inf or -Inf, or silent; B=5, L=1000."""
    rng = np.random.default_rng(3)
    b, length = 5, 1000
    buf, gain = _random_ring(rng, b, length)
    jr = JRing(buffer=jnp.asarray(buf), gain=jnp.asarray(gain))
    tr = RingState(buffer=torch.from_numpy(buf), gain=torch.from_numpy(gain))
    for hop in range(4):
        ch = _chunk(rng, b, t)
        if hop == 1:
            _spoil(ch, 2, bad)
        jr = jax_ring_push(jr, jnp.asarray(ch))
        tr = ring_push(tr, torch.from_numpy(ch))
        np.testing.assert_array_equal(_bits(tr.buffer.numpy()), _bits(jr.buffer), err_msg=f"buffer, hop {hop}")
        np.testing.assert_array_equal(_bits(tr.gain.numpy()), _bits(jr.gain), err_msg=f"gain, hop {hop}")
    np.testing.assert_array_equal(ring_window(tr, 512).numpy(), np.asarray(jax_ring_window(jr, 512)))
    # a spoilt chunk leaves its row as it was, so no non-finite sample gets in
    assert np.isfinite(tr.buffer.numpy()).all()


def _emulation_against_plain(length, t, src_offset=0):
    rng = np.random.default_rng(length + t)
    buf, gain = _random_ring(rng, 5, length)
    ch = _chunk(rng, 5, t)
    for row, kind in ((1, "nan"), (2, "inf"), (3, "silent")):
        _spoil(ch, row, kind)
    params = AgcParameters()
    k, inv_rms = agc._constants(params)
    want = ring_push_plain(RingState(buffer=torch.from_numpy(buf), gain=torch.from_numpy(gain)),
                           torch.from_numpy(ch), params)
    got_buf, got_gain = ring_push_kernel_emulation(buf, gain, ch, k, inv_rms, agc.SILENCE_ENERGY,
                                                   src_offset=src_offset)
    np.testing.assert_array_equal(_bits(got_buf), _bits(want.buffer.numpy()))
    np.testing.assert_array_equal(_bits(got_gain), _bits(want.gain.numpy()))
    # rows 1 and 2 were rejected, row 3 silent: its gain stayed
    np.testing.assert_array_equal(got_buf[1:3], buf[1:3])
    assert got_gain[3] == gain[3]


@pytest.mark.parametrize("t", [1, 4, 367, "L"])
@pytest.mark.parametrize("length", [1000, 1003, 32768])
def test_ring_kernel_emulation_matches_plain(length, t):
    """The kernel's decomposition (vote, float4 shift from misaligned
    loads with scalar head and tail, recurrence in lane 0 over staged tiles,
    tail append, rejected rows) gives ring_push_plain's bits."""
    _emulation_against_plain(length, length if t == "L" else t)


@pytest.mark.parametrize("src_offset", [1, 2, 3])
def test_ring_kernel_emulation_on_unaligned_buffer_rows(src_offset):
    """The same with the source buffer 4, 8 or 12 bytes past a 16-byte
    boundary, so that the shift's source alignment differs row by row."""
    _emulation_against_plain(1003, 367, src_offset)


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


WRAPPER_CASES = {
    "float64 chunk": (TypeError, lambda: (torch.zeros(3, 8), torch.ones(3), torch.zeros(3, 4, dtype=torch.float64))),
    "chunk not 2-D": (ValueError, lambda: (torch.zeros(3, 8), torch.ones(3), torch.zeros(12))),
    "gain not (B,)": (ValueError, lambda: (torch.zeros(3, 8), torch.ones(4), torch.zeros(3, 4))),
    "buffer rows": (ValueError, lambda: (torch.zeros(2, 8), torch.ones(3), torch.zeros(3, 4))),
    "T > L": (ValueError, lambda: (torch.zeros(3, 8), torch.ones(3), torch.zeros(3, 9))),
    "mismatched devices": (ValueError, lambda: (_meta(3, 8), torch.ones(3), torch.zeros(3, 4))),
    "CPU tensors": (ValueError, lambda: (torch.zeros(3, 8), torch.ones(3), torch.zeros(3, 4))),
}


@pytest.mark.parametrize("case", list(WRAPPER_CASES))
def test_ring_kernel_wrapper_checks_before_loading(case, monkeypatch):
    """agc_ring_push raises on what the kernel does not take before it
    builds or loads any library (here, where there is no nvcc)."""
    def no_library(name):
        raise AssertionError(f"library {name!r} loaded")

    monkeypatch.setattr(nvcc, "library", no_library)
    error, make = WRAPPER_CASES[case]
    buffer, gain, chunk = make()
    before = agc.launches
    with pytest.raises(error):
        agc_ring_push(buffer, gain, chunk)
    assert agc.launches == before


def test_agc_chunk_frozen_and_init_match_jax():
    """agc_chunk(frozen=) (the caller's flags instead of the energy's: a
    silent row unfrozen, a loud one frozen) and agc_init, bit for bit."""
    rng = np.random.default_rng(4)
    ch = _chunk(rng, 6, 200)
    ch[2] = 0.0
    frozen = np.array([True, False, False, True, False, True])
    g0 = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    p = AgcParameters(desired_output_rms=0.07, distortion_factor=0.001)
    jg, jout = jax_agc_chunk(jnp.asarray(g0), jnp.asarray(ch), p, frozen=jnp.asarray(frozen))
    tg, tout = agc_chunk(torch.from_numpy(g0), torch.from_numpy(ch), p, frozen=torch.from_numpy(frozen))
    np.testing.assert_array_equal(_bits(tg.numpy()), _bits(jg))
    np.testing.assert_array_equal(_bits(tout.numpy()), _bits(jout))
    np.testing.assert_array_equal(tg.numpy()[frozen], g0[frozen])
    assert tg[2] != g0[2]  # silent but not frozen: the gain moves
    init = agc_init(5, device="cpu")
    assert init.dtype == torch.float32 and init.device.type == "cpu"
    np.testing.assert_array_equal(init.numpy(), np.asarray(jax_agc_init(5)))


def _signal(rng, b, n_chunks, chunk, tail=0):
    """(B, C * chunk + tail) seeded audio with silent chunks in the middle
    and a chunk of energy just under the 1e-6 freeze."""
    x = _chunk(rng, b, n_chunks * chunk + tail)
    x[0, 2 * chunk : 4 * chunk] = 0.0
    if b > 1:
        seg = x[1, chunk : 2 * chunk].astype(np.float64)
        x[1, chunk : 2 * chunk] = (seg * np.sqrt(0.99e-6 / (seg**2).sum())).astype(np.float32)
    return x


def _jax_signal_scan(x, chunk):
    """The JAX package's dataset AGC, _render_agc_jit's scan over a given
    signal: (processed, gains after each chunk), compiled as there."""
    @jax.jit
    def run(sig):
        def step(gain, c):
            g, out = jax_agc_chunk(gain, c, jax_dd.TRAIN_AGC, frozen=None)
            return g, (out, g)

        _, (outs, gains) = jax.lax.scan(step, jnp.ones(1, jnp.float32), sig.reshape(-1, 1, chunk))
        return outs.reshape(-1), gains[:, 0]

    n = x.shape[0] // chunk * chunk
    return run(jnp.asarray(x[:n]))


def test_agc_signal_plain_matches_jax():
    """agc_signal_plain (the signal mode's plain version, a loop over chunks
    of agc_chunk_plain) against the JAX package's dataset AGC on each row, bit
    for bit, gains included: agc_signal_device, and the scan of
    _render_agc_jit; the ragged tail is dropped as there."""
    rng = np.random.default_rng(5)
    chunk = 160
    x = _signal(rng, 2, 9, chunk, tail=37)
    out, gains = agc_signal_plain(torch.from_numpy(x), chunk, TRAIN_AGC)
    assert out.shape == (2, 9 * chunk) and gains.shape == (2, 9)
    for row in range(2):
        jout, jgains = _jax_signal_scan(x[row], chunk)
        np.testing.assert_array_equal(_bits(out[row].numpy()), _bits(jout), err_msg=f"row {row}")
        np.testing.assert_array_equal(_bits(gains[row].numpy()), _bits(jgains), err_msg=f"row {row}")
        np.testing.assert_array_equal(_bits(out[row].numpy()),
                                      _bits(jax_dd.agc_signal_device(jnp.asarray(x[row]), chunk)))
        np.testing.assert_array_equal(agc_signal_device(torch.from_numpy(x[row]), chunk).numpy(), out[row].numpy())
    assert gains[0, 2] == gains[0, 1] and gains[0, 3] == gains[0, 1]  # silent chunks keep the gain
    assert gains[1, 1] == gains[1, 0]  # energy 0.99e-6: frozen


def test_agc_signal_kernel_emulation_matches_plain():
    """The signal mode's per-row decomposition (the producer warp's freeze
    flags from the lane-strided energy and butterfly, frozen chunks as x*g
    across lanes, lane 0's chain on the others with the gain carried)
    emulated in NumPy equals the plain version, silent and just-under-
    threshold chunks included."""
    rng = np.random.default_rng(6)
    chunk = 96
    x = _signal(rng, 3, 7, chunk, tail=5)
    k, inv_rms = agc._constants(TRAIN_AGC)
    want_out, want_gains = agc_signal_plain(torch.from_numpy(x), chunk, TRAIN_AGC)
    got_out, got_gains = agc_signal_kernel_emulation(x, chunk, k, inv_rms, agc.SILENCE_ENERGY)
    np.testing.assert_array_equal(_bits(got_out), _bits(want_out.numpy()))
    np.testing.assert_array_equal(_bits(got_gains), _bits(want_gains.numpy()))


def _scaled_to(seg, energy):
    """seg scaled so that its float64 energy is ``energy``."""
    return (seg.astype(np.float64) * np.sqrt(energy / (seg.astype(np.float64) ** 2).sum())).astype(np.float32)


def _padded(rows, n):
    """Rows of unequal lengths, zero-padded at the end to n samples."""
    out = np.zeros((len(rows), n), np.float32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


EMULATION_CHUNK = 96


def _emulation_case(case, rng):
    """(B, N) signal of one case of test_agc_signal_kernel_emulation_cases,
    chunks of EMULATION_CHUNK, and each row's own length (None: the row
    fills N)."""
    c = EMULATION_CHUNK
    if case == "padded rows":
        lengths = [7 * c + 5, 3 * c, 5 * c + 50, c]
        rows = [_chunk(rng, 1, n)[0] for n in lengths]
        rows[2][c : 2 * c] = 0.0  # a silent chunk inside a shorter row
        return _padded(rows, 8 * c), lengths
    if case == "all-silent row":
        x = _chunk(rng, 3, 5 * c)
        x[1] = 0.0
        return x, None
    if case == "one chunk":
        return _chunk(rng, 2, c), None
    if case == "energy either side of 1e-6":
        x = _chunk(rng, 2, 4 * c)
        for row, target in ((0, 0.99e-6), (1, 1.01e-6)):
            x[row, c : 2 * c] = _scaled_to(x[row, c : 2 * c], target)
            x[row, 3 * c :] = _scaled_to(x[row, 3 * c :], 2e-6 - target)
        return x, None
    if case == "tail shorter than a chunk":
        return _chunk(rng, 2, 4 * c + c - 1), None
    if case == "gain clamped at k":
        # quiet chunks raise the gain, a loud one after them clamps it
        x = (rng.standard_normal((2, 8 * c)) * 1e-3).astype(np.float32)
        x[:, 5 * c : 6 * c] *= 2000.0
        x[1, 7 * c + 3] = 40.0
        return x, None
    raise ValueError(case)


EMULATION_CASES = ["padded rows", "all-silent row", "one chunk", "energy either side of 1e-6",
                   "tail shorter than a chunk", "gain clamped at k"]


@pytest.mark.parametrize("tile", [1024, 40], ids=["tile1024", "tile40"])
@pytest.mark.parametrize("case", EMULATION_CASES)
def test_agc_signal_kernel_emulation_cases(case, tile):
    """The emulated signal mode bit for bit against agc_signal_plain, gains
    included (a case where the max clamps the update at k among them), with
    the kernel's tiles of 1024 and with tiles of 40 (each chunk of 96 then
    three pieces, the last of 16, so that the ring of four slots turns over
    inside a chunk and the chain's remainder loop runs). Zero-padded rows (one with a ragged tail, which its own run drops): each
    row's own chunks also equal the plain version run on the row alone, and
    the chunks of zeros after it freeze."""
    rng = np.random.default_rng(EMULATION_CASES.index(case) + 10)
    c = EMULATION_CHUNK
    x, lengths = _emulation_case(case, rng)
    k, inv_rms = agc._constants(TRAIN_AGC)
    want_out, want_gains = agc_signal_plain(torch.from_numpy(x), c, TRAIN_AGC)
    stats = {}
    got_out, got_gains = agc_signal_kernel_emulation(x, c, k, inv_rms, agc.SILENCE_ENERGY, tile=tile, stats=stats)
    np.testing.assert_array_equal(_bits(got_out), _bits(want_out.numpy()))
    np.testing.assert_array_equal(_bits(got_gains), _bits(want_gains.numpy()))
    if lengths is not None:
        for row, n in enumerate(lengths):
            own_out, own_gains = agc_signal_plain(torch.from_numpy(x[row : row + 1, :n]), c, TRAIN_AGC)
            m = n // c
            np.testing.assert_array_equal(_bits(got_out[row, : m * c]), _bits(own_out[0].numpy()))
            np.testing.assert_array_equal(_bits(got_gains[row, :m]), _bits(own_gains[0].numpy()))
            # the chunks of zeros after the row's last sample freeze
            z = -(-n // c)
            assert (got_gains[row, z:] == got_gains[row, z - 1]).all() and not got_out[row, z * c :].any()
    if case == "all-silent row":
        assert (got_gains[1] == 1.0).all() and not got_out[1].any()
    if case == "energy either side of 1e-6":
        assert got_gains[0, 1] == got_gains[0, 0] and got_gains[1, 1] != got_gains[1, 0]
    # the max clamps the update at k in that case alone
    assert (stats["clamped_steps"] > 0) == (case == "gain clamped at k")


@pytest.mark.parametrize("shape", [(0, 500), (3, 99), (2, 100)])
def test_agc_signal_plain_edges(shape):
    """The empty batch, fewer samples than a chunk (no chunk) and exactly one
    chunk."""
    x = torch.from_numpy(_chunk(np.random.default_rng(7), *shape)) if shape[0] else torch.zeros(shape)
    out, gains = agc_signal(x, 100, TRAIN_AGC)
    n_chunks = shape[1] // 100
    assert out.shape == (shape[0], n_chunks * 100) and gains.shape == (shape[0], n_chunks)
    if shape[0] and n_chunks:
        g, o = agc_chunk(torch.ones(shape[0]), x[:, :100], TRAIN_AGC)
        assert torch.equal(o, out) and torch.equal(g, gains[:, 0])


SIGNAL_CASES = {
    "float64 signal": (TypeError, lambda: _meta(2, 300).double()),
    "signal not 2-D": (ValueError, lambda: _meta(300)),
    "chunk < 1": (ValueError, lambda: _meta(2, 300)),
    "not a CUDA tensor": (ValueError, lambda: _meta(2, 300)),
}


@pytest.mark.parametrize("case", list(SIGNAL_CASES))
def test_signal_kernel_wrapper_checks_before_loading(case, monkeypatch):
    """agc_signal raises on what the kernel does not take before it builds
    or loads any library; a CPU tensor takes the plain version and counts no
    launch."""
    def no_library(name):
        raise AssertionError(f"library {name!r} loaded")

    monkeypatch.setattr(nvcc, "library", no_library)
    error, make = SIGNAL_CASES[case]
    before = agc.signal_launches
    with pytest.raises(error):
        agc_signal(make(), 0 if case == "chunk < 1" else 100, TRAIN_AGC)
    agc_signal(torch.zeros(2, 300), 100, TRAIN_AGC)
    assert agc.signal_launches == before
