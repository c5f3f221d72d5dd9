"""The port's AGC and ring buffer against the JAX package, bit for bit.

XLA on the CPU contracts the AGC update into two fused multiply-adds; the
port's plain version computes exactly those (ops/agc.py::fma_f32) and its
CUDA kernel calls __fmaf_rn, so gains and samples agree exactly. The
kernel's ring mode (one launch a push) runs only on the card; here a NumPy
emulation of its decomposition is held to the plain version, and its
wrapper's checks run before any library is loaded."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pitchvis_tpu.ops.agc import agc_chunk as jax_agc_chunk
from pitchvis_tpu.stream.ring import RingState as JRing
from pitchvis_tpu.stream.ring import ring_push as jax_ring_push
from pitchvis_tpu.stream.ring import ring_window as jax_ring_window
from pitchvis_tpu_torch.core.config import AgcParameters
from pitchvis_tpu_torch.ops import agc
from pitchvis_tpu_torch.ops.agc import agc_chunk, agc_ring_push, fma_f32
from pitchvis_tpu_torch.stream.ring import RingState, ring_push, ring_push_plain, ring_window
from pitchvis_tpu_torch.utils import nvcc

from torch_port_helpers import ring_push_kernel_emulation


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
