"""The port's AGC and ring buffer against the JAX package, bit for bit.

XLA on the CPU contracts the AGC update into two fused multiply-adds; the
port's plain version computes exactly those (ops/agc.py::fma_f32) and its
CUDA kernel calls __fmaf_rn, so gains and samples agree exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pitchvis_tpu.ops.agc import agc_chunk as jax_agc_chunk
from pitchvis_tpu.stream.ring import RingState as JRing
from pitchvis_tpu.stream.ring import ring_push as jax_ring_push
from pitchvis_tpu.stream.ring import ring_window as jax_ring_window
from pitchvis_tpu_torch.ops.agc import agc_chunk, fma_f32
from pitchvis_tpu_torch.stream.ring import RingState, ring_push, ring_window


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


@pytest.mark.parametrize("bad", ["nan", "inf", "silent"])
def test_ring_push_matches_jax(bad):
    rng = np.random.default_rng(2)
    b, length, t = 4, 2048, 367
    jr = JRing.init(b, length)
    tr = RingState.init(b, length, device="cpu")
    for hop in range(7):
        ch = _chunk(rng, b, t)
        if hop == 3:
            if bad == "silent":
                ch[1] = 0.0
            else:
                ch[1, 17] = np.nan if bad == "nan" else np.inf
        jr = jax_ring_push(jr, jnp.asarray(ch))
        tr = ring_push(tr, torch.from_numpy(ch))
        np.testing.assert_array_equal(_bits(tr.buffer.numpy()), _bits(jr.buffer))
        np.testing.assert_array_equal(_bits(tr.gain.numpy()), _bits(jr.gain))
    np.testing.assert_array_equal(ring_window(tr, 1024).numpy(), np.asarray(jax_ring_window(jr, 1024)))
    assert np.isfinite(tr.buffer.numpy()).all()


def test_ring_rejects_oversized_requests():
    r = RingState.init(2, 64, device="cpu")
    with pytest.raises(ValueError):
        ring_push(r, torch.zeros(2, 65))
    with pytest.raises(ValueError):
        ring_window(r, 65)
