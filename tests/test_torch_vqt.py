"""The port's VQT (plain versions on the CPU) against the JAX package's
fused Pallas kernel (interpret mode), its dense path, the float64 oracle and
the committed goldens."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pitchvis_tpu.core.config import VqtParameters, VqtRange
from pitchvis_tpu.io.golden import GOLDEN_PARAMS, load
from pitchvis_tpu.kernel.builder import get_kernel as jax_get_kernel
from pitchvis_tpu.ops.vqt import VqtArrays as JVqtArrays
from pitchvis_tpu.ops.vqt import vqt_db_batch as jax_vqt_db_batch
from pitchvis_tpu.ops.vqt_pallas import PallasVqtArrays as JPallas
from pitchvis_tpu.ops.vqt_pallas import vqt_power_pallas as jax_vqt_power_pallas
from pitchvis_tpu.ops.vqt_ref import vqt_frame_db_np
from pitchvis_tpu_torch import convert
from pitchvis_tpu_torch.kernel.builder import get_kernel
from pitchvis_tpu_torch.ops import vqt as tvqt
from pitchvis_tpu_torch.ops import vqt_pallas as tpallas

from conftest import SMALL_PARAMS
from torch_port_helpers import default_params, to_port

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _frames(params, n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(params.n_fft) / params.sr
    f = 110.0 * 2.0 ** rng.uniform(0.0, 3.5, (n, 1))
    x = 0.3 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal((n, params.n_fft))
    return x.astype(np.float32)


def _port_pallas(jarrays):
    return convert.pallas_vqt_arrays_from_numpy(
        [np.asarray(w) for w in jarrays.weights], jarrays.offsets, jarrays.window_sizes,
        jarrays.nf, jarrays.nf_pad, jarrays.tail, jarrays.n_fft, jarrays.n_buckets,
    )


class TestFusedPlainVsJaxPallas:
    def test_packing_equals_jax(self):
        jk = jax_get_kernel(SMALL_PARAMS)
        ja = JPallas.from_kernel(jk)
        ta = tpallas.PallasVqtArrays.from_kernel(get_kernel(to_port(SMALL_PARAMS)))
        assert (ta.offsets, ta.window_sizes, ta.nf, ta.nf_pad, ta.tail) == (
            ja.offsets, ja.window_sizes, ja.nf, ja.nf_pad, ja.tail)
        for jw, tw in zip(ja.weights, ta.weights):
            np.testing.assert_array_equal(np.asarray(jw), tw.numpy())

    def test_f32_power(self):
        """f32: the same products summed in another order (XLA's dot vs
        torch's). rtol 1e-5 on power, plus an atol of 1e-6 of each frame's
        peak power for the bins far below it, where cancellation in the
        sums leaves an absolute, not a relative, error."""
        ja = JPallas.from_kernel(jax_get_kernel(SMALL_PARAMS))
        x = _frames(SMALL_PARAMS, 5, 0)
        want = np.asarray(jax_vqt_power_pallas(ja, jnp.asarray(x)))
        got = tpallas.vqt_power_pallas(_port_pallas(ja), torch.from_numpy(x)).numpy()
        scale = want.max(axis=1, keepdims=True)
        assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-6 * scale)

    def test_bf16_power(self):
        """bf16: both sides round the frames and weights to bf16 the same
        way (the weights are handed over bit for bit) and sum exact products
        in f32; rtol 1e-3 on power covers the sum order, with the same
        frame-relative atol as in f32."""
        ja = JPallas.from_kernel(jax_get_kernel(SMALL_PARAMS), dtype=jnp.bfloat16)
        ta = _port_pallas(ja)
        assert ta.weights[0].dtype == torch.bfloat16
        x = _frames(SMALL_PARAMS, 5, 1)
        want = np.asarray(jax_vqt_power_pallas(ja, jnp.asarray(x)))
        got = tpallas.vqt_power_pallas(ta, torch.from_numpy(x)).numpy()
        scale = want.max(axis=1, keepdims=True)
        assert np.all(np.abs(got - want) <= 1e-3 * np.abs(want) + 1e-6 * scale)

    def test_tail_only_input(self):
        ta = tpallas.PallasVqtArrays.from_kernel(get_kernel(to_port(SMALL_PARAMS)))
        x = torch.from_numpy(_frames(SMALL_PARAMS, 2, 2))
        full = tpallas.vqt_power_pallas(ta, x)
        tail = tpallas.vqt_power_pallas(ta, x[:, -ta.tail:].contiguous())
        torch.testing.assert_close(full, tail, rtol=0, atol=0)


class TestOracle:
    @pytest.mark.parametrize("path", ["pallas", "time"])
    def test_f32_db_within_3e4_of_oracle(self, path):
        """f32 products summed in f32 stay within 3e-4 dB of the float64
        oracle (the JAX package's contract for its f32 paths)."""
        jk = jax_get_kernel(SMALL_PARAMS)
        vqt = tvqt.Vqt(to_port(SMALL_PARAMS), path=path, device="cpu")
        x = _frames(SMALL_PARAMS, 4, 3)
        want = np.stack([vqt_frame_db_np(jk, xi) for xi in x])
        got = vqt.calculate_vqt_batch_in_db(x).numpy()
        assert np.abs(got - want).max() <= 3e-4

    def test_instant_matches_batch(self):
        vqt = tvqt.Vqt(to_port(SMALL_PARAMS), path="pallas", device="cpu")
        x = _frames(SMALL_PARAMS, 1, 4)
        np.testing.assert_array_equal(
            vqt.calculate_vqt_instant_in_db(x[0]), vqt.calculate_vqt_batch_in_db(x)[0].numpy()
        )


class TestSmallWindowGroups:
    def test_group_smaller_than_k_tile(self):
        """The 512-sample-group configuration of the JAX package's
        TestSmallWindowGroups: the port's fused plain path against the JAX
        dense path, atol 2e-3 dB as there."""
        params = VqtParameters(
            sr=22050.0, n_fft=16384, quality=1.8, gamma=4.8 * 1.8,
            range=VqtRange(min_freq=110.0, octaves=6, buckets_per_octave=36),
        )
        jk = jax_get_kernel(params)
        assert min(g.w_time.shape[0] for g in jk.window_groups) < 1024
        rng = np.random.default_rng(0)
        x = (rng.standard_normal((4, params.n_fft)) * 0.1).astype(np.float32)
        want = np.asarray(jax_vqt_db_batch(JVqtArrays.from_kernel(jk), x))
        ta = tpallas.PallasVqtArrays.from_kernel(get_kernel(to_port(params)))
        got = tpallas.vqt_db_pallas(ta, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=2e-3)

    def test_non_divisible_group_sizes(self):
        """Group windows that are no multiple of any tile (the JAX package's
        TestRemainderKTile geometry) against a float64 product; rtol 2e-4
        as there."""
        rng = np.random.default_rng(1)
        sizes, nfs, tail = (1536, 1100, 700), (7, 130, 3), 1536
        weights, offsets, nf_pad = [], [], []
        for size, f in zip(sizes, nfs):
            fp = -(-f // 128) * 128
            w = np.zeros((size, 2 * fp), np.float32)
            w[:, :f] = rng.standard_normal((size, f)) * 0.01
            w[:, fp : fp + f] = rng.standard_normal((size, f)) * 0.01
            weights.append(w)
            offsets.append(tail - size)
            nf_pad.append(fp)
        arrays = convert.pallas_vqt_arrays_from_numpy(
            weights, offsets, sizes, nfs, nf_pad, tail, tail, sum(nfs))
        x = (rng.standard_normal((5, tail)) * 0.3).astype(np.float32)
        want = []
        for w, off, size, f, fp in zip(weights, offsets, sizes, nfs, nf_pad):
            y = x[:, off : off + size].astype(np.float64) @ w.astype(np.float64)
            want.append(y[:, :f] ** 2 + y[:, fp : fp + f] ** 2)
        got = tpallas.vqt_power_pallas(arrays, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.concatenate(want, 1), rtol=2e-4, atol=1e-9)


class TestGoldens:
    @pytest.mark.parametrize("path", ["pallas", "time"])
    def test_reduced_goldens(self, path):
        g = load(os.path.join(GOLDEN_DIR, "vqt_golden.npz"))
        names = sorted(g)
        x = np.stack([g[n][0] for n in names])
        want = np.stack([g[n][1] for n in names])
        got = tvqt.Vqt(to_port(GOLDEN_PARAMS), path=path, device="cpu").calculate_vqt_batch_in_db(x)
        assert np.abs(got.numpy() - want).max() < 5e-4

    @pytest.mark.parametrize("path", ["pallas", "time"])
    def test_default_goldens(self, path):
        """tests/golden/vqt_golden_default.npz at full default parameters,
        <5e-4 dB as tests/test_golden.py holds the JAX f32 paths."""
        g = load(os.path.join(GOLDEN_DIR, "vqt_golden_default.npz"))
        names = sorted(g)
        x = np.stack([g[n][0] for n in names])
        want = np.stack([g[n][1] for n in names])
        got = tvqt.Vqt(to_port(default_params()), path=path, device="cpu").calculate_vqt_batch_in_db(x)
        assert np.abs(got.numpy() - want).max() < 5e-4

    def test_port_oracle_copy_reproduces_golden(self):
        from pitchvis_tpu_torch.ops.vqt_ref import vqt_frame_db_np as port_oracle

        g = load(os.path.join(GOLDEN_DIR, "vqt_golden_default.npz"))
        x, want = g["detuned_pair"]
        np.testing.assert_array_equal(port_oracle(get_kernel(to_port(default_params())), x), want)
