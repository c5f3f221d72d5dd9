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
        device="cpu",
    )


class TestFusedPlainVsJaxPallas:
    def test_packing_equals_jax(self):
        jk = jax_get_kernel(SMALL_PARAMS)
        ja = JPallas.from_kernel(jk)
        ta = tpallas.PallasVqtArrays.from_kernel(get_kernel(to_port(SMALL_PARAMS)), device="cpu")
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
        ta = tpallas.PallasVqtArrays.from_kernel(get_kernel(to_port(SMALL_PARAMS)), device="cpu")
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


SMALL_GROUP_PARAMS = VqtParameters(
    sr=22050.0, n_fft=16384, quality=1.8, gamma=4.8 * 1.8,
    range=VqtRange(min_freq=110.0, octaves=6, buckets_per_octave=36),
)


def _ragged_arrays(dtype=torch.float32):
    """Group windows that are no multiple of any tile (the JAX package's
    TestRemainderKTile geometry), with seeded random weights."""
    rng = np.random.default_rng(1)
    sizes, nfs, tail = (1536, 1100, 700), (7, 130, 3), 1536
    weights, offsets, nf_pad = [], [], []
    for size, f in zip(sizes, nfs):
        fp = -(-f // 128) * 128
        w = np.zeros((size, 2 * fp), np.float32)
        w[:, :f] = rng.standard_normal((size, f)) * 0.01
        w[:, fp : fp + f] = rng.standard_normal((size, f)) * 0.01
        weights.append(torch.from_numpy(w).to(dtype))
        offsets.append(tail - size)
        nf_pad.append(fp)
    return tpallas.PallasVqtArrays(
        tuple(weights), tuple(offsets), sizes, nfs, tuple(nf_pad), tail, tail, sum(nfs))


def _layout_arrays(geometry, dtype):
    if geometry == "ragged":
        return _ragged_arrays(dtype)
    params = {"default": default_params(), "small_groups": SMALL_GROUP_PARAMS}[geometry]
    return tpallas.PallasVqtArrays.from_kernel(get_kernel(to_port(params)), dtype=dtype, device="cpu")


def _plain_power_f64(arrays, x):
    """vqt_power_pallas_plain's formula on the packed weights, summed in
    float64."""
    x = x[:, x.shape[1] - arrays.tail :].to(tvqt.precision_for(arrays.weights[0].dtype)).double()
    parts = []
    for w, off, size, f, fp in zip(
        arrays.weights, arrays.offsets, arrays.window_sizes, arrays.nf, arrays.nf_pad
    ):
        y = x[:, off : off + size] @ w.double()
        parts.append(y[:, :f] ** 2 + y[:, fp : fp + f] ** 2)
    return torch.cat(parts, dim=-1)


class TestKernelSideLayout:
    """The layout the CUDA kernel reads (aligned start, K padded to whole
    K-tiles, transposed blocks of 64 re | 64 im filters, tile table) against
    the packed weights it is derived from."""

    @pytest.mark.parametrize("b", [1, 5])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
    @pytest.mark.parametrize("geometry", ["default", "small_groups", "ragged"])
    def test_power_from_layout_equals_plain(self, geometry, dtype, b):
        """Summed in float64 the two differ in bf16 only by added zeros: rtol
        1e-6 (met with 1e-12 to spare). The f32 layout holds hi + lo, w to
        2^-22 of each weight, which shows where a bin's sum cancels: rtol 1e-6
        plus 1e-6 of the frame's maximum. In f32 arithmetic the CPU product
        blocks its sums by the operand shapes, which differ, so against the
        plain version itself the bound is that of two f32 sum orders: rtol
        1e-4 plus 1e-5 of the frame's maximum. A wrong offset, interleave or
        table row is an error of order 1 in either."""
        arrays = _layout_arrays(geometry, dtype)
        rng = np.random.default_rng(7)
        x = torch.from_numpy((rng.standard_normal((b, arrays.n_fft)) * 0.1).astype(np.float32))
        got64 = tpallas.vqt_power_kernel_layout_plain(arrays, x, acc_dtype=torch.float64)
        want64 = _plain_power_f64(arrays, x)
        assert got64.shape == (b, arrays.n_buckets)
        atol = 0.0 if dtype == torch.bfloat16 else 1e-6 * float(want64.max())
        np.testing.assert_allclose(got64.numpy(), want64.numpy(), rtol=1e-6, atol=atol)
        got = tpallas.vqt_power_kernel_layout_plain(arrays, x).numpy()
        want = tpallas.vqt_power_pallas_plain(arrays, x).numpy()
        scale = want.max(axis=1, keepdims=True)
        assert np.all(np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-5 * scale)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
    @pytest.mark.parametrize("geometry", ["default", "small_groups", "ragged"])
    def test_table_and_blocks(self, geometry, dtype):
        arrays = _layout_arrays(geometry, dtype)
        wk, table = arrays.kernel_weights, arrays.kernel_tiles.tolist()
        kt = 128 // wk.element_size()
        rows = 128 if dtype == torch.bfloat16 else 256  # f32: tf32 hi rows, then lo rows
        assert wk.dtype == dtype and tuple(wk.shape[1:]) == (rows, kt) and wk.is_contiguous()
        if dtype == torch.float32:
            assert int((wk.view(torch.int32) & 0x1FFF).abs().max()) == 0  # tf32 values
            wk = wk[:, :128] + wk[:, 128:]
        assert len(table) == sum(-(-f // 64) for f in arrays.nf)
        assert [r[1] for r in table] == sorted((r[1] for r in table), reverse=True)
        assert sum(r[1] for r in table) == wk.shape[0]
        assert sorted(c for r in table for c in range(r[3], r[3] + r[4])) == list(range(arrays.n_buckets))
        starts = {off - off % 8: (off, size) for off, size in zip(arrays.offsets, arrays.window_sizes)}
        for block0, n_k, x_col, _, n_valid, *_ in table:
            off, size = starts[x_col]
            assert x_col % 8 == 0 and 1 <= n_valid <= 64
            assert n_k * kt >= off - x_col + size > (n_k - 1) * kt
            k_major = wk[block0 : block0 + n_k].permute(1, 0, 2).reshape(128, n_k * kt).float()
            front, end = off - x_col, off - x_col + size
            assert float(k_major[:, :front].abs().max()) == 0.0 if front else True
            assert float(k_major[:, end:].abs().sum()) == 0.0
            assert float(k_major[n_valid:64].abs().sum()) == 0.0  # padded filters
            assert float(k_major[64 + n_valid :].abs().sum()) == 0.0

    def test_f32_split_restores_the_weights(self):
        """hi = tf32(w) and lo = tf32(w - hi): hi + lo is w to 2^-21 of its
        magnitude (2^-11 from each rounding), and hi alone only to 2^-11."""
        arrays = _layout_arrays("default", torch.float32)
        wk, table = arrays.kernel_weights, arrays.kernel_tiles.tolist()
        block0, n_k, x_col, _, n_valid, *_ = table[2]
        group = arrays.offsets.index(next(o for o in arrays.offsets if o - o % 8 == x_col))
        w, off, fp = arrays.weights[group], arrays.offsets[group], arrays.nf_pad[group]
        c0 = table[2][3] - sum(arrays.nf[:group])
        want = torch.cat([w[:, c0 : c0 + 64], w[:, fp + c0 : fp + c0 + 64]], dim=1).T
        blocks = wk[block0 : block0 + n_k]
        hi = blocks[:, :128].permute(1, 0, 2).reshape(128, -1)[:, off - x_col :][:, : w.shape[0]]
        lo = blocks[:, 128:].permute(1, 0, 2).reshape(128, -1)[:, off - x_col :][:, : w.shape[0]]
        assert torch.all((hi + lo - want).abs() <= 2.0**-21 * want.abs())
        assert torch.all((hi - want).abs() <= 2.0**-11 * want.abs())
        assert float((hi - want).abs().max()) > 0.0

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
    def test_kernel_frames_are_aligned_copies(self, dtype):
        """Frames whose base address or row stride is no multiple of 16
        bytes reach the kernel as a padded f32 copy with the same values (the
        bf16 mode rounds them in the kernel); a tensor that is already
        aligned is passed on as it is."""
        arrays = _ragged_arrays(dtype)
        rng = np.random.default_rng(8)
        wide = torch.from_numpy(rng.standard_normal((5, arrays.tail + 3)).astype(np.float32))
        for view in (wide[:, 1 : 1 + arrays.tail], wide[:, : arrays.tail], wide[:, 3:]):
            frames = tpallas._kernel_frames(arrays, view)
            assert frames.dtype == torch.float32 and tuple(frames.shape) == (5, arrays.tail)
            assert frames.stride(1) == 1
            assert frames.data_ptr() % 16 == 0
            assert frames.stride(0) * frames.element_size() % 16 == 0
            assert torch.equal(frames, view)
        aligned = torch.zeros((5, arrays.tail), dtype=torch.float32)
        if aligned.data_ptr() % 16 == 0:
            assert tpallas._kernel_frames(arrays, aligned).data_ptr() == aligned.data_ptr()


def _tf32(a):
    """float32 -> tf32 (10 mantissa bits), round to nearest even."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~np.uint64(0x1FFF)
    return bits.astype(np.uint32).view(np.float32)


def _emulated_kernel_power(arrays, x, route):
    """NumPy emulation of an f32 route's arithmetic on the kernel-side
    layout. "tf32x3" is csrc/vqt.cu's f32 mode: the weights' tf32 hi and lo
    halves as packed, the frames split the same way, the three products
    hi*hi + hi*lo + lo*hi of 8 samples summed exactly and added to an f32
    accumulator that truncates toward zero (a pessimistic stand-in for the
    tensor cores' accumulate). "ffma" is the route that was built first and
    not kept: each accumulator takes one fused multiply-add a sample, in
    ascending order over the padded K (the exact product is added in float64
    and rounded to f32 once)."""
    x = x[:, x.shape[1] - arrays.tail :]
    wk = arrays.kernel_weights.numpy()
    kt = wk.shape[2]
    out = np.zeros((x.shape[0], arrays.n_buckets), np.float32)
    for block0, n_k, x_col, out_col, n_valid, *_ in arrays.kernel_tiles.tolist():
        k = n_k * kt
        xs = np.zeros((x.shape[0], k), np.float32)
        seg = x[:, x_col : x_col + k]
        xs[:, : seg.shape[1]] = seg
        wh = wk[block0 : block0 + n_k, :128].transpose(0, 2, 1).reshape(k, 128)
        wl = wk[block0 : block0 + n_k, 128:].transpose(0, 2, 1).reshape(k, 128)
        acc = np.zeros((x.shape[0], 128), np.float32)
        if route == "ffma":
            xs64, w64 = xs.astype(np.float64), (wh + wl).astype(np.float64)
            for i in range(k):
                acc = (acc.astype(np.float64) + xs64[:, i, None] * w64[i][None]).astype(np.float32)
        else:
            xh = _tf32(xs)
            xl = _tf32(xs - xh)
            xh, xl, wh, wl = (a.astype(np.float64) for a in (xh, xl, wh, wl))
            for i in range(0, k, 8):
                sl = slice(i, i + 8)
                total = acc.astype(np.float64) + (xh[:, sl] @ wh[sl] + xh[:, sl] @ wl[sl] + xl[:, sl] @ wh[sl])
                acc = total.astype(np.float32)
                over = np.abs(acc.astype(np.float64)) > np.abs(total)
                acc[over] = np.nextafter(acc[over], np.float32(0))
        re, im = acc[:, :n_valid], acc[:, 64 : 64 + n_valid]
        out[:, out_col : out_col + n_valid] = re * re + im * im
    return out


class TestF32RouteArithmetic:
    @pytest.mark.parametrize("params", ["small", "default"])
    @pytest.mark.parametrize("route", ["ffma", "tf32x3"])
    def test_emulated_sums_within_3e4_of_oracle(self, route, params):
        """The f32 kernel's arithmetic (3xTF32) and that of the FFMA route it
        was weighed against, both emulated on the frames TestOracle uses:
        within 3e-4 dB of the float64 oracle. Both hold (about 1.5e-4 and
        1e-4 dB), so arithmetic did not decide the route: its time on the
        card did."""
        jparams = {"small": SMALL_PARAMS, "default": default_params()}[params]
        jk = jax_get_kernel(jparams)
        arrays = tpallas.PallasVqtArrays.from_kernel(get_kernel(to_port(jparams)), device="cpu")
        x = _frames(jparams, 4 if params == "small" else 2, 3)
        want = np.stack([vqt_frame_db_np(jk, xi) for xi in x])
        got = tvqt.power_to_db(torch.from_numpy(_emulated_kernel_power(arrays, x, route))).numpy()
        assert np.abs(got - want).max() <= 3e-4


class TestSmallWindowGroups:
    def test_group_smaller_than_k_tile(self):
        """The 512-sample-group configuration of the JAX package's
        TestSmallWindowGroups: the port's fused plain path against the JAX
        dense path, atol 2e-3 dB as there."""
        params = SMALL_GROUP_PARAMS
        jk = jax_get_kernel(params)
        assert min(g.w_time.shape[0] for g in jk.window_groups) < 1024
        rng = np.random.default_rng(0)
        x = (rng.standard_normal((4, params.n_fft)) * 0.1).astype(np.float32)
        want = np.asarray(jax_vqt_db_batch(JVqtArrays.from_kernel(jk), x))
        ta = tpallas.PallasVqtArrays.from_kernel(get_kernel(to_port(params)), device="cpu")
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
            weights, offsets, sizes, nfs, nf_pad, tail, tail, sum(nfs), device="cpu")
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
