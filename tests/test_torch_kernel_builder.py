"""The port's copy of kernel/builder.py builds the same VQT kernel as the
JAX package's, byte for byte, and keeps its disk cache apart."""

import os

import numpy as np
import pytest

from pitchvis_tpu.kernel import builder as jbuilder
from pitchvis_tpu_torch.kernel import builder as tbuilder

from conftest import SMALL_PARAMS
from torch_port_helpers import default_params, to_port


@pytest.mark.parametrize("which", ["small", "default"])
def test_weights_and_geometry_byte_identical(which):
    jp = SMALL_PARAMS if which == "small" else default_params()
    jk = jbuilder.get_kernel(jp)
    tk = tbuilder.get_kernel(to_port(jp))
    assert len(jk.window_groups) == len(tk.window_groups)
    assert jk.delay_secs == tk.delay_secs
    for jg, tg in zip(jk.window_groups, tk.window_groups):
        assert jg.window == tg.window
        assert jg.row_offset == tg.row_offset
        assert jg.n_filters == tg.n_filters
        assert jg.w_time.dtype == tg.w_time.dtype == np.float32
        assert jg.w_time.shape == tg.w_time.shape
        assert jg.w_time.tobytes() == tg.w_time.tobytes()
        assert jg.w_freq.tobytes() == tg.w_freq.tobytes()
        np.testing.assert_array_equal(jg.downscaling_factors, tg.downscaling_factors)


def test_cache_is_separate_and_round_trips(tmp_path, monkeypatch):
    monkeypatch.setenv("PITCHVIS_TPU_CACHE", str(tmp_path))
    assert os.path.realpath(tbuilder._cache_dir()) != os.path.realpath(jbuilder._cache_dir())
    tp = to_port(SMALL_PARAMS)
    built = tbuilder.build_kernel(tp)
    path = os.path.join(tbuilder._cache_dir(), "k.npz")
    tbuilder._save_kernel(built, path)
    loaded = tbuilder._load_kernel(tp, path)
    for a, b in zip(built.window_groups, loaded.window_groups):
        assert a.w_time.tobytes() == b.w_time.tobytes()
        assert a.window == b.window
    # nothing of the port lands where the JAX package reads its cache
    assert not any(f.startswith("vqt_kernel_") for f in os.listdir(jbuilder._cache_dir()))
