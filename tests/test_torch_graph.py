"""StreamingPipeline.step_multi's CUDA graph path (models/pipeline.py):
the key a captured call is looked up by, the eager path on the CPU, and
replayed calls held to the eager ``pipeline_step_multi`` by torch.equal.

The replay scenarios run twice: on the card with real graphs (marked
``card``, skipped without one), and on the CPU with a stand-in for the
capture that runs the captured function again at each replay, which
rehearses the static inputs, the state buffers, staging and the returned
copies. Nothing here imports JAX, so on a machine with a card the file
runs alone: ``python3 -m pytest --noconftest -m card
tests/test_torch_graph.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from pitchvis_tpu_torch.core.config import AgcParameters, AnalysisParameters, VqtParameters, VqtRange
from pitchvis_tpu_torch.models import pipeline
from pitchvis_tpu_torch.models.pipeline import StreamingPipeline, graph_key, pipeline_step_multi
from pitchvis_tpu_torch.models.pitch_mlp import DEFAULT_T, PitchMLP
from pitchvis_tpu_torch.utils.profiling import debug_report

PARAMS = VqtParameters(
    sr=22050.0, n_fft=8192, range=VqtRange(min_freq=110.0, octaves=4, buckets_per_octave=24),
    sparsity_quantile=0.999, quality=1.6, gamma=4.8 * 1.6,
)
B = 3
K = 3
HOP = 367
DT = HOP / PARAMS.sr


def _banks(n_banks=2, k=K, b=B, seed=0) -> list:
    """``n_banks`` (k, b, HOP) float32 banks of seeded sines and noise;
    stream 1 of bank 0 carries one NaN chunk and stream 2 of bank 1 one
    silent chunk."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_banks * k * HOP) / PARAMS.sr
    freqs = rng.uniform(110.0, 1500.0, (b, 3))
    sig = sum(np.sin(2 * np.pi * freqs[:, i, None] * t) / (i + 1) for i in range(3))
    sig = (0.3 * sig + 0.01 * rng.standard_normal(sig.shape)).astype(np.float32)
    banks = [np.stack([sig[:, (j * k + h) * HOP : (j * k + h + 1) * HOP] for h in range(k)]) for j in range(n_banks)]
    banks[0][1, 1, 7] = np.nan
    if n_banks > 1:
        banks[1][0, 2 % b] = 0.0
    return [torch.from_numpy(x) for x in banks]


def _leaves(tree, prefix="") -> dict:
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    for f in dataclasses.fields(tree):
        out.update(_leaves(getattr(tree, f.name), f"{prefix}.{f.name}"))
    return out


def _assert_equal(got, want, what):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys(), what
    for name in g:
        assert torch.equal(g[name], w[name]), f"{what}: {name} differs"


def _snapshot(tree):
    return pipeline._tree_map(torch.Tensor.clone, tree)


# ---- the key ----------------------------------------------------------------


def _key(pipe, chunks=None, dt=DT, state=None, **changes):
    """The key of a call of ``pipe`` (K hops of B zero samples, a scalar dt,
    its own state and settings unless changed), as step_multi computes it
    from the samples it puts on the device."""
    x = pipe._samples(torch.zeros(K, B, HOP) if chunks is None else chunks)
    kwargs = dict(arrays=pipe.arrays, analysis_params=pipe.analysis_params, agc_params=pipe.agc_params,
                  path=pipe.path, ml_model=pipe.ml_model, with_led=pipe.with_led, with_viewer=pipe.with_viewer)
    return graph_key(pipe.state if state is None else state, x.shape, **{**kwargs, **changes})


@pytest.fixture(scope="module")
def cpu_pipe():
    return StreamingPipeline(B, PARAMS, path="pallas", device="cpu")


def _rebuilt(pipe):
    other = StreamingPipeline(B, PARAMS, path="pallas", device="cpu")
    other.rebuild(dataclasses.replace(PARAMS, quality=PARAMS.quality * 1.1))
    return dict(arrays=other.arrays)


# each entry: the arguments of a call that must not replay the base call's
# graph (K hops of B streams, a scalar dt, the pipeline's own settings)
KEY_CHANGES = {
    "K": lambda pipe: dict(chunks=torch.zeros(K + 1, B, HOP)),
    "B": lambda pipe: dict(chunks=torch.zeros(K, B + 1, HOP),
                           state=pipeline.init_pipeline_state(B + 1, PARAMS, device="cpu")),
    "hop": lambda pipe: dict(chunks=torch.zeros(K, B, HOP + 1)),
    "with_led": lambda pipe: dict(with_led=True),
    "with_viewer": lambda pipe: dict(with_viewer=True),
    "ml_model": lambda pipe: dict(ml_model=PitchMLP(input_bins=DEFAULT_T * PARAMS.n_buckets, mlp_size=8,
                                                    mlp_layers=1, device="cpu")),
    "rebuild": _rebuilt,
    "path": lambda pipe: dict(path="time"),
    "analysis_params": lambda pipe: dict(analysis_params=AnalysisParameters(harmonic_threshold=0.5)),
    "agc_params": lambda pipe: dict(agc_params=AgcParameters(desired_output_rms=0.05)),
    "buffer_len": lambda pipe: dict(state=pipeline.init_pipeline_state(B, PARAMS, buffer_len=2 * PARAMS.n_fft,
                                                                       device="cpu")),
}

# each entry: the arguments of two calls that replay one graph (the samples
# go to the device as f32 and every form of dt into one (B,) input)
KEY_SAME = {
    "dtype": lambda pipe: (dict(), dict(chunks=torch.zeros(K, B, HOP, dtype=torch.float64))),
    "dt_tensor": lambda pipe: (dict(), dict(dt=torch.full((B,), DT))),
    "dt_array": lambda pipe: (dict(), dict(dt=np.full(B, DT))),
    "dt_value": lambda pipe: (dict(), dict(dt=2 * DT)),
    "dt_tensor_values": lambda pipe: (dict(dt=torch.full((B,), DT)), dict(dt=torch.arange(B, dtype=torch.float32))),
    "samples": lambda pipe: (dict(), dict(chunks=torch.ones(K, B, HOP))),
    "state_values": lambda pipe: (dict(), dict(state=pipeline._tree_map(lambda x: x + 1, pipe.state))),
}


@pytest.mark.parametrize("field", sorted(KEY_CHANGES))
def test_graph_key_changes_with(cpu_pipe, field):
    assert _key(cpu_pipe, **KEY_CHANGES[field](cpu_pipe)) != _key(cpu_pipe)


@pytest.mark.parametrize("field", sorted(KEY_SAME))
def test_graph_key_ignores(cpu_pipe, field):
    first, second = KEY_SAME[field](cpu_pipe)
    assert _key(cpu_pipe, **first) == _key(cpu_pipe, **second)


def test_cpu_step_multi_stays_eager():
    """On the CPU every call runs pipeline_step_multi itself: equal to it,
    and counted as an eager call only."""
    banks = _banks()
    pipe = StreamingPipeline(B, PARAMS, path="pallas", with_led=True, device="cpu")
    state = _snapshot(pipe.state)
    for call in range(3):
        bank = banks[call % 2]
        out = pipe.step_multi(bank, DT)
        state, want = pipeline_step_multi(pipe.arrays, state, bank, DT, **pipe._kwargs())
        _assert_equal(out, want, f"call {call}")
        _assert_equal(pipe.state, state, f"state after call {call}")
    pipe.step(banks[0][0], DT)
    assert pipe.graph_counts == {"graph_captures": 0, "graph_replays": 0, "graph_eager_calls": 4,
                                 "graph_state_stagings": 0, "graph_output_bytes": 0}
    assert pipe._graphs == {}


# ---- replayed calls against the eager path -----------------------------------

# variant -> its pipeline settings, its dt ("scalar": changing from call to
# call, "tensor": per stream), what happens before call 2, and whether the
# replays run under set_sync_debug_mode("error")
VARIANTS = {
    "led": dict(with_led=True),
    "viewer": dict(with_viewer=True),
    "ml": dict(ml=True, with_led=True),
    "dt_scalar_changing": dict(dt="scalar"),
    "dt_per_stream": dict(dt="tensor"),
    "reset_stream": dict(with_led=True, between="reset"),
    "rebuild": dict(with_led=True, between="rebuild"),
    "rebuild_new_layout": dict(with_viewer=True, between="rebuild_layout"),
    "restore": dict(with_led=True, between="restore"),
    "sync_debug": dict(with_led=True, sync_debug=True),
}


def _pipeline_pair(device, variant):
    settings = VARIANTS[variant]
    kw = dict(path="pallas", with_led=settings.get("with_led", False),
              with_viewer=settings.get("with_viewer", False), device=device)
    if settings.get("ml"):
        model = PitchMLP(input_bins=DEFAULT_T * PARAMS.n_buckets, mlp_size=32, mlp_layers=1, device="cpu")
        kw.update(ml_model=model, ml_params=model.state_dict())
    # the reference pipeline is stepped eagerly by hand; its rebuilds and
    # resets are the pipeline's own
    return StreamingPipeline(B, PARAMS, **kw), StreamingPipeline(B, PARAMS, **kw)


def _dt(variant, call, device):
    form = VARIANTS[variant].get("dt")
    if form == "scalar":
        return DT * (1.0 + 0.25 * call)
    if form == "tensor":
        return torch.linspace(0.5, 1.5, B, device=device) * DT * (1 + call)
    return DT


def _between(pipe, variant, call, saved):
    what = VARIANTS[variant].get("between")
    if what == "restore" and call == 2:  # the state a replay left, kept by reference
        saved["state"] = pipe.state
    elif what == "restore" and call == 4:  # and put back after two more calls
        pipe.state = saved["state"]
    elif what == "reset" and call == 2:
        pipe.reset_stream(1)
    elif what == "rebuild" and call == 2:
        pipe.rebuild(dataclasses.replace(PARAMS, quality=PARAMS.quality * 1.1))
    elif what == "rebuild_layout" and call == 2:
        pipe.rebuild(dataclasses.replace(PARAMS, range=VqtRange(min_freq=110.0, octaves=3, buckets_per_octave=24)))


def run_replays(device, variant, calls=5):
    """``calls`` calls of step_multi over two alternating banks, each held
    to pipeline_step_multi in outputs and state, and every call's returned
    outputs still as they were after the last. Returns graph_counts and
    the bytes of each call's outputs."""
    pipe, ref = _pipeline_pair(device, variant)
    banks = [b.to(device) for b in _banks()]
    launches = pipeline._launch_counts()
    kept, saved, ref_saved = [], {}, {}
    for call in range(calls):
        _between(pipe, variant, call, saved)
        _between(ref, variant, call, ref_saved)
        bank, dt = banks[call % 2], _dt(variant, call, device)
        if VARIANTS[variant].get("sync_debug") and call >= 1:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = pipe.step_multi(bank, dt)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        else:
            out = pipe.step_multi(bank, dt)
        ref.state, want = pipeline_step_multi(ref.arrays, ref.state, bank, dt, **ref._kwargs())
        _assert_equal(out, want, f"{variant}, call {call}")
        _assert_equal(pipe.state, ref.state, f"{variant}, state after call {call}")
        kept.append((out, _snapshot(out)))
    for call, (out, snap) in enumerate(kept):
        _assert_equal(out, snap, f"{variant}: the outputs of call {call} after the last call")
    # the kernels a hop launches (VQT, peaks, ring push, viewer stage; none
    # on the CPU), in both pipelines' calls: a capture counts none, a replay
    # all of its hops'
    viewer = int(VARIANTS[variant].get("with_viewer", False))
    per_hop = (1, 2, 1, viewer) if device == "cuda" else (0, 0, 0, 0)
    counted = tuple(a - b for a, b in zip(pipeline._launch_counts(), launches))
    assert counted == tuple(2 * calls * K * n for n in per_hop), f"{variant}: launches {counted}"
    return pipe.graph_counts, [pipeline._nbytes(out) for out, _ in kept]


def _expected(variant, sizes):
    """The graph counters after the calls whose outputs take ``sizes``
    bytes: the replays clone their outputs out of the graph."""
    calls = len(sizes)
    between = VARIANTS[variant].get("between")
    if between in ("rebuild", "rebuild_layout"):  # calls 0 and 2 capture
        return {"graph_captures": 2, "graph_replays": calls - 2, "graph_eager_calls": 2, "graph_state_stagings": 2,
                "graph_output_bytes": sum(sizes) - sizes[0] - sizes[2]}
    stagings = 2 if between in ("reset", "restore") else 1  # the first replay stages the eager call's state
    return {"graph_captures": 1, "graph_replays": calls - 1, "graph_eager_calls": 1, "graph_state_stagings": stagings,
            "graph_output_bytes": sum(sizes) - sizes[0]}


def _rerun_record(fn, device):
    """The capture's stand-in on the CPU: the function runs at once, and a
    replay runs it again and writes what it returns into the tensors of its
    first result, as a graph writes its outputs into the same memory."""
    first = fn()

    def replay():
        pipeline._tree_map(torch.Tensor.copy_, first, fn())

    return replay, first


@pytest.mark.parametrize("variant", [v for v in sorted(VARIANTS) if v != "sync_debug"])
def test_replay_logic_on_the_cpu(monkeypatch, variant):
    monkeypatch.setattr(pipeline, "_replays_on", lambda device: True)
    monkeypatch.setattr(pipeline, "_record", _rerun_record)
    counts, sizes = run_replays("cpu", variant)
    assert counts == _expected(variant, sizes)


def test_captures_count_no_launch_and_replays_count_theirs(monkeypatch):
    """The kernels' wrappers count a launch as they record it in a capture,
    and a replay runs no wrapper: the capture takes back what it counted,
    and each replay adds it (a stand-in capture that counts (1, 2, 1, 1))."""

    def counting_record(fn, device):
        pipeline._add_launch_counts((1, 2, 1, 1))
        return _rerun_record(fn, device)

    monkeypatch.setattr(pipeline, "_replays_on", lambda device: True)
    monkeypatch.setattr(pipeline, "_record", counting_record)
    pipe = StreamingPipeline(B, PARAMS, path="pallas", device="cpu")
    bank = _banks(n_banks=1)[0]
    before = pipeline._launch_counts()
    pipe.step_multi(bank, DT)
    assert pipeline._launch_counts() == before
    for _ in range(3):
        pipe.step_multi(bank, DT)
    assert tuple(a - b for a, b in zip(pipeline._launch_counts(), before)) == (3, 6, 3, 3)


def test_pipeline_keeps_the_most_recently_used_graphs(monkeypatch):
    monkeypatch.setattr(pipeline, "_replays_on", lambda device: True)
    monkeypatch.setattr(pipeline, "_record", _rerun_record)
    pipe = StreamingPipeline(B, PARAMS, path="pallas", device="cpu")
    bank = _banks(n_banks=1, k=pipeline.GRAPHS_KEPT + 1)[0]
    for k in range(1, pipeline.GRAPHS_KEPT + 1):
        pipe.step_multi(bank[:k], DT)
    replayed = pipe.step_multi(bank[:1], DT)  # a replay: K = 1 is now the newest
    pipe.step_multi(bank, DT)  # a new key: K = 2, the oldest, is dropped
    assert [key[1][0] for key in pipe._graphs] == [3, 4, 1, pipeline.GRAPHS_KEPT + 1]
    pipe.step_multi(bank[:2], DT)  # captured again
    assert pipe.graph_counts == {"graph_captures": pipeline.GRAPHS_KEPT + 2, "graph_replays": 1,
                                 "graph_eager_calls": pipeline.GRAPHS_KEPT + 2, "graph_state_stagings": 1,
                                 "graph_output_bytes": pipeline._nbytes(replayed)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs are captured and replayed on it")
    return "cuda"


@pytest.mark.card
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_replays_equal_the_eager_path_on_the_card(card, variant):
    counts, sizes = run_replays(card, variant)
    assert counts == _expected(variant, sizes)


def test_debug_report_gives_the_bytes_replays_clone(monkeypatch):
    """``graph_output_bytes`` stays 0 while calls run eagerly and grows by a
    call's output bytes with each replay; debug_report carries it."""
    bank = _banks(n_banks=1)[0]
    eager = StreamingPipeline(B, PARAMS, path="pallas", with_viewer=True, device="cpu")
    for _ in range(3):
        eager.step_multi(bank, DT)
    assert debug_report(eager)["graphs"]["graph_output_bytes"] == 0
    monkeypatch.setattr(pipeline, "_replays_on", lambda device: True)
    monkeypatch.setattr(pipeline, "_record", _rerun_record)
    pipe = StreamingPipeline(B, PARAMS, path="pallas", with_viewer=True, device="cpu")
    outs = [pipe.step_multi(bank, DT) for _ in range(3)]
    graphs = debug_report(pipe)["graphs"]
    call_bytes = sum(leaf.nbytes for leaf in _leaves(outs[1]).values())
    assert graphs["graph_replays"] == 2 and graphs["graph_output_bytes"] == 2 * call_bytes > 0
