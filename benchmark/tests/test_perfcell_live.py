"""The live generator's schedule and the mapping of published hops to the
chunks they carry."""

import threading

import numpy as np

from benchmark import live


class _Grid:
    """A stand-in for the recorder: the loop's grid started at t0."""

    def __init__(self, t0):
        self.t0 = t0
        self.started = threading.Event()
        self.started.set()


class _Server:
    def __init__(self):
        self.pushes = []

    def push_batch(self, block, ids):
        self.pushes.append((block.shape, ids.copy()))
        return np.ones(len(ids), bool)


class _Music:
    def chunks(self, ids, m, count):
        return np.full((len(ids), 10 * count), float(m), np.float32)


class _Clock:
    """A clock that a sleep moves, so that the schedule is exact."""

    def __init__(self, now):
        self.now = now

    def monotonic(self):
        return self.now

    def sleep(self, seconds):
        self.now += seconds


def test_due_times_are_phase_locked_to_the_grid(monkeypatch):
    period, phase = 0.02, 0.5
    clock = _Clock(100.0)
    monkeypatch.setattr(live, "time", clock)
    grid = _Grid(clock.now + 0.05)
    server, log, errors = _Server(), [], []
    live._producer(server, _Music(), 3, 7, 5, grid, period, phase, grid.t0 + 0.3, log, errors)
    assert not errors
    ns = [n for n, *_ in log]
    assert ns == list(range(1, len(ns) + 1)) and len(ns) >= 14
    for n, due, t_start, _ in log:
        # chunk n is due half a period before grid slot n, and pushed then
        assert due == grid.t0 + n * period - phase * period
        assert abs(t_start - due) < 1e-9
    # one push_batch of one hop of audio to the producer's whole range
    for (shape, ids), n in zip(server.pushes, ns):
        assert shape == (4, 10) and list(ids) == [3, 4, 5, 6]


def test_a_catch_up_hop_carries_the_chunk_a_frozen_hop_missed():
    b = 3
    adv = lambda *rows: np.array([i in rows for i in range(b)])  # noqa: E731
    advanced = [
        [adv()],  # dispatch 0: the window built from the prefill, nothing new
        [adv(0, 1, 2)],  # dispatch 1: chunk 1 of every stream
        [adv(0, 1), adv()],  # dispatch 2: stream 2 underran (frozen), no catch-up
        [adv(0, 1, 2), adv(2)],  # dispatch 3: chunk 3 of all, stream 2's chunk 2 in a catch-up hop
        [adv(0, 1, 2)],  # dispatch 4: chunk 4
    ]
    # the consumer held seqs 1, 2 and 4 (it took 4 over 3)
    held = [(1, 10.0), (2, 11.0), (4, 13.0)]
    ns = np.array([1, 2, 3, 4])
    due = np.array([9.0, 10.0, 11.0, 12.0])
    lat = live.latencies(advanced, held, ns, due, t_end=20.0)
    # stream 0: chunks 1..4 in dispatches 1..4, held at 10, 11, 13 (seq 3
    # with 4), 13
    assert lat[0].tolist() == [1.0, 1.0, 2.0, 1.0]
    # stream 2: chunk 2 waited for dispatch 3's catch-up hop, chunk 3
    # came in the same dispatch, chunk 4 in dispatch 4
    assert lat[2].tolist() == [1.0, 3.0, 2.0, 1.0]


def test_a_chunk_never_published_reads_the_end_of_the_run():
    advanced = [[np.array([False])], [np.array([True])], [np.array([False])]]
    lat = live.latencies(advanced, [(1, 5.0)], np.array([1, 2]), np.array([4.0, 4.5]), t_end=9.0)
    assert lat[0].tolist() == [1.0, 4.5]


def test_the_consume_outcome_follows_the_native_rule():
    hop, lag = 4, 10
    # the next hop, when a whole hop is there
    assert live._consume_outcome(20, 28, hop, lag) == (True, 20, 24)
    # an underrun: the stream stays put
    assert live._consume_outcome(20, 23, hop, lag) == (False, 20, 20)
    # a backlog beyond lag is skipped: the read starts lag before the head
    assert live._consume_outcome(20, 40, hop, lag) == (True, 30, 34)
    # a row matches the reference to rounding, and no other row does
    signal = np.arange(100, dtype=np.float64) + 1.0
    assert live._row_matches(signal[20:24] * (1 + 1e-6), signal[20:24])
    assert not live._row_matches(signal[24:28], signal[20:24])
