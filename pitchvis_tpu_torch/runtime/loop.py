"""Self-driving serve loop: the server owns the dispatch cadence.

Port of ``pitchvis_tpu/runtime/loop.py``. ``StreamServer.serve(rate_hz=60)``
starts a background thread that paces hops on a monotonic deadline grid and
publishes each hop's (outputs, gains) for any number of consumers: the
server-side counterpart of the reference viewer's Update schedule invoking
``update_vqt_system`` every frame (pitchvis_viewer/src/app/common.rs:
2082-2118), so producers push() and consumers latest()/wait_next() without
anyone running a step loop of their own.

Lateness policy: a stalled host (GC pause, a busy neighbour) skips the
missed deadlines instead of bursting dispatches to catch up; the delta
ingest drains the accumulated audio through its bounded catch-up hops
inside the next step (runtime/server.py::_dispatch_delta).

Three publish modes:

* ``publish="latest"`` k=1 (default): one step() per grid slot, optionally
  pipelined one deep.
* ``publish="latest"`` k>1 (throughput): each dispatch runs k ingest-fed
  hops (``step_multi``) and publishes the newest.
* ``publish="per_hop"`` (cadenced): each dispatch runs k hops and returns
  every hop's outputs; the loop waits once per dispatch, publishes each hop
  on its own grid slot, and overlaps the previous window's publishes with
  the next window's work on the card.

The loop thread enters ``torch.cuda.device`` of the server's card and
enqueues everything on the default stream, so a ``reset_stream`` from the
control thread is ordered after the loop's hop. Over a mesh the server's
hop enters each slot's device itself, and a hop is complete when the event
recorded on each of the server's devices has completed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import torch

from ..parallel.sharding import Sharded


def _to_host(tree):
    """Every tensor of an output tree (a tensor, a tuple, a dataclass) as a
    NumPy array."""
    if isinstance(tree, (torch.Tensor, Sharded)):
        return tree.cpu().numpy()
    if isinstance(tree, tuple):
        return tuple(_to_host(t) for t in tree)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _to_host(getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    return tree


class ServeLoop:
    """Handle for a running serve loop (created by ``StreamServer.serve``).

    Consumer API (any thread):

    * ``latest()`` — newest published ``(seq, outputs, gains)`` or ``None``
      before the first hop completes. ``seq`` increments per published hop.
    * ``wait_next(seq=None, timeout=None)`` — block until a hop newer than
      ``seq`` (default: newest already published) lands; ``None`` on
      timeout or once the loop has stopped.
    * ``stop()`` — stop pacing, join the thread, publish the in-flight
      pipelined tail, and re-raise any error the loop thread hit. Safe to
      call from the ``on_outputs`` callback (the loop thread itself): it
      then only signals and returns; a later ``stop()``/``close()`` from any
      other thread completes the teardown. Idempotent.

    Also a context manager (``with server.serve() as loop:`` stops on exit;
    if the body is already raising, teardown never masks that exception — a
    loop error stays readable on ``.error``).

    ``sync`` is the publish policy: ``"element"`` waits on the CUDA events
    recorded after the hop's dispatch (one on each of the server's devices),
    so published outputs are complete on the card (on the CPU a step returns
    finished work and nothing waits);
    ``"host"`` publishes every tensor as a NumPy array; ``"none"`` the raw
    tensors, possibly still being computed.
    """

    def __init__(
        self,
        server,
        rate_hz: float,
        pipelined: bool,
        on_outputs=None,
        sync: str = "element",
        hops_per_dispatch: int = 1,
        publish: str = "latest",
    ):
        if rate_hz <= 0:
            raise ValueError("rate_hz must be positive")
        if sync not in ("element", "host", "none"):
            raise ValueError(f"sync must be 'element', 'host' or 'none', got {sync!r}")
        if hops_per_dispatch < 1:
            raise ValueError("hops_per_dispatch must be >= 1")
        if publish not in ("latest", "per_hop"):
            raise ValueError(f"publish must be 'latest' or 'per_hop', got {publish!r}")
        if (hops_per_dispatch > 1 or publish == "per_hop") and server.ingest != "delta":
            raise ValueError("hops_per_dispatch > 1 / publish='per_hop' require ingest='delta'")
        self._server = server
        self._device = server.device
        self._cards = [d for d in server.devices if d.type == "cuda"]
        self._k = int(hops_per_dispatch)
        # multi-hop modes dispatch k hops at a time; the deadline grid
        # spaces dispatches so the audio cadence still averages rate_hz
        self._period = self._k / float(rate_hz)
        self._per_hop = publish == "per_hop"
        self._pipelined = pipelined and self._k == 1 and not self._per_hop
        # the cadenced mode's one-deep overlap: window i-1's wait and paced
        # publishes run while window i computes on the card
        self._pipelined_multi = pipelined and self._per_hop
        self._sync = sync
        self._on_outputs = on_outputs
        self._cond = threading.Condition()
        self._latest = None  # (seq, outputs, gains)
        self._seq = 0
        self._done = False  # loop thread has exited (set under _cond)
        self._stop_evt = threading.Event()
        self._pending_done = None  # event of the pipelined hop in flight
        self.error: BaseException | None = None
        # hops = hops dispatched; published may lag by one when pipelined;
        # skipped_deadlines counts grid slots dropped while the host stalled;
        # catchup_windows counts the cadenced mode's double-width dispatches
        self.stats = {"hops": 0, "published": 0, "skipped_deadlines": 0, "catchup_windows": 0}
        self._thread = threading.Thread(target=self._run, name="pitchvis-serve-loop", daemon=True)
        self._thread.start()

    # -- loop thread -----------------------------------------------------------
    def _mark(self):
        """Events recorded after the dispatch just enqueued, one on each of
        the server's cards (None on the CPU, where a step returns finished
        work)."""
        if not self._cards:
            return None
        done = []
        for device in self._cards:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            done.append(event)
        return done

    def _synced(self, outputs, done):
        """Applies the publish sync policy; ``done`` holds the events recorded
        after the dispatch that computed ``outputs``."""
        if self._sync == "none":
            return outputs
        if self._sync == "host":
            return _to_host(outputs)
        for event in done or ():
            event.synchronize()
        return outputs

    def _publish(self, outputs, gains, done=None, synced: bool = False) -> None:
        """``synced=True`` skips the wait: the cadenced mode waits once per
        k-hop dispatch and then publishes complete slices."""
        if not synced:
            outputs = self._synced(outputs, done)
        with self._cond:
            self._seq += 1
            self.stats["published"] = self._seq
            self._latest = (self._seq, outputs, gains)
            self._cond.notify_all()
        if self._on_outputs is not None:
            self._on_outputs(*self._latest)

    def _run_latest(self) -> None:
        """One publish per dispatch: k=1 single hops, optionally pipelined;
        k>1 the throughput mode publishing the newest of each k-hop
        dispatch."""
        next_t = time.monotonic()
        while not self._stop_evt.is_set():
            if self._k > 1:
                result = self._server.step_multi(self._k)
                done = self._mark()
            else:
                result = self._server.step(pipelined=self._pipelined)
                done = self._mark()
                if self._pipelined:  # the result is the previous dispatch's
                    done, self._pending_done = self._pending_done, done
            self.stats["hops"] += self._k
            if result is not None:  # None = pipelined priming hop
                self._publish(*result, done=done)
            next_t += self._period
            now = time.monotonic()
            if now > next_t:
                skipped = int((now - next_t) / self._period)
                self.stats["skipped_deadlines"] += skipped
                next_t += skipped * self._period
            else:
                self._stop_evt.wait(next_t - now)

    def _run_cadenced(self) -> None:
        """The cadenced mode (``publish="per_hop"``): each dispatch is one
        k-hop ``step_multi(per_hop=True)`` whose per-hop outputs come back
        as a tuple; the loop waits once per dispatch and publishes each hop
        on its own 1/rate_hz grid slot. Consumers see hops k..2k-1 while
        hops 2k..3k-1 compute; the added latency is about one window
        (k/rate_hz)."""
        hop_period = self._period / self._k
        prev = None  # the previous window's (outputs_k, gains_k, done)

        def publish_window(outputs_k, gains_k, done, t_d):
            # one wait per dispatch, then each hop on its grid slot (t_d=None
            # publishes at once: catch-up bursts and the shutdown drain); a
            # stop() request cuts the waits short but still publishes the
            # computed tail, so no ingested hop is lost
            outputs_k = self._synced(outputs_k, done)
            for i in range(len(outputs_k)):
                if t_d is not None and not self._stop_evt.is_set():
                    wait = t_d + (i + 1) * hop_period - time.monotonic()
                    if wait > 0:
                        self._stop_evt.wait(wait)
                self._publish(outputs_k[i], gains_k[i], synced=True)

        body_exc = None
        behind = False
        try:
            next_t = time.monotonic()
            while not self._stop_evt.is_set():
                t_d = next_t
                # catch-up: a window that overran the grid leaves >= k hops
                # of backlog; the next dispatch doubles its width and its
                # publishes burst instead of pacing
                k_used = 2 * self._k if behind else self._k
                outputs_k, gains_k = self._server.step_multi(k_used, per_hop=True)
                cur = (outputs_k, gains_k, self._mark())
                self.stats["hops"] += k_used
                if behind:
                    self.stats["catchup_windows"] += 1
                grid = None if behind else t_d
                if not self._pipelined_multi:
                    publish_window(*cur, grid)
                elif prev is not None:
                    publish_window(*prev, grid)
                prev = cur
                next_t += self._period * (k_used // self._k)
                now = time.monotonic()
                if now > next_t:
                    skipped = int((now - next_t) / self._period)
                    self.stats["skipped_deadlines"] += skipped * self._k
                    next_t += skipped * self._period
                    behind = True
                else:
                    behind = False
                    self._stop_evt.wait(next_t - now)
        except BaseException as e:
            body_exc = e
            raise
        finally:
            # drain the in-flight window so its hops are published before
            # _done wakes any waiter; a drain failure must not mask the
            # body's own exception
            if self._pipelined_multi and prev is not None:
                try:
                    publish_window(*prev, None)
                except BaseException:
                    if body_exc is None:
                        raise

    def _run(self) -> None:
        device = torch.cuda.device(self._device) if self._device.type == "cuda" else contextlib.nullcontext()
        with device:
            try:
                if self._per_hop:
                    self._run_cadenced()
                else:
                    self._run_latest()
            except BaseException as e:  # surfaced via stop()/wait_next()
                self.error = e
            finally:
                # the loop thread drains its own pipeline slot on exit, before
                # declaring itself done: a waiter woken by _done must already
                # see the tail hop, and a hop left in _pending would leak into
                # the next serve loop's first publish
                try:
                    tail = self._server.flush()
                    if self.error is None and self._pipelined and tail is not None:
                        self._publish(*tail, done=self._pending_done)
                except BaseException as e:
                    if self.error is None:
                        self.error = e
                # _done is set before the notify so a woken waiter cannot
                # sleep again past a clean shutdown
                with self._cond:
                    self._done = True
                    self._cond.notify_all()

    # -- consumer API ----------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread.is_alive()

    def latest(self):
        with self._cond:
            return self._latest

    def wait_next(self, seq: int | None = None, timeout: float | None = None):
        """Blocks until a hop with sequence number > ``seq`` is published
        (``seq=None`` = newer than anything already published). Returns the
        ``(seq, outputs, gains)`` triple, or ``None`` if the timeout expires
        or the loop stops first. Raises if the loop thread failed."""
        with self._cond:
            target = self._seq if seq is None else seq
            self._cond.wait_for(
                lambda: self._seq > target or self.error is not None or self._done, timeout,
            )
            if self.error is not None:
                raise RuntimeError("serve loop failed") from self.error
            return self._latest if self._seq > target else None

    def _teardown(self, raise_error: bool):
        """Joins the loop thread and unwinds shared state; both shutdown
        paths (stop, context-manager exit) go through here. Idempotent."""
        self._thread.join()
        with self._server._state_lock:
            if self._server._serve_loop is self:
                self._server._serve_loop = None
        if self.error is not None and raise_error:
            raise RuntimeError("serve loop failed") from self.error
        return self.latest()

    def stop(self):
        """Stops pacing and joins the loop thread; the loop's exit path
        publishes the pipelined tail so no ingested hop is lost; re-raises a
        loop error. From the loop thread itself (``on_outputs``), only
        signals: the tail still publishes when the loop unwinds."""
        self._stop_evt.set()
        if threading.current_thread() is self._thread:
            return self.latest()
        return self._teardown(raise_error=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._stop_evt.set()
        # when the body is already raising, never mask its exception with a
        # loop error (it stays readable on .error); otherwise surface it
        self._teardown(raise_error=exc[0] is None)
        return False
