"""Interactive live-tuning keymap for `demo --serve --loop --tune`.

The reference's defining debug UX is live keyboard parameter tuning: hold a
digit combo and press +/-//(reset) to adjust every analysis and VQT
parameter, with VQT changes rebuilding the kernel 2 s after the last change
(pitchvis_viewer/src/app/common.rs:847-1165). A terminal has no held-key
state, so this adapter maps the same combos onto discrete keystrokes:

* digits 1-9 toggle membership in the active combo (the "held" set; a third
  digit starts a fresh selection), `0`/Esc clears it;
* `+`/`=` and `-` step the selected parameter by its reference rate times
  ``step_seconds`` (terminal auto-repeat approximates holding);
* `/` resets the selected parameter, `r` resets everything (the viewer's
  reset combos), `s` toggles spectrogram mode, `q` quits.

The combo table is the reference's exactly (same fields, same rates, same
clamps — common.rs:908-1102); n_fft steps by powers of two per keypress
(common.rs:975-999, "just_pressed" semantics). VQT changes ride
``ParameterTuner``'s 2 s debounced rebuild handshake; analysis changes are
applied per frame in the reference; here they get the same 2 s debounce
before the server takes them (``take_retuned_analysis``).

`run_reader(fd, keytuner, ...)` is the raw-byte input loop the demo runs on
a thread over /dev/tty.

A copy of ``pitchvis_tpu/io/keytune.py``.
"""

from __future__ import annotations

import os
import time

from ..core.config import AnalysisParameters
from ..core.tuning import REBUILD_DEBOUNCE_SECS, ParameterTuner

# (kind, dotted field, rate per held-second) — rates from common.rs:908-1102
COMBOS: dict[frozenset, tuple[str, str, float]] = {
    frozenset({1, 2}): ("analysis", "peak_config.min_prominence", 5.0),
    frozenset({1, 3}): ("analysis", "peak_config.min_height", 2.5),
    frozenset({2, 3}): ("analysis", "harmonic_threshold", 0.1),
    frozenset({8, 9}): ("analysis", "spectrogram_length", 100.0),
    frozenset({1, 4}): ("vqt", "quality", 1.0),
    frozenset({2, 4}): ("vqt", "gamma", 5.0),
    frozenset({3, 5}): ("vqt", "sparsity_quantile", 0.01),
    frozenset({4, 6}): ("vqt", "n_fft", 0.0),  # power-of-two steps
    frozenset({1}): ("analysis", "bassline_peak_config.min_prominence", 5.0),
    frozenset({2}): ("analysis", "bassline_peak_config.min_height", 2.5),
    frozenset({3}): ("analysis", "highest_bassnote", 12.0),
    frozenset({4}): ("analysis", "vqt_smoothing_duration_base", 0.1),
    frozenset({5}): ("analysis", "vqt_smoothing_calmness_min", 0.5),
    frozenset({6}): ("analysis", "vqt_smoothing_calmness_max", 1.0),
    frozenset({7}): ("analysis", "note_calmness_smoothing_duration", 2.0),
    frozenset({8}): ("analysis", "scene_calmness_smoothing_duration", 1.0),
    frozenset({9}): ("analysis", "tuning_inaccuracy_smoothing_duration", 2.0),
}


class KeyTuner:
    """Keystroke -> ParameterTuner adapter (see module docstring).

    ``feed(ch)`` consumes one character and returns a human-readable status
    line (or None for ignored input). ``take_retuned_analysis()`` returns a
    settled analysis parameter set once its debounce elapses (the server
    recompile half of live tuning; the VQT half is
    ``tuner.take_rebuilt()``)."""

    def __init__(
        self,
        tuner: ParameterTuner,
        step_seconds: float = 0.25,
        clock=time.monotonic,
    ):
        self.tuner = tuner
        self.selected: frozenset = frozenset()
        self.spectrogram_mode = "vqt"  # toggled by `s` (common.rs:863-873)
        self.quit = False
        self._step = step_seconds
        self._clock = clock
        self._analysis_changed_at: float | None = None
        self._analysis_pending = False

    # -- input ------------------------------------------------------------
    def feed(self, ch: str) -> str | None:
        if ch in ("q", "\x03"):  # q / ctrl-c
            self.quit = True
            return "quit"
        if ch == "s":
            self.spectrogram_mode = (
                "peaks" if self.spectrogram_mode == "vqt" else "vqt"
            )
            return f"spectrogram mode: {self.spectrogram_mode}"
        if ch == "r":
            self.tuner.reset()
            self._mark_analysis_changed()
            return "reset ALL parameters to defaults"
        if ch in ("0", "\x1b"):  # 0 / Esc
            self.selected = frozenset()
            return "selection cleared"
        if ch.isdigit():
            d = int(ch)
            if d in self.selected:
                self.selected = self.selected - {d}
            elif len(self.selected) >= 2:
                self.selected = frozenset({d})
            else:
                self.selected = self.selected | {d}
            combo = COMBOS.get(self.selected)
            names = "+".join(str(x) for x in sorted(self.selected)) or "none"
            if combo is None:
                return f"digits [{names}]: no parameter bound"
            return f"digits [{names}]: {combo[1]} = {self._current(combo)}"
        if ch in ("+", "=", "-", "/"):
            combo = COMBOS.get(self.selected)
            if combo is None:
                return "select a digit combo first (e.g. 1 then 4 for Q)"
            return self._apply(combo, ch)
        return None

    # -- parameter application ---------------------------------------------
    def _current(self, combo):
        kind, field, _ = combo
        from ..core.tuning import _get_nested

        src = (
            (self.tuner._pending_vqt or self.tuner.vqt_params)
            if kind == "vqt"
            else self.tuner.analysis_params
        )
        return _get_nested(src, field)

    def _mark_analysis_changed(self):
        self._analysis_changed_at = self._clock()
        self._analysis_pending = True

    def _apply(self, combo, ch: str) -> str:
        kind, field, rate = combo
        reset = ch == "/"
        direction = -1.0 if ch == "-" else 1.0
        if kind == "vqt":
            if reset:
                default = getattr(self.tuner._defaults[0], field)
                new = self.tuner.adjust_vqt(field, value=default)
            elif field == "n_fft":
                cur = self._current(combo)
                new = self.tuner.adjust_vqt(
                    field, value=(cur * 2 if direction > 0 else cur // 2)
                )
            else:
                new = self.tuner.adjust_vqt(field, delta=direction * rate * self._step)
            return f"{field} = {new} (kernel rebuild in {REBUILD_DEBOUNCE_SECS:.0f}s)"
        if reset:
            from ..core.tuning import _get_nested

            default = _get_nested(self.tuner._defaults[1], field)
            new = self.tuner.adjust_analysis(field, value=default)
        else:
            new = self.tuner.adjust_analysis(field, delta=direction * rate * self._step)
        self._mark_analysis_changed()
        return f"{field} = {new}"

    # -- debounced hand-off -------------------------------------------------
    def take_retuned_analysis(self) -> AnalysisParameters | None:
        """The analysis half of the rebuild handshake: returns the settled
        AnalysisParameters once 2 s have passed since the last analysis
        keystroke (one swap per tuning burst), else None."""
        if not self._analysis_pending:
            return None
        if self._clock() - (self._analysis_changed_at or 0.0) < REBUILD_DEBOUNCE_SECS:
            return None
        self._analysis_pending = False
        return self.tuner.analysis_params


def run_reader(fd: int, keytuner: KeyTuner, on_status=None, stop=None) -> None:
    """Byte loop: read single characters from ``fd`` (a raw-mode tty or pty)
    into ``keytuner`` until quit/EOF/stop. ``on_status(line)`` reports each
    recognized keystroke's effect."""
    while not keytuner.quit and (stop is None or not stop.is_set()):
        try:
            data = os.read(fd, 1)
        except OSError:
            break
        if not data:
            break
        status = keytuner.feed(data.decode("latin-1"))
        if status is not None and on_status is not None:
            on_status(status)


def open_tty_raw():
    """Opens /dev/tty in cbreak mode for the live demo; returns
    (fd, restore_fn) or (None, None) when no controlling terminal exists
    (piped/CI runs)."""
    try:
        fd = os.open("/dev/tty", os.O_RDONLY)
    except OSError:
        return None, None
    try:
        import termios
        import tty

        old = termios.tcgetattr(fd)
        tty.setcbreak(fd)

        def restore():
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
            os.close(fd)

        return fd, restore
    except Exception:
        os.close(fd)
        return None, None
