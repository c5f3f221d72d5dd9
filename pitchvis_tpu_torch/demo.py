"""Demo CLI: WAV / tone / live audio -> VQT -> analysis -> peaks / LED frames.

Port of ``pitchvis_tpu/demo.py``, the headless counterpart of the
reference's viewer/serial binaries:

    python -m pitchvis_tpu_torch.demo song.wav [--fps 30] [--led out.bin]
    python -m pitchvis_tpu_torch.demo --tone 440 --seconds 2
    arecord -f FLOAT_LE -r 48000 -c 1 | python -m pitchvis_tpu_torch.demo --serve --input-sr 48000

Prints a per-frame summary (detected notes with names and cents) and can
write the exact pitchvis_serial byte stream to a file/tty, or rasterize the
viewer to a GIF or a directory of PNGs. Runs on the card unless given
``--device cpu``; without CUDA the default exits with an error.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import fields

import numpy as np


def _first(tree):
    """Stream 0 of a batched output dataclass, keeping a stream axis of one
    (the port's render_frame takes a batch of one)."""
    return type(tree)(**{f.name: getattr(tree, f.name)[:1] for f in fields(tree)})


class _FrameRenderer:
    """Shared ``--render`` machinery: rasterizes stream 0 of each hop's
    outputs (offline pipeline or live server, models/render.py) and writes
    an animated GIF or a PNG directory at the end."""

    def __init__(self, args, params, device):
        from .models.render import DebugInputs, RenderConfig, make_scene, render_frame

        self._DebugInputs, self._render_frame = DebugInputs, render_frame
        w, h = (int(v) for v in args.render_size.lower().split("x"))
        self.cfg = RenderConfig(width=w, height=h)
        self.params = params
        self.statics = make_scene(self.cfg, params.range, device=device)  # statics up front
        self.frames: list = []
        self.out = args.render
        self.debug = bool(args.debug_overlay)
        # a live --serve session is unbounded; PNG-directory output flushes
        # incrementally (constant memory), GIF frames must stay in RAM until
        # the end so they are capped (640x360 at 30 fps is ~20 MB/s)
        self._is_gif = args.render.lower().endswith(".gif")
        self.max_gif_frames = int(getattr(args, "render_max_frames", 1800))
        self._written = 0
        self._capped = False
        self._sg = self._graph = None
        if self.debug:
            from .models.viewer import CalmnessGraphState, SpectrogramState

            self._sg = SpectrogramState.init(1, 200, params.range.n_buckets, device=device)
            self._graph = CalmnessGraphState.init(1, device=device)

    def add(self, analysis, viewer, t) -> None:
        """Rasterize stream 0 of one hop (batched analysis + ViewerOutputs)."""
        if self._is_gif and len(self.frames) >= self.max_gif_frames:
            if not self._capped:
                self._capped = True
                print(
                    f"--render: GIF capped at {self.max_gif_frames} frames "
                    "(--render-max-frames; use a directory output for "
                    "unbounded sessions)",
                    file=sys.stderr,
                )
            return
        debug = None
        if self.debug:
            self._sg = self._sg.push(viewer.spectrogram_row[:1])
            self._graph = self._graph.push(analysis.scene_calmness[:1])
            a = analysis
            debug = self._DebugInputs(
                x_vqt_smoothed=a.x_vqt_smoothed[:1],
                peaks=a.peaks[:1],
                peak_center=a.peak_center[:1],
                peak_size=a.peak_size[:1],
                calmness=a.calmness[:1],
                graph_values=self._graph.trace()[0],
                spectrogram=self._sg.image,
                spectrogram_write_index=self._sg.write_index,
                chroma=viewer.chroma[:1],
            )
        frame = self._render_frame(
            self.cfg, self.params.range, _first(viewer.balls), _first(viewer.bass),
            analysis.scene_calmness[:1], t, statics=self.statics, debug=debug,
        ).cpu().numpy()
        if self._is_gif:
            self.frames.append(frame)
        else:  # PNG directory: flush incrementally (constant memory)
            from .io.png import write_png

            if self._written == 0:
                os.makedirs(self.out, exist_ok=True)
            write_png(os.path.join(self.out, f"frame_{self._written:05d}.png"), frame)
            self._written += 1

    def write(self, fps: float) -> None:
        if self._is_gif:
            if not self.frames:
                print("no frames rendered", file=sys.stderr)
                return
            from PIL import Image

            imgs = [Image.fromarray(f) for f in self.frames]
            imgs[0].save(
                self.out, save_all=True, append_images=imgs[1:],
                duration=int(1000 / fps), loop=0,
            )
            print(
                f"wrote {len(self.frames)}-frame GIF to {self.out}",
                file=sys.stderr,
            )
        elif self._written == 0:
            print("no frames rendered", file=sys.stderr)
        else:
            print(
                f"wrote {self._written} PNGs to {self.out}",
                file=sys.stderr,
            )


def note_name(center_bins: float, buckets_per_octave: int, min_freq: float) -> str:
    from .ops.colors import PITCH_NAMES

    semis = center_bins * 12.0 / buckets_per_octave
    # min_freq=55 Hz is A1
    pitch_class = (round(semis) + 9) % 12
    octave = 1 + (round(semis) + 9) // 12
    cents = round((semis - round(semis)) * 100)
    return f"{PITCH_NAMES[pitch_class]}{octave}{cents:+d}ct"


def _notes(params, a) -> str:
    """Stream 0's detected notes, "name(size dB)" comma-separated."""
    peaks = a.peaks[0].cpu().numpy()
    centers = a.peak_center[0].cpu().numpy()
    sizes = a.peak_size[0].cpu().numpy()
    return ", ".join(
        note_name(centers[p], params.range.buckets_per_octave, params.range.min_freq)
        + f"({sizes[p]:.1f}dB)"
        for p in np.where(peaks)[0]
    )


def _write_led(led_out, params, a) -> None:
    from .io.led import led_frame

    led_out.write(led_frame(params.range, a.peaks[0], a.peak_center[0], a.peak_size[0]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("wav", nargs="?", help="input WAV file")
    parser.add_argument("--tone", type=float, help="generate a test tone (Hz) instead")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--fps", type=float, default=30.0)
    parser.add_argument("--led", help="write pitchvis_serial LED frames to this file")
    parser.add_argument("--frames", type=int, default=0, help="print at most N frame summaries")
    parser.add_argument(
        "--serve",
        action="store_true",
        help="serve live audio: read interleaved f32 mono samples from stdin "
        "(e.g. `arecord -f FLOAT_LE -r 22050 -c 1 | python -m pitchvis_tpu_torch.demo --serve`)",
    )
    parser.add_argument(
        "--alsa",
        nargs="?",
        const="default",
        metavar="DEVICE",
        help="with --serve: capture in-process from this ALSA device instead "
        "of stdin (requires libasound; device list: --list-devices)",
    )
    parser.add_argument(
        "--list-devices",
        action="store_true",
        help="list available capture drivers/devices and exit",
    )
    parser.add_argument(
        "--input-sr",
        type=int,
        default=None,
        help="producer sample rate for --serve (44100/48000 mic feeds are "
        "resampled to the pipeline rate in the native ingest path)",
    )
    parser.add_argument(
        "--pipelined",
        action="store_true",
        help="one-deep dispatch overlap for --serve (outputs lag ingest by "
        "one hop; the hop never waits on device compute)",
    )
    parser.add_argument(
        "--loop",
        action="store_true",
        help="with --serve: self-driving serve loop (server.serve()) — a "
        "producer thread feeds the ring while the serving runtime owns the "
        "hop cadence and this process consumes published hops at its own "
        "pace (requires the native runtime)",
    )
    parser.add_argument(
        "--tune",
        action="store_true",
        help="with --serve --loop: interactive live tuning from the "
        "terminal (the reference viewer's digit+/-/reset keymap, "
        "common.rs:847-1165): digits 1-9 select a parameter combo, +/- "
        "step it, / resets it, r resets all, s toggles spectrogram mode, "
        "q quits; VQT changes rebuild the kernel 2 s after the last "
        "keystroke (reads /dev/tty, so it works alongside stdin audio)",
    )
    parser.add_argument(
        "--hops-per-dispatch",
        type=int,
        default=1,
        metavar="K",
        help="with --loop: cadenced serving (publish='per_hop') — each "
        "dispatch runs K hops and the loop publishes every hop on its own "
        "1/fps grid slot (adds ~K/fps of display latency)",
    )
    parser.add_argument(
        "--path",
        default="time",
        choices=["time", "freq", "pallas"],
        help="VQT compute path (pallas = the fused hand-written kernel, the fastest)",
    )
    parser.add_argument(
        "--render",
        metavar="OUT",
        help="rasterize the viewer scene per frame (models/render.py): OUT "
        "ending in .gif writes an animated GIF (needs Pillow), otherwise OUT "
        "is a directory of frame_%%05d.png files; works offline (WAV/--tone) "
        "and with --serve (live viewer; needs the native runtime there)",
    )
    parser.add_argument(
        "--render-size",
        default="640x360",
        metavar="WxH",
        help="raster size for --render",
    )
    parser.add_argument(
        "--render-max-frames",
        type=int,
        default=1800,
        metavar="N",
        help="with --render OUT.gif: cap the in-RAM GIF at N frames "
        "(~20 MB/s at 640x360; directory output flushes PNGs incrementally "
        "and is unbounded)",
    )
    parser.add_argument(
        "--debug-overlay",
        action="store_true",
        help="with --render: draw the Debugging display mode panels "
        "(spectrum + peak circles, calmness histogram, scene-calmness "
        "graph, scrolling spectrogram, chroma boxes)",
    )
    parser.add_argument(
        "--fast",
        action="store_true",
        help="bf16 VQT weights (error budget: tests/test_bf16.py)",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="torch device of the pipeline, the server and the resampler "
        "(default: the card; pass cpu to run the kernels' plain versions)",
    )
    args = parser.parse_args(argv)

    if args.list_devices:
        from .io.capture import dump_input_devices

        dump_input_devices(file=sys.stdout)
        return 0

    from .core.device import resolve_device

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e} (on the command line: --device cpu)", file=sys.stderr)
        return 1

    if args.serve:
        return serve(args, device)

    from .core.config import SERIAL_VQT_PARAMETERS, VqtParameters
    from .io.wav import load_wav
    from .models.pipeline import StreamingPipeline
    from .ops.resample import resample

    params = SERIAL_VQT_PARAMETERS if args.led else VqtParameters()

    if args.tone:
        sr = int(params.sr)
        t = np.arange(int(sr * args.seconds)) / sr
        audio = (0.2 * np.sin(2 * np.pi * args.tone * t)).astype(np.float32)
    elif args.wav:
        audio, sr = load_wav(args.wav)
        if sr != int(params.sr):
            audio = resample(audio, sr, int(params.sr), device=device)[0]
    else:
        parser.error("give a WAV file or --tone")

    renderer = _FrameRenderer(args, params, device) if args.render else None

    pipe = StreamingPipeline(
        1, params, path=args.path, fast=args.fast, with_viewer=bool(args.render), device=device
    )
    hop = int(params.sr / args.fps)
    n_hops = len(audio) // hop
    led_out = open(args.led, "wb") if args.led else None

    printed = 0
    hop_s = []
    t_start = time.perf_counter()
    for i in range(n_hops):
        t_hop = time.perf_counter()
        chunk = audio[i * hop : (i + 1) * hop][None, :]
        out = pipe.step(chunk, hop / params.sr)
        if renderer is not None:
            renderer.add(out.analysis, out.viewer, i * hop / params.sr)

        if led_out is not None:
            _write_led(led_out, params, out.analysis)

        if args.frames == 0 or printed < args.frames:
            notes = _notes(params, out.analysis)
            calm = float(out.analysis.scene_calmness[0])
            tuning = float(out.analysis.tuning_inaccuracy[0])
            print(
                f"t={i * hop / params.sr:6.2f}s gain={float(out.gain[0]):5.2f} "
                f"calm={calm:.2f} tune={tuning:4.1f}ct  {notes}"
            )
            printed += 1
        hop_s.append(time.perf_counter() - t_hop)
    wall = time.perf_counter() - t_start

    if led_out is not None:
        led_out.close()
        print(f"wrote {n_hops} LED frames to {args.led}", file=sys.stderr)
    if renderer is not None:
        renderer.write(args.fps)
    if n_hops:
        audio_s = n_hops * hop / params.sr
        print(
            f"offline: {n_hops} hops on {device.type}, {audio_s:.3f} s of audio in {wall:.3f} s "
            f"({audio_s / wall:.2f}x realtime), median hop {1e3 * float(np.median(hop_s)):.3f} ms",
            file=sys.stderr,
        )
    return 0


def serve(args, device) -> int:
    """Live serving loop: native ring-bank ingest from stdin or ALSA,
    batched device analysis at --fps, per-frame note summaries (and LED
    frames with --led). The multi-stream production shape is
    runtime.server.StreamServer; this drives one stream end to end. Where
    the native runtime cannot be built (no g++), it falls back to the
    device-ring pipeline on the same device."""
    from .core.config import SERIAL_VQT_PARAMETERS, VqtParameters
    from .io.capture import RawPipeDriver
    from .runtime import native

    params = SERIAL_VQT_PARAMETERS if args.led else VqtParameters()
    sr = int(params.sr)
    input_sr = args.input_sr or sr
    hop = int(input_sr / args.fps)  # read cadence follows the producer rate

    server = None
    renderer = None
    # only the native library's own failure to build or load selects the
    # fallback: asked first, so that no other error (a device that is not
    # there, a kernel that fails) is taken for it
    if native.available():
        from .runtime.server import StreamServer

        server = StreamServer(
            1, params, path=args.path, fast=args.fast,
            with_viewer=bool(args.render), device=device,
        )

        def push(s, chunk):
            server.push(s, chunk, sr=input_sr)

        if args.pipelined:
            def step():
                return (server.step(pipelined=True) or (None,))[0]
        else:
            def step():
                return server.step()[0]
    else:  # no native runtime: device-ring pipeline fallback
        if args.loop:
            print("--loop needs the native runtime (g++)", file=sys.stderr)
            return 2
        if args.render:
            print("--render with --serve needs the native runtime (g++)", file=sys.stderr)
            return 2
        if input_sr != sr:
            print("--input-sr needs the native runtime (g++)", file=sys.stderr)
            return 2
        print(
            f"native runtime unavailable: serving through the device ring pipeline on {device}",
            file=sys.stderr,
        )
        from .models.pipeline import StreamingPipeline

        pipe = StreamingPipeline(1, params, path=args.path, fast=args.fast, device=device)
        buf = []

        def push(_s, chunk):
            buf.append(np.asarray(chunk, np.float32))

        def step():
            data = np.concatenate(buf) if buf else np.zeros(hop, np.float32)
            buf.clear()
            n = max(len(data) // hop, 1) * hop
            data = np.resize(data, n)
            out = None
            for i in range(0, n, hop):
                out = pipe.step(data[i : i + hop][None, :], hop / sr)
            return out.analysis

    if args.render and server is not None:
        # only after the native check: make_scene precomputes the raster
        # statics, pointless work if the run is about to be rejected above
        renderer = _FrameRenderer(args, params, device)

    if args.alsa:
        # in-process capture; ALSA soft-resamples any hardware rate to
        # input_sr device-side, so --input-sr is only needed if you WANT
        # the native ingest resampler in the loop
        from .io.alsa import AlsaCaptureDriver

        driver = AlsaCaptureDriver(args.alsa, sr=input_sr, chunk_size=hop)
        source = f"alsa:{args.alsa}"
    else:
        driver = RawPipeDriver(sys.stdin.buffer, input_sr, hop)
        source = "stdin"
    led_out = open(args.led, "wb") if args.led else None
    print(
        f"serving {source}: {input_sr} Hz in -> {sr} Hz, hop {hop} "
        f"({args.fps:.0f} fps){', pipelined' if args.pipelined else ''} on {device}; "
        "ctrl-c to stop",
        file=sys.stderr,
    )
    # stdin serving ends at pipe EOF; a live ALSA device never EOFs, so
    # --seconds bounds it (<= 0: run until ctrl-c)
    max_hops = int(args.seconds * args.fps) if args.alsa and args.seconds > 0 else None

    if args.loop:
        return _serve_with_loop(
            args, server, driver, push, led_out, params, max_hops, renderer
        )

    hops = 0
    served = 0  # outputs consumed; lags `hops` by one when pipelined

    def consume(out):
        nonlocal served
        served += 1
        a = getattr(out, "analysis", out)  # ServeOutputs when fused stages run
        if renderer is not None:
            # timestamp by the OUTPUT's hop index: in pipelined mode step()
            # returns the previous hop, so `hops` would skew the shader
            # clock one hop ahead of the scene it draws
            renderer.add(a, out.viewer, served / args.fps)
        print(f"{time.strftime('%H:%M:%S')} calm={float(a.scene_calmness[0]):.2f} {_notes(params, a)}")
        if led_out is not None:
            _write_led(led_out, params, a)
            led_out.flush()

    try:
        while max_hops is None or hops < max_hops:
            chunk = driver.read_chunk()
            if chunk is None:
                break
            hops += 1
            push(0, chunk)
            out = step()
            if out is None:  # pipelined priming hop
                continue
            consume(out)
        if args.pipelined and server is not None:
            tail = server.flush()  # the in-flight hop a one-deep queue holds
            if tail is not None:
                consume(tail[0])
    except KeyboardInterrupt:
        pass
    finally:
        if led_out is not None:
            led_out.close()
        if renderer is not None:
            renderer.write(args.fps)
        if server is not None:
            if server.stats["hops"]:
                print(f"serving stats: {server.stats}", file=sys.stderr)
            server.close()
    return 0


def _serve_with_loop(
    args, server, driver, push, led_out, params, max_hops, renderer=None
) -> int:
    """--serve --loop: the decoupled live architecture. A producer thread
    feeds the native ring at the capture cadence while the serving runtime
    owns the hop clock (`server.serve()`); this thread is just a consumer
    reading published hops at its own pace — capture never stalls behind a
    slow analysis window and vice versa (the reference's audio-callback /
    main-thread split, pitchvis_viewer/src/vqt_system.rs:59-67, with the
    main loop moved into the runtime)."""
    import threading

    done = threading.Event()

    def producer():
        try:
            hops = 0
            while max_hops is None or hops < max_hops:
                chunk = driver.read_chunk()
                if chunk is None:
                    break
                push(0, chunk)
                hops += 1
        finally:
            done.set()

    prod = threading.Thread(target=producer, daemon=True)
    k = max(1, int(getattr(args, "hops_per_dispatch", 1)))
    loop = server.serve(
        rate_hz=args.fps,
        hops_per_dispatch=k,
        publish="per_hop" if k > 1 else "latest",
    )
    prod.start()

    # --tune: raw-mode /dev/tty keystrokes -> ParameterTuner -> debounced
    # server.rebuild()/retune_analysis() swaps, live during the serve loop
    # (the reference's keyboard tuning + rebuild_vqt_system debounce,
    # common.rs:847-1165)
    keytuner = tty_restore = None
    if getattr(args, "tune", False):
        from .core.tuning import ParameterTuner
        from .io.keytune import KeyTuner, open_tty_raw, run_reader

        tty_fd, tty_restore = open_tty_raw()
        if tty_fd is None:
            print("--tune: no controlling terminal; tuning disabled", file=sys.stderr)
        else:
            keytuner = KeyTuner(ParameterTuner(server.vqt_params, server.analysis_params))
            threading.Thread(
                target=run_reader,
                args=(tty_fd, keytuner),
                kwargs=dict(on_status=lambda s: print(f"[tune] {s}", file=sys.stderr)),
                daemon=True,
            ).start()

    def pump_tuner():
        """Applies settled tuner changes to the live server (call once per
        consumed hop — the debounce makes this cheap)."""
        if keytuner is None:
            return False
        if keytuner.quit:
            return True
        ap = keytuner.take_retuned_analysis()
        if ap is not None:
            print("[tune] applying new analysis parameters", file=sys.stderr)
            server.retune_analysis(ap)
        try:
            vp = keytuner.tuner.take_rebuilt()
        except Exception as e:  # invalid combo: tuner already queued defaults
            print(f"[tune] rebuild failed, resetting to defaults: {e}", file=sys.stderr)
            vp = None
        if vp is not None:
            print(f"[tune] rebuilding kernel (Q={vp.quality:.2f}, gamma={vp.gamma:.2f}, "
                  f"n_fft={vp.n_fft})", file=sys.stderr)
            server.rebuild(vp)
        return False

    last = 0
    drain_check = None  # (advanced, time) snapshot once the producer is done
    settle_left = None  # published hops to serve after the ring drains
    try:
        while True:
            if pump_tuner():  # tuner requested quit
                break
            trip = loop.wait_next(seq=last, timeout=0.5)
            if trip is not None:
                last, raw, _gains = trip
                out = getattr(raw, "analysis", raw)
                if renderer is not None:
                    renderer.add(out, raw.viewer, last / args.fps)
                print(f"{time.strftime('%H:%M:%S')} #{last} calm={float(out.scene_calmness[0]):.2f} "
                      f"{_notes(params, out)}")
                if led_out is not None:
                    _write_led(led_out, params, out)
                    led_out.flush()
            if settle_left is not None:
                if trip is not None:
                    settle_left -= 1
                if settle_left <= 0:
                    break
            elif done.is_set() and last > 0:
                # producer finished AND at least one hop published (the
                # first hops may still be warming up): drain until advanced
                # stops moving for >=1 s, then serve a short settle window
                # so the analysis EMAs surface the trailing audio's peaks
                advanced = server.stats["advanced"]
                now = time.monotonic()
                if drain_check is None or advanced != drain_check[0]:
                    drain_check = (advanced, now)
                elif now - drain_check[1] >= 1.0:
                    settle_left = max(2, int(args.fps // 2))
    except KeyboardInterrupt:
        pass
    finally:
        loop.stop()
        prod.join(timeout=10)
        if tty_restore is not None:
            tty_restore()
        if led_out is not None:
            led_out.close()
        if renderer is not None:
            renderer.write(args.fps)
        print(
            f"serving stats: {server.stats}; loop stats: {loop.stats}",
            file=sys.stderr,
        )
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
