"""Host audio capture shims.

The reference captures audio via cpal/WebAudio/oboe callbacks
(pitchvis_audio). A serving host has no microphone; the equivalents are
stream drivers that feed the runtime from files, pipes, or sockets:

* `WavStreamDriver` — replays WAV files in real time (or faster) into a
  StreamServer / StreamingPipeline, resampling to the pipeline rate.
* `RawPipeDriver` — reads interleaved f32 frames from a file object (a pipe
  from e.g. `arecord`/`sox`/`ffmpeg`), the practical way to attach live
  microphones or network audio to the server.
* `dump_input_devices` — diagnostic listing (audio_desktop.rs:36-48
  equivalent) of the shims available in this environment.

A copy of ``pitchvis_tpu/io/capture.py``; ``resample`` is the port's
(ops/resample.py), on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..ops.resample import resample
from .wav import load_wav


def dump_input_devices(file=sys.stderr) -> None:
    print("pitchvis_tpu_torch host capture drivers:", file=file)
    print("  - WavStreamDriver(path): replay a WAV file", file=file)
    print("  - RawPipeDriver(fileobj, sr): interleaved f32 from a pipe", file=file)
    print("    e.g. arecord -f FLOAT_LE -r 22050 -c 1 | python -m ...", file=file)
    from .alsa import available, list_input_devices

    if available():
        print("  - AlsaCaptureDriver(device): in-process ALSA capture from:", file=file)
        for dev in list_input_devices():
            desc = dev.get("DESC", "").replace("\n", " — ")
            print(f"      {dev['NAME']}: {desc}", file=file)
    else:
        print("  - AlsaCaptureDriver: unavailable (no libasound on this host)", file=file)


class WavStreamDriver:
    """Replays a WAV file into per-chunk callbacks at a given speed factor.

    `push(stream_idx, chunk)` is any sink (StreamServer.push, or collecting
    into arrays for StreamingPipeline batches). A file at another rate is
    resampled on ``device``, the card unless ``device="cpu"``.
    """

    def __init__(self, path: str, target_sr: int, chunk_size: int, speed: float = 1.0, device="cuda"):
        audio, sr = load_wav(path)
        if sr != target_sr:
            audio = resample(audio, sr, target_sr, device=device)[0]
        self.audio = np.asarray(audio, np.float32)
        self.sr = target_sr
        self.chunk_size = chunk_size
        self.speed = speed

    def chunks(self):
        # the trailing partial chunk is zero-padded (same as RawPipeDriver's
        # EOF handling) — a clip shorter than one chunk otherwise fed NOTHING
        for i in range(0, len(self.audio), self.chunk_size):
            chunk = self.audio[i : i + self.chunk_size]
            if len(chunk) < self.chunk_size:
                chunk = np.concatenate(
                    [chunk, np.zeros(self.chunk_size - len(chunk), np.float32)]
                )
            yield chunk

    def stream_to(self, push, stream_idx: int = 0, realtime: bool = False) -> int:
        """Feeds all chunks to `push(stream_idx, chunk)`; sleeps between
        chunks when realtime. Returns the number of chunks."""
        n = 0
        period = self.chunk_size / self.sr / self.speed
        for chunk in self.chunks():
            t0 = time.monotonic()
            push(stream_idx, chunk)
            n += 1
            if realtime:
                time.sleep(max(0.0, period - (time.monotonic() - t0)))
        return n


class RawPipeDriver:
    """Reads interleaved float32 mono samples from a binary file object."""

    def __init__(self, fileobj, sr: int, chunk_size: int):
        self.fileobj = fileobj
        self.sr = sr
        self.chunk_size = chunk_size

    def read_chunk(self) -> np.ndarray | None:
        """Reads one full chunk, looping over short pipe reads (an unbuffered
        producer can return partial sample frames mid-stream). The EOF tail
        is truncated to whole float32 samples and zero-padded to chunk_size
        so consumers always see a fixed shape."""
        want = self.chunk_size * 4
        raw = b""
        while len(raw) < want:
            part = self.fileobj.read(want - len(raw))
            if not part:
                break
            raw += part
        raw = raw[: len(raw) - (len(raw) % 4)]
        if len(raw) < 4:
            return None
        chunk = np.frombuffer(raw, np.float32)
        if len(chunk) < self.chunk_size:
            chunk = np.concatenate(
                [chunk, np.zeros(self.chunk_size - len(chunk), np.float32)]
            )
        return chunk

    def stream_to(self, push, stream_idx: int = 0) -> int:
        n = 0
        while True:
            chunk = self.read_chunk()
            if chunk is None:
                return n
            push(stream_idx, chunk)
            n += 1
