"""Standard MIDI file (SMF) parser.

Port of ``pitchvis_tpu/synth/midi.py``, a copy (NumPy-free Python).

Covers what the training pipeline needs from the reference's vendored
rustysynth MidiFile (rustysynth_fork/src/midi_file.rs): format 0/1 files,
tempo map, and per-channel note-on/note-off/program-change events merged
onto an absolute-seconds timeline. No external dependencies.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field


@dataclass
class MidiEvent:
    time: float  # absolute seconds
    kind: str  # "on" | "off" | "program"
    channel: int
    key: int = 0
    velocity: int = 0
    program: int = 0


@dataclass
class Message:
    """Raw channel message on the absolute-seconds timeline — what the full
    synthesizer engine dispatches (rustysynth's MidiFile stores these as
    (channel, command, data1, data2) + times, midifile.rs:247-253)."""

    time: float
    channel: int
    command: int  # status high nibble: 0x80/0x90/0xA0/0xB0/0xC0/0xD0/0xE0
    data1: int
    data2: int


@dataclass
class MidiFile:
    events: list[MidiEvent] = field(default_factory=list)
    messages: list[Message] = field(default_factory=list)
    length: float = 0.0  # seconds

    def get_length(self) -> float:
        return self.length


def _read_varlen(data: bytes, pos: int) -> tuple[int, int]:
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not (b & 0x80):
            return value, pos


def parse_midi(data: bytes) -> MidiFile:
    try:
        return _parse_midi(data)
    except (IndexError, struct.error) as e:
        # corrupted deltas/lengths walk reads past the buffer; surface them
        # as the same typed rejection as structural errors
        raise ValueError(f"malformed SMF: {e}") from e


def _parse_midi(data: bytes) -> MidiFile:
    if data[:4] != b"MThd":
        raise ValueError("not a MIDI file")
    hlen, fmt, ntrks, division = struct.unpack(">IHHH", data[4:14])
    if fmt not in (0, 1):
        # format 2 = independent patterns per track; merging them onto one
        # absolute-tick timeline (what the loop below does) would play every
        # pattern simultaneously — reject like other malformed inputs
        raise ValueError(f"unsupported SMF format {fmt} (only 0/1)")
    if division & 0x8000:
        raise ValueError("SMPTE time division not supported")
    ticks_per_beat = division or 480

    pos = 8 + hlen
    # collect (tick, order, event) across tracks; tempo events apply globally
    raw_events: list[tuple[int, int, MidiEvent | tuple]] = []
    order = 0
    for _ in range(ntrks):
        if data[pos : pos + 4] != b"MTrk":
            raise ValueError("bad track chunk")
        tlen = struct.unpack(">I", data[pos + 4 : pos + 8])[0]
        tpos = pos + 8
        tend = tpos + tlen
        pos = tend

        tick = 0
        running = 0
        while tpos < tend:
            delta, tpos = _read_varlen(data, tpos)
            tick += delta
            status = data[tpos]
            if status & 0x80:
                tpos += 1
                # meta/sysex do NOT become running status: a channel event
                # encoded with running status after e.g. a text meta would
                # otherwise be swallowed as bogus meta data (SMF 1.0 says
                # meta/sysex "cancel" running status; real files rely on the
                # channel status surviving across interleaved meta events)
                if status < 0xF0:
                    running = status
            else:
                status = running
            kind = status & 0xF0
            ch = status & 0x0F
            if kind in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
                d1, d2 = data[tpos], data[tpos + 1]
                tpos += 2
                raw_events.append((tick, order, Message(0.0, ch, kind, d1, d2)))
            elif kind in (0xC0, 0xD0):
                d1 = data[tpos]
                tpos += 1
                if kind == 0xC0:
                    raw_events.append((tick, order, Message(0.0, ch, kind, d1, 0)))
            elif status == 0xFF:  # meta
                meta_type = data[tpos]
                tpos += 1
                mlen, tpos = _read_varlen(data, tpos)
                if meta_type == 0x51 and mlen == 3:
                    usec = int.from_bytes(data[tpos : tpos + 3], "big")
                    raw_events.append((tick, order, ("tempo", usec)))
                tpos += mlen
            elif status in (0xF0, 0xF7):  # sysex
                mlen, tpos = _read_varlen(data, tpos)
                tpos += mlen
            else:
                raise ValueError(f"unexpected status byte {status:#x}")
            order += 1

    raw_events.sort(key=lambda e: (e[0], e[1]))

    # tick -> seconds with the tempo map
    messages: list[Message] = []
    events: list[MidiEvent] = []
    tempo = 500_000  # default 120 bpm
    last_tick = 0
    now = 0.0
    for tick, _, ev in raw_events:
        now += (tick - last_tick) * tempo / 1_000_000.0 / ticks_per_beat
        last_tick = tick
        if isinstance(ev, tuple):
            tempo = ev[1]
            continue
        ev.time = now
        messages.append(ev)
        # legacy convenience view used by the additive synthesizer
        if ev.command == 0x90 and ev.data2 > 0:
            events.append(MidiEvent(now, "on", ev.channel, ev.data1, ev.data2))
        elif ev.command == 0x80 or (ev.command == 0x90 and ev.data2 == 0):
            events.append(MidiEvent(now, "off", ev.channel, ev.data1, ev.data2))
        elif ev.command == 0xC0:
            events.append(MidiEvent(now, "program", ev.channel, program=ev.data1))

    length = max((m.time for m in messages), default=0.0)
    return MidiFile(events=events, messages=messages, length=length)


def load_midi(path: str) -> MidiFile:
    with open(path, "rb") as f:
        return parse_midi(f.read())


def write_midi(
    path: str,
    notes: list[tuple[float, float, int, int, int]],
    tempo_bpm: float = 120.0,
    programs: dict[int, int] | None = None,
) -> None:
    """Test/dataset helper: writes a single-track MIDI file from
    (start_sec, duration_sec, channel, key, velocity) tuples.
    ``programs`` maps channel -> program number, emitted as 0xC0
    program-change events at tick 0 (selects presets of a multi-instrument
    font; see synth/sf2.py write_multi_sf2)."""
    ticks_per_beat = 480
    tempo = int(60_000_000 / tempo_bpm)

    def varlen(v: int) -> bytes:
        out = [v & 0x7F]
        v >>= 7
        while v:
            out.append((v & 0x7F) | 0x80)
            v >>= 7
        return bytes(reversed(out))

    def to_tick(t: float) -> int:
        return round(t * 1_000_000 / tempo * ticks_per_beat)

    evs = [(to_tick(0), bytes([0xFF, 0x51, 0x03]) + tempo.to_bytes(3, "big"))]
    for ch, prog in sorted((programs or {}).items()):
        evs.append((to_tick(0), bytes([0xC0 | ch, prog])))
    for start, dur, ch, key, vel in notes:
        evs.append((to_tick(start), bytes([0x90 | ch, key, vel])))
        evs.append((to_tick(start + dur), bytes([0x80 | ch, key, 0])))
    evs.sort(key=lambda e: e[0])

    body = b""
    last = 0
    for tick, payload in evs:
        body += varlen(tick - last) + payload
        last = tick
    body += varlen(0) + bytes([0xFF, 0x2F, 0x00])  # end of track

    with open(path, "wb") as f:
        f.write(b"MThd" + struct.pack(">IHHH", 6, 0, 1, ticks_per_beat))
        f.write(b"MTrk" + struct.pack(">I", len(body)) + body)
