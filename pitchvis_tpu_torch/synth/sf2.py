"""SoundFont 2 (SF2) reader with the full generator model.

Port of ``pitchvis_tpu/synth/sf2.py``, a copy (NumPy only).

Behavioral equivalent of the reference's vendored rustysynth SoundFont layer
(rustysynth_fork/src/soundfont.rs, instrument_region.rs, preset_region.rs,
region_pair.rs): RIFF parsing, 16-bit sample data, instrument/preset zones
resolved into regions carrying the complete 61-entry generator table with
SF2-spec defaults, and the preset+instrument generator *sum* semantics the
synthesizer consumes (region_pair.rs:19-21). The fork's quirks are preserved
deliberately where they shape the rendered audio:

* loop-mode constants are all zero in the fork (loop_mode.rs:9-11), so any
  non-zero sampleModes value loops continuously and note-off never exits the
  loop — we mirror that (it changes sustained-note spectra).
* sampleModes == 2 is treated as no-loop (instrument_region.rs:344-350).
* global zones follow the "first zone, unless its last generator is
  SAMPLE_ID/INSTRUMENT" rule (instrument_region.rs:94-121).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

GEN_COUNT = 61

# generator ids (SF2 spec §8.1.2; rustysynth_fork/src/generator_type.rs)
GEN_START_ADDRS_OFFSET = 0
GEN_END_ADDRS_OFFSET = 1
GEN_STARTLOOP_OFFSET = 2
GEN_ENDLOOP_OFFSET = 3
GEN_START_ADDRS_COARSE_OFFSET = 4
GEN_MOD_LFO_TO_PITCH = 5
GEN_VIB_LFO_TO_PITCH = 6
GEN_MOD_ENV_TO_PITCH = 7
GEN_INITIAL_FILTER_FC = 8
GEN_INITIAL_FILTER_Q = 9
GEN_MOD_LFO_TO_FILTER_FC = 10
GEN_MOD_ENV_TO_FILTER_FC = 11
GEN_END_ADDRS_COARSE_OFFSET = 12
GEN_MOD_LFO_TO_VOLUME = 13
GEN_CHORUS_SEND = 15
GEN_REVERB_SEND = 16
GEN_PAN = 17
GEN_DELAY_MOD_LFO = 21
GEN_FREQ_MOD_LFO = 22
GEN_DELAY_VIB_LFO = 23
GEN_FREQ_VIB_LFO = 24
GEN_DELAY_MOD_ENV = 25
GEN_ATTACK_MOD_ENV = 26
GEN_HOLD_MOD_ENV = 27
GEN_DECAY_MOD_ENV = 28
GEN_SUSTAIN_MOD_ENV = 29
GEN_RELEASE_MOD_ENV = 30
GEN_KEYNUM_TO_MOD_ENV_HOLD = 31
GEN_KEYNUM_TO_MOD_ENV_DECAY = 32
GEN_DELAY_VOL_ENV = 33
GEN_ATTACK_VOL_ENV = 34
GEN_HOLD_VOL_ENV = 35
GEN_DECAY_VOL_ENV = 36
GEN_SUSTAIN_VOL_ENV = 37
GEN_RELEASE_VOL_ENV = 38
GEN_KEYNUM_TO_VOL_ENV_HOLD = 39
GEN_KEYNUM_TO_VOL_ENV_DECAY = 40
GEN_INSTRUMENT = 41
GEN_KEY_RANGE = 43
GEN_VEL_RANGE = 44
GEN_STARTLOOP_COARSE_OFFSET = 45
GEN_KEYNUM = 46
GEN_VELOCITY = 47
GEN_INITIAL_ATTENUATION = 48
GEN_ENDLOOP_COARSE_OFFSET = 50
GEN_COARSE_TUNE = 51
GEN_FINE_TUNE = 52
GEN_SAMPLE_ID = 53
GEN_SAMPLE_MODES = 54
GEN_SCALE_TUNING = 56
GEN_EXCLUSIVE_CLASS = 57
GEN_OVERRIDING_ROOT_KEY = 58


# -- soundfont math (soundfont_math.rs) ---------------------------------------

NON_AUDIBLE = 1.0e-3
HALF_PI = np.pi / 2.0


def timecents_to_seconds(x: float) -> float:
    return float(2.0 ** (x / 1200.0))


def cents_to_hertz(x: float) -> float:
    return float(8.176 * 2.0 ** (x / 1200.0))


def cents_to_multiplying_factor(x: float) -> float:
    return float(2.0 ** (x / 1200.0))


def decibels_to_linear(x: float) -> float:
    return float(10.0 ** (0.05 * x))


def linear_to_decibels(x: float) -> float:
    return float(20.0 * np.log10(x))


def key_number_to_multiplying_factor(cents: int, key: int) -> float:
    return timecents_to_seconds(float(cents * (60 - key)))


def _instrument_gs_defaults() -> np.ndarray:
    """SF2 defaults rustysynth seeds every instrument zone with
    (instrument_region.rs:39-58)."""
    gs = np.zeros(GEN_COUNT, np.int16)
    gs[GEN_INITIAL_FILTER_FC] = 13500
    for g in (
        GEN_DELAY_MOD_LFO,
        GEN_DELAY_VIB_LFO,
        GEN_DELAY_MOD_ENV,
        GEN_ATTACK_MOD_ENV,
        GEN_HOLD_MOD_ENV,
        GEN_DECAY_MOD_ENV,
        GEN_RELEASE_MOD_ENV,
        GEN_DELAY_VOL_ENV,
        GEN_ATTACK_VOL_ENV,
        GEN_HOLD_VOL_ENV,
        GEN_DECAY_VOL_ENV,
        GEN_RELEASE_VOL_ENV,
    ):
        gs[g] = -12000
    gs[GEN_KEY_RANGE] = 0x7F00
    gs[GEN_VEL_RANGE] = 0x7F00
    gs[GEN_KEYNUM] = -1
    gs[GEN_VELOCITY] = -1
    gs[GEN_SCALE_TUNING] = 100
    gs[GEN_OVERRIDING_ROOT_KEY] = -1
    return gs


def _preset_gs_defaults() -> np.ndarray:
    """Preset zones default to zero deltas except the ranges
    (preset_region.rs:32-34)."""
    gs = np.zeros(GEN_COUNT, np.int16)
    gs[GEN_KEY_RANGE] = 0x7F00
    gs[GEN_VEL_RANGE] = 0x7F00
    return gs


def _range(v: int) -> tuple[int, int]:
    return v & 0xFF, (v >> 8) & 0xFF


@dataclass
class SampleHeader:
    name: str
    start: int
    end: int
    start_loop: int
    end_loop: int
    sample_rate: int
    original_pitch: int
    pitch_correction: int


class InstrumentRegion:
    """One playable instrument zone: full generator table + sample fields."""

    __slots__ = ("gs", "sample")

    def __init__(self, gs: np.ndarray, sample: SampleHeader):
        self.gs = gs
        self.sample = sample

    def contains(self, key: int, velocity: int) -> bool:
        klo, khi = _range(int(self.gs[GEN_KEY_RANGE]) & 0xFFFF)
        vlo, vhi = _range(int(self.gs[GEN_VEL_RANGE]) & 0xFFFF)
        return klo <= key <= khi and vlo <= velocity <= vhi

    # address offsets (instrument_region.rs:144-162)
    def _offset(self, fine: int, coarse: int) -> int:
        return 32768 * int(self.gs[coarse]) + int(self.gs[fine])

    @property
    def sample_start(self) -> int:
        return self.sample.start + self._offset(
            GEN_START_ADDRS_OFFSET, GEN_START_ADDRS_COARSE_OFFSET
        )

    @property
    def sample_end(self) -> int:
        return self.sample.end + self._offset(GEN_END_ADDRS_OFFSET, GEN_END_ADDRS_COARSE_OFFSET)

    @property
    def sample_start_loop(self) -> int:
        return self.sample.start_loop + self._offset(
            GEN_STARTLOOP_OFFSET, GEN_STARTLOOP_COARSE_OFFSET
        )

    @property
    def sample_end_loop(self) -> int:
        return self.sample.end_loop + self._offset(GEN_ENDLOOP_OFFSET, GEN_ENDLOOP_COARSE_OFFSET)

    @property
    def sample_modes(self) -> int:
        # mode 2 is "unused" in the spec; rustysynth maps it to no-loop
        m = int(self.gs[GEN_SAMPLE_MODES])
        return 0 if m == 2 else m

    @property
    def root_key(self) -> int:
        override = int(self.gs[GEN_OVERRIDING_ROOT_KEY])
        return override if override != -1 else self.sample.original_pitch

    @property
    def exclusive_class(self) -> int:
        return int(self.gs[GEN_EXCLUSIVE_CLASS])


class PresetRegion:
    __slots__ = ("gs", "instrument")

    def __init__(self, gs: np.ndarray, instrument: int):
        self.gs = gs
        self.instrument = instrument

    def contains(self, key: int, velocity: int) -> bool:
        klo, khi = _range(int(self.gs[GEN_KEY_RANGE]) & 0xFFFF)
        vlo, vhi = _range(int(self.gs[GEN_VEL_RANGE]) & 0xFFFF)
        return klo <= key <= khi and vlo <= velocity <= vhi


@dataclass
class Instrument:
    name: str
    regions: list[InstrumentRegion]


@dataclass
class Preset:
    name: str
    bank_number: int
    patch_number: int
    regions: list[PresetRegion]


class RegionPair:
    """Preset + instrument region; generator values are SUMS of the two
    layers (region_pair.rs:19-21), converted to engine units."""

    __slots__ = ("preset", "instrument")

    def __init__(self, preset: PresetRegion, instrument: InstrumentRegion):
        self.preset = preset
        self.instrument = instrument

    def gs(self, i: int) -> int:
        return int(self.preset.gs[i]) + int(self.instrument.gs[i])

    # pitch / sample
    @property
    def coarse_tune(self) -> int:
        return self.gs(GEN_COARSE_TUNE)

    @property
    def fine_tune(self) -> int:
        return self.gs(GEN_FINE_TUNE) + self.instrument.sample.pitch_correction

    @property
    def scale_tuning(self) -> int:
        return self.gs(GEN_SCALE_TUNING)

    # filter
    @property
    def initial_filter_cutoff_frequency(self) -> float:
        return cents_to_hertz(float(self.gs(GEN_INITIAL_FILTER_FC)))

    @property
    def initial_filter_q(self) -> float:
        return 0.1 * self.gs(GEN_INITIAL_FILTER_Q)

    # modulation routing
    @property
    def mod_lfo_to_pitch(self) -> int:
        return self.gs(GEN_MOD_LFO_TO_PITCH)

    @property
    def vib_lfo_to_pitch(self) -> int:
        return self.gs(GEN_VIB_LFO_TO_PITCH)

    @property
    def mod_env_to_pitch(self) -> int:
        return self.gs(GEN_MOD_ENV_TO_PITCH)

    @property
    def mod_lfo_to_filter_cutoff(self) -> int:
        return self.gs(GEN_MOD_LFO_TO_FILTER_FC)

    @property
    def mod_env_to_filter_cutoff(self) -> int:
        return self.gs(GEN_MOD_ENV_TO_FILTER_FC)

    @property
    def mod_lfo_to_volume(self) -> float:
        return 0.1 * self.gs(GEN_MOD_LFO_TO_VOLUME)

    # sends / pan
    @property
    def chorus_effects_send(self) -> float:
        return 0.1 * self.gs(GEN_CHORUS_SEND)

    @property
    def reverb_effects_send(self) -> float:
        return 0.1 * self.gs(GEN_REVERB_SEND)

    @property
    def pan(self) -> float:
        return 0.1 * self.gs(GEN_PAN)

    # LFOs
    @property
    def delay_mod_lfo(self) -> float:
        return timecents_to_seconds(float(self.gs(GEN_DELAY_MOD_LFO)))

    @property
    def frequency_mod_lfo(self) -> float:
        return cents_to_hertz(float(self.gs(GEN_FREQ_MOD_LFO)))

    @property
    def delay_vib_lfo(self) -> float:
        return timecents_to_seconds(float(self.gs(GEN_DELAY_VIB_LFO)))

    @property
    def frequency_vib_lfo(self) -> float:
        return cents_to_hertz(float(self.gs(GEN_FREQ_VIB_LFO)))

    # modulation envelope
    @property
    def delay_mod_env(self) -> float:
        return timecents_to_seconds(float(self.gs(GEN_DELAY_MOD_ENV)))

    @property
    def attack_mod_env(self) -> float:
        return timecents_to_seconds(float(self.gs(GEN_ATTACK_MOD_ENV)))

    @property
    def hold_mod_env(self) -> float:
        return timecents_to_seconds(float(self.gs(GEN_HOLD_MOD_ENV)))

    @property
    def decay_mod_env(self) -> float:
        return timecents_to_seconds(float(self.gs(GEN_DECAY_MOD_ENV)))

    @property
    def sustain_mod_env(self) -> float:
        return 0.1 * self.gs(GEN_SUSTAIN_MOD_ENV)

    @property
    def release_mod_env(self) -> float:
        return timecents_to_seconds(float(self.gs(GEN_RELEASE_MOD_ENV)))

    @property
    def keynum_to_mod_env_hold(self) -> int:
        return self.gs(GEN_KEYNUM_TO_MOD_ENV_HOLD)

    @property
    def keynum_to_mod_env_decay(self) -> int:
        return self.gs(GEN_KEYNUM_TO_MOD_ENV_DECAY)

    # volume envelope
    @property
    def delay_vol_env(self) -> float:
        return timecents_to_seconds(float(self.gs(GEN_DELAY_VOL_ENV)))

    @property
    def attack_vol_env(self) -> float:
        return timecents_to_seconds(float(self.gs(GEN_ATTACK_VOL_ENV)))

    @property
    def hold_vol_env(self) -> float:
        return timecents_to_seconds(float(self.gs(GEN_HOLD_VOL_ENV)))

    @property
    def decay_vol_env(self) -> float:
        return timecents_to_seconds(float(self.gs(GEN_DECAY_VOL_ENV)))

    @property
    def sustain_vol_env(self) -> float:
        return 0.1 * self.gs(GEN_SUSTAIN_VOL_ENV)

    @property
    def release_vol_env(self) -> float:
        return timecents_to_seconds(float(self.gs(GEN_RELEASE_VOL_ENV)))

    @property
    def keynum_to_vol_env_hold(self) -> int:
        return self.gs(GEN_KEYNUM_TO_VOL_ENV_HOLD)

    @property
    def keynum_to_vol_env_decay(self) -> int:
        return self.gs(GEN_KEYNUM_TO_VOL_ENV_DECAY)

    @property
    def initial_attenuation(self) -> float:
        return 0.1 * self.gs(GEN_INITIAL_ATTENUATION)


def _build_regions(bag, gen, zone_lo, zone_hi, terminal_gen, make_region):
    """Shared preset/instrument zone resolution: zones are [gen ranges);
    the first zone is global unless its last generator is the terminal type
    (SAMPLE_ID / INSTRUMENT) (instrument_region.rs:94-121)."""
    zones = []
    # bag/gen indices come from the (untrusted) file: clamp them so a
    # malformed header degrades to empty/truncated zones (skipped below)
    # instead of an IndexError aborting the whole font
    zone_lo = max(0, min(zone_lo, len(bag)))
    zone_hi = max(zone_lo, min(zone_hi, len(bag)))
    for z in range(zone_lo, zone_hi):
        g_start = min(bag[z][0], len(gen))
        g_end = min(bag[z + 1][0], len(gen)) if z + 1 < len(bag) else len(gen)
        zones.append(gen[g_start:g_end] if g_end > g_start else [])
    if not zones:
        return []
    first_is_global = not zones[0] or zones[0][-1][0] != terminal_gen
    global_zone = zones[0] if first_is_global else []
    locals_ = zones[1:] if first_is_global else zones
    regions = []
    for local in locals_:
        if not local or local[-1][0] != terminal_gen:
            continue  # malformed zone; skip rather than abort the font
        region = make_region(global_zone, local)
        if region is not None:
            regions.append(region)
    return regions


class SoundFont:
    """Parsed SF2: int16 `wave_data` + instruments + presets with the full
    generator model (soundfont.rs)."""

    def __init__(self, data: bytes):
        wave, chunks = _parse_riff(data)
        self.wave_data: np.ndarray = wave  # int16, as rustysynth stores it
        self.sample_headers: list[SampleHeader] = _parse_sample_headers(chunks["shdr"])
        self.instruments: list[Instrument] = self._build_instruments(chunks)
        self.presets: list[Preset] = self._build_presets(chunks)
        self.preset_lookup: dict[int, int] = {}
        for i, p in enumerate(self.presets):
            self.preset_lookup[(p.bank_number << 16) | p.patch_number] = i
        # default preset = minimum id (synthesizer.rs:70-84)
        self.default_preset: int = (
            min(
                range(len(self.presets)),
                key=lambda i: (self.presets[i].bank_number << 16) | self.presets[i].patch_number,
            )
            if self.presets
            else 0
        )

    @classmethod
    def from_file(cls, path: str) -> "SoundFont":
        with open(path, "rb") as f:
            return cls(f.read())

    @property
    def samples(self) -> np.ndarray:
        """float32 view of the sample data in [-1, 1) (legacy helper)."""
        return self.wave_data.astype(np.float32) / 32768.0

    def lookup_preset(self, bank: int, patch: int) -> Preset | None:
        """bank/patch lookup with the GM fallback (synthesizer.rs:240-262)."""
        if not self.presets:
            return None
        idx = self.preset_lookup.get((bank << 16) | patch)
        if idx is None:
            gm_id = patch if bank < 128 else (128 << 16)
            idx = self.preset_lookup.get(gm_id, self.default_preset)
        return self.presets[idx]

    # -- construction ----------------------------------------------------
    def _build_instruments(self, c: dict) -> list[Instrument]:
        inst = c["inst"]
        headers = []
        for off in range(0, len(inst) - 22, 22):
            name = inst[off : off + 20].split(b"\0")[0].decode("ascii", "replace")
            (bag_idx,) = struct.unpack_from("<H", inst, off + 20)
            headers.append((name, bag_idx))
        ibag = [struct.unpack_from("<HH", c["ibag"], off) for off in range(0, len(c["ibag"]) - 3, 4)]
        igen = [struct.unpack_from("<Hh", c["igen"], off) for off in range(0, len(c["igen"]) - 3, 4)]

        def make_region(global_zone, local):
            gs = _instrument_gs_defaults()
            for gtype, val in list(global_zone) + list(local):
                if gtype < GEN_COUNT:
                    gs[gtype] = val
            sid = int(gs[GEN_SAMPLE_ID]) & 0xFFFF
            if sid >= len(self.sample_headers):
                return None
            return InstrumentRegion(gs, self.sample_headers[sid])

        out = []
        for i, (name, lo) in enumerate(headers):
            hi = headers[i + 1][1] if i + 1 < len(headers) else len(ibag) - 1
            out.append(
                Instrument(name, _build_regions(ibag, igen, lo, hi, GEN_SAMPLE_ID, make_region))
            )
        return out

    def _build_presets(self, c: dict) -> list[Preset]:
        phdr = c["phdr"]
        headers = []
        for off in range(0, len(phdr) - 38, 38):
            name = phdr[off : off + 20].split(b"\0")[0].decode("ascii", "replace")
            patch, bank, bag_idx = struct.unpack_from("<HHH", phdr, off + 20)
            headers.append((name, patch, bank, bag_idx))
        pbag = [struct.unpack_from("<HH", c["pbag"], off) for off in range(0, len(c["pbag"]) - 3, 4)]
        pgen = [struct.unpack_from("<Hh", c["pgen"], off) for off in range(0, len(c["pgen"]) - 3, 4)]

        def make_region(global_zone, local):
            gs = _preset_gs_defaults()
            for gtype, val in list(global_zone) + list(local):
                if gtype < GEN_COUNT:
                    gs[gtype] = val
            inst_idx = int(gs[GEN_INSTRUMENT]) & 0xFFFF
            if inst_idx >= len(self.instruments):
                return None
            return PresetRegion(gs, inst_idx)

        out = []
        for i, (name, patch, bank, lo) in enumerate(headers):
            hi = headers[i + 1][3] if i + 1 < len(headers) else len(pbag) - 1
            out.append(
                Preset(name, bank, patch, _build_regions(pbag, pgen, lo, hi, GEN_INSTRUMENT, make_region))
            )
        return out


def _parse_sample_headers(shdr: bytes) -> list[SampleHeader]:
    headers = []
    # the terminal "EOS" record (last 46 bytes) is not a sample
    for off in range(0, len(shdr) - 46, 46):
        name = shdr[off : off + 20].split(b"\0")[0].decode("ascii", "replace")
        s, e, sl, el, sr = struct.unpack_from("<IIIII", shdr, off + 20)
        pitch, corr = struct.unpack_from("<Bb", shdr, off + 40)
        headers.append(SampleHeader(name, s, e, sl, el, sr, pitch, corr))
    return headers


def _parse_riff(data: bytes) -> tuple[np.ndarray, dict]:
    if data[:4] != b"RIFF" or data[8:12] != b"sfbk":
        raise ValueError("not an SF2 file")
    pos = 12
    wave = np.zeros(0, np.int16)
    chunks: dict[str, bytes] = {}
    # the declared RIFF size is untrusted: clamp to the actual buffer so a
    # corrupted header can't walk struct.unpack_from past the end
    end = min(8 + struct.unpack_from("<I", data, 4)[0], len(data))
    while pos + 8 <= end:
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"LIST":
            list_type = body[:4]
            sub = body[4:]
            spos = 0
            while spos + 8 <= len(sub):
                scid = sub[spos : spos + 4].decode("ascii", "replace").strip()
                (ssize,) = struct.unpack_from("<I", sub, spos + 4)
                sbody = sub[spos + 8 : spos + 8 + ssize]
                if list_type == b"sdta" and scid == "smpl":
                    wave = np.frombuffer(sbody[: len(sbody) // 2 * 2], "<i2")
                elif list_type == b"pdta":
                    chunks[scid] = sbody
                spos += 8 + ssize + (ssize & 1)
        pos += 8 + size + (size & 1)
    required = {"phdr", "pbag", "pgen", "inst", "ibag", "igen", "shdr"}
    missing = required - set(chunks)
    if missing:
        raise ValueError(f"SF2 missing pdta chunks: {sorted(missing)}")
    return wave, chunks


def write_minimal_sf2(
    path: str,
    sample: np.ndarray,
    sample_rate: int,
    root_key: int = 60,
    loop: bool = True,
    name: str = "minisf",
    instrument_gens: list[tuple[int, int]] | None = None,
    preset_gens: list[tuple[int, int]] | None = None,
) -> None:
    """Testing/tooling helper: writes a valid single-sample, single-preset
    SF2 file (preset 0/bank 0 covering the full key range). Extra generator
    (type, value) pairs can be injected into the instrument or preset zone
    to exercise envelope/LFO/filter paths."""
    pcm = np.clip(np.asarray(sample) * 32767.0, -32768, 32767).astype("<i2").tobytes()
    pcm += b"\0" * 92  # 46 zero samples guard (spec requires >= 46)

    def chunk(cid: bytes, body: bytes) -> bytes:
        pad = b"\0" if len(body) & 1 else b""
        return cid + struct.pack("<I", len(body)) + body + pad

    def name20(s: str) -> bytes:
        return s.encode("ascii")[:19].ljust(20, b"\0")

    n = len(sample)
    shdr = (
        name20(name)
        + struct.pack("<IIIII", 0, n, 0, n, sample_rate)
        + struct.pack("<Bb", root_key, 0)
        + struct.pack("<HH", 0, 1)  # link, type=mono
    )
    shdr += name20("EOS") + b"\0" * 26

    # instrument 0 with one zone; SAMPLE_ID must be last (global-zone rule)
    igen_list = list(instrument_gens or [])
    igen_list += [(GEN_SAMPLE_MODES, 1 if loop else 0), (GEN_SAMPLE_ID, 0)]
    inst = name20(name) + struct.pack("<H", 0) + name20("EOI") + struct.pack("<H", 1)
    ibag = struct.pack("<HH", 0, 0) + struct.pack("<HH", len(igen_list), 0)
    igen = b"".join(struct.pack("<Hh", g, v) for g, v in igen_list)

    # preset 0:0 with one zone -> instrument 0; INSTRUMENT must be last
    pgen_list = list(preset_gens or []) + [(GEN_INSTRUMENT, 0)]
    phdr = (
        name20(name)
        + struct.pack("<HHH", 0, 0, 0)
        + struct.pack("<III", 0, 0, 0)
        + name20("EOP")
        + struct.pack("<HHH", 0, 0, 1)
        + struct.pack("<III", 0, 0, 0)
    )
    pbag = struct.pack("<HH", 0, 0) + struct.pack("<HH", len(pgen_list), 0)
    pgen = b"".join(struct.pack("<Hh", g, v) for g, v in pgen_list)

    pdta = b"pdta" + b"".join(
        chunk(cid, body)
        for cid, body in [
            (b"phdr", phdr),
            (b"pbag", pbag),
            (b"pmod", b"\0" * 10),
            (b"pgen", pgen + struct.pack("<Hh", 0, 0)),
            (b"inst", inst),
            (b"ibag", ibag),
            (b"imod", b"\0" * 10),
            (b"igen", igen + struct.pack("<Hh", 0, 0)),
            (b"shdr", shdr),
        ]
    )
    info = b"INFO" + chunk(b"ifil", struct.pack("<HH", 2, 1)) + chunk(
        b"isng", b"EMU8000\0"
    ) + chunk(b"INAM", name.encode() + b"\0")
    sdta = b"sdta" + chunk(b"smpl", pcm)

    body = b"sfbk" + chunk(b"LIST", info) + chunk(b"LIST", sdta) + chunk(b"LIST", pdta)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def write_multi_sf2(
    path: str,
    instruments: list[dict],
    name: str = "multisf",
) -> None:
    """Writes a multi-instrument SF2: one preset (bank 0, given program
    number) -> one instrument -> one sample per entry. Each entry is a dict:

        {"program": int, "name": str, "sample": f32 array, "sample_rate": int,
         "root_key": int, "loop": bool,
         "instrument_gens": [(gen, val), ...],   # optional
         "preset_gens": [(gen, val), ...]}       # optional

    The tooling counterpart of real multi-preset fonts (MuseScore_General
    in the reference's training pipeline, pitchvis_train/train.py:31):
    program-change events in a MIDI corpus select between these presets."""
    chunks_pcm: list[bytes] = []
    shdr = b""
    inst = b""
    ibag = b""
    igen = b""
    phdr = b""
    pbag = b""
    pgen = b""
    offset = 0

    def chunk(cid: bytes, body: bytes) -> bytes:
        pad = b"\0" if len(body) & 1 else b""
        return cid + struct.pack("<I", len(body)) + body + pad

    def name20(s: str) -> bytes:
        return s.encode("ascii")[:19].ljust(20, b"\0")

    n_igen = n_pgen = 0
    for i, spec in enumerate(instruments):
        sample = np.asarray(spec["sample"])
        pcm = np.clip(sample * 32767.0, -32768, 32767).astype("<i2").tobytes()
        pcm += b"\0" * 92  # >= 46 zero-sample guard between samples
        chunks_pcm.append(pcm)
        n = len(sample)
        shdr += (
            name20(spec["name"])
            + struct.pack("<IIIII", offset, offset + n, offset, offset + n,
                          int(spec["sample_rate"]))
            + struct.pack("<Bb", int(spec.get("root_key", 60)), 0)
            + struct.pack("<HH", 0, 1)
        )
        offset += n + 46

        igen_list = list(spec.get("instrument_gens", []))
        igen_list += [
            (GEN_SAMPLE_MODES, 1 if spec.get("loop", True) else 0),
            (GEN_SAMPLE_ID, i),
        ]
        inst += name20(spec["name"]) + struct.pack("<H", i)
        ibag += struct.pack("<HH", n_igen, 0)
        igen += b"".join(struct.pack("<Hh", g, v) for g, v in igen_list)
        n_igen += len(igen_list)

        pgen_list = list(spec.get("preset_gens", [])) + [(GEN_INSTRUMENT, i)]
        phdr += (
            name20(spec["name"])
            + struct.pack("<HHH", int(spec["program"]), 0, i)
            + struct.pack("<III", 0, 0, 0)
        )
        pbag += struct.pack("<HH", n_pgen, 0)
        pgen += b"".join(struct.pack("<Hh", g, v) for g, v in pgen_list)
        n_pgen += len(pgen_list)

    k = len(instruments)
    shdr += name20("EOS") + b"\0" * 26
    inst += name20("EOI") + struct.pack("<H", k)
    ibag += struct.pack("<HH", n_igen, 0)
    phdr += name20("EOP") + struct.pack("<HHH", 0, 0, k) + struct.pack("<III", 0, 0, 0)
    pbag += struct.pack("<HH", n_pgen, 0)

    pdta = b"pdta" + b"".join(
        chunk(cid, body)
        for cid, body in [
            (b"phdr", phdr),
            (b"pbag", pbag),
            (b"pmod", b"\0" * 10),
            (b"pgen", pgen + struct.pack("<Hh", 0, 0)),
            (b"inst", inst),
            (b"ibag", ibag),
            (b"imod", b"\0" * 10),
            (b"igen", igen + struct.pack("<Hh", 0, 0)),
            (b"shdr", shdr),
        ]
    )
    info = b"INFO" + chunk(b"ifil", struct.pack("<HH", 2, 1)) + chunk(
        b"isng", b"EMU8000\0"
    ) + chunk(b"INAM", name.encode() + b"\0")
    sdta = b"sdta" + chunk(b"smpl", b"".join(chunks_pcm))

    body = b"sfbk" + chunk(b"LIST", info) + chunk(b"LIST", sdta) + chunk(b"LIST", pdta)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
