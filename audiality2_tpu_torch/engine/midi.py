"""MIDI input bridge.

The reference routes MIDI through a driver that translates incoming
events to `a2_Senda(voice, ep=7, (Msg, Ch, Arg1, Arg2))` messages to a
script handler voice (reference src/drivers/alsamididrv.c:73-97 and
the API contract in a2_drivers.h:337-375).  The TPU deployment has no
ALSA; this module provides the same contract for programmatic and
file-based MIDI:

  * MidiBridge: feed (message, channel, data1, data2) events at
    timestamps; they arrive at the handler voice's entry point 7 in
    the same normalized form the reference uses.
  * play_smf(): minimal Standard MIDI File reader driving a bridge
    (note on/off, program change, controllers, pitch bend).
"""

import struct

from ..fixmath import to_f16

# MIDI message codes as delivered to EP 7 (alsamididrv.c translation:
# the handler receives (Msg, Ch, Arg1, Arg2) with pitch as note/12 and
# velocities normalized to [0, 1]).
MIDI_NOTEOFF = 0
MIDI_NOTEON = 1
MIDI_AFTERTOUCH = 2
MIDI_CONTROLCHANGE = 3
MIDI_PROGRAMCHANGE = 4
MIDI_CHANNELPRESSURE = 5
MIDI_PITCHBEND = 6


class MidiBridge:
    """Delivers MIDI events to a handler voice (EP 7)."""

    def __init__(self, interface, handler_voice, channels=-1):
        self.i = interface
        self.voice = handler_voice
        self.channels = channels     # -1: all

    def event(self, msg, channel, arg1=0.0, arg2=0.0):
        """Send one normalized MIDI event at the current API
        timestamp."""
        if self.channels >= 0 and not ((1 << channel) & self.channels):
            return
        self.i.senda(self.voice, 7,
                     [to_f16(float(msg)), to_f16(float(channel)),
                      to_f16(arg1), to_f16(arg2)])

    # convenience wrappers with the reference's normalization
    def note_on(self, channel, note, velocity):
        if velocity == 0:
            return self.note_off(channel, note, 0)
        self.event(MIDI_NOTEON, channel, note / 12.0, velocity / 127.0)

    def note_off(self, channel, note, velocity=0):
        self.event(MIDI_NOTEOFF, channel, note / 12.0,
                   velocity / 127.0)

    def control_change(self, channel, cc, value):
        self.event(MIDI_CONTROLCHANGE, channel, float(cc),
                   value / 127.0)

    def program_change(self, channel, program):
        self.event(MIDI_PROGRAMCHANGE, channel, float(program))

    def pitch_bend(self, channel, value14):
        self.event(MIDI_PITCHBEND, channel,
                   (value14 - 8192) / 8192.0)

    def aftertouch(self, channel, note, pressure):
        self.event(MIDI_AFTERTOUCH, channel, note / 12.0,
                   pressure / 127.0)

    def channel_pressure(self, channel, pressure):
        self.event(MIDI_CHANNELPRESSURE, channel, pressure / 127.0)


def _read_varlen(data, pos):
    v = 0
    while True:
        b = data[pos]
        pos += 1
        v = (v << 7) | (b & 0x7F)
        if not (b & 0x80):
            return v, pos


def parse_smf(path):
    """Minimal SMF reader: returns a merged, time-sorted event list
    [(tick_seconds, status, d1, d2)], honoring tempo changes."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"MThd":
        raise ValueError("not a standard MIDI file")
    _, fmt, ntrk, division = struct.unpack(">IHHH", data[4:14])
    pos = 14
    raw = []
    for _ in range(ntrk):
        if data[pos:pos + 4] != b"MTrk":
            break
        (length,) = struct.unpack(">I", data[pos + 4:pos + 8])
        p = pos + 8
        end = p + length
        pos = end
        t = 0
        status = 0
        while p < end:
            dt, p = _read_varlen(data, p)
            t += dt
            b = data[p]
            if b & 0x80:
                status = b
                p += 1
            if status == 0xFF:
                meta = data[p]
                ln, p2 = _read_varlen(data, p + 1)
                if meta == 0x51:
                    uspq = int.from_bytes(data[p2:p2 + 3], "big")
                    raw.append((t, 0xFF51, uspq, 0))
                p = p2 + ln
            elif status in (0xF0, 0xF7):
                ln, p2 = _read_varlen(data, p)
                p = p2 + ln
            else:
                kind = status & 0xF0
                n = 1 if kind in (0xC0, 0xD0) else 2
                d1 = data[p]
                d2 = data[p + 1] if n == 2 else 0
                raw.append((t, status, d1, d2))
                p += n
    raw.sort(key=lambda e: e[0])
    # ticks -> seconds with tempo map
    out = []
    uspq = 500000
    last_t = 0
    seconds = 0.0
    for t, status, d1, d2 in raw:
        seconds += (t - last_t) * uspq / 1e6 / division
        last_t = t
        if status == 0xFF51:
            uspq = d1
            continue
        out.append((seconds, status, d1, d2))
    return out


def play_smf(interface, handler_voice, path, channels=-1):
    """Feed an SMF file through a MidiBridge with sample-accurate
    timestamps; caller then drives interface.run()."""
    bridge = MidiBridge(interface, handler_voice, channels)
    sr = interface.state.config.samplerate
    base = interface.timestamp
    for seconds, status, d1, d2 in parse_smf(path):
        interface.timestamp = (base + int(seconds * sr * 256)) \
            & 0xFFFFFFFF
        kind = status & 0xF0
        ch = status & 0x0F
        if kind == 0x90:
            bridge.note_on(ch, d1, d2)
        elif kind == 0x80:
            bridge.note_off(ch, d1, d2)
        elif kind == 0xB0:
            bridge.control_change(ch, d1, d2)
        elif kind == 0xC0:
            bridge.program_change(ch, d1)
        elif kind == 0xE0:
            bridge.pitch_bend(ch, (d2 << 7) | d1)
        elif kind == 0xA0:
            bridge.aftertouch(ch, d1, d2)
        elif kind == 0xD0:
            bridge.channel_pressure(ch, d1)
    interface.timestamp = base
    return bridge
