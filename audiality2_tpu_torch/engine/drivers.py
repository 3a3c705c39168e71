"""Driver registry: named audio/MIDI/system backends.

Mirrors the reference's driver architecture (src/drivers.c:310-330
builtin table, drivers.c:544 option-string parsing, a2_drivers.h:46-63
config carrier) in offline-first form.  The TPU deployment has no
realtime audio device, so the audio backends are:

  buffer    offline driver (drivers/bufferdrv.c): Run(frames) renders
            synchronously into driver-owned int32 buffers — the
            backend behind all offline rendering and tests
  dummy     accepts config, discards audio (drivers/dummydrv.c)
  callback  invokes a user process(buffers, frames) per Run — the
            structural analog of the SDL/JACK callback drivers
            (drivers/sdldrv.c:42-144) with the host app as the sink

MIDI backends translate events to `send(voice, 7, (Msg, Ch, Arg1,
Arg2))` exactly like drivers/alsamididrv.c:73-97 (contract
a2_drivers.h:337-375); the built-in `smf` driver replays a parsed
Standard MIDI File on the engine clock.

System driver `heap` fills the RTAlloc/RTFree slot
(drivers/mallocdrv.c:30-56) — host allocation is the python heap, so
it only tracks allocation counts for statistics parity.
"""

import numpy as np

from ..errors import A2Error, A2Exception


def parse_driver_spec(spec):
    """Split "name,opt1,opt2" into (name, [opts]) (drivers.c:544).

    None or "" selects the default driver with no options."""
    if not spec:
        return None, []
    parts = [p.strip() for p in str(spec).split(",")]
    return parts[0] or None, [p for p in parts[1:] if p]


class AudioDriver:
    """Base audio driver (a2_drivers.h:170-220 analog)."""

    name = "audio"

    def __init__(self, state, options=()):
        self.state = state
        self.samplerate = state.config.samplerate
        self.channels = max(1, state.config.channels)
        self.options = list(options)

    def run(self, frames):
        raise NotImplementedError

    # Rare synchronous ops happen between Run calls host-side; these
    # exist for API parity with a2_drivers.h:294-296.
    def lock(self):
        pass

    def unlock(self):
        pass

    def close(self):
        pass


class BufferDriver(AudioDriver):
    """Offline driver: Run renders synchronously into owned buffers
    (drivers/bufferdrv.c:28-40)."""

    name = "buffer"

    def __init__(self, state, options=()):
        super().__init__(state, options)
        self.buffers = None         # np.int32 per channel, last Run

    def run(self, frames):
        out = [[] for _ in range(self.channels)]

        def sink(bufs, n):
            for c in range(min(len(bufs), self.channels)):
                out[c].append(np.array(bufs[c]))

        core = self.state.core
        core.sinks.append(sink)
        try:
            core.run(frames)
        finally:
            core.sinks.remove(sink)
        self.buffers = [np.concatenate(c) if c else
                        np.zeros(frames, np.int32) for c in out]
        return self.buffers


class DummyDriver(AudioDriver):
    """Accepts config, renders, discards (drivers/dummydrv.c)."""

    name = "dummy"

    def run(self, frames):
        self.state.core.run(frames)
        return None


class CallbackDriver(AudioDriver):
    """Hands each rendered block to a host callback — the offline
    analog of the SDL/JACK process callbacks (sdldrv.c:42-144)."""

    name = "callback"

    def __init__(self, state, options=(), process=None):
        super().__init__(state, options)
        self.process = process

    def run(self, frames):
        def sink(bufs, n):
            if self.process is not None:
                self.process(bufs, n)

        core = self.state.core
        core.sinks.append(sink)
        try:
            core.run(frames)
        finally:
            core.sinks.remove(sink)
        return None


def _dispatch_midi(bridge, state, status, d1, d2, offset):
    """Forward one raw MIDI message to the handler voice, timestamped
    at `offset` (24:8 frames) past the current buffer start on the
    ENGINE clock — the reference delivers MIDI in engine context with
    engine-time stamps (alsamididrv.c Poll + a2_Senda)."""
    i = bridge.i
    saved = i.timestamp
    i.timestamp = (state.now_fragstart + offset) & 0xFFFFFFFF
    try:
        kind = status & 0xF0
        ch = status & 0x0F
        if kind == 0x90:
            bridge.note_on(ch, d1, d2)
        elif kind == 0x80:
            bridge.note_off(ch, d1, d2)
        elif kind == 0xB0:
            bridge.control_change(ch, d1, d2)
        elif kind == 0xE0:
            bridge.pitch_bend(ch, (d2 << 7) | d1)
        elif kind == 0xC0:
            bridge.program_change(ch, d1)
        elif kind == 0xA0:
            bridge.aftertouch(ch, d1, d2)
        elif kind == 0xD0:
            bridge.channel_pressure(ch, d1)
    finally:
        i.timestamp = saved


class MidiDriver:
    """MIDI input driver base: poll(frames) runs once per audio
    buffer and forwards events to the handler voice via EP 7 with
    args (Msg, Ch, Arg1, Arg2) — alsamididrv.c:73-97 contract."""

    name = "midi"

    def __init__(self, state, options=()):
        self.state = state
        self.options = list(options)
        self.bridge = None

    def bind_handler(self, interface, voice):
        from .midi import MidiBridge
        self.bridge = MidiBridge(interface, voice)

    def poll(self, frames):
        pass

    def close(self):
        pass


class SmfMidiDriver(MidiDriver):
    """Replays a Standard MIDI File on the engine clock.  The file
    path comes from the driver options: "smf,song.mid"."""

    name = "smf"

    def __init__(self, state, options=()):
        super().__init__(state, options)
        from .midi import parse_smf
        self.events = parse_smf(options[0]) if options else []
        self.pos = 0
        self.time = 0.0     # engine seconds already polled

    def poll(self, frames):
        if self.bridge is None:
            return
        end = self.time + frames / self.state.config.samplerate
        sr = self.state.config.samplerate
        while self.pos < len(self.events) \
                and self.events[self.pos][0] < end:
            t, status, d1, d2 = self.events[self.pos]
            # timestamp the event at its exact subsample position on
            # the ENGINE clock (the API timestamp may be stale)
            offset = int(max(0.0, t - self.time) * sr * 256.0)
            _dispatch_midi(self.bridge, self.state, status, d1, d2,
                           offset)
            self.pos += 1
        self.time = end


class LiveMidiDriver(MidiDriver):
    """Live MIDI input: thread-safe injection of raw MIDI messages,
    delivered to the handler voice at the next buffer poll with
    subsample timestamps — the ALSA sequencer driver's contract
    (drivers/alsamididrv.c:259-344) with `inject()` standing in for
    the sequencer queue (no MIDI hardware in this deployment; a
    hardware backend is an inject() call away).

    Events carry either an explicit engine-time `when` (seconds, for
    deterministic use) or the wall-clock time of injection, mapped
    onto the engine clock like the reference's event timestamping."""

    name = "live"

    def __init__(self, state, options=()):
        super().__init__(state, options)
        import threading
        import time as _t
        self._lock = threading.Lock()
        self._queue = []
        self._time = 0.0          # engine seconds polled so far
        self._wall0 = None        # wall time of current buffer start
        self._clock = _t.monotonic

    def inject(self, status, data1=0, data2=0, when=None):
        """Queue a raw MIDI message (thread-safe).  `when` is an
        absolute engine time in seconds; None timestamps the event at
        the wall-clock moment of injection."""
        wall = self._clock()
        with self._lock:
            self._queue.append((when, wall, status, data1, data2))

    def poll(self, frames):
        if self.bridge is None:
            return
        import time as _t
        sr = self.state.config.samplerate
        now_wall = self._clock()
        if self._wall0 is None:
            self._wall0 = now_wall
        end = self._time + frames / sr
        with self._lock:
            events = [e for e in self._queue
                      if e[0] is None or e[0] < end]
            self._queue = [e for e in self._queue
                           if not (e[0] is None or e[0] < end)]
        for when, wall, status, d1, d2 in events:
            if when is None:
                # wall-clock capture relative to this buffer's start
                t = self._time + max(0.0, wall - self._wall0)
            else:
                t = when
            t = min(max(t, self._time), end)
            offset = int((t - self._time) * sr * 256.0)
            self._dispatch(status, d1, d2, offset)
        self._time = end
        self._wall0 = now_wall

    def _dispatch(self, status, d1, d2, offset):
        _dispatch_midi(self.bridge, self.state, status, d1, d2, offset)


class ClockedCallbackDriver(AudioDriver):
    """Realtime-ish operation: a thread paces the engine on the host
    clock, rendering one buffer per period and handing it to the
    process callback — the SDL/JACK callback thread's structural
    analog (drivers/sdldrv.c:42-144) with the host clock as the
    device clock.  start()/stop() control the thread; underruns are
    counted, not fatal (the engine never stops, core.c:1976-1997)."""

    name = "clock"

    def __init__(self, state, options=(), process=None):
        super().__init__(state, options)
        self.process = process
        self.buffer = state.config.buffer
        self._thread = None
        self._stop = False
        self.underruns = 0
        self.buffers_done = 0

    def run(self, frames):
        # synchronous operation still works (tests, warmup)
        def sink(bufs, n):
            if self.process is not None:
                self.process(bufs, n)
        core = self.state.core
        core.sinks.append(sink)
        try:
            core.run(frames)
        finally:
            core.sinks.remove(sink)

    def start(self):
        import threading
        import time as _t

        period = self.buffer / self.samplerate
        self._stop = False

        def loop():
            nxt = _t.monotonic()
            while not self._stop:
                t0 = _t.monotonic()
                self.run(self.buffer)
                self.buffers_done += 1
                nxt += period
                now = _t.monotonic()
                if now < nxt:
                    _t.sleep(nxt - now)
                else:
                    if now - nxt > period:
                        self.underruns += 1
                    nxt = now
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop = True
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def close(self):
        self.stop()


class SdlAudioDriver(AudioDriver):
    """Hardware audio output via SDL2 (the reference's sdldrv.c),
    loaded through ctypes at open time.  On systems without libSDL2
    (or without an audio device) opening raises DEVICEOPEN cleanly —
    the same failure mode as the reference on an audio-less host.
    The audio callback renders the engine directly (pull model), with
    int32 8:24 -> int16 conversion matching the WAV writer.

    Options: "sdl[,buffer]" (buffer frames, default engine config).

    NOTE: this deployment image has no audio stack, so this driver is
    exercised to the open-failure path only; the callback body
    follows SDL_OpenAudioDevice's documented contract."""

    name = "sdl"

    def __init__(self, state, options=()):
        super().__init__(state, options)
        import ctypes as C
        lib = None
        for nm in ("libSDL2-2.0.so.0", "libSDL2.so", "SDL2"):
            try:
                lib = C.CDLL(nm)
                break
            except OSError:
                continue
        if lib is None:
            from ..errors import A2Exception, A2Error
            raise A2Exception(A2Error.DEVICEOPEN,
                              "SDL2 library not available")
        self._C = C
        self._lib = lib
        SDL_INIT_AUDIO = 0x10
        if lib.SDL_Init(SDL_INIT_AUDIO) != 0:
            from ..errors import A2Exception, A2Error
            raise A2Exception(A2Error.DEVICEOPEN, "SDL_Init failed")

        class SDL_AudioSpec(C.Structure):
            _fields_ = [("freq", C.c_int), ("format", C.c_uint16),
                        ("channels", C.c_uint8), ("silence", C.c_uint8),
                        ("samples", C.c_uint16), ("padding", C.c_uint16),
                        ("size", C.c_uint32),
                        ("callback", C.c_void_p), ("userdata", C.c_void_p)]

        CB = C.CFUNCTYPE(None, C.c_void_p, C.POINTER(C.c_uint8),
                         C.c_int)

        def _cb(userdata, stream, nbytes):
            frames = nbytes // (2 * self.channels)
            chunks = []

            def sink(bufs, n):
                chunks.append([np.array(b[:n]) for b in
                               bufs[:self.channels]])
            core = self.state.core
            core.sinks.append(sink)
            try:
                core.run(frames)
            finally:
                core.sinks.remove(sink)
            if chunks:
                per = [np.concatenate([c[ch] for c in chunks])
                       for ch in range(self.channels)]
                pcm = np.clip(np.stack(per, axis=1).reshape(-1) >> 8,
                              -32768, 32767).astype("<i2").tobytes()
            else:
                pcm = b"\0" * nbytes
            C.memmove(stream, pcm[:nbytes], min(len(pcm), nbytes))

        self._cb = CB(_cb)           # keep alive
        want = SDL_AudioSpec()
        have = SDL_AudioSpec()
        want.freq = self.samplerate
        want.format = 0x8010         # AUDIO_S16LSB
        want.channels = self.channels
        bufframes = state.config.buffer
        for o in self.options:
            if o.isdigit():
                bufframes = int(o)
        want.samples = max(64, bufframes)
        want.callback = C.cast(self._cb, C.c_void_p)
        lib.SDL_OpenAudioDevice.restype = C.c_uint32
        self._dev = lib.SDL_OpenAudioDevice(None, 0, C.byref(want),
                                            C.byref(have), 0)
        if self._dev == 0:
            from ..errors import A2Exception, A2Error
            raise A2Exception(A2Error.DEVICEOPEN,
                              "SDL_OpenAudioDevice failed")

    def start(self):
        self._lib.SDL_PauseAudioDevice(self._dev, 0)

    def stop(self):
        self._lib.SDL_PauseAudioDevice(self._dev, 1)

    def lock(self):
        self._lib.SDL_LockAudioDevice(self._dev)

    def unlock(self):
        self._lib.SDL_UnlockAudioDevice(self._dev)

    def run(self, frames):
        # pull happens on the SDL callback thread; synchronous run is
        # a no-op like the reference's realtime drivers
        return None

    def close(self):
        if getattr(self, "_dev", 0):
            self._lib.SDL_CloseAudioDevice(self._dev)
            self._dev = 0


class JackAudioDriver(AudioDriver):
    """Hardware audio via JACK (the reference's jackdrv.c), ctypes.
    Raises DEVICEOPEN cleanly when libjack (or a running server) is
    unavailable — this image has neither, so only the failure path
    runs here; the process-callback wiring follows jack.h."""

    name = "jack"

    def __init__(self, state, options=()):
        super().__init__(state, options)
        import ctypes as C
        try:
            lib = C.CDLL("libjack.so.0")
        except OSError:
            from ..errors import A2Exception, A2Error
            raise A2Exception(A2Error.DEVICEOPEN,
                              "JACK library not available")
        self._C = C
        self._lib = lib
        lib.jack_client_open.restype = C.c_void_p
        status = C.c_int(0)
        self._client = lib.jack_client_open(
            b"audiality2", 0, C.byref(status))
        if not self._client:
            from ..errors import A2Exception, A2Error
            raise A2Exception(A2Error.DEVICEOPEN,
                              "jack_client_open failed (no server?)")
        CB = C.CFUNCTYPE(C.c_int, C.c_uint32, C.c_void_p)
        lib.jack_port_register.restype = C.c_void_p
        lib.jack_port_get_buffer.restype = C.POINTER(C.c_float)
        self._ports = [
            lib.jack_port_register(self._client,
                                   b"out_%d" % c,
                                   b"32 bit float mono audio",
                                   0x1 | 0x4, 0)   # output|terminal
            for c in range(self.channels)]

        def _process(nframes, arg):
            chunks = []

            def sink(bufs, n):
                chunks.append([np.array(b[:n]) for b in
                               bufs[:self.channels]])
            core = self.state.core
            core.sinks.append(sink)
            try:
                core.run(nframes)
            finally:
                core.sinks.remove(sink)
            for c, port in enumerate(self._ports):
                buf = lib.jack_port_get_buffer(port, nframes)
                if chunks:
                    data = np.concatenate([ch[c] for ch in chunks]) \
                        .astype(np.float64) / 8388608.0
                    arr = np.ctypeslib.as_array(buf, (nframes,))
                    arr[:] = data[:nframes].astype(np.float32)
            return 0

        self._cb = CB(_process)
        lib.jack_set_process_callback(self._client, self._cb, None)
        lib.jack_activate(self._client)

    def run(self, frames):
        return None

    def close(self):
        if getattr(self, "_client", None):
            self._lib.jack_client_close(self._client)
            self._client = None


class AlsaMidiDriver(LiveMidiDriver):
    """Hardware MIDI input via the ALSA sequencer (the reference's
    alsamididrv.c:259-344), loaded through ctypes at open time.  A
    readable client port ("Audiality 2") is created; other sequencer
    clients (keyboards, aconnect) subscribe to it.  poll() drains the
    event queue non-blocking and forwards note/controller/bend/
    pressure events to the handler voice via the EP-7 contract, with
    subsample wall-clock timestamps (the LiveMidiDriver machinery).
    On systems without libasound or a sequencer, opening raises
    DEVICEOPEN cleanly — the reference's failure mode.

    NOTE: this deployment image has no sound stack, so the driver is
    exercised to the open-failure path only; the event decode follows
    alsa/seq_event.h's documented layout."""

    name = "alsa"

    # snd_seq_event_type_t values (alsa/seq_event.h)
    _EV_NOTEON = 6
    _EV_NOTEOFF = 7
    _EV_KEYPRESS = 8
    _EV_CONTROLLER = 10
    _EV_PGMCHANGE = 11
    _EV_CHANPRESS = 12
    _EV_PITCHBEND = 13

    def __init__(self, state, options=()):
        super().__init__(state, options)
        import ctypes as C
        from ..errors import A2Exception, A2Error
        lib = None
        for nm in ("libasound.so.2", "libasound.so"):
            try:
                lib = C.CDLL(nm)
                break
            except OSError:
                continue
        if lib is None:
            raise A2Exception(A2Error.DEVICEOPEN,
                              "ALSA library not available")
        self._C = C
        self._lib = lib
        SND_SEQ_OPEN_INPUT = 2
        SND_SEQ_NONBLOCK = 1
        seq = C.c_void_p()
        if lib.snd_seq_open(C.byref(seq), b"default",
                            SND_SEQ_OPEN_INPUT, SND_SEQ_NONBLOCK) < 0:
            raise A2Exception(A2Error.DEVICEOPEN,
                              "snd_seq_open failed")
        self._seq = seq
        lib.snd_seq_set_client_name(seq, b"Audiality 2")
        # CAP_WRITE|CAP_SUBS_WRITE (0x20|0x40), TYPE_SYNTH (0x400)
        port = lib.snd_seq_create_simple_port(
            seq, b"Audiality 2", 0x20 | 0x40, 0x400)
        if port < 0:
            lib.snd_seq_close(seq)
            self._seq = None
            raise A2Exception(A2Error.DEVICEOPEN,
                              "snd_seq_create_simple_port failed")
        self._port = port
        lib.snd_seq_event_input.argtypes = [C.c_void_p,
                                            C.POINTER(C.c_void_p)]

    def _drain(self):
        """Decode pending sequencer events into raw MIDI and queue
        them at the wall clock of arrival.  snd_seq_event_t layout:
        16-byte header, then the data union (note: channel/note/
        velocity bytes at +16; ctrl: channel at +16, param u32 at
        +20, value i32 at +24)."""
        C = self._C
        lib = self._lib
        ev = C.c_void_p()
        while lib.snd_seq_event_input(self._seq, C.byref(ev)) > 0:
            if not ev.value:
                continue
            raw = C.cast(ev, C.POINTER(C.c_ubyte))
            typ = raw[0]
            if typ in (self._EV_NOTEON, self._EV_NOTEOFF,
                       self._EV_KEYPRESS):
                ch, note, vel = raw[16] & 0x0F, raw[17], raw[18]
                status = {self._EV_NOTEON: 0x90,
                          self._EV_NOTEOFF: 0x80,
                          self._EV_KEYPRESS: 0xA0}[typ] | ch
                self.inject(status, note & 0x7F, vel & 0x7F)
            elif typ in (self._EV_CONTROLLER, self._EV_PGMCHANGE,
                         self._EV_CHANPRESS, self._EV_PITCHBEND):
                ch = raw[16] & 0x0F
                param = C.cast(C.byref(C.c_ubyte.from_address(
                    ev.value + 20)), C.POINTER(C.c_uint32))[0]
                value = C.cast(C.byref(C.c_ubyte.from_address(
                    ev.value + 24)), C.POINTER(C.c_int32))[0]
                if typ == self._EV_CONTROLLER:
                    self.inject(0xB0 | ch, param & 0x7F,
                                max(0, min(127, value)))
                elif typ == self._EV_PGMCHANGE:
                    self.inject(0xC0 | ch, max(0, min(127, value)))
                elif typ == self._EV_CHANPRESS:
                    self.inject(0xD0 | ch, max(0, min(127, value)))
                else:   # pitch bend: ALSA value is -8192..8191
                    v14 = max(0, min(16383, value + 8192))
                    self.inject(0xE0 | ch, v14 & 0x7F, v14 >> 7)
            lib.snd_seq_free_event(ev)

    def poll(self, frames):
        if self._seq is not None:
            self._drain()
        super().poll(frames)

    def close(self):
        if getattr(self, "_seq", None) is not None:
            self._lib.snd_seq_close(self._seq)
            self._seq = None
        super().close()


class HeapSysDriver:
    """RTAlloc/RTFree slot (drivers/mallocdrv.c:30-56): host python
    allocates from its heap; this tracks counts for statistics."""

    name = "heap"

    def __init__(self, state=None, options=()):
        self.allocs = 0
        self.frees = 0

    def rt_alloc(self, size):
        self.allocs += 1
        return bytearray(size)

    def rt_free(self, block):
        self.frees += 1


_REGISTRY = {
    "audio": {"buffer": BufferDriver, "dummy": DummyDriver,
              "callback": CallbackDriver,
              "clock": ClockedCallbackDriver,
              "sdl": SdlAudioDriver, "jack": JackAudioDriver},
    "midi": {"smf": SmfMidiDriver, "live": LiveMidiDriver,
             "alsa": AlsaMidiDriver},
    "sys": {"heap": HeapSysDriver},
}
_DEFAULTS = {"audio": "buffer", "midi": "smf", "sys": "heap"}


def register_driver(kind, name, factory):
    """a2_AddDriver analog: register a named driver backend."""
    if kind not in _REGISTRY:
        raise A2Exception(A2Error.BADTYPE, kind)
    _REGISTRY[kind][name] = factory
    return A2Error.OK


def new_driver(kind, spec, state, **kw):
    """Instantiate "name,opt,opt" (drivers.c:544); None = default."""
    name, opts = parse_driver_spec(spec)
    name = name or _DEFAULTS[kind]
    try:
        factory = _REGISTRY[kind][name]
    except KeyError:
        raise A2Exception(A2Error.DRIVERNOTFOUND
                          if hasattr(A2Error, "DRIVERNOTFOUND")
                          else A2Error.NOTFOUND, f"{kind}:{name}")
    return factory(state, opts, **kw)


def driver_names(kind):
    return sorted(_REGISTRY.get(kind, ()))
