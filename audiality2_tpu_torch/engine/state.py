"""Engine state, shared object system, and the public interface.

Maps the reference's A2_state / A2_sharedstate / A2_interface model
(src/audiality2.c, src/internals.h:608-714) onto Python objects:

  * SharedState: handle manager, banks, waves, programs, registered
    units — shared between a master state and its substates
    (audiality2.c:620-681).
  * State: one render context (sample rate, voice tree, master bus).
  * Interface: the user-facing API + the compiler host.

The root bank is always handle 0 and contains the built-in waves, the
22 core units, and the built-in programs (a2_rootdriver[_mono],
a2_groupdriver, a2_terminator — audiality2.c:266-306).
"""

import math
import os

from ..constants import (
    A2_DEFAULT_NOISESEED, A2_DEFAULT_RANDSEED, A2_MIDDLEC, A2ObjType,
    SampleFormat, WaveType,
)
from ..errors import A2Error, A2Exception
from ..fixmath import NoiseState, f2p, to_f16
from ..objects.banks import A2String, Bank, Constant
from ..objects.handles import A2_APIOWNED, A2_LOCKED, HandleManager
from ..objects.waves import Wave, builtin_waves, normalize_gain, upload_wave
from ..units.descriptors import CORE_UNITS

A2_ROOTBANK = 0

# Builtin programs (behavioral contract from audiality2.c:266-306;
# the script text below matches the reference's builtin bank source).
_BUILTIN_PROGRAMS = """\
export def square pulse50

export a2_rootdriver()
{
	struct {
		inline 0 *
		panmix * *
		xinsert * >
	}
	2(V) { vol V; ramp vol 100 }
	3(PX PY PZ) { pan PX; ramp pan 100 }
}

export a2_rootdriver_mono()
{
	struct {
		inline 0 2
		panmix 2 1
		xinsert 1 >
	}
	2(V) { vol V; ramp vol 100 }
	3(PX PY PZ) { pan PX; ramp pan 100 }
}

export a2_groupdriver()
{
	struct {
		inline 0 *
		panmix * *
		xinsert * >
	}
	2(V) { vol V; ramp vol 100 }
	3(PX PY PZ) { pan PX; ramp pan 100 }
}

export a2_terminator() {}
"""


class Config:
    def __init__(self, samplerate=48000, buffer=1024, channels=2,
                 flags=0, batched=True, use_jax=True, device_mix=False,
                 quality="hifi",
                 audiodriver=None, mididriver=None, sysdriver=None):
        self.samplerate = samplerate
        self.buffer = buffer
        self.channels = channels
        self.flags = flags
        # driver specs: "name,opt,opt" strings (drivers.c:544); None
        # selects the defaults (buffer audio / heap sys, no midi)
        self.audiodriver = audiodriver
        self.mididriver = mididriver
        self.sysdriver = sysdriver
        # batched: record/replay block engine with device-batched
        # oscillator rows (bit-exact with the interleaved engine).
        self.batched = batched
        # use_jax: evaluate large row batches on the TPU; small ones
        # fall back to the numpy twin automatically.
        self.use_jax = use_jax
        # device_mix: whole-superblock device rendering (rows + bus
        # mixing + effect chains on the TPU, master-only readback —
        # tpu/superblock.py); falls back to host replay per superblock
        # when the op tape contains unsupported units.
        self.device_mix = device_mix
        # wtosc interpolation quality (reference config.h A2_HIFI /
        # default / A2_LOFI; wtosc.c:27-46).  fm is unaffected: the
        # reference's fm.c never includes config.h, so it always uses
        # the default oversampling table.
        if quality not in ("hifi", "normal", "lofi"):
            raise ValueError("quality must be hifi/normal/lofi")
        self.quality = quality
        # basepitch: middle C pitch in 1.0/octave relative to the output
        # sample rate (audiality2.c:397-399), reproduced with the same
        # float32 arithmetic:
        #   (int)(log2f(A2_MIDDLEC / samplerate) * 65536.0f + 0.5f)
        import numpy as np
        x32 = np.float32(np.float32(A2_MIDDLEC) / np.float32(samplerate))
        l = np.float32(math.log2(float(x32)))
        self.basepitch = int(np.float32(l * np.float32(65536.0)
                                        + np.float32(0.5)))


class SharedState:
    """Objects shared between a master state and substates."""

    def __init__(self):
        self.hm = HandleManager()
        self.offlinebuffer = 256
        self.silencelevel = 256
        self.silencewindow = 256
        self.silencegrace = 1024
        self.tabsize = 8
        self.units = list(CORE_UNITS)
        from ..units import host_units as _hu
        self.unit_classes = dict(_hu.REGISTRY)
        self.custom_units = 0
        self.terminator = None        # Program
        self.groupdriver = None       # handle
        self.load_cache = {}          # name -> bank handle

        for t, n in [(A2ObjType.BANK, "bank"), (A2ObjType.WAVE, "wave"),
                     (A2ObjType.PROGRAM, "program"),
                     (A2ObjType.UNIT, "unit"),
                     (A2ObjType.CONSTANT, "constant"),
                     (A2ObjType.STRING, "string"),
                     (A2ObjType.STREAM, "stream"),
                     (A2ObjType.XICLIENT, "xinsert client"),
                     (A2ObjType.DETACHED, "detached handle"),
                     (A2ObjType.NEWVOICE, "new voice"),
                     (A2ObjType.VOICE, "voice")]:
            self.hm.register_type(t, n)


class State:
    """One engine context: drives a voice tree at a sample rate."""

    def __init__(self, config=None, parent=None):
        from . import core as _core
        self.config = config or Config()
        self.parent = parent
        self.substates = []
        if parent is not None:
            self.ss = parent.ss
        else:
            self.ss = SharedState()
        self.samplerate = self.config.samplerate
        # One ms in sample frames (16:16).  The reference computes
        # this in FLOAT32 (audiality2.c:499 `samplerate * 65.536f +
        # .5f`), which differs from double math at some rates (96 kHz:
        # 6291457 vs 6291456) — discovered via 96 kHz goldens.
        import numpy as _np
        self.msdur = int(_np.float32(_np.float32(self.config.samplerate)
                                     * _np.float32(65.536))
                         + _np.float32(0.5))
        self.randstate = NoiseState(A2_DEFAULT_RANDSEED)
        self.noisestate = NoiseState(A2_DEFAULT_NOISESEED)
        self.now_fragstart = 0        # 24:8 frames
        self.now_frames = 0
        self.last_rt_error = None
        self.core = _core.Core(self)
        self.interface = Interface(self)
        # drivers (engine/drivers.py): audio defaults to the offline
        # buffer driver; midi optional; sys fills the RTAlloc slot
        from . import drivers as _drv
        self.audio_driver = _drv.new_driver("audio",
                                            self.config.audiodriver,
                                            self)
        self.sys_driver = _drv.new_driver("sys", self.config.sysdriver,
                                          self)
        self.midi_driver = (_drv.new_driver("midi",
                                            self.config.mididriver,
                                            self)
                            if self.config.mididriver else None)

        if parent is None:
            self._open_shared()
        self.core.init_root_voice()

    # ----- bring-up -----

    def _open_shared(self):
        ss = self.ss
        i = self.interface
        # Root bank MUST get handle 0
        h = i.new_bank("root", locked=True)
        assert h == A2_ROOTBANK
        bank = ss.hm.get(h).data
        # Built-in waves
        for name, w in builtin_waves():
            wh = ss.hm.new(w, A2ObjType.WAVE, A2_LOCKED)
            bank.exports[name] = wh
        # Units
        for idx, ud in enumerate(ss.units):
            uh = ss.hm.new(idx, A2ObjType.UNIT, A2_LOCKED)
            bank.exports[ud.name] = uh
        # Built-in programs
        i.load_string(_BUILTIN_PROGRAMS, "rootbank", target=A2_ROOTBANK)
        self.ss.terminator = i.get_program_obj(
            i.get(A2_ROOTBANK, "a2_terminator"))
        self.ss.groupdriver = i.get(A2_ROOTBANK, "a2_groupdriver")

    def substate(self, config=None):
        if config is None:
            config = Config(samplerate=self.config.samplerate,
                            buffer=self.config.buffer,
                            channels=self.config.channels,
                            batched=self.config.batched,
                            use_jax=self.config.use_jax)
        else:
            config.batched = self.config.batched
            config.use_jax = self.config.use_jax
        st = State(config,
                   parent=self if self.parent is None else self.parent)
        (self if self.parent is None else self.parent).substates.append(st)
        return st

    def close(self):
        if self.parent is not None:
            self.parent.substates.remove(self)


class Interface:
    """Public API facade + compiler host (A2_interface equivalent)."""

    def __init__(self, state: State):
        self.state = state
        self.timestamp = 0        # 24:8 frames, for timestamped API
        from ..constants import A2_LOG_DEFAULTS
        self.loglevels = A2_LOG_DEFAULTS

    # ===== compiler host protocol =====

    def root_bank_handle(self):
        return A2_ROOTBANK

    def unit_descs(self):
        return self.state.ss.units

    def unit_index(self, handle):
        hi = self.state.ss.hm.require(handle, A2ObjType.UNIT)
        return hi.data

    def new_program(self, program):
        return self.state.ss.hm.new(program, A2ObjType.PROGRAM)

    def get_program(self, handle):
        hi = self.state.ss.hm.get(handle)
        if hi is None or hi.typecode != A2ObjType.PROGRAM:
            return None
        return hi.data

    def get_program_obj(self, handle):
        return self.get_program(handle)

    def typeof(self, handle):
        hi = self.state.ss.hm.get(handle)
        return None if hi is None else hi.typecode

    def value_of(self, handle):
        hi = self.state.ss.hm.require(handle, A2ObjType.CONSTANT)
        return hi.data.value

    def string_of(self, handle):
        hi = self.state.ss.hm.require(handle, A2ObjType.STRING)
        return hi.data.value

    def new_string(self, s):
        return self.state.ss.hm.new(A2String(s), A2ObjType.STRING)

    def new_constant(self, v):
        return self.state.ss.hm.new(Constant(v), A2ObjType.CONSTANT)

    def bank_of(self, handle):
        hi = self.state.ss.hm.get(handle)
        if hi is None or hi.typecode != A2ObjType.BANK:
            return None
        return hi.data

    def bank_get(self, bank_handle, name):
        b = self.bank_of(bank_handle)
        if b is None:
            return None
        return b.find(name)

    def retain(self, handle):
        return self.state.ss.hm.retain(handle)

    def release(self, handle):
        return self.state.ss.hm.release(handle)

    def render_wave(self, wtype, period, flags, samplerate, length,
                    randseed, noiseseed, program, argv):
        """Compile-time/offline wave rendering (a2_RenderWave,
        render.c:144-177): render 'program' in an offline substate and
        upload the result into a new wave."""
        from .render import render_program
        if not period:
            period = int(samplerate / A2_MIDDLEC)
        props = {"randseed": randseed, "noiseseed": noiseseed}
        data = render_program(self.state, program, argv,
                              samplerate=samplerate, length=length,
                              props=props)
        w = upload_wave(wtype, period, flags, SampleFormat.I24, data)
        return self.state.ss.hm.new(w, A2ObjType.WAVE)

    # ===== banks / loading =====

    def new_bank(self, name, locked=False):
        b = Bank(name)
        return self.state.ss.hm.new(b, A2ObjType.BANK,
                                    A2_LOCKED if locked else A2_APIOWNED)

    def load(self, path, flags=0):
        """a2_Load: compile a .a2s file into a new bank (with the
        shared-bank name cache, bank.c:181-230).  If the filename has
        no extension, ".a2s" is appended (bank.c:187-194)."""
        if "." not in os.path.basename(path):
            path = path + ".a2s"
        cached = self.state.ss.load_cache.get(path)
        if cached is not None:
            self.retain(cached)
            return cached
        h = self.new_bank(path)
        from ..a2s.compiler import Compiler
        c = Compiler(self)
        c.compile_file(h, path)
        self.state.ss.load_cache[path] = h
        return h

    def load_string(self, code, source_name="string", target=None):
        """a2_LoadString: compile source into a new bank (or 'target')."""
        from ..a2s.compiler import Compiler
        if target is None:
            target = self.new_bank(source_name)
        c = Compiler(self)
        c.compile_string(target, code, source_name)
        return target

    def get(self, bank_handle, path):
        """a2_Get: look up "name" or "bank/name" (bank.c:348-390)."""
        parts = path.split("/")
        h = bank_handle
        for p in parts:
            b = self.bank_of(h)
            if b is None:
                raise A2Exception(A2Error.NOTFOUND, path)
            nh = b.find(p)
            if nh is None:
                raise A2Exception(A2Error.NOTFOUND, path)
            h = nh
        return h

    def try_get(self, bank_handle, path):
        try:
            return self.get(bank_handle, path)
        except A2Exception:
            return None

    def export(self, bank_handle, handle, name=None):
        """a2_Export: add object to a bank's export table."""
        b = self.bank_of(bank_handle)
        if b is None:
            raise A2Exception(A2Error.BADBANK)
        if name is None:
            obj = self.state.ss.hm.get(handle)
            name = getattr(obj.data, "name", None)
            if name is None:
                raise A2Exception(A2Error.NONAME)
        b.exports[name] = handle
        self.retain(handle)
        return A2Error.OK

    # ===== waves =====

    def upload_wave(self, wtype, period, flags, fmt, data):
        w = upload_wave(wtype, period, flags, fmt, data)
        return self.state.ss.hm.new(w, A2ObjType.WAVE, A2_APIOWNED)

    def new_wave(self, wtype, period, flags):
        w = Wave(wtype, period, flags)
        return self.state.ss.hm.new(w, A2ObjType.WAVE, A2_APIOWNED)

    def get_wave(self, handle):
        hi = self.state.ss.hm.get(handle)
        if hi is None or hi.typecode != A2ObjType.WAVE:
            return None
        return hi.data

    # ===== voice control (timestamped realtime-ish API) =====

    def root_voice(self):
        return self.state.core.rootvoice_handle

    def timestamp_reset(self):
        self.timestamp = self.state.now_frames
        return self.timestamp

    def timestamp_bump(self, dt_f8):
        self.timestamp += dt_f8
        return self.timestamp

    def timestamp_get(self):
        """a2_TimestampGet."""
        return self.timestamp

    def timestamp_set(self, ts):
        """a2_TimestampSet."""
        self.timestamp = ts & 0xFFFFFFFF
        return self.timestamp

    def timestamp_now(self):
        """a2_TimestampNow: re-anchor to current engine time (the
        offline engine has no jitter margin — interface.c:514-531)."""
        self.timestamp = self.state.now_fragstart
        return self.timestamp

    def timestamp_nudge(self, offset_f8, amount):
        """a2_TimestampNudge: blend the API timestamp toward
        (now + offset) by amount (0..1, 16:16 accepted as int)."""
        from .core import tsdiff
        target = (self.state.now_fragstart + offset_f8) & 0xFFFFFFFF
        d = tsdiff(target, self.timestamp)
        if isinstance(amount, int) and amount > 1:
            amount = amount / 65536.0
        self.timestamp = (self.timestamp + int(d * amount)) & 0xFFFFFFFF
        return self.timestamp

    def ms2timestamp(self, t_ms):
        """a2_ms2Timestamp: milliseconds -> 24:8 frame delta."""
        return int(t_ms * self.state.config.samplerate * 256 / 1000)

    def timestamp2ms(self, ts_f8):
        """a2_Timestamp2ms."""
        return ts_f8 * 1000.0 / (self.state.config.samplerate * 256.0)

    def rand(self, max_val):
        """a2_Rand (api.c:360-365): noise-RNG draw scaled to
        [0, max) as a float.  NOTE: draws from the shared NOISE state
        like the reference (affects subsequent noise audio)."""
        n = self.state.noisestate.next()
        return n * float(max_val) / 65536.0

    def pump_messages(self):
        """a2_PumpMessages: process engine->API responses.  The
        offline engine delivers callbacks synchronously inside run(),
        so this only needs to exist for API parity."""
        return 0

    def last_error(self):
        """a2_LastError (per-interface)."""
        return self.state.last_rt_error

    def last_rt_error(self):
        """a2_LastRTError (engine context)."""
        return self.state.last_rt_error

    def unload_all(self):
        """a2_UnloadAll: drop all unlocked root-bank exports and the
        load cache (bank.c a2_UnloadAll semantics: forget, objects die
        with their last handle)."""
        ss = self.state.ss
        ss.load_cache.clear()
        return 0

    def get_export(self, node, index):
        """a2_GetExport: (handle) of export #index of a bank."""
        bank = self.bank_of(node)
        items = list(bank.exports.values())
        if index < 0 or index >= len(items):
            raise A2Exception(A2Error.INDEXRANGE, str(index))
        return items[index]

    def get_export_name(self, node, index):
        """a2_GetExportName."""
        bank = self.bank_of(node)
        items = list(bank.exports.keys())
        if index < 0 or index >= len(items):
            raise A2Exception(A2Error.INDEXRANGE, str(index))
        return items[index]

    def name_of(self, handle):
        """a2_Name: name of a bank/program/unit object, if any."""
        hi = self.state.ss.hm.get(handle)
        if hi is None:
            return None
        d = hi.data
        for attr in ("name",):
            if hasattr(d, attr):
                return getattr(d, attr)
        if hi.typecode == A2ObjType.UNIT:
            return self.state.ss.units[d].name
        return None

    def size_of(self, handle):
        """a2_Size: object size (wave frames, bank export count,
        string length — properties.c general size)."""
        hi = self.state.ss.hm.get(handle)
        if hi is None:
            raise A2Exception(A2Error.INVALIDHANDLE, str(handle))
        t, d = hi.typecode, hi.data
        if t == A2ObjType.WAVE:
            return int(d.size[0])
        if t == A2ObjType.BANK:
            return len(d.exports)
        if t == A2ObjType.STRING:
            return len(d.value)
        raise A2Exception(A2Error.NOTIMPLEMENTED, "size")

    def new_group(self, parent=None):
        """a2_NewGroup: start a groupdriver voice (for mixer groups)."""
        if parent is None:
            parent = self.root_voice()
        return self.start(parent, self.state.ss.groupdriver)

    def start(self, parent_voice, program, *args):
        """a2_Start: start program on a new attached, handle-addressable
        voice; args are floats (converted to 16:16)."""
        iargs = [to_f16(a) for a in args]
        return self.starta(parent_voice, program, iargs)

    def starta(self, parent_voice, program, iargs):
        return self.state.core.api_start(parent_voice, program, iargs,
                                         self.timestamp)

    def play(self, parent_voice, program, *args):
        """a2_Play: start a detached voice (fire and forget)."""
        iargs = [to_f16(a) for a in args]
        return self.playa(parent_voice, program, iargs)

    def playa(self, parent_voice, program, iargs):
        return self.state.core.api_play(parent_voice, program, iargs,
                                        self.timestamp)

    def send(self, voice, ep, *args):
        iargs = [to_f16(a) for a in args]
        return self.senda(voice, ep, iargs)

    def senda(self, voice, ep, iargs):
        return self.state.core.api_send(voice, ep, iargs, self.timestamp)

    def sendsub(self, voice, ep, *args):
        iargs = [to_f16(a) for a in args]
        return self.state.core.api_sendsub(voice, ep, iargs,
                                           self.timestamp)

    def kill(self, voice):
        return self.state.core.api_kill(voice, self.timestamp)

    def killsub(self, voice):
        return self.state.core.api_killsub(voice, self.timestamp)

    def detach(self, voice):
        return self.state.core.api_detach(voice, self.timestamp)

    def release(self, handle):
        hi = self.state.ss.hm.get(handle)
        if hi is not None and hi.typecode == A2ObjType.VOICE:
            return self.state.core.api_release_voice(handle,
                                                     self.timestamp)
        if hi is not None and hi.typecode == A2ObjType.NEWVOICE:
            return self.state.core.api_release_voice(handle,
                                                     self.timestamp)
        return self.state.ss.hm.release(handle)

    # ===== running =====

    def run(self, frames):
        """a2_Run: drive the engine for 'frames' sample frames
        (offline/buffer operation)."""
        return self.state.core.run(frames)

    def sink_callback(self, callback):
        """Master-output tap: callback receives (list of np.int32
        buffers, frames) once per run() — the offline analog of
        a2_SinkCallback on the root voice (both observe the same
        mix; see insert_callback for the per-fragment client form)."""
        self.state.core.sinks.append(callback)
        return len(self.state.core.sinks)

    # ===== xinsert clients (xinsertapi.c) =====

    def _add_xic(self, voice, callback, read, write, userdata=None):
        from ..units.host_units import XInsertClient
        xic = XInsertClient(callback, read=read, write=write,
                            userdata=userdata)
        h = self.state.ss.hm.new(xic, A2ObjType.XICLIENT)
        xic.handle = h
        from .core import EV_ADDXIC, Event
        e = Event(EV_ADDXIC, self.timestamp, xic=xic)
        self.state.core.apimsgs.append((voice, e))
        return h

    def tap_callback(self, voice, callback, userdata=None):
        """a2_SinkCallback/a2_TapCallback: READ client on the first
        xinsert unit of 'voice'; callback(bufs, n, frames, userdata)."""
        return self._add_xic(voice, callback, True, False, userdata)

    def source_callback(self, voice, callback, userdata=None):
        """a2_SourceCallback: WRITE client — callback fills buffers."""
        return self._add_xic(voice, callback, False, True, userdata)

    def insert_callback(self, voice, callback, userdata=None):
        """a2_InsertCallback: READ/WRITE client — callback transforms
        buffers in place (parallel-summed with other inserts)."""
        return self._add_xic(voice, callback, True, True, userdata)

    def open_sink(self, voice, channel=0):
        """a2_OpenSink: capture a voice's audio into a readable
        stream."""
        from ..objects.streams import XicReadStream
        str_ = XicReadStream(self.state, -1, None, channel)

        def cb(bufs, n, frames, userdata):
            if bufs and channel < len(bufs):
                str_.push(bufs[channel][:frames])
            return 0

        xh = self.tap_callback(voice, cb)
        h = self.state.ss.hm.new(str_, A2ObjType.STREAM)
        str_.target_handle = xh
        return h

    def open_source(self, voice, channel=0):
        """a2_OpenSource: feed a voice's xinsert from a writable
        stream."""
        from ..objects.streams import XicWriteStream
        str_ = XicWriteStream(self.state, -1, None, channel)

        def cb(bufs, n, frames, userdata):
            data = str_.pull(frames)
            for ch in range(n):
                bufs[ch][:frames] = data
            return 0

        xh = self.source_callback(voice, cb)
        h = self.state.ss.hm.new(str_, A2ObjType.STREAM)
        str_.target_handle = xh
        return h

    # ===== streams (stream.c) =====

    def open_stream(self, handle, channel=0, size=0, flags=0):
        """a2_OpenStream on a wave (upload/download)."""
        hm = self.state.ss.hm
        hi = hm.require(handle)
        if hi.typecode == A2ObjType.WAVE:
            from ..objects.streams import WaveStream
            s = WaveStream(self.state, handle, hi.data, channel, size,
                           flags)
            return hm.new(s, A2ObjType.STREAM)
        raise A2Exception(A2Error.WRONGTYPE, "open_stream")

    def _stream(self, h):
        return self.state.ss.hm.require(h, A2ObjType.STREAM).data

    def stream_write(self, h, fmt, data):
        return self._stream(h).write(fmt, data)

    def stream_read(self, h, fmt, count):
        return self._stream(h).read(fmt, count)

    def stream_flush(self, h):
        return self._stream(h).flush()

    def stream_close(self, h):
        s = self._stream(h)
        s.close()
        return self.state.ss.hm.release(h)

    def stream_position(self, h):
        return self._stream(h).position

    def stream_set_position(self, h, offset):
        return self._stream(h).set_position(offset)

    def stream_available(self, h):
        return self._stream(h).available()

    def stream_space(self, h):
        return self._stream(h).space()

    # ===== rendering (render.c) =====

    def render(self, program, *args, samplerate=None, length=0,
               channels=1):
        """a2_Render-style offline render of 'program'; returns int32
        8:24 samples (stops at 'length' frames, or at silence)."""
        from .render import render_program
        if samplerate is None:
            samplerate = self.state.config.samplerate
        iargs = [to_f16(a) for a in args]
        return render_program(self.state, program, iargs,
                              samplerate=samplerate, length=length,
                              channels=channels)

    def dump_code(self, program_handle, prefix=""):
        """a2_DumpCode: disassemble a program's VM code."""
        from ..a2s.disasm import dump_program
        p = self.get_program(program_handle)
        if p is None:
            raise A2Exception(A2Error.BADPROGRAM)
        return dump_program(p, prefix)

    # ===== properties (a2_properties.h) =====

    # ===== custom units (units.c:79-157 a2_RegisterUnit) =====

    def register_unit(self, desc, unit_class):
        """Register a custom voice unit.

        desc is a units.descriptors.UnitDesc; unit_class follows the
        host-unit protocol (initialize/write_callbacks/process, see
        units/host_units.py).  Like the reference (units.c:127-133),
        registration is refused once substates exist, because shared
        compilers may already have resolved the unit namespace.
        Returns a UNIT handle exported from the root bank."""
        st = self.state
        root = st if st.parent is None else st.parent
        if root.substates:
            raise A2Exception(A2Error.ALREADYOPEN,
                              "cannot register units once substates exist")
        ss = st.ss
        for ud in ss.units:
            if ud.name == desc.name:
                raise A2Exception(A2Error.ISASSIGNED, desc.name)
        uindex = len(ss.units)
        ss.units.append(desc)
        ss.unit_classes[desc.name] = unit_class
        ss.custom_units += 1
        h = ss.hm.new(uindex, A2ObjType.UNIT)
        bank = ss.hm.get(A2_ROOTBANK).data
        bank.exports[desc.name] = h
        return h

    # ===== drivers (engine/drivers.py) =====

    @property
    def audio_driver(self):
        return self.state.audio_driver

    def set_midi_driver(self, spec_or_driver, handler_voice=None):
        """Install a MIDI input driver ("name,opt" spec or instance);
        optionally bind its handler voice (the alsamididrv.c:73-97
        contract: events become EP-7 sends)."""
        from . import drivers as _drv
        if isinstance(spec_or_driver, str):
            drv = _drv.new_driver("midi", spec_or_driver, self.state)
        else:
            drv = spec_or_driver
        self.state.midi_driver = drv
        if handler_voice is not None:
            drv.bind_handler(self, handler_voice)
        return drv

    # ===== logging (a2_types.h:86-107, interface.c:916-926) =====

    def log(self, level, msg):
        """Log through the per-interface level bitmask."""
        from ..constants import (A2_LOG_ERROR, A2_LOG_CRITICAL,
                                 A2_LOG_INTERNAL, A2_LOG_WARNING)
        import sys as _sys
        if not (self.loglevels & level):
            return
        stream = (_sys.stderr if level & (A2_LOG_ERROR | A2_LOG_CRITICAL
                                          | A2_LOG_INTERNAL
                                          | A2_LOG_WARNING)
                  else _sys.stdout)
        print(msg, file=stream)

    def get_state_property(self, name):
        st = self.state
        props = {
            "samplerate": st.config.samplerate,
            "buffer": st.config.buffer,
            "channels": st.config.channels,
            "activevoices": st.core.activevoices,
            "totalvoices": st.core.totalvoices,
            "offlinebuffer": st.ss.offlinebuffer,
            "silencelevel": st.ss.silencelevel,
            "silencewindow": st.ss.silencewindow,
            "silencegrace": st.ss.silencegrace,
            "randseed": st.randstate.state,
            "noiseseed": st.noisestate.state,
            "tabsize": st.ss.tabsize,
            "instructions": st.core.instructions,
            "activevoicesmax": st.core.activevoicesmax,
            "apimessages": st.core.apimessages,
            "cputimeavg": st.core.cputimeavg,
            "cputimemax": st.core.cputimemax,
            "cpuloadavg": st.core.cpuloadavg,
            "cpuloadmax": st.core.cpuloadmax,
            "loglevels": self.loglevels,
            "tsmarginavg": st.core.tsavg if st.core.tssamples else 0,
            "tsmarginmin": st.core.tsmin if st.core.tssamples else 0,
            "tsmarginmax": st.core.tsmax if st.core.tssamples else 0,
        }
        if name not in props:
            raise A2Exception(A2Error.NOTFOUND, name)
        return props[name]

    def set_state_property(self, name, value):
        st = self.state
        if name == "loglevels":
            self.loglevels = int(value)
        elif name in ("tsmarginavg", "tsmarginmin", "tsmarginmax"):
            self.state.core.tsstatreset = True   # any write resets
        elif name == "randseed":
            st.randstate.state = value & 0xFFFFFFFF
        elif name == "noiseseed":
            st.noisestate.state = value & 0xFFFFFFFF
        elif name in ("offlinebuffer", "silencelevel", "silencewindow",
                      "silencegrace", "tabsize"):
            setattr(st.ss, name, value)
        else:
            raise A2Exception(A2Error.NOTFOUND, name)
        return A2Error.OK


def open_engine(samplerate=48000, buffer=1024, channels=2, flags=0,
                batched=True, use_jax=True, device_mix=False,
                quality="hifi",
                audiodriver=None, mididriver=None, sysdriver=None):
    """a2_Open equivalent: create a master state, returning its
    interface.  Driver specs are "name,opt,opt" strings
    (drivers.c:544) — see engine/drivers.py for the registry."""
    st = State(Config(samplerate, buffer, channels, flags,
                      batched=batched, use_jax=use_jax,
                      device_mix=device_mix, quality=quality,
                      audiodriver=audiodriver, mididriver=mididriver,
                      sysdriver=sysdriver))
    return st.interface
