"""ctypes bindings for the native runtime (native/liba2rt.so).

The Python side keeps the compiler and object system; a NativeRenderer
serializes every compiled program and prepared wave of an engine state
into the C++ runtime and drives rendering through it.  Audio output is
bit-exact with the Python engine (same integer DSP; see
tests/test_native.py).
"""

import ctypes as C
import os
import subprocess

import numpy as np

from .constants import A2_MAXARGS, A2_MAXEPS, A2ObjType, WaveType
from .errors import A2Error, A2Exception
from .fixmath import to_f16

_LIB = None


def _lib_path():
    # A2RT_LIB overrides for instrumented builds (e.g. -DA2RT_PROF)
    env = os.environ.get("A2RT_LIB")
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native", "liba2rt.so")


def load_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    path = _lib_path()
    if not os.path.exists(path):
        subprocess.run([os.path.join(os.path.dirname(path),
                                     "build.sh")], check=True)
    lib = C.CDLL(path)
    lib.a2rt_new.restype = C.c_void_p
    lib.a2rt_new.argtypes = [C.c_int, C.c_int, C.c_int32, C.c_uint32,
                             C.c_uint32, C.c_int]
    lib.a2rt_free.argtypes = [C.c_void_p]
    lib.a2rt_add_program.argtypes = [C.c_void_p, C.c_int,
                                     C.POINTER(C.c_int32), C.c_int]
    lib.a2rt_add_wave.argtypes = [C.c_void_p, C.c_int, C.c_int,
                                  C.c_uint32, C.c_uint32,
                                  C.POINTER(C.c_uint32),
                                  C.POINTER(C.c_int16)]
    lib.a2rt_init_root.argtypes = [C.c_void_p, C.c_int]
    lib.a2rt_start.argtypes = [C.c_void_p, C.c_int, C.c_int, C.c_int,
                               C.POINTER(C.c_int32), C.c_uint32]
    lib.a2rt_start.restype = C.c_int
    lib.a2rt_play.argtypes = lib.a2rt_start.argtypes
    lib.a2rt_send.argtypes = [C.c_void_p, C.c_int, C.c_int, C.c_int,
                              C.POINTER(C.c_int32), C.c_uint32]
    lib.a2rt_kill.argtypes = [C.c_void_p, C.c_int, C.c_uint32]
    lib.a2rt_release.argtypes = [C.c_void_p, C.c_int, C.c_uint32]
    lib.a2rt_run.argtypes = [C.c_void_p, C.c_int,
                             C.POINTER(C.c_int32)]
    lib.a2rt_now.argtypes = [C.c_void_p]
    lib.a2rt_now.restype = C.c_uint32
    lib.a2rt_activevoices.argtypes = [C.c_void_p]
    lib.a2rt_activevoices.restype = C.c_int64
    lib.a2rt_instructions.argtypes = [C.c_void_p]
    lib.a2rt_instructions.restype = C.c_int64
    lib.a2rt_last_error.argtypes = [C.c_void_p]
    lib.a2rt_last_error.restype = C.c_int
    lib.a2rt_record.argtypes = [C.c_void_p, C.c_int,
                                C.POINTER(C.c_int32), C.c_int,
                                C.POINTER(C.c_int32), C.c_int,
                                C.POINTER(C.c_int32), C.c_int,
                                C.POINTER(C.c_int32)]
    lib.a2rt_record.restype = C.c_int
    p32 = C.POINTER(C.c_int32)
    lib.a2rt_layout_runs.argtypes = [
        p32, C.c_int,            # rows, Nr
        p32, C.c_int,            # inst_of LUT, F
        p32, p32, p32,           # atlas tb/np/off LUTs
        p32, C.c_int,            # pass classes, npc
        p32, p32,                # out runmat, rampmat
        p32, p32, p32]           # out nb_per_class, tb_blocks, meta
    lib.a2rt_layout_runs.restype = C.c_int
    _LIB = lib
    return lib


def layout_runs(rows, inst_of, F, tb_l, np_l, off_l, pass_classes):
    """Native run layout (a2rt_layout_runs): byte-identical to
    tpu/superblock._build_runs, at memcpy speed.  Returns
    (runmat[Nr, 18], rampmat[nramp, 14], nb_per_class[npc + 1],
    tb_blocks, Rtot) or None when the native path can't apply
    (Nr >= 2^24)."""
    lib = load_lib()
    Nr = len(rows)
    p32 = C.POINTER(C.c_int32)

    def a(x):
        return np.ascontiguousarray(x, np.int32)

    rows = a(rows)
    inst_of = a(inst_of)
    tb_l, np_l, off_l = a(tb_l), a(np_l), a(off_l)
    pc = a(pass_classes)
    runmat = np.empty((Nr, 18), np.int32)
    rampmat = np.empty((Nr, 14), np.int32)
    npc = len(pc)
    nb = np.zeros(npc + 1, np.int32)
    # cap: <= one block per run plus one per bucket tail per class
    # (column 16 = RF_LEN, native/a2rt_record.inc row layout)
    cap = (int(rows[:, 16].sum()) // 128 + Nr + npc + 2) if Nr else 8
    tb_blocks = np.empty(cap, np.int32)
    meta = np.zeros(2, np.int32)
    err = lib.a2rt_layout_runs(
        rows.ctypes.data_as(p32), Nr,
        inst_of.ctypes.data_as(p32), int(F),
        tb_l.ctypes.data_as(p32), np_l.ctypes.data_as(p32),
        off_l.ctypes.data_as(p32),
        pc.ctypes.data_as(p32), npc,
        runmat.ctypes.data_as(p32), rampmat.ctypes.data_as(p32),
        nb.ctypes.data_as(p32), tb_blocks.ctypes.data_as(p32),
        meta.ctypes.data_as(p32))
    if err:
        return None
    return runmat, rampmat[:meta[0]], nb, tb_blocks, int(meta[1])


# field layouts of the native record buffers (native/a2rt_record.inc)
ROW_FIELDS = 33
STAGE_FIELDS = 23
STASH_HDR = 5
STASH_STRIDE = STASH_HDR + 2 * 64


def serialize_program(p):
    """Flatten a Program (a2s/program.py) into the int32 blob layout
    read by a2rt_add_program."""
    words = [p.nfuncs, len(p.units), len(p.wires), p.vflags,
             p.buffers]
    words += list(p.eps)
    for fn in p.funcs:
        words += [len(fn.code), fn.argc, fn.argv, fn.topreg]
        words += list(fn.argdefs[:A2_MAXARGS])
        for w in fn.code:
            w &= 0xFFFFFFFF
            words.append(w - (1 << 32) if w & 0x80000000 else w)
    for u in p.units:
        words += [u.uindex, u.ninputs, u.noutputs, u.flags]
    for w in p.wires:
        words += [w.from_unit, w.from_output, w.to_register]
    return np.array(words, dtype=np.int32)


class NativeRenderer:
    """Drives a native engine state mirroring a Python Interface's
    compiled objects."""

    def __init__(self, interface, channels=None):
        self.i = interface
        self.lib = load_lib()
        st = interface.state
        self.samplerate = st.config.samplerate
        self.channels = channels or st.config.channels
        if self.channels < 1:
            self.channels = 1
        self.master_channels = self.channels if self.channels >= 2 else 1
        quality = {"hifi": 0, "normal": 1, "lofi": 2}[
            getattr(st.config, "quality", "hifi")]
        self.st = self.lib.a2rt_new(
            self.samplerate, self.channels, st.config.basepitch,
            16576, 324357, quality)
        self._pushed_programs = set()
        self._pushed_waves = set()
        self.timestamp = 0
        self.sync()
        name = ("a2_rootdriver" if self.master_channels >= 2
                else "a2_rootdriver_mono")
        root = interface.get(0, name)
        r = self.lib.a2rt_init_root(self.st, root)
        if r:
            raise A2Exception(A2Error.INTERNAL, f"init_root {r}")

    def sync(self):
        """Push all programs and waves known to the Python state."""
        hm = self.i.state.ss.hm
        for h in hm.all_handles():
            hi = hm.get(h)
            if hi is None:
                continue
            if hi.typecode == A2ObjType.PROGRAM \
                    and h not in self._pushed_programs:
                blob = serialize_program(hi.data)
                self.lib.a2rt_add_program(
                    self.st, h,
                    blob.ctypes.data_as(C.POINTER(C.c_int32)),
                    len(blob))
                self._pushed_programs.add(h)
            elif hi.typecode == A2ObjType.WAVE \
                    and h not in self._pushed_waves:
                w = hi.data
                levels = w.miplevels
                sizes = np.zeros(10, dtype=np.uint32)
                chunks = []
                for mm in range(levels):
                    sizes[mm] = w.size[mm]
                    chunks.append(w.data[mm])
                data = (np.concatenate(chunks) if chunks
                        else np.zeros(1, dtype=np.int16))
                self.lib.a2rt_add_wave(
                    self.st, h, int(w.type), w.flags, w.period,
                    sizes.ctypes.data_as(C.POINTER(C.c_uint32)),
                    data.ctypes.data_as(C.POINTER(C.c_int16)))
                self._pushed_waves.add(h)

    # ---- API ----

    def timestamp_reset(self):
        self.timestamp = self.lib.a2rt_now(self.st)

    def timestamp_bump(self, dt):
        self.timestamp += dt

    def _args(self, args):
        arr = np.array([to_f16(a) if isinstance(a, float) else int(a)
                        for a in args], dtype=np.int32)
        return len(arr), arr.ctypes.data_as(C.POINTER(C.c_int32))

    def start(self, parent, program, *args):
        n, a = self._args(args)
        return self.lib.a2rt_start(self.st, parent, program, n, a,
                                   self.timestamp)

    def play(self, parent, program, *args):
        n, a = self._args(args)
        return self.lib.a2rt_play(self.st, parent, program, n, a,
                                  self.timestamp)

    def send(self, voice, ep, *args):
        n, a = self._args(args)
        return self.lib.a2rt_send(self.st, voice, ep, n, a,
                                  self.timestamp)

    def kill(self, voice):
        return self.lib.a2rt_kill(self.st, voice, self.timestamp)

    def release(self, voice):
        return self.lib.a2rt_release(self.st, voice, self.timestamp)

    def root_voice(self):
        return 0

    def run(self, frames):
        """Render `frames` frames; returns (channels, frames) int32."""
        out = np.empty((self.master_channels, frames), dtype=np.int32)
        self.lib.a2rt_run(self.st, frames,
                          out.ctypes.data_as(C.POINTER(C.c_int32)))
        return out

    def record(self, frames, maxrows=None, maxstages=None,
               maxstash=None):
        """Record one superblock for the device mixer: runs the native
        control plane and returns (rows, stages, stash) int32 matrices
        (native/a2rt_record.inc field layouts).  Raises A2Exception
        on unsupported content — the engine state HAS advanced, so the
        caller must restart the render on the pure native path."""
        nfrag = (frames + 63) // 64
        # sized for the measured worst cases of the benchmark corpus
        # (pulsetronic/k2loader fm-dense sections: ~24 rows, ~22
        # stages, ~16 stash slices per fragment) with ~2x headroom —
        # an overflow aborts the record (engine state has advanced)
        # and costs a native-path restart
        if maxrows is None:
            maxrows = max(4096, nfrag * 96)
        if maxstages is None:
            # +16/frag headroom for fm stage pairs (2 rows/slice per
            # fm instance since the device fm stages)
            maxstages = max(1024, nfrag * 64)
        if maxstash is None:
            maxstash = max(256, nfrag * 32)
        rows = np.empty((maxrows, ROW_FIELDS), np.int32)
        stages = np.empty((maxstages, STAGE_FIELDS), np.int32)
        stash = np.empty((maxstash, STASH_STRIDE), np.int32)
        counts = np.zeros(4, np.int32)
        p32 = C.POINTER(C.c_int32)
        err = self.lib.a2rt_record(
            self.st, frames,
            rows.ctypes.data_as(p32), maxrows,
            stages.ctypes.data_as(p32), maxstages,
            stash.ctypes.data_as(p32), maxstash,
            counts.ctypes.data_as(p32))
        if err:
            raise A2Exception(A2Error.NOTIMPLEMENTED,
                              f"native record: {err}")
        return (rows[:counts[0]], stages[:counts[1]],
                stash[:counts[2]], nfrag)

    @property
    def activevoices(self):
        return self.lib.a2rt_activevoices(self.st)

    def close(self):
        if self.st:
            self.lib.a2rt_free(self.st)
            self.st = None


def render_native(interface, program_handle, args=(), seconds=2.0,
                  buffer=4096):
    """Convenience: offline-render a program through the native
    runtime; returns int32 8:24 mono samples."""
    r = NativeRenderer(interface, channels=1)
    r.timestamp_reset()
    r.start(0, program_handle, *args)
    sr = r.samplerate
    total = int(seconds * sr)
    chunks = []
    n = 0
    while n < total:
        chunks.append(r.run(buffer)[0])
        n += buffer
    r.close()
    return np.concatenate(chunks)
