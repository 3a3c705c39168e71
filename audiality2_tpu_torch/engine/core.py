"""Engine core: voice tree, event system, VM interpreter, and the
fragment-processing loop.

This is the host reference engine — a behavioral mirror of the
reference realtime core (src/core.c): voices interleave VM execution
and DSP in fragments of at most A2_MAXFRAG frames, with all control
changes applied at exact 24:8 subsample offsets through per-register
write callbacks.  DSP units here are the numpy "host" implementations
(bit-exact integer DSP); the TPU path (audiality2_tpu.tpu) batches the
same control plane onto JAX kernels.

Key behavioral contracts reproduced:
  * Event queues are timestamp-sorted, insertion after equal timestamps
    (internals.h:927-944).
  * The register-write tracker defers and coalesces control writes
    until a timing instruction applies them with (start, duration)
    (core.c:1064-1116, 1731-1742).
  * Subvoice lists are LIFO: the newest voice is processed first
    (a2_VoiceNew, core.c:474-475) — this ordering is audible through
    the shared noise RNG.
  * VM overload kills a voice after A2_INSLIMIT instructions without
    passing time (core.c:1185-1186).
  * END/detach/finalize voice-state machine (core.c:1191-1236).
"""

import numpy as np

from ..constants import (
    A2_FIXEDREGS, A2_INSLIMIT, A2_MAXARGS, A2_MAXFRAG, A2_NESTLIMIT,
    A2_REGISTERS, A2_SV_LUT_SIZE, A2_DEFAULTTICK, A2_1K_DIV_MIDDLEC,
    A2ObjType, Op, R_TICK, R_TRANSPOSE, VState, A2_IO_MATCHOUT,
    A2_IO_WIREOUT, A2_PROCADD, A2_MATCHIO,
)
from ..errors import A2Error, A2Exception
from ..fixmath import p2i, sat32
from ..a2s.program import A2_SUBINLINE, A2_ATTACHED, A2_APIHANDLE
from ..units import host_units

_U32 = 0xFFFFFFFF


def tsdiff(a, b):
    """Wrap-safe timestamp difference (a2_TSDiff)."""
    return ((a - b + 0x80000000) & _U32) - 0x80000000


# Event actions (internals.h:464-485)
EV_PLAY = 0
EV_START = 1
EV_SEND = 2
EV_SENDSUB = 3
EV_RELEASE = 4
EV_KILL = 5
EV_KILLSUB = 6
EV_ADDXIC = 7
EV_REMOVEXIC = 8


class Event:
    __slots__ = ("action", "timestamp", "program", "voice", "argv",
                 "xic")

    def __init__(self, action, timestamp, program=0, voice=-1, argv=(),
                 xic=None):
        self.action = action
        self.timestamp = timestamp & _U32
        self.program = program
        self.voice = voice
        self.argv = argv
        self.xic = xic


def send_event(queue, e):
    """Insert into a timestamp-sorted list, after equal timestamps."""
    i = len(queue)
    while i > 0 and tsdiff(queue[i - 1].timestamp, e.timestamp) > 0:
        i -= 1
    queue.insert(i, e)


class StackEntry:
    __slots__ = ("state", "waketime", "pc", "func", "firstreg", "topreg",
                 "interrupt", "regs")


class Voice:
    __slots__ = ("events", "stack", "program", "waketime", "vstate",
                 "func", "pc", "r", "handle", "flags", "nestlevel",
                 "ncregs", "cregs", "units", "sub", "sv", "noutputs",
                 "outputs")

    def __init__(self):
        self.events = []
        self.stack = []
        self.program = None
        self.waketime = 0
        self.vstate = VState.RUNNING
        self.func = 0
        self.pc = 0
        self.r = [0] * A2_REGISTERS
        self.handle = -1
        self.flags = 0
        self.nestlevel = 0
        self.ncregs = A2_FIXEDREGS
        self.cregs = [None] * A2_REGISTERS   # (unit, write_cb) pairs
        self.units = []
        self.sub = []          # LIFO: index 0 = newest
        self.sv = {}           # vid -> Voice (attached anonymous LUT)
        self.noutputs = 0
        self.outputs = None


class Bus:
    """Per-nest-level scratch bus: channels of A2_MAXFRAG int32."""

    def __init__(self, channels):
        self.channels = channels
        self.buffers = [np.zeros(A2_MAXFRAG, dtype=np.int32)
                        for _ in range(channels)]

    def ensure(self, channels):
        while self.channels < channels:
            self.buffers.append(np.zeros(A2_MAXFRAG, dtype=np.int32))
            self.channels += 1

    def clear(self, offset, frames):
        for b in self.buffers:
            b[offset:offset + frames] = 0


class Core:
    def __init__(self, state):
        self.state = state
        self.sinks = []                  # master-bus tap callbacks
        self.activevoices = 0
        self.totalvoices = 0
        self.activevoicesmax = 0
        self.instructions = 0
        self.apimessages = 0
        self.cputimesum = 0
        self.cputimecount = 0
        self.cputimeavg = 0
        self.cputimemax = 0
        self.cpuloadavg = 0
        self.cpuloadmax = 0
        self.apimsgs = []                # pending API messages (events)
        self.tsstatreset = False
        self.tssamples = 0
        self.tssum = 0
        self.tsavg = 0
        self.tsmin = 0x7FFFFFFF
        self.tsmax = -0x80000000
        self.master = Bus(state.config.channels if state.config.channels
                          >= 2 else 1)
        self.scratch = [None] * A2_NESTLIMIT
        self.rootvoice = None
        self.rootvoice_handle = -1
        self.unit_classes = state.ss.unit_classes
        # --- batched (record/replay) block engine state ---
        self.batched = bool(getattr(state.config, "batched", False))
        self.use_jax = bool(getattr(state.config, "use_jax", True))
        self.recording = False
        self.oplist = None               # current fragment's op list
        self.rowbatch = None
        self._atlas = None
        self._atlas_entries = {}         # (id(wave), mm) -> base
        self._atlas_added = set()
        self._pair_atlas = None          # osc_kernel.PairAtlas (device)
        self._pair_added = set()
        # --- device superblock mixer (tpu/superblock.py) ---
        self.device_mix = bool(getattr(state.config, "device_mix",
                                       False))
        self.device_mixer = None
        self._device_committed = False   # stateful units on device

    # ----- wave atlas for the row kernel -----

    def atlas_base(self, wave, mm):
        key = (id(wave), mm)
        b = self._atlas_entries.get(key)
        if b is None:
            from ..tpu.row_kernel import FRAG  # noqa: F401
            from ..tpu.kernels import WaveAtlas
            if self._atlas is None:
                self._atlas = WaveAtlas()
            if id(wave) not in self._atlas_added:
                self._atlas.add_wave(id(wave), wave)
                self._atlas_added.add(id(wave))
                self._atlas.finalize()
                for (k, m), (base, size) in self._atlas._offsets.items():
                    self._atlas_entries[(k, m)] = base
            b = self._atlas_entries[key]
        return b

    def pair_atlas_entry(self, wave, mm):
        """(tbase, npass, pos_off) in the pallas pair atlas
        (tpu/osc_kernel.PairAtlas) for (wave, mip)."""
        from ..tpu.osc_kernel import PairAtlas
        if self._pair_atlas is None:
            self._pair_atlas = PairAtlas()
        if id(wave) not in self._pair_added:
            self._pair_atlas.add_wave(id(wave), wave)
            self._pair_added.add(id(wave))
            self._pair_atlas.finalize()
        return self._pair_atlas.lookup(id(wave), mm)

    # =====================================================
    #   Voice management
    # =====================================================

    def init_root_voice(self):
        st = self.state
        i = st.interface
        name = "a2_rootdriver" if self.master.channels >= 2 \
            else "a2_rootdriver_mono"
        ph = i.get(0, name)
        p = i.get_program(ph)
        v = Voice()
        self.totalvoices += 1
        self.rootvoice_handle = st.ss.hm.new(v, A2ObjType.VOICE, 0, 1)
        v.handle = self.rootvoice_handle
        self.activevoices += 1
        v.nestlevel = 0
        v.flags = A2_ATTACHED | A2_APIHANDLE
        v.waketime = st.now_fragstart
        v.r[R_TICK] = A2_DEFAULTTICK
        v.r[R_TRANSPOSE] = 0
        v.noutputs = self.master.channels
        v.outputs = self.master.buffers
        self.voice_start(v, p, [])
        self.rootvoice = v

    def voice_new(self, parent, when):
        if parent.nestlevel >= A2_NESTLIMIT - 1:
            self.rt_error(A2Error.VOICENEST, "voice_new")
            return None
        v = Voice()
        self.totalvoices += 1
        self.activevoices += 1
        if self.activevoices > self.activevoicesmax:
            self.activevoicesmax = self.activevoices
        v.nestlevel = parent.nestlevel + 1
        parent.sub.insert(0, v)        # newest first (LIFO)
        v.waketime = when & _U32
        v.r[R_TICK] = parent.r[R_TICK]
        v.r[R_TRANSPOSE] = parent.r[R_TRANSPOSE]
        v.noutputs = parent.noutputs
        v.outputs = parent.outputs
        return v

    def voice_start(self, v, p, argv):
        v.program = p
        v.flags |= p.vflags
        v.func = 0
        v.pc = 0
        v.vstate = VState.RUNNING
        fn = p.funcs[0]
        argc = min(len(argv), fn.argc)
        for i in range(argc):
            v.r[fn.argv + i] = argv[i]
        for i in range(argc, fn.argc):
            v.r[fn.argv + i] = fn.argdefs[i]
        v.ncregs = fn.argv + fn.argc
        return A2Error.OK

    def voice_call(self, v, func, argv, interrupt):
        fn = v.program.funcs[func]
        se = StackEntry()
        se.state = v.vstate
        se.func = v.func
        se.pc = v.pc
        se.interrupt = interrupt
        se.waketime = v.waketime
        se.firstreg = fn.argv
        se.topreg = fn.topreg
        se.regs = v.r[fn.argv:fn.topreg + 1]
        v.stack.append(se)
        v.func = func
        v.pc = 0
        if interrupt:
            v.vstate = VState.INTERRUPT
        argc = min(len(argv), fn.argc)
        for i in range(argc):
            v.r[fn.argv + i] = argv[i]
        for i in range(argc, fn.argc):
            v.r[fn.argv + i] = fn.argdefs[i]
        return A2Error.OK

    def voice_pop(self, v):
        se = v.stack.pop()
        v.vstate = se.state
        v.func = se.func
        if se.interrupt:
            v.pc = se.pc
            v.waketime = se.waketime
        else:
            v.pc = se.pc + 1
        v.r[se.firstreg:se.topreg + 1] = se.regs
        return se.interrupt

    def voice_free(self, v, parent_list, index):
        """Instantly kill and free voice + subvoices (a2_VoiceFree)."""
        parent_list.pop(index)
        self.activevoices -= 1
        if v.flags & A2_APIHANDLE:
            self.detach_handle(v.handle)
            v.handle = -1
            v.flags &= ~A2_APIHANDLE
        v.events.clear()
        while v.sub:
            self.voice_free(v.sub[0], v.sub, 0)
        v.sv.clear()
        if self.recording:
            for u in v.units:
                self.oplist.append(("deinit", u))
        else:
            for u in v.units:
                u.deinitialize()
        v.units = []
        v.stack.clear()
        v.program = None

    def detach_handle(self, h):
        """a2r_DetachHandle + API-side detach_or_free: if referenced,
        handle becomes DETACHED; else freed."""
        hm = self.state.ss.hm
        hi = hm.get(h)
        if hi is None:
            return
        if hi.refcount:
            hi.typecode = A2ObjType.DETACHED
            hi.data = None
        else:
            hm.free(h)

    def voice_detach(self, v, when):
        v.flags &= ~A2_ATTACHED
        if v.vstate >= VState.ENDING:
            v.waketime = when & _U32

    # ----- subvoice addressing (core.c:680-775) -----

    def find_subvoice(self, v, vid):
        if vid < 0:
            return None
        if vid < A2_SV_LUT_SIZE:
            return v.sv.get(vid)
        for sv in v.sub:
            if sv.handle == vid and (sv.flags & A2_ATTACHED) \
                    and not (sv.flags & A2_APIHANDLE):
                return sv
        return None

    def attach_subvoice(self, v, sv, vid):
        if vid < 0:
            if vid == -2:
                sv.flags |= A2_ATTACHED
                sv.handle = -1
            return
        if vid < A2_SV_LUT_SIZE:
            v.sv[vid] = sv
        sv.flags |= A2_ATTACHED
        sv.handle = vid

    def detach_subvoice(self, v, vid):
        if vid < 0:
            return
        if vid < A2_SV_LUT_SIZE:
            sv = v.sv.pop(vid, None)
            if sv is not None:
                self.voice_detach(sv, v.waketime)
            return
        for sv in v.sub:
            if sv.handle == vid and (sv.flags & A2_ATTACHED) \
                    and not (sv.flags & A2_APIHANDLE):
                self.voice_detach(sv, v.waketime)
                return

    def kill_subvoice(self, v, vid):
        if vid < 0:
            return
        if vid < A2_SV_LUT_SIZE:
            sv = v.sv.pop(vid, None)
            if sv is not None:
                self.voice_kill(sv, v.waketime)
            return
        for sv in v.sub:
            if sv.handle == vid and (sv.flags & A2_ATTACHED) \
                    and not (sv.flags & A2_APIHANDLE):
                self.voice_kill(sv, v.waketime)
                return

    def voice_kill(self, v, when):
        send_event(v.events, Event(EV_KILL, when))

    def voice_send(self, v, when, ep, argv):
        send_event(v.events, Event(EV_SEND, when, program=ep,
                                   argv=list(argv)))

    def voice_spawn(self, v, vid, program, argv):
        p = self.state.interface.get_program(program)
        self.detach_subvoice(v, vid)
        if p is None:
            return A2Error.BADPROGRAM
        nv = self.voice_new(v, v.waketime)
        if nv is None:
            return A2Error.VOICEALLOC
        nv.flags = 0
        self.attach_subvoice(v, nv, vid)
        return self.voice_start(nv, p, argv)

    # =====================================================
    #   Voice population (INITV)
    # =====================================================

    def populate_voice(self, p, v):
        """Instantiate + wire units (a2_PopulateVoice, core.c:350-420)."""
        st = self.state
        if not p.units:
            return A2Error.OK
        scratch = None
        if p.buffers:
            bmin = p.buffers
            if bmin < 0:
                bmin = -bmin
                if bmin < v.noutputs:
                    bmin = v.noutputs
            b = self.scratch[v.nestlevel]
            if b is None:
                b = Bus(bmin)
                self.scratch[v.nestlevel] = b
            else:
                b.ensure(bmin)
            scratch = b.buffers

        noutputs = v.noutputs
        outputs = v.outputs
        descs = st.ss.units

        # Batched engine: voices shaped exactly `wtosc` or
        # `wtosc -> panmix` use deferred (device-row) units.
        defer_classes = None
        if self.batched and getattr(st.config, "quality",
                                    "hifi") == "hifi":
            names = [descs[si.uindex].name for si in p.units]
            if names == ["wtosc"] or names == ["wtosc", "panmix"]:
                from ..units.deferred import DeferredPanmix, DeferredWtosc
                defer_classes = {"wtosc": DeferredWtosc,
                                 "panmix": DeferredPanmix}

        for si in p.units:
            ud = descs[si.uindex]
            # input wiring (core.c:190-208)
            if si.ninputs == A2_IO_MATCHOUT:
                ninputs = noutputs
                if ninputs < ud.mininputs:
                    self.rt_error(A2Error.FEWCHANNELS, "populate[in]")
                    return A2Error.VOICEINIT
                ninputs = min(ninputs, ud.maxinputs)
            else:
                ninputs = si.ninputs
            if ud.flags & A2_MATCHIO:
                minout = maxout = ninputs
            else:
                minout = ud.minoutputs
                maxout = ud.maxoutputs
            # output wiring
            if si.noutputs in (A2_IO_WIREOUT, A2_IO_MATCHOUT):
                uout = noutputs
                if uout < minout:
                    self.rt_error(A2Error.FEWCHANNELS, "populate[out]")
                    return A2Error.VOICEINIT
                uout = min(uout, maxout)
            else:
                uout = si.noutputs
            ubufs = outputs if si.noutputs == A2_IO_WIREOUT else scratch

            if defer_classes is not None:
                cls = defer_classes[ud.name]
            else:
                cls = self.unit_classes.get(ud.name)
            if cls is None:
                self.rt_error(A2Error.NOTIMPLEMENTED, f"unit {ud.name}")
                return A2Error.VOICEINIT
            u = cls(st, ud, v, ninputs,
                    scratch[:ninputs] if ninputs else [],
                    uout, (ubufs[:uout] if uout else []))
            # wire control registers onto VM registers; effect units'
            # writes are queued for replay in batched mode
            base = v.ncregs
            wrap = self.batched and getattr(u, "queue_writes", False)
            for j, wcb in enumerate(u.write_callbacks()):
                if wrap and wcb is not None:
                    v.cregs[v.ncregs] = (u, self._make_queuing(wcb, u, j))
                else:
                    v.cregs[v.ncregs] = (u, wcb)
                v.ncregs += 1
            u.regbase = base
            # stage-ordering key for the device superblock compiler
            # (stable even after the voice dies mid-superblock)
            u.depth_key = (-v.nestlevel, len(v.units))
            if (ud.flags & A2_MATCHIO) and ninputs != uout:
                self.rt_error(A2Error.IODONTMATCH, f"unit {ud.name}")
                return A2Error.VOICEINIT
            res = u.initialize(si.flags)
            if res:
                self.rt_error(res, f"unit init {ud.name}")
                return A2Error.VOICEINIT
            v.units.append(u)
        if defer_classes is not None and len(v.units) == 2:
            v.units[1].sibling = v.units[0]
        # control wires (env 'out' etc.)
        for w in p.wires:
            u = v.units[w.from_unit]
            cp = v.cregs[w.to_register]
            if cp is None:
                return A2Error.INTERNAL
            u.set_coutput(w.from_output, cp)
        return A2Error.OK

    # =====================================================
    #   Event processing (a2_VoiceProcessEvents)
    # =====================================================

    def process_events(self, v):
        current = v.events[0].timestamp
        while v.events:
            e = v.events[0]
            if e.timestamp != current:
                return A2Error.OK
            a = e.action
            if a == EV_PLAY:
                res = self._event_play(v, e)
                if res:
                    self.rt_error(res, "EV_PLAY")
            elif a == EV_START:
                res = self._event_start(v, e)
                if res:
                    self.rt_error(res, "EV_START")
                    self.detach_handle(e.voice)
            elif a == EV_SEND:
                ep = v.program.eps[e.program]
                if ep >= 0:
                    res = self.voice_call(v, ep, e.argv, 1)
                    if res:
                        self.rt_error(res, "EV_SEND")
                        v.events.pop(0)
                        continue
                    v.waketime = e.timestamp
                    v.events.pop(0)
                    return A2Error.OK   # spin VM to process message
            elif a in (EV_SENDSUB, EV_KILLSUB):
                if v.sub:
                    e.action = EV_SEND if a == EV_SENDSUB else EV_KILL
                    v.events.pop(0)
                    # forward to all subvoices (copies for 2nd+)
                    send_event(v.sub[0].events, e)
                    for sv in v.sub[1:]:
                        ne = Event(e.action, e.timestamp,
                                   program=e.program, argv=list(e.argv))
                        send_event(sv.events, ne)
                    continue
            elif a == EV_KILL:
                return A2Error.END
            elif a == EV_RELEASE:
                self.detach_handle(v.handle)
                v.handle = -1
                v.flags &= ~A2_APIHANDLE
                self.voice_detach(v, e.timestamp)
            elif a == EV_ADDXIC:
                res = self.xinsert_add_client(v, e.xic)
                if res:
                    self.rt_error(res, "EV_ADDXIC")
            elif a == EV_REMOVEXIC:
                res = self.xinsert_remove_client(e.xic)
                if res:
                    self.rt_error(res, "EV_REMOVEXIC")
            v.events.pop(0)
        return A2Error.OK

    def _event_play(self, parent, e):
        p = self.state.interface.get_program(e.program)
        if p is None:
            return A2Error.BADPROGRAM
        v = self.voice_new(parent, e.timestamp)
        if v is None:
            return A2Error.VOICEALLOC
        v.flags = 0
        return self.voice_start(v, p, e.argv)

    def _event_start(self, parent, e):
        hm = self.state.ss.hm
        hi = hm.get(e.voice)
        p = self.state.interface.get_program(e.program)
        if p is None:
            return A2Error.BADPROGRAM
        v = self.voice_new(parent, e.timestamp)
        if v is None:
            return A2Error.VOICEALLOC
        # handle was A2_TNEWVOICE; grab its pending event queue
        if hi is not None:
            pending = hi.data or []
            v.events = pending
            hi.data = v
            hi.typecode = A2ObjType.VOICE
        v.flags = A2_ATTACHED | A2_APIHANDLE
        v.handle = e.voice
        return self.voice_start(v, p, e.argv)

    # =====================================================
    #   VM interpreter (a2_VoiceProcessVM)
    # =====================================================

    def rt_error(self, code, info=""):
        self.state.last_rt_error = code

    def voice_control(self, v, reg, start, duration):
        cp = v.cregs[reg]
        if cp is not None:
            unit, write = cp
            if write is not None:
                write(v.r[reg], start & 255, duration)

    def _make_queuing(self, wcb, unit=None, idx=None):
        """Wrap an effect unit's write callback: during recording the
        write is queued into the op list (applied at replay, in exact
        order relative to the unit's process slices).  unit/idx ride
        along so the device superblock compiler can shadow-simulate
        the write without touching the unit (tpu/superblock.py)."""
        def queuing(value, start, dur):
            if self.recording:
                self.oplist.append(("write", wcb, value, start, dur,
                                    unit, idx))
            else:
                wcb(value, start, dur)
        return queuing

    def process_vm(self, v):
        st = self.state
        cargv = []
        fn = v.program.funcs[v.func]
        code = fn.decoded
        r = v.r
        inscount = A2_INSLIMIT
        if v.vstate == VState.WAITING:
            v.vstate = VState.RUNNING
        # register-write tracker: ordered set of pending writes
        rt_mask = 0
        rt_regs = []

        def rt_mark(reg):
            nonlocal rt_mask
            b = 1 << reg
            if not (b & rt_mask):
                rt_mask |= b
                rt_regs.append(reg)

        def rt_unmark(reg):
            nonlocal rt_mask
            b = 1 << reg
            if b & rt_mask:
                rt_mask &= ~b
                # C swaps with last element (core.c:1085-1099)
                i = rt_regs.index(reg)
                rt_regs[i] = rt_regs[-1]
                rt_regs.pop()

        def rt_apply(start, duration):
            for reg in rt_regs:
                self.voice_control(v, reg, start, duration)

        def ticks2t(d):
            return ((((d * r[R_TICK] + 127) >> 8) * st.msdur
                     + 0x7FFFFFFF) >> 32) & _U32

        def ms2t(d):
            return ((d * st.msdur + 0x7FFFFF) >> 24) & _U32

        while True:
            ins = code[v.pc]
            op, a1, a2, a3 = ins
            inscount -= 1
            if not inscount:
                self.instructions += A2_INSLIMIT
                self.rt_error(A2Error.OVERLOAD, "VM")
                return A2Error.OVERLOAD
            dt = None

            if op == Op.END:
                now = v.waketime
                rt_apply(v.waketime, 0)
                v.waketime = (v.waketime + 1000000) & _U32
                if v.vstate == VState.FINALIZING:
                    self.instructions += A2_INSLIMIT - inscount
                    return A2Error.OK if v.sub else A2Error.END
                v.vstate = VState.ENDING
                if (v.flags & A2_ATTACHED) or v.events:
                    self.instructions += A2_INSLIMIT - inscount
                    return A2Error.OK
                v.vstate = VState.FINALIZING
                if not v.sub:
                    self.instructions += A2_INSLIMIT - inscount
                    return A2Error.END
                v.sv.clear()
                for sv in v.sub:
                    self.voice_detach(sv, now)
                self.instructions += A2_INSLIMIT - inscount
                return A2Error.OK
            elif op == Op.RETURN:
                now = v.waketime
                if self.voice_pop(v):
                    fn = v.program.funcs[v.func]
                    code = fn.decoded
                    if v.vstate >= VState.ENDING:
                        continue
                    dt = (v.waketime - now) & _U32
                    v.waketime = now
                    # timing_interrupt path
                    rt_apply(v.waketime, dt)
                    if not dt:
                        continue
                    v.vstate = VState.WAITING
                    self.instructions += A2_INSLIMIT - inscount
                    v.waketime = (v.waketime + dt) & _U32
                    return A2Error.OK
                else:
                    fn = v.program.funcs[v.func]
                    code = fn.decoded
                    continue
            elif op == Op.CALL:
                res = self.voice_call(v, a2, cargv, 0)
                if res:
                    self.rt_error(res, "VM:CALL")
                    return res
                fn = v.program.funcs[v.func]
                code = fn.decoded
                cargv = []
                continue
            elif op == Op.JUMP:
                v.pc = a2
                continue
            elif op == Op.LOOP:
                r[a1] = sat32(r[a1] - 65536)
                if r[a1] <= 0:
                    pass
                else:
                    v.pc = a2
                    continue
            elif op == Op.JZ:
                if not r[a1]:
                    v.pc = a2
                    continue
            elif op == Op.JNZ:
                if r[a1]:
                    v.pc = a2
                    continue
            elif op == Op.JG:
                if r[a1] > 0:
                    v.pc = a2
                    continue
            elif op == Op.JL:
                if r[a1] < 0:
                    v.pc = a2
                    continue
            elif op == Op.JGE:
                if r[a1] >= 0:
                    v.pc = a2
                    continue
            elif op == Op.JLE:
                if r[a1] <= 0:
                    v.pc = a2
                    continue
            elif op == Op.DELAY:
                dt = ms2t(a3)
                v.pc += 2
                # timing path
                rt_apply(v.waketime, dt)
                if not dt:
                    continue
                v.vstate = VState.WAITING
                self.instructions += A2_INSLIMIT - inscount
                v.waketime = (v.waketime + dt) & _U32
                return A2Error.OK
            elif op == Op.DELAYR:
                dt = ms2t(r[a1])
                v.pc += 1
                rt_apply(v.waketime, dt)
                if not dt:
                    continue
                v.vstate = VState.WAITING
                self.instructions += A2_INSLIMIT - inscount
                v.waketime = (v.waketime + dt) & _U32
                return A2Error.OK
            elif op == Op.TDELAY:
                dt = ticks2t(a3)
                v.pc += 2
                rt_apply(v.waketime, dt)
                if not dt:
                    continue
                v.vstate = VState.WAITING
                self.instructions += A2_INSLIMIT - inscount
                v.waketime = (v.waketime + dt) & _U32
                return A2Error.OK
            elif op == Op.TDELAYR:
                dt = ticks2t(r[a1])
                v.pc += 1
                rt_apply(v.waketime, dt)
                if not dt:
                    continue
                v.vstate = VState.WAITING
                self.instructions += A2_INSLIMIT - inscount
                v.waketime = (v.waketime + dt) & _U32
                return A2Error.OK
            elif op == Op.SLEEP:
                rt_apply(v.waketime, 0)
                v.vstate = VState.ENDING
                self.instructions += A2_INSLIMIT - inscount
                v.waketime = (v.waketime + 1000000) & _U32
                return A2Error.OK
            elif op == Op.WAKE or op == Op.FORCE:
                se = None
                for cand in reversed(v.stack):
                    se = cand
                    if cand.state != VState.INTERRUPT:
                        break
                if se is not None:
                    if op == Op.WAKE and se.state < VState.ENDING:
                        pass
                    else:
                        se.pc = a2
                        se.state = VState.RUNNING
                        se.waketime = v.waketime
            elif op == Op.SUBR:
                r[a1] = sat32(r[a1] - r[a2])
                rt_mark(a1)
            elif op == Op.DIVR:
                if not r[a2]:
                    self.rt_error(A2Error.DIVBYZERO, "VM:DIVR")
                    return A2Error.DIVBYZERO
                q = (r[a1] << 16)
                q = abs(q) // abs(r[a2]) * (1 if (q < 0) == (r[a2] < 0)
                                            else -1)
                r[a1] = sat32(q)
                rt_mark(a1)
            elif op == Op.P2DR:
                r[a1] = sat32(A2_1K_DIV_MIDDLEC // p2i(r[a2]))
                rt_mark(a1)
            elif op == Op.NEGR:
                r[a1] = sat32(-r[a2])
                rt_mark(a1)
            elif op == Op.LOAD:
                r[a1] = a3
                rt_mark(a1)
                v.pc += 1
            elif op == Op.LOADR:
                r[a1] = r[a2]
                rt_mark(a1)
            elif op == Op.ADD:
                r[a1] = sat32(r[a1] + a3)
                rt_mark(a1)
                v.pc += 1
            elif op == Op.ADDR:
                r[a1] = sat32(r[a1] + r[a2])
                rt_mark(a1)
            elif op == Op.MUL:
                r[a1] = sat32((r[a1] * a3) >> 16)
                rt_mark(a1)
                v.pc += 1
            elif op == Op.MULR:
                r[a1] = sat32((r[a1] * r[a2]) >> 16)
                rt_mark(a1)
            elif op == Op.MOD:
                r[a1] = sat32(_cmod(r[a1], a3))
                rt_mark(a1)
                v.pc += 1
            elif op == Op.MODR:
                if not r[a2]:
                    self.rt_error(A2Error.DIVBYZERO, "VM:MODR")
                    return A2Error.DIVBYZERO
                r[a1] = sat32(_cmod(r[a1], r[a2]))
                rt_mark(a1)
            elif op == Op.QUANT:
                r[a1] = sat32(_cdiv(r[a1], a3) * a3)
                rt_mark(a1)
                v.pc += 1
            elif op == Op.QUANTR:
                if not r[a2]:
                    self.rt_error(A2Error.DIVBYZERO, "VM:QUANTR")
                    return A2Error.DIVBYZERO
                r[a1] = sat32(_cdiv(r[a1], r[a2]) * r[a2])
                rt_mark(a1)
            elif op == Op.RAND:
                r[a1] = sat32((st.noisestate.next() * a3) >> 16)
                rt_mark(a1)
                v.pc += 1
            elif op == Op.RANDR:
                r[a1] = sat32((st.noisestate.next() * r[a2]) >> 16)
                rt_mark(a1)
            elif op == Op.GR:
                r[a1] = (1 << 16) if r[a1] > r[a2] else 0
                rt_mark(a1)
            elif op == Op.LR:
                r[a1] = (1 << 16) if r[a1] < r[a2] else 0
                rt_mark(a1)
            elif op == Op.GER:
                r[a1] = (1 << 16) if r[a1] >= r[a2] else 0
                rt_mark(a1)
            elif op == Op.LER:
                r[a1] = (1 << 16) if r[a1] <= r[a2] else 0
                rt_mark(a1)
            elif op == Op.EQR:
                r[a1] = (1 << 16) if r[a1] == r[a2] else 0
                rt_mark(a1)
            elif op == Op.NER:
                r[a1] = (1 << 16) if r[a1] != r[a2] else 0
                rt_mark(a1)
            elif op == Op.ANDR:
                r[a1] = (1 << 16) if (r[a1] and r[a2]) else 0
                rt_mark(a1)
            elif op == Op.ORR:
                r[a1] = (1 << 16) if (r[a1] or r[a2]) else 0
                rt_mark(a1)
            elif op == Op.XORR:
                r[a1] = (1 << 16) if (not r[a1]) != (not r[a2]) else 0
                rt_mark(a1)
            elif op == Op.NOTR:
                r[a1] = (1 << 16) if not r[a2] else 0
                rt_mark(a1)
            elif op == Op.SET:
                self.voice_control(v, a1, v.waketime, 0)
                rt_unmark(a1)
            elif op == Op.SETALL:
                for reg in rt_regs:
                    self.voice_control(v, reg, v.waketime, 0)
                rt_mask = 0
                rt_regs = []
            elif op == Op.RAMP:
                self.voice_control(v, a1, v.waketime, ms2t(a3))
                rt_unmark(a1)
                v.pc += 1
            elif op == Op.RAMPR:
                self.voice_control(v, a1, v.waketime, ms2t(r[a2]))
                rt_unmark(a1)
            elif op == Op.RAMPALL:
                rt_apply(v.waketime, ms2t(a3))
                rt_mask = 0
                rt_regs = []
                v.pc += 1
            elif op == Op.RAMPALLR:
                rt_apply(v.waketime, ms2t(r[a1]))
                rt_mask = 0
                rt_regs = []
            elif op == Op.PUSH:
                if len(cargv) >= A2_MAXARGS:
                    self.rt_error(A2Error.MANYARGS, "VM:PUSH")
                    return A2Error.MANYARGS
                cargv.append(a3)
                v.pc += 1
            elif op == Op.PUSHR:
                if len(cargv) >= A2_MAXARGS:
                    self.rt_error(A2Error.MANYARGS, "VM:PUSHR")
                    return A2Error.MANYARGS
                cargv.append(r[a1])
            elif op == Op.SPAWN:
                self.voice_spawn(v, a1, a2, cargv)
                cargv = []
            elif op == Op.SPAWNR:
                self.voice_spawn(v, a1, r[a2] >> 16, cargv)
                cargv = []
            elif op == Op.SPAWND:
                self.voice_spawn(v, -1, a2, cargv)
                cargv = []
            elif op == Op.SPAWNDR:
                self.voice_spawn(v, -1, r[a1] >> 16, cargv)
                cargv = []
            elif op == Op.SPAWNV:
                self.voice_spawn(v, r[a1] >> 16, a2, cargv)
                cargv = []
            elif op == Op.SPAWNVR:
                self.voice_spawn(v, r[a1] >> 16, r[a2] >> 16, cargv)
                cargv = []
            elif op == Op.SPAWNA:
                self.voice_spawn(v, -2, a2, cargv)
                cargv = []
            elif op == Op.SPAWNAR:
                self.voice_spawn(v, -2, r[a1] >> 16, cargv)
                cargv = []
            elif op == Op.SEND:
                sv = self.find_subvoice(v, a1)
                if sv is not None:
                    self.voice_send(sv, v.waketime, a2, cargv)
                cargv = []
            elif op == Op.SENDR:
                sv = self.find_subvoice(v, r[a1] >> 16)
                if sv is not None:
                    self.voice_send(sv, v.waketime, a2, cargv)
                cargv = []
            elif op == Op.SENDA:
                for sv in v.sub:
                    self.voice_send(sv, v.waketime, a2, cargv)
                cargv = []
            elif op == Op.SENDS:
                ep = v.program.eps[a2]
                if ep < 0:
                    self.rt_error(A2Error.BADENTRY, "VM:SENDS")
                    return A2Error.BADENTRY
                res = self.voice_call(v, ep, cargv, 1)
                if res:
                    self.rt_error(res, "VM:SENDS")
                    return res
                fn = v.program.funcs[v.func]
                code = fn.decoded
                cargv = []
            elif op == Op.WAIT:
                sv = self.find_subvoice(v, a1)
                if sv is None or sv.vstate >= VState.ENDING:
                    pass
                else:
                    rt_apply(v.waketime, 0)
                    v.waketime = (st.now_fragstart
                                  + (A2_MAXFRAG << 8)) & _U32
                    v.vstate = VState.WAITING
                    self.instructions += A2_INSLIMIT - inscount
                    return A2Error.OK
            elif op == Op.KILL:
                self.kill_subvoice(v, a1)
            elif op == Op.KILLR:
                self.kill_subvoice(v, r[a1] >> 16)
            elif op == Op.KILLA:
                for sv in v.sub:
                    self.voice_kill(sv, v.waketime)
                v.sv.clear()
            elif op == Op.DETACH:
                self.detach_subvoice(v, a1)
            elif op == Op.DETACHR:
                self.detach_subvoice(v, r[a1] >> 16)
            elif op == Op.DETACHA:
                for sv in v.sub:
                    self.voice_detach(sv, v.waketime)
                v.sv.clear()
            elif op == Op.DEBUG:
                print("debug %f" % (a3 / 65536.0))
                v.pc += 1
            elif op == Op.DEBUGR:
                print("debug R%d=%f" % (a1, r[a1] / 65536.0))
            elif op == Op.INITV:
                res = self.populate_voice(v.program, v)
                if res:
                    self.instructions += A2_INSLIMIT - inscount
                    return res
            elif op == Op.SIZEOF or op == Op.SIZEOFR:
                h = a2 if op == Op.SIZEOF else (r[a2] >> 16)
                w = self.state.interface.get_wave(h)
                if w is None or w.type not in (2, 3):
                    self.rt_error(A2Error.WRONGTYPE, "VM:SIZEOF")
                    return A2Error.WRONGTYPE
                r[a1] = sat32((w.size[0] << 16) // w.period)
                rt_mark(a1)
            else:
                self.rt_error(A2Error.ILLEGALOP, "VM")
                return A2Error.ILLEGALOP
            v.pc += 1

    # =====================================================
    #   Fragment processing (a2_VoiceProcess & friends)
    # =====================================================

    def process_vm_ev(self, v, now):
        """Process events + VM for the current position; returns frames
        until next event/instruction, or negative error
        (a2_VoiceProcessVMEv)."""
        while v.events:
            nextvm = tsdiff(v.waketime, now)
            nextev = tsdiff(v.events[0].timestamp, now)
            if nextvm > 255 and nextev > 255:
                return (nextvm >> 8) if nextvm < nextev else (nextev >> 8)
            if nextvm <= nextev:
                res = self.process_vm(v)
            else:
                res = self.process_events(v)
            if res:
                return -int(res)
        while True:
            nextvm = tsdiff(v.waketime, now)
            if nextvm > 255:
                return nextvm >> 8
            res = self.process_vm(v)
            if res:
                return -int(res)

    def process_voice(self, v, offset, frames):
        """Alternate VM and unit processing over one fragment
        (a2_VoiceProcess).  Returns (error, frames)."""
        s = offset
        s_stop = offset + frames
        while s < s_stop:
            now = (self.state.now_fragstart + (s << 8)) & _U32
            res = self.process_vm_ev(v, now)
            if res < 0:
                return -res, frames
            if s + res > s_stop:
                res = s_stop - s
            if self.recording:
                for u in v.units:
                    self._record_unit(u, s, res)
            else:
                for u in v.units:
                    u.process(s, res)
            s += res
        return 0, frames

    def _record_unit(self, u, offset, frames):
        """Recording pass: generators compute now (exact RNG order);
        deferred units emit device rows; effect units are queued."""
        kind = getattr(u, "record_kind", "proc")
        if kind == "defer":
            u.process_record(self, offset, frames)
        elif kind == "inline":
            self.oplist.append(("clear", u, offset, frames))
            self.process_subvoices(u.voice, offset, frames)
        elif kind == "gen":
            if u.noutputs:
                temps = [np.zeros(A2_MAXFRAG, dtype=np.int32)
                         for _ in range(u.noutputs)]
                real = u.outputs
                u.outputs = temps
                try:
                    u.process(offset, frames)
                finally:
                    u.outputs = real
                self.oplist.append(("stash", u, offset, frames, temps))
            else:
                u.process(offset, frames)   # env: control only
        else:
            self.oplist.append(("proc", u, offset, frames))

    def process_voices(self, vlist, offset, frames):
        """Process a voice list, recursing into subvoices
        (a2_ProcessVoices)."""
        i = 0
        while i < len(vlist):
            v = vlist[i]
            res, frames2 = self.process_voice(v, offset, frames)
            if not (v.flags & A2_SUBINLINE):
                self.process_subvoices(v, offset, frames)
            if res:
                self.voice_free(v, vlist, i)
            else:
                i += 1

    def process_subvoices(self, v, offset, frames):
        if not v.sub:
            return
        self.process_voices(v.sub, offset, frames)
        if not v.sub and v.vstate >= VState.ENDING:
            v.waketime = (self.state.now_fragstart + (frames << 8)) & _U32

    # =====================================================
    #   The "audio callback" (a2_AudioCallback / a2_Run)
    # =====================================================

    def run(self, frames):
        """Drive the engine for 'frames' frames (offline operation).
        Output goes to the sink callbacks.  Wall-time statistics per
        callback are kept like the reference's CPU-load tracing
        (core.c:1976-1997): cputimeavg/max in microseconds, load as a
        percentage of the rendered time."""
        import time as _t
        t0 = _t.perf_counter()
        md = self.state.midi_driver
        if md is not None:
            md.poll(frames)         # once per buffer (a2_PollMIDI)
        try:
            if self.batched:
                return self.run_batched(frames)
            return self._run_interleaved(frames)
        finally:
            dur = int((_t.perf_counter() - t0) * 1e6)
            self.cputimesum += dur
            self.cputimecount += 1
            if dur > self.cputimemax:
                self.cputimemax = dur
            self.cputimeavg = self.cputimesum // self.cputimecount
            audio_us = frames * 1e6 / self.state.config.samplerate
            load = int(dur * 100 / audio_us) if audio_us else 0
            if load > self.cpuloadmax:
                self.cpuloadmax = load
            self.cpuloadavg = int(
                self.cputimesum * 100
                / (self.cputimecount * audio_us)) if audio_us else 0

    def _run_interleaved(self, frames):
        st = self.state
        st.now_frames = (st.now_fragstart + (frames << 8)) & _U32
        self.pump_api_messages()
        remain = frames
        out = [np.empty(frames, dtype=np.int32)
               for _ in range(self.master.channels)]
        offset = 0
        while remain:
            frag = min(remain, A2_MAXFRAG)
            self.master.clear(0, frag)
            rootlist = [self.rootvoice]
            self.process_voices(rootlist, 0, frag)
            for c in range(self.master.channels):
                out[c][offset:offset + frag] = \
                    self.master.buffers[c][:frag]
            offset += frag
            remain -= frag
            st.now_fragstart = (st.now_fragstart + (frag << 8)) & _U32
        for cb in self.sinks:
            cb(out, frames)
        return frames

    def run_batched(self, frames):
        """Superblock record -> device dispatch -> replay.

        P1 (record): run the VM/event control plane for every fragment
        of this buffer; generators compute inline (exact RNG order),
        deferred oscillators emit device rows, effect units are queued.
        P2: evaluate all rows in one batched dispatch (TPU via JAX, or
        the numpy twin).  P3 (replay): apply writes / row audio / host
        effects in the exact recorded order and fill the output.

        The phases are split so a multi-engine scheduler can merge the row
        batches of many engine instances into one device dispatch.
        """
        frags, oplists, rowbatch = self.record_superblock(frames)
        if self.device_mix:
            res = self._try_device_mix(frames, frags, oplists, rowbatch)
            if res is not None:
                return res
        if rowbatch.n:
            rows = rowbatch.evaluate(self._atlas, use_jax=self.use_jax)
        else:
            rows = None
        return self.replay_superblock(frames, frags, oplists, rows)

    def _try_device_mix(self, frames, frags, oplists, rowbatch):
        """Full-superblock device render (tpu/superblock.py): rows +
        bus mixing + effect chains on the TPU, master-only readback.
        Returns frames on success, None to fall back to host replay
        (safe: compilation never mutates engine state)."""
        from ..tpu.superblock import (compile_superblock, DeviceMixer,
                                      Unsupported)
        try:
            prog = compile_superblock(self, frags, oplists, rowbatch)
        except Unsupported:
            if self._device_committed:
                # stateful unit state (fbdelay rings) lives on the
                # device; host replay would diverge
                raise
            return None
        if prog.fbdelays:
            self._device_committed = True
        if self.device_mixer is None:
            self.device_mixer = DeviceMixer(self)
        bufs = self.device_mixer.run(prog)
        self._replay_control_only(frags, oplists)
        out = bufs[:self.master.channels]
        for cb in self.sinks:
            cb(out, frames)
        return frames

    def _replay_control_only(self, frags, oplists):
        """Advance host-side unit control state exactly as the host
        replay would (writes, ramper prepare/run per slice, deinit) —
        the audio itself was produced on the device."""
        from ..units.host_units import (PanmixUnit, XInsertUnit,
                                        FbdelayUnit)
        for frag, ops in zip(frags, oplists):
            for e in ops:
                tag = e[0]
                if tag == "write":
                    e[1](e[2], e[3], e[4])
                elif tag == "proc":
                    u, o, f = e[1], e[2], e[3]
                    if isinstance(u, PanmixUnit):
                        u.vol.prepare(f)
                        if not (u.ninputs == 1 and u.noutputs == 1):
                            u.pan.prepare(f)
                            u.vol.run(f)
                            u.pan.run(f)
                        else:
                            u.vol.run(f)
                    elif isinstance(u, FbdelayUnit):
                        u.bufpos += f
                elif tag == "deinit":
                    e[1].deinitialize()

    def record_superblock(self, frames):
        """P1: run the control plane for the whole buffer, recording
        the op list and the oscillator row batch."""
        from ..tpu.row_kernel import RowBatch
        st = self.state
        st.now_frames = (st.now_fragstart + (frames << 8)) & _U32
        self.pump_api_messages()

        self.recording = True
        self.rowbatch = RowBatch()
        oplists = []
        frags = []
        remain = frames
        while remain:
            frag = min(remain, A2_MAXFRAG)
            self.oplist = []
            rootlist = [self.rootvoice]
            self.process_voices(rootlist, 0, frag)
            oplists.append(self.oplist)
            frags.append(frag)
            remain -= frag
            st.now_fragstart = (st.now_fragstart + (frag << 8)) & _U32
        self.recording = False
        self.oplist = None
        rowbatch = self.rowbatch
        self.rowbatch = None
        return frags, oplists, rowbatch

    def replay_superblock(self, frames, frags, oplists, rows):
        """P3: apply recorded ops (with evaluated row audio) in
        order and emit the buffer to the sinks."""
        out = [np.empty(frames, dtype=np.int32)
               for _ in range(self.master.channels)]
        offset = 0
        for frag, ops in zip(frags, oplists):
            self.master.clear(0, frag)
            for e in ops:
                tag = e[0]
                if tag == "row":
                    # row sample 0 corresponds to the slice start
                    _, u, idx, o, f = e
                    r = rows[idx]
                    for ch in range(u.noutputs):
                        u.outputs[ch][o:o + f] += \
                            r[ch, :f].astype(np.int32)
                elif tag == "proc":
                    _, u, o, f = e
                    u.process(o, f)
                elif tag == "write":
                    wcb, value, start, dur = e[1], e[2], e[3], e[4]
                    wcb(value, start, dur)
                elif tag == "stash":
                    _, u, o, f, temps = e
                    add = bool(u.flags & 0x0001)    # A2_PROCADD
                    for ch in range(u.noutputs):
                        if add:
                            u.outputs[ch][o:o + f] += temps[ch][o:o + f]
                        else:
                            u.outputs[ch][o:o + f] = temps[ch][o:o + f]
                elif tag == "clear":
                    _, u, o, f = e
                    if not (u.flags & 0x0001):
                        for b in u.outputs:
                            b[o:o + f] = 0
                elif tag == "deinit":
                    e[1].deinitialize()
            for c in range(self.master.channels):
                out[c][offset:offset + frag] = \
                    self.master.buffers[c][:frag]
            offset += frag
        for cb in self.sinks:
            cb(out, frames)
        return frames

    def pump_api_messages(self):
        # timestamp deadline margin statistics (interface.c:146-155,
        # core.c:1939-1958): per message, tsdiff vs the late limit;
        # avg recomputed per buffer; reset requested via properties
        if self.tsstatreset:
            self.tsstatreset = False
            self.tssamples = 0
            self.tssum = 0
            self.tsmin = 0x7FFFFFFF
            self.tsmax = -0x80000000
        msgs = self.apimsgs
        self.apimsgs = []
        for target, e in msgs:
            self.apimessages += 1
            q = self.get_event_queue(target)
            if q is None:
                self.rt_error(A2Error.BADVOICE, "pump")
                continue
            td = tsdiff(e.timestamp, self._pump_latelimit())
            if td < self.tsmin:
                self.tsmin = td
            if td > self.tsmax:
                self.tsmax = td
            self.tssum += td >> 8
            self.tssamples += 1
            if td < 0:
                self.rt_error(A2Error.LATEMESSAGE, "pump")
                e.timestamp = self._pump_latelimit()
            send_event(q, e)
        if self.tssamples:
            self.tsavg = (self.tssum << 8) // self.tssamples

    def _pump_latelimit(self):
        # The reference pumps with latelimit = previous now_frames; for
        # the offline engine the equivalent bound is the start of the
        # current buffer.
        return self.state.now_fragstart

    def get_event_queue(self, handle):
        hi = self.state.ss.hm.get(handle)
        if hi is None:
            return None
        if hi.typecode == A2ObjType.NEWVOICE:
            if hi.data is None:
                hi.data = []
            return hi.data
        if hi.typecode == A2ObjType.VOICE:
            return hi.data.events
        return None

    # =====================================================
    #   API entry points (timestamped async messages)
    # =====================================================

    def api_start(self, parent, program, argv, timestamp):
        hm = self.state.ss.hm
        vh = hm.new(None, A2ObjType.NEWVOICE)
        e = Event(EV_START, timestamp, program=program, voice=vh,
                  argv=list(argv))
        self.apimsgs.append((parent, e))
        return vh

    def api_play(self, parent, program, argv, timestamp):
        e = Event(EV_PLAY, timestamp, program=program, argv=list(argv))
        self.apimsgs.append((parent, e))
        return A2Error.OK

    def api_send(self, voice, ep, argv, timestamp):
        if ep >= 8:
            raise A2Exception(A2Error.INDEXRANGE)
        e = Event(EV_SEND, timestamp, program=ep, argv=list(argv))
        self.apimsgs.append((voice, e))
        return A2Error.OK

    def api_sendsub(self, voice, ep, argv, timestamp):
        e = Event(EV_SENDSUB, timestamp, program=ep, argv=list(argv))
        self.apimsgs.append((voice, e))
        return A2Error.OK

    def api_kill(self, voice, timestamp):
        e = Event(EV_KILL, timestamp)
        self.apimsgs.append((voice, e))
        return A2Error.OK

    def api_killsub(self, voice, timestamp):
        e = Event(EV_KILLSUB, timestamp)
        self.apimsgs.append((voice, e))
        return A2Error.OK

    def api_detach(self, voice, timestamp):
        return self.api_release_voice(voice, timestamp)

    def api_release_voice(self, voice, timestamp):
        e = Event(EV_RELEASE, timestamp)
        self.apimsgs.append((voice, e))
        return A2Error.OK

    # =====================================================
    #   xinsert client hosting
    # =====================================================

    def xinsert_add_client(self, v, xic):
        for u in v.units:
            if getattr(u, "is_xinsert", False):
                return u.add_client(xic)
        return A2Error.NOXINSERT

    def xinsert_remove_client(self, xic):
        if xic.unit is not None:
            return xic.unit.remove_client(xic)
        return A2Error.OK


def _cdiv(a, b):
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _cmod(a, b):
    return a - _cdiv(a, b) * b
