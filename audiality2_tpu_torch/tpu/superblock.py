"""The host engine's device mixer (``device_mix=True``), without JAX.

The copied ``engine/core.py`` imports ``compile_superblock``,
``DeviceMixer`` and ``Unsupported`` from here (its
``_try_device_mix``).  ``compile_superblock`` and the helpers and
constants it reaches are verbatim copies from
``audiality2_tpu/tpu/superblock.py`` (``tests/test_torch_device_mix.py``
holds their source text equal): it turns one recorded superblock of the
batched engine (the op tape and the row batch) into the
``SuperblockProgram`` of ``cuda/superblock.py``, or raises
``Unsupported`` for what the device program cannot express, and the
engine replays the superblock on the host instead.  ``DeviceMixer`` is
the port's ``TorchMixer`` on the device of the calling thread's row
batches (``tpu.row_kernel.thread_device``: the card, unless a caller
chose another device with ``row_device``).

Usage::

    i = audiality2_tpu_torch.open_engine(44100, 4096, 2,
                                         device_mix=True)
"""

import numpy as np

from ..constants import A2_PROCADD
from ..units.ramper import Ramper
from ..cuda import osc_kernel as OK
from ..cuda.mixer import TorchMixer
from ..cuda.superblock import (FRAG, SuperblockProgram, Unsupported,
                               _FBD_BUFSIZE, _build_runs, _pow2)
from .row_kernel import thread_device

__all__ = ["DeviceMixer", "Unsupported", "compile_superblock"]


def _shadow_ramper(r):
    s = Ramper(0)
    s.value, s.target, s.delta, s.timer = r.value, r.target, r.delta, \
        r.timer
    return s


class _PanmixShadow:
    def __init__(self, u):
        self.vol = _shadow_ramper(u.vol)
        self.pan = _shadow_ramper(u.pan)


class _FbdelayShadow:
    def __init__(self, u):
        self.samplerate = u.samplerate
        self.fbdelay = u.fbdelay
        self.ldelay = u.ldelay
        self.rdelay = u.rdelay
        self.drygain = u.drygain
        self.fbgain = u.fbgain
        self.lgain = u.lgain
        self.rgain = u.rgain


def _trunc_div_c(a, b):
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


# mode bits for rows (bits 1/2/4 are shared with the fused panmix
# in the pallas kernel — keep in sync with osc_kernel.ROW_*)
_ROW_HASPM = OK.ROW_HASPM       # 1
_ROW_STEREO = OK.ROW_STEREO     # 2
_ROW_CLAMP = OK.ROW_CLAMP       # 4
# noise row (native a2rt_record.inc RM_NOISE): the run is a pitched
# S&H LCG oscillator (reference wtosc.c:129-152); RC_SIZE carries the
# global RNG state and RC_POSOFF the held sample at the run's first
# real sample.  Noise runs live in pseudo pass class 0 (no wavetable)
# and are expanded as closed-form crossing counts + an LCG log-jump.
_ROW_NOISE = 8
# dc row (native a2rt_record.inc RM_DC, RF_WAVE == -2): pseudo pass
# class 0 like noise; the device emits the per-sample amp ramp value
# itself (dc.c LINEAR out[n] = value + n*delta after PrepareRamper)
_ROW_DC = 16


def compile_superblock(core, frags, oplists, rowbatch):
    """Builds a SuperblockProgram from one recorded superblock.
    Raises Unsupported if the tape can't run fully on-device."""
    from ..units.host_units import (PanmixUnit, XInsertUnit,
                                    FbdelayUnit, InlineUnit)
    from ..units.deferred import DeferredPanmix, DeferredWtosc

    F = len(frags)
    prog = SuperblockProgram()
    prog.F = F
    prog.frag_sizes = list(frags)

    # ----- instance table; master is instance 0 -----
    inst_ids = {}

    def inst_of(u):
        i = inst_ids.get(id(u))
        if i is None:
            i = len(inst_ids) + 1          # 0 is master
            inst_ids[id(u)] = i
        return i

    master_bind = {}
    mch = core.master.channels
    for ch in range(mch):
        master_bind[id(core.master.buffers[ch])] = (0, ch)
    prog.master_inst = 0
    prog.master_channels = mch

    shadows = {}
    stages = {}          # (nest, chain, kind, variant) -> entry lists
    fbd_insts = {}       # id(u) -> dict
    rows_slot = np.full(rowbatch.n, -1, np.int64)
    rows_off = np.zeros(rowbatch.n, np.int32)
    rows_frm = np.zeros(rowbatch.n, np.int32)
    stash_list = []

    def depth_key(u):
        # assigned at populate time (engine/core.py) so it survives
        # the voice dying mid-superblock
        return u.depth_key

    for fi, ops in enumerate(oplists):
        binding = dict(master_bind)
        for e in ops:
            tag = e[0]
            if tag == "clear":
                u = e[1]
                if u.flags & A2_PROCADD:
                    raise Unsupported("inline in adding mode")
                ii = inst_of(u)
                for ch, buf in enumerate(u.outputs):
                    binding[id(buf)] = (ii, ch)
            elif tag == "row":
                _, u, idx, o, f = e
                b0 = binding.get(id(u.outputs[0]))
                if b0 is None:
                    raise Unsupported("row into unbound bus")
                ii, ch0 = b0
                if ch0 != 0:
                    raise Unsupported("row channel offset")
                if len(u.outputs) == 2:
                    b1 = binding.get(id(u.outputs[1]))
                    if b1 != (ii, 1):
                        raise Unsupported("row split across buses")
                if not (u.flags & A2_PROCADD) and not isinstance(
                        u, (DeferredPanmix, DeferredWtosc)):
                    raise Unsupported("replacing row")
                rows_slot[idx] = ii * F + fi
                rows_off[idx] = o
                rows_frm[idx] = f
            elif tag == "stash":
                _, u, o, f, bufs = e
                if not (u.flags & A2_PROCADD):
                    raise Unsupported("replacing stash")
                audio = np.zeros((2, FRAG), np.int32)
                slot = None
                for ch, buf in enumerate(bufs):
                    b = binding.get(id(u.outputs[ch]))
                    if b is None:
                        raise Unsupported("stash into unbound bus")
                    ii, bch = b
                    if slot is None:
                        slot = ii * F + fi
                    elif slot != ii * F + fi or bch != ch:
                        raise Unsupported("stash channel mismatch")
                    audio[bch, o:o + f] = buf[o:o + f]
                stash_list.append((slot, audio))
            elif tag == "write":
                wcb, value, start, dur = e[1], e[2], e[3], e[4]
                u, j = e[5], e[6]
                if u is None:
                    raise Unsupported("untagged write")
                sh = shadows.get(id(u))
                if sh is None:
                    if isinstance(u, PanmixUnit):
                        sh = _PanmixShadow(u)
                    elif isinstance(u, FbdelayUnit):
                        sh = _FbdelayShadow(u)
                    else:
                        raise Unsupported(
                            "write to %s" % type(u).__name__)
                    shadows[id(u)] = sh
                if isinstance(u, PanmixUnit):
                    (sh.vol if j == 0 else sh.pan).set(value, start, dur)
                else:
                    if j < 3:
                        v = _trunc_div_c(value * sh.samplerate,
                                         65536000)
                        setattr(sh, ("fbdelay", "ldelay", "rdelay")[j],
                                v)
                    else:
                        setattr(sh, ("drygain", "fbgain", "lgain",
                                     "rgain")[j - 3], value)
            elif tag == "proc":
                _, u, o, f = e
                if isinstance(u, PanmixUnit):
                    sh = shadows.get(id(u))
                    if sh is None:
                        sh = _PanmixShadow(u)
                        shadows[id(u)] = sh
                    ni, no = u.ninputs, u.noutputs
                    add = bool(u.flags & A2_PROCADD)
                    srcs = [binding.get(id(b)) for b in
                            u.inputs[:ni]]
                    dsts = [binding.get(id(b)) for b in
                            u.outputs[:no]]
                    if any(s is None for s in srcs + dsts):
                        raise Unsupported("panmix unbound bus")
                    si = srcs[0][0]
                    di = dsts[0][0]
                    if any(s[0] != si for s in srcs) or \
                            any(d[0] != di for d in dsts):
                        raise Unsupported("panmix cross-bus channels")
                    sch = tuple(s[1] for s in srcs)
                    dch = tuple(d[1] for d in dsts)
                    sh.vol.prepare(f)
                    if ni == 1 and no == 1:
                        entry = (si * F + fi, di * F + fi, o, f,
                                 sh.vol.value, sh.vol.delta, 0, 0, 0)
                        sh.vol.run(f)
                    else:
                        sh.pan.prepare(f)
                        clamp = int(sh.pan.target > 0xFFFFFF
                                    or sh.pan.target < -0xFFFFFF
                                    or sh.pan.value > 0xFFFFFF
                                    or sh.pan.value < -0xFFFFFF)
                        entry = (si * F + fi, di * F + fi, o, f,
                                 sh.vol.value, sh.vol.delta,
                                 sh.pan.value, sh.pan.delta, clamp)
                        sh.vol.run(f)
                        sh.pan.run(f)
                    key = depth_key(u) + ("panmix", ni, no, add,
                                          sch, dch)
                    stages.setdefault(key, []).append(entry)
                elif isinstance(u, XInsertUnit):
                    if u.clients:
                        raise Unsupported("xinsert with clients")
                    n = u.ninputs
                    add = bool(u.flags & A2_PROCADD)
                    for ch in range(n):
                        s = binding.get(id(u.inputs[ch]))
                        d = binding.get(id(u.outputs[ch]))
                        if s is None or d is None:
                            raise Unsupported("xinsert unbound bus")
                        key = depth_key(u) + ("copy", ch, add,
                                              (s[1],), (d[1],))
                        stages.setdefault(key, []).append(
                            (s[0] * F + fi, d[0] * F + fi, o, f,
                             0, 0, 0, 0, 0))
                elif isinstance(u, FbdelayUnit):
                    sh = shadows.get(id(u))
                    if sh is None:
                        sh = _FbdelayShadow(u)
                        shadows[id(u)] = sh
                    mind = min(sh.fbdelay, sh.ldelay, sh.rdelay)
                    if mind < f or sh.fbdelay < f:
                        raise Unsupported("fbdelay shorter than slice")
                    srcs = [binding.get(id(b)) for b in u.inputs]
                    dsts = [binding.get(id(b)) for b in u.outputs]
                    if any(x is None for x in srcs + dsts):
                        raise Unsupported("fbdelay unbound bus")
                    fd = fbd_insts.get(id(u))
                    if fd is None:
                        fd = {"unit": u, "key": depth_key(u),
                              "stereoin": u.ninputs == 2,
                              "stereoout": u.noutputs == 2,
                              "add": bool(u.flags & A2_PROCADD),
                              "slices": []}
                        fbd_insts[id(u)] = fd
                    fd["slices"].append(
                        (srcs[0][0] * F + fi,
                         srcs[-1][0] * F + fi,
                         dsts[0][0] * F + fi,
                         dsts[-1][0] * F + fi,
                         o, f, sh.fbdelay, sh.ldelay, sh.rdelay,
                         sh.drygain, sh.fbgain, sh.lgain, sh.rgain))
                else:
                    raise Unsupported("proc %s" % type(u).__name__)
            elif tag == "deinit":
                pass
            else:
                raise Unsupported("op %s" % tag)

    if rowbatch.n and (rows_slot < 0).any():
        raise Unsupported("orphan rows")

    # pad the instance count to a power of two (min 4) so the slot
    # array shape — and thus the jit signature — stays stable as
    # groups come and go
    prog.ninst = _pow2(len(inst_ids) + 1, 4)

    # ----- rows -> 1-fragment runs for the device expansion -----
    R = rowbatch.n
    if R:
        cls_arr = np.empty(R, np.int32)
        tbase = np.empty(R, np.int32)
        posoff = np.empty(R, np.int32)
        ph_hi = np.empty(R, np.int32)
        ph_lo = np.empty(R, np.int32)
        for i in range(R):
            w, mm = rowbatch.wavemip[i]
            if w is None:
                raise Unsupported("row without wave key")
            tb, npz, off = core.pair_atlas_entry(w, mm)
            # shift the row back by its slice offset so the kernel
            # computes directly at absolute frame positions (frame n
            # = slice sample n-off); exact because the kernel's phase
            # and amp arithmetic are mod-2^32 / carried exactly, and
            # frames outside [off, off+frm) are masked before the
            # slot scatter.
            so = int(rows_off[i])
            ph_s = rowbatch.ph0[i] - so * rowbatch.dph[i]
            tbase[i] = tb
            cls_arr[i] = OK.pass_class(npz)
            posoff[i] = off
            ph_hi[i] = np.int64(ph_s >> 32).astype(np.int32)
            ph_lo[i] = np.int64(ph_s & 0xFFFFFFFF).astype(np.int32)
        so_a = rows_off[:R].astype(np.int64)
        amp_s = (np.asarray(rowbatch.amp0, np.int64)
                 - so_a * np.asarray(rowbatch.damp, np.int64)) \
            .astype(np.int32)
        # vol/pan are fragment-frame-0 normalized like phase/amp
        vol_s = (np.asarray(rowbatch.vol0, np.int64)
                 - so_a * np.asarray(rowbatch.dvol, np.int64)) \
            .astype(np.int32)
        pan_s = (np.asarray(rowbatch.pan0, np.int64)
                 - so_a * np.asarray(rowbatch.dpan, np.int64)) \
            .astype(np.int32)
        mode = (np.asarray(rowbatch.haspm, bool) * _ROW_HASPM
                + np.asarray(rowbatch.stereo, bool) * _ROW_STEREO
                + np.asarray(rowbatch.clamp, bool) * _ROW_CLAMP) \
            .astype(np.int32)
        _build_runs(
            prog, cls_arr, tbase, posoff, ph_hi, ph_lo,
            np.asarray(rowbatch.dph, np.int64).astype(np.int32),
            np.zeros(R, np.int32), amp_s,
            np.asarray(rowbatch.damp, np.int64).astype(np.int32),
            vol_s,
            np.asarray(rowbatch.dvol, np.int64).astype(np.int32),
            pan_s,
            np.asarray(rowbatch.dpan, np.int64).astype(np.int32),
            rows_slot[:R].astype(np.int32), mode,
            rows_off[:R].astype(np.int32),
            rows_frm[:R].astype(np.int32),
            np.ones(R, np.int32))

    # ----- stash -----
    if stash_list:
        NS = _pow2(len(stash_list), 64)
        sa = np.zeros((NS, 2, FRAG), np.int32)
        ssl = np.full(NS, prog.ninst * F, np.int32)
        stash_list.sort(key=lambda t: t[0])   # sorted segment-sum
        for i, (slot, audio) in enumerate(stash_list):
            sa[i] = audio
            ssl[i] = slot
        prog.stash_audio = sa
        prog.stash_slot = ssl

    # ----- stages -----
    for key in sorted(stages.keys()):
        nest, chain, kind = key[0], key[1], key[2]
        entries = stages[key]
        K = _pow2(len(entries), 128)   # min pad: stable jit shapes
        arr = np.zeros((K, 9), np.int32)
        arr[:, 0] = prog.ninst * F     # dead src for padding
        arr[:, 1] = prog.ninst * F
        entries = sorted(entries, key=lambda en: en[1])  # sorted emit
        for i, en in enumerate(entries):
            arr[i] = en
        prog.stages.append({"kind": kind, "key": key, "arr": arr,
                            "n": len(entries),
                            "dense": np.zeros((0, F, 9), np.int32)})

    # fbdelay instances are stage ops too — insert in depth order
    for fd in fbd_insts.values():
        sl = fd["slices"]
        # chunked scan: C consecutive slices are processed in one
        # vectorized step — exact because the FEEDBACK delay is at
        # least the chunk's ring span (reader taps run vectorized
        # against the final ring; min delay >= slice frames is
        # already enforced above)
        if prog.F * FRAG + (1 << 17) > _FBD_BUFSIZE:
            raise Unsupported("superblock too long for fbdelay ring")
        mind = min(s[6] for s in sl)
        C = 1
        while C * 2 * FRAG <= mind and C < 1024:
            C *= 2
        ns = _pow2(len(sl), C)
        ns = ((ns + C - 1) // C) * C
        arr = np.zeros((ns, 13), np.int32)
        arr[:, :4] = prog.ninst * F  # dead src/dst (sorted emit)
        for i, s in enumerate(sl):
            arr[i] = s
        arr[len(sl):, 5] = 0                    # frames=0 -> no-op
        prog.fbdelays.append({
            "unit_id": id(fd["unit"]), "key": fd["key"],
            "stereoin": fd["stereoin"], "stereoout": fd["stereoout"],
            "add": fd["add"], "arr": arr, "n": len(sl), "chunk": C,
            "dense": False})

    return prog


class DeviceMixer(TorchMixer):
    """The JAX package's ``DeviceMixer(core)`` for the host engine: a
    ``TorchMixer`` on ``tpu.row_kernel.thread_device()`` (the card by
    default), unprofiled (pow2 shape padding, unpacked uploads)."""

    def __init__(self, core, **kw):
        kw.setdefault("device", thread_device())
        super().__init__(core, **kw)
