"""Host (numpy) implementations of the built-in voice units.

These are the engine-context DSP processors: int32 8:24 audio,
bit-exact with the reference's integer DSP (each unit's behavioral
contract cited from src/units/*.c).  Inner loops are vectorized with
int64 numpy where the math is order-independent; the few genuinely
sample-serial recurrences (filter12/dcblock state, limiter peak
tracker, FM feedback) run as short per-fragment loops.

The TPU path (audiality2_tpu.tpu) implements the same units as
voice-batched JAX kernels; this module is the correctness reference
and the offline fallback.
"""

import numpy as np

from ..constants import (
    A2_MAXFRAG, A2_MAXPHINC, A2_MIPLEVELS, A2_PROCADD, A2_WAVEPRE,
    R_TRANSPOSE, WaveType,
)
from ..errors import A2Error
from ..fixmath import p2i, sat32
from .ramper import Ramper

_U32 = 0xFFFFFFFF
_U64 = (1 << 64) - 1


def _sh(x, n):
    """Arithmetic shift right on numpy int64 arrays/ints."""
    return x >> n


class HostUnit:
    """Base class for engine-context unit instances."""

    is_xinsert = False
    # batched-engine classification: "proc" units are replayed after
    # the device dispatch (effects, need their inputs); "gen" units
    # compute at record time (generators; preserves shared-RNG order);
    # "inline"/"defer" are special-cased.
    record_kind = "proc"
    queue_writes = True

    def __init__(self, state, desc, voice, ninputs, inputs, noutputs,
                 outputs):
        self.state = state
        self.desc = desc
        self.voice = voice
        self.ninputs = ninputs
        self.inputs = inputs       # list of np.int32[A2_MAXFRAG]
        self.noutputs = noutputs
        self.outputs = outputs
        self.regbase = 0
        self.flags = 0

    # Write callbacks, one per control register, in descriptor order.
    def write_callbacks(self):
        return []

    def set_reg(self, idx, value):
        self.voice.r[self.regbase + idx] = value

    def get_reg(self, idx):
        return self.voice.r[self.regbase + idx]

    def initialize(self, flags):
        self.flags = flags
        return 0

    def deinitialize(self):
        pass

    def process(self, offset, frames):
        pass

    def set_coutput(self, index, cport):
        pass

    # output helper
    def _out(self, ch, offset, frames, data):
        o = self.outputs[ch]
        if self.flags & A2_PROCADD:
            o[offset:offset + frames] += data.astype(np.int32)
        else:
            o[offset:offset + frames] = data.astype(np.int32)


# =========================================================
#   inline — runs subvoices inside the unit chain
#   (src/units/inline.c, core.c:1763-1776)
# =========================================================

class InlineUnit(HostUnit):
    record_kind = "inline"
    queue_writes = False

    def initialize(self, flags):
        self.flags = flags
        v = self.voice
        v.noutputs = self.noutputs
        v.outputs = self.outputs
        self.core = self.state.core
        return 0

    def process(self, offset, frames):
        if not (self.flags & A2_PROCADD):
            for o in self.outputs:
                o[offset:offset + frames] = 0
        self.core.process_subvoices(self.voice, offset, frames)


# =========================================================
#   wtosc — mipmapped wavetable oscillator (src/units/wtosc.c)
# =========================================================

_WTOSC_MAXLENGTH = 0x01000000 - A2_WAVEPRE - 131   # A2_WTOSC_MAXLENGTH


def _hermite_vec(d32, idx, x):
    """Vectorized a2_Hermite (a2_dsp.h:64-74): d32 is the padded wave
    as int64 (index 0 == d[-A2_WAVEPRE]); idx/x already split.
    Indexing is relative to d = data + A2_WAVEPRE."""
    i = idx + A2_WAVEPRE
    dm1 = d32[i - 1]
    d0 = d32[i]
    d1 = d32[i + 1]
    d2 = d32[i + 2]
    xx = x << 7
    c = _sh(d1 - dm1, 1)
    a = _sh(3 * (d0 - d1) + d2 - dm1, 1)
    b = dm1 - d0 + c - a
    a = _sh(a * xx, 15)
    a = _sh((a + b) * xx, 15)
    return d0 + _sh((a + c) * xx, 15)


def _lerp_vec(d32, idx, x):
    i = idx + A2_WAVEPRE
    return _sh(d32[i] * (256 - x) + d32[i + 1] * x, 8)


def _inter_vec(d32, ph16, dph16):
    """A2_HIFI interpolation: 2x oversampled Hermite (wtosc.c:29-33).
    ph16: 16.8-style phase (sample index << 8 | frac)."""
    v1 = _hermite_vec(d32, ph16 >> 8, ph16 & 0xFF)
    ph2 = ph16 + (dph16 >> 1)
    v2 = _hermite_vec(d32, ph2 >> 8, ph2 & 0xFF)
    return v1 + v2


def _inter_vec_normal(d32, ph16, dph16):
    """Default quality: 2x oversampled linear (wtosc.c:41-46)."""
    v1 = _lerp_vec(d32, ph16 >> 8, ph16 & 0xFF)
    ph2 = ph16 + (dph16 >> 1)
    v2 = _lerp_vec(d32, ph2 >> 8, ph2 & 0xFF)
    return v1 + v2


def _inter_vec_lofi(d32, ph16, dph16):
    """A2_LOFI: plain linear, doubled (wtosc.c:34-39)."""
    return _lerp_vec(d32, ph16 >> 8, ph16 & 0xFF) << 1


_INTER_BY_QUALITY = {"hifi": _inter_vec, "normal": _inter_vec_normal,
                     "lofi": _inter_vec_lofi}


class WtoscUnit(HostUnit):
    record_kind = "gen"
    queue_writes = False
    R_W, R_P, R_A, R_PHASE = 0, 1, 2, 3

    def initialize(self, flags):
        self.flags = flags
        st = self.state
        self._inter = _INTER_BY_QUALITY[
            getattr(st.config, "quality", "hifi")]
        self.basepitch = st.config.basepitch
        self.noise = 0
        self.p_ramping = 0
        self.wave = None
        self.mode = "off"
        self.a = Ramper(0)
        self.p = Ramper(self._transpose() + self.basepitch)
        self.dphase = p2i(self.p.value >> 8)
        self.phase = 0
        self._set_phase(0, self.voice.waketime & 0xFF)
        self.set_reg(self.R_W, 0)
        self.set_reg(self.R_P, 0)
        self.set_reg(self.R_A, 0)
        self.set_reg(self.R_PHASE, 0)
        return 0

    def _transpose(self):
        return self.voice.r[R_TRANSPOSE]

    def write_callbacks(self):
        return [self._w_wave, self._w_pitch, self._w_amp, self._w_phase]

    def _w_wave(self, v, start, dur):
        w = self.state.interface.get_wave(v >> 16)
        wt = WaveType.OFF
        self.wave = w
        if w is not None:
            wt = w.type
        if wt in (WaveType.WAVE, WaveType.MIPWAVE):
            if w.size[0] > _WTOSC_MAXLENGTH:
                wt = WaveType.OFF
        if wt == WaveType.OFF:
            self.wave = None
            self.mode = "off"
        elif wt == WaveType.NOISE:
            self.mode = "noise"
        elif wt == WaveType.WAVE:
            self.mode = "nomip"
        else:
            self.mode = "mip"

    def _w_pitch(self, v, start, dur):
        self.p.set(sat32(v + self._transpose() + self.basepitch),
                   start, dur)
        if not dur:
            self.p_ramping = 1    # force update for 'set'

    def _w_amp(self, v, start, dur):
        self.a.set(v, start, dur)

    def _w_phase(self, v, start, dur):
        self._set_phase(v, start)

    def _set_phase(self, ph, sst):
        if self.wave is None:
            self.phase = 0
            return
        ph = sat32(ph + ((sst * (self.dphase >> 8)) >> 8))
        self.phase = (ph * self.wave.period << 8) & _U64

    def _run_pitch(self, frames):
        """wtosc_run_pitch (wtosc.c:89-105).  The reference's midpoint
        variable is unsigned, so the pitch sum shifts LOGICALLY (u32
        bit pattern >> 9) before a2_P2I reinterprets it — the result
        is always a non-negative "pitch" (< 2^23) whose octave falls
        into a2_P2I's x86 masked-shift region.  Signed arithmetic
        happens to produce identical dphase at 44.1/48/22.05 kHz
        basepitches but audibly diverges at 96 kHz (caught by the
        96 kHz golden)."""
        self.p.prepare(frames)
        if self.dphase and not self.p.timer and not self.p_ramping:
            return
        lastv = self.p.value
        self.p.run(frames)
        self.p_ramping = self.p.delta
        self.dphase = p2i(((lastv + self.p.value) & 0xFFFFFFFF) >> 9)

    def process(self, offset, frames):
        m = self.mode
        if m == "off":
            self.p.prepare(frames)
            self.a.prepare(frames)
            self.p.run(frames)
            self.a.run(frames)
            if not (self.flags & A2_PROCADD):
                self.outputs[0][offset:offset + frames] = 0
        elif m == "noise":
            self._process_noise(offset, frames)
        elif m == "mip":
            self._process_mip(offset, frames)
        else:
            self._process_nomip(offset, frames)

    # --- noise: pitched S&H RNG (wtosc.c:129-152) ---

    def _process_noise(self, offset, frames):
        self._run_pitch(frames)
        self.a.prepare(frames)
        ns = self.state.noisestate
        dph = self.dphase
        ph = self.phase & _U64
        n = np.arange(1, frames + 1, dtype=np.uint64)
        nph = np.uint64(ph) + n * np.uint64(dph)      # wraps like C u64
        prev = np.concatenate(([np.uint64(ph)], nph[:-1]))
        if dph >= (1 << 23):
            draw = np.ones(frames, dtype=bool)
        else:
            draw = (((prev ^ nph) >> np.uint64(23)) != 0)
        ndraws = int(draw.sum())
        vals = np.empty(max(ndraws, 1), dtype=np.int64)
        noise = self.noise
        for k in range(ndraws):
            vals[k] = ns.next() - 32767
        # sample value = last drawn value at or before each sample
        idx = np.cumsum(draw) - 1
        samples = np.where(idx >= 0, vals[np.maximum(idx, 0)], noise)
        if ndraws:
            self.noise = int(vals[ndraws - 1])
        self.phase = int(nph[-1])
        av = self.a.values(frames)
        out = _sh(samples * _sh(av, 10), 6)
        self._out(0, offset, frames, out)
        self.a.run(frames)

    # --- mipmapped wavetable (wtosc.c:239-298) ---

    def _process_mip(self, offset, frames):
        w = self.wave
        if w.size[0] == 0:
            self.wave = None
            self.mode = "off"
            self.process(offset, frames)
            return
        self._run_pitch(frames)
        dph_chk = ((self.dphase + 255) >> 8) * w.period
        self.a.prepare(frames)
        mm = 0
        while dph_chk > (A2_MAXPHINC << 8) and mm < A2_MIPLEVELS - 1:
            dph_chk >>= 1
            mm += 1
        ph = self.phase >> mm
        dph = (self.dphase * w.period) >> mm
        size = w.size[mm]
        looped = bool(w.flags & 0x100)
        if looped:
            ph %= size << 24
        elif (ph >> 24) > (size + A2_WAVEPRE):
            if not (self.flags & A2_PROCADD):
                self.outputs[0][offset:offset + frames] = 0
            return
        if dph > (A2_MAXPHINC << 16):
            if not (self.flags & A2_PROCADD):
                self.outputs[0][offset:offset + frames] = 0
            ph += dph * frames
            self.phase = (ph << mm) & _U64
            self.a.run(frames)
        else:
            ph = self._do_fragment(w.data[mm], offset, frames, ph, dph,
                                   looped=False, wsize=0)
            self.phase = (ph << mm) & _U64

    # --- non-mipmapped (wtosc.c:301-358) ---

    def _process_nomip(self, offset, frames):
        w = self.wave
        if w.size[0] == 0:
            self.wave = None
            self.mode = "off"
            self.process(offset, frames)
            return
        self._run_pitch(frames)
        dph = self.dphase * w.period
        self.a.prepare(frames)
        looped = bool(w.flags & 0x100)
        if dph >> 32:
            if not (self.flags & A2_PROCADD):
                self.outputs[0][offset:offset + frames] = 0
            self.phase = (self.phase + dph * frames) & _U64
            self.a.run(frames)
        elif dph > (A2_MAXPHINC << 16):
            self.phase = self._do_fragment(w.data[0], offset, frames,
                                           self.phase, dph,
                                           looped=looped,
                                           wsize=w.size[0])
        else:
            if looped:
                self.phase = self.phase % (w.size[0] << 24)
            elif (self.phase >> 24) > (w.size[0] + A2_WAVEPRE):
                if not (self.flags & A2_PROCADD):
                    self.outputs[0][offset:offset + frames] = 0
                return
            self.phase = self._do_fragment(w.data[0], offset, frames,
                                           self.phase, dph,
                                           looped=False, wsize=0)

    def _do_fragment(self, data, offset, frames, ph, dph, looped, wsize):
        """wtosc_do_fragment (wtosc.c:200-236), vectorized."""
        d32 = data.astype(np.int64)
        n = np.arange(frames, dtype=np.int64)
        phs = ph + n * dph
        add = bool(self.flags & A2_PROCADD)
        av = self.a.values(frames)
        valid = frames
        if wsize:
            if looped:
                phs = phs % (wsize << 24)
            else:
                over = (phs >> 24) >= wsize
                if over.any():
                    valid = int(np.argmax(over))
        ph16 = (phs >> 16)
        out = _sh(self._inter(d32, ph16, dph >> 16)[:valid]
                  * av[:valid], 17)
        o = self.outputs[0]
        if add:
            o[offset:offset + valid] += out.astype(np.int32)
        else:
            o[offset:offset + valid] = out.astype(np.int32)
            if valid < frames:
                o[offset + valid:offset + frames] = 0
        self.a.value = sat32(self.a.value + self.a.delta * valid)
        if valid < frames:
            return int(phs[valid])     # stopped at end of wave
        return int(ph + frames * dph)


# =========================================================
#   panmix — volume/pan matrix (src/units/panmix.c)
# =========================================================

class PanmixUnit(HostUnit):
    R_VOL, R_PAN = 0, 1

    def initialize(self, flags):
        self.flags = flags
        self.vol = Ramper(65536)
        self.pan = Ramper(0)
        self.set_reg(self.R_VOL, 65536)
        self.set_reg(self.R_PAN, 0)
        return 0

    def write_callbacks(self):
        return [lambda v, s, d: self.vol.set(v, s, d),
                lambda v, s, d: self.pan.set(v, s, d)]

    def process(self, offset, frames):
        add = bool(self.flags & A2_PROCADD)
        ni, no = self.ninputs, self.noutputs
        sl = slice(offset, offset + frames)
        self.vol.prepare(frames)
        if ni == 1 and no == 1:
            vv = self.vol.values(frames)
            inp = self.inputs[0][sl].astype(np.int64)
            out = _sh(inp * vv, 24)
            self._acc(0, sl, out, add)
            self.vol.run(frames)
            return
        self.pan.prepare(frames)
        vv = self.vol.values(frames)
        pv = self.pan.values(frames)
        clamp = (self.pan.target > 0xFFFFFF
                 or self.pan.target < -0xFFFFFF
                 or self.pan.value > 0xFFFFFF
                 or self.pan.value < -0xFFFFFF)
        vp = _sh(pv * vv, 24)
        v0 = vv - vp
        v1 = vv + vp
        if clamp:
            lim = vv << 1
            v0 = np.minimum(v0, lim)
            v1 = np.minimum(v1, lim)
        if ni == 1 and no == 2:
            inp = self.inputs[0][sl].astype(np.int64)
            self._acc(0, sl, _sh(inp * v0, 24), add)
            self._acc(1, sl, _sh(inp * v1, 24), add)
        elif ni == 2 and no == 1:
            i0 = self.inputs[0][sl].astype(np.int64)
            i1 = self.inputs[1][sl].astype(np.int64)
            self._acc(0, sl, _sh(i0 * v0 + i1 * v1, 25), add)
        else:
            i0 = self.inputs[0][sl].astype(np.int64)
            i1 = self.inputs[1][sl].astype(np.int64)
            self._acc(0, sl, _sh(i0 * v0, 24), add)
            self._acc(1, sl, _sh(i1 * v1, 24), add)
        self.vol.run(frames)
        self.pan.run(frames)

    def _acc(self, ch, sl, data, add):
        if add:
            self.outputs[ch][sl] += data.astype(np.int32)
        else:
            self.outputs[ch][sl] = data.astype(np.int32)


# =========================================================
#   dc — audio-rate constant/ramp generator (src/units/dc.c)
# =========================================================

class DcUnit(HostUnit):
    record_kind = "gen"
    queue_writes = False
    MODE_STEP, MODE_LINEAR = 0, 1

    def initialize(self, flags):
        self.flags = flags
        self.value = Ramper(0)
        self.mode = self.MODE_LINEAR
        self.set_reg(0, 0)
        self.set_reg(1, self.MODE_LINEAR << 16)
        return 0

    def write_callbacks(self):
        return [self._w_value, self._w_mode]

    def _w_value(self, v, start, dur):
        if self.mode == self.MODE_STEP:
            self.value.target = sat32(v << 8)
            self.value.timer = (dur >> 1) - start
            if self.value.timer <= 0:
                self.value.value = self.value.target
                self.value.timer = 0
        else:
            self.value.set(v, start, dur)

    def _w_mode(self, v, start, dur):
        m = v >> 16
        self.mode = m if m in (0, 1) else self.MODE_STEP

    def process(self, offset, frames):
        add = bool(self.flags & A2_PROCADD)
        v = self.value
        sl = slice(offset, offset + frames)
        if self.mode == self.MODE_STEP:
            buf = np.empty(frames, dtype=np.int64)
            s = 0
            if v.timer >= 256:
                if (v.timer >> 8) >= frames:
                    e2 = frames
                    v.timer -= frames << 8
                else:
                    e2 = v.timer >> 8
                    v.timer &= 0xFF
                buf[:e2] = v.value
                s = e2
            if v.timer < 256 and s < frames:
                tv = _sh(_sh(v.value, 4) * v.timer
                         + _sh(v.target, 4) * (256 - v.timer), 4)
                buf[s] = tv
                s += 1
                v.timer = 0
                v.value = v.target
            buf[s:] = v.target
        else:
            v.prepare(frames)
            buf = v.values(frames)
            v.run(frames)
        for o in range(self.noutputs):
            if add:
                self.outputs[o][sl] += buf.astype(np.int32)
            else:
                self.outputs[o][sl] = buf.astype(np.int32)


# =========================================================
#   filter12 — 12 dB/oct Chamberlin SVF (src/units/filter12.c)
# =========================================================

def _pitch2coeff_f32(cutoff_value_8_24, samplerate):
    """f12_pitch2coeff (filter12.c:65-72): f in float32, the sin() and
    final multiply in double (exact C mixed-precision semantics)."""
    f = np.float32(np.float32(p2i(cutoff_value_8_24 >> 8))
                   * np.float32(np.float32(261.626) / np.float32(16777216.0)))
    if f > np.float32(samplerate >> 2):
        return 362 << 16
    return int(np.float64(np.float32(512.0 * 65536.0))
               * np.sin(np.pi * np.float64(f) / np.float64(samplerate)))


class Filter12Unit(HostUnit):
    def initialize(self, flags):
        self.flags = flags
        self.samplerate = self.state.config.samplerate
        self.cutoff = Ramper(0)
        self.q = Ramper(0)
        self.lp = 65536 >> 8
        self.bp = 0
        self.hp = 0
        self.d1 = [0, 0]
        self.d2 = [0, 0]
        self.set_reg(0, 0)
        self.set_reg(1, 0)
        self.set_reg(2, 65536)
        self.set_reg(3, 0)
        self.set_reg(4, 0)
        self._w_cutoff(0, 0, 0)
        self._w_q(0, 0, 0)
        return 0

    def write_callbacks(self):
        return [self._w_cutoff, self._w_q, self._w_lp, self._w_bp,
                self._w_hp]

    def _w_cutoff(self, v, start, dur):
        self.cutoff.set(sat32(v + self.voice.r[R_TRANSPOSE]), start, dur)
        if dur < 256:
            self.f1 = _pitch2coeff_f32(self.cutoff.value,
                                       self.samplerate)

    def _w_q(self, v, start, dur):
        if v < 512:
            self.q.set(32768, start, dur)
        else:
            self.q.set((65536 << 8) // v, start, dur)

    def _w_lp(self, v, start, dur):
        self.lp = v >> 8

    def _w_bp(self, v, start, dur):
        self.bp = v >> 8

    def _w_hp(self, v, start, dur):
        self.hp = v >> 8

    def process(self, offset, frames):
        add = bool(self.flags & A2_PROCADD)
        channels = self.ninputs
        f0 = self.f1
        self.q.prepare(frames)
        self.cutoff.prepare(frames)
        if self.cutoff.delta:
            self.cutoff.run(frames)
            self.f1 = _pitch2coeff_f32(self.cutoff.value,
                                       self.samplerate)
            df = _trunc_div_c(self.f1 - f0 + (frames >> 1), frames)
        else:
            df = 0
        qv = self.q.value
        qd = self.q.delta
        lp, bp, hp = self.lp, self.bp, self.hp
        ins = [self.inputs[c] for c in range(channels)]
        outs = [self.outputs[c] for c in range(channels)]
        d1 = self.d1
        d2 = self.d2
        for s in range(offset, offset + frames):
            f = f0 >> 12
            q = qv >> 12
            for c in range(channels):
                dd1 = d1[c] >> 4
                l = sat32(d2[c] + ((f * dd1) >> 8))
                h = sat32((int(ins[c][s]) >> 5) - l - ((q * dd1) >> 8))
                b = sat32(((f * (h >> 4)) >> 8) + d1[c])
                fout = sat32((l * lp + b * bp + h * hp) >> 3)
                if add:
                    outs[c][s] = sat32(int(outs[c][s]) + fout)
                else:
                    outs[c][s] = fout
                d1[c] = b
                d2[c] = l
            f0 = sat32(f0 + df)
            qv = sat32(qv + qd)
        self.q.value = qv


def _trunc_div_c(a, b):
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


# =========================================================
#   dcblock — DC-blocking high-pass (src/units/dcblock.c)
# =========================================================

class DcblockUnit(HostUnit):
    def initialize(self, flags):
        self.flags = flags
        self.samplerate = self.state.config.samplerate
        self.cutoff = 0
        self.d1 = [0, 0]
        self.d2 = [0, 0]
        self.set_reg(0, sat32((-5) << 16))
        self._w_cutoff(self.get_reg(0), 0, 0)
        return 0

    def write_callbacks(self):
        return [self._w_cutoff]

    def _w_cutoff(self, v, start, dur):
        self.cutoff = sat32(v + self.voice.r[R_TRANSPOSE])
        f = np.float32(np.float32(p2i(self.cutoff))
                       * np.float32(np.float32(261.626)
                                    / np.float32(16777216.0)))
        if f > np.float32(self.samplerate >> 2):
            self.f1 = 362 << 16
        else:
            self.f1 = int(np.float64(np.float32(512.0 * 65536.0))
                          * np.sin(np.pi * np.float64(f)
                                   / np.float64(self.samplerate)))

    def process(self, offset, frames):
        add = bool(self.flags & A2_PROCADD)
        channels = self.ninputs
        f = self.f1 >> 12
        d1, d2 = self.d1, self.d2
        for c in range(channels):
            inp = self.inputs[c]
            out = self.outputs[c]
            dd1, dd2 = d1[c], d2[c]
            for s in range(offset, offset + frames):
                t1 = dd1 >> 4
                l = sat32(dd2 + ((f * t1) >> 8))
                h = sat32((int(inp[s]) >> 5) - l - (t1 << 4))
                b = sat32(((f * (h >> 4)) >> 8) + dd1)
                fout = sat32(h << 5)
                if add:
                    out[s] = sat32(int(out[s]) + fout)
                else:
                    out[s] = fout
                dd1 = b
                dd2 = l
            d1[c], d2[c] = dd1, dd2


# =========================================================
#   waveshaper — polynomial/rational shaper (src/units/waveshaper.c)
# =========================================================

class WaveshaperUnit(HostUnit):
    def initialize(self, flags):
        self.flags = flags
        self.amount = Ramper(0)
        self.set_reg(0, 0)
        return 0

    def write_callbacks(self):
        return [lambda v, s, d: self.amount.set(v, s, d)]

    def process(self, offset, frames):
        add = bool(self.flags & A2_PROCADD)
        sl = slice(offset, offset + frames)
        self.amount.prepare(frames)
        a = self.amount.values(frames)
        a3p1 = (a << 1) + a + (1 << 24)
        asqr = _sh(_sh(a, 4) * _sh(a, 4), 24)
        for c in range(self.ninputs):
            v = self.inputs[c][sl].astype(np.int64)
            vsqr = _sh(v * v, 22)
            vout = v * a3p1
            sqrsub = a * vsqr
            vout = np.where(v >= 0, vout - sqrsub, vout + sqrsub)
            den = _sh(asqr * vsqr, 16) + (1 << 24)
            q = np.abs(vout) // den
            vout = np.where((vout < 0), -q, q)
            if add:
                self.outputs[c][sl] += vout.astype(np.int32)
            else:
                self.outputs[c][sl] = vout.astype(np.int32)
        self.amount.run(frames)


# =========================================================
#   limiter — peak-tracking compressor (src/units/limiter.c)
# =========================================================

class LimiterUnit(HostUnit):
    def initialize(self, flags):
        self.flags = flags
        self.samplerate = self.state.config.samplerate
        self.set_reg(0, 64 << 16)
        self.set_reg(1, 1 << 16)
        self.release = ((64 << 16) << 8) // self.samplerate
        self.threshold = (1 << 16) << 8
        self.peak = 32768 << 8
        return 0

    def write_callbacks(self):
        return [self._w_release, self._w_threshold]

    def _w_release(self, v, start, dur):
        self.release = _trunc_div_c(sat32(v << 8), self.samplerate)

    def _w_threshold(self, v, start, dur):
        self.threshold = sat32(v << 8) & _U32
        if self.threshold < 256:
            self.threshold = 256

    def process(self, offset, frames):
        add = bool(self.flags & A2_PROCADD)
        peak = self.peak
        rel = self.release
        thr = self.threshold
        if self.ninputs == 1:
            inp = self.inputs[0]
            out = self.outputs[0]
            for s in range(offset, offset + frames):
                i = int(inp[s])
                p = abs(i)
                if p > peak:
                    peak = p
                else:
                    peak -= rel
                    if peak < thr:
                        peak = thr
                    p = peak
                gain = (32767 << 16) // ((p + 511) >> 9)
                o = (i * gain) >> 16
                if add:
                    out[s] = sat32(int(out[s]) + o)
                else:
                    out[s] = sat32(o)
        else:
            in0, in1 = self.inputs[0], self.inputs[1]
            out0, out1 = self.outputs[0], self.outputs[1]
            for s in range(offset, offset + frames):
                i0 = int(in0[s])
                i1 = int(in1[s])
                lpk = abs(i0)
                rpk = abs(i1)
                p = max(lpk, rpk)
                p = p + ((p - abs(lpk - rpk)) >> 1)
                if p > peak:
                    peak = p
                else:
                    peak -= rel
                    if peak < thr:
                        peak = thr
                    p = peak
                gain = (32767 << 16) // ((p + 511) >> 9)
                o0 = (i0 * gain) >> 16
                o1 = (i1 * gain) >> 16
                if add:
                    out0[s] = sat32(int(out0[s]) + o0)
                    out1[s] = sat32(int(out1[s]) + o1)
                else:
                    out0[s] = sat32(o0)
                    out1[s] = sat32(o1)
        self.peak = peak


# =========================================================
#   fbdelay — cross-feedback stereo delay (src/units/fbdelay.c)
# =========================================================

_FBD_BUFSIZE = 131072


class FbdelayUnit(HostUnit):
    def initialize(self, flags):
        self.flags = flags
        sr = self.state.config.samplerate
        self.samplerate = sr
        self.lbuf = np.zeros(_FBD_BUFSIZE, dtype=np.int32)
        self.rbuf = np.zeros(_FBD_BUFSIZE, dtype=np.int32)
        self.bufpos = 0
        self.set_reg(0, 400 << 16)
        self.set_reg(1, 280 << 16)
        self.set_reg(2, 320 << 16)
        self.fbdelay = (400 << 16) * sr // 65536000
        self.ldelay = (280 << 16) * sr // 65536000
        self.rdelay = (320 << 16) * sr // 65536000
        self.drygain = 65536
        self.fbgain = 16384
        self.lgain = 32768
        self.rgain = 32768
        self.set_reg(3, 65536)
        self.set_reg(4, 16384)
        self.set_reg(5, 32768)
        self.set_reg(6, 32768)
        return 0

    def write_callbacks(self):
        def dl(attr):
            def f(v, start, dur):
                setattr(self, attr,
                        _trunc_div_c(v * self.samplerate, 65536000))
            return f

        def g(attr):
            def f(v, start, dur):
                setattr(self, attr, v)
            return f
        return [dl("fbdelay"), dl("ldelay"), dl("rdelay"),
                g("drygain"), g("fbgain"), g("lgain"), g("rgain")]

    def process(self, offset, frames):
        add = bool(self.flags & A2_PROCADD)
        stereoin = self.ninputs == 2
        stereoout = self.noutputs == 2
        mindelay = min(self.fbdelay, self.ldelay, self.rdelay)
        if mindelay >= frames and self.fbdelay >= frames:
            self._process_vec(offset, frames, add, stereoin, stereoout)
        else:
            self._process_loop(offset, frames, add, stereoin, stereoout)

    def _taps(self, buf, delay, frames):
        idx = (self.bufpos + np.arange(frames, dtype=np.int64) - delay) \
            & (_FBD_BUFSIZE - 1)
        return buf[idx].astype(np.int64)

    def _process_vec(self, offset, frames, add, stereoin, stereoout):
        sl = slice(offset, offset + frames)
        i0 = self.inputs[0][sl].astype(np.int64)
        i1 = self.inputs[1 if stereoin else 0][sl].astype(np.int64)
        o0 = _sh(self._taps(self.rbuf, self.fbdelay, frames)
                 * self.fbgain, 16)
        o1 = _sh(self._taps(self.lbuf, self.fbdelay, frames)
                 * self.fbgain, 16)
        # write input + feedback
        widx = (self.bufpos + np.arange(frames, dtype=np.int64)) \
            & (_FBD_BUFSIZE - 1)
        self.lbuf[widx] = (i0 + o0).astype(np.int32)
        self.rbuf[widx] = (i1 + o1).astype(np.int32)
        o0 = o0 + _sh(self._taps(self.lbuf, self.ldelay, frames)
                      * self.lgain, 16)
        o1 = o1 + _sh(self._taps(self.rbuf, self.rdelay, frames)
                      * self.rgain, 16)
        o0 = o0 + _sh(i0 * self.drygain, 16)
        o1 = o1 + _sh(i1 * self.drygain, 16)
        self.bufpos += frames
        if stereoout:
            if add:
                self.outputs[0][sl] += o0.astype(np.int32)
                self.outputs[1][sl] += o1.astype(np.int32)
            else:
                self.outputs[0][sl] = o0.astype(np.int32)
                self.outputs[1][sl] = o1.astype(np.int32)
        else:
            mix = _sh(o0 + o1, 1)
            if add:
                self.outputs[0][sl] += mix.astype(np.int32)
            else:
                self.outputs[0][sl] = mix.astype(np.int32)

    def _process_loop(self, offset, frames, add, stereoin, stereoout):
        b0, b1 = self.lbuf, self.rbuf
        in0 = self.inputs[0]
        in1 = self.inputs[1 if stereoin else 0]
        out0 = self.outputs[0]
        out1 = self.outputs[1] if stereoout else None
        M = _FBD_BUFSIZE - 1
        for s in range(offset, offset + frames):
            i0 = int(in0[s])
            i1 = int(in1[s])
            o0 = (int(b1[(self.bufpos - self.fbdelay) & M])
                  * self.fbgain) >> 16
            o1 = (int(b0[(self.bufpos - self.fbdelay) & M])
                  * self.fbgain) >> 16
            b0[self.bufpos & M] = sat32(i0 + o0)
            b1[self.bufpos & M] = sat32(i1 + o1)
            o0 += (int(b0[(self.bufpos - self.ldelay) & M])
                   * self.lgain) >> 16
            o1 += (int(b1[(self.bufpos - self.rdelay) & M])
                   * self.rgain) >> 16
            o0 += (i0 * self.drygain) >> 16
            o1 += (i1 * self.drygain) >> 16
            if stereoout:
                if add:
                    out0[s] = sat32(int(out0[s]) + o0)
                    out1[s] = sat32(int(out1[s]) + o1)
                else:
                    out0[s] = sat32(o0)
                    out1[s] = sat32(o1)
            else:
                mix = (o0 + o1) >> 1
                if add:
                    out0[s] = sat32(int(out0[s]) + mix)
                else:
                    out0[s] = sat32(mix)
            self.bufpos += 1

    def deinitialize(self):
        self.lbuf = None
        self.rbuf = None


# =========================================================
#   env — control-rate envelope with control output
#   (src/units/env.c)
# =========================================================

_ENV_LUTSHIFT = 6
_ENV_LUTSIZE = 1 << _ENV_LUTSHIFT


def _env_build_luts():
    import math as _m
    luts = []
    # cosine spline
    t = [int((1.0 - _m.cos(i * _m.pi / (_ENV_LUTSIZE - 1)))
             * 16384.0 + 0.5) for i in range(_ENV_LUTSIZE)]
    luts.append(t + [32768, 32768])
    deg = [1, 2, 3, 4, 6, 9, 13]
    for d in deg:
        c = 0.1 ** d
        rc = 0.002 + 0.1 * (0.8 ** d)
        t = []
        for i in range(_ENV_LUTSIZE):
            x = 1.0 - i / _ENV_LUTSIZE
            rr = (1.0 - x) * rc
            t.append(int((c ** x * (1.0 - rr) + rr - c * x)
                         * 32768.0 + 0.5))
        luts.append(t + [32768, 32768])
    return luts


_ENV_LUTS = _env_build_luts()


class EnvUnit(HostUnit):
    record_kind = "gen"      # control only; runs at record time
    queue_writes = False
    CI_TARGET, CI_MODE, CI_DOWN, CI_TIME = 0, 1, 2, 3

    def initialize(self, flags):
        self.flags = flags
        cfg = self.state.config
        # float32 like audiality2.c:499 (see engine/state.py)
        self.msdur = int(np.float32(np.float32(cfg.samplerate)
                                    * np.float32(65.536))
                         + np.float32(0.5))
        self.ramper = Ramper(0)
        self.out = 0
        self.scale = 0
        self.offset_v = 0
        self.lut = None
        self.active = False
        self.coutput = None
        self.set_reg(self.CI_TARGET, 0)
        self.set_reg(self.CI_MODE, 1)      # A2ENVRM_LINEAR
        self.set_reg(self.CI_DOWN, 0)      # A2ENVRM_LINK
        self.set_reg(self.CI_TIME, 0)
        return 0

    def set_coutput(self, index, cport):
        self.coutput = cport

    def write_callbacks(self):
        return [self._w_target, None, None, None]

    def _ms2t(self, d):
        return ((d * self.msdur + 0x7FFFFF) >> 24) & _U32

    def _w_target(self, v, start, dur):
        co = self.coutput
        if co is None:
            return
        ci_time = self.get_reg(self.CI_TIME)
        if ci_time:
            dur = self._ms2t(ci_time)
        if dur >= 256 - start:
            mode = self.get_reg(self.CI_DOWN) >> 16
            if v >= self.out or mode == 0:
                mode = self.get_reg(self.CI_MODE) >> 16
        else:
            mode = 1    # LINEAR
        if mode in (0, 1) or mode < -8 or mode > 8:
            self.out = v
            co[1](v, start, dur)
            self.active = False
            return
        if mode == -1:
            self.lut = _ENV_LUTS[0]
            mode = 1
        elif mode >= 2:
            self.lut = _ENV_LUTS[1 + mode - 2]
        else:   # -8..-2
            self.lut = _ENV_LUTS[1 - mode - 2]
        if mode >= 0:
            rstart, rend = 0, 1 << 16
            self.scale = sat32(v - self.out)
            self.offset_v = self.out
        else:
            rstart, rend = 1 << 16, 0
            self.scale = sat32(self.out - v)
            self.offset_v = sat32(self.out - self.scale)
        self.ramper.value = rstart << 8
        self.ramper.set(rend, start, dur)
        self.active = True

    def process(self, offset, frames):
        if not self.active:
            return
        co = self.coutput
        r = self.ramper
        t = self.lut
        r.prepare(frames)
        r.run(frames)
        i = r.value >> (24 - _ENV_LUTSHIFT)
        f = (r.value >> (24 - 16 - _ENV_LUTSHIFT)) & 65535
        i = max(0, min(i, _ENV_LUTSIZE))
        out = (f * t[i + 1] + (65536 - f) * t[i]) >> 7
        out = sat32(((out * self.scale) >> 24) + self.offset_v)
        self.out = out
        co[1](out, offset, frames << 8)
        if not r.delta:
            self.active = False


# =========================================================
#   fm1..fm4 / fm3p / fm4p / fm2r / fm4r (src/units/fm.c)
# =========================================================

_FM_PERIOD_BITS = 11
_FM_PERIOD = 1 << _FM_PERIOD_BITS
_FM_SINE = None


def _fm_sine():
    global _FM_SINE
    if _FM_SINE is None:
        import math as _m
        n = _FM_PERIOD + 1
        _FM_SINE = np.array(
            [int(_m.sin(s * 2.0 * _m.pi / _FM_PERIOD) * 32767.0)
             for s in range(n)], dtype=np.int64)
    return _FM_SINE


# fm oversampling bits.  NOTE: fm.c does not include config.h, so
# A2_HIFI is NOT in effect there — the reference always compiles fm
# with the "standard" quality settings (fm.c:46-51): 0/1/2/2 bits.
_FM_OSBITS = {1: 0, 2: 1, 3: 2, 4: 2}


class _FmOp:
    __slots__ = ("a", "fb", "p", "last_pitch", "phase", "dphase", "last")

    def __init__(self, pitch_init):
        self.a = Ramper(0)
        self.fb = Ramper(0)
        self.p = Ramper(pitch_init)
        self.last_pitch = 0
        self.phase = 0
        self.dphase = 0
        self.last = 0


class FmUnit(HostUnit):
    record_kind = "gen"
    queue_writes = False

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.nops = int(self.desc.name[2])

    def initialize(self, flags):
        self.flags = flags
        name = self.desc.name
        self.structure = self.nops
        if len(name) > 3 and name[3] == 'p':
            self.structure += 4
        elif len(name) > 3 and name[3] == 'r':
            self.structure += 8
        cfg = self.state.config
        self.basepitch = cfg.basepitch
        init_p = self.voice.r[R_TRANSPOSE] + self.basepitch
        self.op = [_FmOp(init_p) for _ in range(self.nops)]
        self.op[0].dphase = p2i(self.op[0].p.value >> 8)
        for i in range(1, self.nops):
            self.op[i].dphase = self.op[0].dphase
        self._set_phase(0, self.voice.waketime & 0xFF)
        self.set_reg(0, 0)
        for i in range(self.nops * 3):
            self.set_reg(1 + i, 0)
        if self.structure == 4:
            self.osbits = _FM_OSBITS[4]          # fm4_Process: A2FM4
        elif self.structure in (1, 2, 3):
            self.osbits = _FM_OSBITS[self.nops]
        elif self.structure in (7, 8, 12):
            self.osbits = _FM_OSBITS[3]          # fm3p/fm4p/fm4r: A2FM3
        else:   # 10 == fm2r
            self.osbits = _FM_OSBITS[2]          # A2FM2
        return 0

    def _set_phase(self, ph, sst):
        for o in self.op:
            ssph = sat32(ph + ((sst * (o.dphase >> 8)) >> 8))
            o.phase = (ssph * _FM_PERIOD >> 8) & _U32

    def write_callbacks(self):
        cbs = [self._w_phase]
        for i in range(self.nops):
            cbs.append(self._mk_pitch(i))
            cbs.append(self._mk_amp(i))
            cbs.append(self._mk_fb(i))
        return cbs

    def _w_phase(self, v, start, dur):
        self._set_phase(v, start)

    def _mk_pitch(self, i):
        if i == 0:
            def f(v, start, dur):
                self.op[0].p.set(
                    sat32(v + self.voice.r[R_TRANSPOSE]
                          + self.basepitch), start, dur)
        else:
            def f(v, start, dur):
                self.op[i].p.set(v, start, dur)
        return f

    def _mk_amp(self, i):
        def f(v, start, dur):
            self.op[i].a.set(v, start, dur)
        return f

    def _mk_fb(self, i):
        def f(v, start, dur):
            self.op[i].fb.set(v, start, dur)
        return f

    def _run_pitch(self, o, frames, detune):
        o.p.prepare(frames)
        o.p.run(frames >> 1)
        newpitch = sat32(o.p.value + detune) >> 8
        if newpitch != o.last_pitch:
            o.dphase = p2i(newpitch)
            o.last_pitch = newpitch

    def process(self, offset, frames):
        nops = self.nops
        structure = self.structure
        parallel = 1 if structure in (7, 8) else \
            (2 if structure in (10, 12) else 0)
        add = bool(self.flags & A2_PROCADD)
        detune = 0
        for i in range(nops):
            o = self.op[i]
            o.a.prepare(frames)
            o.fb.prepare(frames)
            self._run_pitch(o, frames, detune)
            detune = self.op[0].p.value
        oversample = 1 << self.osbits
        sine = _fm_sine()
        out = self.outputs[0]
        # Sequential reference loop (feedback + chained modulation are
        # sample-serial at the oversampled rate).
        for s in range(offset, offset + frames):
            vsum = 0
            for _ in range(oversample):
                if parallel == 2:
                    vsum += self._sample_rm()
                else:
                    vsum += self._sample(parallel)
            for i in range(nops):
                o = self.op[i]
                o.a.run(1)
                o.fb.run(1)
                o.phase = (o.phase + (o.dphase & (oversample - 1))) \
                    & _U32
            v = vsum >> self.osbits
            if add:
                out[s] = sat32(int(out[s]) + v)
            else:
                out[s] = sat32(v)

    def _osc(self, o, mod):
        sine = _fm_sine()
        fb = (o.last * o.fb.value) >> 17
        ph = ((o.phase + mod + fb) & _U32) \
            >> (24 - 8 - _FM_PERIOD_BITS)
        # a2_Lerp on the sine table (fm.c:119)
        i = (ph >> 8) & ((_FM_PERIOD << 8) - 1) >> 8
        i = (ph & ((_FM_PERIOD << 8) - 1)) >> 8
        x = ph & 0xFF
        o.last = (int(sine[i]) * (256 - x) + int(sine[i + 1]) * x) >> 8
        return (o.last * o.a.value) >> 16

    def _sample(self, parallel):
        v = 0
        osb = self.osbits
        for i in range(self.nops - 1, -1, -1):
            o = self.op[i]
            if i and parallel:
                v += self._osc(o, 0)
            else:
                v = self._osc(o, v)
            o.phase = (o.phase + (o.dphase >> osb)) & _U32
        return v

    def _sample_rm(self):
        osb = self.osbits
        v = [0, 0]
        if self.nops == 2:
            for i in range(2):
                o = self.op[i]
                v[i] = self._osc(o, 0)
                o.phase = (o.phase + (o.dphase >> osb)) & _U32
        else:
            for i in range(2):
                o = self.op[i]
                om = self.op[i + 2]
                v[i] = self._osc(o, self._osc(om, 0))
                o.phase = (o.phase + (o.dphase >> osb)) & _U32
                om.phase = (om.phase + (om.dphase >> osb)) & _U32
        return (v[0] * v[1]) >> 23


# =========================================================
#   xsink / xsource / xinsert — external client I/O
#   (src/units/xsink.c, xsource.c, xinsert.c)
# =========================================================

class XInsertClient:
    def __init__(self, callback, read=True, write=False, userdata=None):
        self.callback = callback
        self.read = read
        self.write = write
        self.userdata = userdata
        self.unit = None
        self.handle = -1


class _XBase(HostUnit):
    is_xinsert = True

    def initialize(self, flags):
        self.flags = flags
        self.clients = []
        return 0

    def add_client(self, xic):
        self.clients.append(xic)
        xic.unit = self
        return 0

    def remove_client(self, xic):
        if xic in self.clients:
            self.clients.remove(xic)
        xic.unit = None
        return 0

    def deinitialize(self):
        for c in self.clients:
            c.unit = None
        self.clients = []


class XSinkUnit(_XBase):
    """Feeds voice audio to clients; no outputs (xsink.c:91-112)."""

    def process(self, offset, frames):
        if not self.clients:
            return
        bufs = [i[offset:offset + frames] for i in self.inputs]
        for c in self.clients:
            c.callback(bufs, self.ninputs, frames, c.userdata)


class XSourceUnit(_XBase):
    """Injects client audio into the graph (xsource.c:171-191)."""

    def process(self, offset, frames):
        add = bool(self.flags & A2_PROCADD)
        tmp = [np.zeros(frames, dtype=np.int32)
               for _ in range(self.noutputs)]
        for c in self.clients:
            c.callback(tmp, self.noutputs, frames, c.userdata)
        for ch in range(self.noutputs):
            o = self.outputs[ch]
            if add:
                o[offset:offset + frames] += tmp[ch]
            else:
                o[offset:offset + frames] = tmp[ch]
        if not self.clients and not add:
            for ch in range(self.noutputs):
                self.outputs[ch][offset:offset + frames] = 0


class XInsertUnit(_XBase):
    """Insert point with parallel-summed WRITE clients and bypass
    (xinsert.c:61-132)."""

    def process(self, offset, frames):
        add = bool(self.flags & A2_PROCADD)
        n = self.ninputs
        sl = slice(offset, offset + frames)
        obufs = [np.zeros(frames, dtype=np.int64) for _ in range(n)]
        has_inserts = False
        inbufs = [i[sl] for i in self.inputs]
        for c in self.clients:
            if not c.write:
                c.callback(inbufs, n, frames, c.userdata)
                continue
            work = [np.array(i, dtype=np.int32) if c.read
                    else np.zeros(frames, dtype=np.int32)
                    for i in inbufs]
            if c.read:
                has_inserts = True
            c.callback(work, n, frames, c.userdata)
            for i in range(n):
                obufs[i] += work[i]
        if not has_inserts:
            for i in range(n):
                obufs[i] += inbufs[i]
        for i in range(n):
            o = self.outputs[i]
            if add:
                o[sl] += obufs[i].astype(np.int32)
            else:
                o[sl] = obufs[i].astype(np.int32)


# =========================================================
#   dbgunit — buffer statistics printer (src/units/dbgunit.c)
# =========================================================

class DbgUnit(HostUnit):
    def process(self, offset, frames):
        for c in range(min(self.ninputs, self.noutputs)):
            self.outputs[c][offset:offset + frames] = \
                self.inputs[c][offset:offset + frames]


REGISTRY = {
    "inline": InlineUnit,
    "wtosc": WtoscUnit,
    "panmix": PanmixUnit,
    "xsink": XSinkUnit,
    "xsource": XSourceUnit,
    "xinsert": XInsertUnit,
    "dbgunit": DbgUnit,
    "limiter": LimiterUnit,
    "fbdelay": FbdelayUnit,
    "filter12": Filter12Unit,
    "dcblock": DcblockUnit,
    "waveshaper": WaveshaperUnit,
    "fm1": FmUnit, "fm2": FmUnit, "fm3": FmUnit, "fm4": FmUnit,
    "fm3p": FmUnit, "fm4p": FmUnit, "fm2r": FmUnit, "fm4r": FmUnit,
    "dc": DcUnit,
    "env": EnvUnit,
}
