"""TorchMixer: runs a SuperblockProgram in PyTorch.

Counterpart of the JAX package's ``DeviceMixer._build_inner``
(``audiality2_tpu/tpu/superblock.py:3638``):

  runs --(_expand_rows: run -> row expansion, ramp replay)--> rows
  rows --(osc_call per pass class; noise/dc rows in torch)--> audio
  audio, stash --(int32 segment sums)--> slots[ninst*F+1, 2, 64]
  slots --(stage tail: panmix/copy/waveshaper stages, fbdelay,
           filter12/dcblock/limiter, fm, in record order)--> slots
  slots --> master slice [F, channels, 64]

The stage tail's serial recurrences run as CUDA kernels
(``fbdelay.py``, ``filter.py``, ``fm.py``); their state (fbdelay
rings, filter and fm state) persists on the mixer from one superblock
to the next, as in the JAX mixer.  The mixer takes the program as the
builder made it: eager PyTorch needs none of the JAX mixer's shape
padding, and that padding changes no number.  Slots are updated in
place where the JAX functions return new arrays.

Integer semantics follow the reference exactly: int32 audio with
wrap, int64 where the reference computes in int64, arithmetic right
shifts, C truncating division (``torch.div(..., rounding_mode=
"trunc")``) where the JAX code uses its f32-estimate ``_tdiv``.
"""

import numpy as np
import torch

from ..constants import A2_MAXFRAG
from . import fbdelay as FB
from . import filter as FL
from . import fm as FM
from . import osc_kernel as OK
from .osc_kernel import _w
from .superblock import (
    RC_START, RC_LEN, RC_DPH, RC_SIZE, RC_POSOFF, RC_AMP0,
    RC_DAMP, RC_VOL0, RC_DVOL, RC_PAN0, RC_DPAN, RC_SLOT, RC_MODE, RC_OFF,
    RC_TOTAL, RC_PHHI, RC_PHLO, RC_RIDX, RR_MIP, RR_AT, RR_ATMR, RR_VT,
    RR_VTMR, RR_PT, RR_PTMR, RR_PV, RR_PTGT, RR_PTIMER, RR_PRAMP,
    RR_DPHRAW, RR_PERIOD, RR_BASE, RUN_KCHUNK,
    _ROW_NOISE, _ROW_DC, _ROW_STEREO, _ROW_HASPM, _ROW_CLAMP)

FRAG = A2_MAXFRAG
_M32 = 0xFFFFFFFF
# every kernel wrapper of the mixer's path, by kernel name; each counts
# its launches in `.launches`
KERNEL_WRAPPERS = {"osc_rows": OK.osc_call,
                   "fbdelay_dense": FB.fbd_dense_call,
                   "fbdelay_legacy": FB.fbd_legacy_call,
                   "filter": FL.filter_call, "fm": FM.fm_call}


def _pitch_tables():
    from ..fixmath import _PITCH_TAB
    base = np.asarray([b for b, _ in _PITCH_TAB], np.int64)
    coeff = np.asarray([c for _, c in _PITCH_TAB], np.int64)
    return base, coeff


_PTAB_BASE, _PTAB_COEFF = _pitch_tables()


def _nz_tab():
    # noise LCG doubling-jump table (reference a2_dsp.h:37-42, native
    # a2rt.cpp lcg_next: s = s*1566083941 + 1 mod 2^32): after 2^j
    # steps, s -> A[j]*s + C[j]
    A, C = 1566083941, 1
    out = []
    for _ in range(11):
        out.append((A, C))
        A, C = (A * A) & _M32, (A * C + C) & _M32
    return out


_NZ_TAB = _nz_tab()


def _mulmod32(s, a):
    """(s * a) mod 2^32 for s in [0, 2^32) (int64 tensor) and a Python
    int in [0, 2^32), without leaving int64."""
    lo = s * (a & 0xFFFF)
    hi = ((s * (a >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _tdiv(a, b):
    """C truncating int64 division."""
    return torch.div(a, b, rounding_mode="trunc")


def _prepare_vec(v, tg, t, fr):
    """a2_PrepareRamper(fr), vectorized (int64 tensors carrying int32
    wrap).  Returns (value, delta, timer) after the call."""
    t0 = t == 0
    big = (t >> 8) >= fr
    diff = _w(tg - v)
    safe_t = torch.where(t0 | ~big, torch.ones_like(t), t)
    d_big = _w(_tdiv(diff << 8, safe_t))
    d_small = _w(_tdiv(diff, fr))
    v2 = torch.where(t0, tg, v)
    d = torch.where(t0, torch.zeros_like(v),
                    torch.where(big, d_big, d_small))
    t2 = torch.where(t0, t, torch.where(big, t - (fr << 8),
                                        torch.zeros_like(t)))
    return v2, d, t2


def _p2i_vec(p, tabs):
    """a2_P2I (fixmath.p2i), vectorized in int64; p nonnegative."""
    ptab_base, ptab_coeff = tabs
    n = p & 0xFFFF
    oct_ = p >> 16
    idx = n >> 10
    dph = (ptab_coeff[idx] * (n & 1023)) & _M32
    dph = dph >> 2
    dph = (dph + ptab_base[idx]) & _M32
    sh = (7 - oct_) & 31
    return dph >> sh


def _ramp_scan(rmp, base, tabs):
    """Replays the reference's per-fragment control recurrences for
    every RAMP run: a2_PrepareRamper's requantization for amp/vol/pan
    and wtosc_run_pitch's pitch -> dphase with phase accumulation.
    rmp: rampmat int64 [NrR, RR_N]; base: runmat int64 [Nr, BASE_N].
    Returns int32 [RUN_KCHUNK-1, NrR, 10]: for fragments k=1..15,
    (amp, damp, vol, dvol, pan, dpan, dph, ph_hi, ph_lo, draws)."""
    n64 = FRAG
    g = base[rmp[:, RR_BASE].clamp(min=0)]
    av = _w(g[:, RC_AMP0] + n64 * g[:, RC_DAMP])
    at = rmp[:, RR_ATMR]
    atg = rmp[:, RR_AT]
    vv = _w(g[:, RC_VOL0] + n64 * g[:, RC_DVOL])
    vt = rmp[:, RR_VTMR]
    vtg = rmp[:, RR_VT]
    pv = _w(g[:, RC_PAN0] + n64 * g[:, RC_DPAN])
    ptm = rmp[:, RR_PTMR]
    ptg = rmp[:, RR_PT]
    pcv = rmp[:, RR_PV]
    pct = rmp[:, RR_PTIMER]
    pctg = rmp[:, RR_PTGT]
    pramp = rmp[:, RR_PRAMP]
    dphraw = rmp[:, RR_DPHRAW] & _M32
    period = rmp[:, RR_PERIOD] & _M32
    mip = rmp[:, RR_MIP]
    # noise runs carry the RNG state in RC_SIZE: no phase wrap
    noise = (g[:, RC_MODE] & _ROW_NOISE) != 0
    msz = torch.where(noise, torch.zeros_like(mip), g[:, RC_SIZE] << 24)
    safe_m = torch.where(msz > 0, msz, torch.ones_like(msz))
    dph0 = g[:, RC_DPH] & _M32
    ph0 = (g[:, RC_PHHI] << 32) | (g[:, RC_PHLO] & _M32)
    ph = ph0 + n64 * dph0
    # fragment k's frame count: 64 mid-run, the remaining tail for a
    # terminal merge (prepare()'s branch depends on it)
    span = g[:, RC_OFF] + g[:, RC_TOTAL]
    # noise S&H draws consumed before fragment k, fragment 0 being
    # samples [OFF, min(span, 64))
    off0 = g[:, RC_OFF]
    end0 = span.clamp(0, FRAG)
    dcnt = torch.where(dph0 >= (1 << 23), end0 - off0,
                       ((ph0 + end0 * dph0) >> 23)
                       - ((ph0 + off0 * dph0) >> 23))
    outs = []
    for k in range(1, RUN_KCHUNK):
        fr = (span - (k << 6)).clamp(1, FRAG)
        av2, ad, at = _prepare_vec(av, atg, at, fr)
        vv2, vd, vt = _prepare_vec(vv, vtg, vt, fr)
        pv2, pd, ptm = _prepare_vec(pv, ptg, ptm, fr)
        # wtosc_run_pitch
        pcv2, pcd, pct = _prepare_vec(pcv, pctg, pct, fr)
        skip = (dphraw != 0) & (pct == 0) & (pramp == 0)
        lastv = pcv2 & _M32
        pcv = torch.where(skip, pcv2, _w(pcv2 + pcd * fr))
        pin = ((lastv + (pcv & _M32)) & _M32) >> 9
        dphraw = torch.where(skip, dphraw, _p2i_vec(pin, tabs))
        pramp = torch.where(skip, pramp, pcd)
        dph = (dphraw * period) >> mip
        phm = torch.where(msz > 0, torch.remainder(ph, safe_m), ph)
        outs.append(torch.stack(
            [av2, ad, vv2, vd, pv2, pd, dph, phm >> 32, phm & _M32, dcnt],
            dim=-1))
        dk = torch.where(dph >= (1 << 23), fr,
                         ((phm + fr * dph) >> 23) - (phm >> 23))
        av = _w(av2 + ad * fr)
        vv = _w(vv2 + vd * fr)
        pv = _w(pv2 + pd * fr)
        ph = phm + fr * dph
        dcnt = dcnt + dk
    return _w(torch.stack(outs)).to(torch.int32)


def _noise_audio(s0, last0, phr, dphu, offl, offr, kk, isramp, c0, amp0,
                 damp):
    """Noise-run rows: the reference's pitched S&H LCG (wtosc.c:129-152)
    with closed-form draw counts and an LCG log-jump.  s0/last0: RNG
    state and held sample at the run's first real sample; phr: row
    frame-0 phase (48:24); dphu: phase increment (uint32 value); offl:
    the row's first valid sample; offr: the run's starting sample; kk:
    the row's fragment index in its run; isramp/c0: ramp-replayed rows
    and their accumulated draw counts.  All int64 [R] tensors (amp0,
    damp int32-valued).  Returns int64 [R, FRAG] int32-valued audio."""
    n = torch.arange(FRAG, dtype=torch.int64, device=s0.device)[None, :]
    hi = (dphu >= (1 << 23))[:, None]
    zero = torch.zeros_like(c0)
    base23 = torch.where(isramp, phr >> 23,
                         (phr - (kk * FRAG - offr) * dphu) >> 23)
    cons_lo = ((phr[:, None] + (n + 1) * dphu[:, None]) >> 23) \
        - base23[:, None] + torch.where(isramp, c0, zero)[:, None]
    cons_hi = (n + 1 - offl[:, None]) \
        + torch.where(isramp, c0, kk * FRAG - offr + offl)[:, None]
    cons = torch.where(hi, cons_hi, cons_lo).clamp(0, (1 << 11) - 1)
    # s = jump(s0, cons): 11 doubling steps, uint32 wrap
    s = (s0 & _M32)[:, None].expand(cons.shape)
    for j, (aj, cj) in enumerate(_NZ_TAB):
        bit = ((cons >> j) & 1) != 0
        s = torch.where(bit, (_mulmod32(s, aj) + cj) & _M32, s)
    val = (((s * (s >> 16)) & _M32) >> 16) - 32767
    last = torch.where(cons == 0, last0[:, None], val)
    ampn = _w(amp0[:, None] + n * damp[:, None])
    return _w(last * (ampn >> 10)) >> 6


def _panmix_rows(osc, vol0, dvol, pan0, dpan, off, end, mode, mono):
    """Reference panmix (panmix.c panmix_process12/process11) for the
    table-less class-0 rows: per-sample vol/pan ramps, stereo position
    with the 2*vol clamp, and the [OFF, END) window, in int64 as the
    JAX mixer's ``_panmix_rows``.  osc int64 [P, FRAG]; returns int32
    [P, C*FRAG] (channel 0 first)."""
    n = torch.arange(FRAG, dtype=torch.int64, device=osc.device)[None, :]
    valid = (n >= off[:, None]) & (n < end[:, None])
    zero = torch.zeros((), dtype=torch.int64, device=osc.device)
    vol = _w(vol0[:, None] + n * dvol[:, None])
    haspm = ((mode & _ROW_HASPM) != 0)[:, None]
    mono_pm = (osc * vol) >> 24
    if mono:
        ch0 = torch.where(haspm, mono_pm, osc)
        return _w(torch.where(valid, ch0, zero)).to(torch.int32)
    pan = _w(pan0[:, None] + n * dpan[:, None])
    vp = (pan * vol) >> 24
    v0 = vol - vp
    v1 = vol + vp
    lim = vol << 1
    clamp = ((mode & _ROW_CLAMP) != 0)[:, None]
    v0 = torch.where(clamp, torch.minimum(v0, lim), v0)
    v1 = torch.where(clamp, torch.minimum(v1, lim), v1)
    stereo = ((mode & _ROW_STEREO) != 0)[:, None]
    ch0 = torch.where(haspm, torch.where(stereo, (osc * v0) >> 24, mono_pm),
                      osc)
    ch1 = torch.where(haspm & stereo, (osc * v1) >> 24, zero)
    out = torch.cat([torch.where(valid, ch0, zero),
                     torch.where(valid, ch1, zero)], dim=1)
    return _w(out).to(torch.int32)


def _stage_key_meta(key):
    """(add, sch) for either stage-key layout (copy/ws vs panmix)."""
    if key[2] in ("copy", "ws"):
        return key[4], key[5]
    return key[5], key[6]


def _stage_math(key, x0, x1, a, ns):
    """Per-slice stage arithmetic (panmix / copy / waveshaper) on int64
    channel inputs [K, 64]: returns {dst_channel: int64 output}.
    ns = slice-local sample index; a = int64 slice params with p0..p4
    in columns 4..8."""
    kind = key[2]
    if kind == "copy":
        return {key[6][0]: x0}
    if kind == "ws":
        # waveshaper.c:67-105 fixed-point path, exact int64 including
        # the truncating division
        av = _w(a[:, 4:5] + ns * a[:, 5:6])
        a3p1 = _w(_w(_w(av << 1) + av) + (1 << 24))
        a4 = av >> 4
        asqr = _w((a4 * a4) >> 24)
        vsqr = _w((x0 * x0) >> 22)
        vout = x0 * a3p1
        sq = av * vsqr
        vout = torch.where(x0 >= 0, vout - sq, vout + sq)
        den = ((asqr * vsqr) >> 16) + (1 << 24)
        den = torch.where(den <= 0, torch.ones_like(den), den)
        return {key[6][0]: _tdiv(vout, den)}
    ni, no, dch = key[3], key[4], key[7]
    vol = a[:, 4:5] + ns * a[:, 5:6]
    if ni == 1 and no == 1:
        return {dch[0]: (x0 * vol) >> 24}
    pan = a[:, 6:7] + ns * a[:, 7:8]
    clamp = a[:, 8:9] != 0
    vp = (pan * vol) >> 24
    v0 = vol - vp
    v1 = vol + vp
    lim = vol << 1
    v0 = torch.where(clamp, torch.minimum(v0, lim), v0)
    v1 = torch.where(clamp, torch.minimum(v1, lim), v1)
    # destination channel 0xFF = dropped (that side of the panmix
    # writes an unowned, unreadable buffer)
    if ni == 1 and no == 2:
        out = {}
        if dch[0] != 0xFF:
            out[dch[0]] = (x0 * v0) >> 24
        if dch[1] != 0xFF:
            out[dch[1]] = (x0 * v1) >> 24
        return out
    if ni == 2 and no == 1:
        return {dch[0]: (x0 * v0 + x1 * v1) >> 25}
    out = {}
    if dch[0] != 0xFF:
        out[dch[0]] = (x0 * v0) >> 24
    if dch[1] != 0xFF:
        out[dch[1]] = (x1 * v1) >> 24
    return out


def _stage_delta(key, slots, src_idx, dst_idx, a):
    """One stage's slices: src_idx/dst_idx int64 [K] slot indices, a
    int64 [K, 9] slice params (offset in column 2, frames in 3).
    Adds the stage's output into slots in place; REPLACE is applied as
    add-of-difference against the slots as they were before this
    call, so duplicate destinations stay well-defined."""
    n = torch.arange(FRAG, dtype=torch.int64, device=slots.device)[None, :]
    o = a[:, 2:3]
    f = a[:, 3:4]
    mask = (n >= o) & (n < o + f)
    ns = n - o
    add, sch = _stage_key_meta(key)
    src = slots[src_idx]
    x0 = src[:, sch[0]].to(torch.int64)
    x1 = src[:, sch[-1]].to(torch.int64)
    outs = _stage_math(key, x0, x1, a, ns)
    old = None if add else slots[dst_idx].to(torch.int64)
    delta = torch.zeros((len(src_idx), 2, FRAG), dtype=torch.int32,
                        device=slots.device)
    zero = torch.zeros((), dtype=torch.int64, device=slots.device)
    for ch, out in outs.items():
        d = _w(out) if add else _w(_w(out) - old[:, ch])
        delta[:, ch] = torch.where(mask, d, zero).to(torch.int32)
    slots.index_add_(0, dst_idx, delta)


def _apply_stage_dense(slots, key, darr, F):
    """Dense stage path: group g's row f is fragment f of the slot
    spans starting at darr[g, 0, 0] (source) and darr[g, 0, 1]
    (destination).  Fragments the instance did not process carry
    frames 0, so their delta is zero."""
    G = darr.shape[0]
    a = darr.reshape(G * F, 9)
    fr = torch.arange(F, dtype=torch.int64, device=slots.device)
    src_idx = (darr[:, 0, 0][:, None] + fr[None, :]).reshape(-1)
    dst_idx = (darr[:, 0, 1][:, None] + fr[None, :]).reshape(-1)
    _stage_delta(key, slots, src_idx, dst_idx, a)


def _apply_stage(slots, key, arr):
    """Legacy slice-list stage path: arbitrary (slot, off, frames)
    slices."""
    _stage_delta(key, slots, arr[:, 0], arr[:, 1], arr)


def stage_items(prog):
    """The stage tail in execution order, as the JAX mixer runs it
    (``DeviceMixer._prepare``): stages, fbdelays and filter/fm items
    merged and sorted by (key, tiebreak), the tiebreak being the unit
    id of an fbdelay.  Returns [(tag, key, item)] with tag "stage",
    "fbd" or "filt"."""
    items = [("stage", st["key"], st, "") for st in prog.stages]
    items += [("fbd", fd["key"], fd, str(fd["unit_id"]))
              for fd in prog.fbdelays]
    items += [("filt", fl["key"], fl, "") for fl in prog.filters]
    items.sort(key=lambda t: (t[1], t[3]))
    return [t[:3] for t in items]


class TorchMixer:
    """Executes SuperblockPrograms with PyTorch on ``device``; the
    oscillator runs through ``osc_kernel.osc_call`` (the CUDA kernel
    for CUDA tensors, its plain version on the CPU).  Holds the
    device copy of the renderer's pair atlas."""

    def __init__(self, core, device="cuda", readback="exact", quality=0):
        self.core = core
        self.device = torch.device(device)
        if readback not in ("exact", "i16"):
            raise ValueError("readback must be 'exact' or 'i16'")
        self.readback = readback
        self.quality = quality
        self._atlas_dev = None
        self._atlas_ver = -1
        self._ptabs = (torch.as_tensor(_PTAB_BASE, device=self.device),
                       torch.as_tensor(_PTAB_COEFF, device=self.device))
        self._rings = {}         # unit id -> [ring, ring position]
        self._fbd_dense = {}     # unit id -> sticky dense flag
        self._fbd_par = {}       # unit id -> (fb, ld, rd) of the dense form
        self._filt = {}          # item key -> (state, serials)
        self._sine = None

    def device_atlas(self):
        """The pair atlas on the mixer's device (uploaded again when
        the atlas grows)."""
        pa = self.core._pair_atlas
        if pa.data is None:
            pa.finalize()
        if pa.version != self._atlas_ver:
            self._atlas_dev = torch.as_tensor(pa.data, dtype=torch.int32,
                                              device=self.device)
            self._atlas_ver = pa.version
        return self._atlas_dev

    def _t(self, a, dtype=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device) \
            .to(dtype)

    def row_params(self, prog):
        """Run -> row expansion (the JAX mixer's ``_expand_rows`` up to
        its kernel calls).  Returns (classes, slot_r, mono) where
        classes lists (pass_class, tbase int32 [NB], params int32
        [NPARAM, NB*RPB] or the class-0 inputs dict) in row order,
        and slot_r is each row's int64 slot index."""
        F = prog.F
        dead_slot = prog.ninst * F
        dev = self.device
        rm = self._t(prog.runmat)
        Rtot = sum(NB * OK.RPB for _, NB, _ in prog.class_blocks)
        mono = not bool((prog.runmat[:, RC_MODE] & _ROW_STEREO).any())
        if prog.stash_audio is not None and len(prog.stash_audio):
            mono = mono and not prog.stash_audio[:, 1].any()

        start = rm[:, RC_START]
        alive_run = (rm[:, RC_LEN] > 0).to(torch.int64)
        mark = torch.zeros(Rtot + 1, dtype=torch.int64, device=dev)
        mark.index_add_(0, start.clamp(0, Rtot), alive_run)
        rid = torch.cumsum(mark[:Rtot], 0) - 1
        g = rm[rid.clamp(min=0)]
        p = torch.arange(Rtot, dtype=torch.int64, device=dev)
        k = p - g[:, RC_START]
        alive = (rid >= 0) & (k < g[:, RC_LEN])
        kn = _w(k << 6)
        dph = g[:, RC_DPH]
        # the one per-row int64 the reference keeps: the raw phase
        ph = ((g[:, RC_PHHI] << 32) | (g[:, RC_PHLO] & _M32)) \
            + k * (dph << 6)
        # noise rows carry the RNG state in RC_SIZE: never phase-wrap
        noisef = (g[:, RC_MODE] & _ROW_NOISE) != 0
        sz = torch.where(noisef, torch.zeros_like(k), g[:, RC_SIZE])
        wrap = (sz > 0) & (k > 0)
        pos32 = _w(ph >> 24)
        f32 = ph & 0xFFFFFF
        pos32 = torch.where(
            wrap, torch.remainder(pos32, torch.where(sz > 0, sz,
                                                     torch.ones_like(sz))),
            pos32)
        amp = _w(g[:, RC_AMP0] + _w(kn * g[:, RC_DAMP]))
        damp = g[:, RC_DAMP]
        dph32 = dph
        vol0 = _w(g[:, RC_VOL0] + _w(kn * g[:, RC_DVOL]))
        pan0 = _w(g[:, RC_PAN0] + _w(kn * g[:, RC_DPAN]))
        dvol = g[:, RC_DVOL]
        dpan = g[:, RC_DPAN]
        has_ramp = bool(prog.has_ramp) and prog.rampmat is not None \
            and len(prog.rampmat) > 0
        tg = None
        if has_ramp:
            traj = _ramp_scan(self._t(prog.rampmat), rm, self._ptabs)
            NrR = traj.shape[1]
            ridx = g[:, RC_RIDX]
            fidx = (k - 1).clamp(0, RUN_KCHUNK - 2) * NrR + ridx.clamp(min=0)
            tg = traj.reshape(-1, traj.shape[-1])[fidx].to(torch.int64)
            use = (ridx >= 0) & (k >= 1) & alive
            amp = torch.where(use, tg[:, 0], amp)
            damp = torch.where(use, tg[:, 1], damp)
            vol0 = torch.where(use, tg[:, 2], vol0)
            dvol = torch.where(use, tg[:, 3], dvol)
            pan0 = torch.where(use, tg[:, 4], pan0)
            dpan = torch.where(use, tg[:, 5], dpan)
            dph32 = torch.where(use, tg[:, 6], dph32)
            # the replayed phase is already wrapped: (pos, frac24)
            # straight from its hi/lo words
            pos32 = torch.where(
                use, _w(tg[:, 7] << 8) | ((tg[:, 8] & _M32) >> 24), pos32)
            f32 = torch.where(use, tg[:, 8] & 0xFFFFFF, f32)
            cnt0 = torch.where(use, tg[:, 9], torch.zeros_like(k))
        else:
            use = torch.zeros_like(alive)
            cnt0 = torch.zeros_like(k)
        az = alive.to(torch.int64)
        pos = _w(pos32 + g[:, RC_POSOFF]) * az
        f = f32 * az
        amp = amp * az
        damp = damp * az
        zeros = torch.zeros_like(pos)
        off = torch.where(k == 0, g[:, RC_OFF], zeros)
        end = _w(g[:, RC_OFF] + g[:, RC_TOTAL] - kn).clamp(0, FRAG)
        end = torch.where(alive, end, zeros)
        slot_r = torch.where(alive, g[:, RC_SLOT] + k,
                             torch.full_like(k, dead_slot))
        mode = g[:, RC_MODE]
        fields = [pos, f, (dph32 >> 24) * az, (dph32 & 0xFFFFFF) * az,
                  amp, damp, vol0, dvol, pan0, dpan, off, end, mode,
                  zeros, zeros, zeros]

        classes = []
        b0 = 0
        for cls, NB, tb in prog.class_blocks:
            if not NB:
                continue
            P = NB * OK.RPB
            sl = slice(b0, b0 + P)
            b0 += P
            if cls == 0:
                ph_sl = ph[sl]
                if has_ramp:
                    ph_sl = torch.where(
                        use[sl], (tg[sl, 7] << 32) | (tg[sl, 8] & _M32),
                        ph_sl)
                classes.append((0, None, {
                    "size": g[sl, RC_SIZE], "posoff": g[sl, RC_POSOFF],
                    "ph": ph_sl, "dphu": dph32[sl] & _M32, "off": off[sl],
                    "runoff": g[sl, RC_OFF], "k": k[sl], "use": use[sl],
                    "cnt0": cnt0[sl], "amp": amp[sl], "damp": damp[sl],
                    "vol0": vol0[sl], "dvol": dvol[sl], "pan0": pan0[sl],
                    "dpan": dpan[sl], "end": end[sl], "mode": mode[sl]}))
                continue
            par = torch.stack([x[sl] for x in fields]).to(torch.int32)
            classes.append((cls, self._t(tb, torch.int32), par))
        return classes, slot_r, mono

    def _class0_audio(self, c, mono):
        res = _noise_audio(c["size"], c["posoff"], c["ph"], c["dphu"],
                           c["off"], c["runoff"], c["k"], c["use"],
                           c["cnt0"], c["amp"], c["damp"])
        n = torch.arange(FRAG, dtype=torch.int64, device=self.device)
        dcres = _w(c["amp"][:, None] + n[None, :] * c["damp"][:, None])
        dcf = ((c["mode"] & _ROW_DC) != 0)[:, None]
        res = torch.where(dcf, dcres, res)
        return _panmix_rows(res, c["vol0"], c["dvol"], c["pan0"],
                            c["dpan"], c["off"], c["end"], c["mode"], mono)

    def _expand_rows(self, prog, slots):
        """Evaluates every row and adds its audio into its slot."""
        classes, slot_r, mono = self.row_params(prog)
        atlas = self.device_atlas()
        outs = []
        for cls, tb, par in classes:
            if cls == 0:
                outs.append(self._class0_audio(par, mono))
            else:
                res = OK.osc_call(cls, tb, par, atlas, quality=self.quality,
                                  fused_pm=True, mono=mono)
                outs.append(res.t())                 # (P, C*64)
        audio = torch.cat(outs, dim=0)
        if mono:
            slots[:, 0].index_add_(0, slot_r, audio)
        else:
            slots.view(slots.shape[0], 2 * FRAG).index_add_(0, slot_r, audio)

    def _fbd_is_dense(self, fd):
        """The sticky dense flag (JAX ``DeviceMixer._repad``): once a
        superblock needs the legacy form for an instance, or its
        delays differ from those its dense form began with, the
        instance stays legacy."""
        uid = fd["unit_id"]
        dense = bool(fd["dense"]) and self._fbd_dense.get(uid, True)
        if dense:
            dense = self._fbd_par.setdefault(uid, fd["fbpar"]) \
                == fd["fbpar"]
        self._fbd_dense[uid] = dense
        return dense

    def _fbdelay(self, slots, fd, F):
        """One fbdelay item, with its ring.  The two forms keep their
        rings in two formats (dense: the last 2^17 samples, time
        ordered; legacy: a 2^20 ring ending at position - 1); a switch
        from dense to legacy converts the ring exactly (JAX
        ``_prepare``)."""
        uid = fd["unit_id"]
        dense = self._fbd_is_dense(fd)
        want = FB.FBD_TAIL if dense else FB.FBD_BUFSIZE
        ring = self._rings.get(uid)
        if ring is None:
            ring = [torch.zeros((2, want), dtype=torch.int32,
                                device=self.device), 0]
        elif ring[0].shape[1] != want:
            cur = ring[0]
            if dense:
                pos = ring[1] & (FB.FBD_BUFSIZE - 1)
                idx = (pos - FB.FBD_TAIL + torch.arange(
                    FB.FBD_TAIL, device=self.device)) % FB.FBD_BUFSIZE
                ring = [cur[:, idx].contiguous(), 0]
            else:
                full = torch.zeros((2, FB.FBD_BUFSIZE), dtype=torch.int32,
                                   device=self.device)
                full[:, FB.FBD_BUFSIZE - FB.FBD_TAIL:] = cur
                ring = [full, 0]
        self._rings[uid] = ring
        arr = self._t(fd["arr"], torch.int32)
        sig = (fd["stereoin"], fd["stereoout"], fd["add"], fd["chunk"])
        if dense:
            ring[0] = FB.apply_fbdelay_dense(slots, sig + fd["fbpar"], arr,
                                             ring[0], F)
        else:
            FB.apply_fbdelay(slots, sig, arr, ring[0], ring[1])
            ring[1] = (ring[1] + int(fd["arr"][:, 5].sum())) \
                % FB.FBD_BUFSIZE

    def _filter(self, slots, fl):
        """One filter12 / dcblock / limiter / fm item.  Its state rows
        follow the unit serials: a serial seen in the previous
        superblock keeps its row, a new one starts from the initial
        state (JAX ``_prepare`` / ``_build_fn``)."""
        kind, key, cur = fl["kind"], fl["key"], fl["serials"]
        K = fl["arr"].shape[1]
        state = FL.init_state(kind, K, self.device)
        prev = self._filt.get(key)
        if prev is not None:
            pos = {s: i for i, s in enumerate(prev[1])}
            perm = [(j, pos[s]) for j, s in enumerate(cur) if s in pos]
            if perm:
                dst, src = zip(*perm)
                state[list(dst)] = prev[0][list(src)]
        arr = self._t(fl["arr"], torch.int32)
        if kind == "fm":
            if self._sine is None:
                self._sine = self._t(FM.sine_pairs(), torch.int32)
            sig = (key[3], key[4], key[5][0])
            FM.fm_call(slots, sig, arr, state, self._sine,
                       FM.groups(fl["arr"], sig))
        else:
            FL.filter_call(slots, kind, key[3:8], arr, state,
                           FL.groups(fl["arr"], key[3:8]))
        self._filt[key] = (state, list(cur))

    def dispatch(self, prog):
        """Runs one superblock; returns the master slice as a device
        tensor [F, channels, 64] (int32, or int16 for readback="i16")."""
        F = prog.F
        nslot = prog.ninst * F + 1
        dev = self.device
        slots = torch.zeros((nslot, 2, FRAG), dtype=torch.int32, device=dev)
        Rtot = sum(NB * OK.RPB for _, NB, _ in prog.class_blocks)
        if prog.runmat is not None and len(prog.runmat) and Rtot:
            self._expand_rows(prog, slots)
        if prog.stash_audio is not None and len(prog.stash_audio):
            slots.view(nslot, 2 * FRAG).index_add_(
                0, self._t(prog.stash_slot),
                self._t(prog.stash_audio, torch.int32)
                .reshape(-1, 2 * FRAG))
        if prog.stash_mono is not None and len(prog.stash_mono):
            slots[:, 0].index_add_(0, self._t(prog.stash_mono_slot),
                                   self._t(prog.stash_mono, torch.int32))
        for tag, key, it in stage_items(prog):
            if tag == "stage":
                if it["dense"].shape[0]:
                    _apply_stage_dense(slots, key, self._t(it["dense"]), F)
                if it["arr"].shape[0]:
                    _apply_stage(slots, key, self._t(it["arr"]))
            elif tag == "fbd":
                self._fbdelay(slots, it, F)
            else:
                self._filter(slots, it)
        m = prog.master_inst
        master = slots[m * F:(m + 1) * F, :prog.master_channels]
        if self.readback == "i16":
            master = torch.clamp(master >> 8, -32768, 32767) \
                .to(torch.int16)
        return master

    def fetch(self, master, prog):
        """Master tensor -> [channels][frames] int32 numpy."""
        out = master.cpu().numpy()
        if out.dtype == np.int16:
            # the int32 8:24 contract from the 16-bit conversion
            out = out.astype(np.int32) << 8
        mch = prog.master_channels
        total = sum(prog.frag_sizes)
        if total == len(prog.frag_sizes) * FRAG:
            flat = out.transpose(1, 0, 2).reshape(mch, total)
            return [flat[ch] for ch in range(mch)]
        bufs = []
        for ch in range(mch):
            b = np.empty(total, np.int32)
            pos = 0
            for fi, nfr in enumerate(prog.frag_sizes):
                b[pos:pos + nfr] = out[fi, ch, :nfr]
                pos += nfr
            bufs.append(b)
        return bufs

    def run(self, prog):
        """Returns master audio int32 [channels][frames] (numpy)."""
        return self.fetch(self.dispatch(prog), prog)
