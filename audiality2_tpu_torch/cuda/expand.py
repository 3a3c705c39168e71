"""The run -> row expansion of a superblock: one hand-written CUDA kernel
and its plain PyTorch version.

Counterpart of the JAX package's ``_expand_rows``
(``audiality2_tpu/tpu/superblock.py``) up to its oscillator calls:

  runs (packed "rmq" words and their value tables, or the plain int32
  runmat) --decode--> each row's run (the count of alive runs starting
  at or before the row) --> the row's fields (phase, loop wrap, amp /
  vol / pan bases) --ramp runs: replay of fragments 1 .. 15
  (``_ramp_scan``)--> each pass class's oscillator parameters int32
  [16, NB*128] and each row's slot index, and the table-less class-0
  rows (noise and dc, ``_noise_audio``, ``_panmix_rows``) rendered and
  added into the slots.

``expand_call`` runs ``expand_plain`` (the torch glue the mixer ran
before, arithmetic unchanged) for CPU tensors, and the launches of
``csrc/expand_kernel.cu`` for CUDA tensors (the runs' order, the rows,
the class-0 samples where there are class-0 rows), or raises.  The pass
classes' rows then go through ``osc_kernel.osc_slots_call``, which adds
them into the slots (``TorchMixer._expand``).
"""

import ctypes

import numpy as np
import torch

from ..constants import A2_MAXFRAG
from . import build
from . import osc_kernel as OK
from . import packed as PK
from .osc_kernel import _w, add_rows
from .superblock import (
    BASE_N, RR_N, RC_START, RC_LEN, RC_DPH, RC_SIZE, RC_POSOFF, RC_AMP0,
    RC_DAMP, RC_VOL0, RC_DVOL, RC_PAN0, RC_DPAN, RC_SLOT, RC_MODE, RC_OFF,
    RC_TOTAL, RC_PHHI, RC_PHLO, RC_RIDX, RR_MIP, RR_AT, RR_ATMR, RR_VT,
    RR_VTMR, RR_PT, RR_PTMR, RR_PV, RR_PTGT, RR_PTIMER, RR_PRAMP,
    RR_DPHRAW, RR_PERIOD, RR_BASE, RUN_KCHUNK,
    _ROW_NOISE, _ROW_DC, _ROW_STEREO, _ROW_HASPM, _ROW_CLAMP)

FRAG = A2_MAXFRAG
_M32 = 0xFFFFFFFF
# the decodes a launch makes, by table form: a packed runmat, a packed
# rampmat, a plain table (runmat or rampmat)
KINDS = ("rmq", "rqr", "plain")
MAX_CLASSES = 8
# the kernel's scratch: an order entry per 512 runs, a record per
# class-0 row
ORDER_RUNS = 512
ROW0_BYTES = 128


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


def row_params(rm, rmp, tbases, rows_sig, mono, dead_slot, ptabs):
    """Run -> row expansion (the JAX mixer's ``_expand_rows`` up to its
    kernel calls) from tensors: rm int64 runmat, rmp int64 rampmat or
    None, tbases int32 [NB] per class block, ptabs the int64 pitch
    tables.  Returns (classes, slot_r) where classes lists (pass_class,
    tbase int32 [NB], params int32 [NPARAM, NB*RPB] or the class-0
    inputs dict) in row order, and slot_r is each row's int64 slot index
    (dead_slot for dead rows)."""
    dev = rm.device
    Rtot = sum(NB * OK.RPB for _, NB in rows_sig)
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
    has_ramp = rmp is not None
    tg = None
    if has_ramp:
        traj = _ramp_scan(rmp, rm, ptabs)
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
    for (cls, NB), tb in zip(rows_sig, tbases):
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
        classes.append((cls, tb, par))
    return classes, slot_r


def class0_audio(c, mono):
    """The class-0 rows' audio from ``row_params``'s inputs dict: noise
    or the dc ramp, through the panmix; int32 [P, C*FRAG]."""
    res = _noise_audio(c["size"], c["posoff"], c["ph"], c["dphu"],
                       c["off"], c["runoff"], c["k"], c["use"],
                       c["cnt0"], c["amp"], c["damp"])
    n = torch.arange(FRAG, dtype=torch.int64, device=res.device)
    dcres = _w(c["amp"][:, None] + n[None, :] * c["damp"][:, None])
    dcf = ((c["mode"] & _ROW_DC) != 0)[:, None]
    res = torch.where(dcf, dcres, res)
    return _panmix_rows(res, c["vol0"], c["dvol"], c["pan0"],
                        c["dpan"], c["off"], c["end"], c["mode"], mono)


def decode(table):
    """A run or ramp table in either form as int64: ("rmq" / "rqr", pk,
    value tables) through the packed format's plain decoder, ("plain",
    m) as it is; None stays None."""
    if table is None:
        return None
    if table[0] == "plain":
        return table[1].to(torch.int64)
    return PK._PLAIN[table[0]](table[1], table[2]).to(torch.int64)


def expand_plain(rows_sig, mono, dead_slot, runs, ramps, tbases, ptabs,
                 slots):
    """The plain version of ``expand_call``: decodes the tables, runs
    ``row_params`` and adds the class-0 rows' audio into ``slots``.
    Returns (classes, slot_r): (pass class, tbase, params int32 [16, P],
    first row) per pass class block, and every row's int64 slot index."""
    classes, slot_r = row_params(decode(runs), decode(ramps), tbases,
                                 rows_sig, mono, dead_slot, ptabs)
    out = []
    b0 = 0
    for (cls, NB), (_, tb, par) in zip([x for x in rows_sig if x[1]],
                                       classes):
        P = NB * OK.RPB
        if cls == 0:
            add_rows(slots, slot_r[b0:b0 + P], class0_audio(par, mono),
                     mono)
        else:
            out.append((cls, tb, par, b0))
        b0 += P
    return out, slot_r


# ---- the CUDA kernel ----

def _bind(lib):
    lib.a2_expand.restype = ctypes.c_int
    lib.a2_expand.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]     # runs nr packed
        + [ctypes.c_void_p] * 2                           # tables (host)
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]   # ramps nrr packed
        + [ctypes.c_void_p] * 2                           # tables (host)
        + [ctypes.c_void_p] * 2                           # pitch tables
        + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]  # classes
        + [ctypes.c_int, ctypes.c_longlong]               # mono dead_slot
        + [ctypes.c_void_p] * 3 + [ctypes.c_longlong]     # params .. nslot
        + [ctypes.c_void_p] * 3)                          # order row0 stream


def _load():
    return build.load("expand_kernel", _bind)


def _check_table(what, table, forms, dev):
    """Checks one run / ramp table argument; returns (form, matrix,
    value tables, row count)."""
    if not isinstance(table, tuple) or not table or table[0] not in forms:
        raise ValueError("%s: a table must be one of %s, got %r"
                         % (what, forms, table if not isinstance(table, tuple)
                            else table[:1]))
    form = table[0]
    if form == "plain":
        if len(table) != 2:
            raise ValueError("%s: a plain table is (\"plain\", m)" % what)
        m = table[1]
        ncol = BASE_N if forms[0] == "rmq" else RR_N
        n = m.shape[0] if m.dim() == 2 else -1
        build.check_tensor(m, what, "plain table", torch.int32,
                           (max(n, 1), ncol), dev)
        return form, m, [], n
    words, ntab, _ = PK.KINDS[form]
    if len(table) != 3:
        raise ValueError("%s: a packed table is (%r, pk, tables)"
                         % (what, form))
    pk, tabs = table[1], table[2]
    n = pk.shape[1] if pk.dim() == 2 else -1
    build.check_tensor(pk, what, form, torch.int32, (words, max(n, 1)), dev)
    if len(tabs) != ntab:
        raise ValueError("%s: %s takes %d tables, got %d"
                         % (what, form, ntab, len(tabs)))
    for j, t in enumerate(tabs):
        build.check_tensor(t, what, "%s table %d" % (form, j), torch.int32,
                           (max(t.shape[0], 1),), dev)
    return form, pk, list(tabs), n


def expand_call(rows_sig, mono, dead_slot, runs, ramps, tbases, ptabs,
                slots):
    """The expansion of one superblock.  rows_sig: ((class, NB), ...) the
    class blocks in row order; runs: ("rmq", pk int32 (11, N), 7 value
    tables) or ("plain", rm int32 [N, BASE_N]); ramps: None, ("rqr", pk
    int32 (8, NrR), 8 value tables) or ("plain", rmp int32 [NrR, RR_N]);
    tbases: int32 [NB] per class block; ptabs: the int64 pitch tables
    (``_PTAB_BASE``, ``_PTAB_COEFF``); slots int32 [nslot, 2, FRAG], into
    which the class-0 rows are added; dead_slot: the dead rows' slot.
    Returns (classes, slot_r): (pass class, tbase, params int32 [16,
    NB*128], first row) per pass class block and slot_r int64 [Rtot].
    CPU tensors take ``expand_plain``; CUDA tensors launch the kernel
    (``expand_call.launches`` counts launches, ``kind_launches`` the
    decodes by table form) or raise."""
    return _expand(_load, rows_sig, mono, dead_slot, runs, ramps, tbases,
                   ptabs, slots)


def _expand(load, rows_sig, mono, dead_slot, runs, ramps, tbases, ptabs,
            slots):
    """``expand_call`` with the kernel library that load() returns (the
    repository's, or an earlier build of the same C interface)."""
    what = "expand_call"
    dev = slots.device
    nslot = slots.shape[0] if slots.dim() == 3 else -1
    build.check_tensor(slots, what, "slots", torch.int32,
                       (max(nslot, 1), 2, FRAG), dev)
    if not 0 <= dead_slot < nslot:
        raise ValueError("%s: dead slot %d outside %d slots"
                         % (what, dead_slot, nslot))
    rows_sig = tuple((int(c), int(nb)) for c, nb in rows_sig)
    if len(rows_sig) != len(tbases):
        raise ValueError("%s: %d class blocks, %d tbase arrays"
                         % (what, len(rows_sig), len(tbases)))
    for (cls, NB), tb in zip(rows_sig, tbases):
        if cls not in (0,) + OK.PASS_CLASSES or NB < 0:
            raise ValueError("%s: class block %r" % (what, (cls, NB)))
        build.check_tensor(tb, what, "tbase", torch.int32, (NB,), dev)
    live = [(c, NB) for c, NB in rows_sig if NB]
    if not live or len(live) > MAX_CLASSES:
        raise ValueError("%s: %d class blocks with rows (1 to %d)"
                         % (what, len(live), MAX_CLASSES))
    rform, rm, rtabs, nr = _check_table(what, runs, ("rmq", "plain"), dev)
    qform = qm = None
    qtabs, nrr = [], 0
    if ramps is not None:
        qform, qm, qtabs, nrr = _check_table(what, ramps, ("rqr", "plain"),
                                             dev)
    for t, name in zip(ptabs, ("ptab base", "ptab coeff")):
        build.check_tensor(t, what, name, torch.int64, (len(_PTAB_BASE),),
                           dev)
    if len(ptabs) != 2:
        raise ValueError("%s: two pitch tables, got %d" % (what, len(ptabs)))
    if nr < 1 or (ramps is not None and nrr < 1):
        raise ValueError("%s: empty run table" % what)
    if dev.type == "cpu":
        return expand_plain(rows_sig, mono, dead_slot, runs, ramps, tbases,
                            ptabs, slots)
    if dev.type != "cuda":
        raise ValueError("%s: unsupported device %s" % (what, dev))
    Rtot = sum(NB * OK.RPB for _, NB in live)
    nz = sum(NB * OK.RPB for c, NB in live if c == 0)
    params = torch.empty(OK.NPARAM * Rtot, dtype=torch.int32, device=dev)
    slot_r = torch.empty(Rtot, dtype=torch.int64, device=dev)
    order = torch.empty(2 * -(-nr // ORDER_RUNS), dtype=torch.int32,
                        device=dev)
    row0 = torch.empty(nz * ROW0_BYTES // 4, dtype=torch.int32, device=dev)

    def host(ts):
        return ((ctypes.c_void_p * 8)(*[t.data_ptr() for t in ts]),
                (ctypes.c_int * 8)(*[t.shape[0] for t in ts]))
    rp, rs = host(rtabs)
    qp, qs = host(qtabs)
    ncls = len(live)
    cls_a = (ctypes.c_int * MAX_CLASSES)(*[c for c, _ in live])
    rows_a = (ctypes.c_int * MAX_CLASSES)(*[NB * OK.RPB for _, NB in live])
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.a2_expand(
            rm.data_ptr(), nr, int(rform == "rmq"), ctypes.addressof(rp),
            ctypes.addressof(rs), qm.data_ptr() if qm is not None else None,
            nrr, int(qform == "rqr"), ctypes.addressof(qp),
            ctypes.addressof(qs), ptabs[0].data_ptr(), ptabs[1].data_ptr(),
            ncls, ctypes.addressof(cls_a), ctypes.addressof(rows_a),
            int(bool(mono)), int(dead_slot), params.data_ptr(),
            slot_r.data_ptr(), slots.data_ptr(), nslot, order.data_ptr(),
            row0.data_ptr() if nz else None, stream)
    build.launch_check(err, "expand")
    # the order, the rows (which decode the tables) and, with class-0
    # rows, their samples
    build.count_launch(expand_call)
    build.count_launch(expand_call, tuple(sorted(
        {rform} | ({qform} if qform else set()))))
    if nz:
        build.count_launch(expand_call)
    classes = []
    b0 = 0
    for (cls, NB), tb in zip(rows_sig, tbases):
        if not NB:
            continue
        P = NB * OK.RPB
        if cls:
            classes.append((cls, tb, params[OK.NPARAM * b0:OK.NPARAM
                                            * (b0 + P)].view(OK.NPARAM, P),
                            b0))
        b0 += P
    return classes, slot_r


expand_call.launches = 0
expand_call.kind_launches = dict.fromkeys(KINDS, 0)


# ---- the kernel's work, and seeded tables for its checks ----

# int32 operations, counted by hand from csrc/expand_kernel.cu (a 64-bit
# operation counts as 2, a 64-bit division as 2): per row (its run, its
# fields and its parameters), per replayed ramp fragment (four
# requantisations, the pitch step, the phase), per class-0 sample (the
# draw count, the LCG jump, the panmix)
OPS_ROW = 90
OPS_STEP = 130
OPS_SAMPLE = 80


def row_runs(rm, rows_sig):
    """(rid, k, alive) per row of a numpy runmat, as ``row_params`` maps
    rows to runs."""
    Rtot = sum(NB * OK.RPB for _, NB in rows_sig)
    mark = np.zeros(Rtot + 1, np.int64)
    np.add.at(mark, np.clip(rm[:, RC_START].astype(np.int64), 0, Rtot),
              (rm[:, RC_LEN] > 0).astype(np.int64))
    rid = np.cumsum(mark[:Rtot]) - 1
    g = rm[np.maximum(rid, 0)].astype(np.int64)
    k = np.arange(Rtot) - g[:, RC_START]
    return rid, k, (rid >= 0) & (k < g[:, RC_LEN])


def work(rm, rmp, rows_sig, mono, rmq_sizes=None, rqr_sizes=None):
    """(bytes, int32 ops) of one expansion of the numpy runmat rm and
    rampmat rmp (or None) over the class blocks rows_sig: each table
    read once (packed where its value-table sizes are given), every
    row's parameters (pass classes) and slot index written once, each
    live class-0 sample's read-modify-write of its slot; the operations
    of OPS_ROW per row, OPS_STEP per fragment that this data's ramp rows
    replay and OPS_SAMPLE per live class-0 sample."""
    Rtot = sum(NB * OK.RPB for _, NB in rows_sig)
    C = 1 if mono else 2
    nbytes = (4 * (PK._RMQ_WORDS * len(rm) + sum(rmq_sizes)) if rmq_sizes
              else 4 * BASE_N * len(rm))
    if rmp is not None:
        nbytes += (4 * (PK._RQR_WORDS * len(rmp) + sum(rqr_sizes))
                   if rqr_sizes else 4 * RR_N * len(rmp))
    nbytes += 2 * 8 * len(_PTAB_BASE) + 8 * Rtot
    rid, k, alive = row_runs(rm, rows_sig)
    g = rm[np.maximum(rid, 0)].astype(np.int64)
    steps = 0
    if rmp is not None:
        use = (g[:, RC_RIDX] >= 0) & (k >= 1) & alive
        steps = int(np.minimum(k[use], RUN_KCHUNK - 1).sum())
    samples = 0
    b0 = 0
    for cls, NB in rows_sig:
        P = NB * OK.RPB
        if cls:
            nbytes += 4 * OK.NPARAM * P
        else:
            sl = slice(b0, b0 + P)
            end = np.where(alive[sl], np.clip(
                g[sl, RC_OFF] + g[sl, RC_TOTAL] - 64 * k[sl], 0, FRAG), 0)
            off = np.where(k[sl] == 0, g[sl, RC_OFF], 0)
            samples += int(np.maximum(end - off, 0).sum())
        b0 += P
    nbytes += 2 * 4 * C * samples
    return nbytes, OPS_ROW * Rtot + OPS_STEP * steps + OPS_SAMPLE * samples


def _i32(rng, n, lo=-(1 << 31), hi=1 << 31):
    return rng.integers(lo, hi, n, dtype=np.int64)


def seeded_program(rng, rows_sig=((0, 2), (2, 3), (8, 1)), nruns=160,
                   nramps=48, ramps=True, order="sorted", packable=False):
    """Seeded tables for an expansion whose fields reach every branch of
    the row arithmetic: alive runs (wrapping and noise phases, dc and
    noise rows, every mode bit, windows past the fragment, int32 wraps of
    the amp / vol / pan bases), dead runs, ramp runs whose timers take
    each branch of the requantisation and whose pitch steps skip or not.
    order: "sorted" (alive runs first, sorted by START, as
    ``program_from_native`` makes them), "shuffled" (the runs in any
    order) or "dead" (no alive run).  packable keeps every field inside
    the packed format (mode bits below 16, PHHI in [-1, 61], LEN below
    256, PTGT == PV).
    Returns dict(rows_sig, tbases, rm, rmp, nslot) of numpy arrays (rmp
    None without ramps)."""
    Rtot = sum(NB * OK.RPB for _, NB in rows_sig)
    maxlen = 255 if packable else 600
    nalive = 0 if order == "dead" else nruns * 3 // 4
    nslot = 2 * Rtot + 4 * maxlen + 1
    rm = np.zeros((nruns, BASE_N), np.int64)
    rm[:, RC_START] = Rtot
    rm[:, RC_RIDX] = -1
    a = slice(0, nalive)
    rm[a, RC_START] = np.sort(rng.integers(0, Rtot, nalive))
    rm[a, RC_LEN] = np.where(rng.random(nalive) < 0.3,
                             rng.integers(1, 4, nalive),
                             rng.integers(1, maxlen + 1, nalive))
    rm[a, RC_DPH] = np.where(rng.random(nalive) < 0.3,
                             _i32(rng, nalive, 1 << 23, 1 << 28),
                             _i32(rng, nalive, -(1 << 22), 1 << 23))
    rm[a, RC_SIZE] = np.where(rng.random(nalive) < 0.7,
                              rng.integers(1, 5000, nalive),
                              _i32(rng, nalive))
    for c in (RC_POSOFF, RC_AMP0, RC_DAMP, RC_VOL0, RC_DVOL, RC_PAN0,
              RC_DPAN, RC_PHLO):
        small = rng.random(nalive) < 0.5
        rm[a, c] = np.where(small, _i32(rng, nalive, -(1 << 24), 1 << 24),
                            _i32(rng, nalive))
    rm[a, RC_SLOT] = rng.integers(Rtot, Rtot + 2 * maxlen, nalive)
    bits = (1, 2, 4, 8) if packable else (1, 2, 4, 8, 16)
    rm[a, RC_MODE] = sum(b * (rng.random(nalive) < 0.5) for b in bits)
    rm[a, RC_OFF] = rng.integers(0, 64, nalive)
    rm[a, RC_TOTAL] = np.where(rng.random(nalive) < 0.9,
                               rng.integers(-64, 64 * maxlen, nalive),
                               _i32(rng, nalive))
    rm[a, RC_PHHI] = rng.integers(-1, 62, nalive) if packable \
        else np.where(rng.random(nalive) < 0.8,
                      rng.integers(-1, 62, nalive), _i32(rng, nalive))
    nrr = nramps if ramps else 0
    if nrr:
        rm[a, RC_RIDX] = np.where(rng.random(nalive) < 0.4,
                                  rng.integers(0, nrr, nalive), -1)
    # dead runs: the padding's, and some with LEN 0 elsewhere
    d = slice(nalive, nruns)
    nd = nruns - nalive
    rm[d, RC_START] = np.where(rng.random(nd) < 0.5, Rtot,
                               rng.integers(0, Rtot + 1, nd))
    rm[d, RC_SLOT] = rng.integers(Rtot, Rtot + 2 * maxlen, nd)
    if order == "shuffled":
        rm = rm[rng.permutation(nruns)]
    rmp = None
    if nrr:
        rmp = np.zeros((nrr, RR_N), np.int64)
        rmp[:, RR_MIP] = rng.integers(0, 16, nrr)
        if not packable:
            # tensor shifts past 62 and below 0 shift by 63
            rmp[:4, RR_MIP] = (63, 70, -3, 62)[:min(nrr, 4)]
        for c in (RR_AT, RR_VT, RR_PT, RR_PV):
            rmp[:, c] = np.where(rng.random(nrr) < 0.5,
                                 _i32(rng, nrr, -(1 << 24), 1 << 24),
                                 _i32(rng, nrr))
        for c in (RR_ATMR, RR_VTMR, RR_PTMR, RR_PTIMER):
            # each branch: no timer, a short one (inside the fragment),
            # a long one (several fragments), a negative one
            rmp[:, c] = rng.choice(
                [0, 1, 2], nrr, p=(0.3, 0.35, 0.35)).astype(np.int64)
            rmp[:, c] = np.where(
                rmp[:, c] == 1, rng.integers(1, 64 * 256, nrr),
                np.where(rmp[:, c] == 2, rng.integers(64 * 256, 1 << 20,
                                                      nrr), 0))
            rmp[rng.random(nrr) < 0.05, c] = -rng.integers(1, 1000)
        rmp[:, RR_PTGT] = rmp[:, RR_PV] if packable \
            else np.where(rng.random(nrr) < 0.5, rmp[:, RR_PV],
                          _i32(rng, nrr))
        rmp[:, RR_PRAMP] = np.where(rng.random(nrr) < 0.5, 0,
                                    _i32(rng, nrr, -(1 << 20), 1 << 20))
        rmp[:, RR_DPHRAW] = np.where(rng.random(nrr) < 0.3, 0,
                                     _i32(rng, nrr))
        rmp[:, RR_PERIOD] = _i32(rng, nrr)
        rmp[:, RR_BASE] = rng.integers(0, nruns, nrr)
    tbases = [rng.integers(0, 100, NB).astype(np.int32)
              for _, NB in rows_sig]
    return {"rows_sig": tuple(rows_sig), "tbases": tbases,
            "rm": rm.astype(np.int32),
            "rmp": None if rmp is None else rmp.astype(np.int32),
            "nslot": nslot}


def own_tables(mat, cols):
    """Value tables of a table's own columns (with 0, as the mixer's
    ``_rmq_finalize`` makes them)."""
    return [np.unique(np.concatenate([mat[:, c], [0]])).astype(np.int32)
            for c in cols]


def seeded_args(seed, order="sorted", packed=False, ramps="plain",
                rows_sig=((0, 2), (2, 3), (8, 1)), nruns=160, mono=False,
                device="cpu"):
    """``seeded_program``'s tables as ``expand_call``'s arguments on
    `device`: runs plain or packed ("rmq" from their own value tables,
    some indices past their tables), ramps None, "plain" or "rqr", seeded
    slots.  Returns (rows_sig, mono, dead_slot, runs, ramps, tbases,
    ptabs, slots)."""
    rng = np.random.default_rng(seed)
    sp = seeded_program(rng, rows_sig=rows_sig, nruns=nruns,
                        ramps=ramps is not None, order=order,
                        packable=packed or ramps == "rqr")
    rm, rmp = sp["rm"], sp["rmp"]

    def on(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)
    if packed:
        tabs = own_tables(rm, PK._RMQ_IDXCOLS)
        pk = PK._rmq_pack(rm, tabs)
        # an index past its table reads the table's last entry
        pk[10, :5] |= 0xFFFF
        runs = ("rmq", on(pk), [on(t) for t in tabs])
    else:
        runs = ("plain", on(rm))
    rq = None
    if ramps == "rqr":
        tabs = own_tables(rmp, PK._RQR_IDXCOLS)
        pk = PK._rqr_pack(rmp, tabs)
        pk[7, :3] = (pk[7, :3].view(np.uint32) | 0xFFFF0000).view(np.int32)
        rq = ("rqr", on(pk), [on(t) for t in tabs])
    elif ramps == "plain":
        rq = ("plain", on(rmp))
    slots = rng.integers(-(1 << 31), 1 << 31, (sp["nslot"], 2, FRAG))
    return (sp["rows_sig"], mono, sp["nslot"] - 1, runs, rq,
            [on(t) for t in sp["tbases"]],
            (on(_PTAB_BASE), on(_PTAB_COEFF)), on(slots.astype(np.int32)))
