"""The run -> row expansion (``audiality2_tpu_torch/cuda/expand.py``)
against the JAX package and against a model of its CUDA kernel, on the
CPU.

``expand_plain`` (what ``expand_call`` runs for CPU tensors) and
``TorchMixer._expand`` equal the JAX package's ``_expand_rows(...,
interpret=True)`` slot for slot (tolerance 0) on the first superblocks of
the slice song (stereo and mono), of the effects song with the packed
format on and off, and of a script of pitch ramps; every program goes
through the mixers' padding (``_repad``: padded runs and dead rows).

``kernel_model`` below follows ``csrc/expand_kernel.cu`` step by step in
Python integers: the run-order check, each 128-row block's row -> run
mapping (two searches over sorted runs, else a scan of every run, then
the block's marks), the per-row replay of the row's ramp run up to its
fragment, the row's fields, and the class-0 samples (the draw count, the
LCG jump, the panmix).  It must equal ``expand_plain`` in
parameters, slot indices and slots on seeded tables (sorted, shuffled
and all-dead runs; plain and packed runs and ramps; mono and stereo;
noise and dc rows) and on a real superblock.  ``torch_rows_model`` does
the kernel's row -> run map (a search over sorted runs, else a count of
every run) and its per-row ramp replay in torch over whole tables; it
must equal the plain version's map and trajectory gather on seeded and
recorded tables.  The kernel itself is held against ``expand_plain`` on
the card by ``chip_smoke.py`` (``expand``).
"""

import bisect
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiality2_tpu.tpu import superblock as JSB
from audiality2_tpu_torch.cuda import expand as EX
from audiality2_tpu_torch.cuda import osc_kernel as OK
from audiality2_tpu_torch.cuda import packed as PK
from audiality2_tpu_torch.cuda.mixer import (TorchMixer, blob_layout,
                                             blob_views)
from audiality2_tpu_torch.cuda.superblock import (
    BASE_N, RC_START, RC_LEN, RC_DPH, RC_SIZE, RC_POSOFF, RC_AMP0,
    RC_DAMP, RC_VOL0, RC_DVOL, RC_PAN0, RC_DPAN, RC_SLOT, RC_MODE, RC_OFF,
    RC_TOTAL, RC_PHHI, RC_PHLO, RC_RIDX, RR_MIP, RR_AT, RR_ATMR, RR_VT,
    RR_VTMR, RR_PT, RR_PTMR, RR_PV, RR_PTGT, RR_PTIMER, RR_PRAMP,
    RR_DPHRAW, RR_PERIOD, RR_BASE)
from audiality2_tpu_torch.songs import EFFECTS_SONG, SLICE_SONG

from test_torch_mixer import PITCH_SONG, _Core, record

FRAG = 64
RPB = 128
M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------
# a model of csrc/expand_kernel.cu in Python integers
# ---------------------------------------------------------------

def s64(x):
    """Wrap to int64 (the kernel's addw / mulw / shl)."""
    x &= M64
    return x - (1 << 64) if x >> 63 else x


def i64(x):
    """A plain int64 operation of the kernel: it must not overflow."""
    assert -(1 << 63) <= x < (1 << 63), x
    return x


def w32(x):
    x &= M32
    return x - (1 << 32) if x >> 31 else x


def tdiv(a, b):
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def shr_t(a, s):
    return a >> 63 if s < 0 or s >= 63 else a >> s


def clamp(x, lo, hi):
    return lo if x < lo else hi if x > hi else x


class Table:
    """One run or ramp table as the kernel reads it: plain rows, or
    packed words with their value tables (an index past a table reads
    its last entry)."""

    def __init__(self, table):
        self.packed = table[0] != "plain"
        self.m = table[1].numpy().astype(np.int64)
        self.tabs = [t.numpy().astype(np.int64) for t in table[2]] \
            if self.packed else []
        self.n = self.m.shape[1] if self.packed else self.m.shape[0]

    def word(self, k, j):
        return int(self.m[k, j]) & M32

    def take(self, t, i):
        return int(self.tabs[t][min(i, len(self.tabs[t]) - 1)])

    def run(self, j):
        if not self.packed:
            return [int(x) for x in self.m[j]]
        w = [self.word(k, j) for k in range(PK._RMQ_WORDS)]
        r = [0] * BASE_N
        r[RC_AMP0], r[RC_DPH] = w32(w[0]), w32(w[1])
        r[RC_PHLO], r[RC_SIZE] = w32(w[2]), w32(w[3])
        r[RC_START] = w[4] & 0x3FFFFF
        r[RC_OFF] = (w[4] >> 22) & 63
        r[RC_MODE] = (w[4] >> 28) & 15
        r[RC_RIDX] = (w[5] & 0x3FFFFF) - 1
        r[RC_PHHI] = ((w[5] >> 22) & 63) - 1
        r[RC_SLOT] = w[6] & 0x3FFFFF
        r[RC_LEN] = (w[6] >> 22) & 255
        for t, (c, x) in enumerate(zip(PK._RMQ_IDXCOLS, (
                w[7] & 0xFFFF, w[7] >> 16, w[8] & 0xFFFF, w[8] >> 16,
                w[9] & 0xFFFF, w[9] >> 16, w[10] & 0xFFFF))):
            r[c] = self.take(t, x)
        return r

    def ramp(self, j):
        if not self.packed:
            return [int(x) for x in self.m[j]]
        w = [self.word(k, j) for k in range(PK._RQR_WORDS)]
        q = [0] * 14
        q[RR_BASE], q[RR_MIP] = w[0] & 0x3FFFFF, (w[0] >> 22) & 15
        q[RR_ATMR], q[RR_PV], q[RR_DPHRAW] = w32(w[1]), w32(w[2]), w32(w[3])
        q[RR_PTGT] = q[RR_PV]
        for t, (c, x) in enumerate(zip(PK._RQR_IDXCOLS, (
                w[4] & 0xFFFF, w[4] >> 16, w[5] & 0xFFFF, w[5] >> 16,
                w[6] & 0xFFFF, w[6] >> 16, w[7] & 0xFFFF, w[7] >> 16))):
            q[c] = self.take(t, x)
        return q

    def mark(self, j, rtot):
        if self.packed:
            start = self.word(4, j) & 0x3FFFFF
            alive = ((self.word(6, j) >> 22) & 255) > 0
        else:
            start, alive = int(self.m[j, RC_START]), self.m[j, RC_LEN] > 0
        return clamp(start, 0, rtot), bool(alive)


def model_order(T, rtot):
    """order_kernel, its entries summed: (alive runs, whether they come
    first and sorted)."""
    marks = [T.mark(j, rtot) for j in range(T.n)]
    na = sum(a for _, a in marks)
    ok = all(a == (j < na) for j, (_, a) in enumerate(marks)) and all(
        marks[j - 1][0] <= marks[j][0] for j in range(1, na))
    return na, ok


def model_rids(T, rtot):
    """Each row's run as expand_kernel's blocks find it; also which path
    (searches over sorted runs, or the scan) the blocks took."""
    na, ok = model_order(T, rtot)
    starts = [T.mark(j, rtot)[0] for j in range(na)] if ok else None
    rids = []
    for p0 in range(0, rtot, RPB):
        marks = [0] * RPB
        if ok:
            below = bisect.bisect_left(starts, p0)
            for j in range(below, bisect.bisect_left(starts, p0 + RPB)):
                marks[starts[j] - p0] += 1
        else:
            below = 0
            for j in range(T.n):
                s, a = T.mark(j, rtot)
                if a and s < p0:
                    below += 1
                elif a and s < p0 + RPB:
                    marks[s - p0] += 1
        acc = 0
        for i in range(RPB):
            acc += marks[i]
            rids.append(below + acc - 1)
    return rids, ok


def prepare(v, tg, t, fr):
    """The kernel's prepare(): (v, d, t) after a2_PrepareRamper."""
    if t == 0:
        return tg, 0, t
    diff = w32(tg - v)
    if (t >> 8) >= fr:
        return v, w32(tdiv(diff * 256, t)), t - (fr << 8)
    return v, w32(tdiv(diff, fr)), 0


def p2i(p, ptabs):
    n, oct_ = p & 0xFFFF, p >> 16
    idx = n >> 10
    dph = (int(ptabs[1][idx]) * (n & 1023)) & M32
    dph = ((dph >> 2) + int(ptabs[0][idx])) & M32
    return dph >> ((7 - oct_) & 31)


def model_replay(g, q, steps, ptabs):
    """replay(): fragment `steps` of ramp run q over base run g."""
    av, at = w32(g[RC_AMP0] + 64 * g[RC_DAMP]), q[RR_ATMR]
    vv, vt = w32(g[RC_VOL0] + 64 * g[RC_DVOL]), q[RR_VTMR]
    pv, ptm = w32(g[RC_PAN0] + 64 * g[RC_DPAN]), q[RR_PTMR]
    pcv, pct, pramp = q[RR_PV], q[RR_PTIMER], q[RR_PRAMP]
    dphraw, period = q[RR_DPHRAW] & M32, q[RR_PERIOD] & M32
    msz = 0 if g[RC_MODE] & 8 else s64(g[RC_SIZE] << 24)
    dph0 = g[RC_DPH] & M32
    ph0 = s64(g[RC_PHHI] << 32) | (g[RC_PHLO] & M32)
    ph = s64(ph0 + 64 * dph0)
    span = i64(g[RC_OFF] + g[RC_TOTAL])
    end0 = clamp(span, 0, FRAG)
    dcnt = end0 - g[RC_OFF] if dph0 >= (1 << 23) else \
        (s64(ph0 + end0 * dph0) >> 23) - (s64(ph0 + g[RC_OFF] * dph0) >> 23)
    for k in range(1, steps + 1):
        fr = clamp(span - (k << 6), 1, FRAG)
        av2, ad, at = prepare(av, q[RR_AT], at, fr)
        vv2, vd, vt = prepare(vv, q[RR_VT], vt, fr)
        pv2, pd, ptm = prepare(pv, q[RR_PT], ptm, fr)
        pcv2, pcd, pct = prepare(pcv, q[RR_PTGT], pct, fr)
        skip = dphraw != 0 and pct == 0 and pramp == 0
        lastv = pcv2 & M32
        pcv = pcv2 if skip else w32(pcv2 + pcd * fr)
        if not skip:
            dphraw = p2i(((lastv + (pcv & M32)) & M32) >> 9, ptabs)
            pramp = pcd
        dph = shr_t(s64(dphraw * period), q[RR_MIP])
        phm = ph % msz if msz > 0 else ph
        if k == steps:
            return [w32(x) for x in (av2, ad, vv2, vd, pv2, pd, dph,
                                     phm >> 32, phm & M32, dcnt)]
        nxt = s64(phm + fr * dph)
        dk = fr if dph >= (1 << 23) else s64((nxt >> 23) - (phm >> 23))
        av, vv, pv = (w32(av2 + ad * fr), w32(vv2 + vd * fr),
                      w32(pv2 + pd * fr))
        ph, dcnt = nxt, s64(dcnt + dk)


def kernel_model(rows_sig, mono, dead_slot, runs, ramps, ptabs, slots):
    """expand_kernel over every row: (params int32 [16, Rtot] with the
    class-0 columns 0, slot_r int64 [Rtot], slots int32 with the class-0
    rows added, whether the sorted-runs path ran)."""
    ptabs = [t.numpy() for t in ptabs]
    R = Table(runs)
    Q = Table(ramps) if ramps is not None else None
    live = [(c, nb) for c, nb in rows_sig if nb]
    rtot = sum(nb * RPB for _, nb in live)
    rids, fast = model_rids(R, rtot)
    params = np.zeros((16, rtot), np.int64)
    slot_r = np.zeros(rtot, np.int64)
    acc = slots.numpy().astype(np.int64).copy()
    row_cls = np.concatenate([[c] * (nb * RPB) for c, nb in live])
    for p in range(rtot):
        rid = rids[p]
        g = R.run(max(rid, 0))
        k = p - g[RC_START]
        alive = rid >= 0 and k < g[RC_LEN]
        kn = w32(s64(k << 6))
        ph = s64((s64(g[RC_PHHI] << 32) | (g[RC_PHLO] & M32))
                 + s64(k * s64(g[RC_DPH] << 6)))
        sz = 0 if g[RC_MODE] & 8 else g[RC_SIZE]
        pos32, f32 = w32(ph >> 24), ph & 0xFFFFFF
        if sz > 0 and k > 0:
            pos32 %= sz
        amp = w32(g[RC_AMP0] + w32(kn * g[RC_DAMP]))
        damp, dph32 = g[RC_DAMP], g[RC_DPH]
        vol0 = w32(g[RC_VOL0] + w32(kn * g[RC_DVOL]))
        pan0 = w32(g[RC_PAN0] + w32(kn * g[RC_DPAN]))
        dvol, dpan = g[RC_DVOL], g[RC_DPAN]
        use, cnt0 = False, 0
        if Q is not None and g[RC_RIDX] >= 0 and k >= 1 and alive:
            use = True
            frag, q = min(k - 1, 14), g[RC_RIDX]
            if q >= Q.n:
                f = frag * Q.n + q
                frag, q = min(f // Q.n, 14), f % Q.n
            qr = Q.ramp(q)
            gb = R.run(clamp(qr[RR_BASE], 0, R.n - 1))
            tg = model_replay(gb, qr, frag + 1, ptabs)
            amp, damp, vol0, dvol, pan0, dpan, dph32 = tg[:7]
            pos32 = w32(s64(tg[7] << 8)) | ((tg[8] & M32) >> 24)
            f32, cnt0 = tg[8] & 0xFFFFFF, tg[9]
            ph = s64(tg[7] << 32) | (tg[8] & M32)
        az = int(alive)
        amp, damp = amp * az, damp * az
        off = g[RC_OFF] if k == 0 else 0
        end = clamp(w32(g[RC_OFF] + g[RC_TOTAL] - kn), 0, FRAG) \
            if alive else 0
        slot = g[RC_SLOT] + k if alive else dead_slot
        slot_r[p] = slot
        if row_cls[p]:
            params[:, p] = [
                w32(pos32 + g[RC_POSOFF]) * az, f32 * az,
                (dph32 >> 24) * az, (dph32 & 0xFFFFFF) * az, amp, damp,
                vol0, dvol, pan0, dpan, off, end, g[RC_MODE], 0, 0, 0]
            continue
        if end <= off:
            continue
        dphu = dph32 & M32
        base23 = ph >> 23 if use else \
            s64(ph - s64((k * FRAG - g[RC_OFF]) * dphu)) >> 23
        c_lo = cnt0 if use else 0
        c_hi = cnt0 if use else s64(k * FRAG - g[RC_OFF] + off)
        for n in range(off, end):
            ampn = w32(amp + n * damp)
            if g[RC_MODE] & 16:
                osc = ampn
            else:
                if dphu >= (1 << 23):
                    cons = s64(n + 1 - off + c_hi)
                else:
                    cons = s64((s64(ph + (n + 1) * dphu) >> 23) - base23
                               + c_lo)
                cons = clamp(cons, 0, 2047)
                s, a, c = g[RC_SIZE] & M32, 1566083941, 1
                for j in range(11):
                    if (cons >> j) & 1:
                        s = (s * a + c) & M32
                    c, a = (a * c + c) & M32, (a * a) & M32
                val = (((s * (s >> 16)) & M32) >> 16) - 32767
                last = g[RC_POSOFF] if cons == 0 else val
                osc = w32(last * (ampn >> 10)) >> 6
            vol = w32(vol0 + n * dvol)
            mono_pm = (osc * vol) >> 24
            haspm = g[RC_MODE] & 1
            if mono:
                acc[slot, 0, n] += mono_pm if haspm else osc
                continue
            pan = w32(pan0 + n * dpan)
            vp = (pan * vol) >> 24
            v0, v1 = vol - vp, vol + vp
            if g[RC_MODE] & 4:
                v0, v1 = min(v0, vol << 1), min(v1, vol << 1)
            stereo = g[RC_MODE] & 2
            acc[slot, 0, n] += w32(
                (s64(osc * v0) >> 24 if stereo else mono_pm) if haspm
                else osc)
            if haspm and stereo:
                acc[slot, 1, n] += w32(s64(osc * v1) >> 24)
    acc = ((acc + (1 << 31)) & M32) - (1 << 31)
    return (params.astype(np.int32), slot_r,
            torch.from_numpy(acc.astype(np.int32)), fast)


# ---------------------------------------------------------------
# seeded tables through the plain version and the model
# ---------------------------------------------------------------

def plain_parts(args):
    """expand_plain's (params [16, Rtot] with class-0 columns 0, slot_r,
    slots) on a copy of the slots."""
    rows_sig, mono, dead, runs, ramps, tbases, ptabs, slots = args
    slots = slots.clone()
    classes, slot_r = EX.expand_plain(rows_sig, mono, dead, runs, ramps,
                                      tbases, ptabs, slots)
    rtot = slot_r.shape[0]
    params = np.zeros((16, rtot), np.int32)
    for cls, tb, par, b0 in classes:
        params[:, b0:b0 + par.shape[1]] = par.numpy()
    return params, slot_r.numpy(), slots


SEEDED = {
    "sorted plain": dict(),
    "sorted mono": dict(mono=True),
    "shuffled plain": dict(order="shuffled"),
    "all dead": dict(order="dead"),
    "packed rmq, plain ramps": dict(packed=True),
    "packed rmq and rqr": dict(packed=True, ramps="rqr"),
    "shuffled packed, no ramps": dict(order="shuffled", packed=True,
                                      ramps=None),
    "plain runs, packed rqr, mono": dict(ramps="rqr", mono=True),
    "pass classes only": dict(rows_sig=((1, 1), (4, 2), (18, 1))),
}


@pytest.mark.parametrize("name", list(SEEDED))
def test_kernel_model_matches_plain_on_seeded_tables(name):
    args = EX.seeded_args(len(name), **SEEDED[name])
    params, slot_r, slots = plain_parts(args)
    rows_sig, mono, dead, runs, ramps, _, ptabs, slots0 = args
    mp, ms, mslots, fast = kernel_model(rows_sig, mono, dead, runs, ramps,
                                        ptabs, slots0)
    assert fast == (SEEDED[name].get("order", "sorted") != "shuffled")
    assert np.array_equal(mp, params)
    assert np.array_equal(ms, slot_r)
    assert torch.equal(mslots, slots)
    if name != "all dead":
        # the tables reach the paths they are made for
        assert (slot_r != dead).any() and (slot_r == dead).any()
        assert not torch.equal(slots, slots0) or "classes only" in name


# ---------------------------------------------------------------
# a torch model of the row -> run map and the per-row replay, over
# whole tables at once
# ---------------------------------------------------------------

def torch_rows_model(rm, rmp, rtot, ptabs):
    """The kernel's row -> run map and per-row ramp replay, vectorised in
    torch over the rows: the runs' order decided from adjacent pairs;
    over sorted runs each row's run by a search (searchsorted), else by
    counting every run; each ramp row replays its own ramp run, over its
    ramp's base run, up to fragment min(k, 15), steps applied only to
    the rows still short of theirs.  rm / rmp int64 tables.  Returns
    (rid [rtot], whether the runs were sorted, use mask [rtot], tg int64
    [rtot, 10] (0 where not use))."""
    start = rm[:, RC_START].clamp(0, rtot)
    alive = rm[:, RC_LEN] > 0
    na = int(alive.sum())
    pairs_ok = ~(alive[1:] & (~alive[:-1] | (start[:-1] > start[1:])))
    ordered = bool(pairs_ok.all())
    p = torch.arange(rtot, dtype=torch.int64)
    if ordered:
        rid = torch.searchsorted(start[:na].contiguous(), p,
                                 right=True) - 1
    else:
        rid = ((start[None, :] <= p[:, None]) & alive[None, :]).sum(1) - 1
    g = rm[rid.clamp(min=0)]
    k = p - g[:, RC_START]
    live = (rid >= 0) & (k < g[:, RC_LEN])
    tg = torch.zeros((rtot, 10), dtype=torch.int64)
    if rmp is None:
        return rid, ordered, torch.zeros_like(live), tg
    nrr = rmp.shape[0]
    use = live & (g[:, RC_RIDX] >= 0) & (k >= 1)
    frag = (k - 1).clamp(0, 14) * nrr + g[:, RC_RIDX].clamp(min=0)
    q = rmp[(frag % nrr)[use]]
    steps = (frag // nrr).clamp(max=14)[use] + 1
    gb = rm[q[:, RR_BASE].clamp(0, rm.shape[0] - 1)]
    wrap = EX._w
    av, at = wrap(gb[:, RC_AMP0] + 64 * gb[:, RC_DAMP]), q[:, RR_ATMR]
    vv, vt = wrap(gb[:, RC_VOL0] + 64 * gb[:, RC_DVOL]), q[:, RR_VTMR]
    pv, ptm = wrap(gb[:, RC_PAN0] + 64 * gb[:, RC_DPAN]), q[:, RR_PTMR]
    pcv, pct, pramp = q[:, RR_PV], q[:, RR_PTIMER], q[:, RR_PRAMP]
    dphraw, period = q[:, RR_DPHRAW] & M32, q[:, RR_PERIOD] & M32
    zero = torch.zeros_like(av)
    msz = torch.where((gb[:, RC_MODE] & 8) != 0, zero, gb[:, RC_SIZE] << 24)
    dph0 = gb[:, RC_DPH] & M32
    ph0 = (gb[:, RC_PHHI] << 32) | (gb[:, RC_PHLO] & M32)
    ph = ph0 + 64 * dph0
    span = gb[:, RC_OFF] + gb[:, RC_TOTAL]
    end0 = span.clamp(0, FRAG)
    dcnt = torch.where(dph0 >= (1 << 23), end0 - gb[:, RC_OFF],
                       ((ph0 + end0 * dph0) >> 23)
                       - ((ph0 + gb[:, RC_OFF] * dph0) >> 23))
    out = torch.zeros((len(q), 10), dtype=torch.int64)
    for kk in range(1, 16):
        fr = (span - (kk << 6)).clamp(1, FRAG)
        av2, ad, at = EX._prepare_vec(av, q[:, RR_AT], at, fr)
        vv2, vd, vt = EX._prepare_vec(vv, q[:, RR_VT], vt, fr)
        pv2, pd, ptm = EX._prepare_vec(pv, q[:, RR_PT], ptm, fr)
        pcv2, pcd, pct = EX._prepare_vec(pcv, q[:, RR_PTGT], pct, fr)
        skip = (dphraw != 0) & (pct == 0) & (pramp == 0)
        lastv = pcv2 & M32
        pcv = torch.where(skip, pcv2, wrap(pcv2 + pcd * fr))
        pin = ((lastv + (pcv & M32)) & M32) >> 9
        dphraw = torch.where(skip, dphraw, EX._p2i_vec(pin, ptabs))
        pramp = torch.where(skip, pramp, pcd)
        dph = (dphraw * period) >> q[:, RR_MIP]
        phm = torch.where(msz > 0, torch.remainder(
            ph, torch.where(msz > 0, msz, torch.ones_like(msz))), ph)
        now = steps == kk
        vals = torch.stack([av2, ad, vv2, vd, pv2, pd, dph, phm >> 32,
                            phm & M32, dcnt], dim=1)
        out = torch.where(now[:, None], wrap(vals), out)
        dk = torch.where(dph >= (1 << 23), fr,
                         ((phm + fr * dph) >> 23) - (phm >> 23))
        av, vv, pv = (wrap(av2 + ad * fr), wrap(vv2 + vd * fr),
                      wrap(pv2 + pd * fr))
        ph, dcnt = phm + fr * dph, dcnt + dk
    tg[use] = out
    return rid, ordered, use, tg


def _rows_and_traj(rm, rmp, rows_sig, ptabs):
    """The plain version's row -> run map (``row_runs``) and its ramp
    trajectory gather, per row (0 where not use)."""
    rtot = sum(nb * RPB for _, nb in rows_sig)
    rid, k, alive = EX.row_runs(rm.numpy(), rows_sig)
    rid, k, alive = (torch.from_numpy(x) for x in (rid, k, alive))
    tg = torch.zeros((rtot, 10), dtype=torch.int64)
    if rmp is None:
        return rid, tg
    traj = EX._ramp_scan(rmp, rm, ptabs)
    ridx = rm[rid.clamp(min=0), RC_RIDX]
    use = (ridx >= 0) & (k >= 1) & alive
    fidx = (k - 1).clamp(0, 14) * rmp.shape[0] + ridx.clamp(min=0)
    tg[use] = traj.reshape(-1, 10)[fidx[use]].to(torch.int64)
    return rid, tg


@pytest.mark.parametrize("name", ["sorted plain", "shuffled plain",
                                  "all dead", "sorted mono"])
def test_torch_model_of_the_row_map_and_replay(name):
    """The torch model's rows (search over sorted runs, or the count)
    and per-row replays equal the plain version's map and trajectory
    gather, on seeded tables."""
    args = EX.seeded_args(len(name) + 50, **SEEDED[name])
    rows_sig, runs, ramps, ptabs = args[0], args[3], args[4], args[6]
    rm = runs[1].to(torch.int64)
    rmp = ramps[1].to(torch.int64)
    rtot = sum(nb * RPB for _, nb in rows_sig)
    rid, ordered, use, tg = torch_rows_model(rm, rmp, rtot, ptabs)
    want_rid, want_tg = _rows_and_traj(rm, rmp, rows_sig, ptabs)
    assert ordered == (SEEDED[name].get("order", "sorted") != "shuffled")
    assert torch.equal(rid, want_rid)
    assert torch.equal(tg, want_tg)
    assert name == "all dead" or bool(use.any())


def test_seeded_tables_reach_every_branch():
    """The seeded tables ramp-replay rows, render noise and dc rows,
    wrap looped phases and leave rows dead."""
    rng = np.random.default_rng(5)
    sp = EX.seeded_program(rng)
    rm, rows_sig = sp["rm"], sp["rows_sig"]
    rid, k, alive = EX.row_runs(rm, rows_sig)
    g = rm[np.maximum(rid, 0)]
    c0 = slice(0, rows_sig[0][1] * RPB)
    mode = g[c0, RC_MODE][alive[c0]]
    assert ((mode & 16) != 0).any() and ((mode & 16) == 0).any()
    assert ((mode & 8) != 0).any()
    assert (alive & (g[:, RC_RIDX] >= 0) & (k >= 15)).any()
    assert (alive & (g[:, RC_SIZE] > 0) & (k > 0)).any()
    assert (~alive).any()
    nb, ops = EX.work(rm, sp["rmp"], rows_sig, False)
    assert nb > 0 and ops > EX.OPS_ROW * sum(n * RPB for _, n in rows_sig)


# ---------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------

def test_expand_call_on_the_cpu_is_the_plain_version():
    args = EX.seeded_args(3, packed=True, ramps="rqr")
    params, slot_r, slots = plain_parts(args)
    rows_sig, mono, dead, runs, ramps, tbases, ptabs, slots0 = args
    got = slots0.clone()
    classes, sr = EX.expand_call(rows_sig, mono, dead, runs, ramps, tbases,
                                 ptabs, got)
    assert torch.equal(got, slots) and np.array_equal(sr.numpy(), slot_r)
    for cls, tb, par, b0 in classes:
        assert cls and par.dtype == torch.int32 and par.is_contiguous()
        assert np.array_equal(par.numpy(),
                              params[:, b0:b0 + par.shape[1]])
    assert EX.expand_call.launches == 0


def _bad(args, i, value):
    args = list(args)
    args[i] = value
    return args


def test_expand_call_refuses_bad_arguments():
    args = EX.seeded_args(4)
    rows_sig, mono, dead, runs, ramps, tbases, ptabs, slots = args
    meta = torch.empty(runs[1].shape, dtype=torch.int32, device="meta")
    bad = [
        _bad(args, 3, ("plain", meta)),                        # mixed
        _bad(args, 7, slots.to("meta")),                      # all meta
        _bad(args, 3, ("plain", runs[1].to(torch.int64))),    # dtype
        _bad(args, 3, ("plain", runs[1][:, :10].contiguous())),  # shape
        _bad(args, 3, ("plain", runs[1].t())),                # layout
        _bad(args, 3, ("rmq", runs[1], [])),                  # form
        _bad(args, 3, ("zip", runs[1])),
        _bad(args, 4, ("rqr", ramps[1], [])),
        _bad(args, 5, tbases[:-1]),                            # blocks
        _bad(args, 5, [tbases[0][:1]] + tbases[1:]),
        _bad(args, 2, slots.shape[0]),                         # dead slot
        _bad(args, 7, slots[:, :1].contiguous()),
        _bad(args, 6, (ptabs[0].to(torch.int32), ptabs[1])),
        _bad(args, 0, ((3, 1),) + rows_sig[1:]),
    ]
    for b in bad:
        with pytest.raises(ValueError):
            EX.expand_call(*b)


def test_launch_counts_by_kind():
    """A launch counts into each of its kinds once; a graph capture's
    counts into the wrapper's when the graph runs."""
    from audiality2_tpu_torch.cuda import build
    fn = EX.expand_call
    before = fn.launches, dict(fn.kind_launches)
    try:
        with build.captured_launches() as counts:
            build.count_launch(fn)
            build.count_launch(fn, ("plain", "rqr"))
        assert fn.launches == before[0]
        build.add_launches(counts)
        assert fn.launches == before[0] + 2
        assert fn.kind_launches["plain"] == before[1]["plain"] + 1
        assert fn.kind_launches["rqr"] == before[1]["rqr"] + 1
        assert fn.kind_launches["rmq"] == before[1]["rmq"]
    finally:
        fn.launches, fn.kind_launches = before[0], before[1]


# ---------------------------------------------------------------
# real superblocks against the JAX package
# ---------------------------------------------------------------

CASES = {"slice stereo": (SLICE_SONG, 2, 8192, 4096, False),
         "slice mono": (SLICE_SONG, 1, 8192, 4096, False),
         "effects unpacked": (EFFECTS_SONG, 2, 4096, 8192, False),
         "effects packed": (EFFECTS_SONG, 2, 4096, 8192, True),
         "pitch ramps": (PITCH_SONG, 2, 8192, 0, False)}


@pytest.fixture(scope="module")
def recorded():
    out = {}
    for name, (src, ch, frames, skip, _) in CASES.items():
        key = (src, ch, frames, skip)
        if key not in out:
            out[key] = record(src, ch, frames, skip)
    return out


def mixers(recorded, name):
    """A port and a JAX mixer on one recorded superblock, each with its
    own padded copy (observed first where the packed format is on):
    (port mixer, sig, blob views, JAX mixer, JAX sig, JAX program)."""
    src, ch, frames, skip, packed = CASES[name]
    prog, jprog, tpa, jpa = recorded[(src, ch, frames, skip)]
    tm = TorchMixer(_Core(tpa), device="cpu")
    jm = JSB.DeviceMixer(_Core(jpa), interpret=True)
    if packed:
        tm.observe(copy.deepcopy(prog))
        jm.observe(copy.deepcopy(jprog))
    tp, jp = copy.deepcopy(prog), copy.deepcopy(jprog)
    sig, blob, _, _ = tm._prepare(tp)
    jm._repad(jp)
    jsig = jm._signature(jp)
    assert sig == jsig and (sig[12] is not None) == packed
    v = blob_views(torch.from_numpy(blob), blob_layout(sig)[0])
    return tm, sig, v, jm, jsig, jp


def jax_slots(jm, jsig, jp):
    (F, ninst, _, _, rows_sig, _, _, _, ramppad, _, quality, _,
     _) = jsig
    nslot = ninst * F + 1
    out = JSB._expand_rows(
        jnp.zeros((nslot, 2, FRAG), jnp.int32), jm._atlas(), rows_sig,
        [jnp.asarray(tb) for _, _, tb in jp.class_blocks],
        jnp.asarray(jp.runmat),
        jnp.asarray(jp.rampmat) if ramppad else None, nslot - 1, True,
        ramppad > 0, quality & 15, mono=bool(quality & 32))
    return np.asarray(out)


@pytest.mark.parametrize("name", list(CASES))
def test_expand_matches_jax(recorded, name):
    tm, sig, v, jm, jsig, jp = mixers(recorded, name)
    want = jax_slots(jm, jsig, jp)
    nslot = sig[1] * sig[0] + 1
    got = torch.zeros((nslot, 2, FRAG), dtype=torch.int32)
    tm._expand(sig, v, got)
    assert np.array_equal(got.numpy(), want)
    assert np.abs(want).max() > 0
    # expand_plain, then the oscillator's plain version per pass class
    slots = torch.zeros_like(got)
    args = tm._expand_args(sig, v, slots)
    classes, slot_r = EX.expand_plain(*args)
    mono = args[1]
    for cls, tb, par, b0 in classes:
        res = OK.osc_rows_torch(cls, tb, par, tm._atlas_dev, 0, True, mono)
        EX.add_rows(slots, slot_r[b0:b0 + par.shape[1]], res.t(), mono)
    assert torch.equal(slots, got)
    # the padding left dead rows; the ramp case replays ramps
    assert (slot_r == nslot - 1).any()
    if name == "pitch ramps":
        assert sig[8] > 0


@pytest.mark.parametrize("name", ["effects packed", "slice stereo"])
def test_expand_plain_equals_the_glue(recorded, name):
    """expand_plain's parameters and slot indices from the blob (the
    packed upload decoded) equal the row glue's on the padded program
    (``TorchMixer.row_params``), dead rows included; the kernel model
    equals both on the real tables."""
    tm, sig, v, jm, jsig, jp = mixers(recorded, name)
    nslot = sig[1] * sig[0] + 1
    slots = torch.zeros((nslot, 2, FRAG), dtype=torch.int32)
    args = tm._expand_args(sig, v, slots)
    classes, slot_r = EX.expand_plain(*args)
    src, ch, frames, skip, _ = CASES[name]
    prog = copy.deepcopy(recorded[(src, ch, frames, skip)][0])
    tm._repad(prog)
    gclasses, gslot_r, gmono = tm.row_params(prog)
    assert gmono == args[1]
    assert torch.equal(gslot_r, slot_r)
    assert (slot_r == nslot - 1).any()
    glue = [(c, par) for c, _, par in gclasses if c]
    assert [(c, p.shape) for c, p in glue] \
        == [(c, p.shape) for c, _, p, _ in classes]
    for (c, gp), (_, _, p, _) in zip(glue, classes):
        assert torch.equal(gp, p)
    if name == "effects packed":
        # the kernel model on the real packed tables, whose run order
        # (program_from_native's) takes the searches over sorted runs
        params, sr, pslots = plain_parts(args)
        mp, ms, mslots, fast = kernel_model(*args[:5], args[6], args[7])
        assert fast
        assert np.array_equal(mp, params) and np.array_equal(ms, sr)
        assert torch.equal(mslots, pslots)


@pytest.mark.parametrize("name", ["slice stereo", "pitch ramps"])
def test_torch_model_on_real_superblocks(recorded, name):
    """The torch model of the row map and per-row replay on recorded,
    padded tables (sorted by ``program_from_native``: the search path)."""
    tm, sig, v, _, _, _ = mixers(recorded, name)
    rm, rmp = v["rm"].to(torch.int64), v["rmp"].to(torch.int64)
    rows_sig = sig[4]
    rtot = sum(nb * RPB for _, nb in rows_sig)
    rid, ordered, use, tg = torch_rows_model(rm, rmp, rtot, tm._ptabs)
    want_rid, want_tg = _rows_and_traj(rm, rmp, rows_sig, tm._ptabs)
    assert ordered and bool(use.any())
    assert torch.equal(rid, want_rid) and torch.equal(tg, want_tg)
