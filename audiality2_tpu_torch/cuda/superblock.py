"""Superblock program builder, without JAX.

The numpy half of ``audiality2_tpu/tpu/superblock.py``: the
``SuperblockProgram`` container, the oscillator-run layout
(``_build_runs``) and ``program_from_native``, which turns one native
record pass (``NativeRenderer.record``) into the tables the mixer
runs.  The code below is copied from that file unchanged (line ranges
99-123, 149-238, 287-382 and 713-1195, minus the probe helpers and
the host-engine ``compile_superblock``), so both packages build the
same program from the same record; ``tests/test_torch_mixer.py``
holds them equal.  The run layout goes through the port's own copy of
``native.layout_runs``.
"""

import numpy as np

from ..constants import A2_MAXFRAG
from . import osc_kernel as OK

FRAG = A2_MAXFRAG
# fbdelay ring sizes: the legacy ring per channel, and the dense
# form's tail (the builder checks a superblock against both)
_FBD_BUFSIZE = 1 << 20
FBD_TAIL = 1 << 17


class Unsupported(Exception):
    """Op tape contains something the device program can't express."""



def _pow2(n, lo=1):
    p = lo
    while p < n:
        p <<= 1
    return p


def _quant(n, step):
    """Rounds n up to a multiple of step.  Used for the mixer's
    monotone shape padding: finer than pow2 (which wastes up to 2x
    upload and compute on padding), at the cost of a few more shape
    crossings — which the profiled render absorbs, since its dry
    pass pins the high-water marks before the one jit compile."""
    return ((max(n, 1) + step - 1) // step) * step


class SuperblockProgram:
    """Compiled device program for one superblock (see compile())."""

    def __init__(self):
        self.F = 0
        self.frag_sizes = None
        self.ninst = 0
        self.master_inst = 0
        self.master_channels = 1
        # oscillator runs (see _build_runs): one record per LEN
        # consecutive linearly-continuing fragments of an oscillator;
        # the device expands runs into per-fragment kernel rows
        # (_expand_rows), so upload and host build cost scale with
        # the run count, not the row count
        self.runmat = None       # int32 [Nr, BASE_N]
        self.rampmat = None      # int32 [NrR, RC_N] (RAMP runs only)
        self.inst_of = None      # owner serial -> instance index lut
        self.nruns = 0
        self.has_ramp = False    # any RAMP run (part of the sig)
        self.class_blocks = []   # (pass_class, NB, tbase np[NB])
        self.Rtot = 0            # total expanded row capacity
        # stash
        self.stash_audio = None  # int32 [NS, 2, 64] pre-masked
        self.stash_slot = None   # int32 [NS]
        self.stash_mono = None   # int32 [NSm, 64] (1-channel patches)
        self.stash_mono_slot = None
        # stages: list of dicts (kind, variant, arrays)
        self.stages = []
        # fbdelay instances: list of dicts
        self.fbdelays = []
        # filter12/dcblock/limiter classes: instance-batched scans
        self.filters = []


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

# run pass classes: the pallas classes plus the table-less noise
# class 0, which _expand_rows computes directly on the VPU
ALL_CLASSES = (0,) + OK.PASS_CLASSES

# run-matrix columns (SuperblockProgram.runmat).  START is the run's
# first expanded-row index in the concatenated class row space; dead
# (padding) runs have LEN 0 and START == Rtot.  A run covers TOTAL
# contiguous samples from fragment FRAG0 sample OFF, spanning LEN
# fragments; AMP0/VOL0/PAN0 (and PH) are fragment-frame-0 normalized.
#
# RC_RAMP=1 marks a ramper-replay run (native/a2rt_record.inc): its
# fragments k>=1 are reconstructed by replaying a2_PrepareRamper /
# wtosc_run_pitch per fragment from the RC_AT..RC_PERIOD snapshot
# (state at the END of fragment 0) in _ramp_scan — whole envelope and
# pitch-ramp segments ship as single runs even though the reference's
# per-fragment integer division bends them off any line.
(RC_START, RC_LEN, RC_DPH, RC_SIZE, RC_POSOFF, RC_AMP0, RC_DAMP,
 RC_VOL0, RC_DVOL, RC_PAN0, RC_DPAN, RC_SLOT, RC_MODE, RC_OFF,
 RC_TOTAL, RC_PHHI, RC_PHLO,
 RC_RAMP, RC_MIP, RC_AT, RC_ATMR, RC_VT, RC_VTMR, RC_PT, RC_PTMR,
 RC_PV, RC_PTGT, RC_PTIMER, RC_PRAMP, RC_DPHRAW, RC_PERIOD) = range(31)
RC_N = 31

# the uploaded runmat carries only the base columns plus RC_RIDX (an
# index into the separate rampmat, -1 for LINEAR runs) — the 13
# ramper-snapshot columns ship only for the RAMP runs that need them,
# keeping the per-run upload at 72 B + 56 B for ramp runs
RC_RIDX = RC_RAMP
BASE_N = RC_RIDX + 1

# rampmat layout: the 13 snapshot columns plus a back-pointer to the
# run's base row (for the scan's shared base fields)
(RR_MIP, RR_AT, RR_ATMR, RR_VT, RR_VTMR, RR_PT, RR_PTMR,
 RR_PV, RR_PTGT, RR_PTIMER, RR_PRAMP, RR_DPHRAW, RR_PERIOD,
 RR_BASE) = range(14)
RR_N = 14

# device ramp-replay scan length (native a2rt_record.inc RUN_KCHUNK):
# a RAMP run spans at most this many fragments
RUN_KCHUNK = 16


def _build_runs(prog, cls_arr, tbase, posoff, ph_hi, ph_lo, dph,
                modsize, amp0, damp, vol0, dvol, pan0, dpan, slot0,
                mode, off0, total, lens, extra=None):
    """Sorts oscillator runs by (pass class, table base), lays their
    expanded rows out in 128-row kernel blocks (padding within each
    (class, tbase) bucket so a block reads one table), and fills
    prog.runmat / prog.class_blocks / prog.Rtot.  All inputs are
    int32 numpy arrays of length = number of runs; everything here is
    O(runs), not O(rows)."""
    Nr = len(cls_arr)
    prog.nruns = Nr
    if Nr == 0:
        prog.runmat = np.zeros((0, BASE_N), np.int32)
        prog.rampmat = np.zeros((0, RC_N), np.int32)
        prog.class_blocks = [(c, 0, np.zeros(0, np.int32))
                             for c in ALL_CLASSES]
        prog.Rtot = 0
        prog.has_ramp = False
        return
    # assemble the run matrix UNSORTED first (contiguous column
    # writes), then apply the sort as ONE row gather — 17 separate
    # `x[order]` gathers each re-walk the permutation cache-hostilely
    # and dominated the build at ~180k runs/superblock
    m = np.empty((Nr, RC_N), np.int32)
    m[:, RC_LEN] = lens
    m[:, RC_DPH] = dph
    m[:, RC_SIZE] = modsize
    m[:, RC_POSOFF] = posoff
    m[:, RC_AMP0] = amp0
    m[:, RC_DAMP] = damp
    m[:, RC_VOL0] = vol0
    m[:, RC_DVOL] = dvol
    m[:, RC_PAN0] = pan0
    m[:, RC_DPAN] = dpan
    m[:, RC_SLOT] = slot0
    m[:, RC_MODE] = mode
    m[:, RC_OFF] = off0
    m[:, RC_TOTAL] = total
    m[:, RC_PHHI] = ph_hi
    m[:, RC_PHLO] = ph_lo
    if extra is not None:
        # ramper-replay snapshot columns RC_RAMP..RC_PERIOD
        m[:, RC_RAMP:RC_N] = extra
    else:
        m[:, RC_RAMP:RC_N] = 0
    order = np.lexsort((tbase, cls_arr))
    m = m[order]
    cls_s = cls_arr[order]
    tb_s = tbase[order]
    len_s = m[:, RC_LEN].astype(np.int64)
    bkey = (cls_s.astype(np.int64) << 32) | tb_s
    newb = np.empty(Nr, bool)
    newb[0] = True
    newb[1:] = bkey[1:] != bkey[:-1]
    bstart = np.nonzero(newb)[0]
    brows = np.add.reduceat(len_s, bstart)
    bpad = ((brows + OK.RPB - 1) // OK.RPB) * OK.RPB
    bcls = cls_s[bstart]
    btb = tb_s[bstart].astype(np.int32)

    class_blocks = []
    bucket_base = np.zeros(len(bstart), np.int64)
    base = 0
    for c in ALL_CLASSES:
        sel = np.nonzero(bcls == c)[0]
        crows = int(bpad[sel].sum()) if len(sel) else 0
        NB = crows // OK.RPB
        if len(sel):
            cb = np.cumsum(bpad[sel]) - bpad[sel]
            bucket_base[sel] = base + cb
            tb_blocks = np.repeat(btb[sel],
                                  (bpad[sel] // OK.RPB).astype(np.int64))
        else:
            tb_blocks = np.zeros(0, np.int32)
        class_blocks.append((c, NB, tb_blocks.astype(np.int32)))
        base += NB * OK.RPB
    prog.class_blocks = class_blocks
    prog.Rtot = base

    bid = np.cumsum(newb) - 1
    cum = np.cumsum(len_s) - len_s
    start = bucket_base[bid] + (cum - cum[bstart][bid])
    m[:, RC_START] = start
    ramp_sel = m[:, RC_RAMP] != 0
    nramp = int(ramp_sel.sum())
    ridx = np.full(Nr, -1, np.int32)
    ridx[ramp_sel] = np.arange(nramp, dtype=np.int32)
    base = np.empty((Nr, BASE_N), np.int32)
    base[:, :RC_RIDX] = m[:, :RC_RIDX]
    base[:, RC_RIDX] = ridx
    prog.runmat = base
    rmp = np.empty((nramp, RR_N), np.int32)
    rmp[:, RR_MIP:RR_BASE] = m[ramp_sel][:, RC_MIP:RC_PERIOD + 1]
    rmp[:, RR_BASE] = np.nonzero(ramp_sel)[0].astype(np.int32)
    prog.rampmat = rmp
    prog.has_ramp = nramp > 0


# native/a2rt_record.inc field indices
(RF_WAVE, RF_MIP, RF_PH_HI, RF_PH_LO, RF_DPH, RF_AMP0, RF_DAMP,
 RF_VOL0, RF_DVOL, RF_PAN0, RF_DPAN, RF_OWNER, RF_FRAG, RF_OFF,
 RF_TOTAL, RF_MODE, RF_LEN, RF_SIZE,
 RF_RAMP, RF_AT, RF_ATMR, RF_VT, RF_VTMR, RF_PT, RF_PTMR,
 RF_PV, RF_PTGT, RF_PTIMER, RF_PRAMP, RF_DPHRAW, RF_PERIOD,
 RF_NS0, RF_NLAST) = range(33)
(SF_KIND, SF_NEST, SF_CHAIN, SF_NI, SF_NO, SF_ADD, SF_SCH, SF_DCH,
 SF_SRC0, SF_SRC1, SF_DST0, SF_DST1, SF_FRAG, SF_OFF, SF_FRM,
 SF_P0, SF_P1, SF_P2, SF_P3, SF_P4, SF_P5, SF_P6, SF_SERIAL) = range(23)
SF_N = 23
SK_PANMIX, SK_COPY, SK_FBDELAY = 0, 1, 2
SK_WS, SK_F12, SK_DCB, SK_LIM = 3, 4, 5, 6
SK_FM, SK_FMP = 7, 8     # fm stage header + op1-3 continuation row
_FILT_TAG = {SK_F12: "f12", SK_DCB: "dcb", SK_LIM: "lim"}
# per-kind state-carrying item arr widths + dead-slot columns (the
# "filters" machinery hosts every instance-batched scan unit: the
# three filter recurrences and the fm operator graph)
_FILT_W = {"f12": 13, "dcb": 13, "lim": 13, "fm": 27}
_FILT_DEAD = {"f12": (2, 3), "dcb": (2, 3), "lim": (2, 3),
              "fm": (0,)}
# limiter peak state starts at 32768<<8 (reference limiter.c lim_init)
_LIM_PEAK0 = 32768 << 8


def program_from_native(rows, stages, stash, F, frag_sizes,
                        atlas_entry, master_channels,
                        inst_map=None):
    """Builds a SuperblockProgram from the native record pass's flat
    arrays (NativeRenderer.record).  atlas_entry(wave_handle, mip) ->
    (tbase, npass, pos_off) in the PairAtlas.  All heavy lifting is
    vectorized numpy — no per-row Python loops.

    inst_map: optional (inst_of_lut, ninst) precomputed from a FULL
    program — used by the sharded render to build per-shard row
    programs whose slot numbering agrees with the full program's
    stage tables (a shard sees only a subset of owners, so deriving
    the map from the subset would renumber instances)."""
    prog = SuperblockProgram()
    prog.F = F
    prog.frag_sizes = list(frag_sizes)
    prog.master_channels = master_channels
    prog.master_inst = 0

    if inst_map is not None:
        inst_of, ninst = inst_map
        prog.ninst = ninst
        prog.inst_of = inst_of
    else:
        # owner serials -> dense instance indices (0 = master).
        # SK_FMP continuation rows carry raw op params in the
        # SRC/DST columns and must not leak into the owner set.
        owners = [np.zeros(1, np.int32)]
        if len(rows):
            owners.append(rows[:, RF_OWNER])
        if len(stages):
            so = stages[stages[:, SF_KIND] != SK_FMP]
            owners.append(so[:, SF_SRC0])
            owners.append(so[:, SF_SRC1])
            owners.append(so[:, SF_DST0])
            owners.append(so[:, SF_DST1])
        if len(stash):
            owners.append(stash[:, 0])
        uniq = np.unique(np.concatenate(owners))
        assert uniq[0] == 0
        ninst = _pow2(len(uniq), 4)
        prog.ninst = ninst
        lut_sz = int(uniq.max()) + 1
        inst_of = np.zeros(lut_sz, np.int32)
        inst_of[uniq] = np.arange(len(uniq), dtype=np.int32)
        prog.inst_of = inst_of

    def slot(owner, frag):
        return inst_of[np.asarray(owner)] * F + np.asarray(frag)

    # ----- oscillator runs -----
    R = len(rows)
    if R:
        # noise runs (RF_WAVE == -1) have no wavetable: pseudo pass
        # class 0, RNG state / held sample ride the SIZE / POSOFF
        # columns (native a2rt_record.inc RM_NOISE)
        noise = rows[:, RF_WAVE] < 0
        wm = np.where(noise, 0,
                      rows[:, RF_WAVE].astype(np.int64) * 16
                      + rows[:, RF_MIP])
        uw = np.unique(wm[~noise]) if (~noise).any() \
            else np.zeros(0, np.int64)
        tb_l = np.zeros(int(uw.max()) + 1 if len(uw) else 1, np.int32)
        np_l = np.zeros_like(tb_l)
        off_l = np.zeros_like(tb_l)
        for key in uw:
            t, n_, o_ = atlas_entry(int(key) // 16, int(key) % 16)
            tb_l[key], np_l[key], off_l[key] = t, n_, o_
        lay = None
        try:
            from ..native import layout_runs
            lay = layout_runs(rows, inst_of, F, tb_l, np_l, off_l,
                              np.asarray(OK.PASS_CLASSES, np.int32))
        except Exception:
            lay = None
        if lay is not None:
            # native layout (a2rt_layout_runs): byte-identical to
            # _build_runs below, ~10x faster — the run layout was the
            # dominant host build cost and the host build caps
            # aggregate serving throughput
            runmat, rampmat, nb, tb_blocks, rtot = lay
            prog.runmat = runmat
            prog.rampmat = rampmat
            prog.nruns = R
            prog.has_ramp = len(rampmat) > 0
            blocks = []
            pos = 0
            for ci, c in enumerate(ALL_CLASSES):
                NB = int(nb[ci])
                blocks.append((c, NB,
                               tb_blocks[pos:pos + NB].copy()))
                pos += NB
            prog.class_blocks = blocks
            prog.Rtot = rtot
        else:
            tbase = np.where(noise, 0, tb_l[wm]).astype(np.int32)
            npass = np_l[wm]
            posoff = np.where(noise, rows[:, RF_NLAST],
                              off_l[wm]).astype(np.int32)
            cls_idx = np.searchsorted(OK.PASS_CLASSES, npass)
            cls_arr = np.asarray(OK.PASS_CLASSES, np.int32)[cls_idx]
            cls_arr = np.where(noise, 0, cls_arr).astype(np.int32)
            modsize = np.where(noise, rows[:, RF_NS0],
                               rows[:, RF_SIZE]).astype(np.int32)
            extra = np.empty((R, RC_N - RC_RAMP), np.int32)
            extra[:, 0] = rows[:, RF_RAMP]
            extra[:, 1] = rows[:, RF_MIP]
            extra[:, 2:] = rows[:, RF_AT:RF_PERIOD + 1]
            _build_runs(
                prog, cls_arr, tbase, posoff,
                rows[:, RF_PH_HI], rows[:, RF_PH_LO], rows[:, RF_DPH],
                modsize, rows[:, RF_AMP0], rows[:, RF_DAMP],
                rows[:, RF_VOL0], rows[:, RF_DVOL], rows[:, RF_PAN0],
                rows[:, RF_DPAN],
                slot(rows[:, RF_OWNER], rows[:, RF_FRAG])
                .astype(np.int32),
                rows[:, RF_MODE], rows[:, RF_OFF], rows[:, RF_TOTAL],
                rows[:, RF_LEN], extra)

    # ----- stash -----
    # mono patches (the common case: fm/noise/dc leaf voices) upload
    # one channel instead of the record format's fixed two — half the
    # stash bytes on fm-heavy songs
    NS = len(stash)
    if NS:
        mono_sel = stash[:, 4] <= 1
        sm = stash[mono_sel]
        st2 = stash[~mono_sel]
        NSm, NSs = len(sm), len(st2)
        if NSm:
            NSmp = _pow2(NSm, 64)
            ma = np.zeros((NSmp, FRAG), np.int32)
            msl = np.full(NSmp, ninst * F, np.int32)
            sl_m = slot(sm[:, 0], sm[:, 1])
            # slot-sorted (pure adds, order-free): the device stash
            # accumulation is a sorted segment-sum
            o = np.argsort(sl_m, kind="stable")
            ma[:NSm] = sm[o, 5:5 + FRAG]
            msl[:NSm] = sl_m[o]
            prog.stash_mono = ma
            prog.stash_mono_slot = msl
        if NSs:
            NSp = _pow2(NSs, 64)
            sa = np.zeros((NSp, 2, FRAG), np.int32)
            ssl = np.full(NSp, ninst * F, np.int32)
            sl_s = slot(st2[:, 0], st2[:, 1])
            o = np.argsort(sl_s, kind="stable")
            sa[:NSs] = st2[o, 5:].reshape(NSs, 2, FRAG)
            ssl[:NSs] = sl_s[o]
            prog.stash_audio = sa
            prog.stash_slot = ssl

    # ----- stages (vectorized grouping) -----
    if len(stages):
        S = stages
        skind = S[:, SF_KIND]
        reg = S[(skind == SK_PANMIX) | (skind == SK_COPY)
                | (skind == SK_WS)]
        # waveshaper rows apply identical per-sample math to each
        # channel: expand a stereo entry into two per-channel rows
        # (channel tag in SF_NI, like xinsert copies)
        ws2 = reg[(reg[:, SF_KIND] == SK_WS) & (reg[:, SF_NI] == 2)]
        if len(ws2):
            hi = ws2.copy()
            hi[:, SF_SRC0] = ws2[:, SF_SRC1]
            hi[:, SF_DST0] = ws2[:, SF_DST1]
            hi[:, SF_SCH] = ws2[:, SF_SCH] >> 8
            hi[:, SF_DCH] = ws2[:, SF_DCH] >> 8
            hi[:, SF_NI] = 1
            hi[:, SF_NO] = 0
            lo = reg.copy()
            sel = (lo[:, SF_KIND] == SK_WS) & (lo[:, SF_NI] == 2)
            lo[sel, SF_SCH] &= 0xFF
            lo[sel, SF_DCH] &= 0xFF
            lo[sel, SF_NI] = 0
            lo[sel, SF_NO] = 0
            reg = np.concatenate([lo, hi])
        else:
            sel = reg[:, SF_KIND] == SK_WS
            if sel.any():
                reg = reg.copy()
                reg[sel, SF_NI] = 0
                reg[sel, SF_NO] = 0
        # group key as one int64: nest/chain/kind/ni/no/add/sch/dch
        gk = (reg[:, SF_NEST].astype(np.int64) << 48) \
            | (reg[:, SF_CHAIN].astype(np.int64) << 40) \
            | (reg[:, SF_KIND].astype(np.int64) << 36) \
            | (reg[:, SF_NI].astype(np.int64) << 32) \
            | (reg[:, SF_NO].astype(np.int64) << 28) \
            | (reg[:, SF_ADD].astype(np.int64) << 24) \
            | (reg[:, SF_SCH].astype(np.int64) << 12) \
            | reg[:, SF_DCH].astype(np.int64)
        order = np.argsort(gk, kind="stable")
        gs = gk[order]
        bnd = np.nonzero(np.concatenate(
            [[True], gs[1:] != gs[:-1]]))[0]
        sizes = np.diff(np.append(bnd, len(gs)))
        ent = np.empty((len(reg), 9), np.int32)
        rr = reg[order]
        ent[:, 0] = slot(rr[:, SF_SRC0], rr[:, SF_FRAG])
        ent[:, 1] = slot(rr[:, SF_DST0], rr[:, SF_FRAG])
        ent[:, 2] = rr[:, SF_OFF]
        ent[:, 3] = rr[:, SF_FRM]
        ent[:, 4:9] = rr[:, SF_P0:SF_P4 + 1]
        frags_all = rr[:, SF_FRAG].astype(np.int64)
        far = np.arange(F, dtype=np.int32)
        for gi, b in enumerate(bnd):
            r0 = rr[b]
            nest, chain = int(r0[SF_NEST]), int(r0[SF_CHAIN])
            ni, no = int(r0[SF_NI]), int(r0[SF_NO])
            add = bool(r0[SF_ADD])
            sch = (int(r0[SF_SCH]) & 0xFF, int(r0[SF_SCH]) >> 8)
            dch = (int(r0[SF_DCH]) & 0xFF, int(r0[SF_DCH]) >> 8)
            if int(r0[SF_KIND]) == SK_PANMIX:
                key = (-nest, chain, "panmix", ni, no, add,
                       sch[:max(ni, 1)], dch[:max(no, 1)])
            elif int(r0[SF_KIND]) == SK_WS:
                key = (-nest, chain, "ws", ni, add,
                       (sch[0],), (dch[0],))
            else:
                key = (-nest, chain, "copy", ni, add,
                       (sch[0],), (dch[0],))
            n = int(sizes[gi])
            seg = ent[b:b + n]
            # dense partition: an instance-pair (= source/dest slot
            # span) whose slices are one-per-fragment ships as a
            # dense [F, 9] span table (contiguous device slices, no
            # gather/scatter — see _apply_stage_dense); pairs with
            # sub-fragment splits, and sparse pairs where the dense
            # table would cost more upload than it saves, stay on
            # the legacy slice list
            fr_g = frags_all[b:b + n]
            sspan = seg[:, 0].astype(np.int64) - fr_g
            dspan = seg[:, 1].astype(np.int64) - fr_g
            pk = (sspan << 32) | dspan
            o2 = np.argsort(pk, kind="stable")
            pks = pk[o2]
            pbnd = np.nonzero(np.concatenate(
                [[True], pks[1:] != pks[:-1]]))[0]
            psz = np.diff(np.append(pbnd, n))
            dense_groups = []
            legacy = []
            dense_dsts = set()
            for pb, pn in zip(pbnd, psz):
                idx = o2[pb:pb + pn]
                np_ = int(pn)
                frs = fr_g[idx]
                p = int(pks[pb])
                dsp = p & 0xFFFFFFFF
                # REPLACE groups must have unique destination spans
                # for the vectorized emit (the add-of-difference
                # reads `old` once for all groups; two REPLACEs into
                # one span would both subtract it) — such pairs stay
                # on the order-free legacy slice list
                if np_ * 2 < F or len(np.unique(frs)) != np_ \
                        or (not add and dsp in dense_dsts):
                    legacy.append(seg[idx])
                    continue
                dense_dsts.add(dsp)
                da = np.zeros((F, 9), np.int32)
                da[:, 0] = (p >> 32) + far
                da[:, 1] = dsp + far
                da[frs, 2:9] = seg[idx][:, 2:9]
                dense_groups.append(da)
            dense = np.stack(dense_groups) if dense_groups \
                else np.zeros((0, F, 9), np.int32)
            if legacy:
                lg = np.concatenate(legacy)
                nl = len(lg)
                K = _quant(nl, 128)
                arr = np.zeros((K, 9), np.int32)
                arr[:, 0] = ninst * F
                arr[:, 1] = ninst * F
                # dst-sorted (adds / add-of-difference are
                # order-free): the device emit is a sorted
                # segment-sum, padding = dead slot = highest index
                arr[:nl] = lg[np.argsort(lg[:, 1], kind="stable")]
            else:
                nl = 0
                arr = np.zeros((0, 9), np.int32)
            prog.stages.append({"kind": key[2], "key": key,
                                "arr": arr, "n": nl,
                                "dense": dense})
        prog.stages.sort(key=lambda st: st["key"])
        fbd = S[skind == SK_FBDELAY]
        filt = S[(skind == SK_F12) | (skind == SK_DCB)
                 | (skind == SK_LIM)]
    else:
        fbd = np.zeros((0, SF_N), np.int32)
        filt = np.zeros((0, SF_N), np.int32)
    for serial in np.unique(fbd[:, SF_SERIAL]) if len(fbd) else ():
        sr = fbd[fbd[:, SF_SERIAL] == serial]
        s0 = sr[0]
        # chunk bound: only the FEEDBACK delay serializes (reader
        # taps are vectorized against the final ring), so the chunk
        # grows to the fb tap's span, not min(fb, ld, rd)
        mind = int(sr[:, SF_P0].min())
        C = 1
        while C * 2 * FRAG <= mind and C < 1024:
            C *= 2
        n = len(sr)
        # dense eligibility (_apply_fbdelay_dense): contiguous
        # full-superblock coverage in time order (slices may split
        # fragments — per-slice gain ramps — the device expands gains
        # per sample), constant slot spans, constant fb/ld/rd within
        # the reference's 2^17 window (native fbd_process masks every
        # tap by 2^17-1).  fb/ld/rd become jit-time constants of the
        # dense program (static ring slicing), so they also gate the
        # signature (_repad keeps them sticky per song).
        tpos = sr[:, SF_FRAG].astype(np.int64) * FRAG \
            + sr[:, SF_OFF]
        dense = bool(
            n > 0
            and mind >= FRAG
            and tpos[0] == 0
            and (tpos[1:] == tpos[:-1] + sr[:-1, SF_FRM]).all()
            and tpos[-1] + sr[-1, SF_FRM] == F * FRAG
            and all((sr[:, c] == sr[0, c]).all()
                    for c in (SF_SRC0, SF_SRC1, SF_DST0, SF_DST1,
                              SF_P0, SF_P1, SF_P2))
            and max(int(sr[0, SF_P0]), int(sr[0, SF_P1]),
                    int(sr[0, SF_P2])) <= FBD_TAIL)
        if not dense and F * FRAG + FBD_TAIL > _FBD_BUFSIZE:
            # the legacy path's vectorized reader taps need the whole
            # superblock + max reference delay to fit the 2^20 ring
            # without wrapping (the dense path has no such bound: its
            # linear buffer is sized per superblock)
            raise Unsupported("superblock too long for fbdelay ring")
        ns = _quant(n, C)
        arr = np.zeros((ns, 13), np.int32)
        arr[:, :4] = ninst * F     # dead src/dst: keeps the emit's
        # sorted-segment invariant
        arr[:n, 0] = slot(sr[:, SF_SRC0], sr[:, SF_FRAG])
        arr[:n, 1] = slot(sr[:, SF_SRC1], sr[:, SF_FRAG])
        arr[:n, 2] = slot(sr[:, SF_DST0], sr[:, SF_FRAG])
        arr[:n, 3] = slot(sr[:, SF_DST1], sr[:, SF_FRAG])
        arr[:n, 4] = sr[:, SF_OFF]
        arr[:n, 5] = sr[:, SF_FRM]
        arr[:n, 6:13] = sr[:, SF_P0:SF_P6 + 1]
        prog.fbdelays.append({
            "unit_id": int(serial), "key": (-int(s0[SF_NEST]),
                                            int(s0[SF_CHAIN])),
            "stereoin": int(s0[SF_NI]) == 2,
            "stereoout": int(s0[SF_NO]) == 2,
            "add": bool(s0[SF_ADD]), "arr": arr, "n": n,
            "chunk": C, "dense": dense,
            "fbpar": (int(s0[SF_P0]), int(s0[SF_P1]),
                      int(s0[SF_P2])) if dense else (-1, -1, -1)})

    # ----- filter12 / dcblock / limiter: instance-batched per-sample
    # scans (serial state per instance persists on the device between
    # superblocks like the fbdelay rings) -----
    if len(filt):
        fk = (filt[:, SF_NEST].astype(np.int64) << 48) \
            | (filt[:, SF_CHAIN].astype(np.int64) << 40) \
            | (filt[:, SF_KIND].astype(np.int64) << 36) \
            | (filt[:, SF_NI].astype(np.int64) << 32) \
            | (filt[:, SF_NO].astype(np.int64) << 28) \
            | (filt[:, SF_ADD].astype(np.int64) << 24) \
            | (filt[:, SF_SCH].astype(np.int64) << 12) \
            | filt[:, SF_DCH].astype(np.int64)
        for key64 in np.unique(fk):
            rows_k = filt[fk == key64]
            serials = [int(s) for s in np.unique(rows_k[:, SF_SERIAL])]
            K = len(serials)
            Smax = max(int((rows_k[:, SF_SERIAL] == s).sum())
                       for s in serials)
            arr = np.zeros((Smax, K, 13), np.int32)
            arr[:, :, 2] = ninst * F
            arr[:, :, 3] = ninst * F
            for j, ser in enumerate(serials):
                sr = rows_k[rows_k[:, SF_SERIAL] == ser]
                n = len(sr)
                arr[:n, j, 0] = slot(sr[:, SF_SRC0], sr[:, SF_FRAG])
                arr[:n, j, 1] = slot(sr[:, SF_SRC1], sr[:, SF_FRAG])
                arr[:n, j, 2] = slot(sr[:, SF_DST0], sr[:, SF_FRAG])
                arr[:n, j, 3] = slot(sr[:, SF_DST1], sr[:, SF_FRAG])
                arr[:n, j, 4] = sr[:, SF_OFF]
                arr[:n, j, 5] = sr[:, SF_FRM]
                arr[:n, j, 6:13] = sr[:, SF_P0:SF_P6 + 1]
            r0 = rows_k[0]
            nest, chain = int(r0[SF_NEST]), int(r0[SF_CHAIN])
            ni, no = int(r0[SF_NI]), int(r0[SF_NO])
            sch = (int(r0[SF_SCH]) & 0xFF, int(r0[SF_SCH]) >> 8)
            dch = (int(r0[SF_DCH]) & 0xFF, int(r0[SF_DCH]) >> 8)
            kind = _FILT_TAG[int(r0[SF_KIND])]
            # float-tier eligibility: an undamped filter12 resonator
            # (q near 0) never decays the reference's truncation
            # noise, so the float continuum drifts beyond the -80 dB
            # budget — such classes keep the exact serial scan.  The
            # minimum q over this superblock's slices (q ramps
            # linearly within a slice) unions across the profile
            # pass in observe().  dcblock (Q=1) and the limiter are
            # always damped.
            if kind == "f12":
                qv = rows_k[:, SF_P2].astype(np.int64)
                qd = rows_k[:, SF_P3].astype(np.int64)
                frm = rows_k[:, SF_FRM].astype(np.int64)
                qe = qv + qd * np.maximum(frm - 1, 0)
                minq = int(min(qv.min(), qe.min()))
            else:
                minq = 1 << 30
            prog.filters.append({
                "kind": kind,
                "key": (-nest, chain, kind,
                        ni, no, bool(r0[SF_ADD]), sch[:max(ni, 1)],
                        dch[:max(no, 1)]),
                "serials": serials, "arr": arr, "n": K,
                "minq": minq})

    # ----- fm stages: instance-batched oversampled operator scans
    # (native a2rt_record.inc fm_record; SK_FM header + SK_FMP op1-3
    # continuation row).  Per-op `last` persists on the device
    # between superblocks like filter state. -----
    if len(stages):
        fmi = np.nonzero(stages[:, SF_KIND] == SK_FM)[0]
        if len(fmi):
            fmh = stages[fmi]
            fmp = stages[fmi + 1]       # SK_FMP partners
            fk = (fmh[:, SF_NEST].astype(np.int64) << 48) \
                | (fmh[:, SF_CHAIN].astype(np.int64) << 40) \
                | (fmh[:, SF_P0].astype(np.int64) << 16) \
                | (fmh[:, SF_ADD].astype(np.int64) << 8) \
                | fmh[:, SF_DCH].astype(np.int64)
            for key64 in np.unique(fk):
                m2 = fk == key64
                rows_k = fmh[m2]
                prm_k = fmp[m2]
                serials = [int(s)
                           for s in np.unique(rows_k[:, SF_SERIAL])]
                K = len(serials)
                Smax = max(int((rows_k[:, SF_SERIAL] == s).sum())
                           for s in serials)
                arr = np.zeros((Smax, K, 27), np.int32)
                arr[:, :, 0] = ninst * F       # dead dst
                for j, ser in enumerate(serials):
                    sel = rows_k[:, SF_SERIAL] == ser
                    sr = rows_k[sel]
                    pr = prm_k[sel]
                    n = len(sr)
                    arr[:n, j, 0] = slot(sr[:, SF_DST0],
                                         sr[:, SF_FRAG])
                    arr[:n, j, 1] = sr[:, SF_OFF]
                    arr[:n, j, 2] = sr[:, SF_FRM]
                    arr[:n, j, 3:9] = sr[:, SF_P1:SF_P6 + 1]
                    arr[:n, j, 9:27] = pr[:, 1:19]
                r0 = rows_k[0]
                nest, chain = int(r0[SF_NEST]), int(r0[SF_CHAIN])
                sk = int(r0[SF_P0])
                prog.filters.append({
                    "kind": "fm",
                    "key": (-nest, chain, "fm", sk,
                            bool(r0[SF_ADD]),
                            (int(r0[SF_DCH]),)),
                    "serials": serials, "arr": arr, "n": K,
                    "minq": 1 << 30})

    return prog
