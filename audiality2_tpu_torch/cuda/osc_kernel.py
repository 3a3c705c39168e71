"""Wavetable oscillator rows: the CUDA kernel, its wrapper and its plain
PyTorch version.

Port of the Pallas kernel ``audiality2_tpu/tpu/osc_kernel.py``
(``_make_kernel``, launched by ``_osc_call``).  Every row is 64 frames
of one wtosc voice fragment; 128 rows form a block and every row of a
block reads the same (wave, mip) table, whose first atlas row is
``tbase[block]``.  Per row and frame the kernel computes the exact
48:24 phase as (pos, frac24), looks up packed sample pairs
``d[k+1] << 16 | u16(d[k])``, interpolates (hifi 2x Hermite, normal 2x
lerp, lofi lerp << 1), scales by the amplitude ramp with
``(v * amp) >> 17`` in three limbs, applies the fused per-row panmix
(vol/pan ramps, ``_mul_shr24``, the 2*vol clamp) and masks to the
row's ``[OFF, END)`` window.  All arithmetic is int32 with wrap.

Two entry points share the kernel in ``csrc/osc_kernel.cu`` (one body,
two epilogues): ``osc_call`` returns the rows in the Pallas kernel's
layout (plain version ``osc_rows_torch``), and ``osc_slots_call`` adds
each row's samples into the (instance x fragment) slots in place, the
JAX package's ``segment_sum`` after the kernel (plain version
``osc_slots_torch``).  Each runs its plain version for CPU tensors and
the kernel for CUDA tensors; the kernel is built with ``nvcc`` at first
use into ``cuda/build/`` and bound with ctypes (``build.py``).
"""

import ctypes
import threading

import numpy as np
import torch

from ..constants import A2_MAXFRAG, A2_WAVEPRE
from . import build

FRAG = A2_MAXFRAG           # 64 frames per row
RPB = 128                   # rows per block
NPARAM = 16                 # packed param vectors per row
NPREAD = 13                 # of which the kernel reads the first 13

# param indices within a row's NPARAM column (same layout as the JAX
# package's kernel): slots 6..12 feed the fused per-row panmix
(P_POS0, P_F0, P_DPOS, P_DF, P_AMP0, P_DAMP,
 P_VOL0, P_DVOL, P_PAN0, P_DPAN, P_OFF, P_END, P_MODE) = range(13)

# row mode bits (shared with the superblock row tables)
ROW_HASPM = 1               # row passes through a panmix stage
ROW_STEREO = 2              # panmix 1->2 (else 1->1 vol only)
ROW_CLAMP = 4               # panmix clamps v0/v1 at 2*vol

# pass classes: a block of class c holds a table of at most c atlas
# rows; 18 covers a mip-0 2048-entry table plus its padding
PASS_CLASSES = (1, 2, 4, 8, 18)


class PairAtlas:
    """Wave atlas packed as int32 (d[k+1]<<16 | u16(d[k])) pairs,
    reshaped to (rows, 128).

    Each (wave, mip) level's padded data (A2_WAVEPRE + size + post)
    is placed at a 128-aligned offset so a block's table base is a
    whole row; lookup() returns (tbase_row, npass, pos_offset) where
    pos_offset is added to the oscillator's sample position (d[0]
    relative) to form the kernel's pair index."""

    def __init__(self):
        self._rows = []          # list of (128,) int32 rows
        self._index = {}         # (wave_key, mip) -> (tbase, npass, off)
        self.data = None         # numpy (T, 128) after finalize
        self.np_pairs = None     # numpy flat pairs (for the twin)
        self.version = 0
        # a fleet-shared atlas (serve.render_multiplexed) is mutated
        # from record threads when a stream's superblock meets an unseen
        # wave: add_wave's tbase = len(_rows) and the extend must not
        # interleave.  Reentrant, so that callers hold it across their
        # own check-then-act (DeviceRenderer.atlas_entry).
        self.lock = threading.RLock()

    def add_wave(self, key, wave):
        with self.lock:
            for mm in range(wave.miplevels):
                d = np.asarray(wave.data[mm], dtype=np.int32)
                # pairs P[k] = (d16[k+1]<<16) | u16(d16[k]); one extra
                # 0 beyond the padded data is never read
                lo = d & 0xFFFF
                hi = np.empty_like(d)
                hi[:-1] = d[1:]
                hi[-1] = 0
                pairs = (hi << 16) | lo
                npad = (-len(pairs)) % 128
                if npad:
                    pairs = np.concatenate([pairs,
                                            np.zeros(npad, np.int32)])
                tbase = len(self._rows)
                self._rows.extend(pairs.reshape(-1, 128))
                npass = len(pairs) // 128
                # oscillator positions are relative to data[0] = index
                # A2_WAVEPRE within the padded block
                self._index[(key, mm)] = (tbase, npass, A2_WAVEPRE)

    def finalize(self):
        with self.lock:
            if self._rows:
                arr = np.stack(self._rows)
            else:
                arr = np.zeros((1, 128), dtype=np.int32)
            self.np_pairs = arr.reshape(-1)
            self.data = arr
            self.version += 1
            return self.data

    def lookup(self, key, mip):
        with self.lock:
            return self._index[(key, mip)]


def pass_class(npass):
    for c in PASS_CLASSES:
        if npass <= c:
            return c
    raise ValueError("table too large for pass classes: %d" % npass)


# ---------------------------------------------------------------
# plain PyTorch version (int64 tensors carrying int32 wrap values)
# ---------------------------------------------------------------

def _w(x):
    """int64 tensor -> the int32 two's-complement wrap of each value,
    kept in int64 (the conversion keeps the low 32 bits)."""
    return x.to(torch.int32).to(torch.int64)


def _mul_shr24(x, y):
    """Low 32 bits of ((int64)x * y) >> 24 for int32-valued x, y (the
    JAX kernel computes the same bits from 16-bit limbs)."""
    return _w((x * y) >> 24)


def _hermite_poly(dm1, d0, d1, d2, x):
    # a2_Hermite (reference a2_dsp.h:64-74), int32 wrap products
    c = _w(d1 - dm1) >> 1
    a = _w(3 * _w(d0 - d1) + d2 - dm1) >> 1
    b = _w(dm1 - d0 + c - a)
    a = _w(a * x) >> 15
    a = _w(_w(a + b) * x) >> 15
    return _w(d0 + (_w(_w(a + c) * x) >> 15))


def osc_rows_torch(npass, tbase, params, atlas, quality=0, fused_pm=True,
                   mono=False):
    """Plain version of the oscillator kernel.  tbase int32 (NB,),
    params int32 (NPARAM, NB*RPB), atlas int32 (T, 128) -> int32
    (C*FRAG, NB*RPB) with C = 1 if mono else 2: rows on the last axis,
    channel c frame n at row c*FRAG + n.  Equal to the JAX package's
    ``_osc_call`` for every row whose lookups stay inside its block's
    table; a table index outside the block's ``npass`` atlas rows
    (only dead or padded rows carry one) is clamped into them."""
    dev = params.device
    NB = params.shape[1] // RPB
    T = atlas.shape[0]
    n = torch.arange(FRAG, dtype=torch.int64, device=dev)[:, None]
    P = params.to(torch.int64)
    pos0, f0, dpos, df = (P[i][None, :] for i in range(4))
    amp0, damp = P[P_AMP0][None, :], P[P_DAMP][None, :]

    # exact 48:24 phase via the (pos, frac24) split
    fr = _w(f0 + _w(n * df))
    pos = _w(pos0 + _w(n * dpos) + (fr >> 24))
    fr = fr & 0xFFFFFF
    ph16 = _w(pos << 8) | (fr >> 16)          # 16:8 table position
    dph16 = _w(dpos << 8) | (df >> 16)

    # each row's table span in the flat atlas: [lo, hi]
    tb = tbase.to(torch.int64).clamp(0, T - 1)
    span = torch.clamp(T - tb, max=npass)
    lo = (tb * RPB).repeat_interleave(RPB)[None, :]
    hi = lo + (span * RPB).repeat_interleave(RPB)[None, :] - 1
    flat = atlas.reshape(-1).to(torch.int64)

    def lookup_pair(j):
        return flat[torch.minimum(torch.maximum(lo + j, lo), hi)]

    def lo16(p):
        return _w(p << 16) >> 16

    def hi16(p):
        return p >> 16

    def lerp16(ph):
        # a2_Lerp16 (a2_dsp.h:58-61): the pair packs both endpoints
        i = ph >> 8
        x = ph & 0xFF
        pa = lookup_pair(i)
        return _w(lo16(pa) * (256 - x) + hi16(pa) * x) >> 8

    if quality == 0:
        # both 2x-oversampled Hermite taps from three pair lookups
        # (the record pass caps dph16 at A2_MAXPHINC, so the second
        # tap's base index advances by at most 1)
        i = ph16 >> 8
        x1 = (ph16 & 0xFF) << 7
        ph2 = _w(ph16 + (dph16 >> 1))
        x2 = (ph2 & 0xFF) << 7
        pa = lookup_pair(i - 1)
        pb = lookup_pair(i + 1)
        pc = lookup_pair(i + 3)
        dm1, d0, d1, d2, d3 = lo16(pa), hi16(pa), lo16(pb), hi16(pb), \
            lo16(pc)
        v1 = _hermite_poly(dm1, d0, d1, d2, x1)
        adv = (ph2 >> 8) != i
        v = _w(v1 + _hermite_poly(torch.where(adv, d0, dm1),
                                  torch.where(adv, d1, d0),
                                  torch.where(adv, d2, d1),
                                  torch.where(adv, d3, d2), x2))
    elif quality == 1:
        v = _w(lerp16(ph16) + lerp16(_w(ph16 + (dph16 >> 1))))
    else:
        v = _w(lerp16(ph16) << 1)

    # (v * amp) >> 17 by the same three limbs as the JAX kernel
    amp = _w(amp0 + _w(n * damp))
    a2 = amp >> 28
    a1 = (amp >> 14) & 0x3FFF
    a0 = amp & 0x3FFF
    x = _w(_w(_w(v * a2) << 11)
           + (_w(_w(v * a1) + (_w(v * a0) >> 14)) >> 3))

    off = P[P_OFF][None, :]
    end = P[P_END][None, :]
    valid = (n >= off) & (n < end)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    C = 1 if mono else 2
    out = torch.zeros((C * FRAG, NB * RPB), dtype=torch.int32, device=dev)
    if not fused_pm:
        out[:FRAG] = torch.where(valid, x, zero).to(torch.int32)
        return out
    mode = P[P_MODE][None, :]
    haspm = (mode & ROW_HASPM) != 0
    vol = _w(P[P_VOL0][None, :] + _w(n * P[P_DVOL][None, :]))
    mch0 = _mul_shr24(x, vol)
    if mono:
        out[:] = torch.where(valid, torch.where(haspm, mch0, x),
                             zero).to(torch.int32)
        return out
    pan = _w(P[P_PAN0][None, :] + _w(n * P[P_DPAN][None, :]))
    vp = _mul_shr24(pan, vol)
    v0 = _w(vol - vp)
    v1 = _w(vol + vp)
    lim = _w(vol << 1)
    clampf = (mode & ROW_CLAMP) != 0
    v0 = torch.where(clampf, torch.minimum(v0, lim), v0)
    v1 = torch.where(clampf, torch.minimum(v1, lim), v1)
    stereo = (mode & ROW_STEREO) != 0
    ch0 = torch.where(haspm, torch.where(stereo, _mul_shr24(x, v0), mch0),
                      x)
    ch1 = torch.where(haspm & stereo, _mul_shr24(x, v1), zero)
    out[:FRAG] = torch.where(valid, ch0, zero).to(torch.int32)
    out[FRAG:] = torch.where(valid, ch1, zero).to(torch.int32)
    return out


def add_rows(slots, slot_r, audio, mono):
    """Adds row audio int32 [P, C*FRAG] into slots int32 [nslot, 2,
    FRAG] (or [nslot, 1, FRAG] when mono) at the rows' slots (channel 0
    only when mono), int32 with wrap."""
    if mono:
        slots[:, 0].index_add_(0, slot_r, audio)
    else:
        slots.view(slots.shape[0], 2 * FRAG).index_add_(0, slot_r, audio)


def osc_slots_torch(npass, tbase, params, atlas, slots, slot_r, quality=0,
                    fused_pm=True, mono=False):
    """Plain version of the kernel's slots epilogue: ``osc_rows_torch``,
    then each row's samples added into ``slots`` at ``slot_r`` (int64
    [NB*RPB]) in place.  Returns slots."""
    res = osc_rows_torch(npass, tbase, params, atlas, quality, fused_pm,
                         mono)
    add_rows(slots, slot_r, res.t(), mono)
    return slots


def seeded_blocks(npass, nblocks, rng, dead=False):
    """Seeded kernel inputs for checks: a synthetic pair atlas (random
    int16 samples) and `nblocks` 128-row blocks, each reading `npass`
    atlas rows at a random base.  Live rows keep every table lookup
    inside their block's table (as recorded rows do); with dead=True
    one row in eight is dead (amp 0, garbage phase), as padded rows
    are.  Returns numpy int32 (tbase [NB], params [NPARAM, NB*RPB],
    atlas [T, 128])."""
    T = 2 * npass + 3
    d = rng.integers(-32768, 32768, T * RPB + 1).astype(np.int32)
    atlas = ((d[1:] << 16) | (d[:-1] & 0xFFFF)).astype(np.int32) \
        .reshape(T, RPB)
    tbase = rng.integers(0, T - npass + 1, nblocks).astype(np.int32)
    R = nblocks * RPB
    span = npass * RPB
    # at most 2 samples per frame (the A2_MAXPHINC cap), and 64 frames
    # plus the hermite window (i-1 .. i+3) inside the table
    dph = (rng.random(R) * min(2.0, (span - 8) / 64.0)
           * (1 << 24)).astype(np.int64)
    dph = np.minimum(dph, (512 << 16) - 1)
    room = span - 7 - (64 * dph >> 24)
    p = np.zeros((NPARAM, R), np.int64)
    p[P_POS0] = 1 + (rng.random(R) * (room - 1)).astype(np.int64)
    p[P_F0] = rng.integers(0, 1 << 24, R)
    p[P_DPOS] = dph >> 24
    p[P_DF] = dph & 0xFFFFFF
    p[P_AMP0] = rng.integers(-(1 << 27), 1 << 27, R)
    p[P_DAMP] = rng.integers(-(1 << 20), 1 << 20, R)
    p[P_VOL0] = rng.integers(0, 1 << 25, R)
    p[P_DVOL] = rng.integers(-(1 << 14), 1 << 14, R)
    p[P_PAN0] = rng.integers(-(1 << 24), 1 << 24, R)
    p[P_DPAN] = rng.integers(-(1 << 14), 1 << 14, R)
    p[P_OFF] = rng.integers(0, 64, R) * (rng.random(R) < 0.3)
    p[P_END] = np.maximum(p[P_OFF], np.where(
        rng.random(R) < 0.3, rng.integers(0, 65, R), 64))
    p[P_MODE] = rng.integers(0, 8, R)
    if dead:
        sel = rng.random(R) < 0.125
        p[P_AMP0, sel] = 0
        p[P_DAMP, sel] = 0
        p[P_POS0, sel] = rng.integers(-(1 << 30), 1 << 30, sel.sum())
    return tbase, p.astype(np.int32), atlas


def seeded_slot_rows(nrows, nslot, rng):
    """Seeded int64 slot indices [nrows] into nslot slots, the last the
    dead slot, drawn so that many rows share a slot, within one 128-row
    block too: runs of 1-16 neighbouring rows on one slot (as a voice's
    rows), one run in eight on the dead slot, the rest on a few of the
    live slots."""
    out = np.empty(nrows, np.int64)
    i = 0
    while i < nrows:
        k = int(rng.integers(1, 17))
        out[i:i + k] = nslot - 1 if rng.random() < 0.125 \
            else rng.integers(0, max(nslot - 1, 1))
        i += k
    return out


# ---------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------

def _bind(lib):
    lib.a2_osc_rows.restype = ctypes.c_int
    lib.a2_osc_rows.argtypes = (
        [ctypes.c_void_p] * 4                  # tbase params atlas out
        + [ctypes.c_int] * 6                   # NB T npass quality
        + [ctypes.c_void_p])                   #  fused mono; stream
    lib.a2_osc_slots.restype = ctypes.c_int
    lib.a2_osc_slots.argtypes = (
        [ctypes.c_void_p] * 5                  # tbase params atlas slot_r
        + [ctypes.c_int] * 8                   #  slots; nslot S NB T npass
        + [ctypes.c_void_p])                   #  quality fused mono; stream


def _load():
    return build.load("osc_kernel", _bind)


def osc_call(npass, tbase, params, atlas, quality=0, fused_pm=True,
             mono=False):
    """One pass-class oscillator evaluation: tbase int32 (NB,), params
    int32 (NPARAM, NB*RPB), atlas int32 (T, 128) -> int32
    (C*FRAG, NB*RPB).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (``osc_call.launches`` counts those
    launches) or raise."""
    if params.device.type == "cpu":
        return osc_rows_torch(npass, tbase, params, atlas, quality,
                              fused_pm, mono)
    if params.device.type != "cuda":
        raise ValueError("osc_call: unsupported device %s" % params.device)
    NB = params.shape[1] // RPB
    dev = params.device
    for t, name, shape in ((tbase, "tbase", (NB,)),
                           (params, "params", (NPARAM, NB * RPB)),
                           (atlas, "atlas", (atlas.shape[0], RPB))):
        build.check_tensor(t, "osc_call", name, torch.int32, shape, dev)
    if npass not in PASS_CLASSES or quality not in (0, 1, 2):
        raise ValueError("osc_call: npass %r / quality %r"
                         % (npass, quality))
    C = 1 if mono else 2
    out = torch.empty((C * FRAG, NB * RPB), dtype=torch.int32,
                      device=params.device)
    if NB == 0:
        return out
    lib = _load()
    with torch.cuda.device(params.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.a2_osc_rows(tbase.data_ptr(), params.data_ptr(),
                              atlas.data_ptr(), out.data_ptr(), NB,
                              atlas.shape[0], npass, quality,
                              int(bool(fused_pm)), int(bool(mono)),
                              stream)
    build.launch_check(err, "osc")
    build.count_launch(osc_call)
    return out


osc_call.launches = 0


def osc_slots_call(npass, tbase, params, atlas, slots, slot_r, quality=0,
                   fused_pm=True, mono=False):
    """One pass-class oscillator evaluation added into slots: tbase int32
    (NB,), params int32 (NPARAM, NB*RPB), atlas int32 (T, 128), slots
    int32 (nslot, 2, FRAG) (or (nslot, 1, FRAG) when mono), slot_r
    int64 (NB*RPB,): row r's samples are added into slots[slot_r[r]] in
    place (channel 0 only when mono), int32 with wrap.  CPU tensors take
    the plain version ``osc_slots_torch``; CUDA tensors launch the
    kernel's slots epilogue (``osc_slots_call.launches`` counts those
    launches) or raise.  The kernel adds nothing for a slot index outside
    [0, nslot), where the plain version raises.  Returns slots."""
    if params.device.type == "cpu":
        return osc_slots_torch(npass, tbase, params, atlas, slots, slot_r,
                               quality, fused_pm, mono)
    if params.device.type != "cuda":
        raise ValueError("osc_slots_call: unsupported device %s"
                         % params.device)
    NB = params.shape[1] // RPB
    dev = params.device
    S = slots.shape[1] if slots.dim() == 3 else 0
    if S not in ((1, 2) if mono else (2,)):
        raise ValueError("osc_slots_call: slots must be (nslot, %s, %d), "
                         "got %s" % ("1 or 2" if mono else "2", FRAG,
                                     tuple(slots.shape)))
    for t, name, dtype, shape in (
            (tbase, "tbase", torch.int32, (NB,)),
            (params, "params", torch.int32, (NPARAM, NB * RPB)),
            (atlas, "atlas", torch.int32, (atlas.shape[0], RPB)),
            (slots, "slots", torch.int32, (slots.shape[0], S, FRAG)),
            (slot_r, "slot_r", torch.int64, (NB * RPB,))):
        build.check_tensor(t, "osc_slots_call", name, dtype, shape, dev)
    if npass not in PASS_CLASSES or quality not in (0, 1, 2) \
            or not slots.shape[0]:
        raise ValueError("osc_slots_call: npass %r / quality %r / %d slots"
                         % (npass, quality, slots.shape[0]))
    if NB == 0:
        return slots
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.a2_osc_slots(tbase.data_ptr(), params.data_ptr(),
                               atlas.data_ptr(), slot_r.data_ptr(),
                               slots.data_ptr(), slots.shape[0], S, NB,
                               atlas.shape[0], npass, quality,
                               int(bool(fused_pm)), int(bool(mono)), stream)
    build.launch_check(err, "osc slots")
    build.count_launch(osc_slots_call)
    return slots


osc_slots_call.launches = 0


def ops_per_frame(quality, fused_pm, mono):
    """int32 ALU operations per row and frame of the kernel, counted by
    hand from csrc/osc_kernel.cu (adds, multiplies, shifts, masks,
    compares, selects and the clamp of each table index; a 64-bit
    product counts as 2).  Used for the kernel's bound."""
    ops = 12                                     # phase, ph16
    ops += (3 * 4 + 10 + 2 * 17 + 9) if quality == 0 \
        else (2 * (4 + 9) + 3) if quality == 1 else (4 + 9 + 1)
    ops += 2 + 4 + 11                            # amp ramp, limbs, product
    ops += 3 + 1                                 # [OFF, END) mask, store
    if fused_pm:
        ops += 3 + 4 + 2                         # vol ramp, mch0, select
        if not mono:
            ops += 3 + 4 + 6 + 2 * 4 + 4 + 1     # pan, v0/v1, clamp, L/R
    return ops


def slots_work(blocks, atlas_rows, quality, fused_pm, mono):
    """(bytes, int32 operations) that the slots form needs for the pass
    classes' rows `blocks`, a list of (npass, tbase [NB], params [NPARAM,
    NB*RPB], slot_r [NB*RPB]) in numpy (atlas_rows: the atlas's row
    count): every row's NPREAD params and slot index and every block's
    table base read once, the distinct atlas rows that the blocks'
    tables cover read once, each slot that a live row touches read and
    written once (C*FRAG words; C = 1 when mono or unfused), and for the
    valid frames of the live rows (amp ramp not 0, window not empty)
    ``ops_per_frame`` plus one add per output sample."""
    C = 1 if mono or not fused_pm else 2
    rows, touched = set(), set()
    nbytes = nops = 0
    for npass, tbase, params, slot_r in blocks:
        for t in np.clip(np.asarray(tbase, np.int64), 0,
                         atlas_rows - 1).tolist():
            rows.update(range(t, min(t + npass, atlas_rows)))
        p = np.asarray(params, np.int64)
        win = np.clip(p[P_END], 0, FRAG) - np.clip(p[P_OFF], 0, FRAG)
        live = ((p[P_AMP0] != 0) | (p[P_DAMP] != 0)) & (win > 0)
        touched.update(np.unique(np.asarray(slot_r)[live]).tolist())
        nbytes += p.shape[1] * (NPREAD * 4 + 8) + len(tbase) * 4
        nops += int(win[live].sum()) * (ops_per_frame(quality, fused_pm,
                                                      mono) + C)
    nbytes += len(rows) * RPB * 4 + len(touched) * C * FRAG * 4 * 2
    return nbytes, nops
