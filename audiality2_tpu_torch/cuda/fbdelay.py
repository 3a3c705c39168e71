"""fbdelay: the CUDA feedback-loop kernels, their wrappers and plain
PyTorch versions, and the stage functions around them.

Port of the JAX package's ``_apply_fbdelay`` (legacy form) and
``_apply_fbdelay_dense`` (dense form) in ``audiality2_tpu/tpu/
superblock.py``.  Only the cross-feedback tap is serial, and only
across chunk steps (the chunk rule: C*64 <= fb, so no tap reads a
sample written in its own step); ``fbd_legacy_call`` /
``fbd_dense_call`` run that loop, as the kernels in
``csrc/fbdelay_kernel.cu`` for CUDA tensors (dense: one thread per
residue chain t mod fb; legacy: the chunk steps over one cooperative
grid) and as the plain versions ``fbd_legacy_torch`` /
``fbd_dense_torch`` (the chunk loop, vectorised within a step) for CPU
tensors.  The reader taps, the dry path and the emit are elementwise
torch ops in ``apply_fbdelay`` / ``apply_fbdelay_dense``.

Unlike the pure JAX functions these update their arguments in place:
``slots`` gets the stage's output, and the legacy ring is advanced in
place.
"""

import ctypes

import numpy as np
import torch

from ..constants import A2_MAXFRAG
from . import build
from .osc_kernel import _w
from .superblock import FBD_TAIL, _FBD_BUFSIZE as FBD_BUFSIZE

FRAG = A2_MAXFRAG
_M = FBD_BUFSIZE - 1
# slice-table columns (program_from_native's fbdelay arr)
(C_SRC0, C_SRC1, C_DST0, C_DST1, C_OFF, C_FRAMES, C_FB, C_LD, C_RD,
 C_DRY, C_FBG, C_LG, C_RG) = range(13)


# ---------------------------------------------------------------
# plain PyTorch versions of the feedback loop
# ---------------------------------------------------------------

def fbd_legacy_torch(x, arr, starts, ring, C):
    """Legacy feedback loop.  x int32 [2, NS, 64] slice inputs (sample
    n of slice j is the slice's n-th sample); arr int32 [NS, 13];
    starts int32 [NS] ring position of each slice's sample 0; ring
    int32 [2, 2^20], advanced in place (samples n >= frames are not
    written).  Returns o_fb int32 [2, NS, 64]."""
    NS = arr.shape[0]
    a = arr.to(torch.int64)
    n = torch.arange(FRAG, dtype=torch.int64, device=x.device)[None, :]
    wid = (starts.to(torch.int64)[:, None] + n) & _M
    fidx = (wid - a[:, C_FB:C_FB + 1]) & _M
    fbg = a[:, C_FBG:C_FBG + 1]
    msk = n < a[:, C_FRAMES:C_FRAMES + 1]
    ofb = torch.empty((2, NS, FRAG), dtype=torch.int32, device=x.device)
    for s in range(NS // C):
        sl = slice(s * C, (s + 1) * C)
        # cross-feedback: channel 0 taps the right ring, 1 the left
        taps = torch.stack([ring[1][fidx[sl]], ring[0][fidx[sl]]])
        o = (taps.to(torch.int64) * fbg[sl]) >> 16
        w = _w(x[:, sl].to(torch.int64) + o).to(torch.int32)
        ofb[:, sl] = _w(o).to(torch.int32)
        m = msk[sl]
        for c in range(2):
            ring[c][wid[sl][m]] = w[c][m]
    return ofb


def fbd_dense_torch(x, g, buf, fb, C):
    """Dense feedback loop.  x int32 [2, NPad], g int32 [NPad] feedback
    gain per sample, buf int32 [2, 2^17 + NPad] whose first 2^17
    samples hold the tail; fills the rest of buf in place.  Returns
    o_fb int32 [2, NPad]."""
    CH = C * FRAG
    D = FBD_TAIL
    npad = x.shape[1]
    ofb = torch.empty((2, npad), dtype=torch.int32, device=x.device)
    for t0 in range(0, npad, CH):
        taps = buf[:, D + t0 - fb:D + t0 - fb + CH].flip(0)
        o = (taps.to(torch.int64) * g[t0:t0 + CH].to(torch.int64)) >> 16
        ofb[:, t0:t0 + CH] = _w(o).to(torch.int32)
        buf[:, D + t0:D + t0 + CH] = \
            _w(x[:, t0:t0 + CH].to(torch.int64) + o).to(torch.int32)
    return ofb


# ---------------------------------------------------------------
# the CUDA kernels: bind, launch
# ---------------------------------------------------------------

def _bind(lib):
    lib.a2_fbd_legacy.restype = ctypes.c_int
    lib.a2_fbd_legacy.argtypes = (
        [ctypes.c_void_p] * 5                  # x arr starts ring ofb
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])   # NS C; stream
    lib.a2_fbd_dense.restype = ctypes.c_int
    lib.a2_fbd_dense.argtypes = (
        [ctypes.c_void_p] * 4                  # x g buf ofb
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])   # npad fb; stream


def _load():
    return build.load("fbdelay_kernel", _bind)


def fbd_legacy_call(x, arr, starts, ring, C):
    """The legacy feedback loop (see fbd_legacy_torch): the plain
    version for CPU tensors, the kernel for CUDA tensors
    (``fbd_legacy_call.launches`` counts its launches)."""
    if x.device.type == "cpu":
        return fbd_legacy_torch(x, arr, starts, ring, C)
    NS = arr.shape[0]
    dev = x.device
    what = "fbd_legacy_call"
    if dev.type != "cuda" or C < 1 or NS % C:
        raise ValueError("%s: device %s, NS %d, chunk %d"
                         % (what, dev, NS, C))
    build.check_tensor(x, what, "x", torch.int32, (2, NS, FRAG), dev)
    build.check_tensor(arr, what, "arr", torch.int32, (NS, 13), dev)
    build.check_tensor(starts, what, "starts", torch.int32, (NS,), dev)
    build.check_tensor(ring, what, "ring", torch.int32, (2, FBD_BUFSIZE),
                       dev)
    ofb = torch.empty((2, NS, FRAG), dtype=torch.int32, device=dev)
    if NS == 0:
        return ofb
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.a2_fbd_legacy(x.data_ptr(), arr.data_ptr(),
                                starts.data_ptr(), ring.data_ptr(),
                                ofb.data_ptr(), NS, C, stream)
    build.launch_check(err, "fbdelay legacy")
    build.count_launch(fbd_legacy_call)
    return ofb


fbd_legacy_call.launches = 0


def fbd_dense_call(x, g, buf, fb, C):
    """The dense feedback loop (see fbd_dense_torch): the plain version
    for CPU tensors, the kernel for CUDA tensors
    (``fbd_dense_call.launches`` counts its launches)."""
    if x.device.type == "cpu":
        return fbd_dense_torch(x, g, buf, fb, C)
    npad = x.shape[1]
    CH = C * FRAG
    dev = x.device
    what = "fbd_dense_call"
    # with CH <= fb the chunked loop is the sequential recurrence, which
    # the kernel walks as fb residue chains; taps reach back FBD_TAIL
    if dev.type != "cuda" or npad % CH or not CH <= fb <= FBD_TAIL:
        raise ValueError("%s: device %s, npad %d, chunk %d, fb %d"
                         % (what, dev, npad, C, fb))
    build.check_tensor(x, what, "x", torch.int32, (2, npad), dev)
    build.check_tensor(g, what, "g", torch.int32, (npad,), dev)
    build.check_tensor(buf, what, "buf", torch.int32,
                       (2, FBD_TAIL + npad), dev)
    ofb = torch.empty((2, npad), dtype=torch.int32, device=dev)
    if npad == 0:
        return ofb
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.a2_fbd_dense(x.data_ptr(), g.data_ptr(), buf.data_ptr(),
                               ofb.data_ptr(), npad, fb, stream)
    build.launch_check(err, "fbdelay dense")
    build.count_launch(fbd_dense_call)
    return ofb


fbd_dense_call.launches = 0


# ---------------------------------------------------------------
# the stage functions
# ---------------------------------------------------------------

def _emit(slots, ch, idx, out, old, mask, add):
    """Adds the stage's output into slots[idx, ch] (REPLACE as
    add-of-difference against `old`, as the JAX emit)."""
    d = out if add else _w(out - old)
    d = torch.where(mask, d, torch.zeros_like(d))
    slots[:, ch].index_add_(0, idx, d.to(torch.int32))


def fbd_legacy_inputs(slots, sig, arr, bufpos):
    """The legacy loop's inputs from the slots: (x, starts) with x int32
    [2, NS, 64] (slice inputs shifted so sample n is bus frame off+n)
    and starts int64 [NS] (ring position of each slice's sample 0)."""
    stereoin = sig[0]
    a = arr.to(torch.int64)
    n = torch.arange(FRAG, dtype=torch.int64, device=slots.device)[None, :]
    frames = a[:, C_FRAMES]
    starts = bufpos + torch.cumsum(frames, 0) - frames
    ridx = (n + a[:, C_OFF:C_OFF + 1]).clamp(0, FRAG - 1)
    x = torch.stack([slots[a[:, C_SRC0], 0].gather(1, ridx),
                     slots[a[:, C_SRC1], 1 if stereoin else 0]
                     .gather(1, ridx)])
    return x.contiguous(), starts


def apply_fbdelay(slots, sig, arr, ring, bufpos):
    """Legacy fbdelay (JAX ``_apply_fbdelay``).  sig: (stereoin,
    stereoout, add, chunk); arr int64 or int32 [NS, 13] (NS a multiple
    of chunk); ring int32 [2, 2^20], advanced in place; bufpos the ring
    position of the first slice.  Adds into slots in place; returns the
    ring."""
    _, stereoout, add, C = sig
    a = arr.to(torch.int64)
    n = torch.arange(FRAG, dtype=torch.int64, device=slots.device)[None, :]
    old0 = slots[a[:, C_DST0], 0].to(torch.int64)
    old1 = slots[a[:, C_DST1], 1].to(torch.int64)
    x, starts = fbd_legacy_inputs(slots, sig, arr, bufpos)
    ofb = fbd_legacy_call(x, arr.to(torch.int32).contiguous(),
                          (starts & _M).to(torch.int32), ring, C)
    # reader taps against the final ring (a reader tap at p reads
    # p - delay, already final), then the dry path
    widx = (starts[:, None] + n) & _M
    src = x.to(torch.int64)
    dry = a[:, C_DRY:C_DRY + 1]
    out0 = ofb[0].to(torch.int64) \
        + ((ring[0][(widx - a[:, C_LD:C_LD + 1]) & _M].to(torch.int64)
            * a[:, C_LG:C_LG + 1]) >> 16) + ((src[0] * dry) >> 16)
    out1 = ofb[1].to(torch.int64) \
        + ((ring[1][(widx - a[:, C_RD:C_RD + 1]) & _M].to(torch.int64)
            * a[:, C_RG:C_RG + 1]) >> 16) + ((src[1] * dry) >> 16)
    oj = a[:, C_OFF:C_OFF + 1]
    back = (n - oj).clamp(0, FRAG - 1)
    omask = (n >= oj) & (n < oj + a[:, C_FRAMES:C_FRAMES + 1])
    out0 = _w(out0).gather(1, back)
    out1 = _w(out1).gather(1, back)
    if not stereoout:
        # mono output mixes both delay channels (fbdelay.c mono variant)
        out0 = _w(out0 + out1) >> 1
    _emit(slots, 0, a[:, C_DST0], out0, old0, omask, add)
    if stereoout:
        _emit(slots, 1, a[:, C_DST1], out1, old1, omask, add)
    return ring


def fbd_dense_inputs(slots, sig, arr, F):
    """The dense loop's inputs: (x int32 [2, NPad], g int32 [NPad] the
    feedback gain per sample, per-sample gains int64 [N, 4] (dry, fb,
    left, right)), x and g padded with zeros to whole chunks."""
    stereoin, C = sig[0], sig[3]
    N = F * FRAG
    CH = C * FRAG
    npad = -(-N // CH) * CH
    dev = slots.device
    a = arr.to(torch.int64)
    fr = torch.arange(F, dtype=torch.int64, device=dev)
    x = torch.zeros((2, npad), dtype=torch.int32, device=dev)
    x[0, :N] = slots[a[0, C_SRC0] + fr, 0].reshape(N)
    x[1, :N] = slots[a[0, C_SRC1] + fr, 1 if stereoin else 0].reshape(N)
    # slice j covers samples [sum(frames[:j]), +frames[j]); padding rows
    # (frames 0) start at N
    frames = a[:, C_FRAMES]
    starts = torch.cumsum(frames, 0) - frames
    mark = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    mark.index_add_(0, starts.clamp(0, N), torch.ones_like(starts))
    sid = torch.cumsum(mark[:N], 0) - 1
    gains = a[sid.clamp(min=0), C_DRY:C_RG + 1]
    g = torch.zeros(npad, dtype=torch.int32, device=dev)
    g[:N] = gains[:, 1].to(torch.int32)
    return x, g, gains


def apply_fbdelay_dense(slots, sig, arr, tail, F):
    """Dense fbdelay (JAX ``_apply_fbdelay_dense``): the superblock is
    one contiguous sample stream of one instance with constant delays
    and slot spans.  sig: (stereoin, stereoout, add, chunk, fb, ld, rd);
    arr [NS, 13] time-ordered slice rows; tail int32 [2, 2^17]
    (time-ordered, newest last).  Adds into slots in place; returns the
    new tail."""
    _, stereoout, add, C, fb, ld, rd = sig
    N = F * FRAG
    D = FBD_TAIL
    dev = slots.device
    a = arr.to(torch.int64)
    x, g, gains = fbd_dense_inputs(slots, sig, arr, F)
    npad = x.shape[1]
    buf = torch.empty((2, D + npad), dtype=torch.int32, device=dev)
    buf[:, :D] = tail
    ofb = fbd_dense_call(x, g, buf, fb, C)[:, :N].to(torch.int64)
    src = x[:, :N].to(torch.int64)
    dry = gains[:, 0]
    out0 = _w(ofb[0]
              + ((buf[0, D - ld:D - ld + N].to(torch.int64) * gains[:, 2])
                 >> 16) + ((src[0] * dry) >> 16))
    out1 = _w(ofb[1]
              + ((buf[1, D - rd:D - rd + N].to(torch.int64) * gains[:, 3])
                 >> 16) + ((src[1] * dry) >> 16))
    if not stereoout:
        out0 = _w(out0 + out1) >> 1
    fr = torch.arange(F, dtype=torch.int64, device=dev)
    every = torch.ones((F, FRAG), dtype=torch.bool, device=dev)
    d0 = a[0, C_DST0] + fr
    _emit(slots, 0, d0, out0.reshape(F, FRAG),
          slots[d0, 0].to(torch.int64), every, add)
    if stereoout:
        d1 = a[0, C_DST1] + fr
        _emit(slots, 1, d1, out1.reshape(F, FRAG),
              slots[d1, 1].to(torch.int64), every, add)
    return buf[:, N:N + D].clone()


# ---------------------------------------------------------------
# seeded inputs for checks
# ---------------------------------------------------------------

def chunk_for(fb):
    """The builder's chunk rule (program_from_native): the largest power
    of two C <= 1024 with C*64 <= fb, or 1."""
    C = 1
    while C * 2 * FRAG <= fb and C < 1024:
        C *= 2
    return C


def _seeded_slots(rng, nslot):
    return rng.integers(-(1 << 27), 1 << 27, (nslot, 2, FRAG)) \
        .astype(np.int32)


def _seeded_gains(rng, n):
    # 16.16 gains around 0..1.25, some negative
    return rng.integers(-(1 << 14), 5 << 14, (n, 4))


def seeded_legacy(rng, C, nslices=24, nslot=40, fb=None):
    """Seeded legacy-form inputs: (slots int32 [nslot, 2, 64], arr int32
    [NS, 13] with NS a multiple of C, ring int32 [2, 2^20], bufpos).
    Slices run in time order from bufpos (near the ring's end, so the
    positions wrap); some are partial (off > 0 or frames < 64), the
    last rows are padding (frames 0, dead slot); every delay is at
    least C*64, as the chunk rule guarantees."""
    NS = -(-nslices // C) * C + C
    dead = nslot - 1
    arr = np.zeros((NS, 13), np.int64)
    arr[:, :4] = dead
    n = nslices
    arr[:n, :4] = rng.integers(0, nslot - 1, (n, 4))
    off = np.where(rng.random(n) < 0.3, rng.integers(1, 48, n), 0)
    arr[:n, C_OFF] = off
    arr[:n, C_FRAMES] = np.where(rng.random(n) < 0.3,
                                 rng.integers(1, 64 - off + 1),
                                 64 - off)
    lo = C * FRAG
    fb = fb or int(rng.integers(lo, 3 * lo + 200))
    arr[:n, C_FB] = fb + rng.integers(0, 100, n)
    arr[:n, C_LD] = rng.integers(1, 3000, n)
    arr[:n, C_RD] = rng.integers(1, 3000, n)
    arr[:n, C_DRY:C_RG + 1] = _seeded_gains(rng, n)
    ring = rng.integers(-(1 << 27), 1 << 27, (2, FBD_BUFSIZE)) \
        .astype(np.int32)
    bufpos = FBD_BUFSIZE - int(rng.integers(100, 2000))
    return _seeded_slots(rng, nslot), arr.astype(np.int32), ring, bufpos


def seeded_dense(rng, F=12, fb=None, nslot=None):
    """Seeded dense-form inputs: (slots, arr int32 [NS, 13], tail int32
    [2, 2^17], (fb, ld, rd)).  One instance's slices cover the F
    fragments contiguously (some fragments split in two, each slice
    with its own gains), then padding rows; constant slot spans and
    delays."""
    nslot = nslot or 4 * F + 1
    dead = nslot - 1
    spans = rng.integers(0, 3, 4) * F
    rows = []
    for f in range(F):
        cuts = [0, int(rng.integers(1, 64)), 64] if rng.random() < 0.4 \
            else [0, 64]
        for o, e in zip(cuts[:-1], cuts[1:]):
            rows.append((f, o, e - o))
    n = len(rows)
    NS = n + 3
    arr = np.zeros((NS, 13), np.int64)
    arr[:, :4] = dead
    fr = np.asarray([r[0] for r in rows])
    arr[:n, :4] = spans[None, :] + fr[:, None]
    arr[:n, C_OFF] = [r[1] for r in rows]
    arr[:n, C_FRAMES] = [r[2] for r in rows]
    fb = fb or int(rng.integers(FRAG, 2000))
    ld = int(rng.integers(1, FBD_TAIL))
    rd = int(rng.integers(1, 3000))
    arr[:n, C_FB], arr[:n, C_LD], arr[:n, C_RD] = fb, ld, rd
    arr[:n, C_DRY:C_RG + 1] = _seeded_gains(rng, n)
    tail = rng.integers(-(1 << 27), 1 << 27, (2, FBD_TAIL)) \
        .astype(np.int32)
    return _seeded_slots(rng, nslot), arr.astype(np.int32), tail, \
        (fb, ld, rd)


def seeded_dense_loop(rng, F, fb, dev):
    """Seeded inputs of the dense loop over F fragments at feedback
    delay fb, on `dev`, as apply_fbdelay_dense derives them from
    seeded_dense's table: (x int32 [2, NPad], g int32 [NPad], tail int32
    [2, 2^17], chunk)."""
    slots, arr, tail, par = seeded_dense(rng, F, fb=fb)
    C = chunk_for(fb)
    x, g, _ = fbd_dense_inputs(torch.as_tensor(slots, device=dev),
                               (True, True, True, C) + par,
                               torch.as_tensor(arr, device=dev), F)
    return x, g, torch.as_tensor(tail, device=dev), C


def seeded_legacy_loop(rng, C, nslices, dev):
    """Seeded inputs of the legacy loop over `nslices` slices in chunks
    of C, on `dev`, as apply_fbdelay derives them from seeded_legacy's
    table: (x int32 [2, NS, 64], arr int32 [NS, 13], starts int32 [NS],
    ring int32 [2, 2^20])."""
    slots, arr, ring, bufpos = seeded_legacy(rng, C, nslices=nslices)
    a = torch.as_tensor(arr, device=dev)
    x, starts = fbd_legacy_inputs(torch.as_tensor(slots, device=dev),
                                  (True, True, True, C), a, bufpos)
    return x, a, (starts & _M).to(torch.int32), \
        torch.as_tensor(ring, device=dev)


# ---------------------------------------------------------------
# the work a feedback loop must do, for its bound
# ---------------------------------------------------------------

# int32 operations per sample and channel that the function needs,
# whatever computes it: the 64-bit product of tap and gain (2 words),
# its 64-bit arithmetic shift (2) and the add into the ring (1); the
# legacy form also computes its tap's ring position (start + n - fb,
# masked: 3), where the dense form's is fixed
OPS_DENSE = 5
OPS_LEGACY = OPS_DENSE + 3


def legacy_work(arr):
    """(bytes, int32 ops) of one legacy loop over the numpy table arr
    [NS, 13]: x, the table, the taps and the o_fb outputs for every
    slice sample, the ring writes for the live ones."""
    NS = arr.shape[0]
    samples = NS * FRAG
    live = int(np.clip(arr[:, C_FRAMES], 0, FRAG).sum())
    nbytes = 4 * (NS * 14 + 2 * (3 * samples + live))
    return nbytes, 2 * samples * OPS_LEGACY


def dense_work(npad, fb):
    """(bytes, int32 ops) of one dense loop over npad samples: x, the
    gains, the taps that reach back into the tail, the buffer and o_fb
    outputs."""
    nbytes = 4 * (2 * npad + npad + 2 * min(fb, npad) + 4 * npad)
    return nbytes, 2 * npad * OPS_DENSE
