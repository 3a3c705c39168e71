"""The oscillator's general entry point, counterpart of the JAX package's
``audiality2_tpu/tpu/osc_kernel.py``: the device pair atlas (the copied
``engine/core.py`` reaches it through ``pair_atlas_entry``), a batch of
arbitrary wavetable rows (``OscBatch``), its evaluation on the card
(``evaluate_osc_batch``) and the per-row numpy twin (``osc_rows_numpy``).

``evaluate_osc_batch`` runs each pass class through ``osc_slots_call``,
which adds each row's samples at its index in the batch: the
hand-written kernel (``cuda/csrc/osc_kernel.cu``) for an atlas on a CUDA
device, its plain PyTorch version (``osc_slots_torch``) for one on the
CPU.  The kernel clamps a table lookup into its block's table, the JAX
interpreter into the whole atlas, and the twin does not clamp; they
agree on every row whose 64 frames and interpolation window stay inside
its level's ``A2_WAVEPRE + size + A2_WAVEPOST`` entries, which holds for
``0 <= ph0 < size << 24`` and ``dph < 2 << 24`` (``A2_WAVEPOST`` covers
64 frames at ``A2_MAXPHINC``).
"""

import numpy as np
import torch

from ..cuda.osc_kernel import (FRAG, NPARAM, P_AMP0, P_DAMP, P_DF, P_DPAN,
                               P_DPOS, P_DVOL, P_END, P_F0, P_MODE, P_OFF,
                               P_PAN0, P_POS0, P_VOL0, PASS_CLASSES, RPB,
                               PairAtlas, osc_slots_call, pass_class)

__all__ = ["PairAtlas", "pass_class", "PASS_CLASSES", "FRAG", "RPB",
           "NPARAM", "P_POS0", "P_F0", "P_DPOS", "P_DF", "P_AMP0", "P_DAMP",
           "P_VOL0", "P_DVOL", "P_PAN0", "P_DPAN", "P_OFF", "P_END",
           "P_MODE", "OscBatch", "evaluate_osc_batch", "osc_rows_numpy"]


def _i32(x):
    """The int32 two's-complement wrap of a Python int."""
    return ((int(x) + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


class OscBatch:
    """Accumulates oscillator rows bucketed by (pass class, table base)
    and evaluates them with one oscillator launch per pass class.
    Returns audio in the original row order."""

    def __init__(self, atlas):
        self.atlas = atlas
        # (tbase, npass, pos0, f0, dpos, df, amp0, damp) per row
        self.rows = []
        self.n = 0

    def add(self, tbase, npass, pos_off, ph0, dph, amp0, damp):
        """ph0/dph are 48:24 ints relative to d[0]; amp 8:24 int32."""
        self.rows.append((tbase, npass, (ph0 >> 24) + pos_off,
                          ph0 & 0xFFFFFF, dph >> 24, dph & 0xFFFFFF,
                          _i32(amp0), _i32(damp)))
        self.n += 1
        return self.n - 1

    def build(self):
        """The rows grouped into pass-class calls: a list of
        (npass_class, tbase int32 [NB], params int32 [NPARAM, NB*RPB],
        order int64 [NB, RPB]), one per pass class in PASS_CLASSES
        order.  Within a class, buckets of equal table base in
        ascending order, each padded to whole 128-row blocks (order -1,
        zero params); the block count padded to a power of two, at
        least 8, with dead blocks (table base 0).  Rows keep their
        order within a bucket."""
        rows = np.array(self.rows, np.int64).reshape(-1, 8)
        tbase = rows[:, 0]
        ci = np.searchsorted(PASS_CLASSES, rows[:, 1])
        if (ci == len(PASS_CLASSES)).any():
            raise ValueError("table too large for pass classes: %d"
                             % rows[:, 1].max())
        srt = np.lexsort((tbase, ci))            # stable
        tb_s, ci_s = tbase[srt], ci[srt]
        first = np.ones(len(srt), bool)
        first[1:] = (tb_s[1:] != tb_s[:-1]) | (ci_s[1:] != ci_s[:-1])
        bucket = np.cumsum(first) - 1            # bucket of each sorted row
        bstart = np.flatnonzero(first)
        rank = np.arange(len(srt)) - bstart[bucket]
        nblk = -(-np.diff(np.append(bstart, len(srt))) // RPB)
        bcls = ci_s[bstart]
        out = []
        for c, cls in enumerate(PASS_CLASSES):
            mine = np.where(bcls == c, nblk, 0)
            boff = np.cumsum(mine) - mine        # first block of a bucket
            NB = 8
            while NB < mine.sum():
                NB <<= 1
            sel = ci_s == c
            col = (boff[bucket[sel]] + rank[sel] // RPB) * RPB \
                + rank[sel] % RPB
            ri = srt[sel]
            tbase_arr = np.zeros(NB, np.int32)
            tbase_arr[col // RPB] = tb_s[sel]
            params = np.zeros((NPARAM, NB * RPB), np.int32)
            params[:6, col] = rows[ri, 2:].T
            # no panmix: mode 0 passes the amped sample through on
            # channel 0, full validity window
            params[P_END, col] = FRAG
            order = np.full(NB * RPB, -1, np.int64)
            order[col] = ri
            out.append((cls, tbase_arr, params, order.reshape(NB, RPB)))
        return out


def evaluate_osc_batch(batch, device_atlas=None, quality=0):
    """Evaluates an OscBatch.  Returns int32[n, FRAG] oscillator audio
    in row order (numpy).  device_atlas: an int32 (T, 128) tensor of
    batch.atlas.data, whose device decides where the rows run (the CPU:
    the plain version; CUDA: the kernel); None or a numpy array is
    uploaded to the card, and without one this raises."""
    atlas = device_atlas
    if not isinstance(atlas, torch.Tensor):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "evaluate_osc_batch: no CUDA device; pass the atlas as a "
                "CPU tensor to evaluate with the plain version")
        atlas = torch.as_tensor(np.asarray(
            batch.atlas.data if atlas is None else atlas, np.int32),
            device="cuda")
    if not batch.n:
        return np.zeros((0, FRAG), np.int32)
    dev = atlas.device
    # each row adds into its own row of zeros (the order indices are
    # unique); row batch.n collects the padding rows, and is dropped
    outs = torch.zeros((batch.n + 1, 1, FRAG), dtype=torch.int32,
                       device=dev)
    for cls, tbase_arr, params, order in batch.build():
        idx = order.reshape(-1)
        # unfused channel 0 is the raw amped row (mode 0, END = FRAG)
        osc_slots_call(cls, torch.from_numpy(tbase_arr).to(dev),
                       torch.from_numpy(params).to(dev), atlas, outs,
                       torch.from_numpy(np.where(idx >= 0, idx, batch.n))
                       .to(dev), quality=quality, fused_pm=False, mono=True)
    return outs[:batch.n, 0].cpu().numpy()


# ---------------------------------------------------------------
# numpy twin (for tests and checks); mirrors the kernel bit for bit
# ---------------------------------------------------------------

def osc_rows_numpy(atlas_pairs_flat, tbase, npass, pos0, f0, dpos, df,
                   amp0, damp, quality=0):
    """atlas_pairs_flat: int32[T*128]; all params int32 arrays[R]."""
    n = np.arange(FRAG, dtype=np.int64)[None, :]
    fr = f0[:, None].astype(np.int64) + n * df[:, None]
    pos = pos0[:, None] + n * dpos[:, None] + (fr >> 24)
    fr = fr & 0xFFFFFF
    ph16 = (pos << 8) | (fr >> 16)
    dph16 = (dpos << 8) | (df >> 16)
    base = (tbase[:, None].astype(np.int64)) * 128

    def lookup(j):
        return atlas_pairs_flat[base + j].astype(np.int64)

    def herm(ph):
        i = ph >> 8
        x = (ph & 0xFF) << 7
        pa = lookup(i - 1)
        pb = lookup(i + 1)
        dm1 = (pa.astype(np.int32) << 16) >> 16
        d0 = pa.astype(np.int32) >> 16
        d1 = (pb.astype(np.int32) << 16) >> 16
        d2 = pb.astype(np.int32) >> 16
        i32 = np.int32
        c = i32(d1 - dm1) >> 1
        a = (i32(3) * i32(d0 - d1) + d2 - dm1) >> 1
        b = i32(dm1 - d0) + c - a
        with np.errstate(over="ignore"):
            a = i32(a * i32(x)) >> 15
            a = i32(i32(a + b) * i32(x)) >> 15
            return i32(d0 + (i32(i32(a + c) * i32(x)) >> 15))

    def lrp(ph):
        i = ph >> 8
        x = (ph & 0xFF).astype(np.int64)
        pa = lookup(i)
        d0 = (pa.astype(np.int32) << 16) >> 16
        d1 = pa.astype(np.int32) >> 16
        return ((d0 * (256 - x) + d1 * x) >> 8).astype(np.int32)

    if quality == 0:
        v = herm(ph16).astype(np.int64) \
            + herm(ph16 + (dph16[:, None] >> 1)).astype(np.int64)
    elif quality == 1:
        v = lrp(ph16).astype(np.int64) \
            + lrp(ph16 + (dph16[:, None] >> 1)).astype(np.int64)
    else:
        v = lrp(ph16).astype(np.int64) << 1
    amp = amp0[:, None].astype(np.int64) + n * damp[:, None]
    return ((v * amp) >> 17).astype(np.int32)
