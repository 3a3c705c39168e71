"""The packed dispatch format of the superblock upload: the host packers,
the device decoders as CUDA kernels, and their plain PyTorch versions.

Port of the JAX package's packed runmat ("rmq") and rampmat ("rqr")
format (``audiality2_tpu/tpu/superblock.py``, ``_rmq_pack`` /
``_rqr_pack`` on the host, ``_rmq_unpack`` / ``_rqr_unpack`` on the
device).  A profiled mixer (``TorchMixer._rmq_finalize``) freezes, per
song or fleet, one sorted value table per low-entropy column; each run
then ships as 11 int32 words instead of the runmat's 18 (44 B against
72 B) and each ramp run as 8 words instead of the rampmat's 14 (32 B
against 56 B):

  rmq  words 0-3   raw: AMP0, DPH, PHLO, SIZE
       word  4     START(22) | OFF(6)<<22 | MODE(4)<<28
       word  5     (RIDX+1)(22) | (PHHI+1)(6)<<22
       word  6     SLOT(22) | LEN(8)<<22
       words 7-10  u16 pairs of table indices: DAMP,DPAN / PAN0,TOTAL /
                   POSOFF,DVOL / VOL0
  rqr  word  0     BASE(22) | MIP(4)<<22
       words 1-3   raw: ATMR, PV, DPHRAW
       words 4-7   u16 pairs of table indices: AT,PT / PTMR,VT /
                   VTMR,PTIMER / PRAMP,PERIOD  (PTGT == PV, not shipped)

``_rmq_pack`` / ``_rqr_pack`` are the JAX package's numpy functions,
unchanged: a value outside its table raises ``ValueError``.
``unpack_call`` rebuilds the [Nrp, BASE_N] runmat or [NrR, RR_N]
rampmat, column for column, with the kernels of
``csrc/unpack_kernel.cu`` for CUDA tensors and with
``rmq_unpack_torch`` / ``rqr_unpack_torch`` for CPU tensors.  A table
index beyond its table reads the table's last entry in both (a pack
never makes one).
"""

import ctypes

import numpy as np
import torch

from . import build
from .superblock import (
    BASE_N, RR_N, RC_START, RC_LEN, RC_DPH, RC_SIZE, RC_POSOFF, RC_AMP0,
    RC_DAMP, RC_VOL0, RC_DVOL, RC_PAN0, RC_DPAN, RC_SLOT, RC_MODE, RC_OFF,
    RC_TOTAL, RC_PHHI, RC_PHLO, RC_RIDX, RR_MIP, RR_AT, RR_ATMR, RR_VT,
    RR_VTMR, RR_PT, RR_PTMR, RR_PV, RR_PTGT, RR_PTIMER, RR_PRAMP,
    RR_DPHRAW, RR_PERIOD, RR_BASE)

# ---- the format (audiality2_tpu/tpu/superblock.py, unchanged) ----

_RMQ_IDXCOLS = (RC_DAMP, RC_DPAN, RC_PAN0, RC_TOTAL, RC_POSOFF,
                RC_DVOL, RC_VOL0)
_RMQ_WORDS = 11

_RQR_IDXCOLS = (RR_AT, RR_PT, RR_PTMR, RR_VT, RR_VTMR, RR_PTIMER,
                RR_PRAMP, RR_PERIOD)
_RQR_WORDS = 8


def _rmq_pack(rm, tables):
    """Host-side encode of a padded runmat [Nrp, BASE_N] into the
    packed (11, Nrp) int32 stream.  Raises ValueError when a value is
    missing from its table (a stream recorded past the profiled
    universe — the caller bridges natively)."""
    u = rm.astype(np.uint32)
    out = np.empty((_RMQ_WORDS, rm.shape[0]), np.uint32)
    out[0] = u[:, RC_AMP0]
    out[1] = u[:, RC_DPH]
    out[2] = u[:, RC_PHLO]
    out[3] = u[:, RC_SIZE]
    out[4] = (u[:, RC_START] | (u[:, RC_OFF] << 22)
              | (u[:, RC_MODE] << 28))
    out[5] = (((u[:, RC_RIDX] + 1) & 0x3FFFFF)
              | ((u[:, RC_PHHI] + 1) << 22))
    out[6] = u[:, RC_SLOT] | (u[:, RC_LEN] << 22)
    for w in range(4):
        half = []
        for j in (2 * w, 2 * w + 1):
            if j >= len(_RMQ_IDXCOLS):
                half.append(np.uint32(0))
                continue
            col = rm[:, _RMQ_IDXCOLS[j]]
            idx = np.searchsorted(tables[j], col)
            if (idx >= len(tables[j])).any() \
                    or not np.array_equal(tables[j][idx], col):
                raise ValueError("rmq: value outside profiled table")
            half.append(idx.astype(np.uint32))
        out[7 + w] = half[0] | (half[1] << 16)
    return out.view(np.int32)


def _rqr_pack(rmp, tables):
    """Host-side encode of a padded rampmat [NrR, RR_N] into the
    packed (8, NrR) int32 stream (see _RQR_WORDS)."""
    u = rmp.astype(np.uint32)
    out = np.empty((_RQR_WORDS, rmp.shape[0]), np.uint32)
    out[0] = u[:, RR_BASE] | (u[:, RR_MIP] << 22)
    out[1] = u[:, RR_ATMR]
    out[2] = u[:, RR_PV]
    out[3] = u[:, RR_DPHRAW]
    for w in range(4):
        half = []
        for j in (2 * w, 2 * w + 1):
            col = rmp[:, _RQR_IDXCOLS[j]]
            idx = np.searchsorted(tables[j], col)
            if (idx >= len(tables[j])).any() \
                    or not np.array_equal(tables[j][idx], col):
                raise ValueError("rqr: value outside profiled table")
            half.append(idx.astype(np.uint32))
        out[4 + w] = half[0] | (half[1] << 16)
    return out.view(np.int32)


# ---- the decoders: plain versions ----

# per kind: (words, table count, output columns)
KINDS = {"rmq": (_RMQ_WORDS, len(_RMQ_IDXCOLS), BASE_N),
         "rqr": (_RQR_WORDS, len(_RQR_IDXCOLS), RR_N)}


def _fields(pk, w):
    """The 16-bit table indices of words w.. (two per word), int64.
    Arithmetic shifts with a mask give the logical shifts of the
    format."""
    idx = []
    for k in range(w, pk.shape[0]):
        iw = pk[k]
        idx.append((iw & 0xFFFF).to(torch.int64))
        idx.append(((iw >> 16) & 0xFFFF).to(torch.int64))
    return idx


def _take(tab, idx):
    return tab[idx.clamp(max=tab.shape[0] - 1)]


def rmq_unpack_torch(pk, tabs):
    """The JAX package's ``_rmq_unpack``: packed int32 (11, Nrp) and
    the 7 value tables -> runmat int32 [Nrp, BASE_N]."""
    w1, w2, w3 = pk[4], pk[5], pk[6]
    idx = _fields(pk, 7)
    (damp, dpan, pan0, total, posoff, dvol,
     vol0) = [_take(tabs[j], idx[j]) for j in range(len(_RMQ_IDXCOLS))]
    cols = [None] * BASE_N
    cols[RC_START] = w1 & 0x3FFFFF
    cols[RC_LEN] = (w3 >> 22) & 255
    cols[RC_DPH] = pk[1]
    cols[RC_SIZE] = pk[3]
    cols[RC_POSOFF] = posoff
    cols[RC_AMP0] = pk[0]
    cols[RC_DAMP] = damp
    cols[RC_VOL0] = vol0
    cols[RC_DVOL] = dvol
    cols[RC_PAN0] = pan0
    cols[RC_DPAN] = dpan
    cols[RC_SLOT] = w3 & 0x3FFFFF
    cols[RC_MODE] = (w1 >> 28) & 15
    cols[RC_OFF] = (w1 >> 22) & 63
    cols[RC_TOTAL] = total
    cols[RC_PHHI] = ((w2 >> 22) & 63) - 1
    cols[RC_PHLO] = pk[2]
    cols[RC_RIDX] = (w2 & 0x3FFFFF) - 1
    return torch.stack(cols, dim=1)


def rqr_unpack_torch(pk, tabs):
    """The JAX package's ``_rqr_unpack``: packed int32 (8, NrR) and the
    8 value tables -> rampmat int32 [NrR, RR_N] (PTGT = PV)."""
    idx = _fields(pk, 4)
    (at, pt, ptmr, vt, vtmr, ptimer, pramp,
     period) = [_take(tabs[j], idx[j]) for j in range(len(_RQR_IDXCOLS))]
    cols = [None] * RR_N
    cols[RR_MIP] = (pk[0] >> 22) & 15
    cols[RR_AT] = at
    cols[RR_ATMR] = pk[1]
    cols[RR_VT] = vt
    cols[RR_VTMR] = vtmr
    cols[RR_PT] = pt
    cols[RR_PTMR] = ptmr
    cols[RR_PV] = pk[2]
    cols[RR_PTGT] = pk[2]
    cols[RR_PTIMER] = ptimer
    cols[RR_PRAMP] = pramp
    cols[RR_DPHRAW] = pk[3]
    cols[RR_PERIOD] = period
    cols[RR_BASE] = pk[0] & 0x3FFFFF
    return torch.stack(cols, dim=1)


_PLAIN = {"rmq": rmq_unpack_torch, "rqr": rqr_unpack_torch}


# ---- the decoders: CUDA kernels ----

def _bind(lib):
    lib.a2_unpack.restype = ctypes.c_int
    lib.a2_unpack.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]    # kind pk n
        + [ctypes.c_void_p] * 2                          # tabs sizes (host)
        + [ctypes.c_void_p] * 2)                         # out stream


def _load():
    return build.load("unpack_kernel", _bind)


def unpack_call(kind, pk, tabs):
    """Decodes a packed stream: kind "rmq" (pk int32 (11, N), 7 tables)
    -> runmat int32 [N, BASE_N], or "rqr" (pk int32 (8, N), 8 tables)
    -> rampmat int32 [N, RR_N]; tabs are 1-D int32 tensors of at least
    one value.  CPU tensors take the plain version; CUDA tensors launch
    the kernel (``unpack_call.launches`` counts those launches,
    ``unpack_call.kind_launches`` by kind) or raise."""
    if pk.device.type == "cpu":
        return _PLAIN[kind](pk, tabs)
    what = "unpack_call"
    dev = pk.device
    if dev.type != "cuda" or kind not in KINDS:
        raise ValueError("%s: device %s, kind %r" % (what, dev, kind))
    words, ntab, ncol = KINDS[kind]
    n = pk.shape[1]
    build.check_tensor(pk, what, "pk", torch.int32, (words, n), dev)
    if len(tabs) != ntab:
        raise ValueError("%s: %s takes %d tables, got %d"
                         % (what, kind, ntab, len(tabs)))
    for j, t in enumerate(tabs):
        build.check_tensor(t, what, "table %d" % j, torch.int32,
                           (max(t.shape[0], 1),), dev)
    out = torch.empty((n, ncol), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    ptrs = (ctypes.c_void_p * 8)(*[t.data_ptr() for t in tabs])
    sizes = (ctypes.c_int * 8)(*[t.shape[0] for t in tabs])
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.a2_unpack(list(KINDS).index(kind), pk.data_ptr(), n,
                            ctypes.addressof(ptrs), ctypes.addressof(sizes),
                            out.data_ptr(), stream)
    build.launch_check(err, "unpack " + kind)
    build.count_launch(unpack_call, kind)
    return out


unpack_call.launches = 0
unpack_call.kind_launches = dict.fromkeys(KINDS, 0)


def work(kind, n, tabs):
    """(bytes, int32 ops) of decoding n packed runs: the packed words
    and the tables read once, the decoded rows written once; the ops
    counted by hand from csrc/unpack_kernel.cu (per run: the field
    shifts and masks, each index's clamp, the gathers' address math)."""
    words, ntab, ncol = KINDS[kind]
    nbytes = 4 * (words * n + sum(int(t) for t in tabs) + ncol * n)
    ops = {"rmq": 40, "rqr": 32}[kind] * n
    return nbytes, ops


def seeded_format(rng, kind, n, table_sizes=None):
    """A seeded table set and a packed stream of n runs whose fields use
    every bit of the format (indices up to each table's last entry):
    (packed int32 numpy (words, n), [tables int32 numpy])."""
    words, ntab, _ = KINDS[kind]
    sizes = table_sizes or [int(rng.integers(1, 3000)) for _ in range(ntab)]
    tabs = [np.unique(rng.integers(-(1 << 31), 1 << 31, s, dtype=np.int64))
            .astype(np.int32) for s in sizes]
    pk = rng.integers(0, 1 << 32, (words, n), dtype=np.uint64) \
        .astype(np.uint32)
    first = 7 if kind == "rmq" else 4
    for w in range(first, words):
        lo = rng.integers(0, len(tabs[2 * (w - first)]), n)
        j = 2 * (w - first) + 1
        hi = rng.integers(0, len(tabs[j]), n) if j < ntab else 0
        pk[w] = (lo | (np.asarray(hi) << 16)).astype(np.uint32)
    return pk.view(np.int32), tabs
