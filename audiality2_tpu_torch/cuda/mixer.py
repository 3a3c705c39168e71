"""TorchMixer: runs SuperblockPrograms in PyTorch, on the card through
CUDA graphs.

Counterpart of the JAX package's ``DeviceMixer``
(``audiality2_tpu/tpu/superblock.py:3033``).  One superblock body
(``TorchMixer._body``, the JAX mixer's ``_build_inner``):

  runs, packed or not --(expand_call: decode, run -> row expansion,
           ramp replay, noise/dc rows added)--> params, slots
  params --(osc_slots_call per pass class: oscillator, slot adds)--> slots
  stash --(int32 segment sums)--> slots[ninst*F+1, 2, 64]
  slots --(stage tail: panmix/copy/waveshaper stages, fbdelay,
           filter12/dcblock/limiter, fm, in record order)--> slots
  slots --> master slice [F, channels, 64]

The body reads every table from one int32 upload blob laid out by the
program's signature (``blob_layout``) and advances the persistent
state (fbdelay rings, filter and fm state) in place in static buffers,
so that a ``torch.cuda.CUDAGraph`` per signature captures it: the host
work of a superblock (``_prepare``) is numpy, one pinned upload and
one graph launch.  The stage tail's serial recurrences run as CUDA
kernels (``fbdelay.py``, ``filter.py``, ``fm.py``; under
``stage_mode="float"`` the eligible filter12 / dcblock / limiter items
run as scans, ``filter_float.py``).

Integer semantics follow the reference exactly: int32 audio with
wrap, int64 where the reference computes in int64, arithmetic right
shifts, C truncating division (``torch.div(..., rounding_mode=
"trunc")``) where the JAX code uses its f32-estimate ``_tdiv``.
"""

import contextlib
import os
import threading
import time

import numpy as np
import torch

from ..constants import A2_MAXFRAG
from . import build
from . import expand as EX
from . import fbdelay as FB
from . import filter as FL
from . import filter_float as FF
from . import fm as FM
from . import osc_kernel as OK
from . import packed as PK
from .expand import _PTAB_BASE, _PTAB_COEFF, _tdiv
from .osc_kernel import _w
from .packed import _RMQ_IDXCOLS, _RMQ_WORDS, _RQR_IDXCOLS, _RQR_WORDS
from .superblock import (
    ALL_CLASSES, BASE_N, RR_N, _FILT_DEAD, _FILT_W, _pow2, _quant,
    Unsupported, RC_START, RC_LEN, RC_SLOT, RC_MODE, RC_OFF, RC_PHHI,
    RC_RIDX, RR_MIP, RR_PV, RR_PTGT, RR_BASE, _ROW_STEREO)

FRAG = A2_MAXFRAG
# every kernel wrapper of the mixer's path, by kernel name; each counts
# its launches in `.launches`
KERNEL_WRAPPERS = {"osc_rows": OK.osc_call,
                   "osc_slots": OK.osc_slots_call,
                   "fbdelay_dense": FB.fbd_dense_call,
                   "fbdelay_legacy": FB.fbd_legacy_call,
                   "filter": FL.filter_call, "fm": FM.fm_call,
                   "filter_float": FF.filter_float_call,
                   "unpack": PK.unpack_call, "expand": EX.expand_call}


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


# the JAX mixer's float-tier eligibility threshold on a filter12 class's
# lowest q (a signature element): a weakly damped resonator keeps the
# exact scan under stage_mode="float", as its truncation noise, which the
# float tier models only by its mean, would drift past the -80 dB budget
_FLOAT_TIER_MINQ = int(0.15 * (1 << 24))
_FILT_INIT = {"lim": FL.LIM_PEAK0, "fm": 0, "f12": 0, "dcb": 0}
# one process-wide lock around graph capture: the caching allocator's
# capture pools and the relaxed capture mode are per capturing thread
_CAPTURE_LOCK = threading.Lock()


_DEVICE_CTX = {}
_DEVICE_CTX_LOCK = threading.Lock()


def _device_context(device):
    """The streams and the graph memory pool that every mixer on one card
    shares: (compute, upload, capture stream, pool).  All graphs run one
    at a time on the one compute stream, and nothing a body allocates
    outlives it (its results go to static buffers), so the graphs'
    intermediates may share one pool.  A one-node anchor graph holds the
    pool, so that its memory outlives any one renderer's graphs and a
    new mixer's first capture finds it allocated."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _DEVICE_CTX_LOCK:
        ctx = _DEVICE_CTX.get(idx)
        if ctx is None:
            dev = torch.device("cuda", idx)
            cs, us, gs = (torch.cuda.Stream(dev) for _ in range(3))
            pool = torch.cuda.graph_pool_handle()
            anchor = torch.cuda.CUDAGraph()
            x = torch.zeros(1, dtype=torch.int32, device=dev)
            gs.wait_stream(torch.cuda.current_stream(dev))
            with _CAPTURE_LOCK, torch.cuda.stream(gs):
                anchor.capture_begin(pool=pool,
                                     capture_error_mode="relaxed")
                try:
                    x.add_(1)
                finally:
                    anchor.capture_end()
            ctx = (cs, us, gs, pool, (anchor, x))
            _DEVICE_CTX[idx] = ctx
        return ctx[:4]


def blob_layout(sig):
    """Static layout of one superblock's upload: name -> (offset, shape)
    over one flat int32 array, and its size, from the signature alone
    (so the host fill and the body's views always agree).  The JAX
    mixer's ``_blob_layout`` (the packed format's streams and tables
    ``rmq`` / ``("rmt", j)`` and ``rqr`` / ``("rqt", j)`` where the
    signature's last element holds their sizes, else ``rm`` / ``rmp``),
    without its sorted-accumulation permutation, plus each filter / fm
    item's step-group table ``("fgrp", j)`` (``filter.pack_bounds``,
    [S + 2])."""
    (F, ninst, minst, mch, rows_sig, rpad, ns, nsm, ramppad,
     readback, quality, items, rmq) = sig
    ent = []
    for i, (cls, NB) in enumerate(rows_sig):
        ent.append((("tbase", i), (NB,)))
    if rpad:
        if rmq:
            ent.append(("rmq", (_RMQ_WORDS, rpad)))
            for j, sz in enumerate(rmq[0]):
                ent.append((("rmt", j), (sz,)))
        else:
            ent.append(("rm", (rpad, BASE_N)))
    if ramppad:
        if rmq and rmq[1]:
            ent.append(("rqr", (_RQR_WORDS, ramppad)))
            for j, sz in enumerate(rmq[1]):
                ent.append((("rqt", j), (sz,)))
        else:
            ent.append(("rmp", (ramppad, RR_N)))
    if ns:
        ent.append(("sa", (ns, 2, FRAG)))
        ent.append(("sas", (ns,)))
    if nsm:
        ent.append(("sm", (nsm, FRAG)))
        ent.append(("sms", (nsm,)))
    nfbd = 0
    nperm = 0
    for j, (tag, key, extra) in enumerate(items):
        if tag == "stage":
            K, G = extra
            if K:
                ent.append((("it", j), (K, 9)))
            if G:
                ent.append((("itd", j), (G, F, 9)))
        elif tag == "fbd":
            ent.append((("it", j), (extra[0], 13)))
            nfbd += 1
        else:
            S, K = extra[0], extra[1]
            ent.append((("it", j), (S, K, _FILT_W[key[2]])))
            ent.append((("fgrp", j), (S + 2,)))
            nperm += K
    if nfbd:
        ent.append(("fbdpos", (nfbd,)))
    if nperm:
        ent.append(("fperm", (nperm,)))
    layout = {}
    pos = 0
    for name, shape in ent:
        layout[name] = (pos, shape)
        pos += int(np.prod(shape, dtype=np.int64))
    return layout, max(pos, 1)


def blob_views(blob, layout, base=0):
    """name -> the view of each table of `layout` in the flat int32
    tensor `blob`, the layout starting at offset `base`."""
    v = {}
    for name, (pos, shape) in layout.items():
        size = int(np.prod(shape, dtype=np.int64))
        v[name] = blob[base + pos:base + pos + size].view(shape)
    return v


def rowless(sig):
    """The signature of a body's stage half alone: `sig` without its row
    tables (no class blocks, runs or ramp runs), so that its blob holds
    the stash and the stage items only."""
    return sig[:4] + ((), 0) + sig[6:8] + (0,) + sig[9:12] + (None,)


class _StateSet:
    """The persistent state that one superblock body reads and advances
    in place: an fbdelay ring per fbdelay item and a state array per
    filter / fm item, in the signature's item order.  Each buffer
    remembers the id of the stream state it holds (``owner``): the
    mixer binds a stream's state by pointing its entry at the buffer,
    copying it in (and the previous holder's out) only when another
    stream's state sits there."""

    def __init__(self, sig, device):
        self.rings = []
        self.filt = []
        for tag, key, extra in sig[11]:
            if tag == "fbd":
                n = FB.FBD_TAIL if extra[5] else FB.FBD_BUFSIZE
                self.rings.append(torch.zeros((2, n), dtype=torch.int32,
                                              device=device))
            elif tag == "filt":
                self.filt.append(FL.init_state(key[2], extra[1], device))
        self.owners = {"ring": [None] * len(self.rings),
                       "filt": [None] * len(self.filt)}


class _Entry:
    """One dispatch unit: the static buffers of n superblock bodies (one
    device blob holding their uploads, the views of each, their state
    sets and masters) and, on the card, the CUDA graph that runs them
    all in one launch.  chain: the bodies share one state set
    (consecutive superblocks of one stream); otherwise each has its
    own (state-disjoint streams)."""

    def __init__(self, mixer, sigs, chain):
        dev = mixer.device
        self.sigs = sigs
        self.layouts = []
        self.offs = []
        total = 0
        for sig in sigs:
            lay, n = blob_layout(sig)
            self.layouts.append(lay)
            self.offs.append((total, n))
            total += n
        self.total = total
        self.blob = torch.zeros(total, dtype=torch.int32, device=dev)
        self.views = [blob_views(self.blob, lay, o)
                      for lay, (o, n) in zip(self.layouts, self.offs)]
        if chain:
            st = _StateSet(sigs[0], dev)
            self.states = [st] * len(sigs)
        else:
            self.states = [_StateSet(sig, dev) for sig in sigs]
        self.masters = [
            torch.zeros((sig[0], sig[3], FRAG),
                        dtype=torch.int16 if sig[9] == "i16"
                        else torch.int32, device=dev) for sig in sigs]
        # what the captured graph reads besides its own buffers: kept
        # alive with it, and the atlas version it was captured against
        self.refs = (mixer._atlas_dev, mixer._sine, mixer._ptabs)
        self.atlas_ver = mixer._atlas_ver
        self.graph = None
        # (kernel wrapper, kind) -> launches per run of the graph
        self.launches = {}
        if dev.type == "cuda":
            # two pinned staging blobs, used in turn: the host fills one
            # while the other's upload may still be in flight
            self.stage = [torch.empty(total, dtype=torch.int32,
                                      pin_memory=True) for _ in range(2)]
            self.stage_ev = [None, None]
            self.k = 0
            # recorded after each run: the next upload into the device
            # blob waits for it
            self.free_ev = torch.cuda.Event()
            self.free_ev.record(mixer._cstream)

    def run(self, mixer):
        for sig, v, st, m in zip(self.sigs, self.views, self.states,
                                 self.masters):
            mixer._body(sig, v, st, m)


class TorchMixer:
    """Executes SuperblockPrograms with PyTorch on ``device``, as the
    JAX package's ``DeviceMixer`` does on the TPU: every program is
    padded to its stream's high-water shapes (``_repad``; ``observe``
    pins them in a profile pass) and keyed by ``_signature``.  Per
    signature the mixer holds static device buffers (the upload blob,
    the persistent state, the master) and, on the card, one
    ``torch.cuda.CUDAGraph`` of the superblock body (``_fns``: signature
    -> entry), captured by ``precompile`` or by the signature's second
    dispatch (the first runs the body eagerly); ``dispatch_chain`` /
    ``dispatch_many`` run several superblocks in one graph launch.  ``_prepare`` does all host work
    (padding, the numpy tables, step groups, the dense flags, the filter
    lane permutation) and writes one pinned blob, uploaded
    asynchronously on an upload stream; the body reads everything from
    device buffers.  On the CPU the same bodies run eagerly.  A profiled
    mixer decides the JAX mixer's packed dispatch format once
    (``_rmq_finalize``, or ``finalize_format`` for a fleet): the runmat
    (and rampmat) then upload as packed words and value tables, which
    the body's expansion (``expand.expand_call``) decodes.

    The run expansion runs through ``expand.expand_call``, the
    oscillator and its slot adds through ``osc_kernel.osc_slots_call``,
    the stage tail through the fbdelay / filter / fm wrappers (the CUDA
    kernels for
    CUDA tensors, their plain versions on the CPU); with
    ``stage_mode="float"`` a filter12 / dcblock / limiter item whose
    class is eligible (the signature's flag: a filter12 class's lowest
    q at or above ``_FLOAT_TIER_MINQ``) runs through
    ``filter_float.filter_float_call`` instead.  Persistent state is
    keyed per stream as in the JAX mixer: fbdelay rings by unit id,
    which ``DeviceRenderer._tag_prog`` makes ``(ns, unit_id)`` on a
    shared mixer, filter / fm state by ``(ns, key)``.  A wrapper's
    ``.launches`` grows at each graph launch by the kernel launches
    captured in it."""

    def __init__(self, core, device="cuda", readback="exact", quality=0,
                 transfer_lock=None, stage_mode="exact"):
        if stage_mode not in ("exact", "float"):
            raise ValueError("stage_mode must be 'exact' or 'float'")
        if readback not in ("exact", "i16"):
            raise ValueError("readback must be 'exact' or 'i16'")
        self.core = core
        self.device = torch.device(device)
        self.readback = readback
        self.quality = quality
        self.stage_mode = stage_mode
        self.transfer_lock = transfer_lock
        self._atlas_dev = None
        self._atlas_ver = -1
        self._ptabs = None
        self._sine = None
        self._cstream = self._ustream = self._gstream = None
        self._rings = {}         # unit id -> [ring, ring position]
        self._filt = {}          # (ns, item key) -> [state, serials]
        self._fns = {}           # signature -> _Entry
        self._chain_fns = {}     # ("chain", sig, n) / ("many", sigs)
        # per-namespace shape padding (prog.ns; 0 for solo renders), as
        # in the JAX mixer
        self._hw = {}            # ns -> {key -> high-water}
        self._union_stages = {}  # ns -> {stage key -> template}
        self._union_fbd = {}     # ns -> {unit_id -> template dict}
        self._union_filters = {}  # ns -> {filter class key -> {S,K}}
        self._fine = False       # exact-fit padding (observe())
        # the packed dispatch format: None until decided (at the first
        # signature after a profile pass, or finalize_format), then its
        # tables or False (unpacked uploads); observe() gathers each
        # packed column's values and each bit field's range
        self._rmq = None
        self._rmq_acc = {"uniq": [[] for _ in _RMQ_IDXCOLS],
                         "runiq": [[] for _ in _RQR_IDXCOLS],
                         "max": {}}
        self._pinned = {}        # (shape, dtype) -> free pinned buffers
        self._pin_lock = threading.Lock()
        self._pool = None        # the graphs' shared memory pool
        self.captures = 0        # graphs captured
        self.capture_s = 0.0     # host seconds spent capturing
        self.capture_log = []
        self.replays = 0         # graph launches
        # time_device: each graph launch is bracketed by timing events,
        # read by device_seconds()
        self.time_device = False
        self._dev_events = []

    @property
    def _fbd_dense(self):
        """The sticky dense flag of every fbdelay instance seen: unit
        id -> bool (``_repad`` keeps it per namespace)."""
        out = {}
        for hw in self._hw.values():
            for k, v in hw.items():
                if isinstance(k, tuple) and k[0] == "fbdense":
                    out[k[1]] = bool(v)
        return out

    # ---- static device data ----

    def device_atlas(self):
        """The pair atlas on the mixer's device (uploaded again when
        the atlas grows; an engine that has met no wave yet gets an empty
        one, as in the JAX mixer)."""
        pa = self.core._pair_atlas
        if pa is None:
            self.core._pair_atlas = pa = OK.PairAtlas()
        with pa.lock:
            if pa.data is None:
                pa.finalize()
            if pa.version != self._atlas_ver:
                self._atlas_dev = torch.as_tensor(pa.data,
                                                  dtype=torch.int32,
                                                  device=self.device)
                self._atlas_ver = pa.version
        return self._atlas_dev

    def _ensure_static(self):
        """On the card the shared streams; then, on the compute stream,
        the tables every body reads (pitch tables, fm sine pairs, the
        atlas)."""
        if self.device.type == "cuda" and self._cstream is None:
            (self._cstream, self._ustream, self._gstream,
             self._pool) = _device_context(self.device)
        with self._stream():
            if self._ptabs is None:
                self._ptabs = (
                    torch.as_tensor(_PTAB_BASE, device=self.device),
                    torch.as_tensor(_PTAB_COEFF, device=self.device))
                self._sine = torch.as_tensor(FM.sine_pairs(),
                                             dtype=torch.int32,
                                             device=self.device)
            self.device_atlas()

    def _stream(self):
        """Context: the mixer's compute stream on the card."""
        if self._cstream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._cstream)

    def _t(self, a, dtype=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device) \
            .to(dtype)

    # ---- profile pass and shape padding (the JAX mixer's) ----

    def observe(self, prog):
        """Profile pass: folds this program's shapes into the high-water
        marks and the stage-structure union without dispatching
        anything.  After observing every superblock of a song, all its
        real dispatches share one signature (one graph capture), and
        the padding steps are fine (``_quant``) instead of pow2."""
        self._fine = True
        self._repad(prog)
        ns = getattr(prog, "ns", 0)
        ust = self._union_stages.setdefault(ns, {})
        ufb = self._union_fbd.setdefault(ns, {})
        ufl = self._union_filters.setdefault(ns, {})
        for st in prog.stages:
            t = ust.get(st["key"]) or {"K": 0, "G": 0}
            ust[st["key"]] = {
                "K": max(t["K"], st["arr"].shape[0]),
                "G": max(t["G"], st["dense"].shape[0])}
        for fd in prog.fbdelays:
            ufb[fd["unit_id"]] = {
                "key": fd["key"], "stereoin": fd["stereoin"],
                "stereoout": fd["stereoout"], "add": fd["add"],
                "chunk": fd["chunk"], "ns": fd["arr"].shape[0]}
        for fl in prog.filters:
            old = ufl.get(fl["key"])
            ufl[fl["key"]] = {
                "S": fl["arr"].shape[0], "K": fl["arr"].shape[1],
                "minq": min(fl.get("minq", 1 << 30),
                            old["minq"] if old else 1 << 30)}
        # the packed format's profile, over the PADDED runmat and
        # rampmat (so the dead runs' encoding is covered too): each
        # table column's values and each bit field's range, unioned at
        # _rmq_finalize
        if self._rmq is None and prog.runmat is not None \
                and prog.runmat.size:
            rm = prog.runmat
            acc = self._rmq_acc
            for j, c in enumerate(_RMQ_IDXCOLS):
                acc["uniq"][j].append(np.unique(rm[:, c]))
            mx = acc["max"]
            mx["rtot"] = max(mx.get("rtot", 0), int(prog.Rtot))
            for key, col in (("start", RC_START), ("slot", RC_SLOT),
                             ("len", RC_LEN), ("off", RC_OFF),
                             ("mode", RC_MODE), ("phhi", RC_PHHI),
                             ("ridx", RC_RIDX)):
                v = rm[:, col]
                mx[key] = max(mx.get(key, 0), int(v.max()))
                mx[key + "_lo"] = min(mx.get(key + "_lo", 0),
                                      int(v.min()))
            rmp = getattr(prog, "rampmat", None)
            if rmp is not None and rmp.size:
                for j, c in enumerate(_RQR_IDXCOLS):
                    acc["runiq"][j].append(np.unique(rmp[:, c]))
                for key, col in (("rbase", RR_BASE), ("rmip", RR_MIP)):
                    v = rmp[:, col]
                    mx[key] = max(mx.get(key, 0), int(v.max()))
                    mx[key + "_lo"] = min(mx.get(key + "_lo", 0),
                                          int(v.min()))
                if not np.array_equal(rmp[:, RR_PV], rmp[:, RR_PTGT]):
                    mx["ptgt_ne"] = 1
                mx["rseen"] = 1

    def finalize_format(self):
        """Decides the packed format now, for a fleet-shared mixer whose
        whole fleet has profiled (``serve.render_multiplexed`` calls it
        after the streams' profile passes): the tables union every
        profiled stream's values.  A stream that later records a value
        outside them raises ``Unsupported`` at its dispatch and bridges
        natively."""
        if self._rmq is None and self._fine:
            self._rmq = self._rmq_finalize(force=True)

    def _rmq_finalize(self, force=False):
        """The JAX mixer's packed-format decision, made once per mixer
        after the profile pass: the 7 sorted runmat value tables (and
        the rampmat's 8, when every rampmat field fits) and their sizes,
        or False (unpacked uploads) when ``A2_NO_PACK`` is set, a bit
        field's range or a table's size breaks the format, or the mixer
        is shared by a fleet (namespaces other than 0: a stream joining
        later could record values outside the tables) and ``force`` is
        not set."""
        if os.environ.get("A2_NO_PACK") \
                or (not force and set(self._hw.keys()) != {0}):
            return False
        acc = self._rmq_acc
        mx = acc["max"]
        if not mx:
            return False
        ok = (mx.get("rtot", 0) < (1 << 22)
              and mx.get("start", 0) <= mx.get("rtot", 0)
              and mx.get("start_lo", 0) >= 0
              and mx.get("slot", 0) < (1 << 22)
              and mx.get("slot_lo", 0) >= 0
              and mx.get("len", 0) <= 255
              and mx.get("len_lo", 0) >= 0
              and 0 <= mx.get("off", 0) < 64
              and mx.get("off_lo", 0) >= 0
              and 0 <= mx.get("mode", 0) < 16
              and mx.get("mode_lo", 0) >= 0
              and -1 <= mx.get("phhi_lo", 0)
              and mx.get("phhi", 0) < 62
              and mx.get("ridx", 0) + 1 < (1 << 22)
              and mx.get("ridx_lo", 0) >= -1)
        if not ok:
            return False
        tables = []
        for j in range(len(_RMQ_IDXCOLS)):
            u = np.unique(np.concatenate(
                acc["uniq"][j] + [np.zeros(1, np.int32)]))
            if len(u) > 65535:
                return False
            tables.append(u.astype(np.int32))
        # the rampmat's half: where its fields break the format, only
        # the rampmat ships unpacked
        rtables = None
        if mx.get("rseen") and not mx.get("ptgt_ne") \
                and 0 <= mx.get("rbase_lo", 0) \
                and mx.get("rbase", 0) < (1 << 22) \
                and 0 <= mx.get("rmip_lo", 0) \
                and mx.get("rmip", 0) < 16:
            rtables = []
            for j in range(len(_RQR_IDXCOLS)):
                u = np.unique(np.concatenate(
                    acc["runiq"][j] + [np.zeros(1, np.int32)]))
                if len(u) > 65535:
                    rtables = None
                    break
                rtables.append(u.astype(np.int32))
        return {"tables": tables,
                "sizes": tuple(len(t) for t in tables),
                "rtables": rtables,
                "rsizes": (tuple(len(t) for t in rtables)
                           if rtables else None)}

    def _repad(self, prog):
        """Pads every variable-size array up to its stream's high-water
        mark, so that steady-state superblocks share one signature (the
        JAX mixer's ``_repad``, line for line).  Padding changes no
        number: padded runs, rows, slices and stash patches are dead."""
        ns = getattr(prog, "ns", 0)
        hw = self._hw.setdefault(ns, {})

        def grow(key, n):
            m = max(hw.get(key, 0), n)
            hw[key] = m
            return m

        # padding instances are never read (all real slots index inst <
        # the build-time count)
        prog.ninst = grow("ninst", prog.ninst)
        # sticky ramp-replay flag
        prog.has_ramp = bool(grow("has_ramp",
                                  int(getattr(prog, "has_ramp", False))))
        # sticky stereo-rows flag: a song none of whose rows (nor stash
        # patches) is stereo expands its rows in mono
        st = 0
        if prog.runmat is not None and prog.runmat.shape[0]:
            st = int(bool((prog.runmat[:, RC_MODE] & _ROW_STEREO).any()))
        if not st and getattr(prog, "stash_audio", None) is not None \
                and prog.stash_audio.shape[0]:
            st = int(bool(prog.stash_audio[:, 1].any()))
        prog.rows_stereo = bool(grow("rows_stereo", st))
        dead = prog.ninst * prog.F

        # oscillator runs: monotone class-block growth; growing a class
        # shifts the bases of later classes, so run starts are remapped
        if prog.runmat is not None:
            old_ends = []
            shift = []
            ob = nb = 0
            blocks = []
            for cls, NB, tb in prog.class_blocks:
                NBp = grow(("cls", cls), _quant(NB, 8)
                           if self._fine else _pow2(max(NB, 1), 8))
                shift.append(nb - ob)
                ob += NB * OK.RPB
                old_ends.append(ob)
                nb += NBp * OK.RPB
                if NBp > NB:
                    tb = np.concatenate([tb, np.zeros(NBp - NB, np.int32)])
                blocks.append((cls, NBp, tb))
            prog.class_blocks = blocks
            shift.append(nb - ob)        # dead-run sentinel (== Rtot)
            starts = prog.runmat[:, RC_START].astype(np.int64)
            if nb != ob:
                ci = np.searchsorted(np.asarray(old_ends), starts,
                                     side="right")
                prog.runmat[:, RC_START] = (
                    starts + np.asarray(shift, np.int64)[ci]) \
                    .astype(np.int32)
            prog.Rtot = nb
            Nr = prog.runmat.shape[0]
            Nrp = grow("runs", _quant(Nr, 2048)
                       if self._fine else _pow2(max(Nr, 1), 1024))
            if Nrp > Nr:
                m = np.zeros((Nrp, BASE_N), np.int32)
                m[:, RC_START] = prog.Rtot
                m[:, RC_RIDX] = -1
                m[:Nr] = prog.runmat
                prog.runmat = m
            if prog.has_ramp or hw.get("rampruns", 0):
                NrR = prog.rampmat.shape[0]
                NrRp = grow("rampruns", _quant(NrR, 512)
                            if self._fine else _pow2(max(NrR, 1), 512))
                if NrRp > NrR:
                    rm = np.zeros((NrRp, RR_N), np.int32)
                    rm[:NrR] = prog.rampmat
                    prog.rampmat = rm
                prog.has_ramp = True
        if prog.runmat is None and hw.get("runs", 0):
            # no oscillator rows here, but the signature must match:
            # dead runmat and the high-water class blocks
            blocks = []
            base = 0
            for cls in ALL_CLASSES:
                NBp = hw.get(("cls", cls), 0)
                blocks.append((cls, NBp, np.zeros(NBp, np.int32)))
                base += NBp * OK.RPB
            prog.class_blocks = blocks
            prog.Rtot = base
            m = np.zeros((hw["runs"], BASE_N), np.int32)
            m[:, RC_START] = base
            m[:, RC_RIDX] = -1
            prog.runmat = m
            if hw.get("rampruns", 0):
                prog.rampmat = np.zeros((hw["rampruns"], RR_N), np.int32)
                prog.has_ramp = True
        if prog.stash_audio is not None or hw.get("stash", 0):
            NS = prog.stash_audio.shape[0] \
                if prog.stash_audio is not None else 0
            NSp = grow("stash", NS)
            if NSp > NS:
                sa = np.zeros((NSp, 2, FRAG), np.int32)
                sl = np.full(NSp, dead, np.int32)
                if NS:
                    sa[:NS] = prog.stash_audio
                    sl[:NS] = prog.stash_slot
                prog.stash_audio, prog.stash_slot = sa, sl
        if prog.stash_mono is not None or hw.get("stashm", 0):
            NS = prog.stash_mono.shape[0] \
                if prog.stash_mono is not None else 0
            NSp = grow("stashm", NS)
            if NSp > NS:
                sa = np.zeros((NSp, FRAG), np.int32)
                sl = np.full(NSp, dead, np.int32)
                if NS:
                    sa[:NS] = prog.stash_mono
                    sl[:NS] = prog.stash_mono_slot
                prog.stash_mono, prog.stash_mono_slot = sa, sl
        for st in prog.stages:
            K = st["arr"].shape[0]
            Kp = grow(("st",) + st["key"], K)
            if Kp > K:
                arr = np.zeros((Kp, 9), np.int32)
                arr[:, 0] = dead
                arr[:, 1] = dead
                arr[:K] = st["arr"]
                st["arr"] = arr
            G = st["dense"].shape[0]
            Gp = grow(("stG",) + st["key"], G)
            if Gp > G:
                # padding groups: all-zero rows (frames 0), whose
                # delta is zero
                da = np.zeros((Gp, prog.F, 9), np.int32)
                da[:G] = st["dense"]
                st["dense"] = da
        for fd in prog.fbdelays:
            # sticky dense flag: once any superblock needs the legacy
            # form for this instance (or its delays drift from those
            # its dense form began with), it stays legacy, so the ring
            # format is stable across the song's one signature
            dkey = ("fbdense", fd["unit_id"])
            sticky = hw.get(dkey, 1)
            nowd = int(bool(fd.get("dense"))) & sticky
            pkey = ("fbpar", fd["unit_id"])
            if nowd:
                par = fd.get("fbpar", (-1, -1, -1))
                seen = hw.get(pkey)
                if seen is None:
                    hw[pkey] = par
                elif seen != par:
                    nowd = 0
            hw[dkey] = nowd
            fd["dense"] = bool(nowd)
            NS = fd["arr"].shape[0]
            C = fd["chunk"]
            NSp = grow(("fbd", fd["unit_id"], C), NS)
            NSp = ((NSp + C - 1) // C) * C
            if NSp > NS:
                arr = np.zeros((NSp, 13), np.int32)
                arr[:, :4] = dead      # sorted-emit invariant
                arr[:NS] = fd["arr"]
                fd["arr"] = arr
        for fl in prog.filters:
            S_, K_, W_ = fl["arr"].shape
            Sp = grow(("flS",) + fl["key"], S_)
            Kp = grow(("flK",) + fl["key"], K_)
            if Sp > S_ or Kp > K_:
                arr = np.zeros((Sp, Kp, W_), np.int32)
                for c in _FILT_DEAD[fl["kind"]]:
                    arr[:, :, c] = dead
                arr[:S_, :K_] = fl["arr"]
                fl["arr"] = arr
            # sticky low-water of the observed q (a signature element)
            qkey = ("flQ",) + fl["key"]
            mq = min(hw.get(qkey, 1 << 30), fl.get("minq", 1 << 30))
            hw[qkey] = mq
            fl["minq"] = mq

        # profiled structure union: dead entries for the stages /
        # fbdelay instances / filter classes absent from this superblock
        ust = self._union_stages.get(ns) or {}
        ufb = self._union_fbd.get(ns) or {}
        ufl = self._union_filters.get(ns) or {}
        if ust:
            have = {st["key"] for st in prog.stages}
            for key, t in ust.items():
                if key in have:
                    continue
                K = max(t["K"], hw.get(("st",) + key, 0))
                G = max(t["G"], hw.get(("stG",) + key, 0))
                hw[("st",) + key] = K
                hw[("stG",) + key] = G
                arr = np.zeros((K, 9), np.int32)
                arr[:, 0] = dead
                arr[:, 1] = dead
                prog.stages.append({
                    "kind": key[2], "key": key, "arr": arr, "n": 0,
                    "dense": np.zeros((G, prog.F, 9), np.int32)})
        if ufb:
            have = {fd["unit_id"] for fd in prog.fbdelays}
            for uid, t in ufb.items():
                if uid in have:
                    continue
                # an absent instance cannot be dense (its ring time
                # must freeze): the whole song goes legacy
                hw[("fbdense", uid)] = 0
                n = max(t["ns"], hw.get(("fbd", uid, t["chunk"]), t["ns"]))
                n = ((n + t["chunk"] - 1) // t["chunk"]) * t["chunk"]
                hw[("fbd", uid, t["chunk"])] = max(
                    hw.get(("fbd", uid, t["chunk"]), 0), n)
                fda = np.zeros((n, 13), np.int32)
                fda[:, :4] = dead      # sorted-emit invariant
                prog.fbdelays.append({
                    "unit_id": uid, "key": t["key"],
                    "stereoin": t["stereoin"],
                    "stereoout": t["stereoout"], "add": t["add"],
                    "arr": fda, "n": 0, "chunk": t["chunk"],
                    "dense": False})
        if ufl:
            have = {fl["key"] for fl in prog.filters}
            for key, t in ufl.items():
                if key in have:
                    continue
                Sp = max(t["S"], hw.get(("flS",) + key, 0))
                Kp = max(t["K"], hw.get(("flK",) + key, 0))
                arr = np.zeros((Sp, Kp, _FILT_W[key[2]]), np.int32)
                for c in _FILT_DEAD[key[2]]:
                    arr[:, :, c] = dead
                prog.filters.append({
                    "kind": key[2], "key": key, "serials": [], "arr": arr,
                    "n": 0, "minq": min(t.get("minq", 1 << 30),
                                        hw.get(("flQ",) + key, 1 << 30))})

    def _signature(self, prog):
        """The JAX mixer's signature tuple of a padded program: shapes,
        the stage tail's item structure in execution order, readback
        and quality bits (16 float tier, 32 mono row expansion), and the
        packed format's table sizes ``(sizes, rsizes)`` or None.  The
        first signature after a profile pass decides the format
        (``_rmq_finalize``)."""
        rows = tuple((cls, NB) for cls, NB, _ in prog.class_blocks)
        rpad = prog.runmat.shape[0] if prog.runmat is not None else 0
        ramppad = prog.rampmat.shape[0] \
            if getattr(prog, "rampmat", None) is not None else 0
        ns = prog.stash_audio.shape[0] if prog.stash_audio is not None \
            else 0
        nsm = prog.stash_mono.shape[0] \
            if getattr(prog, "stash_mono", None) is not None else 0
        items = []
        for st in prog.stages:
            items.append(("stage", st["key"],
                          (st["arr"].shape[0], st["dense"].shape[0]), ""))
        for fd in prog.fbdelays:
            # fb/ld/rd ride the signature for dense instances: the dense
            # body's ring slicing is static in them
            items.append(("fbd", fd["key"],
                          (fd["arr"].shape[0], fd["stereoin"],
                           fd["stereoout"], fd["add"], fd["chunk"],
                           bool(fd["dense"]))
                          + (tuple(fd.get("fbpar", (-1, -1, -1)))
                             if fd["dense"] else ()),
                          str(fd["unit_id"])))
        for fl in prog.filters:
            ok = int(fl.get("minq", 1 << 30) >= _FLOAT_TIER_MINQ)
            items.append(("filt", fl["key"],
                          fl["arr"].shape[:2] + (ok,), ""))
        items.sort(key=lambda t: (t[1], t[3]))
        items = [t[:3] for t in items]
        if self._rmq is None and self._fine:
            self._rmq = self._rmq_finalize()
        return (prog.F, prog.ninst, prog.master_inst,
                prog.master_channels, rows, rpad, ns, nsm,
                ramppad if prog.has_ramp else 0, self.readback,
                self.quality + (16 if self.stage_mode == "float" else 0)
                + (32 if rpad and not getattr(prog, "rows_stereo", True)
                   else 0),
                tuple(items),
                ((self._rmq["sizes"], self._rmq["rsizes"])
                 if self._rmq else None))

    def device_bytes(self, prog):
        """Device memory of one stream at this program's signature, with
        the JAX mixer's keys: persistent (fbdelay rings, filter / fm
        state), exec (slots, row audio, row parameters, stash of one
        executing superblock), blob (the upload) and master (the
        readback) of each superblock in flight, working (their sum),
        and atlas (the shared wave atlas, counted once)."""
        self._repad(prog)
        sig = self._signature(prog)
        (F, ninst, minst, mch, rows_sig, rpad, ns, nsm, ramppad,
         readback, quality, items, rmq) = sig
        persistent = 0
        for t, k, e in items:
            if t == "fbd":
                persistent += 2 * (FB.FBD_TAIL if e[5]
                                   else FB.FBD_BUFSIZE) * 4
            elif t == "filt":
                persistent += e[1] * (8 if k[2] == "lim" else 16)
        blob = blob_layout(sig)[1] * 4
        Rtot = sum(NB * OK.RPB for _, NB in rows_sig)
        execb = (ninst * F + 1) * 2 * FRAG * 4             # slots
        execb += Rtot * (FRAG if quality & 32
                         else 2 * FRAG) * 4                # row audio
        execb += Rtot * (OK.NPARAM * 4 + 8)                # params, slot_r
        execb += ns * 2 * FRAG * 4 + nsm * FRAG * 4        # stash
        master = F * mch * FRAG * (2 if readback == "i16" else 4)
        atlas = self.core._pair_atlas
        return {"persistent": persistent, "blob": blob, "exec": execb,
                "master": master, "working": blob + execb + master,
                "atlas": (atlas.data.nbytes if atlas is not None
                          and atlas.data is not None else 0)}

    # ---- the superblock body (everything a graph captures) ----

    def row_params(self, prog):
        """``expand.row_params`` of a program as ``program_from_native``
        made it (or padded), its tables uploaded here.  Returns (classes,
        slot_r, mono)."""
        self._ensure_static()
        mono = not bool((prog.runmat[:, RC_MODE] & _ROW_STEREO).any())
        if prog.stash_audio is not None and len(prog.stash_audio):
            mono = mono and not prog.stash_audio[:, 1].any()
        rmp = self._t(prog.rampmat) if prog.has_ramp \
            and prog.rampmat is not None and len(prog.rampmat) else None
        classes, slot_r = EX.row_params(
            self._t(prog.runmat), rmp,
            [self._t(tb, torch.int32) for _, _, tb in prog.class_blocks],
            [(cls, NB) for cls, NB, _ in prog.class_blocks], mono,
            prog.ninst * prog.F, self._ptabs)
        return classes, slot_r, mono

    def _body(self, sig, v, st, master):
        """One superblock from the device buffers of its signature: v
        the blob's views (``blob_layout``), st its ``_StateSet``
        (advanced in place), master the static output [F, channels,
        64].  No host data and no host synchronisation: a CUDA graph
        captures it.  The oscillator half (``_expand``) and the stage
        half (``_tail``) also run apart in the sharded render
        (``parallel.py``), which sums several shards' expansions into
        one tail."""
        nslot = sig[1] * sig[0] + 1
        slots = torch.zeros((nslot, 2, FRAG), dtype=torch.int32,
                            device=master.device)
        self._expand(sig, v, slots)
        self._tail(sig, v, st, slots, master)

    def _expand_args(self, sig, v, slots):
        """``expand.expand_call``'s arguments for the row tables of v
        (``tbase``, ``rm`` / ``rmq``, ``rmp`` / ``rqr``) and ``slots``."""
        rows_sig, ramppad, rmq = sig[4], sig[8], sig[12]
        runs = ("rmq", v["rmq"], [v[("rmt", j)] for j in
                                  range(len(rmq[0]))]) if rmq \
            else ("plain", v["rm"])
        ramps = None
        if ramppad:
            ramps = ("rqr", v["rqr"], [v[("rqt", j)] for j in
                                       range(len(rmq[1]))]) \
                if rmq and rmq[1] else ("plain", v["rmp"])
        return (rows_sig, bool(sig[10] & 32), slots.shape[0] - 1, runs,
                ramps, [v[("tbase", i)] for i in range(len(rows_sig))],
                self._ptabs, slots)

    def _expand(self, sig, v, slots):
        """The oscillator half of a body: ``expand.expand_call`` decodes
        the runs (the packed format where the signature has it), expands
        them into rows and adds the class-0 rows into ``slots`` int32
        [ninst*F+1, 2, 64] in place; each pass class's rows then go
        through ``osc_slots_call``, which adds them into the slots."""
        rows_sig, rpad, quality = sig[4], sig[5], sig[10]
        if not (rpad and any(NB for _, NB in rows_sig)):
            return
        mono = bool(quality & 32)
        classes, slot_r = EX.expand_call(*self._expand_args(sig, v, slots))
        for cls, tb, par, b0 in classes:
            OK.osc_slots_call(cls, tb, par, self._atlas_dev, slots,
                              slot_r[b0:b0 + par.shape[1]],
                              quality=quality & 15, fused_pm=True,
                              mono=mono)

    def _tail(self, sig, v, st, slots, master):
        """The stage half of a body: the stash adds, the stage items in
        execution order (filter / fm lanes following their unit serials
        through ``fperm``), and the master slice into ``master``.  Reads
        the stash and item tables of v, advances st in place."""
        (F, ninst, minst, mch, rows_sig, rpad, ns, nsm, ramppad,
         readback, quality, items, rmq) = sig
        nslot = slots.shape[0]
        if ns:
            slots.view(nslot, 2 * FRAG).index_add_(
                0, v["sas"].to(torch.int64), v["sa"].view(ns, 2 * FRAG))
        if nsm:
            slots[:, 0].index_add_(0, v["sms"].to(torch.int64), v["sm"])
        fi = li = pj = 0
        for j, (tag, key, extra) in enumerate(items):
            if tag == "stage":
                K, G = extra
                if G:
                    _apply_stage_dense(slots, key,
                                       v[("itd", j)].to(torch.int64), F)
                if K:
                    _apply_stage(slots, key, v[("it", j)].to(torch.int64))
            elif tag == "fbd":
                ring = st.rings[fi]
                arr = v[("it", j)]
                fsig = (extra[1], extra[2], extra[3], extra[4])
                if extra[5]:
                    ring.copy_(FB.apply_fbdelay_dense(
                        slots, fsig + tuple(extra[6:9]), arr, ring, F))
                else:
                    FB.apply_fbdelay(slots, fsig, arr, ring,
                                     v["fbdpos"][fi:fi + 1].to(torch.int64))
                fi += 1
            else:
                kind = key[2]
                K = extra[1]
                state = st.filt[li]
                # lanes follow the unit serials: the previous superblock's
                # lane, or the initial state (-1)
                pm = v["fperm"][pj:pj + K].to(torch.int64)
                fresh = (pm < 0).view((K,) + (1,) * (state.dim() - 1))
                state.copy_(torch.where(
                    fresh, torch.full_like(state, _FILT_INIT[kind]),
                    state[pm.clamp(min=0)]))
                arr = v[("it", j)]
                if kind == "fm":
                    FM.fm_call(slots, (key[3], key[4], key[5][0]), arr,
                               state, self._sine, v[("fgrp", j)])
                elif quality & 16 and extra[2]:
                    # the float tier, where the class is eligible
                    FF.filter_float_call(slots, kind, key[3:8], arr, state)
                else:
                    FL.filter_call(slots, kind, key[3:8], arr, state,
                                   v[("fgrp", j)])
                li += 1
                pj += K
        m = slots[minst * F:(minst + 1) * F, :mch]
        if readback == "i16":
            m = torch.clamp(m >> 8, -32768, 32767).to(torch.int16)
        master.copy_(m)

    # ---- host side of a dispatch ----

    def _pids(self, prog):
        """The persistent-state ids a padded program binds, in the state
        set's order: [("ring", unit id), ...] + [("filt", (ns, key))]."""
        ns = getattr(prog, "ns", 0)
        out = []
        for tag, key, it in stage_items(prog):
            if tag == "fbd":
                out.append(("ring", it["unit_id"]))
            elif tag == "filt":
                out.append(("filt", (ns, key)))
        rings = [p for p in out if p[0] == "ring"]
        return rings + [p for p in out if p[0] == "filt"]

    def _prepare(self, prog, rows=True):
        """All host work of one superblock: pads the program, takes its
        signature (``rowless`` when `rows` is false: the sharded render's
        stage half, whose shards upload the rows), brings its stream's persistent state into the
        signature's format (a dense <-> legacy ring conversion; filter
        state grown to the padded K), advances the host-side state (ring
        positions, lane serials) and fills the numpy upload blob,
        including the filter lane permutation (previous lane or -1) and
        each filter / fm item's step groups; packs the runmat and
        rampmat where the signature says so, raising ``Unsupported``
        before any state moves when a value is outside the format's
        tables.  Returns (sig, blob, pids, (frag sizes, channels)).
        Device work here (state conversions) runs on the caller's
        stream."""
        self._ensure_static()
        self._repad(prog)
        sig = self._signature(prog)
        if not rows:
            sig = rowless(sig)
        ns_ = getattr(prog, "ns", 0)
        layout, total = blob_layout(sig)
        blob = np.zeros(total, np.int32)

        def put(name, a):
            pos, shape = layout[name]
            a = np.asarray(a)
            blob[pos:pos + a.size] = a.ravel().astype(np.int32, copy=False)

        for i, (_, _, tb) in enumerate(prog.class_blocks if sig[4] else ()):
            put(("tbase", i), tb)
        rmq = sig[12]
        try:
            if sig[5]:
                if rmq:
                    put("rmq", PK._rmq_pack(prog.runmat,
                                            self._rmq["tables"]))
                    for j, t in enumerate(self._rmq["tables"]):
                        put(("rmt", j), t)
                else:
                    put("rm", prog.runmat)
            if sig[8]:
                if rmq and rmq[1]:
                    put("rqr", PK._rqr_pack(prog.rampmat,
                                            self._rmq["rtables"]))
                    for j, t in enumerate(self._rmq["rtables"]):
                        put(("rqt", j), t)
                else:
                    put("rmp", prog.rampmat)
        except ValueError as e:
            # a value outside the profiled tables: content this mixer's
            # format cannot express (the renderer bridges natively)
            raise Unsupported(str(e)) from e
        if sig[6]:
            put("sa", prog.stash_audio)
            put("sas", prog.stash_slot)
        if sig[7]:
            put("sm", prog.stash_mono)
            put("sms", prog.stash_mono_slot)
        fbd_pos = []
        perm = []
        for j, (tag, key, ob) in enumerate(stage_items(prog)):
            if tag == "stage":
                if ob["arr"].shape[0]:
                    put(("it", j), ob["arr"])
                if ob["dense"].shape[0]:
                    put(("itd", j), ob["dense"])
                continue
            put(("it", j), ob["arr"])
            if tag == "fbd":
                uid = ob["unit_id"]
                dense = bool(ob["dense"])
                want = FB.FBD_TAIL if dense else FB.FBD_BUFSIZE
                ring = self._rings.get(uid)
                if ring is None:
                    ring = [torch.zeros((2, want), dtype=torch.int32,
                                        device=self.device), 0]
                    self._rings[uid] = ring
                elif ring[0].shape[1] != want:
                    # dense <-> legacy state conversion (at most once per
                    # song, when the sticky dense flag settles): both
                    # hold the last samples, dense time-ordered, legacy
                    # ending at position - 1
                    cur = ring[0]
                    if dense:
                        pos = ring[1] & (FB.FBD_BUFSIZE - 1)
                        idx = (pos - FB.FBD_TAIL + torch.arange(
                            FB.FBD_TAIL, device=self.device)) \
                            % FB.FBD_BUFSIZE
                        ring[0] = cur[:, idx].contiguous()
                    else:
                        full = torch.zeros((2, FB.FBD_BUFSIZE),
                                           dtype=torch.int32,
                                           device=self.device)
                        full[:, FB.FBD_BUFSIZE - FB.FBD_TAIL:] = cur
                        ring[0] = full
                    ring[1] = 0
                fbd_pos.append(ring[1] & (FB.FBD_BUFSIZE - 1))
                if not dense:
                    ring[1] = (ring[1] + int(ob["arr"][:, 5].sum())) \
                        % FB.FBD_BUFSIZE
            else:
                kind = ob["kind"]
                K = ob["arr"].shape[1]
                cur = list(ob["serials"])
                cur += [None] * (K - len(cur))
                ck = (ns_, key)
                ent = self._filt.get(ck)
                if ent is None:
                    ent = [FL.init_state(kind, K, self.device), []]
                    self._filt[ck] = ent
                elif ent[0].shape[0] != K:
                    init = FL.init_state(kind, K, self.device)
                    ent[0] = torch.cat([ent[0][:K],
                                        init[ent[0].shape[0]:]], dim=0)
                prev = {}
                for i, s in enumerate(ent[1]):
                    prev.setdefault(s, i)
                perm.extend(prev.get(s, -1) if s is not None else -1
                            for s in cur)
                ent[1] = cur
                sg = (key[3], key[4], key[5][0]) if kind == "fm" \
                    else key[3:8]
                grp = FM.groups(ob["arr"], sg) if kind == "fm" \
                    else FL.groups(ob["arr"], sg)
                put(("fgrp", j), FL.pack_bounds(grp, ob["arr"].shape[0]))
        if fbd_pos:
            put("fbdpos", fbd_pos)
        if perm:
            put("fperm", perm)
        return sig, blob, self._pids(prog), \
            (list(prog.frag_sizes), prog.master_channels)

    def _bind(self, st, pids):
        """Points each persistent state of `pids` at its buffer in the
        state set `st`; copies it in where another state sits there
        (whose holder then gets a copy of its own first)."""
        idx = {"ring": 0, "filt": 0}
        for kind, pid in pids:
            i = idx[kind]
            idx[kind] += 1
            store = self._rings if kind == "ring" else self._filt
            buf = (st.rings if kind == "ring" else st.filt)[i]
            ent = store[pid]
            if ent[0] is buf:
                continue
            owner = st.owners[kind][i]
            if owner is not None:
                old = store.get(owner)
                if old is not None and old[0] is buf:
                    old[0] = buf.clone()
            buf.copy_(ent[0])
            ent[0] = buf
            st.owners[kind][i] = pid

    # ---- entries and graphs ----

    def _entry(self, table, key, sigs, chain, capture=False):
        """The dispatch unit of `key` in `table` (``_fns`` or
        ``_chain_fns``), made on first use, and made again when the atlas
        it read has been replaced.  On the card its CUDA graph is
        captured when `capture` is set (``precompile``) or when the unit
        is used again: a unit's first dispatch runs its bodies eagerly,
        since a capture costs more than one eager run and a signature
        that never recurs (a synchronous render's pow2 shapes) would not
        repay it.  Returns (entry, whether it was made or captured)."""
        e = table.get(key)
        made = e is None or e.atlas_ver != self._atlas_ver
        if made:
            e = _Entry(self, sigs, chain)
            table[key] = e
        if self.device.type == "cuda" and e.graph is None \
                and (capture or not made):
            self._capture(e)
            return e, True
        return e, made

    def _capture(self, e):
        """Captures the entry's bodies as one CUDA graph.  Capturing
        launches nothing: the wrappers count this thread's launches into
        the entry (``build.captured_launches``), to be added at each
        launch of the graph, while other threads' launches count as
        they happen.  ``capture_log`` keeps each capture's host seconds:
        running the bodies under capture, and ending it (instantiating
        the graph)."""
        t0 = time.perf_counter()
        g = torch.cuda.CUDAGraph()
        cs = self._gstream
        cs.wait_stream(self._cstream)
        with _CAPTURE_LOCK, build.captured_launches() as counts, \
                torch.cuda.stream(cs):
            g.capture_begin(pool=self._pool, capture_error_mode="relaxed")
            try:
                e.run(self)
            finally:
                t1 = time.perf_counter()
                g.capture_end()
        self._cstream.wait_stream(cs)
        t2 = time.perf_counter()
        e.graph = g
        e.launches = counts
        self.captures += 1
        self.capture_s += t2 - t0
        self.capture_log.append({"bodies": len(e.sigs), "run_s": t1 - t0,
                                 "end_s": t2 - t1})

    def _pinned_get(self, shape, dtype):
        with self._pin_lock:
            free = self._pinned.get((shape, dtype))
            if free:
                return free.pop()
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def _pinned_put(self, t):
        with self._pin_lock:
            self._pinned.setdefault((tuple(t.shape), t.dtype), []).append(t)

    def _launch(self, e, blobs, pidss, metas):
        """Uploads the blobs of an entry's bodies, binds their streams'
        state and runs the entry: on the card one graph replay, or the
        bodies eagerly at the entry's first use (the upload on the
        upload stream from pinned memory, the compute stream waiting on
        it; each master then copied to pinned host memory on the
        compute stream and recorded by an event), the bodies eagerly on
        the CPU.  Returns one fetch handle per
        body."""
        if self.device.type != "cuda":
            for (o, n), b in zip(e.offs, blobs):
                e.blob[o:o + n] = torch.from_numpy(b)
            for st, pids in zip(e.states, pidss):
                self._bind(st, pids)
            e.run(self)
            return [("cpu", m.clone(), meta)
                    for m, meta in zip(e.masters, metas)]
        k = e.k
        e.k ^= 1
        if e.stage_ev[k] is not None:
            e.stage_ev[k].synchronize()      # its last upload has left
        host = e.stage[k].numpy()
        for (o, n), b in zip(e.offs, blobs):
            host[o:o + n] = b
        up = torch.cuda.Event()
        with torch.cuda.stream(self._ustream):
            # the last run has read the device blob
            self._ustream.wait_event(e.free_ev)
            e.blob.copy_(e.stage[k], non_blocking=True)
            up.record(self._ustream)
        e.stage_ev[k] = up
        self._cstream.wait_event(up)
        for st, pids in zip(e.states, pidss):
            self._bind(st, pids)
        if self.time_device:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record(self._cstream)
        if e.graph is None:
            e.run(self)              # first use: eager launches
        else:
            e.graph.replay()
            build.add_launches(e.launches)
            self.replays += 1
        if self.time_device:
            t1.record(self._cstream)
            self._dev_events.append((t0, t1))
        e.free_ev.record(self._cstream)
        handles = []
        for m, meta in zip(e.masters, metas):
            out = self._pinned_get(tuple(m.shape), m.dtype)
            out.copy_(m, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._cstream)
            handles.append(("cuda", (ev, out), meta))
        return handles

    def _locked(self, fn, *args):
        self._ensure_static()
        if self.transfer_lock is None:
            with self._stream():
                return fn(*args)
        with self.transfer_lock, self._stream():
            return fn(*args)

    # ---- dispatch API (the JAX mixer's) ----

    def run(self, prog):
        """Returns master audio int32 [channels][frames] (numpy)."""
        return self.fetch(self.dispatch(prog))

    def dispatch(self, prog):
        """Dispatches one superblock asynchronously; returns a handle for
        ``fetch``.  The first dispatch of a signature runs its body
        eagerly and the next captures its graph (``precompile`` captures
        it ahead)."""
        return self._locked(self._dispatch, prog)

    def _dispatch(self, prog):
        sig, blob, pids, meta = self._prepare(prog)
        e, _ = self._entry(self._fns, sig, [sig], True)
        return self._launch(e, [blob], [pids], [meta])[0]

    def precompile(self, prog):
        """Captures this program's signature from its shapes alone (no
        data moves, no state changes) before a render needs it.
        Returns True if a capture (on the CPU: the static buffers)
        happened."""
        def go():
            self._ensure_static()
            self._repad(prog)
            sig = self._signature(prog)
            return self._entry(self._fns, sig, [sig], True, True)[1]
        return self._locked(go)

    def dispatch_chain(self, progs):
        """ONE graph launch for n consecutive superblocks of one stream,
        their state threaded in place from each to the next.  Needs
        every program to share one signature and one state population
        (true for a profiled song in steady state); dispatches them one
        by one otherwise.  Returns the fetch handles in order."""
        return self._locked(self._dispatch_chain, progs)

    def _dispatch_chain(self, progs):
        if len(progs) == 1:
            return [self._dispatch(progs[0])]
        self._ensure_static()
        sigs = []
        for p in progs:
            self._repad(p)
            sigs.append(self._signature(p))
        pids = self._pids(progs[0])
        if any(s != sigs[0] for s in sigs) \
                or any(self._pids(p) != pids for p in progs[1:]):
            return [self._dispatch(p) for p in progs]
        preps = [self._prepare(p) for p in progs]
        e, _ = self._entry(self._chain_fns, ("chain", sigs[0], len(progs)),
                           sigs, True)
        return self._launch(e, [pr[1] for pr in preps], [pids],
                            [pr[3] for pr in preps])

    def precompile_chain(self, prog, n):
        """Captures the n-superblock chain of this program's signature
        (the solo counterpart of ``precompile_many``)."""
        def go():
            self._ensure_static()
            self._repad(prog)
            sig = self._signature(prog)
            return self._entry(self._chain_fns, ("chain", sig, n),
                               [sig] * n, True, True)[1]
        return self._locked(go)

    def dispatch_many(self, progs):
        """ONE graph launch for a batch of superblocks of state-disjoint
        streams (one per stream of a multiplexed fleet), each with its
        own state.  Returns a fetch handle per program."""
        return self._locked(self._dispatch_many, progs)

    def _dispatch_many(self, progs):
        if len(progs) == 1:
            return [self._dispatch(progs[0])]
        self._ensure_static()
        for p in progs:
            self._repad(p)
        allp = [pid for p in progs for pid in self._pids(p)]
        if len(set(allp)) != len(allp):
            return [self._dispatch(p) for p in progs]
        preps = [self._prepare(p) for p in progs]
        sigs = tuple(pr[0] for pr in preps)
        e, _ = self._entry(self._chain_fns, ("many", sigs), list(sigs),
                           False)
        return self._launch(e, [pr[1] for pr in preps],
                            [pr[2] for pr in preps],
                            [pr[3] for pr in preps])

    def precompile_many(self, progs):
        """Captures the batch of these programs' signatures (a serving
        fleet's, before its window opens).  Returns True if a capture
        happened."""
        def go():
            self._ensure_static()
            for p in progs:
                self._repad(p)
            sigs = tuple(self._signature(p) for p in progs)
            if len(progs) < 2:
                return False
            return self._entry(self._chain_fns, ("many", sigs),
                               list(sigs), False, True)[1]
        return self._locked(go)

    def fetch(self, handle):
        """Waits for a dispatched superblock's master and returns it as
        [channels][frames] int32 numpy."""
        where, res, (frag_sizes, mch) = handle
        if where == "cpu":
            out = res.numpy()
        else:
            ev, host = res
            ev.synchronize()
            if self.transfer_lock is not None:
                with self.transfer_lock:
                    out = host.numpy().copy()
            else:
                out = host.numpy().copy()
            self._pinned_put(host)
        if out.dtype == np.int16:
            # the int32 8:24 contract from the 16-bit conversion
            out = out.astype(np.int32) << 8
        total = sum(frag_sizes)
        if total == len(frag_sizes) * FRAG:
            flat = out.transpose(1, 0, 2).reshape(mch, total)
            return [flat[ch] for ch in range(mch)]
        bufs = []
        for ch in range(mch):
            b = np.empty(total, np.int32)
            pos = 0
            for fi, nfr in enumerate(frag_sizes):
                b[pos:pos + nfr] = out[fi, ch, :nfr]
                pos += nfr
            bufs.append(b)
        return bufs

    def device_seconds(self):
        """Device seconds of the graph launches timed since the last
        call (``time_device``); waits for them to finish."""
        ev, self._dev_events = self._dev_events, []
        total = 0.0
        for t0, t1 in ev:
            t1.synchronize()
            total += t0.elapsed_time(t1) * 1e-3
        return total

    def reset_instance(self, unit_id):
        """Drops an fbdelay instance's ring: its next superblock starts
        from silence."""
        self._rings.pop(unit_id, None)
