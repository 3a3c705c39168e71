"""filter12 / dcblock / limiter stage items: the CUDA kernel, its
wrapper and its plain PyTorch version.

Port of the JAX package's ``_apply_filter`` (``audiality2_tpu/tpu/
superblock.py``; reference filter12.c, dcblock.c, limiter.c:84-131).
An item holds K instances of one filter class, each a per-sample
recurrence over its S slices (table ``arr`` int32 [S, K, 13]: source
slots, destination slots, offset, frames and the unit's parameters);
state is ``[K, 2, 2]`` int32 (d1, d2 per channel) for filter12 and
dcblock and ``[K]`` int64 (the unsigned 32-bit peak) for the limiter.

``filter_call`` runs the kernel in ``csrc/filter_kernel.cu`` for CUDA
tensors, one step group (``stage_groups.py``) at a time (the groups
reach the kernel as a packed int32 table on the card, ``pack_bounds``,
so a CUDA graph can capture the launch), and
``filter_torch`` (a loop over slices and samples on [K] tensors, int64
carrying int32 wrap, step by step) for CPU tensors.  Unlike the pure
JAX function both update ``slots`` and ``state`` in place.
"""

import ctypes

import numpy as np
import torch

from ..constants import A2_MAXFRAG
from . import build
from .osc_kernel import _w
from .stage_groups import step_groups

FRAG = A2_MAXFRAG
_M32 = 0xFFFFFFFF
KINDS = ("f12", "dcb", "lim")
# limiter peak state starts at 32768<<8 (reference limiter.c lim_init)
LIM_PEAK0 = 32768 << 8
# (step, instance) pairs of a kernel's scratch tile: 8 MiB of filter
# scratch, which stays in the card's 50 MB L2
SCRATCH_PAIRS = 16384


def init_state(kind, K, device):
    """A fresh instance's state (the JAX mixer's ``_init_state``)."""
    if kind == "lim":
        return torch.full((K,), LIM_PEAK0, dtype=torch.int64, device=device)
    if kind == "fm":
        return torch.zeros((K, 4), dtype=torch.int32, device=device)
    return torch.zeros((K, 2, 2), dtype=torch.int32, device=device)


def sample_windows(arr, c_off):
    """Per slice step, the sample range [lo, hi) that any instance
    runs (offset in column c_off, frames in c_off+1)."""
    off = arr[:, :, c_off].to(torch.int64)
    end = off + arr[:, :, c_off + 1].to(torch.int64)
    live = end > off
    big = torch.full_like(off, FRAG)
    lo = torch.where(live, off.clamp(0, FRAG), big).min(dim=1).values
    hi = torch.where(live, end.clamp(0, FRAG), 0 * off).max(dim=1).values
    return list(zip(lo.tolist(), hi.tolist()))


def _emit(slots, ax, msk, outs, sig):
    """Adds one slice step's outputs into the slots (REPLACE as
    add-of-difference; channel 1 reads its old values after channel
    0's add, as the JAX emit does)."""
    no, add, dch = sig[1], sig[2], sig[4]
    for c, col, ch in ((0, 2, dch[0]),) + (((1, 3, dch[-1]),)
                                           if no == 2 else ()):
        d = outs[c] if add else _w(outs[c] - slots[ax[:, col], ch]
                                   .to(torch.int64))
        d = torch.where(msk, d, torch.zeros_like(d))
        slots[:, ch].index_add_(0, ax[:, col], d.to(torch.int32))


def filter_torch(slots, kind, sig, arr, state):
    """Plain version.  sig: (ni, no, add, sch, dch); arr int32 [S, K,
    13]; state as the module says.  Updates slots and state in place;
    returns state."""
    ni, no, add, sch, dch = sig
    stereo = ni == 2
    nch = 2 if stereo else 1
    a = arr.to(torch.int64)
    K = a.shape[1]
    n = torch.arange(FRAG, dtype=torch.int64, device=slots.device)[None, :]
    if kind == "lim":
        pk = state.clone()
    else:
        d1 = [state[:, 0, c].to(torch.int64) for c in range(2)]
        d2 = [state[:, 1, c].to(torch.int64) for c in range(2)]
    for s, (lo, hi) in enumerate(sample_windows(arr, 4)):
        if lo >= hi:
            continue
        ax = a[s]
        off = ax[:, 4:5]
        msk = (n >= off) & (n < off + ax[:, 5:6])
        full = bool(msk[:, lo:hi].all())
        acts = msk.unbind(1)
        x0 = slots[ax[:, 0], sch[0]].to(torch.int64)[:, lo:hi]
        x1 = slots[ax[:, 1], sch[-1]].to(torch.int64)[:, lo:hi] \
            if stereo else x0
        outs = [torch.zeros((K, FRAG), dtype=torch.int64,
                            device=slots.device) for _ in range(no)]
        # the serial part runs per sample on [K] columns; what depends
        # only on the inputs and the per-sample results runs vectorised
        # over the slice around it
        if kind == "lim":
            rel = ax[:, 6]
            thr = ax[:, 7] & _M32
            if stereo:
                lp = x0.abs()
                rp = x1.abs()
                pka = torch.maximum(lp, rp)
                pka = (pka + ((pka - (lp - rp).abs()) >> 1)) & _M32
            else:
                pka = x0.abs() & _M32
            pks = []
            for j, pkan in enumerate(pka.unbind(1)):
                dec = ((pk - rel) & _M32).maximum(thr)
                pk2 = torch.where(pkan > pk, pkan, dec)
                pks.append(pk2)
                pk = pk2 if full else torch.where(acts[lo + j], pk2, pk)
            gain = torch.div(32767 << 16,
                             (((torch.stack(pks, 1) + 511) & _M32) >> 9)
                             .clamp(min=1), rounding_mode="trunc")
            o0 = _w((x0 * gain) >> 16)
            o1 = _w((x1 * gain) >> 16) if stereo else torch.zeros_like(o0)
            if no == 2:
                outs[0][:, lo:hi] = o0
                outs[1][:, lo:hi] = o1
            else:
                # stereo-in/mono-out: the later channel wins
                outs[0][:, lo:hi] = o1 if stereo else o0
        else:
            ns = n[:, lo:hi] - off
            if kind == "f12":
                fl = (_w(ax[:, 6:7] + ns * ax[:, 7:8]) >> 12).unbind(1)
                qq = (_w(ax[:, 8:9] + ns * ax[:, 9:10]) >> 12).unbind(1)
            else:
                fc0 = ax[:, 6] >> 12
            for c in range(nch):
                xs = ((x0, x1)[c] >> 5).unbind(1)
                ls, hs, bs = [], [], []
                d1c_, d2c_ = d1[c], d2[c]
                for j in range(hi - lo):
                    t1 = d1c_ >> 4
                    if kind == "f12":
                        l = _w(d2c_ + (_w(fl[j] * t1) >> 8))
                        h = _w(xs[j] - l - (_w(qq[j] * t1) >> 8))
                        b = _w((_w(fl[j] * (h >> 4)) >> 8) + d1c_)
                    else:
                        l = _w(d2c_ + (_w(fc0 * t1) >> 8))
                        h = _w(xs[j] - l - (t1 << 4))
                        b = _w((_w(fc0 * (h >> 4)) >> 8) + d1c_)
                    ls.append(l)
                    hs.append(h)
                    bs.append(b)
                    if full:
                        d1c_, d2c_ = b, l
                    else:
                        d1c_ = torch.where(acts[lo + j], b, d1c_)
                        d2c_ = torch.where(acts[lo + j], l, d2c_)
                d1[c], d2[c] = d1c_, d2c_
                h = torch.stack(hs, 1)
                if kind == "f12":
                    fo = _w(_w(torch.stack(ls, 1) * ax[:, 10:11])
                            + _w(torch.stack(bs, 1) * ax[:, 11:12])
                            + _w(h * ax[:, 12:13])) >> 3
                else:
                    fo = _w(h << 5)
                # stereo-in/mono-out: the later channel wins the output
                outs[min(c, no - 1)][:, lo:hi] = fo
        _emit(slots, ax, msk, outs, sig)
    if kind == "lim":
        state.copy_(pk)
    else:
        for c in range(2):
            state[:, 0, c] = d1[c].to(torch.int32)
            state[:, 1, c] = d2[c].to(torch.int32)
    return state


# ---------------------------------------------------------------
# the CUDA kernel: bind, launch
# ---------------------------------------------------------------

def _bind(lib):
    lib.a2_filter.restype = ctypes.c_int
    lib.a2_filter.argtypes = (
        [ctypes.c_void_p] * 5                  # slots arr state scratch
        #                                        bounds
        + [ctypes.c_int] * 10                  # tmax K kind ni no add
        #                                        sch0 sch1 dch0 dch1
        + [ctypes.c_void_p])                   # stream


def _load():
    return build.load("filter_kernel", _bind)


def groups(arr, sig):
    """Step bounds int32 [G + 1] of the numpy table arr [S, K, 13] of
    an item with signature sig (stage_groups.step_groups: sources in
    columns 0 (and 1 for stereo input), destinations in 2 (and 3 for
    stereo output), frames in 5)."""
    ni, no, add = sig[:3]
    return step_groups(arr, (0, 1)[:ni], (2, 3)[:no], 4, add)


def tile_steps(S, K):
    """Steps per tile of an item of S steps and K instances: at most
    SCRATCH_PAIRS // K (at least 1).  A group longer than that runs in
    several tiles; any cut of a group is a group too."""
    return int(max(1, min(S, SCRATCH_PAIRS // K)))


def pack_bounds(bounds, S):
    """The kernels' step-group table, int32 [S + 2]: the group count G,
    then the G + 1 step bounds (``groups``), then zeros.  Its size
    depends on S alone, so a captured launch reads each superblock's
    groups from the same buffer."""
    b = np.asarray(bounds, np.int32)
    check_bounds(b, S, "pack_bounds")
    out = np.zeros(S + 2, np.int32)
    out[0] = len(b) - 1
    out[1:len(b) + 1] = b
    return out


def device_bounds(bounds, arr, sig, groups_of, what):
    """The packed step-group table on arr's device: ``bounds`` as given
    when it is a tensor there already (``pack_bounds`` layout, written
    by the caller), else packed from host step bounds (computed from a
    host copy of arr when None)."""
    S = arr.shape[0]
    if isinstance(bounds, torch.Tensor):
        if bounds.device != arr.device or bounds.dtype != torch.int32 \
                or bounds.numel() < S + 2:
            raise ValueError("%s: packed bounds must be int32 [S + 2] on "
                             "%s" % (what, arr.device))
        return bounds
    if bounds is None:
        bounds = groups_of(arr.cpu().numpy(), sig)
    return torch.as_tensor(pack_bounds(bounds, S), device=arr.device)


def filter_call(slots, kind, sig, arr, state, bounds=None):
    """One filter12 / dcblock / limiter item (see filter_torch): the
    plain version for CPU tensors, the kernel for CUDA tensors
    (``filter_call.launches`` counts its launches, and
    ``filter_call.kind_launches`` by kind), which runs the
    item's step groups ``bounds``: host step bounds (``groups``;
    computed from a host copy of arr when not given), or the packed
    table (``pack_bounds``) as an int32 tensor on the card, which a
    CUDA graph can capture.  Updates slots and state in place; returns
    state."""
    if slots.device.type == "cpu":
        return filter_torch(slots, kind, sig, arr, state)
    ni, no, add, sch, dch = sig
    S, K = arr.shape[:2]
    dev = slots.device
    what = "filter_call"
    if dev.type != "cuda" or kind not in KINDS or ni not in (1, 2) \
            or no not in (1, 2):
        raise ValueError("%s: device %s, kind %r, ni %r, no %r"
                         % (what, dev, kind, ni, no))
    build.check_tensor(slots, what, "slots", torch.int32,
                       (slots.shape[0], 2, FRAG), dev)
    build.check_tensor(arr, what, "arr", torch.int32, (S, K, 13), dev)
    if kind == "lim":
        build.check_tensor(state, what, "state", torch.int64, (K,), dev)
    else:
        build.check_tensor(state, what, "state", torch.int32, (K, 2, 2),
                           dev)
    if S == 0 or K == 0:
        return state
    bt = device_bounds(bounds, arr, sig, groups, what)
    tmax = tile_steps(S, K)
    scratch = torch.empty((tmax, K, 2, FRAG), dtype=torch.int32,
                          device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.a2_filter(slots.data_ptr(), arr.data_ptr(),
                            state.data_ptr(), scratch.data_ptr(),
                            bt.data_ptr(), tmax, K,
                            KINDS.index(kind), ni, no, int(bool(add)),
                            sch[0], sch[-1], dch[0], dch[-1], stream)
    build.launch_check(err, "filter")
    build.count_launch(filter_call, kind)
    return state


def check_bounds(bounds, S, what):
    """Raises unless bounds are step bounds 0 = b0 < b1 < ... = S."""
    b = np.asarray(bounds)
    if b.ndim != 1 or len(b) < 2 or b[0] != 0 or b[-1] != S \
            or (np.diff(b) <= 0).any():
        raise ValueError("%s: bad step group bounds for S=%d: %s"
                         % (what, S, b))


filter_call.launches = 0
# the same launches by kind (a dict that callers may zero with launches)
filter_call.kind_launches = dict.fromkeys(KINDS, 0)


def seeded_slices(rng, S, K):
    """Offsets and frames of a seeded [S, K] slice table: most slices
    whole, some partial (off > 0 or frames < 64), and each instance
    ends in a random number of padding slices (frames 0).  Returns
    (off, frames, padding mask), int64 [S, K]."""
    off = np.where(rng.random((S, K)) < 0.2, rng.integers(1, 48, (S, K)),
                   0)
    frm = np.where(rng.random((S, K)) < 0.2,
                   rng.integers(1, 64 - off + 1), 64 - off)
    last = rng.integers(S // 2, S + 1, K)
    pad = np.arange(S)[:, None] >= last[None, :]
    return off, np.where(pad, 0, frm), pad


# slot layouts of seeded tables (seeded_layout)
LAYOUTS = ("shared", "free", "split")


def seeded_layout(rng, S, K, layout="shared", nslot=20):
    """Slot columns (source 0, source 1, destination 0, destination 1)
    int64 [S, K, 4], offsets, frames and the slot count of a seeded
    [S, K] slice table.  "shared": slots drawn from few values, so
    instances share destinations and step groups break often; "free":
    every slice reads and writes slots of its own, so one step group
    spans the table; "split": each instance runs in place (sources =
    destinations) over consecutive fragments, each cut into 1-3
    slices, whose windows do not overlap (one group too, which a test
    per slot alone would cut at every split).  Padding slices
    (frames 0, at each instance's end) carry the dead slot (the last)
    as their destinations."""
    if layout == "shared":
        cols = rng.integers(0, min(nslot - 1, 2 * K), (S, K, 4))
        off, frm, pad = seeded_slices(rng, S, K)
    elif layout == "free":
        cols = np.arange(4 * S * K).reshape(4, S, K).transpose(1, 2, 0)
        nslot = 4 * S * K + 1
        off, frm, pad = seeded_slices(rng, S, K)
    elif layout == "split":
        off = np.zeros((S, K), np.int64)
        frm = np.zeros((S, K), np.int64)
        frag = np.zeros((S, K), np.int64)
        for k in range(K):
            s = f = 0
            while s < S:
                cuts = np.sort(rng.choice(np.arange(1, FRAG),
                                          rng.integers(0, 3),
                                          replace=False))
                edges = [0] + cuts.tolist() + [FRAG]
                for a, b in zip(edges, edges[1:]):
                    if s < S:
                        off[s, k], frm[s, k], frag[s, k] = a, b - a, f
                        s += 1
                f += 1
        slot = np.arange(K)[None, :] * S + frag
        cols = np.repeat(slot[:, :, None], 4, axis=2)
        nslot = K * S + 1
        last = rng.integers(S // 2, S + 1, K)
        pad = np.arange(S)[:, None] >= last[None, :]
        frm = np.where(pad, 0, frm)
    else:
        raise ValueError("layout %r" % layout)
    cols[:, :, 2:4][pad] = nslot - 1
    return cols, off, frm, nslot


def seeded_item(rng, kind, ni, no, S=24, K=6, nslot=20, layout="shared"):
    """Seeded inputs of one filter item: (slots int32 [nslot, 2, 64],
    arr int32 [S, K, 13], state), slots laid out as seeded_layout
    says (which may change nslot)."""
    arr = np.zeros((S, K, 13), np.int64)
    arr[:, :, :4], arr[:, :, 4], arr[:, :, 5], nslot = seeded_layout(
        rng, S, K, layout, nslot)
    if kind == "f12":
        arr[:, :, 6] = rng.integers(1 << 12, 1 << 16, (S, K)) << 4
        arr[:, :, 7] = rng.integers(-(1 << 10), 1 << 10, (S, K))
        arr[:, :, 8] = rng.integers(1 << 12, 1 << 17, (S, K))
        arr[:, :, 9] = rng.integers(-(1 << 8), 1 << 8, (S, K))
        arr[:, :, 10:13] = rng.integers(-(1 << 16), 1 << 16, (S, K, 3))
    elif kind == "dcb":
        arr[:, :, 6] = rng.integers(1 << 12, 1 << 22, (S, K))
    else:
        arr[:, :, 6] = rng.integers(0, 1 << 18, (S, K))
        arr[:, :, 7] = rng.integers(0, 1 << 25, (S, K))
    slots = rng.integers(-(1 << 27), 1 << 27, (nslot, 2, FRAG)) \
        .astype(np.int32)
    if kind == "lim":
        state = rng.integers(0, 1 << 32, K).astype(np.int64)
    else:
        state = rng.integers(-(1 << 26), 1 << 26, (K, 2, 2)) \
            .astype(np.int32)
    return slots, arr.astype(np.int32), state


def active_samples(arr, c_off):
    """Samples inside the [off, off+frames) windows of a numpy slice
    table (offset in column c_off, frames in c_off + 1)."""
    off = arr[..., c_off].astype(np.int64)
    lo = np.clip(off, 0, FRAG)
    hi = np.clip(off + arr[..., c_off + 1], 0, FRAG)
    return int(np.maximum(hi - lo, 0).sum())


def ops_per_sample(kind, ni, no, add):
    """int32 operations per active sample of one instance, counted by
    hand from csrc/filter_kernel.cu (a 64-bit product as 2, the 32-bit
    division as 20), the emit included (old value and subtraction for
    REPLACE, the atomic add, their loops)."""
    nch = 2 if ni == 2 else 1
    if kind == "f12":
        ops = 7 + 27 * nch
    elif kind == "dcb":
        ops = 3 + 19 * nch
    else:
        ops = 46 + 4 * (nch - 1)
    return ops + no * (4 + (0 if add else 4))


def work(arr, kind, ni, no, add):
    """(bytes, int32 ops) of one filter item over the numpy table arr
    [S, K, 13]: the table, the state in and out, each active sample's
    inputs, old values (REPLACE) and outputs."""
    S, K = arr.shape[:2]
    act = active_samples(arr, 4)
    nch = 2 if ni == 2 else 1
    state = K * (8 if kind == "lim" else 16)
    nbytes = 4 * S * K * 13 + 2 * state \
        + 4 * act * (nch + no * (1 if add else 2))
    return nbytes, act * ops_per_sample(kind, ni, no, add)
