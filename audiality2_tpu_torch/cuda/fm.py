"""fm stage items (fm1 ... fm4r): the CUDA kernel, its wrapper and its
plain PyTorch version.

Port of the JAX package's ``_apply_fm`` and ``_fm_sine_table``
(``audiality2_tpu/tpu/superblock.py``; reference fm.c fm_process).  An
item holds K instances of one operator structure, given by its
structkey: nops = (sk >> 8) & 15 operators, parallel = (sk >> 4) & 15
(0 serial chain, 1 ops 1.. summed into op 0, 2 ring-modulated pairs),
osbits = (sk >> 1) & 7 (1 << osbits oversampled steps per sample).
Table ``arr`` int32 [S, K, 27]: destination slot, offset, frames and
per op (phase, dphase, amp, amp delta, feedback, feedback delta), all
fragment-frame-0 normalised.  State ``[K, 4]`` int32 is each op's last
output, which feeds back into its own phase through
``(last * fb) >> 17``.

``fm_call`` runs the kernel in ``csrc/fm_kernel.cu`` for CUDA tensors,
one step group (``stage_groups.py``) at a time, and ``fm_torch`` (a
loop over slices and samples on [K] tensors, step by step) for CPU
tensors.  Unlike the pure JAX function both update ``slots`` and
``state`` in place.
"""

import ctypes

import numpy as np
import torch

from ..constants import A2_MAXFRAG
from ..units.host_units import _fm_sine
from . import build
from .filter import (active_samples, device_bounds, sample_windows,
                     seeded_layout, tile_steps)
from .stage_groups import step_groups
from .osc_kernel import _w

FRAG = A2_MAXFRAG
_M32 = 0xFFFFFFFF
WPMASK = (2048 << 8) - 1
# the eight structures the native record emits (fm1, fm2, fm2r, fm3,
# fm3p, fm4, fm4p, fm4r)
STRUCTKEYS = (256, 514, 546, 772, 788, 1028, 1044, 1060)


def structure(structkey):
    """(nops, parallel, osbits) of a structkey."""
    return ((structkey >> 8) & 0xF, (structkey >> 4) & 0xF,
            (structkey >> 1) & 0x7)


def sine_pairs():
    """The 2048-entry paired sine table sine[k+1] << 16 | u16(sine[k]),
    int32 numpy."""
    t = _fm_sine().astype(np.int64)          # 2049 entries
    return (((t[1:] & 0xFFFF) << 16) | (t[:-1] & 0xFFFF)).astype(np.int32)


def fm_torch(slots, sig, arr, state, sine):
    """Plain version.  sig: (structkey, add, dch); arr int32 [S, K, 27];
    state int32 [K, 4]; sine int32 [2048] (``sine_pairs``).  Updates
    slots and state in place; returns state."""
    structkey, add, dch = sig
    nops, parallel, osbits = structure(structkey)
    a = arr.to(torch.int64)
    K = a.shape[1]
    dev = slots.device
    n = torch.arange(FRAG, dtype=torch.int64, device=dev)[None, :]
    pr = sine.to(torch.int64)
    s0tab = _w(pr << 16) >> 16
    dtab = (pr >> 16) - s0tab
    last = [state[:, i].to(torch.int64) for i in range(4)]
    for s, (lo, hi) in enumerate(sample_windows(arr, 1)):
        if lo >= hi:
            continue
        ax = a[s]
        off = ax[:, 1:2]
        msk = (n >= off) & (n < off + ax[:, 2:3])
        full = bool(msk[:, lo:hi].all())
        op = [ax[:, 3 + 6 * i:9 + 6 * i] for i in range(nops)]
        # closed-form per-sample ramps, split into per-sample [K] columns
        avs = [_w(o[:, 2:3] + n * o[:, 3:4]).unbind(1) for o in op]
        fbvs = [_w(o[:, 4:5] + n * o[:, 5:6]).unbind(1) for o in op]
        phs = [((o[:, 0:1] & _M32) + n * (o[:, 1:2] & _M32)) & _M32
               for o in op]
        dphs = [((o[:, 1:2] & _M32) >> osbits) for o in op]
        base = [[(phs[i] + os_ * dphs[i]).unbind(1)
                 for os_ in range(1 << osbits)] for i in range(nops)]
        acts = msk.unbind(1)
        out = torch.zeros((K, FRAG), dtype=torch.int64, device=dev)
        for nn in range(lo, hi):
            cand = list(last[:nops])

            def osc(i, mod, os_):
                # fm.c fm_osc: per-op self-feedback into the phase.  Only
                # bits 5..23 of the phase sum matter, so neither it nor
                # `mod` needs wrapping; |cand| < 2^15 keeps the outputs
                # below 2^30 without a wrap too.
                fb = (cand[i] * fbvs[i][nn]) >> 17
                pw = ((base[i][os_][nn] + mod + fb) >> 5) & WPMASK
                ix = pw >> 8
                cand[i] = s0tab[ix] + ((dtab[ix] * (pw & 0xFF)) >> 8)
                return (cand[i] * avs[i][nn]) >> 16

            vsum = 0
            for os_ in range(1 << osbits):
                if parallel == 2:          # ring-modulated pairs
                    if nops == 2:
                        v0 = osc(0, 0, os_)
                        v1 = osc(1, 0, os_)
                    else:
                        v0 = osc(0, osc(2, 0, os_), os_)
                        v1 = osc(1, osc(3, 0, os_), os_)
                    vsum = vsum + ((v0 * v1) >> 23)
                else:
                    vv = 0
                    for i in range(nops - 1, -1, -1):
                        if i and parallel:
                            vv = vv + osc(i, 0, os_)
                        else:
                            vv = osc(i, vv, os_)
                    vsum = vsum + vv
            out[:, nn] = _w(vsum) >> osbits
            for i in range(nops):
                last[i] = cand[i] if full \
                    else torch.where(acts[nn], cand[i], last[i])
        # emit (REPLACE as add-of-difference)
        d = out if add else _w(out - slots[ax[:, 0], dch].to(torch.int64))
        d = torch.where(msk, d, torch.zeros_like(d))
        slots[:, dch].index_add_(0, ax[:, 0], d.to(torch.int32))
    for i in range(nops):
        state[:, i] = last[i].to(torch.int32)
    return state


# ---------------------------------------------------------------
# the CUDA kernel: bind, launch
# ---------------------------------------------------------------

def _bind(lib):
    lib.a2_fm.restype = ctypes.c_int
    lib.a2_fm.argtypes = (
        [ctypes.c_void_p] * 6                  # slots arr state sine scratch
        #                                        bounds
        + [ctypes.c_int] * 5                   # tmax K structkey add dch
        + [ctypes.c_void_p])                   # stream


def _load():
    return build.load("fm_kernel", _bind)


def groups(arr, sig):
    """Step bounds int32 [G + 1] of the numpy table arr [S, K, 27] of
    an item with signature sig (stage_groups.step_groups: no sources,
    the destination in column 0, frames in 2)."""
    return step_groups(arr, (), (0,), 1, sig[1])


def fm_call(slots, sig, arr, state, sine, bounds=None):
    """One fm item (see fm_torch): the plain version for CPU tensors,
    the kernel for CUDA tensors (``fm_call.launches`` counts its
    launches), which runs the item's step groups ``bounds`` (host step
    bounds, computed from a host copy of arr when not given, or the
    packed table on the card, as ``filter.filter_call`` takes them).
    Updates slots and state in place; returns state."""
    if slots.device.type == "cpu":
        return fm_torch(slots, sig, arr, state, sine)
    structkey, add, dch = sig
    S, K = arr.shape[:2]
    dev = slots.device
    what = "fm_call"
    if dev.type != "cuda" or structkey not in STRUCTKEYS \
            or dch not in (0, 1):
        raise ValueError("%s: device %s, structkey %r, dch %r"
                         % (what, dev, structkey, dch))
    build.check_tensor(slots, what, "slots", torch.int32,
                       (slots.shape[0], 2, FRAG), dev)
    build.check_tensor(arr, what, "arr", torch.int32, (S, K, 27), dev)
    build.check_tensor(state, what, "state", torch.int32, (K, 4), dev)
    build.check_tensor(sine, what, "sine", torch.int32, (2048,), dev)
    if S == 0 or K == 0:
        return state
    bt = device_bounds(bounds, arr, sig, groups, what)
    tmax = tile_steps(S, K)
    scratch = torch.empty((tmax, K, FRAG), dtype=torch.int32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.a2_fm(slots.data_ptr(), arr.data_ptr(), state.data_ptr(),
                        sine.data_ptr(), scratch.data_ptr(), bt.data_ptr(),
                        tmax, K, structkey,
                        int(bool(add)), dch, stream)
    build.launch_check(err, "fm")
    build.count_launch(fm_call)
    return state


fm_call.launches = 0


def seeded_item(rng, structkey, S=16, K=5, nslot=20, layout="shared"):
    """Seeded inputs of one fm item: (slots int32 [nslot, 2, 64], arr
    int32 [S, K, 27], state int32 [K, 4]); destinations laid out as
    ``filter.seeded_layout`` says (which may change nslot)."""
    arr = np.zeros((S, K, 27), np.int64)
    cols, arr[:, :, 1], arr[:, :, 2], nslot = seeded_layout(
        rng, S, K, layout, nslot)
    arr[:, :, 0] = cols[:, :, 2]
    for i in range(4):
        c = 3 + 6 * i
        arr[:, :, c] = rng.integers(-(1 << 31), 1 << 31, (S, K))
        arr[:, :, c + 1] = rng.integers(0, 1 << 29, (S, K))
        arr[:, :, c + 2] = rng.integers(0, 1 << 16, (S, K))
        arr[:, :, c + 3] = rng.integers(-(1 << 8), 1 << 8, (S, K))
        arr[:, :, c + 4] = rng.integers(0, 1 << 16, (S, K))
        arr[:, :, c + 5] = rng.integers(-(1 << 8), 1 << 8, (S, K))
    slots = rng.integers(-(1 << 27), 1 << 27, (nslot, 2, FRAG)) \
        .astype(np.int32)
    state = rng.integers(-32768, 32768, (K, 4)).astype(np.int32)
    return slots, arr.astype(np.int32), state


def ops_per_sample(structkey, add):
    """int32 operations per active sample of one instance, counted by
    hand from csrc/fm_kernel.cu: per op its three ramps (6), per op and
    oversampled step one operator (22: the feedback and amplitude
    64-bit products as 2 each, phase sum, table lerp), per step the
    sum (2), then the shift, the store and the emit."""
    nops, _, osbits = structure(structkey)
    return 6 * nops + (1 << osbits) * (22 * nops + 2) + 4 \
        + (4 if add else 8)


def work(arr, structkey, add):
    """(bytes, int32 ops) of one fm item over the numpy table arr
    [S, K, 27]: the table, the state in and out, each active sample's
    old value (REPLACE) and output."""
    S, K = arr.shape[:2]
    act = active_samples(arr, 1)
    nbytes = 4 * S * K * 27 + 2 * 16 * K + 4 * act * (1 if add else 2)
    return nbytes, act * ops_per_sample(structkey, add)
