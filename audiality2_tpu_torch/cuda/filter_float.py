"""The float stage tier (``stage_mode="float"``) of filter12 / dcblock /
limiter items: the CUDA kernels, their wrapper and their plain PyTorch
version.

Port of the JAX package's ``_apply_filter_float`` (``audiality2_tpu/tpu/
superblock.py``).  The per-sample recurrences of the exact tier
(``filter.py``) become scans: filter12 / dcblock are affine maps of the
(d1, d2) state,

    d1' = (1 - F*(F+Q))*d1 - F*d2 + F*(x/32 + hbias) - cF,
    d2' = F*d1 + d2 - cF,

with the mean-truncation bias terms cF, cQ, hbias of the JAX function,
and the limiter's peak is the max-plus recurrence pk' = max(pk - drop,
mseg).  Inactive samples are identity maps.  Accuracy is the -80 dB
production budget against the exact tier, not bit-exactness; state
stays in the exact tier's format (``filter.init_state``), rounded at
the item's end, so the tiers can be switched per render.

Both versions evaluate the scan in one fixed association order, set by
the tile layout alone, so that kernel and plain version agree bit for
bit.  Each instance-channel is one sequence of N = S*64 samples
(time-major: sample s*64 + n of slice s), padded with identity maps to
whole tiles of TILE = THREADS * CHUNK samples:

1. every thread folds the maps of its CHUNK consecutive samples left to
   right, and a tile's THREADS chunk maps reduce pairwise in a balanced
   tree (level l+1 node i = level l nodes 2i then 2i+1): the tile's map
   is its root;
2. tile t's entry state is the chain's entry state with the roots of
   tiles 0 .. t-1 applied in order, and the end state that of the last
   tile with its own root applied (``serial_entries`` computes them in
   one pass over the tiles; the kernel, one launch per item, lets each
   tile compute its own, ``tile_entries``: the same operations on the
   same values);
3. each tile walks its tree down from its entry state (a node's left
   child takes its state, the right child the left child's map applied
   to it), then each thread walks its chunk: the outputs come from each
   sample's state before (filter) or after (limiter) its map.

Float operations round one at a time (no contraction into fused
multiply-adds; the kernel uses ``__fmul_rn`` / ``__fadd_rn`` /
``__fdiv_rn``), and outputs and state convert to int32 saturating, as
the JAX package's casts do.  The emit is the exact tier's (REPLACE as
add-of-difference; all inputs gathered before any write; the second
output channel reads its old values after the first one's adds).

``filter_float_call`` runs the kernel of ``csrc/filter_float_kernel.cu``
(one cooperative launch per item) for CUDA tensors,
``filter_float_torch`` for CPU tensors; both update ``slots`` and
``state`` in place.
"""

import ctypes

import torch

from ..constants import A2_MAXFRAG
from . import build
from .filter import KINDS, _emit, active_samples
from .filter import seeded_item as exact_seeded_item
from .filter import work as exact_work
from .osc_kernel import _w

FRAG = A2_MAXFRAG
_M32 = 0xFFFFFFFF
THREADS = 256            # threads of a tile (one block)
CHUNK = 8                # samples of a thread
TILE = THREADS * CHUNK   # samples of a tile
LEVELS = 8               # log2(THREADS): the tile tree's depth
# float32(2^31 - 1), which is 2^31: the JAX tier's clip bound
F_LIM = 2147483648.0
_I32 = (-(1 << 31), (1 << 31) - 1)
_F32 = torch.float32


def sat_i32(v):
    """float32 -> int32 as the JAX tier converts: clipped to +-2^31,
    truncated toward zero, saturating at the int32 range (PyTorch's own
    float -> int32 cast wraps instead)."""
    return v.clamp(-F_LIM, F_LIM).to(torch.int64).clamp(*_I32) \
        .to(torch.int32)


# ---- the maps: affine 2x2 (a00, a01, a10, a11, b0, b1), max-plus (d, m)

def comb_affine(l, r):
    """l, then r."""
    return (r[0] * l[0] + r[1] * l[2], r[0] * l[1] + r[1] * l[3],
            r[2] * l[0] + r[3] * l[2], r[2] * l[1] + r[3] * l[3],
            r[0] * l[4] + r[1] * l[5] + r[4],
            r[2] * l[4] + r[3] * l[5] + r[5])


def apply_affine(m, s):
    return (m[0] * s[0] + m[1] * s[1] + m[4],
            m[2] * s[0] + m[3] * s[1] + m[5])


def comb_maxplus(l, r):
    return (l[0] + r[0], torch.maximum(l[1] - r[0], r[1]))


def apply_maxplus(m, s):
    return (torch.maximum(s[0] - m[0], m[1]),)


def _at(m, idx):
    return tuple(v[idx] for v in m)


def _tree(maps, comb):
    """Every tile's chunk folds and balanced tree: the levels, leaves
    first, each a tuple of [..., T, nodes]; the last level holds the
    tiles' roots.  maps: tuple of float32 tensors [..., T, THREADS,
    CHUNK] (one per map component)."""
    acc = _at(maps, (Ellipsis, 0))
    for j in range(1, CHUNK):
        acc = comb(acc, _at(maps, (Ellipsis, j)))
    levels = [acc]
    for _ in range(LEVELS):
        lv = levels[-1]
        levels.append(comb(_at(lv, (Ellipsis, slice(0, None, 2))),
                           _at(lv, (Ellipsis, slice(1, None, 2)))))
    return levels


def tile_roots(maps, comb):
    """Each tile's map, tuple of [..., T]."""
    return _at(_tree(maps, comb)[-1], (Ellipsis, 0))


def serial_entries(root, s0, apply):
    """Each tile's entry state (tuple of [..., T]) and the end state
    (tuple of [...]), in one pass over the tiles' roots (tuple of [...,
    T]) from the entry states s0 (tuple of [...])."""
    s = tuple(v.clone() for v in s0)
    entry = []
    for t in range(root[0].shape[-1]):
        entry.append(s)
        s = apply(_at(root, (Ellipsis, t)), s)
    return tuple(torch.stack([e[i] for e in entry], -1)
                 for i in range(len(s0))), s


def tile_entries(root, s0, apply):
    """serial_entries as the kernel computes them: tile t applies the
    roots of tiles 0 .. t-1 to s0 itself, in order, and the last tile
    its own root to its entry state for the end state."""
    T = root[0].shape[-1]
    entry = []
    for t in range(T):
        s = tuple(v.clone() for v in s0)
        for u in range(t):
            s = apply(_at(root, (Ellipsis, u)), s)
        entry.append(s)
    return tuple(torch.stack([e[i] for e in entry], -1)
                 for i in range(len(s0))), \
        apply(_at(root, (Ellipsis, T - 1)), entry[-1])


def _scan(maps, s0, comb, apply):
    """The fixed-order scan.  maps: tuple of float32 tensors [..., T,
    THREADS, CHUNK] (one per map component); s0: tuple of [...] entry
    states.  Returns (the pre-state of every sample, tuple of [..., T,
    THREADS, CHUNK]; the end state, tuple of [...])."""
    levels = _tree(maps, comb)
    entry, s = serial_entries(_at(levels[-1], (Ellipsis, 0)), s0, apply)
    st = tuple(v[..., None] for v in entry)         # [..., T, 1]
    for lv in reversed(levels[:-1]):
        left = _at(lv, (Ellipsis, slice(0, None, 2)))
        right = apply(left, st)
        st = tuple(torch.stack([a, b], -1).flatten(-2)
                   for a, b in zip(st, right))
    pre = []
    for j in range(CHUNK):
        pre.append(st)
        st = apply(_at(maps, (Ellipsis, j)), st)
    return tuple(torch.stack([p[i] for p in pre], -1)
                 for i in range(len(s0))), s


def _tiled(v, T):
    """[..., N] -> [..., T, THREADS, CHUNK], padded with zeros."""
    pad = T * TILE - v.shape[-1]
    if pad:
        v = torch.cat([v, v.new_zeros(v.shape[:-1] + (pad,))], -1)
    return v.reshape(v.shape[:-1] + (T, THREADS, CHUNK))


def _time_major(v):
    """[S, K, 64] -> [K, S*64]."""
    S, K = v.shape[:2]
    return v.permute(1, 0, 2).reshape(K, S * FRAG)


def filter_float_torch(slots, kind, sig, arr, state):
    """Plain version.  sig: (ni, no, add, sch, dch); arr int32 [S, K,
    13]; state as ``filter.init_state`` makes it.  Updates slots and
    state in place; returns state."""
    ni, no, add, sch, dch = sig
    stereo = ni == 2
    S, K = arr.shape[:2]
    if S == 0 or K == 0:
        return state
    N = S * FRAG
    T = -(-N // TILE)
    dev = slots.device
    a = arr.to(torch.int64)
    # every input gathered before any write
    x0i = slots[a[:, :, 0], sch[0]]                      # [S, K, 64]
    x1i = slots[a[:, :, 1], sch[-1]] if stereo else x0i
    n = torch.arange(FRAG, dtype=torch.int64, device=dev)
    off = a[:, :, 4:5]
    act = (n >= off) & (n < off + a[:, :, 5:6])

    def tm(v):
        return _tiled(_time_major(v), T)

    actt = tm(act)
    x0f = tm(x0i).to(_F32)
    x1f = tm(x1i).to(_F32) if stereo else x0f

    def col(c):
        return tm(a[:, :, c:c + 1].expand(S, K, FRAG))

    if kind == "lim":
        rel = col(6).to(_F32)
        thr = (col(7) & _M32).to(_F32)
        if stereo:
            lp, rp = x0f.abs(), x1f.abs()
            mx = torch.maximum(lp, rp)
            pka = mx + torch.floor((mx - (lp - rp).abs()) * 0.5)
        else:
            pka = x0f.abs()
        maps = (torch.where(actt, rel, 0.0),
                torch.where(actt, torch.maximum(pka, thr), -1e30))
        pre, (pend,) = _scan(maps, (state.to(_F32),), comb_maxplus,
                             apply_maxplus)
        (pk,) = apply_maxplus(maps, pre)
        # a true division (a Python number over a tensor would take the
        # reciprocal and multiply, which rounds twice)
        den = torch.floor((pk + 511.0) * (1.0 / 512.0)).clamp(min=1.0)
        gain = torch.full_like(den, float(32767 << 16)).div_(den)
        o0 = x0f * gain * (1.0 / 65536.0)
        o1 = x1f * gain * (1.0 / 65536.0) if stereo else None
        if no == 2:
            outs = [o0, o1]
        else:
            outs = [o1 if stereo else o0]
        state.copy_(pend.clamp(min=1.0).to(torch.int64))
    else:
        ns = tm(n.expand(S, K, FRAG)) - col(4)
        if kind == "f12":
            fl = _w(col(6) + ns * col(7)) >> 12
            qq = _w(col(8) + ns * col(9)) >> 12
            F = fl.to(_F32) * (1.0 / 4096.0)
            Q = qq.to(_F32) * (1.0 / 4096.0)
            cF = F * 8.0 + 0.5
            cQ = Q * 8.0 + 0.5
            hbias = -0.5 + cF + cQ
            g = [col(c).to(_F32) for c in (10, 11, 12)]
        else:
            F = (col(6) >> 12).to(_F32) * (1.0 / 4096.0)
            Q = torch.ones_like(F)
            cF = F * 8.0 + 0.5
            hbias = -0.5 + cF + 7.5
        FQ = F * (F + Q)
        nch = 2 if stereo else 1
        outs = [None] * no
        for c in range(nch):
            xc = (x1f if c else x0f) * (1.0 / 32.0)
            maps = (torch.where(actt, 1.0 - FQ, 1.0),
                    torch.where(actt, -F, 0.0),
                    torch.where(actt, F, 0.0),
                    torch.ones_like(F),
                    torch.where(actt, F * (xc + hbias) - cF, 0.0),
                    torch.where(actt, -cF, 0.0))
            s0 = (state[:, 0, c].to(_F32), state[:, 1, c].to(_F32))
            (d1p, d2p), (d1e, d2e) = _scan(maps, s0, comb_affine,
                                           apply_affine)
            l_ = d2p + F * d1p - cF
            h_ = xc + (hbias - cF) - l_ - Q * d1p
            if kind == "f12":
                b_ = d1p + F * h_ - cF
                fo = (l_ * g[0] + b_ * g[1] + h_ * g[2]) * (1.0 / 8.0)
            else:
                fo = h_ * 32.0
            # stereo-in/mono-out: the later channel wins the output
            outs[min(c, no - 1)] = fo
            state[:, 0, c] = sat_i32(torch.round(d1e))
            state[:, 1, c] = sat_i32(torch.round(d2e))
        if nch == 1:
            state[:, :, 1] = 0
    out32 = []
    for o in outs:
        if o is None:
            out32.append(torch.zeros((S, K, FRAG), dtype=torch.int64,
                                     device=dev))
        else:
            v = sat_i32(o).reshape(K, T * TILE)[:, :N]
            out32.append(v.reshape(K, S, FRAG).permute(1, 0, 2)
                         .to(torch.int64))
    _emit(slots, a.reshape(S * K, -1), act.reshape(S * K, FRAG),
          [v.reshape(S * K, FRAG) for v in out32], sig)
    return state


def seeded_item(rng, kind, ni, no, S=24, K=6, nslot=20, layout="shared",
                hot=False):
    """Seeded inputs of one float-tier item, as ``filter.seeded_item``
    makes them but with parameters the float tier takes: filter12
    cutoffs F in [0.02, 0.6] and damping Q in [0.15, 1.5] (at or above
    the mixer's eligibility threshold) and gains of up to +-2 (8.8
    fixed point, as ``program_from_native`` writes lp / bp / hp),
    dcblock cutoffs F in [0.001, 0.1].  hot: filter12 gains of up to
    +-32, which drive outputs of the seeded inputs past the int32 range
    (the emit's saturation)."""
    slots, arr, state = exact_seeded_item(rng, kind, ni, no, S, K, nslot,
                                          layout)
    arr = arr.astype("int64")
    if kind == "f12":
        arr[:, :, 6] = rng.uniform(0.02, 0.6, (S, K)) * (1 << 24)
        arr[:, :, 7] = rng.integers(-(1 << 8), 1 << 8, (S, K))
        arr[:, :, 8] = rng.uniform(0.15, 1.5, (S, K)) * (1 << 24)
        arr[:, :, 9] = rng.integers(-(1 << 8), 1 << 8, (S, K))
        g = 1 << (13 if hot else 9)
        arr[:, :, 10:13] = rng.integers(-g, g, (S, K, 3))
    elif kind == "dcb":
        arr[:, :, 6] = rng.uniform(0.001, 0.1, (S, K)) * (1 << 24)
    return slots, arr.astype("int32"), state


# ---------------------------------------------------------------
# the CUDA kernels: bind, launch
# ---------------------------------------------------------------

def _bind(lib):
    lib.a2_filter_float.restype = ctypes.c_int
    lib.a2_filter_float.argtypes = (
        [ctypes.c_void_p] * 4                  # slots arr state scratch
        + [ctypes.c_int] * 10                  # S K kind ni no add
        #                                        sch0 sch1 dch0 dch1
        + [ctypes.c_void_p])                   # stream
    lib.a2_filter_float_plan.restype = ctypes.c_int
    lib.a2_filter_float_plan.argtypes = (
        [ctypes.c_int] * 6                     # S K kind ni no add
        + [ctypes.c_void_p])                   # out int64 [5]


def _load():
    return build.load("filter_float_kernel", _bind)


def chains(kind, ni):
    """Sequences per instance: one peak for the limiter, one (d1, d2)
    per input channel for filter12 / dcblock."""
    return 1 if kind == "lim" or ni != 2 else 2


def plan(kind, sig, S, K, device):
    """The kernel's launch plan for an item on CUDA `device`:
    {"scratch": floats of scratch, "blocks", "tiles_per_block",
    "shared": whether the tile buffers live in shared memory (else in
    the scratch), "smem_bytes": a block's shared memory}."""
    ni, no, add = sig[:3]
    out = (ctypes.c_int64 * 5)()
    with torch.cuda.device(device):
        err = _load().a2_filter_float_plan(S, K, KINDS.index(kind), ni, no,
                                           int(bool(add)), out)
    build.launch_check(err, "filter_float plan")
    p = dict(zip(("scratch", "blocks", "tiles_per_block", "shared",
                  "smem_bytes"), (int(v) for v in out)))
    p["shared"] = bool(p["shared"])
    return p


def filter_float_call(slots, kind, sig, arr, state):
    """One float-tier filter12 / dcblock / limiter item (see
    filter_float_torch): the plain version for CPU tensors, the kernel
    for CUDA tensors, one cooperative launch per item.
    ``filter_float_call.launches`` counts those launches,
    ``filter_float_call.kind_launches`` the same by kind.
    Updates slots and state in place; returns state."""
    if slots.device.type == "cpu":
        return filter_float_torch(slots, kind, sig, arr, state)
    ni, no, add, sch, dch = sig
    S, K = arr.shape[:2]
    dev = slots.device
    what = "filter_float_call"
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
    scratch = torch.empty(plan(kind, sig, S, K, dev)["scratch"],
                          dtype=_F32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.a2_filter_float(
            slots.data_ptr(), arr.data_ptr(), state.data_ptr(),
            scratch.data_ptr(), S, K, KINDS.index(kind), ni, no,
            int(bool(add)), sch[0], sch[-1], dch[0], dch[-1], stream)
    build.launch_check(err, "filter_float")
    build.count_launch(filter_float_call, kind)
    return state


filter_float_call.launches = 0
# the same launches by kind (a dict that callers may zero with launches)
filter_float_call.kind_launches = dict.fromkeys(KINDS, 0)

# float32 operations of the function per active sample and sequence,
# each counted once, whatever computes them (conversions and clips not
# counted): filter12's terms (x/32, F, Q, cF, cQ, hbias: 9), map (6), one
# map composition (20: the chunk fold and the tree take one per sample),
# the state update (8) and output (17); dcblock's terms (6), map, its
# composition and update (34) and output (9); the stereo limiter's peak
# (9: mono 1), segment maximum (1), composition (3), update (2), gain (5)
# and outputs (2 per channel)
FLOPS_PER_SAMPLE = {"f12": 60, "dcb": 49, "lim": 24, "lim_mono": 14}


def work(arr, kind, ni, no, add):
    """(bytes, float32 ops) of one float-tier item over the numpy table
    arr [S, K, 13]: the bytes as the exact tier's (``filter.work``: the
    table, the state in and out, each active sample's inputs, old values
    and outputs, each once), the ops per active sample and sequence
    (FLOPS_PER_SAMPLE)."""
    nbytes = exact_work(arr, kind, ni, no, add)[0]
    per = FLOPS_PER_SAMPLE["lim_mono" if kind == "lim" and ni != 2
                           else kind]
    return nbytes, active_samples(arr, 4) * chains(kind, ni) * per
