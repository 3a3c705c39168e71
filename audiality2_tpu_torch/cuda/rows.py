"""The batched host engine's row batch on the card: the CUDA kernel of
``csrc/rows_kernel.cu``, its wrapper and its plain PyTorch version.

Port of the JAX package's jitted ``rows_jax`` (``audiality2_tpu/tpu/
row_kernel.py``).  A row is one deferred wtosc voice slice
(``units/deferred.py``); per row and frame of 64:

    2x oversampled Hermite of the wave atlas -> (v * amp) >> 17 ->
    fused panmix (mono, stereo, the 2*vol clamp)

in int64 with numpy's wrap-around, as ``tpu.row_kernel.rows_numpy``.
``rows_call`` launches the kernel for CUDA tensors and runs
``rows_plain`` for CPU tensors; ``tpu/row_kernel.py``'s
``RowBatch.evaluate`` reaches it through ``rows_cuda`` on a CUDA device
and keeps ``rows_torch`` (``rows_plain`` on the batch's device) on
every other.
"""

import ctypes

import numpy as np
import torch

from . import build

FRAG = 64
# the row parameters, in the order of rows_numpy's arguments
PARAMS = ("base", "ph0", "dph", "amp0", "damp", "haspm", "stereo", "clamp",
          "vol0", "dvol", "pan0", "dpan")
# int32 ALU operations per row and frame of the kernel, counted by hand
# from csrc/rows_kernel.cu (a 64-bit add, subtract or compare counts 2,
# a 64-bit multiply 4, a 64-bit shift 2): the phase (10), each Hermite
# (4 index wraps and clamps of 6, 4 loads' address math of 2, 27 for
# the polynomial: 2 x 43 with the position), the amplitude product (16),
# the vol / pan ramps and their product (18), the clamp (6), the channel
# products (16) and the selects (4)
OPS_PER_FRAME = 10 + 2 * 43 + 16 + 18 + 6 + 16 + 4


def _hermite(atlas, pos, x):
    dm1 = torch.take(atlas, pos - 1)
    d0 = torch.take(atlas, pos)
    d1 = torch.take(atlas, pos + 1)
    d2 = torch.take(atlas, pos + 2)
    xx = x << 7
    c = (d1 - dm1) >> 1
    a = (3 * (d0 - d1) + d2 - dm1) >> 1
    b = dm1 - d0 + c - a
    a = (a * xx) >> 15
    a = ((a + b) * xx) >> 15
    return d0 + (((a + c) * xx) >> 15)


def rows_plain(atlas, params):
    """rows_numpy with PyTorch: atlas int32 [A], params int64 [12, N]
    (PARAMS order, the flags 0 or 1) -> int64 [N, 2, 64]."""
    atlas = atlas.to(torch.int64)
    (base, ph0, dph, amp0, damp, haspm, stereo, clamp, vol0, dvol, pan0,
     dpan) = params
    n = torch.arange(FRAG, dtype=torch.int64, device=atlas.device)
    ph = ph0[:, None] + n[None, :] * dph[:, None]
    ph16 = ph >> 16
    dph16 = (dph >> 16)[:, None]
    v1 = _hermite(atlas, base[:, None] + (ph16 >> 8), ph16 & 0xFF)
    ph2 = ph16 + (dph16 >> 1)
    v2 = _hermite(atlas, base[:, None] + (ph2 >> 8), ph2 & 0xFF)
    amp = amp0[:, None] + n[None, :] * damp[:, None]
    osc = ((v1 + v2) * amp) >> 17

    vol = vol0[:, None] + n[None, :] * dvol[:, None]
    pan = pan0[:, None] + n[None, :] * dpan[:, None]
    vp = (pan * vol) >> 24
    v0 = vol - vp
    v1g = vol + vp
    lim = vol << 1
    cl = (clamp != 0)[:, None]
    v0 = torch.where(cl, torch.minimum(v0, lim), v0)
    v1g = torch.where(cl, torch.minimum(v1g, lim), v1g)
    mono_pm = (osc * vol) >> 24
    l_pm = (osc * v0) >> 24
    r_pm = (osc * v1g) >> 24

    st = (stereo != 0)[:, None]
    hp = (haspm != 0)[:, None]
    ch0 = torch.where(hp, torch.where(st, l_pm, mono_pm), osc)
    ch1 = torch.where(hp & st, r_pm, torch.zeros_like(osc))
    return torch.stack([ch0, ch1], dim=1)


def _bind(lib):
    lib.a2_rows.restype = ctypes.c_int
    lib.a2_rows.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]


def _load():
    return build.load("rows_kernel", _bind)


def rows_call(atlas, params):
    """The row batch: atlas int32 [A], params int64 [12, N] -> int64
    [N, 2, 64].  CPU tensors take the plain version; CUDA tensors
    launch the kernel (``rows_call.launches`` counts those launches);
    anything else (another device, tensors on two devices, another type
    or layout) raises."""
    what = "rows_call"
    dev = params.device
    if atlas.device != dev or dev.type not in ("cpu", "cuda"):
        raise ValueError("%s: params on %s, atlas on %s: both must be CPU "
                         "or both on one CUDA device"
                         % (what, dev, atlas.device))
    N = params.shape[1] if params.dim() == 2 else -1
    build.check_tensor(params, what, "params", torch.int64,
                       (len(PARAMS), N), dev)
    build.check_tensor(atlas, what, "atlas", torch.int32,
                       (max(atlas.shape[0], 1),), dev)
    if dev.type == "cpu":
        return rows_plain(atlas, params)
    out = torch.empty((N, 2, FRAG), dtype=torch.int64, device=dev)
    if N == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.a2_rows(params.data_ptr(), N, atlas.data_ptr(),
                          atlas.shape[0], out.data_ptr(), stream)
    build.launch_check(err, "rows")
    build.count_launch(rows_call)
    return out


rows_call.launches = 0


def work(N, A):
    """(bytes, int32 ops) of N rows over an atlas of A values: the
    parameters and the atlas read once, the output written once."""
    return 8 * len(PARAMS) * N + 4 * A + 8 * 2 * FRAG * N, \
        OPS_PER_FRAME * FRAG * N


def seeded_rows(rng, n, A=1 << 20):
    """A seeded int32 atlas [A] of 16-bit samples and n rows as an int64
    [12, n] numpy table whose lookups stay inside it: mono, stereo,
    clamped and bare rows; phases up to 2^44 and increments up to 2^32,
    amplitudes and volumes over the int32 range and, in an eighth of the
    rows, far beyond it (the products then wrap, as numpy's do); pans
    up to 2^26 either way (the clamp engages)."""
    atlas = rng.integers(-32768, 32768, A).astype(np.int32)
    span = A // 2
    p = np.zeros((len(PARAMS), n), np.int64)
    p[0] = rng.integers(4, span, n)                        # base
    p[2] = rng.integers(0, 1 << 32, n)                     # dph
    # ph0 + 63 dph stays below (A - base - 8) << 24
    room = ((A - p[0] - 8) << 24) - 64 * p[2]
    p[1] = (rng.random(n) * np.maximum(room, 1)).astype(np.int64)
    p[3] = rng.integers(-(1 << 31), 1 << 31, n)            # amp0
    p[4] = rng.integers(-(1 << 24), 1 << 24, n)            # damp
    p[5] = rng.random(n) < 0.8                             # haspm
    p[6] = rng.random(n) < 0.6                             # stereo
    p[7] = rng.random(n) < 0.4                             # clamp
    p[8] = rng.integers(-(1 << 31), 1 << 31, n)            # vol0
    p[9] = rng.integers(-(1 << 20), 1 << 20, n)            # dvol
    p[10] = rng.integers(-(1 << 26), 1 << 26, n)           # pan0
    p[11] = rng.integers(-(1 << 18), 1 << 18, n)           # dpan
    wild = rng.random(n) < 0.125
    for k in (3, 8):
        p[k] = np.where(wild, rng.integers(-(1 << 62), 1 << 62, n), p[k])
    return atlas, p
