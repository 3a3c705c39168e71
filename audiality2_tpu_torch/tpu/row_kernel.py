"""Row kernel of the batched host engine: the fused wtosc(+panmix)
voice-slice rows of one superblock, evaluated in one call.

Port of ``audiality2_tpu/tpu/row_kernel.py``.  The block engine lowers
every deferred oscillator slice to one control ROW
(``units/deferred.py``); ``RowBatch.evaluate`` turns all rows into

    row -> 64 frames of  hermite-interpolated wavetable  ->  vol/pan

with backends of identical integer semantics (int64, exact mirrors of
the host units' math):
  * ``rows_numpy`` on the host, below ``RowBatch.JAX_MIN_ROWS`` rows or
    when the engine was opened with ``use_jax=False``;
  * the counterpart of the JAX package's jitted ``rows_jax`` on
    ``RowBatch.device`` (the card), or on the device that
    ``row_device`` sets for the calling thread: the CUDA kernel
    (``rows_cuda``, ``cuda/rows.py``) on a CUDA device, its plain
    PyTorch version (``rows_torch``) on any other.

Row layout (int64 unless noted):
  base   atlas offset of d[0] for the chosen mip level
  ph0    48:24 phase at slice start (mip-shifted)
  dph    48:24 per-frame increment
  amp0   8:24 amplitude at slice start,  damp per-frame delta
  haspm  bool: fused panmix stage present
  stereo bool: panmix has 2 outputs
  clamp  bool: panmix over-pan clamping active (panmix.c:119-135)
  vol0/dvol, pan0/dpan : 8:24 panmix ramps

Output: int64[N, 2, 64] per-row audio (ch1 all-zero for mono rows).
"""

import contextlib
import threading

import numpy as np
import torch

from ..cuda import rows as CR

FRAG = 64


def _hermite_np(atlas, pos, x):
    dm1 = atlas[pos - 1].astype(np.int64)
    d0 = atlas[pos].astype(np.int64)
    d1 = atlas[pos + 1].astype(np.int64)
    d2 = atlas[pos + 2].astype(np.int64)
    xx = x << 7
    c = (d1 - dm1) >> 1
    a = (3 * (d0 - d1) + d2 - dm1) >> 1
    b = dm1 - d0 + c - a
    a = (a * xx) >> 15
    a = ((a + b) * xx) >> 15
    return d0 + (((a + c) * xx) >> 15)


def rows_numpy(atlas, base, ph0, dph, amp0, damp, haspm, stereo, clamp,
               vol0, dvol, pan0, dpan):
    n = np.arange(FRAG, dtype=np.int64)
    ph = ph0[:, None] + n[None, :] * dph[:, None]
    ph16 = ph >> 16
    dph16 = (dph >> 16)[:, None]
    p1 = base[:, None] + (ph16 >> 8)
    v1 = _hermite_np(atlas, p1, ph16 & 0xFF)
    ph2 = ph16 + (dph16 >> 1)
    p2 = base[:, None] + (ph2 >> 8)
    v2 = _hermite_np(atlas, p2, ph2 & 0xFF)
    v = v1 + v2
    amp = amp0[:, None] + n[None, :] * damp[:, None]
    osc = (v * amp) >> 17

    vol = vol0[:, None] + n[None, :] * dvol[:, None]
    pan = pan0[:, None] + n[None, :] * dpan[:, None]
    vp = (pan * vol) >> 24
    v0 = vol - vp
    v1g = vol + vp
    lim = vol << 1
    cl = clamp[:, None]
    v0 = np.where(cl, np.minimum(v0, lim), v0)
    v1g = np.where(cl, np.minimum(v1g, lim), v1g)
    mono_pm = (osc * vol) >> 24
    l_pm = (osc * v0) >> 24
    r_pm = (osc * v1g) >> 24

    st = stereo[:, None]
    hp = haspm[:, None]
    ch0 = np.where(hp, np.where(st, l_pm, mono_pm), osc)
    ch1 = np.where(hp & st, r_pm, np.zeros_like(osc))
    return np.stack([ch0, ch1], axis=1)


# the device copies of the last atlas evaluated, by dtype: the WaveAtlas
# object, its version, the device and the tensor (uploaded once per
# version, not per evaluation)
_DEV_ATLAS = {}


def _device_atlas(atlas_obj, dev):
    c = _DEV_ATLAS
    if c.get("atlas") is not atlas_obj or c["version"] \
            != atlas_obj.version or c["device"] != dev:
        c.clear()
        c.update(atlas=atlas_obj, version=atlas_obj.version, device=dev,
                 data=torch.as_tensor(np.asarray(atlas_obj.data,
                                                 np.int32), device=dev))
    return c["data"]


def _device_params(args, dev):
    """The 12 numpy row arrays as one int64 [12, N] tensor on dev (one
    upload)."""
    return torch.as_tensor(np.stack([np.asarray(a, np.int64)
                                     for a in args]), device=dev)


def rows_torch(atlas_obj, *args, device="cuda"):
    """rows_numpy's result for the numpy row arrays `args`, computed
    by the plain PyTorch version (``cuda.rows.rows_plain``) on
    `device`; returns int64 numpy [N, 2, 64].  atlas_obj is a
    WaveAtlas (numpy .data + .version)."""
    dev = _check_device(device)
    return CR.rows_plain(_device_atlas(atlas_obj, dev),
                         _device_params(args, dev)).cpu().numpy()


def rows_cuda(atlas_obj, *args, device="cuda"):
    """rows_torch's result from the CUDA kernel (``cuda.rows.rows_call``)
    on the CUDA device `device`."""
    dev = _check_device(device)
    if dev.type != "cuda":
        raise ValueError("rows_cuda: %s is not a CUDA device" % dev)
    return CR.rows_call(_device_atlas(atlas_obj, dev),
                        _device_params(args, dev)).cpu().numpy()


def _check_device(device):
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "RowBatch: the device row path needs a CUDA device and none "
            "is available; open the engine with use_jax=False to "
            "evaluate rows on the host")
    return dev


# the calling thread's row device (row_device), over RowBatch.device
_thread = threading.local()


def thread_device():
    """The calling thread's row device: ``row_device``'s, else
    ``RowBatch.device``."""
    return getattr(_thread, "device", None) or RowBatch.device


@contextlib.contextmanager
def row_device(device):
    """Inside the block, the calling thread's row batches evaluate on
    `device` (other threads keep ``RowBatch.device``)."""
    prev = getattr(_thread, "device", None)
    _thread.device = device
    try:
        yield
    finally:
        _thread.device = prev


def _next_pow2(n):
    p = 64
    while p < n:
        p <<= 1
    return p


class RowBatch:
    """Accumulates rows during a superblock; evaluated in one call."""

    __slots__ = ("base", "ph0", "dph", "amp0", "damp", "haspm",
                 "stereo", "clamp", "vol0", "dvol", "pan0", "dpan",
                 "n", "wavemip")

    # where rows_torch runs (a class attribute: the copied engine builds
    # its batches itself); tests set "cpu"
    device = "cuda"

    def __init__(self):
        self.base = []
        self.ph0 = []
        self.dph = []
        self.amp0 = []
        self.damp = []
        self.haspm = []
        self.stereo = []
        self.clamp = []
        self.vol0 = []
        self.dvol = []
        self.pan0 = []
        self.dpan = []
        self.wavemip = []        # (wave, mip) per row
        self.n = 0

    def add_osc(self, base, ph0, dph, amp0, damp, wave=None, mip=0):
        self.wavemip.append((wave, mip))
        self.base.append(base)
        self.ph0.append(ph0)
        self.dph.append(dph)
        self.amp0.append(amp0)
        self.damp.append(damp)
        self.haspm.append(False)
        self.stereo.append(False)
        self.clamp.append(False)
        self.vol0.append(0)
        self.dvol.append(0)
        self.pan0.append(0)
        self.dpan.append(0)
        self.n += 1
        return self.n - 1

    def attach_panmix(self, row, vol0, dvol, pan0, dpan, stereo, clamp):
        self.haspm[row] = True
        self.stereo[row] = stereo
        self.clamp[row] = clamp
        self.vol0[row] = vol0
        self.dvol[row] = dvol
        self.pan0[row] = pan0
        self.dpan[row] = dpan

    # Below this row count, the host->device round trip costs more
    # than evaluating the batch in numpy.
    JAX_MIN_ROWS = 8192

    def evaluate(self, atlas_obj, use_jax=True):
        """Returns int64[n, 2, 64] row audio.  atlas_obj is a
        WaveAtlas (numpy data + version for device caching).  use_jax
        (the engine's config name) selects the device path on
        ``thread_device()`` for batches of at least JAX_MIN_ROWS rows:
        the CUDA kernel on a CUDA device, rows_torch on another."""
        if not self.n:
            return np.zeros((0, 2, FRAG), dtype=np.int64)
        if use_jax and self.n < self.JAX_MIN_ROWS:
            use_jax = False
        # Pad to a power of two only for the device path (bucketed
        # shapes); numpy evaluates the exact row count.
        pad = _next_pow2(self.n) if use_jax else self.n

        def arr(x, dt=np.int64):
            a = np.zeros(pad, dtype=dt)
            a[:self.n] = x
            return a

        args = (arr(self.base), arr(self.ph0), arr(self.dph),
                arr(self.amp0), arr(self.damp),
                arr(self.haspm, bool), arr(self.stereo, bool),
                arr(self.clamp, bool),
                arr(self.vol0), arr(self.dvol), arr(self.pan0),
                arr(self.dpan))
        if use_jax:
            dev = thread_device()
            if torch.device(dev).type == "cuda":
                out = rows_cuda(atlas_obj, *args, device=dev)
            else:
                out = rows_torch(atlas_obj, *args, device=dev)
        else:
            out = rows_numpy(atlas_obj.data, *args)
        return out[:self.n]
