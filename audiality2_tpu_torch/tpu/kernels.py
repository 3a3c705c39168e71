"""The voice-batched DSP helpers of ``audiality2_tpu/tpu/kernels.py``
and the batched host engine's wave atlas (``WaveAtlas``, which the
copied ``engine/core.py`` reaches through ``atlas_base``).

All live voices are processed per 64-frame fragment as SoA tensors
(int64 [V] parameters, as the JAX module's):

    voices x 64-frame fragments -> gather + Hermite + ramp multiply
    -> panmix -> per-bus segmented sum

The oscillator and its fused panmix run through the row batch's kernel
(``cuda/rows.py``: ``rows_call``, the CUDA kernel for CUDA tensors, its
plain version ``rows_plain`` for CPU tensors), whose row math is the JAX
module's ``wtosc_fragments`` followed by ``panmix_mono`` or
``panmix_stereo``: a row without panmix gives ``wtosc_fragments``, a
mono row the mono panmix, a stereo row the stereo one with the clamp
set where ``|pan0| > 0xFFFFFF``.  The standalone panmixes over a given
``voice_out`` and ``mix_to_buses`` (an int64 ``index_add_``) are plain
PyTorch.  Reference contracts: wtosc.c:200-236 (fragment loop),
a2_dsp.h:64-74 (Hermite), wtosc.c:29-33 (2x oversampled HIFI
interpolation), panmix.c:49-135.
"""

import numpy as np
import torch

from ..constants import A2_MAXFRAG, A2_WAVEPRE
from ..cuda.rows import rows_call

FRAG = A2_MAXFRAG


class WaveAtlas:
    """All mip levels of all waves packed into one int32 array.

    Entry (wave, mip) gives the atlas offset of d[0] (i.e. after the
    A2_WAVEPRE pad) and the level's size.  `data` is host numpy; the
    row kernel keeps a per-version device copy (uploaded once, not per
    dispatch)."""

    def __init__(self):
        self._chunks = []
        self._offsets = {}      # (wave_key, mip) -> (base, size)
        self._pos = 0
        self.data = None
        self.version = 0

    def add_wave(self, key, wave):
        for mm in range(wave.miplevels):
            d = wave.data[mm]
            self._chunks.append(d.astype(np.int32))
            self._offsets[(key, mm)] = (self._pos + A2_WAVEPRE,
                                        wave.size[mm])
            self._pos += len(d)

    def finalize(self):
        if self._chunks:
            self.data = np.concatenate(self._chunks)
        else:
            self.data = np.zeros(1, dtype=np.int32)
        self.version += 1
        return self.data

    def lookup(self, key, mip):
        return self._offsets[(key, mip)]


# =========================================================
#   Voice-batched oscillator and panmix
# =========================================================

def _rows(atlas, base, ph0, dph, amp0, damp, haspm, stereo, clamp, vol0,
          dvol, pan0, dpan):
    """One fragment of V rows through ``rows_call`` on base's device:
    int64 [V, 2, 64].  atlas: int32 tensor or array."""
    atlas = torch.as_tensor(atlas, device=base.device).to(torch.int32)
    params = torch.stack([torch.as_tensor(x, device=base.device)
                          .to(torch.int64).expand(base.shape)
                          for x in (base, ph0, dph, amp0, damp, haspm,
                                    stereo, clamp, vol0, dvol, pan0,
                                    dpan)])
    return rows_call(atlas, params)


def wtosc_fragments(atlas, base, ph0, dph, amp0, damp):
    """Renders one 64-frame fragment for V voices.

    atlas: int32 [N] packed wave data
    base:  int64 [V] atlas offset of d[0] for the selected mip
    ph0:   int64 [V] 48:24 start phase (relative to wave start)
    dph:   int64 [V] 48:24 per-frame increment
    amp0:  int64 [V] 8:24 amplitude at frame 0
    damp:  int64 [V] per-frame amplitude delta

    Returns int64 [V, 64] voice audio (8:24): the 2x oversampled Hermite
    times the amplitude ramp, >> 17."""
    z = torch.zeros_like(base)
    return _rows(atlas, base, ph0, dph, amp0, damp, z, z, z, z, z, z,
                 z)[:, 0]


def wtosc_panmix_mono(atlas, base, ph0, dph, amp0, damp, vol0, dvol):
    """``wtosc_fragments`` followed by ``panmix_mono``, fused in one row
    batch: int64 [V, 64]."""
    z, one = torch.zeros_like(base), torch.ones_like(base)
    return _rows(atlas, base, ph0, dph, amp0, damp, one, z, z, vol0, dvol,
                 z, z)[:, 0]


def wtosc_panmix_stereo(atlas, base, ph0, dph, amp0, damp, vol0, dvol,
                        pan0, dpan):
    """``wtosc_fragments`` followed by ``panmix_stereo``, fused in one
    row batch: (left, right) int64 [V, 64]."""
    one = torch.ones_like(base)
    clamp = (pan0 > 0xFFFFFF) | (pan0 < -0xFFFFFF)
    out = _rows(atlas, base, ph0, dph, amp0, damp, one, one, clamp, vol0,
                dvol, pan0, dpan)
    return out[:, 0], out[:, 1]


def panmix_mono(voice_out, vol0, dvol):
    """panmix 1->1: out = in * vol >> 24 (panmix.c:49-65)."""
    n = torch.arange(FRAG, dtype=torch.int64, device=voice_out.device)
    vol = vol0[:, None] + n[None, :] * dvol[:, None]
    return (voice_out * vol) >> 24


def panmix_stereo(voice_out, vol0, dvol, pan0, dpan):
    """panmix 1->2 with clamped over-pan (panmix.c:78-135)."""
    n = torch.arange(FRAG, dtype=torch.int64, device=voice_out.device)
    vol = vol0[:, None] + n[None, :] * dvol[:, None]
    pan = pan0[:, None] + n[None, :] * dpan[:, None]
    vp = (pan * vol) >> 24
    v0 = vol - vp
    v1 = vol + vp
    lim = vol << 1
    clamp = ((pan0 > 0xFFFFFF) | (pan0 < -0xFFFFFF))[:, None]
    v0 = torch.where(clamp, torch.minimum(v0, lim), v0)
    v1 = torch.where(clamp, torch.minimum(v1, lim), v1)
    return (voice_out * v0) >> 24, (voice_out * v1) >> 24


def mix_to_buses(voice_out, bus, nbus):
    """Segmented sum of (V, 64) voice audio into (nbus, 64) int64 buses
    (bus ids must lie in [0, nbus))."""
    out = torch.zeros((nbus,) + tuple(voice_out.shape[1:]),
                      dtype=torch.int64, device=voice_out.device)
    return out.index_add_(0, torch.as_tensor(bus, device=voice_out.device)
                          .to(torch.int64), voice_out.to(torch.int64))
