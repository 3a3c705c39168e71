"""The batched host engine's wave atlas (``WaveAtlas``), the half of
``audiality2_tpu/tpu/kernels.py`` that the copied ``engine/core.py``
reaches (``atlas_base``).  The voice-batched helpers of that module
(``wtosc_fragments``, ``panmix_*``, ``mix_to_buses``) are not ported
yet."""

import numpy as np

from ..constants import A2_WAVEPRE


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
