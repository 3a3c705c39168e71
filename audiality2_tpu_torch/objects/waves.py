"""Waveform objects: upload, normalization, loop post-processing, mipmaps,
padding, and the built-in wave bank.

Behavioral contract from reference src/waves.c and include/a2_waves.h:

  * Wave data is int16; sizes per mip level are (length+2^i-1)>>i
    (waves.c:59-87).
  * Mip level i+1 is the half-band decimation
    (2*s[2k] + s[2k-1] + s[2k+1]) >> 2 of level i (waves.c:121-130),
    computed AFTER level i's pad zones are fixed.
  * Looped waves wrap their pad zones; one-shot waves zero-pad
    (waves.c:90-106).
  * Upload converts I8/I16/I24/I32/F32 to int16, with optional
    normalization (waves.c:154-306), then applies A2_REVMIX/A2_XFADE
    loop post-processing (waves.c:310-346).
  * The built-in bank holds off, pulse1..pulse50 (square == pulse50),
    saw, triangle, sine/asine/hsine/qsine, noise — all period 2048,
    looped, mipmapped (waves.c:629-708).

This module is pure host-side preparation code.  Prepared mip chains are
also exported as float32 arrays for the TPU render path (scaled so that
int16 32767 -> 32767.0f; the oscillator kernels apply the same gains as
the integer reference within the -80 dB tolerance).
"""

import math

import numpy as np

from ..constants import (
    A2_CLEAR, A2_LOOPED, A2_MIPLEVELS, A2_NORMALIZE, A2_REVMIX,
    A2_UNPREPARED, A2_WAVEPERIOD, A2_WAVEPOST, A2_WAVEPRE, A2_XFADE,
    SampleFormat, WaveType,
)
from ..errors import A2Error, A2Exception


class Wave:
    def __init__(self, wtype: WaveType, period: int, flags: int):
        self.type = WaveType(wtype)
        self.flags = flags
        self.period = period
        # int16 arrays including pre/post pad; sizes EXCLUDE pad.
        self.data = [None] * A2_MIPLEVELS
        self.size = [0] * A2_MIPLEVELS
        if self.type in (WaveType.WAVE, WaveType.MIPWAVE):
            self.flags |= A2_UNPREPARED

    @property
    def miplevels(self):
        if self.type == WaveType.MIPWAVE:
            return A2_MIPLEVELS
        if self.type == WaveType.WAVE:
            return 1
        return 0

    def alloc(self, length: int):
        for i in range(self.miplevels):
            size = (length + (1 << i) - 1) >> i
            self.size[i] = size
            total = A2_WAVEPRE + size + A2_WAVEPOST
            self.data[i] = np.zeros(total, dtype=np.int16)

    def fix_pad(self, level: int):
        d = self.data[level]
        size = self.size[level]
        if (self.flags & A2_LOOPED) and size:
            d[:A2_WAVEPRE] = d[size:size + A2_WAVEPRE]
            idx = A2_WAVEPRE + (np.arange(A2_WAVEPOST) % size)
            d[A2_WAVEPRE + size:] = d[idx]
        else:
            d[:A2_WAVEPRE] = 0
            d[A2_WAVEPRE + size:] = 0

    def render_mipmaps(self):
        if self.type not in (WaveType.WAVE, WaveType.MIPWAVE):
            return
        self.fix_pad(0)
        if self.type != WaveType.MIPWAVE:
            return
        for i in range(1, A2_MIPLEVELS):
            size = self.size[i]
            sd = self.data[i - 1]
            d = self.data[i]
            # source indices relative to sd start (pad included):
            # sd[A2_WAVEPRE + 2k], neighbors at +-1
            k = np.arange(size)
            center = sd[A2_WAVEPRE + 2 * k].astype(np.int32)
            left = sd[A2_WAVEPRE + 2 * k - 1].astype(np.int32)
            right = sd[A2_WAVEPRE + 2 * k + 1].astype(np.int32)
            d[A2_WAVEPRE:A2_WAVEPRE + size] = \
                ((center << 1) + left + right) >> 2
            self.fix_pad(i)

    def write(self, offset: int, gain: float, fmt: SampleFormat, data):
        """Convert + write samples into mip level 0 (a2_do_write)."""
        arr = np.asarray(data)
        length = len(arr)
        if offset + length > self.size[0]:
            raise A2Exception(A2Error.INDEXRANGE)
        d = self.data[0]
        o = A2_WAVEPRE + offset
        if gain == 1.0:
            if fmt == SampleFormat.I8:
                out = arr.astype(np.int32) << 8
            elif fmt == SampleFormat.I16:
                out = arr.astype(np.int32)
            elif fmt == SampleFormat.I24:
                out = arr.astype(np.int32) >> 8
            elif fmt == SampleFormat.I32:
                out = arr.astype(np.int32) >> 16
            elif fmt == SampleFormat.F32:
                # C float->int16_t conversion truncates toward zero;
                # the product is computed in float32 like the reference
                out = np.trunc((arr.astype(np.float32)
                                * np.float32(32767.0)).astype(np.float64)
                               ).astype(np.int64)
            else:
                raise A2Exception(A2Error.BADFORMAT)
        else:
            g = float(gain)
            if fmt == SampleFormat.I8:
                g *= 256.0
            elif fmt == SampleFormat.I24:
                g /= 256.0
            elif fmt == SampleFormat.I32:
                g /= 65536.0
            elif fmt == SampleFormat.F32:
                g *= 32767.0
            elif fmt != SampleFormat.I16:
                raise A2Exception(A2Error.BADFORMAT)
            # reference multiplies in float32 then int16-converts
            # (truncation toward zero)
            out = np.trunc((arr.astype(np.float32)
                            * np.float32(g)).astype(np.float64)
                           ).astype(np.int64)
        d[o:o + length] = out.astype(np.int16)

    def postprocess(self):
        """Apply A2_REVMIX / A2_XFADE (a2_postprocess)."""
        size = self.size[0]
        sh = size // 2
        d = self.data[0]
        base = A2_WAVEPRE
        if self.flags & A2_REVMIX:
            for i in range(sh):
                d[base + i] = (int(d[base + i]) + int(d[base + size - i])) >> 1
            for i in range(sh):
                d[base + size - i] = d[base + i]
        if self.flags & A2_XFADE:
            g = 0.0
            dg = 1.0 / sh
            for i in range(sh):
                d[base + i] = int(d[base + i] * g)
                g += dg
            for i in range(sh, size):
                d[base + i] = int(d[base + i] * g)
                g -= dg
            for i in range(sh):
                d[base + i] += d[base + i + sh]
            for i in range(sh, size):
                d[base + i] = d[base + i - sh]

    def prepared_float(self, level: int) -> np.ndarray:
        """float32 view of a mip level (pads included) for the TPU path."""
        return self.data[level].astype(np.float32)


def normalize_gain(fmt: SampleFormat, data) -> float:
    arr = np.asarray(data)
    if len(arr) == 0:
        return 1.0
    if fmt == SampleFormat.F32:
        peak = float(np.max(np.abs(arr)))
        return 1.0 / peak if peak else 1.0
    peak = int(np.max(np.maximum(arr, -arr)))
    if not peak:
        return 1.0
    if fmt == SampleFormat.I8:
        return 127.0 / peak
    if fmt == SampleFormat.I16:
        return 32767.0 / peak
    if fmt == SampleFormat.I24:
        return 32767.0 * 256.0 / peak
    if fmt == SampleFormat.I32:
        return 32767.0 * 65536.0 / peak
    return 1.0


def upload_wave(wtype: WaveType, period: int, flags: int,
                fmt: SampleFormat, data) -> Wave:
    """Create + prepare a wave from raw data (a2_UploadWave, waves.c:559)."""
    w = Wave(wtype, period, flags)
    w.flags &= ~A2_UNPREPARED
    if data is None:
        return w
    arr = np.asarray(data)
    if len(arr) == 0:
        return w
    if w.flags & A2_NORMALIZE:
        gain = normalize_gain(fmt, arr)
    else:
        gain = 1.0
    w.alloc(len(arr))
    w.write(0, gain, fmt, arr)
    w.postprocess()
    w.render_mipmaps()
    return w


def builtin_waves():
    """The built-in wave bank (a2_InitWaves, waves.c:629-708).

    Returns an ordered list of (name, Wave).
    """
    out = []
    P = A2_WAVEPERIOD

    out.append(("off", Wave(WaveType.OFF, 0, 0)))

    # pulse1..pulse50 (1..9 by 1, then 10..50 by 5).  The reference's
    # fill loops (waves.c:643-647) skip the sample at index s1 — the
    # `for(++s; ...)` second loop starts at s1+1 — so that sample keeps
    # whatever the reused stack buffer held from the previous iteration
    # (uninitialized stack for pulse1; -32767 for the rest, since s1
    # grows monotonically).  pulse1's stale sample is genuinely
    # uninitialized stack memory in the reference — its value depends
    # on the CALLING BINARY's stack at a2_Open time (we observed 28,
    # -8192 and 4 from three different callers of the same library).
    # The golden corpus generator (tools/golden_dump.c) deterministically
    # leaves 4 there, solved by bit-exact search against its renders,
    # so that is the value modeled here.
    buf = np.zeros(P, dtype=np.int16)
    buf[(P * 1 + 50) // 100] = 4
    j = 1
    while j <= 50:
        s1 = (P * j + 50) // 100
        buf[:s1] = 32767
        buf[s1 + 1:] = -32767          # buf[s1] left stale on purpose
        out.append((f"pulse{j}", upload_wave(WaveType.MIPWAVE, P, A2_LOOPED,
                                             SampleFormat.I16, buf.copy())))
        j += 1 if j < 10 else 5

    # Sawtooth
    s = np.arange(P, dtype=np.int64)
    buf = (s * 65534 // P - 32767).astype(np.int16)
    out.append(("saw", upload_wave(WaveType.MIPWAVE, P, A2_LOOPED,
                                   SampleFormat.I16, buf)))

    # Triangle (waves.c:664-667)
    buf = np.zeros(P, dtype=np.int16)
    for sv in range(P // 2):
        v = sv * 65534 * 2 // P - 32767
        buf[(5 * P // 4 - sv - 1) % P] = v
        buf[sv + P // 4] = v
    out.append(("triangle", upload_wave(WaveType.MIPWAVE, P, A2_LOOPED,
                                        SampleFormat.I16, buf)))

    # Sine family
    s = np.arange(P)
    sine = np.trunc(np.sin(s * 2.0 * math.pi / P) * 32767.0).astype(np.int16)
    out.append(("sine", upload_wave(WaveType.MIPWAVE, P, A2_LOOPED,
                                    SampleFormat.I16, sine.copy())))
    asine = sine.copy()
    asine[P // 2:] = -asine[P // 2:]
    out.append(("asine", upload_wave(WaveType.MIPWAVE, P, A2_LOOPED,
                                     SampleFormat.I16, asine.copy())))
    hsine = asine.copy()
    hsine[P // 2:] = 0
    out.append(("hsine", upload_wave(WaveType.MIPWAVE, P, A2_LOOPED,
                                     SampleFormat.I16, hsine.copy())))
    qsine = hsine.copy()
    qsine[P // 2:P // 2 + P // 4] = qsine[:P // 4]
    out.append(("qsine", upload_wave(WaveType.MIPWAVE, P, A2_LOOPED,
                                     SampleFormat.I16, qsine)))

    # Pitched S&H noise "oscillator"
    out.append(("noise", Wave(WaveType.NOISE, 256, A2_LOOPED)))
    return out
