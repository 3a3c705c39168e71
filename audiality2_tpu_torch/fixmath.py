"""Fixed-point helpers, linear-pitch conversion, and the engine RNG.

The control plane (VM, rampers, pitch) is kept bit-exact with the
reference so timing and frequencies match:

  * a2_P2I: 16:16 linear pitch -> 8:24 phase increment via a 64-segment
    linear-interpolation LUT of 2^x (reference src/pitch.c:33-67).
  * a2_Noise: the 16-bit LCG used by RAND instructions and the 'noise'
    wave (include/a2_dsp.h:37-42).

All helpers use plain Python ints (arbitrary precision) masked to the
C wrap-around semantics where required.
"""

import math

from .constants import A2_MIDDLEC

_U32 = 0xFFFFFFFF

# --- Pitch LUT (pitch.c:70-96) ---
_PITCH_TABLE_BITS = 6
_PITCH_TABLE_SIZE = 1 << _PITCH_TABLE_BITS


def _build_pitch_table():
    # Matches pitch.c:83-96 bit-for-bit: the reference computes each
    # segment endpoint with powf() (float32, correctly rounded by
    # glibc), so we evaluate pow in double on the float32 argument and
    # round the result to float32.
    import numpy as np
    tab = []
    b = 0x80000000
    for i in range(_PITCH_TABLE_SIZE):
        x = np.float32((i + 1) * np.float32(1.0 / _PITCH_TABLE_SIZE))
        p = np.float32(2.0 ** float(x))
        b2 = int(np.float64(0x80000000) * np.float64(p) + 0.5)
        tab.append((b, (b2 - b + 128) >> 8))
        b = b2
    return tab


_PITCH_TAB = _build_pitch_table()


def p2i(pitch: int) -> int:
    """16:16 linear pitch -> 8:24 phase increment (bit-exact a2_P2I)."""
    pitch &= _U32
    if pitch & 0x80000000:
        pitch -= 1 << 32            # sign
    n = pitch & 0xFFFF
    oct_ = pitch >> 16              # arithmetic shift (floor)
    base, coeff = _PITCH_TAB[n >> (16 - _PITCH_TABLE_BITS)]
    dph = (coeff * (n & (0xFFFF >> _PITCH_TABLE_BITS))) & _U32
    dph >>= 8 - _PITCH_TABLE_BITS
    dph = (dph + base) & _U32
    # x86 masks shift counts by 31; the reference relies on this for
    # out-of-range pitches (the golden outputs were produced on x86).
    return dph >> ((7 - oct_) & 31)


def f2p(f: float, reference: float = A2_MIDDLEC) -> float:
    """Frequency (Hz) -> linear pitch, with the reference's exact
    float32 semantics (a2_F2Pf, pitch.c:45-48: the division and the
    return value are float32; log2 itself runs in double).  Script
    literals like `9000f` depend on this rounding."""
    import numpy as np
    x = np.float32(np.float32(f) / np.float32(reference))
    return float(np.float32(math.log2(float(x))))


def p2if(pitch: float) -> float:
    """Linear pitch -> relative rate (a2_P2If)."""
    return math.pow(2.0, pitch)


class NoiseState:
    """The reference's RAND/noise LCG (a2_dsp.h:37-42)."""

    __slots__ = ("state",)

    def __init__(self, seed: int):
        self.state = seed & _U32

    def next(self) -> int:
        """Returns a pseudo random number in [0, 65535]."""
        s = (self.state * 1566083941 + 1) & _U32
        self.state = s
        return ((s * (s >> 16)) & _U32) >> 16


def to_f16(v: float) -> int:
    """double -> 16:16 with round-half-up (compiler a2c_Num2VM)."""
    return int(math.floor(v * 65536.0 + 0.5))


def from_f16(v: int) -> float:
    return v / 65536.0


def sat32(v: int) -> int:
    """Wrap to signed 32-bit (C int overflow semantics of the VM regs)."""
    v &= _U32
    return v - (1 << 32) if v & 0x80000000 else v


def c_div(a: int, b: int) -> int:
    """C-style truncating integer division."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def c_mod(a: int, b: int) -> int:
    """C-style remainder (sign of dividend)."""
    return a - c_div(a, b) * b
