"""The 8:24 control ramping device (a2_dsp.h:105-170), bit-exact.

Every control register of every unit is driven by one of these: a
write callback arms (target, start, duration); PrepareRamper computes
the per-sample delta at each fragment; RunRamper advances.  All
arithmetic wraps like C int32.
"""

import numpy as np

from ..fixmath import sat32


def _trunc_div(a, b):
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


class Ramper:
    __slots__ = ("value", "target", "delta", "timer")

    def __init__(self, v=0):
        self.init(v)

    def init(self, v):
        """a2_InitRamper: constant value 'v' (16:16)."""
        self.value = self.target = sat32(v << 8)
        self.delta = 0
        self.timer = 0

    def prepare(self, frames):
        """a2_PrepareRamper."""
        if not self.timer:
            self.value = self.target
            self.delta = 0
        elif frames <= (self.timer >> 8):
            self.delta = sat32(_trunc_div(
                (self.target - self.value) << 8, self.timer))
            self.timer -= frames << 8
        else:
            self.delta = sat32(_trunc_div(self.target - self.value,
                                          frames))
            self.timer = 0

    def run(self, frames):
        """a2_RunRamper."""
        self.value = sat32(self.value + self.delta * frames)

    def set(self, target, start, duration):
        """a2_SetRamper: target is 16:16; start/duration 24:8."""
        self.target = sat32(target << 8)
        self.timer = sat32(duration + start)
        if self.timer < 256:
            self.value = self.target
        else:
            self.value = sat32(self.value + ((self.delta * start) >> 8))

    def values(self, frames):
        """Vectorized: 8:24 value at each of 'frames' samples, assuming
        prepare() was already called (value advances by delta each
        sample, like calling run(1) in the loop)."""
        return self.value + self.delta * np.arange(frames, dtype=np.int64)
