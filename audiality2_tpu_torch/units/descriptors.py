"""Unit descriptors: the compile-time protocol of voice units.

A descriptor lists a unit's control registers (in VM-register mapping
order), control outputs, script-visible constants, and I/O channel
ranges — everything the A2S compiler needs to wire voice structures
(reference include/a2_units.h, and each unit's A2_unitdesc, e.g.
src/units/wtosc.c:507-536).

The DSP implementations (host engine + TPU kernels) are registered
separately and looked up by unit name.
"""

from dataclasses import dataclass, field
from typing import Optional, Tuple

from ..constants import A2_MAXCHANNELS, A2_MATCHIO

A2_XINSERT = 0x0200  # unit hosts xinsert clients (a2_units.h)


@dataclass(frozen=True)
class UnitDesc:
    name: str
    flags: int = 0
    registers: Tuple[str, ...] = ()      # control register names, in order
    coutputs: Tuple[str, ...] = ()       # control output names, in order
    constants: Tuple[Tuple[str, int], ...] = ()   # (name, 16:16 value)
    mininputs: int = 0
    maxinputs: int = 0
    minoutputs: int = 0
    maxoutputs: int = 0


def _fm_regs(nops: int) -> Tuple[str, ...]:
    regs = ["phase", "p", "a", "fb"]
    for i in range(1, nops):
        regs += [f"p{i}", f"a{i}", f"fb{i}"]
    return tuple(regs)


_ENV_CONSTANTS = tuple(
    [(f"IEXP{i}", (-(i + 1)) << 16) for i in range(7, 0, -1)]
    + [("SPLINE", (-1) << 16), ("LINK", 0), ("LINEAR", 1 << 16)]
    + [(f"EXP{i}", (i + 1) << 16) for i in range(1, 8)]
)

# All built-in units, in the reference registration order
# (audiality2.c:183-207 a2_core_units[]).
CORE_UNITS = (
    UnitDesc("inline", 0, (), (), (), 0, 0, 1, A2_MAXCHANNELS),
    UnitDesc("wtosc", 0, ("w", "p", "a", "phase"), (), (), 0, 0, 1, 1),
    UnitDesc("panmix", 0, ("vol", "pan"), (),
             (("CENTER", 0), ("LEFT", (-1) << 16), ("RIGHT", 1 << 16)),
             1, 2, 1, 2),
    UnitDesc("xsink", A2_XINSERT, (), (), (), 1, A2_MAXCHANNELS, 0, 0),
    UnitDesc("xsource", A2_XINSERT, (), (), (), 0, 0, 1, A2_MAXCHANNELS),
    UnitDesc("xinsert", A2_MATCHIO | A2_XINSERT, (), (), (),
             1, A2_MAXCHANNELS, 1, A2_MAXCHANNELS),
    UnitDesc("dbgunit", 0, (), (), (), 0, A2_MAXCHANNELS, 0, A2_MAXCHANNELS),
    UnitDesc("limiter", A2_MATCHIO, ("release", "threshold"), (), (),
             1, 2, 1, 2),
    UnitDesc("fbdelay", 0,
             ("fbdelay", "ldelay", "rdelay", "drygain", "fbgain",
              "lgain", "rgain"), (), (), 1, 2, 1, 2),
    UnitDesc("filter12", A2_MATCHIO, ("cutoff", "q", "lp", "bp", "hp"),
             (), (), 1, 2, 1, 2),
    UnitDesc("dcblock", A2_MATCHIO, ("cutoff",), (), (), 1, 2, 1, 2),
    UnitDesc("waveshaper", A2_MATCHIO, ("amount",), (), (), 1, 2, 1, 2),
    UnitDesc("fm1", 0, _fm_regs(1), (), (), 0, 0, 1, 1),
    UnitDesc("fm2", 0, _fm_regs(2), (), (), 0, 0, 1, 1),
    UnitDesc("fm3", 0, _fm_regs(3), (), (), 0, 0, 1, 1),
    UnitDesc("fm4", 0, _fm_regs(4), (), (), 0, 0, 1, 1),
    UnitDesc("fm3p", 0, _fm_regs(3), (), (), 0, 0, 1, 1),
    UnitDesc("fm4p", 0, _fm_regs(4), (), (), 0, 0, 1, 1),
    UnitDesc("fm2r", 0, _fm_regs(2), (), (), 0, 0, 1, 1),
    UnitDesc("fm4r", 0, _fm_regs(4), (), (), 0, 0, 1, 1),
    UnitDesc("dc", 0, ("value", "mode"), (),
             (("STEP", 0), ("LINEAR", 1 << 16)), 0, 0, 1, 2),
    UnitDesc("env", 0, ("target", "mode", "down", "time"), ("out",),
             _ENV_CONSTANTS, 0, 0, 0, 0),
)

UNIT_BY_NAME = {u.name: u for u in CORE_UNITS}
