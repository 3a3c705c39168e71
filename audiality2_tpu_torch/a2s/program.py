"""Compiled A2S program representation.

The VM instruction stream uses the same 32-bit word encoding as the
reference (internals.h:211-223): word0 = opcode | a1<<8 | a2<<16, with
an optional second word holding a signed 32-bit immediate (a3) for
two-word instructions.  Jump targets are word positions, so compiled
code round-trips through the same disassembly layout as a2_DumpCode.

For fast interpretation, each function also carries a pre-decoded
tuple-per-word table (None at immediate-word positions).
"""

from dataclasses import dataclass, field
from typing import List, Optional

from ..constants import A2_MAXARGS, A2_MAXEPS, Op, ins_size

# Voice flags stored in Program.vflags (internals.h:551-556)
A2_SUBINLINE = 0x0100
A2_ATTACHED = 0x0200
A2_APIHANDLE = 0x0400


@dataclass
class Function:
    code: List[int] = field(default_factory=list)   # 32-bit words
    argdefs: List[int] = field(default_factory=lambda: [0] * A2_MAXARGS)
    argv: int = 0        # first register of the argument list
    argc: int = 0
    topreg: int = 0
    decoded: Optional[list] = None   # pos -> (op, a1, a2, a3) | None

    def decode(self):
        """Pre-decode the word stream for the interpreter."""
        d = [None] * len(self.code)
        pos = 0
        n = len(self.code)
        while pos < n:
            w = self.code[pos] & 0xFFFFFFFF
            op = w & 0xFF
            a1 = (w >> 8) & 0xFF
            a2 = (w >> 16) & 0xFFFF
            if ins_size(op) == 2 and pos + 1 < n:
                a3 = self.code[pos + 1] & 0xFFFFFFFF
                if a3 & 0x80000000:
                    a3 -= 1 << 32
            else:
                a3 = 0
            d[pos] = (op, a1, a2, a3)
            pos += ins_size(op)
        self.decoded = d


@dataclass
class UnitItem:
    """Voice-structure unit entry (A2_structitem unit variant)."""
    uindex: int          # index into the registered unit table
    ninputs: int         # count or A2_iocodes
    noutputs: int        # count or A2_iocodes
    flags: int = 0       # A2_PROCADD etc


@dataclass
class WireItem:
    """Control wire (A2_structitem wire variant)."""
    from_unit: int
    from_output: int
    to_register: int


@dataclass
class Program:
    funcs: List[Function] = field(default_factory=list)
    units: List[UnitItem] = field(default_factory=list)
    wires: List[WireItem] = field(default_factory=list)
    eps: List[int] = field(default_factory=lambda: [-1] * A2_MAXEPS)
    vflags: int = 0
    buffers: int = 0     # scratch buffers needed; negative => matchout
    name: str = "<anonymous>"

    @property
    def nfuncs(self):
        return len(self.funcs)
