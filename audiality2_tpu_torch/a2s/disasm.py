"""VM code disassembler (a2_DumpCode / a2_DumpIns equivalents,
reference compiler.c:134-324).  Same output layout so compiled programs
can be eyeballed against the reference's `a2play -xa` dumps."""

from ..constants import A2_CREGISTERS, A2_MAXEPS, Op, ins_size

_REGNAMES = ["TICK", "TR"]

_NO_ARGS = {Op.END, Op.RETURN, Op.SLEEP, Op.KILLA, Op.DETACHA,
            Op.INITV, Op.SETALL}
_INT_A2 = {Op.JUMP, Op.WAKE, Op.FORCE, Op.SENDA, Op.SENDS, Op.CALL,
           Op.SPAWND, Op.SPAWNA, Op.SIZEOF}
_F16_A3 = {Op.DELAY, Op.TDELAY, Op.PUSH, Op.DEBUG, Op.RAMPALL}
_REG_A1 = {Op.DELAYR, Op.TDELAYR, Op.PUSHR, Op.SET, Op.DEBUGR,
           Op.SIZEOFR, Op.KILLR, Op.DETACHR, Op.SPAWNDR, Op.SPAWNAR,
           Op.RAMPALLR}
_REG_F16 = {Op.LOAD, Op.ADD, Op.MUL, Op.MOD, Op.QUANT, Op.RAND,
            Op.RAMP}
_REG_INT = {Op.LOOP, Op.JZ, Op.JNZ, Op.JG, Op.JL, Op.JGE, Op.JLE,
            Op.SPAWNV}
_IDX_A1 = {Op.KILL, Op.DETACH, Op.WAIT}
_IDX_INT = {Op.SPAWN, Op.SEND}


def _reg(r):
    return _REGNAMES[r] if r < A2_CREGISTERS else f"R{r}"


def dump_ins(code, pc):
    """One instruction at word position pc -> (text, size)."""
    w = code[pc] & 0xFFFFFFFF
    op = Op(w & 0xFF)
    a1 = (w >> 8) & 0xFF
    a2 = (w >> 16) & 0xFFFF
    size = ins_size(op)
    if size == 2:
        a3 = code[pc + 1] & 0xFFFFFFFF
        if a3 & 0x80000000:
            a3 -= 1 << 32
    else:
        a3 = 0
    s = f"{pc:6d}: {op.name:<8.8s}"
    if op in _NO_ARGS:
        pass
    elif op in _INT_A2:
        s += f"{a2}"
    elif op in _F16_A3:
        s += f"{a3 / 65536.0:f}"
    elif op in _REG_A1:
        s += _reg(a1)
    elif op in _REG_F16:
        s += f"{_reg(a1)} {a3 / 65536.0:f}"
    elif op in _REG_INT:
        s += f"{_reg(a1)} {a2}"
    elif op in _IDX_A1:
        s += f"{a1}"
    elif op in _IDX_INT:
        s += f"{a1} {a2}"
    else:
        s += f"{_reg(a1)} {_reg(a2)}"
    return s, size


def dump_function(p, fn_index, prefix=""):
    lines = []
    f = p.funcs[fn_index]
    if f.argc:
        defaults = " ".join(f"{d / 65536.0:g}"
                            for d in f.argdefs[:f.argc])
        lines.append(f"{prefix} | {f.argc} args; defaults: {defaults}")
    lines.append(f"{prefix} | size: {len(f.code)}; topreg: {f.topreg}")
    lines.append(f"{prefix} |")
    pc = 0
    while pc < len(f.code):
        text, size = dump_ins(f.code, pc)
        lines.append(f"{prefix} | {text}")
        pc += size
    lines.append(f"{prefix} '--------------------------------")
    return "\n".join(lines)


def dump_program(p, prefix=""):
    """a2_DumpCode layout: main EP, message EPs, local functions."""
    out = [f"{prefix} .-[ Main EP ]----------------",
           dump_function(p, 0, prefix)]
    for ep in range(1, A2_MAXEPS):
        if p.eps[ep] >= 0:
            out.append(f"{prefix} .-[ EP {ep} ]-------------------")
            out.append(dump_function(p, p.eps[ep], prefix))
    for j in range(1, p.nfuncs):
        if j not in p.eps:
            out.append(f"{prefix} .-[ Function {j} ]--------------")
            out.append(dump_function(p, j, prefix))
    return "\n".join(out)
