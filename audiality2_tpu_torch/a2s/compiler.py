"""A2S compiler: single-pass recursive-descent parser + assembler.

Reimplements the reference language front-end (src/compiler.c) in
Python: same grammar, same VM instruction encoding, same register
allocation model (flat 64-register map with TEMPORARY/VARIABLE/
ARGUMENT/CONTROL classes), same scoping/export semantics, and the same
constant-folding rules (strict left-to-right expressions, no
precedence).

The compiler talks to the engine through a small host interface
(`CompilerHost` duck type, implemented by engine.state.Interface):
object handles, bank lookup, imports, and compile-time wave rendering.
"""

import math
from enum import IntEnum

from ..constants import (
    A2_CREGISTERS, A2_IO_DEFAULT, A2_IO_MATCHOUT, A2_IO_WIREOUT,
    A2_LOOPED, A2_MAXARGS, A2_MAXEPS, A2_NORMALIZE, A2_PROCADD,
    A2_REGISTERS, A2_REVMIX, A2_UNDEFJUMP, A2_XFADE,
    A2_DEFAULT_NOISESEED, A2_DEFAULT_RANDSEED, A2_MATCHIO,
    A2ObjType, Op, R_TICK, R_TRANSPOSE, WaveType, ins_size,
)
from ..errors import A2CompileError, A2Error
from ..fixmath import f2p, p2if, to_f16
from .program import A2_SUBINLINE, Function, Program, UnitItem, WireItem


class Tok(IntEnum):
    # Values >255 so single characters can be their own token codes.
    EOF = 256
    EOS = 257
    NAMESPACE = 258
    ALIAS = 259
    VALUE = 260
    REGISTER = 261
    TEMPREG = 262
    COUTPUT = 263
    STRING = 264
    BANK = 265
    WAVE = 266
    UNIT = 267
    PROGRAM = 268
    FUNCTION = 269
    NAME = 270
    FWDECL = 271
    LABEL = 272
    INSTRUCTION = 273
    KW_IMPORT = 274
    KW_EXPORT = 275
    KW_AS = 276
    KW_DEF = 277
    KW_STRUCT = 278
    KW_WIRE = 279
    KW_TEMPO = 280
    KW_WAVE = 281
    IF = 282
    KW_ELSE = 283
    WHILE = 284
    KW_FOR = 285
    GE = 286
    LE = 287
    EQ = 288
    NE = 289
    KW_AND = 290
    KW_OR = 291
    KW_XOR = 292
    KW_NOT = 293
    AT_WAVETYPE = 294
    WAVETYPE = 295
    AT_PERIOD = 296
    AT_SAMPLERATE = 297
    AT_LENGTH = 298
    AT_DURATION = 299
    AT_FLAG = 300
    AT_RANDSEED = 301
    AT_NOISESEED = 302


def is_value(tk):
    return tk == Tok.VALUE


def is_handle(tk):
    return tk in (Tok.BANK, Tok.WAVE, Tok.PROGRAM, Tok.STRING)


def is_register(tk):
    return tk in (Tok.TEMPREG, Tok.REGISTER)


def is_symbol(tk):
    return tk in (Tok.NAMESPACE, Tok.NAME, Tok.FWDECL, Tok.LABEL,
                  Tok.COUTPUT)


def is_eos(tk):
    return tk == Tok.EOS or tk == ord('}')


# Register allocation classes (compiler.h:215-222)
RT_FREE = 0
RT_TEMPORARY = 1
RT_VARIABLE = 2
RT_ARGUMENT = 3
RT_CONTROL = 4


class Symbol:
    __slots__ = ("name", "token", "value", "flags", "symbols", "fixups",
                 "exported")

    def __init__(self, name, token, value=0):
        self.name = name
        self.token = token
        self.value = value        # int / float / Symbol / (inst, idx)
        self.exported = False
        self.symbols = []         # child symbol stack (namespaces)
        self.fixups = []


class LexVal:
    __slots__ = ("pos", "token", "value")

    def __init__(self):
        self.pos = 0
        self.token = 0
        self.value = None


class Coder:
    __slots__ = ("prev", "program", "func", "code", "topreg")

    def __init__(self, prev, program, func):
        self.prev = prev
        self.program = program
        self.func = func
        self.code = []
        self.topreg = prev.topreg if prev else 0

    @property
    def pos(self):
        return len(self.code)


# Root keyword table (compiler.c:3942-4014)
_ROOT_INSTRUCTIONS = [
    ("end", Op.END), ("sleep", Op.SLEEP), ("return", Op.RETURN),
    ("jump", Op.JUMP), ("jz", Op.JZ), ("jnz", Op.JNZ), ("jg", Op.JG),
    ("jl", Op.JL), ("jge", Op.JGE), ("jle", Op.JLE), ("wake", Op.WAKE),
    ("force", Op.FORCE), ("wait", Op.WAIT), ("loop", Op.LOOP),
    ("kill", Op.KILL), ("detach", Op.DETACH), ("d", Op.DELAY),
    ("td", Op.TDELAY), ("quant", Op.QUANT), ("rand", Op.RAND),
    ("p2d", Op.P2DR), ("neg", Op.NEGR), ("not", Op.NOTR),
    ("set", Op.SET), ("ramp", Op.RAMP), ("sizeof", Op.SIZEOF),
    ("debug", Op.DEBUG),
]

_ROOT_KEYWORDS = [
    ("import", Tok.KW_IMPORT), ("export", Tok.KW_EXPORT),
    ("as", Tok.KW_AS), ("def", Tok.KW_DEF), ("struct", Tok.KW_STRUCT),
    ("wire", Tok.KW_WIRE), ("tempo", Tok.KW_TEMPO), ("wave", Tok.KW_WAVE),
    ("else", Tok.KW_ELSE), ("for", Tok.KW_FOR),
    ("and", Tok.KW_AND), ("or", Tok.KW_OR), ("xor", Tok.KW_XOR),
]

_ROOT_CONDITIONALS = [
    ("if", Tok.IF, Op.JZ), ("ifz", Tok.IF, Op.JNZ),
    ("ifl", Tok.IF, Op.JG), ("ifg", Tok.IF, Op.JL),
    ("ifle", Tok.IF, Op.JGE), ("ifge", Tok.IF, Op.JLE),
    ("while", Tok.WHILE, Op.JZ), ("wz", Tok.WHILE, Op.JNZ),
    ("wl", Tok.WHILE, Op.JGE), ("wg", Tok.WHILE, Op.JLE),
    ("wle", Tok.WHILE, Op.JG), ("wge", Tok.WHILE, Op.JL),
]

# Wave definition attribute symbols (compiler.c:3443-3470)
_WD_SYMS = [
    ("wavetype", Tok.AT_WAVETYPE, 0),
    ("period", Tok.AT_PERIOD, 0),
    ("samplerate", Tok.AT_SAMPLERATE, 0),
    ("length", Tok.AT_LENGTH, 0),
    ("duration", Tok.AT_DURATION, 0),
    ("randseed", Tok.AT_RANDSEED, 0),
    ("noiseseed", Tok.AT_NOISESEED, 0),
    ("looped", Tok.AT_FLAG, A2_LOOPED),
    ("normalize", Tok.AT_FLAG, A2_NORMALIZE),
    ("xfade", Tok.AT_FLAG, A2_XFADE),
    ("revmix", Tok.AT_FLAG, A2_REVMIX),
    ("OFF", Tok.WAVETYPE, WaveType.OFF),
    ("NOISE", Tok.WAVETYPE, WaveType.NOISE),
    ("WAVE", Tok.WAVETYPE, WaveType.WAVE),
    ("MIPWAVE", Tok.WAVETYPE, WaveType.MIPWAVE),
    ("DEFAULT_RANDSEED", Tok.VALUE, A2_DEFAULT_RANDSEED),
    ("DEFAULT_NOISESEED", Tok.VALUE, A2_DEFAULT_NOISESEED),
]

_BINOP_CHARS = {
    ord('+'): Op.ADD, ord('*'): Op.MUL, ord('%'): Op.MOD,
    ord('-'): Op.SUBR, ord('/'): Op.DIVR, ord('>'): Op.GR,
    ord('<'): Op.LR,
    Tok.GE: Op.GER, Tok.LE: Op.LER, Tok.EQ: Op.EQR, Tok.NE: Op.NER,
    Tok.KW_AND: Op.ANDR, Tok.KW_OR: Op.ORR, Tok.KW_XOR: Op.XORR,
}

_BINOPS = frozenset({
    Op.MOD, Op.ADD, Op.MUL, Op.QUANT, Op.SUBR, Op.DIVR, Op.GR, Op.LR,
    Op.GER, Op.LER, Op.EQR, Op.NER, Op.ANDR, Op.ORR, Op.XORR,
})


class Throw(Exception):
    """Internal compile-abort exception (the a2c_Throw equivalent)."""

    def __init__(self, code):
        self.code = code
        super().__init__(str(code))


class Compiler:
    """One compilation context (a2_OpenCompiler equivalent)."""

    LEXDEPTH = 3
    WHITENEWLINE = 1
    NAMESPACE_ONLY = 2

    def __init__(self, host):
        self.host = host          # CompilerHost (engine interface)
        self.coder = None
        self.symbols = []         # symbol stack; [-1] is newest
        self.imports = []         # bank handles searched for names
        self.target = None        # target Bank object
        self.path = None
        self.source = ""
        self.source_name = ""
        self.l = [LexVal() for _ in range(self.LEXDEPTH)]
        self.regmap = [RT_FREE] * A2_REGISTERS
        self.canexport = False
        self.inhandler = False
        self.nocode = True

        for _ in range(A2_CREGISTERS):
            self.alloc_reg(RT_CONTROL)

        # Built-in symbols
        root = Symbol("root", Tok.BANK, host.root_bank_handle())
        self.push_symbol(self.symbols, root)
        self.push_symbol(self.symbols, Symbol("tick", Tok.REGISTER, R_TICK))
        self.push_symbol(self.symbols, Symbol("tr", Tok.REGISTER,
                                              R_TRANSPOSE))
        for name, op in _ROOT_INSTRUCTIONS:
            self.push_symbol(self.symbols,
                             Symbol(name, Tok.INSTRUCTION, int(op)))
        for name, tk in _ROOT_KEYWORDS:
            self.push_symbol(self.symbols, Symbol(name, tk, 0))
        for name, tk, op in _ROOT_CONDITIONALS:
            self.push_symbol(self.symbols, Symbol(name, tk, int(op)))

        self.imports.append(host.root_bank_handle())

        # units.<name>.constants namespaces (a2_OpenCompiler:4062-4077)
        uns = Symbol("units", Tok.NAMESPACE)
        self.push_symbol(self.symbols, uns)
        for ud in host.unit_descs():
            if not ud.constants:
                continue
            s_unit = Symbol(ud.name, Tok.NAMESPACE)
            self.push_symbol(uns.symbols, s_unit)
            s_const = Symbol("constants", Tok.NAMESPACE)
            self.push_symbol(s_unit.symbols, s_const)
            self._add_unit_constants(ud, s_const.symbols)

    # ----- errors -----

    def throw(self, code):
        raise Throw(code)

    # ----- symbols -----

    @staticmethod
    def push_symbol(stack, sym):
        stack.append(sym)

    @staticmethod
    def find_symbol(stack, name):
        for s in reversed(stack):
            if s.name == name:
                while s.token == Tok.ALIAS:
                    s = s.value
                return s
        return None

    def create_namespace(self, stack, name):
        s = Symbol(name, Tok.NAMESPACE)
        if stack is None:
            stack = self.symbols
        self.push_symbol(stack, s)
        return s.symbols

    # ----- registers -----

    def alloc_reg(self, rt):
        for r in range(A2_REGISTERS):
            if self.regmap[r] == RT_FREE:
                self.regmap[r] = rt
                if self.coder and r > self.coder.topreg:
                    self.coder.topreg = r
                return r
        self.throw(A2Error.OUTOFREGS)

    def free_reg(self, r):
        self.regmap[r] = RT_FREE

    # ----- code generation -----

    def num2vm(self, v):
        fxv = to_f16(v)
        if fxv > 0x7FFFFFFF or fxv < -0x80000000:
            # The reference's range check is unreachable
            # (compiler.c:497: `>max && <min`); the double->int
            # conversion yields INT_MIN on x86 for out-of-range values.
            fxv = -0x80000000
        if v and not fxv:
            self.throw(A2Error.UNDERFLOW)
        return fxv

    def num2int(self, v):
        fxv = int(v)
        if v > 2147483647.0 or v < -2147483648.0:
            self.throw(A2Error.OVERFLOW)
        if v != fxv:
            self.throw(A2Error.EXPINTEGER)
        return fxv

    def push_coder(self, program, func):
        self.coder = Coder(self.coder, program
                           or (self.coder.program if self.coder else None),
                           func)

    def pop_coder(self):
        cdr = self.coder
        if not cdr:
            self.throw(A2Error.INTERNAL)
        fn = cdr.program.funcs[cdr.func]
        fn.code = cdr.code + [int(Op.END)]
        fn.topreg = cdr.topreg
        if fn.topreg - fn.argv > 64:   # A2_MAXSAVEREGS bound
            self.throw(A2Error.LARGEFRAME)
        fn.decode()
        self.coder = cdr.prev

    def code(self, op, reg, arg):
        cdr = self.coder
        if self.nocode:
            self.throw(A2Error.NOCODE)
        op = int(op)
        if op >= int(Op.SIZEOFR) + 1:
            self.throw(A2Error.BADOPCODE)
        if op in (Op.SPAWN, Op.SPAWNR, Op.SEND, Op.WAIT, Op.KILL,
                  Op.DETACH):
            if reg > 255:
                self.throw(A2Error.INTERNAL)
        else:
            if reg >= A2_REGISTERS:
                self.throw(A2Error.BADREGISTER)
        if op in (Op.RAMPR, Op.RAMP, Op.SET):
            if self.regmap[reg] != RT_CONTROL:
                self.throw(A2Error.EXPCTRLREGISTER)
        if op == Op.END:
            if self.inhandler:
                self.throw(A2Error.INTERNAL)
        elif op == Op.RETURN:
            if not cdr.func:
                self.throw(A2Error.NORETURN)
        elif op in (Op.JUMP, Op.LOOP, Op.JZ, Op.JNZ, Op.JG, Op.JL,
                    Op.JGE, Op.JLE):
            if arg == A2_UNDEFJUMP:
                arg = 0
            else:
                if arg < 0:
                    self.throw(A2Error.BADJUMP)
                if arg == cdr.pos:
                    self.throw(A2Error.INFLOOP)
                if arg > cdr.pos:
                    self.throw(A2Error.BADJUMP)
        elif op in (Op.SPAWN, Op.SPAWNV, Op.SPAWND, Op.SPAWNA):
            if self.host.get_program(arg) is None:
                self.throw(A2Error.BADPROGRAM)
        elif op in (Op.SEND, Op.SENDR, Op.SENDA, Op.SENDS, Op.CALL):
            if not arg:
                self.throw(A2Error.BADENTRY)
            if arg > A2_MAXEPS:
                self.throw(A2Error.BADENTRY)
        elif op == Op.LOADR:
            if arg == reg:
                return    # NOP
        if op in (Op.LOADR, Op.ADDR, Op.SUBR, Op.MULR, Op.DIVR, Op.MODR,
                  Op.RANDR, Op.P2DR, Op.NEGR, Op.GR, Op.LR, Op.GER,
                  Op.LER, Op.EQR, Op.NER, Op.ANDR, Op.ORR, Op.XORR,
                  Op.NOTR, Op.QUANTR, Op.SPAWNR, Op.SPAWNVR, Op.RAMPR):
            if arg < 0 or arg > A2_REGISTERS:
                self.throw(A2Error.BADREG2)
        if ins_size(op) == 2:
            cdr.code.append(op | (reg << 8))
            cdr.code.append(arg & 0xFFFFFFFF)
        else:
            if arg < 0 or arg > 0xFFFF:
                self.throw(A2Error.BADIMMARG)
            cdr.code.append(op | (reg << 8) | (arg << 16))

    def codef(self, op, reg, arg):
        self.code(op, reg, self.num2vm(arg))

    def set_a2(self, pos, val):
        """Patch the a2 field of the instruction at word position 'pos'."""
        if val < 0 or val > 0xFFFF:
            self.throw(A2Error.BADIMMARG)
        w = self.coder.code[pos]
        self.coder.code[pos] = (w & 0xFFFF) | (val << 16)

    # ----- lexer -----

    def _getchar(self):
        pos = self.l[0].pos
        if pos >= len(self.source):
            return -1
        ch = self.source[pos]
        self.l[0].pos = pos + 1
        return ch

    def _ungetchar(self):
        self.l[0].pos -= 1

    def _getnum(self, ch):
        """Parse a decimal value (a2_GetNum).  Returns float or None
        (restoring position on failure)."""
        startpos = self.l[0].pos
        figures = 0
        sign = 1
        val = 0.0
        xp = 0
        modifier = None
        if ch == '-':
            sign = -1
            ch = self._getchar()
        while True:
            if isinstance(ch, str) and '0' <= ch <= '9':
                xp *= 10
                val = val * 10.0 + (ord(ch) - ord('0'))
                figures += 1
            elif ch == '.':
                if xp:
                    self.l[0].pos = startpos
                    return None    # A2_NEXPDECPOINT
                xp = 1
            elif ch in ('n', 'f'):
                if not figures or modifier:
                    self.l[0].pos = startpos
                    return None    # A2_NEXPMODIFIER
                modifier = ch
                if xp:
                    break
                xp = 1
            elif not figures:
                self.l[0].pos = startpos
                return None        # A2_BADVALUE
            else:
                self._ungetchar()
                break
            ch = self._getchar()
        val *= sign
        if xp:
            val /= xp
        if modifier == 'n':
            val /= 12.0
        elif modifier == 'f':
            val = f2p(val)
        return val

    def _get_int_num(self, base, figures):
        value = 0
        limitonly = figures < 0
        figures = abs(figures)
        got = 0
        while figures:
            figures -= 1
            ch = self._getchar()
            if isinstance(ch, str):
                c = ch.lower()
                if '0' <= c <= '9':
                    n = ord(c) - ord('0')
                elif 'a' <= c <= 'z':
                    n = ord(c) - ord('a') + 10
                else:
                    n = -1
            else:
                n = -1
            if n < 0 or n >= base:
                if n >= 0 or ch != -1:
                    if ch != -1:
                        self._ungetchar()
                if limitonly and got:
                    return value
                return -1
            value = value * base + n
            got += 1
        return value

    def _lex_string(self):
        buf = []
        while True:
            ch = self._getchar()
            if ch == -1:
                self.throw(A2Error.NEXPEOF)
            if ch == '\\':
                ch = self._getchar()
                if ch == -1:
                    self.throw(A2Error.NEXPEOF)
                if ch in '0123':
                    self._ungetchar()
                    v = self._get_int_num(8, -3)
                    if v < 0:
                        self.throw(A2Error.BADOCTESCAPE)
                    buf.append(chr(v))
                    continue
                esc = {'a': '\a', 'b': '\b', 'f': '\f', 'n': '\n',
                       'r': '\r', 't': '\t', 'v': '\v'}
                if ch == 'd':
                    v = self._get_int_num(10, -3)
                    if v < 0:
                        self.throw(A2Error.BADDECESCAPE)
                    buf.append(chr(v))
                    continue
                if ch == 'x':
                    v = self._get_int_num(16, -2)
                    if v < 0:
                        self.throw(A2Error.BADHEXESCAPE)
                    buf.append(chr(v))
                    continue
                buf.append(esc.get(ch, ch))
                continue
            if ch in '\n\r\t':
                continue
            if ch == '"':
                break
            buf.append(ch)
        s = "".join(buf)
        h = self.host.new_string(s)
        self.l[0].token = Tok.STRING
        self.l[0].value = h
        self.add_dependency(h)
        return self.l[0].token

    def _get_op_or_char(self, ch):
        nxt = self._getchar()
        if nxt == '=':
            m = {'>': Tok.GE, '<': Tok.LE, '=': Tok.EQ, '!': Tok.NE}
            if ch in m:
                self.l[0].token = m[ch]
                return self.l[0].token
        if nxt != -1:
            self._ungetchar()
        self.l[0].token = ord(ch)
        return self.l[0].token

    def skip_white(self, flags=0):
        while True:
            ch = self._getchar()
            if ch == '\n' and not (flags & self.WHITENEWLINE):
                self._ungetchar()
                return
            if ch in (' ', '\t', '\r', '\n'):
                continue
            if ch == '/':
                ch2 = self._getchar()
                if ch2 == '/':
                    while True:
                        ch2 = self._getchar()
                        if ch2 == -1:
                            return
                        if ch2 == '\n':
                            self._ungetchar()
                            break
                    continue
                if ch2 == '*':
                    prev = None
                    while True:
                        ch2 = self._getchar()
                        if ch2 == -1:
                            return
                        if prev == '*' and ch2 == '/':
                            break
                        prev = ch2
                    continue
                if ch2 != -1:
                    self._ungetchar()
                self._ungetchar()
                return
            if ch != -1:
                self._ungetchar()
            return

    def lex(self, flags=0):
        # shift lexer states
        for i in range(self.LEXDEPTH - 1, 0, -1):
            self.l[i].pos = self.l[i - 1].pos
            self.l[i].token = self.l[i - 1].token
            self.l[i].value = self.l[i - 1].value
        self.l[0].value = None

        self.skip_white(flags)
        ch = self._getchar()

        if ch == -1:
            self.l[0].token = Tok.EOF
            return self.l[0].token
        if ch == ',':
            self.throw(A2Error.BADDELIMITER)
        if ch in (';', '\n'):
            self.l[0].token = Tok.EOS
            self.l[0].value = ch
            return self.l[0].token
        if ch == '"':
            return self._lex_string()

        v = self._getnum(ch)
        if v is not None:
            nxt = self._getchar()
            if isinstance(nxt, str) and (nxt.isalnum() or nxt == '.'):
                self.throw(A2Error.NEXPTOKEN)
            if nxt != -1:
                self._ungetchar()
            self.l[0].token = Tok.VALUE
            self.l[0].value = v
            return self.l[0].token

        # identifier?
        nstart = self.l[0].pos - 1
        while isinstance(ch, str) and (ch.isascii() and (ch.isalnum()
                                                         or ch == '_')):
            ch = self._getchar()
        if nstart == self.l[0].pos - 1:
            return self._get_op_or_char(ch)
        if ch != -1:
            self._ungetchar()
        name = self.source[nstart:self.l[0].pos]

        s = self.find_symbol(self.symbols_for_lex, name)
        if s is not None:
            self.l[0].token = s.token
            if is_value(s.token):
                self.l[0].value = s.value
            elif is_symbol(s.token):
                self.l[0].value = s
            else:
                self.l[0].value = s.value
            return self.l[0].token

        if not (flags & self.NAMESPACE_ONLY):
            h = self._find_import(name)
            if h is not None:
                return self._handle2token(h)

        s = Symbol(name, Tok.NAME)
        self.l[0].token = Tok.NAME
        self.l[0].value = s
        return self.l[0].token

    @property
    def symbols_for_lex(self):
        return self._ns_symbols if self._ns_symbols is not None \
            else self.symbols

    _ns_symbols = None

    def lex_namespace(self, namespace, flags=0):
        """Lex one token considering only 'namespace' symbols."""
        save = self._ns_symbols
        self._ns_symbols = namespace if namespace is not None else []
        try:
            if namespace is None:
                # bank member lookup: lex a plain name
                self._ns_symbols = []
                return self.lex(self.NAMESPACE_ONLY | flags)
            return self.lex(self.NAMESPACE_ONLY | flags)
        finally:
            self._ns_symbols = save

    def unlex(self):
        if not self.l[0].token:
            self.throw(A2Error.INTERNAL)
        for i in range(1, self.LEXDEPTH):
            self.l[i - 1].pos = self.l[i].pos
            self.l[i - 1].token = self.l[i].token
            self.l[i - 1].value = self.l[i].value
        self.l[self.LEXDEPTH - 1].token = 0
        self.l[self.LEXDEPTH - 1].value = None

    def drop_token(self):
        pos = self.l[0].pos
        self.unlex()
        self.l[0].pos = pos

    def set_token(self, tk, value):
        self.l[0].token = tk
        self.l[0].value = value

    def _find_import(self, name):
        for bh in self.imports:
            h = self.host.bank_get(bh, name)
            if h is not None and h >= 0:
                return h
        return None

    def _handle2token(self, h):
        t = self.host.typeof(h)
        m = {A2ObjType.BANK: Tok.BANK, A2ObjType.WAVE: Tok.WAVE,
             A2ObjType.UNIT: Tok.UNIT, A2ObjType.PROGRAM: Tok.PROGRAM,
             A2ObjType.STRING: Tok.STRING}
        if t == A2ObjType.CONSTANT:
            self.set_token(Tok.VALUE, self.host.value_of(h))
            return Tok.VALUE
        tk = m.get(t)
        if tk is None:
            self.throw(A2Error.INTERNAL)
        self.set_token(tk, h)
        return tk

    # ----- token accessors -----

    def get_value(self, l):
        if l.token != Tok.VALUE:
            self.throw(A2Error.INTERNAL)
        return l.value

    def get_handle(self, l):
        if l.token not in (Tok.STRING, Tok.BANK, Tok.WAVE, Tok.UNIT,
                           Tok.PROGRAM):
            self.throw(A2Error.INTERNAL)
        return l.value

    def get_index(self, l):
        if l.token in (Tok.TEMPREG, Tok.REGISTER, Tok.FUNCTION,
                       Tok.INSTRUCTION):
            return l.value
        if l.token == Tok.LABEL:
            return l.value.value
        self.throw(A2Error.INTERNAL)

    def grab_symbol(self, l):
        if not is_symbol(l.token):
            self.throw(A2Error.INTERNAL)
        return l.value

    # ----- dependencies / scopes -----

    def add_dependency(self, h):
        if self.target.add_dep(h):
            self.host.retain(h)

    def begin_scope(self):
        sc = (len(self.symbols), list(self.regmap), self.canexport)
        self.canexport = False
        return sc

    def end_scope(self, sc):
        """Unwind symbols; export A2_SF_EXPORTED ones to the bank's
        export table, and record the rest in the private table when the
        current context allows exports (a2c_EndScope)."""
        nsyms, regmap, canexport = sc
        self.regmap = regmap
        err = None
        while len(self.symbols) > nsyms:
            s = self.symbols.pop()
            if s.token == Tok.FWDECL:
                err = A2Error.UNDEFSYM
            h = -1
            if s.token in (Tok.BANK, Tok.WAVE, Tok.UNIT, Tok.PROGRAM,
                           Tok.STRING):
                h = s.value
            elif s.token == Tok.VALUE and s.exported:
                h = self.host.new_constant(s.value)
            if s.exported:
                if h >= 0:
                    self.target.exports[s.name] = h
            elif self.canexport and h >= 0:
                self.target.private[s.name] = h
        if err:
            self.throw(err)
        self.canexport = canexport

    def clean_scope(self, sc):
        nsyms, regmap, canexport = sc
        self.regmap = regmap
        del self.symbols[nsyms:]
        for lv in self.l:
            lv.token = 0
            lv.value = None
        self.canexport = canexport

    # ----- parser helpers -----

    def expect(self, tk, err):
        if self.lex() != tk:
            self.throw(err)

    def value(self):
        self.expect(Tok.VALUE, A2Error.EXPVALUE)
        return self.get_value(self.l[0])

    def branch(self, op, to):
        """Emit a conditional branch on the current token.  Returns the
        emitted instruction's word position (for fixup), or None."""
        l0 = self.l[0]
        if is_value(l0.token):
            r = self.alloc_reg(RT_TEMPORARY)
            self.codef(Op.LOAD, r, self.get_value(l0))
            fixpos = self.coder.pos
            self.code(op, r, to)
            self.free_reg(r)
            return fixpos
        if is_register(l0.token):
            r = self.get_index(l0)
            fixpos = self.coder.pos
            self.code(op, r, to)
            if l0.token == Tok.TEMPREG:
                self.free_reg(r)
            return fixpos
        self.throw(A2Error.INTERNAL)

    def var_decl(self, s):
        s.token = Tok.REGISTER
        s.value = self.alloc_reg(RT_VARIABLE)
        self.push_symbol(self.symbols, s)

    # constant folding (a2c_DoUnop / a2c_DoOp)
    def do_unop(self, op, v):
        if op == Op.P2DR:
            return 1000.0 / (p2if(v) * 261.626)
        if op == Op.NEGR:
            return -v
        if op == Op.NOTR:
            return 0.0 if v else 1.0
        self.throw(A2Error.INTERNAL)

    def do_op(self, op, vl, vr):
        if op == Op.MOD:
            if not vr:
                self.throw(A2Error.DIVBYZERO)
            return math.fmod(vl, vr)
        if op == Op.ADD:
            return vl + vr
        if op == Op.MUL:
            return vl * vr
        if op == Op.QUANT:
            if not vr:
                self.throw(A2Error.DIVBYZERO)
            return math.floor(vl / vr) * vr
        if op == Op.SUBR:
            return vl - vr
        if op == Op.DIVR:
            if not vr:
                self.throw(A2Error.DIVBYZERO)
            return vl / vr
        if op == Op.GR:
            return 1.0 if vl > vr else 0.0
        if op == Op.LR:
            return 1.0 if vl < vr else 0.0
        if op == Op.GER:
            return 1.0 if vl >= vr else 0.0
        if op == Op.LER:
            return 1.0 if vl <= vr else 0.0
        if op == Op.EQR:
            return 1.0 if vl == vr else 0.0
        if op == Op.NER:
            return 1.0 if vl != vr else 0.0
        if op == Op.ANDR:
            return 1.0 if vl and vr else 0.0
        if op == Op.ORR:
            return 1.0 if vl or vr else 0.0
        if op == Op.XORR:
            return 1.0 if (not vl) != (not vr) else 0.0
        self.throw(A2Error.INTERNAL)

    def code_op_r(self, op, to, r):
        if op in (Op.ADD, Op.MUL, Op.MOD, Op.QUANT, Op.RAND, Op.LOAD,
                  Op.SIZEOF):
            self.code(op + 1, to, r)
        elif op in (Op.DELAY, Op.TDELAY, Op.DEBUG):
            self.code(op + 1, r, 0)
        elif op in (Op.SUBR, Op.DIVR, Op.P2DR, Op.NEGR, Op.GR, Op.LR,
                    Op.GER, Op.LER, Op.EQR, Op.NER, Op.ANDR, Op.ORR,
                    Op.XORR, Op.NOTR):
            self.code(op, to, r)
        else:
            self.throw(A2Error.INTERNAL)

    def code_op_v(self, op, to, v):
        if op in (Op.MOD, Op.QUANT):
            if not v:
                self.throw(A2Error.DIVBYZERO)
            self.codef(op, to, v)
        elif op in (Op.ADD, Op.MUL, Op.RAND, Op.LOAD, Op.DELAY,
                    Op.TDELAY, Op.DEBUG):
            self.codef(op, to, v)
        elif op == Op.SUBR:
            self.codef(Op.ADD, to, -v)
        elif op == Op.DIVR:
            if not v:
                self.throw(A2Error.DIVBYZERO)
            self.codef(Op.MUL, to, 1.0 / v)
        else:
            if op in (Op.RAND, Op.P2DR, Op.NEGR, Op.NOTR):
                tmpr = to
            else:
                tmpr = self.alloc_reg(RT_TEMPORARY)
            self.codef(Op.LOAD, tmpr, v)
            self.code_op_r(op, to, tmpr)
            if tmpr != to:
                self.free_reg(tmpr)

    def code_op_h(self, op, to, h):
        if op == Op.SIZEOF:
            self.code(op, to, h)
        elif op == Op.LOAD:
            self.code(op, to, (h << 16) & 0xFFFFFFFF)
        else:
            self.throw(A2Error.INTERNAL)

    def code_op_l(self, op, to, l):
        if is_register(l.token):
            self.code_op_r(op, to, self.get_index(l))
        elif is_handle(l.token):
            self.code_op_h(op, to, self.get_handle(l))
        elif is_value(l.token):
            self.code_op_v(op, to, self.get_value(l))
        else:
            self.throw(A2Error.INTERNAL)

    # ----- expressions -----

    def namespace(self):
        """Dive into namespaces / banks (a2c_Namespace)."""
        in_namespace = False
        while self.l[0].token == Tok.NAMESPACE:
            ns = self.l[0].value.symbols
            if self.lex() != ord('.'):
                self.unlex()
                return in_namespace
            in_namespace = True
            self.lex_namespace(ns)
        while self.l[0].token == Tok.BANK:
            bh = self.l[0].value
            if self.lex() != ord('.'):
                self.unlex()
                break
            in_namespace = True
            if self.lex_namespace(None) != Tok.NAME:
                self.throw(A2Error.EXPNAME)
            h = self.host.bank_get(bh, self.l[0].value.name)
            if h is None or h < 0:
                self.throw(A2Error.NOTFOUND)
            self._handle2token(h)
        return in_namespace

    def variable(self):
        self.lex()
        self.namespace()
        if self.l[0].token != Tok.REGISTER:
            self.throw(A2Error.EXPVARIABLE)
        return self.get_index(self.l[0])

    def simplexp(self, r):
        self.lex()
        in_namespace = self.namespace()
        tk = self.l[0].token
        if tk in (Tok.VALUE, Tok.WAVE, Tok.PROGRAM, Tok.STRING,
                  Tok.LABEL, Tok.REGISTER, Tok.NAMESPACE):
            return
        if tk == ord('('):
            if in_namespace:
                self.throw(A2Error.NEXPTOKEN)
            self.expression(r, ord(')'))
            return
        if tk == ord('-'):
            tmpr = r
            self.simplexp(r)
            if self.l[0].token == Tok.VALUE:
                self.set_token(Tok.VALUE,
                               self.do_unop(Op.NEGR,
                                            self.get_value(self.l[0])))
                return
            if r < 0 and self.l[0].token != Tok.TEMPREG:
                tmpr = self.alloc_reg(RT_TEMPORARY)
            elif r < 0:
                tmpr = self.get_index(self.l[0])
            self.code_op_l(Op.NEGR, tmpr, self.l[0])
            self.set_token(Tok.TEMPREG if r < 0 else Tok.REGISTER, tmpr)
            return
        if tk == Tok.INSTRUCTION:
            tmpr = r
            op = self.get_index(self.l[0])
            if op not in (Op.P2DR, Op.RAND, Op.NEGR, Op.NOTR, Op.SIZEOF):
                self.throw(A2Error.NOTUNARY)
            self.simplexp(r)
            if self.l[0].token == Tok.VALUE and op in (Op.P2DR, Op.NEGR,
                                                       Op.NOTR):
                self.set_token(Tok.VALUE,
                               self.do_unop(op,
                                            self.get_value(self.l[0])))
                return
            if r < 0 and self.l[0].token != Tok.TEMPREG:
                tmpr = self.alloc_reg(RT_TEMPORARY)
            elif r < 0:
                tmpr = self.get_index(self.l[0])
            self.code_op_l(op, tmpr, self.l[0])
            self.set_token(Tok.TEMPREG if r < 0 else Tok.REGISTER, tmpr)
            return
        self.throw(A2Error.EXPEXPRESSION)

    def expression(self, r, delim):
        """Parse expression; returns True if 'simple' (single term)."""
        simple = True
        res_tk = Tok.REGISTER
        self.simplexp(r)
        if is_handle(self.l[0].token):
            self.throw(A2Error.NEXPHANDLE)
        while True:
            tk = self.lex(self.WHITENEWLINE)
            if tk in _BINOP_CHARS:
                op = _BINOP_CHARS[tk]
            elif tk == Tok.INSTRUCTION:
                op = self.get_index(self.l[0])
                if op not in _BINOPS:
                    if not delim:
                        self.unlex()
                        return simple
                    self.throw(A2Error.EXPBINOP)
            else:
                if delim:
                    if self.l[0].token != delim:
                        self.throw(A2Error.EXPOP)
                    self.drop_token()
                else:
                    self.unlex()
                return simple

            simple = False
            lopr_token = self.l[1].token
            lopr_value = self.l[1].value

            self.skip_white(self.WHITENEWLINE)
            self.simplexp(-1)
            if is_handle(self.l[0].token):
                self.throw(A2Error.NEXPHANDLE)

            if lopr_token == Tok.VALUE and self.l[0].token == Tok.VALUE:
                self.set_token(Tok.VALUE,
                               self.do_op(op, lopr_value,
                                          self.get_value(self.l[0])))
                continue

            class _L:
                pass
            lopr = _L()
            lopr.token = lopr_token
            lopr.value = lopr_value

            if r < 0:
                if lopr_token == Tok.TEMPREG:
                    r = lopr_value
                else:
                    r = self.alloc_reg(RT_TEMPORARY)
                res_tk = Tok.TEMPREG

            if is_register(self.l[0].token) \
                    and self.get_index(self.l[0]) == r:
                self.throw(A2Error.INTERNAL)

            self.code_op_l(Op.LOAD, r, lopr)
            if lopr_token == Tok.TEMPREG and lopr_value != r:
                self.free_reg(lopr_value)

            self.code_op_l(op, r, self.l[0])
            if self.l[0].token == Tok.TEMPREG:
                self.free_reg(self.get_index(self.l[0]))
            self.set_token(res_tk, r)

    # ----- arguments -----

    def arguments(self, maxargc):
        argc = 0
        while argc <= maxargc:
            self.lex()
            if is_eos(self.l[0].token):
                self.unlex()
                return
            self.unlex()
            self.simplexp(-1)
            l0 = self.l[0]
            if is_value(l0.token):
                self.codef(Op.PUSH, 0, self.get_value(l0))
            elif is_handle(l0.token):
                self.code(Op.PUSH, 0,
                          (self.get_handle(l0) << 16) & 0xFFFFFFFF)
            elif is_register(l0.token):
                rr = self.get_index(l0)
                self.code(Op.PUSHR, rr, 0)
                if l0.token == Tok.TEMPREG:
                    self.free_reg(rr)
            else:
                self.throw(A2Error.INTERNAL)
            argc += 1
        self.throw(A2Error.MANYARGS)

    def const_arguments(self, maxargc, argv):
        argc = 0
        while argc <= maxargc:
            self.lex()
            if is_eos(self.l[0].token):
                self.unlex()
                return argc
            self.unlex()
            self.simplexp(-1)
            l0 = self.l[0]
            if is_value(l0.token):
                argv.append(self.num2vm(self.get_value(l0)))
            elif is_handle(l0.token):
                argv.append((self.get_handle(l0) << 16) & 0xFFFFFFFF)
            else:
                self.throw(A2Error.EXPCONSTANT)
            argc += 1
        self.throw(A2Error.MANYARGS)

    # ----- instructions -----

    def instruction(self, op, r=0):
        op = Op(op)
        if op in (Op.END, Op.SLEEP, Op.RETURN):
            self.code(op, 0, 0)
            return
        if op in (Op.WAKE, Op.FORCE, Op.JUMP):
            if op in (Op.WAKE, Op.FORCE) and not self.inhandler:
                self.throw(A2Error.NOWAKEFORCE)
            self.lex()
            if self.l[0].token not in (Tok.LABEL, Tok.FWDECL):
                self.throw(A2Error.EXPLABEL)
            self.code(op, 0, self.get_index(self.l[0]))
            return
        if op == Op.LOOP:
            r = self.variable()
            self.expect(Tok.LABEL, A2Error.EXPLABEL)
            self.code(op, r, self.get_index(self.l[0]))
            return
        if op in (Op.JZ, Op.JNZ, Op.JG, Op.JL, Op.JGE, Op.JLE):
            self.simplexp(-1)
            self.expect(Tok.LABEL, A2Error.EXPLABEL)
            i = self.get_index(self.l[0])
            self.drop_token()
            self.branch(op, i)
            return
        if op in (Op.SPAWN, Op.SPAWNV, Op.SPAWND, Op.SPAWNA):
            tk = self.l[0].token
            if tk == Tok.REGISTER:
                op = Op(op + 1)
                p = self.get_index(self.l[0])
                maxa = A2_MAXARGS
            elif tk == Tok.PROGRAM:
                p = self.get_handle(self.l[0])
                maxa = self.host.get_program(p).funcs[0].argc
            else:
                self.throw(A2Error.EXPPROGRAM)
            self.arguments(maxa)
            if op in (Op.SPAWNDR, Op.SPAWNAR):
                self.code(op, p, 0)
            elif op in (Op.SPAWN, Op.SPAWNR) and r > 255:
                tmpr = self.alloc_reg(RT_TEMPORARY)
                self.codef(Op.LOAD, tmpr, r)
                self.code(op, tmpr, p)
                self.free_reg(tmpr)
            else:
                self.code(op, r, p)
            return
        if op == Op.CALL:
            self.expect(Tok.FUNCTION, A2Error.EXPFUNCTION)
            p = self.get_index(self.l[0])
            if p >= self.coder.program.nfuncs:
                self.throw(A2Error.BADENTRY)
            maxa = self.coder.program.funcs[p].argc
            self.arguments(maxa)
            self.code(op, r, p)
            return
        if op == Op.WAIT:
            if self.inhandler:
                self.throw(A2Error.NORUN)
            self.code(op, self.num2int(self.value()), 0)
            return
        if op in (Op.SEND, Op.SENDR, Op.SENDA, Op.SENDS):
            p = self.num2int(self.value())
            if not p:
                self.throw(A2Error.BADENTRY)
            self.arguments(A2_MAXARGS)
            if op == Op.SEND and r > 255:
                tmpr = self.alloc_reg(RT_TEMPORARY)
                self.codef(Op.LOAD, tmpr, r)
                self.code(op, tmpr, p)
                self.free_reg(tmpr)
            else:
                self.code(op, r, p)
            return
        if op in (Op.KILL, Op.DETACH):
            self.lex()
            if is_eos(self.l[0].token):
                self.unlex()
                self.code(op + 2, 0, 0)       # KILLA/DETACHA
                return
            self.unlex()
            self.simplexp(-1)
            l0 = self.l[0]
            if is_value(l0.token):
                rr = self.num2int(self.get_value(l0))
                if rr > 255:
                    tmpr = self.alloc_reg(RT_TEMPORARY)
                    self.codef(Op.LOAD, tmpr, rr)
                    self.code(op, tmpr, 0)
                    self.free_reg(tmpr)
                else:
                    self.code(op, rr, 0)
            elif is_register(l0.token):
                op = Op(op + 1)               # KILLR/DETACHR
                rr = self.get_index(l0)
                self.code(op, rr, 0)
                if l0.token == Tok.TEMPREG:
                    self.free_reg(rr)
            else:
                self.throw(A2Error.EXPVOICEEOS)
            return
        if op == Op.SET:
            self.lex()
            if is_eos(self.l[0].token):
                self.unlex()
                self.code(Op.SETALL, 0, 0)
                return
            self.unlex()
            self.code(Op.SET, self.variable(), 0)
            return
        if op == Op.RAMP:
            self.simplexp(-1)
            self.lex()
            if is_eos(self.l[0].token):
                self.unlex()
                op = Op.RAMPALL
                r = 0
            else:
                self.unlex()
                r = self.get_index(self.l[0])
                self.simplexp(-1)
            l0 = self.l[0]
            if is_register(l0.token):
                op = Op(op + 1)
                if op == Op.RAMPALLR:
                    self.code(op, self.get_index(l0), 0)
                else:
                    self.code(op, r, self.get_index(l0))
                if l0.token == Tok.TEMPREG:
                    self.free_reg(self.get_index(l0))
            elif is_value(l0.token):
                self.codef(op, r, self.get_value(l0))
            else:
                self.throw(A2Error.EXPEXPRESSION)
            return
        if op in (Op.DELAY, Op.TDELAY, Op.DEBUG):
            if op in (Op.DELAY, Op.TDELAY) and self.inhandler:
                self.throw(A2Error.NOTIMING)
            self.simplexp(-1)
            self.code_op_l(op, 0, self.l[0])
            if self.l[0].token == Tok.TEMPREG:
                self.free_reg(self.get_index(self.l[0]))
            return
        if op in (Op.ADD, Op.SUBR, Op.MUL, Op.DIVR, Op.MOD, Op.QUANT,
                  Op.RAND, Op.P2DR, Op.NEGR, Op.NOTR, Op.SIZEOF):
            self.lex()
            self.namespace()
            tk = self.l[0].token
            if tk == ord('!'):
                if op not in (Op.RAND, Op.P2DR, Op.NEGR, Op.NOTR):
                    self.throw(A2Error.BADVARDECL)
                self.expect(Tok.NAME, A2Error.EXPNAME)
                s = self.grab_symbol(self.l[0])
                self.var_decl(s)
                r = s.value
            elif tk == Tok.REGISTER:
                r = self.get_index(self.l[0])
            else:
                self.throw(A2Error.EXPVARIABLE)
            self.simplexp(r if op in (Op.RAND, Op.P2DR, Op.NEGR,
                                      Op.NOTR) else -1)
            self.code_op_l(op, r, self.l[0])
            if self.l[0].token == Tok.TEMPREG:
                self.free_reg(self.get_index(self.l[0]))
            return
        self.throw(A2Error.INTERNAL)

    # ----- import / def -----

    def import_(self, export):
        tk = self.lex()
        if tk == Tok.STRING:
            nameh = self.l[0].value
            name = self.host.string_of(nameh)
        elif tk == Tok.NAME:
            name = self.l[0].value.name
            nameh = None
        else:
            self.throw(A2Error.EXPSTRINGORNAME)
        h = None
        if self.path:
            import os
            try:
                h = self.host.load(os.path.join(self.path, name))
            except Exception:
                h = None
        if h is None:
            try:
                h = self.host.load(name)
            except Exception as e:
                self.throw(getattr(e, "code", A2Error.OPEN))
        self.add_dependency(h)
        if self.lex() == Tok.KW_AS:
            self.expect(Tok.NAME, A2Error.EXPNAME)
            s = Symbol(self.l[0].value.name, Tok.BANK, h)
            if export:
                s.exported = True
            self.push_symbol(self.symbols, s)
        else:
            self.unlex()
            self.imports.append(h)
            if export:
                bank = self.host.bank_of(h)
                for n, eh in bank.exports.items():
                    self.target.exports[n] = eh

    def def_(self, export):
        self.expect(Tok.NAME, A2Error.EXPNAME)
        s = self.grab_symbol(self.l[0])
        if export:
            s.exported = True
        self.simplexp(-1)
        tk = self.l[0].token
        if tk == Tok.VALUE:
            s.token = Tok.VALUE
            s.value = self.get_value(self.l[0])
        elif tk == Tok.REGISTER:
            if export:
                self.throw(A2Error.NOEXPORT)
            s.token = tk
            s.value = self.get_index(self.l[0])
        elif tk in (Tok.WAVE, Tok.PROGRAM, Tok.STRING):
            s.token = tk
            s.value = self.get_handle(self.l[0])
        else:
            if not is_symbol(tk):
                self.throw(A2Error.BADVALUE)
            s.token = Tok.ALIAS
            s.value = self.l[0].value
        self.push_symbol(self.symbols, s)

    # ----- declarations -----

    def arglist(self, fn):
        nextr = self.alloc_reg(RT_ARGUMENT)
        fn.argv = nextr
        self.free_reg(nextr)
        fn.argc = 0
        while self.lex(self.WHITENEWLINE) != ord(')'):
            if fn.argc > A2_MAXARGS:
                self.throw(A2Error.MANYARGS)
            if self.l[0].token != Tok.NAME:
                self.throw(A2Error.EXPNAME)
            s = self.grab_symbol(self.l[0])
            self.var_decl(s)
            if s.value != nextr:
                self.throw(A2Error.INTERNAL)
            nextr += 1
            if self.lex() == ord('='):
                self.lex()
                self.namespace()
                l0 = self.l[0]
                if is_value(l0.token):
                    v = self.num2vm(self.get_value(l0))
                elif is_handle(l0.token):
                    v = (self.get_handle(l0) << 16) & 0xFFFFFFFF
                else:
                    self.throw(A2Error.EXPVALUEHANDLE)
                fn.argdefs[fn.argc] = v
            else:
                self.unlex()
            fn.argc += 1

    def _add_unit_constants(self, ud, namespace):
        for name, v in ud.constants:
            if self.find_symbol(namespace, name):
                self.throw(A2Error.SYMBOLDEF)
            self.push_symbol(namespace, Symbol(name, Tok.VALUE,
                                               v / 65536.0))

    def _add_unit(self, namespace, uindex, inputs, outputs):
        ud = self.host.unit_descs()[uindex]
        p = self.coder.program
        ind = len(p.units)
        p.units.append(UnitItem(uindex, inputs, outputs))
        if namespace is None:
            namespace = self.symbols
        # registers
        for rn in ud.registers:
            if self.find_symbol(namespace, rn):
                self.throw(A2Error.SYMBOLDEF)
            s = Symbol(rn, Tok.REGISTER, self.alloc_reg(RT_CONTROL))
            self.push_symbol(namespace, s)
        # control outputs
        for i, cn in enumerate(ud.coutputs):
            if self.find_symbol(namespace, cn):
                self.throw(A2Error.SYMBOLDEF)
            s = Symbol(cn, Tok.COUTPUT, (ind, i))
            self.push_symbol(namespace, s)
        self._add_unit_constants(ud, namespace)

    def iospec(self, minv, maxv, outputs):
        tk = self.lex()
        if tk == Tok.VALUE:
            val = self.num2int(self.get_value(self.l[0]))
            if val < minv or val > maxv:
                self.throw(A2Error.VALUERANGE)
            return val
        if tk == ord('*'):
            if not maxv:
                self.throw(A2Error.CANTOUTPUT if outputs
                           else A2Error.CANTINPUT)
            return A2_IO_MATCHOUT
        if tk == ord('>'):
            if not outputs:
                self.throw(A2Error.NOTOUTPUT)
            if not maxv:
                self.throw(A2Error.CANTOUTPUT)
            return A2_IO_WIREOUT
        self.unlex()
        return A2_IO_DEFAULT

    def unitspec(self):
        uh = self.get_handle(self.l[0])
        uindex = self.host.unit_index(uh)
        ud = self.host.unit_descs()[uindex]
        namespace = None
        if self.lex() == Tok.NAME:
            namespace = self.create_namespace(None,
                                              self.l[0].value.name)
        else:
            self.unlex()
        inputs = self.iospec(ud.mininputs, ud.maxinputs, False)
        outputs = self.iospec(ud.minoutputs, ud.maxoutputs, True)
        self._add_unit(namespace, uindex, inputs, outputs)

    def wirespec(self):
        self.lex()
        self.namespace()
        tk = self.l[0].token
        if tk == Tok.VALUE:
            self.throw(A2Error.NOTIMPLEMENTED)   # audio wires
        if tk == Tok.COUTPUT:
            frm = self.l[0].value
            inst, idx = frm.value
            for w in self.coder.program.wires:
                if w.from_unit == inst and w.from_output == idx:
                    self.throw(A2Error.COUTWIRED)
            self.lex()
            self.namespace()
            if self.l[0].token != Tok.REGISTER:
                self.throw(A2Error.EXPCTRLREGISTER)
            self.coder.program.wires.append(
                WireItem(inst, idx, self.l[0].value))
            return
        self.throw(A2Error.NEXPTOKEN)

    def struct_statement(self, terminator):
        tk = self.lex()
        if tk == Tok.UNIT:
            self.unitspec()
        elif tk == Tok.KW_WIRE:
            self.wirespec()
        elif tk == Tok.EOS:
            return True
        else:
            if self.l[0].token != terminator:
                self.throw(A2Error.NEXPTOKEN)
            return False
        if self.lex() == Tok.EOS:
            return True
        if self.l[0].token != terminator:
            self.throw(A2Error.EXPEOS)
        return False

    def _downstream_inputs(self, units, start):
        for si in units[start:]:
            ud = self.host.unit_descs()[si.uindex]
            if not ud.maxinputs:
                continue
            if si.ninputs:
                return True
        return False

    def structdef(self):
        p = self.coder.program
        matchout = False
        chainchannels = 0
        if self.lex(self.WHITENEWLINE) != Tok.KW_STRUCT:
            self.unlex()
            return
        self.expect(ord('{'), A2Error.EXPBODY)
        while self.struct_statement(ord('}')):
            pass
        # Autowiring (a2c_StructDef, compiler.c:3009-3188)
        for idx, si in enumerate(p.units):
            ud = self.host.unit_descs()[si.uindex]
            if ud.name == "inline":
                if p.vflags & A2_SUBINLINE:
                    self.throw(A2Error.MULTIINLINE)
                p.vflags |= A2_SUBINLINE
            # inputs
            if si.ninputs == 0:
                if chainchannels:
                    si.flags |= A2_PROCADD
            elif si.ninputs == A2_IO_DEFAULT:
                si.ninputs = ud.mininputs
            elif si.ninputs == A2_IO_MATCHOUT:
                matchout = True
            elif si.ninputs == A2_IO_WIREOUT:
                self.throw(A2Error.INTERNAL)
            if si.ninputs:
                # If we have inputs, there must be a chain going, with a
                # matching channel count (raw A2_iocodes compare, like
                # the reference at compiler.c:3056-3066).
                if not chainchannels:
                    self.throw(A2Error.NOINPUT)
                elif si.ninputs != chainchannels:
                    self.throw(A2Error.CHAINMISMATCH)
            # outputs
            dsi = self._downstream_inputs(p.units, idx + 1)
            if si.noutputs == A2_IO_DEFAULT:
                if idx + 1 >= len(p.units) or not dsi:
                    si.noutputs = A2_IO_WIREOUT
                elif chainchannels:
                    si.noutputs = chainchannels
                    if 0 < si.noutputs < ud.minoutputs:
                        self.throw(A2Error.FEWCHANNELS)
                else:
                    si.noutputs = ud.minoutputs
            elif si.noutputs == A2_IO_MATCHOUT:
                matchout = True
            if si.noutputs == A2_IO_WIREOUT:
                chainchannels = 0
                si.flags |= A2_PROCADD
            elif si.noutputs:
                if idx + 1 >= len(p.units):
                    self.throw(A2Error.NOOUTPUT)
                if not dsi:
                    self.throw(A2Error.BLINDCHAIN)
                if chainchannels and not si.ninputs:
                    si.flags |= A2_PROCADD
                chainchannels = si.noutputs
            if si.ninputs > p.buffers:
                p.buffers = si.ninputs
            if p.buffers and si.noutputs > p.buffers:
                p.buffers = si.noutputs
        if matchout:
            p.buffers = -p.buffers if p.buffers else -1

    def progdef(self, s, export):
        if s.token != Tok.NAME:
            self.throw(A2Error.EXPNAME)
        if self.coder or self.inhandler:
            self.throw(A2Error.NOPROGHERE)
        s.token = Tok.PROGRAM
        p = Program(name=s.name)
        s.value = self.host.new_program(p)
        self.add_dependency(s.value)
        if export:
            s.exported = True
        self.push_symbol(self.symbols, s)
        self.push_coder(p, 0)
        p.funcs.append(Function())
        p.eps[0] = 0
        sc = self.begin_scope()
        self.arglist(p.funcs[0])
        self.skip_white(self.WHITENEWLINE)
        self.expect(ord('{'), A2Error.EXPBODY)
        self.structdef()
        self.inhandler = False
        self.nocode = False
        if p.units:
            self.code(Op.INITV, 0, 0)
        self.body()
        if not self.nocode:
            self.code(Op.END, 0, 0)
        self.end_scope(sc)
        self.pop_coder()
        self.nocode = True

    def funcdef(self, s):
        if s.token != Tok.NAME:
            self.throw(A2Error.EXPNAME)
        if not self.coder or not self.coder.program or self.inhandler:
            self.throw(A2Error.NOFUNCHERE)
        p = self.coder.program
        f = len(p.funcs)
        p.funcs.append(Function())
        s.token = Tok.FUNCTION
        s.value = f
        self.push_symbol(self.symbols, s)
        self.push_coder(None, f)
        sc = self.begin_scope()
        self.arglist(p.funcs[f])
        self.skip_white(self.WHITENEWLINE)
        self.expect(ord('{'), A2Error.EXPBODY)
        self.body()
        self.code(Op.RETURN, 0, 0)
        self.end_scope(sc)
        self.pop_coder()

    def msgdef(self, ep):
        if ep >= A2_MAXEPS:
            self.throw(A2Error.BADENTRY)
        if not self.coder or not self.coder.program or self.inhandler:
            self.throw(A2Error.NOMSGHERE)
        p = self.coder.program
        f = len(p.funcs)
        p.funcs.append(Function())
        p.eps[ep] = f
        self.push_coder(None, f)
        sc = self.begin_scope()
        self.arglist(p.funcs[f])
        self.skip_white(self.WHITENEWLINE)
        self.expect(ord('{'), A2Error.EXPBODY)
        self.inhandler = True
        self.nocode = False
        self.body()
        self.code(Op.RETURN, 0, 0)
        self.inhandler = False
        self.end_scope(sc)
        self.pop_coder()
        self.nocode = True

    # ----- wave definitions -----

    def wavedef(self, export):
        wd = {
            "type": WaveType.MIPWAVE,
            "period": 0,
            "flags": 0,
            "samplerate": 48000,
            "length": 0,
            "duration": 0.0,
            "randseed": A2_DEFAULT_RANDSEED,
            "noiseseed": A2_DEFAULT_NOISESEED,
        }
        self.expect(Tok.NAME, A2Error.EXPNAME)
        sym = self.grab_symbol(self.l[0])
        sym.token = Tok.WAVE
        if export:
            sym.exported = True
        self.push_symbol(self.symbols, sym)
        self.skip_white(self.WHITENEWLINE)
        self.expect(ord('{'), A2Error.EXPBODY)
        sc = self.begin_scope()
        for name, tk, v in _WD_SYMS:
            if self.find_symbol(self.symbols, name) and tk != Tok.VALUE:
                pass
            s = Symbol(name, tk, float(v) if tk == Tok.VALUE else int(v))
            self.push_symbol(self.symbols, s)
        while self._wavedef_statement(wd, sym, ord('}')):
            pass
        self.end_scope(sc)

    def _wavedef_statement(self, wd, sym, terminator):
        tk = self.lex()
        if tk in (Tok.AT_PERIOD, Tok.AT_SAMPLERATE, Tok.AT_LENGTH,
                  Tok.AT_DURATION, Tok.AT_RANDSEED, Tok.AT_NOISESEED):
            self.simplexp(-1)
            if not is_value(self.l[0].token):
                self.throw(A2Error.EXPCONSTANT)
            v = self.get_value(self.l[0])
            if tk == Tok.AT_PERIOD:
                wd["period"] = self.num2int(v)
            elif tk == Tok.AT_SAMPLERATE:
                wd["samplerate"] = int(v)
            elif tk == Tok.AT_LENGTH:
                wd["length"] = self.num2int(v)
                wd["duration"] = 0.0
            elif tk == Tok.AT_DURATION:
                wd["duration"] = v
            elif tk == Tok.AT_RANDSEED:
                wd["randseed"] = int(v)
            elif tk == Tok.AT_NOISESEED:
                wd["noiseseed"] = int(v)
        elif tk == Tok.AT_WAVETYPE:
            self.expect(Tok.WAVETYPE, A2Error.EXPWAVETYPE)
            wd["type"] = WaveType(self.l[0].value)
        elif tk == Tok.AT_FLAG:
            flag = self.l[0].value
            setf = 1
            if is_value(self.lex()):
                setf = self.num2int(self.get_value(self.l[0]))
            else:
                self.unlex()
            if setf:
                wd["flags"] |= flag
            else:
                wd["flags"] &= ~flag
        elif tk == Tok.PROGRAM:
            self._wavedef_render(wd, sym, terminator)
            return False
        elif tk == Tok.EOS:
            return True
        else:
            if self.l[0].token != terminator:
                self.throw(A2Error.NEXPTOKEN)
            return False
        if self.lex() == Tok.EOS:
            return True
        if self.l[0].token != terminator:
            self.throw(A2Error.EXPEOS)
        return False

    def _wavedef_render(self, wd, sym, terminator):
        if wd["duration"]:
            wd["length"] = int(wd["duration"] * wd["samplerate"])
        program = self.get_handle(self.l[0])
        maxargc = self.host.get_program(program).funcs[0].argc
        argv = []
        self.const_arguments(maxargc, argv)
        h = self.host.render_wave(
            wd["type"], wd["period"], wd["flags"], wd["samplerate"],
            wd["length"], wd["randseed"], wd["noiseseed"], program, argv)
        sym.value = h
        while self.lex(self.WHITENEWLINE) != terminator:
            if self.l[0].token != Tok.EOS:
                self.throw(A2Error.EXPEOS)

    # ----- if/while/for/times -----

    def if_while(self, op, loop):
        loopto = self.coder.pos
        simple = self.expression(-1, 0)
        fixpos = self.branch(op, A2_UNDEFJUMP)
        self.skip_white(self.WHITENEWLINE)
        if not simple:
            self.expect(ord('{'), A2Error.EXPBODY)
            self.body()
        else:
            if self.lex() == Tok.IF:
                self.throw(A2Error.BADIFNEST)
            self.unlex()
            self.statement(Tok.EOS)
        braced = self.l[0].token == ord('}')
        if self.lex(self.WHITENEWLINE) == Tok.KW_ELSE:
            fixelse = self.coder.pos
            if loop:
                self.throw(A2Error.NEXPELSE)
            if not braced:
                self.throw(A2Error.BADELSE)
            self.code(Op.JUMP, 0, A2_UNDEFJUMP)
            if fixpos is not None and fixpos >= 0:
                self.set_a2(fixpos, self.coder.pos)
            braced = self.lex(self.WHITENEWLINE) == ord('{')
            self.unlex()
            self.skip_white(self.WHITENEWLINE if braced else 0)
            self.statement(Tok.EOS)
            self.set_a2(fixelse, self.coder.pos)
            return
        else:
            self.unlex()
        if loop:
            self.code(Op.JUMP, 0, loopto)
        if fixpos is not None and fixpos >= 0:
            self.set_a2(fixpos, self.coder.pos)

    def times_l(self):
        r = self.alloc_reg(RT_TEMPORARY)
        self.code_op_l(Op.LOAD, r, self.l[0])
        loopto = self.coder.pos
        self.skip_white(self.WHITENEWLINE)
        self.expect(ord('{'), A2Error.EXPBODY)
        self.body()
        self.code(Op.LOOP, r, loopto)
        self.free_reg(r)

    def for_(self):
        loopto = self.coder.pos
        self.skip_white(self.WHITENEWLINE)
        self.expect(ord('{'), A2Error.EXPBODY)
        self.body()
        self.code(Op.JUMP, 0, loopto)

    # ----- statements -----

    def statement(self, terminator):
        setprefix = False
        export = False
        self.lex()
        tk = self.l[0].token
        if tk == Tok.KW_EXPORT:
            if not self.canexport:
                self.throw(A2Error.CANTEXPORT)
            export = True
            self.lex()
            if self.l[0].token not in (Tok.NAME, Tok.KW_DEF, Tok.KW_WAVE,
                                       Tok.KW_IMPORT):
                self.throw(A2Error.NOEXPORT)
        elif tk == ord('@'):
            setprefix = True
            self.lex()
        if self.namespace():
            if self.l[0].token not in (Tok.VALUE, Tok.REGISTER,
                                       Tok.INSTRUCTION, Tok.PROGRAM,
                                       Tok.FUNCTION, Tok.KW_WAVE):
                self.throw(A2Error.NEXPTOKEN)
        if setprefix and self.l[0].token != Tok.REGISTER:
            self.throw(A2Error.EXPCTRLREGISTER)

        tk = self.l[0].token
        if tk == Tok.VALUE:
            r = self.num2int(self.get_value(self.l[0]))
            tk2 = self.lex()
            if tk2 == ord('('):
                self.msgdef(r)
                return True
            if tk2 == ord('{'):
                self.unlex()
                self.times_l()
                return True
            if tk2 == ord('<'):
                self.instruction(Op.SEND, r)
            elif tk2 == ord(':'):
                self.lex()
                self.namespace()
                self.instruction(Op.SPAWN, r)
            else:
                self.throw(A2Error.NEXPVALUE)
        elif tk == Tok.REGISTER:
            r = self.get_index(self.l[0])
            if setprefix and self.regmap[r] != RT_CONTROL:
                self.throw(A2Error.EXPCTRLREGISTER)
            tk2 = self.lex()
            if tk2 == ord('{'):
                self.unlex()
                self.times_l()
                return True
            if tk2 == ord('<'):
                self.instruction(Op.SENDR, r)
            elif tk2 == ord(':'):
                self.lex()
                self.namespace()
                self.instruction(Op.SPAWNV, r)
            else:
                self.unlex()
                self.simplexp(r)
                self.code_op_l(Op.LOAD, r, self.l[0])
                if setprefix:
                    self.code(Op.SET, r, 0)
        elif tk == ord('('):
            self.unlex()
            self.simplexp(-1)
            xtk = self.l[0].token
            if xtk == Tok.VALUE:
                r = self.num2int(self.get_value(self.l[0]))
                tk2 = self.lex()
                if tk2 == ord('{'):
                    self.unlex()
                    self.times_l()
                    return True
                if tk2 == ord('<'):
                    self.instruction(Op.SEND, r)
                elif tk2 == ord(':'):
                    self.lex()
                    self.namespace()
                    self.instruction(Op.SPAWN, r)
                else:
                    self.throw(A2Error.NEXPVALUE)
            elif xtk in (Tok.REGISTER, Tok.TEMPREG):
                r = self.get_index(self.l[0])
                tk2 = self.lex()
                if tk2 == ord('{'):
                    self.unlex()
                    self.times_l()
                    if xtk == Tok.TEMPREG:
                        self.free_reg(r)
                    return True
                if tk2 == ord('<'):
                    self.instruction(Op.SENDR, r)
                elif tk2 == ord(':'):
                    self.lex()
                    self.namespace()
                    self.instruction(Op.SPAWNV, r)
                else:
                    self.throw(A2Error.NEXPTOKEN)
                if xtk == Tok.TEMPREG:
                    self.free_reg(r)
            else:
                self.throw(A2Error.NEXPTOKEN)
        elif tk == ord('.'):       # label
            tk2 = self.lex()
            if tk2 in (Tok.NAME, Tok.FWDECL):
                if not self.coder:
                    self.throw(A2Error.NEXPLABEL)
                s = self.grab_symbol(self.l[0])
                s.token = Tok.LABEL
                s.value = self.coder.pos
                self.push_symbol(self.symbols, s)
                return True
            self.throw(A2Error.BADLABEL)
        elif tk == Tok.FWDECL:
            self.throw(A2Error.SYMBOLDEF)
        elif tk == Tok.NAME:
            if self.lex() != ord('('):
                # reference surfaces this as "Undefined symbol" at the
                # offending token (unknown name used as a register)
                self.throw(A2Error.UNDEFSYM)
            sym = self.grab_symbol(self.l[1])
            if self.coder and self.coder.program:
                self.funcdef(sym)
            else:
                self.progdef(sym, export)
        elif tk == Tok.LABEL:
            self.throw(A2Error.SYMBOLDEF)
        elif tk == ord('!'):
            tk2 = self.lex()
            if tk2 != Tok.NAME:
                if tk2 in (Tok.REGISTER, Tok.LABEL, Tok.PROGRAM):
                    self.throw(A2Error.SYMBOLDEF)
                self.throw(A2Error.EXPNAME)
            s = self.grab_symbol(self.l[0])
            self.var_decl(s)
            self.simplexp(s.value)
            self.code_op_l(Op.LOAD, s.value, self.l[0])
        elif tk == ord(':'):
            self.lex()
            self.namespace()
            self.instruction(Op.SPAWND, 0)
        elif tk == ord('<'):
            self.instruction(Op.SENDS, 0)
        elif tk == ord('+'):
            self.instruction(Op.ADD, 0)
        elif tk == ord('-'):
            self.instruction(Op.SUBR, 0)
        elif tk == ord('*'):
            tk2 = self.lex()
            if tk2 == ord('<'):
                self.instruction(Op.SENDA, 0)
            elif tk2 == ord(':'):
                self.lex()
                self.namespace()
                self.instruction(Op.SPAWNA, 0)
            else:
                self.unlex()
                self.instruction(Op.MUL, 0)
        elif tk == ord('/'):
            self.instruction(Op.DIVR, 0)
        elif tk == ord('%'):
            self.instruction(Op.MOD, 0)
        elif tk == Tok.INSTRUCTION:
            if terminator == Tok.EOF \
                    and self.get_index(self.l[0]) == Op.END:
                return False
            self.instruction(self.get_index(self.l[0]), 0)
        elif tk == Tok.PROGRAM:
            self.instruction(Op.SPAWND, 0)
        elif tk == Tok.FUNCTION:
            self.unlex()
            self.instruction(Op.CALL, 0)
        elif tk == Tok.KW_TEMPO:
            r = self.alloc_reg(RT_TEMPORARY)
            self.simplexp(r)
            self.code_op_l(Op.LOAD, r, self.l[0])
            self.codef(Op.MUL, r, 1.0 / 60.0)
            self.simplexp(r)
            self.code_op_l(Op.MUL, r, self.l[0])
            self.codef(Op.LOAD, R_TICK, 1000.0)
            self.code(Op.DIVR, R_TICK, r)
            self.free_reg(r)
        elif tk == Tok.KW_IMPORT:
            self.import_(export)
            return True
        elif tk == Tok.KW_DEF:
            self.def_(export)
            return True
        elif tk == Tok.KW_WAVE:
            self.wavedef(export)
            return True
        elif tk == Tok.IF:
            self.if_while(Op(self.l[0].value), False)
            return True
        elif tk == Tok.WHILE:
            self.if_while(Op(self.l[0].value), True)
            return True
        elif tk == Tok.KW_FOR:
            self.for_()
            return True
        elif tk == ord('{'):
            self.body()
            return True
        elif tk == Tok.EOS:
            if terminator == Tok.EOS:
                self.throw(A2Error.EXPSTATEMENT)
            return True
        else:
            if terminator and self.l[0].token != terminator:
                self.throw(A2Error.NEXPTOKEN)
            return False
        # statement finalizer
        if self.lex() == Tok.EOS:
            return True
        if terminator and self.l[0].token != terminator:
            self.throw(A2Error.EXPEOS)
        return False

    def statements(self, terminator):
        while self.statement(terminator):
            pass

    def body(self):
        sc = self.begin_scope()
        self.statements(ord('}'))
        self.end_scope(sc)

    # ----- main entry points -----

    def calculate_pos(self, pos):
        line, col = 1, 1
        for i in range(min(pos, len(self.source))):
            ch = self.source[i]
            if ch == '\n':
                line += 1
                col = 1
            elif ch == '\t':
                col += 9
                col -= col % 8
            else:
                col += 1
        return line, col

    def compile_string(self, bank, code, source_name):
        self.target = self.host.bank_of(bank)
        if self.target is None:
            raise A2CompileError(A2Error.INVALIDHANDLE, source_name)
        self.source = code
        self.source_name = source_name
        for lv in self.l:
            lv.pos = 0
            lv.token = 0
            lv.value = None
        self.inhandler = False
        self.nocode = True
        sc = self.begin_scope()
        try:
            self.canexport = True
            self.statements(Tok.EOF)
            self.end_scope(sc)
        except Throw as t:
            line, col = self.calculate_pos(self.l[0].pos)
            while self.coder:
                try:
                    self.pop_coder()
                except Throw:
                    break
            self.clean_scope(sc)
            raise A2CompileError(t.code, source_name, line, col) from None

    def compile_file(self, bank, fn):
        import os
        with open(fn, "r") as f:
            code = f.read()
        d = os.path.dirname(fn)
        if d:
            self.path = d
        self.compile_string(bank, code, fn)
