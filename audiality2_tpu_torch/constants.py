"""Core constants of the audiality2-tpu engine.

These mirror the observable contracts of the reference Audiality 2 engine
(values cited from /root/reference where they are part of script/VM/API
behavior), re-used here so that compiled A2S programs and rendered audio
match the reference bit-for-bit on the control plane.

References:
  - VM limits: include/a2_vm.h:33-39
  - Opcode set: src/internals.h:152-205
  - Engine limits: audiality2.h.cmake:50-56, src/config.h
  - Wave constants: include/a2_waves.h:33-71
"""

from enum import IntEnum

# --- VM limits (a2_vm.h) ---
A2_REGISTERS = 64          # VM registers per voice
A2_MAXARGS = 8             # max program/function arguments
A2_MAXEPS = 8              # max entry points per program (EP 0 = main)

# Hardwired control registers (a2_vm.h:52-59)
R_TICK = 0
R_TRANSPOSE = 1
A2_CREGISTERS = 2
A2_FIXEDREGS = A2_CREGISTERS

# --- Engine limits ---
A2_MAXFRAG = 64            # max fragment size, frames (audiality2.h.cmake:50)
A2_MAXCHANNELS = 8         # max bus channels (audiality2.h.cmake:56)
A2_NESTLIMIT = 255         # voice nesting depth limit (config.h:124)
A2_INSLIMIT = 1000         # VM instructions per timing slice (config.h:119)
A2_DEFAULTTICK = 125 << 16  # 'tempo 120 4' default tick (config.h:112)
A2_SV_LUT_SIZE = 8         # subvoice-ID fast LUT size (config.h:135)

# --- Fixed point formats ---
# Script values:   16:16 (a2_interface.h)
# Timestamps:      24:8 audio frames (internals.h:497)
# Audio samples:   8:24 int32 (a2_drivers.h:301)
# Control ramps:   8:24 (a2_dsp.h:105-118)
F16 = 65536                # one, in 16:16
F8 = 256                   # one, in 24:8

# --- Pitch (a2_pitch.h) ---
A2_MIDDLEC = 261.626       # reference frequency for linear pitch 0.0
A2_1K_DIV_MIDDLEC = 4202608409623  # 1000/A2_MIDDLEC in 24:40 fixp

# --- Waves (a2_waves.h) ---
A2_MIPLEVELS = 10
A2_INTERPRE = 1
A2_INTERPOST = 2
A2_MAXPHINC = 512          # max per-sample phase increment (24:8)
A2_WAVEPRE = A2_INTERPRE
A2_WAVEPOST = A2_INTERPOST + ((A2_MAXFRAG * A2_MAXPHINC + 255) >> 8) + 1
A2_WAVEPERIOD = 2048       # built-in geometric wave period

# RNG seeds (audiality2.h)
A2_DEFAULT_RANDSEED = 16576
A2_DEFAULT_NOISESEED = 324357

# --- Object types (a2_types.h:44-60) ---
class A2ObjType(IntEnum):
    BANK = 1
    WAVE = 2
    PROGRAM = 3
    UNIT = 4
    CONSTANT = 5
    STRING = 6
    STREAM = 7
    XICLIENT = 8
    DETACHED = 9
    NEWVOICE = 10
    VOICE = 11


# --- Wave types (a2_waves.h:79-85) ---
class WaveType(IntEnum):
    OFF = 0
    NOISE = 1
    WAVE = 2
    MIPWAVE = 3


# --- Wave flags (a2_waves.h:110-118) ---
A2_LOOPED = 0x00000100
A2_NORMALIZE = 0x00010000
A2_XFADE = 0x00040000
A2_REVMIX = 0x00080000
A2_CLEAR = 0x00100000
A2_UNPREPARED = 0x01000000

# --- Unit flags (a2_units.h) ---
A2_PROCADD = 0x0001        # instantiation: adding output mode
A2_MATCHIO = 0x0100        # unitdesc: inputs must match outputs

# --- Sample formats (a2_types.h) ---
class SampleFormat(IntEnum):
    I8 = 1
    I16 = 2
    I24 = 3    # actually 8:24 in int32
    I32 = 4
    F32 = 5


# --- Voice states (a2_vm.h:42-49) ---
class VState(IntEnum):
    RUNNING = 0
    WAITING = 1
    INTERRUPT = 2
    ENDING = 3
    FINALIZING = 4


# --- Struct I/O codes (internals.h:375-380) ---
A2_IO_MATCHOUT = -1
A2_IO_WIREOUT = -2
A2_IO_DEFAULT = -3


# --- VM opcodes ---
# Order MUST match the reference instruction set exactly
# (internals.h:152-205): *R versions right after their non-R counterparts,
# and SPAWN*/SEND*/KILL*/DETACH* groups in sequence — the compiler relies
# on `op + 1` / `op + 2` arithmetic in several places.
class Op(IntEnum):
    END = 0
    RETURN = 1
    CALL = 2
    JUMP = 3
    LOOP = 4
    JZ = 5
    JNZ = 6
    JG = 7
    JL = 8
    JGE = 9
    JLE = 10
    DELAY = 11
    DELAYR = 12
    TDELAY = 13
    TDELAYR = 14
    SLEEP = 15
    WAKE = 16
    FORCE = 17
    SUBR = 18
    DIVR = 19
    P2DR = 20
    NEGR = 21
    LOAD = 22
    LOADR = 23
    ADD = 24
    ADDR = 25
    MUL = 26
    MULR = 27
    MOD = 28
    MODR = 29
    QUANT = 30
    QUANTR = 31
    RAND = 32
    RANDR = 33
    GR = 34
    LR = 35
    GER = 36
    LER = 37
    EQR = 38
    NER = 39
    ANDR = 40
    ORR = 41
    XORR = 42
    NOTR = 43
    SET = 44
    SETALL = 45
    RAMP = 46
    RAMPR = 47
    RAMPALL = 48
    RAMPALLR = 49
    PUSH = 50
    PUSHR = 51
    SPAWN = 52
    SPAWNR = 53
    SPAWND = 54
    SPAWNDR = 55
    SPAWNV = 56
    SPAWNVR = 57
    SPAWNA = 58
    SPAWNAR = 59
    SEND = 60
    SENDR = 61
    SENDA = 62
    SENDS = 63
    WAIT = 64
    KILL = 65
    KILLR = 66
    KILLA = 67
    DETACH = 68
    DETACHR = 69
    DETACHA = 70
    DEBUG = 71
    DEBUGR = 72
    INITV = 73
    SIZEOF = 74
    SIZEOFR = 75


# Instructions with a 32-bit immediate (second code word); a2_InsSize()
# in the reference (compiler.c:111-131).
TWO_WORD_OPS = frozenset({
    Op.DELAY, Op.TDELAY, Op.LOAD, Op.ADD, Op.MUL, Op.MOD, Op.QUANT,
    Op.RAND, Op.PUSH, Op.DEBUG, Op.RAMP, Op.RAMPALL,
})


def ins_size(op: int) -> int:
    return 2 if op in TWO_WORD_OPS else 1


# Illegal jump target used to mark branches pending fixup
# (compiler.h:199).
A2_UNDEFJUMP = 0xFF000000


# ---- log levels (a2_types.h:86-107) ----
A2_LOG_INTERNAL = 0x0001
A2_LOG_CRITICAL = 0x0002
A2_LOG_ERROR = 0x0004
A2_LOG_WARNING = 0x0008
A2_LOG_INFO = 0x0010
A2_LOG_MESSAGE = 0x0020
A2_LOG_DEBUG = 0x0100
A2_LOG_DEFAULTS = (A2_LOG_INTERNAL | A2_LOG_CRITICAL | A2_LOG_ERROR
                   | A2_LOG_WARNING | A2_LOG_INFO | A2_LOG_MESSAGE)
