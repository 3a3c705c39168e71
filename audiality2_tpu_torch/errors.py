"""Error codes and exceptions.

Mirrors the reference's named error set (include/a2_types.h:132-285) so
scripts, tests, and API users see the same error identities.  Here errors
are Python exceptions carrying an `A2Error` enum code, rather than C
return codes.
"""

from enum import IntEnum

_ERRORS = [
    # (name, description) — order defines the numeric code, starting at 1.
    ("REFUSE", "Destruction refused"),
    ("OOMEMORY", "Out of memory"),
    ("OOHANDLES", "Out of handles"),
    ("INVALIDHANDLE", "Invalid handle"),
    ("FREEHANDLE", "Handle already returned to the free pool"),
    ("DEADHANDLE", "Released (not locked) handle used by API"),
    ("END", "VM program ended normally"),
    ("OVERLOAD", "VM overload; too many instructions back-to-back"),
    ("ILLEGALOP", "Illegal VM opcode"),
    ("LATEMESSAGE", "API message arrived late to engine context"),
    ("MANYARGS", "Too many arguments to VM program"),
    ("MSGOVERFLOW", "API message buffer overflow"),
    ("BUFOVERFLOW", "Buffer overflow"),
    ("BUFUNDERFLOW", "Buffer underflow"),
    ("DIVBYZERO", "Division by zero"),
    ("INFLOOP", "Jump would cause infinite loop"),
    ("OVERFLOW", "Value does not fit in numeric type"),
    ("UNDERFLOW", "Value too small; would truncate to zero"),
    ("VALUERANGE", "Value out of range"),
    ("INDEXRANGE", "Index out of range"),
    ("OUTOFREGS", "Out of VM registers"),
    ("LARGEFRAME", "Function uses too many VM registers"),
    ("NOTIMPLEMENTED", "Operation or feature not implemented"),
    ("OPEN", "Error opening file"),
    ("NODRIVER", "No driver of the required type available"),
    ("DRIVERNOTFOUND", "Specified driver not found"),
    ("DEVICEOPEN", "Error opening device"),
    ("ALREADYOPEN", "Device is already open"),
    ("ISASSIGNED", "Object is already assigned to this bank"),
    ("READ", "Error reading file or stream"),
    ("WRITE", "Error writing file or stream"),
    ("READONLY", "Object is read-only"),
    ("WRITEONLY", "Object is write-only"),
    ("STREAMCLOSED", "Stream closed by the other party"),
    ("WRONGTYPE", "Wrong type of data or object"),
    ("WRONGFORMAT", "Wrong stream data format"),
    ("VOICEALLOC", "Could not allocate voice"),
    ("VOICEINIT", "Could not initialize voice"),
    ("VOICENEST", "Subvoice nesting depth exceeded"),
    ("IODONTMATCH", "Input and output counts don't match"),
    ("FEWCHANNELS", "Voice has to few channels for unit"),
    ("UNITINIT", "Could not initialize unit instance"),
    ("NOTFOUND", "Object not found"),
    ("NOOBJECT", "Handle is not attached to an object"),
    ("NOXINSERT", "No 'xinsert' unit found in voice structure"),
    ("NOSTREAMCLIENT", "'xinsert' client not set up for streaming"),
    ("NOREPLACE", "Unit does not implement replacing output mode"),
    ("NOTOUTPUT", "Tried to wire inputs to voice output bus"),
    ("NOUNITS", "Voice has no units"),
    ("MULTIINLINE", "Voice cannot have multiple inline units"),
    ("CHAINMISMATCH", "Unit input count does not match chain"),
    ("NOOUTPUT", "Final unit must send to voice output"),
    ("BLINDCHAIN", "Outputs wired to nothing, as there are no inputs downstream"),
    ("EXPORTDECL", "Export already declared"),
    ("SYMBOLDEF", "Symbol already defined"),
    ("UNDEFSYM", "Undefined symbols in program"),
    ("MESSAGEDEF", "Handler for this message already defined"),
    ("ONLYLOCAL", "Symbols can only be local in this scope"),
    ("DECLNOINIT", "Declared variable not initialized"),
    ("COUTWIRED", "Control output is already wired"),
    ("EXPEOS", "Expected end of statement"),
    ("EXPSTATEMENT", "Expected a non-empty statement"),
    ("EXPCLOSE", "Expected closing brace"),
    ("EXPNAME", "Expected name"),
    ("EXPVALUE", "Expected value"),
    ("EXPVALUEHANDLE", "Expected value or handle"),
    ("EXPINTEGER", "Expected integer value"),
    ("EXPSTRING", "Expected string literal"),
    ("EXPSTRINGORNAME", "Expected string literal or name"),
    ("EXPVARIABLE", "Expected variable"),
    ("EXPCTRLREGISTER", "Expected control register"),
    ("EXPLABEL", "Expected label"),
    ("EXPPROGRAM", "Expected program"),
    ("EXPFUNCTION", "Expected function declaration"),
    ("EXPUNIT", "Expected unit"),
    ("EXPBODY", "Expected body"),
    ("EXPOP", "Expected operator"),
    ("EXPBINOP", "Expected binary operator"),
    ("EXPCONSTANT", "Expected constant"),
    ("EXPWAVETYPE", "Expected wave type identifier"),
    ("EXPEXPRESSION", "Expected expression"),
    ("EXPVOICEEOS", "Expected voice index or end of statement"),
    ("NEXPEOF", "Unexpected end of file"),
    ("NEXPNAME", "Undefined symbol"),
    ("NEXPVALUE", "Value not expected here"),
    ("NEXPHANDLE", "Handle not expected here"),
    ("NEXPTOKEN", "Unexpected token"),
    ("NEXPELSE", "'else' not applicable here"),
    ("NEXPLABEL", "Label not expected here"),
    ("NEXPMODIFIER", "Value modifier not expected here"),
    ("NEXPDECPOINT", "Decimal point not expected here"),
    ("BADFORMAT", "Bad file or device I/O format"),
    ("BADSAMPLERATE", "Unsupported audio sample rate"),
    ("BADBUFSIZE", "Unsupported audio buffer size"),
    ("BADCHANNELS", "Unsupported audio channel count"),
    ("BADTYPE", "Invalid type ID"),
    ("BADBANK", "Invalid bank handle"),
    ("BADWAVE", "Invalid waveform handle"),
    ("BADPROGRAM", "Invalid program handle"),
    ("BADENTRY", "Invalid program entry point"),
    ("BADVOICE", "Voice does not exist, or bad voice id"),
    ("BADLABEL", "Bad label name"),
    ("BADVALUE", "Bad value"),
    ("BADJUMP", "Illegal jump target position"),
    ("BADOPCODE", "Invalid VM opcode"),
    ("BADREGISTER", "Invalid VM register index"),
    ("BADREG2", "Invalid VM register index, second argument"),
    ("BADIMMARG", "Immediate argument out of range"),
    ("BADVARDECL", "Variable cannot be declared here"),
    ("BADOCTESCAPE", "Bad octal escape format in string literal"),
    ("BADDECESCAPE", "Bad decimal escape format in string literal"),
    ("BADHEXESCAPE", "Bad hex escape format in string literal"),
    ("BADIFNEST", "Nested 'if' without braces"),
    ("BADELSE", "Use of 'else' after non-braced statement"),
    ("BADLIBVERSION", "Linked A2 lib incompatible with application"),
    ("BADDELIMITER", "Unexpected ',' delimiter (old script?)"),
    ("CANTEXPORT", "Cannot export from this scope"),
    ("CANTINPUT", "Unit cannot have inputs"),
    ("CANTOUTPUT", "Unit cannot have outputs"),
    ("NOPROGHERE", "Program cannot be declared here"),
    ("NOMSGHERE", "Message cannot be declared here"),
    ("NOFUNCHERE", "Function cannot be declared here"),
    ("NOTUNARY", "Not a unary operator"),
    ("NOCODE", "Code not allowed here"),
    ("NOTIMING", "Timing instructions not allowed here"),
    ("NORUN", "Cannot run program from here"),
    ("NORETURN", "'return' not allowed in this context"),
    ("NOEXPORT", "Cannot export this kind of symbol"),
    ("NOWAKEFORCE", "'wake' and 'force' not applicable here"),
    ("NOPORT", "Port is unavailable or does not exist"),
    ("NOINPUT", "Unit with inputs where there is no audio"),
    ("NONAME", "Object has no name"),
    ("INTERNAL", "INTERNAL ERROR"),
]

A2Error = IntEnum("A2Error", [("OK", 0)] + [(n, i + 1) for i, (n, _) in enumerate(_ERRORS)])

_DESCRIPTIONS = {A2Error[n]: d for n, d in _ERRORS}
_DESCRIPTIONS[A2Error.OK] = "Ok"


def error_description(e) -> str:
    e = A2Error(int(e)) if int(e) <= int(A2Error.INTERNAL) else A2Error.INTERNAL
    return _DESCRIPTIONS[e]


def error_name(e) -> str:
    try:
        return A2Error(int(e)).name
    except ValueError:
        return "INTERNAL"


class A2Exception(Exception):
    """Engine/runtime error carrying an A2Error code."""

    def __init__(self, code: A2Error, info: str = ""):
        self.code = code
        self.info = info
        super().__init__(f"{error_name(code)}: {error_description(code)}"
                         + (f" ({info})" if info else ""))


class A2CompileError(A2Exception):
    """Compile error with source position."""

    def __init__(self, code: A2Error, source: str = "", line: int = 0,
                 col: int = 0, info: str = ""):
        super().__init__(code, info)
        self.source = source
        self.line = line
        self.col = col

    def __str__(self):
        base = f"{error_name(self.code)}: {error_description(self.code)}"
        if self.line:
            base += f" at line {self.line}, column {self.col}"
        if self.source:
            base += f' in "{self.source}"'
        if self.info:
            base += f" ({self.info})"
        return base
