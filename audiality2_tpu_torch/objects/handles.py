"""Reference-counted handle manager.

Plays the role of the reference's rchm (src/rchm.h): integer handles
mapping to (object, typecode, userbits, refcount), with per-type
destructors that may refuse destruction (used for engine-round-trip
voice/wave teardown).  Handles are never reused while referenced; freed
entries go on a free list like the reference's.
"""

from ..constants import A2ObjType
from ..errors import A2Error, A2Exception

# Handle userbits (internals.h:62-67)
A2_LOCKED = 0x01
A2_APIOWNED = 0x02

RCHM_REFUSE = "refuse"


class HandleInfo:
    __slots__ = ("data", "typecode", "userbits", "refcount")

    def __init__(self, data, typecode, userbits=0, refcount=1):
        self.data = data
        self.typecode = typecode
        self.userbits = userbits
        self.refcount = refcount


class HandleManager:
    def __init__(self):
        self._handles = {}
        self._free = []
        self._next = 0
        self._destructors = {}     # typecode -> callable(hi, handle) -> bool
        self._stream_openers = {}  # typecode -> callable(stream, handle)
        self._typenames = {}

    def register_type(self, typecode, name, destructor=None, stream_open=None):
        self._destructors[typecode] = destructor
        self._stream_openers[typecode] = stream_open
        self._typenames[typecode] = name

    def type_name(self, typecode):
        try:
            return self._typenames.get(A2ObjType(typecode), "<unknown>")
        except ValueError:
            return "<unknown>"

    def stream_opener(self, typecode):
        return self._stream_openers.get(typecode)

    def new(self, data, typecode, userbits=0, refcount=1) -> int:
        if self._free:
            h = self._free.pop()
        else:
            h = self._next
            self._next += 1
        self._handles[h] = HandleInfo(data, typecode, userbits, refcount)
        return h

    def get(self, handle):
        return self._handles.get(handle)

    def require(self, handle, typecode=None):
        hi = self._handles.get(handle)
        if hi is None:
            raise A2Exception(A2Error.INVALIDHANDLE, f"handle {handle}")
        if typecode is not None and hi.typecode != typecode:
            raise A2Exception(A2Error.WRONGTYPE, f"handle {handle}")
        return hi

    def retain(self, handle):
        hi = self.require(handle)
        hi.refcount += 1
        return hi.refcount

    def release(self, handle) -> int:
        """Decrement refcount; destroy at zero (unless the destructor
        refuses, in which case the object lingers at refcount 0 until
        destruction is retried)."""
        hi = self._handles.get(handle)
        if hi is None:
            raise A2Exception(A2Error.INVALIDHANDLE, f"handle {handle}")
        if hi.refcount > 0:
            hi.refcount -= 1
        if hi.refcount == 0 and not (hi.userbits & A2_LOCKED):
            return self._destroy(handle, hi)
        return hi.refcount

    def _destroy(self, handle, hi) -> int:
        d = self._destructors.get(hi.typecode)
        if d is not None:
            if d(hi, handle) is RCHM_REFUSE:
                return 0        # lingers; revisited later
        self.free(handle)
        return 0

    def free(self, handle):
        if handle in self._handles:
            del self._handles[handle]
            self._free.append(handle)

    def retry_destroy(self, handle):
        hi = self._handles.get(handle)
        if hi is not None and hi.refcount == 0 \
                and not (hi.userbits & A2_LOCKED):
            self._destroy(handle, hi)

    def all_handles(self):
        return list(self._handles.keys())
