"""The stream interface: generic byte/sample streams over objects.

Behavioral model from reference src/stream.c + the wave upload path
(waves.c:349-527): a stream opened on a wave buffers writes and applies
them on flush — the first flush fixes the wave's length, allocates the
mip chain, converts/normalizes, applies loop post-processing, and
renders mipmaps.  Streams on xinsert clients move audio between the
API context and a running voice (async source/sink).
"""

from collections import deque

import numpy as np

from ..constants import A2_NORMALIZE, A2_UNPREPARED, SampleFormat
from ..errors import A2Error, A2Exception
from .waves import normalize_gain


class Stream:
    def __init__(self, state, target_handle, target, channel=0, size=0,
                 flags=0):
        self.state = state
        self.target_handle = target_handle
        self.target = target
        self.channel = channel
        self.size = size
        self.flags = flags
        self.position = 0
        self.closed = False

    # backends (overridden per target type)
    def read(self, fmt, count):
        raise A2Exception(A2Error.NOTIMPLEMENTED, "stream read")

    def write(self, fmt, data):
        raise A2Exception(A2Error.NOTIMPLEMENTED, "stream write")

    def flush(self):
        return A2Error.OK

    def close(self):
        self.flush()
        self.closed = True

    def set_position(self, offset):
        self.position = offset

    def available(self):
        raise A2Exception(A2Error.NOTIMPLEMENTED)

    def space(self):
        raise A2Exception(A2Error.NOTIMPLEMENTED)


def _to_i16(fmt, data):
    arr = np.asarray(data)
    if fmt == SampleFormat.I8:
        return arr.astype(np.int32) << 8
    if fmt == SampleFormat.I16:
        return arr.astype(np.int32)
    if fmt == SampleFormat.I24:
        return arr.astype(np.int32) >> 8
    if fmt == SampleFormat.I32:
        return arr.astype(np.int32) >> 16
    if fmt == SampleFormat.F32:
        return np.trunc(arr.astype(np.float64) * 32767.0).astype(np.int64)
    raise A2Exception(A2Error.BADFORMAT)


def _from_i16(fmt, arr):
    if fmt == SampleFormat.I8:
        return (arr >> 8).astype(np.int8)
    if fmt == SampleFormat.I16:
        return arr.astype(np.int16)
    if fmt == SampleFormat.I24:
        return arr.astype(np.int32) << 8
    if fmt == SampleFormat.I32:
        return arr.astype(np.int32) << 16
    if fmt == SampleFormat.F32:
        return arr.astype(np.float32) / 32767.0
    raise A2Exception(A2Error.BADFORMAT)


class WaveStream(Stream):
    """Upload/download stream on a wave object (waves.c:349-527)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._buffers = []      # (offset, fmt, data) applied on flush

    def write(self, fmt, data):
        arr = np.asarray(data).copy()
        self._buffers.append((self.position, fmt, arr))
        self.position += len(arr)
        return A2Error.OK

    def read(self, fmt, count):
        w = self.target
        if w.data[0] is None:
            raise A2Exception(A2Error.WRONGTYPE, "unprepared wave")
        start = self.position
        end = min(start + count, w.size[0])
        raw = w.data[0][1 + start:1 + end].astype(np.int64)
        self.position = end
        return _from_i16(fmt, raw)

    def flush(self):
        w = self.target
        if not self._buffers:
            return A2Error.OK
        if w.flags & A2_UNPREPARED:
            # first flush: length = highest write position
            length = max(off + len(d) for off, _, d in self._buffers)
            w.alloc(length)
            w.flags &= ~A2_UNPREPARED
        if w.flags & A2_NORMALIZE:
            gain = min((normalize_gain(fmt, d)
                        for _, fmt, d in self._buffers), default=1.0)
        else:
            gain = 1.0
        for off, fmt, d in self._buffers:
            w.write(off, gain, fmt, d)
        self._buffers.clear()
        w.postprocess()
        w.render_mipmaps()
        return A2Error.OK

    def get_size(self):
        return self.target.size[0]


class XicReadStream(Stream):
    """Read audio captured by a sink xinsert client (a2_OpenSink)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.fifo = deque()
        self._avail = 0

    def push(self, samples):
        self.fifo.append(np.asarray(samples, dtype=np.int32))
        self._avail += len(samples)

    def read(self, fmt, count):
        out = np.zeros(count, dtype=np.int64)
        got = 0
        while got < count and self.fifo:
            chunk = self.fifo[0]
            take = min(len(chunk), count - got)
            out[got:got + take] = chunk[:take] >> 8   # 8:24 -> int16
            if take == len(chunk):
                self.fifo.popleft()
            else:
                self.fifo[0] = chunk[take:]
            got += take
        self._avail -= got
        self.position += got
        return _from_i16(fmt, out[:got])

    def available(self):
        return self._avail


class XicWriteStream(Stream):
    """Write audio for a source xinsert client (a2_OpenSource)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.fifo = deque()
        self._avail = 0

    def write(self, fmt, data):
        i16 = _to_i16(fmt, data)
        self.fifo.append((i16.astype(np.int64) << 8).astype(np.int32))
        self._avail += len(i16)
        self.position += len(i16)
        return A2Error.OK

    def pull(self, count):
        out = np.zeros(count, dtype=np.int32)
        got = 0
        while got < count and self.fifo:
            chunk = self.fifo[0]
            take = min(len(chunk), count - got)
            out[got:got + take] = chunk[:take]
            if take == len(chunk):
                self.fifo.popleft()
            else:
                self.fifo[0] = chunk[take:]
            got += take
        self._avail -= got
        return out

    def space(self):
        return 1 << 20
