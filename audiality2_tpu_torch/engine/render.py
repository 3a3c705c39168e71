"""Offline rendering (a2_Render / a2_RenderWave, src/render.c).

Renders a program in a dedicated offline substate sharing the caller's
banks, returning the raw int32 8:24 mono sample data.  Used both by
the public render API and by compile-time `wave { ... Program args }`
definitions (compiler.c:3334-3373).
"""

import numpy as np

from ..constants import A2_DEFAULT_NOISESEED, A2_DEFAULT_RANDSEED
from ..errors import A2Error, A2Exception


def render_program(state, program, argv, samplerate, length=0,
                   props=None, channels=1):
    """Render 'program' offline; stops at 'length' frames, or at
    silence when length == 0 (render.c:34-127)."""
    from .state import Config, State
    master = state if state.parent is None else state.parent
    ss = master.ss
    offlinebuffer = ss.offlinebuffer
    silencelevel = ss.silencelevel
    silencewindow = ss.silencewindow
    silencegrace = ss.silencegrace

    sub = master.substate(Config(samplerate=samplerate,
                                 buffer=offlinebuffer,
                                 channels=channels))
    i = sub.interface
    if props:
        if "randseed" in props:
            sub.randstate.state = props["randseed"] & 0xFFFFFFFF
        if "noiseseed" in props:
            sub.noisestate.state = props["noiseseed"] & 0xFFFFFFFF

    chunks = []
    captured = []

    def sink(bufs, frames):
        captured.append(np.array(bufs[0][:frames]))

    i.sink_callback(sink)
    i.timestamp_reset()
    h = i.starta(i.root_voice(), program, list(argv))

    frames = 0
    lastpeak = 0
    while True:
        frag = offlinebuffer
        if length and frag > length - frames:
            frag = length - frames
        if not frag:
            break
        captured.clear()
        i.run(frag)
        buf = captured[0] if captured else np.zeros(frag, dtype=np.int32)
        chunks.append(buf)
        if not length:
            lastpeak += frag
            over = np.abs(buf.astype(np.int64)) > silencelevel
            if over.any():
                lastpeak = frag - int(np.max(np.nonzero(over)[0]))
        frames += frag
        if length:
            if frames >= length:
                break
        else:
            if frames >= silencegrace and lastpeak >= silencewindow:
                break
            if frames > samplerate * 120:
                break   # hard cap: 2 minutes of silence-less render
    i.timestamp_reset()
    i.senda(h, 1, [])
    sub.close()
    return np.concatenate(chunks) if chunks else \
        np.zeros(0, dtype=np.int32)
