"""Deferred (device-batched) unit variants.

Voices whose structure is exactly `wtosc` or `wtosc -> panmix` (the
dominant leaf-voice signatures in real scores) get these subclasses:
the control plane (rampers, pitch, phase, mip selection) still runs on
the host — bit-exact with the reference — but instead of computing
samples, each process slice emits one control ROW; all rows of a
superblock are evaluated in a single batched device dispatch
(tpu/row_kernel.py) and mixed back in replay order.

Modes the row kernel cannot express (noise S&H — which consumes the
shared engine RNG in sequence — and non-mipmapped waves) fall back to
the exact host DSP at record time, preserving RNG draw order.
"""

import numpy as np

from ..constants import A2_MAXFRAG, A2_MAXPHINC, A2_MIPLEVELS, A2_PROCADD
from ..fixmath import sat32
from .host_units import PanmixUnit, WtoscUnit

_U64 = (1 << 64) - 1


class DeferredWtosc(WtoscUnit):
    record_kind = "defer"
    queue_writes = False

    def process_record(self, core, offset, frames):
        """Record-mode process: control plane + row emission.
        Sets self._emit for the sibling panmix:
          ("row", idx) | ("fallback", buf) | ("silent", None)
        """
        m = self.mode
        if m == "mip":
            w = self.wave
            if w.size[0] == 0:
                self.wave = None
                self.mode = "off"
                return self.process_record(core, offset, frames)
            self._run_pitch(frames)
            dph_chk = ((self.dphase + 255) >> 8) * w.period
            self.a.prepare(frames)
            mm = 0
            while dph_chk > (A2_MAXPHINC << 8) and mm < A2_MIPLEVELS - 1:
                dph_chk >>= 1
                mm += 1
            ph = self.phase >> mm
            dph = (self.dphase * w.period) >> mm
            size = w.size[mm]
            looped = bool(w.flags & 0x100)
            if looped:
                ph %= size << 24
            elif (ph >> 24) > (size + 1):
                self._emit = ("silent", None)
                return
            if dph > (A2_MAXPHINC << 16):
                # pitch out of range: silence, advance
                ph += dph * frames
                self.phase = (ph << mm) & _U64
                self.a.run(frames)
                self._emit = ("silent", None)
                return
            base = core.atlas_base(w, mm)
            idx = core.rowbatch.add_osc(base, ph, dph, self.a.value,
                                        self.a.delta, wave=w, mip=mm)
            self.phase = ((ph + frames * dph) << mm) & _U64
            self.a.value = sat32(self.a.value + self.a.delta * frames)
            self._emit = ("row", idx)
            core.oplist.append(("row", self, idx, offset, frames))
            return
        if m == "off":
            self.p.prepare(frames)
            self.a.prepare(frames)
            self.p.run(frames)
            self.a.run(frames)
            self._emit = ("silent", None)
            return
        # noise / nomip: exact host DSP at record time (keeps the
        # shared-RNG draw order identical to the interleaved engine)
        buf = np.zeros(A2_MAXFRAG, dtype=np.int32)
        real = self.outputs
        self.outputs = [buf]
        try:
            WtoscUnit.process(self, offset, frames)
        finally:
            self.outputs = real
        self._emit = ("fallback", buf)
        if len(self.voice.units) == 1:
            # no panmix stage: stash the audio for replay
            core.oplist.append(("stash", self, offset, frames, [buf]))


class DeferredPanmix(PanmixUnit):
    record_kind = "defer"
    queue_writes = False
    sibling = None     # the DeferredWtosc feeding us

    def process_record(self, core, offset, frames):
        kind, payload = self.sibling._emit
        mono = self.noutputs == 1
        if kind == "row":
            self.vol.prepare(frames)
            if mono:
                core.rowbatch.attach_panmix(payload, self.vol.value,
                                            self.vol.delta, 0, 0,
                                            False, False)
                self.vol.run(frames)
            else:
                self.pan.prepare(frames)
                clamp = (self.pan.target > 0xFFFFFF
                         or self.pan.target < -0xFFFFFF
                         or self.pan.value > 0xFFFFFF
                         or self.pan.value < -0xFFFFFF)
                core.rowbatch.attach_panmix(
                    payload, self.vol.value, self.vol.delta,
                    self.pan.value, self.pan.delta, True, clamp)
                self.vol.run(frames)
                self.pan.run(frames)
            # replace the wtosc's oplist row entry target: audio goes
            # through THIS unit's outputs
            for i in range(len(core.oplist) - 1, -1, -1):
                e = core.oplist[i]
                if e[0] == "row" and e[2] == payload:
                    core.oplist[i] = ("row", self, payload, offset,
                                      frames)
                    break
            return
        if kind == "silent":
            # control-only advance (exact host behavior on zero input)
            self.vol.prepare(frames)
            if not mono:
                self.pan.prepare(frames)
                self.vol.run(frames)
                self.pan.run(frames)
            else:
                self.vol.run(frames)
            return
        # fallback: host panmix on the host-computed wtosc buffer
        buf = payload
        temps = [np.zeros(A2_MAXFRAG, dtype=np.int32)
                 for _ in range(self.noutputs)]
        real_in, real_out = self.inputs, self.outputs
        self.inputs = [buf]
        self.outputs = temps
        try:
            PanmixUnit.process(self, offset, frames)
        finally:
            self.inputs, self.outputs = real_in, real_out
        core.oplist.append(("stash", self, offset, frames, temps))
