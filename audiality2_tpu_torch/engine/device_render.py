"""DeviceRenderer: native record -> PyTorch/CUDA superblock mixer.

The port of ``audiality2_tpu/engine/device_render.py``: the C++
runtime runs the whole control plane in record mode
(``NativeRenderer.record``), ``program_from_native`` builds the
superblock program with numpy, and ``TorchMixer`` mixes it on the
card; only the master audio returns to the host.  Rendering is
synchronous, one superblock after another: no threads, no pipelining
and no profile pass.

Content the device program cannot express (the builder raises
``Unsupported``, e.g. an fbdelay legacy ring a superblock would wrap),
or a record error (e.g. a sub-fragment fbdelay), makes the renderer
restart on the pure native path, bit-exact either way, as the
reference does; ``fell_back`` says so.
"""

import time

import numpy as np
import torch

from ..errors import A2Exception
from ..native import NativeRenderer
from ..cuda.mixer import TorchMixer
from ..cuda.osc_kernel import PairAtlas
from ..cuda.superblock import Unsupported, program_from_native

SUPERBLOCK_FRAMES = 2752 * 64


class DeviceRenderer:
    """Drives a NativeRenderer in record mode and mixes with PyTorch on
    ``device`` ("cuda" unless the caller asks for "cpu").  Drop-in for
    NativeRenderer's offline API (timestamp_reset / start / play /
    send / run / close).  ``timings`` accumulates host seconds per
    phase: record, build, mix (device work included: the mix ends in
    a synchronize) and fetch."""

    def __init__(self, interface, channels=None, device="cuda",
                 readback="exact"):
        self.i = interface
        self.nr = NativeRenderer(interface, channels=channels)
        self.samplerate = self.nr.samplerate
        self.master_channels = self.nr.master_channels
        quality = {"hifi": 0, "normal": 1, "lofi": 2}[
            getattr(interface.state.config, "quality", "hifi")]
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DeviceRenderer: no CUDA device (pass "
                               "device='cpu' to mix on the CPU)")
        self._pair_atlas = PairAtlas()
        self._atlas_handles = set()
        self.mixer = TorchMixer(self, device=self.device,
                                readback=readback, quality=quality)
        self.fell_back = False
        self._calls = []         # replayed on native fallback
        self._rendered = 0
        self.timings = {"record": 0.0, "build": 0.0, "mix": 0.0,
                        "fetch": 0.0}

    # ---- control API (recorded for fallback replay) ----

    def timestamp_reset(self):
        self.nr.timestamp_reset()
        self._calls.append(("timestamp_reset",))

    def timestamp_bump(self, dt):
        self.nr.timestamp_bump(dt)
        self._calls.append(("timestamp_bump", dt))

    def start(self, parent, program, *args):
        self._calls.append(("start", parent, program) + args)
        return self.nr.start(parent, program, *args)

    def play(self, parent, program, *args):
        self._calls.append(("play", parent, program) + args)
        return self.nr.play(parent, program, *args)

    def send(self, voice, ep, *args):
        self._calls.append(("send", voice, ep) + args)
        return self.nr.send(voice, ep, *args)

    # ---- wave atlas keyed by native wave handle ----

    def atlas_entry(self, handle, mip):
        if handle not in self._atlas_handles:
            hi = self.i.state.ss.hm.get(handle)
            self._pair_atlas.add_wave(handle, hi.data)
            self._atlas_handles.add(handle)
            self._pair_atlas.finalize()
        return self._pair_atlas.lookup(handle, mip)

    # ---- rendering ----

    def _fallback(self, rendered_frames):
        """The device path met content it cannot run: rebuild a fresh
        native state, replay the control calls, skip what was already
        rendered, and continue on the pure native path."""
        self.fell_back = True
        self.nr.close()
        self.nr = NativeRenderer(self.i, channels=self.master_channels)
        for c in self._calls:
            getattr(self.nr, c[0])(*c[1:])
        skip = rendered_frames
        while skip > 0:
            n = min(skip, 65536)
            self.nr.run(n)
            skip -= n

    def record_program(self, frames):
        """Records `frames` frames on the native control plane and
        builds their superblock program.  Raises A2Exception on a
        record error and Unsupported for content the device program
        cannot express (the native state has advanced either way)."""
        t0 = time.perf_counter()
        rows, stages, stash, nfrag = self.nr.record(frames)
        t1 = time.perf_counter()
        sizes = [64] * (frames // 64)
        if frames % 64:
            sizes.append(frames % 64)
        prog = program_from_native(rows, stages, stash, nfrag, sizes,
                                   self.atlas_entry, self.master_channels)
        self.timings["record"] += t1 - t0
        self.timings["build"] += time.perf_counter() - t1
        return prog

    def _superblock(self, frames):
        """Records, builds and mixes `frames` frames; returns
        (channels, frames) int32, or None after falling back."""
        try:
            prog = self.record_program(frames)
        except (A2Exception, Unsupported):
            self._fallback(self._rendered)
            return None
        t0 = time.perf_counter()
        master = self.mixer.dispatch(prog)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        out = np.stack(self.mixer.fetch(master, prog))
        self.timings["mix"] += t1 - t0
        self.timings["fetch"] += time.perf_counter() - t1
        return out

    def run(self, frames):
        """Render `frames` frames; returns (channels, frames) int32."""
        out = None if self.fell_back else self._superblock(frames)
        if out is None:
            out = self.nr.run(frames)
        self._rendered += frames
        return out

    def render(self, total_frames, bufsize=None):
        """Offline render, one superblock of `bufsize` frames (rounded
        down to whole fragments) at a time.  Every superblock records a
        full `bufsize`; the tail past `total_frames` is trimmed.
        Returns (channels, total_frames) int32."""
        if bufsize is None:
            bufsize = min(total_frames, SUPERBLOCK_FRAMES)
        bufsize -= bufsize % 64
        if bufsize <= 0:
            raise ValueError("bufsize must hold at least one fragment")
        chunks = []
        n = 0
        while n < total_frames:
            out = None if self.fell_back else self._superblock(bufsize)
            frames = bufsize
            if out is None:
                frames = min(bufsize, total_frames - n)
                out = self.nr.run(frames)
            chunks.append(out[:, :total_frames - n])
            n += frames
            self._rendered += frames
        return np.concatenate(chunks, axis=1)

    @property
    def activevoices(self):
        return self.nr.activevoices

    def close(self):
        self.nr.close()
