"""DeviceRenderer: native record -> PyTorch/CUDA superblock mixer.

The port of ``audiality2_tpu/engine/device_render.py``: the C++
runtime runs the whole control plane in record mode
(``NativeRenderer.record``), ``program_from_native`` builds the
superblock program with numpy, and ``TorchMixer`` mixes it on the
card, one CUDA graph launch per superblock (or per chain of them);
only the master audio returns to the host.

``render`` is pipelined as the reference's: the main thread records
and builds superblock N+1 while a dispatch thread uploads and launches
N, the card holds up to ``pipeline_depth`` superblocks and a pool of
fetch threads reads them back in order.  A profile pass first records
the whole song once so that it runs one signature (one graph capture).

The kernels are built once per process on a background thread (nvcc
of the kernel libraries); ``render`` and ``run`` wait for the
build, and a failed build is raised by ``wait_device`` and by them.
Content the device program cannot express (the builder raises
``Unsupported``, or the mixer at a dispatch: a value outside the
packed format's tables), or a record error, makes the renderer restart
on the pure native path, bit-exact either way; ``fell_back`` says so and
``bridged_frames`` counts the frames rendered natively.  A fault of the
device itself (a dispatch or a fetch) is raised, never rendered around.
"""

import os
import threading
import time
from collections import deque

import numpy as np
import torch

from ..errors import A2Exception
from ..native import NativeRenderer
from ..cuda.mixer import TorchMixer
from ..cuda.osc_kernel import PairAtlas
from ..cuda.superblock import Unsupported, program_from_native

SUPERBLOCK_FRAMES = 2752 * 64
# the most host bytes of program tables a profile pass keeps for the
# render to dispatch (about 300 superblocks of the effects song)
PROFILE_KEEP_BYTES = 1 << 30


def _prog_bytes(prog):
    """Host bytes of a program's tables."""
    arrs = [prog.runmat, prog.rampmat, prog.stash_audio, prog.stash_slot,
            prog.stash_mono, prog.stash_mono_slot]
    for st in prog.stages:
        arrs += [st["arr"], st["dense"]]
    arrs += [fd["arr"] for fd in prog.fbdelays]
    arrs += [fl["arr"] for fl in prog.filters]
    return sum(a.nbytes for a in arrs if a is not None)


def _frag_sizes(frames):
    sizes = [64] * (frames // 64)
    if frames % 64:
        sizes.append(frames % 64)
    return sizes


class DeviceRenderer:
    """Drives a NativeRenderer in record mode and mixes with PyTorch on
    ``device`` ("cuda" unless the caller asks for "cpu").  Drop-in for
    NativeRenderer's offline API (timestamp_reset / start / play /
    send / run / close).

    ``timings`` accumulates host seconds per phase: record and build
    (the main thread), mix (host seconds spent dispatching: the
    upload, state binding and graph launch, or under ``run`` the
    whole superblock including its device work) and fetch (waiting
    for and copying back masters, summed over the fetch threads);
    ``wall`` is the wall time of ``render`` calls."""

    _warm_lock = threading.Lock()
    _warm_thread = None
    _warm_done = threading.Event()
    _warm_error = None       # the kernel build's exception, if it failed
    _warm_elapsed = None     # seconds the build took, once done
    _NS_COUNTER = [0]

    @classmethod
    def _ensure_warm(cls):
        """Starts the per-process kernel build (every library of
        ``cuda/build.py``, loaded with ctypes) on a background thread."""
        with cls._warm_lock:
            if cls._warm_thread is not None:
                return
            t0 = time.perf_counter()
            done = cls._warm_done

            def go():
                try:
                    from ..cuda import build, fbdelay, filter, fm
                    from ..cuda import filter_float, osc_kernel
                    build.build()
                    for mod in (osc_kernel, fbdelay, filter, fm,
                                filter_float):
                        mod._load()
                except BaseException as e:
                    cls._warm_error = e
                finally:
                    cls._warm_elapsed = time.perf_counter() - t0
                    done.set()
            cls._warm_thread = threading.Thread(target=go, daemon=True)
            cls._warm_thread.start()

    @classmethod
    def _raise_warm_error(cls):
        if cls._warm_error is not None:
            raise RuntimeError("the port's kernels failed to build or "
                               "load") from cls._warm_error

    def wait_device(self, timeout=None):
        """Blocks until the per-process kernel build is done (True), or
        the timeout expires (False); raises if the build failed."""
        if self._cpu:
            return True
        DeviceRenderer._ensure_warm()
        ok = DeviceRenderer._warm_done.wait(timeout)
        if ok:
            DeviceRenderer._raise_warm_error()
        return ok

    def __init__(self, interface, channels=None, device="cuda",
                 transfer_lock=None, readback="exact", mixer=None,
                 stage_mode="exact", pipeline_depth=3, chain_dispatch=1):
        if stage_mode not in ("exact", "float"):
            raise ValueError("stage_mode must be 'exact' or 'float'")
        self.i = interface
        self.nr = NativeRenderer(interface, channels=channels)
        self.samplerate = self.nr.samplerate
        self.master_channels = self.nr.master_channels
        quality = {"hifi": 0, "normal": 1, "lofi": 2}[
            getattr(interface.state.config, "quality", "hifi")]
        DeviceRenderer._NS_COUNTER[0] += 1
        self._ns = DeviceRenderer._NS_COUNTER[0]
        self._atlas_handles = set()
        if mixer is None:
            self.device = torch.device(device)
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("DeviceRenderer: no CUDA device (pass "
                                   "device='cpu' to mix on the CPU)")
            # own mixer and atlas: wave handles and unit serials are
            # engine-local, no namespacing needed
            self._pair_atlas = PairAtlas()
            self.mixer = TorchMixer(self, device=self.device,
                                    transfer_lock=transfer_lock,
                                    readback=readback, quality=quality,
                                    stage_mode=stage_mode)
            self._shared = False
        else:
            # a shared mixer (serve.render_multiplexed): one signature
            # and one device atlas for the fleet; atlas keys and device
            # state are namespaced per stream
            self.mixer = mixer
            self.device = mixer.device
            self._pair_atlas = mixer.core._pair_atlas
            self._shared = True
            if mixer.quality != quality:
                raise ValueError(
                    "shared-mixer streams must share one wtosc quality "
                    "(mixer %d, stream %d)" % (mixer.quality, quality))
        self._cpu = self.device.type == "cpu"
        self.fell_back = False
        self.bridged_frames = 0  # rendered natively after a fallback
        # superblocks dispatched but not fetched yet
        self.pipeline_depth = max(1, int(pipeline_depth))
        # chain_dispatch > 1: render() sends this many consecutive
        # superblocks per graph launch (TorchMixer.dispatch_chain)
        self.chain_dispatch = max(1, int(chain_dispatch))
        self._calls = []         # replayed on native fallback
        self._rendered = 0
        self._nr_pos = 0         # frames self.nr has recorded or rendered
        self._profiled_prog = None
        # the profile pass's programs, one per superblock from the song's
        # start (kept for the render to dispatch), the next one's index,
        # and the native state at their end
        self._kept = None
        self._kept_at = 0
        self._kept_nr = None
        self._tlock = threading.Lock()
        self.timings = {"record": 0.0, "build": 0.0, "mix": 0.0,
                        "fetch": 0.0, "wall": 0.0}
        if not self._cpu:
            DeviceRenderer._ensure_warm()

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

    def _tag_prog(self, prog):
        """Namespaces per-unit device state ids on a shared mixer: unit
        serials are engine-local, so the fbdelay rings and filter state
        of different streams must not alias.  prog.ns keys the mixer's
        per-stream shape high-water marks (and its filter state)."""
        prog.ns = self._ns if self._shared else 0
        if self._shared:
            for fd in prog.fbdelays:
                if not isinstance(fd["unit_id"], tuple):
                    fd["unit_id"] = (self._ns, fd["unit_id"])
            for fl in prog.filters:
                fl["serials"] = [x if isinstance(x, tuple)
                                 else (self._ns, x)
                                 for x in fl["serials"]]
        return prog

    # ---- wave atlas keyed by native wave handle ----

    def atlas_entry(self, handle, mip):
        key = (self._ns, handle) if self._shared else handle
        # the atlas may be fleet-shared and reached from concurrent
        # record threads: hold its (reentrant) lock across the whole
        # add-if-missing
        with self._pair_atlas.lock:
            if key not in self._atlas_handles:
                hi = self.i.state.ss.hm.get(handle)
                self._pair_atlas.add_wave(key, hi.data)
                self._atlas_handles.add(key)
                self._pair_atlas.finalize()
            return self._pair_atlas.lookup(key, mip)

    # ---- rendering ----

    def _fallback(self, rendered_frames, frames=0):
        """The device path met content it cannot run: build a fresh
        native state, replay the control calls, skip what was
        already rendered, and continue on the pure native path."""
        self.fell_back = True
        self._drop_kept()
        self.nr.close()
        self.nr = NativeRenderer(self.i, channels=self.master_channels)
        for c in self._calls:
            getattr(self.nr, c[0])(*c[1:])
        skip = rendered_frames
        while skip > 0:
            n = min(skip, 65536)
            self.nr.run(n)
            skip -= n
        self._nr_pos = rendered_frames

    def _native_run(self, frames):
        """Renders `frames` frames on the native path (self.nr)."""
        out = self.nr.run(frames)
        self._nr_pos += frames
        self.bridged_frames += frames
        return out

    def _drop_kept(self):
        if self._kept_nr is not None:
            self._kept_nr.close()
        self._kept = self._kept_nr = None

    def _next_program_done(self):
        """After the last kept program: the native state moves on to the
        profile pass's, which stands at their end."""
        self.nr.close()
        self.nr, self._kept_nr = self._kept_nr, None
        self._kept = None

    def _next_program(self, frames):
        """The next superblock's program: the profile pass's, while it
        kept them (the native state then moves on to the end of the
        profiled frames), else recorded and built now."""
        if self._kept is not None:
            if self._kept_at < len(self._kept):
                self._nr_pos += frames
                self._kept_at += 1
                return self._kept[self._kept_at - 1]
            self._next_program_done()
        return self.record_program(frames)

    def _build(self, nr, frames):
        """Records `frames` frames on `nr` and builds their tagged
        program; returns (prog, record s, build s).  Raises A2Exception
        on a record error and Unsupported for content the device
        program cannot express (the native state has advanced either
        way)."""
        t0 = time.perf_counter()
        rows, stages, stash, nfrag = nr.record(frames)
        t1 = time.perf_counter()
        prog = program_from_native(rows, stages, stash, nfrag,
                                   _frag_sizes(frames), self.atlas_entry,
                                   self.master_channels)
        self._tag_prog(prog)
        return prog, t1 - t0, time.perf_counter() - t1

    def record_program(self, frames):
        """Records and builds `frames` frames (see _build), counting the
        host seconds in timings."""
        self._nr_pos += frames
        prog, tr, tb = self._build(self.nr, frames)
        self.timings["record"] += tr
        self.timings["build"] += tb
        return prog

    def run(self, frames):
        """Renders `frames` frames synchronously (record, build, mix,
        fetch, one superblock); returns (channels, frames) int32."""
        native = self.fell_back
        if not native:
            self.wait_device()
            try:
                prog = self._next_program(frames)
            except (A2Exception, Unsupported):
                self._fallback(self._rendered)
                native = True
        if not native:
            t0 = time.perf_counter()
            try:
                out = np.stack(self.mixer.run(prog))
            except Unsupported:
                # a value outside the packed format's tables
                self._fallback(self._rendered)
                native = True
            self.timings["mix"] += time.perf_counter() - t0
        if native:
            out = self._native_run(frames)
        self._rendered += frames
        return out

    def _profile(self, total_frames, bufsize):
        """Record-only dry pass over the whole render on a scratch native
        state: folds every superblock's shapes into the mixer's
        high-water marks and stage union (TorchMixer.observe), so that
        the real render runs ONE signature, one graph capture.  Returns
        False (no profile) if the dry pass meets content the device
        path cannot run.

        Unlike the reference, which records and builds the song again,
        a render that starts at the song's beginning keeps the dry
        pass's programs (up to PROFILE_KEEP_BYTES of tables) and
        dispatches them: the native record is deterministic, so they
        are the programs the render would build."""
        probe = NativeRenderer(self.i, channels=self.master_channels)
        keep = [] if self._nr_pos == 0 else None
        kept_bytes = 0
        try:
            for c in self._calls:
                getattr(probe, c[0])(*c[1:])
            n = 0
            while n < total_frames:
                prog, tr, tb = self._build(probe, bufsize)
                self.timings["record"] += tr
                self.timings["build"] += tb
                self.mixer.observe(prog)
                self._profiled_prog = prog
                if keep is not None:
                    kept_bytes += _prog_bytes(prog)
                    if kept_bytes <= PROFILE_KEEP_BYTES:
                        keep.append(prog)
                    else:
                        keep = None
                n += bufsize
        except (A2Exception, Unsupported):
            probe.close()
            return False
        if keep is None:
            probe.close()
        else:
            self._drop_kept()
            self._kept, self._kept_nr = keep, probe
            self._kept_at = 0
        return True

    def _time(self, key, t0):
        with self._tlock:
            self.timings[key] += time.perf_counter() - t0

    def render(self, total_frames, bufsize=None, sink=None, profile=True):
        """Pipelined offline render: records superblock N+1 on the host
        while the card computes N and fetch threads read back N-1.  With
        profile=True a record-only dry pass first unifies the signature
        across the whole song, and its graphs (one superblock, and a
        chain of ``chain_dispatch``) are captured before the first
        dispatch.  Every superblock records a full `bufsize` (the tail
        is trimmed) so the signature stays constant.  Waits for the
        kernel build first.  A dispatch or fetch fault emits what the
        card finished before it, then is raised.  Returns (channels,
        total_frames) int32, or streams through `sink(bufs, frames)` and
        returns None."""
        t_wall = time.perf_counter()
        try:
            return self._render(total_frames, bufsize, sink, profile)
        finally:
            self.timings["wall"] += time.perf_counter() - t_wall

    def _render(self, total_frames, bufsize, sink, profile):
        if bufsize is None:
            bufsize = min(total_frames, SUPERBLOCK_FRAMES)
        bufsize -= bufsize % 64
        if bufsize <= 0:
            raise ValueError("bufsize must hold at least one fragment")
        if not self.fell_back:
            self.wait_device()
        # frames rendered before this call (by run() or an earlier
        # render()): a native restart skips them too
        base = self._rendered
        C = self.chain_dispatch
        if profile and not self.fell_back \
                and self._profile(total_frames, bufsize) \
                and not self._cpu and self._profiled_prog is not None:
            # the song's one signature, captured before the first record
            self.mixer.precompile(self._profiled_prog)
            if 1 < C <= -(-total_frames // bufsize):
                self.mixer.precompile_chain(self._profiled_prog, C)
        chunks = []
        emitted = [0]

        def emit(bufs):
            frames = len(bufs[0])
            keep = min(frames, total_frames - emitted[0])
            if keep <= 0:
                return
            if keep < frames:
                bufs = [b[:keep] for b in bufs]
            emitted[0] += keep
            if sink is not None:
                sink(bufs, keep)
            else:
                chunks.append(np.stack(bufs))

        # the pipeline, all busy at once in steady state:
        #   main thread:     record + build superblock N
        #   dispatch thread: upload, bind state and launch N-1 (one
        #                    dispatch in flight, so the mixer's state
        #                    stays ordered)
        #   card:            up to `depth` superblocks enqueued
        #   fetch pool:      wait for the oldest masters, emit in order
        depth = max(self.pipeline_depth, C)
        rec_out = []             # built programs awaiting dispatch
        disp = None              # running dispatch thread
        dres = [None, None]      # dispatch (handles, error)
        inflight = deque()       # dispatched handles awaiting fetch
        FPOOL = max(1, min(int(os.environ.get("A2_FETCH_POOL", "3")),
                           depth))
        fpool = deque()          # [thread, [out, error]], oldest first

        def join_fetches(emit_ok):
            # waits for every fetch thread, emitting in order while
            # emit_ok and each succeeded
            while fpool:
                th, slot = fpool.popleft()
                th.join()
                if emit_ok and slot[0] is not None:
                    emit(slot[0])
                else:
                    emit_ok = False
            return emit_ok

        n = 0
        while n < total_frames or rec_out or disp is not None \
                or inflight or fpool:
            blocked = False      # did this iteration do blocking work
            if n < total_frames and not self.fell_back and len(rec_out) < C:
                # always a full superblock (stable signature); emit()
                # trims the tail past total_frames
                frames = bufsize
                prog = None
                blocked = True
                try:
                    prog = self._next_program(frames)
                except (A2Exception, Unsupported):
                    # what was recorded before still runs on the card
                    # (rec_out stays, and is dispatched below); native
                    # continues after it
                    self._fallback(base + n, min(frames, total_frames - n))
                if prog is not None:
                    rec_out.append(prog)
                    n += frames
            elif n < total_frames and not rec_out \
                    and disp is None and not inflight and not fpool:
                # fell back: native, once the in-flight superblocks have
                # drained, so emission stays in order across the switch
                frames = min(bufsize, total_frames - n)
                emit(list(self._native_run(frames)))
                n += frames
                blocked = True
            if disp is not None:
                disp.join()
                disp = None
                blocked = True
                if dres[1] is not None:
                    # a dispatch fault: emit what the card finished
                    # before it, then raise; content the mixer cannot
                    # express (a value outside the packed format's
                    # tables) continues natively from there instead
                    done = join_fetches(True)
                    if done:
                        for h in inflight:
                            emit(self.mixer.fetch(h))
                    if not (done and isinstance(dres[1], Unsupported)):
                        raise dres[1]
                    inflight.clear()
                    rec_out = []
                    self._fallback(base + emitted[0])
                    n = emitted[0]
                else:
                    inflight.extend(dres[0])
            if rec_out and (len(rec_out) >= C or n >= total_frames
                            or self.fell_back):
                grp = rec_out
                rec_out = []

                def put(grp=grp):
                    dres[0] = None
                    dres[1] = None
                    t0 = time.perf_counter()
                    try:
                        if len(grp) >= 2 and len(grp) == C:
                            # a full group: one graph launch
                            dres[0] = self.mixer.dispatch_chain(grp)
                        else:
                            # a partial tail: singles (no fresh chain
                            # shape for the song's last group)
                            dres[0] = [self.mixer.dispatch(p)
                                       for p in grp]
                    except BaseException as e:
                        dres[1] = e
                    finally:
                        self._time("mix", t0)
                disp = threading.Thread(target=put)
                disp.start()
            if fpool and (not fpool[0][0].is_alive()
                          or len(inflight) + len(fpool) >= depth
                          or not blocked):
                th, slot = fpool.popleft()
                th.join()
                if slot[0] is None:
                    # a fetch fault (the oldest handle): nothing newer
                    # may emit; stop every thread, then raise
                    join_fetches(False)
                    if disp is not None:
                        disp.join()
                    raise slot[1]
                emit(slot[0])
            while len(fpool) < FPOOL and inflight:
                h = inflight.popleft()
                slot = [None, None]

                def go(h=h, slot=slot):
                    t0 = time.perf_counter()
                    try:
                        slot[0] = self.mixer.fetch(h)
                    except BaseException as e:
                        slot[1] = e
                    finally:
                        self._time("fetch", t0)
                th = threading.Thread(target=go)
                th.start()
                fpool.append((th, slot))
        self._rendered += emitted[0]
        if self._kept is not None and self._kept_at >= len(self._kept):
            self._next_program_done()
        if sink is not None:
            return None
        return np.concatenate(chunks, axis=1)

    @property
    def activevoices(self):
        return self.nr.activevoices

    def close(self):
        self._drop_kept()
        self.nr.close()
