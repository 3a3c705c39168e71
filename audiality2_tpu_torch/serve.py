"""Multi-stream serving: render many songs concurrently on one card.

The port of ``audiality2_tpu/serve.py`` for the superblock device path
(``engine/device_render.py``): K independent streams (different songs,
scores or listeners), each with its own engine, rendered concurrently
so that the card, the host control plane and the transfers all stay
busy.  The per-process kernel build is shared; streams wait for it.
A stream whose content the device program cannot express continues on
the bit-exact native path; a fault of the card (a failed dispatch or
fetch) fails the stream and is raised.

``render_many`` gives each stream its own renderer and mixer on a
thread of its own; ``render_multiplexed`` drives all streams through
ONE shared ``TorchMixer`` (one graph per signature for the fleet),
rotating per superblock, optionally with a batch of streams per graph
launch (``TorchMixer.dispatch_many``).  Uploads and readbacks are
serialised with a shared transfer lock by default, as in the
reference; the card's compute still overlaps every stream's host
record.
"""

import os
import threading
import time
from collections import deque

import numpy as np
import torch

from .cuda.superblock import Unsupported
from .engine.device_render import DeviceRenderer
from .errors import A2Exception


class StreamJob:
    """One render job: `program` (handle from interface.get) started
    with `args` on a fresh root voice of `interface`, rendered for
    `frames` frames.  `sink(bufs, frames)` streams audio; without a
    sink the job's output is returned as [channels][frames] int32."""

    def __init__(self, interface, program, frames, args=(),
                 channels=None, sink=None):
        self.interface = interface
        self.program = program
        self.frames = frames
        self.args = tuple(args)
        self.channels = channels
        self.sink = sink
        self.output = None
        self.error = None
        self.renderer = None


def render_many(jobs, bufsize=None, serialize_transfers=True,
                device="cuda", profile=True, readback="exact",
                stagger=True, stagger_timeout=180.0, stage_mode="exact",
                chain_dispatch=1):
    """Renders all jobs concurrently on the device path, each on a
    thread of its own with its own renderer and mixer.  Each job's
    output is bit-exact with a solo render (streams share no mutable
    state beyond the card).  Returns the job list with .output filled
    (or .error set; the first error is raised again).  readback="i16"
    halves each stream's readback bytes (lossless for 16-bit PCM
    sinks).

    stagger=True starts stream k+1 only once stream k has captured its
    first graph (``mixer._fns``), or fell back, or timed out: graph
    captures then do not pile up at the start."""
    lock = threading.Lock() if serialize_transfers else None
    for j in jobs:
        r = DeviceRenderer(j.interface, channels=j.channels, device=device,
                           transfer_lock=lock, readback=readback,
                           stage_mode=stage_mode,
                           chain_dispatch=chain_dispatch)
        r.timestamp_reset()
        r.start(0, j.program, *j.args)
        j.renderer = r

    done = []

    def go(j):
        try:
            j.output = j.renderer.render(j.frames, bufsize=bufsize,
                                         sink=j.sink, profile=profile)
        except BaseException as e:
            j.error = e
        finally:
            done.append(j)
            j.renderer.close()

    threads = [threading.Thread(target=go, args=(j,)) for j in jobs]
    for t, j in zip(threads, jobs):
        t.start()
        if not stagger:
            continue
        deadline = time.monotonic() + stagger_timeout
        while time.monotonic() < deadline and j not in done \
                and not j.renderer.mixer._fns \
                and not j.renderer.fell_back:
            time.sleep(0.01)
    for t in threads:
        t.join()
    for j in jobs:
        if j.error is not None:
            raise j.error
    return jobs


class _SharedCore:
    """Atlas owner for a fleet-shared TorchMixer."""

    def __init__(self):
        from .cuda.osc_kernel import PairAtlas
        self._pair_atlas = PairAtlas()


class A2HbmBudgetError(RuntimeError):
    """The fleet's device-memory plan exceeds the budget."""


def device_memory_budget(device):
    """The default budget of ``fleet_hbm_plan``: the device's memory less
    an eighth for the allocator and fragmentation (the reference leaves
    2 of a v5e's 16 GiB).  On the card its total memory; on the CPU the
    host's physical memory."""
    device = torch.device(device)
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return total - total // 8


def fleet_hbm_plan(mixer, progs, pipeline_depth=3, hbm_budget=None):
    """Conservative device-memory plan for a fleet sharing one
    TorchMixer: per-stream persistent state (fbdelay rings, filter / fm
    state) is resident for every stream at once, while the transient
    working sets exist only for the <= pipeline_depth + 1 superblocks in
    flight.  hbm_budget defaults to ``device_memory_budget`` of the
    mixer's device.  Returns the plan dict; raises A2HbmBudgetError
    when it does not fit."""
    if hbm_budget is None:
        hbm_budget = device_memory_budget(mixer.device)
    persistent = execb = flight = atlas = 0
    for p in progs:
        b = mixer.device_bytes(p)
        persistent += b["persistent"]
        # expansion intermediates live only while a program executes
        # (x2 covers enqueue/execute overlap), while every in-flight
        # superblock holds its upload and master
        execb = max(execb, b["exec"])
        flight = max(flight, b["blob"] + b["master"])
        atlas = b["atlas"]
    total = persistent + 2 * execb + (pipeline_depth + 1) * flight + atlas
    plan = {"streams": len(progs), "persistent": persistent,
            "exec_per_dispatch": execb, "flight_per_superblock": flight,
            "atlas": atlas, "inflight": pipeline_depth + 1, "total": total,
            "budget": hbm_budget}
    if total > hbm_budget:
        raise A2HbmBudgetError(
            "fleet device-memory plan %.2f GB exceeds budget %.2f GB "
            "(%d streams: %.2f GB persistent + 2 x %.2f GB executing + "
            "%d x %.2f GB in flight + %.2f GB atlas)"
            % (total / 2**30, hbm_budget / 2**30, len(progs),
               persistent / 2**30, execb / 2**30, pipeline_depth + 1,
               flight / 2**30, atlas / 2**30))
    return plan


def render_multiplexed(jobs, bufsize=None, readback="exact",
                       device="cuda", profile=True, stage_mode="exact",
                       pipeline_depth=3, hbm_budget=None, batch=1):
    """Time-division-multiplexed serving: ONE scheduler drives all
    streams through ONE shared TorchMixer, rotating per superblock:
    record stream A's next superblock while the card computes B's and
    C's readback is in flight.  The shared mixer unions every stream's
    shapes, so streams with equal shapes share one graph; per-stream
    device state (fbdelay rings, filter state) and atlas entries are
    namespaced.

    Per-stream output is bit-exact with a solo render.  A stream whose
    content the device program cannot express (its record raises
    ``Unsupported`` or ``A2Exception``, or its dispatch meets a value
    outside the packed format's tables, ``Unsupported``) is bridged to
    the native path at its emitted frontier, sample-exactly, without
    disturbing the others.  A stream whose dispatch or fetch fails on the card stops
    with the error in its job's ``.error``; the others render on, and
    the first such error is raised at the end.

    batch > 1 groups streams into fixed batches whose superblocks run
    as ONE graph launch (TorchMixer.dispatch_many).  Each group's batch
    graph is captured after profiling; when a group's members drain
    unevenly (different stream lengths, or a member bridges natively)
    the rest dispatch one by one.  A failed batched dispatch bridges
    (``Unsupported``) or fails every stream of the group."""
    from .cuda.mixer import TorchMixer

    core = _SharedCore()
    mixer = TorchMixer(core, device=device, readback=readback,
                       stage_mode=stage_mode)
    if bufsize is None:
        bufsize = 1376 * 64
    bufsize -= bufsize % 64

    class _S:
        def __init__(self, j):
            self.j = j
            self.r = DeviceRenderer(j.interface, channels=j.channels,
                                    mixer=mixer)
            self.r.timestamp_reset()
            self.r.start(0, j.program, *j.args)
            j.renderer = self.r
            self.recorded = 0
            self.emitted = 0
            self.chunks = [] if j.sink is None else None
            self.native = False

        def emit(self, bufs):
            frames = len(bufs[0])
            keep = min(frames, self.j.frames - self.emitted)
            if keep <= 0:
                return
            if keep < frames:
                bufs = [b[:keep] for b in bufs]
            self.emitted += keep
            if self.j.sink is not None:
                self.j.sink(bufs, keep)
            else:
                self.chunks.append(np.stack(bufs))

        @property
        def live(self):
            return not self.native and self.j.error is None

        def bridge(self):
            """Sample-exact native continuation from the emitted
            frontier (drops this stream's in-flight superblocks)."""
            self.native = True
            self.r._fallback(self.emitted, 0)
            n = self.emitted
            while n < self.j.frames:
                frames = min(bufsize, self.j.frames - n)
                self.emit(list(self.r.nr.run(frames)))
                n += frames
            self.recorded = self.j.frames

        def finish(self):
            if self.j.sink is None and self.chunks:
                self.j.output = np.concatenate(self.chunks, axis=1)

    streams = [_S(j) for j in jobs]
    # one kernel build for the fleet
    streams[0].r.wait_device()
    if profile:
        for s in streams:
            s.r._profile(s.j.frames, bufsize)
        # the whole fleet has profiled: freeze the packed dispatch format
        # over every stream's recorded values (a stream that records a
        # value outside them later bridges natively at its dispatch)
        mixer.finalize_format()
        progs = [s.r._profiled_prog for s in streams
                 if s.r._profiled_prog is not None]
        # refuse a fleet whose device-resident state cannot fit before
        # any stream starts
        fleet_hbm_plan(mixer, progs, pipeline_depth=pipeline_depth,
                       hbm_budget=hbm_budget)
        # capture every stream's signature up front (streams with equal
        # shapes share one graph)
        for p in progs:
            mixer.precompile(p)

    # fixed stream groups for batched dispatch (see docstring)
    batch = max(1, int(batch))
    groups = [streams[i:i + batch] for i in range(0, len(streams), batch)]
    if profile and batch > 1:
        for g in groups:
            gp = [s.r._profiled_prog for s in g]
            if len(g) > 1 and all(p is not None for p in gp):
                mixer.precompile_many(gp)

    # the solo render()'s pipeline with stream rotation: the main
    # thread records a group's next superblocks while a dispatch thread
    # launches the previous group's, the card holds up to
    # `pipeline_depth` superblocks and a fetch pool reads the oldest
    depth = max(batch, int(pipeline_depth))
    rot = 0
    rec_out = None           # [(stream, prog), ...] awaiting dispatch
    disp = None              # running dispatch thread
    dres = [None, None, None]    # (group, handles, error)
    inflight = deque()       # (stream, handle) enqueued on the card
    # per-stream emission order is kept: the pool is FIFO over the
    # (stream-ordered) inflight queue and only its oldest entry emits
    FPOOL = max(1, min(int(os.environ.get("A2_FETCH_POOL", "3")), depth))
    fpool = deque()          # (thread, [stream, out, error])

    def drop_inflight(s2):
        """Discards s2's pipeline slots (it bridged natively or
        failed)."""
        nonlocal rec_out
        if rec_out is not None:
            rec_out = [e for e in rec_out if e[0] is not s2] or None
        for ent in [e for e in inflight if e[0] is s2]:
            inflight.remove(ent)

    def record_raw(s, slot):
        """Records s's next superblock into slot = [prog, error].
        Thread-safe: each stream owns its native engine state, and the
        fleet-shared PairAtlas is changed under its lock (atlas_entry);
        the native record releases the GIL, so a group's streams record
        in parallel on a multi-core host."""
        try:
            slot[0] = s.r._next_program(bufsize)
        except BaseException as e:
            slot[1] = e

    # record-pool width (A2_RECORD_POOL, default the host's cores): at
    # most this many records run at once; 1 keeps the serial path
    try:
        RPOOL = int(os.environ.get("A2_RECORD_POOL",
                                   str(os.cpu_count() or 1)))
    except ValueError:
        RPOOL = os.cpu_count() or 1
    RPOOL = max(1, RPOOL)
    rec_sem = threading.Semaphore(RPOOL)

    def record_bounded(s, sl):
        with rec_sem:
            record_raw(s, sl)

    def stop(s2, err):
        """Takes s2 off the device: content the device program cannot
        express bridges natively, any other error fails the stream."""
        drop_inflight(s2)
        if isinstance(err, (A2Exception, Unsupported)):
            s2.bridge()
        else:
            s2.j.error = err

    def record_group(live):
        """Records every live stream's next superblock; returns the
        [(stream, prog), ...] that succeeded, stopping failures."""
        slots = [[None, None] for _ in live]
        if RPOOL > 1 and len(live) > 1:
            ths = [threading.Thread(target=record_bounded, args=(s, sl))
                   for s, sl in zip(live, slots)]
            for t in ths:
                t.start()
            for t in ths:
                t.join()
        else:
            for s, sl in zip(live, slots):
                record_raw(s, sl)
        recs = []
        for s, (prog, err) in zip(live, slots):
            if err is not None:
                stop(s, err)
            else:
                s.recorded += bufsize
                recs.append((s, prog))
        return recs

    while True:
        active = [s for s in streams if s.live and s.recorded < s.j.frames]
        if not active and rec_out is None and disp is None \
                and not inflight and not fpool:
            break
        blocked = False      # did this iteration do blocking work
        if active and rec_out is None:
            # the next group's superblocks (a whole group dispatches
            # batched; a partial one superblock by superblock)
            for _ in range(len(groups)):
                g = groups[rot % len(groups)]
                rot += 1
                live = [s for s in g if s in active]
                if live:
                    break
            recs = record_group(live)
            if recs:
                rec_out = recs
                blocked = True
        if disp is not None:
            disp.join()
            disp = None
            blocked = True
            grp, hs, err = dres
            if err is not None:
                # the group's superblocks never ran: content the device
                # cannot express (a value outside the packed format's
                # tables) bridges its streams, any other fault fails them
                for s2, _ in grp:
                    if s2.live:
                        stop(s2, err)
            else:
                for (s2, _), h in zip(grp, hs):
                    if s2.live:
                        inflight.append((s2, h))
        if rec_out is not None:
            grp = rec_out
            rec_out = None
            whole = len(grp) == batch

            def put(grp=grp, whole=whole):
                dres[0], dres[1], dres[2] = grp, None, None
                try:
                    if whole and len(grp) > 1:
                        dres[1] = mixer.dispatch_many([p for _, p in grp])
                    else:
                        dres[1] = [mixer.dispatch(p) for _, p in grp]
                except BaseException as e:
                    dres[2] = e
            disp = threading.Thread(target=put)
            disp.start()
        if fpool and (not fpool[0][0].is_alive()
                      or len(inflight) + len(fpool) >= depth
                      or not blocked):
            th, slot = fpool.popleft()
            th.join()
            s2, out, err = slot
            if err is not None:
                if s2.live:
                    drop_inflight(s2)
                    s2.j.error = err
            elif s2.live:
                s2.emit(out)
        while len(fpool) < FPOOL and inflight:
            s2, h = inflight.popleft()
            slot = [s2, None, None]

            def get(h=h, slot=slot):
                try:
                    slot[1] = mixer.fetch(h)
                except BaseException as e:
                    slot[2] = e
            th = threading.Thread(target=get)
            th.start()
            fpool.append((th, slot))
    for s in streams:
        s.finish()
    for j in jobs:
        if j.error is not None:
            raise j.error
    return jobs
