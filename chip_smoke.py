#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (``audiality2_tpu_torch``) only; nothing here imports
``jax`` or ``audiality2_tpu``.  Phases, each printing one line with its
seconds:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, whether nvcc is found;
2. build: the native runtime (native/build.sh) and the eight kernel
   libraries (one nvcc per source for sm_90a), from the sources in the
   checkout, all in parallel;
3. kernel: the CUDA oscillator's two epilogues against their plain
   PyTorch versions on the card: the rows (``osc_call`` against
   ``osc_rows_torch``) and the slot adds (``osc_slots_call`` against
   ``osc_slots_torch``, seeded slot contents, slots shared by many rows
   of a block and the dead slot), on seeded rows for every pass class x
   quality x mono x fused_pm and on the slice song's real blocks and
   slot indices: 0 mismatches; times the slots form per superblock
   against the earlier form (``osc_call``, then ``index_add_`` of the
   transposed rows) in turns (OSC_ROUNDS each, device time in a CUDA
   graph), beside its bound, the rows epilogue alone (the median of
   OSC_ROUNDS rounds) and the plain versions at the real shape, and
   counts how many live rows of a block share a slot;
4. tail: the stage-tail kernels (fbdelay dense and legacy, filter12 /
   dcblock / limiter, fm) against their plain versions: on seeded
   tables for every variant (the CUDA entry point against the same
   entry point on CPU copies, which takes the plain version; the
   filter and fm tables in three slot layouts: slots shared by few
   values, so that step groups break often; slots of their own; in
   place over split fragments, whose disjoint windows keep one group;
   and with K = 300), and on the real items of the effects
   song's first superblock and of the late fbdelay song's (the whole
   real tables, seeded slot contents; the plain version on the card),
   and on seeded full superblocks of the fbdelay loops (dense at
   fb = 64 and fb = 2^17, legacy at C = 1): 0 mismatches; prints each
   real filter / fm item's group count; times each kernel (device time
   through a CUDA graph of repeated launches) and each plain version
   at that shape;
5. expand: the run expansion's kernel (``expand_call``: the run order,
   a block per 128 rows (decode, row fields, ramp replay, params), then
   the class-0 rows' samples added into the slots) against its plain
   version ``expand_plain`` on the card, params, slot indices and slots
   bit for bit, on seeded tables (sorted, shuffled and all-dead runs;
   packed and plain runs; ramps absent, plain and packed; mono and
   stereo; noise, dc and dead rows; several pass classes) and on the
   first superblocks
   of the slice song (plain tables) and the effects song (packed); the
   mixer's ``_expand`` on them equal to the earlier path (the
   decoders, the torch glue, the oscillator, an ``index_add_`` per pass
   class), with no ``index_add_`` of its own; the kernel's ms (a CUDA
   graph of repeated launches) beside its bound and the plain version's
   ms; the kernel nodes of a CUDA graph of one ``_expand`` (at most 40)
   and of one superblock body, each beside the earlier path's;
6. capture: the graph-capture probe: a seeded filter12 item and a
   seeded fm item, whose kernels launch cooperatively
   (``cudaLaunchCooperativeKernel``), captured into a CUDA graph,
   replayed, and held against the same launch made eagerly;
7. slice: the slice song (stereo, 44.1 kHz, 10 s, superblocks of
   2752x64 frames) through ``DeviceRenderer(device=DEVICE).render``
   (profile pass, one CUDA graph, the pipeline) against the native
   renderer, bit for bit, with no native bridging and with oscillator
   launches; then 2 s mono the same way;
8. effects: the effects song, stereo 10 s, the same way, with launches
   of the oscillator, the dense fbdelay, the filter and the fm kernels;
9. legacy: the late fbdelay song, mono, the same way, with launches of
   the legacy fbdelay kernel;
10. pipeline: the same four renders with ``chain_dispatch=4`` (chains of
   4 superblocks per graph launch), the same checks, and the effects
   song in quarter superblocks so that whole chains run; then the
   synchronous render (``run`` per superblock) and the pipelined one
   of the slice and effects songs timed in alternating pairs (3 each),
   with x realtime, the card's idle share (graph launches bracketed by
   CUDA events) and host seconds by phase; then ``torch.profiler`` over
   a pipelined render of the effects and late fbdelay songs must show
   each kernel's name among the graph's device kernels;
11. serve: ``serve.render_multiplexed`` of four streams (two slice, two
   effects with different arguments, batch 2) and ``serve.render_many``
   of two (slice, effects), each stream bit for bit against its solo
   native render, every kernel of the path launched; aggregate x
   realtime;
12. float: the float stage tier's kernel (``filter_float_call``, one
   cooperative launch per item) against its plain version on the card,
   bit for bit, on seeded items (every kind x inputs x outputs x add in
   two slot layouts, both outputs on one slot channel, a
   full-superblock limiter stereo and stereo-in / mono-out, filter12
   outputs driven past the int32 range, a single chain of 88 tiles,
   more tiles than the card holds at once (tile buffers in shared
   memory with several tiles per block, and in device memory), ragged
   last tiles) and on the effects song's real limiter, filter12 and
   dcblock items, each timed beside the exact tier's kernel on the same
   item and its bound, with the kernel nodes of a CUDA graph of one
   call counted (one); then ``stage_mode="float"`` renders, pipelined: the float
   song, the damped song (filter12 in the float tier too) and the
   effects song each bit-equal to the same render through the plain
   versions on the CPU (``DeviceRenderer(device="cpu",
   stage_mode="float")``) and within their dB limits of native,
   ``songs.RESO_SONG`` bit-equal to native (its resonant filter12 stays
   exact); then the effects song exact against float, 10 s, in
   alternating pairs, each again equal to its reference;
13. cli: ``audiality2_tpu_torch.cli.main(["-c", "2", "-st", "10", "-o",
   wav, path])`` (the card by default) and the same with ``--gpu`` on
   the effects song written to a temporary .a2s file: the WAV's PCM
   equal to clip(native >> 8), every kernel of the path launched, the
   CLI's x realtime.

14. shards: ``parallel.render_sharded``: the effects song (stereo, 10 s,
   superblocks of 1376x64 frames) at 1, 2, 4 and 8 shards on the card
   (in process, the card repeated) and under NCCL at world size 1, and
   the slice song at 4 shards, each bit-equal to native and to the solo
   ``DeviceRenderer.render`` of the same superblocks; the oscillator,
   filter, fm and fbdelay kernels launched inside the sharded renders;
   per-shard expansion, sum and tail device times per superblock,
   printed beside the card's name and power limit; then
   ``graft_entry.entry()`` and ``dryrun_multichip(4)`` on the card, with
   launches of the row kernel (the voice-batched helpers);
15. osc_batch: ``tpu.osc_kernel.OscBatch`` / ``evaluate_osc_batch``, the
   oscillator's general entry point: the JAX package's kernel-ceiling
   batch (16,384 rows on saw mip 0, seed 0) at qualities 0 and 2 and a
   mixture of five waves at mips 0/1/3/5 at 0/1/2, each call on the
   card with 5 oscillator launches (the slots epilogue, each row into
   its own row of the output) and equal to the plain version on
   the CPU and to the numpy twin; the kernel's device ms (a CUDA graph),
   the host add and build ms and the copy-back ms, printed beside the
   card's name and power limit.

Every kernel launch counter is set to 0 just before each render and
read just after; a graph launch adds the launches captured in it.
Then one JSON line with the kernels' numbers and, last, the
``{"ok": true, "device": ...}`` line.  Any failure raises, and the exit
code is not 0.  Needs one card; exits non-zero without one.
``--phases a,b`` runs only the named phases of 3-15 after device,
build (for quick checks; the full run takes no argument).
"""

import argparse
import contextlib
import copy
import ctypes
import io
import itertools
import json
import os
import shutil
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import audiality2_tpu_torch as a2
from audiality2_tpu_torch.cuda import build
from audiality2_tpu_torch.cuda import expand as EX
from audiality2_tpu_torch.cuda import fbdelay as FB
from audiality2_tpu_torch.cuda import filter as FL
from audiality2_tpu_torch.cuda import filter_float as FF
from audiality2_tpu_torch.cuda import fm as FM
from audiality2_tpu_torch.cuda import osc_kernel as OK
from audiality2_tpu_torch.cuda import packed as PK
from audiality2_tpu_torch.cuda import rows as CR
from audiality2_tpu_torch.cuda.mixer import (KERNEL_WRAPPERS,
                                             _FLOAT_TIER_MINQ, TorchMixer,
                                             _StateSet, blob_layout,
                                             blob_views)
from audiality2_tpu_torch.cuda.superblock import RC_LEN, RR_PTGT, RR_PV
from audiality2_tpu_torch.engine.device_render import (DeviceRenderer,
                                                       SUPERBLOCK_FRAMES)
from audiality2_tpu_torch import cli, graft_entry, serve
from audiality2_tpu_torch.native import NativeRenderer
from audiality2_tpu_torch.parallel import DEFAULT_BUFSIZE, render_sharded
from audiality2_tpu_torch.shard_scaling import summarize
from audiality2_tpu_torch.songs import SONGS
from audiality2_tpu_torch.tail_ab import graph_ms
from audiality2_tpu_torch.tpu import osc_kernel as TOK
from audiality2_tpu_torch.tpu import row_kernel as TRK

ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 44100
# H100 SXM peaks for the bound: HBM at 3.35 TB/s (data sheet); int32
# ALU at 64 lanes/SM x 132 SMs x 1.98 GHz boost (Hopper white paper)
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 64 * 132 * 1.98e9
# float32 outside the tensor cores, 67 TFLOP/s (data sheet)
FP32_OPS_S = 67e12
DEVICE = "cuda"
# rounds of the oscillator's timing, for its spread within one run
OSC_ROUNDS = 5


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def phase(name, t0, text):
    torch.cuda.synchronize()
    print("phase %-7s %8.3f s  %s" % (name, time.perf_counter() - t0, text),
          flush=True)


def cuda_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes, nops, ops_s=INT32_OPS_S):
    """(bound ms, "bytes" or "operations") of work at the card's peaks
    (ops_s: the peak rate of the work's operations)."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = nops / ops_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def record(name, source, replaces, ms, plain_ms, nbytes, nops, max_err,
           ops_s=INT32_OPS_S, **extra):
    bms, by = bound(nbytes, nops, ops_s)
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "max_abs_err": max_err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
           "bound_by": by, "library_ms": None}
    rec.update(extra)
    return rec


def mismatches(pairs):
    """(mismatching values, max abs difference) over (kernel, plain)
    tensor pairs."""
    bad = err = 0
    for a, b in pairs:
        a = a.cpu().to(torch.int64)
        b = b.cpu().to(torch.int64)
        check(a.shape == b.shape, "kernel and plain shapes differ")
        bad += int((a != b).sum())
        if a.numel():
            err = max(err, int((a - b).abs().max()))
    return bad, err


def open_song(song, channels, renderer, args=(), **kw):
    src, program = SONGS[song]
    i = a2.open_engine(SR, 4096, channels, batched=False)
    s = i.get(i.load_string(src, song), program)
    r = renderer(i, channels=channels, **kw)
    r.timestamp_reset()
    r.start(0, s, *args)
    return r


def native_render(song, channels, frames, args=(), sb=SUPERBLOCK_FRAMES):
    """The native renderer over the same whole superblocks of `sb` frames
    as the device path (a ragged last fragment would bend its ramps off
    the device path's full-fragment record), trimmed to `frames`."""
    nat = open_song(song, channels, NativeRenderer, args)
    want = np.concatenate(
        [nat.run(sb) for _ in range(-(-frames // sb))], axis=1)[:, :frames]
    nat.close()
    return want


# every kernel wrapper: the mixer's, and the host engine's row batch
WRAPPERS = dict(KERNEL_WRAPPERS, rows=CR.rows_call)
# the wrappers that also count by kind
KIND_WRAPPERS = (("filter", FL.filter_call, FL.KINDS),
                 ("filter_float", FF.filter_float_call, FL.KINDS),
                 ("unpack", PK.unpack_call, tuple(PK.KINDS)),
                 ("expand", EX.expand_call, EX.KINDS))


def zero_launches():
    for fn in WRAPPERS.values():
        fn.launches = 0
    for _, fn, kinds in KIND_WRAPPERS:
        fn.kind_launches = dict.fromkeys(kinds, 0)


def read_launches():
    launches = {k: fn.launches for k, fn in WRAPPERS.items()}
    for name, fn, _ in KIND_WRAPPERS:
        launches.update((name + "_" + k, n)
                        for k, n in fn.kind_launches.items())
    return launches


def mixer_formats(mixer):
    """The packed-format element of every signature the mixer ran (its
    single, chain and batch entries)."""
    sigs = list(mixer._fns)
    for key in mixer._chain_fns:
        sigs += list(key[1]) if key[0] == "many" else [key[1]]
    return [sig[12] for sig in sigs]


def check_packed(label, formats, launches, need):
    """Each mixer of a profiled render decided its packed format once
    (formats: per mixer, the format element of its signatures, all
    equal), the expansion kernel decoded packed runs ("rmq") exactly when
    a mixer's format is on, and the standalone decoder never launched
    (the expansion decodes the runs itself).  need: a mixer's format
    must be on.  (The format's
    field caps decide it as the JAX package's do: at superblocks of 2752
    fragments a run longer than 255 fragments, a sustained note, breaks
    the 8-bit LEN field, and the song ships its tables unpacked.)
    Returns whether a mixer ran packed."""
    for f in formats:
        check(f and all(x == f[0] for x in f), "%s: a mixer's signatures "
              "with different formats: %s" % (label, f))
    packed = any(f[0] is not None for f in formats)
    check(packed or not need, "%s: the packed format is off" % label)
    check((launches["expand_rmq"] > 0) == packed, "%s: %d packed run "
          "decodes with the format %s" % (label, launches["expand_rmq"],
                                          "on" if packed else "off"))
    check(launches["unpack"] == 0, "%s: %d standalone decoder launches on "
          "the main path" % (label, launches["unpack"]))
    return packed


@contextlib.contextmanager
def formats_seen():
    """The packed-format element of every signature that any TorchMixer
    takes inside the block (for a render whose mixer is out of reach,
    the CLI's)."""
    seen = []
    real = TorchMixer._signature

    def spy(self, prog):
        sig = real(self, prog)
        seen.append(sig[12])
        return sig
    TorchMixer._signature = spy
    try:
        yield seen
    finally:
        TorchMixer._signature = real


def first_program(song, channels):
    """The first superblock program of `song`, recorded on the card's
    renderer."""
    r = open_song(song, channels, DeviceRenderer, device=DEVICE)
    prog = r.record_program(SUPERBLOCK_FRAMES)
    atlas = r.mixer.device_atlas()
    r.close()
    return prog, r, atlas


def phase_device():
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    phase("device", t0, "%s | torch %s, CUDA %s, %d device(s), nvcc %s"
          % (torch.cuda.get_device_name(0), torch.__version__,
             torch.version.cuda, torch.cuda.device_count(),
             nvcc if os.path.exists(nvcc) else "not found"))
    return card


def phase_build():
    t0 = time.perf_counter()
    native = subprocess.Popen(["sh", os.path.join(ROOT, "native",
                                                  "build.sh")],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    try:
        paths = build.build(verbose=True)
    finally:
        nout, _ = native.communicate(timeout=build.BUILD_TIMEOUT_S)
    check(native.returncode == 0, "native build failed:\n" + nout)
    for mod in (OK, FB, FL, FM, FF, PK, CR, EX):
        mod._load()
    ptxas = ["%s: %s" % (n, " | ".join(
        ln.strip() for ln in build.build_log.get(n, "").splitlines()
        if "registers" in ln or "spill" in ln)) for n in build.SOURCES]
    phase("build", t0, "native/liba2rt.so, %s; ptxas: %s"
          % (", ".join(os.path.relpath(p, ROOT) for p in paths.values()),
             " || ".join(ptxas)))


def compare(cls, tb, par, atlas, quality, fused, mono):
    got = OK.osc_call(cls, tb, par, atlas, quality=quality,
                      fused_pm=fused, mono=mono)
    want = OK.osc_rows_torch(cls, tb, par, atlas, quality, fused, mono)
    return mismatches([(got, want)])


def compare_slots(blocks, atlas, slots, quality, fused, mono):
    """The slots epilogue against osc_slots_torch, each adding the pass
    classes' rows `blocks` ((cls, tb, par, slot_r) each) into its own
    copy of `slots`."""
    got, want = slots.clone(), slots.clone()
    for cls, tb, par, sl in blocks:
        OK.osc_slots_call(cls, tb, par, atlas, got, sl, quality=quality,
                          fused_pm=fused, mono=mono)
        OK.osc_slots_torch(cls, tb, par, atlas, want, sl, quality, fused,
                           mono)
    return mismatches([(got, want)])


def slot_sharing(blocks):
    """How many live rows of one 128-row block share a slot, over the
    blocks of `blocks`: (mean of each block's largest count, the share
    of live rows whose slot holds another live row of their block)."""
    most, shared, live_rows = [], 0, 0
    for _, _, par, sl in blocks:
        p = par.cpu().numpy().astype(np.int64)
        win = np.clip(p[OK.P_END], 0, OK.FRAG) - np.clip(p[OK.P_OFF], 0,
                                                         OK.FRAG)
        live = (((p[OK.P_AMP0] != 0) | (p[OK.P_DAMP] != 0)) & (win > 0)) \
            .reshape(-1, OK.RPB)
        srow = sl.cpu().numpy().reshape(-1, OK.RPB)
        for lv, s in zip(live, srow):
            if lv.any():
                _, cnt = np.unique(s[lv], return_counts=True)
                most.append(int(cnt.max()))
                shared += int(cnt[cnt > 1].sum())
                live_rows += int(lv.sum())
    return float(np.mean(most)), shared / max(live_rows, 1)


def phase_kernel():
    """The oscillator kernel's two epilogues against their plain
    versions, and the slots epilogue timed against the earlier form
    (osc_call, then index_add_ of the transposed rows) in turns; returns
    the JSON records of both (launches filled in by the slice phase)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(2024)
    nvar = 0
    max_err = 0
    nslot = 64
    for npass in OK.PASS_CLASSES:
        tb, par, atlas = (torch.from_numpy(x).to(DEVICE) for x in
                          OK.seeded_blocks(npass, 16, rng, dead=True))
        # slots shared by many rows, within a block too, and the dead
        # slot; seeded contents, so that the adds wrap
        sl = torch.from_numpy(OK.seeded_slot_rows(par.shape[1], nslot,
                                                  rng)).to(DEVICE)
        slots = torch.from_numpy(rng.integers(
            -(1 << 31), 1 << 31, (nslot, 2, OK.FRAG)).astype(np.int32)) \
            .to(DEVICE)
        for quality in (0, 1, 2):
            for fused in (True, False):
                for mono in (False, True):
                    for form, (bad, err) in (
                            ("rows", compare(npass, tb, par, atlas, quality,
                                             fused, mono)),
                            ("slots", compare_slots(
                                [(npass, tb, par, sl)], atlas, slots,
                                quality, fused, mono))):
                        check(bad == 0, "kernel (%s) != plain: npass %d "
                              "quality %d fused %s mono %s: %d mismatches"
                              % (form, npass, quality, fused, mono, bad))
                        max_err = max(max_err, err)
                    nvar += 1

    # the slice song's first superblock at its real shapes
    prog, r, atlas = first_program("slice", 2)
    classes, slot_r, mono = r.mixer.row_params(prog)
    blocks = []
    b0 = 0
    for (cls, NB), (_, tb, par) in zip(
            [(c, NB) for c, NB, _ in prog.class_blocks if NB], classes):
        if cls:
            blocks.append((cls, tb, par, slot_r[b0:b0 + NB * OK.RPB]))
        b0 += NB * OK.RPB
    zeros = torch.zeros((prog.ninst * prog.F + 1, 2, OK.FRAG),
                        dtype=torch.int32, device=DEVICE)
    for cls, tb, par, _ in blocks:
        bad, err = compare(cls, tb, par, atlas, 0, True, mono)
        check(bad == 0, "kernel (rows) != plain on the slice song's class "
              "%d blocks: %d mismatches" % (cls, bad))
        max_err = max(max_err, err)
    bad, err = compare_slots(blocks, atlas, zeros, 0, True, mono)
    check(bad == 0, "kernel (slots) != plain on the slice song's "
          "superblock: %d mismatches" % bad)
    max_err = max(max_err, err)

    # the rows epilogue alone, as earlier PRs timed it
    rounds = [0.0] * OSC_ROUNDS
    plain_ms = 0.0
    nbytes = nops = 0
    nrows = 0
    C = 1 if mono else 2
    for cls, tb, par, sl in blocks:
        R = par.shape[1]
        nrows += R
        for i in range(OSC_ROUNDS):
            rounds[i] += cuda_ms(lambda: OK.osc_call(cls, tb, par, atlas, 0,
                                                     True, mono), reps=20)
        plain_ms += cuda_ms(lambda: OK.osc_rows_torch(cls, tb, par, atlas,
                                                      0, True, mono),
                            reps=3, warmup=1)
        nbytes += par.numel() * 4 + tb.numel() * 4 + atlas.numel() * 4 \
            + C * OK.FRAG * R * 4
        nops += R * OK.FRAG * OK.ops_per_frame(0, True, mono)
    buf = zeros.clone()
    plain_slots_ms = cuda_ms(lambda: [OK.osc_slots_torch(
        cls, tb, par, atlas, buf, sl, 0, True, mono)
        for cls, tb, par, sl in blocks], reps=3, warmup=1)
    ms = float(np.median(rounds))

    # the superblock's oscillator and slot adds: the earlier form and the
    # slots epilogue in turns (device time per call in a CUDA graph)
    def earlier():
        for cls, tb, par, sl in blocks:
            res = OK.osc_call(cls, tb, par, atlas, 0, True, mono)
            EX.add_rows(buf, sl, res.t(), mono)

    def slots_form():
        for cls, tb, par, sl in blocks:
            OK.osc_slots_call(cls, tb, par, atlas, buf, sl, 0, True, mono)
    t_earlier, t_slots = [], []
    for i in range(OSC_ROUNDS):
        pair = ((earlier, t_earlier), (slots_form, t_slots))
        for fn, out in (pair if i % 2 == 0 else pair[::-1]):
            out.append(graph_ms(fn))
    ms_slots = float(np.median(t_slots))
    ms_earlier = float(np.median(t_earlier))
    nbytes_s, nops_s = OK.slots_work(
        [(cls, tb.cpu().numpy(), par.cpu().numpy(), sl.cpu().numpy())
         for cls, tb, par, sl in blocks], atlas.shape[0], 0, True, mono)
    share = slot_sharing(blocks)
    shapes = " ".join("%dx%d" % (cls, par.shape[1] // OK.RPB)
                      for cls, _, par, _ in blocks)
    bms, by = bound(nbytes_s, nops_s)
    phase("kernel", t0, "%d variants x (rows, slots on shared slots) + "
          "slice blocks (pass class x blocks: %s, %d rows) equal to the "
          "plain versions; slots form %.4f ms per superblock (rounds %s; "
          "bound %.4f ms, %s) against osc_call + index_add_ %.4f ms "
          "(rounds %s), plain %.3f ms; rows alone %.4f ms (rounds %s), "
          "plain %.3f ms; live rows per slot within a block: largest %.2f "
          "(mean over blocks), %.1f%% of live rows share their slot"
          % (nvar, shapes, nrows, ms_slots,
             " ".join("%.4f" % t for t in t_slots), bms, by, ms_earlier,
             " ".join("%.4f" % t for t in t_earlier), plain_slots_ms, ms,
             " ".join("%.4f" % t for t in rounds), plain_ms,
             share[0], 100 * share[1]))
    src = "audiality2_tpu_torch/cuda/csrc/osc_kernel.cu"
    return [record("osc_slots", src, "audiality2_tpu/tpu/osc_kernel.py:117",
                   ms_slots, plain_slots_ms, nbytes_s, nops_s, max_err,
                   rows=nrows, variants_checked=nvar, ms_rounds=t_slots,
                   earlier_ms=ms_earlier, earlier_rounds=t_earlier,
                   earlier="osc_call + index_add_ of the transposed rows",
                   replaces_function="_make_kernel via _osc_call (:283), "
                   "with the segment_sum at audiality2_tpu/tpu/"
                   "superblock.py:1694", rows_per_slot_in_block=share[0],
                   shared_row_share=share[1]),
            record("osc_rows", src, "audiality2_tpu/tpu/osc_kernel.py:117",
                   ms, plain_ms, nbytes, nops, max_err, rows=nrows,
                   variants_checked=nvar, ms_rounds=rounds)]


# ---------------------------------------------------------------
# the stage tail's kernels
# ---------------------------------------------------------------

def on(dev, *arrays):
    """Copies of numpy arrays on `dev`."""
    return [torch.tensor(np.ascontiguousarray(a), device=dev)
            for a in arrays]


def seeded_tail(rng):
    """Every seeded variant through the CUDA entry points against the
    same entry points on CPU copies (the plain versions); returns
    {kernel name: (variants, max abs err)}."""
    out = {}
    n = err = 0
    # chunk delays, then taps that fall on their own step's writes
    # (delays of 1-100 samples in chunks of 1; delays that wrap the ring
    # forward), which the kernel reads before its barrier
    for form in itertools.product((True, False), repeat=3):
        for C, fb in ((1, None), (4, None), (1, 1),
                      (4, FB.FBD_BUFSIZE - 150)):
            slots, arr, ring, bufpos = FB.seeded_legacy(rng, C, fb=fb)
            res = []
            for dev in (DEVICE, "cpu"):
                s, a, rg = on(dev, slots, arr, ring)
                FB.apply_fbdelay(s, form + (C,), a, rg, bufpos)
                res.append((s, rg))
            bad, e = mismatches(zip(*res))
            check(bad == 0, "fbdelay legacy %s C %d fb %s: %d mismatches"
                  % (form, C, fb, bad))
            n, err = n + 1, max(err, e)
    out["fbdelay_legacy"] = (n, err, None)
    n = err = 0
    for form in itertools.product((True, False), repeat=3):
        for F in (12, 40):
            slots, arr, tail, par = FB.seeded_dense(rng, F)
            sig = form + (FB.chunk_for(par[0]),) + par
            res = []
            for dev in (DEVICE, "cpu"):
                s, a, tl = on(dev, slots, arr, tail)
                res.append((s, FB.apply_fbdelay_dense(s, sig, a, tl, F)))
            bad, e = mismatches(zip(*res))
            check(bad == 0, "fbdelay dense %s F %d: %d mismatches"
                  % (form, F, bad))
            n, err = n + 1, max(err, e)
    out["fbdelay_dense"] = (n, err, None)
    # step groups: slots shared by few values (groups break often),
    # conflict-free (one group spans the item), in-place instances over
    # split fragments (disjoint windows of one slot: one group too);
    # K = 300 makes the block's threads take several instances each
    n = err = 0
    groups = {}
    # the limiter's peak chains run in chunks from a guessed start and
    # are repaired (seeded peaks far above their floor: long repairs);
    # S = 200 gives its chunks several slices each
    for kind, (ni, no), add, layout, SK in itertools.product(
            FL.KINDS, ((1, 1), (2, 2), (1, 2), (2, 1)), (True, False),
            FL.LAYOUTS, ((12, 6), (3, 300), (200, 1))):
        S, K = SK
        if S == 200 and kind != "lim":
            continue
        slots, arr, state = FL.seeded_item(rng, kind, ni, no, S, K,
                                           nslot=2 * K + 8, layout=layout)
        sig = (ni, no, add, (0, 1)[:ni] if ni == 2 else (1,),
               (1, 0) if no == 2 else (0,))
        G = len(FL.groups(arr, sig)) - 1
        check(layout == "shared" or G == 1, "a conflict-free filter "
              "table (%s) cut into %d groups" % (layout, G))
        groups.setdefault(layout, []).append(G)
        res = []
        for dev in (DEVICE, "cpu"):
            s, a, st = on(dev, slots, arr, state)
            FL.filter_call(s, kind, sig, a, st)
            res.append((s, st))
        bad, e = mismatches(zip(*res))
        check(bad == 0, "filter %s %d->%d add %s %s K %d: %d mismatches"
              % (kind, ni, no, add, layout, K, bad))
        n, err = n + 1, max(err, e)
    out["filter"] = (n, err, groups)
    n = err = 0
    groups = {}
    sine = {dev: on(dev, FM.sine_pairs())[0] for dev in (DEVICE, "cpu")}
    for sk, add, layout, SK in itertools.product(
            FM.STRUCTKEYS, (True, False), FL.LAYOUTS, ((8, 5), (2, 300))):
        S, K = SK
        slots, arr, state = FM.seeded_item(rng, sk, S, K, nslot=2 * K + 8,
                                           layout=layout)
        sig = (sk, add, 1 if add else 0)
        groups.setdefault(layout, []).append(len(FM.groups(arr, sig)) - 1)
        res = []
        for dev in (DEVICE, "cpu"):
            s, a, st = on(dev, slots, arr, state)
            FM.fm_call(s, sig, a, st, sine[dev])
            res.append((s, st))
        bad, e = mismatches(zip(*res))
        check(bad == 0, "fm %d add %s %s K %d: %d mismatches"
              % (sk, add, layout, K, bad))
        n, err = n + 1, max(err, e)
    out["fm"] = (n, err, groups)
    return out


def time_pair(kernel, plain, make):
    """Kernel ms (graph_ms: device time per launch of a CUDA graph of
    repeated launches on the inputs of make(), which the runs keep
    updating) and plain ms of one run; kernel and plain version over the
    same fresh inputs of make() must agree.  kernel/plain take the
    inputs and return the tensors to compare."""
    warm = make()
    ms = graph_ms(lambda: kernel(*warm))
    del warm
    kin = make()
    pin = [t.clone() for t in kin]
    got = kernel(*kin)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain(*pin)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bad, err = mismatches(zip(got, want))
    return ms, plain_ms, bad, err


def seeded_i32(gen, shape):
    """Seeded int32 audio-range values on the card."""
    return torch.randint(-(1 << 27), 1 << 27, shape, dtype=torch.int32,
                         device=DEVICE, generator=gen)


def real_tail(rng):
    """The real items of the effects song's first stereo superblock (and
    the late fbdelay song's legacy item): returns {kernel name: dict of
    ms, plain_ms, bytes, ops, max_err, shape notes}."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(int(rng.integers(1 << 30)))
    prog, _, _ = first_program("effects", 2)
    slots0 = seeded_i32(gen, (prog.ninst * prog.F + 1, 2, FB.FRAG))
    out = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0,
               "max_err": 0, "items": [], "kinds": {}}
           for k in ("fbdelay_dense", "fbdelay_legacy", "filter", "fm")}

    def add(name, note, ms, plain_ms, bad, err, nbytes, nops, kind=None,
            groups=None):
        check(bad == 0, "%s kernel != plain on the real item %s: %d "
              "mismatches" % (name, note, bad))
        o = out[name]
        o["ms"] += ms
        o["plain_ms"] += plain_ms
        o["bytes"] += nbytes
        o["ops"] += nops
        o["max_err"] = max(o["max_err"], err)
        o["items"].append("%s %.4f ms (plain %.1f ms)%s"
                          % (note, ms, plain_ms, "" if groups is None
                             else ", %d groups" % groups))
        if kind is not None:
            bms, by = bound(nbytes, nops)
            o["kinds"][kind] = {"ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bms, "bound_by": by,
                                "groups": groups, "shape": note}

    for fd in prog.fbdelays:
        check(fd["dense"], "the effects song's fbdelay is not dense")
        sig = (fd["stereoin"], fd["stereoout"], fd["add"], fd["chunk"]) \
            + fd["fbpar"]
        a = on(DEVICE, fd["arr"])[0]
        x, g, _ = FB.fbd_dense_inputs(slots0, sig, a, prog.F)
        tail = seeded_i32(gen, (2, FB.FBD_TAIL))
        add("fbdelay_dense", *dense_pair(x, g, tail, fd["fbpar"][0],
                                         fd["chunk"]))

    for fl in prog.filters:
        kind, key = fl["kind"], fl["key"]
        S, K = fl["arr"].shape[:2]
        arr = on(DEVICE, fl["arr"])[0]
        if kind == "fm":
            sine = on(DEVICE, FM.sine_pairs())[0]
            sig = (key[3], key[4], key[5][0])

            def kernel(s, a, st, sig=sig, b=device_groups(FM, fl, sig)):
                return s, FM.fm_call(s, sig, a, st, sine, b)

            def plain(s, a, st):
                return s, FM.fm_torch(s, sig, a, st, sine)
            name = "fm"
            nbytes, nops = FM.work(fl["arr"], sig[0], sig[1])
            bounds = FM.groups(fl["arr"], sig)
        else:
            sig = key[3:8]

            def kernel(s, a, st, kind=kind, sig=sig,
                       b=device_groups(FL, fl, sig)):
                return s, FL.filter_call(s, kind, sig, a, st, b)

            def plain(s, a, st, kind=kind, sig=sig):
                return s, FL.filter_torch(s, kind, sig, a, st)
            name = "filter"
            nbytes, nops = FL.work(fl["arr"], kind, *sig[:3])
            bounds = FL.groups(fl["arr"], sig)

        def make(kind=kind, K=K, arr=arr):
            return (slots0.clone(), arr, FL.init_state(kind, K, DEVICE))

        ms, pms, bad, err = time_pair(
            lambda s, a, st: kernel(s, a, st),
            lambda s, a, st: plain(s, a, st), make)
        add(name, "%s S%d K%d" % (kind if kind != "fm" else "fm%d" % key[3],
                                  S, K), ms, pms, bad, err, nbytes, nops,
            kind, len(bounds) - 1)

    # the legacy form: the late fbdelay song's first mono superblock
    prog, _, _ = first_program("late_fbdelay", 1)
    slots0 = seeded_i32(gen, (prog.ninst * prog.F + 1, 2, FB.FRAG))
    for fd in prog.fbdelays:
        check(not fd["dense"], "the late fbdelay song's item is dense")
        C = fd["chunk"]
        sig = (fd["stereoin"], fd["stereoout"], fd["add"], C)
        a = on(DEVICE, fd["arr"])[0]
        x, starts = FB.fbd_legacy_inputs(slots0, sig, a, 12345)
        starts = (starts & (FB.FBD_BUFSIZE - 1)).to(torch.int32)
        add("fbdelay_legacy", *legacy_pair(
            x, a, starts, seeded_i32(gen, (2, FB.FBD_BUFSIZE)), C))
    return out


def dense_pair(x, g, tail, fb, C):
    """The dense loop's kernel against its plain version on the card:
    (note, ms, plain ms, mismatches, max err, bytes, ops)."""
    npad = x.shape[1]

    def make():
        buf = torch.empty((2, FB.FBD_TAIL + npad), dtype=torch.int32,
                          device=DEVICE)
        buf[:, :FB.FBD_TAIL] = tail
        return (buf,)

    res = time_pair(
        lambda buf: (FB.fbd_dense_call(x, g, buf, fb, C), buf),
        lambda buf: (FB.fbd_dense_torch(x, g, buf, fb, C), buf), make)
    note = "fb %d C%d: %d links per chain (%d chunk steps)" % (
        fb, C, -(-npad // fb), npad // (C * FB.FRAG))
    return (note,) + res + FB.dense_work(npad, fb)


def legacy_pair(x, a, starts, ring0, C):
    """The legacy loop's kernel against its plain version on the card:
    (note, ms, plain ms, mismatches, max err, bytes, ops)."""
    NS = a.shape[0]
    res = time_pair(
        lambda ring: (FB.fbd_legacy_call(x, a, starts, ring, C), ring),
        lambda ring: (FB.fbd_legacy_torch(x, a, starts, ring, C), ring),
        lambda: (ring0.clone(),))
    return ("C%d NS%d: %d steps" % (C, NS, NS // C),) + res \
        + FB.legacy_work(a.cpu().numpy())


def device_groups(mod, fl, sig):
    """A filter / fm item's packed step-group table on the card (what a
    graph captures)."""
    return torch.as_tensor(FL.pack_bounds(mod.groups(fl["arr"], sig),
                                          fl["arr"].shape[0]),
                           device=DEVICE)


def full_fbdelay(rng):
    """The fbdelay loops on seeded full superblocks (2752x64 frames):
    dense at fb = 64 (C = 1) and fb = 2^17, legacy at C = 1, each kernel
    against its plain version on the card; returns {kernel name: [dict of
    shape, ms, plain_ms, bound_ms, bound_by]}."""
    F = SUPERBLOCK_FRAMES // FB.FRAG
    runs = []
    for fb in (64, FB.FBD_TAIL):
        x, g, tail, C = FB.seeded_dense_loop(rng, F, fb, DEVICE)
        runs.append(("fbdelay_dense", dense_pair(x, g, tail, fb, C)))
    runs.append(("fbdelay_legacy", legacy_pair(
        *FB.seeded_legacy_loop(rng, 1, F, DEVICE), 1)))
    out = {}
    for name, (note, ms, pms, bad, err, nbytes, nops) in runs:
        check(bad == 0, "%s kernel != plain on the seeded full superblock "
              "%s: %d mismatches" % (name, note, bad))
        bms, by = bound(nbytes, nops)
        out.setdefault(name, []).append({
            "shape": note, "ms": ms, "plain_ms": pms, "bound_ms": bms,
            "bound_by": by, "max_abs_err": err})
    return out


def phase_tail():
    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    seeded = seeded_tail(rng)
    real = real_tail(rng)
    full = full_fbdelay(rng)
    sources = {
        "fbdelay_dense": ("fbdelay_kernel.cu", "_apply_fbdelay_dense",
                          2101),
        "fbdelay_legacy": ("fbdelay_kernel.cu", "_apply_fbdelay", 1982),
        "filter": ("filter_kernel.cu", "_apply_filter", 2219),
        "fm": ("fm_kernel.cu", "_apply_fm", 2604)}
    recs = []
    notes = []
    for name, (src, fn, line) in sources.items():
        nvar, serr, groups = seeded[name]
        o = real[name]
        check(o["items"], "no real %s item to check" % name)
        extra = {}
        if groups is not None:
            extra["seeded_groups"] = {k: [min(v), max(v)]
                                      for k, v in groups.items()}
        if o["kinds"]:
            extra["kinds"] = o["kinds"]
        if name in full:
            extra["seeded_full_superblocks"] = full[name]
        recs.append(record(
            name, "audiality2_tpu_torch/cuda/csrc/" + src,
            "audiality2_tpu/tpu/superblock.py:%d" % line, o["ms"],
            o["plain_ms"], o["bytes"], o["ops"], max(serr, o["max_err"]),
            variants_checked=nvar, real_items=o["items"],
            replaces_function=fn, **extra))
        notes.append("%s: %d seeded variants%s, real %s%s"
                     % (name, nvar, "" if groups is None else
                        " (groups per layout, min-max: %s)" % ", ".join(
                            "%s %d-%d" % (k, min(v), max(v))
                            for k, v in groups.items()),
                        "; ".join(o["items"]),
                        "".join("; seeded full superblock %s %.4f ms "
                                "(plain %.1f ms, bound %.4f ms)"
                                % (f["shape"], f["ms"], f["plain_ms"],
                                   f["bound_ms"])
                                for f in full.get(name, ()))))
    phase("tail", t0, "kernels equal to their plain versions (kernel and "
          "plain ms on the whole real items): %s" % " | ".join(notes))
    return recs


# ---------------------------------------------------------------
# the run expansion
# ---------------------------------------------------------------

# the bound on the kernel nodes of one superblock's _expand in a graph
EXPAND_NODES = 40
# seeded expansions: (order, packed runs, ramps, mono, class blocks, runs)
SEEDED_EXPAND = [
    (order, packed, ramps, mono, rows, nruns)
    for order in ("sorted", "shuffled", "dead")
    for packed in (False, True)
    for ramps in (None, "plain", "rqr")
    for mono in (False, True)
    for rows, nruns in ((((0, 2), (2, 3), (8, 1)), 160),)] + [
    ("sorted", False, "plain", False,
     ((0, 4), (1, 2), (2, 8), (4, 4), (8, 2), (18, 1)), 3000),
    ("shuffled", True, "rqr", False, ((1, 3), (4, 5)), 2000),
    ("sorted", True, "plain", True, ((0, 16),), 1200)]


def expand_pair(args):
    """expand_call (the kernel) against expand_plain on the card, each on
    its own copy of the slots: (mismatches, max abs difference) over the
    pass classes' params, the slot indices and the slots."""
    slots = args[7]
    res = []
    for fn in (EX.expand_call, EX.expand_plain):
        s = slots.clone()
        classes, slot_r = fn(*args[:7], s)
        res.append((classes, slot_r, s))
    (kc, ks, kslots), (pc, ps, pslots) = res
    check([(c, b0, p.shape) for c, _, p, b0 in kc]
          == [(c, b0, p.shape) for c, _, p, b0 in pc],
          "expand: the kernel's and the plain version's class blocks differ")
    return mismatches([(ks, ps), (kslots, pslots)]
                      + [(a[2], b[2]) for a, b in zip(kc, pc)])


def glue_expand(m, sig, v, slots):
    """The earlier path of _expand: the standalone decoders, the torch glue
    (expand_plain on the card), the oscillator, one index_add_ per class."""
    rows_sig, mono, dead, runs, ramps, tbases, ptabs, _ = \
        m._expand_args(sig, v, slots)
    if runs[0] == "rmq":
        runs = ("plain", PK.unpack_call("rmq", runs[1], runs[2]))
    if ramps is not None and ramps[0] == "rqr":
        ramps = ("plain", PK.unpack_call("rqr", ramps[1], ramps[2]))
    classes, slot_r = EX.expand_plain(rows_sig, mono, dead, runs, ramps,
                                      tbases, ptabs, slots)
    for cls, tb, par, b0 in classes:
        res = OK.osc_call(cls, tb, par, m._atlas_dev, quality=sig[10] & 15,
                          fused_pm=True, mono=mono)
        EX.add_rows(slots, slot_r[b0:b0 + par.shape[1]], res.t(), mono)


@contextlib.contextmanager
def index_adds():
    """The shapes of the tensors that ``index_add_`` is called on inside
    the block."""
    calls = []
    real = torch.Tensor.index_add_
    own = "index_add_" in vars(torch.Tensor)

    def spy(self, *args, **kw):
        calls.append(tuple(self.shape))
        return real(self, *args, **kw)
    torch.Tensor.index_add_ = spy
    try:
        yield calls
    finally:
        if own:
            torch.Tensor.index_add_ = real
        else:
            del torch.Tensor.index_add_


def real_expand(song):
    """The first superblock of `song` (stereo, 2752x64 frames) on a
    profiled card mixer: the kernel against expand_plain, the mixer's
    _expand against the earlier path, the kernel and plain times, the
    bound, and the kernel nodes of _expand and of the body in a graph
    beside the earlier path's.  Returns a dict."""
    m, prog, sig = real_format(song, SUPERBLOCK_FRAMES)
    sig, blob, _, _ = m._prepare(copy.deepcopy(prog))
    v = blob_views(torch.from_numpy(blob).to(DEVICE), blob_layout(sig)[0])
    nslot = sig[1] * sig[0] + 1
    zeros = torch.zeros((nslot, 2, OK.FRAG), dtype=torch.int32,
                        device=DEVICE)
    args = m._expand_args(sig, v, zeros)
    bad, err = expand_pair(args)
    check(bad == 0, "expand on the %s song's superblock: %d mismatches"
          % (song, bad))
    got, old = zeros.clone(), zeros.clone()
    with index_adds() as adds:
        m._expand(sig, v, got)
    check(not adds, "%s: _expand ran %d index_add_ (shapes %s)"
          % (song, len(adds), adds))
    glue_expand(m, sig, v, old)
    check(int((got != old).sum()) == 0 and int(got.abs().max()) > 0,
          "%s: _expand differs from the earlier path" % song)
    # times and graphs add into a scratch copy of the slots
    buf = zeros.clone()
    ms = graph_ms(lambda: EX.expand_call(*args[:7], buf))
    plain_ms = cuda_ms(lambda: EX.expand_plain(*args[:7], buf), reps=3,
                       warmup=1)
    rmq = sig[12]
    nbytes, nops = EX.work(prog.runmat, prog.rampmat if sig[8] else None,
                           sig[4], args[1], rmq and rmq[0],
                           rmq and rmq[1])
    bms, by = bound(nbytes, nops)
    nodes = {}
    for label, fn in (("expand", lambda: m._expand(sig, v, buf)),
                      ("expand_before", lambda: glue_expand(m, sig, v, buf))):
        nodes[label] = graph_nodes(fn)[0]
    check(nodes["expand"] <= EXPAND_NODES, "%s: one _expand makes %d "
          "kernel nodes (at most %d)" % (song, nodes["expand"],
                                         EXPAND_NODES))
    st = _StateSet(sig, DEVICE)
    master = torch.zeros((sig[0], sig[3], OK.FRAG), dtype=torch.int32,
                         device=DEVICE)
    nodes["body"] = graph_nodes(lambda: m._body(sig, v, st, master))[0]
    m._expand = lambda s_, v_, slots: glue_expand(m, s_, v_, slots)
    try:
        nodes["body_before"] = graph_nodes(
            lambda: m._body(sig, v, st, master))[0]
    finally:
        del m._expand
    return {"rows": sum(NB * OK.RPB for _, NB in sig[4]),
            "runs": int(prog.runmat.shape[0]),
            "ramp_runs": int(prog.rampmat.shape[0]) if sig[8] else 0,
            "format": "rmq" if rmq else "plain",
            "ramps": None if not sig[8] else "rqr" if rmq and rmq[1]
            else "plain",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "bytes": nbytes, "ops": nops,
            "max_abs_err": err, "nodes": nodes}


def phase_expand():
    """The expansion kernel against its plain version on seeded tables and
    on the songs' real superblocks; times, bound and graph nodes.
    Returns the kernel's JSON record (launches filled in by the effects
    phase)."""
    t0 = time.perf_counter()
    nvar = err = 0
    for i, (order, packed, ramps, mono, rows, nruns) in enumerate(
            SEEDED_EXPAND):
        args = EX.seeded_args(100 + i, order=order, packed=packed,
                              ramps=ramps, rows_sig=rows, nruns=nruns,
                              mono=mono, device=DEVICE)
        bad, e = expand_pair(args)
        check(bad == 0, "expand seeded (%s, packed %s, ramps %s, mono %s, "
              "classes %s): %d mismatches" % (order, packed, ramps, mono,
                                              rows, bad))
        nvar, err = nvar + 1, max(err, e)
    real = {song: real_expand(song) for song in ("slice", "effects")}
    err = max([err] + [r["max_abs_err"] for r in real.values()])
    phase("expand", t0, "%d seeded expansions equal to the plain version; "
          "%s" % (nvar, "; ".join(
              "%s superblock 0 (%d rows, %d runs, %d ramp runs, runs %s, "
              "ramps %s) == plain, _expand == the earlier path; kernel "
              "%.4f ms (bound %.4f ms, %s), plain %.3f ms; kernel nodes: "
              "_expand %d (earlier path %d), body %d (earlier path %d)"
              % (song, r["rows"], r["runs"], r["ramp_runs"], r["format"],
                 r["ramps"], r["ms"], r["bound_ms"], r["bound_by"],
                 r["plain_ms"], r["nodes"]["expand"],
                 r["nodes"]["expand_before"], r["nodes"]["body"],
                 r["nodes"]["body_before"]) for song, r in real.items())))
    main = real["slice"]
    return record("expand", "audiality2_tpu_torch/cuda/csrc/expand_kernel.cu",
                  "audiality2_tpu/tpu/superblock.py:1428", main["ms"],
                  main["plain_ms"], main["bytes"], main["ops"], err,
                  variants_checked=nvar, shape="slice superblock 0",
                  replaces_function="_expand_rows (up to its oscillator "
                  "calls), with _rmq_unpack (:2932) and _rqr_unpack (:2908)",
                  by_song=real)


# ---------------------------------------------------------------
# renders against native
# ---------------------------------------------------------------

def rms_db(mine, ref):
    """The RMS of mine - ref against the RMS of ref, in dB."""
    d = mine.astype(np.float64) - ref.astype(np.float64)
    r = np.sqrt((ref.astype(np.float64) ** 2).mean())
    return float(20 * np.log10(np.sqrt((d ** 2).mean()) / r + 1e-30))


def render_check(song, channels, seconds, label, need,
                 sb=SUPERBLOCK_FRAMES, max_db=None, same_as=None, **kw):
    """Renders `song` through the port in superblocks of `sb` frames and
    natively over the same superblocks; checks bit equality (or, with
    max_db, an RMS difference of at most max_db dB, and bit equality with
    the render `same_as` when given), no bridging, and a launch of each
    kernel in `need`.  kw go to the DeviceRenderer.
    Returns ({kernel: launches}, x realtime, timings, wall s, graph
    launches, dB against native)."""
    frames = int(seconds * SR)
    want = native_render(song, channels, frames, sb=sb)
    r = open_song(song, channels, DeviceRenderer, device=DEVICE, **kw)
    r.wait_device()
    zero_launches()
    t0 = time.perf_counter()
    out = r.render(frames, bufsize=sb)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    fell_back, bridged = r.fell_back, r.bridged_frames
    timings = dict(r.timings)
    replays = r.mixer.replays
    formats = mixer_formats(r.mixer)
    r.close()
    check_packed(label, [formats], launches, song == "effects")
    check(out.shape == (channels, frames) and out.dtype == np.int32,
          "%s: output shape %s" % (label, out.shape))
    check(np.abs(out).max() > 0, "%s: silent output" % label)
    check(not fell_back, "%s: bridged natively" % label)
    check(bridged == 0, "%s: %d frames bridged natively" % (label, bridged))
    for k in need:
        check(launches[k] > 0, "%s: the %s kernel never launched"
              % (label, k))
    db = rms_db(out, want)
    if max_db is None:
        bad = int((out != want).sum())
        check(bad == 0, "%s: %d samples differ from native" % (label, bad))
    else:
        check(db <= max_db, "%s: %.2f dB from native (limit %.1f dB)"
              % (label, db, max_db))
    if same_as is not None:
        bad = int((out != same_as).sum())
        check(bad == 0, "%s: %d samples differ from the same render "
              "through the plain versions on the CPU" % (label, bad))
    return launches, seconds / dt, timings, dt, replays, db


def split(tm):
    return ", ".join("%s %.4f" % kv for kv in tm.items())


def phase_slice():
    t0 = time.perf_counter()
    launches, xrt, tm, dt, _, _ = render_check(
        "slice", 2, 10.0, "slice stereo 10 s", PATH_KERNELS["slice"])
    mono, mono_xrt, _, _, _, _ = render_check(
        "slice", 1, 2.0, "slice mono 2 s", PATH_KERNELS["slice"])
    # the render adds the oscillator's rows into the slots in its kernel:
    # the rows epilogue (osc_call) is off the path
    for label, l in (("stereo", launches), ("mono", mono)):
        check(l["osc_rows"] == 0, "slice %s: %d osc_call launches on the "
              "render path" % (label, l["osc_rows"]))
    phase("slice", t0, "stereo 10 s == native, %.1f x realtime (%.3f s: "
          "%s), %d oscillator launches (slots epilogue, none of the rows "
          "epilogue); mono 2 s == native, %.1f x realtime, %d launches"
          % (xrt, dt, split(tm), launches["osc_slots"], mono_xrt,
             mono["osc_slots"]))
    return launches


def phase_effects():
    t0 = time.perf_counter()
    launches, xrt, tm, dt, _, _ = render_check(
        "effects", 2, 10.0, "effects stereo 10 s", PATH_KERNELS["effects"])
    phase("effects", t0, "stereo 10 s == native, %.1f x realtime (%.3f s: "
          "%s); launches %s" % (xrt, dt, split(tm), json.dumps(launches)))
    return launches


def phase_legacy():
    t0 = time.perf_counter()
    launches, xrt, tm, dt, _, _ = render_check(
        "late_fbdelay", 1, 1.4, "late fbdelay mono 1.4 s",
        ["fbdelay_legacy"])
    phase("legacy", t0, "mono 1.4 s == native, %.1f x realtime (%.3f s: "
          "%s); launches %s" % (xrt, dt, split(tm), json.dumps(launches)))
    return launches


# ---------------------------------------------------------------
# graphs: the capture probe, the pipelined render, serving
# ---------------------------------------------------------------

# each kernel's name in the profiler's device trace
KERNEL_NAMES = {"osc_slots": "osc_slots_kernel",
                "fbdelay_dense": "fbd_dense_kernel",
                "fbdelay_legacy": "fbd_legacy_kernel",
                "filter": "filter_kernel", "fm": "fm_kernel",
                "expand": "expand_kernel"}
# the kernels of each song's path (the effects song's profiled renders
# also run the packed format: render_check)
PATH_KERNELS = {"slice": ["osc_slots", "expand"],
                "effects": ["osc_slots", "fbdelay_dense", "filter", "fm",
                            "expand"],
                "late_fbdelay": ["fbdelay_legacy", "expand"]}


def capture_probe(rng):
    """One filter12 and one fm item: the launch made eagerly, and
    captured into a graph and replayed; returns the mismatches (of the
    replay, and of the capture, which must launch nothing)."""
    bad = 0
    sine = on(DEVICE, FM.sine_pairs())[0]
    items = []
    slots, arr, state = FL.seeded_item(rng, "f12", 2, 2, 24, 6, nslot=20)
    sig = (2, 2, True, (0, 1), (1, 0))
    items.append((slots, arr, state, FL.groups(arr, sig),
                  lambda s, a, st, b, sig=sig: FL.filter_call(
                      s, "f12", sig, a, st, b)))
    slots, arr, state = FM.seeded_item(rng, 514, 16, 5, nslot=20)
    sig = (514, False, 0)
    items.append((slots, arr, state, FM.groups(arr, sig),
                  lambda s, a, st, b, sig=sig: FM.fm_call(
                      s, sig, a, st, sine, b)))
    for slots, arr, state, bounds, call in items:
        b = torch.as_tensor(FL.pack_bounds(bounds, arr.shape[0]),
                            device=DEVICE)
        s_e, a, st_e = on(DEVICE, slots, arr, state)
        call(s_e, a, st_e, b)
        s_g, st_g = on(DEVICE, slots, state)
        g = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            g.capture_begin(capture_error_mode="relaxed")
            try:
                call(s_g, a, st_g, b)
            finally:
                g.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        # capturing launches nothing
        bad += mismatches([(s_g, on(DEVICE, slots)[0])])[0]
        g.replay()
        torch.cuda.synchronize()
        bad += mismatches([(s_e, s_g), (st_e, st_g)])[0]
    return bad


def phase_capture():
    """Whether a CUDA graph captures the kernels' cooperative launches
    (cudaLaunchCooperativeKernel, csrc/stage_common.cuh): a seeded
    filter12 and fm item captured, replayed and held against the same
    launch made eagerly."""
    t0 = time.perf_counter()
    bad = capture_probe(np.random.default_rng(11))
    check(bad == 0, "captured cooperative launches: %d mismatches against "
          "the eager launch" % bad)
    phase("capture", t0, "cudaLaunchCooperativeKernel (filter12, fm) "
          "captured into a CUDA graph; its replay equal to the eager "
          "launch")
    return "captured; replay equal to the eager launch"


def timed_render(song, channels, frames, pipelined, stage_mode="exact"):
    """One fresh render, device launches timed: (wall s, timings, device
    busy s, graph replays, captures)."""
    r = open_song(song, channels, DeviceRenderer, device=DEVICE,
                  chain_dispatch=4, stage_mode=stage_mode)
    r.wait_device()
    r.mixer.time_device = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if pipelined:
        out = r.render(frames, bufsize=SUPERBLOCK_FRAMES)
    else:
        out = np.concatenate(
            [r.run(SUPERBLOCK_FRAMES)
             for _ in range(-(-frames // SUPERBLOCK_FRAMES))],
            axis=1)[:, :frames]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy = r.mixer.device_seconds()
    check(not r.fell_back and r.bridged_frames == 0,
          "%s timing render bridged natively" % song)
    # a profiled (pipelined) effects render packs; `run` never profiles
    check(not pipelined or song != "effects"
          or mixer_formats(r.mixer)[0] is not None,
          "%s timing render: the packed format is off" % song)
    res = (wall, dict(r.timings), busy, r.mixer.replays, r.mixer.captures,
           r.mixer.capture_s, out)
    r.close()
    return res


def profiler_check():
    """torch.profiler over a pipelined render of the effects and late
    fbdelay songs: every kernel of their paths shows by name among the
    device kernels (graph replays included).  Returns {kernel: device
    ms}."""
    r1 = open_song("effects", 2, DeviceRenderer, device=DEVICE,
                   chain_dispatch=4)
    r2 = open_song("late_fbdelay", 1, DeviceRenderer, device=DEVICE,
                   chain_dispatch=4)
    r1.wait_device()
    torch.cuda.synchronize()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        r1.render(2 * SUPERBLOCK_FRAMES, bufsize=SUPERBLOCK_FRAMES)
        r2.render(int(1.4 * SR), bufsize=SUPERBLOCK_FRAMES)
        torch.cuda.synchronize()
    r1.close()
    r2.close()
    seen = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        for k, name in KERNEL_NAMES.items():
            if name in e.key:
                seen[k] = seen.get(k, 0.0) + us * 1e-3
    missing = [k for k in KERNEL_NAMES if k not in seen]
    check(not missing, "the profiler saw no %s kernel in the graph "
          "replays" % missing)
    return seen


def phase_pipeline():
    """The songs through render(chain_dispatch=4); the synchronous and
    the pipelined render timed in alternating pairs; the profiler check.
    Returns ({path: launches}, timing summary)."""
    t0 = time.perf_counter()
    paths = {}
    notes = []
    # the last: quarter superblocks, 12 of them, so that whole chains of
    # 4 run (the 10 s songs have 3 superblocks of 2752x64 frames)
    for song, ch, secs, sb in (
            ("slice", 2, 10.0, SUPERBLOCK_FRAMES),
            ("slice", 1, 2.0, SUPERBLOCK_FRAMES),
            ("effects", 2, 10.0, SUPERBLOCK_FRAMES),
            ("late_fbdelay", 1, 1.4, SUPERBLOCK_FRAMES),
            ("effects", 2, 10.0, SUPERBLOCK_FRAMES // 4)):
        label = "%s %s %.1f s chain 4%s" % (
            song, "stereo" if ch == 2 else "mono", secs,
            "" if sb == SUPERBLOCK_FRAMES else ", %d-frame superblocks" % sb)
        launches, xrt, tm, dt, replays, _ = render_check(
            song, ch, secs, label, PATH_KERNELS[song], sb=sb,
            chain_dispatch=4)
        if sb != SUPERBLOCK_FRAMES:
            nsb = -(-int(secs * SR) // sb)
            check(replays < nsb, "%s: %d graph launches for %d superblocks"
                  ": no chain ran" % (label, replays, nsb))
        paths[label] = launches
        notes.append("%s == native, %.1f x realtime, %d graph launches, "
                     "kernel launches %s" % (label, xrt, replays, json.dumps(
                         {k: v for k, v in launches.items() if v})))
    timing = {}
    for song in ("slice", "effects"):
        frames = int(10.0 * SR)
        want = native_render(song, 2, frames)
        runs = {"sync": [], "pipelined": []}
        for order in (("sync", "pipelined"), ("pipelined", "sync"),
                      ("sync", "pipelined")):
            for mode in order:
                wall, tm, busy, replays, caps, cap_s, out = timed_render(
                    song, 2, frames, mode == "pipelined")
                check(int((out != want).sum()) == 0,
                      "%s %s timing render differs from native"
                      % (song, mode))
                runs[mode].append({
                    "wall_s": wall, "x_realtime": 10.0 / wall,
                    "device_busy_s": busy, "idle_share": 1 - busy / wall,
                    "graph_launches": replays, "captures": caps,
                    "capture_s": cap_s, "phases_s": tm})
        timing[song] = runs
        for mode, rs in runs.items():
            notes.append("%s %s: x realtime %s, idle %s, captures %d (%.3f "
                         "s), phases of the first: %s" % (
                             song, mode, " ".join(
                                 "%.1f" % r["x_realtime"] for r in rs),
                             " ".join("%.3f" % r["idle_share"] for r in rs),
                             rs[0]["captures"], rs[0]["capture_s"],
                             split(rs[0]["phases_s"])))
    seen = profiler_check()
    notes.append("profiler, device ms by kernel: %s" % ", ".join(
        "%s %.3f" % kv for kv in seen.items()))
    phase("pipeline", t0, " | ".join(notes))
    return paths, timing


def phase_serve():
    """render_multiplexed of four streams (batch 2) and of two effects
    streams (a fleet whose finalized format packs), and render_many of
    two, each stream against its solo native render."""
    t0 = time.perf_counter()
    frames = int(10.0 * SR)
    notes = []
    results = {}
    for mode, specs, need in (
            ("multiplexed", [("slice", ()), ("slice", ()),
                             ("effects", ()), ("effects", (0.25,))], False),
            ("multiplexed effects", [("effects", ()), ("effects", (0.25,))],
             True),
            ("many", [("slice", ()), ("effects", (0.25,))], True)):
        jobs = []
        for song, args in specs:
            src, program = SONGS[song]
            i = a2.open_engine(SR, 4096, 2, batched=False)
            jobs.append(serve.StreamJob(
                i, i.get(i.load_string(src, song), program), frames,
                args=args, channels=2))
        zero_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if mode.startswith("multiplexed"):
            serve.render_multiplexed(jobs, bufsize=SUPERBLOCK_FRAMES,
                                     batch=2)
        else:
            serve.render_many(jobs, bufsize=SUPERBLOCK_FRAMES)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        launches = read_launches()
        for k in PATH_KERNELS["effects"]:
            check(launches[k] > 0, "serve %s: the %s kernel never "
                  "launched" % (mode, k))
        mixers = {id(j.renderer.mixer): j.renderer.mixer for j in jobs}
        check_packed("serve " + mode, [mixer_formats(m)
                                       for m in mixers.values()],
                     launches, need)
        for j, (song, args) in zip(jobs, specs):
            check(j.error is None and not j.renderer.fell_back,
                  "serve %s: %s %s bridged natively" % (mode, song, args))
            bad = int((j.output != native_render(song, 2, frames,
                                                  args)).sum())
            check(bad == 0, "serve %s: %s %s: %d samples differ from its "
                  "solo native render" % (mode, song, args, bad))
        agg = len(jobs) * 10.0 / dt
        results[mode] = {"streams": len(jobs), "wall_s": dt,
                         "aggregate_x_realtime": agg, "launches": launches}
        notes.append("%s: %d streams x 10 s stereo == solo native, %.3f s "
                     "= %.1f x realtime aggregate; launches %s"
                     % (mode, len(jobs), dt, agg, json.dumps(
                         {k: v for k, v in launches.items() if v})))
    phase("serve", t0, " | ".join(notes))
    return results


# ---------------------------------------------------------------
# the float stage tier, the CLI
# ---------------------------------------------------------------

# dB limits of float-tier renders against native where the JAX package's
# own float tier misses its -80 dB budget (its renders on the CPU, in the
# same superblocks): the effects song, 10 s, -66.66 dB (seconds 6-9 near
# -44 dB); the damped song, 1.8 s, -74.4 dB.  The port tracks JAX's
# float tier to within -90 dB on both.  What holds the card's float
# renders is bit equality with the same render through the plain
# versions on the CPU (plain_float_render); the dB are reported.
FLOAT_DB = {"effects": -65.0, "damped": -70.0}


def plain_float_render(song, channels, frames):
    """`song` through DeviceRenderer(device="cpu", stage_mode="float"):
    every kernel's plain version, in the superblocks of the card's
    renders."""
    r = open_song(song, channels, DeviceRenderer, device="cpu",
                  stage_mode="float")
    out = r.render(frames, bufsize=SUPERBLOCK_FRAMES)
    r.close()
    return out


def float_pair(kind, sig, slots, arr, state):
    """filter_float_call against filter_float_torch on the card, each on
    its own copy of the inputs: (the kernel's slots, mismatches, max abs
    difference)."""
    s1, st1 = slots.clone(), state.clone()
    s2, st2 = slots.clone(), state.clone()
    FF.filter_float_call(s1, kind, sig, arr, st1)
    FF.filter_float_torch(s2, kind, sig, arr, st2)
    bad, err = mismatches([(s1, s2), (st1, st2)])
    return s1, bad, err


def seeded_float(rng):
    """Every seeded float-tier variant, kernel against plain version on
    the card; returns (variants, max abs err, notes).  The launch plans
    of the variants must keep the tile buffers in shared memory with one
    tile per block, and with several, and in device memory."""
    cases = [(kind, ni, no, add, layout, 40, 5, None, False)
             for kind, (ni, no), add, layout in itertools.product(
                 FL.KINDS, ((1, 1), (2, 2), (1, 2), (2, 1)), (True, False),
                 ("shared", "free"))]
    # both outputs on one slot channel: the second channel's old values
    # are read after the first channel's adds (a delta pass of its own)
    cases += [(kind, 2, 2, False, "shared", 40, 5, (0, 0), False)
              for kind in FL.KINDS]
    # a full superblock's limiter (2,797 slices: 88 tiles of 2,048
    # samples), stereo and stereo-in / mono-out
    cases += [("lim", 2, 2, False, "split", 2797, 1, None, False),
              ("lim", 2, 1, True, "split", 2797, 1, None, False)]
    # filter12 outputs past the int32 range: the emit saturates
    cases += [("f12", ni, ni, False, "free", 40, 5, None, True)
              for ni in (1, 2)]
    # the one-launch design's edges: a single chain of 88 tiles (the
    # last tile applies 87 roots); more tiles than the card holds at
    # once (K 512 and 1024 stereo: a block loops over its tiles, their
    # buffers in shared memory or in device memory); ragged last tiles
    # (10,688 samples: 5 tiles and 448 samples); REPLACE with both
    # outputs on one slot channel at those sizes (two more barriers)
    cases += [("f12", 1, 1, False, "split", 2797, 1, None, False),
              ("dcb", 1, 2, True, "split", 2797, 1, None, False),
              ("f12", 2, 2, False, "free", 40, 512, None, False),
              ("dcb", 2, 1, True, "free", 40, 512, None, False),
              ("lim", 2, 2, True, "free", 40, 512, None, False),
              ("lim", 2, 1, False, "free", 40, 1024, None, False),
              ("f12", 2, 2, False, "split", 167, 7, None, False),
              ("dcb", 1, 2, False, "free", 167, 7, None, False),
              ("lim", 1, 2, False, "split", 167, 7, None, False),
              ("f12", 2, 2, False, "free", 40, 512, (0, 0), False),
              ("f12", 1, 2, False, "free", 167, 7, (0, 0), False),
              ("lim", 2, 2, False, "split", 2797, 1, (0, 0), False)]
    # where the tiles outgrow one tile per resident block but not shared
    # memory: the smallest such K on this card (a limiter, 2 tiles per
    # instance)
    for K in range(520, 1400, 40):
        pl = FF.plan("lim", (2, 2, True), 40, K, torch.device(DEVICE))
        if pl["shared"] and pl["tiles_per_block"] > 1:
            cases.append(("lim", 2, 2, True, "free", 40, K, None, False))
            break
    err = 0
    saturated = 0
    modes = set()
    for kind, ni, no, add, layout, S, K, dch, hot in cases:
        slots, arr, state = FF.seeded_item(rng, kind, ni, no, S, K,
                                           2 * K + 8, layout, hot)
        sig = (ni, no, add, (0, 1) if ni == 2 else (1,),
               dch or ((1, 0) if no == 2 else (0,)))
        got, bad, e = float_pair(kind, sig, *on(DEVICE, slots, arr, state))
        pl = FF.plan(kind, sig, S, K, torch.device(DEVICE))
        check(bad == 0, "filter_float %s %d->%d add %s %s S %d K %d dch %s "
              "hot %s (plan %s): %d mismatches"
              % (kind, ni, no, add, layout, S, K, sig[4], hot,
                 json.dumps(pl), bad))
        modes.add("shared x%d" % pl["tiles_per_block"] if pl["shared"]
                  else "device memory x%d" % pl["tiles_per_block"])
        if hot:
            n = int(((got == (1 << 31) - 1) | (got == -(1 << 31))).sum())
            check(n > 0, "the hot filter12 item saturated nothing")
            saturated += n
        err = max(err, e)
    check("shared x1" in modes and any(
        m.startswith("shared x") and m != "shared x1" for m in modes)
        and any(m.startswith("device memory") for m in modes),
        "the seeded float variants miss a buffer placement: %s"
        % sorted(modes))
    return len(cases), err, "%d saturated outputs; tile buffers %s" % (
        saturated, ", ".join(sorted(modes)))


def graph_nodes(fn):
    """The nodes of a CUDA graph that captures one call of fn(): (kernel
    nodes, all nodes), read with libcuda's cuGraphGetNodes and
    cuGraphNodeGetType (a kernel node's type is 0)."""
    g = torch.cuda.CUDAGraph(keep_graph=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with build.captured_launches(), torch.cuda.stream(side):
        g.capture_begin(capture_error_mode="relaxed")
        try:
            fn()
        finally:
            g.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    graph = g.raw_cuda_graph()
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    kinds = []
    for node in nodes:
        t = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(node, ctypes.byref(t)) == 0,
              "cuGraphNodeGetType failed")
        kinds.append(t.value)
    return kinds.count(0), len(kinds)


def real_float(rng):
    """The effects song's first superblock's limiter, filter12 and
    dcblock items through the float tier: kernel against plain version,
    kernel ms beside the exact tier's kernel on the same item and the
    bound.  Returns {kind: dict}."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(int(rng.integers(1 << 30)))
    prog, _, _ = first_program("effects", 2)
    slots0 = seeded_i32(gen, (prog.ninst * prog.F + 1, 2, FB.FRAG))
    out = {}
    for fl in prog.filters:
        kind, key = fl["kind"], fl["key"]
        if kind == "fm":
            continue
        S, K = fl["arr"].shape[:2]
        sig = key[3:8]
        arr = on(DEVICE, fl["arr"])[0]

        def make(kind=kind, K=K, arr=arr):
            return (slots0.clone(), arr, FL.init_state(kind, K, DEVICE))

        ms, pms, bad, err = time_pair(
            lambda s, a, st, kind=kind, sig=sig:
                (s, FF.filter_float_call(s, kind, sig, a, st)),
            lambda s, a, st, kind=kind, sig=sig:
                (s, FF.filter_float_torch(s, kind, sig, a, st)), make)
        check(bad == 0, "filter_float kernel != plain on the real %s item: "
              "%d mismatches" % (kind, bad))
        b = device_groups(FL, fl, sig)
        s, a, st = make()
        exact_ms = graph_ms(lambda: FL.filter_call(s, kind, sig, a, st, b))
        nk, nn = graph_nodes(
            lambda: FF.filter_float_call(s, kind, sig, a, st))
        check(nk == nn == 1, "filter_float: one call on the real %s item "
              "makes %d kernel nodes of %d graph nodes" % (kind, nk, nn))
        nbytes, nops = FF.work(fl["arr"], kind, *sig[:3])
        bms, by = bound(nbytes, nops, FP32_OPS_S)
        out[kind] = {"shape": "S%d K%d" % (S, K), "ms": ms,
                     "launches_per_item": nk,
                     "plan": FF.plan(kind, sig, S, K, torch.device(DEVICE)),
                     "exact_ms": exact_ms, "plain_ms": pms,
                     "bound_ms": bms, "bound_by": by, "bytes": nbytes,
                     "ops": nops, "max_abs_err": err,
                     "eligible": fl.get("minq", 1 << 30)
                     >= _FLOAT_TIER_MINQ}
    check(set(out) == set(FL.KINDS), "the effects song's first superblock "
          "lacks a filter kind: %s" % sorted(out))
    return out


def phase_float():
    """The float tier: kernels against the plain version, the real items
    timed beside the exact kernel, float renders against the plain
    versions on the CPU and native, and the effects song exact against
    float in alternating pairs.  Returns
    (the kernel's JSON record, {render: launches}, timing)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(13)
    nvar, serr, snote = seeded_float(rng)
    real = real_float(rng)
    notes = ["%d seeded variants equal to the plain version (%s)"
             % (nvar, snote)]
    notes.append("real items: " + "; ".join(
        "%s %s %.4f ms in %d launch (%d blocks x %d tiles; exact kernel "
        "%.4f ms, plain %.1f ms, bound %.4f ms)"
        % (k, v["shape"], v["ms"], v["launches_per_item"],
           v["plan"]["blocks"], v["plan"]["tiles_per_block"], v["exact_ms"],
           v["plain_ms"], v["bound_ms"]) for k, v in real.items()))
    paths = {}
    plain = {}
    # (song, channels, seconds, dB limit against native or None for bit
    # equality, float kinds that must launch, kinds that must not)
    for song, ch, secs, max_db, need, never in (
            ("float", 2, 2.0, -80.0, ("lim", "dcb"), ("f12",)),
            ("damped", 2, 2.0, FLOAT_DB["damped"], FL.KINDS, ()),
            ("effects", 2, 10.0, FLOAT_DB["effects"], ("lim", "dcb"),
             ("f12",)),
            ("reso", 1, 1.2, None, (), FL.KINDS)):
        label = "%s %s %.1f s float" % (song, "stereo" if ch == 2
                                        else "mono", secs)
        if max_db is not None:
            t1 = time.perf_counter()
            plain[song] = plain_float_render(song, ch, int(secs * SR))
            plain_s = time.perf_counter() - t1
        launches, xrt, tm, dt, replays, db = render_check(
            song, ch, secs, label, ("expand",),
            max_db=max_db, stage_mode="float",
            chain_dispatch=4, same_as=plain.get(song))
        for k in need:
            check(launches["filter_float_" + k] > 0, "%s: the float %s "
                  "kernels never launched" % (label, k))
        for k in never:
            check(launches["filter_float_" + k] == 0, "%s: %s ran in the "
                  "float tier under the eligibility threshold" % (label, k))
        if never:
            check(launches["filter"] > 0, "%s: no exact filter kernel "
                  "launched" % label)
        paths[label] = launches
        notes.append("%s %s, %.2f dB from native%s, %.1f x realtime, "
                     "launches %s" % (
                         label, "== native" if max_db is None else
                         "== plain versions on the CPU (%.1f s)" % plain_s,
                         db, "" if max_db is None else
                         " (limit %.1f)" % max_db, xrt, json.dumps(
                             {k: v for k, v in launches.items() if v})))
    frames = int(10.0 * SR)
    want = native_render("effects", 2, frames)
    runs = {"exact": [], "float": []}
    for order in (("exact", "float"), ("float", "exact"),
                  ("exact", "float")):
        for mode in order:
            wall, tm, busy, replays, caps, cap_s, out = timed_render(
                "effects", 2, frames, True, stage_mode=mode)
            db = rms_db(out, want)
            ref = plain["effects"] if mode == "float" else want
            check(int((out != ref).sum()) == 0, "effects %s timing render "
                  "differs from %s (%.2f dB from native)"
                  % (mode, "the plain versions" if mode == "float"
                     else "native", db))
            runs[mode].append({"wall_s": wall, "x_realtime": 10.0 / wall,
                               "device_busy_s": busy,
                               "idle_share": 1 - busy / wall,
                               "db_vs_native": db, "phases_s": tm})
    for mode, rs in runs.items():
        notes.append("effects pipelined %s: x realtime %s, idle %s"
                     % (mode, " ".join("%.1f" % r["x_realtime"] for r in rs),
                        " ".join("%.3f" % r["idle_share"] for r in rs)))
    phase("float", t0, " | ".join(notes))
    rec = record(
        "filter_float", "audiality2_tpu_torch/cuda/csrc/"
        "filter_float_kernel.cu", "audiality2_tpu/tpu/superblock.py:2374",
        sum(v["ms"] for v in real.values()),
        sum(v["plain_ms"] for v in real.values()),
        sum(v["bytes"] for v in real.values()),
        sum(v["ops"] for v in real.values()),
        max([serr] + [v["max_abs_err"] for v in real.values()]),
        ops_s=FP32_OPS_S, variants_checked=nvar,
        replaces_function="_apply_filter_float",
        kinds={k: {x: v[x] for x in ("shape", "ms", "exact_ms", "plain_ms",
                                     "bound_ms", "bound_by", "eligible",
                                     "launches_per_item", "plan")}
               for k, v in real.items()},
        launches_by_path={p: l["filter_float"] for p, l in paths.items()})
    return rec, paths, runs


def phase_cli():
    """The CLI's render of the effects song to a WAV on the card, by
    default and with --gpu, against clip(native >> 8)."""
    t0 = time.perf_counter()
    frames = int(10.0 * SR)
    want = native_render("effects", 2, frames)
    tmp = tempfile.mkdtemp()
    try:
        path = os.path.join(tmp, "effects.a2s")
        wav = os.path.join(tmp, "effects.wav")
        with open(path, "w") as f:
            f.write(SONGS["effects"][0])
        exp = np.clip(want.T.reshape(-1) >> 8, -32768, 32767) \
            .astype("<i2")
        res = {}
        for switches in ([], ["--gpu"]):
            label = " ".join(["a2play-gpu"] + switches)
            out = io.StringIO()
            zero_launches()
            with contextlib.redirect_stdout(out), formats_seen() as fmts:
                rc = cli.main(switches + ["-c", "2", "-st", "10", "-o", wav,
                                          path])
            launches = read_launches()
            check_packed(label, [fmts], launches, True)
            check(rc == 0, "%s: exit code %d:\n%s"
                  % (label, rc, out.getvalue()))
            with open(wav, "rb") as f:
                pcm = np.frombuffer(f.read()[44:], "<i2")
            check(pcm.shape == exp.shape, "%s: %d PCM samples, want %d"
                  % (label, pcm.size, exp.size))
            bad = int((pcm != exp).sum())
            check(bad == 0, "%s: %d PCM samples differ from clip(native "
                  ">> 8)" % (label, bad))
            for k in PATH_KERNELS["effects"]:
                check(launches[k] > 0, "%s: the %s kernel never launched"
                      % (label, k))
            m = re.search(r"\(([0-9.]+)x realtime\)", out.getvalue())
            check(m is not None, "%s: no x realtime in its output:\n%s"
                  % (label, out.getvalue()))
            res[label] = {"x_realtime": float(m.group(1)),
                          "launches": launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase("cli", t0, " | ".join(
        "%s -c 2 -st 10 -o: WAV == clip(native >> 8) (%d samples), %.1f x "
        "realtime; launches %s" % (label, exp.size, r["x_realtime"],
                                   json.dumps({k: v for k, v in
                                               r["launches"].items() if v}))
        for label, r in res.items()))
    return res


# ---------------------------------------------------------------
# the packed dispatch format, the host engine's device mixer and row
# batch
# ---------------------------------------------------------------

def decode_pair(kind, pk, tabs):
    """The decoder kernel against its plain version on the card, on the
    numpy pack and tables: (the kernel's output, mismatches, max abs
    difference)."""
    pk_d = torch.from_numpy(np.ascontiguousarray(pk)).to(DEVICE)
    tabs_d = [torch.from_numpy(t).to(DEVICE) for t in tabs]
    got = PK.unpack_call(kind, pk_d, tabs_d)
    want = PK._PLAIN[kind](pk_d, tabs_d)
    bad, err = mismatches([(got, want)])
    return got.cpu().numpy(), bad, err


def host_ms(fn, reps):
    """The median host ms of reps calls of fn()."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def real_format(song, frames):
    """The first stereo superblock of `frames` frames of `song` on a
    profiled card mixer (observed, so that its signature decides the
    format): (mixer, padded program, signature)."""
    r = open_song(song, 2, DeviceRenderer, device=DEVICE)
    prog = r.record_program(frames)
    r.close()
    m = r.mixer
    m.observe(prog)
    return m, prog, m._signature(prog)


def time_decoder(kind, pk, tabs):
    """(kernel ms, plain ms, bytes, ops) of one decode at this shape."""
    pk_d = torch.from_numpy(np.ascontiguousarray(pk)).to(DEVICE)
    tabs_d = [torch.from_numpy(t).to(DEVICE) for t in tabs]
    ms = graph_ms(lambda: PK.unpack_call(kind, pk_d, tabs_d))
    plain_ms = cuda_ms(lambda: PK._PLAIN[kind](pk_d, tabs_d), reps=5)
    nbytes, nops = PK.work(kind, pk.shape[1], [len(t) for t in tabs])
    return ms, plain_ms, nbytes, nops


def rqr_through_mixer():
    """The rampmat half of the format through the mixer: the slice song's
    first two superblocks of 172 fragments (where the runmat packs) with
    each ramp run's PTGT set to its PV
    (the format's invariant, which the native record does not keep: its
    ramp runs end fragment 0 inside a pitch ramp, so profiled renders
    ship the rampmat unpacked), on a card mixer (a captured graph) and
    on a CPU mixer: the masters bit-equal, the expansion kernel decoding
    both packed tables.  Returns the launches."""
    r = open_song("slice", 2, DeviceRenderer, device=DEVICE)
    progs = [r.record_program(SUPERBLOCK_FRAMES // 16) for _ in range(2)]
    r.close()
    for p in progs:
        p.rampmat[:, RR_PTGT] = p.rampmat[:, RR_PV]
    outs = {}
    launches = None
    for dev in (DEVICE, "cpu"):
        m = TorchMixer(r.mixer.core, device=dev)
        cp = copy.deepcopy(progs)
        for p in cp:
            m.observe(p)
        if dev == DEVICE:
            m.precompile(cp[0])
            zero_launches()
        outs[dev] = [np.stack(m.run(p)) for p in cp]
        if dev == DEVICE:
            torch.cuda.synchronize()
            launches = read_launches()
        check(all(f is not None and f[1] is not None
                  for f in mixer_formats(m)),
              "rqr through the mixer: the rampmat did not pack (%s)"
              % mixer_formats(m))
    bad = sum(int((a != b).sum()) for a, b in zip(outs[DEVICE],
                                                  outs["cpu"]))
    check(bad == 0, "rqr through the mixer: %d samples differ between the "
          "card and the CPU" % bad)
    check(launches["expand_rqr"] > 0 and launches["expand_rmq"] > 0
          and launches["unpack"] == 0,
          "rqr through the mixer: launches %s" % launches)
    return launches


def phase_packed():
    """The decoders against their plain versions (seeded packs, the slice
    and effects songs' first superblocks), pack -> kernel unpack equal
    to the padded tables, decoder times beside their bounds, the blob
    bytes packed and unpacked and the host time of packing, and the
    rampmat half through the mixer.  Returns the kernel's JSON record
    (launches filled in from the slice phase)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(17)
    nvar = err = 0
    for kind in PK.KINDS:
        ntab = PK.KINDS[kind][1]
        for n, sizes in ((1000, None), (1000, [1] * ntab), (77, None),
                         (50000, None), (50000, [65535] * ntab)):
            pk, tabs = PK.seeded_format(rng, kind, n, sizes)
            _, bad, e = decode_pair(kind, pk, tabs)
            check(bad == 0, "unpack %s seeded n %d: %d mismatches"
                  % (kind, n, bad))
            nvar, err = nvar + 1, max(err, e)
    notes = ["%d seeded packs equal to the plain version" % nvar]
    kinds = {}
    real = {}
    # the effects song packs at the main path's superblock; the slice
    # song's sustained notes (runs of up to 553 fragments) break the LEN
    # field there, and its tables pack at superblocks of 172 fragments
    for song, frames, need in (("effects", SUPERBLOCK_FRAMES, True),
                               ("slice", SUPERBLOCK_FRAMES, False),
                               ("slice", SUPERBLOCK_FRAMES // 16, True)):
        label = "%s %d-frame superblock 0" % (song, frames)
        m, prog, sig = real_format(song, frames)
        nb_plain = blob_layout(sig[:12] + (None,))[1] * 4
        info = {"runs": int(prog.runmat.shape[0]),
                "max_run_fragments": int(prog.runmat[:, RC_LEN].max()),
                "format": sig[12], "blob_bytes_unpacked": nb_plain}
        real[label] = info
        check(sig[12] is not None or not need, "%s: the profiled mixer "
              "did not pack" % label)
        if sig[12] is None:
            notes.append("%s: %d runs of up to %d fragments, format off "
                         "(LEN field), blob %d B unpacked"
                         % (label, info["runs"], info["max_run_fragments"],
                            nb_plain))
            continue
        tabs = m._rmq["tables"]
        pk = PK._rmq_pack(prog.runmat, tabs)
        got, bad, e = decode_pair("rmq", pk, tabs)
        check(bad == 0, "unpack rmq on the %s: %d mismatches"
              % (label, bad))
        check(np.array_equal(got, prog.runmat), "%s: pack -> kernel "
              "unpack differs from the padded runmat" % label)
        err = max(err, e)
        rmp = prog.rampmat
        ne = 0
        if rmp is not None and rmp.shape[0]:
            rtabs = EX.own_tables(rmp, PK._RQR_IDXCOLS)
            rpk = PK._rqr_pack(rmp, rtabs)
            got, bad, e = decode_pair("rqr", rpk, rtabs)
            want = rmp.copy()
            want[:, RR_PTGT] = want[:, RR_PV]
            check(bad == 0 and np.array_equal(got, want),
                  "unpack rqr on the %s: %d mismatches against the plain "
                  "version, or not the padded rampmat" % (label, bad))
            err = max(err, e)
            ne = int((rmp[:, RR_PV] != rmp[:, RR_PTGT]).sum())
        nb_packed = blob_layout(sig)[1] * 4
        pack_ms = host_ms(lambda: PK._rmq_pack(prog.runmat, tabs), 20)
        prep_ms = host_ms(lambda: m._prepare(copy.deepcopy(prog)), 5)
        info.update({
            "ramp_runs": int(rmp.shape[0]) if rmp is not None else 0,
            "ramp_runs_ptgt_ne_pv": ne,
            "blob_bytes_packed": nb_packed,
            "pack_host_ms": pack_ms, "prepare_host_ms": prep_ms})
        for kind, kpk, ktabs, shape in (
                ("rmq", pk, tabs, "%d runs" % pk.shape[1]),
                ("rqr", rpk, rtabs, "%d ramp runs" % rpk.shape[1])):
            ms, plain_ms, nbytes, nops = time_decoder(kind, kpk, ktabs)
            bms, by = bound(nbytes, nops)
            kinds.setdefault(kind, {})[label] = {
                "shape": shape, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bms, "bound_by": by, "bytes": nbytes,
                "ops": nops}
        notes.append(
            "%s: %d runs (%d ramp runs, %d with PTGT != PV), pack -> "
            "kernel unpack == the padded tables; blob %d B packed / %d B "
            "unpacked; host pack %.3f ms of a %.3f ms _prepare; decoders "
            "%s" % (label, info["runs"], info["ramp_runs"], ne, nb_packed,
                    nb_plain, pack_ms, prep_ms, "; ".join(
                        "%s %s %.4f ms (plain %.3f ms, bound %.4f ms)"
                        % (k, v[label]["shape"], v[label]["ms"],
                           v[label]["plain_ms"], v[label]["bound_ms"])
                        for k, v in kinds.items())))
    rqr_launches = rqr_through_mixer()
    notes.append("rampmat packed through the mixer (PTGT := PV): card == "
                 "CPU, expansion launches decoding rmq %d rqr %d"
                 % (rqr_launches["expand_rmq"], rqr_launches["expand_rqr"]))
    phase("packed", t0, " | ".join(notes))
    # the main path's shape: the effects song's superblock
    main = "effects %d-frame superblock 0" % SUPERBLOCK_FRAMES
    k = kinds["rmq"][main]
    return record("unpack", "audiality2_tpu_torch/cuda/csrc/unpack_kernel.cu",
                  "audiality2_tpu/tpu/superblock.py:2932", k["ms"],
                  k["plain_ms"], k["bytes"], k["ops"], err,
                  variants_checked=nvar, shape=main,
                  kinds={x: dict(v[main], replaces="audiality2_tpu/tpu/"
                                 "superblock.py:%d" % (2932 if x == "rmq"
                                                       else 2908))
                         for x, v in kinds.items()},
                  by_shape=kinds, real=real,
                  rqr_through_mixer={x: rqr_launches["expand_" + x]
                                     for x in PK.KINDS})


def host_render(song, channels, frames, bufsize, **config):
    """`song` through the host engine (``open_engine(..., **config)``) in
    buffers of `bufsize` frames: (channels, frames) int32, its core."""
    src, program = SONGS[song]
    i = a2.open_engine(SR, bufsize, channels, **config)
    s = i.get(i.load_string(src, song), program)
    out = []
    i.sink_callback(lambda bufs, n: out.append(
        np.stack([np.array(bufs[c][:n]) for c in range(channels)])))
    i.timestamp_reset()
    i.starta(i.root_voice(), s, [])
    for _ in range(-(-frames // bufsize)):
        i.run(bufsize)
    return np.concatenate(out, axis=1)[:, :frames], i.state.core


def phase_device_mix():
    """The host engine's device mixer (device_mix=True) on the card:
    the slice song through TorchMixer equal to host replay (rows in
    numpy) and to native; the effects song falls back to host replay.
    Returns the slice render's launches."""
    t0 = time.perf_counter()
    frames = int(2.0 * SR)
    bufsize = 4096
    notes = []
    res = {}
    for song in ("slice", "effects"):
        want = native_render(song, 2, frames, sb=bufsize)
        host, _ = host_render(song, 2, frames, bufsize, use_jax=False)
        check(int((host != want).sum()) == 0, "%s: host replay differs "
              "from native" % song)
        zero_launches()
        t1 = time.perf_counter()
        got, core = host_render(song, 2, frames, bufsize, device_mix=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        launches = read_launches()
        bad = int((got != host).sum())
        check(bad == 0, "%s device_mix: %d samples differ from host replay"
              % (song, bad))
        dm = core.device_mixer
        if song == "slice":
            check(dm is not None and dm.device.type == "cuda",
                  "slice device_mix: no mixer on the card")
            check(launches["osc_slots"] > 0, "slice device_mix: the "
                  "oscillator kernel never launched")
            res[song] = launches
        else:
            check(dm is None and not core._device_committed,
                  "effects device_mix did not fall back to host replay")
        notes.append("%s stereo 2 s device_mix == host replay == native, "
                     "%s, %.1f x realtime; launches %s" % (
                         song, "mixer on %s (%d graph launches, %d "
                         "captures)" % (dm.device, dm.replays, dm.captures)
                         if dm is not None else "host replay (fell back)",
                         2.0 / dt, json.dumps(
                             {k: v for k, v in launches.items() if v})))
    phase("device_mix", t0, " | ".join(notes))
    return res["slice"]


def phase_rows():
    """The row kernel against its plain version (seeded rows, and the
    slice song's real batches), timed at the real shape; the batched
    host engine (use_jax=True) with superblocks of at least JAX_MIN_ROWS
    rows equal to its numpy rows and to native.  Returns (the kernel's
    JSON record, the engine render's launches)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(19)
    nvar = err = 0
    for n in (1, 64, 1000, 16384):
        atlas, p = CR.seeded_rows(rng, n)
        a_d, p_d = on(DEVICE, atlas, p)
        bad, e = mismatches([(CR.rows_call(a_d, p_d),
                              CR.rows_plain(a_d, p_d))])
        check(bad == 0, "rows kernel != plain on %d seeded rows: %d "
              "mismatches" % (n, bad))
        nvar, err = nvar + 1, max(err, e)
    bufsize = 16384
    frames = 6 * bufsize
    want = native_render("slice", 2, frames, sb=bufsize)
    host, _ = host_render("slice", 2, frames, bufsize, use_jax=False)
    check(int((host != want).sum()) == 0, "rows: the host engine's numpy "
          "rows differ from native")
    # the batches the engine sends to the card, kept for the kernel check
    batches = []
    real_cuda = TRK.rows_cuda

    def keep(atlas_obj, *args, **kw):
        batches.append((atlas_obj.data.copy(), [np.array(a) for a in args]))
        return real_cuda(atlas_obj, *args, **kw)
    TRK.rows_cuda = keep
    zero_launches()
    try:
        t1 = time.perf_counter()
        got, _ = host_render("slice", 2, frames, bufsize, use_jax=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
    finally:
        TRK.rows_cuda = real_cuda
    launches = read_launches()
    check(launches["rows"] > 0 and launches["rows"] == len(batches),
          "rows: %d kernel launches for %d device batches"
          % (launches["rows"], len(batches)))
    bad = int((got != host).sum())
    check(bad == 0, "rows: the engine's device rows give %d samples "
          "differing from its numpy rows" % bad)
    big = max(batches, key=lambda b: len(b[1][0]))
    for atlas, args in batches:
        a_d, p_d = on(DEVICE, atlas, np.stack(
            [np.asarray(a, np.int64) for a in args]))
        bad, e = mismatches([(CR.rows_call(a_d, p_d),
                              CR.rows_plain(a_d, p_d))])
        check(bad == 0, "rows kernel != plain on a real batch of %d rows: "
              "%d mismatches" % (p_d.shape[1], bad))
        err = max(err, e)
    atlas, args = big
    a_d, p_d = on(DEVICE, atlas, np.stack([np.asarray(a, np.int64)
                                           for a in args]))
    N = p_d.shape[1]
    ms = graph_ms(lambda: CR.rows_call(a_d, p_d))
    plain_ms = cuda_ms(lambda: CR.rows_plain(a_d, p_d), reps=3, warmup=1)
    nbytes, nops = CR.work(N, atlas.shape[0])
    phase("rows", t0, "%d seeded row sets and %d real batches equal to the "
          "plain version; kernel %.4f ms, plain %.3f ms at %d rows (atlas "
          "%d values); host engine slice stereo %d x %d frames with device "
          "rows == numpy rows == native, %.1f x realtime, %d rows launches"
          % (nvar, len(batches), ms, plain_ms, N, atlas.shape[0], 6,
             bufsize, frames / SR / dt, launches["rows"]))
    rec = record("rows", "audiality2_tpu_torch/cuda/csrc/rows_kernel.cu",
                 "audiality2_tpu/tpu/row_kernel.py:146", ms, plain_ms,
                 nbytes, nops, err, rows=N, variants_checked=nvar,
                 replaces_function="rows_jax",
                 batch_rows=[len(b[1][0]) for b in batches])
    return rec, launches


# ---------------------------------------------------------------
# the oscillator's general entry point (OscBatch)
# ---------------------------------------------------------------

# the JAX package's kernel-ceiling batch (bench.py bench_osc_kernel)
OSC_BATCH_ROWS = 16384
OSC_WAVES = ("saw", "triangle", "sine", "square", "pulse10")


def osc_batches(pa, waves):
    """(label, batch, rows as (tbase, npass, pos_off, ph0, dph, amp0,
    damp)): the kernel-ceiling batch (OSC_BATCH_ROWS rows on saw mip 0,
    seed 0, drawn as bench_osc_kernel draws them) and a mixture of 256
    rows on each of the five waves at mips 0/1/3/5 (seed 1, shuffled),
    all inside the table contract (ph0 < size << 24, dph < 2 << 24)."""
    rng = np.random.default_rng(0)
    tb, npz, off = pa.lookup("saw", 0)
    size = waves["saw"].size[0]
    bench = [(tb, npz, off, int(rng.integers(0, size << 24)),
              int(rng.integers(1 << 20, 2 << 24)),
              int(rng.integers(0, 1 << 26)), 0)
             for _ in range(OSC_BATCH_ROWS)]
    rng = np.random.default_rng(1)
    mix = []
    for name in OSC_WAVES:
        for mm in (0, 1, 3, 5):
            tb, npz, off = pa.lookup(name, mm)
            n = 256
            mix += zip([tb] * n, [npz] * n, [off] * n,
                       rng.integers(0, waves[name].size[mm] << 24, n)
                       .tolist(),
                       rng.integers(1 << 18, 2 << 24, n).tolist(),
                       rng.integers(-(1 << 27), 1 << 27, n).tolist(),
                       rng.integers(-(1 << 20), 1 << 20, n).tolist())
    mix = [mix[k] for k in rng.permutation(len(mix))]
    out = []
    for label, rows in (("bench", bench), ("mixture", mix)):
        b = TOK.OscBatch(pa)
        for r in rows:
            b.add(*r)
        out.append((label, b, rows))
    return out


def osc_twin(pa, b, quality):
    """osc_rows_numpy over the columns an OscBatch stores."""
    return TOK.osc_rows_numpy(
        pa.np_pairs, *np.array(b.rows, np.int32).reshape(-1, 8).T,
        quality=quality)


def phase_osc_batch(card):
    """OscBatch / evaluate_osc_batch on the card: the kernel-ceiling
    batch at qualities 0 and 2 and the five-wave mixture at 0/1/2,
    each through ``evaluate_osc_batch(batch)`` (the atlas uploaded to
    the card), 5 oscillator launches per call, equal to the plain
    version on the CPU and to the numpy twin; then, on the
    kernel-ceiling batch, the kernel's device ms (its 5 launches in a
    CUDA graph), the host add and build ms, the copy-back ms and the
    whole call's ms.  Returns (the path's launches, the numbers)."""
    t0 = time.perf_counter()
    i = a2.open_engine(SR, 1024, 1, batched=False)
    waves = {name: i.get_wave(i.get(0, name)) for name in OSC_WAVES}
    pa = TOK.PairAtlas()
    for name, w in waves.items():
        pa.add_wave(name, w)
    pa.finalize()
    cases = [(label, b, rows, q)
             for label, b, rows in osc_batches(pa, waves)
             for q in ((0, 2) if label == "bench" else (0, 1, 2))]
    zero_launches()
    got = {}
    for label, b, _, q in cases:
        before = OK.osc_slots_call.launches
        got[label, q] = TOK.evaluate_osc_batch(b, quality=q)
        torch.cuda.synchronize()
        check(OK.osc_slots_call.launches - before == len(TOK.PASS_CLASSES),
              "osc_batch %s q%d: %d oscillator launches, not %d"
              % (label, q, OK.osc_slots_call.launches - before,
                 len(TOK.PASS_CLASSES)))
    launches = read_launches()
    check(launches["osc_slots"] == len(TOK.PASS_CLASSES) * len(cases)
          and launches["osc_rows"] == 0,
          "osc_batch: %d oscillator launches (%d of the rows epilogue) for "
          "%d calls" % (launches["osc_slots"], launches["osc_rows"],
                        len(cases)))
    cpu_atlas = torch.from_numpy(pa.data)
    for label, b, _, q in cases:
        out = got[label, q]
        check(out.shape == (b.n, TOK.FRAG) and out.dtype == np.int32
              and np.abs(out).max() > 0, "osc_batch %s q%d: output %s %s"
              % (label, q, out.shape, out.dtype))
        plain = TOK.evaluate_osc_batch(b, cpu_atlas, quality=q)
        bad = int((out != plain).sum())
        check(bad == 0, "osc_batch %s q%d: %d samples differ from the "
              "plain version" % (label, q, bad))
        bad = int((out != osc_twin(pa, b, q)).sum())
        check(bad == 0, "osc_batch %s q%d: %d samples differ from the "
              "numpy twin" % (label, q, bad))

    # the parts of one call on the kernel-ceiling batch
    _, bench, rows, _ = cases[0]
    times = {}
    reps = 5
    adds, builds = [], []
    for _ in range(reps):
        t1 = time.perf_counter()
        b = TOK.OscBatch(pa)
        for r in rows:
            b.add(*r)
        t2 = time.perf_counter()
        calls = b.build()
        adds.append((t2 - t1) * 1e3)
        builds.append((time.perf_counter() - t2) * 1e3)
    atlas = torch.as_tensor(pa.data, device=DEVICE)
    dev_calls = [(cls, torch.as_tensor(t, device=DEVICE),
                  torch.as_tensor(p, device=DEVICE),
                  torch.as_tensor(np.where(o >= 0, o, bench.n).reshape(-1),
                                  device=DEVICE))
                 for cls, t, p, o in calls]
    outs = torch.zeros((bench.n + 1, 1, OK.FRAG), dtype=torch.int32,
                       device=DEVICE)
    # the work the function needs: the pair rows of the tables its live
    # rows read, each live row's params and its FRAG output words, and
    # its frames' operations without the panmix (channel 0 of mode 0
    # rows is the amped sample; the dead blocks' work is not needed)
    tables = {(r[0], r[1]) for r in bench.rows}
    nbytes = (sum(npass for _, npass in tables) * OK.RPB
              + bench.n * (OK.NPARAM + OK.FRAG)) * 4
    copies = []
    dev_out = torch.zeros((bench.n, OK.FRAG), dtype=torch.int32,
                          device=DEVICE)
    for _ in range(reps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dev_out.cpu().numpy()
        copies.append((time.perf_counter() - t1) * 1e3)
    for q in (0, 2):
        kernel_ms = graph_ms(lambda: [
            OK.osc_slots_call(cls, t, p, atlas, outs, o, q, False, True)
            for cls, t, p, o in dev_calls])
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            TOK.evaluate_osc_batch(bench, quality=q)
            walls.append((time.perf_counter() - t1) * 1e3)
        nops = bench.n * OK.FRAG * OK.ops_per_frame(q, False, True)
        bms, by = bound(nbytes, nops)
        times["q%d" % q] = dict(
            kernel_ms=kernel_ms, bound_ms=bms, bound_by=by,
            msamples_s=bench.n * OK.FRAG / kernel_ms / 1e3,
            call_ms=float(np.median(walls)))
    times.update(rows=bench.n, blocks=[p.shape[1] // OK.RPB
                                       for _, _, p, _ in dev_calls],
                 add_ms=float(np.median(adds)),
                 build_ms=float(np.median(builds)),
                 copy_ms=float(np.median(copies)))
    print("%s | osc_batch, %d rows on saw mip 0 (blocks per pass class "
          "%s): kernel %s; host add %.3f ms, build %.3f ms, copy back "
          "%.3f ms (median of %d)" % (
              card, bench.n, times["blocks"], "; ".join(
                  "%s %.4f ms for 5 launches (bound %.4f ms, %s), %.1f M "
                  "voice-samples/s, whole call %.3f ms"
                  % (k, t["kernel_ms"], t["bound_ms"], t["bound_by"],
                     t["msamples_s"], t["call_ms"])
                  for k, t in times.items() if k in ("q0", "q2")),
              times["add_ms"], times["build_ms"], times["copy_ms"], reps),
          flush=True)
    phase("osc_batch", t0, "%s equal to the plain version and the numpy "
          "twin; %d oscillator launches (5 per call)"
          % (", ".join("%s q%d (%d rows)" % (label, q, b.n)
                       for label, b, _, q in cases), launches["osc_slots"]))
    return launches, times


# ---------------------------------------------------------------
# the sharded render and the voice-batched helpers
# ---------------------------------------------------------------

SHARD_COUNTS = (1, 2, 4, 8)


def sharded_render(song, channels, frames, n, **kw):
    """`song` through ``parallel.render_sharded``: n shards on the card
    (in process, one device repeated), or under `group` when kw has it,
    at the default superblock (1376x64 frames)."""
    src, program = SONGS[song]
    i = a2.open_engine(SR, 4096, channels, batched=False)
    s = i.get(i.load_string(src, song), program)
    devices = kw.pop("devices", None) or [DEVICE] * n
    return render_sharded(i, s, frames, n_devices=n, channels=channels,
                          devices=devices, **kw)


def nccl_render(song, channels, frames):
    """`song` through the process-group form under NCCL at world size 1
    (a file:// store in a temporary directory)."""
    import torch.distributed as dist
    tmp = tempfile.mkdtemp()
    try:
        dist.init_process_group("nccl", init_method="file://"
                                + os.path.join(tmp, "store"), rank=0,
                                world_size=1)
        try:
            return sharded_render(song, channels, frames, None,
                                  devices=[DEVICE],
                                  group=dist.group.WORLD)
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_shards(card):
    """The sharded render: the effects song (stereo, 10 s, superblocks of
    1376x64 frames) at 1, 2, 4 and 8 shards on the card and under NCCL
    at world size 1, and the slice song at 4 shards, each bit-equal to
    native and to the solo DeviceRenderer.render of the same superblocks,
    with launches of the oscillator and the exact tail kernels counted
    over the sharded renders; per-shard expansion, sum and tail times;
    then graft_entry.entry() and dryrun_multichip(4) on the card, with
    the row kernel's launches.  Returns (the sharded renders' launches,
    the helpers' launches, the times by shard count)."""
    t0 = time.perf_counter()
    frames = int(10.0 * SR)
    sb = min(frames, DEFAULT_BUFSIZE)
    want, solo = {}, {}
    for song in ("effects", "slice"):
        want[song] = native_render(song, 2, frames, sb=sb)
        r = open_song(song, 2, DeviceRenderer, device=DEVICE)
        r.wait_device()
        solo[song] = r.render(frames, bufsize=sb)
        check(not r.fell_back, "shards: the solo %s render bridged" % song)
        r.close()
        check(int((solo[song] != want[song]).sum()) == 0,
              "shards: the solo %s render differs from native" % song)

    def held(label, song, out):
        check(out.shape == (2, frames) and out.dtype == np.int32,
              "%s: output shape %s" % (label, out.shape))
        check(np.abs(out).max() > 0, "%s: silent output" % label)
        for ref, what in ((want[song], "native"), (solo[song], "solo")):
            bad = int((out != ref).sum())
            check(bad == 0, "%s: %d samples differ from %s"
                  % (label, bad, what))

    zero_launches()
    times = {}
    per_render = {}

    def count(label):
        # this render's launches: the counts since the last render's
        torch.cuda.synchronize()
        now = read_launches()
        per_render[label] = {k: v - sum(p.get(k, 0)
                                        for p in per_render.values())
                             for k, v in now.items()}
        return now

    for n in SHARD_COUNTS:
        tm = []
        held("effects %d shards" % n, "effects",
             sharded_render("effects", 2, frames, n, timings=tm))
        times[n] = summarize(tm)
        count("effects %d shards" % n)
    held("effects nccl 1 rank", "effects", nccl_render("effects", 2, frames))
    count("effects nccl 1 rank")
    held("slice 4 shards", "slice", sharded_render("slice", 2, frames, 4))
    launches = count("slice 4 shards")
    for k in ("osc_slots", "filter", "fm", "expand"):
        check(launches[k] > 0, "shards: the %s kernel never launched in a "
              "sharded render" % k)
    check(launches["fbdelay_dense"] + launches["fbdelay_legacy"] > 0,
          "shards: no fbdelay kernel launched in a sharded render")
    check(launches["unpack"] == 0 and launches["filter_float"] == 0
          and launches["expand_rmq"] == 0 and launches["expand"] > 0,
          "shards: the sharded render left the exact unpacked path")

    zero_launches()
    fn, args = graft_entry.entry()
    out = fn(*args)
    check(out.shape == (2, 64) and int(out.abs().max()) > 0,
          "entry: output %s" % (tuple(out.shape),))
    graft_entry.dryrun_multichip(4)
    torch.cuda.synchronize()
    helpers = read_launches()
    check(helpers["rows"] > 0, "entry / dryrun: the rows kernel never "
          "launched")
    print("%s | sharded effects stereo 10 s, per superblock (device ms, "
          "mean of %d steady superblocks): %s" % (card, times[1][
              "superblocks"], "; ".join(
                  "%d shards: wall %.3f, expansion %.3f per shard (%.3f "
                  "all), sum %.3f, tail %.3f"
                  % (n, t["wall_ms"], float(np.mean(t["expand_ms"])),
                     t["expand_total_ms"], t["sum_ms"], t["tail_ms"])
                  for n, t in times.items())), flush=True)
    phase("shards", t0, "effects stereo 10 s at %s shards and NCCL world "
          "size 1, slice at 4 shards == native == solo; launches by "
          "render %s; entry + dryrun_multichip(4): launches %s"
          % ("/".join(map(str, SHARD_COUNTS)),
             json.dumps({label: {k: v for k, v in l.items() if v}
                         for label, l in per_render.items()}),
             json.dumps({k: v for k, v in helpers.items() if v})))
    return launches, helpers, dict(times=times, launches_by_render=per_render)


PHASES = ("expand", "capture", "slice", "effects", "legacy", "pipeline",
          "serve", "float", "cli", "packed", "device_mix", "rows",
          "osc_batch", "shards")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(("kernel", "tail")
                                                 + PHASES))
    a = ap.parse_args(argv)
    want = set(a.phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = phase_device()
    phase_build()
    kernels = []
    if "kernel" in want:
        kernels += phase_kernel()
    if "tail" in want:
        kernels += phase_tail()
    extra = {}
    if "expand" in want:
        kernels.append(phase_expand())
    if "capture" in want:
        extra["capture"] = phase_capture()
    paths = {}
    if "slice" in want:
        # the rows epilogue's count there is 0 (checked)
        paths["osc_slots"] = paths["osc_rows"] = phase_slice()
    if "effects" in want:
        effects = phase_effects()
        # the standalone decoder is off the main path: its launches there
        # (0) are counted on the effects song, as are the expansion's
        for k in ("fbdelay_dense", "filter", "fm", "unpack", "expand"):
            paths[k] = effects
        check(all(effects["filter_" + k] for k in FL.KINDS),
              "effects: a filter kind never launched: %s"
              % json.dumps(effects))
    if "legacy" in want:
        paths["fbdelay_legacy"] = phase_legacy()
    if "pipeline" in want:
        extra["pipeline_launches"], extra["timing"] = phase_pipeline()
    if "serve" in want:
        extra["serve"] = phase_serve()
    if "float" in want:
        rec, fpaths, extra["float_timing"] = phase_float()
        kernels.append(rec)
        paths["filter_float"] = fpaths["effects stereo 10.0 s float"]
    if "cli" in want:
        extra["cli"] = phase_cli()
    if "packed" in want:
        kernels.append(phase_packed())
    if "device_mix" in want:
        extra["device_mix_launches"] = phase_device_mix()
    if "rows" in want:
        rec, paths["rows"] = phase_rows()
        kernels.append(rec)
    osc_batch = None
    if "osc_batch" in want:
        osc_batch, extra["osc_batch"] = phase_osc_batch(card)
    sharded = {}
    if "shards" in want:
        sharded, helpers, extra["shards"] = phase_shards(card)
        sharded = dict(sharded, rows=helpers["rows"])
    # launches of the render phases that ran (all of them without
    # --phases); a kind without a count of its own (fm) takes its
    # kernel's
    for rec in kernels:
        own = paths.get(rec["name"])
        if own is not None:
            rec["launches"] = own[rec["name"]]
            for kind, k in rec.get("kinds", {}).items():
                k["launches"] = own.get(rec["name"] + "_" + kind,
                                        own[rec["name"]])
        if rec["name"] in sharded:
            # the sharded renders' launches (the row kernel's: the
            # voice-batched helpers')
            rec["launches_sharded"] = sharded[rec["name"]]
        if "pipeline_launches" in extra and "launches_by_path" not in rec:
            rec["launches_by_path"] = {
                p: l[rec["name"]]
                for p, l in extra["pipeline_launches"].items()}
        if osc_batch is not None and rec["name"] == "osc_slots":
            rec.setdefault("launches_by_path", {})["osc_batch"] = \
                osc_batch["osc_slots"]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump({"kernels": kernels, **extra}, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
