#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (``audiality2_tpu_torch``) only; nothing here imports
``jax`` or ``audiality2_tpu``.  Phases, each printing one line with its
seconds:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, whether nvcc is found;
2. build: the native runtime (native/build.sh) and the oscillator
   kernel (nvcc for sm_90a), from the sources in the checkout, in
   parallel;
3. kernel: the CUDA oscillator against its plain PyTorch version on
   the card, on seeded rows for every pass class x quality x mono x
   fused_pm and on the slice song's real blocks: 0 mismatches; times
   the kernel and the plain version at the real shape;
4. slice: the slice song (stereo, 44.1 kHz, 10 s, superblocks of
   2752x64 frames) through ``DeviceRenderer(device=DEVICE).render``
   against the native renderer, bit for bit, with no native bridging
   and with oscillator launches; then 2 s mono the same way.

Then one JSON line with the kernel's numbers and, last, the
``{"ok": true, "device": ...}`` line.  Any failure raises, and the exit
code is not 0.  Needs one card; exits non-zero without one.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

import audiality2_tpu_torch as a2
from audiality2_tpu_torch.cuda import osc_kernel as OK
from audiality2_tpu_torch.engine.device_render import (DeviceRenderer,
                                                       SUPERBLOCK_FRAMES)
from audiality2_tpu_torch.native import NativeRenderer
from audiality2_tpu_torch.songs import SLICE_SONG

ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 44100
# H100 SXM peaks for the bound: HBM at 3.35 TB/s (data sheet); int32
# ALU at 64 lanes/SM x 132 SMs x 1.98 GHz boost (Hopper white paper)
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 64 * 132 * 1.98e9
DEVICE = "cuda"


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


def open_song(channels, renderer, **kw):
    i = a2.open_engine(SR, 4096, channels, batched=False)
    song = i.get(i.load_string(SLICE_SONG, "slice"), "Song")
    r = renderer(i, channels=channels, **kw)
    r.timestamp_reset()
    r.start(0, song)
    return r


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
        lib = OK.build_library(verbose=True)
    finally:
        nout, _ = native.communicate(timeout=OK.BUILD_TIMEOUT_S)
    check(native.returncode == 0, "native build failed:\n" + nout)
    OK._load()
    ptxas = [ln.strip() for ln in OK._Lib.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    phase("build", t0, "native/liba2rt.so, %s; ptxas: %s"
          % (os.path.relpath(lib, ROOT), " | ".join(ptxas[:4])))


def compare(cls, tb, par, atlas, quality, fused, mono):
    got = OK.osc_call(cls, tb, par, atlas, quality=quality,
                      fused_pm=fused, mono=mono)
    want = OK.osc_rows_torch(cls, tb, par, atlas, quality, fused, mono)
    check(got.shape == want.shape, "kernel output shape")
    diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
    return int((got != want).sum()), int(diff.max()) if diff.numel() else 0


def phase_kernel():
    """Kernel vs plain version; returns the kernel's JSON record
    (launches filled in by the slice phase)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(2024)
    nvar = 0
    max_err = 0
    for npass in OK.PASS_CLASSES:
        tb, par, atlas = (torch.from_numpy(x).to(DEVICE) for x in
                          OK.seeded_blocks(npass, 16, rng, dead=True))
        for quality in (0, 1, 2):
            for fused in (True, False):
                for mono in (False, True):
                    bad, err = compare(npass, tb, par, atlas, quality,
                                       fused, mono)
                    check(bad == 0, "kernel != plain: npass %d quality %d "
                          "fused %s mono %s: %d mismatches"
                          % (npass, quality, fused, mono, bad))
                    max_err = max(max_err, err)
                    nvar += 1

    # the slice song's first superblock at its real shapes
    r = open_song(2, DeviceRenderer, device=DEVICE)
    prog = r.record_program(SUPERBLOCK_FRAMES)
    classes, _, mono = r.mixer.row_params(prog)
    atlas = r.mixer.device_atlas()
    r.close()
    ms = plain_ms = 0.0
    nbytes = nops = 0
    nrows = 0
    shapes = []
    for cls, tb, par in classes:
        if cls == 0:
            continue
        bad, err = compare(cls, tb, par, atlas, 0, True, mono)
        check(bad == 0, "kernel != plain on the slice song's class %d "
              "blocks: %d mismatches" % (cls, bad))
        max_err = max(max_err, err)
        R = par.shape[1]
        nrows += R
        shapes.append("%dx%d" % (cls, R // OK.RPB))
        ms += cuda_ms(lambda: OK.osc_call(cls, tb, par, atlas, 0, True,
                                          mono), reps=20)
        plain_ms += cuda_ms(lambda: OK.osc_rows_torch(cls, tb, par, atlas,
                                                      0, True, mono),
                            reps=3, warmup=1)
        C = 1 if mono else 2
        nbytes += par.numel() * 4 + tb.numel() * 4 + atlas.numel() * 4 \
            + C * OK.FRAG * R * 4
        nops += R * OK.FRAG * OK.ops_per_frame(0, True, mono)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = nops / INT32_OPS_S * 1e3
    phase("kernel", t0, "%d variants + slice blocks (pass class x blocks: "
          "%s, %d rows) equal to the plain version; kernel %.4f ms, plain "
          "%.3f ms per superblock" % (nvar, " ".join(shapes), nrows, ms,
                                      plain_ms))
    return {"name": "osc_rows", "route": "cuda",
            "source": "audiality2_tpu_torch/cuda/csrc/osc_kernel.cu",
            "replaces": "audiality2_tpu/tpu/osc_kernel.py:117",
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "rows": nrows,
            "variants_checked": nvar}


def render_check(channels, seconds, label):
    """Renders the slice song through the port and natively; returns
    (oscillator launches, x realtime, timings)."""
    frames = int(seconds * SR)
    # native renders the same superblocks (a ragged last fragment would
    # bend its ramps off the device path's full-fragment record)
    nat = open_song(channels, NativeRenderer)
    want = np.concatenate(
        [nat.run(SUPERBLOCK_FRAMES)
         for _ in range(-(-frames // SUPERBLOCK_FRAMES))], axis=1)[:, :frames]
    nat.close()
    r = open_song(channels, DeviceRenderer, device=DEVICE)
    OK.osc_call.launches = 0
    t0 = time.perf_counter()
    out = r.render(frames, bufsize=SUPERBLOCK_FRAMES)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = OK.osc_call.launches
    fell_back = r.fell_back
    timings = dict(r.timings)
    r.close()
    check(out.shape == (channels, frames) and out.dtype == np.int32,
          "%s: output shape %s" % (label, out.shape))
    check(np.abs(out).max() > 0, "%s: silent output" % label)
    check(not fell_back, "%s: bridged natively" % label)
    check(launches > 0, "%s: the oscillator kernel never launched" % label)
    bad = int((out != want).sum())
    check(bad == 0, "%s: %d samples differ from native" % (label, bad))
    return launches, seconds / dt, timings, dt


def phase_slice():
    t0 = time.perf_counter()
    launches, xrt, tm, dt = render_check(2, 10.0, "stereo 10 s")
    mono_launches, mono_xrt, _, _ = render_check(1, 2.0, "mono 2 s")
    phase("slice", t0, "stereo 10 s == native, %.1f x realtime (%.3f s: "
          "record %.3f, build %.3f, mix %.3f, fetch %.3f), %d oscillator "
          "launches; mono 2 s == native, %.1f x realtime, %d launches"
          % (xrt, dt, tm["record"], tm["build"], tm["mix"], tm["fetch"],
             launches, mono_xrt, mono_launches))
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    phase_device()
    phase_build()
    kern = phase_kernel()
    kern["launches"] = phase_slice()
    print(json.dumps({"kernels": [kern]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
