"""The filter and fm kernels against an earlier form of them, on the card.

    python3 -m audiality2_tpu_torch.tail_ab --old-csrc DIR [--reps 3]

DIR holds an earlier ``filter_kernel.cu``, ``fm_kernel.cu`` and
``stage_common.cuh`` with the one-slice-step C interface (one block,
three synchronised phases per slice step, no step groups):

    a2_filter(slots, arr, state, scratch [K, 2, 64], S, K, kind, ni, no,
              add, sch0, sch1, dch0, dch1, stream)
    a2_fm(slots, arr, state, sine, scratch [K, 64], S, K, structkey,
          add, dch, stream)

for instance ``git archive <commit> audiality2_tpu_torch/cuda/csrc``
unpacked into a directory that ``.gitignore`` lists.  Builds them with
nvcc (sm_90a) beside the current kernels, records the effects song's
first stereo superblock, and for each of its filter12 / dcblock /
limiter / fm items runs both forms on the same seeded slots: their
slots and state must agree bit for bit; then times them with CUDA
events in the order earlier, current, current, earlier (``reps``
launches each).  Also times the host's step-group computation of the
superblock's items.  Prints the card's name and power limit, one line
per item, and one JSON object last.  Needs a CUDA device.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import open_engine
from .cuda import build
from .cuda import filter as FL
from .cuda import fm as FM
from .engine.device_render import DeviceRenderer, SUPERBLOCK_FRAMES
from .songs import SONGS


def build_old(csrc, out_dir):
    """nvcc of the earlier sources, both at once; returns {name: CDLL}."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in ("filter_kernel", "fm_kernel"):
        lib = os.path.join(out_dir, "libold_%s.so" % name)
        cmd = [build._nvcc()] + build.NVCC_FLAGS + [
            "-o", lib, os.path.join(csrc, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (p, lib) in procs.items():
        out, _ = p.communicate(timeout=build.BUILD_TIMEOUT_S)
        if p.returncode:
            raise RuntimeError("nvcc failed on the earlier %s.cu:\n%s"
                               % (name, out))
        libs[name] = ctypes.CDLL(lib)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    libs["filter_kernel"].a2_filter.argtypes = [vp] * 4 + [ci] * 10 + [vp]
    libs["fm_kernel"].a2_fm.argtypes = [vp] * 5 + [ci] * 5 + [vp]
    return libs


def old_filter(lib, slots, kind, sig, arr, state):
    ni, no, add, sch, dch = sig
    S, K = arr.shape[:2]
    scratch = torch.empty((K, 2, FL.FRAG), dtype=torch.int32,
                          device=slots.device)
    err = lib.a2_filter(slots.data_ptr(), arr.data_ptr(), state.data_ptr(),
                        scratch.data_ptr(), S, K, FL.KINDS.index(kind), ni,
                        no, int(bool(add)), sch[0], sch[-1], dch[0],
                        dch[-1], torch.cuda.current_stream().cuda_stream)
    build.launch_check(err, "earlier filter")


def old_fm(lib, slots, sig, arr, state, sine):
    structkey, add, dch = sig
    S, K = arr.shape[:2]
    scratch = torch.empty((K, FM.FRAG), dtype=torch.int32,
                          device=slots.device)
    err = lib.a2_fm(slots.data_ptr(), arr.data_ptr(), state.data_ptr(),
                    sine.data_ptr(), scratch.data_ptr(), S, K, structkey,
                    int(bool(add)), dch,
                    torch.cuda.current_stream().cuda_stream)
    build.launch_check(err, "earlier fm")


def event_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def first_program(song, channels):
    src, program = SONGS[song]
    i = open_engine(44100, 4096, channels, batched=False)
    s = i.get(i.load_string(src, song), program)
    r = DeviceRenderer(i, channels=channels, device="cuda")
    r.timestamp_reset()
    r.start(0, s)
    prog = r.record_program(SUPERBLOCK_FRAMES)
    r.close()
    return prog


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", required=True)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tail_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    old = build_old(a.old_csrc, os.path.join(a.old_csrc, "build"))
    build.build()
    prog = first_program("effects", 2)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    slots0 = torch.randint(-(1 << 27), 1 << 27,
                           (prog.ninst * prog.F + 1, 2, FL.FRAG),
                           dtype=torch.int32, device=dev, generator=gen)
    sine = torch.as_tensor(FM.sine_pairs(), device=dev)
    items = []
    t_groups = []
    for _ in range(20):
        t0 = time.perf_counter()
        for fl in prog.filters:
            key = fl["key"]
            if fl["kind"] == "fm":
                FM.groups(fl["arr"], (key[3], key[4], key[5][0]))
            else:
                FL.groups(fl["arr"], key[3:8])
        t_groups.append((time.perf_counter() - t0) * 1e3)
    for fl in prog.filters:
        kind, key = fl["kind"], fl["key"]
        arr = torch.as_tensor(fl["arr"], device=dev)
        S, K = arr.shape[:2]
        if kind == "fm":
            sig = (key[3], key[4], key[5][0])
            bounds = FM.groups(fl["arr"], sig)

            def new(s, st, sig=sig, arr=arr, b=bounds):
                FM.fm_call(s, sig, arr, st, sine, b)

            def older(s, st, sig=sig, arr=arr):
                old_fm(old["fm_kernel"], s, sig, arr, st, sine)
        else:
            sig = key[3:8]
            bounds = FL.groups(fl["arr"], sig)

            def new(s, st, kind=kind, sig=sig, arr=arr, b=bounds):
                FL.filter_call(s, kind, sig, arr, st, b)

            def older(s, st, kind=kind, sig=sig, arr=arr):
                old_filter(old["filter_kernel"], s, kind, sig, arr, st)
        res = []
        for fn in (older, new):
            s, st = slots0.clone(), FL.init_state(kind, K, dev)
            fn(s, st)
            torch.cuda.synchronize()
            res.append((s.cpu(), st.cpu()))
        bad = sum(int((x != y).sum()) for x, y in zip(*res))
        s, st = slots0.clone(), FL.init_state(kind, K, dev)
        times = {"old": [], "new": []}
        for which, fn in (("old", older), ("new", new), ("new", new),
                          ("old", older)):
            times[which].append(event_ms(lambda: fn(s, st), a.reps))
        rec = {"kind": kind, "S": int(S), "K": int(K),
               "groups": len(bounds) - 1, "mismatches": bad,
               "old_ms": times["old"], "new_ms": times["new"],
               "speedup": float(np.mean(times["old"])
                                / np.mean(times["new"]))}
        items.append(rec)
        print("%-4s S%d K%d %d groups: earlier %s ms, current %s ms "
              "(%.1fx), %d mismatches"
              % (kind, S, K, rec["groups"],
                 " / ".join("%.4f" % t for t in times["old"]),
                 " / ".join("%.4f" % t for t in times["new"]),
                 rec["speedup"], bad), flush=True)
    print("host step groups of the superblock's %d items: median %.3f ms "
          "(min %.3f, max %.3f over 20 runs)"
          % (len(prog.filters), float(np.median(t_groups)), min(t_groups),
             max(t_groups)))
    print(json.dumps({"card": card, "items": items,
                      "host_groups_ms": t_groups}))
    return 1 if any(r["mismatches"] for r in items) else 0


if __name__ == "__main__":
    sys.exit(main())
