"""The stage-tail kernels against an earlier form of them, on the card.

    python3 -m audiality2_tpu_torch.tail_ab --old-csrc DIR \\
        [--kernels fbdelay | filter,fm | filter_float] [--reps 10]

DIR holds earlier kernel sources (with their ``stage_common.cuh``), for
instance ``git archive <commit> audiality2_tpu_torch/cuda/csrc``
unpacked into a directory that ``.gitignore`` lists.  ``--kernels``
names the kernels to compare:

- ``fbdelay`` (the default): DIR's ``fbdelay_kernel.cu`` with the
  one-block C interface

      a2_fbd_dense(x, g, buf, ofb, npad, CH, fb, stream)
      a2_fbd_legacy(x, arr, starts, ring, ofb, wbuf [2, NS, 64], NS, C,
                    stream)

  on the effects song's dense item and the late fbdelay song's legacy
  item (first superblocks, seeded slots, tail and ring), and on seeded
  full superblocks (2752x64 frames): dense at fb = 64 and fb = 2^17,
  legacy at C = 1.  Both forms' o_fb and buffer or ring must agree.
- ``filter`` / ``fm``: DIR's ``filter_kernel.cu`` / ``fm_kernel.cu``
  with the one-slice-step C interface (one block, three synchronised
  phases per slice step, no step groups):

      a2_filter(slots, arr, state, scratch [K, 2, 64], S, K, kind, ni,
                no, add, sch0, sch1, dch0, dch1, stream)
      a2_fm(slots, arr, state, sine, scratch [K, 64], S, K, structkey,
            add, dch, stream)

  on the effects song's first superblock's filter12 / dcblock /
  limiter / fm items, on the same seeded slots: slots and state must
  agree.  Also times the host's step-group computation of those items.
- ``filter_float``: DIR's ``filter_float_kernel.cu`` with the
  four-launch C interface (tile maps, tile scan, walk, emit; commit
  0ce2b73 and before)

      a2_filter_float(slots, arr, state, scratch [old_float_scratch],
                      obuf [S, K, no, 64], S, K, kind, ni, no, add,
                      sch0, sch1, dch0, dch1, stream)

  on the same limiter / filter12 / dcblock items in the float tier,
  against the current one-launch kernel.  The current kernel, built
  again with ``-DA2_FF_CLOCK``, also runs each item eagerly
  (CLOCK_RUNS times): the mean ns of its phases (tiles built, grid
  barrier, entry state, walk down, outputs computed, outputs added, a
  late REPLACE's channel 1) in the first and the last block, which
  holds the chain's last tile.

Builds the earlier sources with nvcc (sm_90a) beside the current
kernels, then times each item's two forms in the order earlier,
current, current, earlier (``graph_ms``: ``reps`` launches captured into
one CUDA graph, so the host's launch rate does not hide a short
kernel's device time).  Prints the card's name and power limit, one
line per item and one JSON object last; exits 1 on any mismatch.
Needs a CUDA device.
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
from .cuda import fbdelay as FB
from .cuda import filter as FL
from .cuda import filter_float as FF
from .cuda import fm as FM
from .engine.device_render import DeviceRenderer, SUPERBLOCK_FRAMES
from .songs import SONGS

VP, CI = ctypes.c_void_p, ctypes.c_int
# H100 SXM peaks for a kernel's bound (data sheet): HBM, float32 outside
# the tensor cores
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
# the earlier C interfaces: source name -> {function: argtypes}
OLD_ARGTYPES = {
    "fbdelay_kernel": {"a2_fbd_dense": [VP] * 4 + [CI] * 3 + [VP],
                       "a2_fbd_legacy": [VP] * 6 + [CI] * 2 + [VP]},
    "filter_kernel": {"a2_filter": [VP] * 4 + [CI] * 10 + [VP]},
    "fm_kernel": {"a2_fm": [VP] * 5 + [CI] * 5 + [VP]},
    "filter_float_kernel": {"a2_filter_float": [VP] * 5 + [CI] * 10 + [VP]},
}


CLOCK_RUNS = 30
CLOCK_PHASES = ("build", "barrier", "entry", "walk_down", "outputs", "adds",
                "late_emit")


def start_clock_build(out_dir):
    """Starts nvcc of the current float kernel with -DA2_FF_CLOCK;
    returns (process, library path)."""
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libfilter_float_clock.so")
    cmd = [build._nvcc()] + build.NVCC_FLAGS + [
        "-DA2_FF_CLOCK", "-o", lib,
        os.path.join(build.CSRC_DIR, "filter_float_kernel.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def load_clock(proc, path):
    out, _ = proc.communicate(timeout=build.BUILD_TIMEOUT_S)
    if proc.returncode:
        raise RuntimeError("nvcc failed on the clock build:\n%s" % out)
    lib = ctypes.CDLL(path)
    FF._bind(lib)
    lib.a2_filter_float_clock.argtypes = [VP]
    lib.a2_filter_float_clock.restype = CI
    return lib


def clock_item(lib, slots, kind, sig, arr, state):
    """Mean ns of each phase of the clock build's launch on one item,
    in its first and its last block, over CLOCK_RUNS eager launches."""
    ni, no, add, sch, dch = sig
    S, K = arr.shape[:2]
    scratch = torch.empty(FF.plan(kind, sig, S, K, slots.device)["scratch"],
                          dtype=torch.float32, device=slots.device)
    stamps = (ctypes.c_uint64 * 16)()
    runs = []
    for _ in range(CLOCK_RUNS):
        err = lib.a2_filter_float(
            slots.data_ptr(), arr.data_ptr(), state.data_ptr(),
            scratch.data_ptr(), S, K, FL.KINDS.index(kind), ni, no,
            int(bool(add)), sch[0], sch[-1], dch[0], dch[-1], _stream())
        build.launch_check(err, "filter_float clock")
        torch.cuda.synchronize()
        build.launch_check(lib.a2_filter_float_clock(stamps), "clock read")
        runs.append(np.array(stamps[:], dtype=np.int64).reshape(2, 8))
    r = np.array(runs, dtype=np.float64)           # [runs, block, stamp]
    d = np.diff(r, axis=2).mean(0)
    return {"first": dict(zip(CLOCK_PHASES, d[0].tolist())),
            "last": dict(zip(CLOCK_PHASES, d[1].tolist())),
            "last_start_ns": float((r[:, 1, 0] - r[:, 0, 0]).mean()),
            "span_ns": float((r[:, :, 7].max(1) - r[:, :, 0].min(1))
                             .mean())}


def build_old(csrc, out_dir, names):
    """nvcc of the earlier sources `names`, all at once; returns {name:
    CDLL}."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
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
        for fn, argtypes in OLD_ARGTYPES[name].items():
            getattr(libs[name], fn).argtypes = argtypes
    return libs


def _stream():
    return torch.cuda.current_stream().cuda_stream


def old_filter(lib, slots, kind, sig, arr, state):
    ni, no, add, sch, dch = sig
    S, K = arr.shape[:2]
    scratch = torch.empty((K, 2, FL.FRAG), dtype=torch.int32,
                          device=slots.device)
    err = lib.a2_filter(slots.data_ptr(), arr.data_ptr(), state.data_ptr(),
                        scratch.data_ptr(), S, K, FL.KINDS.index(kind), ni,
                        no, int(bool(add)), sch[0], sch[-1], dch[0],
                        dch[-1], _stream())
    build.launch_check(err, "earlier filter")


def old_float_scratch(kind, ni, S, K):
    """Floats of the four-launch kernel's scratch: each tile's map (6
    floats, or 2 for the limiter) and entry state (2, or 1), per
    sequence, tiles of FF.TILE samples."""
    T = -(-S * FL.FRAG // FF.TILE)
    return K * FF.chains(kind, ni) * T * (3 if kind == "lim" else 8)


def old_filter_float(lib, slots, kind, sig, arr, state):
    ni, no, add, sch, dch = sig
    S, K = arr.shape[:2]
    scratch = torch.empty(old_float_scratch(kind, ni, S, K),
                          dtype=torch.float32, device=slots.device)
    obuf = torch.empty((S, K, no, FL.FRAG), dtype=torch.int32,
                       device=slots.device)
    err = lib.a2_filter_float(
        slots.data_ptr(), arr.data_ptr(), state.data_ptr(),
        scratch.data_ptr(), obuf.data_ptr(), S, K, FL.KINDS.index(kind),
        ni, no, int(bool(add)), sch[0], sch[-1], dch[0], dch[-1],
        _stream())
    build.launch_check(err, "earlier filter_float")


def old_fm(lib, slots, sig, arr, state, sine):
    structkey, add, dch = sig
    S, K = arr.shape[:2]
    scratch = torch.empty((K, FM.FRAG), dtype=torch.int32,
                          device=slots.device)
    err = lib.a2_fm(slots.data_ptr(), arr.data_ptr(), state.data_ptr(),
                    sine.data_ptr(), scratch.data_ptr(), S, K, structkey,
                    int(bool(add)), dch, _stream())
    build.launch_check(err, "earlier fm")


def old_fbd_dense(lib, x, g, buf, fb, C):
    npad = x.shape[1]
    ofb = torch.empty((2, npad), dtype=torch.int32, device=x.device)
    err = lib.a2_fbd_dense(x.data_ptr(), g.data_ptr(), buf.data_ptr(),
                           ofb.data_ptr(), npad, C * FB.FRAG, fb, _stream())
    build.launch_check(err, "earlier fbdelay dense")
    return ofb


def old_fbd_legacy(lib, x, arr, starts, ring, C):
    NS = arr.shape[0]
    ofb = torch.empty((2, NS, FB.FRAG), dtype=torch.int32, device=x.device)
    wbuf = torch.empty_like(ofb)
    err = lib.a2_fbd_legacy(x.data_ptr(), arr.data_ptr(), starts.data_ptr(),
                            ring.data_ptr(), ofb.data_ptr(), wbuf.data_ptr(),
                            NS, C, _stream())
    build.launch_check(err, "earlier fbdelay legacy")
    return ofb


def graph_ms(fn, reps=10, rounds=3):
    """Device ms of one call of fn(): after an eager warm-up, `reps`
    calls captured into one CUDA graph (their launch counts discarded),
    the graph replayed once, then `rounds` replays timed with CUDA
    events; the mean per call."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with build.captured_launches(), torch.cuda.stream(side):
        g.capture_begin(capture_error_mode="relaxed")
        try:
            for _ in range(reps):
                fn()
        finally:
            g.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        g.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (rounds * reps)


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


def seeded_i32(gen, shape):
    return torch.randint(-(1 << 27), 1 << 27, shape, dtype=torch.int32,
                         device="cuda", generator=gen)


def fbdelay_items(gen, rng):
    """The fbdelay items: [(label, form, inputs, fb or None, chunk)],
    form "dense" with inputs (x, g, tail), "legacy" with (x, arr,
    starts, ring)."""
    items = []
    prog = first_program("effects", 2)
    slots = seeded_i32(gen, (prog.ninst * prog.F + 1, 2, FB.FRAG))
    for fd in prog.fbdelays:
        C = fd["chunk"]
        sig = (fd["stereoin"], fd["stereoout"], fd["add"], C) + fd["fbpar"]
        x, g, _ = FB.fbd_dense_inputs(
            slots, sig, torch.as_tensor(fd["arr"], device="cuda"), prog.F)
        items.append(("effects dense", "dense",
                      (x, g, seeded_i32(gen, (2, FB.FBD_TAIL))),
                      fd["fbpar"][0], C))
    prog = first_program("late_fbdelay", 1)
    slots = seeded_i32(gen, (prog.ninst * prog.F + 1, 2, FB.FRAG))
    for fd in prog.fbdelays:
        C = fd["chunk"]
        a = torch.as_tensor(fd["arr"], device="cuda")
        x, starts = FB.fbd_legacy_inputs(
            slots, (fd["stereoin"], fd["stereoout"], fd["add"], C), a,
            12345)
        items.append(("late legacy", "legacy",
                      (x, a, (starts & (FB.FBD_BUFSIZE - 1)).to(torch.int32),
                       seeded_i32(gen, (2, FB.FBD_BUFSIZE))), None, C))
    F = SUPERBLOCK_FRAMES // FB.FRAG
    for fb in (64, FB.FBD_TAIL):
        x, g, tail, C = FB.seeded_dense_loop(rng, F, fb, "cuda")
        items.append(("seeded dense fb %d" % fb, "dense", (x, g, tail), fb,
                      C))
    x, a, starts, ring = FB.seeded_legacy_loop(rng, 1, F, "cuda")
    items.append(("seeded legacy C 1", "legacy", (x, a, starts, ring), None,
                  1))
    return items


def fbdelay_ab(old, gen, rng, reps):
    """Earlier and current fbdelay kernels on every item of
    fbdelay_items; returns the item records."""
    lib = old["fbdelay_kernel"]
    recs = []
    for label, form, inp, fb, C in fbdelay_items(gen, rng):
        if form == "dense":
            x, g, tail = inp
            npad = x.shape[1]

            def state():
                buf = torch.empty((2, FB.FBD_TAIL + npad), dtype=torch.int32,
                                  device="cuda")
                buf[:, :FB.FBD_TAIL] = tail
                return buf

            def new(buf, x=x, g=g, fb=fb, C=C):
                return FB.fbd_dense_call(x, g, buf, fb, C)

            def older(buf, x=x, g=g, fb=fb, C=C):
                return old_fbd_dense(lib, x, g, buf, fb, C)
            shape = "npad %d, fb %d, C %d: %d links per chain (was %d " \
                "steps)" % (npad, fb, C, -(-npad // fb), npad // (C * 64))
        else:
            x, a, starts, ring0 = inp
            NS = a.shape[0]

            def state(ring0=ring0):
                return ring0.clone()

            def new(ring, x=x, a=a, starts=starts, C=C):
                return FB.fbd_legacy_call(x, a, starts, ring, C)

            def older(ring, x=x, a=a, starts=starts, C=C):
                return old_fbd_legacy(lib, x, a, starts, ring, C)
            shape = "NS %d, C %d: %d steps" % (NS, C, NS // C)
        res = []
        for fn in (older, new):
            st = state()
            ofb = fn(st)
            torch.cuda.synchronize()
            res.append((ofb.cpu(), st.cpu()))
        bad = sum(int((p != q).sum()) for p, q in zip(*res))
        times = {"old": [], "new": []}
        st = state()
        for which, fn in (("old", older), ("new", new), ("new", new),
                          ("old", older)):
            times[which].append(graph_ms(lambda: fn(st), reps))
        recs.append({"item": label, "form": form, "shape": shape,
                     "mismatches": bad, "old_ms": times["old"],
                     "new_ms": times["new"],
                     "speedup": float(np.mean(times["old"])
                                      / np.mean(times["new"]))})
        print("%-20s %s: earlier %s ms, current %s ms (%.1fx), %d "
              "mismatches" % (label, shape,
                              " / ".join("%.4f" % t for t in times["old"]),
                              " / ".join("%.4f" % t for t in times["new"]),
                              recs[-1]["speedup"], bad), flush=True)
    return recs


def item_ab(kind, S, K, older, new, slots0, reps, note, **extra):
    """An item's earlier and current kernels, fn(slots, state), from
    the same slots and a fresh state: results compared, then each timed
    in the order earlier, current, current, earlier; returns the
    record."""
    dev = slots0.device
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
        times[which].append(graph_ms(lambda: fn(s, st), reps))
    rec = dict(kind=kind, S=int(S), K=int(K), mismatches=bad,
               old_ms=times["old"], new_ms=times["new"],
               speedup=float(np.mean(times["old"])
                             / np.mean(times["new"])), **extra)
    print("%-4s S%d K%d %s: earlier %s ms, current %s ms (%.1fx), %d "
          "mismatches" % (kind, S, K, note,
                          " / ".join("%.4f" % t for t in times["old"]),
                          " / ".join("%.4f" % t for t in times["new"]),
                          rec["speedup"], bad), flush=True)
    return rec


def float_ab(old, gen, reps, clock):
    """Earlier and current float-tier kernels on the effects song's
    limiter / filter12 / dcblock items, and the current kernel's phases
    from the clock build; returns the item records."""
    prog = first_program("effects", 2)
    dev = torch.device("cuda")
    slots0 = seeded_i32(gen, (prog.ninst * prog.F + 1, 2, FL.FRAG))
    recs = []
    for fl in prog.filters:
        kind, sig = fl["kind"], fl["key"][3:8]
        if kind not in FL.KINDS:
            continue
        arr = torch.as_tensor(fl["arr"], device=dev)
        S, K = arr.shape[:2]

        def new(s, st, kind=kind, sig=sig, arr=arr):
            FF.filter_float_call(s, kind, sig, arr, st)

        def older(s, st, kind=kind, sig=sig, arr=arr):
            old_filter_float(old["filter_float_kernel"], s, kind, sig, arr,
                             st)
        nbytes, nops = FF.work(fl["arr"], kind, *sig[:3])
        pl = FF.plan(kind, sig, S, K, dev)
        ck = clock_item(clock, slots0.clone(), kind, sig, arr,
                        FL.init_state(kind, K, dev))
        print("%-4s phases (ns; first block / last block): %s"
              % (kind, ", ".join("%s %.0f / %.0f" % (p, ck["first"][p],
                                                      ck["last"][p])
                                 for p in CLOCK_PHASES)), flush=True)
        recs.append(item_ab(
            kind, S, K, older, new, slots0, reps,
            "float tier (%d blocks x %d tiles)" % (pl["blocks"],
                                                   pl["tiles_per_block"]),
            plan=pl, bytes=nbytes, ops=nops,
            bound_ms=max(nbytes / HBM_BYTES_S, nops / FP32_OPS_S) * 1e3,
            clock_ns=ck))
    return recs


def filter_fm_ab(old, gen, reps, kernels):
    """Earlier and current filter / fm kernels on the effects song's
    items; returns (item records, host step-group ms per run)."""
    prog = first_program("effects", 2)
    dev = torch.device("cuda")
    slots0 = seeded_i32(gen, (prog.ninst * prog.F + 1, 2, FL.FRAG))
    sine = torch.as_tensor(FM.sine_pairs(), device=dev)
    items = [fl for fl in prog.filters
             if ("fm" if fl["kind"] == "fm" else "filter") in kernels]
    t_groups = []
    for _ in range(20):
        t0 = time.perf_counter()
        for fl in items:
            key = fl["key"]
            if fl["kind"] == "fm":
                FM.groups(fl["arr"], (key[3], key[4], key[5][0]))
            else:
                FL.groups(fl["arr"], key[3:8])
        t_groups.append((time.perf_counter() - t0) * 1e3)
    recs = []
    for fl in items:
        kind, key = fl["kind"], fl["key"]
        arr = torch.as_tensor(fl["arr"], device=dev)
        S, K = arr.shape[:2]
        if kind == "fm":
            sig = (key[3], key[4], key[5][0])
            bounds = FM.groups(fl["arr"], sig)
            b = torch.as_tensor(FL.pack_bounds(bounds, S), device=dev)

            def new(s, st, sig=sig, arr=arr, b=b):
                FM.fm_call(s, sig, arr, st, sine, b)

            def older(s, st, sig=sig, arr=arr):
                old_fm(old["fm_kernel"], s, sig, arr, st, sine)
        else:
            sig = key[3:8]
            bounds = FL.groups(fl["arr"], sig)
            b = torch.as_tensor(FL.pack_bounds(bounds, S), device=dev)

            def new(s, st, kind=kind, sig=sig, arr=arr, b=b):
                FL.filter_call(s, kind, sig, arr, st, b)

            def older(s, st, kind=kind, sig=sig, arr=arr):
                old_filter(old["filter_kernel"], s, kind, sig, arr, st)
        recs.append(item_ab(kind, S, K, older, new, slots0, reps,
                            "%d groups" % (len(bounds) - 1),
                            groups=len(bounds) - 1))
    print("host step groups of the superblock's %d items: median %.3f ms "
          "(min %.3f, max %.3f over 20 runs)"
          % (len(items), float(np.median(t_groups)), min(t_groups),
             max(t_groups)))
    return recs, t_groups


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", required=True)
    ap.add_argument("--kernels", default="fbdelay",
                    help="comma-separated: fbdelay, filter, fm, "
                         "filter_float")
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args(argv)
    kernels = set(a.kernels.split(","))
    if not kernels <= {"fbdelay", "filter", "fm", "filter_float"}:
        ap.error("unknown kernels: %s" % a.kernels)
    if not torch.cuda.is_available():
        print("tail_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    clock = None
    if "filter_float" in kernels:
        clock = start_clock_build(os.path.join(a.old_csrc, "build"))
    old = build_old(a.old_csrc, os.path.join(a.old_csrc, "build"),
                    [k + "_kernel" for k in sorted(kernels)])
    build.build()
    if clock is not None:
        clock = load_clock(*clock)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    out = {"card": card}
    if "fbdelay" in kernels:
        out["fbdelay"] = fbdelay_ab(old, gen, np.random.default_rng(8),
                                    a.reps)
    if kernels & {"filter", "fm"}:
        out["items"], out["host_groups_ms"] = filter_fm_ab(old, gen, a.reps,
                                                           kernels)
    if "filter_float" in kernels:
        out["float_items"] = float_ab(old, gen, a.reps, clock)
    print(json.dumps(out))
    bad = [r for k in ("fbdelay", "items", "float_items")
           for r in out.get(k, ()) if r["mismatches"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
