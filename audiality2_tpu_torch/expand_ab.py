"""The run-expansion kernel against an earlier form of it, on the card.

    python3 -m audiality2_tpu_torch.expand_ab [--old-csrc DIR] [--reps 10]

Takes the first superblock (2752x64 frames, stereo) of the slice song
(plain run and ramp tables) and of the effects song (packed runs) on a
profiled mixer, and times ``expand.expand_call`` there (``graph_ms``:
``reps`` calls captured into one CUDA graph).  With ``--old-csrc DIR``,
DIR's ``expand_kernel.cu`` (an earlier source with the same C
interface, or with the first form's, whose class-0 rows render in its
second launch and which takes no ``row0`` scratch; for instance ``git
archive <commit>
audiality2_tpu_torch/cuda/csrc`` unpacked into a directory that
``.gitignore`` lists) is built with nvcc beside it, both forms must give
the same parameters, slot indices and slots, and they are timed in the
order earlier, current, current, earlier.

Then the whole of ``TorchMixer._expand`` (the kernel, an oscillator
launch per pass class and the pass classes' adds into the slots) with
each of four forms of the adds, all bit-equal: the oscillator's slots
epilogue (``osc_slots_call``, the mixer's), and after ``osc_call``
``index_add_`` of the oscillator's transposed output (the mixer's
before), of a contiguous copy of it, and along the slot axis of
transposed slots.

Then the current kernel on the same tables with a part of its work
taken away, to show each part's share: no ramp table (no replay), the
class-0 block relabelled as a pass class (no class-0 audio), both, and
one class block of 128 rows (the run-order launch, one block and the
launch floors).  These outputs are not the expansion's; only their
times are read.

Prints the card's name and power limit, one line per superblock and
one JSON object last (also written to chiprun_out/expand_ab.json);
exits 1 on a mismatch.  Needs a CUDA device.
"""

import argparse
import copy
import ctypes
import json
import os
import subprocess
import sys

import torch

from .cuda import build
from .cuda import expand as EX
from .cuda import osc_kernel as OK
from .cuda.mixer import blob_layout, blob_views
from .engine.device_render import DeviceRenderer, SUPERBLOCK_FRAMES
from .shard_scaling import card_line
from .songs import SONGS
from .tail_ab import graph_ms
from . import open_engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def superblock_args(song, device):
    """(expand_call's arguments for `song`'s first superblock on a
    profiled card mixer (the packed format where the song packs), the
    mixer, the signature)."""
    src, program = SONGS[song]
    i = open_engine(44100, 4096, 2, batched=False)
    # the script loads before the renderer is made (see the CLI)
    s = i.get(i.load_string(src, song), program)
    r = DeviceRenderer(i, channels=2, device=device)
    r.timestamp_reset()
    r.start(0, s)
    prog = r.record_program(SUPERBLOCK_FRAMES)
    r.close()
    m = r.mixer
    m.observe(prog)
    sig, blob, _, _ = m._prepare(copy.deepcopy(prog))
    v = blob_views(torch.from_numpy(blob).to(device), blob_layout(sig)[0])
    slots = torch.zeros((sig[1] * sig[0] + 1, 2, 64), dtype=torch.int32,
                        device=device)
    return m._expand_args(sig, v, slots), m, sig


def _add_transposed(slots, idx, res, mono):
    EX.add_rows(slots, idx, res.t(), mono)


def _add_copy(slots, idx, res, mono):
    EX.add_rows(slots, idx, res.t().contiguous(), mono)


def _add_slot_axis(slots, idx, res, mono):
    flat = slots[:, 0] if mono else slots.view(slots.shape[0], 128)
    flat.t().index_add_(1, idx, res)


# the pass classes' adds into the slots: None adds inside the
# oscillator (osc_slots_call); the others take osc_call's output, int32
# [C*64, P], one column per row
ADD_FORMS = {"the oscillator's slots epilogue": None,
             "index_add_ of the transposed output": _add_transposed,
             "a contiguous copy, then index_add_": _add_copy,
             "index_add_ along the slot axis": _add_slot_axis}


def whole_expand(args, m, sig, add):
    """TorchMixer._expand with `add` for the pass classes' adds (None:
    the oscillator's slots epilogue, as the mixer)."""
    mono = args[1]
    classes, slot_r = EX.expand_call(*args)
    for cls, tb, par, b0 in classes:
        sl = slot_r[b0:b0 + par.shape[1]]
        if add is None:
            OK.osc_slots_call(cls, tb, par, m._atlas_dev, args[7], sl,
                              quality=sig[10] & 15, fused_pm=True,
                              mono=mono)
        else:
            add(args[7], sl, OK.osc_call(cls, tb, par, m._atlas_dev,
                                         quality=sig[10] & 15,
                                         fused_pm=True, mono=mono), mono)


class _TwoLaunches:
    """An earlier library whose a2_expand renders the class-0 rows in its
    second launch and so takes no row0 scratch: the current call's
    arguments without it."""

    def __init__(self, lib):
        self.lib = lib

    def a2_expand(self, *args):
        return self.lib.a2_expand(*(args[:-2] + args[-1:]))


def build_old(csrc, out_dir):
    """DIR's expand_kernel.cu built for sm_90a and bound like the
    current library (or, for the two-launch interface, through
    _TwoLaunches)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "libexpand_old.so")
    src = os.path.join(csrc, "expand_kernel.cu")
    r = subprocess.run([build._nvcc()] + build.NVCC_FLAGS + [
        "-o", path, src],
        capture_output=True, text=True, timeout=build.BUILD_TIMEOUT_S)
    if r.returncode:
        raise RuntimeError("nvcc failed on %s:\n%s" % (csrc, r.stdout
                                                       + r.stderr))
    lib = ctypes.CDLL(path)
    EX._bind(lib)
    with open(src) as f:
        if "void* row0" in f.read():
            return lib
    types = list(lib.a2_expand.argtypes)
    lib.a2_expand.argtypes = types[:-2] + types[-1:]
    return _TwoLaunches(lib)


def outputs(load, args):
    """(params of each pass class, slot_r, slots) of one call on a copy of
    the slots."""
    slots = args[7].clone()
    classes, slot_r = EX._expand(load, *args[:7], slots)
    return [p for _, _, p, _ in classes] + [slot_r, slots]


def ablations(args):
    """The current kernel's arguments with parts of its work taken away,
    by name."""
    rows_sig, tbases = args[0], args[5]
    relabel = tuple((c or 1, nb) for c, nb in rows_sig)
    return {"no ramps": args[:4] + (None,) + args[5:],
            "no class-0 audio": (relabel,) + args[1:],
            "neither": (relabel,) + args[1:4] + (None,) + args[5:],
            "one block": (((1, 1),),) + args[1:5]
            + ([tbases[0][:1].contiguous()],) + args[6:]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", default=None)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("expand_ab: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    build.build()
    old = build_old(a.old_csrc, os.path.join(
        ROOT, "chiprun_out", "expand_ab_build")) if a.old_csrc else None
    cur = EX._load
    res = {"card": card, "songs": {}}
    bad = 0
    for song in ("slice", "effects"):
        args, m, sig = superblock_args(song, a.device)
        buf = args[7].clone()
        row = {"rows": int(sum(nb * 128 for _, nb in args[0])),
               "runs": args[3][0], "ramps": args[4] and args[4][0]}

        def timed(load, xargs=args):
            return graph_ms(lambda: EX._expand(load, *xargs[:7], buf),
                            reps=a.reps)
        if old is not None:
            for x, y in zip(outputs(lambda: old, args), outputs(cur, args)):
                bad += int((x != y).sum())
            order = (("earlier", lambda: old), ("current", cur),
                     ("current", cur), ("earlier", lambda: old))
            for label, load in order:
                row.setdefault(label + "_ms", []).append(timed(load))
        else:
            row["current_ms"] = [timed(cur)]
        whole = {}
        for name, add in ADD_FORMS.items():
            slots = args[7].clone()
            whole_expand(args[:7] + (slots,), m, sig, add)
            whole[name] = slots
        ref = whole[next(iter(ADD_FORMS))]
        bad += sum(int((x != ref).sum()) for x in whole.values())
        row["expand_ms"] = {name: graph_ms(
            lambda add=add: whole_expand(args[:7] + (buf,), m, sig, add),
            reps=a.reps) for name, add in ADD_FORMS.items()}
        row["parts_ms"] = {k: timed(cur, xa)
                           for k, xa in ablations(args).items()}
        res["songs"][song] = row
        print("%s superblock 0 (%d rows, runs %s, ramps %s): %s; parts %s"
              % (song, row["rows"], row["runs"], row["ramps"], "; ".join(
                  "%s %s ms" % (k[:-3], " / ".join("%.4f" % t for t in v))
                  for k, v in row.items() if k.endswith("_ms")
                  and isinstance(v, list)), ", ".join(
                  "%s %.4f ms" % kv for kv in row["parts_ms"].items())),
              flush=True)
        print("  _expand: %s" % ", ".join(
            "%s %.4f ms" % kv for kv in row["expand_ms"].items()),
            flush=True)
    res["mismatches"] = bad
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "expand_ab.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    if bad:
        print("expand_ab: %d values differ between the two forms" % bad,
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
