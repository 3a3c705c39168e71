"""Times this checkout's renders against another checkout of the port.

    python3 -m audiality2_tpu_torch.render_ab --other DIR
        [--songs slice,effects] [--seconds 10] [--reps 3] [--rounds 2]

DIR is the root of another checkout, for example the parent commit
unpacked with ``git archive`` into ``_archive/`` (listed in
``.gitignore``).  Each round runs this checkout, the other, the other
and this one again (ABBA), each in a fresh process on the card.  A
process builds what it needs (``native/build.sh`` where
``native/liba2rt.so`` is missing, the kernels at first use), renders
each song once per mode to warm up, then `reps` times per mode in
turn, each render with a fresh ``DeviceRenderer`` (stereo, superblocks
of ``SUPERBLOCK_FRAMES``), and holds every output against the native
renderer bit for bit.  The modes: ``run`` (``DeviceRenderer.run`` per
superblock, the synchronous render) and, in a checkout whose renderer
takes ``pipeline_depth``, ``render`` (the pipelined render with its
profile pass, ``chain_dispatch=4``).

Prints the card's name and power limit, then per checkout, song and
mode the wall seconds and x realtime of every render; the last line is
the same as one JSON object, also written to
``chiprun_out/render_ab.json``.  Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys

# run in each checkout's root (python3 -c): prints one JSON line of
# {song: {mode: [wall s, ...]}}
WORKER = r"""
import inspect, json, sys, time
import numpy as np
import torch
import audiality2_tpu_torch as a2t
from audiality2_tpu_torch.engine.device_render import (DeviceRenderer,
                                                       SUPERBLOCK_FRAMES)
from audiality2_tpu_torch.native import NativeRenderer
from audiality2_tpu_torch.songs import SONGS

songs, seconds, reps = sys.argv[1].split(","), float(sys.argv[2]), \
    int(sys.argv[3])
SB = SUPERBLOCK_FRAMES
frames = int(seconds * 44100)
nsb = -(-frames // SB)
pipelined = "pipeline_depth" in inspect.signature(
    DeviceRenderer.__init__).parameters
modes = ["run", "render"] if pipelined else ["run"]


def opened(name, cls, **kw):
    # the song is loaded before the renderer is made, which snapshots
    # the engine's programs and waves
    src, program = SONGS[name]
    i = a2t.open_engine(44100, 4096, 2, batched=False)
    song = i.get(i.load_string(src, name), program)
    r = cls(i, channels=2, **kw)
    r.timestamp_reset()
    r.start(0, song)
    return r


def once(name, mode, want):
    kw = {"chain_dispatch": 4} if pipelined else {}
    r = opened(name, DeviceRenderer, device="cuda", **kw)
    if hasattr(r, "wait_device"):
        r.wait_device()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if mode == "run":
        out = np.concatenate([r.run(SB) for _ in range(nsb)], axis=1)
    else:
        out = r.render(frames, bufsize=SB)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if r.fell_back or not np.abs(want).max() \
            or int((out[:, :frames] != want).sum()):
        raise SystemExit("%s %s: the render differs from native" % (name,
                                                                     mode))
    r.close()
    return wall


res = {}
for name in songs:
    nat = opened(name, NativeRenderer)
    want = np.concatenate([nat.run(SB) for _ in range(nsb)],
                          axis=1)[:, :frames]
    nat.close()
    for mode in modes:
        once(name, mode, want)                      # warm-up
    res[name] = {m: [] for m in modes}
    for _ in range(reps):
        for mode in modes:
            res[name][mode].append(once(name, mode, want))
print(json.dumps(res))
"""


def _run_tree(root, a):
    if not os.path.exists(os.path.join(root, "native", "liba2rt.so")):
        subprocess.run(["sh", os.path.join(root, "native", "build.sh")],
                       cwd=os.path.join(root, "native"), check=True,
                       capture_output=True, timeout=600)
    p = subprocess.run([sys.executable, "-c", WORKER, a.songs,
                        str(a.seconds), str(a.reps)], cwd=root,
                       capture_output=True, text=True, timeout=1200)
    if p.returncode:
        raise RuntimeError("render_ab worker in %s failed:\n%s%s"
                           % (root, p.stdout[-4000:], p.stderr[-4000:]))
    return json.loads(p.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--songs", default="slice,effects")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("render_ab: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"this": here, "other": os.path.abspath(a.other)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi failed"
    print("card: %s" % card, flush=True)
    walls = {t: {} for t in trees}     # tree -> song -> mode -> [s]
    for rnd in range(a.rounds):
        for t in ("this", "other", "other", "this"):
            res = _run_tree(trees[t], a)
            for song, modes in res.items():
                for mode, ws in modes.items():
                    walls[t].setdefault(song, {}).setdefault(
                        mode, []).extend(ws)
            print("round %d, %s: %s" % (rnd, t, json.dumps(res)),
                  flush=True)
    for t, songs in walls.items():
        for song, modes in songs.items():
            for mode, ws in modes.items():
                print("%-5s %-8s %-6s wall s %s | x realtime %s" % (
                    t, song, mode, " ".join("%.4f" % w for w in ws),
                    " ".join("%.1f" % (a.seconds / w) for w in ws)))
    out = {"card": card, "trees": trees, "seconds": a.seconds,
           "wall_s": walls}
    out_dir = os.path.join(here, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "render_ab.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
