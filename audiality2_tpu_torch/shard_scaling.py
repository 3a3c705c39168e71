"""Shard scaling of the sharded render on one card.

Runs ``parallel.render_sharded`` in process at 1, 2, 4 and 8 shards, all
on one card (a device may repeat), and reports the wall time per steady
superblock, split into each shard's expansion, the slot sum and the
stage tail (device time between CUDA events on the compute stream; the
shards run one after another there).  Each shard count renders twice
with one shared ``cache``: the first render settles the sticky pads and
loads the kernels, the second is measured, and both must equal native.

On one card the shards do not run at once: the expansion's eager
launches repeat once per shard, so the wall time per superblock grows
with the shard count.  What the split shows is each part's share: the
per-shard expansion (what each card of a multi-card run would do), the
sum (what the collective replaces) and the serial tail.

    python3 -m audiality2_tpu_torch.shard_scaling [--song effects]
        [--seconds 10] [--shards 1,2,4,8] [--device cuda] [--profile 4]

``--profile N`` also traces one render at N shards with torch.profiler
and prints the kernels with the most device time per superblock.

Prints the card's name and power limit, a table, and one JSON line; also
writes chiprun_out/shard_scaling.json in the checkout.
"""

import argparse
import json
import os
import subprocess
import time

import numpy as np

SR = 44100
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def summarize(timings):
    """The steady part of a render's per-superblock timings
    (``render_sharded(timings=...)``; the first superblock, which loads
    kernels and sizes buffers, left out): {superblocks, wall_ms,
    expand_ms (mean per shard), expand_total_ms, sum_ms, tail_ms}, each
    a mean per superblock."""
    steady = timings[1:] or timings
    ex = np.asarray([t["expand"] for t in steady], np.float64)
    return {"superblocks": len(steady),
            "wall_ms": float(np.mean([t["wall_s"] for t in steady])) * 1e3,
            "expand_ms": [float(x) for x in ex.mean(axis=0)],
            "expand_total_ms": float(ex.sum(axis=1).mean()),
            "sum_ms": float(np.mean([t["sum"] for t in steady])),
            "tail_ms": float(np.mean([t["tail"] for t in steady]))}


def card_line():
    """nvidia-smi's name and power limit of the card, or a note."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60, check=True)
        return r.stdout.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def _song(song, channels):
    from . import open_engine
    from .songs import SONGS
    src, program = SONGS[song]
    i = open_engine(SR, 4096, channels, batched=False)
    return i, i.get(i.load_string(src, song), program)


def native(song, channels, frames, bufsize):
    """Native render over the same superblocks, trimmed to `frames`."""
    from .native import NativeRenderer
    i, s = _song(song, channels)
    nr = NativeRenderer(i, channels=channels)
    nr.timestamp_reset()
    nr.start(0, s)
    out = np.concatenate([nr.run(bufsize)
                          for _ in range(-(-frames // bufsize))],
                         axis=1)[:, :frames]
    nr.close()
    return out


def run(song="effects", seconds=10.0, shards=(1, 2, 4, 8), device="cuda",
        channels=2, bufsize=None):
    """{n: summarize(...) plus "render_s"} of the steady render at each
    shard count; raises AssertionError when a render leaves native."""
    import torch
    from .parallel import DEFAULT_BUFSIZE, render_sharded
    frames = int(seconds * SR)
    bufsize = bufsize or min(frames, DEFAULT_BUFSIZE)
    bufsize -= bufsize % 64
    want = native(song, channels, frames, bufsize)
    rows = {}
    for n in shards:
        cache = {}
        for _ in range(2):          # settle the pads, then measure
            i, s = _song(song, channels)
            tm = []
            t0 = time.perf_counter()
            out = render_sharded(i, s, frames, n_devices=n, bufsize=bufsize,
                                 channels=channels, devices=[device] * n,
                                 cache=cache, timings=tm)
            if device != "cpu":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            bad = int((out != want).sum())
            assert bad == 0, "%d shards: %d samples differ from native" \
                % (n, bad)
        rows[n] = dict(summarize(tm), render_s=dt)
    return rows


def _dev_us(evt):
    """A device event's microseconds (the name moved between torch
    releases)."""
    for name in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profile(song, seconds, n, channels=2, top=12):
    """torch.profiler over one steady render at n shards on the card
    (after one that settles the pads): the kernels with the most device
    time, as [(name, launches, device ms per superblock)], the device ms
    per superblock in all, and the superblocks."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    from .parallel import DEFAULT_BUFSIZE, render_sharded
    frames = int(seconds * SR)
    bufsize = min(frames, DEFAULT_BUFSIZE)
    bufsize -= bufsize % 64
    nsb = -(-frames // bufsize)
    cache = {}

    def render():
        i, s = _song(song, channels)
        render_sharded(i, s, frames, n_devices=n, bufsize=bufsize,
                       channels=channels, devices=["cuda"] * n, cache=cache)
        torch.cuda.synchronize()

    render()                          # settle the pads
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        render()
    evs = [e for e in prof.key_averages() if _dev_us(e) > 0]
    evs.sort(key=_dev_us, reverse=True)
    total = sum(_dev_us(e) for e in evs) / 1e3 / nsb
    return ([(e.key, int(e.count), _dev_us(e) / 1e3 / nsb)
             for e in evs[:top]], total, nsb)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--song", default="effects")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--shards", default="1,2,4,8")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--channels", type=int, default=2)
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="also trace one render at N shards with "
                         "torch.profiler (the card only)")
    a = ap.parse_args(argv)
    card = card_line()
    print(card, flush=True)
    shards = tuple(int(x) for x in a.shards.split(","))
    rows = run(a.song, a.seconds, shards, a.device, a.channels)
    print("| shards | wall ms / superblock | expansion ms per shard "
          "(mean) | expansion ms, all shards | sum ms | tail ms |")
    print("|---|---|---|---|---|---|")
    for n, r in rows.items():
        print("| %d | %.3f | %.3f | %.3f | %.3f | %.3f |"
              % (n, r["wall_ms"], float(np.mean(r["expand_ms"])),
                 r["expand_total_ms"], r["sum_ms"], r["tail_ms"]))
    res = {"card": card, "song": a.song, "seconds": a.seconds,
           "channels": a.channels, "device": a.device, "shards": rows}
    if a.profile:
        kern, total, nsb = profile(a.song, a.seconds, a.profile, a.channels)
        print("torch.profiler, %d shards, %d superblocks: device ms per "
              "superblock %.3f; top kernels (launches, device ms per "
              "superblock):" % (a.profile, nsb, total))
        for name, cnt, ms in kern:
            print("  %8.3f  %6d  %s" % (ms, cnt, name[:100]))
        res["profile"] = {"shards": a.profile, "device_ms_per_superblock":
                          total, "top": kern}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "shard_scaling.json"),
              "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
