"""Where a render's time goes on the card.

    python3 -m audiality2_tpu_torch.profile_render [--song slice|effects]
        [--seconds 10] [--channels 2] [--top 15]
        [--pipelined [--chain N]] [--serve K]

Renders a song of ``songs.py`` (the slice song by default) three times:
to warm up, timed, and under ``torch.profiler``.  By default the render
is synchronous (``DeviceRenderer.run`` per superblock: a signature's
first superblock runs its body eagerly, later ones launch its graph);
``--pipelined`` renders with ``render`` (profile pass, one signature
captured ahead, the pipeline) and ``--chain N`` superblocks per graph
launch.  ``--serve K`` renders K streams of the song
(transposed apart) through ``serve.render_multiplexed`` (batch 2)
instead, and reports the aggregate.

Prints the unprofiled render's wall time and host seconds per render
phase (record, build, mix, fetch), the graph captures (host seconds
running the bodies under capture and instantiating), the device time
summed over the CUDA kernels of the profiled render and its share of
the unprofiled wall time (the rest is the device's idle share; the
profiler's own overhead inflates the profiled wall time, not the
kernels' device time), graph launches and kernel launches per
superblock (and those of each of the port's own kernels, counted by
their wrappers), and the kernels that take the most device time; the
last line is the same as one JSON object.  Needs a CUDA device.
"""

import argparse
import json
import subprocess
import sys
import time

import torch

from . import open_engine
from .cuda import filter as FL
from .cuda.mixer import KERNEL_WRAPPERS
from .engine.device_render import DeviceRenderer, SUPERBLOCK_FRAMES
from .songs import SONGS


def _renderer(name, channels, a, args=()):
    src, program = SONGS[name]
    i = open_engine(44100, 4096, channels, batched=False)
    song = i.get(i.load_string(src, name), program)
    r = DeviceRenderer(i, channels=channels, device="cuda",
                       chain_dispatch=a.chain)
    r.timestamp_reset()
    r.start(0, song, *args)
    r.wait_device()
    return r


def _render(name, seconds, channels, a, profiler=None):
    """One render; returns (wall s, stats dict)."""
    frames = int(seconds * 44100)
    nsb = -(-frames // SUPERBLOCK_FRAMES)
    if a.serve:
        from . import serve
        jobs = []
        for k in range(a.serve):
            src, program = SONGS[name]
            i = open_engine(44100, 4096, channels, batched=False)
            jobs.append(serve.StreamJob(
                i, i.get(i.load_string(src, name), program), frames,
                args=(0.25 * k,) if name == "effects" else (),
                channels=channels))

        def go():
            serve.render_multiplexed(jobs, bufsize=SUPERBLOCK_FRAMES,
                                     batch=2)
    else:
        r = _renderer(name, channels, a)

        def go():
            if a.pipelined:
                r.render(frames, bufsize=SUPERBLOCK_FRAMES)
            else:
                for _ in range(nsb):
                    r.run(SUPERBLOCK_FRAMES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if profiler is None:
        go()
    else:
        with profiler:
            go()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rs = [j.renderer for j in jobs] if a.serve else [r]
    if any(x.fell_back or x.bridged_frames for x in rs):
        raise RuntimeError("the render bridged natively")
    m = rs[0].mixer
    st = {"phases_s": dict(rs[0].timings), "graph_launches": m.replays,
          "captures": m.capture_log}
    if a.serve:
        st["phases_s"] = {k: sum(x.timings[k] for x in rs)
                          for k in rs[0].timings}
    for x in rs:
        x.close()
    return wall, st


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--song", choices=("slice", "effects"), default="slice")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--channels", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--pipelined", action="store_true")
    ap.add_argument("--chain", type=int, default=1)
    ap.add_argument("--serve", type=int, default=0)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_render: no CUDA device", file=sys.stderr)
        return 2
    _render(a.song, a.seconds, a.channels, a)            # warm-up
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    FL.filter_call.kind_launches = dict.fromkeys(FL.KINDS, 0)
    plain_wall, st = _render(a.song, a.seconds, a.channels, a)
    own = {k: fn.launches for k, fn in KERNEL_WRAPPERS.items()}
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof_wall, _ = _render(a.song, a.seconds, a.channels, a, prof)
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(_device_us(e) for e in kernels) * 1e-6
    nlaunch = sum(e.count for e in kernels)
    streams = max(1, a.serve)
    nsb = streams * -(-int(a.seconds * 44100) // SUPERBLOCK_FRAMES)
    audio_s = streams * a.seconds
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    mode = ("served x%d (render_multiplexed, batch 2)" % a.serve
            if a.serve else "pipelined, chain %d" % a.chain if a.pipelined
            else "synchronous (run per superblock)")
    print("card: %s (%s)" % (torch.cuda.get_device_name(0),
                             smi.stdout.strip().splitlines()[0]
                             if smi.returncode == 0 else "nvidia-smi failed"))
    print("render %s song, %.1f s audio x %d, %d ch, %d superblocks, %s: "
          "%.4f s unprofiled (%.1f x realtime), %.4f s profiled"
          % (a.song, a.seconds, streams, a.channels, nsb, mode, plain_wall,
             audio_s / plain_wall, prof_wall))
    print("phases (unprofiled, host s): " + ", ".join(
        "%s %.4f" % kv for kv in st["phases_s"].items()))
    print("graph captures: %s" % ", ".join(
        "%d bodies: run %.4f s, end %.4f s" % (c["bodies"], c["run_s"],
                                               c["end_s"])
        for c in st["captures"]))
    print("device busy %.4f s = %.1f%% of the unprofiled wall time; "
          "%d graph launches; %d kernel launches (%.0f per superblock); "
          "the port's kernels: %s"
          % (busy_s, 100 * busy_s / plain_wall, st["graph_launches"],
             nlaunch, nlaunch / nsb,
             ", ".join("%s %d" % kv for kv in own.items())))
    top = sorted(kernels, key=_device_us, reverse=True)[:a.top]
    for e in top:
        print("  %9.3f ms %6d x  %s" % (_device_us(e) * 1e-3, e.count,
                                        e.key[:100]))
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "song": a.song,
        "mode": mode, "seconds": a.seconds, "streams": streams,
        "channels": a.channels, "superblocks": nsb,
        "wall_s": plain_wall, "profiled_wall_s": prof_wall,
        "x_realtime": audio_s / plain_wall, "phases_s": st["phases_s"],
        "captures": st["captures"], "graph_launches": st["graph_launches"],
        "device_busy_s": busy_s, "device_idle_share": 1 - busy_s / plain_wall,
        "kernel_launches": nlaunch, "own_kernel_launches": own,
        "top_kernels_ms": {e.key[:100]: _device_us(e) * 1e-3
                           for e in top}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
