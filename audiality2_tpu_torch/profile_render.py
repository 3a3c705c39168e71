"""Where a render's time goes on the card.

    python3 -m audiality2_tpu_torch.profile_render [--song slice|effects]
        [--seconds 10] [--channels 2] [--top 15]

Renders a song of ``songs.py`` (the slice song by default) three times:
to warm up, timed, and under ``torch.profiler``.  Prints the unprofiled
render's wall time and host seconds per render phase (record, build,
mix, fetch), the device time summed over the CUDA kernels of the
profiled render and its share of the unprofiled wall time (the rest is
the device's idle share; the profiler's own overhead inflates the
profiled wall time, not the kernels' device time), the number of
kernel launches per superblock (and those of each of the port's own
kernels among them, counted by their wrappers), and the kernels that
take the most device time; the last line is the same as one JSON
object.  Needs a CUDA device.
"""

import argparse
import json
import subprocess
import sys
import time

import torch

from . import open_engine
from .cuda.mixer import KERNEL_WRAPPERS
from .engine.device_render import DeviceRenderer, SUPERBLOCK_FRAMES
from .songs import SONGS


def _render(name, seconds, channels, profiler=None):
    src, program = SONGS[name]
    i = open_engine(44100, 4096, channels, batched=False)
    song = i.get(i.load_string(src, name), program)
    r = DeviceRenderer(i, channels=channels, device="cuda")
    r.timestamp_reset()
    r.start(0, song)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if profiler is None:
        r.render(int(seconds * 44100), bufsize=SUPERBLOCK_FRAMES)
    else:
        with profiler:
            r.render(int(seconds * 44100), bufsize=SUPERBLOCK_FRAMES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if r.fell_back:
        raise RuntimeError("the render bridged natively")
    r.close()
    return wall, r.timings


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
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_render: no CUDA device", file=sys.stderr)
        return 2
    _render(a.song, a.seconds, a.channels)            # warm-up
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    plain_wall, tm = _render(a.song, a.seconds, a.channels)
    own = {k: fn.launches for k, fn in KERNEL_WRAPPERS.items()}
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof_wall, _ = _render(a.song, a.seconds, a.channels, prof)
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(_device_us(e) for e in kernels) * 1e-6
    nlaunch = sum(e.count for e in kernels)
    nsb = -(-int(a.seconds * 44100) // SUPERBLOCK_FRAMES)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print("card: %s (%s)" % (torch.cuda.get_device_name(0),
                             smi.stdout.strip().splitlines()[0]
                             if smi.returncode == 0 else "nvidia-smi failed"))
    print("render %s song, %.1f s audio, %d ch, %d superblocks: %.4f s "
          "unprofiled (%.1f x realtime), %.4f s profiled"
          % (a.song, a.seconds, a.channels, nsb, plain_wall,
             a.seconds / plain_wall, prof_wall))
    print("phases (unprofiled, host s): " + ", ".join(
        "%s %.4f" % kv for kv in tm.items()))
    print("device busy %.4f s = %.1f%% of the unprofiled wall time; "
          "%d kernel launches (%.0f per superblock); the port's kernels: %s"
          % (busy_s, 100 * busy_s / plain_wall, nlaunch, nlaunch / nsb,
             ", ".join("%s %d" % kv for kv in own.items())))
    top = sorted(kernels, key=_device_us, reverse=True)[:a.top]
    for e in top:
        print("  %9.3f ms %6d x  %s" % (_device_us(e) * 1e-3, e.count,
                                        e.key[:100]))
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "song": a.song,
        "seconds": a.seconds,
        "channels": a.channels, "superblocks": nsb,
        "wall_s": plain_wall, "profiled_wall_s": prof_wall,
        "x_realtime": a.seconds / plain_wall, "phases_s": tm,
        "device_busy_s": busy_s, "device_idle_share": 1 - busy_s / plain_wall,
        "kernel_launches": nlaunch, "own_kernel_launches": own,
        "top_kernels_ms": {e.key[:100]: _device_us(e) * 1e-3
                           for e in top}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
