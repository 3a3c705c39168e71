"""a2play for the PyTorch/CUDA port: load and compile .a2s modules,
render offline, write WAV, dump exports and VM assembly.

    python -m audiality2_tpu_torch.cli [switches] <file.a2s>
      -p <name>[,arg[,...]]   run program with arguments
      -st <n>                 stop time (seconds)
      -sl <n>                 stop level (1.0 == clip)
      -r <n>                  sample rate (Hz)
      -c <n>                  channels
      -o <file.wav>           output WAV (16-bit PCM)
      -x / -xa / -xr / -xp / -xh
                              dump module exports (+ VM assembly, the
                              engine root, private symbols, handles)
      --interleaved           disable the batched block engine
      --gpu                   render on the card (the default)
      --native / --no-native  render on the host instead: the C++
                              runtime or the Python host engine
      --shards <n>            split one render over n cards
      -M <file.mid>, --live, -q hifi|normal|lofi

The switches are those of the JAX package's a2play-tpu (reference
a2play/a2play.c:457-489), but the card renders by default: native
record -> superblock mixer on the card (``DeviceRenderer``, one CUDA
graph per padded signature, chains of 4 superblocks per launch, a
pipelined render unless ``-sl`` is given; with ``-o`` the master
converts to 16-bit on the card).  Without a CUDA device a render exits
with an error unless ``--native`` or ``--no-native`` asks for the
host.  ``--gpu`` (``--tpu`` there) is accepted and changes nothing.
``-M`` and ``--live`` run the host engine, whose large oscillator row
batches evaluate on the card.  ``--shards N`` renders one song with its
oscillator runs split over the cards cuda:0 .. cuda:N-1
(``parallel.render_sharded``; an error when fewer are visible).
"""

import argparse
import struct
import sys
import time

import numpy as np
import torch


def write_wav(path, data_i24, samplerate, channels=1):
    """Write int32 8:24 audio as 16-bit PCM WAV."""
    pcm = np.clip(data_i24 >> 8, -32768, 32767).astype("<i2")
    with open(path, "wb") as f:
        n = pcm.nbytes
        f.write(b"RIFF" + struct.pack("<I", 36 + n) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels,
                                      samplerate,
                                      samplerate * channels * 2,
                                      channels * 2, 16))
        f.write(b"data" + struct.pack("<I", n))
        f.write(pcm.tobytes())


_MAXINDENT = 32


def _print_info(i, h, xname=None, indent=0, flags=frozenset()):
    """Recursive object-info printout, the reference a2play's dump
    tree (a2play/a2play.c:116-273 print_info): name, handle (-xh),
    type, then type-specific details (wave geometry, constant value,
    unit I/O + registers + constants), recursing into bank exports
    and, with -xp, private symbols."""
    from .constants import A2ObjType, WaveType, A2_LOOPED
    indent = min(indent, _MAXINDENT)
    prefix = "| " * indent
    t = i.typeof(h)
    name = xname or i.name_of(h)
    line = prefix
    line += f"{name:<24s}" if name else f"{h:<24d}"
    if "handles" in flags:
        line += f"{h:<8d}"
    line += f"{i.state.ss.hm.type_name(t):<12s}"
    if t == A2ObjType.WAVE:
        w = i.get_wave(h)
        line += f"{w.type.name:<8s}"
        if w.type == WaveType.NOISE:
            line += f" per: {w.period:<8d}"
        elif w.type in (WaveType.WAVE, WaveType.MIPWAVE):
            line += f" per: {w.period:<8d} size: {w.size[0]:<8d}"
            if w.flags & A2_LOOPED:
                line += " LOOPED"
    elif t == A2ObjType.UNIT:
        ud = i.unit_descs()[i.unit_index(h)]
        line += (f"i: {ud.mininputs}     "
                 if ud.mininputs == ud.maxinputs
                 else f"i: {ud.mininputs}..{ud.maxinputs}  ") \
            if ud.maxinputs else "i: ----  "
        line += (f"o: {ud.minoutputs}     "
                 if ud.minoutputs == ud.maxoutputs
                 else f"o: {ud.minoutputs}..{ud.maxoutputs}  ") \
            if ud.maxoutputs else "o: ----  "
        if ud.registers:
            line += "R: " + " ".join(ud.registers)
        if ud.constants:
            line += "   C: " + " ".join(
                f"{n}:{v / 65536.0:g}" for n, v in ud.constants)
    elif t == A2ObjType.CONSTANT:
        line += f"{i.value_of(h):f}"
    elif t == A2ObjType.STRING:
        line += i.string_of(h)
    print(line)
    if "asm" in flags and t == A2ObjType.PROGRAM:
        print(i.dump_code(h, prefix=prefix))
    if t != A2ObjType.BANK:
        return
    bank = i.bank_of(h)
    show_private = "private" in flags and bank.private
    if bank.exports or show_private:
        print(prefix + "|----------------(exports)"
              + "-" * 21)
        for n, x in bank.exports.items():
            _print_info(i, x, n, indent + 1, flags)
    if show_private:
        print(prefix + "|-------------(private symbols)"
              + "-" * 16)
        for n, x in bank.private.items():
            _print_info(i, x, n, indent + 1, flags)
    if bank.exports or show_private:
        print(prefix + "'" + "-" * 46)


def dump_exports(i, module, flags=frozenset()):
    """-x family: dump the module's (or with -xr the engine root's)
    export tree (reference a2play.c dump_exports)."""
    root = "root" in flags
    _print_info(i, 0 if root else module, None, 0, flags)


def run_live(i, prog, args):
    """Interactive jam surface (the reference's test/a2test.c keyboard
    player, stdin-driven): the program runs as the EP-7 MIDI handler
    on the host engine with a live MIDI driver; stdin lines inject
    events with wall-clock timestamps while a realtime-paced loop
    renders, so timing feels and quantizes like a live take.  Works
    headless (pipe a script of events) or at a terminal."""
    import threading

    out = []
    if args.channels == 1:
        i.sink_callback(lambda bufs, frames: out.append(
            np.array(bufs[0])))
    else:
        i.sink_callback(lambda bufs, frames: out.append(
            np.stack([np.array(b) for b in bufs[:args.channels]],
                     axis=1).reshape(-1)))
    i.timestamp_reset()
    vh = i.starta(i.root_voice(), prog, [])
    drv = i.set_midi_driver("live", handler_voice=vh)
    stop = threading.Event()

    def reader():
        for line in sys.stdin:
            parts = line.split()
            if not parts:
                continue
            cmd = parts[0].lower()
            try:
                if cmd == "q":
                    break
                elif cmd == "w":        # wait (ms) — scripted takes
                    time.sleep(float(parts[1]) / 1000.0)
                elif cmd == "n":        # note on
                    note = int(parts[1])
                    vel = int(parts[2]) if len(parts) > 2 else 100
                    drv.inject(0x90, note, vel)
                elif cmd == "o":        # note off
                    drv.inject(0x80, int(parts[1]), 0)
                elif cmd == "c":        # control change
                    drv.inject(0xB0, int(parts[1]), int(parts[2]))
                elif cmd == "b":        # pitch bend (14-bit value)
                    v = int(parts[1]) & 0x3FFF
                    drv.inject(0xE0, v & 0x7F, v >> 7)
                else:
                    print("live: n <note> [vel] | o <note> | "
                          "c <ctrl> <val> | b <bend> | q",
                          file=sys.stderr)
            except (ValueError, IndexError):
                print(f"live: bad event: {line.strip()}",
                      file=sys.stderr)
        stop.set()

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    print("a2play-gpu: live mode — enter events on stdin "
          "(n <note> [vel] / o <note> / c / b / q)", flush=True)
    chunk = 1024
    total = int(args.stoptime * args.rate)
    n = 0
    t0 = time.perf_counter()
    while not stop.is_set() and n < total:
        # realtime pacing: never render ahead of the wall clock, so
        # injected events land in the near future like a sequencer
        target = int((time.perf_counter() - t0) * args.rate) + chunk
        while n < min(target, total):
            i.run(chunk)
            n += chunk
        time.sleep(chunk / args.rate / 2)
    # release tail after quit/EOF so the last notes ring out
    tail = min(total - n, args.rate)
    while tail > 0:
        i.run(chunk)
        tail -= chunk
    audio = np.concatenate(out) if out else np.zeros(0, np.int32)
    secs = len(audio) / args.rate / max(args.channels, 1)
    print(f"a2play-gpu: live session: {secs:.2f} s")
    if args.output:
        write_wav(args.output, audio, args.rate, args.channels)
        print(f"a2play-gpu: wrote {args.output}")
    return 0


def run_sharded(i, prog, pargs, args, device):
    """--shards N: one render with its oscillator runs split over N
    shards (``parallel.render_sharded``): the cards cuda:0 .. cuda:N-1,
    or N shards on the CPU for device "cpu"."""
    from .parallel import render_sharded
    if device == "cuda" and not torch.cuda.is_available():
        print("a2play-gpu: --shards renders on the cards and needs a CUDA "
              "device, and torch finds none", file=sys.stderr)
        return 1
    total = int(args.stoptime * args.rate)
    devices = None if device == "cuda" else [device] * args.shards
    t0 = time.perf_counter()
    try:
        audio = render_sharded(i, prog, total,
                               args=[float(a) for a in pargs],
                               n_devices=args.shards,
                               channels=args.channels, devices=devices)
    except ValueError as e:
        print("a2play-gpu: %s" % e, file=sys.stderr)
        return 1
    dt = time.perf_counter() - t0
    print(f"a2play-gpu: rendered {total} frames "
          f"({total / args.rate:.2f} s) sharded over "
          f"{args.shards} devices in {dt:.2f} s "
          f"({total / args.rate / dt:.1f}x realtime)")
    if args.output:
        flat = (audio[0] if args.channels == 1 else
                np.stack(list(audio[:args.channels]), axis=1).reshape(-1))
        write_wav(args.output, flat, args.rate, args.channels)
        print(f"a2play-gpu: wrote {args.output}")
    return 0


def main(argv=None, device="cuda"):
    """Runs the CLI on argv (sys.argv[1:] when None); returns the exit
    code.  device: where the card render mixes and where this thread's
    host engine evaluates its row batches (``row_kernel.row_device``):
    "cuda" for the CLI, "cpu" for the tests."""
    from .tpu.row_kernel import row_device
    with row_device(device):
        return _main(argv, device)


def _main(argv, device):
    ap = argparse.ArgumentParser(prog="a2play-gpu", add_help=True)
    ap.add_argument("file", nargs="?", default=None,
                    help=".a2s module to load")
    ap.add_argument("-p", "--program", default=None,
                    help="program[,arg[,...]] to run (default: Song)")
    ap.add_argument("-st", "--stoptime", type=float, default=10.0,
                    help="stop time in seconds")
    ap.add_argument("-sl", "--stoplevel", type=float, default=None,
                    help="stop when below this level (1.0 == clip)")
    ap.add_argument("-r", "--rate", type=int, default=44100)
    ap.add_argument("-c", "--channels", type=int, default=1)
    ap.add_argument("-o", "--output", default=None,
                    help="write WAV file")
    ap.add_argument("-x", action="store_true", help="dump exports")
    ap.add_argument("-xa", action="store_true",
                    help="dump exports with VM assembly")
    ap.add_argument("-xr", action="store_true",
                    help="dump engine root exports")
    ap.add_argument("-xp", action="store_true",
                    help="dump with private symbols")
    ap.add_argument("-xh", action="store_true",
                    help="dump with object handles")
    ap.add_argument("-v", "--version", action="store_true",
                    help="print engine version and exit")
    ap.add_argument("--interleaved", action="store_true",
                    help="use the interleaved (non-batched) engine")
    ap.add_argument("-M", "--midi", default=None, metavar="FILE.mid",
                    help="MIDI handler mode (a2play -M): run the "
                         "program as an EP-7 MIDI handler and feed it "
                         "the given Standard MIDI File")
    ap.add_argument("--shards", type=int, default=None,
                    help="shard one render's oscillator runs across N "
                         "cards (parallel.render_sharded; the stage tail "
                         "runs once, on the first)")
    where = ap.add_mutually_exclusive_group()
    where.add_argument("--gpu", action="store_true",
                       help="render on the card, the default (native "
                            "record -> superblock mixer, one CUDA graph "
                            "per signature, hand-written kernels; "
                            "pipelined unless -sl is given)")
    where.add_argument("--native", action="store_true", default=None,
                       help="render on the host through the native C++ "
                            "runtime")
    where.add_argument("--no-native", dest="native", action="store_false",
                       help="render on the host through the Python "
                            "engine")
    ap.add_argument("-q", "--quality", default="hifi",
                    choices=("hifi", "normal", "lofi"),
                    help="wtosc interpolation quality (reference "
                         "A2_HIFI / default / A2_LOFI builds)")
    ap.add_argument("--live", action="store_true",
                    help="interactive mode (a2test-style jam "
                         "surface): the program runs as an EP-7 MIDI "
                         "handler, events are read from stdin "
                         "('n <note> [vel]' on, 'o <note>' off, "
                         "'c <ctrl> <val>', 'b <bend>', 'q' quit) "
                         "and rendered realtime-paced; -o writes the "
                         "session WAV")
    args = ap.parse_args(argv)
    if args.version:
        from . import __version__
        print(f"audiality2-tpu a2play (PyTorch/CUDA port)\n"
              f"Engine v{__version__}")
        return 0
    if args.file is None:
        ap.error("a .a2s module file is required")
    from . import open_engine
    i = open_engine(args.rate, 4096, args.channels,
                    batched=not args.interleaved,
                    quality=args.quality)
    module = i.load(args.file)
    print(f"Loaded \"{args.file}\"")

    if args.x or args.xa or args.xr or args.xp or args.xh:
        flags = set()
        if args.xa:
            flags.add("asm")
        if args.xr:
            flags.add("root")
        if args.xp:
            flags.add("private")
        if args.xh:
            flags.add("handles")
        dump_exports(i, module, frozenset(flags))

    progspec = args.program or "Song"
    parts = progspec.split(",")
    pname = parts[0]
    pargs = [float(x) for x in parts[1:]]
    prog = i.try_get(module, pname)
    if prog is None:
        prog = i.try_get(0, pname)
    if prog is None:
        if args.program is None:
            return 0        # nothing to play; dump-only use
        print(f"a2play-gpu: program '{pname}' not found",
              file=sys.stderr)
        return 1

    if args.live:
        return run_live(i, prog, args)

    if args.shards and not args.midi:
        return run_sharded(i, prog, pargs, args, device)

    # the card unless the host is asked for or nothing is to be rendered
    # (-st 0); the MIDI driver runs on the host engine
    total = int(args.stoptime * args.rate)
    on_card = args.native is None and not args.midi and total > 0
    if on_card and device == "cuda" and not torch.cuda.is_available():
        print("a2play-gpu: rendering on the card needs a CUDA device, and "
              "torch finds none (--native or --no-native render on the "
              "host)", file=sys.stderr)
        return 1

    out = []
    renderer = None
    if on_card:
        from .engine.device_render import DeviceRenderer
        # a 16-bit PCM sink makes the card's int16 readback lossless for
        # the product (the WAV writer's clip(x>>8) runs on the card);
        # raw sinks keep the exact int32 master.  Chains of 4 superblocks
        # per graph launch.
        readback = "i16" if args.output else "exact"
        renderer = DeviceRenderer(i, channels=args.channels, device=device,
                                  readback=readback, chain_dispatch=4)
        renderer.timestamp_reset()
        renderer.start(0, prog, *[float(a) for a in pargs])
    elif args.native and not args.midi:
        from .native import NativeRenderer
        renderer = NativeRenderer(i, channels=args.channels)
        renderer.timestamp_reset()
        renderer.start(0, prog, *[float(a) for a in pargs])
    else:
        if args.channels == 1:
            i.sink_callback(lambda bufs, frames: out.append(
                np.array(bufs[0])))
        else:
            i.sink_callback(lambda bufs, frames: out.append(
                np.stack([np.array(b) for b in
                          bufs[:args.channels]], axis=1).reshape(-1)))
        i.timestamp_reset()
        vh = i.starta(i.root_voice(), prog, [int(a * 65536)
                                             for a in pargs])
        if args.midi:
            i.set_midi_driver(f"smf,{args.midi}", handler_voice=vh)

    silence = (int(args.stoplevel * 8388608.0)
               if args.stoplevel is not None else None)
    lastpeak = 0
    t0 = time.perf_counter()
    if on_card and silence is None:
        # pipelined profiled render (one graph signature per song)
        def sink(bufs, frames):
            out.append(bufs[0] if args.channels == 1 else
                       np.stack(list(bufs[:args.channels]), axis=1)
                       .reshape(-1))
        renderer.render(total, sink=sink)
        n = total
    else:
        n = 0
    while n < total:
        if renderer is not None:
            b = renderer.run(4096)
            out.append(b[0] if args.channels == 1 else
                       np.stack(list(b[:args.channels]), axis=1)
                       .reshape(-1))
        else:
            i.run(4096)
        n += 4096
        if silence is not None:
            buf = out[-1]
            lastpeak += len(buf)
            over = np.abs(buf.astype(np.int64)) > silence
            if over.any():
                lastpeak = len(buf) - int(np.max(np.nonzero(over)[0]))
            if lastpeak > args.rate:
                break
    dt = time.perf_counter() - t0
    if renderer is not None:
        renderer.close()
    audio = np.concatenate(out) if out \
        else np.zeros(0, np.int32)           # -st 0: dump-only run
    secs = len(audio) / args.rate / args.channels
    print(f"a2play-gpu: rendered {len(audio)} frames "
          f"({secs:.2f} s) in {dt:.2f} s ({secs / dt:.1f}x realtime)")
    if args.output:
        write_wav(args.output, audio, args.rate, args.channels)
        print(f"a2play-gpu: wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
