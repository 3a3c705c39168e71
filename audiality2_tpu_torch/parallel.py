"""Sharded single render: one song's oscillator runs split over n
shards, their bus slots summed, the stage tail run once.

The counterpart of the JAX package's ``parallel.render_sharded``
(``audiality2_tpu/parallel.py``).  The voice-tree mix is an integer sum
(reference core.c:364-395 bus accumulation), so a render splits the
scaling-book way: shard d owns the record runs d, d+n, ... of every
superblock, lays out its own class blocks from them (pinned to the full
program's instance map), expands them through the mixer's oscillator
half (``TorchMixer._expand``: the run expansion, the ramp replay and
the oscillator kernel) into an int32 slot array, and the shards' slot
arrays are summed.  The sum is taken in int64 and wrapped to int32,
which equals the int32 wrap-around of the solo mixer's adds, so the
result is bit-exact with the solo render (and with native).

The stage tail (stash adds, stages, fbdelay, filter12 / dcblock /
limiter, fm in item order) is serial; it runs once, on shard 0, through
the mixer's stage half (``TorchMixer._tail``) on the full program with
its rows stripped: the exact tier, the packed format off, and filter /
fm lanes following their unit serials through the mixer's lane
permutation.  (The JAX function passes filter state on by lane
position, so its output leaves native where a voice ends and the later
lanes move down; this one does not.)

Two forms:

- in process (``group`` None): shard d expands on ``devices[d]``
  (default ``cuda:0 .. cuda:n-1``; a device may repeat), each into its
  own slot buffer; the buffers are summed on shard 0's device;
- under a process group (``group``, a ``torch.distributed`` group):
  shard = rank, n = world size; the slot sum is an ``all_reduce`` of
  int64 slots; rank 0 alone holds the stage state and runs the tail,
  and its master goes out by ``broadcast``, so every rank returns the
  same array.

    from audiality2_tpu_torch.parallel import render_sharded
    out = render_sharded(interface, program, frames, n_devices=4)

The shard step runs eagerly (no CUDA graph).
"""

import time

import numpy as np
import torch

from .constants import A2_MAXFRAG
from .cuda import osc_kernel as OK
from .cuda.mixer import TorchMixer, _StateSet, blob_layout, blob_views
from .cuda.superblock import (ALL_CLASSES, BASE_N, RC_RIDX, RC_START, RR_N,
                              Unsupported, _pow2, program_from_native)
from .engine.device_render import DeviceRenderer

FRAG = A2_MAXFRAG
# the reference's default superblock: 1376 fragments of 64 frames
DEFAULT_BUFSIZE = 1376 * 64


def wrap32(acc):
    """int64 tensor -> int32, each value wrapped to 32 bits (two's
    complement), as int32 wrap-around addition would have left it."""
    return (((acc + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def shard_programs(rows, stages, stash, nfrag, prog, n, atlas_entry,
                   master_channels, hw):
    """Per-shard compacted row programs (the JAX function's
    ``shard_programs``): shard d owns record runs d, d+n, ... and lays
    out its own class blocks from just those runs, its slot numbering
    pinned to the full program's instance map.  The per-class block
    counts, the run count and the ramp-run count are unified over the
    shards as pow2 high-water marks kept in `hw` (sticky across the
    superblocks of a render, and across renders sharing it).  Returns
    (rows_sig, Rtot, ramppad, tbases [per class: int32 [n, NB]], runmat
    int32 [n, Nr, BASE_N], rampmat int32 [n, max(ramppad, 1), RR_N]),
    every shard's RC_START remapped into the unified row space."""
    z_st = stages[:0] if len(stages) else stages
    z_sh = stash[:0] if len(stash) else stash
    sprogs = [program_from_native(rows[d::n] if len(rows) else rows, z_st,
                                  z_sh, nfrag, prog.frag_sizes, atlas_entry,
                                  master_channels,
                                  inst_map=(prog.inst_of, prog.ninst))
              for d in range(n)]
    nb_u = {}
    for sp in sprogs:
        for c, NB, _ in sp.class_blocks:
            nb_u[c] = max(nb_u.get(c, 0), NB)
    for c in nb_u:
        if nb_u[c]:
            nb_u[c] = hw[("cls", c)] = max(_pow2(nb_u[c], 1),
                                           hw.get(("cls", c), 0))
    rows_sig = tuple((c, nb_u.get(c, 0)) for c in ALL_CLASSES)
    Rtot = sum(NB * OK.RPB for _, NB in rows_sig)
    Nr = hw["runs"] = max(
        _pow2(max(max((sp.runmat.shape[0] if sp.runmat is not None else 0)
                      for sp in sprogs), 1), 256), hw.get("runs", 0))
    ramppad = max((sp.rampmat.shape[0] if sp.rampmat is not None else 0)
                  for sp in sprogs)
    if any(sp.has_ramp for sp in sprogs) or prog.has_ramp \
            or hw.get("rampruns", 0):
        ramppad = hw["rampruns"] = max(_pow2(max(ramppad, 1), 128),
                                       hw.get("rampruns", 0))
    tbs = [np.zeros((n, NB), np.int32) for _, NB in rows_sig]
    rm = np.zeros((n, Nr, BASE_N), np.int32)
    rm[:, :, RC_START] = Rtot
    rm[:, :, RC_RIDX] = -1
    rmp = np.zeros((n, max(ramppad, 1), RR_N), np.int32)
    for d, sp in enumerate(sprogs):
        # the searchsorted shift of TorchMixer._repad: a class block
        # that grew moves the bases of the later classes
        cb = {c: (NB, tb) for c, NB, tb in sp.class_blocks}
        old_ends = []
        shift = []
        ob = nb = 0
        for i, (c, NBu) in enumerate(rows_sig):
            NB, tb = cb.get(c, (0, None))
            shift.append(nb - ob)
            ob += NB * OK.RPB
            old_ends.append(ob)
            nb += NBu * OK.RPB
            if NB:
                tbs[i][d, :NB] = tb
        shift.append(nb - ob)          # dead-run sentinel
        m = sp.runmat if sp.runmat is not None \
            else np.zeros((0, BASE_N), np.int32)
        if m.shape[0]:
            starts = m[:, RC_START].astype(np.int64)
            ci = np.searchsorted(np.asarray(old_ends), starts, side="right")
            m = m.copy()
            m[:, RC_START] = (starts + np.asarray(shift, np.int64)[ci]) \
                .astype(np.int32)
            rm[d, :m.shape[0]] = m
        if sp.rampmat is not None and sp.rampmat.shape[0]:
            rmp[d, :sp.rampmat.shape[0]] = sp.rampmat
    return rows_sig, Rtot, ramppad, tbs, rm, rmp


def shard_signature(sig, rows_sig, nruns, ramppad):
    """The signature of one shard's oscillator half: the full program's
    frame count, instances, channels, readback and quality bits (the mono
    row expansion among them), its own row tables, no stash and no
    items."""
    return sig[:4] + (rows_sig, nruns, 0, 0, ramppad) + sig[9:11] \
        + ((), None)


def shard_blob(ssig, d, tbs, rm, rmp):
    """Shard d's upload: its class bases, runs and ramp runs laid out by
    ``blob_layout(ssig)``."""
    layout, total = blob_layout(ssig)
    blob = np.zeros(total, np.int32)

    def put(name, a):
        pos, shape = layout[name]
        blob[pos:pos + a.size] = a.ravel()

    for i, tb in enumerate(tbs):
        put(("tbase", i), tb[d])
    put("rm", rm[d])
    if ssig[8]:
        put("rmp", rmp[d, :ssig[8]])
    return layout, blob


def _device_list(n_devices, devices, group):
    """(n, this process's shard indices, their devices)."""
    if group is not None:
        import torch.distributed as dist
        n = dist.get_world_size(group)
        d = dist.get_rank(group)
        if n_devices is not None and n_devices != n:
            raise ValueError("render_sharded: n_devices %d, but the group "
                             "has %d ranks" % (n_devices, n))
        if devices is None:
            if not torch.cuda.is_available():
                raise ValueError("render_sharded: need a CUDA device, "
                                 "have none")
            devices = [torch.device("cuda", dist.get_rank()
                                    % torch.cuda.device_count())]
        return n, [d], [torch.device(devices[0])]
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", k) for k in range(have)]
    else:
        devices = [torch.device(x) for x in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices < 1 or n_devices > len(devices):
        raise ValueError("render_sharded: need %d devices, have %d"
                         % (n_devices, len(devices)))
    return n_devices, list(range(n_devices)), devices[:n_devices]


def _now(device):
    """A time mark on `device`: a CUDA event on its current stream, or
    the host clock."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev
    return time.perf_counter()


def _ms(a, b):
    """Milliseconds between two marks of ``_now`` (events: once both
    have completed)."""
    if isinstance(a, float):
        return (b - a) * 1e3
    return a.elapsed_time(b)


def render_sharded(interface, program, frames, args=(), n_devices=None,
                   bufsize=None, channels=None, devices=None, group=None,
                   cache=None, timings=None):
    """Renders `frames` frames of `program` with its oscillator runs
    sharded over `n_devices` shards.  Returns [channels][frames] int32
    numpy, bit-exact with the solo render and native.

    devices: the shards' devices in process (default ``cuda:0 ..
    cuda:n-1``; ``ValueError`` when n exceeds them), or under `group`
    this rank's device as a one-element list (default ``cuda:<rank mod
    the visible cards>``).  cache: a dict that renders may share; it
    keeps the sticky pads (``cache["hw"]``), never the render's state.
    timings: a list that receives, per superblock, {"expand": [ms per
    shard of this process], "sum": ms, "tail": ms (shard 0),
    "wall_s": s}.  Content the device path cannot express raises
    ``Unsupported``: this render does not bridge natively."""
    n, mine, devs = _device_list(n_devices, devices, group)
    dev0 = devs[0]
    root = 0
    if group is not None:
        import torch.distributed as dist
        root = dist.get_global_rank(group, 0)
    lead = 0 in mine

    r = DeviceRenderer(interface, channels=channels, device=dev0)
    try:
        r.timestamp_reset()
        r.start(0, program, *args)
        if bufsize is None:
            bufsize = min(frames, DEFAULT_BUFSIZE)
        bufsize -= bufsize % 64
        if bufsize < 64:
            raise ValueError("render_sharded: bufsize below 64 frames")
        mixer = r.mixer
        # the stage half runs the exact tier with the packed format off
        mixer._rmq = False
        if not r._profile(frames, bufsize):
            raise Unsupported("render_sharded: the profile pass met content "
                              "the device path cannot run")
        r._drop_kept()
        r.wait_device()
        # one oscillator-half mixer per device (its atlas and tables)
        mixers = {}
        for dv in devs:
            if dv not in mixers:
                mixers[dv] = mixer if dv == dev0 else TorchMixer(
                    r, device=dv, quality=mixer.quality)
        if cache is None:
            cache = {}
        hw = cache.setdefault("hw", {})
        sets = {}                     # tail signature -> _StateSet
        out = []
        done = 0
        while done < frames:
            t_sb = time.perf_counter()
            rows, stages, stash, nfrag = r.nr.record(bufsize)
            prog = program_from_native(rows, stages, stash, nfrag,
                                       [64] * (bufsize // 64),
                                       r.atlas_entry, r.master_channels)
            r._tag_prog(prog)
            mixer._repad(prog)
            sig = mixer._signature(prog)
            rows_sig, _, ramppad, tbs, rm, rmp = shard_programs(
                rows, stages, stash, nfrag, prog, n, r.atlas_entry,
                r.master_channels, hw)
            ssig = shard_signature(sig, rows_sig, rm.shape[1], ramppad)
            F, ninst, mch = sig[0], sig[1], sig[3]
            nslot = ninst * F + 1
            if lead:
                tsig, tblob, pids, _ = mixer._prepare(prog, rows=False)
            spans = []
            with mixer._stream():
                parts = []
                for d, dv in zip(mine, devs):
                    sm = mixers[dv]
                    layout, blob = shard_blob(ssig, d, tbs, rm, rmp)
                    with sm._stream():
                        sm._ensure_static()
                        t0 = _now(dv)
                        v = blob_views(torch.from_numpy(blob).to(dv), layout)
                        slots = torch.zeros((nslot, 2, FRAG),
                                            dtype=torch.int32, device=dv)
                        sm._expand(ssig, v, slots)
                        spans.append((t0, _now(dv)))
                        # to shard 0's device on the shard's stream,
                        # after its expansion
                        parts.append(slots.to(dev0))
                t0 = _now(dev0)
                acc = torch.zeros((nslot, 2, FRAG), dtype=torch.int64,
                                  device=dev0)
                for p in parts:
                    acc.add_(p)
                del parts
                if group is not None:
                    dist.all_reduce(acc, group=group)
                slots = wrap32(acc)
                del acc
                t1 = _now(dev0)
                master = torch.zeros((F, mch, FRAG), dtype=torch.int32,
                                     device=dev0)
                if lead:
                    st = sets.get(tsig)
                    if st is None:
                        st = sets[tsig] = _StateSet(tsig, dev0)
                    mixer._bind(st, pids)
                    tl, _ = blob_layout(tsig)
                    mixer._tail(tsig, blob_views(
                        torch.from_numpy(tblob).to(dev0), tl), st, slots,
                        master)
                t2 = _now(dev0)
                if group is not None:
                    dist.broadcast(master, src=root, group=group)
                host = master.cpu().numpy()
            keep = min(bufsize, frames - done)
            out.append(host.transpose(1, 0, 2).reshape(mch, -1)[:, :keep])
            done += bufsize
            if timings is not None:
                for dv in set(devs):
                    if dv.type == "cuda":
                        torch.cuda.synchronize(dv)
                timings.append({"expand": [_ms(a, b) for a, b in spans],
                                "sum": _ms(t0, t1), "tail": _ms(t1, t2),
                                "wall_s": time.perf_counter() - t_sb})
    finally:
        r.close()
    return np.concatenate(out, axis=1)
