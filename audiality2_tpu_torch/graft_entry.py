"""Entry points: the voice-batched forward step and the multi-shard dry
run, the port's counterparts of the root ``__graft_entry__.py``.

The voice-batched step renders one 64-frame fragment for all live
voices (wavetable oscillator and panmix fused in one row batch,
``tpu/kernels.py``) and mixes them to stereo.  The dry run shards the
voice axis, the row axis and the superblock mixer over n shards: each
shard renders its part, and the parts are summed, which is exact
because the bus mix is an integer sum.  The JAX module forces a
virtual CPU mesh; here the shards run one after another in this
process on the given device (the card unless the caller asks for
"cpu").

    fn, args = entry()            # on the card
    out = fn(*args)               # int64 [2, 64]
    dryrun_multichip(4)
"""

import numpy as np
import torch

# the multi-fragment scan's length, and the fleet superblock's fragments
NFRAGS = 4
FLEET_F = 16


def _build_inputs(V, device):
    from .engine.state import open_engine
    from .fixmath import p2i
    from .tpu import kernels as K

    i = open_engine(48000, 1024, 1)
    atlas = K.WaveAtlas()
    w = i.get_wave(i.get(0, "saw"))
    atlas.add_wave("saw", w)
    data = atlas.finalize()
    mm = 3
    base, size = atlas.lookup("saw", mm)
    dph = (p2i(-492789) * w.period) >> mm     # middle C at 48 kHz
    rng = np.random.default_rng(0)
    dphs = (dph * (1.0 + 0.3 * rng.random(V))).astype(np.int64)

    def full(x):
        return torch.full((V,), x, dtype=torch.int64, device=device)

    return dict(
        atlas=torch.as_tensor(data, dtype=torch.int32, device=device),
        base=full(base),
        dph=torch.as_tensor(dphs, device=device),
        size24=full(w.size[mm] << 24),
        amp0=full(1 << 22),
        damp=full(0),
        vol=full(1 << 24),
        pan=torch.as_tensor(((rng.random(V) - 0.5) * (1 << 24))
                            .astype(np.int64), device=device),
        ph0=full(0),
    )


def _forward(atlas, base, ph0, dph, size24, amp0, damp, vol, pan):
    """One fragment of every voice, panned and summed to stereo: int64
    [2, 64]."""
    from .tpu import kernels as K
    z = torch.zeros_like(vol)
    left, right = K.wtosc_panmix_stereo(atlas, base, ph0, dph, amp0, damp,
                                        vol, z, pan, z)
    return torch.stack([left.sum(0), right.sum(0)])


def entry(device="cuda"):
    """Returns (fn, example_args): the voice-batched forward step of 128
    voices on `device`, and its torch tensor arguments."""
    a = _build_inputs(128, torch.device(device))
    example_args = (a["atlas"], a["base"], a["ph0"], a["dph"],
                    a["size24"], a["amp0"], a["damp"], a["vol"], a["pan"])
    return _forward, example_args


def _scan(a, sl):
    """NFRAGS fragments of the voices `sl`, each step's phase wrapped to
    its wave and its amplitude ramped: int64 [2, NFRAGS*64]."""
    from .tpu import kernels as K
    ph, amp = a["ph0"][sl], a["amp0"][sl]
    dph, damp, size24 = a["dph"][sl], a["damp"][sl], a["size24"][sl]
    outs = []
    for _ in range(NFRAGS):
        outs.append(_forward(a["atlas"], a["base"][sl], ph, dph, size24, amp,
                             damp, a["vol"][sl], a["pan"][sl]))
        ph = (ph + K.FRAG * dph) % size24
        amp = amp + K.FRAG * damp
    return torch.cat(outs, dim=1)


def dryrun_multichip(n_devices, device="cuda"):
    """Three sharded topologies on `n_devices` shards, each held bit for
    bit against its unsharded form: the voice-sharded fragment scan, the
    row-sharded row batch (``cuda/rows.py``) and the superblock mixer
    (``_dryrun_superblock_fleet``).  Raises AssertionError on a
    difference."""
    from .cuda.rows import rows_call
    from .tpu import kernels as K

    dev = torch.device(device)
    n = n_devices
    V = 8 * n
    a = _build_inputs(V, dev)

    # 1) the voice axis sharded: each shard scans its voices, the masters
    #    are summed
    per = V // n
    out = sum(_scan(a, slice(d * per, (d + 1) * per)) for d in range(n))
    assert out.shape == (2, NFRAGS * K.FRAG)
    assert int(out.abs().max()) > 0
    ref = _scan(a, slice(None))
    assert torch.equal(out, ref), "sharded render != unsharded render"

    # 2) the row batch (wtosc -> panmix with per-row haspm / stereo /
    #    clamp), row axis sharded, partial master mixes summed
    R = 8 * n
    rng = np.random.default_rng(1)
    z = torch.zeros(R, dtype=torch.int64, device=dev)

    def flag(p):
        return torch.as_tensor(rng.random(R) < p, device=dev) \
            .to(torch.int64)

    haspm, stereo, clamp = flag(0.8), flag(0.5), flag(0.1)
    pan0 = torch.as_tensor(((rng.random(R) - 0.5) * (1 << 24))
                           .astype(np.int64), device=dev)
    params = torch.stack([a["base"], z, a["dph"], z + (1 << 22), z, haspm,
                          stereo, clamp, z + (1 << 24), z, pan0, z])
    per = R // n
    rout = sum(rows_call(a["atlas"],
                         params[:, d * per:(d + 1) * per].contiguous())
               .sum(0) for d in range(n))
    assert rout.shape == (2, K.FRAG)
    assert int(rout.abs().max()) > 0
    rref = rows_call(a["atlas"], params).sum(0)
    assert torch.equal(rout, rref), "sharded row kernel != unsharded"

    # 3) the superblock mixer: a fleet of one stream per shard, and one
    #    render sharded over the shards
    _dryrun_superblock_fleet(n, dev)


# The fleet song exercises every state-carrying device item kind:
# a filter12 chain (on-device d1/d2 scan state), an fm2 voice with
# operator feedback (on-device per-op `last` state), and an fbdelay
# in the master group (device-resident ring) — so the sharded
# topologies below validate the production mixer's full item loop,
# not just stateless stages.
_FLEET_SCRIPT = """
Tone(P V=1)
{
	struct { wtosc; filter12; panmix }
	lp .5; bp .3; cutoff 2; q .1
	w saw; a (V * .3); p P
	d 400
	a 0
	d 20
}

Bass(P V=1)
{
	struct { fm2; panmix }
	a V; @p P; fb .3; a1 .4; @p1 .998
	d 400
	a 0; d 20
}

export Song(V=1)
{
	struct { inline; fbdelay; panmix }
	fbdelay 80; fbgain .3; ldelay 50; lgain .2
	1:Tone 0n (V * .8)
	2:Bass 1n (V * .5)
	d 420
}
"""


def _dryrun_superblock_fleet(n, dev):
    """The superblock mixer on the fleet song's first superblock (16
    fragments, mono): (a) a fleet of n streams, one per shard, each a
    mixer body with its own state, and a monitoring mix of their masters,
    against the unsharded body; (b) one render whose oscillator runs are
    split over the n shards (shard d owns runs d, d+n, ... in the full
    program's row space, its ramp runs' back-pointers made shard-local),
    the shards' slot arrays summed and the stage half run once, against
    the unsharded body."""
    from . import open_engine
    from .cuda.mixer import _StateSet, blob_layout, blob_views
    from .cuda.superblock import (BASE_N, RC_RIDX, RC_START, RR_BASE, RR_N,
                                  program_from_native)
    from .engine.device_render import DeviceRenderer
    from .parallel import shard_blob, shard_signature, wrap32

    i = open_engine(44100, 4096, 1, batched=False)
    song = i.get(i.load_string(_FLEET_SCRIPT, "fleet"), "Song")
    r = DeviceRenderer(i, channels=1, device=dev)
    r.timestamp_reset()
    r.start(0, song)
    r.wait_device()
    F = FLEET_F
    rows, stages, stash, nfrag = r.nr.record(F * 64)
    prog = program_from_native(rows, stages, stash, nfrag, [64] * F,
                               r.atlas_entry, 1)
    mixer = r.mixer

    def go():
        # the first superblock of the stream: every filter lane fresh
        sig, blob, _, _ = mixer._prepare(prog)
        layout, _ = blob_layout(sig)
        v = blob_views(torch.from_numpy(blob).to(dev), layout)
        nslot = prog.ninst * F + 1
        mch = prog.master_channels

        def master():
            return torch.zeros((F, mch, 64), dtype=torch.int32, device=dev)

        def body():
            m = master()
            mixer._body(sig, v, _StateSet(sig, dev), m)
            return m

        mref = body()
        # (a) the fleet and its monitoring mix
        masters = torch.stack([body() for _ in range(n)])
        monitor = wrap32(masters.to(torch.int64).sum(0))
        assert masters.shape[0] == n
        assert int(monitor.abs().max()) > 0
        assert all(torch.equal(m, mref) for m in masters), \
            "sharded fleet != unsharded mixer"
        assert torch.equal(monitor, wrap32(mref.to(torch.int64) * n)), \
            "monitor mix != integer sum of masters"

        # (b) one render, its runs strided over the shards
        rm = prog.runmat
        Nr = rm.shape[0]
        ramppad = sig[8]
        Lmax = (Nr + n - 1) // n
        rm_sh = np.zeros((n, Lmax, BASE_N), np.int32)
        rm_sh[:, :, RC_START] = prog.Rtot
        rm_sh[:, :, RC_RIDX] = -1
        rmp_sh = np.zeros((n, max(ramppad, 1), RR_N), np.int32)
        for d in range(n):
            own = np.arange(d, Nr, n)
            rm_sh[d, :len(own)] = rm[own]
            if ramppad:
                local = np.zeros(Nr, np.int32)
                local[own] = np.arange(len(own), dtype=np.int32)
                rmp = prog.rampmat[:ramppad].copy()
                owned = np.isin(rmp[:, RR_BASE], own)
                rmp[:, RR_BASE] = np.where(owned, local[rmp[:, RR_BASE]], 0)
                rmp_sh[d, :ramppad] = rmp
        rows_sig = tuple((c, NB) for c, NB, _ in prog.class_blocks)
        tbs = [np.broadcast_to(tb, (n, NB))
               for _, NB, tb in prog.class_blocks]
        ssig = shard_signature(sig, rows_sig, Lmax, ramppad)
        acc = torch.zeros((nslot, 2, 64), dtype=torch.int64, device=dev)
        for d in range(n):
            slay, sblob = shard_blob(ssig, d, tbs, rm_sh, rmp_sh)
            slots = torch.zeros((nslot, 2, 64), dtype=torch.int32,
                                device=dev)
            mixer._expand(ssig, blob_views(torch.from_numpy(sblob).to(dev),
                                           slay), slots)
            acc.add_(slots)
        smaster = master()
        mixer._tail(sig, v, _StateSet(sig, dev), wrap32(acc), smaster)
        assert torch.equal(smaster, mref), \
            "sharded single render != unsharded mixer"

    try:
        mixer._locked(go)
    finally:
        r.close()
