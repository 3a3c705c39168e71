"""The port's stage tail (fbdelay, filter12 / dcblock / limiter, fm)
against the JAX package, on the CPU.

Each plain version (``cuda/fbdelay.py``, ``cuda/filter.py``,
``cuda/fm.py``, reached through its wrapper with CPU tensors) must equal
the JAX function it ports (``_apply_fbdelay``, ``_apply_fbdelay_dense``,
``_apply_filter``, ``_apply_fm``, called as jnp on the CPU) on the same
numpy-seeded tables: 0 mismatches in the slots and in the returned
state.  Then ``TorchMixer(device="cpu")`` must equal
``DeviceMixer(interpret=True)`` over at least three consecutive
recorded superblocks, so that fbdelay rings and filter / fm state carry
from one to the next.  ``DeviceMixer._repad`` rewrites a program's
tables in place, so each mixer gets its own deep copy of every program.
The CUDA kernels themselves are held against the plain versions on the
card by ``chip_smoke.py``.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiality2_tpu.tpu import superblock as JSB
from audiality2_tpu.tpu.osc_kernel import PairAtlas as JPairAtlas
import audiality2_tpu_torch as a2t
from audiality2_tpu_torch.cuda import fbdelay as FB
from audiality2_tpu_torch.cuda import filter as FL
from audiality2_tpu_torch.cuda import fm as FM
from audiality2_tpu_torch.cuda import superblock as SB
from audiality2_tpu_torch.cuda.mixer import TorchMixer
from audiality2_tpu_torch.cuda.osc_kernel import PairAtlas
from audiality2_tpu_torch.native import NativeRenderer
from audiality2_tpu_torch.songs import EFFECTS_SONG, LATE_FBDELAY_SONG


def _diff(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    return int((a != b).sum())


# ---------------------------------------------------------------
# plain versions against the JAX functions, on seeded tables
# ---------------------------------------------------------------

FBD_FORMS = [(True, True, True), (True, True, False), (False, False, True),
             (True, False, False), (False, True, False)]


def _fbd_id(f):
    return "in%d-out%d-%s" % (1 + f[0], 1 + f[1], "add" if f[2] else "rep")


@pytest.mark.parametrize("form", FBD_FORMS, ids=_fbd_id)
@pytest.mark.parametrize("C", [1, 4])
def test_fbdelay_legacy_matches_jax(C, form):
    """Legacy form: a 2^20 ring written from a position near its end
    (the positions wrap), partial slices, padding rows."""
    rng = np.random.default_rng(10 + C)
    slots, arr, ring, bufpos = FB.seeded_legacy(rng, C)
    sig = form + (C,)
    js, jring = JSB._apply_fbdelay(jnp.asarray(slots), sig,
                                   jnp.asarray(arr), jnp.asarray(ring),
                                   jnp.int32(bufpos))
    ts = torch.from_numpy(slots.copy())
    tring = torch.from_numpy(ring.copy())
    FB.apply_fbdelay(ts, sig, torch.from_numpy(arr), tring, bufpos)
    assert _diff(ts.numpy(), js) == 0
    assert _diff(tring.numpy(), jring) == 0
    assert (ts.numpy() != slots).any() and (tring.numpy() != ring).any()


@pytest.mark.parametrize("form", FBD_FORMS, ids=_fbd_id)
def test_fbdelay_dense_matches_jax(form):
    """Dense form: one instance's contiguous stream, fragments split
    into slices with their own gains, padding rows."""
    rng = np.random.default_rng(20 + sum(form))
    F = 12
    slots, arr, tail, par = FB.seeded_dense(rng, F)
    sig = form + (FB.chunk_for(par[0]),) + par
    js, jtail = JSB._apply_fbdelay_dense(jnp.asarray(slots), sig,
                                         jnp.asarray(arr),
                                         jnp.asarray(tail), F)
    ts = torch.from_numpy(slots.copy())
    ttail = FB.apply_fbdelay_dense(ts, sig, torch.from_numpy(arr),
                                   torch.from_numpy(tail.copy()), F)
    assert _diff(ts.numpy(), js) == 0
    assert _diff(ttail.numpy(), jtail) == 0
    assert (ts.numpy() != slots).any()


def _filter_sig(ni, no, add):
    sch = (0, 1) if ni == 2 else (1,)
    dch = (1, 0) if no == 2 else (0,)
    return ni, no, add, sch, dch


@pytest.mark.parametrize("add", [True, False], ids=["add", "rep"])
@pytest.mark.parametrize("ni,no", [(1, 1), (2, 2), (1, 2), (2, 1)])
@pytest.mark.parametrize("kind", FL.KINDS)
def test_filter_matches_jax(kind, ni, no, add):
    """filter12 / dcblock / limiter: padding slices (frames 0), partial
    slices (off > 0), instances that share destination slots."""
    rng = np.random.default_rng(
        100 * FL.KINDS.index(kind) + 10 * ni + 2 * no + add)
    slots, arr, state = FL.seeded_item(rng, kind, ni, no)
    sig = _filter_sig(ni, no, add)
    js, jstate = JSB._apply_filter(jnp.asarray(slots), kind, sig,
                                   jnp.asarray(arr), jnp.asarray(state))
    ts = torch.from_numpy(slots.copy())
    tstate = torch.from_numpy(state.copy())
    FL.filter_call(ts, kind, sig, torch.from_numpy(arr), tstate)
    assert _diff(ts.numpy(), js) == 0
    assert _diff(tstate.numpy(), jstate) == 0
    assert (ts.numpy() != slots).any() and (tstate.numpy() != state).any()


@pytest.mark.parametrize("add", [True, False], ids=["add", "rep"])
@pytest.mark.parametrize("structkey", FM.STRUCTKEYS)
def test_fm_matches_jax(structkey, add):
    """All eight fm structures (fm1, fm2, fm2r, fm3, fm3p, fm4, fm4p,
    fm4r): per-op feedback, oversampling, ring-modulated pairs."""
    rng = np.random.default_rng(structkey + add)
    slots, arr, state = FM.seeded_item(rng, structkey)
    sig = (structkey, add, 1 if add else 0)
    js, jstate = JSB._apply_fm(jnp.asarray(slots), sig, jnp.asarray(arr),
                               jnp.asarray(state))
    ts = torch.from_numpy(slots.copy())
    tstate = torch.from_numpy(state.copy())
    FM.fm_call(ts, sig, torch.from_numpy(arr), tstate,
               torch.from_numpy(FM.sine_pairs()))
    assert _diff(ts.numpy(), js) == 0
    assert _diff(tstate.numpy(), jstate) == 0
    assert (ts.numpy() != slots).any()


def test_fm_sine_pairs_match_jax():
    assert _diff(FM.sine_pairs(), JSB._fm_sine_table()) == 0


# ---------------------------------------------------------------
# TorchMixer against DeviceMixer over consecutive superblocks
# ---------------------------------------------------------------

# a mono fbdelay mid-chain of a leaf voice (test_device_render.py's
# mono fbdelay script): dense in every superblock
MONOFBD_SCRIPT = """
Song(V=1)
{
	struct { wtosc; fbdelay; panmix }
	drygain .5; fbgain .4; lgain .4; rgain .4
	w saw; a (V * .3); p 0n
	d 1100
	a 0
	d 100
}

export SongMain(V=1)
{
	struct { inline; panmix }
	1:Song V
	d 1300
}
"""
# songs.LATE_FBDELAY_SONG is this script with the voice started 100 ms
# late: the first superblock covers the delay partly, so the instance
# takes the legacy form for the whole song
# the delays change at 400 ms: dense, then legacy from that superblock
# on (the dense tail converts to a legacy ring)
CHANGEFBD_SCRIPT = MONOFBD_SCRIPT.replace(
    "\td 1100\n", "\td 400\n\tfbdelay 150; ldelay 120; rdelay 90\n"
    "\td 700\n")

# test_device_effects.py's limiter scripts
LIM_MONO = """
Song(V=1)
{
	struct { wtosc; limiter; panmix }
	release 24; threshold .2
	w saw; a (V * .9); p 0n
	d 400
	threshold .6
	a .1
	d 400
	a 0; d 100
}
export SongMain(V=1)
{
	struct { inline; panmix }
	1:Song V
	d 900
}
"""
LIM_STEREO = """
Song(V=1)
{
	struct { wtosc; panmix 1 2; limiter 2 > }
	release 24; threshold .2
	w saw; a (V * .9); p 0n; pan .3
	d 800
	a 0; d 100
}
export SongMain(V=1)
{
	struct { inline 0 2; panmix 2 > }
	1:Song V
	d 900
}
"""

# test_quality.py's filter scripts, run here at the exact tier
FLOAT_SRC = """
FilterLead(P V=1)
{
        struct { wtosc; filter12; dcblock db; panmix }
        lp .5; bp .4; hp .2
        w saw; p P; a (V * .3); set a
        cutoff 3; q 1.5; set cutoff; set q
        db.cutoff 2n
        d 200
        10 {
                cutoff (rand 4 + 1); q (rand 2 + .3)
                set cutoff; set q
                d 180
        }
        a 0; d 400
}

export Song(P V=1)
{
        struct { inline 0 2; panmix PM 2 2; limiter L 2 > }
        L.release 64; L.threshold 4
        PM.vol .8
        1:FilterLead (P + 2); d 300
        1:FilterLead P; d 1800
        end
}
"""
RESO_SRC = """
export Song(P V=1)
{
        struct { wtosc; filter12; panmix }
        lp 1; bp 1; hp .5
        q .1; set q; cutoff (P + 3); set cutoff
        w saw; a .8; set a; p P
        d 900; a 0; d 300
}
"""

FM_UNITS = ("fm1", "fm2", "fm2r", "fm3", "fm3p", "fm4", "fm4p", "fm4r")


def _fm_voice(unit):
    nops = int(unit[2])
    ops = "".join("; p%d (P + %d.5); a%d .%d; fb%d .%d"
                  % (i, i, i, 3 + i, i, 2 * i) for i in range(1, nops))
    return ("%s(P)\n{\n\tstruct { %s; panmix }\n\tp P; a .3; fb .3%s\n"
            "\td 10\n\ta 0; d 30\n}\n" % (unit.upper(), unit, ops))


# every fm unit, one note of each every 30 ms (each lives 40 ms, so
# notes overlap and cross superblocks): all eight structures in one
# superblock, within the native record's 64 stage rows per fragment
ALL_FM_SCRIPT = "".join(_fm_voice(u) for u in FM_UNITS) + """
Song()
{
	!n 0
	8 {
""" + "".join("\t\t%s (n * .25 - %d)\n" % (u.upper(), k % 3)
              for k, u in enumerate(FM_UNITS)) + """		+n 1
		d 30
	}
	d 200
}
"""

# name -> (source, program, channels, superblock frames, superblocks)
MIXER_SCRIPTS = {
    "effects": (EFFECTS_SONG, "Song", 2, 8192, 3),
    "monofbd": (MONOFBD_SCRIPT, "SongMain", 1, 8192, 3),
    "latefbd": (LATE_FBDELAY_SONG, "SongMain", 1, 8192, 3),
    "changefbd": (CHANGEFBD_SCRIPT, "SongMain", 1, 8192, 4),
    "lim_mono": (LIM_MONO, "SongMain", 1, 8192, 3),
    "lim_stereo": (LIM_STEREO, "SongMain", 2, 8192, 3),
    "float_src": (FLOAT_SRC, "Song", 2, 8192, 3),
    "reso_src": (RESO_SRC, "Song", 1, 8192, 3),
    "all_fm": (ALL_FM_SCRIPT, "Song", 2, 2048, 3),
}


class _Core:
    """The mixers read the pair atlas from ``core._pair_atlas``."""

    def __init__(self, atlas):
        self._pair_atlas = atlas


def record_superblocks(src, program, channels, frames, count):
    """Records `count` consecutive superblocks of `frames` frames and
    builds them with the port's builder; the port's and the JAX
    package's pair atlases fill in lockstep.  Returns (programs, port
    atlas, JAX atlas)."""
    i = a2t.open_engine(44100, 4096, channels, batched=False)
    song = i.get(i.load_string(src, "t"), program)
    nr = NativeRenderer(i, channels=channels)
    nr.timestamp_reset()
    nr.start(0, song)
    tpa, jpa = PairAtlas(), JPairAtlas()
    seen = set()

    def entry(handle, mip):
        if handle not in seen:
            seen.add(handle)
            w = i.state.ss.hm.get(handle).data
            for pa in (tpa, jpa):
                pa.add_wave(handle, w)
                pa.finalize()
        return tpa.lookup(handle, mip)

    progs = []
    for _ in range(count):
        rows, stages, stash, nfrag = nr.record(frames)
        progs.append(SB.program_from_native(
            rows, stages, stash, nfrag, [64] * nfrag, entry,
            nr.master_channels))
    nr.close()
    return progs, tpa, jpa


@pytest.mark.parametrize("name", list(MIXER_SCRIPTS))
def test_torch_mixer_stage_tail_matches_device_mixer(name):
    src, program, channels, frames, count = MIXER_SCRIPTS[name]
    progs, tpa, jpa = record_superblocks(src, program, channels, frames,
                                         count)
    tm = TorchMixer(_Core(tpa), device="cpu")
    jm = JSB.DeviceMixer(_Core(jpa), interpret=True)
    loud = False
    for k, prog in enumerate(progs):
        got = tm.run(copy.deepcopy(prog))
        want = jm.run(copy.deepcopy(prog))
        assert len(got) == len(want) == channels
        for g, w in zip(got, want):
            assert _diff(g, w) == 0, "superblock %d" % k
            loud = loud or np.abs(g).max() > 0
    assert loud
    kinds = {fl["kind"] for p in progs for fl in p.filters}
    fms = {fl["key"][3] for p in progs for fl in p.filters
           if fl["kind"] == "fm"}
    dense = [[fd["dense"] for fd in p.fbdelays] for p in progs]
    # state carries: some item runs in two consecutive superblocks
    keys = [{it["key"] for it in p.filters + p.fbdelays} for p in progs]
    assert any(a & b for a, b in zip(keys, keys[1:]))
    if name == "effects":
        assert kinds == {"lim", "f12", "dcb", "fm"}
        assert all(d == [True] for d in dense)
    elif name == "monofbd":
        assert all(d == [True] for d in dense)
    elif name == "latefbd":
        assert dense[0] == [False] and dense[1] == [True]
        assert not any(tm._fbd_dense.values())
    elif name == "changefbd":
        assert dense[0] == [True] and [False] in dense
        ring = next(iter(tm._rings.values()))[0]
        assert ring.shape == (2, FB.FBD_BUFSIZE)
    elif name.startswith("lim"):
        assert kinds == {"lim"}
    elif name == "all_fm":
        assert fms == set(FM.STRUCTKEYS)
    else:
        assert "f12" in kinds
