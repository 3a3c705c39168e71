"""The port's program builder and TorchMixer against the JAX package.

One native record pass feeds both builders (the port's
``cuda/superblock.program_from_native`` and the JAX package's): the
programs must be equal table for table.  Then ``TorchMixer(device=
"cpu")`` (the oscillator's plain version) must equal
``DeviceMixer(interpret=True)`` exactly, mono and stereo, on the slice
song and two short scripts: pitch ramps only, and a waveshaper stage;
and on an fbdelay item (the rest of the stage tail is in
``test_torch_stage_tail.py``).
"""

import copy

import numpy as np
import pytest
import torch

from audiality2_tpu.tpu import superblock as JSB
from audiality2_tpu.tpu.osc_kernel import PairAtlas as JPairAtlas
import audiality2_tpu_torch as a2t
from audiality2_tpu_torch.cuda import superblock as SB
from audiality2_tpu_torch.cuda.mixer import (TorchMixer, _StateSet,
                                             blob_layout, blob_views, rowless)
from audiality2_tpu_torch.cuda.osc_kernel import PairAtlas
from audiality2_tpu_torch.native import NativeRenderer
from audiality2_tpu_torch.songs import EFFECTS_SONG, SLICE_SONG

PITCH_SONG = """
Song()
{
	struct { wtosc; panmix }
	w saw; a .3; p -1; pan -.4
	d 5
	p 1.5; d 150
	p -.5; pan .6; d 90
	p 2; d 200
	p 0; d 120
	a 0; d 20
}
"""

WS_SONG = """
Song()
{
	struct { wtosc; waveshaper; panmix }
	w saw; a .8; p 0; amount .5; pan .2
	d 120
	amount 2; p .5; d 600
	a 0; amount 0; d 60
}
"""

FBD_SONG = """
Song()
{
	struct { wtosc; fbdelay; panmix }
	drygain .5; fbgain .4; lgain .4; rgain .4
	w saw; a .3; p 0
	d 300
	a 0; d 50
}
"""


class _Core:
    """The mixers read the pair atlas from ``core._pair_atlas``."""

    def __init__(self, atlas):
        self._pair_atlas = atlas


def record(src, channels, frames, skip=0):
    """Records one superblock of `src`'s Song (after `skip` recorded
    frames) and builds it with both packages' builders, whose pair
    atlases fill in lockstep.  Returns (port program, JAX program,
    port atlas, JAX atlas)."""
    i = a2t.open_engine(44100, 4096, channels, batched=False)
    song = i.get(i.load_string(src, "t"), "Song")
    nr = NativeRenderer(i, channels=channels)
    nr.timestamp_reset()
    nr.start(0, song)
    if skip:
        nr.record(skip)
    rows, stages, stash, nfrag = nr.record(frames)
    nr.close()
    tpa, jpa = PairAtlas(), JPairAtlas()
    seen = set()

    def entry(handle, mip):
        if handle not in seen:
            seen.add(handle)
            w = i.state.ss.hm.get(handle).data
            tpa.add_wave(handle, w)
            tpa.finalize()
            jpa.add_wave(handle, w)
            jpa.finalize()
        return tpa.lookup(handle, mip)

    mch = nr.master_channels
    args = (rows, stages, stash, nfrag, [64] * nfrag, entry, mch)
    return (SB.program_from_native(*args), JSB.program_from_native(*args),
            tpa, jpa)


def _assert_same_program(p, q):
    for name in ("F", "ninst", "master_inst", "master_channels", "nruns",
                 "has_ramp", "Rtot", "frag_sizes"):
        assert getattr(p, name) == getattr(q, name), name
    for name in ("runmat", "rampmat", "inst_of", "stash_audio",
                 "stash_slot", "stash_mono", "stash_mono_slot"):
        a, b = getattr(p, name), getattr(q, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert len(p.class_blocks) == len(q.class_blocks)
    for (c1, n1, t1), (c2, n2, t2) in zip(p.class_blocks, q.class_blocks):
        assert (c1, n1) == (c2, n2) and np.array_equal(t1, t2)
    assert len(p.stages) == len(q.stages)
    for s1, s2 in zip(p.stages, q.stages):
        assert s1["key"] == s2["key"] and s1["n"] == s2["n"]
        assert np.array_equal(s1["arr"], s2["arr"])
        assert np.array_equal(s1["dense"], s2["dense"])
    assert len(p.fbdelays) == len(q.fbdelays)
    assert len(p.filters) == len(q.filters)


CASES = [("slice", SLICE_SONG, 8192, 4096), ("pitch", PITCH_SONG, 8192, 0),
         ("ws", WS_SONG, 8192, 0)]


@pytest.fixture(scope="module")
def programs():
    """(name, channels) -> (port prog, JAX prog, port atlas, JAX atlas),
    built once per module."""
    return {(name, ch): record(src, ch, frames, skip)
            for name, src, frames, skip in CASES for ch in (1, 2)}


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_program_from_native_matches_original(programs, name, channels):
    prog, jprog, _, _ = programs[(name, channels)]
    _assert_same_program(prog, jprog)
    assert prog.Rtot > 0
    if name == "ws":
        assert any(s["kind"] == "ws" for s in prog.stages)
    if name in ("slice", "pitch"):
        assert prog.has_ramp


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_torch_mixer_matches_device_mixer(programs, name, channels):
    prog, jprog, tpa, jpa = programs[(name, channels)]
    got = TorchMixer(_Core(tpa), device="cpu").run(prog)
    want = JSB.DeviceMixer(_Core(jpa), interpret=True).run(jprog)
    assert len(got) == len(want) == channels
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == w.shape
        assert int((g != w).sum()) == 0
    assert any(np.abs(g).max() > 0 for g in got)


def test_torch_mixer_i16_readback(programs):
    prog, _, tpa, _ = programs[("slice", 2)]
    exact = TorchMixer(_Core(tpa), device="cpu").run(prog)
    i16 = TorchMixer(_Core(tpa), device="cpu", readback="i16").run(prog)
    for e, q in zip(exact, i16):
        assert (q == (np.clip(e >> 8, -32768, 32767) << 8)).all()


def _run_halves(mixer, sig, blob):
    """The body's two halves on a blob: (master of _body, master of
    _expand then _tail, the expanded slots), each from a fresh state
    set."""
    v = blob_views(torch.from_numpy(blob), blob_layout(sig)[0])
    F, ninst, mch = sig[0], sig[1], sig[3]
    body = torch.zeros((F, mch, 64), dtype=torch.int32)
    mixer._body(sig, v, _StateSet(sig, "cpu"), body)
    slots = torch.zeros((ninst * F + 1, 2, 64), dtype=torch.int32)
    mixer._expand(sig, v, slots)
    expanded = slots.clone()        # the tail adds into its slots
    halves = torch.zeros_like(body)
    mixer._tail(sig, v, _StateSet(sig, "cpu"), slots, halves)
    return body, halves, expanded


@pytest.mark.parametrize("name", ["effects", "slice"])
def test_expand_and_tail_equal_body(name):
    """_body is _expand then _tail; the stage half also runs from the
    rowless blob (``_prepare(rows=False)``) on the expanded slots."""
    src, frames, skip = {"effects": (EFFECTS_SONG, 4096, 8192),
                         "slice": (SLICE_SONG, 8192, 4096)}[name]
    prog, _, tpa, _ = record(src, 2, frames, skip)
    prog2 = copy.deepcopy(prog)
    mixer = TorchMixer(_Core(tpa), device="cpu")
    sig, blob, _, _ = mixer._prepare(prog)
    body, halves, slots = _run_halves(mixer, sig, blob)
    assert torch.equal(halves, body)
    assert int(body.abs().max()) > 0
    if name == "effects":
        assert any(t == "filt" and k[2] == "fm" for t, k, _ in sig[11])
        assert any(t == "fbd" for t, _, _ in sig[11])
    other = TorchMixer(_Core(tpa), device="cpu")
    tsig, tblob, _, _ = other._prepare(prog2, rows=False)
    assert tsig == rowless(sig) and not tsig[4] and not tsig[5]
    assert len(tblob) < len(blob)
    tail = torch.zeros_like(body)
    other._tail(tsig, blob_views(torch.from_numpy(tblob),
                                 blob_layout(tsig)[0]),
                _StateSet(tsig, "cpu"), slots, tail)
    assert torch.equal(tail, body)


STAGE_KEYS = [
    (0, 2, "panmix", 1, 1, True, (0,), (0,)),
    (0, 2, "panmix", 1, 2, True, (0,), (0, 1)),
    (0, 2, "panmix", 1, 2, False, (1,), (1, 0xFF)),
    (0, 2, "panmix", 2, 1, True, (0, 1), (1,)),
    (0, 2, "panmix", 2, 2, False, (0, 1), (0, 1)),
    (0, 2, "panmix", 2, 2, True, (1, 0), (0xFF, 0)),
    (0, 4, "copy", 0, True, (1,), (0,)),
    (0, 4, "copy", 1, False, (0,), (1,)),
    (0, 3, "ws", 0, True, (0,), (0,)),
    (0, 3, "ws", 1, False, (1,), (1,)),
]


def _stage_tables(key, rng, ninst=6, F=8, G=3, K=40):
    """Seeded slots plus dense [G, F, 9] and legacy [K, 9] tables for
    one stage key; REPLACE dense groups get distinct destination spans
    (as the builder guarantees)."""
    nslot = ninst * F + 1
    slots = rng.integers(-(1 << 24), 1 << 24, (nslot, 2, 64)) \
        .astype(np.int32)

    def params(n):
        a = np.zeros((n, 9), np.int64)
        a[:, 2] = rng.integers(0, 64, n) * (rng.random(n) < 0.5)
        a[:, 3] = rng.integers(0, 65, n)
        a[:, 3] = np.minimum(a[:, 3], 64 - a[:, 2])
        if key[2] == "ws":
            a[:, 4] = rng.integers(0, 3 << 24, n)
            a[:, 5] = rng.integers(-(1 << 16), 1 << 16, n)
        else:
            a[:, 4] = rng.integers(0, 1 << 25, n)
            a[:, 5] = rng.integers(-(1 << 12), 1 << 12, n)
            a[:, 6] = rng.integers(-(1 << 24), 1 << 24, n)
            a[:, 7] = rng.integers(-(1 << 12), 1 << 12, n)
            a[:, 8] = rng.integers(0, 2, n)
        return a

    src = rng.integers(0, ninst, G)
    dst = rng.permutation(ninst)[:G]
    dense = np.zeros((G, F, 9), np.int64)
    for g in range(G):
        dense[g] = params(F)
        dense[g, :, 0] = src[g] * F + np.arange(F)
        dense[g, :, 1] = dst[g] * F + np.arange(F)
    leg = params(K)
    leg[:, 0] = rng.integers(0, nslot, K)
    leg[:, 1] = np.sort(rng.integers(0, nslot, K))
    return slots, dense.astype(np.int32), leg.astype(np.int32), F


@pytest.mark.parametrize("key", STAGE_KEYS, ids=lambda k: "-".join(
    str(x) for x in k[2:5]) + ("-add" if k[-3] is True else ""))
def test_stage_paths_match_original(key):
    """Dense and legacy stage paths (panmix 1->1/1->2/2->1/2->2 with
    dropped channels, copy, waveshaper; ADD and REPLACE) on seeded
    slot arrays, against the JAX mixer's stage functions."""
    import jax.numpy as jnp
    import torch
    from audiality2_tpu_torch.cuda import mixer as M
    rng = np.random.default_rng(len(str(key)))
    slots, dense, leg, F = _stage_tables(key, rng)
    want = JSB._apply_stage(JSB._apply_stage_dense(
        jnp.asarray(slots), key, jnp.asarray(dense)), key, jnp.asarray(leg))
    got = torch.from_numpy(slots.copy())
    M._apply_stage_dense(got, key, torch.from_numpy(dense).long(), F)
    M._apply_stage(got, key, torch.from_numpy(leg).long())
    assert int((got.numpy() != np.asarray(want)).sum()) == 0
    assert (got.numpy() != slots).any()


def test_fbdelay_item_raises_unsupported():
    """An fbdelay item (which raised Unsupported before the stage tail
    was ported) now runs on TorchMixer and equals the JAX mixer."""
    import copy
    prog, jprog, tpa, jpa = record(FBD_SONG, 2, 4096)
    assert prog.fbdelays
    got = TorchMixer(_Core(tpa), device="cpu").run(prog)
    want = JSB.DeviceMixer(_Core(jpa), interpret=True).run(
        copy.deepcopy(jprog))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape and int((g != w).sum()) == 0
    assert any(np.abs(g).max() > 0 for g in got)
