"""The schedules of the port's fbdelay kernels (``cuda/csrc/
fbdelay_kernel.cu``), checked on the CPU.

Dense form: the kernel walks the feedback loop as fb residue chains
(thread r carries the pair at t - fb along t = r, r + fb, ...).
``chain_walk`` below is a torch model of that walk; it must be
bit-equal to the plain chunked loop ``fbd_dense_torch`` and, put in the
place of the loop inside ``apply_fbdelay_dense``, to the JAX function
``_apply_fbdelay_dense``, for short, long and maximal delays, a
superblock shorter than the delay or not a multiple of it, and
negative gains.

Legacy form: the kernel keeps the JAX scan's order within a chunk step
(every tap read before any write, a grid barrier between), because a
tap can fall on a position its own step writes: a delay shorter than a
fragment (chunk 1), or one near the ring's 2^20 that wraps forward.
The tests show that such tables exist, that delays of at least a chunk
never alias (seeded tables with partial slices, and the late fbdelay
song's real record), and hold the plain loop against the JAX function
on the aliasing tables, which ``chip_smoke.py`` also gives the kernel.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiality2_tpu.tpu import superblock as JSB
import audiality2_tpu_torch as a2t
from audiality2_tpu_torch.cuda import fbdelay as FB
from audiality2_tpu_torch.cuda.osc_kernel import _w
from audiality2_tpu_torch.engine.device_render import (DeviceRenderer,
                                                       SUPERBLOCK_FRAMES)
from audiality2_tpu_torch.songs import LATE_FBDELAY_SONG


def _diff(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    return int((a != b).sum())


# ---------------------------------------------------------------
# dense: the residue-chain walk
# ---------------------------------------------------------------

def chain_walk(x, g, buf, fb):
    """Model of fbd_dense_kernel: chain r < min(fb, npad) starts from
    the tail's pair at 2^17 + r - fb and carries it along t = r, r + fb,
    ... < npad (link k of every chain at once); fills buf[:, 2^17:] in
    place and returns o_fb int32 [2, npad]."""
    D = FB.FBD_TAIL
    npad = x.shape[1]
    r = torch.arange(min(fb, npad))
    v = buf[:, D + r - fb].to(torch.int64)
    ofb = torch.empty((2, npad), dtype=torch.int32)
    for k in range(-(-npad // fb)):
        t = r + k * fb
        live = t < npad
        t = t[live]
        # channel 0 taps channel 1's value at t - fb, and back
        f = _w((v[[1, 0]][:, live] * g[t].to(torch.int64)) >> 16)
        nv = _w(x[:, t].to(torch.int64) + f)
        ofb[:, t] = f.to(torch.int32)
        buf[:, D + t] = nv.to(torch.int32)
        v[:, live] = nv
    return ofb


DENSE_FB = [64, 100, 1000, 8192, FB.FBD_TAIL]
GAINS = ["seeded", "negative"]


def dense_case(fb, gains, F=12):
    """seeded_dense's table at delay fb; "negative" makes every feedback
    gain negative, down to -2.0 in 16.16."""
    rng = np.random.default_rng(fb + 7 * (gains == "negative"))
    slots, arr, tail, par = FB.seeded_dense(rng, F, fb=fb)
    if gains == "negative":
        arr[:, FB.C_FBG] = -rng.integers(1, 1 << 17, arr.shape[0])
    return slots, arr, tail, (True, True, True, FB.chunk_for(fb)) + par


@pytest.mark.parametrize("gains", GAINS)
@pytest.mark.parametrize("fb", DENSE_FB)
def test_chain_walk_matches_plain_loop(fb, gains):
    """The chain walk against the chunked plain loop on the loop's own
    inputs: o_fb and the whole buffer."""
    F = 12
    slots, arr, tail, sig = dense_case(fb, gains, F)
    x, g, _ = FB.fbd_dense_inputs(torch.from_numpy(slots), sig,
                                  torch.from_numpy(arr), F)
    npad = x.shape[1]
    if fb == FB.FBD_TAIL:
        assert npad < fb
    if fb in (100, 1000):
        assert npad % fb
    if gains == "negative":
        assert (g[:F * 64] < 0).all()
    bufs = []
    for _ in range(2):
        b = torch.empty((2, FB.FBD_TAIL + npad), dtype=torch.int32)
        b[:, :FB.FBD_TAIL] = torch.from_numpy(tail)
        bufs.append(b)
    want = FB.fbd_dense_torch(x, g, bufs[0], fb, sig[3])
    got = chain_walk(x, g, bufs[1], fb)
    assert _diff(got.numpy(), want.numpy()) == 0
    assert _diff(bufs[1].numpy(), bufs[0].numpy()) == 0


@pytest.mark.parametrize("gains", GAINS)
@pytest.mark.parametrize("fb", DENSE_FB)
def test_chain_walk_stage_matches_jax(fb, gains, monkeypatch):
    """apply_fbdelay_dense with the chain walk as its loop against the
    JAX _apply_fbdelay_dense: slots and the new tail."""
    F = 12
    slots, arr, tail, sig = dense_case(fb, gains, F)
    js, jtail = JSB._apply_fbdelay_dense(jnp.asarray(slots), sig,
                                         jnp.asarray(arr),
                                         jnp.asarray(tail), F)
    monkeypatch.setattr(FB, "fbd_dense_call",
                        lambda x, g, buf, fb, C: chain_walk(x, g, buf, fb))
    ts = torch.from_numpy(slots.copy())
    ttail = FB.apply_fbdelay_dense(ts, sig, torch.from_numpy(arr),
                                   torch.from_numpy(tail.copy()), F)
    assert _diff(ts.numpy(), js) == 0
    assert _diff(ttail.numpy(), jtail) == 0
    assert (ts.numpy() != slots).any()


# ---------------------------------------------------------------
# legacy: can a step's taps fall on its own writes?
# ---------------------------------------------------------------

def step_aliases(arr, bufpos, C):
    """How many taps of each chunk step read a ring position that the
    same step writes (numpy, over the legacy table arr [NS, 13])."""
    a = arr.astype(np.int64)
    M = FB.FBD_BUFSIZE - 1
    frames = a[:, FB.C_FRAMES]
    starts = bufpos + np.cumsum(frames) - frames
    n = np.arange(FB.FRAG)[None, :]
    wid = (starts[:, None] + n) & M
    tap = (wid - a[:, FB.C_FB:FB.C_FB + 1]) & M
    live = n < frames[:, None]
    return [int(np.isin(tap[s:s + C], wid[s:s + C][live[s:s + C]]).sum())
            for s in range(0, a.shape[0], C)]


@pytest.mark.parametrize("C", [1, 4, 256])
def test_legacy_chunk_delays_never_alias(C):
    """Delays of at least a chunk (program_from_native's chunk rule),
    partial slices and padding rows: no tap of a step, masked ones
    included, reads a position the step writes."""
    for seed in range(4):
        rng = np.random.default_rng(seed)
        _, arr, _, bufpos = FB.seeded_legacy(rng, C, nslices=3 * C + 5)
        frames = arr[:, FB.C_FRAMES]
        assert ((frames > 0) & (frames < FB.FRAG)).any()
        assert sum(step_aliases(arr, bufpos, C)) == 0


def test_legacy_real_record_never_aliases():
    """The late fbdelay song's recorded superblock (the legacy form)."""
    src, program = LATE_FBDELAY_SONG, "SongMain"
    i = a2t.open_engine(44100, 4096, 1, batched=False)
    s = i.get(i.load_string(src, "late"), program)
    r = DeviceRenderer(i, channels=1, device="cpu")
    r.timestamp_reset()
    r.start(0, s)
    prog = r.record_program(SUPERBLOCK_FRAMES)
    r.close()
    assert prog.fbdelays
    for fd in prog.fbdelays:
        assert not fd["dense"]
        assert sum(step_aliases(fd["arr"], 12345, fd["chunk"])) == 0


# tables whose taps fall on their own step's writes: delays of 1-100
# samples in chunks of one slice, and delays 50-150 short of the ring
ALIASING = {"short": (1, 1), "wrap": (4, FB.FBD_BUFSIZE - 150)}


@pytest.mark.parametrize("case", list(ALIASING))
def test_legacy_aliasing_tables_exist(case):
    C, fb = ALIASING[case]
    _, arr, _, bufpos = FB.seeded_legacy(np.random.default_rng(3), C, fb=fb)
    assert sum(step_aliases(arr, bufpos, C)) > 0


@pytest.mark.parametrize("case", list(ALIASING))
def test_legacy_aliasing_plain_matches_jax(case):
    """On those tables the plain loop (taps read before writes, as the
    kernel does across its barrier) equals the JAX _apply_fbdelay."""
    C, fb = ALIASING[case]
    slots, arr, ring, bufpos = FB.seeded_legacy(np.random.default_rng(3), C,
                                                fb=fb)
    sig = (True, True, True, C)
    js, jring = JSB._apply_fbdelay(jnp.asarray(slots), sig,
                                   jnp.asarray(arr), jnp.asarray(ring),
                                   jnp.int32(bufpos))
    ts = torch.from_numpy(slots.copy())
    tring = torch.from_numpy(ring.copy())
    FB.apply_fbdelay(ts, sig, torch.from_numpy(arr), tring, bufpos)
    assert _diff(ts.numpy(), js) == 0
    assert _diff(tring.numpy(), jring) == 0
    assert (tring.numpy() != ring).any()
