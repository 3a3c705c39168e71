"""The float stage tier (``stage_mode="float"``) of the port against the
JAX package, a float64 model and the native runtime, on the CPU.

``filter_float_torch`` (``cuda/filter_float.py``, reached through
``filter_float_call`` with CPU tensors) is held against the JAX
function it ports, ``_apply_filter_float``, on numpy-seeded items of
every (kind, inputs, outputs, add) the program tables carry.  The two
associate the scans differently (JAX's ``associative_scan`` tree, the
port's fixed tiles), so they agree within a stated tolerance, not bit
for bit; the emit's saturation and the state's carry from one call to
the next are exact.  The tile algorithm itself is held against a
sample-by-sample float64 loop of the same recurrence.  Renders through
``DeviceRenderer(device="cpu", stage_mode="float")`` are held against
native (the exact tier) and JAX's ``DeviceRenderer(interpret=True,
stage_mode="float")``.  The CUDA kernels are held against the plain
version, bit for bit, on the card by ``chip_smoke.py``.
"""

import copy
import ctypes
import os
import re
import threading
import time
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import audiality2_tpu as a2j
from audiality2_tpu.engine.device_render import DeviceRenderer as JaxRenderer
from audiality2_tpu.tpu import superblock as JSB
import audiality2_tpu_torch as a2t
from audiality2_tpu_torch import serve
from audiality2_tpu_torch.cuda import build
from audiality2_tpu_torch.cuda import filter as FL
from audiality2_tpu_torch.cuda import filter_float as FF
from audiality2_tpu_torch.cuda.mixer import TorchMixer
from audiality2_tpu_torch.engine.device_render import DeviceRenderer
from audiality2_tpu_torch.native import NativeRenderer
from audiality2_tpu_torch.songs import DAMPED_SONG, FLOAT_SONG, RESO_SONG

from test_torch_stage_tail import MIXER_SCRIPTS, _Core, record_superblocks

# Port against JAX, in int32 units of the slots: the outputs reach the
# int32 range (2^31), where a float32 step is 256, and the two scans
# round in different orders.  Measured at most 14,822 (filter12, 2 -> 2,
# both outputs on one slot channel: two outputs' differences in one
# slot), 3,200 elsewhere; the bound is 2^15, 2^-16 of the int32 range.
SLOT_TOL = 1 << 15
# end states (rounded half to even): at most 2 units plus 2 float32 steps
# of the value (the limiter's peak reaches 2^32, where a step is 512);
# measured at most 128 (a peak near 2^31)


def _state_ok(a, b):
    a, b = a.astype(np.int64), b.astype(np.int64)
    return bool((np.abs(a - b) <= 2 + np.abs(b) * 2.0 ** -22).all())


def _sig(ni, no, add, dch=None):
    return (ni, no, add, (0, 1) if ni == 2 else (1,),
            dch or ((1, 0) if no == 2 else (0,)))


def _jax(slots, kind, sig, arr, state):
    js, jst = JSB._apply_filter_float(jnp.asarray(slots), kind, sig,
                                      jnp.asarray(arr), jnp.asarray(state))
    return np.asarray(js), np.asarray(jst)


def _port(slots, kind, sig, arr, state):
    ts = torch.from_numpy(slots.copy())
    tst = torch.from_numpy(state.copy())
    FF.filter_float_call(ts, kind, sig, torch.from_numpy(arr), tst)
    return ts.numpy(), tst.numpy()


def _maxdiff(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


@pytest.mark.parametrize("add", [True, False], ids=["add", "rep"])
@pytest.mark.parametrize("ni,no", [(1, 1), (2, 2), (1, 2), (2, 1)])
@pytest.mark.parametrize("kind", FL.KINDS)
def test_plain_matches_jax(kind, ni, no, add):
    """Padding slices, partial slices, instances that share destination
    slots (REPLACE adds each writer's difference from the same old
    value), the later channel winning a stereo-in / mono-out output."""
    rng = np.random.default_rng(
        100 * FL.KINDS.index(kind) + 10 * ni + 2 * no + add)
    slots, arr, state = FF.seeded_item(rng, kind, ni, no, S=40, K=5)
    sig = _sig(ni, no, add)
    js, jst = _jax(slots, kind, sig, arr, state)
    ts, tst = _port(slots, kind, sig, arr, state)
    assert (js != slots).any() and (ts != slots).any()
    assert _maxdiff(ts, js) <= SLOT_TOL
    assert _state_ok(tst, jst)
    if kind != "lim" and ni == 1:
        # a mono filter's second state channel is zeroed, as in JAX
        assert (tst[:, :, 1] == 0).all()


@pytest.mark.parametrize("kind", ["f12", "lim"])
def test_second_channel_reads_after_first(kind):
    """REPLACE, 2 -> 2, both outputs on one slot channel: the second
    channel's old values are read after the first channel's adds."""
    rng = np.random.default_rng(77)
    slots, arr, state = FF.seeded_item(rng, kind, 2, 2, S=40, K=5)
    sig = _sig(2, 2, False, dch=(0, 0))
    js, jst = _jax(slots, kind, sig, arr, state)
    ts, tst = _port(slots, kind, sig, arr, state)
    assert _maxdiff(ts, js) <= SLOT_TOL
    assert _state_ok(tst, jst)


@pytest.mark.parametrize("ni", [1, 2])
def test_emit_saturates_as_jax(ni):
    """Filter12 gains that drive outputs past the int32 range: the emit
    saturates (JAX's astype(int32)), where PyTorch's own cast of the
    clipped value would wrap 2^31 to -2^31.  Saturated samples are
    equal, the rest within SLOT_TOL (measured: at most 12,288)."""
    v = torch.tensor([3e9, -3e9]).clamp(-FF.F_LIM, FF.F_LIM)
    assert v.to(torch.int32).tolist() == [-(1 << 31)] * 2
    assert FF.sat_i32(torch.tensor([3e9, -3e9])).tolist() \
        == [(1 << 31) - 1, -(1 << 31)]
    rng = np.random.default_rng(5 + ni)
    slots, arr, state = FF.seeded_item(rng, "f12", ni, ni, S=40, K=5,
                                       layout="free", hot=True)
    sig = _sig(ni, ni, False)
    js, jst = _jax(slots, "f12", sig, arr, state)
    ts, tst = _port(slots, "f12", sig, arr, state)
    lim = np.array([(1 << 31) - 1, -(1 << 31)], np.int32)
    jsat, tsat = np.isin(js, lim), np.isin(ts, lim)
    assert jsat.sum() > 100
    assert (jsat == tsat).all() and (ts[jsat] == js[jsat]).all()
    assert _maxdiff(ts, js) <= SLOT_TOL


@pytest.mark.parametrize("kind", FL.KINDS)
def test_state_carries_over(kind):
    """One item's slices in two consecutive calls: the rounded state of
    the first call enters the second, as in JAX."""
    rng = np.random.default_rng(31 + FL.KINDS.index(kind))
    slots, arr, state = FF.seeded_item(rng, kind, 2, 2, S=80, K=5,
                                       layout="free")
    sig = _sig(2, 2, False)
    arr[:, :, 5] = np.where(arr[:, :, 5] == 0, 64 - arr[:, :, 4],
                            arr[:, :, 5])     # no padding at the cut
    js, jst = _jax(slots, kind, sig, arr[:40], state)
    ts, tst = _port(slots, kind, sig, arr[:40], state)
    assert _state_ok(tst, jst)
    js, jst2 = _jax(js, kind, sig, arr[40:], jst)
    ts, tst2 = _port(ts, kind, sig, arr[40:], tst)
    assert _maxdiff(ts, js) <= SLOT_TOL
    assert _state_ok(tst2, jst2)
    assert (tst2 != tst).any()


# ---------------------------------------------------------------
# the tile algorithm against a sample-by-sample float64 loop
# ---------------------------------------------------------------

def _loop64(kind, ni, arr, x, state):
    """The float tier's recurrence one sample at a time in float64:
    x [nch, S, K, 64] inputs; returns outputs [nch_out, S, K, 64]
    (filter: one per input channel; limiter: one per input channel of
    the shared gain) and the end state."""
    S, K = arr.shape[:2]
    a = arr.astype(np.int64)
    xf = x.astype(np.float64)
    out = np.zeros_like(xf)
    st = state.astype(np.float64).copy()
    for s in range(S):
        for n in range(64):
            act = (n >= a[s, :, 4]) & (n < a[s, :, 4] + a[s, :, 5])
            if kind == "lim":
                if ni == 2:
                    lp, rp = np.abs(xf[0, s, :, n]), np.abs(xf[1, s, :, n])
                    mx = np.maximum(lp, rp)
                    pka = mx + np.floor((mx - np.abs(lp - rp)) * 0.5)
                else:
                    pka = np.abs(xf[0, s, :, n])
                pk = np.maximum(st - a[s, :, 6],
                                np.maximum(pka, a[s, :, 7] & 0xFFFFFFFF))
                st = np.where(act, pk, st)
                gain = float(32767 << 16) / np.maximum(
                    np.floor((st + 511) / 512), 1)
                for c in range(ni):
                    out[c, s, :, n] = xf[c, s, :, n] * gain / 65536
                continue
            ns = n - a[s, :, 4]
            if kind == "f12":
                w = (a[s, :, 6] + ns * a[s, :, 7]).astype(np.int32)
                F = (w.astype(np.int64) >> 12) / 4096
                w = (a[s, :, 8] + ns * a[s, :, 9]).astype(np.int32)
                Q = (w.astype(np.int64) >> 12) / 4096
                cF, cQ = F * 8 + 0.5, Q * 8 + 0.5
                hbias = -0.5 + cF + cQ
            else:
                F = (a[s, :, 6] >> 12) / 4096
                Q = np.ones(K)
                cF = F * 8 + 0.5
                hbias = -0.5 + cF + 7.5
            for c in range(2 if ni == 2 else 1):
                d1, d2 = st[:, 0, c], st[:, 1, c]
                xc = xf[c, s, :, n] / 32
                l_ = d2 + F * d1 - cF
                h_ = xc + hbias - cF - l_ - Q * d1
                b_ = d1 + F * h_ - cF
                if kind == "f12":
                    out[c, s, :, n] = (l_ * a[s, :, 10] + b_ * a[s, :, 11]
                                       + h_ * a[s, :, 12]) / 8
                else:
                    out[c, s, :, n] = h_ * 32
                st[:, 0, c] = np.where(act, b_, d1)
                st[:, 1, c] = np.where(act, l_, d2)
    return out, st


@pytest.mark.parametrize("S", [8, 32, 167],
                         ids=["under-a-tile", "one-tile", "ragged-tiles"])
@pytest.mark.parametrize("kind,ni", [("f12", 2), ("dcb", 1), ("lim", 2),
                                     ("lim", 1)])
def test_tiles_match_float64_loop(kind, ni, S):
    """Sequences of 512 samples, exactly one tile (2,048) and 10,688
    (five tiles and a ragged sixth, each instance ending in padding
    slices); every slice in its own slots (add into zeroed outputs, so
    the slots hold the outputs).  Within 2^-16 of the largest output
    plus 2 units (measured: at most 2^-21.6)."""
    K = 3
    rng = np.random.default_rng(S + 7 * ni)
    slots, arr, state = FF.seeded_item(rng, kind, ni, ni, S=S, K=K,
                                       layout="free")
    # audio and state at levels that keep the outputs in the int32 range
    slots = (slots >> 3).astype(np.int32)
    state = state >> 8 if kind == "lim" else (state >> 6).astype(np.int32)
    cols = arr[:, :, :4].astype(np.int64)
    slots[cols[:, :, 2:4].ravel()] = 0
    x = np.stack([slots[cols[:, :, c], ch]
                  for c, ch in ((0, 0), (1, 1))[:ni]])
    sig = (ni, ni, True, (0, 1)[:ni], (0, 1)[:ni])
    ts, tst = _port(slots, kind, sig, arr, state)
    want, st64 = _loop64(kind, ni, arr, x, state)
    got = np.stack([ts[cols[:, :, 2 + c], c] for c in range(ni)])
    act = (np.arange(64) >= arr[:, :, 4:5]) \
        & (np.arange(64) < arr[:, :, 4:5] + arr[:, :, 5:6])
    want = np.where(act, np.trunc(want), 0)
    scale = np.abs(want).max()
    assert scale > 1 << 18 and scale < 1 << 31
    err = np.abs(got - want).max()
    assert err <= scale * 2.0 ** -14 + 2, (err, scale)
    if kind != "lim" and ni == 1:
        # a mono filter's second state channel is zeroed, as in JAX
        assert (tst[:, :, 1] == 0).all()
        tst, st64 = tst[:, :, :1], st64[:, :, :1]
    st_err = np.abs(tst.astype(np.float64) - np.round(st64)).max()
    assert st_err <= np.abs(st64).max() * 2.0 ** -14 + 2


# ---------------------------------------------------------------
# renders: native (the exact tier), JAX's float tier
# ---------------------------------------------------------------

def _rms_db(mine, ref):
    d = mine.astype(np.float64) - ref.astype(np.float64)
    r = np.sqrt((ref.astype(np.float64) ** 2).mean())
    return 20 * np.log10(np.sqrt((d ** 2).mean()) / r + 1e-30)


def _render(pkg, cls, src, channels, frames, sb, **kw):
    i = pkg.open_engine(44100, 4096, channels, batched=False)
    song = i.get(i.load_string(src, "t"), "Song")
    r = cls(i, channels=channels, **kw)
    r.timestamp_reset()
    r.start(0, song)
    if cls is NativeRenderer:
        out = np.concatenate([r.run(sb) for _ in range(-(-frames // sb))],
                             axis=1)[:, :frames]
    else:
        out = np.stack(r.render(frames, bufsize=sb))
        assert not r.fell_back
    r.close()
    return out


@pytest.fixture
def float_items(monkeypatch):
    """The kinds of the items that the port's float tier ran."""
    seen = []
    plain = FF.filter_float_torch

    def spy(slots, kind, *args):
        seen.append(kind)
        return plain(slots, kind, *args)
    monkeypatch.setattr(FF, "filter_float_torch", spy)
    return seen


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FLOAT_FRAMES = int(1.8 * 44100) // 64 * 64


def test_float_render_within_budget(float_items):
    """FLOAT_SONG, 1.8 s stereo in superblocks of 16,384 frames: its
    dcblock and limiter take the float tier, its filter12 (q under the
    eligibility threshold) the exact one, in the port as in JAX.  Within
    -80 dB of native, not equal to it, and within -90 dB of JAX's float
    tier (measured: -88.7 dB against native, -134.2 dB and at most 2
    units against JAX)."""
    frames, sb = FLOAT_FRAMES, 16384
    got = _render(a2t, DeviceRenderer, FLOAT_SONG, 2, frames, sb,
                  device="cpu", stage_mode="float")
    assert set(float_items) == {"dcb", "lim"}
    nat = _render(a2t, NativeRenderer, FLOAT_SONG, 2, frames, sb)
    jax = _render(a2j, JaxRenderer, FLOAT_SONG, 2, frames, sb,
                  interpret=True, stage_mode="float")
    assert got.shape == nat.shape == jax.shape
    assert _rms_db(got, nat) <= -80.0
    assert (got != nat).any()
    assert _rms_db(got, jax) <= -90.0


def test_damped_filter_render_tracks_jax(float_items):
    """DAMPED_SONG: every class, filter12 included, takes the float
    tier.  The JAX package's float tier lands at -74.4 dB of native on
    it (short of its own -80 dB budget); the port lands within 0.5 dB of
    that and within -100 dB of JAX (measured -118.1 dB, at most 7
    units)."""
    frames, sb = FLOAT_FRAMES, 16384
    got = _render(a2t, DeviceRenderer, DAMPED_SONG, 2, frames, sb,
                  device="cpu", stage_mode="float")
    assert set(float_items) == set(FL.KINDS)
    nat = _render(a2t, NativeRenderer, DAMPED_SONG, 2, frames, sb)
    jax = _render(a2j, JaxRenderer, DAMPED_SONG, 2, frames, sb,
                  interpret=True, stage_mode="float")
    assert abs(_rms_db(got, nat) - _rms_db(jax, nat)) <= 0.5
    assert _rms_db(got, jax) <= -100.0


def test_resonant_render_stays_exact(float_items):
    """RESO_SONG's filter12 class falls under the eligibility threshold:
    under stage_mode="float" it keeps the exact scan, bit-equal to
    native and to JAX's float tier."""
    frames, sb = int(1.0 * 44100) // 64 * 64, 16384
    got = _render(a2t, DeviceRenderer, RESO_SONG, 1, frames, sb,
                  device="cpu", stage_mode="float")
    assert float_items == []
    nat = _render(a2t, NativeRenderer, RESO_SONG, 1, frames, sb)
    jax = _render(a2j, JaxRenderer, RESO_SONG, 1, frames, sb,
                  interpret=True, stage_mode="float")
    assert np.abs(got).max() > 0
    assert (got == nat).all() and (got == jax).all()


@pytest.mark.parametrize("mode", ["many", "multiplexed"])
def test_serve_float_matches_solo(mode, float_items):
    """Both serving entry points take stage_mode="float": two streams of
    DAMPED_SONG (different pitches) equal their solo float renders bit
    for bit, the float tier running every filter kind."""
    frames, sb = 2 * 16384, 16384
    jobs, solo = [], []
    for p in (0.0, 0.5):
        i = a2t.open_engine(44100, 4096, 2, batched=False)
        song = i.get(i.load_string(DAMPED_SONG, "t"), "Song")
        jobs.append(serve.StreamJob(i, song, frames, args=(p,),
                                    channels=2))
        i = a2t.open_engine(44100, 4096, 2, batched=False)
        song = i.get(i.load_string(DAMPED_SONG, "t"), "Song")
        r = DeviceRenderer(i, channels=2, device="cpu", stage_mode="float")
        r.timestamp_reset()
        r.start(0, song, p)
        solo.append(np.stack(r.render(frames, bufsize=sb)))
        r.close()
    del float_items[:]
    if mode == "many":
        serve.render_many(jobs, bufsize=sb, device="cpu",
                          stage_mode="float")
    else:
        serve.render_multiplexed(jobs, bufsize=sb, device="cpu",
                                 stage_mode="float")
    assert set(float_items) == set(FL.KINDS)
    for j, want in zip(jobs, solo):
        assert j.error is None and not j.renderer.fell_back
        assert (np.stack(j.output) == want).all()


@pytest.mark.parametrize("name", ["effects", "float_src", "reso_src",
                                  "lim_mono"])
def test_signature_float_matches_device_mixer(name):
    """_signature under stage_mode="float" equals the JAX mixer's, the
    quality element (bit 16) and each filter item's eligibility flag
    included."""
    src, program, channels, frames, count = MIXER_SCRIPTS[name]
    progs, tpa, jpa = record_superblocks(src, program, channels, frames,
                                         count)
    tm = TorchMixer(_Core(tpa), device="cpu", stage_mode="float")
    jm = JSB.DeviceMixer(_Core(jpa), interpret=True, stage_mode="float")
    for p in progs:
        tp, jp = copy.deepcopy(p), copy.deepcopy(p)
        tm._repad(tp)
        jm._repad(jp)
        ts, js = tm._signature(tp), jm._signature(jp)
        assert ts == js
        assert ts[10] & 16
        if tp.filters:
            assert any(len(x) == 3 and x[0] == "filt" for x in ts[11])



def test_binding_matches_c_interface():
    """The ctypes signatures of ``a2_filter_float`` (the launch) and
    ``a2_filter_float_plan`` have the C entry points' parameters,
    pointer for pointer and int for int (a missing int makes every call
    raise; a pointer bound as int is cut)."""
    src = open(os.path.join(os.path.dirname(FF.__file__), "csrc",
                            "filter_float_kernel.cu")).read()
    names = ("a2_filter_float", "a2_filter_float_plan")
    lib = types.SimpleNamespace(**{n: types.SimpleNamespace()
                                   for n in names})
    FF._bind(lib)
    for name in names:
        params = re.search(r'extern "C" int %s\(([^)]*)\)' % name,
                           src).group(1).split(",")
        want = [ctypes.c_void_p if "*" in p else ctypes.c_int
                for p in params]
        assert getattr(lib, name).argtypes == want
        assert getattr(lib, name).restype is ctypes.c_int


def test_build_runs_one_at_a_time(monkeypatch):
    """build.build() called from several threads at once (a renderer's
    warm-up thread and a wrapper's first call, as the float kernel's
    launch plan makes one): the nvcc rounds take turns, so two never
    write the same temporary library."""
    inside, most = [0], [0]

    def fake(verbose):
        inside[0] += 1
        most[0] = max(most[0], inside[0])
        time.sleep(0.05)
        inside[0] -= 1
        return {}
    monkeypatch.setattr(build, "_build", fake)
    threads = [threading.Thread(target=build.build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert most[0] == 1


@pytest.mark.parametrize("T,S", [(1, 32), (2, 40), (88, 2797)],
                         ids=["T1", "T2", "T88"])
@pytest.mark.parametrize("ni", [1, 2], ids=["mono", "stereo"])
@pytest.mark.parametrize("kind", FL.KINDS)
def test_tile_entries_match_scan(kind, ni, T, S, monkeypatch):
    """The kernel's order of the tile prefix (each tile applies the
    roots of tiles 0 .. t-1 to the chain's entry state itself,
    ``tile_entries``) is bit-equal to the plain version's serial pass
    (``serial_entries``, inside ``_scan``): every tile's entry state and
    the end state, on the maps and states of seeded items; T = 88 is the
    effects song's master limiter (2,797 slices)."""
    scans = []
    plain = FF._scan

    def spy(maps, s0, comb, apply):
        out = plain(maps, s0, comb, apply)
        scans.append((maps, s0, comb, apply, out[1]))
        return out
    monkeypatch.setattr(FF, "_scan", spy)
    rng = np.random.default_rng(400 + 10 * T + ni)
    slots, arr, state = FF.seeded_item(rng, kind, ni, ni, S=S, K=3,
                                       layout="free")
    _port(slots, kind, _sig(ni, ni, False), arr, state)
    assert len(scans) == (2 if kind != "lim" and ni == 2 else 1)

    def bits(v):
        return v.contiguous().view(torch.int32)
    for maps, s0, comb, apply, end in scans:
        root = FF.tile_roots(maps, comb)
        assert root[0].shape == (3, T)
        want, want_end = FF.serial_entries(root, s0, apply)
        got, got_end = FF.tile_entries(root, s0, apply)
        for g, w in zip(got + got_end, want + want_end):
            assert torch.equal(bits(g), bits(w))
        for g, w in zip(got_end, end):
            assert torch.equal(bits(g), bits(w))
        # the entries move: each tile's state is not the chain's own
        assert T == 1 or not torch.equal(got[0][:, -1], got[0][:, 0])
