"""The port's pipelined renderer and the mixer's signature, chain and
batch machinery, on the CPU.

``DeviceRenderer(device="cpu").render`` (profile pass, dispatch thread,
fetch pool, chained dispatch) must equal the native renderer over whole
superblocks and the JAX package's ``DeviceRenderer(interpret=True)``,
with 0 mismatches, for every pipeline shape.  ``TorchMixer``'s padding
and signature equal the JAX ``DeviceMixer``'s; chained and batched
dispatches equal the same programs dispatched one by one; two streams
on one shared mixer keep their state apart; a record fault bridges
natively at the emitted frontier, sample-exactly, while a dispatch or
fetch fault is raised after what the device finished; renders wait for
the kernel build; a graph capture counts only its own thread's kernel
launches."""

import copy
import threading
import time

import numpy as np
import pytest
import torch

import audiality2_tpu as a2j
from audiality2_tpu.engine.device_render import DeviceRenderer as JaxRenderer
from audiality2_tpu.tpu import superblock as JSB
import audiality2_tpu_torch as a2t
from audiality2_tpu_torch.cuda import build
from audiality2_tpu_torch.cuda import mixer as M
from audiality2_tpu_torch.cuda.mixer import TorchMixer
from audiality2_tpu_torch.cuda.superblock import program_from_native
from audiality2_tpu_torch.engine.device_render import DeviceRenderer
from audiality2_tpu_torch.native import NativeRenderer
from audiality2_tpu_torch.songs import (EFFECTS_SONG, LATE_FBDELAY_SONG,
                                        SLICE_SONG)

from test_torch_stage_tail import MIXER_SCRIPTS, _Core, record_superblocks
from test_torch_render import MIDFALL_SCRIPT

SB = 8192

# a filtered voice whose pitch and cutoff come from the program's
# arguments, through a mono fbdelay: two streams of it with different
# arguments hold different filter and ring state under the same item
# keys and unit serials
ARG_SONG = """
Voice(P C)
{
	struct { wtosc; filter12; panmix }
	lp 1; w saw; p P; a .3
	cutoff C; q .8
	d 40
	cutoff (C + 1); d 40
	a 0; d 20
}
Song(P=0 C=2)
{
	struct { inline; fbdelay; panmix }
	fbdelay 150; ldelay 120; rdelay 90
	drygain .6; fbgain .4; lgain .3; rgain .3
	!n 0
	20 {
		Voice (P + n * .05) C
		+n 1
		d 25
	}
	d 200
}
"""


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the renders' own threads (dispatch, fetch,
    record) then do not compete with idle-spinning torch workers when
    the suite runs several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _open(pkg, src, channels, cls, program="Song", args=(), **kw):
    i = pkg.open_engine(44100, 4096, channels, batched=False)
    song = i.get(i.load_string(src, "t"), program)
    r = cls(i, channels=channels, **kw)
    r.timestamp_reset()
    r.start(0, song, *args)
    return r


def native(src, channels, frames, program="Song", args=(), sb=SB):
    """Native render of whole superblocks of sb frames, trimmed."""
    r = _open(a2t, src, channels, NativeRenderer, program, args)
    out = np.concatenate([r.run(sb) for _ in range(-(-frames // sb))],
                         axis=1)
    r.close()
    return out[:, :frames]


def _same(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int((a != b).sum())


# song -> (source, program, channels, frames rendered)
SONGS = {"slice": (SLICE_SONG, "Song", 2, 4 * SB - 100),
         "effects": (EFFECTS_SONG, "Song", 2, 3 * SB),
         "latefbd": (LATE_FBDELAY_SONG, "SongMain", 1, 4 * SB)}


@pytest.fixture(scope="module")
def refs():
    """Per song: the native render and the JAX package's pipelined
    render (interpret mode, profile pass) of the same frames."""
    out = {}
    for name, (src, program, ch, frames) in SONGS.items():
        r = _open(a2j, src, ch, JaxRenderer, program, interpret=True)
        jax_out = r.render(frames, bufsize=SB)
        assert not r.fell_back
        r.close()
        out[name] = (native(src, ch, frames, program), np.asarray(jax_out))
    return out


# (song, chain_dispatch, pipeline_depth, sink)
PIPELINES = [("slice", 1, 1, False), ("slice", 1, 3, True),
             ("slice", 3, 1, True), ("slice", 3, 3, False),
             ("effects", 3, 3, True), ("latefbd", 3, 1, False),
             ("latefbd", 1, 3, True)]


@pytest.mark.parametrize("song,chain,depth,use_sink", PIPELINES)
def test_render_pipeline_matches_native_and_jax(refs, song, chain, depth,
                                                use_sink):
    src, program, ch, frames = SONGS[song]
    nat, jax_out = refs[song]
    r = _open(a2t, src, ch, DeviceRenderer, program, device="cpu",
              chain_dispatch=chain, pipeline_depth=depth)
    got = []
    out = r.render(frames, bufsize=SB, profile=True,
                   sink=(lambda bufs, n: got.append(np.stack(bufs)))
                   if use_sink else None)
    if use_sink:
        assert out is None
        out = np.concatenate(got, axis=1)
    assert not r.fell_back and r.bridged_frames == 0
    # the profile pass pinned one signature for the whole song
    sigs = set(r.mixer._fns) | {k[1] for k in r.mixer._chain_fns}
    assert len(sigs) == 1
    if chain > 1:
        assert any(k[0] == "chain" for k in r.mixer._chain_fns)
    r.close()
    assert np.abs(out).max() > 0
    assert _same(out, nat) == 0
    assert _same(out, jax_out) == 0


@pytest.mark.parametrize("name", list(MIXER_SCRIPTS))
def test_signature_matches_device_mixer(name):
    """_repad / _signature / device_bytes["persistent"] equal the JAX
    mixer's, before a profile pass (pow2 padding, growing high-water
    marks) and after one (observe over every superblock, fine padding,
    the structure union), the packed format's table sizes included."""
    src, program, channels, frames, count = MIXER_SCRIPTS[name]
    progs, tpa, jpa = record_superblocks(src, program, channels, frames,
                                         count)
    for profiled in (False, True):
        tm = TorchMixer(_Core(tpa), device="cpu")
        jm = JSB.DeviceMixer(_Core(jpa), interpret=True)
        if profiled:
            for p in progs:
                tm.observe(copy.deepcopy(p))
                jm.observe(copy.deepcopy(p))
        for k, p in enumerate(progs):
            tp, jp = copy.deepcopy(p), copy.deepcopy(p)
            tm._repad(tp)
            jm._repad(jp)
            ts, js = tm._signature(tp), jm._signature(jp)
            assert ts == js, (profiled, k)
            assert (ts[12] is not None) == (profiled and tp.runmat
                                            is not None)
            assert tm.device_bytes(copy.deepcopy(p))["persistent"] \
                == jm.device_bytes(copy.deepcopy(p))["persistent"]
            for a, b in ((tp.runmat, jp.runmat), (tp.rampmat, jp.rampmat),
                         (tp.stash_audio, jp.stash_audio)):
                assert (a is None) == (b is None)
                if a is not None:
                    assert np.array_equal(a, b)


def _tag(prog, ns):
    """What DeviceRenderer._tag_prog writes on a shared mixer."""
    prog.ns = ns
    for fd in prog.fbdelays:
        fd["unit_id"] = (ns, fd["unit_id"])
    for fl in prog.filters:
        fl["serials"] = [(ns, x) for x in fl["serials"]]
    return prog


def _two_streams(channels=1, frames=4096, count=3):
    """Two streams of ARG_SONG with different arguments, tagged as on a
    shared mixer; one pair atlas for both."""
    out = []
    pa = M.OK.PairAtlas()
    for ns, args in ((1, (0, 2)), (2, (0.5, 3))):
        i = a2t.open_engine(44100, 4096, channels, batched=False)
        song = i.get(i.load_string(ARG_SONG, "t"), "Song")
        nr = NativeRenderer(i, channels=channels)
        nr.timestamp_reset()
        nr.start(0, song, *args)

        def entry(handle, mip, i=i, ns=ns):
            key = (ns, handle)
            with pa.lock:
                if (key, 0) not in pa._index:
                    pa.add_wave(key, i.state.ss.hm.get(handle).data)
                    pa.finalize()
                return pa.lookup(key, mip)
        progs = []
        for _ in range(count):
            rows, stages, stash, nfrag = nr.record(frames)
            progs.append(_tag(program_from_native(
                rows, stages, stash, nfrag, [64] * nfrag, entry,
                nr.master_channels), ns))
        nr.close()
        out.append(progs)
    return out, pa


def test_dispatch_chain_and_many_equal_single():
    """dispatch_chain (3 consecutive superblocks, state threaded in
    place) and dispatch_many (a superblock of each of two streams)
    equal the same programs dispatched one by one."""
    (s1, s2), pa = _two_streams()
    assert any(p.filters for p in s1) and any(p.fbdelays for p in s1)

    def mixer():
        tm = TorchMixer(_Core(pa), device="cpu")
        for p in s1 + s2:
            tm.observe(copy.deepcopy(p))
        return tm
    single = mixer()
    want = [[single.run(copy.deepcopy(p)) for p in s] for s in (s1, s2)]
    chained = mixer()
    got1 = [chained.fetch(h) for h in chained.dispatch_chain(
        [copy.deepcopy(p) for p in s1])]
    assert any(k[0] == "chain" for k in chained._chain_fns)
    batched = mixer()
    got = [[], []]
    for p1, p2 in zip(s1, s2):
        hs = batched.dispatch_many([copy.deepcopy(p1), copy.deepcopy(p2)])
        got[0].append(batched.fetch(hs[0]))
        got[1].append(batched.fetch(hs[1]))
    assert any(k[0] == "many" for k in batched._chain_fns)
    for k in range(3):
        for a, b, c in zip(want[0][k], got1[k], got[0][k]):
            assert np.abs(a).max() > 0
            assert _same(a, b) == 0 and _same(a, c) == 0
        for a, c in zip(want[1][k], got[1][k]):
            assert _same(a, c) == 0


def test_shared_mixer_keeps_stream_state_apart():
    """Two streams of the same filtered song (filter12 and fbdelay, the
    same item keys and unit serials) with different arguments on one
    shared TorchMixer, alternating superblocks: each equals its own solo
    native render.  Keyed by item key or bare unit id, the second
    stream would read the first one's filter state and ring."""
    from audiality2_tpu_torch.serve import _SharedCore
    sb = 4096
    shared = TorchMixer(_SharedCore(), device="cpu")
    streams = []
    for args in ((0, 2), (0.5, 3)):
        r = _open(a2t, ARG_SONG, 1, DeviceRenderer, args=args, mixer=shared)
        streams.append((r, args, []))
    for _ in range(4):
        for r, _, outs in streams:
            outs.append(r.run(sb))
    keys = [k for k in shared._filt]
    assert len({k[0] for k in keys}) == 2
    assert {u[0] for u in shared._rings} == {r._ns for r, _, _ in streams}
    for r, args, outs in streams:
        assert not r.fell_back
        r.close()
        out = np.concatenate(outs, axis=1)
        assert np.abs(out).max() > 0
        assert _same(out, native(ARG_SONG, 1, 4 * sb, args=args,
                                 sb=sb)) == 0


def _faulty(method, at):
    """Wraps a bound mixer method so that its call number `at` raises."""
    calls = [0]

    def f(*a, **kw):
        calls[0] += 1
        if calls[0] == at:
            raise RuntimeError("injected fault")
        return method(*a, **kw)
    return f


@pytest.mark.parametrize("fault,chain", [("dispatch", 1), ("dispatch", 2),
                                         ("fetch", 1), ("record", 3)])
def test_fault_bridges_at_emitted_frontier(monkeypatch, fault, chain):
    """A record fault (the fbdelay going sub-fragment mid-song) lets the
    superblocks already recorded finish on the device, then continues
    natively at the emitted frontier, sample-exactly.  A dispatch or
    fetch fault is a fault of the device: the render emits what the
    device finished before it, in order, and raises it."""
    if fault == "record":
        src, program, ch, frames, sb = MIDFALL_SCRIPT, "SongMain", 1, \
            3 * 5 * 4096, 4096
    else:
        src, program, ch, frames, sb = SLICE_SONG, "Song", 2, 5 * SB, SB
    r = _open(a2t, src, ch, DeviceRenderer, program, device="cpu",
              chain_dispatch=chain)
    if fault == "dispatch":
        name = "dispatch_chain" if chain > 1 else "dispatch"
        monkeypatch.setattr(r.mixer, name, _faulty(getattr(r.mixer, name),
                                                   2))
    elif fault == "fetch":
        monkeypatch.setattr(r.mixer, "fetch", _faulty(r.mixer.fetch, 2))
    want = native(src, ch, frames, program, sb=sb)
    if fault == "record":
        out = r.render(frames, bufsize=sb, profile=False)
        assert r.fell_back and 0 < r.bridged_frames < frames
        assert _same(out, want) == 0
    else:
        got = []
        with pytest.raises(RuntimeError, match="injected fault"):
            r.render(frames, bufsize=sb,
                     sink=lambda bufs, n: got.append(np.stack(bufs)))
        assert not r.fell_back and r.bridged_frames == 0
        # the superblocks before the faulty call: the first chain for
        # a faulty second dispatch; for a faulty second fetch, those
        # before it (the fetch threads may call in either order)
        out = np.concatenate(got, axis=1) if got \
            else np.zeros((ch, 0), np.int32)
        if fault == "dispatch":
            assert out.shape[1] == chain * sb
        else:
            assert out.shape[1] % sb == 0 and out.shape[1] <= sb
        assert _same(out, want[:, :out.shape[1]]) == 0
    r.close()


def _slow_broken_build(monkeypatch):
    """Makes the per-process kernel build fail after a while, as on a
    machine whose nvcc is slow and then fails."""
    def broken(verbose=False):
        time.sleep(0.3)
        raise RuntimeError("nvcc failed on osc_kernel.cu")
    monkeypatch.setattr(build, "build", broken)
    monkeypatch.setattr(DeviceRenderer, "_warm_thread", None)
    monkeypatch.setattr(DeviceRenderer, "_warm_done", threading.Event())
    monkeypatch.setattr(DeviceRenderer, "_warm_error", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


@pytest.mark.parametrize("entry", ["render", "run", "render_many",
                                   "render_multiplexed"])
def test_renders_wait_for_the_kernel_build(monkeypatch, entry):
    """Every entry point waits for the kernel build and raises its
    failure: nothing renders natively while the kernels build."""
    from audiality2_tpu_torch import serve
    _slow_broken_build(monkeypatch)
    i = a2t.open_engine(44100, 4096, 2, batched=False)
    song = i.get(i.load_string(SLICE_SONG, "t"), "Song")
    if entry in ("render", "run"):
        r = DeviceRenderer(i, channels=2, device="cuda")
        r.timestamp_reset()
        r.start(0, song)
        with pytest.raises(RuntimeError, match="failed to build"):
            if entry == "render":
                r.render(2 * SB, bufsize=SB)
            else:
                r.run(SB)
        renderers = [r]
    else:
        jobs = [serve.StreamJob(i, song, 2 * SB, channels=2)]
        with pytest.raises(RuntimeError, match="failed to build"):
            getattr(serve, entry)(jobs, bufsize=SB, device="cuda")
        renderers = [j.renderer for j in jobs]
    for r in renderers:
        assert not r.fell_back and r.bridged_frames == 0 and r._nr_pos == 0
        r.close()


def test_capture_counts_only_its_own_thread():
    """A graph capture launches nothing: the launches its thread makes
    meanwhile go to the capture's counts, added at each graph launch,
    while other threads' launches count in the wrapper at once."""
    def wrapper():
        pass
    wrapper.launches = 0
    wrapper.kind_launches = {"f12": 0}
    entered, counted = threading.Event(), threading.Event()
    captured = {}

    def capture():
        with build.captured_launches() as counts:
            entered.set()
            counted.wait()
            build.count_launch(wrapper, "f12")
            build.count_launch(wrapper, "f12")
        captured.update(counts)
    th = threading.Thread(target=capture)
    th.start()
    entered.wait()
    for _ in range(3):
        build.count_launch(wrapper)
    counted.set()
    th.join()
    assert captured == {(wrapper, "f12"): 2}
    assert wrapper.launches == 3 and wrapper.kind_launches["f12"] == 0
    build.count_launch(wrapper, "f12")
    for _ in range(2):       # two launches of the captured graph
        build.add_launches(captured)
    assert wrapper.launches == 8 and wrapper.kind_launches["f12"] == 5


def test_float_stage_mode_raises():
    """stage_mode: "float" is taken since the float tier is ported (it
    raised before); a mode that neither package has still raises."""
    i = a2t.open_engine(44100, 4096, 2, batched=False)
    with pytest.raises(ValueError, match="stage_mode"):
        DeviceRenderer(i, channels=2, device="cpu", stage_mode="approx")
    with pytest.raises(ValueError, match="stage_mode"):
        TorchMixer(_Core(None), device="cpu", stage_mode="approx")
    r = DeviceRenderer(i, channels=2, device="cpu", stage_mode="float")
    assert r.mixer.stage_mode == "float"
    r.close()


def test_failed_kernel_build_is_raised(monkeypatch):
    """A kernel build that fails is kept and raised by wait_device() and
    by the next render, never turned into a silent native render."""
    import threading

    def broken(verbose=False):
        raise RuntimeError("nvcc failed on osc_kernel.cu")
    monkeypatch.setattr(build, "build", broken)
    monkeypatch.setattr(DeviceRenderer, "_warm_thread", None)
    monkeypatch.setattr(DeviceRenderer, "_warm_done", threading.Event())
    monkeypatch.setattr(DeviceRenderer, "_warm_error", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    r = _open(a2t, SLICE_SONG, 2, DeviceRenderer, device="cuda")
    with pytest.raises(RuntimeError, match="failed to build") as e:
        r.wait_device()
    assert "nvcc failed" in str(e.value.__cause__)
    with pytest.raises(RuntimeError, match="failed to build"):
        r.render(SB, bufsize=SB)
    with pytest.raises(RuntimeError, match="failed to build"):
        r.run(SB)
    assert not r.fell_back
    r.close()
