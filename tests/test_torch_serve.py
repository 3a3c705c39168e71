"""The port's serving (``audiality2_tpu_torch/serve.py``) on the CPU.

Three streams (a stereo filtered song, a stereo fm song and the mono
slice song, of different lengths) through ``render_many`` (a renderer
and mixer per stream, on threads) and ``render_multiplexed`` (one
shared mixer, streams rotated per superblock; batch 1 and 2, the batch
through ``TorchMixer.dispatch_many``): each stream equals its solo
native render with 0 mismatches; a dispatch or fetch fault on the
device fails only its own stream.  ``fleet_hbm_plan`` refuses a fleet
that does not fit its budget."""

import numpy as np
import pytest
import torch

import audiality2_tpu_torch as a2t
from audiality2_tpu_torch import serve
from audiality2_tpu_torch.cuda.mixer import TorchMixer
from audiality2_tpu_torch.songs import SLICE_SONG

from test_torch_pipeline import _same, native

SB = 8192

# saw leads through filter12 and dcblock, panned, stereo
FILTER_SONG = """
Lead(P V=1)
{
	struct { wtosc; filter12; dcblock db; panmix }
	lp .6; bp .3; hp .1
	w saw; p P; a (V * .3); pan (P * .3)
	cutoff 2; q 1.2
	db.cutoff 2n
	d 30
	cutoff (P + 2); q .7; d 120
	a 0; d 60
}
Song(B=0)
{
	!n 0
	24 {
		Lead (B + n * .0833 - 1) .3
		+n 1
		d 30
	}
	d 300
}
"""

# fm2 bells, panned, stereo
FM_SONG = """
Bell(P V=1)
{
	struct { fm2; panmix }
	p P; a V; p1 (P + 1); a1 .5; fb .2; pan (P * .2)
	d 10
	a 0; d 150
}
Song()
{
	!n 0
	12 {
		Bell (n * .0833 + 1) .1
		+n 1
		d 40
	}
	d 300
}
"""

# name -> (source, channels, frames, args)
STREAMS = {"filter": (FILTER_SONG, 2, 3 * SB, (0.5,)),
           "fm": (FM_SONG, 2, 2 * SB - 64, ()),
           "slice": (SLICE_SONG, 1, 3 * SB, ())}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the renders' own threads (dispatch, fetch,
    record) then do not compete with idle-spinning torch workers when
    the suite runs several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def solo():
    """Each stream's solo native render over whole superblocks."""
    return {k: native(src, ch, frames, args=args)
            for k, (src, ch, frames, args) in STREAMS.items()}


def _jobs():
    jobs = []
    for src, ch, frames, args in STREAMS.values():
        i = a2t.open_engine(44100, 4096, ch, batched=False)
        song = i.get(i.load_string(src, "t"), "Song")
        jobs.append(serve.StreamJob(i, song, frames, args=args,
                                    channels=ch))
    return jobs


@pytest.mark.parametrize("mode", ["many", "mux1", "mux2"])
def test_served_streams_match_solo_native(solo, mode):
    jobs = _jobs()
    if mode == "many":
        serve.render_many(jobs, bufsize=SB, device="cpu")
    else:
        serve.render_multiplexed(jobs, bufsize=SB, device="cpu",
                                 batch=int(mode[-1]))
    mixers = {id(j.renderer.mixer) for j in jobs}
    assert len(mixers) == (len(jobs) if mode == "many" else 1)
    if mode == "mux2":
        assert any(k[0] == "many" for k in jobs[0].renderer.mixer._chain_fns)
    for j, (name, want) in zip(jobs, solo.items()):
        assert j.error is None and not j.renderer.fell_back, name
        assert np.abs(j.output).max() > 0, name
        assert _same(j.output, want) == 0, name


@pytest.mark.parametrize("fault", ["dispatch", "fetch"])
def test_multiplexed_device_fault_fails_only_its_stream(monkeypatch, solo,
                                                         fault):
    """A dispatch or fetch that fails on the device fails the stream it
    belonged to, whose output stops at what was emitted before; the
    other streams render on and equal their solo native renders; the
    error is raised at the end."""
    method = getattr(TorchMixer, fault)
    calls = [0]

    def faulty(*a, **kw):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("injected fault")
        return method(*a, **kw)
    monkeypatch.setattr(TorchMixer, fault, faulty)
    jobs = _jobs()
    with pytest.raises(RuntimeError, match="injected fault"):
        serve.render_multiplexed(jobs, bufsize=SB, device="cpu")
    failed = [j for j in jobs if j.error is not None]
    assert len(failed) == 1
    for j, (name, want) in zip(jobs, solo.items()):
        assert not j.renderer.fell_back, name
        if j.error is None:
            assert _same(j.output, want) == 0, name
        elif j.output is not None:
            n = j.output.shape[1]
            assert n < want.shape[1], name
            assert _same(j.output, want[:, :n]) == 0, name


def test_fleet_plan_refuses_a_fleet_over_budget():
    """The plan counts every stream's persistent state and the in-flight
    superblocks' working sets; a budget below that raises before any
    stream starts, and the default budget (the device's memory less an
    eighth) takes a small fleet."""
    jobs = _jobs()
    mixer = TorchMixer(serve._SharedCore(), device="cpu")
    progs = []
    for j in jobs:
        r = serve.DeviceRenderer(j.interface, channels=j.channels,
                                 mixer=mixer)
        r.timestamp_reset()
        r.start(0, j.program, *j.args)
        assert r._profile(j.frames, SB)
        progs.append(r._profiled_prog)
        r.close()
    plan = serve.fleet_hbm_plan(mixer, progs)
    assert plan["streams"] == 3 and plan["persistent"] > 0
    assert plan["total"] <= plan["budget"] \
        == serve.device_memory_budget("cpu")
    with pytest.raises(serve.A2HbmBudgetError):
        serve.fleet_hbm_plan(mixer, progs, hbm_budget=plan["total"] - 1)
    with pytest.raises(serve.A2HbmBudgetError):
        serve.render_multiplexed(_jobs(), bufsize=SB, device="cpu",
                                 hbm_budget=1 << 20)
