"""The packed dispatch format (``audiality2_tpu_torch/cuda/packed.py``
and ``TorchMixer``'s use of it) against the JAX package, on the CPU.

The port's host packers ``_rmq_pack`` / ``_rqr_pack`` equal the JAX
package's on the padded runmats and rampmats of recorded superblocks;
the plain decoders ``rmq_unpack_torch`` / ``rqr_unpack_torch`` (what
``unpack_call`` runs for CPU tensors) give the padded tables back and
equal the JAX package's ``_rmq_unpack`` / ``_rqr_unpack`` on the same
packs, real and seeded; after the same profile pass the port's
``_rmq_finalize`` gives the JAX mixer's tables.  A value outside the
tables raises ``Unsupported`` from ``_prepare``, and a solo render, a
synchronous run or a served stream that meets one bridges natively,
sample-exactly.
Profiled renders and a served fleet run packed and equal native.
Tolerance 0 everywhere.  The CUDA decoders are held against the plain
versions on the card by ``chip_smoke.py`` (``packed``).
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import audiality2_tpu as a2j
from audiality2_tpu.engine.device_render import DeviceRenderer as JaxRenderer
from audiality2_tpu.tpu import superblock as JSB
import audiality2_tpu_torch as a2t
from audiality2_tpu_torch import serve
from audiality2_tpu_torch.cuda import packed as PK
from audiality2_tpu_torch.cuda.mixer import TorchMixer
from audiality2_tpu_torch.cuda.superblock import (RC_TOTAL, RR_PTGT, RR_PV,
                                                  Unsupported)
from audiality2_tpu_torch.engine.device_render import DeviceRenderer
from audiality2_tpu_torch.songs import SLICE_SONG

from test_torch_pipeline import _open, _same, native
from test_torch_serve import STREAMS
from test_torch_stage_tail import MIXER_SCRIPTS, _Core, record_superblocks

SB = 8192

# the recorded superblocks whose tables are packed: the slice song and
# some of the stage-tail scripts
PACK_SCRIPTS = {"slice": (SLICE_SONG, "Song", 2, SB, 3)}
PACK_SCRIPTS.update((k, MIXER_SCRIPTS[k]) for k in
                    ("effects", "float_src", "changefbd", "lim_stereo"))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _profiled(name):
    """The programs of PACK_SCRIPTS[name], a port and a JAX mixer that
    observed deep copies of all of them, and each mixer's padded copy of
    each program."""
    src, program, channels, frames, count = PACK_SCRIPTS[name]
    progs, tpa, jpa = record_superblocks(src, program, channels, frames,
                                         count)
    tm = TorchMixer(_Core(tpa), device="cpu")
    jm = JSB.DeviceMixer(_Core(jpa), interpret=True)
    for p in progs:
        tm.observe(copy.deepcopy(p))
        jm.observe(copy.deepcopy(p))
    tps, jps = [], []
    for p in progs:
        tp, jp = copy.deepcopy(p), copy.deepcopy(p)
        tm._repad(tp)
        jm._repad(jp)
        tps.append(tp)
        jps.append(jp)
    return tm, jm, tps, jps


def _col_tables(mat, cols):
    """Value tables made from a table's own columns (with 0, as
    ``_rmq_finalize`` makes them)."""
    return [np.unique(np.concatenate([mat[:, c], [0]])).astype(np.int32)
            for c in cols]


@pytest.mark.parametrize("name", list(PACK_SCRIPTS))
def test_finalize_and_pack_match_jax(name):
    tm, jm, tps, jps = _profiled(name)
    ts, js = tm._signature(tps[0]), jm._signature(jps[0])
    assert ts == js
    assert ts[12] is not None
    tf, jf = tm._rmq, jm._rmq
    assert tf["sizes"] == jf["sizes"] and tf["rsizes"] == jf["rsizes"]
    for a, b in zip(tf["tables"], jf["tables"]):
        assert a.dtype == np.int32 and np.array_equal(a, b)
    assert (tf["rtables"] is None) == (jf["rtables"] is None)
    for tp, jp in zip(tps, jps):
        assert np.array_equal(tp.runmat, jp.runmat)
        pk = PK._rmq_pack(tp.runmat, tf["tables"])
        assert np.array_equal(pk, JSB._rmq_pack(jp.runmat, jf["tables"]))
        tabs = [torch.from_numpy(t) for t in tf["tables"]]
        got = PK.unpack_call("rmq", torch.from_numpy(pk), tabs).numpy()
        assert np.array_equal(got, tp.runmat)
        want = np.asarray(JSB._rmq_unpack(
            jnp.asarray(pk), [jnp.asarray(t) for t in jf["tables"]]))
        assert np.array_equal(got, want)


@pytest.mark.parametrize("name", list(PACK_SCRIPTS))
def test_rampmat_pack_matches_jax(name):
    """The rampmat leg on each recorded rampmat, with tables made from
    the rampmat itself: the decoder gives PV for PTGT (the format's
    invariant), every other column as recorded."""
    tm, jm, tps, jps = _profiled(name)
    for tp, jp in zip(tps, jps):
        rmp = tp.rampmat
        if rmp is None or not rmp.shape[0]:
            continue
        tabs = _col_tables(rmp, PK._RQR_IDXCOLS)
        pk = PK._rqr_pack(rmp, tabs)
        assert np.array_equal(pk, JSB._rqr_pack(jp.rampmat, tabs))
        got = PK.unpack_call("rqr", torch.from_numpy(pk),
                             [torch.from_numpy(t) for t in tabs]).numpy()
        want = rmp.copy()
        want[:, RR_PTGT] = want[:, RR_PV]
        assert np.array_equal(got, want)
        jax_out = np.asarray(JSB._rqr_unpack(
            jnp.asarray(pk), [jnp.asarray(t) for t in tabs]))
        assert np.array_equal(got, jax_out)


@pytest.mark.parametrize("kind", ["rmq", "rqr"])
def test_seeded_unpack_matches_jax(kind):
    """Seeded packs using every bit of each word, tables of 1 to 3,000
    values, and one-entry tables."""
    rng = np.random.default_rng(71 if kind == "rmq" else 72)
    jfn = JSB._rmq_unpack if kind == "rmq" else JSB._rqr_unpack
    ntab = PK.KINDS[kind][1]
    for sizes in (None, [1] * ntab):
        pk, tabs = PK.seeded_format(rng, kind, 1000, sizes)
        got = PK.unpack_call(kind, torch.from_numpy(pk),
                             [torch.from_numpy(t) for t in tabs]).numpy()
        want = np.asarray(jfn(jnp.asarray(pk),
                              [jnp.asarray(t) for t in tabs]))
        assert got.shape == (1000, PK.KINDS[kind][2])
        assert np.array_equal(got, want)


def _drop_used_values(tables):
    """Replaces every nonzero value of the TOTAL table (the frames of a
    run: nonzero in every live run) with values above them; the table
    stays sorted and keeps its size, and every live run is outside
    it."""
    j = PK._RMQ_IDXCOLS.index(RC_TOTAL)
    t = tables[j]
    tables[j] = np.concatenate(
        [[0], t.max() + 1 + np.arange(len(t) - 1)]).astype(np.int32)


def test_pack_miss_raises_unsupported_from_prepare():
    tm, _, tps, _ = _profiled("slice")
    tm._signature(tps[0])
    _drop_used_values(tm._rmq["tables"])
    hit = 0
    for tp in tps:
        try:
            tm._prepare(copy.deepcopy(tp))
        except Unsupported as e:
            assert "outside profiled table" in str(e)
            hit += 1
    assert hit == len(tps)


@pytest.fixture
def missing_value(monkeypatch):
    """Every mixer's packed format loses the values that the song
    recorded in one table (``_drop_used_values``)."""
    real = TorchMixer._rmq_finalize

    def finalize(self, force=False):
        fmt = real(self, force)
        if fmt:
            _drop_used_values(fmt["tables"])
        return fmt
    monkeypatch.setattr(TorchMixer, "_rmq_finalize", finalize)


def test_solo_render_bridges_a_pack_miss(missing_value):
    frames = 3 * SB
    r = _open(a2t, SLICE_SONG, 2, DeviceRenderer, device="cpu")
    out = r.render(frames, bufsize=SB)
    assert r.fell_back and r.bridged_frames > 0
    assert r.mixer._rmq
    assert _same(out, native(SLICE_SONG, 2, frames)) == 0
    r.close()


def test_run_after_render_bridges_a_pack_miss():
    """The synchronous run after a profiled render packs with the frozen
    tables; a superblock outside them continues natively."""
    r = _open(a2t, SLICE_SONG, 2, DeviceRenderer, device="cpu")
    first = r.render(SB, bufsize=SB)
    assert r.mixer._rmq and not r.fell_back
    _drop_used_values(r.mixer._rmq["tables"])
    rest = [r.run(SB) for _ in range(2)]
    assert r.fell_back and r.bridged_frames == 2 * SB
    out = np.concatenate([first] + rest, axis=1)
    assert _same(out, native(SLICE_SONG, 2, 3 * SB)) == 0
    r.close()


def test_served_stream_bridges_a_pack_miss(missing_value):
    src, ch, frames, args = STREAMS["slice"]
    i = a2t.open_engine(44100, 4096, ch, batched=False)
    job = serve.StreamJob(i, i.get(i.load_string(src, "t"), "Song"),
                          frames, args=args, channels=ch)
    serve.render_multiplexed([job], bufsize=SB, device="cpu")
    assert job.error is None and job.renderer.fell_back
    assert job.renderer.mixer._rmq
    assert _same(job.output, native(src, ch, frames, args=args)) == 0


def test_profiled_render_runs_packed_and_matches_native_and_jax():
    frames = 3 * SB
    r = _open(a2t, SLICE_SONG, 2, DeviceRenderer, device="cpu")
    out = r.render(frames, bufsize=SB)
    sigs = list(r.mixer._fns)
    assert not r.fell_back and len(sigs) == 1 and sigs[0][12] is not None
    r.close()
    j = _open(a2j, SLICE_SONG, 2, JaxRenderer, interpret=True)
    jax_out = np.asarray(j.render(frames, bufsize=SB))
    assert list(j.mixer._fns)[0][12] == sigs[0][12]
    j.close()
    assert np.abs(out).max() > 0
    assert _same(out, native(SLICE_SONG, 2, frames)) == 0
    assert _same(out, jax_out) == 0


def test_multiplexed_fleet_is_finalized_and_matches_solo_native():
    jobs = []
    for name in ("slice", "fm"):
        src, ch, frames, args = STREAMS[name]
        i = a2t.open_engine(44100, 4096, ch, batched=False)
        jobs.append(serve.StreamJob(i, i.get(i.load_string(src, "t"),
                                             "Song"),
                                    frames, args=args, channels=ch))
    serve.render_multiplexed(jobs, bufsize=SB, device="cpu")
    mixer = jobs[0].renderer.mixer
    assert mixer._rmq and all(s[12] is not None for s in mixer._fns)
    for j, name in zip(jobs, ("slice", "fm")):
        src, ch, frames, args = STREAMS[name]
        assert j.error is None and not j.renderer.fell_back
        assert _same(j.output, native(src, ch, frames, args=args)) == 0
