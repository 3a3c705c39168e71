"""The port's host engine against the JAX package's, on the CPU.

The copied ``engine/core.py`` defaults to the batched record / replay
engine (``batched=True``), which reaches ``audiality2_tpu_torch.tpu``
(the row batch, its wave atlas, the pair atlas) and the copied
``units/deferred.py``; the copied ``engine/drivers.py`` reaches the
copied ``engine/midi.py``.  Here the port's batched render equals the
JAX package's batched render and the port's interleaved render, with
the rows evaluated by numpy (``use_jax=False``) and by the device row
path (``use_jax=True``: ``rows_torch`` on the CPU, the JAX package's
``rows_jax`` on JAX's CPU backend); ``rows_torch`` equals
``rows_numpy`` and ``rows_jax`` on seeded rows above
``JAX_MIN_ROWS``; and the MIDI driver and bridge render in the port as
they do in the JAX package.
"""

import struct
import types

import numpy as np
import pytest
import torch

import audiality2_tpu as a2j
from audiality2_tpu.tpu import row_kernel as JRK
import audiality2_tpu_torch as a2t
from audiality2_tpu_torch.engine.midi import MidiBridge
from audiality2_tpu_torch.cuda import rows as CR
from audiality2_tpu_torch.songs import SLICE_SONG
from audiality2_tpu_torch.tpu import row_kernel as TRK

SR = 44100


def _render(pkg, src, program, channels, frames, bufsize=1024,
            **config):
    """(channels, frames) int32 of `program` rendered by pkg's engine
    through its sink."""
    i = pkg.open_engine(SR, bufsize, channels, **config)
    song = i.get(i.load_string(src, "t"), program)
    out = []
    i.sink_callback(lambda bufs, n: out.append(
        np.stack([np.array(bufs[c][:n]) for c in range(channels)])))
    i.timestamp_reset()
    i.starta(i.root_voice(), song, [])
    for _ in range(-(-frames // bufsize)):
        i.run(bufsize)
    return np.concatenate(out, axis=1)[:, :frames]


@pytest.fixture
def device_rows_on_cpu(monkeypatch):
    """Every row batch takes the device path (no row minimum), the
    port's on the CPU."""
    monkeypatch.setattr(TRK.RowBatch, "device", "cpu")
    monkeypatch.setattr(TRK.RowBatch, "JAX_MIN_ROWS", 0)
    monkeypatch.setattr(JRK.RowBatch, "JAX_MIN_ROWS", 0)


@pytest.mark.parametrize("use_jax", [False, True],
                         ids=["numpy_rows", "device_rows"])
def test_batched_render_matches_jax_package(use_jax, request):
    if use_jax:
        request.getfixturevalue("device_rows_on_cpu")
    frames = 12 * 1024
    got = _render(a2t, SLICE_SONG, "Song", 2, frames, batched=True,
                  use_jax=use_jax)
    want = _render(a2j, SLICE_SONG, "Song", 2, frames, batched=True,
                   use_jax=use_jax)
    plain = _render(a2t, SLICE_SONG, "Song", 2, frames, batched=False)
    assert got.shape == (2, frames) and np.abs(got).max() > 0
    assert int((got != want).sum()) == 0
    assert int((got != plain).sum()) == 0


def test_default_engine_is_batched_and_renders():
    """open_engine's defaults (batched=True, use_jax=True): below
    JAX_MIN_ROWS the rows stay on the host, so no card is needed."""
    got = _render(a2t, SLICE_SONG, "Song", 1, 4096)
    want = _render(a2j, SLICE_SONG, "Song", 1, 4096)
    assert np.abs(got).max() > 0
    assert int((got != want).sum()) == 0


def _seeded_rows(rng, n):
    """A seeded atlas (WaveAtlas-like) and n rows whose lookups stay
    inside it: mono, stereo and clamped panmix rows and bare rows."""
    atlas = types.SimpleNamespace(
        data=rng.integers(-32768, 32768, 6000).astype(np.int32),
        version=7919)
    base = rng.integers(4, 200, n)
    ph0 = rng.integers(0, 2000 << 24, n)
    dph = rng.integers(0, 20 << 24, n)
    amp0 = rng.integers(0, 1 << 24, n)
    damp = rng.integers(-(1 << 14), 1 << 14, n)
    haspm = rng.random(n) < 0.8
    stereo = rng.random(n) < 0.6
    clamp = rng.random(n) < 0.3
    vol0 = rng.integers(0, 1 << 24, n)
    dvol = rng.integers(-(1 << 12), 1 << 12, n)
    pan0 = rng.integers(-(1 << 25), 1 << 25, n)
    dpan = rng.integers(-(1 << 14), 1 << 14, n)
    return atlas, (base, ph0, dph, amp0, damp, haspm, stereo, clamp,
                   vol0, dvol, pan0, dpan)


def test_rows_torch_matches_numpy_and_jax():
    rng = np.random.default_rng(31)
    n = TRK.RowBatch.JAX_MIN_ROWS + 131
    atlas, rows = _seeded_rows(rng, n)
    got = TRK.rows_torch(atlas, *rows, device="cpu")
    want = TRK.rows_numpy(atlas.data, *rows)
    jax_out = JRK.rows_jax(atlas, *rows)
    assert got.shape == (n, 2, 64) and got.dtype == np.int64
    assert int((got != want).sum()) == 0
    assert int((got != jax_out).sum()) == 0
    assert (JRK.rows_numpy(atlas.data, *rows) == want).all()


def test_row_batch_device_path_above_min_rows(monkeypatch):
    """RowBatch.evaluate above JAX_MIN_ROWS rows takes rows_torch (padded
    to a power of two) and equals its numpy evaluation."""
    monkeypatch.setattr(TRK.RowBatch, "device", "cpu")
    rng = np.random.default_rng(32)
    n = TRK.RowBatch.JAX_MIN_ROWS + 131
    atlas, rows = _seeded_rows(rng, n)
    rb = TRK.RowBatch()
    for r in range(n):
        rb.add_osc(*(int(x[r]) for x in rows[:5]))
        if rows[5][r]:
            rb.attach_panmix(r, int(rows[8][r]), int(rows[9][r]),
                             int(rows[10][r]), int(rows[11][r]),
                             bool(rows[6][r]), bool(rows[7][r]))
    calls = []
    real = TRK.rows_torch
    monkeypatch.setattr(TRK, "rows_torch", lambda *a, **k: calls.append(
        len(a[1])) or real(*a, **k))
    dev = rb.evaluate(atlas, use_jax=True)
    host = rb.evaluate(atlas, use_jax=False)
    assert calls == [16384]
    assert int((dev != host).sum()) == 0


@pytest.mark.parametrize("seed", [34, 35])
def test_rows_wrapper_plain_matches_numpy_and_jax(seed):
    """cuda/rows.py's wrapper on CPU tensors runs the plain version: equal
    to rows_numpy and to the JAX package's rows_jax on seeded rows (mono,
    stereo, clamped and bare), its launch count untouched."""
    rng = np.random.default_rng(seed)
    n = 300 if seed == 34 else TRK.RowBatch.JAX_MIN_ROWS + 5
    atlas, rows = _seeded_rows(rng, n)
    # rows_jax keeps its device atlas by version alone
    atlas.version = 10000 + seed
    before = CR.rows_call.launches
    got = CR.rows_call(torch.from_numpy(atlas.data),
                       torch.from_numpy(np.stack([np.asarray(a, np.int64)
                                                  for a in rows])))
    assert CR.rows_call.launches == before
    assert got.dtype == torch.int64 and tuple(got.shape) == (n, 2, 64)
    want = TRK.rows_numpy(atlas.data, *rows)
    assert int((got.numpy() != want).sum()) == 0
    assert int((got.numpy() != JRK.rows_jax(atlas, *rows)).sum()) == 0


def test_rows_wrapper_refuses_what_the_kernel_does_not_take():
    """The wrapper launches only for CUDA tensors: tensors on another
    device or on two devices, another type or shape, raise; rows_cuda
    refuses a device that is not CUDA."""
    atlas, rows = _seeded_rows(np.random.default_rng(36), 64)
    a = torch.from_numpy(atlas.data)
    p = torch.from_numpy(np.stack([np.asarray(x, np.int64) for x in rows]))
    for args in ((a.to("meta"), p.to("meta")), (a, p.to("meta")),
                 (a.to(torch.int64), p), (a, p.to(torch.int32)),
                 (a, p[:11]), (a, p.t().contiguous().t())):
        with pytest.raises(ValueError):
            CR.rows_call(*args)
    with pytest.raises(ValueError, match="not a CUDA device"):
        TRK.rows_cuda(atlas, *rows, device="cpu")


def test_row_batch_on_a_cpu_device_uses_rows_torch(monkeypatch):
    """On a CPU device (the thread's row_device) RowBatch.evaluate takes
    rows_torch, never the kernel's path; on a CUDA device it takes the
    kernel's (rows_cuda)."""
    monkeypatch.setattr(TRK.RowBatch, "JAX_MIN_ROWS", 0)
    atlas, rows = _seeded_rows(np.random.default_rng(37), 200)
    rb = TRK.RowBatch()
    for r in range(200):
        rb.add_osc(*(int(x[r]) for x in rows[:5]))
        if rows[5][r]:
            rb.attach_panmix(r, int(rows[8][r]), int(rows[9][r]),
                             int(rows[10][r]), int(rows[11][r]),
                             bool(rows[6][r]), bool(rows[7][r]))
    calls = []
    real = TRK.rows_torch
    monkeypatch.setattr(TRK, "rows_torch", lambda *a, **k: calls.append(
        k["device"]) or real(*a, **k))
    monkeypatch.setattr(TRK, "rows_cuda", lambda *a, **k: calls.append(
        ("cuda", k["device"])) or real(*a, device="cpu"))
    with TRK.row_device("cpu"):
        dev = rb.evaluate(atlas, use_jax=True)
    assert calls == ["cpu"]
    host = rb.evaluate(atlas, use_jax=False)
    assert int((dev != host).sum()) == 0
    rb.evaluate(atlas, use_jax=True)
    assert calls == ["cpu", ("cuda", "cuda")]


def test_device_rows_without_a_card_name_use_jax_false(monkeypatch):
    monkeypatch.setattr(TRK.torch.cuda, "is_available", lambda: False)
    atlas, rows = _seeded_rows(np.random.default_rng(33), 64)
    with pytest.raises(RuntimeError, match="use_jax=False"):
        TRK.rows_torch(atlas, *rows)


# ---------------------------------------------------------------
# MIDI (tests/test_drivers_units.py test_smf_midi_driver and
# tests/test_parity_extras.py test_midi_bridge_noteon, on the port)
# ---------------------------------------------------------------

MIDI_SRC = """
Tone(P V) { struct { wtosc } w sine; p P; a V; set a; d 2000; end }
export H() { struct { } d 100000; end
  7(Msg Ch A1 A2) { ifg (Msg - .5) { ifl (Msg - 1.5) { :Tone (A1 - 5) A2 } } }
}
"""


def _midi_engine(pkg):
    i = pkg.open_engine(SR, 1024, 1)
    h = i.load_string(MIDI_SRC)
    i.timestamp_reset()
    vh = i.starta(i.root_voice(), i.get(h, "H"), [])
    out = []
    i.sink_callback(lambda bufs, frames: out.append(np.array(bufs[0])))
    return i, vh, out


def test_smf_midi_driver(tmp_path):
    track = (b"\x00\xff\x51\x03\x07\xa1\x20"
             b"\x00\x90\x3c\x64"
             b"\x60\x80\x3c\x00"
             b"\x00\xff\x2f\x00")
    data = (b"MThd" + struct.pack(">IHHH", 6, 0, 1, 96)
            + b"MTrk" + struct.pack(">I", len(track)) + track)
    p = tmp_path / "t.mid"
    p.write_bytes(data)
    res = []
    for pkg in (a2t, a2j):
        i, vh, out = _midi_engine(pkg)
        i.set_midi_driver(f"smf,{p}", handler_voice=vh)
        for _ in range(20):
            i.run(1024)
        res.append(np.concatenate(out))
    assert np.abs(res[0]).max() > 0
    assert int((res[0] != res[1]).sum()) == 0


def test_midi_bridge_noteon():
    from audiality2_tpu.engine.midi import MidiBridge as JMidiBridge
    res = []
    for pkg, bridge in ((a2t, MidiBridge), (a2j, JMidiBridge)):
        i, vh, out = _midi_engine(pkg)
        b = bridge(i, vh)
        i.run(1024)
        i.timestamp_bump(1024 << 8)
        b.note_on(0, 60, 100)
        for _ in range(9):
            i.run(1024)
        res.append(np.concatenate(out))
    assert np.abs(res[0]).max() > 0
    assert int((res[0] != res[1]).sum()) == 0
