"""The port's oscillator batch (audiality2_tpu_torch/tpu/osc_kernel.py:
``OscBatch``, ``evaluate_osc_batch``, ``osc_rows_numpy``) against the
JAX package's.

Rows are numpy-seeded over the builtin saw, triangle, sine, square and
pulse10 waves at mips 0/1/3/5, inside the oscillator's table contract
(``0 <= ph0 < size << 24``, ``dph < 2 << 24``).  Tolerance: 0
mismatches everywhere.  On the CPU ``evaluate_osc_batch`` runs the
kernel's plain version (a CPU atlas tensor); the CUDA kernel behind it
is held against that plain version on the card by ``chip_smoke.py
--phases osc_batch``."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiality2_tpu.engine.state import open_engine
from audiality2_tpu.tpu import osc_kernel as JOK
from audiality2_tpu_torch.cuda import osc_kernel as COK
from audiality2_tpu_torch.tpu import kernels as TK
from audiality2_tpu_torch.tpu import osc_kernel as TOK
from audiality2_tpu_torch.tpu.row_kernel import rows_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVES = ("saw", "triangle", "sine", "square", "pulse10")
MIPS = (0, 1, 3, 5)


@pytest.fixture(scope="module")
def atlases():
    """(waves, the JAX pair atlas, the port's pair atlas, the port's
    flat sample atlas), each over the five builtin waves."""
    i = open_engine(48000, 1024, 1)
    waves = {name: i.get_wave(i.get(0, name)) for name in WAVES}
    jpa, tpa, wa = JOK.PairAtlas(), TOK.PairAtlas(), TK.WaveAtlas()
    for name, w in waves.items():
        for a in (jpa, tpa, wa):
            a.add_wave(name, w)
    for a in (jpa, tpa, wa):
        a.finalize()
    return waves, jpa, tpa, wa


def table_rows(at, name, mm, count, rng, amp_lo=-(1 << 27),
               amp_hi=1 << 27):
    """`count` seeded rows on (name, mm): (sample base, tbase, npass,
    pos_off, ph0, dph, amp0, damp), Python ints."""
    waves, _, tpa, wa = at
    size = waves[name].size[mm]
    base, _ = wa.lookup(name, mm)
    tbase, npass, off = tpa.lookup(name, mm)
    ph0 = rng.integers(0, size << 24, count)
    dph = rng.integers(1 << 18, 2 << 24, count)
    amp0 = rng.integers(amp_lo, amp_hi, count)
    damp = rng.integers(-(1 << 20), 1 << 20, count)
    return [(base, tbase, npass, off, int(p), int(d), int(a), int(da))
            for p, d, a, da in zip(ph0, dph, amp0, damp)]


def mixture(at, n_per, seed):
    """n_per rows on every (wave, mip) table, shuffled so that the
    buckets interleave."""
    rng = np.random.default_rng(seed)
    rows = [r for name in WAVES for mm in MIPS
            for r in table_rows(at, name, mm, n_per, rng)]
    return [rows[k] for k in rng.permutation(len(rows))]


def batches(at, rows):
    """The same rows added to a JAX OscBatch and to the port's."""
    _, jpa, tpa, _ = at
    jb, tb = JOK.OscBatch(jpa), TOK.OscBatch(tpa)
    for r in rows:
        assert jb.add(*r[1:]) == tb.add(*r[1:])
    return jb, tb


def case_rows(at, case):
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "empty":
        return []
    if case == "one":
        return table_rows(at, "sine", 3, 1, rng)
    if case in ("bucket128", "bucket129"):
        return table_rows(at, "saw", 0, int(case[-3:]), rng)
    if case == "over8blocks":
        # 10 blocks of one class (saw and square at mip 0), padded to 16
        return table_rows(at, "saw", 0, 700, rng) \
            + table_rows(at, "square", 0, 500, rng) \
            + table_rows(at, "pulse10", 5, 3, rng)
    if case == "amp_wraps":
        # amp0 / damp at and above 2**31 (and below -2**31) wrap to int32
        rows = table_rows(at, "triangle", 1, 40, rng, 1 << 31, 1 << 32) \
            + table_rows(at, "sine", 0, 8, rng, -(1 << 32), -(1 << 31))
        return [r[:7] + (r[7] + (1 << 32),) for r in rows]
    if case == "shared_tbase":
        # one table base under every pass class: buckets key on both
        # (rows for build() only; they need not fit their tables)
        n = 300
        return list(zip([0] * n, [5] * n, rng.integers(1, 19, n).tolist(),
                        [2] * n,
                        rng.integers(0, 1 << 30, n).tolist(), [1 << 24] * n,
                        [1 << 20] * n, [0] * n))
    return mixture(at, 40, 11)


def columns(batch):
    """The (tbase, npass, pos0, f0, dpos, df, amp0, damp) columns that
    OscBatch.add stores, int32: the twin's arguments."""
    return np.array(batch.rows, np.int32).reshape(-1, 8).T


def twin(at, batch, quality):
    """osc_rows_numpy of the port over `batch`'s rows."""
    return TOK.osc_rows_numpy(at[2].np_pairs, *columns(batch),
                              quality=quality)


@pytest.mark.parametrize("case", ["empty", "one", "bucket128", "bucket129",
                                  "over8blocks", "amp_wraps", "shared_tbase",
                                  "mixture"])
def test_build_matches_jax(atlases, case):
    rows = case_rows(atlases, case)
    jb, tb = batches(atlases, rows)
    assert tb.n == jb.n == len(rows)
    assert tb.rows == jb.rows
    want, got = jb.build(), tb.build()
    assert [c[0] for c in got] == list(TOK.PASS_CLASSES)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for ga, wa in zip(g[1:], w[1:]):
            assert ga.dtype == wa.dtype and ga.shape == wa.shape
            assert int((ga != wa).sum()) == 0
    if case == "over8blocks":
        assert got[-1][1].shape == (16,)


def test_pair_atlas_matches_jax(atlases):
    _, jpa, tpa, _ = atlases
    assert tpa.np_pairs.dtype == jpa.np_pairs.dtype
    assert (tpa.np_pairs == jpa.np_pairs).all()
    assert (tpa.np_pairs == tpa.data.reshape(-1)).all()
    for name in WAVES:
        for mm in MIPS:
            assert tpa.lookup(name, mm) == jpa.lookup(name, mm)


def test_evaluate_matches_jax_interpret(atlases):
    """One JAX evaluate_osc_batch (interpret mode: 5 pass-class calls)
    on the mixture, wrapped amplitudes and a class of 16 blocks."""
    rows = mixture(atlases, 16, 3) + case_rows(atlases, "amp_wraps") \
        + table_rows(atlases, "saw", 0, 1100, np.random.default_rng(4))
    jb, tb = batches(atlases, rows)
    want = JOK.evaluate_osc_batch(jb, jnp.asarray(atlases[1].data),
                                  interpret=True, quality=0)
    got = TOK.evaluate_osc_batch(tb, torch.from_numpy(atlases[2].data))
    assert got.dtype == np.int32 and got.shape == (len(rows), TOK.FRAG)
    assert int((got != want).sum()) == 0
    assert np.abs(got).max() > 0
    # the CPU path never reaches the kernel
    assert COK.osc_slots_call.launches == 0


@pytest.mark.parametrize("quality", [0, 1, 2])
def test_evaluate_matches_twin(atlases, quality):
    rows = mixture(atlases, 48, 20 + quality) + case_rows(atlases,
                                                          "bucket129")
    _, tb = batches(atlases, rows)
    got = TOK.evaluate_osc_batch(tb, torch.from_numpy(atlases[2].data),
                                 quality=quality)
    assert int((got != twin(atlases, tb, quality)).sum()) == 0
    assert COK.osc_slots_call.launches == 0


def test_evaluate_empty(atlases):
    _, tb = batches(atlases, [])
    got = TOK.evaluate_osc_batch(tb, torch.from_numpy(atlases[2].data))
    assert got.shape == (0, TOK.FRAG) and got.dtype == np.int32


@pytest.mark.parametrize("quality", [1, 2])
def test_evaluate_quality_matches_native(atlases, quality):
    """lerp tiers (normal = 2x lerp, lofi = single lerp doubled) vs a
    direct scalar port of the native interpolators
    (native/a2rt_units.inc lerp16, reference wtosc.c:37-46)."""
    rows = mixture(atlases, 16, 2)
    _, tb = batches(atlases, rows)
    got = TOK.evaluate_osc_batch(tb, torch.from_numpy(atlases[2].data),
                                 quality=quality)
    i16 = atlases[3].data.astype(np.int64)     # flat padded sample data

    def lerp16(base, ph):
        i = int(ph >> 8)
        x = int(ph & 0xFF)
        return (int(i16[base + i]) * (256 - x)
                + int(i16[base + i + 1]) * x) >> 8

    for ri, (base, _, _, _, ph0, dph, amp0, damp) in enumerate(rows):
        for n in (0, 1, 31, 63):
            ph16 = (ph0 + n * dph) >> 16
            dph16 = dph >> 16
            if quality == 1:
                v = lerp16(base, ph16) + lerp16(base, ph16 + (dph16 >> 1))
            else:
                v = lerp16(base, ph16) << 1
            amp = np.int32(np.int64(amp0) + n * damp)
            assert got[ri, n] == np.int32((v * np.int64(amp)) >> 17), \
                (ri, n, quality)


@pytest.mark.parametrize("quality", [0, 1, 2])
def test_twin_matches_jax_twin(atlases, quality):
    _, tb = batches(atlases, mixture(atlases, 32, 30 + quality))
    args = columns(tb)
    want = JOK.osc_rows_numpy(atlases[1].np_pairs, *args, quality=quality)
    got = TOK.osc_rows_numpy(atlases[2].np_pairs, *args, quality=quality)
    assert got.dtype == want.dtype and int((got != want).sum()) == 0


def test_twin_matches_rows_numpy(atlases):
    """The hifi twin against the port's host row math (no panmix)."""
    rows = mixture(atlases, 64, 5)
    c = np.array([(r[0],) + r[4:] for r in rows], np.int64)
    base, ph0, dph, amp0, damp = c.T
    z = np.zeros(len(rows), np.int64)
    zb = np.zeros(len(rows), bool)
    ref = rows_numpy(atlases[3].data, base, ph0, dph, amp0, damp,
                     zb, zb, zb, z, z, z, z)[:, 0, :]
    _, tb = batches(atlases, rows)
    assert int((twin(atlases, tb, 0).astype(np.int64) != ref).sum()) == 0


def test_evaluate_without_cuda_raises(atlases, monkeypatch):
    """No atlas, or a numpy one, means the card: without a CUDA device
    the call raises and computes nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    monkeypatch.setattr(TOK, "osc_slots_call",
                        lambda *a, **k: calls.append(a))
    for rows in ([], mixture(atlases, 2, 9)):
        _, tb = batches(atlases, rows)
        for dev_atlas in (None, atlases[2].data):
            with pytest.raises(RuntimeError, match="CUDA"):
                TOK.evaluate_osc_batch(tb, dev_atlas)
    assert calls == [] and COK.osc_slots_call.launches == 0


def test_osc_batch_without_jax():
    """With jax and audiality2_tpu blocked: the port's batch builds and
    evaluates on a CPU atlas."""
    body = r"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "audiality2_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, %r)
import torch
import audiality2_tpu_torch as a2
from audiality2_tpu_torch.tpu import osc_kernel as OK
i = a2.open_engine(48000, 1024, 1, batched=False)
pa = OK.PairAtlas()
pa.add_wave("saw", i.get_wave(i.get(0, "saw")))
pa.finalize()
b = OK.OscBatch(pa)
tbase, npass, off = pa.lookup("saw", 2)
for k in range(130):
    b.add(tbase, npass, off, k << 24, (1 << 24) + k, 1 << 26, 0)
out = OK.evaluate_osc_batch(b, torch.from_numpy(pa.data))
assert out.shape == (130, OK.FRAG) and abs(out).max() > 0
print("ok")
""" % ROOT
    r = subprocess.run([sys.executable, "-c", body], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().endswith("ok")
