"""The port's oscillator (audiality2_tpu_torch/cuda/osc_kernel.py)
against the JAX package's Pallas kernel and its numpy twin.

On the CPU ``osc_call`` runs the kernel's plain PyTorch version; it must
equal ``_osc_call(interpret=True)`` exactly (0 mismatches) on the same
numpy-seeded rows for every pass class x quality x mono x fused_pm.
The CUDA kernel itself is held against the plain version on the card
by ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiality2_tpu.engine.state import open_engine
from audiality2_tpu.tpu import osc_kernel as JOK
from audiality2_tpu_torch.cuda import osc_kernel as OK


def make_blocks(npass, seed=0, dead=False):
    return OK.seeded_blocks(
        npass, 2, np.random.default_rng(seed * 100 + npass), dead=dead)


def _jax_rows(npass, tbase, params, atlas, quality, fused_pm, mono):
    return np.asarray(JOK._osc_call(
        npass, jnp.asarray(tbase), jnp.asarray(params), jnp.asarray(atlas),
        interpret=True, quality=quality, fused_pm=fused_pm, mono=mono))


@pytest.mark.parametrize("fused_pm,mono", [(True, False), (True, True),
                                           (False, False), (False, True)])
@pytest.mark.parametrize("quality", [0, 1, 2])
@pytest.mark.parametrize("npass", list(OK.PASS_CLASSES))
def test_osc_rows_torch_matches_pallas(npass, quality, fused_pm, mono):
    tbase, params, atlas = make_blocks(npass, seed=quality)
    want = _jax_rows(npass, tbase, params, atlas, quality, fused_pm, mono)
    got = OK.osc_call(npass, torch.from_numpy(tbase),
                      torch.from_numpy(params), torch.from_numpy(atlas),
                      quality=quality, fused_pm=fused_pm, mono=mono)
    assert got.dtype == torch.int32
    assert got.shape == want.shape
    assert int((got.numpy() != want).sum()) == 0
    # the CPU path never reaches the kernel
    assert OK.osc_call.launches == 0


@pytest.fixture(scope="module")
def waves():
    i = open_engine(48000, 1024, 1)
    return {name: i.get_wave(i.get(0, name))
            for name in ("saw", "triangle", "sine", "square", "pulse10")}


@pytest.mark.parametrize("quality", [0, 1, 2])
def test_osc_rows_torch_matches_numpy_twin(waves, quality):
    """Unfused rows on real builtin waves vs the JAX package's numpy
    twin (osc_rows_numpy), one block per (wave, mip) table."""
    rng = np.random.default_rng(7 + quality)
    pa = OK.PairAtlas()
    for name, w in waves.items():
        pa.add_wave(name, w)
    atlas = pa.finalize()
    tb_rows, pos0, f0, dpos, df, amp0, damp, cls = ([] for _ in range(8))
    for name, w in waves.items():
        for mm in (0, 1, 3, 5, 8):
            tbase, npass, off = pa.lookup(name, mm)
            ph0 = rng.integers(0, w.size[mm] << 24, OK.RPB)
            dph = rng.integers(1 << 18, 2 << 24, OK.RPB)
            tb_rows.append(np.full(OK.RPB, tbase))
            pos0.append((ph0 >> 24) + off)
            f0.append(ph0 & 0xFFFFFF)
            dpos.append(dph >> 24)
            df.append(dph & 0xFFFFFF)
            amp0.append(rng.integers(-(1 << 27), 1 << 27, OK.RPB))
            damp.append(rng.integers(-(1 << 20), 1 << 20, OK.RPB))
            cls.append(OK.pass_class(npass))
    cat = [np.concatenate(x).astype(np.int32)
           for x in (tb_rows, pos0, f0, dpos, df, amp0, damp)]
    tbr, pos0, f0, dpos, df, amp0, damp = cat
    want = JOK.osc_rows_numpy(atlas.reshape(-1), tbr, None, pos0, f0, dpos,
                              df, amp0, damp, quality=quality)
    for b, c in enumerate(cls):
        sl = slice(b * OK.RPB, (b + 1) * OK.RPB)
        params = np.zeros((OK.NPARAM, OK.RPB), np.int32)
        for j, x in enumerate((pos0, f0, dpos, df, amp0, damp)):
            params[j] = x[sl]
        params[OK.P_END] = 64
        got = OK.osc_call(c, torch.from_numpy(tbr[sl][:1].copy()),
                          torch.from_numpy(params), torch.from_numpy(atlas),
                          quality=quality, fused_pm=False)
        assert int((got[:64].numpy().T != want[sl]).sum()) == 0
        assert not got[64:].any()


def test_pair_atlas_matches_original(waves):
    mine, ref = OK.PairAtlas(), JOK.PairAtlas()
    for name, w in waves.items():
        mine.add_wave(name, w)
        ref.add_wave(name, w)
    assert (mine.finalize() == ref.finalize()).all()
    for name, w in waves.items():
        for mm in range(w.miplevels):
            assert mine.lookup(name, mm) == ref.lookup(name, mm)
    assert OK.PASS_CLASSES == JOK.PASS_CLASSES
    for n in range(1, 19):
        assert OK.pass_class(n) == JOK.pass_class(n)


def test_plain_version_clamps_dead_rows():
    """Dead rows (amp 0, garbage phase) read clamped table indices and
    emit silence; live rows are untouched by their presence."""
    tbase, params, atlas = make_blocks(4, seed=3, dead=True)
    got = OK.osc_call(4, torch.from_numpy(tbase), torch.from_numpy(params),
                      torch.from_numpy(atlas), quality=0).numpy()
    dead = params[OK.P_AMP0] == 0
    assert not got[:, dead].any()
    live = make_blocks(4, seed=3)[1]
    assert (params[:, ~dead] == live[:, ~dead]).all()
    want = _jax_rows(4, tbase, live, atlas, 0, True, False)
    assert (got[:, ~dead] == want[:, ~dead]).all()


def test_non_cpu_tensor_never_takes_plain_version():
    """Only a CPU tensor takes the plain version: any other device
    launches the kernel or raises (here: a meta tensor)."""
    tbase, params, atlas = make_blocks(1)
    with pytest.raises(ValueError):
        OK.osc_call(1, torch.from_numpy(tbase).to("meta"),
                    torch.from_numpy(params).to("meta"),
                    torch.from_numpy(atlas).to("meta"))
