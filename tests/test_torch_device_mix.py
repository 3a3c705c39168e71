"""The host engine's device mixer (``open_engine(..., device_mix=True)``)
in the port against the JAX package, on the CPU.

``audiality2_tpu_torch/tpu/superblock.py`` keeps verbatim copies of the
JAX package's ``compile_superblock`` and its helpers (their source text
is held equal here); on the same recorded superblocks both build the
same ``SuperblockProgram``, field by field.  A ``device_mix=True``
render through the port's ``DeviceMixer`` (a ``TorchMixer``, here on
the CPU through ``row_device``) equals host replay and the JAX
package's ``device_mix`` render (interpret mode) with 0 mismatches:
the slice song (oscillator runs and panmix stages), a song whose
fbdelay the device program takes (so the engine commits to the device,
``_device_committed``), and the effects song, whose limiter falls back
to host replay with no mixer made.
"""

import copy
import inspect

import numpy as np
import pytest
import torch

import audiality2_tpu as a2j
from audiality2_tpu import constants as JC
from audiality2_tpu.tpu import superblock as JSB
import audiality2_tpu_torch as a2t
from audiality2_tpu_torch import constants as TC
from audiality2_tpu_torch.cuda import superblock as CSB
from audiality2_tpu_torch.tpu import superblock as TSB
from audiality2_tpu_torch.tpu.row_kernel import row_device
from audiality2_tpu_torch.songs import EFFECTS_SONG, SLICE_SONG

# a voice loop through a stereo fbdelay whose delays are all longer than
# a fragment: compile_superblock takes the fbdelay (its device branch)
FBD_SONG = """
Voice(P)
{
	struct { wtosc; panmix }
	w saw; p P; a .3
	d 40
	a 0; d 20
}
Song()
{
	struct { inline; fbdelay; panmix }
	fbdelay 150; ldelay 120; rdelay 90
	drygain .6; fbgain .4; lgain .3; rgain .3
	!n 0
	20 {
		Voice (n * .05)
		+n 1
		d 25
	}
	d 200
}
"""

COPIED = ["compile_superblock", "_shadow_ramper", "_PanmixShadow",
          "_FbdelayShadow", "_trunc_div_c"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", COPIED)
def test_copied_source_is_verbatim(name):
    assert inspect.getsource(getattr(TSB, name)) \
        == inspect.getsource(getattr(JSB, name))


def test_copied_constants_and_classes():
    for name in ("_ROW_HASPM", "_ROW_STEREO", "_ROW_CLAMP", "_ROW_NOISE",
                 "_ROW_DC", "FRAG", "_FBD_BUFSIZE"):
        assert getattr(TSB, name) == getattr(JSB, name), name
    assert TC.A2_PROCADD == JC.A2_PROCADD
    assert TSB.Unsupported is CSB.Unsupported
    assert TSB.SuperblockProgram is CSB.SuperblockProgram


def _render(pkg, compile_mod, src, channels, device_mix, blocks=3,
            bufsize=4096):
    """(output (channels, frames), core, programs compiled) of `src`
    through pkg's batched engine, rows on the host; with device_mix
    every program compile_superblock made is kept (a deep copy, before
    the mixer pads it)."""
    progs = []
    real = compile_mod.compile_superblock

    def keep(*a):
        prog = real(*a)
        progs.append(copy.deepcopy(prog))
        return prog
    compile_mod.compile_superblock = keep
    try:
        i = pkg.open_engine(44100, bufsize, channels, batched=True,
                            device_mix=device_mix)
        i.state.core.use_jax = False
        song = i.get(i.load_string(src, "t"), "Song")
        out = []
        i.state.core.sinks.append(lambda bufs, n: out.append(
            np.stack([np.array(b[:n]) for b in bufs])))
        i.timestamp_reset()
        i.starta(i.root_voice(), song, [])
        for _ in range(blocks):
            i.run(bufsize)
    finally:
        compile_mod.compile_superblock = real
    return np.concatenate(out, axis=1), i.state.core, progs


def _same_program(a, b):
    """Every field of two SuperblockPrograms equal (fbdelay unit ids are
    object ids of each engine's units, and differ)."""
    assert sorted(vars(a)) == sorted(vars(b))
    for k in vars(a):
        x, y = getattr(a, k), getattr(b, k)
        if k == "fbdelays":
            assert len(x) == len(y)
            for fx, fy in zip(x, y):
                assert sorted(fx) == sorted(fy)
                for f in fx:
                    if f not in ("unit_id", "unit"):
                        _same_value(fx[f], fy[f], (k, f))
        else:
            _same_value(x, y, k)


def _same_value(x, y, what):
    if isinstance(x, np.ndarray):
        assert np.array_equal(x, y), what
    elif isinstance(x, (list, tuple)):
        assert len(x) == len(y), what
        for u, v in zip(x, y):
            _same_value(u, v, what)
    elif isinstance(x, dict):
        assert sorted(x) == sorted(y), what
        for f in x:
            _same_value(x[f], y[f], (what, f))
    else:
        assert x == y, what


# name -> (source, whether the engine commits to the device)
DEVICE_SONGS = {"slice": (SLICE_SONG, False), "fbdelay": (FBD_SONG, True)}


@pytest.mark.parametrize("name", list(DEVICE_SONGS))
def test_device_mix_matches_host_replay_and_jax(name):
    src, committed = DEVICE_SONGS[name]
    host, _, _ = _render(a2t, TSB, src, 2, False)
    with row_device("cpu"):
        got, core, tprogs = _render(a2t, TSB, src, 2, True)
    want, jcore, jprogs = _render(a2j, JSB, src, 2, True)
    assert core.device_mixer is not None
    assert core.device_mixer.device.type == "cpu"
    assert core._device_committed == committed == jcore._device_committed
    assert tprogs and len(tprogs) == len(jprogs)
    if committed:
        assert any(p.fbdelays for p in tprogs)
    for tp, jp in zip(tprogs, jprogs):
        _same_program(tp, jp)
    assert np.abs(host).max() > 0
    assert int((got != host).sum()) == 0
    assert int((got != want).sum()) == 0


def test_effects_falls_back_to_host_replay():
    host, _, _ = _render(a2t, TSB, EFFECTS_SONG, 2, False)
    with row_device("cpu"):
        got, core, tprogs = _render(a2t, TSB, EFFECTS_SONG, 2, True)
    assert core.device_mixer is None and not tprogs
    assert not core._device_committed
    assert np.abs(host).max() > 0
    assert int((got != host).sum()) == 0


def test_device_mixer_takes_the_thread_row_device():
    """DeviceMixer(core) runs on the calling thread's row device, the
    card by default; the choice is the thread's, not the process's."""
    core = object()
    assert TSB.DeviceMixer(core).device == torch.device("cuda")
    with row_device("cpu"):
        assert TSB.DeviceMixer(core).device == torch.device("cpu")
    assert TSB.DeviceMixer(core, device="cpu").device.type == "cpu"
