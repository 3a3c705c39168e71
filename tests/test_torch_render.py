"""The port's DeviceRenderer end to end, on the CPU.

``DeviceRenderer(device="cpu")`` (native record -> port builder ->
TorchMixer with the oscillator's plain version) must equal the native
C++ renderer and the JAX package's ``DeviceRenderer(interpret=True)``
sample for sample on the slice song, without bridging natively, and
native on the effects song (fbdelay, filter12, dcblock, limiter, fm).
Content the device program cannot express (an fbdelay that goes
sub-fragment mid-song) bridges to the native path and still equals
native across the seam."""

import numpy as np
import pytest

import audiality2_tpu as a2j
from audiality2_tpu.engine.device_render import DeviceRenderer as JaxRenderer
import audiality2_tpu_torch as a2t
from audiality2_tpu_torch.engine.device_render import DeviceRenderer
from audiality2_tpu_torch.native import NativeRenderer
from audiality2_tpu_torch.songs import EFFECTS_SONG, SLICE_SONG

FRAMES = 16384

# the fbdelay goes sub-fragment at 0.6 s (test_device_render.py's
# mid-render fallback script): the record pass fails there and the
# renderer restarts natively
MIDFALL_SCRIPT = """
Song(V=1)
{
	struct { wtosc; fbdelay; panmix }
	drygain .5; fbgain .4; lgain .4; rgain .4
	w saw; a (V * .3); p 0n
	d 600
	fbdelay 1; ldelay 1; rdelay 1
	d 500
	a 0
	d 100
}

export SongMain(V=1)
{
	struct { inline; panmix }
	1:Song V
	d 1300
}
"""


def _open(pkg, src, channels, cls, program="Song", **kw):
    i = pkg.open_engine(44100, 4096, channels, batched=False)
    song = i.get(i.load_string(src, "t"), program)
    r = cls(i, channels=channels, **kw)
    r.timestamp_reset()
    r.start(0, song)
    return r


def _native(src, channels, frames):
    r = _open(a2t, src, channels, NativeRenderer)
    out = r.run(frames)
    r.close()
    return out


@pytest.fixture(scope="module")
def slice_refs():
    """Native and JAX-mixer renders of the slice song, stereo."""
    nat = _native(SLICE_SONG, 2, FRAMES)
    r = _open(a2j, SLICE_SONG, 2, JaxRenderer, interpret=True)
    jax_out = r.run(FRAMES)
    assert not r.fell_back
    r.close()
    return nat, jax_out


def test_run_matches_native_and_jax(slice_refs):
    nat, jax_out = slice_refs
    r = _open(a2t, SLICE_SONG, 2, DeviceRenderer, device="cpu")
    out = r.run(FRAMES)
    assert not r.fell_back
    r.close()
    assert out.dtype == np.int32 and out.shape == (2, FRAMES)
    assert np.abs(out).max() > 0
    assert int((out != nat).sum()) == 0
    assert int((out != jax_out).sum()) == 0


@pytest.mark.parametrize("bufsize", [FRAMES, 5000])
def test_render_matches_native(slice_refs, bufsize):
    """render(): one superblock, or several of 4992 frames with the
    last one trimmed."""
    nat, jax_out = slice_refs
    r = _open(a2t, SLICE_SONG, 2, DeviceRenderer, device="cpu")
    out = r.render(FRAMES, bufsize=bufsize)
    assert not r.fell_back
    assert r.timings["mix"] > 0
    r.close()
    assert out.shape == (2, FRAMES)
    assert int((out != nat).sum()) == 0
    assert int((out != jax_out).sum()) == 0


def test_mono_run_matches_native():
    nat = _native(SLICE_SONG, 1, 8192)
    r = _open(a2t, SLICE_SONG, 1, DeviceRenderer, device="cpu")
    out = np.concatenate([r.run(4096), r.run(4096)], axis=1)
    assert not r.fell_back
    r.close()
    assert out.shape == (1, 8192)
    assert int((out != nat).sum()) == 0


@pytest.mark.parametrize("use_render", [False, True])
def test_fbdelay_bridges_natively(use_render):
    """The fbdelay runs on the device path until it goes sub-fragment
    at 0.6 s; that superblock's record fails and the renderer bridges
    (fresh native state, control calls replayed, rendered frames
    skipped): the seam is sample-exact."""
    sb = 5 * 4096
    frames = 3 * sb
    r = _open(a2t, MIDFALL_SCRIPT, 1, NativeRenderer, program="SongMain")
    nat = np.concatenate([r.run(sb) for _ in range(3)], axis=1)
    r.close()
    r = _open(a2t, MIDFALL_SCRIPT, 1, DeviceRenderer, device="cpu",
              program="SongMain")
    first = r.run(sb)
    assert not r.fell_back
    if use_render:
        rest = r.render(frames - sb, bufsize=sb)
    else:
        rest = np.concatenate([r.run(sb) for _ in range(2)], axis=1)
    assert r.fell_back
    r.close()
    out = np.concatenate([first, rest], axis=1)
    assert np.abs(first).max() > 0
    assert int((out != nat).sum()) == 0


def test_effects_song_matches_native():
    """The effects song (dense stereo fbdelay, filter12, dcblock, fm2,
    the master limiter), 3 superblocks of 16384 frames stereo, mixes
    on the device path without bridging and equals native."""
    sb = FRAMES
    r = _open(a2t, EFFECTS_SONG, 2, NativeRenderer)
    nat = np.concatenate([r.run(sb) for _ in range(3)], axis=1)
    r.close()
    r = _open(a2t, EFFECTS_SONG, 2, DeviceRenderer, device="cpu")
    out = r.render(3 * sb, bufsize=sb)
    assert not r.fell_back
    r.close()
    assert out.shape == (2, 3 * sb) and np.abs(out).max() > 0
    assert int((out != nat).sum()) == 0


def test_cuda_device_without_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    i = a2t.open_engine(44100, 4096, 2, batched=False)
    with pytest.raises(RuntimeError):
        DeviceRenderer(i, channels=2)
