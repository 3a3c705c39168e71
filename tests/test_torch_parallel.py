"""The port's sharded render (``audiality2_tpu_torch.parallel``) on the
CPU, in process, on the effects song: bit-equal to native and to the
port's solo render at 1, 2 and 4 shards.

The effects song (stereo) renders 24 superblocks of 31x64 frames, so
fbdelay, filter12, dcblock, limiter and fm state crosses superblocks.
At superblock 9 its first filter voice ends and every later voice moves
down one filter / fm lane, which the port's lanes follow by unit serial
(the mixer's lane permutation).  The JAX package's ``render_sharded``,
the slice song, the two-process (gloo) form and the sticky pads are in
``test_torch_parallel_group.py``."""

import numpy as np
import pytest
import torch

import audiality2_tpu_torch as a2t
from audiality2_tpu_torch.engine.device_render import DeviceRenderer
from audiality2_tpu_torch.native import NativeRenderer
from audiality2_tpu_torch.parallel import render_sharded, wrap32
from audiality2_tpu_torch.songs import EFFECTS_SONG, SLICE_SONG

# the JAX package's sharded test superblock (tests/test_parallel.py)
SB = 31 * 64
FRAMES = 24 * SB
# where the JAX render_sharded leaves native on the effects song: the
# first frame of superblock 9
SHIFT = 9 * SB
# the renders of test_torch_parallel_group.py / _slice.py: the effects
# song across the lane shift, the slice song's first 24 superblocks
SONGS = {"effects": (EFFECTS_SONG, SHIFT + SB),
         "slice": (SLICE_SONG, 24 * SB)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def engine(pkg, src, channels=2):
    i = pkg.open_engine(44100, 4096, channels, batched=False)
    return i, i.get(i.load_string(src, "t"), "Song")


def native(src, frames, channels=2):
    """Native render of whole superblocks of SB frames, trimmed."""
    i, s = engine(a2t, src, channels)
    r = NativeRenderer(i, channels=channels)
    r.timestamp_reset()
    r.start(0, s)
    out = np.concatenate([r.run(SB) for _ in range(-(-frames // SB))],
                         axis=1)[:, :frames]
    r.close()
    return out


def solo(src, frames, channels=2):
    """The port's solo render on the CPU, in superblocks of SB frames."""
    i, s = engine(a2t, src, channels)
    r = DeviceRenderer(i, channels=channels, device="cpu")
    r.timestamp_reset()
    r.start(0, s)
    out = r.render(frames, bufsize=SB)
    assert not r.fell_back
    r.close()
    return out


def sharded(src, frames, n, channels=2, **kw):
    """The port's in-process sharded render, n shards on the CPU."""
    i, s = engine(a2t, src, channels)
    return render_sharded(i, s, frames, n_devices=n, bufsize=SB,
                          channels=channels, devices=["cpu"] * n, **kw)


def same(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int((a != b).sum())


def jax_sharded(src, frames, n=1):
    """The JAX package's render_sharded, interpret mode."""
    import audiality2_tpu as a2j
    from audiality2_tpu.parallel import render_sharded as jax_render
    i, s = engine(a2j, src)
    return jax_render(i, s, frames, n_devices=n, bufsize=SB, channels=2,
                      interpret=True)


@pytest.fixture(scope="module")
def renders():
    """(song of SONGS, n) -> the port's in-process sharded render, and
    (song, "native" / "solo" / "jax") -> its references, each made once
    (and, for "jax", over `frames` frames when given)."""
    cache = {}

    def get(song, n, frames=None):
        src, full = SONGS[song]
        frames = frames or full
        if (song, n, frames) not in cache:
            if n == "native":
                out = native(src, frames)
            elif n == "solo":
                out = solo(src, frames)
            elif n == "jax":
                out = jax_sharded(src, frames)
            else:
                out = sharded(src, frames, n)
            cache[(song, n, frames)] = out
        return cache[(song, n, frames)]
    return get


@pytest.fixture(scope="module")
def effects():
    return {"native": native(EFFECTS_SONG, FRAMES),
            "solo": solo(EFFECTS_SONG, FRAMES)}


@pytest.fixture(scope="module")
def port_renders():
    """n -> the port's sharded render of the effects song, made once."""
    cache = {}

    def get(n):
        if n not in cache:
            cache[n] = sharded(EFFECTS_SONG, FRAMES, n)
        return cache[n]
    return get


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_equals_native_and_solo(effects, port_renders, n):
    out = port_renders(n)
    assert out.dtype == np.int32 and out.shape == (2, FRAMES)
    assert np.abs(out).max() > 0
    assert same(out, effects["native"]) == 0
    assert same(out, effects["solo"]) == 0


def test_int32_wrap_of_the_int64_sum():
    """The slot sum in int64, wrapped, equals int32 wrap-around addition,
    on slots near +-2^31."""
    rng = np.random.default_rng(5)
    for k in (2, 3, 4, 8):
        near = rng.integers(-(1 << 31), 1 << 31, (k, 4096), dtype=np.int64)
        edge = rng.choice(np.array([-(1 << 31), -(1 << 31) + 1, -1, 0,
                                    (1 << 31) - 2, (1 << 31) - 1]),
                          (k, 4096))
        parts = np.where(rng.random((k, 4096)) < 0.5, near, edge) \
            .astype(np.int32)
        want = parts[0].copy()
        with np.errstate(over="ignore"):
            for p in parts[1:]:
                want = want + p                # int32, wraps
        t = torch.from_numpy(parts)
        got = wrap32(t.to(torch.int64).sum(0))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        acc = t[0].clone()
        for p in t[1:]:
            acc += p
        assert torch.equal(got, acc)
        assert (np.abs(t.to(torch.int64).sum(0).numpy()) >= 1 << 31).any()


def test_more_shards_than_devices_raises():
    i, s = engine(a2t, EFFECTS_SONG)
    with pytest.raises(ValueError, match="need 3 devices, have 2"):
        render_sharded(i, s, SB, n_devices=3, bufsize=SB, channels=2,
                       devices=["cpu", "cpu"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="need %d devices" % (have + 1)):
        render_sharded(i, s, SB, n_devices=have + 1, bufsize=SB, channels=2)
