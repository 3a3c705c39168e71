"""The port's sharded render (``audiality2_tpu_torch.parallel``) on the
slice song, on the CPU: its first 24 superblocks of 31x64 frames
(stereo: linear and ramp-replayed runs, noise, panmix stages) at 1, 2
and 4 shards equal native, the port's solo render and the JAX package's
``render_sharded`` (interpret mode, over the first 12 superblocks); two
renders sharing ``cache`` share their sticky pads."""

import numpy as np
import pytest
import torch

from audiality2_tpu_torch import parallel
from audiality2_tpu_torch.songs import SLICE_SONG

from test_torch_parallel import SB, SONGS, native, renders, same, sharded

# the JAX render's length: half the port's, as its interpret mode is
# the slowest render of this file
JAX_FRAMES = 12 * SB


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_slice_equals_native_solo_and_jax(renders, n):
    out = renders("slice", n)
    assert out.dtype == np.int32 and out.shape == (2, SONGS["slice"][1])
    assert np.abs(out).max() > 0
    assert same(out, renders("slice", "native")) == 0
    assert same(out, renders("slice", "solo")) == 0
    assert same(out[:, :JAX_FRAMES],
                renders("slice", "jax", JAX_FRAMES)) == 0


def test_pads_stick_across_renders(monkeypatch):
    """A second render sharing `cache` starts from the first's pads: its
    first superblock's shard layout is the first render's last, and no
    high-water mark shrinks."""
    seen = []
    real = parallel.shard_programs

    def spy(*a, **kw):
        res = real(*a, **kw)
        seen.append((res[0], res[4].shape[1], res[2]))
        return res
    monkeypatch.setattr(parallel, "shard_programs", spy)
    frames = 8 * SB
    cache = {}
    first = sharded(SLICE_SONG, frames, 2, cache=cache)
    pads = dict(cache["hw"])
    one = list(seen)
    del seen[:]
    second = sharded(SLICE_SONG, frames, 2, cache=cache)
    assert same(first, second) == 0
    assert same(first, native(SLICE_SONG, frames)) == 0
    assert one[0] != one[-1], "the pads never grew in the first render"
    assert seen[0] == one[-1]
    assert all(s == one[-1] for s in seen)
    assert cache["hw"] == pads
