"""The port's sharded render (``audiality2_tpu_torch.parallel``) on the
CPU against the JAX package's ``render_sharded`` (interpret mode) on the
effects song, and under a two-process gloo group.

- The effects song (stereo, superblocks of 31x64 frames) at 1, 2 and 4
  shards equals the JAX ``render_sharded`` over frames [0, 17856).  From
  frame 17,856 (superblock 9, where the first filter voice ends and the
  later voices move down one filter / fm lane) the JAX function leaves
  native, since it passes filter state on by lane position; the port
  stays equal to native there.
- Two spawned processes in a gloo group (``init_method="file://..."``)
  render the effects song across the lane shift and the slice song's
  first 24 superblocks; every rank returns the in-process form's
  output."""

import os
import tempfile
import time

import numpy as np
import pytest
import torch

import audiality2_tpu_torch as a2t
from audiality2_tpu_torch import parallel

from test_torch_parallel import (SB, SHIFT, SONGS, engine, renders, same)

GLOO_TIMEOUT_S = 300


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_effects_equals_jax_before_the_lane_shift(renders, n):
    out = renders("effects", n)
    assert same(out, renders("effects", "native")) == 0
    assert same(out[:, :SHIFT], renders("effects", "jax")[:, :SHIFT]) == 0


def test_reference_lane_fault(renders):
    """The JAX render_sharded leaves native first at (channel 0, frame
    17,856), where the lanes move; the port's render equals native
    there."""
    want = renders("effects", "native")
    jax_out = renders("effects", "jax")
    bad = np.nonzero(jax_out != want)
    assert len(bad[1]), "the JAX render_sharded equals native here"
    first = int(bad[1].min())
    assert first == SHIFT
    assert jax_out[0, first] != want[0, first]
    assert same(renders("effects", 4)[:, SHIFT:], want[:, SHIFT:]) == 0


def _gloo_rank(rank, world, store, out_dir):
    """One rank of the gloo test: both songs through the process-group
    form, saved to out_dir/rank<r>.npz."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    try:
        outs = {}
        for song, (src, frames) in SONGS.items():
            i, s = engine(a2t, src)
            outs[song] = parallel.render_sharded(
                i, s, frames, bufsize=SB, channels=2, devices=["cpu"],
                group=dist.group.WORLD)
        np.savez(os.path.join(out_dir, "rank%d.npz" % rank), **outs)
    finally:
        dist.destroy_process_group()


def test_gloo_two_ranks_equal_in_process(renders):
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_gloo_rank, args=(r, 2, store, tmp))
                 for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + GLOO_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
            p.join(10)
        assert not alive, "a gloo rank did not finish in %d s" \
            % GLOO_TIMEOUT_S
        assert [p.exitcode for p in procs] == [0, 0]
        outs = [dict(np.load(os.path.join(tmp, "rank%d.npz" % r)))
                for r in range(2)]
    for song in SONGS:
        want = renders(song, 2)
        for r in range(2):
            assert same(outs[r][song], want) == 0, (song, r)
        assert same(outs[0][song], renders(song, "native")) == 0
