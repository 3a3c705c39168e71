"""The oscillator's slots epilogue (audiality2_tpu_torch/cuda/osc_kernel.py:
``osc_slots_call``, plain version ``osc_slots_torch``) against the JAX
package's Pallas kernel followed by its slot sum, and a model of the
CUDA kernel's thread maps.

On the CPU ``osc_slots_call`` runs ``osc_slots_torch``; it must equal
``_osc_call(interpret=True)`` followed by ``jax.ops.segment_sum`` into the
slots, as ``audiality2_tpu/tpu/superblock.py:1694`` adds them, with 0
mismatches on every slot, the dead slot included, for every pass class x
quality x fused_pm x mono, on seeded blocks (one row in eight dead) whose
rows share slots, within one block too, added into seeded slot contents.
The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` (``--phases kernel``)."""

import collections
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiality2_tpu.tpu import osc_kernel as JOK
from audiality2_tpu_torch.cuda import osc_kernel as OK

NSLOT = 24                  # the last one is the dead slot
NBLOCKS = 2
KERNEL_SRC = os.path.join(os.path.dirname(os.path.abspath(OK.__file__)),
                          "csrc", "osc_kernel.cu")


def seeded_case(npass, seed):
    """(tbase, params, atlas, slot_r, slots): seeded blocks with dead
    rows, slot indices that collide, seeded int32 slot contents."""
    rng = np.random.default_rng(1000 * seed + npass)
    tbase, params, atlas = OK.seeded_blocks(npass, NBLOCKS, rng, dead=True)
    slot_r = OK.seeded_slot_rows(NBLOCKS * OK.RPB, NSLOT, rng)
    slots = rng.integers(-(1 << 31), 1 << 31, (NSLOT, 2, OK.FRAG)) \
        .astype(np.int32)
    return tbase, params, atlas, slot_r, slots


VARIANTS = ((True, False), (True, True), (False, False), (False, True))


def jax_slots(npass, quality, tbase, params, atlas, slot_r, slots):
    """The JAX package's kernel, then its slot sum as superblock.py:1694
    adds it, for each (fused_pm, mono) of VARIANTS: {variant: slots}.
    One jit for the four (tracing and compiling the interpreted kernel
    take nearly all the time)."""
    def all_variants(tbase, params, atlas, slot_r, slots):
        out = []
        for fused_pm, mono in VARIANTS:
            res = JOK._osc_call(npass, tbase, params, atlas,
                                interpret=True, quality=quality,
                                fused_pm=fused_pm, mono=mono)
            seg = jax.ops.segment_sum(res.T, slot_r,
                                      num_segments=slots.shape[0])
            out.append(slots.at[:, 0].add(seg) if mono
                       else slots + seg.reshape(slots.shape))
        return out
    res = jax.jit(all_variants)(
        jnp.asarray(tbase), jnp.asarray(params), jnp.asarray(atlas),
        jnp.asarray(slot_r, jnp.int32), jnp.asarray(slots))
    return {v: np.asarray(x) for v, x in zip(VARIANTS, res)}


@pytest.fixture(scope="module")
def jax_reference():
    """jax_slots of seeded_case(npass, quality), once per (npass,
    quality)."""
    cache = {}

    def get(npass, quality):
        if (npass, quality) not in cache:
            cache[npass, quality] = jax_slots(
                npass, quality, *seeded_case(npass, quality))
        return cache[npass, quality]
    return get


def test_seeded_slots_collide():
    """The seeded slot indices put many rows on one slot, inside one
    128-row block too, and some on the dead slot; some rows are dead."""
    _, params, _, slot_r, _ = seeded_case(4, 0)
    for b in range(NBLOCKS):
        blk = slot_r[b * OK.RPB:(b + 1) * OK.RPB]
        assert np.bincount(blk).max() >= 8
    assert (slot_r == NSLOT - 1).any()
    assert len(np.unique(slot_r)) < NSLOT
    assert (params[OK.P_AMP0] == 0).any()


@pytest.mark.parametrize("fused_pm,mono", VARIANTS)
@pytest.mark.parametrize("quality", [0, 1, 2])
@pytest.mark.parametrize("npass", list(OK.PASS_CLASSES))
def test_osc_slots_torch_matches_pallas_segment_sum(jax_reference, npass,
                                                    quality, fused_pm, mono):
    tbase, params, atlas, slot_r, slots = seeded_case(npass, quality)
    want = jax_reference(npass, quality)[fused_pm, mono]
    got = torch.from_numpy(slots.copy())
    out = OK.osc_slots_call(npass, torch.from_numpy(tbase),
                            torch.from_numpy(params),
                            torch.from_numpy(atlas), got,
                            torch.from_numpy(slot_r), quality=quality,
                            fused_pm=fused_pm, mono=mono)
    assert out is got and got.dtype == torch.int32
    assert int((got.numpy() != want).sum()) == 0
    # the rows reached the slots, and mono left channel 1 alone
    assert int((got.numpy() != slots).sum()) > 0
    if mono:
        assert (got.numpy()[:, 1] == slots[:, 1]).all()
    # the CPU path never reaches the kernel
    assert OK.osc_slots_call.launches == 0


def test_mono_slots_of_one_channel():
    """Mono slots may hold one channel: the same adds as channel 0 of
    two-channel slots."""
    tbase, params, atlas, slot_r, slots = seeded_case(2, 5)
    args = [torch.from_numpy(x) for x in (tbase, params, atlas)]
    two = torch.from_numpy(slots.copy())
    one = torch.from_numpy(slots[:, :1].copy())
    for s in (two, one):
        OK.osc_slots_call(2, *args, s, torch.from_numpy(slot_r), quality=0,
                          mono=True)
    assert (one[:, 0] == two[:, 0]).all()


def test_non_cpu_tensor_never_takes_plain_version():
    """Only a CPU tensor takes the plain version: any other device
    launches the kernel or raises (here: meta tensors, and slots of the
    wrong channel count)."""
    tbase, params, atlas, slot_r, slots = seeded_case(1, 0)
    meta = [torch.from_numpy(x).to("meta")
            for x in (tbase, params, atlas, slots, slot_r)]
    with pytest.raises(ValueError):
        OK.osc_slots_call(1, *meta)
    with pytest.raises(ValueError):
        OK.osc_slots_call(1, *meta[:3], meta[3][:, :1], meta[4])


def test_slots_work_counts_live_rows():
    """The bound's count: dead rows and empty windows need no
    operations; the touched slots are the live rows' distinct slots."""
    tbase, params, atlas, slot_r, _ = seeded_case(4, 1)
    nb, nops = OK.slots_work([(4, tbase, params, slot_r)], len(atlas), 0,
                             True, False)
    p = params.astype(np.int64)
    win = np.clip(p[OK.P_END], 0, 64) - np.clip(p[OK.P_OFF], 0, 64)
    live = ((p[OK.P_AMP0] != 0) | (p[OK.P_DAMP] != 0)) & (win > 0)
    assert nops == int(win[live].sum()) * (OK.ops_per_frame(0, True, False)
                                           + 2)
    assert live.sum() < len(live)
    touched = len(np.unique(slot_r[live]))
    rows = len({r for t in tbase.tolist() for r in range(t, t + 4)})
    assert nb == (NBLOCKS * OK.RPB * (OK.NPREAD * 4 + 8) + NBLOCKS * 4
                  + rows * OK.RPB * 4 + touched * 2 * OK.FRAG * 8)


# ---------------------------------------------------------------
# a model of csrc/osc_kernel.cu's thread maps
# ---------------------------------------------------------------

def kernel_threads():
    """NTHREADS as csrc/osc_kernel.cu defines it."""
    with open(KERNEL_SRC) as f:
        m = re.search(r"constexpr int NTHREADS = (\d+);", f.read())
    return int(m.group(1))


def thread_items(epilogue, nthreads, t):
    """The (row, frame) items of thread t in the order osc_body takes
    them: rows, thread t -> row t % 128, frames (t / 128) * FPT .. + FPT;
    slots, warp w -> rows w, w + NWARPS, ..., lane l -> frames l, l + 32."""
    if epilogue == "rows":
        fpt = OK.FRAG * OK.RPB // nthreads
        r, n0 = t % OK.RPB, (t // OK.RPB) * fpt
        return [(r, n0 + k) for k in range(fpt)]
    warp, lane = divmod(t, 32)
    return [(r, lane + 32 * h) for r in range(warp, OK.RPB, nthreads // 32)
            for h in range(OK.FRAG // 32)]


def test_kernel_block_shape_is_modelled():
    """The kernel's block is one of the shapes the model covers."""
    assert kernel_threads() in (256, 512)


@pytest.mark.parametrize("mono", [False, True])
@pytest.mark.parametrize("epilogue", ["rows", "slots"])
@pytest.mark.parametrize("nthreads", [256, 512])
def test_thread_map_covers_each_item_once(nthreads, epilogue, mono):
    """Every (row, frame, channel) item of a 128-row block is taken by
    exactly one thread, and each warp-wide store or add touches 32
    neighbouring words: 32 neighbouring rows of one output row (rows),
    32 neighbouring frames of one slot channel (slots)."""
    chans = (0,) if mono else (0, 1)
    seen = collections.Counter()
    items = [thread_items(epilogue, nthreads, t) for t in range(nthreads)]
    for its in items:
        seen.update((r, n, c) for r, n in its for c in chans)
    assert len(seen) == OK.RPB * OK.FRAG * len(chans)
    assert set(seen.values()) == {1}
    for w in range(nthreads // 32):
        lanes = items[32 * w:32 * w + 32]
        assert len({len(its) for its in lanes}) == 1
        for step in zip(*lanes):
            rows = [r for r, _ in step]
            frames = [n for _, n in step]
            if epilogue == "rows":
                # out[ch*64 + n][row]: one output row, rows in a line
                assert len(set(frames)) == 1
                assert rows == list(range(rows[0], rows[0] + 32))
            else:
                # slots[slot_r[row]][ch][n]: one row, frames in a line
                assert len(set(rows)) == 1
                assert frames == list(range(frames[0], frames[0] + 32))
