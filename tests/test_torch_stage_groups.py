"""Step groups of the stage items (``cuda/stage_groups.py``) are sound,
on the CPU.

The filter and fm kernels run each step group of an item as one step:
they read every input and old destination value of the group (a tile
of it) before they add any output.  A grouped emulator, written here in
plain torch, does the same: per group it runs the plain recurrence
(``filter_torch`` / ``fm_torch``) with every destination moved to a
fresh slot of its own, so no output of the group can reach an input,
then turns the outputs into deltas against the old values and adds
them, as ``stage_common.cuh``'s ``emit_tile`` does.  It must equal the
step-by-step plain versions and the JAX package's ``_apply_filter`` /
``_apply_fm`` with 0 mismatches: on the seeded tables that draw slots
from few values (groups break often), on seeded conflict-free tables
(one group spans the item), on seeded tables of in-place instances
over split fragments (disjoint windows of one slot: one group too),
and on the effects song's real tables.  The same
emulator over one group per item differs on a conflict-heavy table, so
the check can see an unsound grouping.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiality2_tpu.tpu import superblock as JSB
import audiality2_tpu_torch as a2t
from audiality2_tpu_torch.cuda import filter as FL
from audiality2_tpu_torch.cuda import fm as FM
from audiality2_tpu_torch.cuda import stage_groups as SG
from audiality2_tpu_torch.cuda.osc_kernel import _w
from audiality2_tpu_torch.engine.device_render import (DeviceRenderer,
                                                       SUPERBLOCK_FRAMES)
from audiality2_tpu_torch.songs import EFFECTS_SONG

FRAG = 64


def _emit_groupwise(slots, outs, arr, dst_cols, dch, off_col, add):
    """stage_common.cuh emit_tile over one group: outs int32 [T, K, no,
    64]; old values read before any add (channel 1 after channel 0's
    adds where both share a destination channel)."""
    no = len(dst_cols)
    n = torch.arange(FRAG)[None, None, :]
    off = arr[:, :, off_col:off_col + 1].to(torch.int64)
    msk = (n >= off) & (n < off + arr[:, :, off_col + 1:off_col + 2])
    late = not add and no == 2 and dch[0] == dch[-1]
    for cs in ([[0], [1]] if late else [list(range(no))]):
        deltas = []
        for c in cs:
            dst = arr[:, :, dst_cols[c]].to(torch.int64)
            d = outs[:, :, c].to(torch.int64)
            if not add:
                d = _w(d - slots[dst, dch[c]].to(torch.int64))
            deltas.append((dst, c, torch.where(msk, d, 0)))
        for dst, c, d in deltas:
            slots[:, dch[c]].index_add_(0, dst.reshape(-1),
                                        d.reshape(-1, FRAG).to(torch.int32))


def _fresh(slots, sub, src_cols, dst_cols):
    """A working slot array for the table sub: the slots that sub reads,
    then one fresh slot per (step, instance) for its outputs; sub's
    columns are renumbered to match (in place).  Returns (work, index
    of the first fresh slot)."""
    T, K = sub.shape[:2]
    src = sub[:, :, list(src_cols)].to(torch.int64)
    used = torch.unique(src)
    for c in src_cols:
        sub[:, :, c] = torch.searchsorted(used, sub[:, :, c].to(torch.int64))
    first = len(used)
    fresh = first + torch.arange(T * K, dtype=torch.int32).reshape(T, K)
    for c in dst_cols:
        sub[:, :, c] = fresh
    work = torch.cat([slots[used], torch.zeros((T * K, 2, FRAG),
                                               dtype=torch.int32)])
    return work, first


def grouped_filter(slots, kind, sig, arr, state, bounds):
    ni, no, add, sch, dch = sig
    for g0, g1 in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        sub = arr[g0:g1].clone()
        work, nslot = _fresh(slots, sub, (0, 1)[:ni], (2, 3))
        FL.filter_torch(work, kind, (ni, no, True, sch, (0, 1)[:no]), sub,
                        state)
        outs = work[nslot:].reshape(g1 - g0, arr.shape[1], 2, FRAG)
        _emit_groupwise(slots, outs, arr[g0:g1], (2, 3)[:no], dch, 4, add)
    return state


def grouped_fm(slots, sig, arr, state, sine, bounds):
    sk, add, dch = sig
    for g0, g1 in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        sub = arr[g0:g1].clone()
        work, nslot = _fresh(slots, sub, (), (0,))
        FM.fm_torch(work, (sk, True, 0), sub, state, sine)
        outs = work[nslot:].reshape(g1 - g0, arr.shape[1], 2, FRAG)
        _emit_groupwise(slots, outs, arr[g0:g1], (0,), (dch,), 1, add)
    return state


def conflicts(arr, src_cols, dst_cols, off_col, add, bounds):
    """Pairs (earlier step, later step) of one group where the later
    step reads (a source, or for REPLACE a destination) a sample that
    the earlier step writes: empty for sound bounds.  A direct check of
    step_groups, quadratic in the writes of a slot within a group."""
    lo, hi = SG.windows(arr, off_col)
    bad = []
    for g0, g1 in zip(bounds[:-1], bounds[1:]):
        wrote = {}                       # slot -> [(step, lo, hi)]
        for s in range(g0, g1):
            for k in np.nonzero(hi[s] > lo[s])[0].tolist():
                a, b = lo[s, k], hi[s, k]
                reads = [arr[s, k, c] for c in src_cols]
                if not add:
                    reads += [arr[s, k, c] for c in dst_cols]
                bad += [(w, s) for x in reads
                        for w, wa, wb in wrote.get(int(x), ())
                        if wa < b and a < wb]
            for k in np.nonzero(hi[s] > lo[s])[0].tolist():
                for c in dst_cols:
                    wrote.setdefault(int(arr[s, k, c]), []).append(
                        (s, lo[s, k], hi[s, k]))
    return bad


def _diff(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    return int((a != b).sum())


def _filter_cols(sig):
    ni, no, add = sig[:3]
    return (0, 1)[:ni], (2, 3)[:no], 4, add


def check_filter(kind, sig, slots, arr, state, jax=True):
    """Grouped emulator == filter_torch (== JAX); returns the bounds."""
    bounds = FL.groups(arr, sig)
    assert conflicts(arr, *_filter_cols(sig), bounds) == []
    res = []
    for fn in (FL.filter_torch, grouped_filter):
        ts = torch.from_numpy(slots.copy())
        tst = torch.from_numpy(state.copy())
        args = (torch.from_numpy(arr), tst) + \
            ((torch.from_numpy(bounds),) if fn is grouped_filter else ())
        fn(ts, kind, sig, *args)
        res.append((ts.numpy(), tst.numpy()))
    if jax:
        js, jst = JSB._apply_filter(jnp.asarray(slots), kind, sig,
                                    jnp.asarray(arr), jnp.asarray(state))
        res.append((np.asarray(js), np.asarray(jst)))
    for s, st in res[1:]:
        assert _diff(s, res[0][0]) == 0 and _diff(st, res[0][1]) == 0
    assert (res[0][0] != slots).any()
    return bounds


def check_fm(sig, slots, arr, state, jax=True):
    bounds = FM.groups(arr, sig)
    assert conflicts(arr, (), (0,), 1, sig[1], bounds) == []
    sine = torch.from_numpy(FM.sine_pairs())
    res = []
    for fn in (FM.fm_torch, grouped_fm):
        ts = torch.from_numpy(slots.copy())
        tst = torch.from_numpy(state.copy())
        args = (torch.from_numpy(arr), tst, sine) + \
            ((torch.from_numpy(bounds),) if fn is grouped_fm else ())
        fn(ts, sig, *args)
        res.append((ts.numpy(), tst.numpy()))
    if jax:
        js, jst = JSB._apply_fm(jnp.asarray(slots), sig, jnp.asarray(arr),
                                jnp.asarray(state))
        res.append((np.asarray(js), np.asarray(jst)))
    for s, st in res[1:]:
        assert _diff(s, res[0][0]) == 0 and _diff(st, res[0][1]) == 0
    assert (res[0][0] != slots).any()
    return bounds


def _sig(ni, no, add):
    return (ni, no, add, (0, 1)[:ni] if ni == 2 else (1,),
            (1, 0) if no == 2 else (0,))


# ---------------------------------------------------------------
# seeded tables
# ---------------------------------------------------------------

@pytest.mark.parametrize("layout", FL.LAYOUTS)
@pytest.mark.parametrize("add", [True, False], ids=["add", "rep"])
@pytest.mark.parametrize("ni,no", [(1, 1), (2, 2), (1, 2), (2, 1)])
@pytest.mark.parametrize("kind", FL.KINDS)
def test_grouped_filter_matches_plain_and_jax(kind, ni, no, add, layout):
    rng = np.random.default_rng(
        1000 * FL.LAYOUTS.index(layout) + 100 * FL.KINDS.index(kind)
        + 10 * ni + 2 * no + add)
    slots, arr, state = FL.seeded_item(rng, kind, ni, no, S=16, K=5,
                                       layout=layout)
    bounds = check_filter(kind, _sig(ni, no, add), slots, arr, state)
    G = len(bounds) - 1
    if layout != "shared":
        # own slots, or in place over disjoint windows: one group
        assert G == 1
    elif not add:
        # few shared slots, old values read: groups break
        assert 1 < G
    S = arr.shape[0]
    assert bounds[0] == 0 and bounds[-1] == S


@pytest.mark.parametrize("layout", FL.LAYOUTS)
@pytest.mark.parametrize("add", [True, False], ids=["add", "rep"])
@pytest.mark.parametrize("structkey", [256, 546, 1060])
def test_grouped_fm_matches_plain_and_jax(structkey, add, layout):
    rng = np.random.default_rng(
        2000 + 100 * FL.LAYOUTS.index(layout) + structkey % 97 + add)
    slots, arr, state = FM.seeded_item(rng, structkey, S=10, K=4,
                                       layout=layout)
    bounds = check_fm((structkey, add, 1 if add else 0), slots, arr,
                      state)
    G = len(bounds) - 1
    if add or layout != "shared":
        # no slot inputs: only a REPLACE destination whose window
        # repeats breaks
        assert G == 1
    else:
        assert 1 < G


def test_one_group_per_item_is_unsound_on_shared_slots():
    """The emulator sees a grouping that ignores the conflicts."""
    rng = np.random.default_rng(3)
    kind, sig = "f12", _sig(2, 2, False)
    slots, arr, state = FL.seeded_item(rng, kind, 2, 2, S=16, K=5)
    one = np.array([0, arr.shape[0]], np.int32)
    assert conflicts(arr, *_filter_cols(sig), one)
    res = []
    for b in (FL.groups(arr, sig), one):
        ts = torch.from_numpy(slots.copy())
        grouped_filter(ts, kind, sig, torch.from_numpy(arr),
                       torch.from_numpy(state.copy()), torch.from_numpy(b))
        res.append(ts.numpy())
    assert _diff(res[0], res[1]) > 0


@pytest.mark.parametrize("layout", FL.LAYOUTS)
def test_step_groups_are_maximal(layout):
    """Each bound is needed: merging any two neighbouring groups puts a
    conflicting pair in one group."""
    rng = np.random.default_rng(4 + FL.LAYOUTS.index(layout))
    for ni, no, add in [(1, 1, False), (2, 2, True), (2, 1, False)]:
        _, arr, _ = FL.seeded_item(rng, "dcb", ni, no, S=40, K=7,
                                   layout=layout)
        cols = _filter_cols((ni, no, add))
        b = SG.step_groups(arr, *cols)
        assert conflicts(arr, *cols, b) == []
        for i in range(1, len(b) - 1):
            assert conflicts(arr, *cols, np.delete(b, i))


# ---------------------------------------------------------------
# the effects song's real tables
# ---------------------------------------------------------------

@pytest.fixture(scope="module")
def effects_program():
    """The effects song's first stereo superblock at full size."""
    i = a2t.open_engine(44100, 4096, 2, batched=False)
    s = i.get(i.load_string(EFFECTS_SONG, "effects"), "Song")
    r = DeviceRenderer(i, channels=2, device="cpu")
    r.timestamp_reset()
    r.start(0, s)
    prog = r.record_program(SUPERBLOCK_FRAMES)
    r.close()
    return prog


# (S, K, groups) of the effects song's first superblock's items: the
# master limiter is an ADD item whose sources no step writes; the
# voices' filter12 / dcblock / fm2 items are REPLACE items in place on
# instances of their own, whose split fragments (a parameter change
# mid-fragment) keep disjoint windows: one group each (a test per slot
# alone cuts them into 210, 210 and 190)
REAL_GROUPS = {"lim": (2797, 1, 1), "f12": (275, 58, 1),
               "dcb": (275, 58, 1), "fm": (260, 58, 1)}


def test_real_group_counts(effects_program):
    seen = {}
    for fl in effects_program.filters:
        kind, key, arr = fl["kind"], fl["key"], fl["arr"]
        if kind == "fm":
            sig = (key[3], key[4], key[5][0])
            b = FM.groups(arr, sig)
            cols = ((), (0,), 1, sig[1])
        else:
            b = FL.groups(arr, key[3:8])
            cols = _filter_cols(key[3:8])
        assert conflicts(arr, *cols, b) == []
        seen[kind] = arr.shape[:2] + (len(b) - 1,)
    assert seen == REAL_GROUPS


@pytest.mark.parametrize("kind", ["lim", "f12", "dcb", "fm"])
def test_grouped_matches_plain_on_real_tables(kind, effects_program):
    """The whole real table, seeded slot contents and state."""
    fl = next(f for f in effects_program.filters if f["kind"] == kind)
    key, arr = fl["key"], fl["arr"]
    rng = np.random.default_rng(9)
    slots = rng.integers(-(1 << 27), 1 << 27,
                         (effects_program.ninst * effects_program.F + 1, 2,
                          FRAG)).astype(np.int32)
    K = arr.shape[1]
    if kind == "fm":
        state = rng.integers(-32768, 32768, (K, 4)).astype(np.int32)
        check_fm((key[3], key[4], key[5][0]), slots, arr, state)
    elif kind == "lim":
        state = rng.integers(0, 1 << 32, K).astype(np.int64)
        check_filter(kind, key[3:8], slots, arr, state)
    else:
        state = rng.integers(-(1 << 26), 1 << 26, (K, 2, 2)) \
            .astype(np.int32)
        check_filter(kind, key[3:8], slots, arr, state)
