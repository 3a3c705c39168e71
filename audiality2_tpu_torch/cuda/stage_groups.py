"""Step groups of an instance-batched stage item (filter12 / dcblock /
limiter, fm): runs of consecutive slice steps that may execute as one.

The JAX package's scan (``_apply_filter`` / ``_apply_fm`` in
``audiality2_tpu/tpu/superblock.py``) reads every input and old
destination value of a slice step before it adds any of the step's
outputs into the slots, and a slice reads and writes only the samples
of its window ``[off, off + frames)`` (clipped to the fragment): the
samples outside it change neither the state nor the slots.  A run of
steps may therefore read all of its inputs and old values first and
add everything after, as long as no step reads a sample that an
earlier step of the run writes:

  * a step joins the current group only if none of its source slots
    and, for a REPLACE item (``add == 0``, which reads its old
    destination values), none of its destination slots is a
    destination of an earlier step in the group whose window overlaps
    the step's own window;
  * only rows with a non-empty window count (padding rows, frames 0,
    carry the dead slot and write nothing).

The test runs per slot and window, not per channel: sound.  A test per
slot alone would break a group wherever an instance's fragment is
split into several slices, which on the voices' items of a real song
(splits staggered over some 60 instances) is nearly every step.  The
kernels (``csrc/filter_kernel.cu``, ``csrc/fm_kernel.cu``) take the
groups as int32 step bounds ``[G + 1]``.
"""

import numpy as np

FRAG = 64
# earlier events of a slot checked window by window; any write before
# them counts as a conflict (sound, and rare: a slot has few slices)
LOOKBACK = 8


def windows(arr, off_col):
    """Clipped sample windows [lo, hi) of the table's rows, int64
    [S, K] each (offset in off_col, frames in off_col + 1)."""
    off = arr[:, :, off_col].astype(np.int64)
    return (np.clip(off, 0, FRAG),
            np.clip(off + arr[:, :, off_col + 1], 0, FRAG))


def step_groups(arr, src_cols, dst_cols, off_col, add):
    """Step bounds int32 [G + 1] (0, ..., S) of the groups of the numpy
    table arr [S, K, C]: slot indices in src_cols and dst_cols, the
    window in off_col and off_col + 1."""
    S, K = arr.shape[:2]
    if S == 0:
        return np.zeros(1, np.int32)
    lo, hi = windows(arr, off_col)
    live = hi > lo
    step = np.broadcast_to(np.arange(S)[:, None], (S, K))[live]
    lo, hi = lo[live], hi[live]

    def events(cols):
        # a row's slots once each (stereo columns often repeat one)
        vals = [arr[:, :, c][live].astype(np.int64) for c in cols]
        out = []
        for i, v in enumerate(vals):
            m = np.ones(len(v), bool)
            for w in vals[:i]:
                m &= v != w
            out.append((v[m], step[m], lo[m], hi[m]))
        return out

    writes = events(dst_cols)
    reads = events(tuple(src_cols) + (() if add else tuple(dst_cols)))
    if not reads:
        return np.asarray([0, S], np.int32)
    # one event per (slot, step, window), reads of a step before its
    # writes; sorted by (slot, order), each read looks at the earlier
    # events of its slot
    slot, st, wlo, whi = (np.concatenate(x) for x in zip(*writes + reads))
    is_w = np.zeros(len(slot), bool)
    is_w[:sum(len(w[0]) for w in writes)] = True
    big = 2 * S + 2
    key = slot * big + 2 * st + is_w
    ev = np.argsort(key)
    key, slot, is_w, wlo, whi = (x[ev] for x in
                                 (key, slot, is_w, wlo, whi))
    st = (key - slot * big) >> 1
    # c_ev: the last earlier step that wrote an overlapping window of
    # the event's slot; first, any write LOOKBACK or more events back
    run = np.maximum.accumulate(np.where(is_w, key, slot * big - 1))
    c_ev = np.full(len(slot), -1, np.int64)
    # look back no further than the longest run of one slot's events
    first = np.flatnonzero(np.r_[True, slot[1:] != slot[:-1]])
    M = min(LOOKBACK, int(np.diff(np.r_[first, len(slot)]).max()) - 1)
    if len(slot) > M:
        c_ev[M + 1:] = np.maximum((run[:-M - 1] - slot[M + 1:] * big) >> 1,
                                  -1)
    for m in range(1, min(M, len(slot) - 1) + 1):
        q, p = slice(0, -m), slice(m, None)
        hit = (slot[q] == slot[p]) & is_w[q] & (wlo[q] < whi[p]) \
            & (wlo[p] < whi[q])
        c_ev[p] = np.maximum(c_ev[p], np.where(hit, st[q], -1))
    c = np.full(S, -1, np.int64)
    np.maximum.at(c, st[~is_w], c_ev[~is_w])
    bounds = [0]
    start = 0
    for s, prev in enumerate(c.tolist()):
        if prev >= start:
            bounds.append(s)
            start = s
    bounds.append(S)
    return np.asarray(bounds, np.int32)

