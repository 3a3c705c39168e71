// The float stage tier of filter12 / dcblock / limiter items for Hopper
// (sm_90a): one cooperative launch per item.
//
// Replaces the JAX package's audiality2_tpu/tpu/superblock.py
// _apply_filter_float (stage_mode="float"): the per-sample recurrences of
// the exact tier become scans, filter12 / dcblock over 2x2 affine maps of
// the (d1, d2) state, the limiter's peak over max-plus pairs (drop, m).
// An item holds K instances; each instance-channel is one chain of
// N = S*64 samples (time-major), inactive samples being identity maps.
// Equal bit for bit to the plain version filter_float_torch in
// ../filter_float.py, which evaluates the same association order.
//
// What bounds it on an H100: per sample and chain 14-60 float32
// operations (filter_float.FLOPS_PER_SAMPLE) against 8-12 bytes of input,
// old value and output, so by the card's peaks the bytes bound it, at
// microseconds per superblock.  The serial part of a chain is one tile's
// walk and the prefix of its tiles' roots, so an item of one instance
// still spreads over the card.  Above the bound it is held by what one
// launch cannot avoid: a cooperative launch's floor, the grid barrier,
// two dependent memory round trips to build a tile (its slice rows, then
// their slots) and the atomic adds (PERF.md gives the phases).
//
// The association order (fixed by the tile layout, never by the grid or
// by timing): the chain is cut into tiles of TILE = 2048 samples (256
// threads x 8, the last tile padded with identity maps); every thread
// folds the maps of its 8 samples left to right; a tile's 256 chunk maps
// reduce pairwise in a balanced tree (level l+1 node i = level l nodes 2i
// then 2i+1), whose root is the tile's map; tile t's entry state is the
// chain's entry state with the roots of tiles 0 .. t-1 applied in order
// (the plain version's serial loop, filter_float.serial_entries); the
// state walks down the tree (a left child takes its parent's state, the
// right child the left child's map applied to it), then each thread walks
// its 8 samples: the outputs come from each sample's state before
// (filter) or after (limiter) its map.  Every float operation rounds on
// its own (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn: nothing
// contracts into a fused multiply-add), and outputs convert to int32
// saturating, as the JAX package's casts do.
//
// The launch (stage::launch_grid, every block resident), in phases:
//  1. Each block takes tiles blockIdx.x, blockIdx.x + gridDim.x, ...
//     For each, its threads load the tile's 32 slice rows and their
//     chunk's inputs once, into the tile's buffer, with the chain's entry
//     state and (REPLACE) the old values of the outputs' destinations;
//     build the chunk maps and the tree in the buffer (levels 0-5 by warp
//     shuffles, 5-8 in one warp); and publish the root to scratch.
//  2. One grid barrier: every input and old value is read before it, every
//     write comes after it.  Each tile then computes its own entry state
//     (the block stages the roots of tiles 0 .. t-1 of its chain in
//     shared memory, one warp applies them in order), and the tile T-1
//     writes the chain's end state (rounded half to even, saturated to
//     int32; the limiter's max(pk, 1) as int64).
//  3. The tile walks down the tree it kept (no second upsweep) and then
//     its chunks, from the inputs in its buffer.  The outputs (REPLACE:
//     their differences from the old values) go to the buffer, and each
//     warp adds its 256 samples with atomics, lane by lane over
//     contiguous samples (instances of one step may share a destination).
//     Where the two outputs of a REPLACE item share a slot channel,
//     channel 1 reads its old values after channel 0's adds, behind a
//     grid barrier, and adds after another, as in the JAX function.  Only
//     samples in [off, off + len) are added.
//
// Where a tile's buffer lives: in shared memory where the card holds
// every tile of the item at once (a block keeps one to a few tiles: the
// host takes the fewest tiles per block whose blocks are all resident).
// Otherwise (tiles beyond what shared memory holds) every buffer lives in
// a scratch slice of device memory, mostly L2-resident, and a block loops
// over its tiles there; the code is the same through a generic pointer.
// A tile is never rebuilt from its inputs.  Only grid barriers order the
// phases, so a CUDA graph captures and replays the launch as it does the
// exact tier's cooperative kernels.

#include <cstdint>
#include <cuda_runtime.h>

#include "stage_common.cuh"

namespace {

using stage::wadd;
using stage::wmul;
using stage::wsub;

constexpr int FRAG = 64;
constexpr int NCOL = 13;
constexpr int THREADS = 256;
constexpr int CHUNK = 8;
constexpr int TILE = THREADS * CHUNK;
constexpr int ROWS = TILE / FRAG;          // slice rows of a tile
constexpr int LEVELS = 8;
// nodes of the tile tree: level l starts at node NODES - (NODES >> l)
constexpr int NODES = 2 * THREADS;
constexpr int ROOT = NODES - 2;
constexpr int RSTAGE = 128;                // roots staged at once
enum { KIND_F12 = 0, KIND_DCB = 1, KIND_LIM = 2 };

// float32(2^31 - 1) = 2^31
constexpr float F_LIM = 2147483648.0f;

// Built with -DA2_FF_CLOCK (tail_ab.py), thread 0 of the first and
// of the last block stamps %globaltimer (ns) at the phase bounds:
// start, tiles built, barrier passed, entry state, walk down, outputs
// computed, outputs added, end; a2_filter_float_clock reads the stamps
// of the last launch.
#ifdef A2_FF_CLOCK
__device__ unsigned long long ff_clock[2][8];
__device__ __forceinline__ void clock_stamp(int i) {
    if (threadIdx.x == 0
        && (blockIdx.x == 0 || blockIdx.x == gridDim.x - 1)) {
        unsigned long long t;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
        ff_clock[blockIdx.x != 0][i] = t;
    }
}
#define CLOCK(i) clock_stamp(i)
#else
#define CLOCK(i)
#endif

__device__ __forceinline__ float fmul(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ float fadd(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
    return __fsub_rn(a, b);
}

__device__ __forceinline__ int level_base(int l) {
    return NODES - (NODES >> l);
}

// float -> int32 as the JAX tier's clip and astype: clipped to +-2^31,
// truncated, saturating
__device__ __forceinline__ int32_t sat_i32(float v) {
    return __float2int_rz(fminf(fmaxf(v, -F_LIM), F_LIM));
}

struct Item {
    int32_t* slots;          // [nslot, 2, 64]
    const int32_t* arr;      // [S, K, 13]
    void* state;             // f12/dcb int32 [K, 2, 2]; lim int64 [K]
    float* roots;            // [K * nch, T, W]: each tile's map
    float* gbuf;             // [tiles, tile_words]: the buffers, if not
                             // in shared memory
    int S, K, T, kind, stereo, nch, no, add;
    int sch0, sch1, dch0, dch1;
    int W;                   // floats of a map: 6 (affine) or 2
    int nin;                 // input planes of a buffer
    int nstore;              // sample planes of a buffer: the inputs, and
                             // (REPLACE) the outputs' old values
    int tiles, per_block, smem, tile_words, work_words;
    int root_words;          // floats of roots, rounded up to 16 bytes
};

// A tile's buffer: its tree [W][NODES], sample planes [nstore][TILE]
// (the inputs, whose planes an ADD item's outputs take over; a REPLACE
// item's old values, which become the differences), its slice rows
// [ROWS][NCOL], and the chain's entry state (2 floats, padded to 4).
struct Tile {
    float* tree;
    int32_t* x;
    const int32_t* rows;
    float* hdr;
    int tile, chain, k, c, t;
};

__device__ __forceinline__ Tile tile_at(const Item& it, float* smem,
                                        int tile, int j) {
    Tile tl;
    float* b = it.smem ? smem + it.work_words + (size_t)j * it.tile_words
                       : it.gbuf + (size_t)tile * it.tile_words;
    tl.tree = b;
    tl.x = (int32_t*)(b + it.W * NODES);
    tl.rows = tl.x + it.nstore * TILE;
    tl.hdr = (float*)(tl.x + it.nstore * TILE + ROWS * NCOL);
    tl.tile = tile;
    tl.chain = tile / it.T;
    tl.t = tile % it.T;
    tl.k = tl.chain / it.nch;
    tl.c = tl.chain % it.nch;
    return tl;
}

// ---- affine maps (filter12 / dcblock) ----

struct Aff {
    float a00, a01, a10, a11, b0, b1;
};

__device__ __forceinline__ Aff identity() {
    return {1.f, 0.f, 0.f, 1.f, 0.f, 0.f};
}

// l, then r
__device__ __forceinline__ Aff comb(const Aff& l, const Aff& r) {
    Aff o;
    o.a00 = fadd(fmul(r.a00, l.a00), fmul(r.a01, l.a10));
    o.a01 = fadd(fmul(r.a00, l.a01), fmul(r.a01, l.a11));
    o.a10 = fadd(fmul(r.a10, l.a00), fmul(r.a11, l.a10));
    o.a11 = fadd(fmul(r.a10, l.a01), fmul(r.a11, l.a11));
    o.b0 = fadd(fadd(fmul(r.a00, l.b0), fmul(r.a01, l.b1)), r.b0);
    o.b1 = fadd(fadd(fmul(r.a10, l.b0), fmul(r.a11, l.b1)), r.b1);
    return o;
}

__device__ __forceinline__ void apply(const Aff& m, float* s) {
    float n1 = fadd(fadd(fmul(m.a00, s[0]), fmul(m.a01, s[1])), m.b0);
    float n2 = fadd(fadd(fmul(m.a10, s[0]), fmul(m.a11, s[1])), m.b1);
    s[0] = n1;
    s[1] = n2;
}

__device__ __forceinline__ void store(float* t, int i, const Aff& m) {
    t[i] = m.a00;
    t[NODES + i] = m.a01;
    t[2 * NODES + i] = m.a10;
    t[3 * NODES + i] = m.a11;
    t[4 * NODES + i] = m.b0;
    t[5 * NODES + i] = m.b1;
}
__device__ __forceinline__ void load(const float* t, int i, Aff* m) {
    *m = {t[i], t[NODES + i], t[2 * NODES + i], t[3 * NODES + i],
          t[4 * NODES + i], t[5 * NODES + i]};
}
// a staged root
__device__ __forceinline__ void load_root(const float* r, Aff* m) {
    *m = {r[0], r[1], r[2], r[3], r[4], r[5]};
}
__device__ __forceinline__ Aff shfl_down(const Aff& m, int d) {
    const unsigned all = 0xffffffffu;
    return {__shfl_down_sync(all, m.a00, d), __shfl_down_sync(all, m.a01, d),
            __shfl_down_sync(all, m.a10, d), __shfl_down_sync(all, m.a11, d),
            __shfl_down_sync(all, m.b0, d), __shfl_down_sync(all, m.b1, d)};
}

// One filter sample's terms (the JAX function's per-sample tensors).
struct FSample {
    float F, Q, cF, hbias, xc, g0, g1, g2;
    bool act;
};

__device__ __forceinline__ FSample filt_sample(int kind, const int32_t* row,
                                               int n, int32_t x) {
    FSample s;
    int off = row[4];
    s.act = n >= off && n < off + row[5];
    s.xc = fmul(__int2float_rn(x), 1.0f / 32.0f);
    int ns = n - off;
    if (kind == KIND_F12) {
        int32_t fl = wadd(row[6], wmul(ns, row[7])) >> 12;
        int32_t qq = wadd(row[8], wmul(ns, row[9])) >> 12;
        s.F = fmul(__int2float_rn(fl), 1.0f / 4096.0f);
        s.Q = fmul(__int2float_rn(qq), 1.0f / 4096.0f);
        s.cF = fadd(fmul(s.F, 8.0f), 0.5f);
        float cQ = fadd(fmul(s.Q, 8.0f), 0.5f);
        s.hbias = fadd(fadd(s.cF, -0.5f), cQ);
        s.g0 = __int2float_rn(row[10]);
        s.g1 = __int2float_rn(row[11]);
        s.g2 = __int2float_rn(row[12]);
    } else {
        s.F = fmul(__int2float_rn(row[6] >> 12), 1.0f / 4096.0f);
        s.Q = 1.0f;
        s.cF = fadd(fmul(s.F, 8.0f), 0.5f);
        s.hbias = fadd(fadd(s.cF, -0.5f), 7.5f);
        s.g0 = s.g1 = s.g2 = 0.f;
    }
    return s;
}

__device__ __forceinline__ Aff filt_map(const FSample& s) {
    if (!s.act)
        return identity();
    float FQ = fmul(s.F, fadd(s.F, s.Q));
    return {fsub(1.0f, FQ), -s.F, s.F, 1.0f,
            fsub(fmul(s.F, fadd(s.xc, s.hbias)), s.cF), -s.cF};
}

// the output from the sample's state before its map
__device__ __forceinline__ float filt_out(const FSample& s, int kind,
                                          const float* d) {
    float l = fsub(fadd(d[1], fmul(s.F, d[0])), s.cF);
    float h = fsub(fsub(fadd(s.xc, fsub(s.hbias, s.cF)), l),
                   fmul(s.Q, d[0]));
    if (kind == KIND_F12) {
        float b = fsub(fadd(d[0], fmul(s.F, h)), s.cF);
        return fmul(fadd(fadd(fmul(l, s.g0), fmul(b, s.g1)),
                         fmul(h, s.g2)), 0.125f);
    }
    return fmul(h, 32.0f);
}

// ---- max-plus pairs (limiter): pk' = max(pk - d, m) ----

struct MP {
    float d, m;
};

__device__ __forceinline__ MP comb(const MP& l, const MP& r) {
    return {fadd(l.d, r.d), fmaxf(fsub(l.m, r.d), r.m)};
}

__device__ __forceinline__ void apply(const MP& m, float* s) {
    s[0] = fmaxf(fsub(s[0], m.d), m.m);
}

__device__ __forceinline__ void store(float* t, int i, const MP& m) {
    t[i] = m.d;
    t[NODES + i] = m.m;
}
__device__ __forceinline__ void load(const float* t, int i, MP* m) {
    *m = {t[i], t[NODES + i]};
}
__device__ __forceinline__ void load_root(const float* r, MP* m) {
    *m = {r[0], r[1]};
}
__device__ __forceinline__ MP shfl_down(const MP& m, int d) {
    return {__shfl_down_sync(0xffffffffu, m.d, d),
            __shfl_down_sync(0xffffffffu, m.m, d)};
}
__device__ __forceinline__ MP mp_identity() {
    return {0.0f, -1e30f};
}

__device__ __forceinline__ MP lim_map(const int32_t* row, int n, int32_t x0,
                                      int32_t x1, bool stereo) {
    int off = row[4];
    if (n < off || n >= off + row[5])
        return mp_identity();
    float a = __int2float_rn(x0);
    float pka;
    if (stereo) {
        float lp = fabsf(a), rp = fabsf(__int2float_rn(x1));
        float mx = fmaxf(lp, rp);
        pka = fadd(mx, floorf(fmul(fsub(mx, fabsf(fsub(lp, rp))), 0.5f)));
    } else {
        pka = fabsf(a);
    }
    return {__int2float_rn(row[6]),
            fmaxf(pka, __uint2float_rn((uint32_t)row[7]))};
}

// ---- the tile tree ----
//
// Node i of level l+1 is built by thread i << (l+1) from its own level-l
// node and that of thread (i << (l+1)) + (1 << l): levels 0-5 inside a
// warp (shuffles), levels 5-8 in warp 0 over the 8 warps' nodes.  Every
// node is stored in the tree for the walk down, which runs the other
// way: a thread's state passes to the thread (1 << l) above it through
// the left child's map.

// Stores thread i's chunk map v as leaf i and builds levels 1-8.
template <typename M>
__device__ __forceinline__ void upsweep(float* t, M v) {
    const int i = threadIdx.x, lane = i & 31;
    store(t, i, v);
    for (int l = 0; l < 5; l++) {
        M r = shfl_down(v, 1 << l);
        if ((lane & ((2 << l) - 1)) == 0) {
            v = comb(v, r);
            store(t, level_base(l + 1) + (i >> (l + 1)), v);
        }
    }
    __syncthreads();
    if (i < 32) {
        if (lane < THREADS / 32)
            load(t, level_base(5) + lane, &v);
        for (int l = 5; l < LEVELS; l++) {
            M r = shfl_down(v, 1 << (l - 5));
            if (lane < THREADS / 32 && (lane & ((2 << (l - 5)) - 1)) == 0) {
                v = comb(v, r);
                store(t, level_base(l + 1) + (lane >> (l - 4)), v);
            }
        }
    }
    __syncthreads();
}

// Warp 0, every lane holding the root's state s: lanes 0-7 end with the
// states of level 5's nodes, which they store to sd [NS][8].
template <typename M, int NS>
__device__ __forceinline__ void downsweep_top(const float* t, float* s,
                                              float* sd) {
    const int lane = threadIdx.x & 31;
    for (int l = LEVELS - 1; l >= 5; l--) {
        const int st = 1 << (l - 5);
        float p[NS];
        for (int q = 0; q < NS; q++)
            p[q] = __shfl_up_sync(0xffffffffu, s[q], st);
        if (lane < THREADS / 32 && (lane & (2 * st - 1)) == st) {
            M m;
            load(t, level_base(l) + (lane >> (l - 5)) - 1, &m);
            apply(m, p);
            for (int q = 0; q < NS; q++)
                s[q] = p[q];
        }
    }
    if (lane < THREADS / 32)
        for (int q = 0; q < NS; q++)
            sd[q * (THREADS / 32) + lane] = s[q];
}

// Every thread, after downsweep_top and a barrier: the state before
// thread i's chunk, into s.
template <typename M, int NS>
__device__ __forceinline__ void downsweep(const float* t, const float* sd,
                                          float* s) {
    const int i = threadIdx.x, lane = i & 31;
    for (int q = 0; q < NS; q++)
        s[q] = sd[q * (THREADS / 32) + (i >> 5)];
    for (int l = 4; l >= 0; l--) {
        const int st = 1 << l;
        float p[NS];
        for (int q = 0; q < NS; q++)
            p[q] = __shfl_up_sync(0xffffffffu, s[q], st);
        if ((lane & (2 * st - 1)) == st) {
            M m;
            load(t, level_base(l) + (i >> l) - 1, &m);
            apply(m, p);
            for (int q = 0; q < NS; q++)
                s[q] = p[q];
        }
    }
}

// ---- the item's outputs ----

// The outputs a chain emits (returned: how many), output e to output
// channel oc[e]; a mono input's second output channel gets 0.
__device__ __forceinline__ int outputs(const Item& it, int c, int oc[2]) {
    oc[0] = 0;
    oc[1] = 1;
    if (it.kind == KIND_LIM || it.nch == 1)
        return it.no;
    if (it.no == 2) {
        oc[0] = c;
        return 1;
    }
    // stereo-in/mono-out: the later channel wins the shared output
    return c == 1;
}

// output e is 0 (a mono input's second output channel)
__device__ __forceinline__ bool zero_output(const Item& it, int e) {
    return e == 1 && (it.kind == KIND_LIM ? !it.stereo : it.nch == 1);
}

// REPLACE with both outputs on one slot channel: channel 1 reads its old
// values after channel 0's adds
__device__ __forceinline__ bool late(const Item& it) {
    return !it.add && it.no == 2 && it.dch0 == it.dch1;
}

__device__ __forceinline__ int32_t* dst_of(const Item& it,
                                           const int32_t* row, int oc) {
    return it.slots + ((size_t)row[2 + oc] * 2 + (oc ? it.dch1 : it.dch0))
        * FRAG;
}

// the sample plane of output e: an ADD item's output takes its input's
// plane, a REPLACE item's its old values'
__device__ __forceinline__ int32_t* plane(const Item& it, const Tile& tl,
                                          int e) {
    return tl.x + (it.add ? e : it.nin + e) * TILE;
}

// This thread's chunk of tile tl: its slice row (null for padding) and
// first lane.
__device__ __forceinline__ const int32_t* chunk_row(const Item& it,
                                                    const Tile& tl,
                                                    int* n0) {
    int r = threadIdx.x / (FRAG / CHUNK);
    *n0 = threadIdx.x % (FRAG / CHUNK) * CHUNK;
    return tl.t * ROWS + r < it.S ? tl.rows + r * NCOL : nullptr;
}

// The chunk's outputs v, e-th of the chain, into plane e: as they are
// (ADD, over the inputs; channel 1 of a late REPLACE), else as
// differences from the old values there.
__device__ __forceinline__ void keep(const Item& it, const Tile& tl, int e,
                                     int oc, const int32_t v[CHUNK]) {
    int4* o = (int4*)(plane(it, tl, e) + threadIdx.x * CHUNK);
    const bool diff = !it.add && !(late(it) && oc == 1);
#pragma unroll
    for (int h = 0; h < 2; h++) {
        int4 w = make_int4(v[4 * h], v[4 * h + 1], v[4 * h + 2],
                           v[4 * h + 3]);
        if (diff) {
            const int4 old = o[h];
            w = make_int4(wsub(w.x, old.x), wsub(w.y, old.y),
                          wsub(w.z, old.z), wsub(w.w, old.w));
        }
        o[h] = w;
    }
}

// The warp's part of plane e (its 8 x 32 samples, one per lane in
// turn, so that each atomic covers 128 contiguous bytes) added to
// output channel oc, active samples only.  After __syncwarp().
__device__ __forceinline__ void add_warp(const Item& it, const Tile& tl,
                                         int e, int oc) {
    const int32_t* o = plane(it, tl, e);
    const int m0 = (threadIdx.x & ~31) * CHUNK + (threadIdx.x & 31);
#pragma unroll 2
    for (int i = 0; i < CHUNK; i++) {
        const int m = m0 + 32 * i, n = m % FRAG;
        const int32_t* row = tl.rows + m / FRAG * NCOL;   // padding: 0s
        if (n >= row[4] && n < row[4] + row[5])
            atomicAdd((uint32_t*)dst_of(it, row, oc) + n, (uint32_t)o[m]);
    }
}

// After the walk of a tile: its outputs that are added now (ADD: all
// but zeros; REPLACE: all, but channel 1 of a late item).
__device__ __forceinline__ void add_tile(const Item& it, const Tile& tl) {
    int oc[2];
    const int ne = outputs(it, tl.c, oc);
    __syncwarp();
    for (int e = 0; e < ne; e++)
        if (!(it.add && zero_output(it, e)) && !(late(it) && oc[e] == 1))
            add_warp(it, tl, e, oc[e]);
}

// A late REPLACE item's channel 1 after channel 0's adds and a grid
// barrier: the differences from the old values, a grid barrier, the
// adds.
__device__ __forceinline__ void emit_late(const Item& it, float* smem) {
    for (int step = 0; step < 2; step++) {
        stage::grid_sync();
        for (int j = 0; j < it.per_block; j++) {
            const int tile = blockIdx.x + j * gridDim.x;
            if (tile >= it.tiles)
                break;
            const Tile tl = tile_at(it, smem, tile, j);
            int oc[2];
            const int ne = outputs(it, tl.c, oc);
            for (int e = 0; e < ne; e++) {
                if (oc[e] != 1)
                    continue;
                if (step) {
                    add_warp(it, tl, e, 1);
                    continue;
                }
                int n0 = 0;
                const int32_t* row = chunk_row(it, tl, &n0);
                if (!row)
                    continue;
                int4* o = (int4*)(plane(it, tl, e) + threadIdx.x * CHUNK);
                const int4* d = (const int4*)(dst_of(it, row, 1) + n0);
#pragma unroll
                for (int h = 0; h < 2; h++) {
                    const int4 w = o[h], old = __ldcg(d + h);
                    o[h] = make_int4(wsub(w.x, old.x), wsub(w.y, old.y),
                                     wsub(w.z, old.z), wsub(w.w, old.w));
                }
            }
        }
    }
}

// ---- phase 1 and the entry states, shared by both kernels ----

// This thread's chunk of input plane q (slot channel ch) into the
// buffer and x.
__device__ __forceinline__ void load_plane(const Item& it, const Tile& tl,
                                           const int32_t* row, int n0,
                                           int q, int ch, int32_t x[CHUNK]) {
    const int4* src = (const int4*)(
        it.slots + ((size_t)row[ch] * 2 + (ch ? it.sch1 : it.sch0)) * FRAG
        + n0);
    int4* dst = (int4*)(tl.x + q * TILE + threadIdx.x * CHUNK);
    const int4 a = src[0], b = src[1];
    dst[0] = a;
    dst[1] = b;
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// Loads tile tl's slice rows, the chain's entry state and this thread's
// chunk's input planes (into x0 and, for a stereo limiter, x1; else x1
// is x0) and, for a REPLACE item, the old values of its outputs (but a
// late item's channel 1).  Returns the chunk's row (null for padding)
// and its first lane.
__device__ __forceinline__ const int32_t* load_tile(
        const Item& it, const Tile& tl, int32_t x0[CHUNK],
        int32_t x1[CHUNK], int* n0) {
    int32_t* rows = (int32_t*)tl.rows;
    for (int i = threadIdx.x; i < ROWS * NCOL; i += THREADS) {
        int s = tl.t * ROWS + i / NCOL;
        rows[i] = s < it.S ? it.arr[((size_t)s * it.K + tl.k) * NCOL
                                    + i % NCOL] : 0;
    }
    if (threadIdx.x == 0) {
        if (it.kind == KIND_LIM) {
            tl.hdr[0] = __ll2float_rn(((const int64_t*)it.state)[tl.k]);
        } else {
            const int32_t* st = (const int32_t*)it.state + tl.k * 4;
            tl.hdr[0] = __int2float_rn(st[tl.c]);
            tl.hdr[1] = __int2float_rn(st[2 + tl.c]);
        }
    }
    __syncthreads();
    const int32_t* row = chunk_row(it, tl, n0);
    if (!row)
        return nullptr;
    int oc[2];
    const int ne = it.add ? 0 : outputs(it, tl.c, oc);
    for (int e = 0; e < ne; e++) {
        if (late(it) && oc[e] == 1)
            continue;
        const int4* d = (const int4*)(dst_of(it, row, oc[e]) + *n0);
        int4* o = (int4*)(plane(it, tl, e) + threadIdx.x * CHUNK);
        o[0] = d[0];
        o[1] = d[1];
    }
    // filter: the chain's own channel; limiter: channel q
    load_plane(it, tl, row, *n0, 0, it.kind == KIND_LIM ? 0 : tl.c, x0);
    if (it.nin == 2) {
        load_plane(it, tl, row, *n0, 1, 1, x1);
    } else {
#pragma unroll
        for (int j = 0; j < CHUNK; j++)
            x1[j] = x0[j];
    }
    return row;
}

// Tile tl's entry state (the chain's entry state with the roots of tiles
// 0 .. t-1 applied in order, staged RSTAGE roots at a time in rs and
// applied by every lane of warp 0 alike), the chain's end state from its
// last tile, then the walk down: this thread's chunk's state into s.
// Called by every thread; rs [RSTAGE][W], sd [NS][8].
template <typename M, int NS>
__device__ __forceinline__ void tile_entry(const Item& it, const Tile& tl,
                                           float* rs, float* sd, float* s) {
    for (int q = 0; q < NS; q++)
        s[q] = tl.hdr[q];
    const float* r = it.roots + (size_t)tl.chain * it.T * it.W;
    for (int t0 = 0; t0 < tl.t; t0 += RSTAGE) {
        const int n = min(RSTAGE, tl.t - t0);
        for (int i = threadIdx.x; i < n * it.W; i += THREADS)
            rs[i] = __ldcg(r + (size_t)t0 * it.W + i);
        __syncthreads();
        if (threadIdx.x < 32) {
#pragma unroll 4
            for (int j = 0; j < n; j++) {
                M m;
                load_root(rs + j * it.W, &m);
                apply(m, s);
            }
        }
        __syncthreads();
    }
    if (threadIdx.x == 0 && tl.t == it.T - 1) {
        float e[NS];
        for (int q = 0; q < NS; q++)
            e[q] = s[q];
        M m;
        load(tl.tree, ROOT, &m);
        apply(m, e);
        if (it.kind == KIND_LIM) {
            ((int64_t*)it.state)[tl.k] = __float2ll_rz(fmaxf(e[0], 1.0f));
        } else {
            int32_t* st = (int32_t*)it.state + tl.k * 4;  // [2 (d1, d2), 2]
            st[tl.c] = sat_i32(rintf(e[0]));
            st[2 + tl.c] = sat_i32(rintf(e[1]));
            if (it.nch == 1)
                st[1] = st[3] = 0;
        }
    }
    if (threadIdx.x < 32)
        downsweep_top<M, NS>(tl.tree, s, sd);
    __syncthreads();
    CLOCK(3);
    downsweep<M, NS>(tl.tree, sd, s);
}

// ---- the kernels ----

// 64 registers at most: four blocks of a tile each on an SM
__global__ void __launch_bounds__(THREADS, 4) filt_scan(Item it) {
    extern __shared__ float4 smem4[];
    float* smem = (float*)smem4;
    float* sd = smem;                      // [2][8]: level 5's states
    float* rs = smem + 16;                 // [RSTAGE][6]: staged roots
    CLOCK(0);
    for (int j = 0; j < it.per_block; j++) {
        int tile = blockIdx.x + j * gridDim.x;
        if (tile >= it.tiles)
            break;
        Tile tl = tile_at(it, smem, tile, j);
        int32_t x[CHUNK], x1[CHUNK];
        int n0 = 0;
        const int32_t* row = load_tile(it, tl, x, x1, &n0);
        Aff acc = identity();
        if (row) {
            acc = filt_map(filt_sample(it.kind, row, n0, x[0]));
#pragma unroll
            for (int k = 1; k < CHUNK; k++)
                acc = comb(acc, filt_map(filt_sample(it.kind, row, n0 + k,
                                                     x[k])));
        }
        upsweep<Aff>(tl.tree, acc);
        if (threadIdx.x < 6)
            it.roots[(size_t)tile * 6 + threadIdx.x] =
                tl.tree[threadIdx.x * NODES + ROOT];
    }
    CLOCK(1);
    stage::grid_sync();
    CLOCK(2);
    for (int j = 0; j < it.per_block; j++) {
        int tile = blockIdx.x + j * gridDim.x;
        if (tile >= it.tiles)
            break;
        Tile tl = tile_at(it, smem, tile, j);
        float d[2];
        tile_entry<Aff, 2>(it, tl, rs, sd, d);
        CLOCK(4);
        int n0 = 0;
        const int32_t* row = chunk_row(it, tl, &n0);
        int oc[2];
        const int ne = outputs(it, tl.c, oc);
        if (row && ne) {
            int32_t v[CHUNK];
#pragma unroll
            for (int k = 0; k < CHUNK; k++) {
                FSample s = filt_sample(it.kind, row, n0 + k,
                                        tl.x[threadIdx.x * CHUNK + k]);
                v[k] = sat_i32(filt_out(s, it.kind, d));
                apply(filt_map(s), d);
            }
            keep(it, tl, 0, oc[0], v);
            if (ne == 2 && !it.add) {
                const int32_t z[CHUNK] = {};
                keep(it, tl, 1, 1, z);
            }
        }
        CLOCK(5);
        add_tile(it, tl);
        __syncthreads();                 // sd, rs are the next tile's
    }
    CLOCK(6);
    if (late(it))
        emit_late(it, smem);
    CLOCK(7);
}

__global__ void __launch_bounds__(THREADS) lim_scan(Item it) {
    extern __shared__ float4 smem4[];
    float* smem = (float*)smem4;
    float* sd = smem;                      // [8]: level 5's states
    float* rs = smem + 16;                 // [RSTAGE][2]: staged roots
    const int nin = it.nin;
    CLOCK(0);
    for (int j = 0; j < it.per_block; j++) {
        int tile = blockIdx.x + j * gridDim.x;
        if (tile >= it.tiles)
            break;
        Tile tl = tile_at(it, smem, tile, j);
        int32_t x0[CHUNK], x1[CHUNK];
        int n0 = 0;
        const int32_t* row = load_tile(it, tl, x0, x1, &n0);
        MP acc = mp_identity();
        if (row) {
            acc = lim_map(row, n0, x0[0], x1[0], it.stereo);
#pragma unroll
            for (int k = 1; k < CHUNK; k++)
                acc = comb(acc, lim_map(row, n0 + k, x0[k], x1[k],
                                        it.stereo));
        }
        upsweep<MP>(tl.tree, acc);
        if (threadIdx.x < 2)
            it.roots[(size_t)tile * 2 + threadIdx.x] =
                tl.tree[threadIdx.x * NODES + ROOT];
    }
    CLOCK(1);
    stage::grid_sync();
    CLOCK(2);
    for (int j = 0; j < it.per_block; j++) {
        int tile = blockIdx.x + j * gridDim.x;
        if (tile >= it.tiles)
            break;
        Tile tl = tile_at(it, smem, tile, j);
        float p[1];
        tile_entry<MP, 1>(it, tl, rs, sd, p);
        CLOCK(4);
        int n0 = 0;
        const int32_t* row = chunk_row(it, tl, &n0);
        if (row) {
            const int32_t* x0 = tl.x + threadIdx.x * CHUNK;
            const int32_t* x1 = x0 + (nin - 1) * TILE;
            int32_t o0[CHUNK], o1[CHUNK];
#pragma unroll
            for (int k = 0; k < CHUNK; k++) {
                const int32_t a = x0[k], b = x1[k];
                apply(lim_map(row, n0 + k, a, b, it.stereo), p);
                float gain = __fdiv_rn(
                    2147418112.0f,                       // 32767 << 16
                    fmaxf(floorf(fmul(fadd(p[0], 511.0f), 1.0f / 512.0f)),
                          1.0f));
                o0[k] = sat_i32(fmul(fmul(__int2float_rn(a), gain),
                                     1.0f / 65536.0f));
                o1[k] = it.stereo
                    ? sat_i32(fmul(fmul(__int2float_rn(b), gain),
                                   1.0f / 65536.0f)) : 0;
            }
            if (it.no == 2) {
                keep(it, tl, 0, 0, o0);
                if (it.stereo || !it.add)
                    keep(it, tl, 1, 1, o1);
            } else if (it.stereo) {
                // stereo-in/mono-out: the later channel wins
                keep(it, tl, 0, 0, o1);
            } else {
                keep(it, tl, 0, 0, o0);
            }
        }
        CLOCK(5);
        add_tile(it, tl);
        __syncthreads();                 // sd, rs are the next tile's
    }
    CLOCK(6);
    if (late(it))
        emit_late(it, smem);
    CLOCK(7);
}

// ---- the launch plan ----

struct Plan {
    Item it;
    void (*kernel)(Item);
    int grid;
    size_t smem_bytes;
    long long scratch;       // floats
};

int make_plan(int S, int K, int kind, int ni, int no, int add, Plan* p) {
    Item& it = p->it;
    it.S = S;
    it.K = K;
    it.T = (S * FRAG + TILE - 1) / TILE;
    it.kind = kind;
    it.stereo = ni == 2;
    it.nch = kind == KIND_LIM ? 1 : (ni == 2 ? 2 : 1);
    it.no = no;
    it.add = add;
    it.W = kind == KIND_LIM ? 2 : 6;
    it.nin = kind == KIND_LIM ? ni : 1;
    const int nout = kind == KIND_LIM ? no : (it.nch == 1 ? no : 1);
    it.nstore = add ? it.nin : it.nin + nout;
    it.tiles = K * it.nch * it.T;
    it.root_words = (it.tiles * it.W + 3) / 4 * 4;
    it.tile_words = it.W * NODES + it.nstore * TILE + ROWS * NCOL + 4;
    it.work_words = 16 + RSTAGE * it.W;    // sd [2][8], rs
    p->kernel = kind == KIND_LIM ? lim_scan : filt_scan;
    int dev = 0, sms = 0, optin = 0, per = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            (const void*)p->kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    // the fewest tiles per block whose blocks are all resident, buffers
    // in shared memory
    for (int mt = 1; e == cudaSuccess && mt <= it.tiles; mt++) {
        size_t bytes = 4 * ((size_t)it.work_words
                            + (size_t)mt * it.tile_words);
        if (bytes > (size_t)optin)
            break;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per, p->kernel, THREADS, bytes);
        if (e != cudaSuccess || per < 1)
            break;
        if ((long long)sms * per * mt >= it.tiles) {
            it.per_block = mt;
            it.smem = 1;
            p->grid = (it.tiles + mt - 1) / mt;
            p->smem_bytes = bytes;
            p->scratch = it.root_words;
            return 0;
        }
    }
    if (e != cudaSuccess)
        return (int)e;
    // the buffers in device memory
    p->smem_bytes = 4 * (size_t)it.work_words;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, p->kernel, THREADS, p->smem_bytes);
    if (e != cudaSuccess)
        return (int)e;
    if (per < 1)
        return (int)cudaErrorLaunchOutOfResources;
    p->grid = sms * per < it.tiles ? sms * per : it.tiles;
    it.per_block = (it.tiles + p->grid - 1) / p->grid;
    it.smem = 0;
    p->scratch = it.root_words + (long long)it.tiles * it.tile_words;
    return 0;
}

}  // namespace

// The launch plan of one float-tier item on the current device, into
// out[5]: the scratch floats the launch needs, the blocks, the tiles per
// block, whether the tile buffers live in shared memory (1) or in the
// scratch (0), and the shared memory bytes of a block.  Returns the CUDA
// error (0 for none).
extern "C" int a2_filter_float_plan(int S, int K, int kind, int ni, int no,
                                    int add, int64_t* out) {
    Plan p;
    int e = make_plan(S, K, kind, ni, no, add, &p);
    if (e)
        return e;
    out[0] = p.scratch;
    out[1] = p.grid;
    out[2] = p.it.per_block;
    out[3] = p.it.smem;
    out[4] = (int64_t)p.smem_bytes;
    return 0;
}

// One float-tier item in one cooperative launch: scratch holds
// a2_filter_float_plan's count of floats (each tile's root, then the
// tile buffers if they are not in shared memory).  Returns the CUDA
// error of the launch (0 for none).
extern "C" int a2_filter_float(int32_t* slots, const int32_t* arr,
                               void* state, float* scratch, int S, int K,
                               int kind, int ni, int no, int add, int sch0,
                               int sch1, int dch0, int dch1, void* stream) {
    Plan p;
    int e = make_plan(S, K, kind, ni, no, add, &p);
    if (e)
        return e;
    Item& it = p.it;
    it.slots = slots;
    it.arr = arr;
    it.state = state;
    it.roots = scratch;
    it.gbuf = scratch + it.root_words;
    it.sch0 = sch0;
    it.sch1 = sch1;
    it.dch0 = dch0;
    it.dch1 = dch1;
    return stage::launch_grid(p.kernel, it, THREADS,
                              (cudaStream_t)stream, p.grid, p.smem_bytes);
}

#ifdef A2_FF_CLOCK
// The phase stamps of the last launch, [first block, last block][8].
extern "C" int a2_filter_float_clock(unsigned long long* out) {
    return (int)cudaMemcpyFromSymbol(out, ff_clock, sizeof(ff_clock));
}
#endif
