// The float stage tier of filter12 / dcblock / limiter items for Hopper
// (sm_90a).
//
// Replaces the JAX package's audiality2_tpu/tpu/superblock.py
// _apply_filter_float (stage_mode="float"): the per-sample recurrences of
// the exact tier become scans, filter12 / dcblock over 2x2 affine maps of
// the (d1, d2) state, the limiter's peak over max-plus pairs (drop, m).
// An item holds K instances; each instance-channel is one sequence of
// N = S*64 samples (time-major), inactive samples being identity maps.
// Equal bit for bit to the plain version filter_float_torch in
// ../filter_float.py, which evaluates the same association order.
//
// What bounds it on an H100: per sample and channel some 60 float32
// operations (the map, its share of the tree, the output) against 8-12
// bytes of input, old value and output, so by the card's peaks the bytes
// bound it, at microseconds per superblock.  The exact tier's kernel is
// held back by its serial chains (179,008 dependent samples for the
// effects song's master limiter, K = 1); here no chain is longer than a
// tile, so an item of one instance still fills the card.
//
// The tile argument: a reduce-then-scan over fixed tiles of the time
// axis, TILE = 2048 samples (256 threads x 8), in three launches:
//  1. agg: one block per (tile, instance-channel); every thread folds the
//     maps of its 8 samples left to right, and the block reduces its 256
//     chunk maps pairwise in a balanced tree in shared memory (level l+1
//     node i = level l nodes 2i then 2i+1); the root is the tile's map.
//  2. scan: one thread per instance-channel applies the tile maps to the
//     entry state in order (about N / 2048 steps: 88 for the limiter of
//     a 2752-fragment superblock), storing each tile's entry state and
//     the end state (rounded half to even, saturated to int32; the
//     limiter's max(pk, 1) as int64).
//  3. walk: the agg block again, keeping the tree's levels; the tile's
//     entry state walks down the tree (a left child takes its parent's
//     state, the right child the left child's map applied to it), then
//     each thread walks its 8 samples and produces their outputs.
// The association order is fixed by the tile layout, never by the grid
// size or by timing.  Every float operation rounds on its own
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn: nothing contracts into
// a fused multiply-add), and outputs convert to int32 saturating, as the
// JAX package's casts do.
//
// The emit: the walk writes each output to scratch; a fourth launch, over
// the whole card, runs stage::emit_tile (stage_common.cuh), the exact
// tier's emit: REPLACE as add-of-difference against old values read
// before any write, atomic adds, and a second output channel that shares
// the first one's slot channel reading its old values after the first
// channel's adds, as in the JAX function.  All inputs are read before
// any write, as there.

#include <cstdint>
#include <cuda_runtime.h>

#include "stage_common.cuh"

namespace {

using stage::wadd;
using stage::wmul;

constexpr int FRAG = 64;
constexpr int NCOL = 13;
constexpr int THREADS = 256;
constexpr int CHUNK = 8;
constexpr int TILE = THREADS * CHUNK;
constexpr int LEVELS = 8;
// nodes of the tile tree: level l starts at node NODES - (NODES >> l)
constexpr int NODES = 2 * THREADS;
constexpr int EMIT_THREADS = 256;
enum { KIND_F12 = 0, KIND_DCB = 1, KIND_LIM = 2 };

// float32(2^31 - 1) = 2^31
constexpr float F_LIM = 2147483648.0f;

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
    float* agg;              // [K * nch, T, W]: each tile's map
    float* carry;            // [K * nch, T, 2 or 1]: each tile's entry
    int32_t* obuf;           // [S, K, no, 64]: the outputs
    int S, K, N, T, kind, stereo, nch, no, add;
    int sch0, sch1, dch0, dch1;
};

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

__device__ __forceinline__ void apply(const Aff& m, float& d1, float& d2) {
    float n1 = fadd(fadd(fmul(m.a00, d1), fmul(m.a01, d2)), m.b0);
    float n2 = fadd(fadd(fmul(m.a10, d1), fmul(m.a11, d2)), m.b1);
    d1 = n1;
    d2 = n2;
}

// One filter sample's terms (the JAX function's per-sample tensors).
struct FSample {
    float F, Q, cF, hbias, xc, g0, g1, g2;
    bool act;
};

__device__ __forceinline__ FSample filt_sample(const Item& it,
                                               const int32_t* row, int n,
                                               int c) {
    FSample s;
    int off = row[4];
    s.act = n >= off && n < off + row[5];
    int32_t x = it.slots[((size_t)row[c] * 2 + (c ? it.sch1 : it.sch0))
                         * FRAG + n];
    s.xc = fmul(__int2float_rn(x), 1.0f / 32.0f);
    int ns = n - off;
    if (it.kind == KIND_F12) {
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
                                          float d1, float d2) {
    float l = fsub(fadd(d2, fmul(s.F, d1)), s.cF);
    float h = fsub(fsub(fadd(s.xc, fsub(s.hbias, s.cF)), l),
                   fmul(s.Q, d1));
    if (kind == KIND_F12) {
        float b = fsub(fadd(d1, fmul(s.F, h)), s.cF);
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

__device__ __forceinline__ float apply(const MP& m, float p) {
    return fmaxf(fsub(p, m.d), m.m);
}

struct LSample {
    float x0, x1;
    MP m;
    bool act;
};

__device__ __forceinline__ LSample lim_sample(const Item& it,
                                              const int32_t* row, int n) {
    LSample s;
    int off = row[4];
    s.act = n >= off && n < off + row[5];
    s.x0 = __int2float_rn(it.slots[((size_t)row[0] * 2 + it.sch0) * FRAG
                                   + n]);
    float pka;
    if (it.stereo) {
        s.x1 = __int2float_rn(it.slots[((size_t)row[1] * 2 + it.sch1)
                                       * FRAG + n]);
        float lp = fabsf(s.x0), rp = fabsf(s.x1);
        float mx = fmaxf(lp, rp);
        pka = fadd(mx, floorf(fmul(fsub(mx, fabsf(fsub(lp, rp))), 0.5f)));
    } else {
        s.x1 = s.x0;
        pka = fabsf(s.x0);
    }
    if (s.act)
        s.m = {__int2float_rn(row[6]),
               fmaxf(pka, __uint2float_rn((uint32_t)row[7]))};
    else
        s.m = {0.0f, -1e30f};
    return s;
}

// ---- the tile tree, in shared memory ----

template <int W>
struct Tree {
    float node[W][NODES];
};

__device__ __forceinline__ void store(Tree<6>& t, int i, const Aff& m) {
    t.node[0][i] = m.a00;
    t.node[1][i] = m.a01;
    t.node[2][i] = m.a10;
    t.node[3][i] = m.a11;
    t.node[4][i] = m.b0;
    t.node[5][i] = m.b1;
}
__device__ __forceinline__ Aff load(const Tree<6>& t, int i, Aff) {
    return {t.node[0][i], t.node[1][i], t.node[2][i], t.node[3][i],
            t.node[4][i], t.node[5][i]};
}
__device__ __forceinline__ void store(Tree<2>& t, int i, const MP& m) {
    t.node[0][i] = m.d;
    t.node[1][i] = m.m;
}
__device__ __forceinline__ MP load(const Tree<2>& t, int i, MP) {
    return {t.node[0][i], t.node[1][i]};
}

// leaves (level 0, one chunk map per thread) stored; builds levels 1-8
template <int W, typename M>
__device__ void upsweep(Tree<W>& t) {
    for (int l = 0; l < LEVELS; l++) {
        __syncthreads();
        int i = threadIdx.x;
        if (i < (THREADS >> (l + 1))) {
            int b = level_base(l);
            store(t, level_base(l + 1) + i,
                  comb(load(t, b + 2 * i, M()), load(t, b + 2 * i + 1, M())));
        }
    }
    __syncthreads();
}

// The chunk of this thread: (the slice row, its first lane), or null
// for padding.
__device__ __forceinline__ const int32_t* chunk_row(const Item& it, int k,
                                                    int* n0) {
    int t0 = blockIdx.x * TILE + threadIdx.x * CHUNK;
    if (t0 >= it.N)
        return nullptr;
    *n0 = t0 % FRAG;
    return it.arr + ((size_t)(t0 / FRAG) * it.K + k) * NCOL;
}

__device__ __forceinline__ Aff filt_chunk(const Item& it, const int32_t* row,
                                          int n0, int c) {
    if (!row)
        return identity();
    Aff acc = filt_map(filt_sample(it, row, n0, c));
    for (int j = 1; j < CHUNK; j++)
        acc = comb(acc, filt_map(filt_sample(it, row, n0 + j, c)));
    return acc;
}

__device__ __forceinline__ MP lim_chunk(const Item& it, const int32_t* row,
                                        int n0) {
    if (!row)
        return {0.0f, -1e30f};
    MP acc = lim_sample(it, row, n0).m;
    for (int j = 1; j < CHUNK; j++)
        acc = comb(acc, lim_sample(it, row, n0 + j).m);
    return acc;
}

// ---- launch 1: each tile's map ----

__global__ void __launch_bounds__(THREADS) filt_agg(Item it) {
    __shared__ Tree<6> t;
    int chain = blockIdx.y, k = chain / it.nch, c = chain % it.nch;
    int n0 = 0;
    const int32_t* row = chunk_row(it, k, &n0);
    store(t, threadIdx.x, filt_chunk(it, row, n0, c));
    upsweep<6, Aff>(t);
    if (threadIdx.x < 6)
        it.agg[((size_t)chain * it.T + blockIdx.x) * 6 + threadIdx.x] =
            t.node[threadIdx.x][NODES - 2];
}

__global__ void __launch_bounds__(THREADS) lim_agg(Item it) {
    __shared__ Tree<2> t;
    int k = blockIdx.y;
    int n0 = 0;
    const int32_t* row = chunk_row(it, k, &n0);
    store(t, threadIdx.x, lim_chunk(it, row, n0));
    upsweep<2, MP>(t);
    if (threadIdx.x < 2)
        it.agg[((size_t)k * it.T + blockIdx.x) * 2 + threadIdx.x] =
            t.node[threadIdx.x][NODES - 2];
}

// ---- launch 2: the tiles in order, per instance-channel ----

__global__ void tile_scan(Item it) {
    int chain = blockIdx.x * blockDim.x + threadIdx.x;
    if (chain >= it.K * it.nch)
        return;
    if (it.kind == KIND_LIM) {
        int64_t* st = (int64_t*)it.state + chain;
        float p = __ll2float_rn(*st);
        for (int tt = 0; tt < it.T; tt++) {
            size_t i = (size_t)chain * it.T + tt;
            it.carry[i] = p;
            p = apply(MP{it.agg[2 * i], it.agg[2 * i + 1]}, p);
        }
        *st = __float2ll_rz(fmaxf(p, 1.0f));
        return;
    }
    int k = chain / it.nch, c = chain % it.nch;
    int32_t* st = (int32_t*)it.state + k * 4;        // [2 (d1, d2), 2 (c)]
    float d1 = __int2float_rn(st[c]), d2 = __int2float_rn(st[2 + c]);
    for (int tt = 0; tt < it.T; tt++) {
        size_t i = (size_t)chain * it.T + tt;
        it.carry[2 * i] = d1;
        it.carry[2 * i + 1] = d2;
        const float* a = it.agg + 6 * i;
        apply(Aff{a[0], a[1], a[2], a[3], a[4], a[5]}, d1, d2);
    }
    st[c] = sat_i32(rintf(d1));
    st[2 + c] = sat_i32(rintf(d2));
    if (it.nch == 1)
        st[1] = st[3] = 0;
}

// ---- launch 3: the outputs ----

// output channel oc of the sample (row, lane n), for the emit
__device__ __forceinline__ void put(const Item& it, const int32_t* row,
                                    int n, int oc, int32_t v) {
    size_t j = (size_t)(row - it.arr) / NCOL;        // s * K + k
    it.obuf[(j * it.no + oc) * FRAG + n] = v;
}

__global__ void __launch_bounds__(THREADS) filt_walk(Item it) {
    __shared__ Tree<6> t;
    __shared__ float sd[2][NODES];
    int chain = blockIdx.y, k = chain / it.nch, c = chain % it.nch;
    int n0 = 0;
    const int32_t* row = chunk_row(it, k, &n0);
    store(t, threadIdx.x, filt_chunk(it, row, n0, c));
    upsweep<6, Aff>(t);
    if (threadIdx.x == 0) {
        size_t i = (size_t)chain * it.T + blockIdx.x;
        sd[0][NODES - 2] = it.carry[2 * i];
        sd[1][NODES - 2] = it.carry[2 * i + 1];
    }
    for (int l = LEVELS; l > 0; l--) {
        __syncthreads();
        int i = threadIdx.x;
        if (i < (THREADS >> l)) {
            int p = level_base(l) + i, ch = level_base(l - 1) + 2 * i;
            float d1 = sd[0][p], d2 = sd[1][p];
            sd[0][ch] = d1;
            sd[1][ch] = d2;
            apply(load(t, ch, Aff()), d1, d2);
            sd[0][ch + 1] = d1;
            sd[1][ch + 1] = d2;
        }
    }
    __syncthreads();
    if (!row)
        return;
    // stereo-in/mono-out: the later channel wins the shared output
    if (it.nch == 2 && it.no == 1 && c == 0)
        return;
    int oc = it.nch == 2 && it.no == 2 ? c : 0;
    float d1 = sd[0][threadIdx.x], d2 = sd[1][threadIdx.x];
    for (int j = 0; j < CHUNK; j++) {
        int n = n0 + j;
        FSample s = filt_sample(it, row, n, c);
        put(it, row, n, oc, sat_i32(filt_out(s, it.kind, d1, d2)));
        if (it.nch == 1 && it.no == 2)
            put(it, row, n, 1, 0);
        apply(filt_map(s), d1, d2);
    }
}

__global__ void __launch_bounds__(THREADS) lim_walk(Item it) {
    __shared__ Tree<2> t;
    __shared__ float sp[NODES];
    int k = blockIdx.y;
    int n0 = 0;
    const int32_t* row = chunk_row(it, k, &n0);
    store(t, threadIdx.x, lim_chunk(it, row, n0));
    upsweep<2, MP>(t);
    if (threadIdx.x == 0)
        sp[NODES - 2] = it.carry[(size_t)k * it.T + blockIdx.x];
    for (int l = LEVELS; l > 0; l--) {
        __syncthreads();
        int i = threadIdx.x;
        if (i < (THREADS >> l)) {
            int p = level_base(l) + i, ch = level_base(l - 1) + 2 * i;
            sp[ch] = sp[p];
            sp[ch + 1] = apply(load(t, ch, MP()), sp[p]);
        }
    }
    __syncthreads();
    if (!row)
        return;
    float p = sp[threadIdx.x];
    for (int j = 0; j < CHUNK; j++) {
        int n = n0 + j;
        LSample s = lim_sample(it, row, n);
        p = apply(s.m, p);
        float gain = __fdiv_rn(
            2147418112.0f,                               // 32767 << 16
            fmaxf(floorf(fmul(fadd(p, 511.0f), 1.0f / 512.0f)), 1.0f));
        int32_t o0 = sat_i32(fmul(fmul(s.x0, gain), 1.0f / 65536.0f));
        int32_t o1 = it.stereo
            ? sat_i32(fmul(fmul(s.x1, gain), 1.0f / 65536.0f)) : 0;
        if (it.no == 2) {
            put(it, row, n, 0, o0);
            put(it, row, n, 1, o1);
        } else {
            // stereo-in/mono-out: the later channel wins
            put(it, row, n, 0, it.stereo ? o1 : o0);
        }
    }
}

// ---- launch 4: the emit, over the whole card ----

__global__ void __launch_bounds__(EMIT_THREADS) emit(Item it) {
    const int dcol[2] = {2, 3}, dch[2] = {it.dch0, it.dch1};
    stage::emit_tile<NCOL>(it.slots, it.arr, it.S, it.K, it.obuf, it.no,
                           it.no, dcol, dch, 4, it.add);
}

}  // namespace

// One float-tier item: scratch holds the tile maps then the tile entry
// states (filter_float.scratch_floats floats), obuf [S, K, no, 64]
// int32.  Returns the CUDA error of the launches (0 for none).
extern "C" int a2_filter_float(int32_t* slots, const int32_t* arr,
                               void* state, float* scratch, int32_t* obuf,
                               int S, int K, int kind, int ni, int no,
                               int add, int sch0, int sch1, int dch0,
                               int dch1, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    Item it;
    it.slots = slots;
    it.arr = arr;
    it.state = state;
    it.obuf = obuf;
    it.S = S;
    it.K = K;
    it.N = S * FRAG;
    it.T = (it.N + TILE - 1) / TILE;
    it.kind = kind;
    it.stereo = ni == 2;
    it.nch = kind == KIND_LIM ? 1 : (ni == 2 ? 2 : 1);
    it.no = no;
    it.add = add;
    it.sch0 = sch0;
    it.sch1 = sch1;
    it.dch0 = dch0;
    it.dch1 = dch1;
    int W = kind == KIND_LIM ? 2 : 6;
    size_t chains = (size_t)K * it.nch;
    it.agg = scratch;
    it.carry = scratch + chains * it.T * W;
    dim3 grid(it.T, (unsigned)chains);
    if (kind == KIND_LIM)
        lim_agg<<<grid, THREADS, 0, st>>>(it);
    else
        filt_agg<<<grid, THREADS, 0, st>>>(it);
    tile_scan<<<(unsigned)((chains + 127) / 128), 128, 0, st>>>(it);
    if (kind == KIND_LIM)
        lim_walk<<<grid, THREADS, 0, st>>>(it);
    else
        filt_walk<<<grid, THREADS, 0, st>>>(it);
    const int e = (int)cudaGetLastError();
    if (e)
        return e;
    return stage::launch_grid(emit, it, EMIT_THREADS, st);
}

