// filter12 / dcblock / limiter stage items for Hopper (sm_90a).
//
// Replaces the JAX package's instance-batched scan
// audiality2_tpu/tpu/superblock.py _apply_filter (reference
// filter12.c f12_process, dcblock.c, limiter.c:84-131): per instance, a
// per-sample recurrence over the instance's S slices of up to 64
// samples (filter d1/d2 per channel, limiter peak), each slice's output
// added into the slots (REPLACE as add-of-difference).  Bit-exact with
// the plain version filter_torch in ../filter.py.
//
// What bounds it on an H100: per sample and channel about 25 int32
// operations (filter12; fewer for dcblock, the limiter adds one 32-bit
// division) and 12 bytes (read the input, read the old value, add the
// output), so by the card's peaks the bytes bound it, at microseconds
// per superblock.  What holds it back is the dependency chain: each
// instance is one chain of S*64 samples (some 17,600 per 2752-fragment
// superblock for a voice's filter, 179,000 for the master limiter), of
// some 9 dependent operations per sample (filter12), and only the K
// instances of an item can run side by side.
//
// Design: one cooperative launch per item, one block per SM, with
// grid-wide barriers between phases (stage_common.cuh).  The host cuts
// the item's slice steps into step groups (../stage_groups.py: no step
// reads a sample that an earlier step of its group writes), and the
// kernel runs a group, in tiles of at most tmax steps, as one step:
//  * filter12 / dcblock: one thread per instance, one instance per
//    block first, runs its chain over all steps of the tile with d1/d2
//    in registers.  The 4 samples of a quad and the 16 quads of a
//    slice are unrolled (no array indexed by a runtime sample index),
//    with a predicate only where a slice does not cover the whole
//    fragment; inputs arrive through a ring of RING 16-byte quads
//    loaded RING quads ahead (the next slice's first quads, with its
//    params loaded a slice ahead, during the current slice's last), so
//    the chain does not wait on memory, and outputs leave as 16-byte
//    quads to wrapper-allocated scratch [tmax, K, 2, 64] (L2-resident).
//  * limiter: only the peak pk' = pka > pk ? pka : max(pk - rel, thr)
//    is serial.  The grid computes pka for every sample of the tile;
//    block 0 runs the peak chain (uint32 sub, max, compare, select) and
//    stores pk' per sample, an instance's slices cut into chunks that
//    run in parallel from a guessed start and are then repaired from
//    the true state (peak_chains: speculate and repair, exact for any
//    data, one step per chunk where the two runs meet at once); then
//    the grid computes the gains (one exact unsigned 32-bit division
//    each) and the output products, sample-parallel.
//  * then stage::emit_tile (stage_common.cuh) turns the tile's outputs
//    into deltas and adds them, sample-parallel over the grid and
//    coalesced, with one grid barrier after each pass instead of three
//    block barriers per slice step.
// Only samples inside a slice's [off, off+frames) window change state
// or slots.  Wrapping arithmetic runs in uint32, right shifts on int32.

#include <cstdint>
#include <cuda_runtime.h>

#include "stage_common.cuh"

namespace {

using namespace stage;

constexpr int THREADS = 256;
constexpr int NCOL = 13;
// quads of a filter chain's inputs in flight (filter_chain)
constexpr int RING = 8;
// samples per thread whose loads a sample-parallel pass issues together
constexpr int U = 4;
// chunks of one instance's peak chain (peak_chains): more chunks make
// the parallel runs shorter and the serial repair longer
constexpr int MAXCHUNKS = 32;
enum { KIND_F12 = 0, KIND_DCB = 1, KIND_LIM = 2 };

struct Params {
    int32_t* slots;          // [nslot, 2, 64]
    const int32_t* arr;      // [S, K, 13]
    void* state;             // f12/dcb int32 [K, 2, 2]; lim int64 [K]
    int32_t* scratch;        // [tmax, K, 2, 64]
    // [G, b0 .. bG]: the group count G, then the G + 1 step bounds
    // of the groups (read on the card, so a captured launch takes
    // each superblock's groups from memory)
    const int32_t* bounds;
    int tmax, K, no, add, sch0, sch1, dch0, dch1;
};

__device__ __forceinline__ const int32_t* src_row(const Params& p,
                                                  int32_t slot, int ch) {
    return p.slots + ((size_t)slot * 2 + ch) * FRAG;
}

// component e (0..3, a constant after unrolling) of a quad
__device__ __forceinline__ int32_t lane(const int4& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// filter12 / dcblock: instance k's chain over the T steps of a tile.
// Its inputs and outputs move as 16-byte quads (the thread's own rows:
// one sector per access instead of one per sample), and its inputs
// through a ring of RING quads per channel: each quad is loaded RING
// quads (4 * RING samples of the chain) before its use, the next
// slice's first quads during the current slice's last.
template <int KIND, bool STEREO>
__device__ void filter_chain(const Params& p, const int32_t* rows, int T,
                             int k) {
    constexpr int NCH = STEREO ? 2 : 1;
    constexpr int NQ = FRAG / 4;
    int32_t* st = (int32_t*)p.state + (size_t)k * 4;
    int32_t d1[2] = {st[0], st[1]};
    int32_t d2[2] = {st[2], st[3]};
    int32_t prm[NCOL];
    const int32_t* row = rows + (size_t)k * NCOL;
#pragma unroll
    for (int i = 0; i < NCOL; ++i) prm[i] = row[i];
    const int4* cur[2] = {(const int4*)src_row(p, prm[0], p.sch0),
                          (const int4*)src_row(p, prm[1], p.sch1)};
    int4 x[NCH][RING];
#pragma unroll
    for (int r = 0; r < RING; ++r) {
#pragma unroll
        for (int c = 0; c < NCH; ++c) x[c][r] = cur[c][r];
    }
    for (int t = 0; t < T; ++t) {
        int4* out = (int4*)(p.scratch + (size_t)(t * p.K + k) * 2 * FRAG);
        const bool more = t + 1 < T;
        int32_t nxt[NCOL];
        if (more) {
            const int32_t* r2 = rows + ((size_t)(t + 1) * p.K + k) * NCOL;
#pragma unroll
            for (int i = 0; i < NCOL; ++i) nxt[i] = r2[i];
        }
        const int off = prm[4];
        const int lo = max(off, 0);
        const int hi = min(off + prm[5], FRAG);
        const bool whole = lo == 0 && hi == FRAG;
        const int4* nx[2] = {cur[0], cur[1]};
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
            if (q == NQ - RING && more) {
                nx[0] = (const int4*)src_row(p, nxt[0], p.sch0);
                nx[1] = (const int4*)src_row(p, nxt[1], p.sch1);
            }
            int4 xq[NCH];
#pragma unroll
            for (int c = 0; c < NCH; ++c) {
                xq[c] = x[c][q % RING];
                // the freed ring slot takes the quad RING ahead
                if (q + RING < NQ)
                    x[c][q % RING] = cur[c][q + RING];
                else if (more)
                    x[c][q % RING] = nx[c][q + RING - NQ];
            }
            int32_t o0[4], o1[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int n = 4 * q + e;
                const bool act = whole || (n >= lo && n < hi);
                int32_t fl = 0, qq = 0, fc0 = 0;
                if (KIND == KIND_F12) {
                    const int32_t ns = n - off;
                    fl = wadd(prm[6], wmul(ns, prm[7])) >> 12;
                    qq = wadd(prm[8], wmul(ns, prm[9])) >> 12;
                } else {
                    fc0 = prm[6] >> 12;
                }
                int32_t fo[2];
#pragma unroll
                for (int c = 0; c < NCH; ++c) {
                    const int32_t xv = lane(xq[c], e);
                    int32_t l, h, b;
                    if (KIND == KIND_F12) {
                        const int32_t d1c = d1[c] >> 4;
                        l = wadd(d2[c], wmul(fl, d1c) >> 8);
                        h = wsub(wsub(xv >> 5, l), wmul(qq, d1c) >> 8);
                        b = wadd(wmul(fl, h >> 4) >> 8, d1[c]);
                        fo[c] = wadd(wadd(wmul(l, prm[10]),
                                          wmul(b, prm[11])),
                                     wmul(h, prm[12])) >> 3;
                    } else {
                        const int32_t t1 = d1[c] >> 4;
                        l = wadd(d2[c], wmul(fc0, t1) >> 8);
                        h = wsub(wsub(xv >> 5, l), wshl(t1, 4));
                        b = wadd(wmul(fc0, h >> 4) >> 8, d1[c]);
                        fo[c] = wshl(h, 5);
                    }
                    if (act) {
                        d1[c] = b;
                        d2[c] = l;
                    }
                }
                // stereo-in/mono-out: the later channel wins the output;
                // mono-in/stereo-out: channel 2 silent
                o0[e] = STEREO && p.no == 1 ? fo[NCH - 1] : fo[0];
                o1[e] = STEREO ? fo[NCH - 1] : 0;
            }
            out[q] = make_int4(o0[0], o0[1], o0[2], o0[3]);
            if (p.no == 2)
                out[NQ + q] = make_int4(o1[0], o1[1], o1[2], o1[3]);
        }
        if (more) {
            cur[0] = nx[0];
            cur[1] = nx[1];
#pragma unroll
            for (int i = 0; i < NCOL; ++i) prm[i] = nxt[i];
        }
    }
    st[0] = d1[0];
    st[1] = d1[1];
    st[2] = d2[0];
    st[3] = d2[1];
}

// the i-th quad (4 consecutive samples) of a limiter tile: its pair's
// row and its first sample
struct Quad {
    const int32_t* row;
    size_t j;
    int n;
};

__device__ __forceinline__ Quad quad(const int32_t* rows, int i) {
    const int j = i / (FRAG / 4);
    return {rows + (size_t)j * NCOL, (size_t)j, i % (FRAG / 4) * 4};
}

__device__ __forceinline__ int4 src_quad(const Params& p, int32_t slot,
                                         int ch, int n) {
    return *(const int4*)(src_row(p, slot, ch) + n);
}

__device__ __forceinline__ uint32_t pka_of(int64_t a0, int64_t a1,
                                           bool stereo) {
    const int64_t lp = a0 < 0 ? -a0 : a0;
    if (!stereo) return (uint32_t)lp;
    const int64_t rp = a1 < 0 ? -a1 : a1;
    const int64_t m = lp > rp ? lp : rp;
    const int64_t dd = lp - rp;
    return (uint32_t)(m + ((m - (dd < 0 ? -dd : dd)) >> 1));
}

__device__ __forceinline__ int32_t gain_of(uint32_t pk2) {
    uint32_t den = (pk2 + 511u) >> 9;
    if (den < 1) den = 1;
    return (int32_t)((uint32_t)(32767u << 16) / den);
}

// The peak's step, uint32 wrap: pk' = pka > pk ? pka : max(pk - rel, thr)
__device__ __forceinline__ uint32_t peak(uint32_t pk, uint32_t a,
                                         uint32_t rel, uint32_t thr) {
    uint32_t dec = pk - rel;
    dec = dec < thr ? thr : dec;
    return a > pk ? a : dec;
}

// instance k's peak chain over slices [t0, t1) of a tile from state pk:
// reads pka from the channel-0 half of each scratch pair, stores pk'
// (the state after each sample inside the slice's window) into the
// channel-1 half, both as 16-byte quads; returns the end state.  The
// 64-sample loop is unrolled, and while a slice runs its pka registers
// are refilled with the next slice's.
__device__ uint32_t peak_run(const Params& p, const int32_t* rows, int k,
                             int t0, int t1, uint32_t pk) {
    constexpr int NQ = FRAG / 4;
    const size_t pair = (size_t)p.K * 2 * NQ;     // scratch quads per step
    const int4* sc = (const int4*)p.scratch + (size_t)k * 2 * NQ;
    int4 a[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) a[q] = sc[t0 * pair + q];
    const int32_t* row = rows + ((size_t)t0 * p.K + k) * NCOL;
    int32_t off = row[4], frm = row[5];
    uint32_t rel = (uint32_t)row[6], thr = (uint32_t)row[7];
    for (int t = t0; t < t1; ++t) {
        int4* pp = (int4*)sc + t * pair + NQ;
        const int4* np = sc + (t + 1) * pair;
        const bool more = t + 1 < t1;
        int32_t noff = 0, nfrm = 0;
        uint32_t nrel = 0, nthr = 0;
        if (more) {
            const int32_t* r2 = row + (size_t)(t + 1 - t0) * p.K * NCOL;
            noff = r2[4];
            nfrm = r2[5];
            nrel = (uint32_t)r2[6];
            nthr = (uint32_t)r2[7];
        }
        const int lo = max(off, 0), hi = min(off + frm, FRAG);
        const bool whole = lo == 0 && hi == FRAG;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
            uint32_t v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int n = 4 * q + e;
                v[e] = peak(pk, (uint32_t)lane(a[q], e), rel, thr);
                if (whole || (n >= lo && n < hi)) pk = v[e];
            }
            pp[q] = make_int4(v[0], v[1], v[2], v[3]);
            if (more) a[q] = np[q];
        }
        off = noff;
        frm = nfrm;
        rel = nrel;
        thr = nthr;
    }
    return pk;
}

// peak_run of chunk [t0, t1) again from the true state pk, over values
// that a run from a guessed state stored: stops at the first sample
// inside a window where the true state equals the stored one (from
// there on the stored run is the true one, and its end state spec_end
// is returned); the stored values before it are corrected.
__device__ uint32_t peak_repair(const Params& p, const int32_t* rows, int k,
                                int t0, int t1, uint32_t pk,
                                uint32_t spec_end) {
    constexpr int NQ = FRAG / 4;
    const size_t pair = (size_t)p.K * 2 * NQ;
    for (int t = t0; t < t1; ++t) {
        const int4* ap = (const int4*)p.scratch + (size_t)k * 2 * NQ
            + t * pair;
        int4* pp = (int4*)ap + NQ;
        const int32_t* row = rows + ((size_t)t * p.K + k) * NCOL;
        const int lo = max(row[4], 0), hi = min(row[4] + row[5], FRAG);
        const uint32_t rel = (uint32_t)row[6], thr = (uint32_t)row[7];
        int4 a[NQ], sp[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
            a[q] = ap[q];
            sp[q] = pp[q];
        }
        bool met = false;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
            int32_t v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int n = 4 * q + e;
                v[e] = lane(sp[q], e);
                if (met || n < lo || n >= hi) continue;
                pk = peak(pk, (uint32_t)lane(a[q], e), rel, thr);
                met = pk == (uint32_t)v[e];
                v[e] = (int32_t)pk;
            }
            pp[q] = make_int4(v[0], v[1], v[2], v[3]);
        }
        if (met) return spec_end;
    }
    return pk;
}

// every instance's peak chain over a tile, by the threads of one block.
// An instance's slices are cut into P chunks (P threads per instance, at
// most MAXCHUNKS; P = 1 for K > THREADS / 2)
// that run in parallel, chunk 0 from the true state and the others
// from a guess, the floor thr (speculate); then one thread per
// instance walks the chunks from the true state and repairs each:
// where the true state meets the guessed run at a chunk's first sample
// (the common case: the map forgets its start once a peak overtakes it
// or the floor holds it), the chunk costs one step; else peak_repair
// runs it until the two meet.  Exact for any data.
__device__ void peak_chains(const Params& p, const int32_t* rows, int T) {
    __shared__ uint32_t h_end[THREADS], h_first[THREADS], h_pka[THREADS],
        h_rel[THREADS], h_thr[THREADS];
    __shared__ bool h_live[THREADS];
    const int P = p.K * 2 > THREADS ? 1 : min(THREADS / p.K, MAXCHUNKS);
    const int CH = (T + P - 1) / P;
    for (int w = threadIdx.x; w < p.K * P; w += THREADS) {
        const int k = w / P, c = w % P;
        const int t0 = min(c * CH, T), t1 = min(t0 + CH, T);
        int64_t* pkp = (int64_t*)p.state + k;
        uint32_t pk = c == 0 ? (uint32_t)*pkp
            : t0 < T ? (uint32_t)rows[((size_t)t0 * p.K + k) * NCOL + 7] : 0;
        if (t0 < t1) pk = peak_run(p, rows, k, t0, t1, pk);
        if (P == 1) {
            *pkp = pk;
            continue;
        }
        // the chunk's first sample inside a window, for the repair
        h_end[w] = pk;
        h_live[w] = false;
        for (int t = t0; t < t1; ++t) {
            const int32_t* row = rows + ((size_t)t * p.K + k) * NCOL;
            const int lo = max(row[4], 0), hi = min(row[4] + row[5], FRAG);
            if (lo >= hi) continue;
            const uint32_t* sc = (const uint32_t*)p.scratch
                + ((size_t)t * p.K + k) * 2 * FRAG + lo;
            h_pka[w] = sc[0];
            h_first[w] = sc[FRAG];
            h_rel[w] = (uint32_t)row[6];
            h_thr[w] = (uint32_t)row[7];
            h_live[w] = true;
            break;
        }
    }
    __syncthreads();
    if (P == 1) return;
    for (int k = threadIdx.x; k < p.K; k += THREADS) {
        uint32_t pk = h_end[k * P];
        for (int c = 1; c < P; ++c) {
            const int w = k * P + c;
            if (!h_live[w]) continue;         // no sample: pk unchanged
            if (peak(pk, h_pka[w], h_rel[w], h_thr[w]) == h_first[w]) {
                pk = h_end[w];
            } else {
                const int t0 = c * CH;
                pk = peak_repair(p, rows, k, t0, min(t0 + CH, T), pk,
                                 h_end[w]);
            }
        }
        *((int64_t*)p.state + k) = pk;
    }
}

// limiter: the three phases of a tile (called by every thread).  The
// sample-parallel phases take U quads per thread at a time and load
// all of them before they use any.
template <bool STEREO>
__device__ void limiter_tile(const Params& p, const int32_t* rows, int T) {
    const int total = T * p.K * (FRAG / 4);
    // 1. pka for every sample, into the channel-0 half of its scratch
    // pair
    const int G = grid_threads();
    for (int i0 = grid_tid(); i0 < total; i0 += U * G) {
        int4 a0[U], a1[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int i = i0 + u * G;
            if (i >= total) continue;
            const Quad q = quad(rows, i);
            a0[u] = src_quad(p, q.row[0], p.sch0, q.n);
            if (STEREO) a1[u] = src_quad(p, q.row[1], p.sch1, q.n);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int i = i0 + u * G;
            if (i >= total) continue;
            const Quad q = quad(rows, i);
            const int4 b = STEREO ? a1[u] : a0[u];
            *(int4*)(p.scratch + q.j * 2 * FRAG + q.n) = make_int4(
                pka_of(a0[u].x, b.x, STEREO), pka_of(a0[u].y, b.y, STEREO),
                pka_of(a0[u].z, b.z, STEREO), pka_of(a0[u].w, b.w, STEREO));
        }
    }
    grid_sync();
    // 2. the peak chains, pk' into the channel-1 half of each pair (in
    // block 0)
    if (blockIdx.x == 0) peak_chains(p, rows, T);
    grid_sync();
    // 3. gains and outputs for every sample
    for (int i0 = grid_tid(); i0 < total; i0 += U * G) {
        int4 a0[U], a1[U], pk[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int i = i0 + u * G;
            if (i >= total) continue;
            const Quad q = quad(rows, i);
            pk[u] = *(const int4*)(p.scratch + (q.j * 2 + 1) * FRAG + q.n);
            a0[u] = src_quad(p, q.row[0], p.sch0, q.n);
            if (STEREO) a1[u] = src_quad(p, q.row[1], p.sch1, q.n);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int i = i0 + u * G;
            if (i >= total) continue;
            const Quad q = quad(rows, i);
            const int32_t g[4] = {gain_of(pk[u].x), gain_of(pk[u].y),
                                  gain_of(pk[u].z), gain_of(pk[u].w)};
            const int32_t x0[4] = {a0[u].x, a0[u].y, a0[u].z, a0[u].w};
            int32_t o0[4], o1[4] = {0, 0, 0, 0};
#pragma unroll
            for (int e = 0; e < 4; ++e)
                o0[e] = low32(((int64_t)x0[e] * g[e]) >> 16);
            if (STEREO) {
                const int32_t x1[4] = {a1[u].x, a1[u].y, a1[u].z, a1[u].w};
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    o1[e] = low32(((int64_t)x1[e] * g[e]) >> 16);
            }
            int4* o = (int4*)(p.scratch + q.j * 2 * FRAG + q.n);
            if (p.no == 2) {
                o[0] = make_int4(o0[0], o0[1], o0[2], o0[3]);
                // mono-in: channel 2 silent
                o[FRAG / 4] = make_int4(o1[0], o1[1], o1[2], o1[3]);
            } else {
                // stereo-in/mono-out: the later channel wins
                const int32_t* w = STEREO ? o1 : o0;
                o[0] = make_int4(w[0], w[1], w[2], w[3]);
            }
        }
    }
}

template <int KIND, bool STEREO>
__global__ void __launch_bounds__(THREADS, 1) filter_kernel(Params p) {
    const int dcol[2] = {2, 3}, dch[2] = {p.dch0, p.dch1};
    const int G = p.bounds[0];
    const int32_t* b = p.bounds + 1;
    for (int g = 0; g < G; ++g) {
        const int g1 = b[g + 1];
        for (int s0 = b[g]; s0 < g1; s0 += p.tmax) {
            const int T = min(p.tmax, g1 - s0);
            const int32_t* rows = p.arr + (size_t)s0 * p.K * NCOL;
            if (KIND == KIND_LIM) {
                limiter_tile<STEREO>(p, rows, T);
            } else {
                for (int k = spread_tid(); k < p.K; k += grid_threads())
                    filter_chain<KIND, STEREO>(p, rows, T, k);
            }
            grid_sync();
            emit_tile<NCOL>(p.slots, rows, T, p.K, p.scratch, 2, p.no, dcol,
                            dch, 4, p.add);
        }
    }
}

template <int KIND>
int launch(const Params& p, int ni, cudaStream_t stream) {
    if (ni == 2)
        return launch_grid(filter_kernel<KIND, true>, p, THREADS, stream);
    return launch_grid(filter_kernel<KIND, false>, p, THREADS, stream);
}

}  // namespace

// kind: 0 filter12, 1 dcblock, 2 limiter.  bounds: the group count G
// and the G + 1 step bounds of the item's groups, int32 [G + 2], on the
// card; scratch [tmax, K, 2, 64].
extern "C" int a2_filter(int32_t* slots, const int32_t* arr, void* state,
                         int32_t* scratch, const int32_t* bounds, int tmax,
                         int K, int kind, int ni, int no, int add, int sch0,
                         int sch1, int dch0, int dch1, cudaStream_t stream) {
    Params p{slots, arr, state, scratch, bounds, tmax, K, no, add, sch0,
             sch1, dch0, dch1};
    if (kind == KIND_F12) return launch<KIND_F12>(p, ni, stream);
    if (kind == KIND_DCB) return launch<KIND_DCB>(p, ni, stream);
    if (kind == KIND_LIM) return launch<KIND_LIM>(p, ni, stream);
    return (int)cudaErrorInvalidValue;
}
