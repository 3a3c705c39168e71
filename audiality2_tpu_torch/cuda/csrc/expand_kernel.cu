// The run -> row expansion of a superblock, for Hopper (sm_90a).
//
// Replaces the device glue of the JAX package's _expand_rows
// (audiality2_tpu/tpu/superblock.py) up to its oscillator calls, which
// XLA fused into the superblock program: the packed decoders
// _rmq_unpack / _rqr_unpack, the run -> row gather, the per-fragment
// ramp replay _ramp_scan, the kernel parameter packing, and the
// table-less class-0 rows (_noise_audio, the dc ramp, _panmix_rows) with
// their add into the slots.  Bit-exact with the plain version
// expand_plain (../expand.py), whose arithmetic it repeats in int64 with
// the same int32 wrap points, floor modulo, truncating division and
// torch's shift rule.
//
// What bounds it on an H100: bytes.  Per row it writes 64 B of
// parameters and 8 B of slot index; it reads each run's 44 B (packed)
// or 72 B (plain) once from device memory (the rows of one run hit L1 /
// L2), each class-0 row adds C*64 int32 into its slot.  About 10 MB for
// the slice song's 148,480 rows: 3 us at 3.35 TB/s.  The operations
// (the ramp replay's requantisations, the noise rows' LCG jumps) come to
// a few hundred million int32 operations at most.
//
// Design, three launches:
//  1. order_kernel, a block per 512 runs: counts the alive runs (LEN >
//     0) and checks whether they come first and sorted by their clamped
//     START (what program_from_native and the mixer's padding make): the
//     condition holds iff every adjacent pair does, so each block checks
//     the pairs ending in its runs and writes (alive runs, in order) to
//     its own entry of a scratch array, which needs no clearing.
//  2. expand_kernel, one block of 128 threads per 128 rows, so that a
//     block holds one class block: each row's run is the count of alive
//     runs whose clamped START is at most the row, minus 1 (the plain
//     version's index_add / cumsum).  The block sums launch 1's entries,
//     then finds the runs below its first row and its own start marks by
//     two block-wide searches (128 probes a round) when the runs are
//     sorted, else by scanning every run; then a block scan of the marks.
//     Each thread decodes its row's run straight from the packed words
//     (or the plain runmat), computes the row's fields, replays its ramp
//     run's fragments 1 .. min(k, 15) itself (at most 15 steps, redundant
//     across the rows of a run and needing no grid barrier; the pitch
//     table in shared memory; the divisions in 32 bits or as a double
//     quotient corrected exactly, not through the 64-bit division's
//     subroutine), and writes its parameters and slot index, or, for a
//     class-0 row, the 128-byte record that launch 3 reads.
//  3. class0_kernel, a thread per class-0 sample (four rows a block):
//     the noise draw count, the LCG jump (its table in constant memory)
//     or the dc ramp, the panmix, and a 32-bit atomic add into the slot
//     (integer addition with wrap is order-free, so the sum is exact
//     whatever the order).
// The table pointers and sizes are kernel parameters, so a CUDA graph
// captures the launches whole.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RPB = 128;            // rows of a class block; threads
constexpr int FRAG = 64;
constexpr int NPARAM = 16;
constexpr int KCHUNK = 16;          // RUN_KCHUNK: fragments 1 .. 15 replayed
constexpr int MAXTAB = 8;
constexpr int MAXCLS = 8;
constexpr int ORDER_THREADS = 512;  // runs of an order block
constexpr int AUDIO_ROWS = 4;        // class-0 rows of an audio block
constexpr int64_t M32 = 0xFFFFFFFFll;

// runmat columns (RC_START .. RC_RIDX), rampmat columns (RR_MIP .. RR_BASE)
enum { C_START, C_LEN, C_DPH, C_SIZE, C_POSOFF, C_AMP0, C_DAMP, C_VOL0,
       C_DVOL, C_PAN0, C_DPAN, C_SLOT, C_MODE, C_OFF, C_TOTAL, C_PHHI,
       C_PHLO, C_RIDX, RM_N };
enum { R_MIP, R_AT, R_ATMR, R_VT, R_VTMR, R_PT, R_PTMR, R_PV, R_PTGT,
       R_PTIMER, R_PRAMP, R_DPHRAW, R_PERIOD, R_BASE, RR_N };
// row mode bits
constexpr int ROW_HASPM = 1, ROW_STEREO = 2, ROW_CLAMP = 4, ROW_NOISE = 8,
              ROW_DC = 16;

struct Tabs {
    const int32_t* p[MAXTAB];
    int n[MAXTAB];
};

// the noise LCG's doubling jumps (s -> s * 1566083941 + 1 mod 2^32, as
// expand._NZ_TAB): after 2^j steps, s -> a[j] * s + c[j]
struct NzTab {
    uint32_t a[11], c[11];
};

constexpr NzTab nz_tab() {
    NzTab t{};
    uint32_t a = 1566083941u, c = 1u;
    for (int j = 0; j < 11; ++j) {
        t.a[j] = a;
        t.c[j] = c;
        c = a * c + c;
        a = a * a;
    }
    return t;
}

__constant__ NzTab NZ = nz_tab();

// a run or ramp table: plain [n, cols] int32, or packed (words, n) int32
// with its value tables
struct Table {
    const int32_t* m;
    int n;
    int packed;
    Tabs t;
};

struct Classes {
    int n;
    int cls[MAXCLS];
    int64_t row0[MAXCLS];           // first row of the class block
    int64_t rows[MAXCLS];           // NB * RPB
    int64_t z0[MAXCLS];             // a class-0 block's first class-0 row
};

// ---- torch's int64 semantics ----

__device__ __forceinline__ int64_t w32(int64_t x) {
    return (int64_t)(int32_t)(uint32_t)(uint64_t)x;
}
__device__ __forceinline__ int64_t addw(int64_t a, int64_t b) {
    return (int64_t)((uint64_t)a + (uint64_t)b);
}
__device__ __forceinline__ int64_t subw(int64_t a, int64_t b) {
    return (int64_t)((uint64_t)a - (uint64_t)b);
}
__device__ __forceinline__ int64_t mulw(int64_t a, int64_t b) {
    return (int64_t)((uint64_t)a * (uint64_t)b);
}
__device__ __forceinline__ int64_t shl(int64_t a, int s) {
    return (int64_t)((uint64_t)a << s);
}
// a tensor shift: a shift below 0 or from 63 up shifts by 63
__device__ __forceinline__ int64_t shr_t(int64_t a, int64_t s) {
    return (s < 0 || s >= 63) ? (a >> 63) : (a >> s);
}
// torch.remainder for m > 0: the floor modulo.  Below 2^52 a double
// quotient, off by at most one, corrected exactly in int64 (cheaper than
// the 64-bit integer division's subroutine)
__device__ __forceinline__ int64_t fmod_pos(int64_t a, int64_t m) {
    constexpr int64_t LIM = 1ll << 52;
    if (a > -LIM && a < LIM && m < LIM) {
        int64_t r = a - (int64_t)floor((double)a / (double)m) * m;
        if (r < 0) r += m;
        else if (r >= m) r -= m;
        return r;
    }
    const int64_t r = a % m;
    return r < 0 ? r + m : r;
}

// C's truncating a / b for |a| < 2^52 and 0 < b < 2^52, the same way
__device__ __forceinline__ int64_t tdiv_pos(int64_t a, int64_t b) {
    const int64_t ua = a < 0 ? -a : a;
    int64_t q = (int64_t)((double)ua / (double)b);
    const int64_t r = ua - q * b;
    if (r < 0) --q;
    else if (r >= b) ++q;
    return a < 0 ? -q : q;
}
__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo,
                                           int64_t hi) {
    return x < lo ? lo : x > hi ? hi : x;
}

// ---- the packed format (../packed.py): an index past its table reads
// the table's last entry ----

__device__ __forceinline__ int64_t take(const Tabs& t, int j, uint32_t i) {
    const uint32_t last = (uint32_t)(t.n[j] - 1);
    return __ldg(t.p[j] + (i < last ? i : last));
}

struct Run {
    int64_t start, len, dph, size, posoff, amp0, damp, vol0, dvol, pan0,
        dpan, slot, mode, off, total, phhi, phlo, ridx;
};

__device__ __forceinline__ uint32_t word(const Table& T, int k, int j) {
    return (uint32_t)__ldg(T.m + (int64_t)k * T.n + j);
}

__device__ __forceinline__ int64_t col(const Table& T, int j, int c,
                                       int ncol) {
    return __ldg(T.m + (int64_t)j * ncol + c);
}

__device__ Run load_run(const Table& T, int j) {
    Run r;
    if (T.packed) {
        const uint32_t w4 = word(T, 4, j), w5 = word(T, 5, j),
                       w6 = word(T, 6, j), w7 = word(T, 7, j),
                       w8 = word(T, 8, j), w9 = word(T, 9, j),
                       w10 = word(T, 10, j);
        r.amp0 = (int32_t)word(T, 0, j);
        r.dph = (int32_t)word(T, 1, j);
        r.phlo = (int32_t)word(T, 2, j);
        r.size = (int32_t)word(T, 3, j);
        r.start = w4 & 0x3FFFFFu;
        r.off = (w4 >> 22) & 63u;
        r.mode = (w4 >> 28) & 15u;
        r.ridx = (int64_t)(w5 & 0x3FFFFFu) - 1;
        r.phhi = (int64_t)((w5 >> 22) & 63u) - 1;
        r.slot = w6 & 0x3FFFFFu;
        r.len = (w6 >> 22) & 255u;
        // table order: DAMP, DPAN, PAN0, TOTAL, POSOFF, DVOL, VOL0
        r.damp = take(T.t, 0, w7 & 0xFFFFu);
        r.dpan = take(T.t, 1, w7 >> 16);
        r.pan0 = take(T.t, 2, w8 & 0xFFFFu);
        r.total = take(T.t, 3, w8 >> 16);
        r.posoff = take(T.t, 4, w9 & 0xFFFFu);
        r.dvol = take(T.t, 5, w9 >> 16);
        r.vol0 = take(T.t, 6, w10 & 0xFFFFu);
    } else {
        r.start = col(T, j, C_START, RM_N);
        r.len = col(T, j, C_LEN, RM_N);
        r.dph = col(T, j, C_DPH, RM_N);
        r.size = col(T, j, C_SIZE, RM_N);
        r.posoff = col(T, j, C_POSOFF, RM_N);
        r.amp0 = col(T, j, C_AMP0, RM_N);
        r.damp = col(T, j, C_DAMP, RM_N);
        r.vol0 = col(T, j, C_VOL0, RM_N);
        r.dvol = col(T, j, C_DVOL, RM_N);
        r.pan0 = col(T, j, C_PAN0, RM_N);
        r.dpan = col(T, j, C_DPAN, RM_N);
        r.slot = col(T, j, C_SLOT, RM_N);
        r.mode = col(T, j, C_MODE, RM_N);
        r.off = col(T, j, C_OFF, RM_N);
        r.total = col(T, j, C_TOTAL, RM_N);
        r.phhi = col(T, j, C_PHHI, RM_N);
        r.phlo = col(T, j, C_PHLO, RM_N);
        r.ridx = col(T, j, C_RIDX, RM_N);
    }
    return r;
}

// (clamped START, alive) of run j: what the row -> run mapping reads
__device__ __forceinline__ int64_t run_mark(const Table& T, int j,
                                            int64_t rtot, bool* alive) {
    int64_t start, len;
    if (T.packed) {
        start = word(T, 4, j) & 0x3FFFFFu;
        len = (word(T, 6, j) >> 22) & 255u;
    } else {
        start = col(T, j, C_START, RM_N);
        len = col(T, j, C_LEN, RM_N);
    }
    *alive = len > 0;
    return clamp64(start, 0, rtot);
}

struct Ramp {
    int64_t mip, at, atmr, vt, vtmr, pt, ptmr, pv, ptgt, ptimer, pramp,
        dphraw, period, base;
};

__device__ Ramp load_ramp(const Table& T, int j) {
    Ramp q;
    if (T.packed) {
        const uint32_t w0 = word(T, 0, j), w4 = word(T, 4, j),
                       w5 = word(T, 5, j), w6 = word(T, 6, j),
                       w7 = word(T, 7, j);
        q.base = w0 & 0x3FFFFFu;
        q.mip = (w0 >> 22) & 15u;
        q.atmr = (int32_t)word(T, 1, j);
        q.pv = (int32_t)word(T, 2, j);
        q.ptgt = q.pv;                 // PTGT == PV (the format's invariant)
        q.dphraw = (int32_t)word(T, 3, j);
        // table order: AT, PT, PTMR, VT, VTMR, PTIMER, PRAMP, PERIOD
        q.at = take(T.t, 0, w4 & 0xFFFFu);
        q.pt = take(T.t, 1, w4 >> 16);
        q.ptmr = take(T.t, 2, w5 & 0xFFFFu);
        q.vt = take(T.t, 3, w5 >> 16);
        q.vtmr = take(T.t, 4, w6 & 0xFFFFu);
        q.ptimer = take(T.t, 5, w6 >> 16);
        q.pramp = take(T.t, 6, w7 & 0xFFFFu);
        q.period = take(T.t, 7, w7 >> 16);
    } else {
        q.mip = col(T, j, R_MIP, RR_N);
        q.at = col(T, j, R_AT, RR_N);
        q.atmr = col(T, j, R_ATMR, RR_N);
        q.vt = col(T, j, R_VT, RR_N);
        q.vtmr = col(T, j, R_VTMR, RR_N);
        q.pt = col(T, j, R_PT, RR_N);
        q.ptmr = col(T, j, R_PTMR, RR_N);
        q.pv = col(T, j, R_PV, RR_N);
        q.ptgt = col(T, j, R_PTGT, RR_N);
        q.ptimer = col(T, j, R_PTIMER, RR_N);
        q.pramp = col(T, j, R_PRAMP, RR_N);
        q.dphraw = col(T, j, R_DPHRAW, RR_N);
        q.period = col(T, j, R_PERIOD, RR_N);
        q.base = col(T, j, R_BASE, RR_N);
    }
    return q;
}

// ---- the ramp replay (expand._ramp_scan, one run) ----

// a2_PrepareRamper(fr) (expand._prepare_vec): v, t updated in place,
// returns the delta
__device__ __forceinline__ int64_t prepare(int64_t& v, int64_t tg,
                                           int64_t& t, int64_t fr) {
    if (t == 0) {
        v = tg;
        return 0;
    }
    // diff fits int32; t here is below 2^31 and at least 256
    const int64_t diff = w32(tg - v);
    if ((t >> 8) >= fr) {
        const int64_t d = w32(tdiv_pos(diff * 256, t));
        t -= fr << 8;
        return d;
    }
    t = 0;
    return (int32_t)diff / (int32_t)fr;
}

// a2_P2I (expand._p2i_vec), p nonnegative
__device__ __forceinline__ int64_t p2i(int64_t p, const int64_t* pbase,
                                       const int64_t* pcoeff) {
    const int64_t n = p & 0xFFFF;
    const int64_t oct = p >> 16;
    const int idx = (int)(n >> 10);
    int64_t dph = mulw(pcoeff[idx], n & 1023) & M32;
    dph >>= 2;
    dph = addw(dph, pbase[idx]) & M32;
    return dph >> ((7 - oct) & 31);
}

// fragment `steps` (1 .. 15) of ramp run q over its base run g: the ten
// int32 outputs of expand._ramp_scan (amp, damp, vol, dvol, pan, dpan,
// dph, ph_hi, ph_lo, draws), each wrapped to int32
__device__ void replay(const Run& g, const Ramp& q, int steps,
                       const int64_t* pbase, const int64_t* pcoeff,
                       int64_t out[10]) {
    int64_t av = w32(g.amp0 + FRAG * g.damp), at = q.atmr;
    int64_t vv = w32(g.vol0 + FRAG * g.dvol), vt = q.vtmr;
    int64_t pv = w32(g.pan0 + FRAG * g.dpan), ptm = q.ptmr;
    int64_t pcv = q.pv, pct = q.ptimer, pramp = q.pramp;
    int64_t dphraw = q.dphraw & M32;
    const int64_t period = q.period & M32;
    const int64_t msz = (g.mode & ROW_NOISE) ? 0 : shl(g.size, 24);
    const int64_t dph0 = g.dph & M32;
    const int64_t ph0 = shl(g.phhi, 32) | (g.phlo & M32);
    int64_t ph = addw(ph0, FRAG * dph0);
    const int64_t span = g.off + g.total;
    const int64_t end0 = clamp64(span, 0, FRAG);
    int64_t dcnt = dph0 >= (1 << 23)
        ? end0 - g.off
        : subw(addw(ph0, mulw(end0, dph0)) >> 23,
               addw(ph0, mulw(g.off, dph0)) >> 23);
    for (int k = 1;; ++k) {
        const int64_t fr = clamp64(span - ((int64_t)k << 6), 1, FRAG);
        int64_t av2 = av, vv2 = vv, pv2 = pv, pcv2 = pcv;
        const int64_t ad = prepare(av2, q.at, at, fr);
        const int64_t vd = prepare(vv2, q.vt, vt, fr);
        const int64_t pd = prepare(pv2, q.pt, ptm, fr);
        // wtosc_run_pitch
        const int64_t pcd = prepare(pcv2, q.ptgt, pct, fr);
        const bool skip = dphraw != 0 && pct == 0 && pramp == 0;
        const int64_t lastv = pcv2 & M32;
        pcv = skip ? pcv2 : w32(pcv2 + pcd * fr);
        if (!skip) {
            dphraw = p2i(((lastv + (pcv & M32)) & M32) >> 9, pbase, pcoeff);
            pramp = pcd;
        }
        const int64_t dph = shr_t(mulw(dphraw, period), q.mip);
        const int64_t phm = msz > 0 ? fmod_pos(ph, msz) : ph;
        if (k == steps) {
            out[0] = w32(av2);
            out[1] = w32(ad);
            out[2] = w32(vv2);
            out[3] = w32(vd);
            out[4] = w32(pv2);
            out[5] = w32(pd);
            out[6] = w32(dph);
            out[7] = w32(phm >> 32);
            out[8] = w32(phm & M32);
            out[9] = w32(dcnt);
            return;
        }
        const int64_t nxt = addw(phm, mulw(fr, dph));
        const int64_t dk = dph >= (1 << 23)
            ? fr : subw(nxt >> 23, phm >> 23);
        av = w32(av2 + ad * fr);
        vv = w32(vv2 + vd * fr);
        pv = w32(pv2 + pd * fr);
        ph = nxt;
        dcnt = addw(dcnt, dk);
    }
}

// ---- launch 1: the order of the runs ----

// "alive runs first, sorted by clamped START" holds iff no adjacent pair
// (j - 1, j) has a dead run before an alive one or two alive runs out of
// order.  Each block checks the pairs ending in its ORDER_THREADS runs,
// one a thread, and writes its (alive runs, pairs in order) to its own
// entry of `order`; the row blocks sum the entries.
__global__ void __launch_bounds__(ORDER_THREADS)
order_kernel(Table runs, int64_t rtot, int32_t* __restrict__ order) {
    const int j = blockIdx.x * ORDER_THREADS + threadIdx.x;
    bool a = false, ok = true;
    if (j < runs.n) {
        bool b = true;
        const int64_t s = run_mark(runs, j, rtot, &a);
        const int64_t sp = j > 0 ? run_mark(runs, j - 1, rtot, &b) : s;
        ok = !(a && (!b || sp > s));
    }
    const int n = __syncthreads_count(a);
    ok = __syncthreads_and(ok);
    if (threadIdx.x == 0) {
        order[2 * blockIdx.x] = n;
        order[2 * blockIdx.x + 1] = ok;
    }
}

// ---- launch 2: the rows ----

// inclusive scan of one int per thread over the block
__device__ __forceinline__ int block_scan(int v, int* warp_sums) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xFFFFFFFFu, v, o);
        if (lane >= o) v += u;
    }
    if (lane == 31) warp_sums[wid] = v;
    __syncthreads();
    for (int w = 0; w < wid; ++w) v += warp_sums[w];
    return v;
}

// the first j in [lo, hi) whose clamped START is >= x (runs sorted),
// searched by the whole block: each round probes 128 evenly spaced runs
// and keeps the gap where the answer lies (three rounds for 10^4 runs).
// Every thread calls it; lo and hi are the block's shared bounds.
__device__ int lower_bound(const Table& T, int64_t rtot, int64_t x,
                           int* lo, int* hi) {
    while (true) {
        const int l = *lo, h = *hi;
        if (l >= h) return l;
        const int step = (h - l + RPB - 1) / RPB;
        const int j = l + threadIdx.x * step;
        bool a;
        const bool below = j < h && run_mark(T, j, rtot, &a) < x;
        const int c = __syncthreads_count(below);
        if (threadIdx.x == 0) {
            // probes 0 .. c-1 lie below x, probe c (if any) does not
            if (c > 0) *lo = l + (c - 1) * step + 1;
            if (l + c * step < h) *hi = l + c * step;
        }
        __syncthreads();
    }
}

// a class-0 row as launch 3 reads it
struct Row0 {
    int64_t phr, dphu, base23, c_lo, c_hi, amp, damp, vol0, dvol, pan0,
        dpan, last0, slot;
    uint32_t s0;
    int offl, end, mode;
    int live;
};
static_assert(sizeof(Row0) == 128, "Row0 is 128 bytes (ROW0_BYTES)");

__global__ void __launch_bounds__(RPB)
expand_kernel(Table runs, Table ramps, const int32_t* __restrict__ order,
              int norder, Classes cl, const int64_t* __restrict__ pbase,
              const int64_t* __restrict__ pcoeff, int64_t dead_slot,
              int32_t* __restrict__ params, int64_t* __restrict__ slot_r,
              Row0* __restrict__ row0, int64_t nslot, int64_t rtot) {
    __shared__ int marks[RPB];
    __shared__ int warp_sums[RPB / 32];
    __shared__ int below_s, na_s;
    __shared__ int64_t ptab[2][64];

    const int tid = threadIdx.x;
    ptab[tid >> 6][tid & 63] = __ldg((tid < 64 ? pbase : pcoeff) + (tid & 63));
    const int64_t p0 = (int64_t)blockIdx.x * RPB;
    const int64_t p = p0 + tid;
    int ci = 0;
    while (ci + 1 < cl.n && p0 >= cl.row0[ci] + cl.rows[ci]) ++ci;
    const int cls = cl.cls[ci];

    // ---- row -> run: rid = #{alive runs with clamped START <= p} - 1
    marks[tid] = 0;
    if (tid == 0) below_s = na_s = 0;
    __syncthreads();
    int mine = 0, sorted = 1;
    for (int b = tid; b < norder; b += RPB) {
        mine += order[2 * b];
        sorted &= order[2 * b + 1];
    }
    atomicAdd(&na_s, mine);
    sorted = __syncthreads_and(sorted);
    const int na = na_s;
    if (sorted) {
        // alive runs first and sorted: two searches
        __shared__ int lo, hi;
        if (tid == 0) {
            lo = 0;
            hi = na;
        }
        __syncthreads();
        const int first = lower_bound(runs, rtot, p0, &lo, &hi);
        __syncthreads();
        if (tid == 0) {
            below_s = first;
            hi = na;
        }
        __syncthreads();
        const int last = lower_bound(runs, rtot, p0 + RPB, &lo, &hi);
        for (int j = first + tid; j < last; j += RPB) {
            bool a;
            const int64_t s = run_mark(runs, j, rtot, &a);
            atomicAdd(&marks[s - p0], 1);
        }
    } else {
        int below = 0;
        for (int j = tid; j < runs.n; j += RPB) {
            bool a;
            const int64_t s = run_mark(runs, j, rtot, &a);
            if (!a) continue;
            if (s < p0) ++below;
            else if (s < p0 + RPB) atomicAdd(&marks[s - p0], 1);
        }
        atomicAdd(&below_s, below);
    }
    __syncthreads();
    const int64_t rid = (int64_t)below_s
        + block_scan(marks[tid], warp_sums) - 1;

    // ---- the row's fields (expand.row_params)
    const Run g = load_run(runs, (int)(rid < 0 ? 0 : rid));
    const int64_t k = p - g.start;
    const bool alive = rid >= 0 && k < g.len;
    const int64_t kn = w32(shl(k, 6));
    int64_t ph = addw(shl(g.phhi, 32) | (g.phlo & M32),
                      mulw(k, shl(g.dph, 6)));
    const int64_t sz = (g.mode & ROW_NOISE) ? 0 : g.size;
    int64_t pos32 = w32(ph >> 24);
    int64_t f32 = ph & 0xFFFFFF;
    if (sz > 0 && k > 0) {
        // both fit int32: the floor modulo in 32 bits
        const int32_t r = (int32_t)pos32 % (int32_t)sz;
        pos32 = r < 0 ? r + sz : r;
    }
    int64_t amp = w32(g.amp0 + w32(kn * g.damp));
    int64_t damp = g.damp;
    int64_t dph32 = g.dph;
    int64_t vol0 = w32(g.vol0 + w32(kn * g.dvol));
    int64_t pan0 = w32(g.pan0 + w32(kn * g.dpan));
    int64_t dvol = g.dvol, dpan = g.dpan;
    bool use = false;
    int64_t cnt0 = 0;
    if (ramps.m != nullptr && g.ridx >= 0 && k >= 1 && alive) {
        use = true;
        // the trajectory gather's flat index: fragment min(k, 15) of
        // ramp run RIDX (RIDX < NrR in every program_from_native table)
        const int64_t nrr = ramps.n;
        int64_t frag = (k - 1 < KCHUNK - 2 ? k - 1 : KCHUNK - 2);
        int64_t q = g.ridx;
        if (q >= nrr) {
            const int64_t f = frag * nrr + q;
            frag = f / nrr;
            q = f % nrr;
            if (frag > KCHUNK - 2) frag = KCHUNK - 2;
        }
        const Ramp rq = load_ramp(ramps, (int)q);
        // the ramp's base run, most often the row's own
        const int jb = (int)clamp64(rq.base, 0, (int64_t)runs.n - 1);
        const Run gb = jb == (rid < 0 ? 0 : rid) ? g : load_run(runs, jb);
        int64_t tg[10];
        replay(gb, rq, (int)frag + 1, ptab[0], ptab[1], tg);
        amp = tg[0];
        damp = tg[1];
        vol0 = tg[2];
        dvol = tg[3];
        pan0 = tg[4];
        dpan = tg[5];
        dph32 = tg[6];
        pos32 = w32(shl(tg[7], 8)) | ((tg[8] & M32) >> 24);
        f32 = tg[8] & 0xFFFFFF;
        cnt0 = tg[9];
        ph = shl(tg[7], 32) | (tg[8] & M32);
    }
    const int64_t az = alive ? 1 : 0;
    const int64_t pos = w32(pos32 + g.posoff) * az;
    amp *= az;
    damp *= az;
    const int64_t off = k == 0 ? g.off : 0;
    const int64_t end = alive
        ? clamp64(w32(g.off + g.total - kn), 0, FRAG) : 0;
    const int64_t slot = alive ? g.slot + k : dead_slot;
    slot_r[p] = slot;

    if (cls != 0) {
        const int64_t P = cl.rows[ci];
        int32_t* par = params + NPARAM * cl.row0[ci] + (p - cl.row0[ci]);
        const int64_t fields[NPARAM] = {
            pos, f32 * az, (dph32 >> 24) * az, (dph32 & 0xFFFFFF) * az,
            amp, damp, vol0, dvol, pan0, dpan, off, end, g.mode, 0, 0, 0};
#pragma unroll
        for (int f = 0; f < NPARAM; ++f)
            par[f * P] = (int32_t)(uint32_t)(uint64_t)fields[f];
        return;
    }

    // ---- class 0 (expand._class0_audio): the row for launch 3
    Row0 r;
    const int64_t dphu = dph32 & M32;
    const int64_t runoff = g.off;
    r.phr = ph;
    r.dphu = dphu;
    r.base23 = use ? ph >> 23
        : subw(ph, mulw(subw(k * FRAG, runoff), dphu)) >> 23;
    r.c_lo = use ? cnt0 : 0;
    r.c_hi = use ? cnt0 : addw(subw(mulw(k, FRAG), runoff), off);
    r.amp = amp;
    r.damp = damp;
    r.vol0 = vol0;
    r.dvol = dvol;
    r.pan0 = pan0;
    r.dpan = dpan;
    r.last0 = g.posoff;
    r.s0 = (uint32_t)(uint64_t)g.size;
    r.offl = (int)off;
    r.end = (int)end;
    r.mode = (int)g.mode;
    r.slot = slot;
    // a row with an empty [OFF, END) window adds nothing
    r.live = end > off && slot >= 0 && slot < nslot;
    row0[cl.z0[ci] + (p - cl.row0[ci])] = r;
}

// ---- launch 3: the class-0 rows' samples, one a thread ----

__global__ void __launch_bounds__(AUDIO_ROWS * FRAG)
class0_kernel(const Row0* __restrict__ row0, int64_t nrows, int mono,
              int32_t* __restrict__ slots) {
    const int64_t i = (int64_t)blockIdx.x * AUDIO_ROWS + (threadIdx.x >> 6);
    const int n = threadIdx.x & 63;
    if (i >= nrows) return;
    const Row0& r = row0[i];
    if (!r.live || n < r.offl || n >= r.end) return;
    int64_t osc;
    const int64_t ampn = w32(r.amp + n * r.damp);
    if (r.mode & ROW_DC) {
        osc = ampn;
    } else {
        // the pitched S&H LCG: draws consumed by sample n, then an LCG
        // jump of that many steps from the run's state
        int64_t cons = r.dphu >= (1 << 23)
            ? addw(n + 1 - r.offl, r.c_hi)
            : addw(subw(addw(r.phr, mulw(n + 1, r.dphu)) >> 23, r.base23),
                   r.c_lo);
        cons = clamp64(cons, 0, (1 << 11) - 1);
        uint32_t s = r.s0;
#pragma unroll
        for (int j = 0; j < 11; ++j)
            if ((cons >> j) & 1) s = s * NZ.a[j] + NZ.c[j];
        const int64_t val = (int64_t)((s * (s >> 16)) >> 16) - 32767;
        const int64_t last = cons == 0 ? r.last0 : val;
        osc = w32(last * (ampn >> 10)) >> 6;
    }
    const int64_t vol = w32(r.vol0 + n * r.dvol);
    const int64_t mono_pm = (osc * vol) >> 24;
    const bool haspm = r.mode & ROW_HASPM;
    int32_t* dst = slots + r.slot * 2 * FRAG + n;
    if (mono) {
        atomicAdd((unsigned int*)dst, (unsigned int)(haspm ? mono_pm : osc));
        return;
    }
    const int64_t pan = w32(r.pan0 + n * r.dpan);
    const int64_t vp = (pan * vol) >> 24;
    int64_t v0 = vol - vp, v1 = vol + vp;
    if (r.mode & ROW_CLAMP) {
        const int64_t lim = vol << 1;
        v0 = v0 < lim ? v0 : lim;
        v1 = v1 < lim ? v1 : lim;
    }
    const bool stereo = r.mode & ROW_STEREO;
    const int64_t ch0 = haspm ? (stereo ? mulw(osc, v0) >> 24 : mono_pm)
                              : osc;
    atomicAdd((unsigned int*)dst, (unsigned int)ch0);
    if (haspm && stereo) {
        const int64_t ch1 = mulw(osc, v1) >> 24;
        atomicAdd((unsigned int*)(dst + FRAG), (unsigned int)ch1);
    }
}

}  // namespace

// The expansion of one superblock.  runs: plain int32 [nr, 18] (packed
// 0) or packed int32 (11, nr) with 7 tables (packed 1); ramps: none
// (ramps null), plain int32 [nrr, 14] or packed (8, nrr) with 8 tables.
// Table pointers and lengths (each >= 1) are HOST arrays, copied into
// the launch's parameters.  ptab_base / ptab_coeff: int64 [64] on the
// card.  Classes: ncls class blocks (class, rows), rows a multiple of
// 128, in row order; params int32 receives 16 x rows per pass class at
// 16 * its first row; slot_r int64 [rtot]; slots int32 [nslot, 2, 64]
// receives the class-0 rows (channel 0 only when mono).  Scratch: order
// int32 [2 * ceil(nr / 512)], row0 128 bytes per class-0 row.  Returns
// the cudaError_t of the launches.
extern "C" int a2_expand(
    const int32_t* runs, int nr, int runs_packed, const void* const* rtabs,
    const int* rsizes, const int32_t* ramps, int nrr, int ramps_packed,
    const void* const* qtabs, const int* qsizes, const int64_t* ptab_base,
    const int64_t* ptab_coeff, int ncls, const int* cls, const int* rows,
    int mono, long long dead_slot, int32_t* params, int64_t* slot_r,
    int32_t* slots, long long nslot, int32_t* order, void* row0,
    void* stream) {
    if (runs == nullptr || nr <= 0 || ncls <= 0 || ncls > MAXCLS
        || (ramps != nullptr && nrr <= 0))
        return (int)cudaErrorInvalidValue;
    auto tables = [](Table& T, const void* const* p, const int* n, int cnt) {
        for (int j = 0; j < MAXTAB; ++j) {
            T.t.p[j] = j < cnt ? (const int32_t*)p[j] : nullptr;
            T.t.n[j] = j < cnt ? n[j] : 1;
            if (j < cnt && (T.t.p[j] == nullptr || T.t.n[j] < 1))
                return false;
        }
        return true;
    };
    Table R{runs, nr, runs_packed, {}};
    Table Q{ramps, ramps != nullptr ? nrr : 0, ramps_packed, {}};
    if (!tables(R, rtabs, rsizes, runs_packed ? 7 : 0)
        || !tables(Q, qtabs, qsizes, ramps != nullptr && ramps_packed ? 8 : 0))
        return (int)cudaErrorInvalidValue;
    Classes cl{};
    cl.n = ncls;
    int64_t rtot = 0, nz = 0;
    for (int i = 0; i < ncls; ++i) {
        if (rows[i] <= 0 || rows[i] % RPB) return (int)cudaErrorInvalidValue;
        cl.cls[i] = cls[i];
        cl.row0[i] = rtot;
        cl.rows[i] = rows[i];
        cl.z0[i] = nz;
        rtot += rows[i];
        if (cls[i] == 0) nz += rows[i];
    }
    if (nz && row0 == nullptr) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int norder = (nr + ORDER_THREADS - 1) / ORDER_THREADS;
    order_kernel<<<norder, ORDER_THREADS, 0, s>>>(R, rtot, order);
    int err = (int)cudaGetLastError();
    if (err) return err;
    expand_kernel<<<(unsigned)(rtot / RPB), RPB, 0, s>>>(
        R, Q, order, norder, cl, ptab_base, ptab_coeff, dead_slot, params,
        slot_r, (Row0*)row0, nslot, rtot);
    err = (int)cudaGetLastError();
    if (err || !nz) return err;
    class0_kernel<<<(unsigned)(nz / AUDIO_ROWS), AUDIO_ROWS * FRAG, 0, s>>>(
        (const Row0*)row0, nz, mono, slots);
    return (int)cudaGetLastError();
}
