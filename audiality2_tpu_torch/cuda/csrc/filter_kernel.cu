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
// superblock), and only the K instances of an item (1 for the master
// limiter, about 60 for the leads of the effects song) run side by
// side, against 132 SMs of 2048 threads.
//
// Design: one block per item (one launch), one thread per instance
// (threads loop over instances where K exceeds the block).  Per slice
// step, phase A reads every input of the step and runs each instance's
// 64-sample recurrence in registers, writing its outputs to scratch
// that the wrapper allocates; phases B (old destination values ->
// deltas) and C (atomic adds) are stage::emit_step (stage_common.cuh).
// __syncthreads() separates the phases, so every input and old value of
// a step is read before any add, exactly as the JAX scan does, and two
// instances that share a destination slot still sum exactly.  Only the
// samples inside a slice's [off, off+frames) window run (the others
// leave state and slots untouched).  Wrapping arithmetic runs in
// uint32, right shifts on int32; the limiter's gain
// (32767<<16) / max(((peak+511)&M32)>>9, 1) is one exact unsigned
// 32-bit division (the TPU path's f32 estimate has no counterpart).

#include <cstdint>
#include <cuda_runtime.h>

#include "stage_common.cuh"

namespace {

using namespace stage;

constexpr int THREADS = 256;
constexpr int NCOL = 13;
constexpr int64_t M32 = 0xFFFFFFFFLL;
enum { KIND_F12 = 0, KIND_DCB = 1, KIND_LIM = 2 };

__device__ __forceinline__ int64_t abs64(int64_t v) {
    return v < 0 ? -v : v;
}

struct Params {
    int32_t* slots;          // [nslot, 2, 64]
    const int32_t* arr;      // [S, K, 13]
    void* state;             // f12/dcb int32 [K, 2, 2]; lim int64 [K]
    int32_t* scratch;        // [K, 2, 64]
    int S, K, ni, no, add, sch0, sch1, dch0, dch1;
};

// one instance's recurrence over one slice: outputs to out[c*64 + n].
// The slice's parameters and 64 (or 128) input samples are loaded into
// registers and local memory before the serial loop, so their loads are
// issued together instead of costing a memory latency per sample.
template <int KIND>
__device__ void run_slice(const Params& p, const int32_t* __restrict__ row,
                          int k, int lo, int hi,
                          int32_t* __restrict__ out) {
    const bool stereo = p.ni == 2;
    int32_t prm[NCOL];
#pragma unroll
    for (int i = 0; i < NCOL; ++i) prm[i] = row[i];
    const int32_t* x0p = p.slots + ((size_t)prm[0] * 2 + p.sch0) * FRAG;
    const int32_t* x1p = p.slots + ((size_t)prm[1] * 2 + p.sch1) * FRAG;
    int32_t xin[2][FRAG];
#pragma unroll
    for (int n = 0; n < FRAG; ++n) xin[0][n] = x0p[n];
    if (stereo) {
#pragma unroll
        for (int n = 0; n < FRAG; ++n) xin[1][n] = x1p[n];
    }
    const int32_t* x0 = xin[0];
    const int32_t* x1 = stereo ? xin[1] : xin[0];
    if (KIND == KIND_LIM) {
        int64_t* pkp = (int64_t*)p.state + k;
        int64_t pk = *pkp;
        const int64_t rel = prm[6];
        const int64_t thr = (uint32_t)prm[7];
        for (int n = lo; n < hi; ++n) {
            const int64_t a0 = x0[n], a1 = x1[n];
            int64_t pka;
            if (stereo) {
                const int64_t lp = abs64(a0), rp = abs64(a1);
                pka = lp > rp ? lp : rp;
                pka = (pka + ((pka - abs64(lp - rp)) >> 1)) & M32;
            } else {
                pka = abs64(a0) & M32;
            }
            int64_t dec = (pk - rel) & M32;
            if (dec < thr) dec = thr;
            const int64_t pk2 = pka > pk ? pka : dec;
            uint32_t den = (uint32_t)(((pk2 + 511) & M32) >> 9);
            if (den < 1) den = 1;
            const int64_t gain = (uint32_t)(32767u << 16) / den;
            const int32_t o0 = low32((a0 * gain) >> 16);
            const int32_t o1 = stereo ? low32((a1 * gain) >> 16) : 0;
            pk = pk2;
            if (p.no == 2) {
                out[n] = o0;
                out[FRAG + n] = o1;        // mono-in: channel 2 silent
            } else {
                out[n] = stereo ? o1 : o0;  // the later channel wins
            }
        }
        *pkp = pk;
        return;
    }
    int32_t* st = (int32_t*)p.state + (size_t)k * 4;
    int32_t d1[2] = {st[0], st[1]};
    int32_t d2[2] = {st[2], st[3]};
    const int nch = stereo ? 2 : 1;
    const int off = prm[4];
    for (int n = lo; n < hi; ++n) {
        int32_t fl = 0, qq = 0, fc0 = 0;
        if (KIND == KIND_F12) {
            const int32_t ns = n - off;
            fl = wadd(prm[6], wmul(ns, prm[7])) >> 12;
            qq = wadd(prm[8], wmul(ns, prm[9])) >> 12;
        } else {
            fc0 = prm[6] >> 12;
        }
        for (int c = 0; c < nch; ++c) {
            const int32_t x = (c ? x1 : x0)[n];
            int32_t l, h, b, fo;
            if (KIND == KIND_F12) {
                const int32_t d1c = d1[c] >> 4;
                l = wadd(d2[c], wmul(fl, d1c) >> 8);
                h = wsub(wsub(x >> 5, l), wmul(qq, d1c) >> 8);
                b = wadd(wmul(fl, h >> 4) >> 8, d1[c]);
                fo = wadd(wadd(wmul(l, prm[10]), wmul(b, prm[11])),
                          wmul(h, prm[12])) >> 3;
            } else {
                const int32_t t1 = d1[c] >> 4;
                l = wadd(d2[c], wmul(fc0, t1) >> 8);
                h = wsub(wsub(x >> 5, l), wshl(t1, 4));
                b = wadd(wmul(fc0, h >> 4) >> 8, d1[c]);
                fo = wshl(h, 5);
            }
            // stereo-in/mono-out: the later channel wins the output
            out[(c < p.no - 1 ? c : p.no - 1) * FRAG + n] = fo;
            d1[c] = b;
            d2[c] = l;
        }
        if (nch == 1 && p.no == 2) out[FRAG + n] = 0;
    }
    st[0] = d1[0];
    st[1] = d1[1];
    st[2] = d2[0];
    st[3] = d2[1];
}

template <int KIND>
__global__ void __launch_bounds__(THREADS) filter_kernel(Params p) {
    for (int s = 0; s < p.S; ++s) {
        const int32_t* rows = p.arr + (size_t)s * p.K * NCOL;
        // phase A: inputs and recurrences
        for (int k = threadIdx.x; k < p.K; k += THREADS) {
            const int32_t* row = rows + (size_t)k * NCOL;
            const int lo = max(row[4], 0);
            const int hi = min(row[4] + row[5], FRAG);
            if (lo < hi)
                run_slice<KIND>(p, row, k, lo, hi,
                                p.scratch + (size_t)k * 2 * FRAG);
        }
        __syncthreads();
        const int dcol[2] = {2, 3}, dch[2] = {p.dch0, p.dch1};
        emit_step<NCOL, THREADS>(p.slots, rows, p.K, p.scratch, 2, p.no,
                                 dcol, dch, 4, p.add);
    }
}

}  // namespace

// kind: 0 filter12, 1 dcblock, 2 limiter
extern "C" int a2_filter(int32_t* slots, const int32_t* arr, void* state,
                         int32_t* scratch, int S, int K, int kind, int ni,
                         int no, int add, int sch0, int sch1, int dch0,
                         int dch1, cudaStream_t stream) {
    Params p{slots, arr, state, scratch, S, K, ni, no, add,
             sch0, sch1, dch0, dch1};
    if (kind == KIND_F12)
        filter_kernel<KIND_F12><<<1, THREADS, 0, stream>>>(p);
    else if (kind == KIND_DCB)
        filter_kernel<KIND_DCB><<<1, THREADS, 0, stream>>>(p);
    else if (kind == KIND_LIM)
        filter_kernel<KIND_LIM><<<1, THREADS, 0, stream>>>(p);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
