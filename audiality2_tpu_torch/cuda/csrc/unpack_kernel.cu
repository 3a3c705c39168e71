// Device decoders of the packed dispatch format, for Hopper (sm_90a).
//
// Replaces the JAX package's device-side decoders _rmq_unpack and
// _rqr_unpack (audiality2_tpu/tpu/superblock.py), which XLA compiled
// into the superblock program: a packed runmat (11 int32 words per run)
// or rampmat (8 words per ramp run) and its per-song value tables back
// to the [N, 18] runmat or [N, 14] rampmat that the row expansion
// reads.  The format is documented in ../packed.py; bit-exact with its
// plain versions rmq_unpack_torch / rqr_unpack_torch.
//
// What bounds it on an H100: about 40 int32 operations per run against
// 116 bytes moved (44 read, 72 written; 32 and 56 for a ramp run), so
// the bytes: at 3.35 TB/s a superblock's 10^4-10^5 runs take 1-4 us,
// less than the launch itself.  The tables (a few KB) stay in L1/L2.
//
// Design: one thread per run.  A block of 128 threads reads its runs'
// words (each word a coalesced row of the packed stream), shifts and
// masks the fields in uint32, gathers the table values (an index past
// its table reads the last entry, as the plain version does), and
// writes its 128 output rows into shared memory, which the block then
// stores contiguously (the rows are 72 or 56 bytes wide: a thread per
// row would store at that stride).  The table pointers and sizes are
// kernel parameters, so a CUDA graph captures a launch whole.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RUNS = 128;          // runs (threads) of a block
constexpr int MAXTAB = 8;

struct Tabs {
    const int32_t* p[MAXTAB];
    int n[MAXTAB];
};

__device__ __forceinline__ int32_t take(const Tabs& t, int j, uint32_t i) {
    const uint32_t last = (uint32_t)(t.n[j] - 1);
    return __ldg(t.p[j] + (i < last ? i : last));
}

// runmat columns (RC_START .. RC_RIDX)
enum { C_START, C_LEN, C_DPH, C_SIZE, C_POSOFF, C_AMP0, C_DAMP, C_VOL0,
       C_DVOL, C_PAN0, C_DPAN, C_SLOT, C_MODE, C_OFF, C_TOTAL, C_PHHI,
       C_PHLO, C_RIDX, RM_N };
// rampmat columns (RR_MIP .. RR_BASE)
enum { R_MIP, R_AT, R_ATMR, R_VT, R_VTMR, R_PT, R_PTMR, R_PV, R_PTGT,
       R_PTIMER, R_PRAMP, R_DPHRAW, R_PERIOD, R_BASE, RR_N };

__global__ void __launch_bounds__(RUNS)
rmq_unpack_kernel(const int32_t* __restrict__ pk, int n, Tabs t,
                  int32_t* __restrict__ out) {
    __shared__ int32_t tile[RUNS * RM_N];
    const int r0 = blockIdx.x * RUNS;
    const int i = r0 + threadIdx.x;
    if (i < n) {
        uint32_t w[11];
#pragma unroll
        for (int k = 0; k < 11; ++k) w[k] = (uint32_t)pk[(int64_t)k * n + i];
        int32_t* o = tile + threadIdx.x * RM_N;
        o[C_START] = (int32_t)(w[4] & 0x3FFFFFu);
        o[C_OFF] = (int32_t)((w[4] >> 22) & 63u);
        o[C_MODE] = (int32_t)((w[4] >> 28) & 15u);
        o[C_RIDX] = (int32_t)(w[5] & 0x3FFFFFu) - 1;
        o[C_PHHI] = (int32_t)((w[5] >> 22) & 63u) - 1;
        o[C_SLOT] = (int32_t)(w[6] & 0x3FFFFFu);
        o[C_LEN] = (int32_t)((w[6] >> 22) & 255u);
        o[C_AMP0] = (int32_t)w[0];
        o[C_DPH] = (int32_t)w[1];
        o[C_PHLO] = (int32_t)w[2];
        o[C_SIZE] = (int32_t)w[3];
        // table order: DAMP, DPAN, PAN0, TOTAL, POSOFF, DVOL, VOL0
        o[C_DAMP] = take(t, 0, w[7] & 0xFFFFu);
        o[C_DPAN] = take(t, 1, w[7] >> 16);
        o[C_PAN0] = take(t, 2, w[8] & 0xFFFFu);
        o[C_TOTAL] = take(t, 3, w[8] >> 16);
        o[C_POSOFF] = take(t, 4, w[9] & 0xFFFFu);
        o[C_DVOL] = take(t, 5, w[9] >> 16);
        o[C_VOL0] = take(t, 6, w[10] & 0xFFFFu);
    }
    __syncthreads();
    const int m = min(RUNS, n - r0) * RM_N;
    int32_t* dst = out + (int64_t)r0 * RM_N;
    for (int k = threadIdx.x; k < m; k += RUNS) dst[k] = tile[k];
}

__global__ void __launch_bounds__(RUNS)
rqr_unpack_kernel(const int32_t* __restrict__ pk, int n, Tabs t,
                  int32_t* __restrict__ out) {
    __shared__ int32_t tile[RUNS * RR_N];
    const int r0 = blockIdx.x * RUNS;
    const int i = r0 + threadIdx.x;
    if (i < n) {
        uint32_t w[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) w[k] = (uint32_t)pk[(int64_t)k * n + i];
        int32_t* o = tile + threadIdx.x * RR_N;
        o[R_BASE] = (int32_t)(w[0] & 0x3FFFFFu);
        o[R_MIP] = (int32_t)((w[0] >> 22) & 15u);
        o[R_ATMR] = (int32_t)w[1];
        o[R_PV] = (int32_t)w[2];
        o[R_PTGT] = (int32_t)w[2];       // PTGT == PV (finalize invariant)
        o[R_DPHRAW] = (int32_t)w[3];
        // table order: AT, PT, PTMR, VT, VTMR, PTIMER, PRAMP, PERIOD
        o[R_AT] = take(t, 0, w[4] & 0xFFFFu);
        o[R_PT] = take(t, 1, w[4] >> 16);
        o[R_PTMR] = take(t, 2, w[5] & 0xFFFFu);
        o[R_VT] = take(t, 3, w[5] >> 16);
        o[R_VTMR] = take(t, 4, w[6] & 0xFFFFu);
        o[R_PTIMER] = take(t, 5, w[6] >> 16);
        o[R_PRAMP] = take(t, 6, w[7] & 0xFFFFu);
        o[R_PERIOD] = take(t, 7, w[7] >> 16);
    }
    __syncthreads();
    const int m = min(RUNS, n - r0) * RR_N;
    int32_t* dst = out + (int64_t)r0 * RR_N;
    for (int k = threadIdx.x; k < m; k += RUNS) dst[k] = tile[k];
}

}  // namespace

// kind 0 = rmq (pk int32 (11, n), 7 tables, out int32 [n, 18]), 1 = rqr
// (pk int32 (8, n), 8 tables, out int32 [n, 14]).  tabs / sizes are HOST
// arrays of the tables' device pointers and lengths (each >= 1), copied
// into the launch's parameters.  Returns the cudaError_t of the launch.
extern "C" int a2_unpack(int kind, const int32_t* pk, int n,
                         const void* const* tabs, const int* sizes,
                         int32_t* out, void* stream) {
    const int ntab = kind == 0 ? 7 : kind == 1 ? 8 : 0;
    if (ntab == 0 || n <= 0) return (int)cudaErrorInvalidValue;
    Tabs t;
    for (int j = 0; j < MAXTAB; ++j) {
        t.p[j] = j < ntab ? (const int32_t*)tabs[j] : nullptr;
        t.n[j] = j < ntab ? sizes[j] : 1;
        if (j < ntab && (t.p[j] == nullptr || t.n[j] < 1))
            return (int)cudaErrorInvalidValue;
    }
    const int blocks = (n + RUNS - 1) / RUNS;
    cudaStream_t s = (cudaStream_t)stream;
    if (kind == 0)
        rmq_unpack_kernel<<<blocks, RUNS, 0, s>>>(pk, n, t, out);
    else
        rqr_unpack_kernel<<<blocks, RUNS, 0, s>>>(pk, n, t, out);
    return (int)cudaGetLastError();
}
