// fm operator graphs (fm1 ... fm4r) for Hopper (sm_90a).
//
// Replaces the JAX package's instance-batched scan
// audiality2_tpu/tpu/superblock.py _apply_fm (reference fm.c
// fm_process, native a2rt_units.inc fm_run_t): per instance and
// sample, 1 << osbits oversampled steps of up to 4 sine operators, each
// op's phase / amplitude / feedback amount closed-form from its slice
// snapshot, and each op's last output fed back into its own phase
// through (last * fb) >> 17: the serial recurrence, carried across
// slices and superblocks as per-op state [K, 4].  Structures: nops
// operators in series (parallel 0), ops 1..nops-1 summed into op 0
// (parallel 1), or ring-modulated pairs (parallel 2).  Bit-exact with
// the plain version fm_torch in ../fm.py.
//
// What bounds it on an H100: per sample up to 4 ops x 4 steps of about
// 25 int32 operations and one shared-memory table read each (fm4, 4x
// oversampled), and 12 bytes of slot traffic, so the operations bound
// it, still at microseconds per superblock.  What holds it back is the
// dependency chain of S*64 samples per instance (the feedback of every
// step feeds the next), with only the K instances of an item (about 60
// bells in the effects song) running side by side on 132 SMs.
//
// Design: the filter kernel's layout (filter_kernel.cu): one block per
// item, one thread per instance, phase A (recurrence into scratch) and
// then stage::emit_step (stage_common.cuh: B, old values -> deltas;
// C, atomic adds) per slice step, split by __syncthreads().  The 2048-entry paired sine table
// (sine[k+1] << 16 | u16(sine[k])) sits in shared memory, so each lerp
// is one shared load.  nops / parallel / osbits come from the
// structkey as template parameters, so the per-op state and ramps live
// in registers.  Wrapping arithmetic runs in uint32, right shifts on
// int32, the feedback and amplitude products in int64.

#include <cstdint>
#include <cuda_runtime.h>

#include "stage_common.cuh"

namespace {

using namespace stage;

constexpr int THREADS = 256;
constexpr int NCOL = 27;
constexpr int SINE_N = 2048;
constexpr uint32_t WPMASK = (SINE_N << 8) - 1;

struct Params {
    int32_t* slots;          // [nslot, 2, 64]
    const int32_t* arr;      // [S, K, 27]
    int32_t* state;          // [K, 4] per-op last output
    const int32_t* sine;     // [2048] paired sine table
    int32_t* scratch;        // [K, 64]
    int S, K, add, dch;
};

// fm.c fm_osc: one operator step; updates the op's last output `cand`
__device__ __forceinline__ int32_t fm_osc(const int32_t* sine,
                                          int32_t& cand, int32_t fbv,
                                          uint32_t phase, int32_t mod,
                                          int32_t av) {
    const int32_t fb = low32(((int64_t)cand * fbv) >> 17);
    const uint32_t pw = ((phase + (uint32_t)mod + (uint32_t)fb) >> 5)
        & WPMASK;
    const int32_t x = pw & 0xFF;
    const int32_t pr = sine[pw >> 8];
    const int32_t s0 = (int16_t)(uint16_t)(pr & 0xFFFF);
    const int32_t s1 = pr >> 16;
    cand = (s0 * (256 - x) + s1 * x) >> 8;
    return low32(((int64_t)cand * av) >> 16);
}

template <int NOPS, int PAR, int OSB>
__device__ void run_slice(const Params& p, const int32_t* sine,
                          const int32_t* row, int k, int lo, int hi,
                          int32_t* out) {
    int32_t* st = p.state + (size_t)k * 4;
    int32_t last[NOPS];
    uint32_t ph0[NOPS], dph[NOPS], dphs[NOPS];
    int32_t av0[NOPS], ad[NOPS], fbv0[NOPS], fbd[NOPS];
#pragma unroll
    for (int i = 0; i < NOPS; ++i) {
        last[i] = st[i];
        const int32_t* op = row + 3 + 6 * i;
        ph0[i] = (uint32_t)op[0];
        dph[i] = (uint32_t)op[1];
        dphs[i] = dph[i] >> OSB;
        av0[i] = op[2];
        ad[i] = op[3];
        fbv0[i] = op[4];
        fbd[i] = op[5];
    }
    for (int n = lo; n < hi; ++n) {
        int32_t av[NOPS], fbv[NOPS];
        uint32_t ph[NOPS];
#pragma unroll
        for (int i = 0; i < NOPS; ++i) {
            av[i] = wadd(av0[i], wmul(n, ad[i]));
            fbv[i] = wadd(fbv0[i], wmul(n, fbd[i]));
            ph[i] = ph0[i] + (uint32_t)n * dph[i];
        }
        int32_t vsum = 0;
#pragma unroll
        for (int os = 0; os < (1 << OSB); ++os) {
#define OSC(i, mod) fm_osc(sine, last[i], fbv[i], \
                           ph[i] + (uint32_t)os * dphs[i], (mod), av[i])
            if constexpr (PAR == 2) {  // ring-modulated pairs
                int32_t v0, v1;
                if constexpr (NOPS == 2) {
                    v0 = OSC(0, 0);
                    v1 = OSC(1, 0);
                } else {
                    const int32_t m2 = OSC(2, 0);
                    v0 = OSC(0, m2);
                    const int32_t m3 = OSC(3, 0);
                    v1 = OSC(1, m3);
                }
                vsum = wadd(vsum, low32(((int64_t)v0 * v1) >> 23));
            } else {
                int32_t vv = 0;
#pragma unroll
                for (int i = NOPS - 1; i >= 0; --i) {
                    if (i && PAR)
                        vv = wadd(vv, OSC(i, 0));
                    else
                        vv = OSC(i, vv);
                }
                vsum = wadd(vsum, vv);
            }
#undef OSC
        }
        out[n] = vsum >> OSB;
    }
#pragma unroll
    for (int i = 0; i < NOPS; ++i) st[i] = last[i];
}

template <int NOPS, int PAR, int OSB>
__global__ void __launch_bounds__(THREADS) fm_kernel(Params p) {
    __shared__ int32_t sine[SINE_N];
    for (int i = threadIdx.x; i < SINE_N; i += THREADS) sine[i] = p.sine[i];
    __syncthreads();
    for (int s = 0; s < p.S; ++s) {
        const int32_t* rows = p.arr + (size_t)s * p.K * NCOL;
        // phase A: recurrences into scratch
        for (int k = threadIdx.x; k < p.K; k += THREADS) {
            const int32_t* row = rows + (size_t)k * NCOL;
            const int lo = max(row[1], 0);
            const int hi = min(row[1] + row[2], FRAG);
            if (lo < hi)
                run_slice<NOPS, PAR, OSB>(p, sine, row, k, lo, hi,
                                          p.scratch + (size_t)k * FRAG);
        }
        __syncthreads();
        const int dcol[2] = {0, 0}, dch[2] = {p.dch, p.dch};
        emit_step<NCOL, THREADS>(p.slots, rows, p.K, p.scratch, 1, 1, dcol,
                                 dch, 1, p.add);
    }
}

template <int NOPS, int PAR, int OSB>
int launch(const Params& p, cudaStream_t stream) {
    fm_kernel<NOPS, PAR, OSB><<<1, THREADS, 0, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace

// structkey: nops in bits 8-11, parallel in bits 4-7, osbits in bits 1-3
// (the eight structures the native record emits, fm1 ... fm4r)
extern "C" int a2_fm(int32_t* slots, const int32_t* arr, int32_t* state,
                     const int32_t* sine, int32_t* scratch, int S, int K,
                     int structkey, int add, int dch, cudaStream_t stream) {
    Params p{slots, arr, state, sine, scratch, S, K, add, dch};
    switch (structkey) {
    case 256: return launch<1, 0, 0>(p, stream);
    case 514: return launch<2, 0, 1>(p, stream);
    case 546: return launch<2, 2, 1>(p, stream);
    case 772: return launch<3, 0, 2>(p, stream);
    case 788: return launch<3, 1, 2>(p, stream);
    case 1028: return launch<4, 0, 2>(p, stream);
    case 1044: return launch<4, 1, 2>(p, stream);
    case 1060: return launch<4, 2, 2>(p, stream);
    default: return (int)cudaErrorInvalidValue;
    }
}
