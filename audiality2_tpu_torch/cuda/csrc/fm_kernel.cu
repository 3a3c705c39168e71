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
// Design: one cooperative launch per item, one block per SM
// (stage_common.cuh), over the step groups of filter_kernel.cu
// (../stage_groups.py; an fm item has no slot inputs, so its groups
// break only where a REPLACE destination's window repeats).  Per tile
// of a group, one thread per instance, one instance per block first,
// runs its ops over every step of the tile, with the per-op state and
// ramps in registers and the next slice's params loaded while the
// current slice runs.  Samples go in quads: a quad inside the slice's
// window runs branch-free, so the compiler can interleave one sample's
// carrier with the next sample's modulators (in-order issue would
// otherwise serialise the ops' independent chains), and each quad
// leaves as one 16-byte store to wrapper-allocated scratch [tmax, K,
// 64] (L2-resident).  stage::emit_tile (stage_common.cuh) then turns
// the outputs into deltas and adds them sample-parallel over the grid,
// one grid barrier after each pass.  The 2048-entry paired sine table
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
    int32_t* scratch;        // [tmax, K, 64]
    // [G, b0 .. bG]: the group count G, then the G + 1 step bounds
    // of the groups (read on the card, so a captured launch takes
    // each superblock's groups from memory)
    const int32_t* bounds;
    int tmax, K, add, dch;
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

// one output sample n of an instance: its ops' ramps closed-form from
// the slice's params prm, 1 << OSB oversampled steps; updates last[]
template <int NOPS, int PAR, int OSB>
__device__ __forceinline__ int32_t fm_sample(const int32_t* sine,
                                             const int32_t* prm,
                                             int32_t* last, int n) {
    int32_t av[NOPS], fbv[NOPS];
    uint32_t ph[NOPS], dphs[NOPS];
#pragma unroll
    for (int i = 0; i < NOPS; ++i) {
        const int c = 3 + 6 * i;     // the op's columns
        av[i] = wadd(prm[c + 2], wmul(n, prm[c + 3]));
        fbv[i] = wadd(prm[c + 4], wmul(n, prm[c + 5]));
        ph[i] = (uint32_t)prm[c] + (uint32_t)n * (uint32_t)prm[c + 1];
        dphs[i] = (uint32_t)prm[c + 1] >> OSB;
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
    return vsum >> OSB;
}

// instance k's ops over the T steps of a tile
template <int NOPS, int PAR, int OSB>
__device__ void fm_chain(const Params& p, const int32_t* sine,
                         const int32_t* rows, int T, int k) {
    int32_t* st = p.state + (size_t)k * 4;
    int32_t last[NOPS];
#pragma unroll
    for (int i = 0; i < NOPS; ++i) last[i] = st[i];
    constexpr int NP = 3 + 6 * NOPS;
    int32_t prm[NP];
    const int32_t* row = rows + (size_t)k * NCOL;
#pragma unroll
    for (int i = 0; i < NP; ++i) prm[i] = row[i];
    for (int t = 0; t < T; ++t) {
        const bool more = t + 1 < T;
        int32_t nxt[NP];
        if (more) {
            const int32_t* r2 = rows + ((size_t)(t + 1) * p.K + k) * NCOL;
#pragma unroll
            for (int i = 0; i < NP; ++i) nxt[i] = r2[i];
        }
        int4* out = (int4*)(p.scratch + (size_t)(t * p.K + k) * FRAG);
        const int lo = max(prm[1], 0);
        const int hi = min(prm[1] + prm[2], FRAG);
        // quads of 4 samples, one 16-byte store each; a quad inside the
        // window runs branch-free, so the compiler can interleave one
        // sample's carrier with the next sample's modulators
        for (int q = lo / 4; q < (hi + 3) / 4; ++q) {
            int32_t ov[4];
            if (4 * q >= lo && 4 * q + 4 <= hi) {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    ov[e] = fm_sample<NOPS, PAR, OSB>(sine, prm, last,
                                                      4 * q + e);
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int n = 4 * q + e;
                    ov[e] = n < lo || n >= hi ? 0
                        : fm_sample<NOPS, PAR, OSB>(sine, prm, last, n);
                }
            }
            out[q] = make_int4(ov[0], ov[1], ov[2], ov[3]);
        }
        if (more) {
#pragma unroll
            for (int i = 0; i < NP; ++i) prm[i] = nxt[i];
        }
    }
#pragma unroll
    for (int i = 0; i < NOPS; ++i) st[i] = last[i];
}

template <int NOPS, int PAR, int OSB>
__global__ void __launch_bounds__(THREADS, 1) fm_kernel(Params p) {
    __shared__ int32_t sine[SINE_N];
    for (int i = threadIdx.x; i < SINE_N; i += THREADS) sine[i] = p.sine[i];
    __syncthreads();
    const int dcol[2] = {0, 0}, dch[2] = {p.dch, p.dch};
    const int G = p.bounds[0];
    const int32_t* b = p.bounds + 1;
    for (int g = 0; g < G; ++g) {
        const int g1 = b[g + 1];
        for (int s0 = b[g]; s0 < g1; s0 += p.tmax) {
            const int T = min(p.tmax, g1 - s0);
            const int32_t* rows = p.arr + (size_t)s0 * p.K * NCOL;
            for (int k = spread_tid(); k < p.K; k += grid_threads())
                fm_chain<NOPS, PAR, OSB>(p, sine, rows, T, k);
            grid_sync();
            emit_tile<NCOL>(p.slots, rows, T, p.K, p.scratch, 1, 1, dcol,
                            dch, 1, p.add);
        }
    }
}

template <int NOPS, int PAR, int OSB>
int launch(const Params& p, cudaStream_t stream) {
    return launch_grid(fm_kernel<NOPS, PAR, OSB>, p, THREADS, stream);
}

}  // namespace

// structkey: nops in bits 8-11, parallel in bits 4-7, osbits in bits 1-3
// (the eight structures the native record emits, fm1 ... fm4r)
// bounds: the group count G and the G + 1 step bounds of the item's
// groups, int32 [G + 2], on the card; scratch [tmax, K, 64].
extern "C" int a2_fm(int32_t* slots, const int32_t* arr, int32_t* state,
                     const int32_t* sine, int32_t* scratch,
                     const int32_t* bounds, int tmax, int K, int structkey,
                     int add, int dch, cudaStream_t stream) {
    Params p{slots, arr, state, sine, scratch, bounds, tmax, K, add, dch};
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
