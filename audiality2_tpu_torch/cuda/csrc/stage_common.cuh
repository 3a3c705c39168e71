// Shared by the stage-tail kernels (fbdelay_kernel.cu, filter_kernel.cu,
// fm_kernel.cu): wrapping int32 arithmetic, and the emit of one slice
// step of an instance-batched item into the slots.
//
// Signed overflow is undefined in CUDA C++, so wrapping adds, subtracts,
// multiplies and left shifts run in uint32; right shifts stay on int32
// (arithmetic), as in the JAX package.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace stage {

constexpr int FRAG = 64;

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int32_t wshl(int32_t a, int s) {
    return (int32_t)((uint32_t)a << s);
}
__device__ __forceinline__ int32_t low32(int64_t v) {
    return (int32_t)(uint32_t)(uint64_t)v;
}

// Phases B and C of one slice step, after phase A has written every
// instance's outputs for the step to scratch[(k * sstride + c) * 64 + n]
// (and a __syncthreads()).  Per output channel c < no: phase B turns
// the outputs of a REPLACE item (add == 0) into deltas against the old
// destination values (slot row[dcol[c]], channel dch[c]); phase C adds
// them with atomics.  __syncthreads() separates the phases, so every
// old value of a step is read before any add, as the JAX scan does, and
// two instances that share a destination slot still sum exactly.  Only
// the samples in [row[offcol], row[offcol] + row[offcol + 1]) are
// written.  Called by every thread of the block.
template <int NCOL, int THREADS>
__device__ void emit_step(int32_t* slots, const int32_t* rows, int K,
                          int32_t* scratch, int sstride, int no,
                          const int dcol[2], const int dch[2], int offcol,
                          int add) {
    for (int c = 0; c < no; ++c) {
        if (!add) {
            for (int k = threadIdx.x; k < K; k += THREADS) {
                const int32_t* row = rows + (size_t)k * NCOL;
                const int lo = max(row[offcol], 0);
                const int hi = min(row[offcol] + row[offcol + 1], FRAG);
                const int32_t* dst =
                    slots + ((size_t)row[dcol[c]] * 2 + dch[c]) * FRAG;
                int32_t* o = scratch + ((size_t)k * sstride + c) * FRAG;
                for (int n = lo; n < hi; ++n) o[n] = wsub(o[n], dst[n]);
            }
        }
        __syncthreads();
        for (int k = threadIdx.x; k < K; k += THREADS) {
            const int32_t* row = rows + (size_t)k * NCOL;
            const int lo = max(row[offcol], 0);
            const int hi = min(row[offcol] + row[offcol + 1], FRAG);
            uint32_t* dst = (uint32_t*)slots
                + ((size_t)row[dcol[c]] * 2 + dch[c]) * FRAG;
            const int32_t* o = scratch + ((size_t)k * sstride + c) * FRAG;
            for (int n = lo; n < hi; ++n) atomicAdd(dst + n, (uint32_t)o[n]);
        }
        __syncthreads();
    }
}

}  // namespace stage
