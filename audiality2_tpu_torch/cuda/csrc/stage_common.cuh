// Shared by the stage-tail kernels (fbdelay_kernel.cu, filter_kernel.cu,
// fm_kernel.cu, filter_float_kernel.cu): wrapping int32 arithmetic, a
// cooperative launch over the whole card with a grid-wide barrier, and
// the emit of a tile of slice steps of an instance-batched item into the
// slots (filter_kernel.cu, fm_kernel.cu).
//
// Signed overflow is undefined in CUDA C++, so wrapping adds, subtracts,
// multiplies and left shifts run in uint32; right shifts stay on int32
// (arithmetic), as in the JAX package.

#pragma once

#include <cooperative_groups.h>
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

// A kernel launched by launch_grid runs its blocks (by default one per
// SM, as many as fit) all resident at once: the thread's index and the
// thread count over the whole grid, and a barrier over the whole grid.
__device__ __forceinline__ int grid_tid() {
    return blockIdx.x * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ int grid_threads() {
    return gridDim.x * blockDim.x;
}
// instances of a per-instance loop spread one per block first (each
// serial chain gets an SM of its own): k = block + blocks * thread
__device__ __forceinline__ int spread_tid() {
    return blockIdx.x + gridDim.x * threadIdx.x;
}
__device__ __forceinline__ void grid_sync() {
    cooperative_groups::this_grid().sync();
}

// How many blocks of `kernel`, `threads` each with `smem` bytes of
// dynamic shared memory, can be resident together on the device (into
// *n); returns the CUDA error code (0 for none).
template <typename K>
int resident_blocks(K kernel, int threads, int* n, size_t smem = 0) {
    int dev = 0, sms = 0, per = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel,
                                                          threads, smem);
    *n = sms * per;
    return (int)e;
}

// One cooperative launch of kernel(p) with `threads` per block, `blocks`
// blocks (0: as many as can be resident together on the device) and
// `smem` bytes of dynamic shared memory each; returns the CUDA error
// code (0 for none).
template <typename P>
int launch_grid(void (*kernel)(P), const P& p, int threads,
                cudaStream_t stream, int blocks = 0, size_t smem = 0) {
    if (blocks == 0) {
        const int e = resident_blocks(kernel, threads, &blocks, smem);
        if (e) return e;
    }
    if (blocks < 1) return (int)cudaErrorLaunchOutOfResources;
    P arg = p;
    void* args[] = {&arg};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        (void*)kernel, dim3(blocks), dim3(threads), args, smem, stream);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The emit of a tile: T consecutive slice steps of one step group of an
// instance-batched item (cuda/stage_groups.py), after every output of
// the tile sits in scratch[((t * K + k) * sstride + c) * 64 + n] and a
// grid_sync() has followed.  rows points at the tile's first step
// (rows[(t * K + k) * NCOL + col]).  A REPLACE item (add == 0) first
// turns its outputs into deltas against the old destination values
// (slot row[dcol[c]], channel dch[c]); then every delta is added with
// an atomic.  Both passes run sample-parallel over the whole grid, 4
// consecutive samples per thread with 16-byte loads (consecutive
// threads on consecutive quads: coalesced) and U quads per thread in
// flight, with one grid_sync() after each pass, so every old value of
// the tile is read before any add.  That is exact because no step of a
// group reads a sample that an earlier step of it writes; instances of
// one step that share a destination slot still sum exactly.  Where the
// two outputs of a REPLACE item share a destination channel, channel 1
// reads its old values after channel 0's adds, as the JAX scan does.
// Only the samples in [row[offcol], row[offcol] + row[offcol + 1]) are
// added (the deltas outside are never used).  Called by every thread of
// the grid.
template <int NCOL>
__device__ void emit_tile(int32_t* slots, const int32_t* rows, int T, int K,
                          int32_t* scratch, int sstride, int no,
                          const int dcol[2], const int dch[2], int offcol,
                          int add) {
    constexpr int Q = 4;                  // samples per quad
    constexpr int U = 4;                  // quads per thread in flight
    const int total = T * K * (FRAG / Q);
    const bool late = !add && no == 2 && dch[0] == dch[1];
    for (int c0 = 0; c0 < no; c0 = late ? c0 + 1 : no) {
        const int nc = late ? 1 : no;     // channels c0 .. c0 + nc - 1
        for (int pass = add; pass < 2; ++pass) {
            for (int i0 = grid_tid(); i0 < total;
                 i0 += U * grid_threads()) {
                int4* o[U][2];
                int4* d[U][2];
                int4 ov[U][2], dv[U][2];
                int lo[U], hi[U];
                bool ok[U];
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const int i = i0 + u * grid_threads();
                    ok[u] = i < total;
                    if (!ok[u]) continue;
                    const int j = i / (FRAG / Q), n = i % (FRAG / Q) * Q;
                    const int32_t* row = rows + (size_t)j * NCOL;
                    lo[u] = row[offcol] - n;
                    hi[u] = row[offcol] + row[offcol + 1] - n;
                    ok[u] = lo[u] < Q && hi[u] > 0;
#pragma unroll
                    for (int c = 0; c < 2; ++c) {
                        const int cc = c0 + (c < nc ? c : 0);
                        o[u][c] = (int4*)(scratch
                            + ((size_t)j * sstride + cc) * FRAG + n);
                        d[u][c] = (int4*)(slots
                            + ((size_t)row[dcol[cc]] * 2 + dch[cc]) * FRAG
                            + n);
                    }
                }
#pragma unroll
                for (int u = 0; u < U; ++u) {
#pragma unroll
                    for (int c = 0; c < 2; ++c) {
                        if (ok[u] && c < nc) {
                            ov[u][c] = *o[u][c];
                            if (pass == 0) dv[u][c] = *d[u][c];
                        }
                    }
                }
#pragma unroll
                for (int u = 0; u < U; ++u) {
#pragma unroll
                    for (int c = 0; c < 2; ++c) {
                        if (!ok[u] || c >= nc) continue;
                        int4& v = ov[u][c];
                        if (pass == 0) {        // REPLACE: the deltas
                            const int4& w = dv[u][c];
                            *o[u][c] = make_int4(wsub(v.x, w.x),
                                                 wsub(v.y, w.y),
                                                 wsub(v.z, w.z),
                                                 wsub(v.w, w.w));
                            continue;
                        }
                        uint32_t* dst = (uint32_t*)d[u][c];
                        const int32_t e[Q] = {v.x, v.y, v.z, v.w};
#pragma unroll
                        for (int q = 0; q < Q; ++q)
                            if (q >= lo[u] && q < hi[u])
                                atomicAdd(dst + q, (uint32_t)e[q]);
                    }
                }
            }
            grid_sync();
        }
    }
}

}  // namespace stage
