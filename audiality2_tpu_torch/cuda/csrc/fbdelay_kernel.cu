// Stereo cross-feedback delay (fbdelay) for Hopper (sm_90a): the serial
// feedback loop of both of its forms.
//
// Replaces the lax.scan inside the JAX package's superblock mixer,
// audiality2_tpu/tpu/superblock.py _apply_fbdelay (legacy form: a
// 2^20-sample ring per channel written at a running position) and
// _apply_fbdelay_dense (dense form: a linear buffer of the last 2^17
// samples followed by the superblock).  Per sample t of channel c:
//
//   o_fb = ((int64)ring[1-c][t - fb] * fbgain) >> 16     (cross taps)
//   ring[c][t] = (int32)(x_c[t] + o_fb)
//
// and o_fb is returned for the output mix.  The reader taps, the dry
// path and the emit into the slots are elementwise over the superblock
// and stay torch ops (../fbdelay.py); bit-exact with the plain versions
// fbd_legacy_torch / fbd_dense_torch there.
//
// What bounds it on an H100: per sample, one 4-byte read of x, one of
// the tap and the gain, and two 4-byte writes (ring/buffer and o_fb):
// about 20 bytes and some 10 int32 operations, so by the card's peaks
// the bytes bound it (a 2752x64-frame stereo superblock moves about
// 7 MB, 2 us at 3.35 TB/s).  What holds it back is the dependency
// chain: the feedback tap reads the ring fb samples back, so only the
// samples of one chunk (C fragments, C*64 <= fb) are independent, and
// a superblock is a chain of ceil(N / (C*64)) steps (22 for a 300 ms
// delay at 44.1 kHz) that cannot spread over more than one SM.
//
// Design: one block of 1024 threads per delay instance (one launch),
// looping over the chunk steps with __syncthreads() between them; the
// threads stride over the step's 2*C*64 samples, so loads and stores of
// a warp are contiguous.  The ring stays in device memory (L2-resident
// within a step).  The legacy form reads all taps of a step before any
// write (two phases through a scratch buffer), exactly as the JAX scan
// does; masked samples (a partial slice's tail) are not written.  The
// dense form needs fb >= C*64 (checked by the wrapper), so a step never
// reads what it writes and one phase suffices.  Wrapping adds run in
// uint32; the product is the int64 product with an arithmetic shift.

#include <cstdint>
#include <cuda_runtime.h>

#include "stage_common.cuh"

namespace {

using namespace stage;

constexpr int FBD_BUFSIZE = 1 << 20;
constexpr uint32_t FBD_MASK = FBD_BUFSIZE - 1;
constexpr int FBD_TAIL = 1 << 17;
constexpr int THREADS = 1024;
constexpr int NCOL = 13;      // slice-table columns
constexpr int COL_FRAMES = 5, COL_FB = 6, COL_FBGAIN = 10;

// x, ofb, wbuf: [2, NS, 64]; arr: [NS, 13]; starts: [NS] ring position
// of each slice's sample 0; ring: [2, 2^20] (in place)
__global__ void __launch_bounds__(THREADS)
fbd_legacy_kernel(const int32_t* __restrict__ x,
                  const int32_t* __restrict__ arr,
                  const int32_t* __restrict__ starts,
                  int32_t* __restrict__ ring, int32_t* __restrict__ ofb,
                  int32_t* __restrict__ wbuf, int NS, int C) {
    const int CH = C * FRAG;
    const int per = 2 * CH;
    const int nsteps = NS / C;
    const size_t chan = (size_t)NS * FRAG;
    for (int s = 0; s < nsteps; ++s) {
        for (int q = threadIdx.x; q < per; q += THREADS) {
            const int c = q >= CH;
            const int r = q - c * CH;
            const int j = s * C + r / FRAG;
            const int n = r % FRAG;
            const int32_t* row = arr + (size_t)j * NCOL;
            const uint32_t wid = ((uint32_t)starts[j] + n) & FBD_MASK;
            const uint32_t fidx = (wid - (uint32_t)row[COL_FB]) & FBD_MASK;
            const int32_t tap = ring[(size_t)(1 - c) * FBD_BUFSIZE + fidx];
            const int64_t o = ((int64_t)tap * row[COL_FBGAIN]) >> 16;
            const size_t e = c * chan + (size_t)j * FRAG + n;
            ofb[e] = low32(o);
            wbuf[e] = (int32_t)((uint32_t)x[e] + (uint32_t)low32(o));
        }
        __syncthreads();
        for (int q = threadIdx.x; q < per; q += THREADS) {
            const int c = q >= CH;
            const int r = q - c * CH;
            const int j = s * C + r / FRAG;
            const int n = r % FRAG;
            if (n < arr[(size_t)j * NCOL + COL_FRAMES]) {
                const uint32_t wid = ((uint32_t)starts[j] + n) & FBD_MASK;
                ring[(size_t)c * FBD_BUFSIZE + wid] =
                    wbuf[c * chan + (size_t)j * FRAG + n];
            }
        }
        __syncthreads();
    }
}

// x, ofb: [2, npad]; g: [npad] feedback gain per sample; buf:
// [2, FBD_TAIL + npad], its first FBD_TAIL samples the tail on entry
__global__ void __launch_bounds__(THREADS)
fbd_dense_kernel(const int32_t* __restrict__ x,
                 const int32_t* __restrict__ g, int32_t* __restrict__ buf,
                 int32_t* __restrict__ ofb, int npad, int CH, int fb) {
    const size_t W = (size_t)FBD_TAIL + npad;
    const int nsteps = npad / CH;
    for (int s = 0; s < nsteps; ++s) {
        for (int q = threadIdx.x; q < 2 * CH; q += THREADS) {
            const int c = q >= CH;
            const int t = s * CH + (q - c * CH);
            const int32_t tap = buf[(1 - c) * W + FBD_TAIL + t - fb];
            const int64_t o = ((int64_t)tap * g[t]) >> 16;
            ofb[(size_t)c * npad + t] = low32(o);
            buf[c * W + FBD_TAIL + t] =
                (int32_t)((uint32_t)x[(size_t)c * npad + t]
                          + (uint32_t)low32(o));
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" int a2_fbd_legacy(const int32_t* x, const int32_t* arr,
                             const int32_t* starts, int32_t* ring,
                             int32_t* ofb, int32_t* wbuf, int NS, int C,
                             cudaStream_t stream) {
    fbd_legacy_kernel<<<1, THREADS, 0, stream>>>(x, arr, starts, ring, ofb,
                                                 wbuf, NS, C);
    return (int)cudaGetLastError();
}

extern "C" int a2_fbd_dense(const int32_t* x, const int32_t* g,
                            int32_t* buf, int32_t* ofb, int npad, int CH,
                            int fb, cudaStream_t stream) {
    fbd_dense_kernel<<<1, THREADS, 0, stream>>>(x, g, buf, ofb, npad, CH,
                                                fb);
    return (int)cudaGetLastError();
}
