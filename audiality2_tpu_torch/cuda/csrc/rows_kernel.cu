// The batched host engine's row batch for Hopper (sm_90a).
//
// Replaces the JAX package's jitted rows_jax (audiality2_tpu/tpu/
// row_kernel.py), device code that the JAX package left to XLA: per
// control row (one deferred wtosc voice slice, units/deferred.py) and
// frame, the 2x oversampled Hermite of the wave atlas, the amplitude
// ramp and (v * amp) >> 17, and the fused panmix (mono, stereo, the
// 2*vol clamp).  The math of tpu/kernels.py's wtosc_fragments plus
// panmix_stereo, in 64-bit integers.  Bit-exact with the plain version
// rows_plain in ../rows.py (and with rows_numpy, which it mirrors).
//
// What bounds it on an H100: each (row, frame) writes 16 bytes (two
// int64 channels) and reads 8 atlas values (cached: the atlas is a few
// tens of KB), about 156 int32 ALU operations (rows.OPS_PER_FRAME: the
// 64-bit math emulated in 32-bit, a multiply counting 4); at 16.7 T
// int32 op/s against 3.35 TB/s the two bounds are within 2x of each
// other, the operations the larger.
//
// Design: one thread per (row, frame), 4 rows x 64 frames per block of
// 256 threads.  A warp's 32 threads share a row, so its 12 parameters
// are one broadcast load each, and the warp's stores of one channel are
// 256 contiguous bytes.  numpy wraps int64 products and sums: they run
// in uint64 here (signed overflow is undefined behaviour in C++), and
// the right shifts run on int64 (arithmetic).  An atlas index below 0
// wraps as torch.take and numpy do (the padded rows of a batch read
// atlas[-1]); one past either end, where torch.take raises, reads the
// nearest end instead (no real row gets there: the atlas pads every
// wave with A2_WAVEPRE samples).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int FRAG = 64;
constexpr int ROWS = 4;            // rows of a block
constexpr int NPARAM = 12;

enum { P_BASE, P_PH0, P_DPH, P_AMP0, P_DAMP, P_HASPM, P_STEREO, P_CLAMP,
       P_VOL0, P_DVOL, P_PAN0, P_DPAN };

__device__ __forceinline__ int64_t add(int64_t a, int64_t b) {
    return (int64_t)((uint64_t)a + (uint64_t)b);
}
__device__ __forceinline__ int64_t sub(int64_t a, int64_t b) {
    return (int64_t)((uint64_t)a - (uint64_t)b);
}
__device__ __forceinline__ int64_t mul(int64_t a, int64_t b) {
    return (int64_t)((uint64_t)a * (uint64_t)b);
}

__device__ __forceinline__ int64_t at(const int32_t* __restrict__ atlas,
                                      int64_t n, int64_t i) {
    if (i < 0) i += n;
    i = i < 0 ? 0 : i >= n ? n - 1 : i;
    return (int64_t)__ldg(atlas + i);
}

__device__ __forceinline__ int64_t hermite(const int32_t* __restrict__ atlas,
                                           int64_t n, int64_t pos,
                                           int64_t x) {
    const int64_t dm1 = at(atlas, n, sub(pos, 1));
    const int64_t d0 = at(atlas, n, pos);
    const int64_t d1 = at(atlas, n, add(pos, 1));
    const int64_t d2 = at(atlas, n, add(pos, 2));
    const int64_t xx = x << 7;                       // x in [0, 255]
    const int64_t c = sub(d1, dm1) >> 1;
    int64_t a = sub(add(mul(3, sub(d0, d1)), d2), dm1) >> 1;
    const int64_t b = sub(add(sub(dm1, d0), c), a);
    a = mul(a, xx) >> 15;
    a = mul(add(a, b), xx) >> 15;
    return add(d0, mul(add(a, c), xx) >> 15);
}

__global__ void __launch_bounds__(ROWS * FRAG)
rows_kernel(const int64_t* __restrict__ prm, int n,
            const int32_t* __restrict__ atlas, int64_t na,
            int64_t* __restrict__ out) {
    const int r = blockIdx.x * ROWS + threadIdx.x / FRAG;
    const int64_t f = threadIdx.x % FRAG;
    if (r >= n) return;
    int64_t p[NPARAM];
#pragma unroll
    for (int k = 0; k < NPARAM; ++k) p[k] = prm[(int64_t)k * n + r];

    const int64_t ph = add(p[P_PH0], mul(f, p[P_DPH]));
    const int64_t ph16 = ph >> 16;
    const int64_t dph16 = p[P_DPH] >> 16;
    const int64_t v1 = hermite(atlas, na, add(p[P_BASE], ph16 >> 8),
                               ph16 & 0xFF);
    const int64_t ph2 = add(ph16, dph16 >> 1);
    const int64_t v2 = hermite(atlas, na, add(p[P_BASE], ph2 >> 8),
                               ph2 & 0xFF);
    const int64_t amp = add(p[P_AMP0], mul(f, p[P_DAMP]));
    const int64_t osc = mul(add(v1, v2), amp) >> 17;

    const int64_t vol = add(p[P_VOL0], mul(f, p[P_DVOL]));
    const int64_t pan = add(p[P_PAN0], mul(f, p[P_DPAN]));
    const int64_t vp = mul(pan, vol) >> 24;
    int64_t g0 = sub(vol, vp);
    int64_t g1 = add(vol, vp);
    if (p[P_CLAMP]) {
        const int64_t lim = (int64_t)((uint64_t)vol << 1);
        g0 = g0 < lim ? g0 : lim;
        g1 = g1 < lim ? g1 : lim;
    }
    int64_t ch0 = osc, ch1 = 0;
    if (p[P_HASPM]) {
        if (p[P_STEREO]) {
            ch0 = mul(osc, g0) >> 24;
            ch1 = mul(osc, g1) >> 24;
        } else {
            ch0 = mul(osc, vol) >> 24;
        }
    }
    int64_t* o = out + (int64_t)r * 2 * FRAG;
    o[f] = ch0;
    o[FRAG + f] = ch1;
}

}  // namespace

// params: int64 [12, n] (base, ph0, dph, amp0, damp, haspm, stereo,
// clamp, vol0, dvol, pan0, dpan; the flags 0 or 1); atlas: int32 [na];
// out: int64 [n, 2, 64].  Returns the cudaError_t of the launch.
extern "C" int a2_rows(const int64_t* params, int n, const int32_t* atlas,
                       int64_t na, int64_t* out, void* stream) {
    if (n <= 0 || na <= 0) return (int)cudaErrorInvalidValue;
    const int blocks = (n + ROWS - 1) / ROWS;
    rows_kernel<<<blocks, ROWS * FRAG, 0, (cudaStream_t)stream>>>(
        params, n, atlas, na, out);
    return (int)cudaGetLastError();
}
