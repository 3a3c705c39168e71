// Wavetable oscillator rows for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel audiality2_tpu/tpu/osc_kernel.py
// _make_kernel (launched by _osc_call): per row of 64 frames, the exact
// 48:24 phase as (pos, frac24), packed pair lookups d[k+1]<<16|u16(d[k])
// in the block's table, hifi 2x Hermite (3 lookups) / normal 2x lerp /
// lofi lerp<<1, (v*amp)>>17 in three limbs, the fused panmix (vol/pan
// ramps, 64-bit >>24 products, 2*vol clamp, mono or stereo) and the
// [OFF, END) mask.  Bit-exact with the plain version osc_rows_torch in
// ../osc_kernel.py.
//
// What bounds it on an H100: each output sample costs 4 bytes of store
// and, by the hand count in osc_kernel.ops_per_frame, about 150 int32
// ALU operations (hifi, stereo, fused) against 64 int32 lanes per SM
// per clock: at 16.7 T int32 op/s against 3.35 TB/s the kernel is
// bound by its operations, not by its 4-8 bytes per frame.  Table
// reads are the TPU kernel's bottleneck (it shuffles lanes once per
// table row); here the block's table (<= 18 x 128 int32 = 9 KB) sits
// in shared memory and every lookup is one indexed load.
//
// Design: one CUDA block per 128-row block, one thread per row.  The
// block stages its table rows atlas[tbase .. tbase+npass) in shared
// memory, each thread reads its 16 params once (coalesced) and loops
// over the 64 frames, storing out[ch*64+n][b*128+t] so the stores of a
// warp are contiguous.  Wrapping adds and products run in uint32
// (signed overflow is undefined in C++); arithmetic right shifts run
// on int32.  Every table index is clamped into the block's span: dead
// and padded rows carry garbage positions (and amp 0), live rows never
// leave it.  The TPU's split-index lane shuffle (_ta_rows) has no
// counterpart here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int FRAG = 64;
constexpr int RPB = 128;

enum { P_POS0, P_F0, P_DPOS, P_DF, P_AMP0, P_DAMP, P_VOL0, P_DVOL,
       P_PAN0, P_DPAN, P_OFF, P_END, P_MODE };
constexpr int ROW_HASPM = 1, ROW_STEREO = 2, ROW_CLAMP = 4;

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
// low 32 bits of ((int64)x * y) >> 24
__device__ __forceinline__ int32_t mul_shr24(int32_t x, int32_t y) {
    return (int32_t)(uint32_t)(uint64_t)(((int64_t)x * (int64_t)y) >> 24);
}
__device__ __forceinline__ int32_t lo16(int32_t p) {
    return (int32_t)(int16_t)(uint16_t)(uint32_t)p;
}
__device__ __forceinline__ int32_t hi16(int32_t p) { return p >> 16; }

// a2_Hermite (reference a2_dsp.h:64-74)
__device__ __forceinline__ int32_t hermite_poly(int32_t dm1, int32_t d0,
                                                int32_t d1, int32_t d2,
                                                int32_t x) {
    int32_t c = wsub(d1, dm1) >> 1;
    int32_t a = wsub(wadd(wmul(3, wsub(d0, d1)), d2), dm1) >> 1;
    int32_t b = wsub(wadd(wsub(dm1, d0), c), a);
    a = wmul(a, x) >> 15;
    a = wmul(wadd(a, b), x) >> 15;
    return wadd(d0, wmul(wadd(a, c), x) >> 15);
}

template <int QUALITY, bool FUSED, bool MONO>
__global__ void __launch_bounds__(RPB)
osc_rows_kernel(const int32_t* __restrict__ tbase,
                const int32_t* __restrict__ params,
                const int32_t* __restrict__ atlas,
                int32_t* __restrict__ out, int NB, int T, int npass) {
    extern __shared__ int32_t table[];
    const int b = blockIdx.x;
    const int t = threadIdx.x;
    const int R = NB * RPB;
    int tb = tbase[b];
    tb = tb < 0 ? 0 : (tb > T - 1 ? T - 1 : tb);
    const int span = min(npass, T - tb) * RPB;
    for (int i = t; i < span; i += RPB)
        table[i] = atlas[(int64_t)tb * RPB + i];
    __syncthreads();

    const int row = b * RPB + t;
    int32_t p[13];
#pragma unroll
    for (int i = 0; i < 13; ++i) p[i] = params[(int64_t)i * R + row];

    auto lookup = [&](int32_t j) -> int32_t {
        j = j < 0 ? 0 : (j > span - 1 ? span - 1 : j);
        return table[j];
    };
    auto lerp16 = [&](int32_t ph) -> int32_t {
        int32_t i = ph >> 8;
        int32_t x = ph & 0xFF;
        int32_t pa = lookup(i);
        return wadd(wmul(lo16(pa), 256 - x), wmul(hi16(pa), x)) >> 8;
    };

    const int32_t dph16 = wshl(p[P_DPOS], 8) | (p[P_DF] >> 16);
    const int32_t mode = p[P_MODE];
    const bool haspm = (mode & ROW_HASPM) != 0;
    const bool stereo = (mode & ROW_STEREO) != 0;
    const bool clampf = (mode & ROW_CLAMP) != 0;
    int32_t* out0 = out + row;
    int32_t* out1 = out + (int64_t)FRAG * R + row;

    for (int n = 0; n < FRAG; ++n) {
        int32_t fr = wadd(p[P_F0], wmul(n, p[P_DF]));
        int32_t pos = wadd(wadd(p[P_POS0], wmul(n, p[P_DPOS])), fr >> 24);
        fr &= 0xFFFFFF;
        const int32_t ph16 = wshl(pos, 8) | (fr >> 16);

        int32_t v;
        if (QUALITY == 0) {
            // both 2x-oversampled taps from three pair lookups: the
            // record pass caps dph16 at A2_MAXPHINC, so the second
            // tap's base index advances by at most one
            const int32_t i = ph16 >> 8;
            const int32_t x1 = (ph16 & 0xFF) << 7;
            const int32_t ph2 = wadd(ph16, dph16 >> 1);
            const int32_t x2 = (ph2 & 0xFF) << 7;
            const int32_t pa = lookup(wsub(i, 1));
            const int32_t pb = lookup(wadd(i, 1));
            const int32_t pc = lookup(wadd(i, 3));
            const int32_t dm1 = lo16(pa), d0 = hi16(pa);
            const int32_t d1 = lo16(pb), d2 = hi16(pb), d3 = lo16(pc);
            const int32_t v1 = hermite_poly(dm1, d0, d1, d2, x1);
            const bool adv = (ph2 >> 8) != i;
            v = wadd(v1, adv ? hermite_poly(d0, d1, d2, d3, x2)
                             : hermite_poly(dm1, d0, d1, d2, x2));
        } else if (QUALITY == 1) {
            v = wadd(lerp16(ph16), lerp16(wadd(ph16, dph16 >> 1)));
        } else {
            v = wshl(lerp16(ph16), 1);
        }

        // (v * amp) >> 17 in three limbs, as the TPU kernel
        const int32_t amp = wadd(p[P_AMP0], wmul(n, p[P_DAMP]));
        const int32_t a2 = amp >> 28;
        const int32_t a1 = (amp >> 14) & 0x3FFF;
        const int32_t a0 = amp & 0x3FFF;
        const int32_t x = wadd(
            wshl(wmul(v, a2), 11),
            wadd(wmul(v, a1), wmul(v, a0) >> 14) >> 3);

        const bool valid = n >= p[P_OFF] && n < p[P_END];
        int32_t ch0, ch1 = 0;
        if (!FUSED) {
            ch0 = x;
        } else {
            const int32_t vol = wadd(p[P_VOL0], wmul(n, p[P_DVOL]));
            const int32_t mch0 = mul_shr24(x, vol);
            if (MONO) {
                ch0 = haspm ? mch0 : x;
            } else {
                const int32_t pan = wadd(p[P_PAN0], wmul(n, p[P_DPAN]));
                const int32_t vp = mul_shr24(pan, vol);
                int32_t v0 = wsub(vol, vp);
                int32_t v1 = wadd(vol, vp);
                const int32_t lim = wshl(vol, 1);
                if (clampf) {
                    v0 = min(v0, lim);
                    v1 = min(v1, lim);
                }
                ch0 = haspm ? (stereo ? mul_shr24(x, v0) : mch0) : x;
                ch1 = (haspm && stereo) ? mul_shr24(x, v1) : 0;
            }
        }
        out0[(int64_t)n * R] = valid ? ch0 : 0;
        if (!MONO) out1[(int64_t)n * R] = valid ? ch1 : 0;
    }
}

template <int Q, bool F, bool M>
cudaError_t launch(const int32_t* tbase, const int32_t* params,
                   const int32_t* atlas, int32_t* out, int NB, int T,
                   int npass, cudaStream_t stream) {
    const size_t smem = (size_t)npass * RPB * sizeof(int32_t);
    osc_rows_kernel<Q, F, M><<<NB, RPB, smem, stream>>>(
        tbase, params, atlas, out, NB, T, npass);
    return cudaGetLastError();
}

template <int Q>
cudaError_t launch_q(const int32_t* tbase, const int32_t* params,
                     const int32_t* atlas, int32_t* out, int NB, int T,
                     int npass, int fused, int mono, cudaStream_t s) {
    if (fused && mono)
        return launch<Q, true, true>(tbase, params, atlas, out, NB, T, npass, s);
    if (fused)
        return launch<Q, true, false>(tbase, params, atlas, out, NB, T, npass, s);
    if (mono)
        return launch<Q, false, true>(tbase, params, atlas, out, NB, T, npass, s);
    return launch<Q, false, false>(tbase, params, atlas, out, NB, T, npass, s);
}

}  // namespace

// out: int32 (C*64, NB*128) with C = mono ? 1 : 2.  Unfused stereo
// writes zeros to channel 1, like the TPU kernel.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int a2_osc_rows(const int32_t* tbase, const int32_t* params,
                           const int32_t* atlas, int32_t* out, int NB,
                           int T, int npass, int quality, int fused,
                           int mono, void* stream) {
    if (NB <= 0 || T <= 0 || npass <= 0 || npass > 18)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (quality) {
    case 0: return (int)launch_q<0>(tbase, params, atlas, out, NB, T, npass, fused, mono, s);
    case 1: return (int)launch_q<1>(tbase, params, atlas, out, NB, T, npass, fused, mono, s);
    case 2: return (int)launch_q<2>(tbase, params, atlas, out, NB, T, npass, fused, mono, s);
    }
    return (int)cudaErrorInvalidValue;
}
