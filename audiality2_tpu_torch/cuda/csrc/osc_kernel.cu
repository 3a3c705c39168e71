// Wavetable oscillator rows for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel audiality2_tpu/tpu/osc_kernel.py
// _make_kernel (launched by _osc_call) and, on the render path, the int32
// segment sum of its output into the (instance x fragment) slots that
// follows it (audiality2_tpu/tpu/superblock.py:1694).  Per row of 64
// frames: the exact 48:24 phase as (pos, frac24), packed pair lookups
// d[k+1]<<16|u16(d[k]) in the block's table, hifi 2x Hermite (3 lookups)
// / normal 2x lerp / lofi lerp<<1, (v*amp)>>17 in three limbs, the fused
// panmix (vol/pan ramps, 64-bit >>24 products, 2*vol clamp, mono or
// stereo) and the [OFF, END) mask.  Bit-exact with the plain versions
// osc_rows_torch and osc_slots_torch in ../osc_kernel.py.
//
// One body, two epilogues (the template flag SLOTS):
// - rows (a2_osc_rows): out[ch*64+n][row], the Pallas kernel's layout,
//   which osc_call keeps as its contract;
// - slots (a2_osc_slots): each sample added into slots[slot_r[row]][ch][n]
//   with 32-bit atomic adds that wrap.  Adds mod 2^32 commute and
//   associate, so the order in which the atomics land cannot change a bit
//   of a slot.  On the TPU the sum is XLA's segment_sum outside the
//   kernel; here it saves the render an intermediate of C*64 words per
//   row and an index_add_ that reads it back with a stride.
//
// What bounds it on an H100: by the hand count in osc_kernel.ops_per_frame
// a sample costs about 150 int32 ALU operations (hifi, stereo, fused)
// against 64 int32 lanes per SM per clock, and 4-8 bytes of store or
// atomic add: at 16.7 T int32 op/s against 3.35 TB/s the kernel is bound
// by its operations.  The block's table (<= 18 x 128 int32 = 9 KB), its
// rows' 13 params (6.5 KB) and slot indices sit in shared memory, loaded
// once and coalesced; every lookup is one indexed load.
//
// Design: one block of NTHREADS threads per 128-row block (the table base
// is per block), the block's 128 x 64 (row, frame) items spread over its
// threads, FPT = 16 each, so that a launch of 128 blocks still puts 16
// warps on each SM it reaches.  Every frame is closed-form in n (phase,
// amp, vol and pan ramps), so the items are independent.  The maps:
// - rows: thread t takes row t % 128 and frames (t / 128) * FPT .. + FPT;
//   a warp's stores hit 32 neighbouring rows of one output row;
// - slots: warp w takes rows w, w + NWARPS, ..., lane l frames l and
//   l + 32; a warp's adds hit 32 neighbouring words of one slot channel.
// A row whose amp ramp is 0 (amp0 = damp = 0, as dead and padded rows)
// or whose [OFF, END) window is empty outputs 0 at every frame, and the
// slots map skips it, as it skips every sample equal to 0: adding 0
// leaves a word as it is, so every slot, the dead one included, ends as
// the plain version's index_add_ leaves it.  A slot index outside
// [0, nslot) adds nothing (the plain version raises on it).  Wrapping
// adds and products run in uint32 (signed overflow is undefined in
// C++); arithmetic right shifts run on int32.  Every table index is
// clamped into the block's span: dead and padded rows carry garbage
// positions (and amp 0), live rows never leave it.  The TPU's
// split-index lane shuffle (_ta_rows) has no counterpart here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int FRAG = 64;
constexpr int RPB = 128;
constexpr int NTHREADS = 512;
constexpr int NWARPS = NTHREADS / 32;
constexpr int FPT = FRAG * RPB / NTHREADS;   // rows map: frames a thread takes
constexpr int NP = 13;                       // params a row reads

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

struct Args {
    const int32_t* tbase;    // [NB]
    const int32_t* params;   // [16, NB*128]
    const int32_t* atlas;    // [T, 128]
    int32_t* out;            // rows: [C*64, NB*128]; slots: [nslot, S, 64]
    const int64_t* slot_r;   // slots: [NB*128]
    int nslot, slot_words;   // slots: slot count, S*64
    int NB, T, npass;
};

// a row's params, read from the block's staged copy
struct Row {
    int32_t pos0, f0, dpos, df, amp0, damp, vol0, dvol, pan0, dpan, off,
        end, mode, dph16;
};

__device__ __forceinline__ Row load_row(const int32_t* par, int r) {
    Row w;
    w.pos0 = par[P_POS0 * RPB + r];
    w.f0 = par[P_F0 * RPB + r];
    w.dpos = par[P_DPOS * RPB + r];
    w.df = par[P_DF * RPB + r];
    w.amp0 = par[P_AMP0 * RPB + r];
    w.damp = par[P_DAMP * RPB + r];
    w.vol0 = par[P_VOL0 * RPB + r];
    w.dvol = par[P_DVOL * RPB + r];
    w.pan0 = par[P_PAN0 * RPB + r];
    w.dpan = par[P_DPAN * RPB + r];
    w.off = par[P_OFF * RPB + r];
    w.end = par[P_END * RPB + r];
    w.mode = par[P_MODE * RPB + r];
    w.dph16 = wshl(w.dpos, 8) | (w.df >> 16);
    return w;
}

// frame n of row w: its two channels, 0 outside [OFF, END) (ch1 is 0
// when mono or unfused)
template <int QUALITY, bool FUSED, bool MONO>
__device__ __forceinline__ void sample(const Row& w, int n,
                                       const int32_t* table, int span,
                                       int32_t& ch0, int32_t& ch1) {
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

    int32_t fr = wadd(w.f0, wmul(n, w.df));
    int32_t pos = wadd(wadd(w.pos0, wmul(n, w.dpos)), fr >> 24);
    fr &= 0xFFFFFF;
    const int32_t ph16 = wshl(pos, 8) | (fr >> 16);

    int32_t v;
    if (QUALITY == 0) {
        // both 2x-oversampled taps from three pair lookups: the record
        // pass caps dph16 at A2_MAXPHINC, so the second tap's base index
        // advances by at most one
        const int32_t i = ph16 >> 8;
        const int32_t x1 = (ph16 & 0xFF) << 7;
        const int32_t ph2 = wadd(ph16, w.dph16 >> 1);
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
        v = wadd(lerp16(ph16), lerp16(wadd(ph16, w.dph16 >> 1)));
    } else {
        v = wshl(lerp16(ph16), 1);
    }

    // (v * amp) >> 17 in three limbs, as the TPU kernel
    const int32_t amp = wadd(w.amp0, wmul(n, w.damp));
    const int32_t a2 = amp >> 28;
    const int32_t a1 = (amp >> 14) & 0x3FFF;
    const int32_t a0 = amp & 0x3FFF;
    const int32_t x = wadd(wshl(wmul(v, a2), 11),
                           wadd(wmul(v, a1), wmul(v, a0) >> 14) >> 3);

    const bool valid = n >= w.off && n < w.end;
    ch1 = 0;
    if (!FUSED) {
        ch0 = x;
    } else {
        const bool haspm = (w.mode & ROW_HASPM) != 0;
        const int32_t vol = wadd(w.vol0, wmul(n, w.dvol));
        const int32_t mch0 = mul_shr24(x, vol);
        if (MONO) {
            ch0 = haspm ? mch0 : x;
        } else {
            const bool stereo = (w.mode & ROW_STEREO) != 0;
            const int32_t pan = wadd(w.pan0, wmul(n, w.dpan));
            const int32_t vp = mul_shr24(pan, vol);
            int32_t v0 = wsub(vol, vp);
            int32_t v1 = wadd(vol, vp);
            const int32_t lim = wshl(vol, 1);
            if (w.mode & ROW_CLAMP) {
                v0 = min(v0, lim);
                v1 = min(v1, lim);
            }
            ch0 = haspm ? (stereo ? mul_shr24(x, v0) : mch0) : x;
            ch1 = (haspm && stereo) ? mul_shr24(x, v1) : 0;
        }
    }
    if (!valid) ch0 = ch1 = 0;
}

template <bool SLOTS, int QUALITY, bool FUSED, bool MONO>
__device__ __forceinline__ void osc_body(const Args& a) {
    extern __shared__ int32_t table[];
    __shared__ int32_t par[NP * RPB];
    __shared__ int32_t sidx[RPB];
    const int b = blockIdx.x;
    const int t = threadIdx.x;
    const int64_t R = (int64_t)a.NB * RPB;
    const int64_t row0 = (int64_t)b * RPB;
    int tb = a.tbase[b];
    tb = tb < 0 ? 0 : (tb > a.T - 1 ? a.T - 1 : tb);
    const int span = min(a.npass, a.T - tb) * RPB;
    for (int i = t; i < span; i += NTHREADS)
        table[i] = a.atlas[(int64_t)tb * RPB + i];
    for (int i = t; i < NP * RPB; i += NTHREADS)
        par[i] = a.params[(i / RPB) * R + row0 + i % RPB];
    if (SLOTS && t < RPB) {
        const int64_t s = a.slot_r[row0 + t];
        sidx[t] = (s >= 0 && s < a.nslot) ? (int)s : -1;
    }
    __syncthreads();

    if (!SLOTS) {
        const int r = t % RPB;
        const int n0 = (t / RPB) * FPT;
        const Row w = load_row(par, r);
        int32_t* o = a.out + row0 + r;
#pragma unroll 4
        for (int k = 0; k < FPT; ++k) {
            const int n = n0 + k;
            int32_t c0, c1;
            sample<QUALITY, FUSED, MONO>(w, n, table, span, c0, c1);
            o[(int64_t)n * R] = c0;
            if (!MONO) o[(int64_t)(FRAG + n) * R] = c1;
        }
    } else {
        const int warp = t / 32, lane = t % 32;
        for (int r = warp; r < RPB; r += NWARPS) {
            const int s = sidx[r];
            const Row w = load_row(par, r);
            // warp-uniform: the row adds nothing
            if (s < 0 || (w.amp0 == 0 && w.damp == 0) || w.off >= w.end)
                continue;
            uint32_t* dst = (uint32_t*)a.out + (int64_t)s * a.slot_words;
#pragma unroll
            for (int h = 0; h < FRAG / 32; ++h) {
                const int n = lane + 32 * h;
                int32_t c0, c1;
                sample<QUALITY, FUSED, MONO>(w, n, table, span, c0, c1);
                if (c0) atomicAdd(dst + n, (uint32_t)c0);
                if (!MONO && c1) atomicAdd(dst + FRAG + n, (uint32_t)c1);
            }
        }
    }
}

template <int Q, bool F, bool M>
__global__ void __launch_bounds__(NTHREADS) osc_rows_kernel(Args a) {
    osc_body<false, Q, F, M>(a);
}

template <int Q, bool F, bool M>
__global__ void __launch_bounds__(NTHREADS) osc_slots_kernel(Args a) {
    osc_body<true, Q, F, M>(a);
}

template <bool SLOTS, int Q, bool F, bool M>
cudaError_t launch(const Args& a, cudaStream_t s) {
    const size_t smem = (size_t)a.npass * RPB * sizeof(int32_t);
    if constexpr (SLOTS)
        osc_slots_kernel<Q, F, M><<<a.NB, NTHREADS, smem, s>>>(a);
    else
        osc_rows_kernel<Q, F, M><<<a.NB, NTHREADS, smem, s>>>(a);
    return cudaGetLastError();
}

template <bool SLOTS, int Q>
cudaError_t launch_q(const Args& a, int fused, int mono, cudaStream_t s) {
    if (fused && mono) return launch<SLOTS, Q, true, true>(a, s);
    if (fused) return launch<SLOTS, Q, true, false>(a, s);
    if (mono) return launch<SLOTS, Q, false, true>(a, s);
    return launch<SLOTS, Q, false, false>(a, s);
}

template <bool SLOTS>
int dispatch(const Args& a, int quality, int fused, int mono, void* stream) {
    if (a.NB <= 0 || a.T <= 0 || a.npass <= 0 || a.npass > 18)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (quality) {
    case 0: return (int)launch_q<SLOTS, 0>(a, fused, mono, s);
    case 1: return (int)launch_q<SLOTS, 1>(a, fused, mono, s);
    case 2: return (int)launch_q<SLOTS, 2>(a, fused, mono, s);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// out: int32 (C*64, NB*128) with C = mono ? 1 : 2.  Unfused stereo
// writes zeros to channel 1, like the TPU kernel.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int a2_osc_rows(const int32_t* tbase, const int32_t* params,
                           const int32_t* atlas, int32_t* out, int NB,
                           int T, int npass, int quality, int fused,
                           int mono, void* stream) {
    const Args a{tbase, params, atlas, out, nullptr, 0, 0, NB, T, npass};
    return dispatch<false>(a, quality, fused, mono, stream);
}

// slots: int32 (nslot, S, 64), added into in place: row r's channel c
// frame n into slots[slot_r[r]][c][n], channel 0 only when mono (S is 2,
// or 1 when mono).  slot_r: int64 (NB*128).  Returns the cudaError_t of
// the launch (0 = launched).
extern "C" int a2_osc_slots(const int32_t* tbase, const int32_t* params,
                            const int32_t* atlas, const int64_t* slot_r,
                            int32_t* slots, int nslot, int S, int NB, int T,
                            int npass, int quality, int fused, int mono,
                            void* stream) {
    if (nslot <= 0 || S < 1 || S > 2 || (!mono && S != 2))
        return (int)cudaErrorInvalidValue;
    const Args a{tbase, params, atlas, slots, slot_r, nslot, S * FRAG, NB, T,
                 npass};
    return dispatch<true>(a, quality, fused, mono, stream);
}
