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
// fbd_legacy_torch / fbd_dense_torch there.  Wrapping adds run in
// uint32; the product is the int64 product with an arithmetic shift.
//
// What bounds it on an H100: per sample and channel one 4-byte read of
// x, of the tap and of the gain, and two 4-byte writes (ring / buffer
// and o_fb), against a handful of integer operations: the bytes bound
// it (a 2752x64-frame stereo superblock moves about 5 MB, 1.5 us at
// 3.35 TB/s).  What holds it back is the dependency chain: a tap reads
// the ring fb samples back.
//
// Dense form: one thread per residue chain.  The JAX scan walks the
// superblock in chunks of CH = C*64 samples and reads every tap of a
// chunk before writing it; the wrapper requires CH <= fb, so a tap at t
// reads t - fb <= t0 + CH - 1 - fb < t0 (t0 the chunk's first sample),
// a sample of an earlier chunk, already final.  The chunked scan is
// therefore the sequential recurrence, which splits into fb independent
// chains, one per residue r = t mod fb: the tap at t reads the other
// channel's value at t - fb, the chain's previous link (or, for t < fb,
// the tail at FBD_TAIL + t - fb).  Thread r carries that pair in
// registers along t = r, r + fb, ... < npad (ceil(npad / fb) links), so
// a link needs no barrier and no memory round trip; its x and gain
// loads do not depend on the chain and are issued AHEAD links early
// (a register ring).  Consecutive threads own consecutive t, so every
// warp access is coalesced, and the ceil(fb / 128) blocks spread over
// the SMs.  fb is part of the dense signature, so a captured graph
// keeps its grid.  A short delay leaves few, long chains (fb = 64: 64
// threads walk 2,752 links each); then each link's own latency (the
// 64-bit product, shift and add, and issuing its seven memory
// accesses) bounds the kernel, not the bytes, and the whole rounds run
// without bounds checks to keep a link's instructions few.
//
// Legacy form: fb is per slice, so residue chains do not apply; the
// walk keeps the JAX scan's chunk steps of C slices (2*C*64 samples),
// each spread over one cooperative launch (stage_common.cuh
// launch_grid, as many blocks as the step needs, up to the resident
// limit) with each thread's tap results held in registers.  A step
// reads all of its taps before any of its writes (the JAX scan's
// semantics), with a barrier between: a tap of a partial slice's masked
// tail, or one with fb near 2^20 (wrapping forward), can fall on a
// position the step writes.  A second barrier ends the step; meanwhile
// each thread loads the next step's table entries and inputs, which the
// kernel never writes.  Masked samples (n >= frames) are not written.
// A one-block grid uses __syncthreads() for both barriers.

#include <cstdint>
#include <cuda_runtime.h>

#include "stage_common.cuh"

namespace {

using namespace stage;

constexpr int FBD_BUFSIZE = 1 << 20;
constexpr uint32_t FBD_MASK = FBD_BUFSIZE - 1;
constexpr int FBD_TAIL = 1 << 17;
constexpr int NCOL = 13;      // slice-table columns
constexpr int COL_FRAMES = 5, COL_FB = 6, COL_FBGAIN = 10;

constexpr int DENSE_THREADS = 128;
constexpr int AHEAD = 16;     // links of a chain whose loads are in flight
constexpr int LEGACY_THREADS = 256;
constexpr int LEGACY_Q = 4;   // samples a thread holds per legacy step

// One round of a dense chain: links t0, t0 + fb, ... (AHEAD of them),
// each using the loads in its slot of the register ring and loading
// the link AHEAD further on into it.  CHECKED bounds every link and
// every load by npad (the last rounds); the whole rounds before need
// no check, which keeps the round's instructions few.
template <bool CHECKED>
__device__ __forceinline__ void dense_round(
    int t0, int fb, int npad, int32_t& v0, int32_t& v1,
    int32_t (&ax0)[AHEAD], int32_t (&ax1)[AHEAD], int32_t (&ag)[AHEAD],
    const int32_t* __restrict__ x0, const int32_t* __restrict__ x1,
    const int32_t* __restrict__ g, int32_t* __restrict__ o0,
    int32_t* __restrict__ o1, int32_t* __restrict__ b0,
    int32_t* __restrict__ b1) {
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
        const int t = t0 + u * fb;
        if (CHECKED && t >= npad) break;
        // channel 0 taps channel 1's value at t - fb, and back
        const int64_t gg = ag[u];
        const int32_t f0 = low32(((int64_t)v1 * gg) >> 16);
        const int32_t f1 = low32(((int64_t)v0 * gg) >> 16);
        v0 = wadd(ax0[u], f0);
        v1 = wadd(ax1[u], f1);
        o0[t] = f0;
        o1[t] = f1;
        b0[t] = v0;
        b1[t] = v1;
        const int tn = t + AHEAD * fb;
        if (!CHECKED || tn < npad) {
            ax0[u] = x0[tn];
            ax1[u] = x1[tn];
            ag[u] = g[tn];
        }
    }
}

// x, ofb: [2, npad]; g: [npad] feedback gain per sample; buf:
// [2, FBD_TAIL + npad], its first FBD_TAIL samples the tail on entry
__global__ void __launch_bounds__(DENSE_THREADS)
fbd_dense_kernel(const int32_t* __restrict__ x,
                 const int32_t* __restrict__ g, int32_t* __restrict__ buf,
                 int32_t* __restrict__ ofb, int npad, int fb) {
    const int r = blockIdx.x * DENSE_THREADS + threadIdx.x;
    if (r >= fb || r >= npad) return;
    const int32_t* x1 = x + npad;
    int32_t* b0 = buf + FBD_TAIL;
    int32_t* b1 = buf + 2 * FBD_TAIL + npad;
    int32_t* o1 = ofb + npad;
    // the chain's pair at t - fb
    int32_t v0 = b0[r - fb], v1 = b1[r - fb];
    int32_t ax0[AHEAD], ax1[AHEAD], ag[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
        const int t = r + u * fb;
        if (t < npad) {
            ax0[u] = x[t];
            ax1[u] = x1[t];
            ag[u] = g[t];
        }
    }
    const int stride = AHEAD * fb;
    int t0 = r;
    for (; t0 + stride + (AHEAD - 1) * fb < npad; t0 += stride)
        dense_round<false>(t0, fb, npad, v0, v1, ax0, ax1, ag, x, x1, g,
                           ofb, o1, b0, b1);
    for (; t0 < npad; t0 += stride)
        dense_round<true>(t0, fb, npad, v0, v1, ax0, ax1, ag, x, x1, g,
                          ofb, o1, b0, b1);
}

// x, ofb: [2, NS, 64]; arr: [NS, 13]; starts: [NS] ring position of
// each slice's sample 0; ring: [2, 2^20] (in place)
struct LegacyArgs {
    const int32_t* x;
    const int32_t* arr;
    const int32_t* starts;
    int32_t* ring;
    int32_t* ofb;
    int NS, C;
};

__device__ __forceinline__ void step_sync() {
    if (gridDim.x == 1)
        __syncthreads();
    else
        grid_sync();
}

// What one thread needs of sample q of step s before its tap: the
// output index, the tap's ring index, the write's ring index (-1 for
// a masked sample), the input and the gain.
struct LegacySample {
    int32_t e, tap, wr, x, gain;
};

__device__ __forceinline__ LegacySample legacy_sample(const LegacyArgs& p,
                                                      int s, int q) {
    const int CH = p.C * FRAG;
    const int c = q >= CH;
    const int r = q - c * CH;
    const int j = s * p.C + r / FRAG;
    const int n = r % FRAG;
    const int32_t* row = p.arr + (size_t)j * NCOL;
    const uint32_t wid = ((uint32_t)p.starts[j] + n) & FBD_MASK;
    LegacySample v;
    v.tap = (1 - c) * FBD_BUFSIZE
        + (int32_t)((wid - (uint32_t)row[COL_FB]) & FBD_MASK);
    v.wr = n < row[COL_FRAMES] ? c * FBD_BUFSIZE + (int32_t)wid : -1;
    v.e = c * p.NS * FRAG + j * FRAG + n;
    v.x = p.x[v.e];
    v.gain = row[COL_FBGAIN];
    return v;
}

__global__ void __launch_bounds__(LEGACY_THREADS)
fbd_legacy_kernel(LegacyArgs p) {
    const int per = 2 * p.C * FRAG;
    const int nsteps = p.NS / p.C;
    const int T = grid_threads();
    LegacySample v[LEGACY_Q];
    int32_t w[LEGACY_Q];
#pragma unroll
    for (int u = 0; u < LEGACY_Q; ++u) {
        const int q = grid_tid() + u * T;
        if (q < per) v[u] = legacy_sample(p, 0, q);
    }
    for (int s = 0; s < nsteps; ++s) {
#pragma unroll
        for (int u = 0; u < LEGACY_Q; ++u) {
            if (grid_tid() + u * T >= per) continue;
            const int32_t o = low32(((int64_t)p.ring[v[u].tap] * v[u].gain)
                                    >> 16);
            p.ofb[v[u].e] = o;
            w[u] = wadd(v[u].x, o);
        }
        step_sync();            // every tap of the step read
#pragma unroll
        for (int u = 0; u < LEGACY_Q; ++u) {
            const int q = grid_tid() + u * T;
            if (q >= per) continue;
            if (v[u].wr >= 0) p.ring[v[u].wr] = w[u];
            if (s + 1 < nsteps) v[u] = legacy_sample(p, s + 1, q);
        }
        step_sync();            // every write of the step done
    }
}

}  // namespace

extern "C" int a2_fbd_dense(const int32_t* x, const int32_t* g,
                            int32_t* buf, int32_t* ofb, int npad, int fb,
                            cudaStream_t stream) {
    const int chains = fb < npad ? fb : npad;
    const int blocks = (chains + DENSE_THREADS - 1) / DENSE_THREADS;
    fbd_dense_kernel<<<blocks, DENSE_THREADS, 0, stream>>>(x, g, buf, ofb,
                                                          npad, fb);
    return (int)cudaGetLastError();
}

// One cooperative launch of as many blocks as a step's samples fill,
// held to what can be resident; refused (an error, not a slower path)
// where a step needs more than LEGACY_Q samples per resident thread.
extern "C" int a2_fbd_legacy(const int32_t* x, const int32_t* arr,
                             const int32_t* starts, int32_t* ring,
                             int32_t* ofb, int NS, int C,
                             cudaStream_t stream) {
    const LegacyArgs p{x, arr, starts, ring, ofb, NS, C};
    const int per = 2 * C * FRAG;
    int resident = 0;
    int e = resident_blocks(fbd_legacy_kernel, LEGACY_THREADS, &resident);
    if (e) return e;
    if (resident < 1) return (int)cudaErrorLaunchOutOfResources;
    int blocks = (per + LEGACY_THREADS - 1) / LEGACY_THREADS;
    if (blocks > resident) blocks = resident;
    if ((long long)blocks * LEGACY_THREADS * LEGACY_Q < per)
        return (int)cudaErrorCooperativeLaunchTooLarge;
    return launch_grid(fbd_legacy_kernel, p, LEGACY_THREADS, stream, blocks);
}
