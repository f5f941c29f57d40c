// Fused cascade kernel: decode → NCO mix → S polyphase FIR stages → encode.
//
// Replaces doppler_tpu/ops/pallas/chain.py:768 _make_cascade_kernel (with
// its mix front _make_mix_front, chain.py:145, and reduction _acc_slices,
// chain.py:191), reached through mix_cascade_pallas_stream (chain.py:960)
// and, with a channel axis, mix_cascade_pallas_channels (chain.py:1078).
//
// Computes, for each fused stage s = 0..S−1 and chunk-local index m,
//     x_{s+1}[m] = Σ_{l<T_s} bank_s[(m·Q_s) mod P_s, l] · x_s[⌊m·Q_s/P_s⌋ − l]
// where x_0 is the mixed stream of the chunk and x_s[k < 0] is read from
// the (2, T_s−1) carry of stage s — at every stage, never recomputed from
// stage s−1, which would need history older than carry_{s−1} holds.  The
// output is x_S, encoded to i16 words or as float32 planes (the split
// cascade's ÷2^k front writes planes for the tail stages).  Carry_out_s is
// the last T_s−1 entries of [carry_s | x_s].
//
// Design.  A GPU grid runs in parallel, so nothing passes between CTAs:
// every CTA owns a span of indices at one "target" stage t and works the
// span back through the stages, x_{t−1} over the span's taps, x_{t−2} over
// those, down to the mixed samples, each level held in shared memory with
// its T_s−1 halo.  Tile CTAs target the output (t = S, `tile` outputs each);
// carry CTAs target x_s at the end of the chunk (t = s) and write
// carry_out_s.  Every x_s value, whichever CTA and whichever thread computes
// it, is one __fmaf_rn chain over l = 0..T−1 in that order from the same
// inputs, so the bytes depend neither on the tile, the threads, the register
// tile nor on how the stream is split into chunks.
//
// Thread 0 works out the CTA's target and its spans into shared memory (the
// index arithmetic is divisions, in 32 bits where the indices fit); then the
// CTA runs t + 1 phases with a barrier between them.  Phase 0 loads the tap
// rows and mixes the span of x_0 with nco.cuh's mix_span: a strided walker
// of the phase (one division a thread, then additions) over 16-byte loads of
// the input.  Phase s computes the span of x_s from the span of x_{s−1} with
// fir.cuh's register tiles (R_s windows a thread, all three phases of a
// window where P = 3, four taps a step, an output's four taps as one
// warp-uniform 16-byte load, x as float2 in a padded span).  Phase t
// computes the targets the same way and stores them.  The threads of a CTA
// (a launch parameter, up to 512) are there for the mix, which is the longer
// part wherever the decimation is high; the wrapper picks the tile, the
// threads and each stage's R (ops/cuda/geometry.py, which also lays out the
// shared memory; the C side takes its offsets).
//
// Channels: C channels run the same (B, L) chunk, each with its own plan
// words (7, C, B) and its own carries (C, 2, T_s−1) per stage, into
// (C, n_out) words or (2, C, n_out) planes; a single stream is C = 1.  Every
// channel has its own tile and carry CTAs; the per-stage pointers in the
// Geometry are channel 0's and a CTA adds its channel's stride 2·(T_s−1).
// The channel is the fast index of the grid (nco.cuh split_block), so the C
// CTAs that mix one input span run together and find it in L2.  Channel
// c's bytes are those of a C = 1 launch with its plan words and carries.
//
// Bound.  On paper: at config 3 (÷8 with T = 65, then 3/8 with T = 51)
// 4 + 4·3/64 ≈ 4.19 B and 29 (mix) + 4·(65/8 + 51·3/64) ≈ 71 float32
// operations an input sample: one stream is bound by bytes, C channels by
// operations.  In fact the phases add (PERF.md; NVIDIA H100 80GB HBM3,
// 700.00 W; a 33.5 M-sample chunk takes 0.29 ms at config 3 and 0.27 ms at
// the 100 Msps front: ÷16 T = 85, ÷16 T = 95).  The mix, nearly half of the
// time at both, is ≈ 60 instructions a sample, nearly half of them integer
// at half rate, because its bytes are pinned to the plain version's
// separately rounded steps (no FMA contraction) and its phase is 64-bit.
// The dots are bound by shared-memory loads, as the chain's (chain.cu).  The
// halo a tile re-mixes is Σ_s (T_s−1)·∏_{i<s} Q_i/P_i input samples (464 at
// config 3, 1589 at the front), so larger tiles re-mix less: 512 outputs at
// config 3 (108 KB, two CTAs of 512 threads an SM) re-mix 4%; the front's 32
// outputs span 8192 samples (83 KB) and re-mix 19%.  The kernels are built
// for at most 64 registers a thread so that two 512-thread CTAs fit an SM.
#include "fir.cuh"
#include "nco.cuh"

namespace doppler {

constexpr int kMaxStages = 4;
constexpr int kMaxThreads = 512;

struct Stage {
    FirStage f;
    long long n_in;        // chunk input count of this stage
    const float* bank;     // (P, T)
    const float* carry_in; // (C, 2, T−1)
    float* carry_out;      // (C, 2, T−1)
};

struct Geometry {
    int S;
    int C;                        // channels
    int tile;
    int n_tiles;
    int units;                    // CTAs per channel: tiles + carry CTAs
    int carry_ctas[kMaxStages];   // ⌈(T_s−1)/tile⌉
    int vec4;                     // the input takes 16-byte loads
    int out_f32;
    long long n_out;
    Stage st[kMaxStages];
};

// Where fir_tile's outputs go: the next stage's span, a carry, or the output.
struct CascadeSink {
    int mode;               // 0 span, 1 carry, 2 float32 planes, 3 i16 words
    SpanStore span;
    float* carry;           // this channel's (2, H)
    int H;
    long long first;        // x index of carry entry 0
    void* out;
    long long n_out;
    int C, ch;
    __device__ __forceinline__ void put(long long j, float vi, float vq) const {
        if (mode == 0) {
            span(j, vi, vq);
        } else if (mode == 1) {
            carry[j - first] = vi;
            carry[H + (j - first)] = vq;
        } else if (mode == 2) {
            // output planes (2, C, n_out): Q sits C·n_out after I
            static_cast<float*>(out)[ch * n_out + j] = vi;
            static_cast<float*>(out)[((long long)C + ch) * n_out + j] = vq;
        } else {
            static_cast<int*>(out)[ch * n_out + j] = pack_i16(vi, vq);
        }
    }
};

// What a CTA works on: its channel, its target (stage t, indices a .. a+c−1
// of x_t; x_S = output) and the spans back through the stages.  It holds
// x_s over lo[s] .. lo[s]+cnt[s]−1, which the outputs run[s] of stage s read
// (the indices ≥ 0 of x_{s+1}; the rest of x_{s+1} comes from carry_{s+1}).
// The index arithmetic is 64-bit divisions: one thread does it, once.
struct CtaPlan {
    int ch, t;
    long long a, c;
    long long lo[kMaxStages], org[kMaxStages];
    int cnt[kMaxStages];
    FirRun run[kMaxStages];
};

__device__ __forceinline__ void cascade_plan(const Geometry& g, unsigned block,
                                             CtaPlan& p) {
    int bid;
    split_block(block, g.C, g.units, p.ch, bid);
    p.t = g.S;
    if (bid < g.n_tiles) {
        p.a = (long long)bid * g.tile;
        p.c = min64((long long)g.tile, g.n_out - p.a);
    } else {
        bid -= g.n_tiles;
        for (p.t = 0; p.t < g.S && bid >= g.carry_ctas[p.t]; ++p.t)
            bid -= g.carry_ctas[p.t];
        const int H = g.st[p.t].f.T - 1;
        p.a = g.st[p.t].n_in - H + (long long)bid * g.tile;
        p.c = min64((long long)g.tile, (long long)H - (long long)bid * g.tile);
    }
    long long ta = p.a, tc = p.c;
    for (int s = p.t - 1; s >= 0; --s) {
        const FirStage& f = g.st[s].f;
        const long long j0 = max64(ta, 0);
        const int n_j = (int)max64(ta + tc - j0, 0);
        if (n_j == 0) {
            p.run[s] = FirRun{j0, 0, 0, 0};
            p.lo[s] = p.org[s] = 0;
            p.cnt[s] = 0;
        } else {
            p.run[s] = fir_make_run(f, j0, n_j);
            p.org[s] = span_origin(f, p.run[s].i_lo);
            p.lo[s] = div_nonneg(j0 * f.Q, f.P) - (f.T - 1);
            p.cnt[s] = (int)(div_nonneg((j0 + n_j - 1) * f.Q, f.P) - p.lo[s] + 1);
        }
        ta = p.lo[s];
        tc = p.cnt[s];
    }
}

// Phase `ph` of the CTA with plan `p`, for thread `tid` of `nthreads`; true
// while a further phase follows (after a barrier).
template <bool kInF32>
__device__ __forceinline__ bool cascade_phase(
        const void* __restrict__ in, void* __restrict__ out,
        const uint32_t* __restrict__ plans, const Geometry& g, int B, int L,
        const CtaPlan& p, int tid, int nthreads, int ph, float* smem) {
    const int ch = p.ch, t = p.t;
    plans += (size_t)ch * B;
    const size_t stride = (size_t)g.C * B;

    if (ph < t) {
        // fill the span of x_ph
        const Stage& st = g.st[ph];
        const int H = st.f.T - 1;
        if (ph == 0) {
            for (int s = 0; s < t; ++s)
                fir_load_taps(smem, g.st[s].f, g.st[s].bank, tid, nthreads);
        }
        SpanStore store{reinterpret_cast<float2*>(smem + st.f.buf_off), st.f.S,
                        st.f.magic, p.org[ph]};
        const float* carry = st.carry_in + (size_t)ch * 2 * H;
        const long long lo = p.lo[ph], end = lo + p.cnt[ph];
        for (long long j = lo + tid; j < 0 && j < end; j += nthreads)
            store(j, carry[H + j], carry[2 * H + j]);
        if (end > max64(lo, 0)) {
            if (ph == 0) {
                mix_span<kInF32>(max64(lo, 0), end - 1, in, plans, stride, B, L,
                                 g.vec4 != 0, tid, nthreads, store);
            } else {
                const FirStage& f = g.st[ph - 1].f;
                CascadeSink sink{};
                sink.mode = 0;
                sink.span = store;
                fir_run(reinterpret_cast<const float2*>(smem + f.buf_off),
                        smem + f.tap_off, f, p.run[ph - 1], tid, nthreads, sink);
            }
        }
        smem_copy_wait();       // the taps (phase 0)
        return true;
    }

    // the target entries
    const long long a = p.a, c = p.c;
    CascadeSink sink{};
    if (t == g.S) {
        sink.mode = g.out_f32 ? 2 : 3;
        sink.out = out;
        sink.n_out = g.n_out;
        sink.C = g.C;
        sink.ch = ch;
    } else {
        const Stage& st = g.st[t];
        const int H = st.f.T - 1;
        sink.mode = 1;
        sink.carry = st.carry_out + (size_t)ch * 2 * H;
        sink.H = H;
        sink.first = st.n_in - H;
        const float* carry = st.carry_in + (size_t)ch * 2 * H;
        for (long long j = a + tid; j < 0 && j < a + c; j += nthreads)
            sink.put(j, carry[H + j], carry[2 * H + j]);
    }
    if (a + c > max64(a, 0)) {
        if (t == 0) {
            int cur = -1;
            Plan pl;
            for (long long j = max64(a, 0) + tid; j < a + c; j += nthreads) {
                float vi, vq;
                mix_at<kInF32>(j, in, plans, stride, B, L, cur, pl, vi, vq);
                sink.put(j, vi, vq);
            }
        } else {
            const FirStage& f = g.st[t - 1].f;
            fir_run(reinterpret_cast<const float2*>(smem + f.buf_off),
                    smem + f.tap_off, f, p.run[t - 1], tid, nthreads, sink);
        }
    }
    return false;
}

// A Geometry from doppler_cascade's arguments (below); false where they are
// not ones the kernel takes.
inline bool make_geometry(Geometry& g, const void* in, const void* const* banks,
                          const void* const* carry_in, void* const* carry_out,
                          const int* layout, int S, int C, int B, int L,
                          int tile, int out_f32) {
    if (C <= 0 || B <= 0 || L <= 0 || S < 1 || S > kMaxStages || tile < 1)
        return false;
    g = Geometry{};
    g.S = S;
    g.C = C;
    g.tile = tile;
    g.out_f32 = out_f32;
    g.vec4 = (L % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0) ? 1 : 0;
    long long n = (long long)B * L;
    for (int s = 0; s < S; ++s) {
        Stage& st = g.st[s];
        const int* v = layout + 7 * s;
        st.f.P = v[0];
        st.f.Q = v[1];
        st.f.T = v[2];
        st.f.R = v[3];
        st.f.tap_stride = v[4];
        st.f.tap_off = v[5];
        st.f.buf_off = v[6];
        if (st.f.P <= 0 || st.f.Q <= 0 || st.f.T <= 0 || n % st.f.Q ||
            !fir_r_ok(st.f.R) || st.f.tap_stride < st.f.T + 10 ||
            st.f.tap_stride % 4 || st.f.tap_off % 4 || st.f.buf_off % 4)
            return false;
        fir_derive(st.f);
        st.n_in = n;
        st.bank = static_cast<const float*>(banks[s]);
        st.carry_in = static_cast<const float*>(carry_in[s]);
        st.carry_out = static_cast<float*>(carry_out[s]);
        g.carry_ctas[s] = (st.f.T - 1 + tile - 1) / tile;
        n = n / st.f.Q * st.f.P;
    }
    g.n_out = n;
    g.n_tiles = (int)((n + tile - 1) / tile);
    g.units = g.n_tiles;
    for (int s = 0; s < S; ++s) g.units += g.carry_ctas[s];
    return true;
}

}  // namespace doppler

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

using doppler::Geometry;

template <bool kInF32>
__global__ void __launch_bounds__(doppler::kMaxThreads, 2)
cascade_kernel(const void* __restrict__ in, void* __restrict__ out,
               const uint32_t* __restrict__ plans,
               const __grid_constant__ Geometry g, int B, int L) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    __shared__ doppler::CtaPlan plan;
    if (threadIdx.x == 0) doppler::cascade_plan(g, blockIdx.x, plan);
    __syncthreads();
    for (int ph = 0;; ++ph) {
        if (!doppler::cascade_phase<kInF32>(in, out, plans, g, B, L, plan,
                                            (int)threadIdx.x, (int)blockDim.x,
                                            ph, smem))
            break;
        __syncthreads();
    }
}

template <bool kInF32>
int launch(const void* in, void* out, const uint32_t* plans, const Geometry& g,
           int threads, long long smem, int B, int L, cudaStream_t stream) {
    const long long grid = (long long)g.C * g.units;
    if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    auto kernel = cascade_kernel<kInF32>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<(unsigned)grid, threads, (size_t)smem, stream>>>(in, out, plans, g,
                                                             B, L);
    return (int)cudaGetLastError();
}

}  // namespace

// in: int32 words (B, L) or float32 planes (2, B, L); out: int32 words
// (C, n_out) or float32 planes (2, C, n_out), n_out = B·L·∏P_s/∏Q_s; plans:
// (7, C, B) uint32; banks[s]: (P_s, T_s) float32; carry_in[s], carry_out[s]:
// (C, 2, T_s−1) float32.  layout: 7 ints a stage — P, Q, T, R (windows a
// thread), tap_stride, tap_off, buf_off (float offsets into the `smem` bytes
// of dynamic shared memory, as ops/cuda/cascade.py plan_launch lays them
// out).  tile: final outputs a CTA; threads: a multiple of 32 up to 512.
// Needs every stage's chunk input count to be a multiple of its Q.  Returns
// cudaGetLastError() after the launch.
extern "C" int doppler_cascade(const void* in, void* out, const uint32_t* plans,
                               const void* const* banks,
                               const void* const* carry_in,
                               void* const* carry_out, const int* layout, int S,
                               int C, int B, int L, int tile, int threads,
                               long long smem, int in_f32, int out_f32,
                               void* stream) {
    Geometry g;
    if (threads < 32 || threads > doppler::kMaxThreads || threads % 32 ||
        smem <= 0 ||
        !doppler::make_geometry(g, in, banks, carry_in, carry_out, layout, S, C,
                                B, L, tile, out_f32))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return in_f32 ? launch<true>(in, out, plans, g, threads, smem, B, L, st)
                  : launch<false>(in, out, plans, g, threads, smem, B, L, st);
}

#endif  // __CUDACC__
