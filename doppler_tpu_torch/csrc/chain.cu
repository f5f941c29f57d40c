// Fused chain kernel: decode → NCO mix → P/Q polyphase FIR → encode.
//
// Replaces doppler_tpu/ops/pallas/chain.py:240 _make_kernel (with its mix
// front _make_mix_front, chain.py:145, and banded-matmul reduction
// _acc_slices, chain.py:191), reached through
// mix_resample_chain_pallas_stream (chain.py:404) and, with a channel axis,
// mix_resample_chain_pallas_channels (chain.py:556).
//
// Computes, for chunk-local output m,
//     y[m] = Σ_{l<T} bank[(m·Q) mod P, l] · x[⌊m·Q/P⌋ − l]
// where x is the mixed stream of the chunk and x[k < 0] is read from the
// (2, T−1) carry of the previous chunk.  Also returns the new carry: the
// last T−1 samples of [carry | x].
//
// Design.  A GPU grid runs in parallel, so no FIR history passes from CTA to
// CTA: every CTA owns a tile of outputs and mixes its own input span plus a
// T−1-sample halo into shared memory.  Re-mixing the halo from the raw words
// is exact because the phase is a pure function of the plan words and the
// sample index.  Only CTAs whose span reaches before the chunk (the first)
// read carry_in; one extra CTA (per channel) writes carry_out.
//
// Thread 0 works out the CTA's tile and span into shared memory (the index
// arithmetic is divisions); then a tile CTA runs two phases with a barrier
// between them.  Phase 0 loads the tap rows and mixes the span with
// nco.cuh's mix_span: a strided walker of the phase (one division a thread,
// then additions; no 64-bit product a sample) over 16-byte loads of the
// input, the samples stored as float2 (I, Q).  Phase 1 is fir.cuh's
// register-tiled dot: a thread owns all three phases of R neighbouring
// windows at P = 3 (one phase of R windows otherwise) and walks their common
// x once, four taps a step, so a value loaded from shared memory feeds up to
// 6·R FMAs; an output's four taps are one warp-uniform 16-byte load.  Each
// output is still one __fmaf_rn chain over l = 0..T−1 in that order, so the
// bytes depend neither on the tile, the threads, R nor on how the stream is
// split into chunks.  The wrapper picks tile, threads and R
// (ops/cuda/geometry.py, which also lays out the shared memory; the C side
// takes its offsets).
//
// Channels: C channels run the same (B, L) chunk, each with its own plan
// words (7, C, B) and its own carry (C, 2, T−1), into (C, n_out) words or
// (2, C, n_out) planes; a single stream is C = 1.  Every channel has its
// own tile CTAs and its own carry CTA; the channel is the fast index of the
// grid (nco.cuh split_block), so the C CTAs that mix one input span run
// together and the span comes from L2 after its first read.  Channel c's
// bytes are those of a C = 1 launch with its plan words and carry.
//
// Bound.  On paper: at config 3 (P/Q = 3/64, T = 370) 4 + 4·3/64 ≈ 4.19 B
// and 29 (mix) + 4·370·3/64 ≈ 98 float32 operations an input sample, which
// makes one stream bound by operations, narrowly.  In fact the two phases add,
// and neither runs at that rate (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W; a
// 33.5 M-sample chunk takes 0.27 ms).  The mix is ≈ 60 instructions a sample,
// nearly half of them integer at half rate, because its bytes are pinned to
// the plain version's separately rounded steps (no FMA contraction) and its
// phase is 64-bit: ≈ 0.105 ms.  The dot is bound by shared-memory loads: a
// group of four steps is 37 instructions for 24 FFMA, 9.25 clocks of an SM's
// issue, but its 4 loads of x and 3 of taps take an SM 14.5–16 clocks
// (tools/fir_group_bench.py), and ragged groups at both ends of a window load
// x for one or two phases only: ≈ 0.155 ms.  What limits the tile: at Q = 64
// an output needs 21 input samples of 8 B in shared memory, so an SM holds
// about 1150 outputs at a time, 12 warps of dot work at R = 1; R = 2 halves
// the loads of x a FFMA and the warps, and is slower.  A tile of 384 outputs
// (70 KB, three CTAs an SM) re-mixes 4.5% of the samples.
#include "chain.cuh"
#include "fir.cuh"

namespace doppler {

struct ChainArgs {
    FirStage f;
    int C, B, L;
    int tile, n_tiles;
    int vec4;               // the input takes 16-byte loads
    int out_f32;
    long long m_total;
    const float* bank;      // (P, T)
    const float* carry_in;  // (C, 2, T−1)
    float* carry_out;       // (C, 2, T−1)
};

// What a CTA works on: its channel and its unit (a tile of outputs, or the
// channel's carry), the tile's outputs as a FirRun and the span of x under
// them.  The index arithmetic is 64-bit divisions: one thread does it, once.
struct ChainPlan {
    int ch, unit;
    FirRun run;
    long long lo, last, org;    // the span x[lo .. last]; x index of its k = 0
};

__device__ __forceinline__ void chain_plan(const ChainArgs& g, unsigned block,
                                           ChainPlan& p) {
    const FirStage& f = g.f;
    split_block(block, g.C, g.n_tiles + (f.T > 1), p.ch, p.unit);
    if (p.unit == g.n_tiles) return;
    const long long m0 = (long long)p.unit * g.tile;
    const int cnt = (int)min64((long long)g.tile, g.m_total - m0);
    p.run = fir_make_run(f, m0, cnt);
    p.org = span_origin(f, p.run.i_lo);
    p.lo = div_nonneg(m0 * f.Q, f.P) - (f.T - 1);
    p.last = div_nonneg((m0 + cnt - 1) * f.Q, f.P);
}

// Phase `ph` of the CTA with plan `p`, for thread `tid` of `nthreads`; true
// while a further phase follows (after a barrier).
template <bool kInF32>
__device__ __forceinline__ bool chain_phase(
        const void* __restrict__ in, void* __restrict__ out,
        const uint32_t* __restrict__ plans, const ChainArgs& g,
        const ChainPlan& p, int tid, int nthreads, int ph, float* smem) {
    const FirStage& f = g.f;
    const int H = f.T - 1;
    const int ch = p.ch;
    plans += (size_t)ch * g.B;
    const size_t stride = (size_t)g.C * g.B;
    const float* carry_in = g.carry_in + (size_t)ch * 2 * H;

    if (p.unit == g.n_tiles) {                 // the carry CTA
        chain_carry<kInF32>(in, plans, stride, g.B, g.L, H, carry_in,
                            g.carry_out + (size_t)ch * 2 * H, tid, nthreads);
        return false;
    }

    if (ph == 0) {
        fir_load_taps(smem, f, g.bank, tid, nthreads);
        SpanStore store{reinterpret_cast<float2*>(smem + f.buf_off), f.S, f.magic,
                        p.org};
        chain_fill<kInF32>(p.lo, p.last, in, plans, stride, g.B, g.L,
                           g.vec4 != 0, H, carry_in, tid, nthreads, store);
        smem_copy_wait();       // the taps
        return true;
    }
    ChainSink sink{g.out_f32, out, g.m_total, g.C, ch};
    fir_run(reinterpret_cast<const float2*>(smem + f.buf_off), smem + f.tap_off,
            f, p.run, tid, nthreads, sink);
    return false;
}

// ChainArgs from doppler_chain's arguments (below); false where they are
// not ones the kernel takes.
inline bool make_chain_args(ChainArgs& g, const void* in, const float* bank,
                            const float* carry_in, float* carry_out, int C,
                            int B, int L, int P, int Q, int T, int tile, int R,
                            int tap_stride, int tap_off, int buf_off,
                            int out_f32) {
    if (C <= 0 || B <= 0 || L <= 0 || P <= 0 || Q <= 0 || T <= 0 || L % Q != 0 ||
        tile <= 0 || !fir_r_ok(R) || tap_stride < T + 10 || tap_stride % 4 ||
        tap_off % 4 || buf_off % 4)
        return false;
    g = ChainArgs{};
    g.f.P = P;
    g.f.Q = Q;
    g.f.T = T;
    g.f.R = R;
    g.f.tap_stride = tap_stride;
    g.f.tap_off = tap_off;
    g.f.buf_off = buf_off;
    fir_derive(g.f);
    g.C = C;
    g.B = B;
    g.L = L;
    g.tile = tile;
    g.m_total = (long long)B * L / Q * P;
    g.n_tiles = (int)((g.m_total + tile - 1) / tile);
    g.vec4 = (L % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0) ? 1 : 0;
    g.out_f32 = out_f32;
    g.bank = bank;
    g.carry_in = carry_in;
    g.carry_out = carry_out;
    return true;
}

}  // namespace doppler

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

using doppler::ChainArgs;

constexpr int kMaxThreads = 512;

template <bool kInF32>
__global__ void __launch_bounds__(kMaxThreads, 2)
chain_kernel(const void* __restrict__ in, void* __restrict__ out,
             const uint32_t* __restrict__ plans,
             const __grid_constant__ ChainArgs g) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    __shared__ doppler::ChainPlan plan;
    if (threadIdx.x == 0) doppler::chain_plan(g, blockIdx.x, plan);
    __syncthreads();
    for (int ph = 0;; ++ph) {
        if (!doppler::chain_phase<kInF32>(in, out, plans, g, plan,
                                          (int)threadIdx.x, (int)blockDim.x, ph,
                                          smem))
            break;
        __syncthreads();
    }
}

template <bool kInF32>
int launch(const void* in, void* out, const uint32_t* plans, const ChainArgs& g,
           int threads, long long smem, cudaStream_t stream) {
    const long long grid = (long long)g.C * (g.n_tiles + (g.f.T > 1 ? 1 : 0));
    if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    auto kernel = chain_kernel<kInF32>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<(unsigned)grid, threads, (size_t)smem, stream>>>(in, out, plans, g);
    return (int)cudaGetLastError();
}

}  // namespace

// in: int32 words (B, L) or float32 planes (2, B, L); out: int32 words
// (C, B·L·P/Q) or float32 planes (2, C, B·L·P/Q); plans: (7, C, B) uint32;
// bank: (P, T) float32; carry_in/carry_out: (C, 2, T−1) float32.  tile:
// outputs a CTA; threads: a multiple of 32 up to 512; R: windows a thread;
// tap_stride, tap_off, buf_off: float offsets into the `smem` bytes of
// dynamic shared memory, as ops/cuda/chain.py plan_launch lays them out.
// Needs L % Q == 0.  Returns cudaGetLastError() after the launch.
extern "C" int doppler_chain(const void* in, void* out, const uint32_t* plans,
                             const float* bank, const float* carry_in,
                             float* carry_out, int C, int B, int L, int P,
                             int Q, int T, int tile, int threads, int R,
                             int tap_stride, int tap_off, int buf_off,
                             long long smem, int in_f32, int out_f32,
                             void* stream) {
    ChainArgs g;
    if (threads < 32 || threads > kMaxThreads || threads % 32 || smem <= 0 ||
        !doppler::make_chain_args(g, in, bank, carry_in, carry_out, C, B, L, P,
                                  Q, T, tile, R, tap_stride, tap_off, buf_off,
                                  out_f32))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return in_f32 ? launch<true>(in, out, plans, g, threads, smem, s)
                  : launch<false>(in, out, plans, g, threads, smem, s);
}

#endif  // __CUDACC__
