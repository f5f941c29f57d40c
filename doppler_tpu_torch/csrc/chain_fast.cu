// Fused chain kernel of --precision fast: decode → NCO mix → P/Q polyphase
// FIR as a bf16 tensor-core dot → encode.
//
// Replaces the dot_precision='split3' and 'default' branches of
// doppler_tpu/ops/pallas/chain.py:240 _make_kernel (its _acc_slices,
// chain.py:191-237, on operands split by _split_bf16_exact, chain.py:126,
// against taps split by split3_taps, chain.py:138), reached through
// mix_resample_chain_pallas_stream (chain.py:404) and, with a channel axis,
// mix_resample_chain_pallas_channels (chain.py:556).
//
// Computes, for output j = P·i + p (window i, phase p, off_p = ⌊p·Q/P⌋, bank
// row (p·Q) mod P, as in fir.cuh),
//     y[j] = Σ_{l<T} x_h·t_h + x_h·t_l + x_l·t_h,   x = x[Q·i + off_p − l]
// with x_h = bf16(x), x_l = bf16(x − x_h) and the taps split alike
// (ops/precision.py).  Every product is exact in float32; only the order of
// the sums is the kernel's own.  With one pass (dot_precision 'default',
// the TPU's one bf16 pass of the DEFAULT dot, chain.py:222-237) it sums
// x_h·t_h alone.  The carry is chain.cuh's, the exact kernel's: bitwise the
// same mixed samples.
//
// Design.  Phase 0 is chain.cu's mix: the
// CTA mixes its span with its T−1 halo (chain.cuh chain_fill, nco.cuh
// mix_span); the store splits each sample (__float2bfloat16_rn, __fsub_rn,
// __float2bfloat16_rn) into bf16 planes, a group of four samples as one
// 8-byte store a plane, and the entries before the carry or past the chunk
// are zeros.  Meanwhile 16-byte cp.async copies bring in G's B fragments,
// which the wrapper laid out once per bank (ops/cuda/geometry.py
// fast_taps_index): no CTA builds them.  Phase 1 is the banded bf16
// mma.sync dot of fast_dot.cuh (its design, bytes and NaN reach are written
// there) with D neighbouring windows a row of A (geometry.fast_columns:
// the largest power of two with D·P ≤ 8 and 16·D·Q dividing the block
// length L): at config 3 (P/Q/T = 3/64/370, L = 2048) D = 2 fills 6 of the
// mma's 8 columns and K = 480, 1.73× the useful MACs where one window a
// row took 416·8/1110 = 3.0×, and a warp's A fragments serve twice the
// windows.  The CTA's tile starts at a multiple of 16·D windows, and every
// chunk of whole blocks holds a multiple of 16·D windows, so window i lands
// in row ⌊i/D⌋ mod 16 and column (i mod D)·P + p of its mma whatever the
// tile, the threads or the chunk cut; the kernel refuses a D > 1 whose
// 16·D·Q does not divide L.  f32 input (L = 1024) at config 3 takes D = 1.
// One pass (dot_precision 'default') takes the compact layout: two planes
// (I_h, Q_h) and B fragments of t_h alone, so its CTA holds half the span
// bytes and more CTAs fit on an SM.  Mix and dot run one after the other;
// a form that overlapped them in other warps of a persistent CTA lost to
// this one (PERF.md §6).
//
// Bound on this card.  Bytes: 4 + 4·P/Q a sample (i16 words in, words
// out), plan words, banks and carries, at 3.35 TB/s; operations: the
// float32 mix (29 a sample, nco.cuh), none of them an FMA (-fmad=false),
// at half of 67 TFLOP/s, and the split3 dot (3 passes × I and Q × 2·T·P/Q
// a sample) at 989 TFLOP/s bf16.  At config 3, B = 16384, L = 2048:
// 140.5 MB → 0.0419 ms, mix 0.0290 ms, dot 0.0070 ms: bound by bytes
// (chip_smoke.py computes it).  What the design spends: the mix is
// chain.cu's ≈ 60 instructions a sample plus the split; the dot 1.73× the
// useful MACs, its A fragments 2 KB a warp and k-step from shared memory,
// conflict-free (a plane holds a pad of 8 entries after every S = D·Q ≥ 16,
// so the 8 rows of an ldmatrix phase meet 8 different bank groups).
// __launch_bounds__(256, 3): up to 85 registers a thread.
#include "chain.cuh"
#include "fast_dot.cuh"

namespace doppler {

struct FastArgs : FastDot {
    int C, B, L;
    const unsigned* taps;   // G's B fragments (geometry.fast_taps_index)
    int wt;                 // windows a tile: a multiple of 16·D
    int n_tiles;
    int vec4;               // the input takes 16-byte loads
    int out_f32;
    long long n_win, m_total;
    const float* carry_in;  // (C, 2, T−1)
    float* carry_out;       // (C, 2, T−1)
};

// What a launch runs: the whole kernel, or one of its two halves alone, so
// that a timing can tell how much of the whole each costs (chip_smoke.py
// phase 6).  kMixOnly: the dot is cut; each warp XORs the span's words into
// a side word, which keeps every mixed sample alive.  kDotOnly: the mix is
// cut; 16-byte stores fill the span with zeros (a tensor core takes as long
// over zeros), and the dot's outputs are stored as the whole kernel stores
// them.
enum FastPart { kWhole = 0, kMixOnly = 1, kDotOnly = 2 };

// The span of tile `unit` of channel `ch` into the planes, by thread `tid` of `nthreads`: the mix of chain.cuh chain_fill, split as
// it is stored, and zeros before the carry and past the chunk (which only
// zero taps multiply); kDotOnly stores zeros alone.
template <bool kInF32, int kPasses, int kPart>
__device__ __forceinline__ void chain_fast_fill(const void* __restrict__ in,
                                                const uint32_t* __restrict__ plans,
                                                const FastArgs& g, int ch, int unit,
                                                int tid, int nthreads, unsigned* smem) {
    const int H = g.T - 1;
    if constexpr (kPart == kDotOnly) {
        uint4* words = reinterpret_cast<uint4*>(smem + g.x_off);
        for (int w = tid; w < g.planes * g.plane / 8; w += nthreads)
            words[w] = make_uint4(0u, 0u, 0u, 0u);
        return;
    }
    // span entry 0 is x[org]: Q·i0 is a multiple of 16 and org of 4, so the
    // groups of four the mix stores whole are 8-byte aligned
    const long long i0 = (long long)unit * g.wt;
    const long long org = i0 * g.Q - H - g.lead;
    const long long end = org + g.Q * (g.wt - g.D) + 16 * g.ks;   // past the span
    const long long n_in = (long long)g.B * g.L;
    SplitStore<kPasses, kPasses == 1> store{reinterpret_cast<uint16_t*>(smem + g.x_off),
                                            &g, org};
    chain_fill<kInF32>(max64(org, -H), min64(end, n_in) - 1, in,
                       plans + (size_t)ch * g.B, (size_t)g.C * g.B, g.B, g.L,
                       g.vec4 != 0, H, g.carry_in + (size_t)ch * 2 * H, tid, nthreads,
                       store);
    for (long long n = org + tid; n < -H; n += nthreads) store(n, 0.0f, 0.0f);
    for (long long n = max64(org, n_in) + tid; n < end; n += nthreads)
        store(n, 0.0f, 0.0f);
}

// The dot of tile `unit` of channel `ch` from the planes into the outputs,
// by thread `tid` of `nthreads` (whole warps).
template <bool kOddS, int kPasses>
__device__ __forceinline__ void chain_fast_dot(void* __restrict__ out, const FastArgs& g,
                                               int ch, int unit, int tid, int nthreads,
                                               const unsigned* smem) {
    const long long i0 = (long long)unit * g.wt;
    const int n_win = (int)min64((long long)g.wt, g.n_win - i0);
    ChainSink sink{g.out_f32, out, g.m_total, g.C, ch};
    fast_items<kPasses, kOddS, kPasses == 1>(g, smem, i0, n_win, tid, nthreads, sink);
}

// The carry unit of channel `ch`: chain.cuh chain_carry.
template <bool kInF32>
__device__ __forceinline__ void chain_fast_carry(const void* __restrict__ in,
                                                 const uint32_t* __restrict__ plans,
                                                 const FastArgs& g, int ch, int tid,
                                                 int nthreads) {
    const int H = g.T - 1;
    chain_carry<kInF32>(in, plans + (size_t)ch * g.B, (size_t)g.C * g.B, g.B, g.L, H,
                        g.carry_in + (size_t)ch * 2 * H,
                        g.carry_out + (size_t)ch * 2 * H, tid, nthreads);
}

// Phase `ph` of the CTA for channel `ch`, unit `unit` (a tile of `wt`
// windows, or the channel's carry), thread `tid` of `nthreads`; true while
// a further phase follows (after a barrier): mix, then dot.  `side`: kMixOnly's side words, one a warp.
template <bool kInF32, bool kOddS, int kPasses, int kPart = kWhole>
__device__ __forceinline__ bool chain_fast_phase(
        const void* __restrict__ in, void* __restrict__ out,
        const uint32_t* __restrict__ plans, const FastArgs& g, int ch, int unit,
        int tid, int nthreads, int ph, unsigned* smem, unsigned* side = nullptr) {
    if (unit == g.n_tiles) {
        chain_fast_carry<kInF32>(in, plans, g, ch, tid, nthreads);
        return false;
    }
    if (ph == 0) {
        fast_copy_taps(smem, g, g.taps, tid, nthreads);
        chain_fast_fill<kInF32, kPasses, kPart>(in, plans, g, ch, unit, tid, nthreads,
                                                smem);
        fast_copy_wait();
        return true;
    }
    if constexpr (kPart == kMixOnly) {
        const unsigned* words = smem + g.x_off;
        unsigned x = 0u;
        for (int w = tid; w < g.planes * g.plane / 2; w += nthreads) x ^= words[w];
#ifdef __CUDACC__
        for (int o = 16; o > 0; o >>= 1) x ^= __shfl_xor_sync(0xFFFFFFFFu, x, o);
#endif
        if ((tid & 31) == 0)
            side[((size_t)unit * g.C + ch) * (nthreads / 32) + tid / 32] = x;
        return false;
    }
    chain_fast_dot<kOddS, kPasses>(out, g, ch, unit, tid, nthreads, smem);
    return false;
}

// FastArgs from doppler_chain_fast's arguments (below); false where they
// are not ones the kernel takes.
inline bool make_fast_args(FastArgs& g, const void* in, const unsigned* taps,
                           const float* carry_in, float* carry_out, int C, int B,
                           int L, int P, int Q, int T, int D, bool compact, int wt,
                           int plane, int g_off, int x_off, int out_f32,
                           long long smem) {
    g = FastArgs{};
    // D > 1 needs every chunk of whole blocks to hold whole rows of tiles
    if (C <= 0 || B <= 0 || L <= 0 || !fast_derive(g, P, Q, T, D, compact) ||
        L % Q != 0 || (D > 1 && L % (16 * D * Q) != 0) || wt <= 0 || wt % (16 * D))
        return false;
    g.C = C;
    g.B = B;
    g.L = L;
    g.wt = wt;
    g.plane = plane;
    g.g_off = g_off;
    g.x_off = x_off;
    g.n_win = (long long)B * L / Q;
    g.m_total = g.n_win * P;
    g.n_tiles = (int)((g.n_win + wt - 1) / wt);
    g.vec4 = (L % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0) ? 1 : 0;
    g.out_f32 = out_f32;
    g.taps = taps;
    g.carry_in = carry_in;
    g.carry_out = carry_out;
    return fast_fits(g, (long long)Q * (wt - D) + 16 * g.ks, smem);
}

}  // namespace doppler

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

using doppler::FastArgs;

// 256 threads, three CTAs an SM: up to 85 registers a thread
// (geometry.pick_chain_fast picks CTAs of which three or more fit an SM by
// their shared memory)
constexpr int kMaxThreads = 256;

template <bool kInF32, bool kOddS, int kPasses, int kPart>
__global__ void __launch_bounds__(kMaxThreads, 3)
chain_fast_kernel(const void* __restrict__ in, void* __restrict__ out,
                  const uint32_t* __restrict__ plans,
                  const __grid_constant__ FastArgs g, unsigned* __restrict__ side) {
    extern __shared__ uint4 smem4[];
    unsigned* smem = reinterpret_cast<unsigned*>(smem4);
    int ch, unit;
    doppler::split_block(blockIdx.x, g.C, g.n_tiles + (g.T > 1), ch, unit);
    for (int ph = 0;; ++ph) {
        if (!doppler::chain_fast_phase<kInF32, kOddS, kPasses, kPart>(
                in, out, plans, g, ch, unit, (int)threadIdx.x, (int)blockDim.x,
                ph, smem, side))
            break;
        __syncthreads();
    }
}

template <bool kInF32, bool kOddS, int kPasses, int kPart>
int launch(const void* in, void* out, const uint32_t* plans, const FastArgs& g,
           int threads, long long smem, unsigned* side, cudaStream_t stream) {
    const long long grid = (long long)g.C * (g.n_tiles + (g.T > 1 ? 1 : 0));
    if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    auto kernel = chain_fast_kernel<kInF32, kOddS, kPasses, kPart>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<(unsigned)grid, threads, (size_t)smem, stream>>>(in, out, plans, g, side);
    return (int)cudaGetLastError();
}

template <int kPasses>
int launch_any(const void* in, void* out, const uint32_t* plans, const FastArgs& g,
               int threads, long long smem, int in_f32, cudaStream_t s) {
    if (g.S & 1)
        return in_f32 ? launch<true, true, kPasses, 0>(in, out, plans, g, threads, smem, nullptr, s)
                      : launch<false, true, kPasses, 0>(in, out, plans, g, threads, smem, nullptr, s);
    return in_f32 ? launch<true, false, kPasses, 0>(in, out, plans, g, threads, smem, nullptr, s)
                  : launch<false, false, kPasses, 0>(in, out, plans, g, threads, smem, nullptr, s);
}

}  // namespace

// in, out, plans, carry_in, carry_out: as doppler_chain (chain.cu); taps:
// G's B fragments as ops/cuda/geometry.py fast_taps_index lays them out for
// (P, Q, T, D, passes), 16-byte aligned.  D: windows a row (a power of
// two, 16·D·Q dividing L where D > 1); wt: windows a CTA (a multiple of
// 16·D); threads: a multiple of 32 up to 256; plane: bf16 entries of each
// span plane; g_off, x_off: word offsets of the B fragments and of the
// planes in the `smem` bytes of dynamic shared memory, as
// geometry.fast_layout lays them out; passes: 3 (split3, four planes) or 1
// (default, the compact two).  Needs Q a power of two and L % Q == 0.
// Returns cudaGetLastError() after the launch.
extern "C" int doppler_chain_fast(const void* in, void* out, const uint32_t* plans,
                                  const unsigned* taps, const float* carry_in,
                                  float* carry_out, int C, int B, int L, int P,
                                  int Q, int T, int D, int wt, int threads,
                                  int plane, int g_off, int x_off, long long smem,
                                  int in_f32, int out_f32, int passes,
                                  void* stream) {
    FastArgs g;
    if (threads < 32 || threads > kMaxThreads || threads % 32 || smem <= 0 ||
        (passes != 1 && passes != 3) ||
        !doppler::make_fast_args(g, in, taps, carry_in, carry_out, C, B, L, P, Q,
                                 T, D, passes == 1, wt, plane, g_off, x_off,
                                 out_f32, smem))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return passes == 1 ? launch_any<1>(in, out, plans, g, threads, smem, in_f32, s)
                       : launch_any<3>(in, out, plans, g, threads, smem, in_f32, s);
}

// One half of doppler_chain_fast alone, for timing (chain_fast_phase's
// FastPart): part 1 the mix (side: one word a warp of every CTA, the XOR
// of the span's words), part 2 the dot over the unmixed input.  i16 input,
// three passes, an even row step; the other arguments as
// doppler_chain_fast's.
extern "C" int doppler_chain_fast_part(const void* in, void* out, const uint32_t* plans,
                                       const unsigned* taps, const float* carry_in,
                                       float* carry_out, int C, int B, int L, int P,
                                       int Q, int T, int D, int wt, int threads,
                                       int plane, int g_off, int x_off, long long smem,
                                       int part, unsigned* side, void* stream) {
    FastArgs g;
    if (threads < 32 || threads > kMaxThreads || threads % 32 || smem <= 0 ||
        (part != 1 && part != 2) ||
        !doppler::make_fast_args(g, in, taps, carry_in, carry_out, C, B, L, P, Q,
                                 T, D, false, wt, plane, g_off, x_off, 0, smem) ||
        (g.S & 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return part == 1
        ? launch<false, false, 3, doppler::kMixOnly>(in, out, plans, g, threads, smem, side, s)
        : launch<false, false, 3, doppler::kDotOnly>(in, out, plans, g, threads, smem, side, s);
}

#endif  // __CUDACC__
