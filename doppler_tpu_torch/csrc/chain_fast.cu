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
// Design.  Phase 0 is chain.cu's: the CTA mixes its span with its T−1 halo
// (chain.cuh chain_fill, nco.cuh mix_span); the store splits each sample
// (__float2bfloat16_rn, __fsub_rn, __float2bfloat16_rn) into four bf16
// planes I_h, I_l, Q_h, Q_l, a group of four samples as one 8-byte store a
// plane, and the entries before the carry or past the chunk are zeros.  It
// also lays the taps out as the mma's B fragments.  Phase 1 is the banded
// bf16 mma.sync dot of fast_dot.cuh (its design, bytes and NaN reach are
// written there) over the CTA's tile of windows, which starts at a multiple
// of 16 windows.  So the bytes do not depend on the tile or the threads,
// nor on how the stream is cut into chunks of a multiple of 16 windows (any
// cut at the blocks of 2048 samples of the CLI, for Q ≤ 128).
//
// Bound on this card.  Bytes: 4 + 4·P/Q a sample (i16 words in, words
// out), plan words, banks and carries, at 3.35 TB/s; operations: the
// float32 mix (29 a sample, nco.cuh) at 67 TFLOP/s, and the split3 dot
// (3 passes × I and Q × 2·T·P/Q a sample) at 989 TFLOP/s bf16.  At config 3
// (P/Q = 3/64, T = 370), B = 16384, L = 2048: 140.5 MB → 0.0419 ms, mix
// 0.0145 ms, dot 0.0070 ms: bound by bytes (chip_smoke.py computes it).  The
// banded form multiplies K·8 entries a window for P·T useful taps: 416·8 /
// 1110 ≈ 3.0× the useful MACs at 3/64/370.  What the design spends: the mix
// is chain.cu's ≈ 60 instructions a sample plus the split; the A fragments
// are 2 KB a warp and k-step from shared memory, conflict-free (a plane
// holds a pad of 8 entries after every Q ≥ 16, so the 8 rows of an ldmatrix
// phase meet 8 different bank groups); every CTA builds G's fragments
// (13 KB at config 3) from the two bf16 banks.  __launch_bounds__(256, 3):
// the picked CTA (96 windows, 192 threads, 70 KB) is three an SM by its
// shared memory, so the registers (up to 85) cost no warps.
#include "chain.cuh"
#include "fast_dot.cuh"

namespace doppler {

struct FastArgs : FastDot {
    int C, B, L;
    int wt;                 // windows a tile: a multiple of 16
    int n_tiles;
    int vec4;               // the input takes 16-byte loads
    int out_f32;
    long long n_win, m_total;
    const float* carry_in;  // (C, 2, T−1)
    float* carry_out;       // (C, 2, T−1)
};

// Phase `ph` of the CTA for channel `ch`, unit `unit` (a tile of `wt`
// windows, or the channel's carry), thread `tid` of `nthreads`; true while
// a further phase follows (after a barrier).
template <bool kInF32, bool kOddQ, int kPasses>
__device__ __forceinline__ bool chain_fast_phase(
        const void* __restrict__ in, void* __restrict__ out,
        const uint32_t* __restrict__ plans, const FastArgs& g, int ch, int unit,
        int tid, int nthreads, int ph, unsigned* smem) {
    const int H = g.T - 1;
    plans += (size_t)ch * g.B;
    const size_t stride = (size_t)g.C * g.B;
    const float* carry_in = g.carry_in + (size_t)ch * 2 * H;

    if (unit == g.n_tiles) {                   // the carry CTA
        chain_carry<kInF32>(in, plans, stride, g.B, g.L, H, carry_in,
                            g.carry_out + (size_t)ch * 2 * H, tid, nthreads);
        return false;
    }
    const long long i0 = (long long)unit * g.wt;
    const int n_rows = (int)min64((long long)g.wt, g.n_win - i0);
    if (ph == 0) {
        fast_load_taps(smem, g, tid, nthreads);
        // span entry 0 is x[org]: Q·i0 is a multiple of 16 and org of 4,
        // so the groups of four the mix stores whole are 8-byte aligned
        const long long org = i0 * g.Q - H - g.lead;
        const long long end = org + g.Q * (g.wt - 1) + 16 * g.ks;   // past the span
        const long long n_in = (long long)g.B * g.L;
        SplitStore<kPasses> store{reinterpret_cast<uint16_t*>(smem + g.x_off), &g, org};
        chain_fill<kInF32>(max64(org, -H), min64(end, n_in) - 1, in, plans, stride,
                           g.B, g.L, g.vec4 != 0, H, carry_in, tid, nthreads, store);
        // before the carry (lead columns of the first tile) and past the
        // chunk: zeros, which only zero taps multiply
        for (long long n = org + tid; n < -H; n += nthreads) store(n, 0.0f, 0.0f);
        for (long long n = max64(org, n_in) + tid; n < end; n += nthreads)
            store(n, 0.0f, 0.0f);
        return true;
    }
    ChainSink sink{g.out_f32, out, g.m_total, g.C, ch};
    fast_items<kPasses, kOddQ>(g, smem, i0, n_rows, tid, nthreads, sink);
    return false;
}

// FastArgs from doppler_chain_fast's arguments (below); false where they
// are not ones the kernel takes.
inline bool make_fast_args(FastArgs& g, const void* in, const uint16_t* bank_h,
                           const uint16_t* bank_l, const float* carry_in,
                           float* carry_out, int C, int B, int L, int P, int Q,
                           int T, int wt, int plane, int g_off, int x_off,
                           int out_f32, long long smem) {
    g = FastArgs{};
    if (C <= 0 || B <= 0 || L <= 0 || !fast_derive(g, P, Q, T) || L % Q != 0 ||
        wt <= 0 || wt % 16)
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
    g.bank_h = bank_h;
    g.bank_l = bank_l;
    g.carry_in = carry_in;
    g.carry_out = carry_out;
    return fast_fits(g, (long long)Q * (wt - 1) + 16 * g.ks, smem);
}

}  // namespace doppler

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

using doppler::FastArgs;

// 256 threads, three CTAs an SM: up to 85 registers a thread (the picked
// CTAs take 192 threads, three an SM by their shared memory)
constexpr int kMaxThreads = 256;

template <bool kInF32, bool kOddQ, int kPasses>
__global__ void __launch_bounds__(kMaxThreads, 3)
chain_fast_kernel(const void* __restrict__ in, void* __restrict__ out,
                  const uint32_t* __restrict__ plans,
                  const __grid_constant__ FastArgs g) {
    extern __shared__ uint4 smem4[];
    unsigned* smem = reinterpret_cast<unsigned*>(smem4);
    int ch, unit;
    doppler::split_block(blockIdx.x, g.C, g.n_tiles + (g.T > 1), ch, unit);
    for (int ph = 0;; ++ph) {
        if (!doppler::chain_fast_phase<kInF32, kOddQ, kPasses>(
                in, out, plans, g, ch, unit, (int)threadIdx.x, (int)blockDim.x,
                ph, smem))
            break;
        __syncthreads();
    }
}

template <bool kInF32, bool kOddQ, int kPasses>
int launch(const void* in, void* out, const uint32_t* plans, const FastArgs& g,
           int threads, long long smem, cudaStream_t stream) {
    const long long grid = (long long)g.C * (g.n_tiles + (g.T > 1 ? 1 : 0));
    if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    auto kernel = chain_fast_kernel<kInF32, kOddQ, kPasses>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<(unsigned)grid, threads, (size_t)smem, stream>>>(in, out, plans, g);
    return (int)cudaGetLastError();
}

template <int kPasses>
int launch_any(const void* in, void* out, const uint32_t* plans, const FastArgs& g,
               int threads, long long smem, int in_f32, cudaStream_t s) {
    if (g.Q & 1)
        return in_f32 ? launch<true, true, kPasses>(in, out, plans, g, threads, smem, s)
                      : launch<false, true, kPasses>(in, out, plans, g, threads, smem, s);
    return in_f32 ? launch<true, false, kPasses>(in, out, plans, g, threads, smem, s)
                  : launch<false, false, kPasses>(in, out, plans, g, threads, smem, s);
}

}  // namespace

// in, out, plans, carry_in, carry_out: as doppler_chain (chain.cu); bank_h,
// bank_l: the (P, T) bank's bf16 halves (ops/precision.py split3_bank).  wt:
// windows a CTA (a multiple of 16); threads: a multiple of 32 up to 256;
// plane: bf16 entries of each of the four span planes; g_off, x_off: word
// offsets of the B fragments and of the planes in the `smem` bytes of
// dynamic shared memory, as ops/cuda/geometry.py fast_layout lays them out;
// passes: 3 (split3) or 1 (default).  Needs Q a power of two and
// L % Q == 0.  Returns cudaGetLastError() after the launch.
extern "C" int doppler_chain_fast(const void* in, void* out, const uint32_t* plans,
                                  const uint16_t* bank_h, const uint16_t* bank_l,
                                  const float* carry_in, float* carry_out, int C,
                                  int B, int L, int P, int Q, int T, int wt,
                                  int threads, int plane, int g_off, int x_off,
                                  long long smem, int in_f32, int out_f32,
                                  int passes, void* stream) {
    FastArgs g;
    if (threads < 32 || threads > kMaxThreads || threads % 32 || smem <= 0 ||
        (passes != 1 && passes != 3) ||
        !doppler::make_fast_args(g, in, bank_h, bank_l, carry_in, carry_out, C,
                                 B, L, P, Q, T, wt, plane, g_off, x_off, out_f32,
                                 smem))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return passes == 1 ? launch_any<1>(in, out, plans, g, threads, smem, in_f32, s)
                       : launch_any<3>(in, out, plans, g, threads, smem, in_f32, s);
}

#endif  // __CUDACC__
