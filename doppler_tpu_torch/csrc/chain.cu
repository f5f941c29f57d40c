// Fused chain kernel: decode → NCO mix → P/Q polyphase FIR → encode.
//
// Replaces doppler_tpu/ops/pallas/chain.py:240 _make_kernel (with its mix
// front _make_mix_front, chain.py:145, and banded-matmul reduction
// _acc_slices, chain.py:191), reached through
// mix_resample_chain_pallas_stream (chain.py:404).
//
// Computes, for chunk-local output m,
//     y[m] = Σ_{l<T} bank[(m·Q) mod P, l] · x[⌊m·Q/P⌋ − l]
// where x is the mixed stream of the chunk and x[k < 0] is read from the
// (2, T−1) carry of the previous chunk.  Also returns the new carry: the
// last T−1 samples of [carry | x].
//
// Design.  The TPU kernel walks its grid in order and carries the FIR
// history in scratch from one grid step to the next; a GPU grid runs in
// parallel, so that carry would race.  Here every CTA owns a tile of
// outputs and mixes its own input span plus a T−1-sample halo into shared
// memory.  Re-mixing the halo from the raw words is exact because the
// phase is a pure function of the plan words and the sample index, so the
// halo holds bitwise the values the neighbouring CTA mixes.  Only CTAs
// whose span reaches before the chunk (the first) read carry_in; one extra
// CTA writes carry_out.  Each thread computes one output as a sequential
// __fmaf_rn over l = 0..T−1 in fixed order, so the bytes do not depend on
// the tile size or on how the stream is split into chunks.
//
// Bound: at config 3 (P/Q = 3/64, T = 370) the traffic is 4 + 4·3/64 ≈ 4.19
// B per input sample and the FIR is 2·370·3/64 ≈ 35 FMA per input sample,
// plus the ~13% of samples a CTA re-mixes for its halo.  A tile of 128
// outputs spans ≈ 2731 inputs + 369 halo: ≈ 25 KB of float32 I/Q in
// shared memory beside the (3, 370) bank (4.4 KB).
//
// Shared-memory banks: the 32 lanes of a warp read x[⌊mQ/P⌋ − l] for 32
// consecutive m.  At P/Q = 3/64 those indices are 64k + {0, 21, 42}, which
// fall in only 3 of the 32 banks (an 11-way conflict per load).  The spans
// are therefore stored with one pad word after every 32 samples
// (padded(k) = k + k/32), which spreads the same reads over the banks with
// at most a 2-way conflict.  The padding moves data, not arithmetic: the
// bytes are unchanged.
#include <cuda_runtime.h>

#include "nco.cuh"

namespace {

// shared memory: the (P, T) bank, then the I and Q spans, each holding up
// to span_cap samples at padded positions (span_words floats)
long long span_cap(int tile_m, int P, int Q, int T) {
    return ((long long)(tile_m - 1) * Q + P - 1) / P + T;
}

long long span_words(int tile_m, int P, int Q, int T) {
    const long long cap = span_cap(tile_m, P, Q, T);
    return cap + cap / 32 + 1;
}

long long smem_bytes(int tile_m, int P, int Q, int T) {
    return 4 * ((long long)P * T + 2 * span_words(tile_m, P, Q, T));
}

__device__ __forceinline__ int padded(int k) { return k + (k >> 5); }

// Mixed sample at chunk index g (g < 0: the carry).
template <bool kInF32>
__device__ __forceinline__ void mixed_at(long long g, const void* __restrict__ in,
                                         const uint32_t* __restrict__ plans,
                                         const float* __restrict__ carry_in,
                                         int B, int L, int H, int& cur,
                                         doppler::Plan& p, float& oi, float& oq) {
    if (g < 0) {
        oi = carry_in[H + g];
        oq = carry_in[2 * H + g];
        return;
    }
    doppler::mix_at<kInF32>(g, in, plans, B, L, cur, p, oi, oq);
}

template <bool kInF32, bool kOutF32>
__global__ void chain_kernel(const void* __restrict__ in, void* __restrict__ out,
                             const uint32_t* __restrict__ plans,
                             const float* __restrict__ bank,
                             const float* __restrict__ carry_in,
                             float* __restrict__ carry_out,
                             int B, int L, int P, int Q, int T,
                             long long m_total, int n_tiles, int words) {
    extern __shared__ float smem[];
    const int H = T - 1;
    const long long n_in = (long long)B * L;
    int cur = -1;
    doppler::Plan p;

    if ((int)blockIdx.x == n_tiles) {          // the carry CTA
        for (int k = threadIdx.x; k < H; k += blockDim.x) {
            float oi, oq;
            mixed_at<kInF32>(n_in - H + k, in, plans, carry_in, B, L, H, cur,
                             p, oi, oq);
            carry_out[k] = oi;
            carry_out[H + k] = oq;
        }
        return;
    }

    float* bank_s = smem;
    float* xs_i = smem + P * T;
    float* xs_q = xs_i + words;
    for (int k = threadIdx.x; k < P * T; k += blockDim.x) bank_s[k] = bank[k];

    const long long m0 = (long long)blockIdx.x * blockDim.x;
    const long long m_end = min(m0 + (long long)blockDim.x, m_total);
    const long long s0 = m0 * Q / P - H;       // first input of the span
    const int count = (int)((m_end - 1) * Q / P - s0 + 1);
    for (int k = threadIdx.x; k < count; k += blockDim.x) {
        mixed_at<kInF32>(s0 + k, in, plans, carry_in, B, L, H, cur, p,
                         xs_i[padded(k)], xs_q[padded(k)]);
    }
    __syncthreads();

    const long long m = m0 + threadIdx.x;
    if (m >= m_end) return;
    const long long u = m * Q;
    const long long nm = u / P;
    const float* w = bank_s + (int)(u - nm * P) * T;
    const int base = (int)(nm - s0);            // x[nm − l] is span[base − l]
    float ai = 0.0f, aq = 0.0f;
    for (int l = 0; l < T; ++l) {
        const int k = padded(base - l);
        ai = __fmaf_rn(w[l], xs_i[k], ai);
        aq = __fmaf_rn(w[l], xs_q[k], aq);
    }
    if (kOutF32) {
        static_cast<float*>(out)[m] = ai;
        static_cast<float*>(out)[m_total + m] = aq;
    } else {
        static_cast<int*>(out)[m] = doppler::pack_i16(ai, aq);
    }
}

template <bool kInF32, bool kOutF32>
int launch(const void* in, void* out, const uint32_t* plans, const float* bank,
           const float* carry_in, float* carry_out, int B, int L, int P, int Q,
           int T, int tile_m, cudaStream_t stream) {
    const long long m_total = (long long)B * L / Q * P;
    const int n_tiles = (int)((m_total + tile_m - 1) / tile_m);
    const int grid = n_tiles + (T > 1 ? 1 : 0);
    const long long smem = smem_bytes(tile_m, P, Q, T);
    auto kernel = chain_kernel<kInF32, kOutF32>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<grid, tile_m, (size_t)smem, stream>>>(
        in, out, plans, bank, carry_in, carry_out, B, L, P, Q, T, m_total,
        n_tiles, (int)span_words(tile_m, P, Q, T));
    return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one CTA of `tile_m` outputs needs; the wrapper
// sizes its tile with it.
extern "C" long long doppler_chain_smem_bytes(int tile_m, int P, int Q, int T) {
    return smem_bytes(tile_m, P, Q, T);
}

// in: int32 words (B, L) or float32 planes (2, B, L); out: int32 words
// (B·L·P/Q) or float32 planes (2, B·L·P/Q); plans: (7, B) uint32;
// bank: (P, T) float32; carry_in/carry_out: (2, T−1) float32.
// Needs L % Q == 0.  Returns cudaGetLastError() after the launch.
extern "C" int doppler_chain(const void* in, void* out, const uint32_t* plans,
                             const float* bank, const float* carry_in,
                             float* carry_out, int B, int L, int P, int Q,
                             int T, int tile_m, int in_f32, int out_f32,
                             void* stream) {
    if (B <= 0 || L <= 0 || P <= 0 || Q <= 0 || T <= 0 || L % Q != 0 ||
        tile_m <= 0 || tile_m > 1024)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (in_f32) {
        return out_f32 ? launch<true, true>(in, out, plans, bank, carry_in,
                                            carry_out, B, L, P, Q, T, tile_m, s)
                       : launch<true, false>(in, out, plans, bank, carry_in,
                                             carry_out, B, L, P, Q, T, tile_m, s);
    }
    return out_f32 ? launch<false, true>(in, out, plans, bank, carry_in,
                                         carry_out, B, L, P, Q, T, tile_m, s)
                   : launch<false, false>(in, out, plans, bank, carry_in,
                                          carry_out, B, L, P, Q, T, tile_m, s);
}
