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
// Design.  The TPU kernel walks its grid in order and carries the FIR
// history in scratch from one grid step to the next; a GPU grid runs in
// parallel, so that carry would race.  Here every CTA owns a tile of
// outputs and mixes its own input span plus a T−1-sample halo into shared
// memory.  Re-mixing the halo from the raw words is exact because the
// phase is a pure function of the plan words and the sample index, so the
// halo holds bitwise the values the neighbouring CTA mixes.  Only CTAs
// whose span reaches before the chunk (the first) read carry_in; one extra
// CTA (per channel) writes carry_out.  Each thread computes one output as a sequential
// __fmaf_rn over l = 0..T−1 in fixed order, so the bytes do not depend on
// the tile size or on how the stream is split into chunks.
//
// Channels: C channels run the same (B, L) chunk, each with its own plan
// words (7, C, B) and its own carry (C, 2, T−1), into (C, n_out) words or
// (2, C, n_out) planes; a single stream is C = 1.  Every channel has its
// own tile CTAs and its own carry CTA; the channel is the fast index of the
// grid (nco.cuh split_block), so the C CTAs that mix one input span run
// together and the span comes from L2 after its first read.  Channel c's
// bytes are those of a C = 1 launch with its plan words and carry: the same
// code in the same order.  With C channels the work is C times the stream
// kernel's on one read of the input, so beyond a few channels the bound is
// the float32 rate (the mix and the FIR), not HBM.
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
                                         size_t stride,
                                         const float* __restrict__ carry_in,
                                         int B, int L, int H, int& cur,
                                         doppler::Plan& p, float& oi, float& oq) {
    if (g < 0) {
        oi = carry_in[H + g];
        oq = carry_in[2 * H + g];
        return;
    }
    doppler::mix_at<kInF32>(g, in, plans, stride, B, L, cur, p, oi, oq);
}

template <bool kInF32, bool kOutF32>
__global__ void chain_kernel(const void* __restrict__ in, void* __restrict__ out,
                             const uint32_t* __restrict__ plans,
                             const float* __restrict__ bank,
                             const float* __restrict__ carry_in,
                             float* __restrict__ carry_out,
                             int C, int B, int L, int P, int Q, int T,
                             long long m_total, int n_tiles, int words) {
    extern __shared__ float smem[];
    const int H = T - 1;
    const long long n_in = (long long)B * L;
    int cur = -1;
    doppler::Plan p;

    // this CTA's channel and unit: a tile of outputs, or the channel's carry
    int c, unit;
    doppler::split_block(blockIdx.x, C, n_tiles + (H > 0), c, unit);
    plans += (size_t)c * B;
    const size_t stride = (size_t)C * B;
    carry_in += (size_t)c * 2 * H;
    carry_out += (size_t)c * 2 * H;

    if (unit == n_tiles) {                     // the carry CTA
        for (int k = threadIdx.x; k < H; k += blockDim.x) {
            float oi, oq;
            mixed_at<kInF32>(n_in - H + k, in, plans, stride, carry_in, B, L,
                             H, cur, p, oi, oq);
            carry_out[k] = oi;
            carry_out[H + k] = oq;
        }
        return;
    }

    float* bank_s = smem;
    float* xs_i = smem + P * T;
    float* xs_q = xs_i + words;
    for (int k = threadIdx.x; k < P * T; k += blockDim.x) bank_s[k] = bank[k];

    const long long m0 = (long long)unit * blockDim.x;
    const long long m_end = min(m0 + (long long)blockDim.x, m_total);
    const long long s0 = m0 * Q / P - H;       // first input of the span
    const int count = (int)((m_end - 1) * Q / P - s0 + 1);
    for (int k = threadIdx.x; k < count; k += blockDim.x) {
        mixed_at<kInF32>(s0 + k, in, plans, stride, carry_in, B, L, H, cur, p,
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
        // output planes (2, C, m_total): Q sits C·m_total after I
        static_cast<float*>(out)[c * m_total + m] = ai;
        static_cast<float*>(out)[((long long)C + c) * m_total + m] = aq;
    } else {
        static_cast<int*>(out)[c * m_total + m] = doppler::pack_i16(ai, aq);
    }
}

template <bool kInF32, bool kOutF32>
int launch(const void* in, void* out, const uint32_t* plans, const float* bank,
           const float* carry_in, float* carry_out, int C, int B, int L, int P,
           int Q, int T, int tile_m, cudaStream_t stream) {
    const long long m_total = (long long)B * L / Q * P;
    const int n_tiles = (int)((m_total + tile_m - 1) / tile_m);
    const long long grid = (long long)C * (n_tiles + (T > 1 ? 1 : 0));
    if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    const long long smem = smem_bytes(tile_m, P, Q, T);
    auto kernel = chain_kernel<kInF32, kOutF32>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<(unsigned)grid, tile_m, (size_t)smem, stream>>>(
        in, out, plans, bank, carry_in, carry_out, C, B, L, P, Q, T, m_total,
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
// (C, B·L·P/Q) or float32 planes (2, C, B·L·P/Q); plans: (7, C, B) uint32;
// bank: (P, T) float32; carry_in/carry_out: (C, 2, T−1) float32.
// Needs L % Q == 0.  Returns cudaGetLastError() after the launch.
extern "C" int doppler_chain(const void* in, void* out, const uint32_t* plans,
                             const float* bank, const float* carry_in,
                             float* carry_out, int C, int B, int L, int P,
                             int Q, int T, int tile_m, int in_f32, int out_f32,
                             void* stream) {
    if (C <= 0 || B <= 0 || L <= 0 || P <= 0 || Q <= 0 || T <= 0 || L % Q != 0 ||
        tile_m <= 0 || tile_m > 1024)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DOPPLER_CHAIN_LAUNCH(IN, OUT)                                          \
    launch<IN, OUT>(in, out, plans, bank, carry_in, carry_out, C, B, L, P, Q,  \
                    T, tile_m, s)
    if (in_f32) {
        return out_f32 ? DOPPLER_CHAIN_LAUNCH(true, true)
                       : DOPPLER_CHAIN_LAUNCH(true, false);
    }
    return out_f32 ? DOPPLER_CHAIN_LAUNCH(false, true)
                   : DOPPLER_CHAIN_LAUNCH(false, false);
#undef DOPPLER_CHAIN_LAUNCH
}
