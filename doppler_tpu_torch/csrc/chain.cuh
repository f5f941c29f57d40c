// What the two chain kernels share: the exact one (chain.cu, float32 FMA
// dots) and the one of --precision fast (chain_fast.cu, bf16 tensor-core
// dots).  Both mix the same span with its halo, read x[k < 0] from the same
// carry, write the same carry (the last T−1 mixed samples) from one extra
// CTA a channel, and store outputs the same way; so under --precision fast
// the carry is bitwise the exact kernel's.
#pragma once

#include "nco.cuh"

namespace doppler {

// Where the outputs go: planes (2, C, m_total) or i16 words (C, m_total).
struct ChainSink {
    int out_f32;
    void* out;
    long long m_total;
    int C, ch;
    __device__ __forceinline__ void put(long long m, float vi, float vq) const {
        if (out_f32) {
            static_cast<float*>(out)[ch * m_total + m] = vi;
            static_cast<float*>(out)[((long long)C + ch) * m_total + m] = vq;
        } else {
            static_cast<int*>(out)[ch * m_total + m] = pack_i16(vi, vq);
        }
    }
};

// The carry CTA of one channel: carry_out = the last H = T−1 samples of
// [carry_in | mixed chunk].  `plans` points at the channel's words, `stride`
// is C·B; carry_in/carry_out at the channel's (2, H).
template <bool kInF32>
__device__ __forceinline__ void chain_carry(const void* __restrict__ in,
                                            const uint32_t* __restrict__ plans,
                                            size_t stride, int B, int L, int H,
                                            const float* __restrict__ carry_in,
                                            float* __restrict__ carry_out,
                                            int tid, int nthreads) {
    const long long n_in = (long long)B * L;
    int cur = -1;
    Plan pl;
    for (int k = tid; k < H; k += nthreads) {
        const long long n = n_in - H + k;
        float vi, vq;
        if (n < 0) {
            vi = carry_in[H + n];
            vq = carry_in[2 * H + n];
        } else {
            mix_at<kInF32>(n, in, plans, stride, B, L, cur, pl, vi, vq);
        }
        carry_out[k] = vi;
        carry_out[H + k] = vq;
    }
}

// x[lo .. last] of [carry_in | mixed chunk] (lo ≥ −H, last < B·L) into a
// span: store(n, i, q) once for every n, by some thread of the CTA.
template <bool kInF32, class Store>
__device__ __forceinline__ void chain_fill(long long lo, long long last,
                                           const void* __restrict__ in,
                                           const uint32_t* __restrict__ plans,
                                           size_t stride, int B, int L, bool vec4,
                                           int H, const float* __restrict__ carry_in,
                                           int tid, int nthreads, Store& store) {
    for (long long n = lo + tid; n < 0 && n <= last; n += nthreads)
        store(n, carry_in[H + n], carry_in[2 * H + n]);
    const long long first = lo > 0 ? lo : 0;
    if (last >= first)
        mix_span<kInF32>(first, last, in, plans, stride, B, L, vec4, tid,
                         nthreads, store);
}

}  // namespace doppler
