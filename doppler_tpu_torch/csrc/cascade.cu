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
// Design.  The TPU kernel walks its grid in order and keeps each stage's
// history in scratch; a GPU grid runs in parallel.  Here every CTA owns a
// span of indices at one "target" stage t and works the span back through
// the stages: x_{t−1} over the span's taps, x_{t−2} over those, …, down to
// the mixed samples, each level held in shared memory with its T_s−1 halo.
// Tile CTAs target the output (t = S, `tile` outputs each); carry CTAs
// target x_s at the end of the chunk (t = s, up to `tile` entries each) and
// write carry_out_s.  Every x_s value, whichever CTA computes it, is one
// sequential __fmaf_rn over l = 0..T−1 in fixed order from the same
// inputs, so the bytes depend neither on the tile size nor on how the
// stream is split into chunks.  No state passes between CTAs.
//
// Channels: C channels run the same (B, L) chunk, each with its own plan
// words (7, C, B) and its own carries (C, 2, T_s−1) per stage, into
// (C, n_out) words or (2, C, n_out) planes (the split front writes planes,
// so the tail stages see (C, n_out) rows); a single stream is C = 1.  Every
// channel has its own tile and carry CTAs; the per-stage pointers in the
// Geometry are channel 0's and a CTA adds its channel's stride 2·(T_s−1).
// The channel is the fast index of the grid (nco.cuh split_block), so the C
// CTAs that mix one input span run together and find it in L2.  Channel
// c's bytes are those of a C = 1 launch with its plan words and carries.
// With C channels the work is C times the stream kernel's on one read of
// the input: beyond a few channels the bound is the float32 rate.
//
// Bound: at config 3 (÷8 with T = 65, then 3/8 with T = 51) the traffic is
// 4 + 4·3/64 ≈ 4.19 B per input sample and the FIRs take
// 2·(65/8 + 51·3/64) ≈ 21 FMA per input sample; a 128-output tile spans
// ≈ 2731 inputs plus the input-referred halo Σ_s (T_s−1)·∏_{i<s} Q_i/P_i =
// 64 + 50·8 = 464 (≈ 17% re-mixed), ≈ 30 KB of shared memory.  The split
// front at 100 Msps (÷16 T = 85, ÷16 T = 95) spans ≈ 34 K inputs per 128
// outputs (≈ 300 KB), so the wrapper shrinks the tile until the CTA fits
// (doppler_cascade_smem_bytes).
//
// Shared-memory banks: spans are stored with one pad word after every 32
// samples (padded(k) = k + k/32, as in chain.cu).  For the strides of the
// cascades here (q ∈ {2, 4, 8, 16} and 3/8) a warp's 32 reads of
// x[⌊mQ/P⌋ − l] then meet at most 2 addresses per bank for every alignment
// of the warp's first index (unpadded: up to q-way).  The padding moves
// data, not arithmetic.
#include <cuda_runtime.h>

#include <algorithm>

#include "nco.cuh"

namespace {

constexpr int kMaxStages = 4;
constexpr int kThreads = 128;

struct Stage {
    int P, Q, T;
    int bank_off;          // float offset of the (P, T) bank in shared memory
    int buf_off;           // float offset of the I span (Q span follows)
    int buf_words;         // padded floats per span plane
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
    int bank_words;
    long long n_out;
    Stage st[kMaxStages];
};

// Samples of x_s a span of c entries of x_{s+1} reads, at most (its taps
// plus the stride's rounding).
long long span_back(long long c, int P, int Q, int T) {
    return ((c - 1) * Q + P - 1) / P + T;
}

long long words_for(long long cap) { return cap + cap / 32 + 1; }

// Fills g (offsets, caps, grid) from the stage list; returns the dynamic
// shared memory one CTA needs, or −1 when the geometry is refused.
long long plan_geometry(const int* pqt, int S, long long n0, int tile,
                        Geometry& g) {
    if (S < 1 || S > kMaxStages || tile < 1 || n0 <= 0) return -1;
    g.S = S;
    g.tile = tile;
    long long n = n0;
    int bank_words = 0;
    for (int s = 0; s < S; ++s) {
        Stage& st = g.st[s];
        st.P = pqt[3 * s];
        st.Q = pqt[3 * s + 1];
        st.T = pqt[3 * s + 2];
        if (st.P <= 0 || st.Q <= 0 || st.T <= 0 || n % st.Q) return -1;
        st.n_in = n;
        st.bank_off = bank_words;
        bank_words += st.P * st.T;
        n = n / st.Q * st.P;
        g.carry_ctas[s] = (st.T - 1 + tile - 1) / tile;
    }
    g.n_out = n;
    g.n_tiles = (int)((n + tile - 1) / tile);
    g.units = g.n_tiles;
    for (int s = 0; s < S; ++s) g.units += g.carry_ctas[s];
    g.bank_words = bank_words;
    // span caps: the largest span of x_s any CTA holds — the output tile's
    // or a carry CTA's, whichever reaches further back
    long long cap[kMaxStages] = {0};
    for (int t = 1; t <= S; ++t) {
        long long c = t == S ? tile : std::min<long long>(tile, g.st[t].T - 1);
        for (int s = t - 1; s >= 0 && c > 0; --s) {
            c = span_back(c, g.st[s].P, g.st[s].Q, g.st[s].T);
            cap[s] = std::max(cap[s], c);
        }
    }
    long long off = bank_words;
    for (int s = 0; s < S; ++s) {
        g.st[s].buf_off = (int)off;
        g.st[s].buf_words = (int)words_for(cap[s]);
        off += 2 * words_for(cap[s]);
    }
    return 4 * off;
}

__device__ __forceinline__ int padded(int k) { return k + (k >> 5); }

// x_{s+1}[j] for j ≥ 0 from the shared span of x_s starting at index lo.
__device__ __forceinline__ void fir_at(long long j, const Stage& st,
                                       const float* __restrict__ smem,
                                       long long lo, float& oi, float& oq) {
    const long long u = j * st.Q;
    const long long nm = u / st.P;
    const float* w = smem + st.bank_off + (int)(u - nm * st.P) * st.T;
    const float* xi = smem + st.buf_off;
    const float* xq = xi + st.buf_words;
    const int base = (int)(nm - lo);          // x_s[nm − l] is span[base − l]
    float ai = 0.0f, aq = 0.0f;
    for (int l = 0; l < st.T; ++l) {
        const int k = padded(base - l);
        ai = __fmaf_rn(w[l], xi[k], ai);
        aq = __fmaf_rn(w[l], xq[k], aq);
    }
    oi = ai;
    oq = aq;
}

template <bool kInF32, bool kOutF32>
__global__ void __launch_bounds__(kThreads)
cascade_kernel(const void* __restrict__ in, void* __restrict__ out,
               const uint32_t* __restrict__ plans,
               const __grid_constant__ Geometry g, int B, int L) {
    extern __shared__ float smem[];
    int cur = -1;
    doppler::Plan p;

    // this CTA's channel, and its unit of that channel's work
    int ch, bid;
    doppler::split_block(blockIdx.x, g.C, g.units, ch, bid);
    plans += (size_t)ch * B;
    const size_t stride = (size_t)g.C * B;

    // the unit's target: stage t, indices a .. a+c−1 of x_t (x_S = output)
    int t = g.S;
    long long a, c;
    if (bid < g.n_tiles) {
        a = (long long)bid * g.tile;
        c = min((long long)g.tile, g.n_out - a);
    } else {
        bid -= g.n_tiles;
        for (t = 0; t < g.S && bid >= g.carry_ctas[t]; ++t) bid -= g.carry_ctas[t];
        const int H = g.st[t].T - 1;
        a = g.st[t].n_in - H + (long long)bid * g.tile;
        c = min((long long)g.tile, (long long)H - (long long)bid * g.tile);
    }

    for (int s = 0; s < g.S; ++s) {
        const Stage& st = g.st[s];
        for (int k = threadIdx.x; k < st.P * st.T; k += blockDim.x)
            smem[st.bank_off + k] = st.bank[k];
    }

    // spans back through the stages: x_s over [lo[s], hi[s]]; only indices
    // ≥ 0 of x_{s+1} are computed, the rest come from carry_{s+1}
    long long lo[kMaxStages], hi[kMaxStages];
    {
        long long l = a, h = a + c - 1;
        for (int s = t - 1; s >= 0; --s) {
            const Stage& st = g.st[s];
            if (h < 0) {
                lo[s] = 0;
                hi[s] = -1;
            } else {
                lo[s] = max(l, 0LL) * st.Q / st.P - (st.T - 1);
                hi[s] = h * st.Q / st.P;
            }
            l = lo[s];
            h = hi[s];
        }
    }

    // x_s spans, lowest stage first
    for (int s = 0; s < t; ++s) {
        const Stage& st = g.st[s];
        const int H = st.T - 1;
        float* xi = smem + st.buf_off;
        float* xq = xi + st.buf_words;
        const int count = (int)(hi[s] - lo[s] + 1);
        for (int k = threadIdx.x; k < count; k += blockDim.x) {
            const long long j = lo[s] + k;
            float vi, vq;
            if (j < 0) {
                const float* carry = st.carry_in + (size_t)ch * 2 * H;
                vi = carry[H + j];
                vq = carry[2 * H + j];
            } else if (s == 0) {
                doppler::mix_at<kInF32>(j, in, plans, stride, B, L, cur, p, vi, vq);
            } else {
                fir_at(j, g.st[s - 1], smem, lo[s - 1], vi, vq);
            }
            xi[padded(k)] = vi;
            xq[padded(k)] = vq;
        }
        __syncthreads();
    }

    // the target entries
    for (int k = threadIdx.x; k < c; k += blockDim.x) {
        const long long j = a + k;
        float vi, vq;
        if (t < g.S && j < 0) {
            const Stage& st = g.st[t];
            const int H = st.T - 1;
            const float* carry = st.carry_in + (size_t)ch * 2 * H;
            vi = carry[H + j];
            vq = carry[2 * H + j];
        } else if (t == 0) {
            doppler::mix_at<kInF32>(j, in, plans, stride, B, L, cur, p, vi, vq);
        } else {
            fir_at(j, g.st[t - 1], smem, lo[t - 1], vi, vq);
        }
        if (t < g.S) {
            const Stage& st = g.st[t];
            const int H = st.T - 1;
            const int r = (int)(j - (st.n_in - H));
            float* carry = st.carry_out + (size_t)ch * 2 * H;
            carry[r] = vi;
            carry[H + r] = vq;
        } else if (kOutF32) {
            // output planes (2, C, n_out): Q sits C·n_out after I
            static_cast<float*>(out)[ch * g.n_out + j] = vi;
            static_cast<float*>(out)[((long long)g.C + ch) * g.n_out + j] = vq;
        } else {
            static_cast<int*>(out)[ch * g.n_out + j] = doppler::pack_i16(vi, vq);
        }
    }
}

template <bool kInF32, bool kOutF32>
int launch(const void* in, void* out, const uint32_t* plans, const Geometry& g,
           long long smem, int B, int L, cudaStream_t stream) {
    const long long grid = (long long)g.C * g.units;
    if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    auto kernel = cascade_kernel<kInF32, kOutF32>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<(unsigned)grid, kThreads, (size_t)smem, stream>>>(in, out, plans,
                                                               g, B, L);
    return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one CTA needs for final tiles of `tile` outputs
// over the S stages `pqt` = (P, Q, T) × S, when each stage's chunk input
// count is a multiple of its Q (n0 = a count that satisfies this); −1 for
// a refused geometry.  The wrapper sizes its tile with it.
extern "C" long long doppler_cascade_smem_bytes(const int* pqt, int S,
                                                long long n0, int tile) {
    Geometry g;
    return plan_geometry(pqt, S, n0, tile, g);
}

// in: int32 words (B, L) or float32 planes (2, B, L); out: int32 words
// (C, n_out) or float32 planes (2, C, n_out), n_out = B·L·∏P_s/∏Q_s; plans:
// (7, C, B) uint32; banks[s]: (P_s, T_s) float32; carry_in[s], carry_out[s]:
// (C, 2, T_s−1) float32.  Needs every stage's chunk input count to be a
// multiple of its Q.  Returns cudaGetLastError() after the launch.
extern "C" int doppler_cascade(const void* in, void* out, const uint32_t* plans,
                               const void* const* banks,
                               const void* const* carry_in,
                               void* const* carry_out, const int* pqt, int S,
                               int C, int B, int L, int tile, int in_f32,
                               int out_f32, void* stream) {
    if (C <= 0 || B <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
    Geometry g;
    const long long smem = plan_geometry(pqt, S, (long long)B * L, tile, g);
    if (smem < 0) return (int)cudaErrorInvalidValue;
    g.C = C;
    for (int s = 0; s < S; ++s) {
        g.st[s].bank = static_cast<const float*>(banks[s]);
        g.st[s].carry_in = static_cast<const float*>(carry_in[s]);
        g.st[s].carry_out = static_cast<float*>(carry_out[s]);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (in_f32) {
        return out_f32 ? launch<true, true>(in, out, plans, g, smem, B, L, st)
                       : launch<true, false>(in, out, plans, g, smem, B, L, st);
    }
    return out_f32 ? launch<false, true>(in, out, plans, g, smem, B, L, st)
                   : launch<false, false>(in, out, plans, g, smem, B, L, st);
}
