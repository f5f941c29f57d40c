// Fused cascade kernel of dot_precision 'split3' and 'default': decode →
// NCO mix → S polyphase FIR stages, each a bf16 tensor-core dot → encode.
//
// Replaces the dot_precision='split3' and 'default' branches of
// doppler_tpu/ops/pallas/chain.py:768 _make_cascade_kernel (every stage
// through _acc_slices, chain.py:191-237, chain.py:819-820, on taps split by
// split3_taps, chain.py:1021-1022), reached through
// mix_cascade_pallas_stream (chain.py:960).  The channel-batched cascade
// (chain.py:1078) has no dot_precision, and neither has this kernel a
// channel axis.
//
// Computes, for each fused stage s = 0..S−1 and chunk-local index m,
//     x_{s+1}[m] = Σ_{l<T_s} x_h·t_h + x_h·t_l + x_l·t_h   ('split3')
//     x_{s+1}[m] = Σ_{l<T_s} x_h·t_h                        ('default')
// over x = x_s[⌊m·Q_s/P_s⌋ − l] and the taps of bank_s row (m·Q_s) mod P_s,
// each split into bf16-exact halves (ops/precision.py), with float32
// accumulation: stage s+1's input is stage s's float32 sum, split again, as
// the TPU kernel's rows_i = acc[:G] are (chain.py:822-824).  x_0 is the
// mixed stream and x_s[k < 0] comes from the (2, T_s−1) carry of stage s.
// Carry_out_s is the last T_s−1 entries of [carry_s | x_s]: for s = 0 the
// mixed samples, bitwise the exact kernel's (cascade.cu); for s ≥ 1 this
// kernel's own x_s values, as the TPU kernel's scratch rows hold its own
// (chain.py:810-817), not the exact kernel's.  The output is x_S, encoded
// to i16 words or as float32 planes (the split cascade's ÷2^k front).
//
// Design.  cascade.cu's span recursion with fast_dot.cuh's dot at every
// stage.  Every CTA owns a target, `wt` windows of the last stage's outputs
// (tile CTAs) or up to `wt` entries at the end of x_t (the carry CTAs of
// stage t), and works it back through the stages: the windows of stage s
// that its needed outputs fall in, rounded out to whole M-tiles of 16
// windows that start at a multiple of 16, read a span of x_s (the band of
// every such window, K_s = 16·ks entries from x_s[Q·i − (T−1) − lead]);
// that span is what stage s−1 must give, and so on down to the mixed
// samples.  Thread 0 plans the spans (64-bit divisions); then the CTA runs
// t + 1 phases with a barrier between them.  Phase 0 lays every stage's
// taps out as B fragments and fills the span of x_0: zeros before the
// carry, the carry, the mix (chain.cuh chain_fill, nco.cuh mix_span, split
// as it is stored), zeros past the chunk.  Phase s fills the span of x_s:
// the same zeros and carry, and stage s−1's dot over its M-tiles, whose
// outputs that the span holds are split and stored into its four bf16
// planes; the M-tiles' other rows (the few windows of the rounding) are
// computed and dropped.  Phase t runs stage t−1's dot into the target: the
// output, or carry_out_t.  Between stages the float32 outputs live as four
// bf16 planes, the same 8 B a sample as the two float32 planes of
// cascade.cu.
//
// Bytes.  A tensor core gives no promise across the rows of its tile, so
// every x_s value must come from the same row, column and k-steps in every
// CTA that computes it.  Every CTA computes stage s in M-tiles that start
// at a multiple of 16 windows of that stage's chunk-local grid, and the
// wrapper refuses a chunk in which any stage's window count (chunk input
// count / Q_s) is not a multiple of 16 (ops/cuda/cascade.py): so a
// window's row is its index mod 16 of the stream's absolute grid in every
// cut of the stream into such chunks, and bytes and carries do not depend
// on the tile, the threads or the cut.  (At config 3 a block of 2048
// samples has 256 and 32 windows, any block count passes; at the 100 Msps
// front 128 and 8: an even block count.)  A band entry is a function of
// its index alone: a sample, a carry entry, or a zero before the carry or
// past the chunk, which only zero taps or dropped rows read.
//
// NaN.  As fast_dot.cuh: a NaN or ±∞ in x_s reaches every output of stage s
// whose window's band of K_s samples holds it, and from there every later
// stage's band; ±∞ splits into x_l = NaN.
//
// Bound on this card.  Bytes: 4 + 4·P/Q a sample (i16 words in, words
// out), plan words, banks and carries, at 3.35 TB/s; operations: the
// float32 mix (29 a sample, nco.cuh) at 67 TFLOP/s, and the dot (passes ×
// I and Q × 2·T_s·P_s/Q_s a stage input sample) at 989 TFLOP/s bf16.  At
// config 3 (÷8 T = 65, 3/8 T = 51), B = 16384, L = 2048: ≈ 140.5 MB →
// 0.042 ms, mix 0.0145 ms, the three-pass dot ≈ 126 operations a sample,
// 0.004 ms: bound by bytes (chip_smoke.py computes it).  What the design
// spends: the P phases of a window sit in the mma's 8 columns, so a P = 1
// stage uses 1 column of 8, and the band multiplies K·8 entries a window
// for P·T useful taps: 80·8/65 ≈ 9.8× the useful MACs at ÷8 T = 65, 64·8/153
// ≈ 3.3× at 3/8 T = 51, 9.0× and 9.4× at the front's ÷16 stages (a layout
// with 8 neighbouring windows as the 8 columns is a later redesign); the
// rounding to M-tiles and the K-wide bands widen every span, so a CTA
// re-mixes more halo than cascade.cu's (ops/cuda/geometry.py sizes it);
// every CTA lays out every stage's B fragments.  __launch_bounds__(256, 3):
// up to 85 registers a thread; the geometry picks the largest tile that
// leaves three CTAs an SM by shared memory, else two.
#include "chain.cuh"
#include "fast_dot.cuh"

namespace doppler {

constexpr int kFastStages = 4;

struct FastStage {
    FastDot d;
    long long n_in;          // chunk input count of this stage
    const float* carry_in;   // (2, T−1)
    float* carry_out;        // (2, T−1)
};

struct FastCascade {
    int S, B, L;
    int wt;                          // last-stage windows a tile CTA: 16·k
    int n_tiles;
    int units;                       // CTAs: tiles + carry CTAs
    int carry_ctas[kFastStages];     // ⌈(T_s−1)/wt⌉
    int vec4;                        // the input takes 16-byte loads
    int out_f32;
    long long n_out;
    FastStage st[kFastStages];
};

// What a CTA works on: its target (stage t, entries a .. a+c−1 of x_t; x_S
// = the output) and, for each stage s < t, the outputs ja .. jb it keeps
// (entries of x_{s+1}), its M-tiles (`rows` windows from window w0, a
// multiple of 16) and the span of x_s they read (`len` entries from x_s
// index org).
struct FastCtaPlan {
    int t;
    long long a, c;
    long long ja[kFastStages], jb[kFastStages];
    long long w0[kFastStages], org[kFastStages];
    int rows[kFastStages], len[kFastStages];
};

__device__ __forceinline__ void fast_cascade_plan(const FastCascade& g,
                                                  unsigned block, FastCtaPlan& p) {
    int bid = (int)block;
    p.t = g.S;
    if (bid < g.n_tiles) {
        const long long P = g.st[g.S - 1].d.P;
        p.a = (long long)bid * g.wt * P;
        p.c = min64((long long)g.wt * P, g.n_out - p.a);
    } else {
        bid -= g.n_tiles;
        for (p.t = 0; p.t < g.S && bid >= g.carry_ctas[p.t]; ++p.t)
            bid -= g.carry_ctas[p.t];
        const int H = g.st[p.t].d.T - 1;
        p.a = g.st[p.t].n_in - H + (long long)bid * g.wt;
        p.c = min64((long long)g.wt, (long long)H - (long long)bid * g.wt);
    }
    long long ja = max64(p.a, 0), jb = p.a + p.c - 1;
    for (int s = p.t - 1; s >= 0; --s) {
        const FastDot& d = g.st[s].d;
        p.ja[s] = ja;
        p.jb[s] = jb;
        if (jb < ja) {
            p.w0[s] = p.org[s] = 0;
            p.rows[s] = p.len[s] = 0;
            continue;
        }
        const long long i_hi = div_nonneg(jb, d.P);
        p.w0[s] = div_nonneg(ja, d.P) & ~15LL;
        p.rows[s] = (int)((i_hi - p.w0[s] + 16) & ~15LL);
        p.org[s] = p.w0[s] * d.Q - (d.T - 1) - d.lead;
        p.len[s] = d.Q * (p.rows[s] - 1) + 16 * d.ks;
        ja = max64(p.org[s], 0);
        jb = min64(p.org[s] + p.len[s], g.st[s].n_in) - 1;
    }
}

// Stage s−1's outputs into the span of x_s: those the span holds.
template <int kPasses>
struct FastSpanSink {
    SplitStore<kPasses> store;
    long long ja, jb;
    __device__ __forceinline__ void put(long long j, float vi, float vq) const {
        if (j >= ja && j <= jb) store(j, vi, vq);
    }
};

// The target's outputs: carry_out (2, H) from x index `first`, float32
// planes (2, n_out) or i16 words (n_out).
struct FastTargetSink {
    int mode;               // 1 carry, 2 float32 planes, 3 i16 words
    long long ja, jb;
    float* carry;
    int H;
    long long first;
    void* out;
    long long n_out;
    __device__ __forceinline__ void put(long long j, float vi, float vq) const {
        if (j < ja || j > jb) return;
        if (mode == 1) {
            carry[j - first] = vi;
            carry[H + (j - first)] = vq;
        } else if (mode == 2) {
            static_cast<float*>(out)[j] = vi;
            static_cast<float*>(out)[n_out + j] = vq;
        } else {
            static_cast<int*>(out)[j] = pack_i16(vi, vq);
        }
    }
};

template <int kPasses, class Sink>
__device__ __forceinline__ void fast_stage_items(const FastDot& d,
                                                 const unsigned* __restrict__ smem,
                                                 long long w0, int rows, int tid,
                                                 int nthreads, Sink& sink) {
    if (d.Q & 1) {
        fast_items<kPasses, true>(d, smem, w0, rows, tid, nthreads, sink);
    } else {
        fast_items<kPasses, false>(d, smem, w0, rows, tid, nthreads, sink);
    }
}

// Phase `ph` of the CTA with plan `p`, for thread `tid` of `nthreads`; true
// while a further phase follows (after a barrier).
template <bool kInF32, int kPasses>
__device__ __forceinline__ bool fast_cascade_phase(
        const void* __restrict__ in, void* __restrict__ out,
        const uint32_t* __restrict__ plans, const FastCascade& g,
        const FastCtaPlan& p, int tid, int nthreads, int ph, unsigned* smem) {
    const int t = p.t;
    const size_t stride = (size_t)g.B;          // one channel
    if (ph < t) {
        // fill the span of x_ph
        if (ph == 0) {
            for (int s = 0; s < t; ++s) fast_load_taps(smem, g.st[s].d, tid, nthreads);
        }
        const FastStage& st = g.st[ph];
        if (p.rows[ph] == 0) return true;
        const int H = st.d.T - 1;
        const long long org = p.org[ph], end = org + p.len[ph];
        SplitStore<kPasses> store{reinterpret_cast<uint16_t*>(smem + st.d.x_off), &st.d,
                                  org};
        // before the carry (lead columns of window 0) and past the chunk:
        // zeros, which only zero taps and dropped rows multiply
        for (long long n = org + tid; n < -H && n < end; n += nthreads)
            store(n, 0.0f, 0.0f);
        for (long long n = max64(org, st.n_in) + tid; n < end; n += nthreads)
            store(n, 0.0f, 0.0f);
        if (ph == 0) {
            chain_fill<kInF32>(max64(org, -H), min64(end, st.n_in) - 1, in, plans,
                               stride, g.B, g.L, g.vec4 != 0, H, st.carry_in, tid,
                               nthreads, store);
            return true;
        }
        for (long long n = max64(org, -H) + tid; n < 0 && n < end; n += nthreads)
            store(n, st.carry_in[H + n], st.carry_in[2 * H + n]);
        const int s = ph - 1;
        if (p.rows[s] > 0) {
            FastSpanSink<kPasses> sink{store, p.ja[s], p.jb[s]};
            fast_stage_items<kPasses>(g.st[s].d, smem, p.w0[s], p.rows[s], tid,
                                      nthreads, sink);
        }
        return true;
    }

    // the target entries
    const long long a = p.a, c = p.c;
    FastTargetSink sink{};
    sink.ja = t > 0 ? p.ja[t - 1] : 0;
    sink.jb = t > 0 ? p.jb[t - 1] : -1;
    if (t == g.S) {
        sink.mode = g.out_f32 ? 2 : 3;
        sink.out = out;
        sink.n_out = g.n_out;
    } else {
        const FastStage& st = g.st[t];
        const int H = st.d.T - 1;
        sink.mode = 1;
        sink.carry = st.carry_out;
        sink.H = H;
        sink.first = st.n_in - H;
        for (long long j = a + tid; j < 0 && j < a + c; j += nthreads) {
            st.carry_out[j - sink.first] = st.carry_in[H + j];
            st.carry_out[H + j - sink.first] = st.carry_in[2 * H + j];
        }
        if (t == 0) {
            // the mixed samples, one at a time: bitwise cascade.cu's carry
            int cur = -1;
            Plan pl;
            for (long long j = max64(a, 0) + tid; j < a + c; j += nthreads) {
                float vi, vq;
                mix_at<kInF32>(j, in, plans, stride, g.B, g.L, cur, pl, vi, vq);
                st.carry_out[j - sink.first] = vi;
                st.carry_out[H + j - sink.first] = vq;
            }
            return false;
        }
    }
    if (p.rows[t - 1] > 0)
        fast_stage_items<kPasses>(g.st[t - 1].d, smem, p.w0[t - 1], p.rows[t - 1],
                                  tid, nthreads, sink);
    return false;
}

// The most entries of x_s any CTA's span holds (ops/cuda/geometry.py
// cascade_fast_spans computes the same): a tile CTA's last stage is `wt`
// windows; below it, and below a carry CTA's up to `wt` entries of x_t, a
// run of c needed outputs lies in ⌈(c−1)/P⌉ + 1 windows, 15 more where its
// first window rounds down to a multiple of 16, rounded up to M-tiles; its
// span is Q·(rows − 1) + K entries, each of which the stage below may have
// to give.
__host__ __device__ inline void fast_span_bound(const FastCascade& g,
                                                long long* need) {
    for (int s = 0; s < g.S; ++s) need[s] = 0;
    for (int t = 1; t <= g.S; ++t) {
        long long c = t == g.S ? (long long)g.wt * g.st[t - 1].d.P
                               : min64((long long)g.wt, (long long)g.st[t].d.T - 1);
        if (c <= 0) continue;
        for (int s = t - 1; s >= 0; --s) {
            const FastDot& d = g.st[s].d;
            const long long w = (c - 1 + d.P - 1) / d.P + 1;
            const long long rows = t == g.S && s == t - 1 ? g.wt : (w + 30) / 16 * 16;
            const long long len = (long long)d.Q * (rows - 1) + 16LL * d.ks;
            need[s] = max64(need[s], len);
            c = len;
        }
    }
}

// A FastCascade from doppler_cascade_fast's arguments (below); false where
// they are not ones the kernel takes.
inline bool make_fast_cascade(FastCascade& g, const void* in,
                              const void* const* banks_h, const void* const* banks_l,
                              const void* const* carry_in, void* const* carry_out,
                              const int* layout, int S, int B, int L, int wt,
                              int out_f32, long long smem) {
    g = FastCascade{};
    if (B <= 0 || L <= 0 || S < 1 || S > kFastStages || wt < 16 || wt % 16)
        return false;
    g.S = S;
    g.B = B;
    g.L = L;
    g.wt = wt;
    g.out_f32 = out_f32;
    g.vec4 = (L % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0) ? 1 : 0;
    long long n = (long long)B * L;
    g.units = 0;
    for (int s = 0; s < S; ++s) {
        FastStage& st = g.st[s];
        const int* v = layout + 6 * s;
        if (!fast_derive(st.d, v[0], v[1], v[2]) || n % st.d.Q || (n / st.d.Q) % 16)
            return false;
        st.d.plane = v[3];
        st.d.g_off = v[4];
        st.d.x_off = v[5];
        st.d.bank_h = static_cast<const uint16_t*>(banks_h[s]);
        st.d.bank_l = static_cast<const uint16_t*>(banks_l[s]);
        st.n_in = n;
        st.carry_in = static_cast<const float*>(carry_in[s]);
        st.carry_out = static_cast<float*>(carry_out[s]);
        g.carry_ctas[s] = (st.d.T - 1 + wt - 1) / wt;
        g.units += g.carry_ctas[s];
        n = n / st.d.Q * st.d.P;
    }
    g.n_out = n;
    const long long n_tiles = (n / g.st[S - 1].d.P + wt - 1) / wt;
    if (n_tiles + g.units > 0x7FFFFFFFLL) return false;
    g.n_tiles = (int)n_tiles;
    g.units += g.n_tiles;
    // every span fits its planes; no two stages' regions overlap
    long long need[kFastStages];
    fast_span_bound(g, need);
    for (int s = 0; s < S; ++s) {
        const FastDot& d = g.st[s].d;
        if (!fast_fits(d, need[s], smem)) return false;
        const long long lo[2] = {d.g_off, d.x_off};
        const long long hi[2] = {d.g_off + 128LL * d.ks * d.nt, d.x_off + 2LL * d.plane};
        for (int r = 0; r < s; ++r) {
            const FastDot& e = g.st[r].d;
            const long long lo2[2] = {e.g_off, e.x_off};
            const long long hi2[2] = {e.g_off + 128LL * e.ks * e.nt, e.x_off + 2LL * e.plane};
            for (int i = 0; i < 2; ++i)
                for (int k = 0; k < 2; ++k)
                    if (lo[i] < hi2[k] && lo2[k] < hi[i]) return false;
        }
    }
    return true;
}

}  // namespace doppler

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

using doppler::FastCascade;

// 256 threads, three CTAs an SM: up to 85 registers a thread
constexpr int kFastThreads = 256;

template <bool kInF32, int kPasses>
__global__ void __launch_bounds__(kFastThreads, 3)
cascade_fast_kernel(const void* __restrict__ in, void* __restrict__ out,
                    const uint32_t* __restrict__ plans,
                    const __grid_constant__ FastCascade g) {
    extern __shared__ uint4 smem4[];
    unsigned* smem = reinterpret_cast<unsigned*>(smem4);
    __shared__ doppler::FastCtaPlan plan;
    if (threadIdx.x == 0) doppler::fast_cascade_plan(g, blockIdx.x, plan);
    __syncthreads();
    for (int ph = 0;; ++ph) {
        if (!doppler::fast_cascade_phase<kInF32, kPasses>(
                in, out, plans, g, plan, (int)threadIdx.x, (int)blockDim.x, ph, smem))
            break;
        __syncthreads();
    }
}

template <bool kInF32, int kPasses>
int launch(const void* in, void* out, const uint32_t* plans, const FastCascade& g,
           int threads, long long smem, cudaStream_t stream) {
    auto kernel = cascade_fast_kernel<kInF32, kPasses>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<(unsigned)g.units, threads, (size_t)smem, stream>>>(in, out, plans, g);
    return (int)cudaGetLastError();
}

}  // namespace

// in: int32 words (B, L) or float32 planes (2, B, L); out: int32 words
// (n_out) or float32 planes (2, n_out), n_out = B·L·∏P_s/∏Q_s; plans:
// (7, B) uint32; banks_h[s], banks_l[s]: the (P_s, T_s) bank's bf16 halves
// (ops/precision.py split3_bank); carry_in[s], carry_out[s]: (2, T_s−1)
// float32.  layout: 6 ints a stage — P, Q, T, plane (bf16 entries of each
// of the stage's four span planes), g_off, x_off (word offsets of its B
// fragments and its planes in the `smem` bytes of dynamic shared memory),
// as ops/cuda/geometry.py cascade_fast_layout lays them out.  wt: last-stage
// windows a tile CTA (a multiple of 16); threads: a multiple of 32 up to
// 256; passes: 3 (split3) or 1 (default).  Needs every Q_s a power of two
// and every stage's chunk input count a multiple of 16·Q_s.  Returns
// cudaGetLastError() after the launch.
extern "C" int doppler_cascade_fast(const void* in, void* out, const uint32_t* plans,
                                    const void* const* banks_h,
                                    const void* const* banks_l,
                                    const void* const* carry_in,
                                    void* const* carry_out, const int* layout, int S,
                                    int B, int L, int wt, int threads,
                                    long long smem, int in_f32, int out_f32,
                                    int passes, void* stream) {
    FastCascade g;
    if (threads < 32 || threads > kFastThreads || threads % 32 || smem <= 0 ||
        (passes != 1 && passes != 3) ||
        !doppler::make_fast_cascade(g, in, banks_h, banks_l, carry_in, carry_out,
                                    layout, S, B, L, wt, out_f32, smem))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (passes == 1)
        return in_f32 ? launch<true, 1>(in, out, plans, g, threads, smem, s)
                      : launch<false, 1>(in, out, plans, g, threads, smem, s);
    return in_f32 ? launch<true, 3>(in, out, plans, g, threads, smem, s)
                  : launch<false, 3>(in, out, plans, g, threads, smem, s);
}

#endif  // __CUDACC__
