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
// stage, each stage with its own D_s neighbouring windows a row of A
// (ops/cuda/geometry.py cascade_fast_columns: the largest power of two with
// D_s·P_s ≤ 8 and 16·D_s·Q_s dividing the stage's input count per block,
// else 1).  Every CTA owns a target, `wt` windows of the last stage's
// outputs (tile CTAs; a multiple of 16·D_{S−1}) or up to `wt` entries at the
// end of x_t (the carry CTAs of stage t), and works it back through the
// stages: the windows of stage s that its needed outputs fall in, rounded
// out to whole M-tiles of 16·D_s windows that start at a multiple of
// 16·D_s, read a span of x_s (the band of every row of D_s windows, K_s =
// 16·ks entries from x_s[S_s·r − (T−1) − lead], S_s = D_s·Q_s); that span
// is what stage s−1 must give, and so on down to the mixed samples.  Thread
// 0 plans the spans (no 64-bit division); then the CTA runs its phases with
// a barrier between them.  Stage 0 runs in slabs of `slab` windows (whole
// M-tiles; geometry.cascade_fast_slab: about 4096 samples of x_0), so that
// x_0's planes hold one slab and a CTA can own a wide tile: the rounding to
// M-tiles of 128 windows of the ÷8 stage and the bands re-mix a halo of
// ≈ 2300 samples a tile at config 3, 1.5× the inputs of a tile of 64
// windows, 1.15× of one of 256.  Phase 0 copies the B fragments of every
// stage below the target, laid out once per bank by the wrapper
// (geometry.fast_taps_index), with 16-byte cp.async, writes the entries of
// the spans of x_1 .. x_{t−1} that no stage gives (zeros before the carry,
// the carry, zeros past the chunk) and fills slab 0 of x_0: the same
// zeros, the carry and the mix (chain.cuh chain_fill, nco.cuh mix_span,
// split as it is stored).  Then stage 0's dot over slab k and the fill of
// slab k + 1 alternate; stage 0's outputs that the span of x_1 holds are
// split and stored into its bf16 planes, and the M-tiles' other rows (the
// few windows of the rounding) are computed and dropped.  Then stage s's
// dot, s = 1 .. t−1, over its whole span; the last dot stores the target:
// the output, or carry_out_t.  Between stages the float32 outputs live as
// four bf16 planes (x_h, x_l of I and Q), the same 8 B a sample as the two
// float32 planes of cascade.cu; one pass ('default') keeps the compact
// layout of two (x_h of I and Q) and B fragments of t_h alone, half the
// bytes.
//
// Bytes.  A tensor core gives no promise across the rows and columns of
// its tile, so every x_s value must come from the same row, column and
// k-steps in every CTA that computes it.  Every CTA computes stage s in
// M-tiles that start at a multiple of 16·D_s windows of that stage's
// chunk-local grid.  Where D_s > 1 every block holds a multiple of 16·D_s
// windows of stage s (the kernel refuses a D_s whose 16·D_s·Q_s does not
// divide the stage's input count per block); where D_s = 1 the wrapper
// refuses a chunk whose window count at stage s (chunk input count / Q_s)
// is not a multiple of 16 (ops/cuda/cascade.py, the rule of the kernel
// before D_s; D_s > 1 passes it too, so no chunk it took is refused).  So a
// window i lands in row ⌊i/D_s⌋ mod 16 and column (i mod D_s)·P_s + p of
// its mma in every cut of the stream into such chunks, and bytes and
// carries do not depend on the tile, the threads or the cut.  (At config 3
// a block of 2048 samples has 256 windows at ÷8, D = 8, and 32 at 3/8, D =
// 2: any block count passes; at the 100 Msps front 128 at the first ÷16, D
// = 8, and 8 at the second, D = 1: an even block count.)  A band entry is a
// function of its index alone: a sample, a carry entry, or a zero before
// the carry or past the chunk, which only zero taps or dropped rows read.
//
// NaN.  As fast_dot.cuh: a NaN or ±∞ at x_s[n] reaches all D_s·P_s
// outputs of stage s of every row whose band of K_s entries holds n, and
// from there every later stage's rows alike; ±∞ splits into x_l = NaN.
//
// Bound on this card.  Bytes: 4 + 4·P/Q a sample (i16 words in, words
// out), plan words, banks and carries, at 3.35 TB/s; operations: the
// float32 mix (29 a sample, nco.cuh; none an FMA) at half of 67 TFLOP/s,
// and the dot (passes × I and Q × 2·T_s·P_s/Q_s a stage input sample) at
// 989 TFLOP/s bf16.  At config 3 (÷8 T = 65, 3/8 T = 51), B = 16384, L =
// 2048: ≈ 140.5 MB → 0.042 ms, mix 0.029 ms, the three-pass dot ≈ 126
// operations a sample, 0.004 ms: bound by bytes (chip_smoke.py computes
// it).  What the design spends: the ÷8 stage's band is K = 128 for a row
// of 8 windows, 1024 multiply-adds a row for 8·65 useful (1.97×; one window
// a row took 80·8/65 = 9.8×), the 3/8 stage's K = 80 for 2 windows in 6 of
// the 8 columns (2.09×; 3.3× at D = 1); the halo above, 1.15× the tile's
// inputs at the pick (256 windows, slabs of 512; 512 and 1024 for one
// pass).  __launch_bounds__(256, 3): up to 85 registers a thread; the
// geometry picks the largest tile that leaves three CTAs an SM by shared
// memory, else two, and no larger than gives a small chunk three tiles an
// SM (32 windows at the CLI's 256 blocks).  The mix and the dots still take
// their times one after the other in a CTA, overlapped only across the
// CTAs of an SM (PERF.md §6 has the halves).
#include "chain.cuh"
#include "fast_dot.cuh"

namespace doppler {

constexpr int kFastStages = 4;
constexpr int kFastLayoutInts = 7;   // a stage's ints of `layout` (below)

struct FastStage {
    FastDot d;
    long long n_in;          // chunk input count of this stage
    const unsigned* taps;    // G's B fragments (geometry.fast_taps_index)
    const float* carry_in;   // (2, T−1)
    float* carry_out;        // (2, T−1)
};

struct FastCascade {
    int S, B, L;
    int wt;                          // last-stage windows a tile CTA: 16·D·k
    int slab;                        // stage-0 windows a slab: 16·D_0·k
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
// (entries of x_{s+1}), its M-tiles (`rows` windows from window w0, both
// multiples of 16·D_s) and the span of x_s they read (`len` entries from
// x_s index org).  Stage 0 runs in `slabs` slabs of up to g.slab windows.
struct FastCtaPlan {
    int t, slabs;
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
        // windows an M-tile, 16·D: a power of two, so a mask rounds to it
        // (no 64-bit division: thread 0 plans while the others wait)
        const long long m = 16LL * d.D;
        const long long i_hi = div_nonneg(jb, d.P);
        p.w0[s] = div_nonneg(ja, d.P) & ~(m - 1);
        p.rows[s] = (int)((i_hi - p.w0[s] + m) & ~(m - 1));
        p.org[s] = p.w0[s] * d.Q - (d.T - 1) - d.lead;
        p.len[s] = d.Q * (p.rows[s] - d.D) + 16 * d.ks;
        ja = max64(p.org[s], 0);
        jb = min64(p.org[s] + p.len[s], g.st[s].n_in) - 1;
    }
    p.slabs = p.t > 0 ? (p.rows[0] + g.slab - 1) / g.slab : 0;
}

// Slab k of stage 0: `rows` windows from window w0 and the span of x_0
// they read, `len` entries from x_0 index org.
struct FastSlab {
    long long w0, org;
    int rows, len;
};

__device__ __forceinline__ FastSlab fast_slab(const FastCascade& g,
                                              const FastCtaPlan& p, int k) {
    const FastDot& d = g.st[0].d;
    FastSlab b;
    b.w0 = p.w0[0] + (long long)k * g.slab;
    b.rows = (int)min64(g.slab, p.rows[0] - (long long)k * g.slab);
    b.org = b.w0 * d.Q - (d.T - 1) - d.lead;
    b.len = d.Q * (b.rows - d.D) + 16 * d.ks;
    return b;
}

// Stage s−1's outputs into the span of x_s: those the span holds.
template <int kPasses>
struct FastSpanSink {
    SplitStore<kPasses, kPasses == 1> store;
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
    if (d.S & 1) {
        fast_items<kPasses, true, kPasses == 1>(d, smem, w0, rows, tid, nthreads, sink);
    } else {
        fast_items<kPasses, false, kPasses == 1>(d, smem, w0, rows, tid, nthreads, sink);
    }
}

// The target's sink: the output, or carry_out_t from x_t index n_t − H.
__device__ __forceinline__ FastTargetSink fast_target(const FastCascade& g,
                                                     const FastCtaPlan& p, void* out) {
    FastTargetSink sink{};
    const int t = p.t;
    sink.ja = p.ja[t - 1];
    sink.jb = p.jb[t - 1];
    if (t == g.S) {
        sink.mode = g.out_f32 ? 2 : 3;
        sink.out = out;
        sink.n_out = g.n_out;
    } else {
        sink.mode = 1;
        sink.carry = g.st[t].carry_out;
        sink.H = g.st[t].d.T - 1;
        sink.first = g.st[t].n_in - sink.H;
    }
    return sink;
}

// Span entries n in [lo, hi) of x_s that are no stage's output: zeros
// before the carry (lead columns of window 0) and past the chunk, which
// only zero taps and dropped rows multiply, and the carry entries; with
// `carry` false only the zeros (the mix writes the carry of x_0).
template <class Store>
__device__ __forceinline__ void fast_span_edges(const FastStage& st, long long lo,
                                                long long hi, bool carry, int tid,
                                                int nthreads, Store& store) {
    const int H = st.d.T - 1;
    for (long long n = lo + tid; n < -H && n < hi; n += nthreads) store(n, 0.0f, 0.0f);
    for (long long n = max64(lo, st.n_in) + tid; n < hi; n += nthreads)
        store(n, 0.0f, 0.0f);
    if (carry)
        for (long long n = max64(lo, -H) + tid; n < 0 && n < hi; n += nthreads)
            store(n, st.carry_in[H + n], st.carry_in[2 * H + n]);
}

// Slab k of x_0 into stage 0's planes: the edges and the mix (chain.cuh
// chain_fill, which takes the carry too); kDotOnly stores zeros alone.
template <bool kInF32, int kPasses, int kPart>
__device__ __forceinline__ void fast_fill_slab(const void* __restrict__ in,
                                               const uint32_t* __restrict__ plans,
                                               const FastCascade& g,
                                               const FastCtaPlan& p, int k, int tid,
                                               int nthreads, unsigned* smem) {
    const FastStage& st = g.st[0];
    if constexpr (kPart == kDotOnly) {
        uint4* words = reinterpret_cast<uint4*>(smem + st.d.x_off);
        for (int w = tid; w < st.d.planes * st.d.plane / 8; w += nthreads)
            words[w] = make_uint4(0u, 0u, 0u, 0u);
        return;
    }
    const FastSlab b = fast_slab(g, p, k);
    const long long end = b.org + b.len;
    SplitStore<kPasses, kPasses == 1> store{
        reinterpret_cast<uint16_t*>(smem + st.d.x_off), &st.d, b.org};
    fast_span_edges(st, b.org, end, false, tid, nthreads, store);
    chain_fill<kInF32>(max64(b.org, -(st.d.T - 1)), min64(end, st.n_in) - 1, in, plans,
                       (size_t)g.B, g.B, g.L, g.vec4 != 0, st.d.T - 1, st.carry_in,
                       tid, nthreads, store);
}

// Stage s's dot over `rows` windows from w0 into its consumer: the span of
// x_{s+1} (the outputs it holds), or the target where s + 1 = t.
template <int kPasses>
__device__ __forceinline__ void fast_stage_dot(const FastCascade& g,
                                               const FastCtaPlan& p, int s,
                                               long long w0, int rows, void* out,
                                               int tid, int nthreads, unsigned* smem) {
    if (rows <= 0) return;
    const FastDot& d = g.st[s].d;
    if (s + 1 == p.t) {
        FastTargetSink sink = fast_target(g, p, out);
        fast_stage_items<kPasses>(d, smem, w0, rows, tid, nthreads, sink);
    } else {
        const FastDot& e = g.st[s + 1].d;
        FastSpanSink<kPasses> sink{
            {reinterpret_cast<uint16_t*>(smem + e.x_off), &e, p.org[s + 1]}, p.ja[s],
            p.jb[s]};
        fast_stage_items<kPasses>(d, smem, w0, rows, tid, nthreads, sink);
    }
}

// Phase `ph` of the CTA with plan `p`, for thread `tid` of `nthreads`; true
// while a further phase follows (after a barrier).  A target of stage t ≥ 1
// runs 2·slabs + t − 1 phases: phase 0 copies the B fragments of stages
// 0 .. t−1 (cp.async), writes the edges of the spans of x_1 .. x_{t−1} and
// fills slab 0 of x_0; phase 2k + 1 runs stage 0's dot over slab k, phase
// 2k + 2 fills slab k + 1; then phase 2·slabs − 1 + s runs stage s's dot,
// s = 1 .. t − 1.  The last phase stores the target.  kPart (fast_dot.cuh):
// kMixOnly XORs each slab's planes into `side` (one word a warp of this
// CTA) in place of stage 0's dot and stops after the last slab; kDotOnly
// fills the slabs with zeros.
template <bool kInF32, int kPasses, int kPart = kWhole>
__device__ __forceinline__ bool fast_cascade_phase(
        const void* __restrict__ in, void* __restrict__ out,
        const uint32_t* __restrict__ plans, const FastCascade& g,
        const FastCtaPlan& p, int tid, int nthreads, int ph, unsigned* smem,
        unsigned* side = nullptr) {
    const int t = p.t;
    if (t == 0 || ph == 0) {
        // the entries of the target that come from carry_in
        if (t < g.S) {
            const FastStage& st = g.st[t];
            const int H = st.d.T - 1;
            const long long first = st.n_in - H;
            for (long long j = p.a + tid; j < 0 && j < p.a + p.c; j += nthreads) {
                st.carry_out[j - first] = st.carry_in[H + j];
                st.carry_out[H + j - first] = st.carry_in[2 * H + j];
            }
        }
    }
    if (t == 0) {
        // the mixed samples, one at a time: bitwise cascade.cu's carry
        const FastStage& st = g.st[0];
        const int H = st.d.T - 1;
        const long long first = st.n_in - H;
        int cur = -1;
        Plan pl;
        for (long long j = max64(p.a, 0) + tid; j < p.a + p.c; j += nthreads) {
            float vi, vq;
            mix_at<kInF32>(j, in, plans, (size_t)g.B, g.B, g.L, cur, pl, vi, vq);
            st.carry_out[j - first] = vi;
            st.carry_out[H + j - first] = vq;
        }
        return false;
    }
    if (p.slabs == 0) return false;          // every entry came from carry_in
    const int last0 = 2 * p.slabs - 1;       // stage 0's last phase
    if (ph == 0) {
        for (int s = 0; s < t; ++s)
            fast_copy_taps(smem, g.st[s].d, g.st[s].taps, tid, nthreads);
        for (int s = 1; s < t; ++s) {
            if (p.rows[s] == 0) continue;
            const FastDot& d = g.st[s].d;
            SplitStore<kPasses, kPasses == 1> store{
                reinterpret_cast<uint16_t*>(smem + d.x_off), &d, p.org[s]};
            fast_span_edges(g.st[s], p.org[s], p.org[s] + p.len[s], true, tid, nthreads,
                            store);
        }
        fast_fill_slab<kInF32, kPasses, kPart>(in, plans, g, p, 0, tid, nthreads, smem);
        fast_copy_wait();
        return true;
    }
    if (ph <= last0) {
        const int k = ph >> 1;
        if (!(ph & 1)) {
            fast_fill_slab<kInF32, kPasses, kPart>(in, plans, g, p, k, tid, nthreads, smem);
            return true;
        }
        if constexpr (kPart == kMixOnly) {
            const FastDot& d = g.st[0].d;
            fast_xor_words(smem + d.x_off, d.planes * d.plane / 2, tid, nthreads, side,
                           k > 0);
            return ph < last0;
        }
        const FastSlab b = fast_slab(g, p, k);
        fast_stage_dot<kPasses>(g, p, 0, b.w0, b.rows, out, tid, nthreads, smem);
        return ph < last0 || t > 1;
    }
    const int s = ph - last0;
    fast_stage_dot<kPasses>(g, p, s, p.w0[s], p.rows[s], out, tid, nthreads, smem);
    return s + 1 < t;
}

// The most entries of x_s any CTA's planes hold (ops/cuda/geometry.py
// cascade_fast_spans computes the same): a tile CTA's last stage is `wt`
// windows; below it, and below a carry CTA's up to `wt` entries of x_t, a
// run of c needed outputs lies in ⌈(c−1)/P⌉ + 1 windows, 16·D − 1 more
// where its first window rounds down to a multiple of 16·D, rounded up to
// M-tiles of 16·D; its span is Q·(rows − D) + K entries, each of which the
// stage below may have to give.  x_0's planes hold one slab's span, of at
// most g.slab windows.
__host__ __device__ inline void fast_span_bound(const FastCascade& g,
                                                long long* need) {
    for (int s = 0; s < g.S; ++s) need[s] = 0;
    for (int t = 1; t <= g.S; ++t) {
        long long c = t == g.S ? (long long)g.wt * g.st[t - 1].d.P
                               : min64((long long)g.wt, (long long)g.st[t].d.T - 1);
        if (c <= 0) continue;
        for (int s = t - 1; s >= 0; --s) {
            const FastDot& d = g.st[s].d;
            const long long m = 16LL * d.D;
            const long long w = (c - 1 + d.P - 1) / d.P + 1;
            const long long rows = t == g.S && s == t - 1 ? g.wt : (w + 2 * m - 2) / m * m;
            const long long len = (long long)d.Q * (rows - d.D) + 16LL * d.ks;
            need[s] = max64(need[s], len);
            c = len;
        }
    }
    const FastDot& d = g.st[0].d;
    need[0] = min64(need[0], (long long)d.Q * (g.slab - d.D) + 16LL * d.ks);
}

// A FastCascade from doppler_cascade_fast's arguments (below); false where
// they are not ones the kernel takes.
inline bool make_fast_cascade(FastCascade& g, const void* in,
                              const void* const* taps, const void* const* carry_in,
                              void* const* carry_out, const int* layout, int S, int B,
                              int L, int wt, int slab, int out_f32, int passes,
                              long long smem) {
    g = FastCascade{};
    if (B <= 0 || L <= 0 || S < 1 || S > kFastStages || wt < 16 || slab < 16 ||
        (passes != 1 && passes != 3))
        return false;
    g.S = S;
    g.B = B;
    g.L = L;
    g.wt = wt;
    g.slab = slab;
    g.out_f32 = out_f32;
    g.vec4 = (L % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0) ? 1 : 0;
    long long n = (long long)B * L;
    long long blk = L;          // the stage's input count a block; 0: not whole
    g.units = 0;
    for (int s = 0; s < S; ++s) {
        FastStage& st = g.st[s];
        const int* v = layout + kFastLayoutInts * s;
        if (!fast_derive(st.d, v[0], v[1], v[2], v[3], passes == 1))
            return false;
        const FastDot& d = st.d;
        // whole rows of M-tiles in every chunk: 16·D windows a block where
        // D > 1, 16 windows a chunk where D = 1
        if (n % d.Q || (n / d.Q) % (16LL * d.D) ||
            (d.D > 1 && (blk == 0 || blk % (16LL * d.D * d.Q))))
            return false;
        st.d.plane = v[4];
        st.d.g_off = v[5];
        st.d.x_off = v[6];
        st.taps = static_cast<const unsigned*>(taps[s]);
        st.n_in = n;
        st.carry_in = static_cast<const float*>(carry_in[s]);
        st.carry_out = static_cast<float*>(carry_out[s]);
        g.carry_ctas[s] = (d.T - 1 + wt - 1) / wt;
        g.units += g.carry_ctas[s];
        n = n / d.Q * d.P;
        blk = blk % d.Q ? 0 : blk / d.Q * d.P;
    }
    if (wt % (16 * g.st[S - 1].d.D) || slab % (16 * g.st[0].d.D)) return false;
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
        const long long hi[2] = {d.g_off + 32LL * d.bw * d.ks * d.nt,
                                 d.x_off + (long long)d.planes * d.plane / 2};
        for (int r = 0; r < s; ++r) {
            const FastDot& e = g.st[r].d;
            const long long lo2[2] = {e.g_off, e.x_off};
            const long long hi2[2] = {e.g_off + 32LL * e.bw * e.ks * e.nt,
                                      e.x_off + (long long)e.planes * e.plane / 2};
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

template <bool kInF32, int kPasses, int kPart>
__global__ void __launch_bounds__(kFastThreads, 3)
cascade_fast_kernel(const void* __restrict__ in, void* __restrict__ out,
                    const uint32_t* __restrict__ plans,
                    const __grid_constant__ FastCascade g, unsigned* __restrict__ side) {
    extern __shared__ uint4 smem4[];
    unsigned* smem = reinterpret_cast<unsigned*>(smem4);
    __shared__ doppler::FastCtaPlan plan;
    if (threadIdx.x == 0) doppler::fast_cascade_plan(g, blockIdx.x, plan);
    __syncthreads();
    for (int ph = 0;; ++ph) {
        if (!doppler::fast_cascade_phase<kInF32, kPasses, kPart>(
                in, out, plans, g, plan, (int)threadIdx.x, (int)blockDim.x, ph, smem,
                kPart == doppler::kMixOnly ? side + (size_t)blockIdx.x * (blockDim.x / 32)
                                           : nullptr))
            break;
        __syncthreads();
    }
}

template <bool kInF32, int kPasses, int kPart = doppler::kWhole>
int launch(const void* in, void* out, const uint32_t* plans, const FastCascade& g,
           int threads, long long smem, cudaStream_t stream, unsigned* side = nullptr) {
    auto kernel = cascade_fast_kernel<kInF32, kPasses, kPart>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<(unsigned)g.units, threads, (size_t)smem, stream>>>(in, out, plans, g, side);
    return (int)cudaGetLastError();
}

}  // namespace

// in: int32 words (B, L) or float32 planes (2, B, L); out: int32 words
// (n_out) or float32 planes (2, n_out), n_out = B·L·∏P_s/∏Q_s; plans:
// (7, B) uint32; taps[s]: stage s's B fragments as ops/cuda/geometry.py
// fast_taps_index lays them out for (P_s, Q_s, T_s, D_s, passes), 16-byte
// aligned; carry_in[s], carry_out[s]: (2, T_s−1) float32.  layout: 7 ints
// a stage — P, Q, T, D (windows a row of A: a power of two; where D > 1,
// 16·D·Q divides the stage's input count a block), plane (bf16 entries of
// each of the stage's span planes), g_off, x_off (word offsets of its B
// fragments and its planes in the `smem` bytes of dynamic shared memory),
// as geometry.cascade_fast_layout lays them out.  wt: last-stage windows a
// tile CTA (a multiple of 16·D_{S−1}); slab: stage-0 windows a slab (a
// multiple of 16·D_0); threads: a multiple of 32 up to 256; passes: 3
// (split3, four planes) or 1 (default, the compact two).  Needs every Q_s
// a power of two and every stage's chunk window count a multiple of
// 16·D_s.  Returns cudaGetLastError() after the launch.
extern "C" int doppler_cascade_fast(const void* in, void* out, const uint32_t* plans,
                                    const void* const* taps,
                                    const void* const* carry_in,
                                    void* const* carry_out, const int* layout, int S,
                                    int B, int L, int wt, int slab, int threads,
                                    long long smem, int in_f32, int out_f32,
                                    int passes, void* stream) {
    FastCascade g;
    if (threads < 32 || threads > kFastThreads || threads % 32 || smem <= 0 ||
        !doppler::make_fast_cascade(g, in, taps, carry_in, carry_out, layout, S, B, L,
                                    wt, slab, out_f32, passes, smem))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (passes == 1)
        return in_f32 ? launch<true, 1>(in, out, plans, g, threads, smem, s)
                      : launch<false, 1>(in, out, plans, g, threads, smem, s);
    return in_f32 ? launch<true, 3>(in, out, plans, g, threads, smem, s)
                  : launch<false, 3>(in, out, plans, g, threads, smem, s);
}

// One half of doppler_cascade_fast alone, for timing (FastPart): part 1 the
// mix (side: the XOR of x_0's planes, one word a warp of every CTA), part 2
// the dots over a stage-0 span of zeros.  i16 input, three passes; the
// other arguments as doppler_cascade_fast's.
extern "C" int doppler_cascade_fast_part(const void* in, void* out, const uint32_t* plans,
                                         const void* const* taps,
                                         const void* const* carry_in,
                                         void* const* carry_out, const int* layout,
                                         int S, int B, int L, int wt, int slab,
                                         int threads, long long smem, int out_f32,
                                         int part, unsigned* side, void* stream) {
    FastCascade g;
    if (threads < 32 || threads > kFastThreads || threads % 32 || smem <= 0 ||
        (part != 1 && part != 2) ||
        !doppler::make_fast_cascade(g, in, taps, carry_in, carry_out, layout, S, B, L,
                                    wt, slab, out_f32, 3, smem))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return part == 1
        ? launch<false, 3, doppler::kMixOnly>(in, out, plans, g, threads, smem, s, side)
        : launch<false, 3, doppler::kDotOnly>(in, out, plans, g, threads, smem, s, side);
}

#endif  // __CUDACC__
