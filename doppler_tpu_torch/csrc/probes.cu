// Roofline probes: what the card reaches on the mixer's and the chain's
// traffic with less and less of their work taken away.  They share the
// decode, phase, tone, rotation and encode of nco.cuh with the product
// kernels bit for bit, so a difference of two times is the cost of the code
// that differs.
//
// Replaces
//   tools/roofline.py:130  pallas_elementwise(...).run   (bodies: identity
//                          :160, codec_body :141)
//   tools/roofline.py:262  chain_shape_run(...).run      (kernel
//                          make_chain_shape_kernel :207)
//   tools/probe_chain_precision.py:190  mix_shape_run(...).run  (kernel
//                          make_mix_kernel :142, the tone a parameter)
//
// Bound: HBM bytes, all of them.  The elementwise probes move 8 B/sample
// (one int32 word in, one out); the chain-shaped probes move the chain's
// 4 + 4·P/Q B/sample.  The mix's own instructions (some 60 SASS
// instructions a sample, none of them an FMA under -fmad=false) put an
// issue floor above the byte bound on this card: chip_smoke.py prints both.
//
// Elementwise probe (`doppler_probe_elementwise`).  out = body(in) over n
// int32 words.  body: identity, or the codec — decode ×1/32768, encode
// ×32767 truncating, clip, pack — without encode_i16's NaN guard, as the
// TPU body has it (a decoded i16 is never NaN).  vec: int32 words per
// access, 1 or 4 (4- or 16-byte loads and stores); the TPU tool swept DMA
// tile sizes where this sweeps the access width.  It is the yardstick the
// tools read the card's HBM by, so it streams: every thread moves 16 bytes,
// one 16-byte access or four 4-byte ones, all its loads issued into
// registers before its first store, the tail masked rather than broken out
// of, with streaming cache hints (__ldcs / __stcs: every word is touched
// once), in as many short 256-thread CTAs as the words need (eight
// resident an SM keep 32 KB in flight there).  A grid-stride form sized
// from the SM count (four waves of eight CTAs, eight accesses a thread in
// flight) read slower, at 16-byte accesses, than both the library's copy
// and the kernel before it; PERF.md §6 has the times, by one timer.
//
// Chain-shaped probe (`doppler_chain_shape`).  The chunk is cut into tiles
// of `tile` input samples; tile t's first `keep` = tile·P/Q words go to
// out[t, :]: raw (copy), or mixed and encoded with the fold tone (mix) or
// the select-chain tone (mix-select).
//
// Every sample's work is kept alive.  A word that is not stored would
// otherwise be dead code: nvcc would drop its load (copy) or its whole mix
// (mix), and the probe would time P/Q of the work while claiming all of it.
// So each thread XORs the words it does not store, the tile's XOR is
// reduced, and one int32 a tile goes to side[t].  XOR is order-free, so the
// plain version reproduces side[] bitwise; that equality shows on the card
// that the unstored words were computed.  side[] adds 4 B a tile (0.2 % of
// the chain's output).
//
// The copy: a 128-thread CTA a tile, one sample a step, the CTA's XOR
// through warp shuffles and shared memory.
//
// The mix.  Its samples cost the product kernels' own per-sample code
// (nco.cuh: decode_i16, walker_q24x4, mix_q24, pack_i16); what is the
// probe's own is the schedule around them:
// - One warp a tile (`split` warps a tile for small chunks), for a long
//   loop: lane l mixes the tile's groups of four samples l, l + 32, …
//   from 16-byte loads, 16 groups a lane at the tools' tile of 2048.  A CTA
//   holds `warps` warps.
// - Where the tile lies inside one block (L % tile == 0: the tools' shape),
//   the warp reads the block's seven plan words once, a lane a word, and
//   broadcasts them with shuffles; each lane then starts its walker with
//   two products and no division.
//   Other geometries take nco.cuh's mix_span a tile (walker_seek a lane).
// - Each lane keeps its next `depth` groups (1 or 2) loaded while it mixes
//   the current one, so that the stream of loads runs under the stream of
//   instructions instead of beside it.
// - A tile's kept words are its first, so a lane's first trips store and
//   the rest only XOR: a group wholly inside the kept words is one 16-byte
//   store (rows 16-byte aligned, keep % 4 == 0) or four plain ones; a group
//   outside them is XORed into the lane's side word with no compare; only
//   the ragged group keeps the per-sample rule.
// - The side word: five XOR shuffles and lane 0 stores it; no shared
//   memory and no barrier unless a tile is split over warps.
// - No division by a launch parameter on the device (split is a power of
//   two, a block of one tile needs none), and at most 64 registers, so
//   that four CTAs of eight warps fit an SM (`cuobjdump
//   --dump-resource-usage`: 72 registers and three CTAs without the bound).
// The launch geometry (warps, split, depth) comes from
// ops/cuda/probes.py shape_geometry, from the tile count and the SM count:
// at the CLI's 256-block chunk a tile is split over four warps, so that the
// chunk's 256 tiles still put eight warps on each SM; PERF.md §6 has the
// sweep (tools/kernel_sweep.py --kernels chain-shape) it follows.
//
// The host build (csrc/host/kernel_emulation.cpp) runs the same lane code
// through csrc/host_shim.cuh: a warp's lanes one after the other, the plan
// words loaded by each lane, the side words XOR-folded on the host.
#include "nco.cuh"

namespace doppler {

constexpr int kShapeMaxWarps = 8;       // warps of a chain-shaped mix CTA at most
constexpr int kShapeMinCtas = 4;        // CTAs of 8 warps an SM: at most 64 registers

// One chain-shaped mix launch.
struct ShapeArgs {
    int B, L, tile, keep;
    long long n_tiles;
    int warps;      // warps a CTA
    int split;      // warps a tile: 1, 2 or 4
    int split_shift;            // log2(split)
    int per_cta;    // tiles (warp groups of `split` warps) a CTA: warps / split
    int depth;      // groups of four a lane keeps loaded ahead: 1 or 2
    int tiles_per_block;        // L / tile on the fast path
    int trips;      // groups a lane a tile on the fast path: tile / 4 / (32·split)
    int trips_keep; // ... of them the first that can hold kept words, a
                    // multiple of depth
    bool vec4;      // 16-byte loads: L % 4 == 0 and `in` 16-byte aligned
    bool fast;      // the warp's own loop: vec4, tiles inside blocks (L % tile
                    // == 0) and the same whole trips of `depth` groups for
                    // every lane
    bool rows16;    // a kept group is one 16-byte store: tile % 4 == 0,
                    // keep % 4 == 0 and `out` 16-byte aligned
};

// ShapeArgs and the CTA count of a launch; false where the arguments are
// not ones the kernel takes.
inline bool make_shape_args(ShapeArgs& a, const void* in, const void* out, int B,
                            int L, int tile, int keep, int warps, int split,
                            int depth, long long& ctas) {
    if (B <= 0 || L <= 0 || tile <= 0 || keep <= 0 || keep > tile ||
        ((long long)B * L) % tile != 0)
        return false;
    if (warps < 1 || warps > kShapeMaxWarps || (depth != 1 && depth != 2) ||
        (split != 1 && split != 2 && split != 4) || warps % split != 0)
        return false;
    a.B = B;
    a.L = L;
    a.tile = tile;
    a.keep = keep;
    a.n_tiles = (long long)B * L / tile;
    a.warps = warps;
    a.split = split;
    a.split_shift = split == 4 ? 2 : split == 2 ? 1 : 0;
    a.per_cta = warps / split;
    a.depth = depth;
    a.vec4 = L % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;
    a.fast = a.vec4 && tile % 4 == 0 && L % tile == 0 &&
             (tile / 4) % (32 * split * depth) == 0 &&
             (long long)B * L / 4 <= 0xFFFFFFFFLL;
    a.tiles_per_block = L / tile;
    a.trips = tile / 4 / (32 * split);
    const int keep_groups = (keep + 3) / 4;                 // groups with a kept word
    const int trips_keep = (keep_groups + 32 * split - 1) / (32 * split);
    a.trips_keep = (trips_keep + depth - 1) / depth * depth;
    if (a.trips_keep > a.trips) a.trips_keep = a.trips;
    a.rows16 = tile % 4 == 0 && keep % 4 == 0 &&
               reinterpret_cast<uintptr_t>(out) % 16 == 0;
    ctas = (a.n_tiles + a.per_cta - 1) / a.per_cta;
    return ctas <= 0x7FFFFFFFLL;
}

// A tile's mixed samples: the kept ones stored in its row of out, the
// others XORed into `acc`.
struct ShapeStore {
    int* row;           // the tile's kept words
    long long g0;       // chunk index of the tile's first sample
    int keep;
    bool rows16;
    int acc;            // XOR of the words not kept

    __device__ __forceinline__ void put(int w, int x) {
        if (w < keep) {
            row[w] = x;
        } else {
            acc ^= x;
        }
    }
    // one sample at chunk index g
    __device__ __forceinline__ void operator()(long long g, float oi, float oq) {
        put((int)(g - g0), pack_i16(oi, oq));
    }
    // four samples from tile word w on (w % 4 == 0 where rows16)
    __device__ __forceinline__ void group_at(int w, const float* oi, const float* oq) {
        const int x0 = pack_i16(oi[0], oq[0]), x1 = pack_i16(oi[1], oq[1]);
        const int x2 = pack_i16(oi[2], oq[2]), x3 = pack_i16(oi[3], oq[3]);
        if (w + 4 <= keep) {
            if (rows16) {
                *reinterpret_cast<int4*>(row + w) = make_int4(x0, x1, x2, x3);
            } else {
                row[w] = x0;
                row[w + 1] = x1;
                row[w + 2] = x2;
                row[w + 3] = x3;
            }
        } else if (w >= keep) {
            acc ^= x0 ^ x1 ^ x2 ^ x3;
        } else {                        // the ragged group
            put(w, x0);
            put(w + 1, x1);
            put(w + 2, x2);
            put(w + 3, x3);
        }
    }
    // nco.cuh mix_span's hook: the whole group at chunk index g
    __device__ __forceinline__ void group(long long g, const float* oi, const float* oq) {
        group_at((int)(g - g0), oi, oq);
    }
};

// One trip of a lane on the fast path: its next kDepth groups of four,
// mixed, each stored where it holds kept words (kStore; `word` is the first
// group's tile word) or XORed into st.acc.  v holds the groups loaded ahead:
// each is decoded, then its register is refilled from src[ld] (16-byte
// words, the lane's next but kDepth − 1), so the load runs under the mix.
template <bool kSelect, int kDepth, bool kStore>
__device__ __forceinline__ void shape_trip(int4 (&v)[kDepth], const int4* __restrict__ src,
                                           uint32_t& ld, uint32_t ld_end, uint32_t nlanes,
                                           Walker& w, uint32_t step, ShapeStore& st,
                                           int& word) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
        float fi[4], fq[4];
        decode_i16(v[d].x, fi[0], fq[0]);
        decode_i16(v[d].y, fi[1], fq[1]);
        decode_i16(v[d].z, fi[2], fq[2]);
        decode_i16(v[d].w, fi[3], fq[3]);
        if (ld < ld_end) v[d] = src[ld];
        ld += nlanes;
        int q24[4];
        walker_q24x4(w, q24);
        float oi[4], oq[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) mix_q24<kSelect>(fi[u], fq[u], q24[u], oi[u], oq[u]);
        if (kStore) {
            st.group_at(word, oi, oq);
            word += (int)step;
        } else {
            st.acc ^= pack_i16(oi[0], oq[0]) ^ pack_i16(oi[1], oq[1]) ^
                      pack_i16(oi[2], oq[2]) ^ pack_i16(oi[3], oq[3]);
        }
        w.j += step;
        w.prod += w.step_d;
    }
}

// Lane `lane` of `nlanes` = 32·split, on the fast path: groups lane,
// lane + nlanes, … of tile t (a.trips of them, a multiple of kDepth), which
// are 16-byte words lane + s·nlanes from the tile's start.  A tile's kept
// words are its first, so its first a.trips_keep trips store and the rest
// only XOR.  get_plan(b): block b's plan words, called by every lane of the
// warp together.  Returns the lane's XOR of the words it did not keep.
template <bool kSelect, int kDepth, class GetPlan>
__device__ __forceinline__ int shape_fast_lanes(const int* __restrict__ in,
                                                int* __restrict__ out, const ShapeArgs& a,
                                                long long t, int lane, int nlanes,
                                                GetPlan& get_plan) {
    const uint32_t groups = (uint32_t)a.tile >> 2;
    const uint32_t step = 4u * (uint32_t)nlanes;
    // 16-byte word indices into the chunk (under 2^32: make_shape_args)
    const int4* const src = reinterpret_cast<const int4*>(in);
    const uint32_t start = (uint32_t)t * groups;
    uint32_t ld = start + (uint32_t)lane;
    const uint32_t ld_end = start + groups;
    int4 v[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
        v[d] = src[ld];                 // trips ≥ kDepth: inside the tile
        ld += (uint32_t)nlanes;
    }
    const long long g0 = t * a.tile;
    // the tile lies inside one block, the same for every lane (a block of
    // one tile at the tools' shape: no division)
    Walker w;
    w.b = a.tiles_per_block == 1 ? (int)t
          : (t >> 32) == 0 ? (int)((uint32_t)t / (uint32_t)a.tiles_per_block)
                           : (int)(t / a.tiles_per_block);
    w.j = (uint32_t)(g0 - (long long)w.b * a.L) + 4u * (uint32_t)lane;
    w.p = get_plan(w.b);
    w.prod = (uint64_t)w.j * w.p.d;
    w.step_d = (uint64_t)step * w.p.d;
    ShapeStore st{out + t * a.keep, g0, a.keep, a.rows16, 0};
    int word = 4 * lane;                // tile word of the group mixed next
    int k = 0;
    for (; k < a.trips_keep; k += kDepth)
        shape_trip<kSelect, kDepth, true>(v, src, ld, ld_end, (uint32_t)nlanes, w, step,
                                          st, word);
    for (; k < a.trips; k += kDepth)
        shape_trip<kSelect, kDepth, false>(v, src, ld, ld_end, (uint32_t)nlanes, w, step,
                                           st, word);
    return st.acc;
}

// The work of warp `warp`, lane `lane` of CTA `block`: its tile, the
// tile's XOR handed to side(t, acc) by every lane.
template <bool kSelect, int kDepth, bool kFast, class GetPlan, class Side>
__device__ __forceinline__ void shape_cta(const int* __restrict__ in,
                                          int* __restrict__ out,
                                          const uint32_t* __restrict__ plans,
                                          const ShapeArgs& a, unsigned block, int warp,
                                          int lane, GetPlan& get_plan, Side& side) {
    const long long t = (long long)block * a.per_cta + (warp >> a.split_shift);
    if (t >= a.n_tiles) return;
    const int lane_g = ((warp & (a.split - 1)) << 5) + lane;
    const int nlanes = 32 * a.split;
    if constexpr (kFast) {
        side(t, shape_fast_lanes<kSelect, kDepth>(in, out, a, t, lane_g, nlanes, get_plan));
    } else {
        const long long g0 = t * a.tile;
        ShapeStore st{out + t * a.keep, g0, a.keep, a.rows16, 0};
        mix_span<false, kSelect>(g0, g0 + a.tile - 1, in, plans, (size_t)a.B, a.B, a.L,
                                 a.vec4, lane_g, nlanes, st);
        side(t, st.acc);
    }
}

}  // namespace doppler

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCopyThreads = 128;       // threads of a chain-shaped copy CTA

// ×32767, truncate toward zero, saturate: encode_i16 without its NaN guard.
__device__ __forceinline__ int encode_unguarded(float v) {
    v = truncf(__fmul_rn(v, 32767.0f));
    v = fminf(fmaxf(v, -32768.0f), 32767.0f);
    return (int)v;
}

template <bool kCodec>
__device__ __forceinline__ int body(int w) {
    if (!kCodec) return w;
    float fi, fq;
    doppler::decode_i16(w, fi, fq);
    return (int)(((unsigned)encode_unguarded(fi) & 0xFFFFu) |
                 ((unsigned)encode_unguarded(fq) << 16));
}

template <bool kCodec>
__device__ __forceinline__ int4 body(int4 v) {
    return make_int4(body<kCodec>(v.x), body<kCodec>(v.y), body<kCodec>(v.z),
                     body<kCodec>(v.w));
}

template <int kVec> struct Access { using T = int; };
template <> struct Access<4> { using T = int4; };

// n words as n / kVec accesses of kVec words (n % kVec == 0), 16 bytes a
// thread: kPer = 4 / kVec accesses.
template <bool kCodec, int kVec>
__global__ void __launch_bounds__(kThreads)
elementwise_kernel(const int* __restrict__ in, int* __restrict__ out,
                   long long n) {
    using V = typename Access<kVec>::T;
    constexpr int kPer = 4 / kVec;
    const V* src = reinterpret_cast<const V*>(in);
    V* dst = reinterpret_cast<V*>(out);
    const long long count = n / kVec;
    const long long base = (long long)blockIdx.x * kThreads * kPer + threadIdx.x;
    V v[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
        const long long a = base + u * kThreads;
        if (a < count) v[u] = __ldcs(src + a);
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
        const long long a = base + u * kThreads;
        if (a < count) __stcs(dst + a, body<kCodec>(v[u]));
    }
}

template <bool kCodec, int kVec>
int launch_elementwise(const int* in, int* out, long long n, cudaStream_t s) {
    constexpr int kTile = kThreads * (4 / kVec);      // accesses a CTA
    const long long grid = (n / kVec + kTile - 1) / kTile;
    if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    elementwise_kernel<kCodec, kVec><<<(unsigned)grid, kThreads, 0, s>>>(in, out, n);
    return (int)cudaGetLastError();
}

// Block b's plan words for the whole warp: lane k < 7 loads word k, and
// shuffles hand every lane all seven.
struct WarpPlan {
    const uint32_t* plans;
    size_t stride;
    int lane;
    __device__ __forceinline__ doppler::Plan operator()(int b) const {
        const uint32_t mine = lane < 7 ? __ldg(plans + lane * stride + b) : 0u;
        uint32_t w[7];
#pragma unroll
        for (int k = 0; k < 7; ++k) w[k] = __shfl_sync(0xFFFFFFFFu, mine, k);
        doppler::Plan p;
        p.d = ((uint64_t)w[0] << 32) | w[1];
        p.c1 = ((uint64_t)w[2] << 32) | w[3];
        p.c2 = ((uint64_t)w[4] << 32) | w[5];
        p.t = w[6];
        return p;
    }
};

// A tile's side word from its lanes: the warp's XOR by shuffles; lane 0
// stores it, or with a split tile leaves it in shared memory for the CTA.
struct WarpSide {
    int* side;
    int* part;
    int warp, lane, split;
    __device__ __forceinline__ void operator()(long long t, int acc) {
        for (int o = 16; o > 0; o >>= 1) acc ^= __shfl_xor_sync(0xFFFFFFFFu, acc, o);
        if (lane == 0) {
            if (split == 1) {
                side[t] = acc;
            } else {
                part[warp] = acc;
            }
        }
    }
};

// The copy: one kCopyThreads-thread CTA a tile, one sample a step, the
// CTA's XOR through warp shuffles and shared memory.
__global__ void __launch_bounds__(kCopyThreads)
chain_shape_kernel(const int* __restrict__ in, int* __restrict__ out,
                   int* __restrict__ side, int tile, int keep) {
    const long long g0 = (long long)blockIdx.x * tile;
    int* row = out + (long long)blockIdx.x * keep;
    int acc = 0;
    for (int k = threadIdx.x; k < tile; k += kCopyThreads) {
        const int w = in[g0 + k];
        if (k < keep) {
            row[k] = w;
        } else {
            acc ^= w;
        }
    }
    // XOR of the CTA's unstored words: warps first, then across warps
    for (int o = 16; o > 0; o >>= 1) acc ^= __shfl_xor_sync(0xFFFFFFFFu, acc, o);
    __shared__ int warp_acc[kCopyThreads / 32];
    if ((threadIdx.x & 31) == 0) warp_acc[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        int x = 0;
        for (int i = 0; i < kCopyThreads / 32; ++i) x ^= warp_acc[i];
        side[blockIdx.x] = x;
    }
}

// The mix: kMode 1 with the fold tone, 2 with the select-chain tone; a.warps
// warps a CTA as above.
template <int kMode, int kDepth, bool kFast>
__global__ void __launch_bounds__(doppler::kShapeMaxWarps * 32, doppler::kShapeMinCtas)
chain_shape_kernel(const int* __restrict__ in, int* __restrict__ out,
                   int* __restrict__ side, const uint32_t* __restrict__ plans,
                   const __grid_constant__ doppler::ShapeArgs a) {
    __shared__ int part[doppler::kShapeMaxWarps];
    const int warp = (int)(threadIdx.x >> 5), lane = (int)(threadIdx.x & 31);
    WarpPlan get_plan{plans, (size_t)a.B, lane};
    WarpSide put_side{side, part, warp, lane, a.split};
    doppler::shape_cta<kMode == 2, kDepth, kFast>(in, out, plans, a, blockIdx.x, warp,
                                                  lane, get_plan, put_side);
    if (a.split > 1) {                  // one tile a warp group: fold its warps
        __syncthreads();
        const long long t = (long long)blockIdx.x * a.per_cta + (warp >> a.split_shift);
        if (lane == 0 && (warp & (a.split - 1)) == 0 && t < a.n_tiles) {
            int x = 0;
            for (int k = 0; k < a.split; ++k) x ^= part[warp + k];
            side[t] = x;
        }
    }
}

int launch_copy(const int* in, int* out, int* side, int B, int L, int tile, int keep,
                cudaStream_t s) {
    const long long n_tiles = (long long)B * L / tile;
    if (n_tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    chain_shape_kernel<<<(unsigned)n_tiles, kCopyThreads, 0, s>>>(in, out, side, tile,
                                                                   keep);
    return (int)cudaGetLastError();
}

template <int kMode>
int launch_mix(const int* in, int* out, int* side, const uint32_t* plans, int B, int L,
               int tile, int keep, int warps, int split, int depth, cudaStream_t s) {
    doppler::ShapeArgs a;
    long long ctas;
    if (!doppler::make_shape_args(a, in, out, B, L, tile, keep, warps, split, depth,
                                  ctas))
        return (int)cudaErrorInvalidValue;
    const unsigned threads = 32u * (unsigned)warps;
    if (!a.fast) {
        chain_shape_kernel<kMode, 1, false><<<(unsigned)ctas, threads, 0, s>>>(
            in, out, side, plans, a);
    } else if (a.depth == 2) {
        chain_shape_kernel<kMode, 2, true><<<(unsigned)ctas, threads, 0, s>>>(
            in, out, side, plans, a);
    } else {
        chain_shape_kernel<kMode, 1, true><<<(unsigned)ctas, threads, 0, s>>>(
            in, out, side, plans, a);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// in, out: n int32 words (16-byte aligned and n % 4 == 0 when vec is 4);
// codec: 0 identity, 1 decode + encode; vec: 1 or 4 words an access.
// Returns cudaGetLastError() after the launch.
extern "C" int doppler_probe_elementwise(const void* in, void* out, long long n,
                                         int codec, int vec, void* stream) {
    if (n <= 0 || (vec != 1 && vec != 4) || (vec == 4 && n % 4 != 0))
        return (int)cudaErrorInvalidValue;
    const int* i = static_cast<const int*>(in);
    int* o = static_cast<int*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (codec) {
        return vec == 4 ? launch_elementwise<true, 4>(i, o, n, s)
                        : launch_elementwise<true, 1>(i, o, n, s);
    }
    return vec == 4 ? launch_elementwise<false, 4>(i, o, n, s)
                    : launch_elementwise<false, 1>(i, o, n, s);
}

// in: int32 words (B, L); out: (B·L/tile, keep) int32; side: (B·L/tile,)
// int32; plans: (7, B) uint32 (not read in mode 0); mode: 0 copy, 1 mix
// with the fold tone, 2 mix with the select-chain tone.
// Needs (B·L) % tile == 0 and 0 < keep ≤ tile.  The mix's geometry: warps
// a CTA (≤ 8), split (warps a tile: 1, 2 or 4; dividing warps) and depth
// (groups loaded ahead: 1 or 2); the copy reads none of them.  Returns
// cudaGetLastError() after the launch.
extern "C" int doppler_chain_shape(const void* in, void* out, void* side,
                                   const uint32_t* plans, int B, int L,
                                   int tile, int keep, int mode, int warps,
                                   int split, int depth, void* stream) {
    if (B <= 0 || L <= 0 || tile <= 0 || keep <= 0 || keep > tile ||
        ((long long)B * L) % tile != 0)
        return (int)cudaErrorInvalidValue;
    const int* i = static_cast<const int*>(in);
    int* o = static_cast<int*>(out);
    int* sd = static_cast<int*>(side);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (mode) {
        case 0: return launch_copy(i, o, sd, B, L, tile, keep, s);
        case 1: return launch_mix<1>(i, o, sd, plans, B, L, tile, keep, warps, split,
                                     depth, s);
        case 2: return launch_mix<2>(i, o, sd, plans, B, L, tile, keep, warps, split,
                                     depth, s);
    }
    return (int)cudaErrorInvalidValue;
}

#endif  // __CUDACC__
