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
// 4 + 4·P/Q B/sample.
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
// of `tile` input samples; CTA t reads its tile and writes the tile's first
// `keep` = tile·P/Q words to out[t, :]: raw (copy), or mixed and encoded
// with the fold tone (mix) or the select-chain tone (mix-select).  The
// launch has 128 threads a CTA and a tile of about 128·Q/P inputs, and the
// mix is the product kernels' own front, nco.cuh's mix_span (the strided
// walker over 16-byte loads).
//
// Every sample's work is kept alive.  A word that is not stored would
// otherwise be dead code: nvcc would drop its load (copy) or its whole mix
// (mix), and the probe would time P/Q of the work while claiming all of it.
// So each thread XORs the words it does not store, the CTA reduces the XOR
// (warp shuffles, then shared memory), and thread 0 writes one int32 a tile
// to side[t].  XOR is order-free, so the plain version reproduces side[]
// bitwise; that equality shows on the card that the unstored words were
// computed.  side[] adds 4 B a tile (0.2 % of the chain's output).
#include <cuda_runtime.h>

#include "nco.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kShapeThreads = 128;      // threads of a chain-shaped CTA

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

// A mixed sample of the tile: stored if it is one of the kept words, XORed
// into the thread's side word otherwise.
struct ShapeStore {
    int* row;
    long long g0;
    int keep;
    int acc;
    __device__ __forceinline__ void operator()(long long g, float oi, float oq) {
        const int w = doppler::pack_i16(oi, oq);
        if (g - g0 < keep) {
            row[g - g0] = w;
        } else {
            acc ^= w;
        }
    }
};

// kMode: 0 copy, 1 mix with the fold tone, 2 mix with the select-chain tone.
template <int kMode>
__global__ void __launch_bounds__(kShapeThreads)
chain_shape_kernel(const int* __restrict__ in, int* __restrict__ out,
                   int* __restrict__ side, const uint32_t* __restrict__ plans,
                   int B, int L, int tile, int keep, int vec4) {
    const long long g0 = (long long)blockIdx.x * tile;
    int* row = out + (long long)blockIdx.x * keep;
    int acc = 0;
    if (kMode == 0) {
        for (int k = threadIdx.x; k < tile; k += kShapeThreads) {
            const int w = in[g0 + k];
            if (k < keep) {
                row[k] = w;
            } else {
                acc ^= w;
            }
        }
    } else {
        // the product kernels' mix front: the strided walker of nco.cuh
        ShapeStore store{row, g0, keep, 0};
        doppler::mix_span<false, (kMode == 2)>(
            g0, g0 + tile - 1, in, plans, (size_t)B, B, L, vec4 != 0,
            (int)threadIdx.x, kShapeThreads, store);
        acc = store.acc;
    }
    // XOR of the CTA's unstored words: warps first, then across warps
    for (int o = 16; o > 0; o >>= 1) acc ^= __shfl_xor_sync(0xFFFFFFFFu, acc, o);
    __shared__ int warp_acc[kShapeThreads / 32];
    if ((threadIdx.x & 31) == 0) warp_acc[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        int a = 0;
        for (int i = 0; i < kShapeThreads / 32; ++i) a ^= warp_acc[i];
        side[blockIdx.x] = a;
    }
}

template <int kMode>
int launch_shape(const int* in, int* out, int* side, const uint32_t* plans,
                 int B, int L, int tile, int keep, cudaStream_t s) {
    const long long n_tiles = (long long)B * L / tile;
    if (n_tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    const int vec4 = (L % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0);
    chain_shape_kernel<kMode><<<(unsigned)n_tiles, kShapeThreads, 0, s>>>(
        in, out, side, plans, B, L, tile, keep, vec4);
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
// int32; plans: (7, B) uint32 (not read in mode 0); mode as kMode above.
// Needs (B·L) % tile == 0 and 0 < keep ≤ tile.  Returns cudaGetLastError()
// after the launch.
extern "C" int doppler_chain_shape(const void* in, void* out, void* side,
                                   const uint32_t* plans, int B, int L,
                                   int tile, int keep, int mode, void* stream) {
    if (B <= 0 || L <= 0 || tile <= 0 || keep <= 0 || keep > tile ||
        ((long long)B * L) % tile != 0)
        return (int)cudaErrorInvalidValue;
    const int* i = static_cast<const int*>(in);
    int* o = static_cast<int*>(out);
    int* sd = static_cast<int*>(side);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (mode) {
        case 0: return launch_shape<0>(i, o, sd, plans, B, L, tile, keep, s);
        case 1: return launch_shape<1>(i, o, sd, plans, B, L, tile, keep, s);
        case 2: return launch_shape<2>(i, o, sd, plans, B, L, tile, keep, s);
    }
    return (int)cudaErrorInvalidValue;
}
