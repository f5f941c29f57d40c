// What the device helpers need from CUDA, for a host compiler.
//
// nco.cuh and fir.cuh hold the kernels' index arithmetic and their float
// steps as inline functions.  Under nvcc this header is empty.  Under a host
// C++ compiler it defines the few CUDA names those functions use, each with
// the same rounding (one IEEE operation, fmaf for the fused one), so that a
// test can run a CTA's threads one after the other on the CPU and compare
// bytes (csrc/host/kernel_emulation.cpp; build with -ffp-contract=off).
#pragma once

#ifndef __CUDACC__

#include <cmath>
#include <cstdint>
#include <cstring>

#define __device__
#define __host__
#define __forceinline__ inline

struct float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };

inline float2 make_float2(float x, float y) { return float2{x, y}; }
inline float4 make_float4(float x, float y, float z, float w) {
    return float4{x, y, z, w};
}
inline int4 make_int4(int x, int y, int z, int w) { return int4{x, y, z, w}; }
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
    return uint4{x, y, z, w};
}

template <class T>
inline T __ldg(const T* p) { return *p; }

inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }

inline unsigned __float_as_uint(float f) {
    unsigned u;
    std::memcpy(&u, &f, 4);
    return u;
}

inline float __uint_as_float(unsigned u) {
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}

using std::isnan;

#endif  // __CUDACC__
