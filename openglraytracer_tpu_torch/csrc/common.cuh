// Constants and helpers shared by the raytracer's CUDA kernels.
//
// Every kernel of this directory is built with --fmad=false and without
// fast math, so each multiply, add, divide and square root rounds as IEEE
// float32, exactly like the separate elementwise ops of the plain PyTorch
// version beside each wrapper. rsqrtf, expf and logf are the only
// approximate operations, as they are in PyTorch's own CUDA kernels.
#pragma once

#include <cuda_runtime.h>

namespace oglrt {

constexpr float kInfT = 1.0e10f;      // ops/intersect.py INF_T: no hit
constexpr float kMissT = 10000.0f;    // models/scene.py MISS_T: miss bound
constexpr float kDivEps = 1.0e-12f;   // ops/intersect.py _DIV_EPS
constexpr float kSqrtEps = 1.0e-20f;  // ops/intersect.py _SQRT_EPS
constexpr float kPowEps = 1.0e-12f;   // ops/shading.py _POW_EPS
constexpr int kBlock = 256;           // threads (rays) per block

// Staged float4 rows (kernel 2's hot launch, kernel 7's spheres) are read
// through a 32-bit shared-memory address held in a register: left to
// itself, sm_90 code rebuilds a shared address (S2R SR_CgaCtaId and three
// integer ops) after every divergent branch, that is inside every sphere
// test. smem_addr gives the shared-memory address of rows, opaque to the
// compiler so that it stays in a register.
__device__ __forceinline__ unsigned smem_addr(const void* rows) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(rows));
  asm volatile("" : "+r"(a));
  return a;
}

// Row j of a staged float4 table at shared address addr.
__device__ __forceinline__ float4 staged_row(unsigned addr, int j) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr + 16u * static_cast<unsigned>(j))
               : "memory");
  return v;
}

// Sign-preserving 1/x with |x| clamped away from 0.
__device__ __forceinline__ float inv_safe(float x) {
  const float xs = fabsf(x) < kDivEps ? (x < 0.0f ? -kDivEps : kDivEps) : x;
  return 1.0f / xs;
}

}  // namespace oglrt
