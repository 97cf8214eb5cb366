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

// Sign-preserving 1/x with |x| clamped away from 0.
__device__ __forceinline__ float inv_safe(float x) {
  const float xs = fabsf(x) < kDivEps ? (x < 0.0f ? -kDivEps : kDivEps) : x;
  return 1.0f / xs;
}

}  // namespace oglrt
