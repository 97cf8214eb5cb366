// Fused Phong shade: ambient + diffuse + specular over L lights, per ray.
//
// Replaces openglraytracer_tpu/ops/pallas_shade.py::_shade_kernel (the
// forward pallas_call in _shade_pallas). Per ray: the 20-float material
// row [ambient(4) diffuse(4) specular(4) emissive(4) shininess ...], the
// ray direction, the hit point and normal and one occlusion byte per light
// go in; rgb * alpha comes out. The chain is that of the reference kernel:
// view = normalize(-d); per light the unnormalized segment light - p,
// reflect(-l, n) renormalized, diffuse max(l.n, 0), specular
// exp(shininess * log(max(cos_phi, 1e-12))) gated on cos_phi > 0.
//
// Lights table (L, 16): [pos(3) pad ambient(4) diffuse(4) specular(4)].
//
// What bounds it on the H100: memory traffic. A ray reads 80 bytes of
// material row, 36 bytes of direction, point and normal and L occlusion
// bytes, and writes 12 bytes; about 60 float ops per light. One thread per
// ray streams it once, with every intermediate in registers; the light
// table is a few hundred bytes that every thread reads through the cache.
#include "common.cuh"

namespace oglrt {
namespace {

constexpr int kMatCols = 20;
constexpr int kLightCols = 16;

__global__ void __launch_bounds__(kBlock) phong_shade_kernel(
    const float* __restrict__ lights, const float* __restrict__ mat,
    const float* __restrict__ dirs, const float* __restrict__ hp,
    const float* __restrict__ hn, const bool* __restrict__ occ,
    long long n_rays, int n_lights, float* __restrict__ rgb) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (r >= n_rays) return;

  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  const float px = hp[3 * r], py = hp[3 * r + 1], pz = hp[3 * r + 2];
  const float nx = hn[3 * r], ny = hn[3 * r + 1], nz = hn[3 * r + 2];
  const float* m = mat + r * kMatCols;

  // view = normalize(-d)
  const float inv_d = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, kSqrtEps));
  const float vx = -dx * inv_d, vy = -dy * inv_d, vz = -dz * inv_d;

  float amb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float dif[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float spe[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const float m_shin = m[16];

  for (int j = 0; j < n_lights; ++j) {
    const float* lg = lights + j * kLightCols;
    for (int c = 0; c < 4; ++c) amb[c] = amb[c] + lg[4 + c] * m[c];

    const float tlx = lg[0] - px, tly = lg[1] - py, tlz = lg[2] - pz;
    const float inv_tl =
        rsqrtf(fmaxf(tlx * tlx + tly * tly + tlz * tlz, kSqrtEps));
    const float ldx = tlx * inv_tl, ldy = tly * inv_tl, ldz = tlz * inv_tl;
    const float lit = occ[r * n_lights + j] ? 0.0f : 1.0f;

    // reflect(-l, n), then normalize
    const float dn = -(ldx * nx + ldy * ny + ldz * nz);
    float rx = -ldx - 2.0f * dn * nx;
    float ry = -ldy - 2.0f * dn * ny;
    float rz = -ldz - 2.0f * dn * nz;
    const float inv_r = rsqrtf(fmaxf(rx * rx + ry * ry + rz * rz, kSqrtEps));
    rx = rx * inv_r;
    ry = ry * inv_r;
    rz = rz * inv_r;

    const float cos_theta = fmaxf(ldx * nx + ldy * ny + ldz * nz, 0.0f);
    const float cos_phi = vx * rx + vy * ry + vz * rz;
    const float powv =
        cos_phi > 0.0f ? expf(m_shin * logf(fmaxf(cos_phi, kPowEps))) : 0.0f;

    const float lit_ct = lit * cos_theta;
    const float lit_pw = lit * powv;
    for (int c = 0; c < 4; ++c) {
      dif[c] = dif[c] + lg[8 + c] * m[4 + c] * lit_ct;
      spe[c] = spe[c] + lg[12 + c] * m[8 + c] * lit_pw;
    }
  }

  float ph[4];
  for (int c = 0; c < 4; ++c) ph[c] = amb[c] + dif[c] + spe[c] + m[12 + c];
  rgb[3 * r] = ph[0] * ph[3];
  rgb[3 * r + 1] = ph[1] * ph[3];
  rgb[3 * r + 2] = ph[2] * ph[3];
}

}  // namespace
}  // namespace oglrt

extern "C" int oglrt_phong_shade(const float* lights, const float* mat,
                                 const float* dirs, const float* hp,
                                 const float* hn, const bool* occ,
                                 long long n_rays, int n_lights, float* rgb,
                                 void* stream) {
  if (n_rays == 0) return 0;
  const long long blocks = (n_rays + oglrt::kBlock - 1) / oglrt::kBlock;
  oglrt::phong_shade_kernel<<<static_cast<unsigned>(blocks), oglrt::kBlock,
                              0, static_cast<cudaStream_t>(stream)>>>(
      lights, mat, dirs, hp, hn, occ, n_rays, n_lights, rgb);
  return static_cast<int>(cudaGetLastError());
}
