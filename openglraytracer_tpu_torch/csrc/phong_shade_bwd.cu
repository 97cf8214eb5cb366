// Analytic backward of the fused Phong shade, per ray.
//
// Replaces openglraytracer_tpu/ops/pallas_shade.py::_shade_bwd_kernel (the
// backward pallas_call in _shade_bwd_pallas). Per ray it replays the Phong
// chain of csrc/phong_shade.cu over the L lights in registers, then walks
// it backwards from the cotangent g of rgb * alpha and emits:
//   g_mat (R, 20): ambient, diffuse, specular, emissive (= g_ph), shininess,
//                  columns 17-19 zero;
//   g_dirs, g_p, g_n (R, 3);
//   per block, the partial sums over its rays of the light cotangents,
//                  (blocks, L * 15): per light [pos(3) amb(4) diff(4)
//                  spec(4)]; the caller sums the blocks on the device.
// The gradient semantics are the reference kernel's: the gates are strict
// (cos_phi > 0, cos_phi > 1e-12, l.n > 0) and each normalize's VJP drops
// its projection term where the squared length is at or below 1e-20. The
// occlusion bits get no cotangent.
//
// The pass over lights is done twice: once forward, to get the summed
// colour that every light's cotangent depends on, and once backward, which
// recomputes the light's forward terms (about 60 float ops) instead of
// keeping them per light, so any L runs in a fixed register budget.
//
// What bounds it on the H100: memory traffic. A ray reads 80 bytes of
// material row, 48 bytes of direction, point, normal and cotangent and L
// occlusion bytes, and writes 80 bytes of material cotangent and 36 bytes
// of direction, point and normal cotangents: about 246 bytes, about 258 MB
// at c3 (1,048,576 rays, L = 2), 0.077 ms at 3.35 TB/s; about 250 float ops
// per ray. Material rows move as float4. The light sums are reduced in the
// block with warp shuffles and shared memory in a fixed order (no float
// atomics), so the result does not change from run to run.
#include "common.cuh"

namespace oglrt {
namespace {

constexpr int kMatCols = 20;
constexpr int kLightCols = 16;
constexpr int kLightGrads = 15;  // pos(3) amb(4) diff(4) spec(4)
constexpr int kWarps = kBlock / 32;

// The forward terms of one light at one ray, as csrc/phong_shade.cu
// computes them.
struct LightTerms {
  float inv_tl, ldx, ldy, ldz, stl, lit, dn, sr, inv_r, rx, ry, rz, ct_raw,
      cos_phi, sb, logsb, val, lit_ct, lit_pw;
};

__device__ __forceinline__ LightTerms light_terms(
    const float* lg, float px, float py, float pz, float nx, float ny,
    float nz, float vx, float vy, float vz, float m_shin, bool occluded) {
  LightTerms s;
  const float tlx = lg[0] - px, tly = lg[1] - py, tlz = lg[2] - pz;
  s.stl = tlx * tlx + tly * tly + tlz * tlz;
  s.inv_tl = rsqrtf(fmaxf(s.stl, kSqrtEps));
  s.ldx = tlx * s.inv_tl;
  s.ldy = tly * s.inv_tl;
  s.ldz = tlz * s.inv_tl;
  s.lit = occluded ? 0.0f : 1.0f;
  // reflect(-l, n), then normalize
  s.dn = -(s.ldx * nx + s.ldy * ny + s.ldz * nz);
  const float rx0 = -s.ldx - 2.0f * s.dn * nx;
  const float ry0 = -s.ldy - 2.0f * s.dn * ny;
  const float rz0 = -s.ldz - 2.0f * s.dn * nz;
  s.sr = rx0 * rx0 + ry0 * ry0 + rz0 * rz0;
  s.inv_r = rsqrtf(fmaxf(s.sr, kSqrtEps));
  s.rx = rx0 * s.inv_r;
  s.ry = ry0 * s.inv_r;
  s.rz = rz0 * s.inv_r;
  s.ct_raw = s.ldx * nx + s.ldy * ny + s.ldz * nz;
  const float cos_theta = fmaxf(s.ct_raw, 0.0f);
  s.cos_phi = vx * s.rx + vy * s.ry + vz * s.rz;
  s.sb = fmaxf(s.cos_phi, kPowEps);
  s.logsb = logf(s.sb);
  s.val = expf(m_shin * s.logsb);
  const float powv = s.cos_phi > 0.0f ? s.val : 0.0f;
  s.lit_ct = s.lit * cos_theta;
  s.lit_pw = s.lit * powv;
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kBlock) phong_shade_bwd_kernel(
    const float* __restrict__ lights, const float* __restrict__ mat,
    const float* __restrict__ dirs, const float* __restrict__ hp,
    const float* __restrict__ hn, const bool* __restrict__ occ,
    const float* __restrict__ g, long long n_rays, int n_lights,
    float* __restrict__ g_mat, float* __restrict__ g_dirs,
    float* __restrict__ g_p, float* __restrict__ g_n,
    float* __restrict__ g_light_part) {
  __shared__ float red[kWarps][kLightGrads];
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  // rays past the end take part in the block's light sums with zeros
  const bool live = r < n_rays;
  const long long rr = live ? r : 0;

  float m[kMatCols];
  const float4* m4 = reinterpret_cast<const float4*>(mat + rr * kMatCols);
  for (int q = 0; q < kMatCols / 4; ++q) {
    const float4 v = m4[q];
    m[4 * q] = v.x;
    m[4 * q + 1] = v.y;
    m[4 * q + 2] = v.z;
    m[4 * q + 3] = v.w;
  }
  const float dx = dirs[3 * rr], dy = dirs[3 * rr + 1], dz = dirs[3 * rr + 2];
  const float px = hp[3 * rr], py = hp[3 * rr + 1], pz = hp[3 * rr + 2];
  const float nx = hn[3 * rr], ny = hn[3 * rr + 1], nz = hn[3 * rr + 2];
  const float g0 = live ? g[3 * rr] : 0.0f;
  const float g1 = live ? g[3 * rr + 1] : 0.0f;
  const float g2 = live ? g[3 * rr + 2] : 0.0f;
  const float m_shin = m[16];

  // view = normalize(-d)
  const float sd = dx * dx + dy * dy + dz * dz;
  const float inv_d = rsqrtf(fmaxf(sd, kSqrtEps));
  const float vx = -dx * inv_d, vy = -dy * inv_d, vz = -dz * inv_d;

  // ---- forward replay: the summed colour
  float amb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float dif[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float spe[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = 0; j < n_lights; ++j) {
    const float* lg = lights + j * kLightCols;
    for (int c = 0; c < 4; ++c) amb[c] = amb[c] + lg[4 + c] * m[c];
    const LightTerms s = light_terms(lg, px, py, pz, nx, ny, nz, vx, vy, vz,
                                     m_shin, occ[rr * n_lights + j]);
    for (int c = 0; c < 4; ++c) {
      dif[c] = dif[c] + lg[8 + c] * m[4 + c] * s.lit_ct;
      spe[c] = spe[c] + lg[12 + c] * m[8 + c] * s.lit_pw;
    }
  }
  float ph[4];
  for (int c = 0; c < 4; ++c) ph[c] = amb[c] + dif[c] + spe[c] + m[12 + c];

  // ---- backward
  float g_ph[4] = {g0 * ph[3], g1 * ph[3], g2 * ph[3],
                   g0 * ph[0] + g1 * ph[1] + g2 * ph[2]};
  float g_amb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float g_dif[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float g_spe[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float g_shin = 0.0f;
  float gvx = 0.0f, gvy = 0.0f, gvz = 0.0f;
  float gpx = 0.0f, gpy = 0.0f, gpz = 0.0f;
  float gnx = 0.0f, gny = 0.0f, gnz = 0.0f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int j = 0; j < n_lights; ++j) {
    const float* lg = lights + j * kLightCols;
    const LightTerms s = light_terms(lg, px, py, pz, nx, ny, nz, vx, vy, vz,
                                     m_shin, occ[rr * n_lights + j]);
    float g_lit_ct = 0.0f, g_lit_pw = 0.0f;
    for (int c = 0; c < 4; ++c) {
      g_amb[c] = g_amb[c] + lg[4 + c] * g_ph[c];
      g_dif[c] = g_dif[c] + lg[8 + c] * s.lit_ct * g_ph[c];
      g_spe[c] = g_spe[c] + lg[12 + c] * s.lit_pw * g_ph[c];
      g_lit_ct = g_lit_ct + lg[8 + c] * m[4 + c] * g_ph[c];
      g_lit_pw = g_lit_pw + lg[12 + c] * m[8 + c] * g_ph[c];
    }
    const float g_cos_theta = s.lit * g_lit_ct;
    const float g_val = s.cos_phi > 0.0f ? s.lit * g_lit_pw : 0.0f;
    g_shin = g_shin + g_val * s.val * s.logsb;
    const float g_cos_phi =
        s.cos_phi > kPowEps ? g_val * s.val * m_shin / s.sb : 0.0f;
    const float g_ct_raw = s.ct_raw > 0.0f ? g_cos_theta : 0.0f;

    // cos_phi = v . rhat
    gvx = gvx + g_cos_phi * s.rx;
    gvy = gvy + g_cos_phi * s.ry;
    gvz = gvz + g_cos_phi * s.rz;
    const float grhx = g_cos_phi * vx, grhy = g_cos_phi * vy,
                grhz = g_cos_phi * vz;
    // rhat = r0 * inv_r
    const float rdot = s.rx * grhx + s.ry * grhy + s.rz * grhz;
    const float gate_r = s.sr > kSqrtEps ? 1.0f : 0.0f;
    const float gr0x = s.inv_r * (grhx - gate_r * s.rx * rdot);
    const float gr0y = s.inv_r * (grhy - gate_r * s.ry * rdot);
    const float gr0z = s.inv_r * (grhz - gate_r * s.rz * rdot);
    // r0 = -l - 2 dn n
    const float g_dn = -2.0f * (nx * gr0x + ny * gr0y + nz * gr0z);
    gnx = gnx - 2.0f * s.dn * gr0x;
    gny = gny - 2.0f * s.dn * gr0y;
    gnz = gnz - 2.0f * s.dn * gr0z;
    float glx = -gr0x, gly = -gr0y, glz = -gr0z;
    // dn = -(l . n)
    glx = glx - g_dn * nx;
    gly = gly - g_dn * ny;
    glz = glz - g_dn * nz;
    gnx = gnx - g_dn * s.ldx;
    gny = gny - g_dn * s.ldy;
    gnz = gnz - g_dn * s.ldz;
    // ct_raw = l . n
    glx = glx + g_ct_raw * nx;
    gly = gly + g_ct_raw * ny;
    glz = glz + g_ct_raw * nz;
    gnx = gnx + g_ct_raw * s.ldx;
    gny = gny + g_ct_raw * s.ldy;
    gnz = gnz + g_ct_raw * s.ldz;
    // l = tl * inv_tl
    const float ldot = s.ldx * glx + s.ldy * gly + s.ldz * glz;
    const float gate_tl = s.stl > kSqrtEps ? 1.0f : 0.0f;
    const float gtlx = s.inv_tl * (glx - gate_tl * s.ldx * ldot);
    const float gtly = s.inv_tl * (gly - gate_tl * s.ldy * ldot);
    const float gtlz = s.inv_tl * (glz - gate_tl * s.ldz * ldot);
    // tl = light - p
    gpx = gpx - gtlx;
    gpy = gpy - gtly;
    gpz = gpz - gtlz;

    // this light's cotangents, summed over the block's rays
    float lv[kLightGrads];
    lv[0] = gtlx;
    lv[1] = gtly;
    lv[2] = gtlz;
    for (int c = 0; c < 4; ++c) {
      lv[3 + c] = m[c] * g_ph[c];
      lv[7 + c] = m[4 + c] * s.lit_ct * g_ph[c];
      lv[11 + c] = m[8 + c] * s.lit_pw * g_ph[c];
    }
    for (int k = 0; k < kLightGrads; ++k) {
      const float v = warp_sum(live ? lv[k] : 0.0f);
      if (lane == 0) red[warp][k] = v;
    }
    __syncthreads();
    if (threadIdx.x < kLightGrads) {
      float acc = 0.0f;
      for (int w = 0; w < kWarps; ++w) acc = acc + red[w][threadIdx.x];
      g_light_part[static_cast<long long>(blockIdx.x) * n_lights *
                       kLightGrads +
                   j * kLightGrads + threadIdx.x] = acc;
    }
    __syncthreads();
  }
  if (!live) return;

  // v = -d * inv_d (normalize VJP), then g_d = -g_u
  const float vdot = vx * gvx + vy * gvy + vz * gvz;
  const float gate_d = sd > kSqrtEps ? 1.0f : 0.0f;
  g_dirs[3 * r] = -(inv_d * (gvx - gate_d * vx * vdot));
  g_dirs[3 * r + 1] = -(inv_d * (gvy - gate_d * vy * vdot));
  g_dirs[3 * r + 2] = -(inv_d * (gvz - gate_d * vz * vdot));
  g_p[3 * r] = gpx;
  g_p[3 * r + 1] = gpy;
  g_p[3 * r + 2] = gpz;
  g_n[3 * r] = gnx;
  g_n[3 * r + 1] = gny;
  g_n[3 * r + 2] = gnz;
  float4* gm4 = reinterpret_cast<float4*>(g_mat + r * kMatCols);
  gm4[0] = make_float4(g_amb[0], g_amb[1], g_amb[2], g_amb[3]);
  gm4[1] = make_float4(g_dif[0], g_dif[1], g_dif[2], g_dif[3]);
  gm4[2] = make_float4(g_spe[0], g_spe[1], g_spe[2], g_spe[3]);
  gm4[3] = make_float4(g_ph[0], g_ph[1], g_ph[2], g_ph[3]);
  gm4[4] = make_float4(g_shin, 0.0f, 0.0f, 0.0f);
}

}  // namespace
}  // namespace oglrt

// Launch on `stream`. mat and g_mat must be 16-byte aligned (the wrapper
// checks); g_light_part holds ceil(n_rays / 256) * n_lights * 15 floats.
extern "C" int oglrt_phong_shade_bwd(const float* lights, const float* mat,
                                     const float* dirs, const float* hp,
                                     const float* hn, const bool* occ,
                                     const float* g, long long n_rays,
                                     int n_lights, float* g_mat,
                                     float* g_dirs, float* g_p, float* g_n,
                                     float* g_light_part, void* stream) {
  if (n_rays == 0) return 0;
  const long long blocks = (n_rays + oglrt::kBlock - 1) / oglrt::kBlock;
  oglrt::phong_shade_bwd_kernel<<<static_cast<unsigned>(blocks),
                                  oglrt::kBlock, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      lights, mat, dirs, hp, hn, occ, g, n_rays, n_lights, g_mat, g_dirs,
      g_p, g_n, g_light_part);
  return static_cast<int>(cudaGetLastError());
}
