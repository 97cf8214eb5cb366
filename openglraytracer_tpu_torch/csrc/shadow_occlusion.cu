// Kernel B: per-light shadow occlusion over a tile's survivor rows.
//
// Replaces openglraytracer_tpu/ops/pallas_culled.py::_shadow_kernel (the
// pallas_call in culled_geometry_pallas). Per ray and light: is the segment
// from the offset shadow origin along the UNNORMALIZED direction
// light - p blocked at t in (0, 1)? Sphere occlusion (occ_s) is kept apart
// from box and plane occlusion (occ_o), so that the dense pass over hot
// tiles can replace the sphere column. Lights whose bit is clear in
// light_mask (statically unable to change the image) are skipped and
// report no occlusion.
//
// Row layouts (written by ops/culled.py):
//   sphere (T, L, Ks, 8):  [c(3) r valid pad(3)]
//   box    (T, L, Ksb, 24): [mins(3) maxs(3) pos(3) rot(9) valid pad(5)]
//   plane  (P, 16):        [n(3) off ...]
//   counts (T, L, 2) int32: [min(s_count, Ks) (0 on hot tiles),
//                            min(sb_count, Ksb)]
//
// The sphere test is the sqrt-free predicate of
// openglraytracer_tpu/ops/accel.py::_segment_occluded, written as booleans.
//
// What bounds it on the H100: memory traffic. A ray reads 24 bytes of
// origin and hit point and writes one byte per light and column; a
// survivor costs about 20 float ops, and at the c3 cell a tile keeps 5.6
// and 2.2 occluders for its two lights on average. Same design as kernel A:
// one thread per ray, blocks of 256 rays inside one tile, rows staged in
// shared memory in chunks, each (tile, light) looping to its own count.
#include "common.cuh"

namespace oglrt {
namespace {

constexpr int kSphCols = 8;
constexpr int kBoxCols = 24;
constexpr int kPlnCols = 16;
constexpr int kSphChunk = 64;
constexpr int kBoxChunk = 32;

__device__ __forceinline__ bool sphere_blocked(const float* row, float sx,
                                               float sy, float sz, float tlx,
                                               float tly, float tlz, float qa,
                                               bool qa_ok) {
  const float socx = sx - row[0];
  const float socy = sy - row[1];
  const float socz = sz - row[2];
  const float r = row[3];
  const float qb = 2.0f * (tlx * socx + tly * socy + tlz * socz);
  const float qcs = socx * socx + socy * socy + socz * socz - r * r;
  const float f_end = qa + qb + qcs;
  bool blocked;
  if (qcs < 0.0f) {   // cast origin inside the sphere: blocked iff the
    blocked = f_end > 0.0f;   // segment end is outside it
  } else {
    const bool disc_ok = qb * qb >= 4.0f * qa * qcs;
    const bool vertex_in = (qb < 0.0f) && (-qb < 2.0f * qa);
    blocked = (f_end < 0.0f) || (disc_ok && vertex_in);
  }
  return blocked && qa_ok && (row[4] > 0.5f);
}

__device__ __forceinline__ bool box_blocked(const float* row, float sx,
                                            float sy, float sz, float tlx,
                                            float tly, float tlz) {
  const float bm0 = row[0], bm1 = row[1], bm2 = row[2];
  const float bx0 = row[3], bx1 = row[4], bx2 = row[5];
  const float r00 = row[9], r01 = row[10], r02 = row[11];
  const float r10 = row[12], r11 = row[13], r12 = row[14];
  const float r20 = row[15], r21 = row[16], r22 = row[17];
  const float wx = sx - row[6];
  const float wy = sy - row[7];
  const float wz = sz - row[8];
  const float rox = r00 * wx + r10 * wy + r20 * wz;
  const float roy = r01 * wx + r11 * wy + r21 * wz;
  const float roz = r02 * wx + r12 * wy + r22 * wz;
  const float rdx = r00 * tlx + r10 * tly + r20 * tlz;
  const float rdy = r01 * tlx + r11 * tly + r21 * tlz;
  const float rdz = r02 * tlx + r12 * tly + r22 * tlz;
  const float ix = inv_safe(rdx), iy = inv_safe(rdy), iz = inv_safe(rdz);
  const float tax = (bm0 - rox) * ix, tbx = (bx0 - rox) * ix;
  const float tay = (bm1 - roy) * iy, tby = (bx1 - roy) * iy;
  const float taz = (bm2 - roz) * iz, tbz = (bx2 - roz) * iz;
  const float t1 =
      fmaxf(fminf(tax, tbx), fmaxf(fminf(tay, tby), fminf(taz, tbz)));
  const float t2 =
      fminf(fmaxf(tax, tbx), fminf(fmaxf(tay, tby), fmaxf(taz, tbz)));
  const bool ok = (t1 < t2) && (t2 > 0.0f) && (row[18] > 0.5f);
  const float t = (ok && (t1 < 0.0f)) ? t2 : t1;
  return ok && (t > 0.0f) && (t < 1.0f);
}

__device__ __forceinline__ bool plane_blocked(const float* row, float sx,
                                              float sy, float sz, float tlx,
                                              float tly, float tlz) {
  const float nd = row[0] * tlx + row[1] * tly + row[2] * tlz;
  const float no = row[0] * sx + row[1] * sy + row[2] * sz;
  const float t = (row[3] - no) * inv_safe(nd);
  return (fabsf(nd) > 1.0e-9f) && (t > 0.0f) && (t < 1.0f);
}

// grid (T, ceil(tile_p / kBlock)); block kBlock rays of one tile
__global__ void __launch_bounds__(kBlock) shadow_occlusion_kernel(
    const float* __restrict__ so, const float* __restrict__ hp,
    const float* __restrict__ lights, unsigned light_mask,
    const float* __restrict__ ssph, const float* __restrict__ sbox,
    const float* __restrict__ pln, const int* __restrict__ cnt, int tile_p,
    int n_lights, int ks, int ksb, int n_pln, bool* __restrict__ occ_s,
    bool* __restrict__ occ_o) {
  __shared__ float s_sph[kSphChunk * kSphCols];
  __shared__ float s_box[kBoxChunk * kBoxCols];

  const int tile = blockIdx.x;
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = p < tile_p;
  const long long r = static_cast<long long>(tile) * tile_p + p;

  float sx = 0.0f, sy = 0.0f, sz = 0.0f, px = 0.0f, py = 0.0f, pz = 0.0f;
  if (live) {
    sx = so[3 * r];
    sy = so[3 * r + 1];
    sz = so[3 * r + 2];
    px = hp[3 * r];
    py = hp[3 * r + 1];
    pz = hp[3 * r + 2];
  }

  for (int li = 0; li < n_lights; ++li) {
    const long long tl = static_cast<long long>(tile) * n_lights + li;
    bool os = false, oo = false;
    if ((light_mask >> li) & 1u) {   // uniform over the block
      const float tlx = lights[3 * li] - px;
      const float tly = lights[3 * li + 1] - py;
      const float tlz = lights[3 * li + 2] - pz;
      const float qa = tlx * tlx + tly * tly + tlz * tlz;
      const bool qa_ok = qa > kDivEps;

      const int ns = min(cnt[2 * tl], ks);
      const float* rows = ssph + tl * ks * kSphCols;
      for (int base = 0; base < ns; base += kSphChunk) {
        const int m = min(kSphChunk, ns - base);
        __syncthreads();
        for (int i = threadIdx.x; i < m * kSphCols; i += blockDim.x)
          s_sph[i] = rows[base * kSphCols + i];
        __syncthreads();
        if (live)
          for (int jj = 0; jj < m && !os; ++jj)
            os = sphere_blocked(&s_sph[jj * kSphCols], sx, sy, sz, tlx, tly,
                                tlz, qa, qa_ok);
      }

      const int nsb = min(cnt[2 * tl + 1], ksb);
      const float* brows = sbox + tl * ksb * kBoxCols;
      for (int base = 0; base < nsb; base += kBoxChunk) {
        const int m = min(kBoxChunk, nsb - base);
        __syncthreads();
        for (int i = threadIdx.x; i < m * kBoxCols; i += blockDim.x)
          s_box[i] = brows[base * kBoxCols + i];
        __syncthreads();
        if (live)
          for (int jj = 0; jj < m && !oo; ++jj)
            oo = box_blocked(&s_box[jj * kBoxCols], sx, sy, sz, tlx, tly,
                             tlz);
      }
      for (int k = 0; k < n_pln && !oo; ++k)
        oo = plane_blocked(pln + k * kPlnCols, sx, sy, sz, tlx, tly, tlz);
    }
    if (live) {
      occ_s[tl * tile_p + p] = os;
      occ_o[tl * tile_p + p] = oo;
    }
  }
}

}  // namespace
}  // namespace oglrt

extern "C" int oglrt_shadow_occlusion(const float* so, const float* hp,
                                      const float* lights,
                                      unsigned light_mask, const float* ssph,
                                      const float* sbox, const float* pln,
                                      const int* cnt, int n_tiles, int tile_p,
                                      int n_lights, int ks, int ksb,
                                      int n_pln, bool* occ_s, bool* occ_o,
                                      void* stream) {
  if (n_tiles == 0 || tile_p == 0) return 0;
  const dim3 grid(n_tiles, (tile_p + oglrt::kBlock - 1) / oglrt::kBlock);
  oglrt::shadow_occlusion_kernel<<<grid, oglrt::kBlock, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      so, hp, lights, light_mask, ssph, sbox, pln, cnt, tile_p, n_lights, ks,
      ksb, n_pln, occ_s, occ_o);
  return static_cast<int>(cudaGetLastError());
}
