// Kernel 3 (kernel B): per-light shadow occlusion over a tile's survivor
// rows, and over the global sphere table on the hot (tile, light) pairs.
//
// Replaces openglraytracer_tpu/ops/pallas_culled.py::_shadow_kernel (:351,
// the pallas_call at :993) together with the dense pass the reference runs
// in XLA over the hot shadow tiles around it (pallas_culled.py:923-935,
// accel._segment_occluded). Per ray and light: is the segment from the
// offset shadow origin along the UNNORMALIZED direction light - p blocked
// at t in (0, 1) by a sphere, a box or a plane? The answer goes straight
// into the (R, L) occlusion the shade reads. Lights whose bit is clear in
// light_mask (statically unable to change the image) report no occlusion.
//
// Row layouts (written by ops/culled.py):
//   sphere (T, L, Ks, 4):  [c(3) r], r NaN in an invalid slot
//   box    (T, L, Ksb, 24): [mins(3) maxs(3) pos(3) rot(9) valid pad(5)]
//   plane  (P, 16):        [n(3) off ...]
//   counts (T, L, 2) int32: [min(s_count, Ks), min(sb_count, Ksb)]; the
//                           sphere count is -1 on a hot pair
//   spheres (N, 4):        [c(3) r], every sphere of the scene
//   hot_ids (L, M) int32:  the hot tiles of each light (rows of unlit
//                          lights are not read)
// A hot pair tests every sphere instead of its survivor rows: bit for bit
// accel._segment_occluded over the scene. Boxes are never hot.
//
// The sphere test is the sqrt-free predicate of accel._segment_occluded in
// its operation order: 2 * (...), (4 qa) qcs, and r * r as one rounded
// product. A NaN r fails every comparison, so an invalid row never blocks.
//
// What bounds it on the H100: on cold pairs memory traffic (a ray reads 24
// bytes of origin and hit point and writes a byte per light; a pair scans
// a few survivor rows), on hot pairs operations (each hot ray tests the
// spheres up to its first blocker: up to 5.4e8 tests a c5_grid4096 frame,
// where the dense pass built (hot_m, N, P) tensors of a gigabyte an op).
// Design: one thread per ray, 256 rays of one tile a block, in two
// launches. The cold launch (shadow_cold_kernel, a block per tile part,
// every light) writes every (ray, light): a cold pair's survivor spheres,
// then any pair's boxes and planes. It has no barrier: every lane reads
// the same few rows through the read-only cache, four tests between
// checks for a blocker. The hot launch (shadow_hot_kernel) then sets the
// bit of every hot (ray, light) that a sphere blocks. It splits the
// table's chunks among up to four blocks a pair, so that its few pairs
// still fill the card; a block stages its rows as [c r^2] in 1024-row
// chunks (16 KB) read through a register-held shared address
// (common.cuh), a lane runs sixteen independent tests between checks for
// a blocker and stops at the first check that finds one, and a block
// skips its remaining chunks once no lane is open (__syncthreads_or). Two
// launches measured faster than one whose first blocks took the hot
// pairs: the cold blocks slowed the long hot blocks they shared SMs with.
#include "common.cuh"

namespace oglrt {
namespace {

constexpr int kBoxCols = 24;
constexpr int kPlnCols = 16;
constexpr int kHotRows = 1024;   // hot pairs: table rows a staged chunk
constexpr int kHotTests = 16;    // hot pairs: tests between exit checks
constexpr int kColdTests = 4;    // survivor rows: tests between exit checks

struct Args {
  const float* so;         // (R, 3) offset shadow origins
  const float* hp;         // (R, 3) hit points
  const float* lights;     // (L, 3)
  const float4* ssph;      // (T, L, Ks) survivor rows [c r]
  const float* sbox;       // (T, L, Ksb, 24)
  const float* pln;        // (P, 16)
  const int* cnt;          // (T, L, 2)
  const float4* spheres;   // (N) global table [c r]
  const int* hot_ids;      // (L, M)
  bool* occ;               // (R, L)
  unsigned light_mask;
  int tile_p, n_lights, ks, ksb, n_pln, n_sph, n_hot;
};

struct Ray {   // a ray's cast origin and hit point
  float sx, sy, sz, px, py, pz;
};

struct Segment {   // one ray's shadow segment towards one light
  float sx, sy, sz;      // cast origin
  float tlx, tly, tlz;   // light - p, unnormalized
  float qa;
};

__device__ __forceinline__ Ray load_ray(const Args& a, long long r) {
  return Ray{a.so[3 * r], a.so[3 * r + 1], a.so[3 * r + 2],
             a.hp[3 * r], a.hp[3 * r + 1], a.hp[3 * r + 2]};
}

__device__ __forceinline__ Segment segment(const Args& a, const Ray& ray,
                                           int li) {
  Segment s;
  s.sx = ray.sx;
  s.sy = ray.sy;
  s.sz = ray.sz;
  s.tlx = a.lights[3 * li] - ray.px;
  s.tly = a.lights[3 * li + 1] - ray.py;
  s.tlz = a.lights[3 * li + 2] - ray.pz;
  s.qa = s.tlx * s.tlx + s.tly * s.tly + s.tlz * s.tlz;
  return s;
}

// accel._segment_occluded for one sphere, row [c r^2]; the caller has
// checked qa > _DIV_EPS (without it no sphere blocks)
__device__ __forceinline__ bool sphere_blocked(const Segment& s, float4 row) {
  const float socx = s.sx - row.x;
  const float socy = s.sy - row.y;
  const float socz = s.sz - row.z;
  const float qb = 2.0f * (s.tlx * socx + s.tly * socy + s.tlz * socz);
  const float qcs = socx * socx + socy * socy + socz * socz - row.w;
  const float f_end = s.qa + qb + qcs;
  if (qcs < 0.0f) return f_end > 0.0f;   // cast origin inside the sphere:
                                         // blocked iff the end is outside
  const bool disc_ok = qb * qb >= 4.0f * s.qa * qcs;
  const bool vertex_in = (qb < 0.0f) && (-qb < 2.0f * s.qa);
  return (f_end < 0.0f) || (disc_ok && vertex_in);
}

__device__ __forceinline__ bool box_blocked(const float* __restrict__ row,
                                            const Segment& s) {
  const float bm0 = row[0], bm1 = row[1], bm2 = row[2];
  const float bx0 = row[3], bx1 = row[4], bx2 = row[5];
  const float r00 = row[9], r01 = row[10], r02 = row[11];
  const float r10 = row[12], r11 = row[13], r12 = row[14];
  const float r20 = row[15], r21 = row[16], r22 = row[17];
  const float wx = s.sx - row[6];
  const float wy = s.sy - row[7];
  const float wz = s.sz - row[8];
  const float rox = r00 * wx + r10 * wy + r20 * wz;
  const float roy = r01 * wx + r11 * wy + r21 * wz;
  const float roz = r02 * wx + r12 * wy + r22 * wz;
  const float rdx = r00 * s.tlx + r10 * s.tly + r20 * s.tlz;
  const float rdy = r01 * s.tlx + r11 * s.tly + r21 * s.tlz;
  const float rdz = r02 * s.tlx + r12 * s.tly + r22 * s.tlz;
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

__device__ __forceinline__ bool plane_blocked(const float* __restrict__ row,
                                              const Segment& s) {
  const float nd = row[0] * s.tlx + row[1] * s.tly + row[2] * s.tlz;
  const float no = row[0] * s.sx + row[1] * s.sy + row[2] * s.sz;
  const float t = (row[3] - no) * inv_safe(nd);
  return (fabsf(nd) > 1.0e-9f) && (t > 0.0f) && (t < 1.0f);
}

// survivor row j of a pair as [c r^2], read through the read-only cache
__device__ __forceinline__ float4 survivor_row(const float4* rows, int j) {
  float4 row = __ldg(rows + j);
  row.w = row.w * row.w;
  return row;
}

// the boxes and planes of pair tl, in row order, up to the first blocker
__device__ __forceinline__ bool boxes_or_planes(const Args& a, long long tl,
                                                const Segment& s) {
  const int nsb = min(a.cnt[2 * tl + 1], a.ksb);
  const float* boxes = a.sbox + tl * a.ksb * kBoxCols;
  bool o = false;
  for (int j = 0; j < nsb && !o; ++j)
    o = box_blocked(boxes + j * kBoxCols, s);
  for (int k = 0; k < a.n_pln && !o; ++k)
    o = plane_blocked(a.pln + k * kPlnCols, s);
  return o;
}

// grid (T, ceil(tile_p / kBlock)): every (ray, light) of tile blockIdx.x;
// a hot pair's spheres are left to the hot launch
__global__ void __launch_bounds__(kBlock) shadow_cold_kernel(Args a) {
  const int tile = blockIdx.x;
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  if (p >= a.tile_p) return;   // no barrier in this kernel
  const long long r = static_cast<long long>(tile) * a.tile_p + p;
  const Ray ray = load_ray(a, r);
  for (int li = 0; li < a.n_lights; ++li) {
    const long long tl = static_cast<long long>(tile) * a.n_lights + li;
    bool o = false;
    if ((a.light_mask >> li) & 1u) {
      const Segment s = segment(a, ray, li);
      const int ns = min(a.cnt[2 * tl], a.ks);   // -1 on a hot pair
      if (s.qa > kDivEps) {
        // kColdTests tests between exit checks, their row loads in flight
        // together; a test past the first blocker leaves the OR unchanged
        const float4* rows = a.ssph + tl * a.ks;
        int j = 0;
        for (; j + kColdTests <= ns && !o; j += kColdTests) {
#pragma unroll
          for (int u = 0; u < kColdTests; ++u)
            o |= sphere_blocked(s, survivor_row(rows, j + u));
        }
        for (; j < ns && !o; ++j) o = sphere_blocked(s, survivor_row(rows, j));
      }
      if (!o) o = boxes_or_planes(a, tl, s);
    }
    a.occ[r * a.n_lights + li] = o;
  }
}

// grid (L * M * splits, ceil(tile_p / kBlock)), after the cold launch:
// block b tests the hot pair (hot_ids[b / splits], light b / (M * splits))
// against share b % splits of the table's chunks, and sets the bit of
// every ray a sphere of its share blocks
__global__ void __launch_bounds__(kBlock) shadow_hot_kernel(Args a,
                                                            int splits) {
  __shared__ float4 s_row[kHotRows];
  const int pair = blockIdx.x / splits;
  const int li = pair / a.n_hot;
  if (!((a.light_mask >> li) & 1u)) return;   // uniform over the block
  const int chunks = (a.n_sph + kHotRows - 1) / kHotRows;
  const int per = (chunks + splits - 1) / splits;
  const int lo = (blockIdx.x % splits) * per * kHotRows;
  const int hi = min(a.n_sph, lo + per * kHotRows);
  const int tile = a.hot_ids[pair];
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = p < a.tile_p;
  const long long r = static_cast<long long>(tile) * a.tile_p + p;
  Segment s{};
  if (live) s = segment(a, load_ray(a, r), li);
  bool open = live && s.qa > kDivEps, blocked = false;
  const unsigned rows = smem_addr(s_row);
  for (int base = lo; base < hi; base += kHotRows) {
    // also the barrier after which the previous chunk may be overwritten
    if (!__syncthreads_or(open)) break;
    const int m = min(kHotRows, hi - base);
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      float4 row = __ldg(a.spheres + base + i);
      row.w = row.w * row.w;
      s_row[i] = row;
    }
    __syncthreads();
    if (open) {
      // kHotTests independent tests between exit checks: a lane may test
      // a few rows past its first blocker, which leaves the OR unchanged
      int j = 0;
      for (; j + kHotTests <= m && !blocked; j += kHotTests) {
#pragma unroll
        for (int u = 0; u < kHotTests; ++u)
          blocked |= sphere_blocked(s, staged_row(rows, j + u));
      }
      for (; j < m && !blocked; ++j)
        blocked = sphere_blocked(s, staged_row(rows, j));
      open = !blocked;
    }
  }
  if (blocked) a.occ[r * a.n_lights + li] = true;
}

}  // namespace
}  // namespace oglrt

namespace {

oglrt::Args args(const float* so, const float* hp, const float* lights,
                 unsigned light_mask, const float* ssph, const float* sbox,
                 const float* pln, const int* cnt, int tile_p, int n_lights,
                 int ks, int ksb, int n_pln, const float* spheres, int n_sph,
                 const int* hot_ids, int n_hot, bool* occ) {
  return oglrt::Args{so, hp, lights,
                     reinterpret_cast<const float4*>(ssph), sbox, pln, cnt,
                     reinterpret_cast<const float4*>(spheres), hot_ids, occ,
                     light_mask, tile_p, n_lights, ks, ksb, n_pln, n_sph,
                     n_hot};
}

}  // namespace

// The cold launch: every (ray, light), the hot pairs' spheres left out.
extern "C" int oglrt_shadow_occlusion(
    const float* so, const float* hp, const float* lights,
    unsigned light_mask, const float* ssph, const float* sbox,
    const float* pln, const int* cnt, int n_tiles, int tile_p, int n_lights,
    int ks, int ksb, int n_pln, const float* spheres, int n_sph,
    const int* hot_ids, int n_hot, bool* occ, void* stream) {
  if (n_tiles == 0 || tile_p == 0 || n_lights == 0) return 0;
  const int parts = (tile_p + oglrt::kBlock - 1) / oglrt::kBlock;
  oglrt::shadow_cold_kernel<<<dim3(n_tiles, parts), oglrt::kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      args(so, hp, lights, light_mask, ssph, sbox, pln, cnt, tile_p,
           n_lights, ks, ksb, n_pln, spheres, n_sph, hot_ids, n_hot, occ));
  return static_cast<int>(cudaGetLastError());
}

// The hot launch, after the cold one on the same arguments: the hot pairs'
// spheres. Each pair's table is split among as many blocks as would make
// the launch one wave of the card at 2048 threads an SM, at most one a
// staged chunk (splitting by the blocks an SM really holds at the
// kernel's registers measured no faster).
extern "C" int oglrt_shadow_hot(
    const float* so, const float* hp, const float* lights,
    unsigned light_mask, const float* ssph, const float* sbox,
    const float* pln, const int* cnt, int n_tiles, int tile_p, int n_lights,
    int ks, int ksb, int n_pln, const float* spheres, int n_sph,
    const int* hot_ids, int n_hot, bool* occ, void* stream) {
  if (n_hot == 0 || n_sph == 0 || tile_p == 0 || n_lights == 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int parts = (tile_p + oglrt::kBlock - 1) / oglrt::kBlock;
  const int blocks = n_lights * n_hot * parts;
  const int chunks = (n_sph + oglrt::kHotRows - 1) / oglrt::kHotRows;
  int splits = sms * (2048 / oglrt::kBlock) / blocks;
  splits = splits < 1 ? 1 : (splits > chunks ? chunks : splits);
  const int per = (chunks + splits - 1) / splits;
  splits = (chunks + per - 1) / per;   // no share left empty
  oglrt::shadow_hot_kernel<<<dim3(n_lights * n_hot * splits, parts),
                             oglrt::kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      args(so, hp, lights, light_mask, ssph, sbox, pln, cnt, tile_p,
           n_lights, ks, ksb, n_pln, spheres, n_sph, hot_ids, n_hot, occ),
      splits);
  return static_cast<int>(cudaGetLastError());
}
