// Kernel 7: the dense closest hit and per-light occlusion of every ray
// against every object.
//
// Replaces openglraytracer_tpu/ops/pallas_render.py::_geometry_kernel (the
// pallas_call of pallas_geometry, engine 'pallas'). Per ray:
//   1. the closest hit over all N spheres, then all M oriented boxes (slab
//      test in the box's frame; face pick by exact equality of t with the
//      winning slab boundary, y before z), then all P planes. Running
//      minimum with strict <: the first object wins a tie, objects beat
//      planes at equal t.
//   2. the finalize: the normal normalized (sphere normals are carried as
//      p - c and flipped here when the ray started inside), zero on a miss;
//      p = o + t d with t zeroed on a miss.
//   3. for every light, occlusion of the unnormalized segment from
//      p + 0.01 n to the light (t in (0, 1)) by every object. Every light
//      casts, as in the reference kernel; on a miss the segment starts at o.
// Output: t (INF_T when nothing was hit, a hit is t < MISS_T), the unit
// normal, inside (false on a miss), the global object id (spheres, boxes,
// planes; -1 on a miss) and occ (L, R) as bytes.
//
// Tables (written by ops/dense.py _scene_tables): spheres (N, 4) [c r];
// boxes (M, 18) [mins(3) maxs(3) pos(3) rot(9) row-major]; planes (P, 4)
// [unit normal, offset]; lights (L, 3).
//
// Rounding: every op rounds as IEEE float32 (--fmad=false, no fast math),
// with fmaf written out where XLA's CPU compiler contracts the reference
// kernel's multiply-adds (the three-term dot products, the discriminant,
// o + t d and p + 0.01 n), so that t equals the JAX package's bit for bit.
// The plain version (dense_hit_plain) emulates each fmaf. The normal is
// normalized with 1 / sqrtf, correctly rounded, not rsqrtf.
//
// What bounds it on the H100: arithmetic. A ray reads 24 bytes and writes
// 21 + L; it costs about 40 float ops per sphere of the closest hit and 25
// per (light, sphere) of the occlusion, about 100 and 90 per box. At c3
// (64 spheres, 2 lights, 1024^2 rays) that is some 7e9 ops, about 0.1 ms
// at 67 TFLOP/s, against 0.015 ms of bytes at 3.35 TB/s. The design keeps
// each object's parameters out of device memory's way: one thread per ray,
// blocks of 256 rays, and the tables staged in shared memory in fixed-size
// chunks, so any N, M, P fits and every table row is read once per block
// and pass from L2, then broadcast to the block's 256 rays. A table that
// fits in one chunk (every measured scene) is staged once per block; a
// longer one once per pass, the closest hit's and each light's. Most tests
// are misses, and most of their cost was work whose result is thrown away:
//   (a) a sphere test whose discriminant is negative takes no root: the
//       square root and both roots run under disc >= 0 only (a miss is not
//       ok either way, so the result is the same);
//   (b) a lane stops testing a light's segment once it is blocked (the OR
//       cannot change). It asks before each box test (a slab test costs
//       several sphere misses) and before each chunk of spheres and of
//       planes, not before each sphere: a check per sphere cost the c3
//       grid more than its blocked lanes saved. A warp leaves once all its
//       lanes have. No barrier sits inside the loops over a staged chunk;
//       where a table is staged in several chunks every thread still
//       reaches every stage() barrier and only skips the tests;
//   (c) the sphere rows are staged as [c r^2], r^2 = r * r rounded once
//       per row where the reference kernel rounds the same product per
//       test;
//   (e) the staged sphere rows are read through a shared-memory address
//       held in a register (staged_row in common.cuh).
// The measurements of each step are in PERF.md.
#include "common.cuh"

namespace oglrt {
namespace {

constexpr int kSphCols = 4;
constexpr int kBoxCols = 18;
constexpr int kPlnCols = 4;
constexpr int kSphChunk = 256;   // sphere rows staged per pass (4 KB)
constexpr int kBoxChunk = 64;    // box rows staged per pass (4.5 KB)
constexpr int kPlnChunk = 64;    // plane rows staged per pass (1 KB)
constexpr float kShadowEps = 0.01f;  // ops/shading.py SHADOW_EPS

// a . b rounded as the reference kernel: fma(z, fma(x, y * y))
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return fmaf(az, bz, fmaf(ax, bx, ay * by));
}

struct SphereQuad {
  float ocx, ocy, ocz, qb, disc;
};

// The quadratic of p + t v against staged sphere row [c r^2].
__device__ __forceinline__ SphereQuad sphere_quad(const float4 row, float px,
                                                  float py, float pz,
                                                  float vx, float vy,
                                                  float vz, float qa) {
  SphereQuad q;
  q.ocx = px - row.x;
  q.ocy = py - row.y;
  q.ocz = pz - row.z;
  q.qb = 2.0f * dot3(vx, vy, vz, q.ocx, q.ocy, q.ocz);
  const float qc = dot3(q.ocx, q.ocy, q.ocz, q.ocx, q.ocy, q.ocz) - row.w;
  q.disc = fmaf(q.qb, q.qb, -(4.0f * qa * qc));
  return q;
}

// Whether the test can skip its root: a negative discriminant is no hit.
__device__ __forceinline__ bool sphere_miss(const SphereQuad& q) {
  return !(q.disc >= 0.0f);
}

struct SphereRoot {
  float t;
  bool ok, is_in;
};

// Its roots: t, whether it hits (t > 0), and whether p is inside.
__device__ __forceinline__ SphereRoot sphere_root(const SphereQuad& q,
                                                  float inv_2qa) {
  SphereRoot s;
  const float sq = sqrtf(fmaxf(q.disc, 0.0f));
  const float t1 = (sq - q.qb) * inv_2qa;
  const float t2 = (-sq - q.qb) * inv_2qa;
  const float t_near = fminf(t1, t2);
  const float t_far = fmaxf(t1, t2);
  s.is_in = t_near < 0.0f;
  s.t = s.is_in ? t_far : t_near;
  s.ok = (q.disc >= 0.0f) && (t_far >= 0.0f) && (s.t > 0.0f);
  return s;
}

struct Slab {
  float t, rdx, rdy, rdz, t1y, t1z, t2y, t2z;
  bool ok, is_in;
};

// The slab test of p + t v against box row [mins maxs pos rot(9)].
__device__ __forceinline__ Slab box_slab(const float* row, float px, float py,
                                         float pz, float vx, float vy,
                                         float vz) {
  const float r00 = row[9], r01 = row[10], r02 = row[11];
  const float r10 = row[12], r11 = row[13], r12 = row[14];
  const float r20 = row[15], r21 = row[16], r22 = row[17];
  const float wx = px - row[6], wy = py - row[7], wz = pz - row[8];
  // world -> local: R^T (x - pos), R^T v
  const float rox = dot3(wx, wy, wz, r00, r10, r20);
  const float roy = dot3(wx, wy, wz, r01, r11, r21);
  const float roz = dot3(wx, wy, wz, r02, r12, r22);
  Slab s;
  s.rdx = dot3(vx, vy, vz, r00, r10, r20);
  s.rdy = dot3(vx, vy, vz, r01, r11, r21);
  s.rdz = dot3(vx, vy, vz, r02, r12, r22);
  // the reciprocal, then a multiply (never a division): the face pick
  // compares these slab t's for equality
  const float ix = inv_safe(s.rdx), iy = inv_safe(s.rdy),
              iz = inv_safe(s.rdz);
  const float tax = (row[0] - rox) * ix, tbx = (row[3] - rox) * ix;
  const float tay = (row[1] - roy) * iy, tby = (row[4] - roy) * iy;
  const float taz = (row[2] - roz) * iz, tbz = (row[5] - roz) * iz;
  const float t1x = fminf(tax, tbx), t2x = fmaxf(tax, tbx);
  s.t1y = fminf(tay, tby);
  s.t2y = fmaxf(tay, tby);
  s.t1z = fminf(taz, tbz);
  s.t2z = fmaxf(taz, tbz);
  const float t_near = fmaxf(t1x, fmaxf(s.t1y, s.t1z));
  const float t_far = fminf(t2x, fminf(s.t2y, s.t2z));
  s.is_in = t_near < 0.0f;
  s.t = s.is_in ? t_far : t_near;
  s.ok = (t_near < t_far) && (t_far > 0.0f) && (s.t > 0.0f);
  return s;
}

// (t, nd) of p + t v against plane row [unit n, off]: a division, as the
// reference kernel.
__device__ __forceinline__ float plane_t(const float* row, float px,
                                         float py, float pz, float vx,
                                         float vy, float vz, float* nd_out) {
  const float nd = dot3(row[0], row[1], row[2], vx, vy, vz);
  const float no = dot3(row[0], row[1], row[2], px, py, pz);
  const float nd_safe =
      fabsf(nd) < kDivEps ? (nd < 0.0f ? -kDivEps : kDivEps) : nd;
  *nd_out = nd;
  return (row[3] - no) / nd_safe;
}

// Stage rows [base, base + m) of a (rows, cols) table into shared memory.
// Every thread of the block calls it (it holds both barriers).
//
// A table of n rows that fits in one chunk was staged by the closest hit
// and stays in place (each table has its own buffer): the occlusion passes
// (resident) skip it, so such a table is staged once per block.
__device__ __forceinline__ void stage(float* dst, const float* src, int base,
                                      int m, int cols, bool resident = false) {
  if (resident) return;   // uniform over the block
  __syncthreads();   // the previous chunk is consumed
  for (int i = threadIdx.x; i < m * cols; i += blockDim.x)
    dst[i] = src[base * cols + i];
  __syncthreads();
}

// stage() for the sphere table: rows [c r] staged as [c r^2], see (c).
__device__ __forceinline__ void stage_spheres(float4* dst, const float* src,
                                              int base, int m,
                                              bool resident = false) {
  if (resident) return;   // uniform over the block
  __syncthreads();   // the previous chunk is consumed
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const float* row = src + (base + i) * kSphCols;
    dst[i] = make_float4(row[0], row[1], row[2], row[3] * row[3]);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kBlock) dense_hit_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ sph, const float* __restrict__ box,
    const float* __restrict__ pln, const float* __restrict__ lights,
    int n_rays, int n_sph, int n_box, int n_pln, int n_lights,
    float* __restrict__ t_out, float* __restrict__ n_out,
    bool* __restrict__ ins_out, int* __restrict__ idx_out,
    bool* __restrict__ occ_out) {
  __shared__ float4 s_sph[kSphChunk];
  __shared__ float s_box[kBoxChunk * kBoxCols];
  __shared__ float s_pln[kPlnChunk * kPlnCols];

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < n_rays;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (live) {
    ox = origins[3 * r];
    oy = origins[3 * r + 1];
    oz = origins[3 * r + 2];
    dx = dirs[3 * r];
    dy = dirs[3 * r + 1];
    dz = dirs[3 * r + 2];
  }
  const float qa = dot3(dx, dy, dz, dx, dy, dz);
  const float inv_2qa = 0.5f / fmaxf(qa, kDivEps);
  const unsigned sph_rows = smem_addr(s_sph);

  float tb = kInfT, nx = 0.0f, ny = 0.0f, nz = 0.0f;
  bool ins = false, flp = false;
  int idx = 0;

  // 1. closest hit; sphere normals kept as p - c, flipped at the finalize
  for (int base = 0; base < n_sph; base += kSphChunk) {
    const int m = min(kSphChunk, n_sph - base);
    stage_spheres(s_sph, sph, base, m);
    for (int j = 0; j < m; ++j) {
      const SphereQuad q = sphere_quad(staged_row(sph_rows, j), ox, oy, oz,
                                       dx, dy, dz, qa);
      if (sphere_miss(q)) continue;
      const SphereRoot s = sphere_root(q, inv_2qa);
      const float t = s.ok ? s.t : kInfT;
      if (t < tb) {
        tb = t;
        nx = fmaf(t, dx, q.ocx);
        ny = fmaf(t, dy, q.ocy);
        nz = fmaf(t, dz, q.ocz);
        ins = s.is_in;
        flp = s.is_in;
        idx = base + j;
      }
    }
  }
  for (int base = 0; base < n_box; base += kBoxChunk) {
    const int m = min(kBoxChunk, n_box - base);
    stage(s_box, box, base, m, kBoxCols);
    for (int j = 0; j < m; ++j) {
      const float* row = &s_box[j * kBoxCols];
      const Slab s = box_slab(row, ox, oy, oz, dx, dy, dz);
      const float t = s.ok ? s.t : kInfT;
      if (t < tb) {
        // face pick: exact equality with the winning slab boundary, y
        // before z; entry compares t1, exit t2
        const float by = s.is_in ? s.t2y : s.t1y;
        const float bz = s.is_in ? s.t2z : s.t1z;
        const bool face_y = t == by;
        const bool face_z = !face_y && (t == bz);
        const bool face_x = !(face_y || face_z);
        const float rd_face = face_y ? s.rdy : (face_z ? s.rdz : s.rdx);
        const float sgn = rd_face > 0.0f ? -1.0f : 1.0f;
        const float nlx = face_x ? sgn : 0.0f;
        const float nly = face_y ? sgn : 0.0f;
        const float nlz = face_z ? sgn : 0.0f;
        tb = t;
        // local -> world: R n_local
        nx = row[9] * nlx + row[10] * nly + row[11] * nlz;
        ny = row[12] * nlx + row[13] * nly + row[14] * nlz;
        nz = row[15] * nlx + row[16] * nly + row[17] * nlz;
        ins = s.is_in;
        flp = false;
        idx = n_sph + base + j;
      }
    }
  }
  for (int base = 0; base < n_pln; base += kPlnChunk) {
    const int m = min(kPlnChunk, n_pln - base);
    stage(s_pln, pln, base, m, kPlnCols);
    for (int k = 0; k < m; ++k) {
      const float* row = &s_pln[k * kPlnCols];
      float nd;
      float t = plane_t(row, ox, oy, oz, dx, dy, dz, &nd);
      t = (fabsf(nd) > 1.0e-9f && t > 0.0f) ? t : kInfT;
      if (t < tb) {   // strict: objects beat planes at equal t
        const float s = nd > 0.0f ? -1.0f : 1.0f;   // faces the ray
        tb = t;
        nx = row[0] * s;
        ny = row[1] * s;
        nz = row[2] * s;
        ins = false;
        flp = false;
        idx = n_sph + n_box + base + k;
      }
    }
  }

  // 2. finalize
  const bool hit = tb < kMissT;
  const float ts = hit ? tb : 0.0f;
  const float inv_len = 1.0f / sqrtf(fmaxf(dot3(nx, ny, nz, nx, ny, nz),
                                           kSqrtEps));
  const float sgn = (flp ? -inv_len : inv_len) * (hit ? 1.0f : 0.0f);
  nx *= sgn;
  ny *= sgn;
  nz *= sgn;
  const float px = fmaf(ts, dx, ox), py = fmaf(ts, dy, oy),
              pz = fmaf(ts, dz, oz);
  if (live) {
    t_out[r] = tb;
    n_out[3 * r] = nx;
    n_out[3 * r + 1] = ny;
    n_out[3 * r + 2] = nz;
    ins_out[r] = ins && hit;
    idx_out[r] = hit ? idx : -1;
  }

  // 3. occlusion of every light's segment from the offset origin
  const float sx = fmaf(kShadowEps, nx, px), sy = fmaf(kShadowEps, ny, py),
              sz = fmaf(kShadowEps, nz, pz);
  for (int l = 0; l < n_lights; ++l) {
    const float tlx = lights[3 * l] - px;
    const float tly = lights[3 * l + 1] - py;
    const float tlz = lights[3 * l + 2] - pz;
    const float sqa = dot3(tlx, tly, tlz, tlx, tly, tlz);
    const float sinv_2qa = 0.5f / fmaxf(sqa, kDivEps);
    // a lane past the last ray has nothing to test, see (b)
    bool blocked = !live;
    for (int base = 0; base < n_sph; base += kSphChunk) {
      const int m = min(kSphChunk, n_sph - base);
      stage_spheres(s_sph, sph, base, m, n_sph <= kSphChunk);
      if (blocked) continue;   // to the next stage()
      for (int j = 0; j < m; ++j) {
        const SphereQuad q = sphere_quad(staged_row(sph_rows, j), sx, sy,
                                         sz, tlx, tly, tlz, sqa);
        if (sphere_miss(q)) continue;
        const SphereRoot s = sphere_root(q, sinv_2qa);
        blocked |= s.ok && (s.t < 1.0f);
      }
    }
    for (int base = 0; base < n_box; base += kBoxChunk) {
      const int m = min(kBoxChunk, n_box - base);
      stage(s_box, box, base, m, kBoxCols, n_box <= kBoxChunk);
      for (int j = 0; j < m && !blocked; ++j) {
        const Slab s = box_slab(&s_box[j * kBoxCols], sx, sy, sz, tlx, tly,
                                tlz);
        blocked |= s.ok && (s.t < 1.0f);
      }
    }
    for (int base = 0; base < n_pln; base += kPlnChunk) {
      const int m = min(kPlnChunk, n_pln - base);
      stage(s_pln, pln, base, m, kPlnCols, n_pln <= kPlnChunk);
      if (blocked) continue;   // to the next stage()
      for (int k = 0; k < m; ++k) {
        float nd;
        const float t = plane_t(&s_pln[k * kPlnCols], sx, sy, sz, tlx, tly,
                                tlz, &nd);
        blocked |= (fabsf(nd) > 1.0e-9f) && (t > 0.0f) && (t < 1.0f);
      }
    }
    if (live) occ_out[static_cast<long long>(l) * n_rays + r] = blocked;
  }
}

}  // namespace
}  // namespace oglrt

extern "C" int oglrt_dense_hit(const float* origins, const float* dirs,
                               const float* sph, const float* box,
                               const float* pln, const float* lights,
                               int n_rays, int n_sph, int n_box, int n_pln,
                               int n_lights, float* t, float* n, bool* inside,
                               int* obj_id, bool* occ, void* stream) {
  if (n_rays == 0) return 0;
  const int grid = (n_rays + oglrt::kBlock - 1) / oglrt::kBlock;
  oglrt::dense_hit_kernel<<<grid, oglrt::kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      origins, dirs, sph, box, pln, lights, n_rays, n_sph, n_box, n_pln,
      n_lights, t, n, inside, obj_id, occ);
  return static_cast<int>(cudaGetLastError());
}
