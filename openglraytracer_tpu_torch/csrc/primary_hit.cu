// Kernels A and 2: the closest hit over a tile's survivor rows.
//
// Replaces openglraytracer_tpu/ops/pallas_culled.py::_primary_kernel in
// both of its modes: shared-pinhole (kernel A, the first pallas_call of
// culled_geometry_pallas) and per-ray origin (kernel 2: the same pallas_call
// for bounce children, and the hot-primary pallas_call over the global
// object table). One template, a flag for the mode: the intersection code
// is written once. Per ray: the closest hit over the tile's sphere rows,
// then its box rows, then every plane, in ascending slot order. Tie rules:
// running minimum with strict <, so the first survivor wins; boxes and
// planes merge with strict <, so objects beat planes at equal t. Output per
// ray: t, the unit normal (flipped for inside sphere hits, zero on a miss),
// the inside flag, the material id, the global object id and the survivor
// slot (-1 for planes).
//
// Row layouts (written by ops/culled.py):
//   shared mode, the pinhole origin o0 folded into the rows:
//   sphere (T, Kp, 8):  [ocx ocy ocz qc mat gid valid pad], oc = o0 - c,
//                       qc = oc.oc - r^2
//   box    (T, Kb, 24): [mins(3) maxs(3) ro(3) rot(9) mat gid valid pad(3)],
//                       ro = R^T (o0 - pos)
//   plane  (P, 16):     [n(3) off unit_n(3) off-n.o0 mat gid pad(6)]
//   per-ray mode, raw geometry (the origin-relative terms are per ray):
//   sphere (T, Kp, 8):  [cx cy cz r^2 mat gid valid pad]
//   box    (T, Kb, 24): [mins(3) maxs(3) pos(3) rot(9) mat gid valid pad(3)]
//   plane  (P, 16):     as shared mode with o0 = 0 (slot 7 holds off)
//   counts (T, 2) int32: [min(p_count, Kp), min(b_count, Kb)]
//
// The hot-primary launch runs per-ray mode over a grid of M hot tiles:
// tile_ids maps block row b to the ray tile it reads, every block reads the
// one (1, N, 8) and (1, Nb, 24) global tables, counts (M, 2) are N and Nb
// on the truly hot tiles and 0 on the slack, and the outputs are
// (M * tile_p) rays in block order; the slot is then the global row id.
//
// What bounds it on the H100: memory traffic in shared and cold per-ray
// mode, not arithmetic. A ray reads 12 bytes of direction (24 with its
// origin) and writes a 29-byte hit record; a survivor costs about 25 float
// ops (35 per ray in per-ray mode). The design keeps each row read once per
// block: one thread per ray, blocks of 256 rays inside one tile, and the
// tile's rows staged in shared memory in chunks, so every tile loops to its
// own survivor count with no padding to a static K.
//
// The hot launch has a kernel of its own (primary_hit_hot_kernel): it is
// bound by its sphere tests (tile_p * N per truly hot tile, 6.8e8 at
// c4_mirror4096), nearly all of them misses of reflected rays. So:
//   (a) a miss (qd < 0) takes no root: the square root, both roots and the
//       winner update run under qd >= 0 only. A miss gives kInfT either
//       way, so the result is the same.
//   (b) only the table's [c r^2] columns are staged, 16 bytes a row, in
//       chunks of kHotRows rows (16 KB, two barriers a chunk: 8 a block at
//       N = 4096, where 64-row chunks of 32-byte rows took 128). The valid
//       flag is folded into r^2 (NaN for an invalid row: its qd is NaN and
//       fails qd >= 0, so it never wins). The winner's normal, mat and gid
//       are read from the global table after the loop, by its slot (the
//       global row id). The chunk size keeps five blocks of 256 rays on an
//       SM, as registers allow: the whole table resident (64 KB at
//       N = 4096) leaves three, and measured slower.
//   (c) one ray a thread: two or four, each row read from shared memory
//       feeding that many tests, raised the registers a thread and
//       measured slower.
//   (e) the staged rows are read through a shared-memory address held in a
//       register (staged_row in common.cuh), not rebuilt after every
//       divergent branch.
// The measurements of each step are in PERF.md.
#include "common.cuh"

namespace oglrt {
namespace {

constexpr int kSphCols = 8;
constexpr int kBoxCols = 24;
constexpr int kPlnCols = 16;
constexpr int kSphChunk = 64;   // sphere rows staged per pass
constexpr int kBoxChunk = 32;   // box rows staged per pass
constexpr int kHotRows = 1024;  // hot launch: sphere rows a chunk, 16 B each

struct Best {
  float t, nx, ny, nz;
  int ins, flp, mat, gid, slot;
};

struct Ray {
  float ox, oy, oz;   // per-ray mode only
  float dx, dy, dz;
  float qa, inv_2qa;
  bool qa_ok;
};

// Ray p of the launch (zero when !live: such a ray never hits).
template <bool kPerRay>
__device__ __forceinline__ Ray make_ray(const float* dirs,
                                        const float* origins, long long r,
                                        bool live) {
  Ray ray = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, false};
  if (live) {
    ray.dx = dirs[3 * r];
    ray.dy = dirs[3 * r + 1];
    ray.dz = dirs[3 * r + 2];
    if (kPerRay) {
      ray.ox = origins[3 * r];
      ray.oy = origins[3 * r + 1];
      ray.oz = origins[3 * r + 2];
    }
  }
  // see fold_sphere
  ray.qa = fmaf(ray.dz, ray.dz, fmaf(ray.dx, ray.dx, ray.dy * ray.dy));
  ray.qa_ok = ray.qa > kDivEps;
  ray.inv_2qa = 0.5f / (ray.qa < kDivEps ? kDivEps : ray.qa);
  return ray;
}

// The sphere quadratic cancels at nearly every hit (qd < 1e-3 qb^2 for the
// c3 grid), so the rounding of qb and qd sets t to about 1e-5 relative.
// They are fused multiply-adds, written out with fmaf (--fmad=false fuses
// nothing by itself) at the places where XLA's CPU compiler fuses the
// reference's expressions, so that t agrees with the JAX package's. In
// per-ray mode the 3-sum of oc.oc is fused the same way as d.d.
template <bool kPerRay>
__device__ __forceinline__ void fold_sphere(const float* row, int j,
                                            const Ray& ray, Best& b) {
  float ocx, ocy, ocz, qc;
  if (kPerRay) {
    ocx = ray.ox - row[0];
    ocy = ray.oy - row[1];
    ocz = ray.oz - row[2];
    qc = fmaf(ocz, ocz, fmaf(ocx, ocx, ocy * ocy)) - row[3];
  } else {
    ocx = row[0];
    ocy = row[1];
    ocz = row[2];
    qc = row[3];
  }
  const float dx = ray.dx, dy = ray.dy, dz = ray.dz;
  const float qb = 2.0f * fmaf(dz, ocz, fmaf(dx, ocx, dy * ocy));
  const float qd = fmaf(qb, qb, -(4.0f * ray.qa * qc));
  bool ok = (qd >= 0.0f) && ray.qa_ok && (row[6] > 0.5f);
  const float sq = ok ? sqrtf(fmaxf(qd, kSqrtEps)) : 0.0f;
  const float t1 = (-qb + sq) * ray.inv_2qa;
  const float t2 = (-qb - sq) * ray.inv_2qa;
  const float t_near = fminf(t1, t2);
  const float t_far = fmaxf(t1, t2);
  ok = ok && (t_far >= 0.0f);
  const bool is_in = ok && (t_near < 0.0f);
  float t = is_in ? t_far : t_near;
  ok = ok && (t > 0.0f);
  t = ok ? t : kInfT;
  if (t < b.t) {
    // u = (o - c) + t d = p - c, normalized at the end
    b.t = t;
    b.nx = fmaf(t, dx, ocx);
    b.ny = fmaf(t, dy, ocy);
    b.nz = fmaf(t, dz, ocz);
    b.ins = is_in;
    b.flp = is_in;
    b.mat = static_cast<int>(row[4]);
    b.gid = static_cast<int>(row[5]);
    b.slot = j;
  }
}

template <bool kPerRay>
__device__ __forceinline__ void fold_box(const float* row, int j,
                                         const Ray& ray, Best& b) {
  const float bm0 = row[0], bm1 = row[1], bm2 = row[2];
  const float bx0 = row[3], bx1 = row[4], bx2 = row[5];
  const float r00 = row[9], r01 = row[10], r02 = row[11];
  const float r10 = row[12], r11 = row[13], r12 = row[14];
  const float r20 = row[15], r21 = row[16], r22 = row[17];
  float rox, roy, roz;
  if (kPerRay) {
    // world -> local origin: R^T (o - pos)
    const float wx = ray.ox - row[6];
    const float wy = ray.oy - row[7];
    const float wz = ray.oz - row[8];
    rox = r00 * wx + r10 * wy + r20 * wz;
    roy = r01 * wx + r11 * wy + r21 * wz;
    roz = r02 * wx + r12 * wy + r22 * wz;
  } else {
    rox = row[6];
    roy = row[7];
    roz = row[8];
  }
  const float dx = ray.dx, dy = ray.dy, dz = ray.dz;
  // world -> local direction: R^T d
  const float rdx = r00 * dx + r10 * dy + r20 * dz;
  const float rdy = r01 * dx + r11 * dy + r21 * dz;
  const float rdz = r02 * dx + r12 * dy + r22 * dz;
  const float ix = inv_safe(rdx), iy = inv_safe(rdy), iz = inv_safe(rdz);
  const float tax = (bm0 - rox) * ix, tbx = (bx0 - rox) * ix;
  const float tay = (bm1 - roy) * iy, tby = (bx1 - roy) * iy;
  const float taz = (bm2 - roz) * iz, tbz = (bx2 - roz) * iz;
  const float t1x = fminf(tax, tbx), t2x = fmaxf(tax, tbx);
  const float t1y = fminf(tay, tby), t2y = fmaxf(tay, tby);
  const float t1z = fminf(taz, tbz), t2z = fmaxf(taz, tbz);
  const float t_near = fmaxf(t1x, fmaxf(t1y, t1z));
  const float t_far = fminf(t2x, fminf(t2y, t2z));
  bool ok = (t_near < t_far) && (t_far > 0.0f) && (row[20] > 0.5f);
  const bool is_in = ok && (t_near < 0.0f);
  float t = is_in ? t_far : t_near;
  ok = ok && (t > 0.0f);
  t = ok ? t : kInfT;
  if (t < b.t) {
    // face pick: exact equality with the winning slab boundary, y before z
    const float by = is_in ? t2y : t1y;
    const float bz = is_in ? t2z : t1z;
    const bool face_y = t == by;
    const bool face_z = !face_y && (t == bz);
    const bool face_x = !(face_y || face_z);
    const float rd_face = face_y ? rdy : (face_z ? rdz : rdx);
    const float sgn = rd_face > 0.0f ? -1.0f : 1.0f;
    const float nlx = face_x ? sgn : 0.0f;
    const float nly = face_y ? sgn : 0.0f;
    const float nlz = face_z ? sgn : 0.0f;
    b.t = t;
    b.nx = r00 * nlx + r01 * nly + r02 * nlz;
    b.ny = r10 * nlx + r11 * nly + r12 * nlz;
    b.nz = r20 * nlx + r21 * nly + r22 * nlz;
    b.ins = is_in;
    b.flp = 0;
    b.mat = static_cast<int>(row[18]);
    b.gid = static_cast<int>(row[19]);
    b.slot = j;
  }
}

template <bool kPerRay>
__device__ __forceinline__ void fold_plane(const float* row, const Ray& ray,
                                           Best& b) {
  float off_no = row[7];   // off - n.o0 (per-ray mode: off)
  if (kPerRay)
    off_no = off_no - (row[0] * ray.ox + row[1] * ray.oy + row[2] * ray.oz);
  const float nd = row[0] * ray.dx + row[1] * ray.dy + row[2] * ray.dz;
  float t = off_no * inv_safe(nd);
  const bool ok = (fabsf(nd) > 1.0e-9f) && (t > 0.0f);
  t = ok ? t : kInfT;
  if (t < b.t) {   // strict: objects beat planes at equal t
    const float s = nd > 0.0f ? -1.0f : 1.0f;
    b.t = t;
    b.nx = row[4] * s;
    b.ny = row[5] * s;
    b.nz = row[6] * s;
    b.ins = 0;
    b.flp = 0;
    b.mat = static_cast<int>(row[8]);
    b.gid = static_cast<int>(row[9]);
    b.slot = -1;
  }
}

// The planes (after every sphere and box), the finalize and the record of
// ray r.
template <bool kPerRay>
__device__ __forceinline__ void finish(
    const float* __restrict__ pln, int n_pln, const Ray& ray, Best& b,
    long long r, float* __restrict__ t_out, float* __restrict__ n_out,
    bool* __restrict__ ins_out, int* __restrict__ mat_out,
    int* __restrict__ gid_out, int* __restrict__ slot_out) {
  for (int k = 0; k < n_pln; ++k)
    fold_plane<kPerRay>(pln + k * kPlnCols, ray, b);

  const float hit_f = b.t < kMissT ? 1.0f : 0.0f;
  const float inv_len =
      rsqrtf(fmaxf(b.nx * b.nx + b.ny * b.ny + b.nz * b.nz, kSqrtEps));
  const float sgn = (b.flp ? -inv_len : inv_len) * hit_f;
  t_out[r] = b.t;
  n_out[3 * r] = b.nx * sgn;
  n_out[3 * r + 1] = b.ny * sgn;
  n_out[3 * r + 2] = b.nz * sgn;
  ins_out[r] = b.ins != 0;
  mat_out[r] = b.mat;
  gid_out[r] = b.gid;
  slot_out[r] = b.slot;
}

// grid (T, ceil(tile_p / kBlock)); block kBlock rays of tile b, its counts
// and its rows; it writes rays b * tile_p + p.
template <bool kPerRay>
__global__ void __launch_bounds__(kBlock) primary_hit_kernel(
    const float* __restrict__ dirs, const float* __restrict__ origins,
    const float* __restrict__ sph, const float* __restrict__ box,
    const float* __restrict__ pln, const int* __restrict__ cnt, int tile_p,
    int kp, int kb, int n_pln, float* __restrict__ t_out,
    float* __restrict__ n_out, bool* __restrict__ ins_out,
    int* __restrict__ mat_out, int* __restrict__ gid_out,
    int* __restrict__ slot_out) {
  __shared__ float s_sph[kSphChunk * kSphCols];
  __shared__ float s_box[kBoxChunk * kBoxCols];

  const int blk = blockIdx.x;
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = p < tile_p;
  const long long r = static_cast<long long>(blk) * tile_p + p;
  const Ray ray = make_ray<kPerRay>(dirs, origins, r, live);
  Best b = {kInfT, 0.0f, 0.0f, 0.0f, 0, 0, 0, -1, 0};

  // the trip counts are uniform over the block, so every thread reaches
  // every barrier
  const int np = min(cnt[2 * blk], kp);
  const float* tile_sph = sph + static_cast<long long>(blk) * kp * kSphCols;
  for (int base = 0; base < np; base += kSphChunk) {
    const int m = min(kSphChunk, np - base);
    __syncthreads();   // the previous chunk is consumed
    for (int i = threadIdx.x; i < m * kSphCols; i += blockDim.x)
      s_sph[i] = tile_sph[base * kSphCols + i];
    __syncthreads();
    if (live)
      for (int jj = 0; jj < m; ++jj)
        fold_sphere<kPerRay>(&s_sph[jj * kSphCols], base + jj, ray, b);
  }

  const int nb = min(cnt[2 * blk + 1], kb);
  const float* tile_box = box + static_cast<long long>(blk) * kb * kBoxCols;
  for (int base = 0; base < nb; base += kBoxChunk) {
    const int m = min(kBoxChunk, nb - base);
    __syncthreads();
    for (int i = threadIdx.x; i < m * kBoxCols; i += blockDim.x)
      s_box[i] = tile_box[base * kBoxCols + i];
    __syncthreads();
    if (live)
      for (int jj = 0; jj < m; ++jj)
        fold_box<kPerRay>(&s_box[jj * kBoxCols], base + jj, ray, b);
  }

  if (!live) return;
  finish<kPerRay>(pln, n_pln, ray, b, r, t_out, n_out, ins_out, mat_out,
                  gid_out, slot_out);
}

// One sphere test of the hot launch against staged row c = [c r^2] (r^2
// NaN for an invalid row), global row j; the running winner is (bt, win,
// ins). The arithmetic is fold_sphere's per-ray mode; see (a) above.
__device__ __forceinline__ void hot_sphere(const float4 c, int j,
                                           const Ray& ray, float& bt,
                                           int& win, bool& ins) {
  const float ocx = ray.ox - c.x;
  const float ocy = ray.oy - c.y;
  const float ocz = ray.oz - c.z;
  const float qc = fmaf(ocz, ocz, fmaf(ocx, ocx, ocy * ocy)) - c.w;
  const float qb = 2.0f * fmaf(ray.dz, ocz, fmaf(ray.dx, ocx, ray.dy * ocy));
  const float qd = fmaf(qb, qb, -(4.0f * ray.qa * qc));
  if (!(qd >= 0.0f)) return;   // a miss: kInfT, no update
  bool ok = ray.qa_ok;
  const float sq = ok ? sqrtf(fmaxf(qd, kSqrtEps)) : 0.0f;
  const float t1 = (-qb + sq) * ray.inv_2qa;
  const float t2 = (-qb - sq) * ray.inv_2qa;
  const float t_near = fminf(t1, t2);
  const float t_far = fmaxf(t1, t2);
  ok = ok && (t_far >= 0.0f);
  const bool is_in = ok && (t_near < 0.0f);
  float t = is_in ? t_far : t_near;
  ok = ok && (t > 0.0f);
  t = ok ? t : kInfT;
  if (t < bt) {
    bt = t;
    win = j;
    ins = is_in;
  }
}

// The hot launch: grid (M, ceil(tile_p / kBlock)). Block row b reads ray
// tile tile_ids[b], its counts cnt[b] (N and Nb on a truly hot tile, 0 on
// the slack) and the one global table (N, 8) / (Nb, 24); it writes rays
// b * tile_p + p. Dynamic shared memory: min(N, kHotRows) float4 rows.
__global__ void __launch_bounds__(kBlock) primary_hit_hot_kernel(
    const float* __restrict__ dirs, const float* __restrict__ origins,
    const float* __restrict__ sph, const float* __restrict__ box,
    const float* __restrict__ pln, const int* __restrict__ cnt,
    const int* __restrict__ tile_ids, int tile_p, int kp, int kb, int n_pln,
    float* __restrict__ t_out, float* __restrict__ n_out,
    bool* __restrict__ ins_out, int* __restrict__ mat_out,
    int* __restrict__ gid_out, int* __restrict__ slot_out) {
  extern __shared__ float4 s_row[];
  __shared__ float s_box[kBoxChunk * kBoxCols];

  const int blk = blockIdx.x;
  const int p = blockIdx.y * kBlock + threadIdx.x;
  const bool live = p < tile_p;
  const Ray ray = make_ray<true>(
      dirs, origins, static_cast<long long>(tile_ids[blk]) * tile_p + p,
      live);
  float bt = kInfT;
  int win = -1;
  bool ins = false;

  // the trip counts are uniform over the block, so every thread reaches
  // every barrier
  const int np = min(cnt[2 * blk], kp);
  const unsigned rows = smem_addr(s_row);
  for (int base = 0; base < np; base += kHotRows) {
    const int m = min(kHotRows, np - base);
    if (base > 0) __syncthreads();   // the previous chunk is consumed
    for (int i = threadIdx.x; i < m; i += kBlock) {
      const float* row = sph + static_cast<long long>(base + i) * kSphCols;
      s_row[i] = make_float4(row[0], row[1], row[2],
                             row[6] > 0.5f ? row[3] : __int_as_float(
                                                          0x7fffffff));
    }
    __syncthreads();
    for (int jj = 0; jj < m; ++jj)
      hot_sphere(staged_row(rows, jj), base + jj, ray, bt, win, ins);
  }

  // the sphere winner's record, as fold_sphere would have kept it
  Best b = {bt, 0.0f, 0.0f, 0.0f, ins, ins, 0, -1, 0};
  if (win >= 0) {
    const float* row = sph + static_cast<long long>(win) * kSphCols;
    b.nx = fmaf(bt, ray.dx, ray.ox - row[0]);
    b.ny = fmaf(bt, ray.dy, ray.oy - row[1]);
    b.nz = fmaf(bt, ray.dz, ray.oz - row[2]);
    b.mat = static_cast<int>(row[4]);
    b.gid = static_cast<int>(row[5]);
    b.slot = win;
  }

  const int nb = min(cnt[2 * blk + 1], kb);
  for (int base = 0; base < nb; base += kBoxChunk) {
    const int m = min(kBoxChunk, nb - base);
    __syncthreads();
    for (int i = threadIdx.x; i < m * kBoxCols; i += kBlock)
      s_box[i] = box[base * kBoxCols + i];
    __syncthreads();
    if (live)
      for (int jj = 0; jj < m; ++jj)
        fold_box<true>(&s_box[jj * kBoxCols], base + jj, ray, b);
  }

  if (!live) return;
  finish<true>(pln, n_pln, ray, b, static_cast<long long>(blk) * tile_p + p,
               t_out, n_out, ins_out, mat_out, gid_out, slot_out);
}

template <bool kPerRay>
int launch(const float* dirs, const float* origins, const float* sph,
           const float* box, const float* pln, const int* cnt, int n_blocks,
           int tile_p, int kp, int kb, int n_pln, float* t, float* n,
           bool* inside, int* mat, int* gid, int* slot, void* stream) {
  if (n_blocks == 0 || tile_p == 0) return 0;
  const dim3 grid(n_blocks, (tile_p + kBlock - 1) / kBlock);
  primary_hit_kernel<kPerRay><<<grid, kBlock, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      dirs, origins, sph, box, pln, cnt, tile_p, kp, kb, n_pln, t, n, inside,
      mat, gid, slot);
  return static_cast<int>(cudaGetLastError());
}

int launch_hot(const float* dirs, const float* origins, const float* sph,
               const float* box, const float* pln, const int* cnt,
               const int* tile_ids, int n_blocks, int tile_p, int kp, int kb,
               int n_pln, float* t, float* n, bool* inside, int* mat,
               int* gid, int* slot, void* stream) {
  if (n_blocks == 0 || tile_p == 0) return 0;
  const int smem =
      (kp < kHotRows ? kp : kHotRows) * static_cast<int>(sizeof(float4));
  const dim3 grid(n_blocks, (tile_p + kBlock - 1) / kBlock);
  primary_hit_hot_kernel<<<grid, kBlock, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      dirs, origins, sph, box, pln, cnt, tile_ids, tile_p, kp, kb, n_pln, t,
      n, inside, mat, gid, slot);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace oglrt

// Kernel A, shared-pinhole mode: T tiles of tile_p rays.
extern "C" int oglrt_primary_hit(const float* dirs, const float* sph,
                                 const float* box, const float* pln,
                                 const int* cnt, int n_tiles, int tile_p,
                                 int kp, int kb, int n_pln, float* t,
                                 float* n, bool* inside, int* mat, int* gid,
                                 int* slot, void* stream) {
  return oglrt::launch<false>(dirs, nullptr, sph, box, pln, cnt, n_tiles,
                              tile_p, kp, kb, n_pln, t, n, inside, mat, gid,
                              slot, stream);
}

// Kernel 2, per-ray mode. tile_ids null: the cold launch over T tiles with
// per-tile rows. tile_ids (M,): the hot launch (primary_hit_hot_kernel)
// over the M listed tiles with the global (1, kp, 8) / (1, kb, 24) tables.
extern "C" int oglrt_primary_hit_ray(const float* dirs, const float* origins,
                                     const float* sph, const float* box,
                                     const float* pln, const int* cnt,
                                     const int* tile_ids, int n_blocks,
                                     int tile_p, int kp, int kb, int n_pln,
                                     float* t, float* n, bool* inside,
                                     int* mat, int* gid, int* slot,
                                     void* stream) {
  if (tile_ids != nullptr)
    return oglrt::launch_hot(dirs, origins, sph, box, pln, cnt, tile_ids,
                             n_blocks, tile_p, kp, kb, n_pln, t, n, inside,
                             mat, gid, slot, stream);
  return oglrt::launch<true>(dirs, origins, sph, box, pln, cnt, n_blocks,
                             tile_p, kp, kb, n_pln, t, n, inside, mat, gid,
                             slot, stream);
}

extern "C" const char* oglrt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
