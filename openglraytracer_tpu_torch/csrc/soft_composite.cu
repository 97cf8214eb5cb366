// The soft-coverage composite of ops/soft.py, forward and analytic backward,
// over each tile's valid survivor slots.
//
// Replaces no Pallas kernel: the JAX package's soft composite
// (openglraytracer_tpu/ops/soft.py _composite_block) is plain jnp, which
// XLA fuses. Run eagerly as the plain version beside these kernels
// (ops/soft.py soft_composite_plain), it is ~1,400 elementwise launches a
// block of tiles over a dense (B, P, K) tensor, written to and read back
// from device memory, although a tile keeps a handful of valid survivors
// (K is sized for the fullest tile) and only a few per cent of the kept
// pairs have coverage.
//
// One thread block takes up to 256 rays (kBlock) of one tile, one thread a
// ray; a tile of more rays (32x32) takes several blocks, and the dense pass
// (every ray against every sphere) is one tile of all the rays. The
// survivors are a prefix of each tile's K slots (compact_mask puts the
// valid ones first): a block reads the prefix's end from `valid` and
// stages the rows [cx cy cz r] and their 20 material columns in shared
// memory, so no padded slot costs anything.
//
// Forward, per ray: a first pass over the survivors finds each pair's
// coverage alpha = sigmoid((r^2 - d_perp^2) / (bw r^2)), the cut at
// _ALPHA_CUT and the front gate, and the least depth t_min of the live
// pairs (planes and the background included); a second pass shades the
// live pairs alone (Phong without shadows) and sums the depth-softmax
// weights alpha exp((t_min - t) / gamma) and weighted colours. A warp
// with no live lane skips a slot's shading (__any_sync). It writes the
// rgb and, when autograd will need them, t_min and the softmax's
// denominator: two floats a ray, nothing per pair.
//
// Backward, per ray: from the saved out, t_min and den it recomputes each
// live pair's terms, as a flash-attention backward does, and walks them
// backwards. t_min cancels exactly in num / den (every weight carries
// exp(t_min / gamma); a live pair's exponent is never clamped), so its
// adjoint is zero and each weight is differentiated with t_min held. The
// other selects follow the plain forward's: torch.maximum / minimum pass
// the gradient strictly above / below the constant and half of it at a
// tie; clamp passes it at the bound; sigmoid's is y (1 - y); rsqrt's
// -0.5 y^3. Each slot's gradient (centre, radius, 20 material columns) is
// summed over the block's rays in a fixed order, a shuffle tree in each
// warp and then the warps in order through shared memory, with no float
// atomics, into a (tile, block of rays, slot) row, zeros past the prefix;
// the planes' rows likewise, one a block. The variant kGeom also gives the
// lights' and the planes' geometry cotangents (per-block rows), and runs
// only when such a leaf requires grad.
//
// What bounds them on the H100: neither bytes nor float throughput. A
// view of the c5_grid4096_soft512 cell is 262,144 rays and ~2.2 M kept
// pairs, of which ~64 k are live; the bytes are ~12 MB (rays, rows, rgb)
// and the float work ~0.1 GFLOP. The time goes to the latency of the
// dependent chain per slot (sqrt, exp, a divide, then the shading's rsqrt,
// log and exp) in the tiles with the most survivors, and to the barriers
// of the backward's slot chunks. The design keeps that chain in registers,
// skips dead slots warp by warp, and keeps the slot loop free of global
// memory (rows and material columns staged in shared memory).
//
// Built with --fmad=false: each operation rounds as the plain version's
// separate elementwise ops do (expf, logf and rsqrtf as PyTorch's own CUDA
// kernels call them), so a pair's coverage, depth, weight and colour are
// the plain arithmetic's; only the sums over slots and rays take another
// order.
#include "common.cuh"

namespace oglrt {
namespace {

constexpr int kMatCols = 20;
constexpr int kLightCols = 16;    // pos(3) pad amb(4) diff(4) spec(4)
constexpr int kLightGrads = 15;   // pos(3) amb(4) diff(4) spec(4)
constexpr int kPlaneCols = 24;    // n(3) off m(20)
constexpr int kRowCols = 6;       // cx cy cz r mat gid
constexpr int kWarps = kBlock / 32;
constexpr int kChunk = 32;        // slots a backward chunk
constexpr int kSlotGrads = 24;    // c(3) r m(20)
constexpr int kMaxLights = 8;     // ops/soft.py _MAX_GEOMETRY_LIGHTS
constexpr float kTEps = 1.0e-3f;      // ops/soft.py _T_EPS
constexpr float kAlphaCut = 1.0e-3f;  // ops/soft.py _ALPHA_CUT
constexpr float kR2Eps = 1.0e-12f;
constexpr float kNdEps = 1.0e-9f;
constexpr float kDenEps = 1.0e-20f;

struct Soft {
  float bw, gamma, t_bg;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, vx, vy, vz;
};

__device__ __forceinline__ Ray load_ray(const float* o, const float* d,
                                        long long i) {
  Ray y;
  y.ox = o[3 * i];
  y.oy = o[3 * i + 1];
  y.oz = o[3 * i + 2];
  y.dx = d[3 * i];
  y.dy = d[3 * i + 1];
  y.dz = d[3 * i + 2];
  // the view direction normalize(-d)
  const float inv =
      rsqrtf(fmaxf(y.dx * y.dx + y.dy * y.dy + y.dz * y.dz, kSqrtEps));
  y.vx = -y.dx * inv;
  y.vy = -y.dy * inv;
  y.vz = -y.dz * inv;
  return y;
}

// the gradient torch.maximum(x, c) / torch.minimum(x, c) passes to x
__device__ __forceinline__ float gate_max(float x, float c) {
  return x > c ? 1.0f : (x == c ? 0.5f : 0.0f);
}
__device__ __forceinline__ float gate_min(float x, float c) {
  return x < c ? 1.0f : (x == c ? 0.5f : 0.0f);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// ---- one ray-sphere pair: ops/soft.py _pair_geometry
struct Pair {
  float ocx, ocy, ocz, b, disc, q, alpha0, sq, t_hit, t1, t_sph;
  bool live;
};

__device__ __forceinline__ Pair pair_geometry(const Ray& y, float4 c,
                                              bool valid, const Soft& s) {
  Pair p;
  p.ocx = y.ox - c.x;
  p.ocy = y.oy - c.y;
  p.ocz = y.oz - c.z;
  p.b = p.ocx * y.dx + p.ocy * y.dy + p.ocz * y.dz;
  const float oc2 = p.ocx * p.ocx + p.ocy * p.ocy + p.ocz * p.ocz;
  const float r2 = fmaxf(c.w * c.w, kR2Eps);
  p.disc = r2 - (oc2 - p.b * p.b);
  p.q = s.bw * r2;
  p.alpha0 = 1.0f / (1.0f + expf(-(p.disc / p.q)));
  p.sq = sqrtf(fmaxf(p.disc, kSqrtEps));
  p.t_hit = -p.b - p.sq;
  p.live = valid && p.t_hit > kTEps && p.alpha0 > kAlphaCut;
  p.t1 = fmaxf(p.t_hit, kTEps);
  p.t_sph = fminf(p.t1, s.t_bg);
  return p;
}

// ---- one plane: ops/soft.py _plane_geometry
struct Plane {
  float den, t_raw, t1, t, sgn;
  bool hit;
};

__device__ __forceinline__ Plane plane_geometry(const float* pl,
                                                const Ray& y, const Soft& s) {
  Plane q;
  const float nd = pl[0] * y.dx + pl[1] * y.dy + pl[2] * y.dz;
  const float no = pl[0] * y.ox + pl[1] * y.oy + pl[2] * y.oz;
  q.den = fabsf(nd) < kNdEps ? (nd < 0.0f ? -kNdEps : kNdEps) : nd;
  q.t_raw = (pl[3] - no) / q.den;
  q.hit = fabsf(nd) > kNdEps && q.t_raw > kTEps;
  q.t1 = fmaxf(q.t_raw, kTEps);
  q.t = fminf(q.t1, s.t_bg);
  q.sgn = nd > 0.0f ? -1.0f : 1.0f;
  return q;
}

// ---- shadowless Phong: ops/soft.py _light_terms, _phong_acc, _phong_bwd
struct LightTerms {
  float tlx, tly, tlz, sl, linv, lx, ly, lz, cos_t, rx, ry, rz, sr, rinv,
      dot_rv, cos_p;
};

__device__ __forceinline__ LightTerms light_terms(const float* lg, float px,
                                                  float py, float pz,
                                                  float nx, float ny,
                                                  float nz, const Ray& y) {
  LightTerms t;
  t.tlx = lg[0] - px;
  t.tly = lg[1] - py;
  t.tlz = lg[2] - pz;
  t.sl = t.tlx * t.tlx + t.tly * t.tly + t.tlz * t.tlz;
  t.linv = rsqrtf(fmaxf(t.sl, kSqrtEps));
  t.lx = t.tlx * t.linv;
  t.ly = t.tly * t.linv;
  t.lz = t.tlz * t.linv;
  t.cos_t = t.lx * nx + t.ly * ny + t.lz * nz;
  // the reflection 2 cos_t n - l
  const float c2 = 2.0f * t.cos_t;
  t.rx = c2 * nx - t.lx;
  t.ry = c2 * ny - t.ly;
  t.rz = c2 * nz - t.lz;
  t.sr = t.rx * t.rx + t.ry * t.ry + t.rz * t.rz;
  t.rinv = rsqrtf(fmaxf(t.sr, kSqrtEps));
  t.dot_rv = t.rx * y.vx + t.ry * y.vy + t.rz * y.vz;
  t.cos_p = t.dot_rv * t.rinv;
  return t;
}

// acc (4): ambient, diffuse, specular and emissive summed; the colour is
// acc[0..2] * acc[3]
__device__ __forceinline__ void phong_acc(const float* m,
                                          const float* lights, int n_lights,
                                          float px, float py, float pz,
                                          float nx, float ny, float nz,
                                          const Ray& y, float acc[4]) {
  for (int c = 0; c < 4; ++c) acc[c] = 0.0f;
  for (int j = 0; j < n_lights; ++j) {
    const float* lg = lights + j * kLightCols;
    for (int c = 0; c < 4; ++c) acc[c] = acc[c] + lg[4 + c] * m[c];
    const LightTerms t = light_terms(lg, px, py, pz, nx, ny, nz, y);
    const float ct = fmaxf(t.cos_t, 0.0f);
    const float val = expf(m[16] * logf(fmaxf(t.cos_p, kPowEps)));
    const float pw = t.cos_p > 0.0f ? val : 0.0f;
    for (int c = 0; c < 4; ++c) acc[c] = acc[c] + lg[8 + c] * m[4 + c] * ct;
    for (int c = 0; c < 4; ++c) acc[c] = acc[c] + lg[12 + c] * m[8 + c] * pw;
  }
  for (int c = 0; c < 4; ++c) acc[c] = acc[c] + m[12 + c];
}

// Backward of the colour at its accumulator's cotangent g_acc: adds to
// gm (20 material columns), g_p and g_n, and with kGeom to lacc (15 a
// light).
template <bool kGeom>
__device__ __forceinline__ void phong_bwd(
    const float* m, const float* lights, int n_lights, float px, float py,
    float pz, float nx, float ny, float nz, const Ray& y,
    const float g_acc[4], float* gm, float g_p[3], float g_n[3],
    float* lacc) {
  for (int c = 0; c < 4; ++c) gm[12 + c] += g_acc[c];
  for (int j = 0; j < n_lights; ++j) {
    const float* lg = lights + j * kLightCols;
    const LightTerms t = light_terms(lg, px, py, pz, nx, ny, nz, y);
    const float ct = fmaxf(t.cos_t, 0.0f);
    const float bb = fmaxf(t.cos_p, kPowEps);
    const float lgb = logf(bb);
    const float val = expf(m[16] * lgb);
    const float pw = t.cos_p > 0.0f ? val : 0.0f;
    float g_ct = 0.0f, g_pw = 0.0f;
    for (int c = 0; c < 4; ++c) {
      gm[c] += lg[4 + c] * g_acc[c];
      gm[4 + c] += lg[8 + c] * (g_acc[c] * ct);
      gm[8 + c] += lg[12 + c] * (g_acc[c] * pw);
      g_ct += g_acc[c] * (lg[8 + c] * m[4 + c]);
      g_pw += g_acc[c] * (lg[12 + c] * m[8 + c]);
      if (kGeom) {
        float* la = lacc + j * kLightGrads;
        la[3 + c] += g_acc[c] * m[c];
        la[7 + c] += g_acc[c] * ct * m[4 + c];
        la[11 + c] += g_acc[c] * pw * m[8 + c];
      }
    }
    float g_cos_t = g_ct * gate_max(t.cos_t, 0.0f);
    const float g_val = t.cos_p > 0.0f ? g_pw : 0.0f;
    gm[16] += g_val * val * lgb;
    const float g_cos_p =
        t.cos_p >= kPowEps ? g_val * val * m[16] / bb : 0.0f;
    // cos_p = (r . v) / |r|
    const float g_dot = g_cos_p * t.rinv;
    const float g_sr = g_cos_p * t.dot_rv *
                       (-0.5f * t.rinv * t.rinv * t.rinv) *
                       gate_max(t.sr, kSqrtEps);
    const float grx = g_dot * y.vx + 2.0f * t.rx * g_sr;
    const float gry = g_dot * y.vy + 2.0f * t.ry * g_sr;
    const float grz = g_dot * y.vz + 2.0f * t.rz * g_sr;
    // r = 2 cos_t n - l; cos_t = l . n
    g_cos_t = g_cos_t + 2.0f * (grx * nx + gry * ny + grz * nz);
    g_n[0] += 2.0f * t.cos_t * grx + g_cos_t * t.lx;
    g_n[1] += 2.0f * t.cos_t * gry + g_cos_t * t.ly;
    g_n[2] += 2.0f * t.cos_t * grz + g_cos_t * t.lz;
    const float glx = g_cos_t * nx - grx;
    const float gly = g_cos_t * ny - gry;
    const float glz = g_cos_t * nz - grz;
    // l = tl / |tl|, tl = light - p
    const float g_sl = (glx * t.tlx + gly * t.tly + glz * t.tlz) *
                       (-0.5f * t.linv * t.linv * t.linv) *
                       gate_max(t.sl, kSqrtEps);
    const float gtx = glx * t.linv + 2.0f * t.tlx * g_sl;
    const float gty = gly * t.linv + 2.0f * t.tly * g_sl;
    const float gtz = glz * t.linv + 2.0f * t.tlz * g_sl;
    g_p[0] -= gtx;
    g_p[1] -= gty;
    g_p[2] -= gtz;
    if (kGeom) {
      float* la = lacc + j * kLightGrads;
      la[0] += gtx;
      la[1] += gty;
      la[2] += gtz;
    }
  }
}

// A live pair's cotangents: gr[0..2] the centre, gr[3] the radius,
// gr[4..23] the material columns (gr is zeroed by the caller).
template <bool kGeom>
__device__ __forceinline__ void pair_bwd(const Ray& y, float4 c,
                                         const float* m, const Pair& q,
                                         float t_min, const float gn[3],
                                         float g_den, const Soft& s,
                                         const float* lights, int n_lights,
                                         float* gr, float* lacc) {
  const float e = expf(fminf((t_min - q.t_sph) / s.gamma, 0.0f));
  const float w = q.alpha0 * e;
  const float px = y.ox + q.t_sph * y.dx;
  const float py = y.oy + q.t_sph * y.dy;
  const float pz = y.oz + q.t_sph * y.dz;
  const float nx_ = px - c.x, ny_ = py - c.y, nz_ = pz - c.z;
  const float sn = nx_ * nx_ + ny_ * ny_ + nz_ * nz_;
  const float ninv = rsqrtf(fmaxf(sn, kSqrtEps));
  const float nx = nx_ * ninv, ny = ny_ * ninv, nz = nz_ * ninv;
  float acc[4];
  phong_acc(m, lights, n_lights, px, py, pz, nx, ny, nz, y, acc);
  const float s0 = acc[0] * acc[3], s1 = acc[1] * acc[3],
              s2 = acc[2] * acc[3];
  const float g_w = gn[0] * s0 + gn[1] * s1 + gn[2] * s2 + g_den;
  const float gs0 = gn[0] * w, gs1 = gn[1] * w, gs2 = gn[2] * w;
  const float g_acc[4] = {gs0 * acc[3], gs1 * acc[3], gs2 * acc[3],
                          gs0 * acc[0] + gs1 * acc[1] + gs2 * acc[2]};
  float g_p[3] = {0.0f, 0.0f, 0.0f}, g_n[3] = {0.0f, 0.0f, 0.0f};
  phong_bwd<kGeom>(m, lights, n_lights, px, py, pz, nx, ny, nz, y, g_acc,
                   gr + 4, g_p, g_n, lacc);
  const float g_z = g_w * e * (1.0f - q.alpha0) * q.alpha0;
  // n = n_ / |n_|, n_ = p - c
  const float g_sn = (g_n[0] * nx_ + g_n[1] * ny_ + g_n[2] * nz_) *
                     (-0.5f * ninv * ninv * ninv) * gate_max(sn, kSqrtEps);
  const float gnx_ = g_n[0] * ninv + 2.0f * nx_ * g_sn;
  const float gny_ = g_n[1] * ninv + 2.0f * ny_ * g_sn;
  const float gnz_ = g_n[2] * ninv + 2.0f * nz_ * g_sn;
  // the weight's depth, then p = o + t d
  const float g_t = -(g_w * w) / s.gamma + (g_p[0] + gnx_) * y.dx +
                    (g_p[1] + gny_) * y.dy + (g_p[2] + gnz_) * y.dz;
  const float g_thit =
      g_t * gate_min(q.t1, s.t_bg) * gate_max(q.t_hit, kTEps);
  // t_hit = -b - sqrt(max(disc, eps)); alpha0 = sigmoid(disc / q)
  const float g_disc =
      -g_thit / (2.0f * q.sq) * (q.disc >= kSqrtEps ? 1.0f : 0.0f) +
      g_z / q.q;
  const float g_r2 = g_disc - g_z * (q.disc / q.q) / q.q * s.bw;
  // disc = r2 - (|oc|^2 - b^2), b = oc . d, oc = o - c
  const float g_b = -g_thit + 2.0f * q.b * g_disc;
  gr[0] = -gnx_ - (-2.0f * q.ocx * g_disc + g_b * y.dx);
  gr[1] = -gny_ - (-2.0f * q.ocy * g_disc + g_b * y.dy);
  gr[2] = -gnz_ - (-2.0f * q.ocz * g_disc + g_b * y.dz);
  gr[3] = g_r2 * gate_max(c.w * c.w, kR2Eps) * 2.0f * c.w;
}

// A plane's cotangents at one ray: gp[0..2] its normal, gp[3] its offset
// (kGeom only), gp[4..23] its material columns (gp zeroed by the caller).
template <bool kGeom>
__device__ __forceinline__ void plane_bwd(const float* pl, const Ray& y,
                                          float t_min, const float gn[3],
                                          float g_den, const Soft& s,
                                          const float* lights, int n_lights,
                                          float* gp, float* lacc) {
  const Plane q = plane_geometry(pl, y, s);
  if (!q.hit) return;
  const float w = expf((t_min - q.t) / s.gamma);
  const float px = y.ox + q.t * y.dx, py = y.oy + q.t * y.dy,
              pz = y.oz + q.t * y.dz;
  const float nx = q.sgn * pl[0], ny = q.sgn * pl[1], nz = q.sgn * pl[2];
  float acc[4];
  phong_acc(pl + 4, lights, n_lights, px, py, pz, nx, ny, nz, y, acc);
  const float c0 = acc[0] * acc[3], c1 = acc[1] * acc[3],
              c2 = acc[2] * acc[3];
  const float g_w = gn[0] * c0 + gn[1] * c1 + gn[2] * c2 + g_den;
  const float gs0 = gn[0] * w, gs1 = gn[1] * w, gs2 = gn[2] * w;
  const float g_acc[4] = {gs0 * acc[3], gs1 * acc[3], gs2 * acc[3],
                          gs0 * acc[0] + gs1 * acc[1] + gs2 * acc[2]};
  float g_p[3] = {0.0f, 0.0f, 0.0f}, g_n[3] = {0.0f, 0.0f, 0.0f};
  phong_bwd<kGeom>(pl + 4, lights, n_lights, px, py, pz, nx, ny, nz, y,
                   g_acc, gp + 4, g_p, g_n, lacc);
  if (kGeom) {
    const float g_tp = -(g_w * w) / s.gamma + g_p[0] * y.dx +
                       g_p[1] * y.dy + g_p[2] * y.dz;
    const float g_traw =
        g_tp * gate_min(q.t1, s.t_bg) * gate_max(q.t_raw, kTEps);
    // t_raw = (off - n . o) / (n . d)
    const float g_off = g_traw / q.den;
    const float g_nd = -g_traw * q.t_raw / q.den;
    gp[0] += g_nd * y.dx - g_off * y.ox + q.sgn * g_n[0];
    gp[1] += g_nd * y.dy - g_off * y.oy + q.sgn * g_n[1];
    gp[2] += g_nd * y.dz - g_off * y.oz + q.sgn * g_n[2];
    gp[3] += g_off;
  }
}

// The end of the tile's survivor prefix: one past its last valid slot.
__device__ __forceinline__ int survivor_end(const bool* valid, int k_slots,
                                            int* s_end) {
  if (threadIdx.x == 0) *s_end = 0;
  __syncthreads();
  int last = 0;
  for (int k = threadIdx.x; k < k_slots; k += kBlock)
    if (valid[k]) last = k + 1;
  if (last) atomicMax(s_end, last);
  __syncthreads();
  return *s_end;
}

// Stage slots [k0, k0 + n) of the tile: rows as float4 [cx cy cz r], the
// valid flags and, with mat, the 20 material columns.
__device__ __forceinline__ void stage(const float* rows, const bool* valid,
                                      const float* mrows, int k0, int n,
                                      float4* s_sph, bool* s_val,
                                      float* s_mat) {
  for (int j = threadIdx.x; j < n; j += kBlock) {
    const float* r = rows + static_cast<long long>(k0 + j) * kRowCols;
    s_sph[j] = make_float4(r[0], r[1], r[2], r[3]);
    s_val[j] = valid[k0 + j];
  }
  if (s_mat != nullptr) {
    const float4* src = reinterpret_cast<const float4*>(
        mrows + static_cast<long long>(k0) * kMatCols);
    float4* dst = reinterpret_cast<float4*>(s_mat);
    for (int i = threadIdx.x; i < n * (kMatCols / 4); i += kBlock)
      dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(kBlock) soft_fwd_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ rows, const bool* __restrict__ valid,
    const float* __restrict__ mrows, const float* __restrict__ lights,
    int n_lights, const float* __restrict__ planes, int n_planes,
    int n_rays, int k_slots, int chunks, Soft s, float* __restrict__ out,
    float* __restrict__ t_min_out, float* __restrict__ den_out,
    int* __restrict__ live_count) {
  __shared__ float4 s_sph[kBlock];
  __shared__ bool s_val[kBlock];
  __shared__ __align__(16) float s_mat[kBlock * kMatCols];
  __shared__ int s_end;
  const int tile = blockIdx.x / chunks;
  const int p = (blockIdx.x % chunks) * kBlock + threadIdx.x;
  const bool act = p < n_rays;
  const Ray y = load_ray(o, d, static_cast<long long>(tile) * n_rays +
                                   (act ? p : 0));
  const long long t_off = static_cast<long long>(tile) * k_slots;
  rows += t_off * kRowCols;
  valid += t_off;
  mrows += t_off * kMatCols;
  const int n_k = survivor_end(valid, k_slots, &s_end);

  // pass 1: the least live depth
  float t_min = s.t_bg;
  int n_live = 0;
  for (int k0 = 0; k0 < n_k; k0 += kBlock) {
    const int n = min(kBlock, n_k - k0);
    __syncthreads();
    stage(rows, valid, mrows, k0, n, s_sph, s_val, s_mat);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const Pair q = pair_geometry(y, s_sph[j], s_val[j], s);
      if (act && q.live) {
        t_min = fminf(t_min, q.t_sph);
        ++n_live;
      }
    }
  }
  for (int i = 0; i < n_planes; ++i) {
    const Plane q = plane_geometry(planes + i * kPlaneCols, y, s);
    if (q.hit) t_min = fminf(t_min, q.t);
  }

  // pass 2: the live pairs' weights and colours
  float den = 0.0f, nr = 0.0f, ng = 0.0f, nb = 0.0f;
  for (int k0 = 0; k0 < n_k; k0 += kBlock) {
    const int n = min(kBlock, n_k - k0);
    if (n_k > kBlock) {   // else pass 1's stage is still in place
      __syncthreads();
      stage(rows, valid, mrows, k0, n, s_sph, s_val, s_mat);
      __syncthreads();
    }
    for (int j = 0; j < n; ++j) {
      const float4 c = s_sph[j];
      const Pair q = pair_geometry(y, c, s_val[j], s);
      const bool live = act && q.live;
      if (!__any_sync(0xffffffffu, live) || !live) continue;
      const float w =
          q.alpha0 * expf(fminf((t_min - q.t_sph) / s.gamma, 0.0f));
      const float px = y.ox + q.t_sph * y.dx;
      const float py = y.oy + q.t_sph * y.dy;
      const float pz = y.oz + q.t_sph * y.dz;
      const float nx_ = px - c.x, ny_ = py - c.y, nz_ = pz - c.z;
      const float ninv =
          rsqrtf(fmaxf(nx_ * nx_ + ny_ * ny_ + nz_ * nz_, kSqrtEps));
      float acc[4];
      phong_acc(s_mat + j * kMatCols, lights, n_lights, px, py, pz,
                nx_ * ninv, ny_ * ninv, nz_ * ninv, y, acc);
      den = den + w;
      nr = nr + w * (acc[0] * acc[3]);
      ng = ng + w * (acc[1] * acc[3]);
      nb = nb + w * (acc[2] * acc[3]);
    }
  }
  for (int i = 0; i < n_planes; ++i) {
    const float* pl = planes + i * kPlaneCols;
    const Plane q = plane_geometry(pl, y, s);
    if (!q.hit) continue;
    const float w = expf((t_min - q.t) / s.gamma);
    float acc[4];
    phong_acc(pl + 4, lights, n_lights, y.ox + q.t * y.dx,
              y.oy + q.t * y.dy, y.oz + q.t * y.dz, q.sgn * pl[0],
              q.sgn * pl[1], q.sgn * pl[2], y, acc);
    den = den + w;
    nr = nr + w * (acc[0] * acc[3]);
    ng = ng + w * (acc[1] * acc[3]);
    nb = nb + w * (acc[2] * acc[3]);
  }
  den = den + expf((t_min - s.t_bg) / s.gamma);   // the background: black

  if (live_count != nullptr) {
    int v = n_live;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if ((threadIdx.x & 31) == 0 && v) atomicAdd(live_count, v);
  }
  if (!act) return;
  const long long r = static_cast<long long>(tile) * n_rays + p;
  const float inv = 1.0f / fmaxf(den, kDenEps);
  out[3 * r] = nr * inv;
  out[3 * r + 1] = ng * inv;
  out[3 * r + 2] = nb * inv;
  if (t_min_out != nullptr) {
    t_min_out[r] = t_min;
    den_out[r] = den;
  }
}

template <bool kGeom>
__global__ void __launch_bounds__(kBlock) soft_bwd_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ rows, const bool* __restrict__ valid,
    const float* __restrict__ mrows, const float* __restrict__ lights,
    int n_lights, const float* __restrict__ planes, int n_planes,
    int n_rays, int k_slots, int chunks, Soft s,
    const float* __restrict__ out, const float* __restrict__ t_min_in,
    const float* __restrict__ den_in, const float* __restrict__ g,
    float* __restrict__ g_rows, float* __restrict__ g_mrows,
    float* __restrict__ g_planes, float* __restrict__ g_lights) {
  __shared__ float4 s_sph[kChunk];
  __shared__ bool s_val[kChunk];
  __shared__ __align__(16) float s_mat[kChunk * kMatCols];
  __shared__ float red[kWarps][kChunk][kSlotGrads];
  __shared__ int s_end;
  const int tile = blockIdx.x / chunks;
  const int p = (blockIdx.x % chunks) * kBlock + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool act = p < n_rays;
  const long long r = static_cast<long long>(tile) * n_rays + (act ? p : 0);
  const Ray y = load_ray(o, d, r);
  const long long t_off = static_cast<long long>(tile) * k_slots;
  rows += t_off * kRowCols;
  valid += t_off;
  mrows += t_off * kMatCols;
  const int n_k = survivor_end(valid, k_slots, &s_end);

  // the cotangents of num and den; a ray past the end gives zeros
  const float t_min = t_min_in[r], den = den_in[r];
  float gn[3] = {0.0f, 0.0f, 0.0f};
  float g_den = 0.0f;
  if (act) {
    const float inv = 1.0f / fmaxf(den, kDenEps);
    const float g0 = g[3 * r], g1 = g[3 * r + 1], g2 = g[3 * r + 2];
    gn[0] = g0 * inv;
    gn[1] = g1 * inv;
    gn[2] = g2 * inv;
    g_den = -(g0 * out[3 * r] + g1 * out[3 * r + 1] + g2 * out[3 * r + 2]) *
            inv * gate_max(den, kDenEps);
  }
  float lacc[kGeom ? kMaxLights * kLightGrads : 1];
  if (kGeom)
    for (int i = 0; i < n_lights * kLightGrads; ++i) lacc[i] = 0.0f;

  // the slots, a chunk at a time: every slot of K gets its row
  const long long row0 = static_cast<long long>(blockIdx.x) * k_slots;
  for (int k0 = 0; k0 < k_slots; k0 += kChunk) {
    const int n = max(0, min(kChunk, n_k - k0));
    __syncthreads();
    stage(rows, valid, mrows, k0, n, s_sph, s_val, s_mat);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float4 c = s_sph[j];
      const Pair q = pair_geometry(y, c, s_val[j], s);
      const bool live = act && q.live;
      if (!__any_sync(0xffffffffu, live)) {
        if (lane == 0)
          for (int i = 0; i < kSlotGrads; ++i) red[warp][j][i] = 0.0f;
        continue;
      }
      float gr[kSlotGrads];
      for (int i = 0; i < kSlotGrads; ++i) gr[i] = 0.0f;
      if (live)
        pair_bwd<kGeom>(y, c, s_mat + j * kMatCols, q, t_min, gn, g_den, s,
                        lights, n_lights, gr, lacc);
      for (int i = 0; i < kSlotGrads; ++i) {
        const float v = warp_sum(gr[i]);
        if (lane == 0) red[warp][j][i] = v;
      }
    }
    __syncthreads();
    // the warps in order; columns 4 and 5 (mat, gid) and slots past the
    // prefix are zero
    const int k_n = min(kChunk, k_slots - k0);
    for (int i = threadIdx.x; i < k_n * (kRowCols + kMatCols); i += kBlock) {
      const int j = i / (kRowCols + kMatCols);
      const int col = i % (kRowCols + kMatCols);
      const int src = col < 4 ? col : col - 2;
      float acc = 0.0f;
      if (j < n && (col < 4 || col >= kRowCols))
        for (int w = 0; w < kWarps; ++w) acc = acc + red[w][j][src];
      const long long row = row0 + k0 + j;
      if (col < kRowCols)
        g_rows[row * kRowCols + col] = acc;
      else
        g_mrows[row * kMatCols + col - kRowCols] = acc;
    }
  }

  // the planes: one row a block each
  for (int i = 0; i < n_planes; ++i) {
    float gp[kPlaneCols];
    for (int c = 0; c < kPlaneCols; ++c) gp[c] = 0.0f;
    if (act)
      plane_bwd<kGeom>(planes + i * kPlaneCols, y, t_min, gn, g_den, s,
                       lights, n_lights, gp, lacc);
    __syncthreads();
    for (int c = 0; c < kPlaneCols; ++c) {
      const float v = warp_sum(gp[c]);
      if (lane == 0) red[warp][0][c] = v;
    }
    __syncthreads();
    if (threadIdx.x < kPlaneCols) {
      float acc = 0.0f;
      for (int w = 0; w < kWarps; ++w) acc = acc + red[w][0][threadIdx.x];
      g_planes[(static_cast<long long>(blockIdx.x) * n_planes + i) *
                   kPlaneCols +
               threadIdx.x] = acc;
    }
  }

  // the lights: one row a block each
  if (kGeom) {
    for (int j = 0; j < n_lights; ++j) {
      __syncthreads();
      for (int c = 0; c < kLightGrads; ++c) {
        const float v = warp_sum(lacc[j * kLightGrads + c]);
        if (lane == 0) red[warp][0][c] = v;
      }
      __syncthreads();
      if (threadIdx.x < kLightGrads) {
        float acc = 0.0f;
        for (int w = 0; w < kWarps; ++w) acc = acc + red[w][0][threadIdx.x];
        g_lights[(static_cast<long long>(blockIdx.x) * n_lights + j) *
                     kLightGrads +
                 threadIdx.x] = acc;
      }
    }
  }
}

}  // namespace
}  // namespace oglrt

// Forward on `stream`: o, d (T, P, 3); rows (T, K, 6); valid (T, K);
// mrows (T, K, 20), 16-byte aligned; lights (L, 16); planes (Q, 24).
// Writes out (T, P, 3) and, where the pointers are not null, t_min and den
// (T, P) and the count of live pairs added to *live_count.
extern "C" int oglrt_soft_composite(
    const float* o, const float* d, const float* rows, const bool* valid,
    const float* mrows, const float* lights, int n_lights,
    const float* planes, int n_planes, int n_tiles, int n_rays, int k_slots,
    float bw, float gamma, float t_bg, float* out, float* t_min, float* den,
    int* live_count, void* stream) {
  if (n_tiles == 0 || n_rays == 0) return 0;
  const int chunks = (n_rays + oglrt::kBlock - 1) / oglrt::kBlock;
  const oglrt::Soft s{bw, gamma, t_bg};
  oglrt::soft_fwd_kernel<<<static_cast<unsigned>(n_tiles) * chunks,
                           oglrt::kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      o, d, rows, valid, mrows, lights, n_lights, planes, n_planes, n_rays,
      k_slots, chunks, s, out, t_min, den, live_count);
  return static_cast<int>(cudaGetLastError());
}

// Backward on `stream`, from the forward's out, t_min and den and the
// cotangent g (T, P, 3). Writes, for each block b = tile * chunks + chunk
// (chunks = ceil(P / 256)), g_rows (b, K, 6) and g_mrows (b, K, 20), the
// block's sums of each slot's cotangents (zeros past the survivors and in
// columns 4 and 5), and g_planes (b, Q, 24); with geometry also the
// planes' normal and offset columns and g_lights (b, L, 15), L <= 8.
extern "C" int oglrt_soft_composite_bwd(
    const float* o, const float* d, const float* rows, const bool* valid,
    const float* mrows, const float* lights, int n_lights,
    const float* planes, int n_planes, int n_tiles, int n_rays, int k_slots,
    float bw, float gamma, float t_bg, const float* out, const float* t_min,
    const float* den, const float* g, int geometry, float* g_rows,
    float* g_mrows, float* g_planes, float* g_lights, void* stream) {
  if (n_tiles == 0 || n_rays == 0) return 0;
  if (geometry && n_lights > oglrt::kMaxLights)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (n_rays + oglrt::kBlock - 1) / oglrt::kBlock;
  const oglrt::Soft s{bw, gamma, t_bg};
  const unsigned blocks = static_cast<unsigned>(n_tiles) * chunks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (geometry)
    oglrt::soft_bwd_kernel<true><<<blocks, oglrt::kBlock, 0, st>>>(
        o, d, rows, valid, mrows, lights, n_lights, planes, n_planes, n_rays,
        k_slots, chunks, s, out, t_min, den, g, g_rows, g_mrows, g_planes,
        g_lights);
  else
    oglrt::soft_bwd_kernel<false><<<blocks, oglrt::kBlock, 0, st>>>(
        o, d, rows, valid, mrows, lights, n_lights, planes, n_planes, n_rays,
        k_slots, chunks, s, out, t_min, den, g, g_rows, g_mrows, g_planes,
        g_lights);
  return static_cast<int>(cudaGetLastError());
}
