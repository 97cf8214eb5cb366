// Sum of per-ray winner cotangents into per-block object rows.
//
// Replaces no TPU kernel: the JAX package writes this transpose of the
// per-tile winner gather as one-hot contractions, which XLA fuses, and the
// port first wrote it as index_add_, whose CUDA kernel does one global
// float atomic per ray and column. A tile's rays land on a handful of
// survivor slots (and every plane ray of the image on one plane row), so
// those atomics serialise on a few addresses: 18 ms of a 2048x2048
// training step on an H100.
//
// Input, for R rays in groups of G consecutive rays (a tile's rays):
//   rows (R, F):        a ray's cotangent row for its survivor slot;
//   slot (R,):          its slot in [0, K) of its group's list, -1 none;
//   obj (T, K):         the output row of each slot of each group, of
//                       n_out rows;
//   plane_rows (R, F):  a ray's cotangent row for its plane;
//   plane_slot (R,):    its plane in [0, NP), -1 none; it takes precedence
//                       over slot (the ray's winner is that plane);
//   plane_obj (NP,):    the output row of each plane (null: the plane's
//                       own index).
// Slots and planes outside their range are skipped, as -1 is.
//
// Output, for B blocks: part (B * K + B * NP, F), each block's K slot rows
// (the sums of its rays' rows by slot), then each block's NP plane rows;
// part_idx (B * K + B * NP,), the output row of each (obj, plane_obj; a
// slot row that no ray reached holds zeros and names row (its position mod
// n_out) instead: the lists' pad slots all name object 0, and index_add_'s
// atomics would queue on that row). The caller adds part into the object
// rows by part_idx (index_add_), so the sums across blocks and tiles are
// torch's, in a fixed order whenever torch's deterministic algorithms are
// on.
//
// Design. A block takes `chunk` consecutive rays of one group (a tile is
// split over blocks where it is longer). Each thread reads its ray's row
// as 16-byte (F % 4 == 0) or 8-byte loads, coalesced. A warp covers 32
// neighbouring pixels, which nearly always share one to three slots: equal
// slots are grouped with __match_any_sync and summed by a shuffle tree
// (reduce_peers), and the lowest lane of each group adds the sum into the
// block's row of that slot, the warps of a round one after another in
// warp order. So every sum has one order, fixed by the rays alone: the
// kernel gives the same bits on every run. The block's rows live in shared
// memory; where K slot rows do not fit (survivor lists of thousands), the
// slot rows are summed in place in the block's rows of part instead. Every
// row is written out once, zero where no ray came: no atomic per ray, and
// no float atomic at all.
//
// What bounds it on the H100: memory. A ray reads its slot and plane slot
// (8 bytes) and its row only when it has one (4 F bytes): at 2048x2048
// with F = 20 at most 369 MB, 0.11 ms at 3.35 TB/s; the rows written out
// are B (K + NP) F floats (24 MB at c5's material rows).
#include "common.cuh"

namespace oglrt {
namespace {

constexpr int kWarps = kBlock / 32;
// Shared memory a block may use without opting in to more.
constexpr int kSharedBytes = 48 * 1024;

// Sum x over the lanes of `peers` (the calling lane's group of equal
// keys); the group's lowest lane ends with the sum. Every lane of the warp
// calls it together. A tree over the lanes' ranks in their group: in round
// i a lane adds the value of the peer 2^i ranks above it.
template <int F>
__device__ __forceinline__ void reduce_peers(unsigned peers, int lane,
                                             float (&x)[F]) {
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & (0xfffffffeu << lane);
  while (__any_sync(0xffffffffu, above)) {
    const int next = __ffs(above);  // 1 + the next-higher peer's lane, or 0
    const int src = next ? next - 1 : lane;
#pragma unroll
    for (int c = 0; c < F; ++c) {
      const float t = __shfl_sync(0xffffffffu, x[c], src);
      if (next) x[c] = x[c] + t;
    }
    above &= ~__ballot_sync(0xffffffffu, rank & 1);
    rank >>= 1;
  }
}

template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         float (&x)[F]) {
  if constexpr (F % 4 == 0) {
    const float4* v = reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 a = __ldg(v + q);
      x[4 * q] = a.x;
      x[4 * q + 1] = a.y;
      x[4 * q + 2] = a.z;
      x[4 * q + 3] = a.w;
    }
  } else {
    static_assert(F % 2 == 0, "rows of an even width");
    const float2* v = reinterpret_cast<const float2*>(src);
#pragma unroll
    for (int q = 0; q < F / 2; ++q) {
      const float2 a = __ldg(v + q);
      x[2 * q] = a.x;
      x[2 * q + 1] = a.y;
    }
  }
}

// kSharedSlots: the K slot rows are summed in shared memory (else in the
// block's rows of part). Shared memory: the summed rows (K slot rows if
// kSharedSlots, then NP plane rows) as floats, then one byte a slot and
// plane that says it received a ray.
template <int F, bool kSharedSlots>
__global__ void __launch_bounds__(kBlock) winner_scatter_kernel(
    const float* __restrict__ rows, const int* __restrict__ slot,
    const int* __restrict__ obj, int k, int n_out, int group, int chunk,
    long long n_rays, const float* __restrict__ plane_rows,
    const int* __restrict__ plane_slot, const int* __restrict__ plane_obj,
    int n_planes, float* part, int* __restrict__ part_idx) {
  extern __shared__ float acc[];
  const long long b = blockIdx.x;
  const long long n_blocks = gridDim.x;
  float* slot_acc = kSharedSlots ? acc : part + b * k * F;
  float* plane_acc = acc + (kSharedSlots ? k * F : 0);
  const int keys = k + n_planes;
  unsigned char* touched =
      reinterpret_cast<unsigned char*>(plane_acc + n_planes * F);
  for (int i = threadIdx.x; i < k * F; i += kBlock) slot_acc[i] = 0.0f;
  for (int i = threadIdx.x; i < n_planes * F; i += kBlock) plane_acc[i] = 0.0f;
  for (int i = threadIdx.x; i < keys; i += kBlock) touched[i] = 0;
  __syncthreads();

  const int chunks = (group + chunk - 1) / chunk;
  const long long g = b / chunks;
  const long long start = g * group + (b % chunks) * chunk;
  long long end = start + chunk;
  if (end > (g + 1) * group) end = (g + 1) * group;
  if (end > n_rays) end = n_rays;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // every thread of the block runs the same rounds (they meet at barriers)
  for (long long base = start; base < end; base += kBlock) {
    const long long r = base + threadIdx.x;
    int key = -1;
    if (r < end) {
      const int p = plane_slot ? plane_slot[r] : -1;
      if (p >= 0 && p < n_planes) {
        key = k + p;
      } else if (slot) {
        const int s = slot[r];
        if (s >= 0 && s < k) key = s;
      }
    }
    float x[F];
#pragma unroll
    for (int c = 0; c < F; ++c) x[c] = 0.0f;
    if (key >= k) {
      load_row<F>(plane_rows + r * F, x);
    } else if (key >= 0) {
      load_row<F>(rows + r * F, x);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    reduce_peers<F>(peers, lane, x);
    const bool lead = key >= 0 && lane == __ffs(peers) - 1;
    // the warps' sums join the block's rows in warp order; a warp's
    // leaders hold distinct keys, so they never write one row together
    for (int w = 0; w < kWarps; ++w) {
      if (warp == w && lead) {
        float* dst = key < k ? slot_acc + key * F : plane_acc + (key - k) * F;
#pragma unroll
        for (int c = 0; c < F; ++c) dst[c] = dst[c] + x[c];
        touched[key] = 1;
      }
      __syncthreads();
    }
  }

  if (kSharedSlots) {
    float* dst = part + b * k * F;
    for (int i = threadIdx.x; i < k * F; i += kBlock) dst[i] = slot_acc[i];
  }
  float* plane_dst = part + (n_blocks * k + b * n_planes) * F;
  for (int i = threadIdx.x; i < n_planes * F; i += kBlock)
    plane_dst[i] = plane_acc[i];
  const int* obj_g = obj ? obj + g * k : nullptr;
  for (int i = threadIdx.x; i < k; i += kBlock)
    part_idx[b * k + i] =
        touched[i] ? obj_g[i] : static_cast<int>((b * k + i) % n_out);
  for (int i = threadIdx.x; i < n_planes; i += kBlock)
    part_idx[n_blocks * k + b * n_planes + i] = plane_obj ? plane_obj[i] : i;
}

template <int F>
int launch_f(const float* rows, const int* slot, const int* obj, int k,
             int n_out, int group, int chunk, long long n_rays,
             const float* plane_rows, const int* plane_slot,
             const int* plane_obj, int n_planes,
             float* part, int* part_idx, cudaStream_t stream) {
  const long long groups = (n_rays + group - 1) / group;
  const long long blocks = groups * ((group + chunk - 1) / chunk);
  const long long flags = k + n_planes;
  const long long all_rows = 4LL * (k + n_planes) * F + flags;
  if (all_rows <= kSharedBytes) {
    winner_scatter_kernel<F, true>
        <<<static_cast<unsigned>(blocks), kBlock,
           static_cast<size_t>(all_rows), stream>>>(
            rows, slot, obj, k, n_out, group, chunk, n_rays, plane_rows,
            plane_slot, plane_obj, n_planes, part, part_idx);
  } else {
    const long long plane_only = 4LL * n_planes * F + flags;
    if (plane_only > kSharedBytes) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    winner_scatter_kernel<F, false>
        <<<static_cast<unsigned>(blocks), kBlock,
           static_cast<size_t>(plane_only), stream>>>(
            rows, slot, obj, k, n_out, group, chunk, n_rays, plane_rows,
            plane_slot, plane_obj, n_planes, part, part_idx);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace oglrt

// Launch on `stream`. rows and plane_rows hold n_rays rows of f floats
// (f = 4, 18 or 20), 16-byte aligned for f % 4 == 0 and 8-byte otherwise;
// slot, obj and rows may be null together (planes only, k = 0; n_out is
// then unread), and plane_rows, plane_slot and plane_obj null with
// n_planes = 0. part and
// part_idx hold B = ceil(n_rays / group) * ceil(group / chunk) blocks'
// rows as the header says. Shared memory holds the flags of
// k slots and n_planes planes and the summed plane rows (else
// cudaErrorInvalidValue).
extern "C" int oglrt_winner_scatter(const float* rows, const int* slot,
                                    const int* obj, int k, int n_out,
                                    int group, int chunk, long long n_rays,
                                    int f,
                                    const float* plane_rows,
                                    const int* plane_slot,
                                    const int* plane_obj, int n_planes,
                                    float* part, int* part_idx,
                                    void* stream) {
  if (n_rays == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (f) {
    case 4:
      return oglrt::launch_f<4>(rows, slot, obj, k, n_out, group, chunk,
                                n_rays, plane_rows, plane_slot, plane_obj,
                                n_planes, part, part_idx, s);
    case 18:
      return oglrt::launch_f<18>(rows, slot, obj, k, n_out, group, chunk,
                                 n_rays, plane_rows, plane_slot, plane_obj,
                                 n_planes, part, part_idx, s);
    case 20:
      return oglrt::launch_f<20>(rows, slot, obj, k, n_out, group, chunk,
                                 n_rays, plane_rows, plane_slot, plane_obj,
                                 n_planes, part, part_idx, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
