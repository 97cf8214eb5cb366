// Kernel 6: survivor-list compaction of a (T, N) bool mask.
//
// Replaces openglraytracer_tpu/ops/pallas_compact.py::_compact_kernel (:52,
// the pallas_call in compact_mask_pallas at :116). Per tile row: the ids of
// the set mask bytes in ascending order into slots 0..K-1, valid flags, and
// the true survivor count (count > K means overflow, never silent). Slots
// at or past the count hold id 0 and valid 0.
//
// The TPU kernel extracts survivors by iterated max because a TPU has no
// cheap prefix sum. On the card this is a stream compaction, one warp per
// tile row.
//
// What bounds it on the H100: memory traffic. It reads T*N mask bytes once
// (16.8 MB at c5's T = N = 4096) and writes 5*T*K bytes. A warp reading
// one byte a lane moves 32 bytes a step, and a 4096-wide row then takes 128
// dependent ballot steps: too few bytes in flight to reach the bound. So
// each lane loads 16 bytes (a warp 512 bytes a step, a 4096-wide row in 8
// steps), counts its survivors with __popc over the packed 0/1 bytes, and
// the warp gives each lane its first slot by an exclusive scan of those
// counts (__shfl_up_sync); a lane then writes its survivors in ascending
// order. The next step's load is issued before this step's scan. A row
// whose start is not 16-byte aligned (N % 16 != 0) takes its first and
// last few bytes in one ballot step each.
#include <cstdint>

#include "common.cuh"

namespace oglrt {
namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = kBlock / kWarp;
constexpr int kVec = 16;   // mask bytes a lane loads a step

__device__ __forceinline__ uint4 load_vec(const uint4* v, int i, int n_vec) {
  return i < n_vec ? __ldg(v + i) : make_uint4(0u, 0u, 0u, 0u);
}

// grid ceil(T / kRowsPerBlock); one warp per tile row
__global__ void __launch_bounds__(kBlock) compact_mask_kernel(
    const bool* __restrict__ mask, int n_rows, int n, int k,
    int* __restrict__ idx, bool* __restrict__ valid, int* __restrict__ count) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= n_rows) return;   // whole warps leave together
  const unsigned char* m = reinterpret_cast<const unsigned char*>(mask) +
                           static_cast<long long>(row) * n;
  int* out_idx = idx + static_cast<long long>(row) * k;
  bool* out_valid = valid + static_cast<long long>(row) * k;
  const unsigned lower = (1u << lane) - 1u;

  int total = 0;   // survivors before this step, the same in every lane
  // one ballot step over bytes [lo, hi), at most 32 of them
  auto bytes = [&](int lo, int hi) {
    const int i = lo + lane;
    const bool set = i < hi && m[i];
    const unsigned bits = __ballot_sync(0xffffffffu, set);
    const int slot = total + __popc(bits & lower);
    if (set && slot < k) {
      out_idx[slot] = i;
      out_valid[slot] = true;
    }
    total += __popc(bits);
  };

  // the bytes before the row's first 16-byte boundary, the aligned body,
  // the ragged tail
  const int head =
      min(n, static_cast<int>((kVec - (reinterpret_cast<uintptr_t>(m) &
                                       (kVec - 1))) & (kVec - 1)));
  const int n_vec = (n - head) / kVec;
  bytes(0, head);
  const uint4* v = reinterpret_cast<const uint4*>(m + head);
  uint4 cur = load_vec(v, lane, n_vec);
  for (int base = 0; base < n_vec; base += kWarp) {
    const uint4 nxt = load_vec(v, base + kWarp + lane, n_vec);
    // a mask byte is 0 or 1: a word's popc counts its set bytes
    const int c = __popc(cur.x) + __popc(cur.y) + __popc(cur.z) +
                  __popc(cur.w);
    int incl = c;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += t;
    }
    int slot = total + incl - c;
    if (c > 0 && slot < k) {
      const int first = head + kVec * (base + lane);
      const unsigned w[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        for (unsigned bits = w[q]; bits && slot < k; bits &= bits - 1u) {
          out_idx[slot] = first + 4 * q + (__ffs(bits) - 1) / 8;
          out_valid[slot] = true;
          ++slot;
        }
      }
    }
    total += __shfl_sync(0xffffffffu, incl, kWarp - 1);
    cur = nxt;
  }
  bytes(head + kVec * n_vec, n);
  for (int slot = total + lane; slot < k; slot += kWarp) {
    out_idx[slot] = 0;
    out_valid[slot] = false;
  }
  if (lane == 0) count[row] = total;
}

}  // namespace
}  // namespace oglrt

extern "C" int oglrt_compact_mask(const bool* mask, int n_rows, int n, int k,
                                  int* idx, bool* valid, int* count,
                                  void* stream) {
  if (n_rows == 0) return 0;
  const int grid =
      (n_rows + oglrt::kRowsPerBlock - 1) / oglrt::kRowsPerBlock;
  oglrt::compact_mask_kernel<<<grid, oglrt::kBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      mask, n_rows, n, k, idx, valid, count);
  return static_cast<int>(cudaGetLastError());
}
