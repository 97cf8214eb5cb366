// Kernel 6: survivor-list compaction of a (T, N) bool mask.
//
// Replaces openglraytracer_tpu/ops/pallas_compact.py::_compact_kernel (the
// pallas_call in compact_mask_pallas). Per tile row: the ids of the set
// mask bytes in ascending order into slots 0..K-1, valid flags, and the
// true survivor count (count > K means overflow, never silent). Slots at or
// past the count hold id 0 and valid 0.
//
// The TPU kernel extracts survivors by iterated max because a TPU has no
// cheap prefix sum. On the card this is a stream compaction: one warp per
// tile row walks N in 32-wide chunks; __ballot_sync of the 32 mask bytes
// and __popc of the lower lanes give each survivor its slot, so a row costs
// N/32 steps whatever its count.
//
// What bounds it on the H100: memory traffic. It reads T*N mask bytes once
// (16.8 MB at c5's T = N = 4096) and writes 5*T*K bytes; a warp's 32 lanes
// read 32 consecutive bytes of one row.
#include "common.cuh"

namespace oglrt {
namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = kBlock / kWarp;

// grid ceil(T / kRowsPerBlock); one warp per tile row
__global__ void __launch_bounds__(kBlock) compact_mask_kernel(
    const bool* __restrict__ mask, int n_rows, int n, int k,
    int* __restrict__ idx, bool* __restrict__ valid, int* __restrict__ count) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= n_rows) return;   // whole warps leave together
  const bool* m = mask + static_cast<long long>(row) * n;
  int* out_idx = idx + static_cast<long long>(row) * k;
  bool* out_valid = valid + static_cast<long long>(row) * k;
  const unsigned lower = (1u << lane) - 1u;

  int total = 0;   // survivors before this chunk, the same in every lane
  for (int base = 0; base < n; base += kWarp) {
    const int i = base + lane;
    const bool set = i < n && m[i];
    const unsigned bits = __ballot_sync(0xffffffffu, set);
    const int slot = total + __popc(bits & lower);
    if (set && slot < k) {
      out_idx[slot] = i;
      out_valid[slot] = true;
    }
    total += __popc(bits);
  }
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
