// In-place pool block copies for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `block_copy` / `_kernel` in
// src/repro/kernels/block_copy/kernel.py, which ran one grid step per move
// with the pool aliased in place (`input_output_aliases`), and the engine's
// jnp scatter over the stacked pools (src/repro/serving/engine.py,
// `_moves_entry`).
//
// What bounds it on the H100: bytes.  Each move reads one pool row and
// writes one, per layer and per pool leaf (K and V): nothing is computed.
// The design moves every leaf of every layer in one launch, one block per
// (move, leaf x layer), each thread copying 16-byte vectors with
// neighbouring threads on neighbouring addresses, so the copy streams at
// full width.  A row of deepseek-7b's pools is 16 tokens x 32 heads x 128
// dims x 2 bytes = 128 KiB per layer.  Moves whose destination is -1 are
// pad and skipped.  Copies run concurrently in place: the caller guarantees
// that no move of a launch reads or writes a row another move writes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename V>
__global__ void __launch_bounds__(kThreads)
block_copy_kernel(const long long* __restrict__ leaves, const int* __restrict__ src,
                  const int* __restrict__ dst, int reps, long long nb,
                  long long row_bytes) {
  const int i = blockIdx.x;               // move
  const int lr = blockIdx.y;              // leaf * reps + layer
  const int d = dst[i];
  if (d < 0) return;
  const int leaf = lr / reps, rep = lr - leaf * reps;
  char* base = reinterpret_cast<char*>(leaves[leaf])
               + (size_t)rep * (size_t)nb * (size_t)row_bytes;
  const V* from = reinterpret_cast<const V*>(base + (size_t)src[i] * row_bytes);
  V* to = reinterpret_cast<V*>(base + (size_t)d * row_bytes);
  const long long n = row_bytes / (long long)sizeof(V);
  for (long long j = threadIdx.x; j < n; j += kThreads) to[j] = from[j];
}

}  // namespace

extern "C" int block_copy_launch(const long long* leaves, const int* src,
                                 const int* dst, int nleaves, int reps, int nm,
                                 long long nb, long long row_bytes,
                                 void* stream) {
  if (nm == 0) return 0;
  dim3 grid(nm, nleaves * reps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte vectors when every row starts 16-byte aligned (allocations are
  // 256-byte aligned, so the row size decides)
  if (row_bytes % 16 == 0)
    block_copy_kernel<uint4><<<grid, kThreads, 0, s>>>(leaves, src, dst, reps,
                                                       nb, row_bytes);
  else
    block_copy_kernel<unsigned char><<<grid, kThreads, 0, s>>>(
        leaves, src, dst, reps, nb, row_bytes);
  return static_cast<int>(cudaGetLastError());
}
