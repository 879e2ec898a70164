// Sorted-order segment sum of a float column, hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel. It is the float case of jax.ops.segment_sum in
// the JAX package's aggregation engine (paimon_tpu/ops/aggregates.py _sum_fn
// :72 and _fused_aggregate_fn :304), an XLA program. XLA on the CPU adds the
// rows of each segment one after another in sorted order, starting from 0,
// and the port must give the same bits. torch's scatter-adds (index_add_,
// scatter_add_, scatter_reduce) add with atomics in an order that changes
// from run to run, so their float sums do not. Here one thread owns one
// segment: it starts at a row whose seg_start is set, adds the segment's rows
// in sorted order into an accumulator of the column's own type that starts at
// 0, and writes out[seg_id]. Starting at 0 keeps XLA's one rounding case: a
// segment of one -0.0 sums to +0.0.
//
// Bound: memory. values and seg_start are read once and one value is written
// per segment. Threads of a warp start at neighbouring rows and walk short
// segments (a merge holds a few rows per key), so their loads stay within a
// few cache lines; a segment of length L keeps its thread for L adds, and a
// warp waits for its longest segment. Nothing more is needed while the merge
// is host-bound (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int BLOCK = 256;

template <typename T>
__global__ void segment_sum_kernel(const T* __restrict__ values, const uint8_t* __restrict__ seg_start,
                                   const int32_t* __restrict__ seg_id, T* __restrict__ out, long long m) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= m || !seg_start[i]) return;
  T acc = T(0);
  long long j = i;
  do {
    acc += values[j];
    ++j;
  } while (j < m && !seg_start[j]);
  out[seg_id[i]] = acc;
}

// values: (m,) float or double in sorted order; seg_start: (m,) bool, set at
// the first row of each segment (row 0 always); seg_id: (m,) int32 segment of
// each row; out: (m,) of values' type, zeroed by the caller (rows past the
// last segment keep 0). is_double selects the type. Returns the launch's
// CUDA error code.
extern "C" int paimon_segment_sum(const void* values, const void* seg_start, const void* seg_id, void* out,
                                  long long m, int is_double, void* stream) {
  if (m <= 0) return 0;
  const unsigned grid = static_cast<unsigned>((m + BLOCK - 1) / BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* starts = static_cast<const uint8_t*>(seg_start);
  const int32_t* ids = static_cast<const int32_t*>(seg_id);
  if (is_double) {
    segment_sum_kernel<double><<<grid, BLOCK, 0, s>>>(static_cast<const double*>(values), starts, ids,
                                                     static_cast<double*>(out), m);
  } else {
    segment_sum_kernel<float><<<grid, BLOCK, 0, s>>>(static_cast<const float*>(values), starts, ids,
                                                    static_cast<float*>(out), m);
  }
  return static_cast<int>(cudaGetLastError());
}
