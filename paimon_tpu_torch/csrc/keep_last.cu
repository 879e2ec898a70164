// K2: boundary sweep after a stable sort, hand-written for Hopper (sm_90a).
//
// Replaces paimon_tpu/ops/pallas_kernels.py keep_last_mask (:265), whose
// Pallas body (_keep_last_kernel_factory :229) walks 2048-column blocks with a
// one-block lookahead and pads the ragged tail with synthetic pad rows
// (_sweep_block :252). For every column c of the (L, m) lane matrix:
//   out[c] = 1 if any lane differs between columns c and c + 1, else 0;
//   out[m - 1] = 1 (the global last row closes its segment);
//   mask_pad != 0 also zeroes columns whose lane 0 (the pad flag) is not 0.
// Lanes are int32 bit patterns of the uint32 lanes; equality is all it needs.
//
// Bound: memory. The least traffic is L*m*4 bytes read and m*4 bytes written,
// and nothing is reused, so the design reads every word once, 16 bytes at a
// time, and keeps the grid small enough that launch ramp and tail stay short:
// - keep_last_vec: a thread owns groups of V = 4 consecutive columns. Lane by
//   lane it loads each group as one read-only int4 and folds it into one
//   diff word per column, so registers do not grow with L. The column after a
//   group (the next group's first word) comes from the warp neighbour by
//   shuffle; only a warp's last thread loads it, as one scalar word. Lane 0
//   stays in registers for mask_pad. UNROLL groups per thread per trip of a
//   grid-stride loop, a warp's 32 groups contiguous in each; the grid is at
//   most the blocks the card holds at once (SMs x blocks per SM, read once per
//   device). One streaming int4 store per group. The loads in flight come
//   from residency (2048 threads an SM at 32 registers), not from unrolling:
//   UNROLL 2 and 4 take more registers, fewer blocks fit, and they measured
//   slower at (2, 2^21), as did BLOCK 256 and 512 (PERF.md, K2 candidates).
//   Needs 16-byte aligned rows: x and out at 16-byte addresses and m % 4 == 0.
//   The main path (m a power of two >= 128, fresh allocations) always is.
// - keep_last_scalar: any other input (m not a multiple of 4, a view at an
//   odd offset), one column per thread, the same formula.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int BLOCK = 128;  // threads per block
constexpr int UNROLL = 1;   // column groups per thread per trip
constexpr int V = 4;        // columns per group: one int4
constexpr unsigned FULL_WARP = 0xffffffffu;
constexpr int MAX_DEVICES = 64;

// Loads lane `row` for this thread's UNROLL groups into v and folds
// "column differs from the next column" into diff.
__device__ __forceinline__ void fold_lane(const int32_t* __restrict__ row, long long g0, long long stride,
                                          long long groups, bool warp_last, int4 (&v)[UNROLL],
                                          int4 (&diff)[UNROLL]) {
  int32_t next[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long g = g0 + u * stride;
    v[u] = g < groups ? __ldg(reinterpret_cast<const int4*>(row) + g) : make_int4(0, 0, 0, 0);
    next[u] = warp_last && g + 1 < groups ? __ldg(row + (g + 1) * V) : 0;
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    // every thread of the warp reaches the shuffle: the loop above is warp-uniform
    const int32_t down = __shfl_down_sync(FULL_WARP, v[u].x, 1);
    diff[u].x |= v[u].x ^ v[u].y;
    diff[u].y |= v[u].y ^ v[u].z;
    diff[u].z |= v[u].z ^ v[u].w;
    diff[u].w |= v[u].w ^ (warp_last ? next[u] : down);
  }
}

__global__ void __launch_bounds__(BLOCK)
    keep_last_vec(const int32_t* __restrict__ x, int lanes, long long m, int mask_pad, int32_t* __restrict__ out) {
  const long long groups = m / V;
  const long long stride = (long long)gridDim.x * BLOCK;
  const long long t = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const bool warp_last = (threadIdx.x & 31) == 31;
  // every thread runs every trip, so the shuffles see the whole warp
  for (long long base = 0; base < groups; base += stride * UNROLL) {
    int4 diff[UNROLL], pad[UNROLL], v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) diff[u] = make_int4(0, 0, 0, 0);
    fold_lane(x, base + t, stride, groups, warp_last, pad, diff);
    for (int l = 1; l < lanes; ++l) fold_lane(x + l * m, base + t, stride, groups, warp_last, v, diff);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long g = base + u * stride + t;
      if (g >= groups) continue;
      int4 k = make_int4(diff[u].x != 0, diff[u].y != 0, diff[u].z != 0, diff[u].w != 0 || g + 1 == groups);
      if (mask_pad) {
        k.x &= pad[u].x == 0;
        k.y &= pad[u].y == 0;
        k.z &= pad[u].z == 0;
        k.w &= pad[u].w == 0;
      }
      __stcs(reinterpret_cast<int4*>(out) + g, k);
    }
  }
}

__global__ void __launch_bounds__(BLOCK)
    keep_last_scalar(const int32_t* __restrict__ x, int lanes, long long m, int mask_pad, int32_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * BLOCK;
  for (long long c = (long long)blockIdx.x * BLOCK + threadIdx.x; c < m; c += stride) {
    int keep = 1;
    if (c + 1 < m) {
      int32_t diff = 0;
      for (int l = 0; l < lanes; ++l) diff |= __ldg(x + l * m + c) ^ __ldg(x + l * m + c + 1);
      keep = diff != 0;
    }
    if (mask_pad && __ldg(x + c) != 0) keep = 0;
    out[c] = keep;
  }
}

// Blocks of each kernel that the current device holds at once, computed on
// the first call for that device.
static cudaError_t resident_blocks(int* vec_blocks, int* scalar_blocks) {
  static int cache[MAX_DEVICES][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int local[2] = {0, 0};
  int* slot = dev < MAX_DEVICES ? cache[dev] : local;
  if (slot[0] == 0) {
    int sms = 0, vec = 0, scalar = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&vec, keep_last_vec, BLOCK, 0)) != cudaSuccess) return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&scalar, keep_last_scalar, BLOCK, 0)) != cudaSuccess)
      return err;
    slot[1] = sms * (scalar > 0 ? scalar : 1);
    slot[0] = sms * (vec > 0 ? vec : 1);
  }
  *vec_blocks = slot[0];
  *scalar_blocks = slot[1];
  return cudaSuccess;
}

extern "C" int paimon_keep_last(void* x_ptr, void* out_ptr, int lanes, int m, int mask_pad, void* stream_ptr) {
  if (m < 1 || lanes < 1) return (int)cudaErrorInvalidValue;
  int vec_blocks = 0, scalar_blocks = 0;
  cudaError_t err = resident_blocks(&vec_blocks, &scalar_blocks);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int32_t* x = static_cast<const int32_t*>(x_ptr);
  int32_t* out = static_cast<int32_t*>(out_ptr);
  const bool aligned = reinterpret_cast<uintptr_t>(x_ptr) % 16 == 0 && reinterpret_cast<uintptr_t>(out_ptr) % 16 == 0 &&
                       m % V == 0;
  if (aligned) {
    const long long need = ((long long)(m / V) + (long long)BLOCK * UNROLL - 1) / ((long long)BLOCK * UNROLL);
    const int blocks = (int)(need < vec_blocks ? need : vec_blocks);
    keep_last_vec<<<blocks, BLOCK, 0, stream>>>(x, lanes, m, mask_pad, out);
  } else {
    const long long need = ((long long)m + BLOCK - 1) / BLOCK;
    const int blocks = (int)(need < scalar_blocks ? need : scalar_blocks);
    keep_last_scalar<<<blocks, BLOCK, 0, stream>>>(x, lanes, m, mask_pad, out);
  }
  return (int)cudaGetLastError();
}
