// K1: stable multi-lane sort + keep-last, hand-written for Hopper (sm_90a).
//
// Replaces paimon_tpu/ops/pallas_kernels.py fused_sort_segments (:198),
// whose Pallas body (_fused_kernel :160, _bitonic_sort_lanes :129) holds the
// whole (L+1, m) int32 lane matrix in TPU VMEM for one bitonic network.
// A Hopper block has at most 227 KB of shared memory, so the network is
// split instead:
//   * bitonic_tile  - a block loads TILE columns x nl lanes into shared memory
//                     and runs every compare-exchange stage with stride < TILE
//                     (the whole sort when m <= TILE);
//   * bitonic_global - one thread per compare-exchange pair, for the strides
//                     >= TILE of each merge size k > TILE;
//   * finish        - XOR-fold of the boundary lanes of adjacent sorted
//                     columns -> keep_last (the global last column closes),
//                     and the (3, m) output: perm, keep_last, sorted lane 0.
// Input: arr (nl, m) int32, row-major, m a power of two, nl <= 8, last lane
// distinct (the iota lane): the order is total, so any correct sort yields
// the permutation of a stable sort bit for bit. Lanes arrive sign-flipped
// (u ^ 0x80000000), so signed compares give unsigned order. arr is sorted in
// place (the wrapper passes a scratch copy).
//
// Bound: memory. Each global stage reads and writes nl*m*4 bytes; each tile
// pass reads and writes nl*m*4 bytes once for all its stages. For m = 2^18,
// TILE = 2^11 there are 28 global stages and 8 tile passes. The least the
// card could do is read nl*m*4 bytes and write 3*m*4 bytes once.
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 2048
#define MAX_LANES 8

__device__ __forceinline__ bool lex_gt(const int32_t* base, size_t stride, size_t i, size_t p, int nl) {
  for (int l = 0; l < nl; ++l) {
    int32_t a = base[l * stride + i];
    int32_t b = base[l * stride + p];
    if (a != b) return a > b;
  }
  return false;
}

__device__ __forceinline__ void swap_lanes(int32_t* base, size_t stride, size_t i, size_t p, int nl) {
  for (int l = 0; l < nl; ++l) {
    int32_t t = base[l * stride + i];
    base[l * stride + i] = base[l * stride + p];
    base[l * stride + p] = t;
  }
}

// Stages (k, j) for k in [k_first, k_last] (powers of two) and
// j = min(k, tile)/2 .. 1, on one tile held in shared memory.
__global__ void bitonic_tile(int32_t* arr, int m, int nl, int tile, int k_first, int k_last) {
  extern __shared__ int32_t s[];
  const size_t base = (size_t)blockIdx.x * tile;
  for (int idx = threadIdx.x; idx < tile; idx += blockDim.x)
    for (int l = 0; l < nl; ++l) s[l * tile + idx] = arr[(size_t)l * m + base + idx];
  __syncthreads();
  const int pairs = tile >> 1;
  for (int k = k_first; k <= k_last; k <<= 1) {
    for (int j = (k < tile ? k : tile) >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < pairs; t += blockDim.x) {
        const int i = 2 * j * (t / j) + (t % j);
        const int p = i + j;
        const bool desc = ((base + i) & (size_t)k) != 0;
        if (lex_gt(s, tile, i, p, nl) != desc) swap_lanes(s, tile, i, p, nl);
      }
      __syncthreads();
    }
  }
  for (int idx = threadIdx.x; idx < tile; idx += blockDim.x)
    for (int l = 0; l < nl; ++l) arr[(size_t)l * m + base + idx] = s[l * tile + idx];
}

// One compare-exchange stage (k, j) with j >= TILE, straight on device memory.
__global__ void bitonic_global(int32_t* arr, int m, int nl, int k, int j) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)(m >> 1)) return;
  const size_t i = 2 * (size_t)j * (t / j) + (t % j);
  const size_t p = i + j;
  const bool desc = (i & (size_t)k) != 0;
  if (lex_gt(arr, m, i, p, nl) != desc) swap_lanes(arr, m, i, p, nl);
}

__global__ void finish(const int32_t* arr, int m, int nl, int nb, int32_t* out) {
  const size_t c = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= (size_t)m) return;
  int keep = 1;
  if (c + 1 < (size_t)m) {
    int32_t diff = 0;
    for (int b = 0; b < nb; ++b) diff |= arr[(size_t)b * m + c] ^ arr[(size_t)b * m + c + 1];
    keep = diff != 0;
  }
  out[c] = arr[(size_t)(nl - 1) * m + c];
  out[(size_t)m + c] = keep;
  out[2 * (size_t)m + c] = arr[c];
}

extern "C" int paimon_sort_segments(void* arr_ptr, void* out_ptr, int m, int nl, int nb, void* stream_ptr) {
  int32_t* arr = static_cast<int32_t*>(arr_ptr);
  int32_t* out = static_cast<int32_t*>(out_ptr);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (m < 2 || (m & (m - 1)) != 0 || nl < 1 || nl > MAX_LANES || nb < 1 || nb > nl) return (int)cudaErrorInvalidValue;
  static bool smem_attr_set = false;
  if (!smem_attr_set) {
    cudaError_t e = cudaFuncSetAttribute(bitonic_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         MAX_LANES * TILE * (int)sizeof(int32_t));
    if (e != cudaSuccess) return (int)e;
    smem_attr_set = true;
  }
  const int tile = m < TILE ? m : TILE;
  const int tiles = m / tile;
  const int threads = tile >> 1;  // one compare-exchange pair per thread
  const size_t smem = (size_t)nl * tile * sizeof(int32_t);
  bitonic_tile<<<tiles, threads, smem, stream>>>(arr, m, nl, tile, 2, tile);
  const int pair_blocks = ((m >> 1) + 255) / 256;
  for (int k = 2 * tile; k <= m; k <<= 1) {
    for (int j = k >> 1; j >= tile; j >>= 1) bitonic_global<<<pair_blocks, 256, 0, stream>>>(arr, m, nl, k, j);
    bitonic_tile<<<tiles, threads, smem, stream>>>(arr, m, nl, tile, k, k);
  }
  finish<<<(m + 255) / 256, 256, 0, stream>>>(arr, m, nl, nb, out);
  return (int)cudaGetLastError();
}
