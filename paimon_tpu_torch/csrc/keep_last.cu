// K2: boundary sweep after a stable sort, hand-written for Hopper (sm_90a).
//
// Replaces paimon_tpu/ops/pallas_kernels.py keep_last_mask (:265), whose
// Pallas body (_keep_last_kernel_factory :229) walks 2048-column blocks with a
// one-block lookahead and pads the ragged tail with synthetic pad rows
// (_sweep_block :252). Here one thread owns one column c of the (L, m) lane
// matrix: it reads lane l at c and c + 1 (neighbouring threads read
// neighbouring addresses, so every lane row is read coalesced) and masks the
// ragged edge itself, so no padding is needed for any m >= 1.
//   out[c] = 1 if any lane differs between columns c and c + 1, else 0;
//   out[m - 1] = 1 (the global last row closes its segment);
//   mask_pad != 0 also zeroes columns whose lane 0 (the pad flag) is not 0.
// Lanes are int32 bit patterns of the uint32 lanes; equality is all it needs.
//
// Bound: memory. The least traffic is L*m*4 bytes read and m*4 bytes written.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void keep_last(const int32_t* x, int lanes, int m, int mask_pad, int32_t* out) {
  const size_t c = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= (size_t)m) return;
  int keep = 1;
  if (c + 1 < (size_t)m) {
    int32_t diff = 0;
    for (int l = 0; l < lanes; ++l) diff |= x[(size_t)l * m + c] ^ x[(size_t)l * m + c + 1];
    keep = diff != 0;
  }
  if (mask_pad && x[c] != 0) keep = 0;
  out[c] = keep;
}

extern "C" int paimon_keep_last(void* x_ptr, void* out_ptr, int lanes, int m, int mask_pad, void* stream_ptr) {
  if (m < 1 || lanes < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  keep_last<<<(m + 255) / 256, 256, 0, stream>>>(static_cast<const int32_t*>(x_ptr), lanes, m, mask_pad,
                                                  static_cast<int32_t*>(out_ptr));
  return (int)cudaGetLastError();
}
