// K1: stable multi-lane sort + keep-last, hand-written for Hopper (sm_90a).
//
// Replaces paimon_tpu/ops/pallas_kernels.py fused_sort_segments (:198), whose
// Pallas body (_fused_kernel :160, _bitonic_sort_lanes :129) holds the whole
// (L+1, m) int32 lane matrix in TPU VMEM for one bitonic network and then
// XOR-folds the boundary lanes of adjacent sorted columns.
//
// Contract. arr (nl, m) int32, row-major, nl in [2, 8], m a power of two in
// [2, 2^18], 1 <= nb < nl boundary lanes first, last lane distinct (the iota
// lane). Lanes arrive sign-flipped (u ^ 0x80000000), so signed compares give
// unsigned order. With a distinct last lane the order is total, so any
// correct sort yields the stable sort's permutation bit for bit. out (3, m):
// perm (the sorted last lane), keep_last (1 where the nb boundary lanes of
// sorted columns c and c+1 differ; the last column closes), sorted lane 0.
// arr is only read; scratch holds min(rounds, 2) lane matrices.
//
// Design, 1 + log2(m / T) launches on the caller's stream:
//   block_sort  - each block sorts a tile of T = TILE columns (all of m when
//                 m <= T) with a bitonic network. Each of its T/E threads holds
//                 E = PER_THREAD consecutive columns' lanes in registers
//                 (templated on nl, so the lane arrays stay in registers).
//                 Strides below E run inside the thread, strides below 32*E
//                 between the threads of a warp through __shfl_xor_sync, with
//                 no barrier. Only strides of 32*E and more go through shared
//                 memory, whose lane rows carry one pad word per 32 columns so
//                 that neither the blocked register layout nor a stage's pairs
//                 meet on a bank.
//   merge_round - each round merges pairs of sorted runs along the merge path.
//                 A block owns MERGE_SPAN output columns. Two of its warps find
//                 its start and end splits by a 32-way search over the
//                 lexicographic lane order in device memory, A first on ties,
//                 so the merge is stable whatever the data. The block stages
//                 its A and B windows in shared memory with cp.async, each
//                 thread finds its MERGE_ITEMS-column sub-span by a second
//                 search there and merges it, and each lane row is written out
//                 coalesced. Rounds ping-pong between the two scratch matrices.
//   The last launch (the final round, or the block sort when m <= T) writes
//   out directly. keep_last of a block's last column needs column c+1: in a
//   merge round that is the smaller head of A and B at the block's end split;
//   the global last column has none and closes.
//
// Bound: memory. The least traffic is nl*m*4 bytes read and 3*m*4 written
// (1.5 MB each way at the (3, 2^17) read shape, under a microsecond at
// 3.35 TB/s). This design moves the lane matrix once per launch, through the
// 50 MB L2, so its time is launch and latency: per round one device-memory
// search of about four dependent steps, one staged load, one write.
//
// Against the split bitonic network this replaces: at (3, 2^17) that ran 64
// blocks of 1024 threads (under half the 132 SMs) through 66 barrier-separated
// shared-memory stages with integer division in the pair index, one full pass
// over the matrix per stride >= 2048 (21 launches) plus 6 more tile passes, a
// clone of the input and a separate boundary launch: about 30 launches. Here
// a tile of 512 puts 256 blocks on the card, a block meets a barrier only
// around its few shared-memory stages, every index is shifts and masks, each
// stride >= T is folded into one merge round, the input is read in place and
// the boundary fold rides on the last launch.
//
// T 512 and E 4 were chosen on the H100 against T in {512, 1024, 2048} and
// E in {4, 8, 16} (PERF.md): the fastest plan that gives the (3, 2^17) read
// shape a block on every SM. Shared memory is static, at most 16,928 bytes
// a block at nl = 8, so no launch needs the dynamic limit above 48 KB raised.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 512;  // paimon_tpu_torch/ops/hopper_kernels.py K1_TILE
constexpr int PER_THREAD = 4;
constexpr int SORT_THREADS = TILE / PER_THREAD;
constexpr int MERGE_THREADS = 128;
constexpr int MERGE_ITEMS = 4;
constexpr int MERGE_SPAN = MERGE_THREADS * MERGE_ITEMS;
constexpr unsigned FULL_WARP = 0xffffffffu;

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x >> 1); }
constexpr int LOG_E = ilog2(PER_THREAD);

// Shared-memory lane row for n columns: one pad word per 32, plus one column
// (a merge block's successor column).
__host__ __device__ constexpr int padded_row(int n) { return n + (n >> 5) + 1; }

__device__ __forceinline__ int pad(int c) { return c + (c >> 5); }

// -1, 0 or 1 as column a sorts before, equal to or after column b; lane 0
// is the most significant.
template <int NL>
__device__ __forceinline__ int lex_cmp(const int32_t (&a)[NL], const int32_t (&b)[NL]) {
  int c = 0;
#pragma unroll
  for (int l = NL - 1; l >= 0; --l) c = a[l] != b[l] ? (a[l] > b[l] ? 1 : -1) : c;
  return c;
}

template <int NL>
__device__ __forceinline__ void load_column(const int32_t* p, size_t stride, int32_t (&x)[NL]) {
#pragma unroll
  for (int l = 0; l < NL; ++l) x[l] = p[(size_t)l * stride];
}

template <int NL>
__device__ __forceinline__ void load_shared(const int32_t* s, int row, int c, int32_t (&x)[NL]) {
#pragma unroll
  for (int l = 0; l < NL; ++l) x[l] = s[l * row + pad(c)];
}

__device__ __forceinline__ void cp_async4(int32_t* smem, const int32_t* gmem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// block sort
// ---------------------------------------------------------------------------

template <int NL>
__device__ __forceinline__ void shared_to_regs(const int32_t* s, int32_t (&v)[PER_THREAD][NL], int tid) {
  constexpr int ROW = padded_row(TILE);
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) load_shared<NL>(s, ROW, (tid << LOG_E) + e, v[e]);
}

template <int NL>
__device__ __forceinline__ void regs_to_shared(const int32_t (&v)[PER_THREAD][NL], int32_t* s, int tid) {
  constexpr int ROW = padded_row(TILE);
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int c = pad((tid << LOG_E) + e);
#pragma unroll
    for (int l = 0; l < NL; ++l) s[l * ROW + c] = v[e][l];
  }
}

// Stages j = E/2 .. 1 (those below k) of merge size k on the thread's own
// columns first .. first + E - 1.
template <int NL>
__device__ __forceinline__ void exchange_in_thread(int32_t (&v)[PER_THREAD][NL], int first, int k) {
#pragma unroll
  for (int j = PER_THREAD / 2; j >= 1; j >>= 1) {
    if (j < k) {
#pragma unroll
      for (int e = 0; e < PER_THREAD; ++e) {
        if (e & j) continue;
        const bool desc = ((first + e) & k) != 0;
        const int c = lex_cmp<NL>(v[e], v[e | j]);
        const bool swap = desc ? c < 0 : c > 0;
#pragma unroll
        for (int l = 0; l < NL; ++l) {
          const int32_t x = v[e][l], y = v[e | j][l];
          v[e][l] = swap ? y : x;
          v[e | j][l] = swap ? x : y;
        }
      }
    }
  }
}

// One stage of merge size k between the threads of a warp: stride j = mask*E,
// partner thread lane ^ mask. k > j >= E, so the direction is the thread's.
template <int NL>
__device__ __forceinline__ void exchange_warp(int32_t (&v)[PER_THREAD][NL], int tid, int k, int mask) {
  const bool desc = ((tid << LOG_E) & k) != 0;
  const bool want_min = ((tid & mask) == 0) != desc;
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    int32_t t[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) t[l] = __shfl_xor_sync(FULL_WARP, v[e][l], mask);
    const int c = lex_cmp<NL>(v[e], t);
    const bool take = want_min ? c > 0 : c < 0;
#pragma unroll
    for (int l = 0; l < NL; ++l) v[e][l] = take ? t[l] : v[e][l];
  }
}

// One stage (k, j >= 32*E) on the tile in shared memory; consecutive threads
// take consecutive pairs.
template <int NL>
__device__ __forceinline__ void exchange_shared(int32_t* s, int n, int k, int j, int tid) {
  constexpr int ROW = padded_row(TILE);
  for (int q = tid; q < (n >> 1); q += SORT_THREADS) {
    const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
    int32_t a[NL], b[NL];
    load_shared<NL>(s, ROW, i, a);
    load_shared<NL>(s, ROW, i + j, b);
    const bool desc = (i & k) != 0;
    const int c = lex_cmp<NL>(a, b);
    if (desc ? c < 0 : c > 0) {
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        s[l * ROW + pad(i)] = b[l];
        s[l * ROW + pad(i + j)] = a[l];
      }
    }
  }
}

// Columns [0, n) of a tile in shared memory go to dst (a lane matrix) or, on
// the last launch, to out (3, m). has_next: shared column n holds the column
// that follows the tile in sorted order.
template <int NL>
__device__ __forceinline__ void write_tile(const int32_t* s, int row, int n, size_t base, int m, int nb,
                                           bool has_next, int32_t* dst, int32_t* out, int tid, int threads) {
  if (dst != nullptr) {
#pragma unroll
    for (int l = 0; l < NL; ++l)
      for (int c = tid; c < n; c += threads) dst[(size_t)l * m + base + c] = s[l * row + pad(c)];
    return;
  }
  for (int c = tid; c < n; c += threads) {
    int keep = 1;
    if (c + 1 < n || has_next) {
      int32_t diff = 0;
      for (int l = 0; l < nb; ++l) diff |= s[l * row + pad(c)] ^ s[l * row + pad(c + 1)];
      keep = diff != 0;
    }
    out[base + c] = s[(NL - 1) * row + pad(c)];
    out[(size_t)m + base + c] = keep;
    out[2 * (size_t)m + base + c] = s[pad(c)];
  }
}

template <int NL>
__global__ void __launch_bounds__(SORT_THREADS)
    block_sort(const int32_t* __restrict__ src, int m, int nb, int32_t* __restrict__ dst, int32_t* __restrict__ out) {
  constexpr int ROW = padded_row(TILE);
  __shared__ int32_t s[NL * ROW];
  const int tid = threadIdx.x;
  const int n = m < TILE ? m : TILE;  // a power of two: pairs never leave [0, n)
  const size_t base = (size_t)blockIdx.x << ilog2(TILE);
#pragma unroll
  for (int l = 0; l < NL; ++l)
    for (int c = tid; c < n; c += SORT_THREADS) s[l * ROW + pad(c)] = src[(size_t)l * m + base + c];
  __syncthreads();
  int32_t v[PER_THREAD][NL];
  shared_to_regs<NL>(s, v, tid);
  for (int k = 2; k <= n; k <<= 1) {
    int j = k >> 1;
    if (j >= 32 * PER_THREAD) {
      __syncthreads();
      regs_to_shared<NL>(v, s, tid);
      __syncthreads();
      for (; j >= 32 * PER_THREAD; j >>= 1) {
        exchange_shared<NL>(s, n, k, j, tid);
        __syncthreads();
      }
      shared_to_regs<NL>(s, v, tid);
    }
    for (; j >= PER_THREAD; j >>= 1) exchange_warp<NL>(v, tid, k, j >> LOG_E);
    exchange_in_thread<NL>(v, tid << LOG_E, k);
  }
  __syncthreads();
  regs_to_shared<NL>(v, s, tid);
  __syncthreads();
  write_tile<NL>(s, ROW, n, base, m, nb, false, dst, out, tid, SORT_THREADS);
}

// ---------------------------------------------------------------------------
// merge rounds
// ---------------------------------------------------------------------------

// Merge-path split of diagonal d between sorted runs A and B (run columns
// each, lane stride m): how many A columns are among the first d merged ones,
// A first on ties. The answer is the first a with B[d-1-a] < A[a]. All 32
// lanes of a warp call it; each step probes 32 points at once.
template <int NL>
__device__ int merge_split(const int32_t* A, const int32_t* B, size_t m, int run, int d, int lane) {
  int lo = d > run ? d - run : 0, hi = d < run ? d : run;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + lane * step;
    bool after = true;
    if (p < hi) {
      int32_t a[NL], b[NL];
      load_column<NL>(A + p, m, a);
      load_column<NL>(B + (d - 1 - p), m, b);
      after = lex_cmp<NL>(b, a) < 0;
    }
    const unsigned ballot = __ballot_sync(FULL_WARP, after);
    if (ballot == 0) {
      lo += 31 * step + 1;
    } else {
      const int f = __ffs(ballot) - 1;
      const int pf = lo + f * step;
      if (f == 0) {
        hi = lo;
      } else {
        lo += (f - 1) * step + 1;
        hi = pf < hi ? pf : hi;
      }
    }
  }
  return lo;
}

template <int NL>
__global__ void __launch_bounds__(MERGE_THREADS)
    merge_round(const int32_t* __restrict__ src, int m, int run, int nb, int32_t* __restrict__ dst,
                int32_t* __restrict__ out) {
  constexpr int ROW = padded_row(MERGE_SPAN);
  __shared__ int32_t s[NL * ROW];
  __shared__ int split[2];
  __shared__ int has_next;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t first = (size_t)blockIdx.x << ilog2(MERGE_SPAN);
  const size_t pair = first & ~((size_t)2 * run - 1);
  const int d0 = (int)(first - pair);
  const int32_t* A = src + pair;
  const int32_t* B = A + run;
  if (warp < 2) {
    const int a = merge_split<NL>(A, B, m, run, d0 + warp * MERGE_SPAN, lane);
    if (lane == 0) split[warp] = a;
  }
  __syncthreads();
  const int a0 = split[0], a1 = split[1];
  const int b0 = d0 - a0, b1 = d0 + MERGE_SPAN - a1;
  const int na = a1 - a0, nbw = b1 - b0;  // na + nbw == MERGE_SPAN
#pragma unroll
  for (int l = 0; l < NL; ++l)
    for (int c = tid; c < MERGE_SPAN; c += MERGE_THREADS)
      cp_async4(s + l * ROW + pad(c), (c < na ? A + a0 + c : B + b0 + (c - na)) + (size_t)l * m);
  if (out != nullptr && tid == 0) {  // the column after this block, for keep_last
    const bool a_left = a1 < run, b_left = b1 < run;
    bool take_a = a_left;
    if (a_left && b_left) {
      int32_t a[NL], b[NL];
      load_column<NL>(A + a1, m, a);
      load_column<NL>(B + b1, m, b);
      take_a = lex_cmp<NL>(b, a) >= 0;
    }
    if (a_left || b_left) {
      const int32_t* g = take_a ? A + a1 : B + b1;
#pragma unroll
      for (int l = 0; l < NL; ++l) s[l * ROW + pad(MERGE_SPAN)] = g[(size_t)l * m];
    }
    has_next = a_left || b_left;
  }
  cp_async_wait_all();
  __syncthreads();

  // this thread's sub-span [diag, diag + MERGE_ITEMS) of the block's output;
  // window A is shared columns [0, na), window B [na, MERGE_SPAN)
  const int diag = tid * MERGE_ITEMS;
  int lo = diag > nbw ? diag - nbw : 0, hi = diag < na ? diag : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    int32_t a[NL], b[NL];
    load_shared<NL>(s, ROW, mid, a);
    load_shared<NL>(s, ROW, na + diag - 1 - mid, b);
    if (lex_cmp<NL>(b, a) < 0) hi = mid;
    else lo = mid + 1;
  }
  int ai = lo, bi = diag - lo;
  int32_t r[MERGE_ITEMS][NL];
#pragma unroll
  for (int p = 0; p < MERGE_ITEMS; ++p) {
    bool take_a = bi >= nbw;
    if (ai < na && bi < nbw) {
      int32_t a[NL], b[NL];
      load_shared<NL>(s, ROW, ai, a);
      load_shared<NL>(s, ROW, na + bi, b);
      take_a = lex_cmp<NL>(b, a) >= 0;
    }
    load_shared<NL>(s, ROW, take_a ? ai : na + bi, r[p]);
    ai += take_a;
    bi += !take_a;
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < MERGE_ITEMS; ++p)
#pragma unroll
    for (int l = 0; l < NL; ++l) s[l * ROW + pad(diag + p)] = r[p][l];
  __syncthreads();
  write_tile<NL>(s, ROW, MERGE_SPAN, first, m, nb, out != nullptr && has_next, dst, out, tid, MERGE_THREADS);
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

template <int NL>
cudaError_t launch_sort(const int32_t* arr, int32_t* out, int32_t* scratch, int m, int nb, cudaStream_t stream) {
  if (m <= TILE) {
    block_sort<NL><<<1, SORT_THREADS, 0, stream>>>(arr, m, nb, nullptr, out);
    return cudaGetLastError();
  }
  int32_t* buf[2] = {scratch, scratch + (size_t)NL * m};
  block_sort<NL><<<m >> ilog2(TILE), SORT_THREADS, 0, stream>>>(arr, m, nb, buf[0], nullptr);
  cudaError_t e = cudaGetLastError();
  int cur = 0;
  for (int run = TILE; run < m && e == cudaSuccess; run <<= 1) {
    const bool last = 2 * run == m;
    merge_round<NL><<<m >> ilog2(MERGE_SPAN), MERGE_THREADS, 0, stream>>>(
        buf[cur], m, run, nb, last ? nullptr : buf[cur ^ 1], last ? out : nullptr);
    e = cudaGetLastError();
    cur ^= 1;
  }
  return e;
}

}  // namespace

// arr (nl, m) read; out (3, m) written; scratch min(rounds, 2) * nl * m int32
// where rounds = log2(m / TILE) for m > TILE, else unused. Returns the first
// CUDA error of the launches, or 0.
extern "C" int paimon_sort_segments(const void* arr_ptr, void* out_ptr, void* scratch_ptr, int m, int nl, int nb,
                                    void* stream_ptr) {
  if (m < 2 || m > (1 << 18) || (m & (m - 1)) != 0 || nl < 2 || nl > 8 || nb < 1 || nb >= nl)
    return (int)cudaErrorInvalidValue;
  const int32_t* arr = static_cast<const int32_t*>(arr_ptr);
  int32_t* out = static_cast<int32_t*>(out_ptr);
  int32_t* scratch = static_cast<int32_t*>(scratch_ptr);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (nl) {
    case 2: return (int)launch_sort<2>(arr, out, scratch, m, nb, stream);
    case 3: return (int)launch_sort<3>(arr, out, scratch, m, nb, stream);
    case 4: return (int)launch_sort<4>(arr, out, scratch, m, nb, stream);
    case 5: return (int)launch_sort<5>(arr, out, scratch, m, nb, stream);
    case 6: return (int)launch_sort<6>(arr, out, scratch, m, nb, stream);
    case 7: return (int)launch_sort<7>(arr, out, scratch, m, nb, stream);
    default: return (int)launch_sort<8>(arr, out, scratch, m, nb, stream);
  }
}
