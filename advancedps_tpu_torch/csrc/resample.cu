// Systematic-resampling kernels for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (advancedps_tpu_torch/ops/resample.py).
//
// Three kernels carry the bootstrap-SMC resampling step:
//
//   B1 extents   f_j = clip(ceil(n * (prefix_j * inv_s1) - u), 0, n),
//                prefix = inclusive cumsum of exp(logw - m), output bitwise
//                nondecreasing.  Replaces extents_from_logw
//                (advancedps_tpu/ops/pallas_resample.py, _make_extents_kernel).
//   B2 decode    anc[k] = #{j : f_j <= k} = upper_bound(f, k), with f[M-1]
//                read as `guard`.  Replaces decode_ancestors_bs
//                (pallas_resample.py, _make_decode_bs_kernel).
//   B3 move      out[k, :] = v[anc[k], :] bitwise, 0 where anc[k] == M.
//                Replaces the v6 lookup move _resample_move_cols_v6
//                (pallas_resample.py, _make_lookup_kernel).
//
// What bounds them on the card is memory traffic, not arithmetic.  At
// M = n = 1M: B1 reads logw twice (8 MB) and writes f (4 MB); B2 reads f
// through ~20 binary-search probes per slot, but f (4 MB) stays in the 50 MB
// L2 and neighbouring slots share their probe paths; B3 reads anc and the
// source rows and writes the rows (12 MB at D = 1).  The design keeps every
// access either coalesced (B1, B3 writes) or L2-resident (B2 probes), and
// does no per-row run-length scatter, so a single survivor that owns every
// slot costs the same as uniform weights.
//
// B1 precision.  Near n*cdf = 1e6 one float32 ulp is 0.06, so two float32
// prefix sums that differ by an ulp flip ~6% of the extents.  The prefix is
// therefore accumulated in double (sequential within a thread, a warp-shuffle
// scan across threads, a scan of the tile sums across tiles) and rounded to
// float32 once; the plain version does the same with a float64 cumsum.  Both
// are then the correctly rounded prefix but for double rounding error, and the
// float32 epilogue that follows is the same operations in the same order.
// (The TPU kernel carries a Kahan-compensated float32 sum for the same reason.)
//
// B1 monotonicity.  Blocks run in no order, so the sequential carry of the TPU
// kernel has no counterpart, and neighbouring prefixes can still dip where two
// summation trees meet.  A dip at a stratum boundary would emit a decreasing
// extent, which breaks the exact-copy move.  So the integer extents go through
// an exact max-scan: inside a tile by the same thread/warp structure, across
// tiles by an exclusive max-scan of the tile maxima and a fix-up pass that
// touches only tiles whose first extent lies below that carry.  Integer max is
// exact and associative, so the output is nondecreasing by construction,
// whatever the summation order.
//
// All float32 arithmetic of the extents epilogue uses explicit round-to-nearest
// intrinsics so that nvcc does not contract n*cdf - u into an FMA: the plain
// PyTorch version rounds each operation separately.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // threads per tile block
constexpr int kItems = 8;                  // consecutive elements per thread
constexpr int kTile = kThreads * kItems;   // elements per tile
constexpr int kScanThreads = 1024;         // single-block cross-tile scans
constexpr int kMoveThreads = 256;

struct Add {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct Max {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a > b ? a : b; }
};

// Exclusive scan of one value per thread across the block (blockDim.x a
// multiple of 32, at most 1024).  `smem` holds 32 entries.  Writes the block
// total to *total when it is not null.  Ends with a barrier, so `smem` may be
// reused right after.
template <typename T, typename Op>
__device__ T block_exclusive_scan(T v, T identity, Op op, T* smem, T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  T x = v;  // inclusive scan within the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = op(y, x);
  }
  T excl_in_warp = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 31) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nwarps ? smem[lane] : identity;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      T y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w = op(y, w);
    }
    smem[lane] = w;  // inclusive scan of the warp totals
  }
  __syncthreads();
  const T warp_excl = warp == 0 ? identity : smem[warp - 1];
  const T excl = lane == 0 ? warp_excl : op(warp_excl, excl_in_warp);
  if (total != nullptr && threadIdx.x == 0) *total = smem[nwarps - 1];
  __syncthreads();
  return excl;
}

// ---- B1, pass 1: per-tile sums of exp(logw - m), in double.
__global__ void extents_tile_sums(const float* __restrict__ logw, int64_t len,
                                  const float* __restrict__ mx,
                                  double* __restrict__ tile_sum) {
  __shared__ double smem[32];
  const float m = *mx;
  const int64_t first = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  double acc = 0.0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t j = first + i;
    if (j < len) acc += (double)expf(__fsub_rn(logw[j], m));
  }
  double total;
  block_exclusive_scan(acc, 0.0, Add(), smem, threadIdx.x == 0 ? &total : nullptr);
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = total;
}

// ---- Single-block exclusive scan over the per-tile values (passes 2 and 4).
// Each thread folds a contiguous run of tiles sequentially in Acc, then one
// block scan joins the runs.
template <typename In, typename Acc, typename Op>
__global__ void tiles_exclusive_scan(const In* __restrict__ in, In* __restrict__ out,
                                     int ntiles, Acc identity, Op op) {
  __shared__ Acc smem[32];
  const int per = (ntiles + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, ntiles);
  Acc local = identity;
  for (int i = lo; i < hi; ++i) local = op(local, (Acc)in[i]);
  Acc run = block_exclusive_scan(local, identity, op, smem, (Acc*)nullptr);
  for (int i = lo; i < hi; ++i) {
    out[i] = (In)run;
    run = op(run, (Acc)in[i]);
  }
}

// ---- B1, pass 3: per-tile prefix, the extents epilogue, and an in-tile
// integer max-scan.  Writes the tile's largest extent to tile_max.
__global__ void extents_tiles(const float* __restrict__ logw, int64_t len,
                              const float* __restrict__ mx, const float* __restrict__ s1,
                              float u, int n, const double* __restrict__ tile_base,
                              int* __restrict__ f, int* __restrict__ tile_max) {
  __shared__ double dsmem[32];
  __shared__ int ismem[32];
  const float m = *mx;
  const float inv_s1 = __frcp_rn(*s1);
  const float nf = (float)n;
  const int64_t first = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;

  double p[kItems];  // inclusive prefix within this thread's run
  double acc = 0.0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t j = first + i;
    if (j < len) acc += (double)expf(__fsub_rn(logw[j], m));
    p[i] = acc;
  }
  const double base = tile_base[blockIdx.x] +
                      block_exclusive_scan(acc, 0.0, Add(), dsmem, (double*)nullptr);

  int fi[kItems];
  int run = 0;  // extents are >= 0
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const float prefix = __double2float_rn(base + p[i]);  // rounded once
    const float cdf = __fmul_rn(prefix, inv_s1);
    float ff = ceilf(__fsub_rn(__fmul_rn(nf, cdf), u));
    ff = fminf(fmaxf(ff, 0.0f), nf);
    if (first + i < len) run = max(run, (int)ff);
    fi[i] = run;
  }
  int tmax;
  const int carry = block_exclusive_scan(run, 0, Max(), ismem,
                                         threadIdx.x == 0 ? &tmax : nullptr);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t j = first + i;
    if (j < len) f[j] = max(fi[i], carry);
  }
  if (threadIdx.x == 0) tile_max[blockIdx.x] = tmax;
}

// ---- B1, pass 5: raise each tile to the largest extent of the tiles before
// it.  A tile is already max-scanned, so its first extent is its smallest:
// when that is not below the carry the tile is left alone.
__global__ void extents_carry(int* __restrict__ f, int64_t len,
                              const int* __restrict__ tile_carry) {
  __shared__ bool below;
  const int carry = tile_carry[blockIdx.x];
  const int64_t first_of_tile = (int64_t)blockIdx.x * kTile;
  // Read the tile's first extent before any thread raises it.
  if (threadIdx.x == 0) below = f[first_of_tile] < carry;
  __syncthreads();
  if (!below) return;
  const int64_t first = first_of_tile + (int64_t)threadIdx.x * kItems;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t j = first + i;
    if (j < len && f[j] < carry) f[j] = carry;
  }
}

// ---- B2: one thread per output slot, binary search for the first extent
// above the slot.  f[m-1] is read as `guard` (never written).
__global__ void decode_ancestors_kernel(const int* __restrict__ f, int64_t m, int guard,
                                        int64_t n_out, int* __restrict__ anc) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_out) return;
  int64_t lo = 0, hi = m;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const int fm = mid == m - 1 ? guard : __ldg(f + mid);
    if ((int64_t)fm > k) hi = mid; else lo = mid + 1;
  }
  anc[k] = (int)lo;
}

// ---- B3: one thread per output element (slot k, column c).  Values move as
// 32-bit words, so the copy is bitwise.  Slots whose ancestor is m (past the
// drawn population) move 0; the clipped ancestor m-1 is written beside.
__global__ void move_rows_kernel(const int* __restrict__ anc, int64_t n_out, int64_t m,
                                 const uint32_t* __restrict__ v, int64_t d,
                                 uint32_t* __restrict__ out, int* __restrict__ anc_clipped) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_out * d) return;
  const int64_t k = e / d;
  const int64_t c = e - k * d;
  const int a = __ldg(anc + k);
  const bool inside = a >= 0 && (int64_t)a < m;
  out[e] = inside ? __ldg(v + (int64_t)a * d + c) : 0u;
  if (c == 0) anc_clipped[k] = (int64_t)a < m ? a : (int)(m - 1);
}

inline unsigned blocks_for(int64_t count, int threads) {
  return (unsigned)((count + threads - 1) / threads);
}

}  // namespace

extern "C" {

int aps_extents_tile_size() { return kTile; }

const char* aps_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// logw float32[len]; mx, s1 float32 scalars on the device; f int32[len].
// dscratch float64[2 * ntiles], iscratch int32[2 * ntiles],
// ntiles = ceil(len / aps_extents_tile_size()).
int aps_extents_from_logw(const float* logw, int64_t len, const float* mx,
                          const float* s1, float u, int n, double* dscratch,
                          int* iscratch, int* f, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = (int)((len + kTile - 1) / kTile);
  double* tile_sum = dscratch;
  double* tile_base = dscratch + ntiles;
  int* tile_max = iscratch;
  int* tile_carry = iscratch + ntiles;
  extents_tile_sums<<<ntiles, kThreads, 0, s>>>(logw, len, mx, tile_sum);
  tiles_exclusive_scan<double, double, Add><<<1, kScanThreads, 0, s>>>(
      tile_sum, tile_base, ntiles, 0.0, Add());
  extents_tiles<<<ntiles, kThreads, 0, s>>>(logw, len, mx, s1, u, n, tile_base, f,
                                            tile_max);
  tiles_exclusive_scan<int, int, Max><<<1, kScanThreads, 0, s>>>(
      tile_max, tile_carry, ntiles, 0, Max());
  extents_carry<<<ntiles, kThreads, 0, s>>>(f, len, tile_carry);
  return (int)cudaGetLastError();
}

// f int32[m] nondecreasing; anc int32[n_out] in [0, m].
int aps_decode_ancestors(const int* f, int64_t m, int guard, int64_t n_out, int* anc,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  decode_ancestors_kernel<<<blocks_for(n_out, kMoveThreads), kMoveThreads, 0, s>>>(
      f, m, guard, n_out, anc);
  return (int)cudaGetLastError();
}

// anc int32[n_out] in [0, m]; v 32-bit words [m, d]; out [n_out, d];
// anc_clipped int32[n_out].
int aps_move_rows(const int* anc, int64_t n_out, int64_t m, const void* v, int64_t d,
                  void* out, int* anc_clipped, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  move_rows_kernel<<<blocks_for(n_out * d, kMoveThreads), kMoveThreads, 0, s>>>(
      anc, n_out, m, (const uint32_t*)v, d, (uint32_t*)out, anc_clipped);
  return (int)cudaGetLastError();
}

}  // extern "C"
