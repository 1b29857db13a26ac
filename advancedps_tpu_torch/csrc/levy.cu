// The Levy dynamics' jump path with its mean and covariance, one thread a
// particle-step, for Hopper (sm_90a); bound through a plain C interface and
// loaded with ctypes (advancedps_tpu_torch/ops/levy.py).
//
// No Pallas kernel stands behind this one.  In the JAX package the path,
// advancedps_tpu/models/levy.py:49 GammaProcess.simulate, and its moments,
// :95 LevyLangevinDynamics._meancov, are jnp arithmetic that XLA fuses under
// vmap over particles.  Eager PyTorch ran them as some 100 launches a step,
// each a pass over an [N, K] tensor in device memory.  Here one thread takes
// one path key and writes that particle's mean [2] and covariance [2, 2]:
//
//   keys     k_arr, k_acc, k_t: the blocks at counters (0, 0), (0, 1), (0, 2)
//            of the path key (random.split(key, 3));
//   arrivals K gaps -log1p(-u) / dt from k_arr's uniforms (block (0, k),
//            (b0 ^ b1) >> 9 times 2^-23), summed by the scan below;
//   sizes    x = 1 / (beta (exp(t / C) - 1));
//   thinning kept where k_acc's uniform < (1 + beta x) exp(-beta x) and
//            x >= tol;
//   times    tau = max(lo, f (hi - lo) + lo) from k_t's uniforms, the
//            product-sum in double and rounded once (random.uniform), with
//            lo = (step - 1) dt and hi = step dt in float32;
//   moments  e = exp(theta (hi - tau)), f = [(e - 1) / theta, e];
//            mu = sum_k mu_w f x, cov = (sum_k (f x) f^T) sigma_w^2 + jitter I,
//            the terms of masked candidates zeros (selected, never multiplied:
//            a first gap of 0 makes an infinite, rejected jump).
//
// The gaps and the arrivals stay in shared memory, a column a thread (64
// floats a thread, bank-conflict free); everything else in registers.  A
// thread reads one key pair and writes 24 bytes.
//
// Bound.  The cipher: 3 + 3K Threefry blocks a particle-step (195 at K = 64),
// 79 integer operations each, 15.4k a particle-step; at N = 2M that is 32G
// operations, ~1.9 ms at the card's 16.7 Top/s int32.  The float work (three
// expf, one log1pf, three IEEE divisions and ~20 more operations a candidate)
// issues beside it.  Bytes are 40 a particle-step: not the bound.
//
// Numerics: bitwise the plain chain (LevyLangevinDynamics._meancov_plain) on
// the card, as PyTorch's CUDA kernels compute it:
//
//   * each element-wise operation rounded on its own, as one PyTorch kernel
//     rounds it: __fmul_rn / __fadd_rn / __fdiv_rn, so that nvcc's default
//     -fmad=true contracts nothing; expf and log1pf are the library's full
//     precision functions that PyTorch's kernels call;
//   * the arrivals' cumsum in the order of PyTorch's scan of the rows' last
//     dimension (ATen/native/cuda/ScanUtils.cuh).  Over R > 1 rows it is
//     tensor_kernel_scan_innermost_dim: chunks of `chunk` = 2 << log_x
//     columns (get_log_num_threads_x_inner_scan, in uint32 arithmetic; the
//     wrapper computes it from R), the running total added to each chunk's
//     first element, then a Sklansky tree over the chunk.  A chunk of 64 or
//     more is one tree over the K <= 64 columns (its padding never feeds
//     them), 32 two trees.  One row (R = 1) goes to CUB's
//     DeviceScan::InclusiveScan instead: a blocked scan of kCubItems
//     consecutive items a thread, each thread's items summed in order, a
//     warp's Kogge-Stone scan of those sums, each thread's items scanned in
//     order from its prefix;
//   * the covariance's sums as cuBLAS's FFMA gemm takes the batched einsum:
//     one fused multiply-add a candidate, k = 0 first, from +0;
//   * the mean's sums as PyTorch's reduction over a middle dimension takes
//     them: four accumulators, candidate k into accumulator k % 4, then
//     ((a0 + a1) + a2) + a3.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// Candidates a path holds (ops.levy.MAX_JUMPS): a column of shared memory a
// thread.
constexpr int kMaxJumps = 64;
// Items a thread of CUB's DeviceScan::InclusiveScan takes, as PyTorch's build
// runs it for the cumsum of one row of float32 (found on the card: the one count
// whose order matches); every item of a path then lies in its first warp.
constexpr int kCubItems = 15;
static_assert(kMaxJumps <= 32 * kCubItems, "a path's scan spans one warp of CUB's");
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

__device__ __forceinline__ void mix4(uint32_t& x0, uint32_t& x1, int r0, int r1, int r2, int r3) {
  x0 += x1; x1 = rotl(x1, r0) ^ x0;
  x0 += x1; x1 = rotl(x1, r1) ^ x0;
  x0 += x1; x1 = rotl(x1, r2) ^ x0;
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
}

// Threefry-2x32, 20 rounds (rng.threefry2x32; csrc/threefry.cu's rounds).
__device__ __forceinline__ uint2 threefry20(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1) {
  const uint32_t ks0 = k0, ks1 = k1, ks2 = k0 ^ k1 ^ kParity;
  uint32_t x0 = c0 + ks0, x1 = c1 + ks1;
  mix4(x0, x1, 13, 15, 26, 6);  x0 += ks1; x1 += ks2 + 1u;
  mix4(x0, x1, 17, 29, 16, 24); x0 += ks2; x1 += ks0 + 2u;
  mix4(x0, x1, 13, 15, 26, 6);  x0 += ks0; x1 += ks1 + 3u;
  mix4(x0, x1, 17, 29, 16, 24); x0 += ks1; x1 += ks2 + 4u;
  mix4(x0, x1, 13, 15, 26, 6);  x0 += ks2; x1 += ks0 + 5u;
  return make_uint2(x0, x1);
}

// random.uniform on [0, 1) of the block at counter (0, k): the top 23 bits
// of b0 ^ b1 times 2^-23, both steps exact.
__device__ __forceinline__ float uniform(uint2 key, uint32_t k) {
  const uint2 b = threefry20(key.x, key.y, 0u, k);
  return (float)((b.x ^ b.y) >> 9) * 1.1920928955078125e-7f;
}

// One Sklansky tree over v[Base, Base + W): at the level of span s every
// element whose index has bit s set takes in the last element of the lower
// half of its 2s-block (whose index has that bit clear, so the level's
// sources are never its targets).
template <int Base, int W>
__device__ __forceinline__ void sklansky(float (&v)[kMaxJumps]) {
#pragma unroll
  for (int s = 1; s < W; s <<= 1) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j & s) v[Base + j] = __fadd_rn(v[Base + j], v[Base + (j & ~(2 * s - 1)) + s - 1]);
    }
  }
}

// CUB's blocked scan of one row (see the header), on the column col[k * kThreads]:
// thread t of the scan takes items [t * kCubItems, (t + 1) * kCubItems), all in
// its first warp.
__device__ void cub_scan(float* col, int jumps) {
  const int threads = (jumps + kCubItems - 1) / kCubItems;
  float scan[kMaxJumps / kCubItems + 1];  // each thread's sum of its items, then their scan
  for (int t = 0; t < threads; ++t) {
    const int end = min(jumps, (t + 1) * kCubItems);
    float s = col[t * kCubItems * kThreads];
    for (int k = t * kCubItems + 1; k < end; ++k) s = __fadd_rn(s, col[k * kThreads]);
    scan[t] = s;
  }
  // Kogge-Stone; a level reads the values of the level before.
  for (int d = 1; d < threads; d <<= 1) {
    for (int t = threads - 1; t >= d; --t) scan[t] = __fadd_rn(scan[t - d], scan[t]);
  }
  for (int t = 0; t < threads; ++t) {
    const int begin = t * kCubItems, end = min(jumps, begin + kCubItems);
    float acc = col[begin * kThreads];
    if (t > 0) acc = __fadd_rn(scan[t - 1], acc);
    col[begin * kThreads] = acc;
    for (int k = begin + 1; k < end; ++k) {
      acc = __fadd_rn(acc, col[k * kThreads]);
      col[k * kThreads] = acc;
    }
  }
}

// The arrivals' cumsum over one thread's column (see the header).
__device__ __forceinline__ void arrivals(float* col, int jumps, int chunk) {
  if (chunk == 0) {
    cub_scan(col, jumps);
    return;
  }
  float v[kMaxJumps];
#pragma unroll
  for (int k = 0; k < kMaxJumps; ++k) v[k] = col[k * kThreads];  // 0 past the jumps
  if (chunk < jumps) {  // chunks of 32 columns
    sklansky<0, 32>(v);
    v[32] = __fadd_rn(v[32], v[31]);
    sklansky<32, 32>(v);
  } else {
    sklansky<0, kMaxJumps>(v);
  }
#pragma unroll
  for (int k = 0; k < kMaxJumps; ++k) col[k * kThreads] = v[k];
}

struct Params {
  const float* dt;
  const float* theta;
  const float* c;
  const float* beta;
  const float* mu_w;
  const float* sigma_w;
};

__global__ void __launch_bounds__(kThreads)
    levy_meancov_kernel(const int64_t* __restrict__ keys, int64_t rows, int64_t row_stride,
                        int64_t word_stride, Params p, int64_t step, int jumps, float tol,
                        float jitter, int chunk, float2* __restrict__ mu,
                        float4* __restrict__ cov) {
  __shared__ float ts[kMaxJumps * kThreads];
  const int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  float* col = ts + threadIdx.x;
  const uint32_t kp0 = (uint32_t)keys[r * row_stride];
  const uint32_t kp1 = (uint32_t)keys[r * row_stride + word_stride];
  const uint2 k_arr = threefry20(kp0, kp1, 0u, 0u);
  const uint2 k_acc = threefry20(kp0, kp1, 0u, 1u);
  const uint2 k_t = threefry20(kp0, kp1, 0u, 2u);
  const float dt = *p.dt, theta = *p.theta, c = *p.c, beta = *p.beta, mu_w = *p.mu_w,
              sigma_w = *p.sigma_w;

#pragma unroll 4
  for (int k = 0; k < kMaxJumps; ++k) {
    float gap = 0.0f;
    if (k < jumps) gap = __fdiv_rn(-log1pf(-uniform(k_arr, (uint32_t)k)), dt);
    col[k * kThreads] = gap;
  }
  arrivals(col, jumps, chunk);

  const float lo = __fmul_rn((float)(step - 1), dt), hi = __fmul_rn((float)step, dt);
  const double width = (double)__fsub_rn(hi, lo);
  float m0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, m1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float c00 = 0.0f, c01 = 0.0f, c10 = 0.0f, c11 = 0.0f;
  for (int k4 = 0; k4 < jumps; k4 += 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k4 + i;
      if (k < jumps) {
        const float arrival = col[k * kThreads];
        const float den = __fmul_rn(beta, __fsub_rn(expf(__fdiv_rn(arrival, c)), 1.0f));
        const float x = __fdiv_rn(1.0f, den);  // the jump's size
        const float prob =
            __fmul_rn(__fadd_rn(__fmul_rn(beta, x), 1.0f), expf(__fmul_rn(-beta, x)));
        const bool keep = uniform(k_acc, (uint32_t)k) < prob && x >= tol;
        const double u = (double)uniform(k_t, (uint32_t)k);
        const float tau = fmaxf(lo, __double2float_rn(__dadd_rn(__dmul_rn(u, width), (double)lo)));
        const float e = expf(__fmul_rn(theta, __fsub_rn(hi, tau)));
        const float f0 = __fdiv_rn(__fsub_rn(e, 1.0f), theta);
        const float w0 = keep ? __fmul_rn(f0, x) : 0.0f;
        const float w1 = keep ? __fmul_rn(e, x) : 0.0f;
        m0[i] = __fadd_rn(m0[i], keep ? __fmul_rn(__fmul_rn(f0, mu_w), x) : 0.0f);
        m1[i] = __fadd_rn(m1[i], keep ? __fmul_rn(__fmul_rn(e, mu_w), x) : 0.0f);
        c00 = __fmaf_rn(w0, f0, c00);
        c01 = __fmaf_rn(w0, e, c01);
        c10 = __fmaf_rn(w1, f0, c10);
        c11 = __fmaf_rn(w1, e, c11);
      }
    }
  }
  const float s2 = __fmul_rn(sigma_w, sigma_w);
  mu[r] = make_float2(__fadd_rn(__fadd_rn(__fadd_rn(m0[0], m0[1]), m0[2]), m0[3]),
                      __fadd_rn(__fadd_rn(__fadd_rn(m1[0], m1[1]), m1[2]), m1[3]));
  cov[r] = make_float4(__fadd_rn(__fmul_rn(c00, s2), jitter), __fadd_rn(__fmul_rn(c01, s2), 0.0f),
                       __fadd_rn(__fmul_rn(c10, s2), 0.0f), __fadd_rn(__fmul_rn(c11, s2), jitter));
}

}  // namespace

extern "C" {

// Candidates a path may hold (ops.levy.MAX_JUMPS).
int aps_levy_max_jumps() { return kMaxJumps; }

// rows path keys (int64 words, key r's at keys[r * row_stride] and
// keys[r * row_stride + word_stride]); the model's float32 parameters, each
// one value on the device; out mu float32 [rows, 2], cov float32 [rows, 2, 2].
// chunk: 0 for CUB's scan of one row, else the width of PyTorch's scan
// chunks, a power of two from 32 to 1024.
int aps_levy_meancov(int64_t rows, const int64_t* keys, int64_t row_stride, int64_t word_stride,
                     const float* dt, const float* theta, const float* c, const float* beta,
                     const float* mu_w, const float* sigma_w, int64_t step, int jumps, float tol,
                     float jitter, int chunk, float* mu, float* cov, void* stream) {
  const int64_t blocks = (rows + kThreads - 1) / kThreads;
  const bool pow2 = chunk > 0 && (chunk & (chunk - 1)) == 0;
  if (rows < 1 || blocks >= ((int64_t)1 << 31) || keys == nullptr || mu == nullptr ||
      cov == nullptr || dt == nullptr || theta == nullptr || c == nullptr || beta == nullptr ||
      mu_w == nullptr || sigma_w == nullptr || jumps < 1 || jumps > kMaxJumps ||
      !(chunk == 0 || (pow2 && chunk >= 32 && chunk <= 1024))) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{dt, theta, c, beta, mu_w, sigma_w};
  levy_meancov_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      keys, rows, row_stride, word_stride, p, step, jumps, tol, jitter, chunk,
      reinterpret_cast<float2*>(mu), reinterpret_cast<float4*>(cov));
  return (int)cudaGetLastError();
}

}  // extern "C"
