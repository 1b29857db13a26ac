// Positional Threefry-2x32 for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (advancedps_tpu_torch/ops/threefry.py).
//
// No Pallas kernel stands behind these.  In the JAX package the cipher,
// advancedps_tpu/rng.py:91 threefry2x32, is plain jnp uint32 arithmetic, and
// XLA fuses it, the unit conversion and Box-Muller into the step's kernel
// (rng.py:75-77; "the cipher is not the bottleneck; fusion is", rng.py:175).
// Eager PyTorch has no such fusion and, lacking uint32 arithmetic, ran the
// cipher as some 190 int64 elementwise launches a draw.  Each kernel here is
// that fusion: one thread per output element computes its own 20-round block
// in uint32 registers and writes the finished value.
//
//   threefry2x32  both cipher words of (k0, k1) at counter (c0, c1), written
//                 as int64 values in [0, 2^32): rng.threefry2x32 on tensors,
//                 fold_in_ids (stacked [..., 2]) and random.py's _blocks.
//   pos_uniform   rng.pos_uniform (id g takes word g & 1 of the block at
//                 counter (draw, g >> 1)) or, as a pair, pos_uniform_pair
//                 (both words of the block at (draw, g)); bits >> 8 times 2^-24.
//   pos_normal    rng.pos_normal (Box-Muller on the block of g >> 1, z0 or z1
//                 by the parity of g) or, as a pair, pos_normal_pair.
//   pos_normals   rng.pos_normals: [n, d], columns 2p and 2p + 1 the two
//                 Box-Muller outputs of the block at (draw0 + p, g).
//
// Operands.  Every key word, counter and id is either a host scalar or an
// int64 (ids: int32 or int64) tensor that broadcasts against the output.  The
// wrapper collapses the output's dimensions (dropping those of size 1, merging
// neighbours that every operand walks contiguously) and passes each tensor
// operand's strides in elements, 0 along a broadcast dimension; a thread
// unravels its flat index once.  One chain's key (host words) against
// contiguous ids is one dimension and no division; C chains' keys, a [C]
// column against [N] ids, are two dimensions and one 32-bit division a thread
// (64-bit past 2^32 elements).  A tensor operand is read as its low 32 bits,
// which is rng._as_counter's mask, for ids at or past 2^32 and negative ids
// too.
//
// Bound.  One block is 79 integer operations (two xors for the key schedule,
// two adds, 20 rounds of add, rotate and xor, five injections of three adds).
// For pos_normal at N = 1M that is 79M operations over 132 SMs x 64 int32
// lanes at 1.98 GHz, ~4.7 us, against ~3.6 us to read 8 MB of int64 ids and
// write 4 MB of float32 at 3.35 TB/s: operations bound it, as chip_smoke.py
// phase 3 counts it.  The design does nothing more for that than keep every
// word in registers: one launch, no intermediate in device memory.
//
// Numerics.  The cipher and the uniforms are exact, so bitwise the plain
// versions.  Box-Muller is the plain version's operations in its order and
// precision, sqrtf(-2 * log1pf(-u1)) and fl32(2 pi) * u2, then cosf or sinf,
// the functions torch's CUDA elementwise kernels call; built without
// --use_fast_math (ops/_build.py), so each is the full-precision library
// function.  chip_smoke.py prints the largest ulp gap to the plain version on
// the card.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Dimensions an operand's strides may keep after the wrapper collapses them
// (ops.threefry.MAX_DIMS).
constexpr int kMaxDims = 6;
constexpr uint32_t kParity = 0x1BD11BDAu;
// fl32(2 pi), as torch multiplies a float32 tensor by the Python float 2 pi.
constexpr float kTwoPi = 6.283185307179586f;

// The output's collapsed shape and, for each operand, its strides (elements),
// its pointer (null: the scalar `value`).
template <int NOps>
struct Geom {
  int ndim;
  int64_t size[kMaxDims];
  int64_t stride[NOps][kMaxDims];
  const void* ptr[NOps];
  uint32_t value[NOps];
};

// Each operand's element offset for flat output index i (row-major).
template <typename Idx, int NOps>
__device__ __forceinline__ void offsets(const Geom<NOps>& g, Idx i, int64_t (&off)[NOps]) {
#pragma unroll
  for (int k = 0; k < NOps; ++k) off[k] = 0;
#pragma unroll
  for (int d = kMaxDims - 1; d > 0; --d) {
    if (d < g.ndim) {
      const Idx size = (Idx)g.size[d];
      const Idx q = i / size;
      const int64_t c = (int64_t)(i - q * size);
      i = q;
#pragma unroll
      for (int k = 0; k < NOps; ++k) off[k] += c * g.stride[k][d];
    }
  }
#pragma unroll
  for (int k = 0; k < NOps; ++k) off[k] += (int64_t)i * g.stride[k][0];
}

// Operand k's low 32 bits: an int64 tensor's element or the host scalar.
template <int NOps>
__device__ __forceinline__ uint32_t word(const Geom<NOps>& g, int k, int64_t off) {
  return g.ptr[k] ? (uint32_t)static_cast<const int64_t*>(g.ptr[k])[off] : g.value[k];
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

__device__ __forceinline__ void mix4(uint32_t& x0, uint32_t& x1, int r0, int r1, int r2, int r3) {
  x0 += x1; x1 = rotl(x1, r0) ^ x0;
  x0 += x1; x1 = rotl(x1, r1) ^ x0;
  x0 += x1; x1 = rotl(x1, r2) ^ x0;
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
}

// Threefry-2x32, 20 rounds: five groups of four, each followed by a key
// injection from the schedule (k1, k0 ^ k1 ^ parity, k0) and the group's
// number, as rng.threefry2x32 (Random123's and jax.random's cipher).
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

// uint32 -> float32 in [0, 1): (bits >> 8) * 2^-24, both steps exact.
__device__ __forceinline__ float unit(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

// Box-Muller's radius and angle of one block, in the plain version's order.
__device__ __forceinline__ void polar(uint2 b, float& r, float& theta) {
  const float u1 = unit(b.x), u2 = unit(b.y);
  r = sqrtf(-2.0f * log1pf(-u1));  // 1 - u1 in (0, 1]: the log's argument is never 0
  theta = kTwoPi * u2;
}

template <typename Idx>
__device__ __forceinline__ bool thread_index(Idx n, Idx& i) {
  const int64_t flat = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  i = (Idx)flat;
  return flat < (int64_t)n;
}

// out int64: stacked, [n, 2] (the words of element i side by side); else
// [2, n] (word 0 of every element, then word 1).
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
    threefry_kernel(Geom<4> g, Idx n, int stacked, int64_t* __restrict__ out) {
  Idx i;
  if (!thread_index(n, i)) return;
  int64_t off[4];
  offsets(g, i, off);
  const uint2 b = threefry20(word(g, 0, off[0]), word(g, 1, off[1]), word(g, 2, off[2]),
                             word(g, 3, off[3]));
  if (stacked) {
    reinterpret_cast<longlong2*>(out)[i] = make_longlong2((int64_t)b.x, (int64_t)b.y);
  } else {
    out[i] = (int64_t)b.x;
    out[(int64_t)n + (int64_t)i] = (int64_t)b.y;
  }
}

// Operands 0 and 1 are the key words, 2 the ids (IdT).  pair: out float32
// [2, n], both units (or normals) of the block at counter (draw, id); else
// [n], the paired layout's one value of the block at (draw, id >> 1).
template <bool kNormal, typename Idx, typename IdT>
__global__ void __launch_bounds__(kThreads)
    positional_kernel(Geom<3> g, Idx n, uint32_t draw, int pair, float* __restrict__ out) {
  Idx i;
  if (!thread_index(n, i)) return;
  int64_t off[3];
  offsets(g, i, off);
  const int64_t id = (int64_t)static_cast<const IdT*>(g.ptr[2])[off[2]];
  const uint32_t k0 = word(g, 0, off[0]), k1 = word(g, 1, off[1]);
  if (pair) {
    const uint2 b = threefry20(k0, k1, draw, (uint32_t)id);
    float v0, v1;
    if (kNormal) {
      float r, theta;
      polar(b, r, theta);
      v0 = r * cosf(theta);
      v1 = r * sinf(theta);
    } else {
      v0 = unit(b.x);
      v1 = unit(b.y);
    }
    out[i] = v0;
    out[(int64_t)n + (int64_t)i] = v1;
    return;
  }
  const uint2 b = threefry20(k0, k1, draw, (uint32_t)(id >> 1));
  const bool odd = (id & 1) != 0;
  if (kNormal) {
    float r, theta;
    polar(b, r, theta);
    out[i] = odd ? r * sinf(theta) : r * cosf(theta);
  } else {
    out[i] = unit(odd ? b.y : b.x);
  }
}

// out float32 [n, d]; blockIdx.y is the column pair p: the block at counter
// (draw0 + p, id) gives columns 2p and, if d > 2p + 1, 2p + 1.
template <typename Idx, typename IdT>
__global__ void __launch_bounds__(kThreads)
    normals_kernel(Geom<3> g, Idx n, int64_t d, uint32_t draw0, float* __restrict__ out) {
  Idx i;
  if (!thread_index(n, i)) return;
  int64_t off[3];
  offsets(g, i, off);
  const int64_t id = (int64_t)static_cast<const IdT*>(g.ptr[2])[off[2]];
  const int64_t col = 2 * (int64_t)blockIdx.y;
  const uint2 b =
      threefry20(word(g, 0, off[0]), word(g, 1, off[1]), draw0 + blockIdx.y, (uint32_t)id);
  float r, theta;
  polar(b, r, theta);
  float* row = out + (int64_t)i * d;
  row[col] = r * cosf(theta);
  if (col + 1 < d) row[col + 1] = r * sinf(theta);
}

// Fill g from the wrapper's flat geometry: [ndim, size[ndim], then for each
// operand its strides[ndim]].
template <int NOps>
bool make_geom(const int64_t* geom, const void* const (&ptr)[NOps],
               const uint32_t (&value)[NOps], Geom<NOps>& g) {
  if (geom == nullptr || geom[0] < 1 || geom[0] > kMaxDims) return false;
  g = Geom<NOps>{};
  g.ndim = (int)geom[0];
  for (int d = 0; d < g.ndim; ++d) {
    g.size[d] = geom[1 + d];
    if (g.size[d] < 1) return false;
    for (int k = 0; k < NOps; ++k) g.stride[k][d] = geom[1 + g.ndim + k * g.ndim + d];
  }
  for (int k = 0; k < NOps; ++k) {
    g.ptr[k] = ptr[k];
    g.value[k] = value[k];
  }
  return true;
}

bool grid_of(int64_t n, unsigned& blocks) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  if (n < 1 || b >= (int64_t)1 << 31) return false;
  blocks = (unsigned)b;
  return true;
}

constexpr int64_t kNarrow = (int64_t)1 << 32;  // below: 32-bit index arithmetic

template <bool kNormal, typename IdT>
int launch_positional(int64_t n, const Geom<3>& g, uint32_t draw, int pair, float* out,
                      cudaStream_t s) {
  unsigned blocks;
  if (!grid_of(n, blocks)) return (int)cudaErrorInvalidValue;
  if (n < kNarrow) {
    positional_kernel<kNormal, uint32_t, IdT>
        <<<blocks, kThreads, 0, s>>>(g, (uint32_t)n, draw, pair, out);
  } else {
    positional_kernel<kNormal, uint64_t, IdT>
        <<<blocks, kThreads, 0, s>>>(g, (uint64_t)n, draw, pair, out);
  }
  return (int)cudaGetLastError();
}

template <bool kNormal>
int positional(int64_t n, const int64_t* geom, const void* k0, uint32_t v0, const void* k1,
               uint32_t v1, const void* ids, int ids64, uint32_t draw, int pair, float* out,
               void* stream) {
  Geom<3> g;
  const void* const ptr[3] = {k0, k1, ids};
  const uint32_t value[3] = {v0, v1, 0u};
  if (ids == nullptr || out == nullptr || !make_geom(geom, ptr, value, g)) {
    return (int)cudaErrorInvalidValue;
  }
  return ids64 ? launch_positional<kNormal, int64_t>(n, g, draw, pair, out, (cudaStream_t)stream)
               : launch_positional<kNormal, int32_t>(n, g, draw, pair, out, (cudaStream_t)stream);
}

template <typename IdT>
int launch_normals(int64_t n, const Geom<3>& g, int64_t d, uint32_t draw0, float* out,
                   cudaStream_t s) {
  unsigned blocks;
  if (!grid_of(n, blocks) || d < 1 || (d + 1) / 2 > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks, (unsigned)((d + 1) / 2));
  if (n < kNarrow) {
    normals_kernel<uint32_t, IdT><<<grid, kThreads, 0, s>>>(g, (uint32_t)n, d, draw0, out);
  } else {
    normals_kernel<uint64_t, IdT><<<grid, kThreads, 0, s>>>(g, (uint64_t)n, d, draw0, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dimensions the geometry may hold (ops.threefry.MAX_DIMS).
int aps_threefry_max_dims() { return kMaxDims; }

// n output elements (>= 1) of the collapsed shape in geom (operands k0, k1,
// c0, c1); an operand whose pointer is null is its value.  out int64: [n, 2]
// if stacked, else [2, n].
int aps_threefry2x32(int64_t n, const int64_t* geom, const void* k0, uint32_t v0, const void* k1,
                     uint32_t v1, const void* c0, uint32_t vc0, const void* c1, uint32_t vc1,
                     int stacked, int64_t* out, void* stream) {
  Geom<4> g;
  const void* const ptr[4] = {k0, k1, c0, c1};
  const uint32_t value[4] = {v0, v1, vc0, vc1};
  unsigned blocks;
  if (out == nullptr || !grid_of(n, blocks) || !make_geom(geom, ptr, value, g)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (n < kNarrow) {
    threefry_kernel<uint32_t><<<blocks, kThreads, 0, s>>>(g, (uint32_t)n, stacked, out);
  } else {
    threefry_kernel<uint64_t><<<blocks, kThreads, 0, s>>>(g, (uint64_t)n, stacked, out);
  }
  return (int)cudaGetLastError();
}

// Operands k0, k1 and the ids (int64 if ids64, else int32; never null).
// out float32: [2, n] if pair, else [n].
int aps_pos_uniform(int64_t n, const int64_t* geom, const void* k0, uint32_t v0, const void* k1,
                    uint32_t v1, const void* ids, int ids64, uint32_t draw, int pair, float* out,
                    void* stream) {
  return positional<false>(n, geom, k0, v0, k1, v1, ids, ids64, draw, pair, out, stream);
}

// As aps_pos_uniform, the values N(0, 1) by Box-Muller.
int aps_pos_normal(int64_t n, const int64_t* geom, const void* k0, uint32_t v0, const void* k1,
                   uint32_t v1, const void* ids, int ids64, uint32_t draw, int pair, float* out,
                   void* stream) {
  return positional<true>(n, geom, k0, v0, k1, v1, ids, ids64, draw, pair, out, stream);
}

// As aps_pos_normal with pair, d columns: out float32 [n, d], 1 <= d and
// ceil(d / 2) <= 65535.
int aps_pos_normals(int64_t n, const int64_t* geom, const void* k0, uint32_t v0, const void* k1,
                    uint32_t v1, const void* ids, int ids64, int64_t d, uint32_t draw0,
                    float* out, void* stream) {
  Geom<3> g;
  const void* const ptr[3] = {k0, k1, ids};
  const uint32_t value[3] = {v0, v1, 0u};
  if (ids == nullptr || out == nullptr || !make_geom(geom, ptr, value, g)) {
    return (int)cudaErrorInvalidValue;
  }
  return ids64 ? launch_normals<int64_t>(n, g, d, draw0, out, (cudaStream_t)stream)
               : launch_normals<int32_t>(n, g, d, draw0, out, (cudaStream_t)stream);
}

}  // extern "C"
