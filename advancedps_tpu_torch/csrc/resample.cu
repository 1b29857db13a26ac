// Resampling kernels for Hopper (sm_90a), bound through a plain C interface
// and loaded with ctypes (advancedps_tpu_torch/ops/resample.py).
//
// Every kernel replaces one function of advancedps_tpu/ops/pallas_resample.py:
//
//   B1 extents   f_j = clip(ceil(n * (prefix_j * inv_s1) - u), 0, n),
//                prefix = inclusive cumsum of exp(logw - m), output bitwise
//                nondecreasing.  Replaces extents_from_logw
//                (_make_extents_kernel).
//   B2 decode    anc[k] = #{j : f_j <= start + k} = upper_bound(f, start + k)
//                for the output window [start, start + n_out), with f[M-1]
//                read as `guard`: a block per tile of slots counts the run
//                ends of the tile's own owner rows in shared memory.  Replaces decode_ancestors_bs
//                (_make_decode_bs_kernel).
//   B3 move      out[k, :] = v[anc[k], :] bitwise, 0 where anc[k] == M.
//                Replaces the v6 lookup move _resample_move_cols_v6
//                (_make_lookup_kernel).
//   B4 decode+move  B2 and B3 in one pass over an output window.  Replaces
//                the v1 staircase _resample_move_cols (_make_move_kernel).
//                Its form over leaves moves up to eight arrays of rows (the
//                leaves of a tree-shaped particle state) after one decode, as
//                the TPU kernel moves its list of columns.
//   B5 dense decode  B2 by counting instead of searching: each run of equal
//                extents writes its end once, then an integer max-scan.
//                Replaces decode_ancestors (_decode_kernel).
//   B6 prefix    out_j = (sum_{i<=j} e_i) * scale, e = exp(x - m) or x,
//                output bitwise nondecreasing.  Replaces _scaled_prefix
//                (_make_scaled_prefix_kernel) behind scaled_prefix_from_logw
//                and prefix_sum.
//   B7 count     out[j] = #{k : s_k <= t_j} for sorted s: a block per tile
//                of thresholds searches the tile's own run of s in shared
//                memory.  Replaces count_le_sorted_bs (_count_le_bs_kernel).
//   B8 merge     the same counts by a merge path over sorted s and t: equal
//                tiles of the merged order, each block finding its own two
//                splits.  Replaces count_le_sorted (_count_le_kernel).
//
// Every time in these notes is device time at M = n = 1M on an NVIDIA H100
// 80GB HBM3 at a 700 W power limit, read by chip_smoke.py.
//
// What bounds them on the card is memory traffic, not arithmetic, and below a
// few megabytes the latency of one block's chain of dependent steps.  At
// M = n = 1M: B1 and B6 read their input once (4 MB) and write 4 MB in one
// launch (see "B1/B6 single pass"); B2 reads f once, a tile's owner rows at a
// time, and writes anc (see "B2 tile decode"); B3 reads anc and the source
// rows and writes the rows (12 MB at D = 1); B7 and B8 read s and t once each
// into shared memory and write the counts (12 MB; see "B7 tile search" and
// "B8 merge path"); B4 reads each tile's owner extents once, as B2 does, and
// the source rows, and writes the clipped anc and the rows (16 MB at D = 1),
// B3's traffic without B2's unclipped anc written and read in between (see
// "B4 decode, then move"); B5 reads f once, marks the run ends in a scratch,
// and makes one pass that reads the marks, clears them and writes anc (8 MB
// in and out, 8 MB more to and from the scratch; see "B5 counting").
// The design keeps every access either coalesced or L2-resident, and does no
// per-row run-length scatter to device memory, so a single survivor that owns
// every slot costs no more than uniform weights.
//
// B1/B6 precision.  Near n*cdf = 1e6 one float32 ulp is 0.06, so two float32
// prefix sums that differ by an ulp flip ~6% of the extents.  The prefix is
// therefore accumulated in double (sequential within a thread, a warp-shuffle
// scan across threads, a fixed tree over the tile sums across tiles) and
// rounded to float32 once; the plain versions do the same with a float64
// cumsum.  Both are then the correctly rounded prefix but for double rounding
// error, and the float32 epilogue that follows is the same operations in the
// same order.  (The TPU kernels carry a Kahan-compensated float32 sum for the
// same reason.)
//
// B1/B6 monotonicity.  Blocks run in no order, so the sequential carry of the
// TPU kernels has no counterpart, and neighbouring double prefixes can still
// differ by a double ulp the wrong way where two summation trees meet (the end
// of one thread's run against the start of the next).  Where that straddles a
// float32 rounding boundary the output would dip, and B2/B7/B8 and the
// stratified extents all need a nondecreasing input.  So the epilogue's values
// go through an exact max-scan: inside a tile by the same thread/warp
// structure, across tiles by the largest value of the tiles before, which
// every tile takes before it stores.  Max is exact and associative, so the
// output is nondecreasing by construction, whatever the summation order.  (The
// TPU kernels keep a running max for the same reason.)
//
// B1/B6 single pass.  The scan was five launches (tile sums, a one-block scan
// of them, the prefixes and the epilogue, a one-block max-scan of the tile
// maxima, a fix-up pass): the input read twice, exp taken twice, one SM at
// work in two of the five while 131 idled, and every 4-byte store of a thread's
// eight consecutive outputs 32 bytes from its neighbour's.  Now one launch:
// a tile (256 threads, 8 consecutive elements each) is read once with 16-byte
// loads, summed, and its double sum published; its base is the combination of
// the sums of the tiles before it; the epilogue and the in-tile max-scan
// follow; the tile's largest value is published and the largest of the tiles
// before it taken the same way; the outputs leave as 16-byte stores.  The
// base must not depend on timing (double addition is not associative, and a
// sweep must repeat bitwise), so a tile never adds whatever happens to be
// published: it reads the sums of the tiles before it in its group of 32 and
// the totals of the groups before its own (and so on upward, 32 at a level),
// and scans each level in one warp exactly as block_exclusive_scan does, the
// last tile of a group publishing the group's total.  Up to 1024 tiles
// (2,097,152 elements) that is, bit for bit, the tree of the one-block scan it
// replaces; above, a third level takes the place of that scan's sequential
// folds.  Nothing published waits for more than the sums (or maxima) of
// earlier tiles, so no chain of waits runs along the tiles.  A value and the
// epoch of its launch travel as one 16-byte word, so the scratch is never
// reset: the wrapper hands each launch a larger epoch.  The launch is
// cooperative and no larger than what the card holds at once, block b taking
// tiles b, b + grid, ...: a waiting block can only wait for a running one.
// What is left is latency, not bytes: a tile's two look-backs are four
// dependent round trips to the L2 behind the slowest tile's load.
//
// B2 tile decode.  One thread per slot searching all of f is a chain of ~20
// dependent loads, each a round trip to the L2, and neighbouring slots repeat
// each other's first ~10 probes: B7's problem with thresholds that are the
// consecutive integers start + k.  So a block takes kDecodeTile consecutive
// slots; two warps find the counts of its first and last slot by the 32-way
// search (4 rounds at 1M in place of 20); the rows between, the tile's owners,
// are staged into shared memory with 16-byte cp.async copies, the guard put in
// place of row M-1 there.  Then no search at all: each staged row that ends a
// run of equal extents writes the rows counted up to it at the slot of its
// extent (run ends have distinct extents, so no two writes meet), and a block
// max-scan over the tile's slots fills the gaps, B5's counting done in shared
// memory: O(run + tile) with 16-byte reads and stores.  (Searching the staged
// run as B7 does was 1.4 us slower at 1M, 7.3 against 5.9, and 0.2 us faster
// on a window of 250k; tiles of 2048 slots were slower in both forms.)  A run
// longer than the staging buffer (many zero-offspring rows between two owners)
// is searched in global memory between the same two bounds, as B7 does,
// so the count is exact for every nondecreasing f.  A tile owned by one row
// has an empty run and costs only the two searches.
//
// All float32 arithmetic of the epilogues uses explicit round-to-nearest
// intrinsics so that nvcc does not contract n*cdf - u into an FMA: the plain
// PyTorch versions round each operation separately.
//
// B7 tile search.  One thread per threshold searching all of s is a chain of
// ~20 dependent loads, each a round trip to the L2 (s is resident there, 4 MB
// of 50): the kernel is then bound by that latency, ~20M sector requests for
// the 12 MB it needs, and neighbouring thresholds repeat each other's first
// ~10 probes.  So a block takes kCountTile consecutive thresholds, reduces
// them to their smallest and largest (exact for any t; for nondecreasing t
// these are the first and last), and two warps find the counts of those two
// values by a 32-way search each (every lane probes one of 32 evenly spaced
// entries, a ballot narrows the range 32 times: 4 rounds at 1M in place of
// 20).  Every count of the tile lies between these two, so only that run of s
// is staged into shared memory, with 16-byte cp.async copies, and each
// threshold is searched there with 32-bit indices in a branchless loop whose
// length depends on the run only, so a thread's four searches run interleaved.
// A warp's lanes hold neighbouring thresholds: their probes fall on
// neighbouring entries of the run, in different banks (a thread holding four
// consecutive thresholds put its warp's probes four entries apart and lost
// most of the kernel's time to bank conflicts), and thresholds and counts
// move as coalesced 128-byte rows.  A run longer than the staging
// buffer (a tile whose thresholds jump over many s: one particle holding most
// of the weight) is searched in global memory between the same two bounds, as
// B2 does.  Thresholds that are all equal, or all inside one gap of s, have an
// empty or one-entry run and cost less than the uniform case.
//
// B8 merge path.  The merge path (Green, McColl, Bader 2012) cuts the merged
// order of s and t into equal tiles along its diagonals, so every block
// handles exactly kMergeTile merged entries, whatever the skew: one particle
// holding all the weight (every threshold in one tile) costs what uniform
// weights cost.  That is what the TPU's chunk-once staircase was for.  The
// earlier kernel began each block with two serial searches by threads 0 and 1
// (~20 dependent loads each) while the rest waited, staged 2048 entries with
// 4-byte loads, and merged 8 entries per thread serially from shared memory,
// lanes 8 entries apart: bank conflicts on every step and a 4-byte store per
// count.  Now two warps find the block's two splits by the 32-way search along
// the diagonal (a separate partition pass was tried and was slower: a second
// launch costs more than the searches it shares), the block's run of s (at
// most kMergeTile entries) is staged with 16-byte cp.async copies, and its
// thresholds are ranked in that run exactly as B7 ranks them: neighbouring
// lanes on neighbouring thresholds, four interleaved searches a thread,
// coalesced loads of t and stores of the counts.  A tile holds at most
// kMergeTile thresholds and at most kMergeTile entries of s, so the staging
// buffer always suffices and no block does more than a fixed amount of work.
// The tile is 16 KB, so several blocks are resident on an SM and one block's
// copies overlap another's searches; a persistent block with two buffers
// would add nothing at 2M merged entries, where every tile is resident at
// once.
//
// B4 decode, then move.  A block decodes its tile of kDecodeMoveTile slots by
// the very function B2's kernel calls (decode_tile: the two owners by the
// 32-way search, the owner run staged with 16-byte cp.async copies and the
// guard put in place of row M-1, run ends marked at the slot of their extent,
// a block max-scan; a run longer than the stage searched in global memory), so
// a slot's owner is the same instructions in both and B4 is B2 + B3 bit for
// bit.  The counts stay in registers, four consecutive slots a thread.  For
// one column the thread gathers its four rows and stores them and the clipped
// owners as two 16-byte words; nothing goes through shared memory again.  For
// D columns the tile's rows are contiguous in out, so the counts go back into
// the tile's shared array and consecutive threads write consecutive words (16
// bytes each where D is a multiple of four and v is aligned), slot and column
// of a word found with 32-bit arithmetic inside the tile.  The earlier kernel
// found its owners with two serial binary searches by two threads, staged up
// to 8192 rows with 4-byte loads, searched the staged run once per slot and
// divided a 64-bit index for every word; it took 1.7 times as long as B2 + B3 in
// two launches though it moved 8 MB less.  1024 slots a block at 32 registers a
// thread keep all 977 blocks of 1M resident at once (8 an SM), so one block's
// gather hides behind the others' decode chains; at 40 registers (6 an SM) a
// second short wave cost a third more time.  Blocks of 2048 slots were a third
// slower for one column and up to a tenth faster for three or four.  The TPU
// staircase's compare masks, which stood in for the missing per-lane gather,
// are not carried over.
//
// B4 over leaves.  A tree-shaped state (the history buffer beside the state
// of a non-Markov model, a record of variables) is several arrays of rows
// moved by the same ancestors.  One B4 launch a leaf would decode each tile
// once a leaf; the TPU kernel takes a list of columns for that reason.  Here
// the leaves go to the kernel as one by-value table (a pointer in, a pointer
// out and a width each, 24 bytes a leaf, eight leaves: far under the 4 KB
// parameter limit): a block decodes its tile once with decode_tile, puts the
// owners in shared memory once, and moves each leaf's rows by B4's own paths
// (one column from registers, wider rows as consecutive 16-byte or 4-byte
// words).  The table's loop is unrolled so that no entry is indexed at run
// time.  The bytes are those of the leaves, read once and written once; the
// decode's chain is paid once a tile instead of once a leaf.  More leaves than
// eight take more launches, each decoding again.
//
// B5 counting.  anc[k] = #{j : f_j <= k} is, for nondecreasing f, one more
// than the last row whose extent is <= k.  Each run of equal extents ends at
// one row j (j = M-1, or f_j < f_{j+1}); writing j + 1 at f_j (when f_j <
// n_out) leaves a sparse array of marks whose inclusive running max is anc.
// Run ends have distinct extents, so no two threads write one entry and no
// atomics are needed.  Work is O(M + n_out), with no search.  Two launches:
// the scatter (one thread a row; four rows a thread from a 16-byte load were
// a tenth slower, each thread then issuing four scattered stores in turn),
// and one single-pass max-scan on the machinery of B1 and B6: a tile of
// kDenseTile slots loads its marks with 16-byte loads, scans them in
// registers and across the block, publishes its largest mark under the
// launch's epoch, takes the largest of the tiles before it by warp_lookback
// and stores anc with 16-byte stores.  Every mark lies between the two
// launches, so the kernel boundary is the barrier the counting needs.  (One
// cooperative launch with a grid barrier in its place, every block publishing
// the epoch and polling every other's, took 22 us of device time against 12,
// though 10 us less of the host's.)  The marks live in a scratch the wrapper
// keeps per device and stream, zero between calls: the scan clears each word
// it has read, which takes the place of a memset of anc before every call
// (and of the scan reading anc back).  The earlier form was that memset and
// four launches (scatter, a max-scan of each tile in place with 4-byte
// accesses, a one-block scan of the tile maxima, a carry pass).  The scan
// shares B1's and B6's look-back scratch: a launch reads only what was
// published under its own epoch, so launches in turn on one stream never see
// each other's values.  The launch is cooperative and no larger than the card
// holds, for the same reason as B1's.

// The chain axis.  Independent chains run as one batch: C rows of N
// log-weights, extents and particle rows, one launch for all of them.  B1 and
// B6 number their tiles chain-major over all C rows and give every row its own
// part of the look-back scratch, so a tile looks back only at the tiles of its
// own row, in the same tree, and row c is the one-chain launch on that row bit
// for bit: the same tiles, summed in the same order, under the row's own m, s1
// and offset u (read from device arrays, where the one-chain launch takes u as
// an argument).  Tile g waits only for tiles of lower number, so the argument
// that the cooperative launch cannot deadlock is unchanged.  B4 and B4 over
// leaves take the chain as blockIdx.y and offset their extents, rows, outputs
// and owners by the row's stride in 64 bits (C * N * d words pass 2^31 on a
// GP-SSM's [N, 100] history), each block decoding and moving as before.  The
// one-chain entries are the same kernels instantiated without the chain axis,
// where the chain index is the constant 0: the scan and B4 sit at their
// register caps (64 and 32 a thread), and with the chain offsets compiled in,
// one chain's B1 and B6 took 0.0153 ms at 1M against 0.0110 (chip_smoke.py
// phase 7) and B4 0.0073-0.0075 against 0.0067 (profiling/torch_kernels_ab.py,
// in turns with the one-chain kernels; H100 80GB HBM3 at 700 W).
//
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // threads per tile block
constexpr int kItems = 8;                  // consecutive elements per thread
constexpr int kTile = kThreads * kItems;   // elements per tile
constexpr int kMoveThreads = 256;          // B3, and B5's scatter
constexpr int kDecodeThreads = 256;        // B2
constexpr int kDecodeItems = 4;            // output slots per B2 thread
constexpr int kDecodeTile = kDecodeThreads * kDecodeItems;
constexpr int kDecodeStage = 4096;         // owner extents staged per B2 or B4 block (16 KB)
constexpr int kCountThreads = 256;         // B7
constexpr int kCountItems = 4;             // thresholds a thread searches together
constexpr int kCountTile = kCountThreads * kCountItems;
constexpr int kCountStage = 4096;          // entries of s staged per B7 block (16 KB)
constexpr int kMergeThreads = 256;         // B8
constexpr int kMergeTile = 4096;           // merged entries per B8 block (16 KB of s at most)
constexpr int kDecodeMoveTile = kDecodeTile;  // output slots per B4 block: B2's tile
constexpr int kDecodeMoveBlocks = 8;       // B4 blocks an SM: 32 registers a thread
constexpr int kDenseTile = kTile;          // slots per tile of B5's scan

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

// ---- Pieces shared by the scans, B2, B4, B7 and B8.

constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start the block's copy of src[lo, hi) into shared memory at dst (16-byte
// aligned), so that src[lo] lands at dst[r] for the returned r in [0, 3]:
// where src is 16-byte aligned the copy starts at the aligned entry at or
// below lo and moves 16 bytes at a time, with a 4-byte ragged tail; otherwise
// every entry moves on its own.  dst needs room for hi - lo + 3 entries.
// Complete after cp_async_wait_all() and a barrier.
template <typename T>
__device__ int stage_run(T* dst, const T* __restrict__ src, int64_t lo, int64_t hi) {
  static_assert(sizeof(T) == 4, "stage_run moves 4-byte entries");
  const bool vec = aligned16(src);
  const int64_t a0 = vec ? (lo & ~(int64_t)3) : lo;
  const int64_t v_end = vec ? a0 + ((hi - a0) & ~(int64_t)3) : a0;
  for (int64_t k = a0 + 4 * (int64_t)threadIdx.x; k < v_end; k += 4 * (int64_t)blockDim.x) {
    cp_async16(dst + (k - a0), src + k);
  }
  for (int64_t k = v_end + threadIdx.x; k < hi; k += blockDim.x) {
    cp_async4(dst + (k - a0), src + k);
  }
  return (int)(lo - a0);
}

// The first i in [lo, hi) at which pred(i) is false, or hi, for a predicate
// that is true up to some point and false from there on; called by a whole
// warp.  Each round the 32 lanes probe 32 evenly spaced entries and a ballot
// keeps the one gap that holds the answer.
template <typename Pred>
__device__ int64_t warp_partition_point(int64_t lo, int64_t hi, Pred pred) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) >> 5;
    const int64_t p = lo + (int64_t)(lane + 1) * step - 1;
    const int c = __popc(__ballot_sync(kFullWarp, p < hi && pred(p)));
    // Probes 0 .. c-1 hold, probe c (if there is one) does not.
    const int64_t next_hi = lo + (int64_t)(c + 1) * step - 1;
    if (c < 32 && next_hi < hi) hi = next_hi;
    lo = lo + c * step < hi ? lo + c * step : hi;
  }
  return lo;
}

// cnt[i] = #{k < len : r_k <= t[i]} for nondecreasing r, len >= 1, with no
// branch on the data: the trip count depends on len only, so the K searches
// run interleaved and their loads overlap.  (!(r > t) and not r <= t: a NaN
// threshold counts every entry, as searchsorted does.)  r and t are both
// float (B7, B8) or both int (B2).
template <int K, typename T, typename Load>
__device__ __forceinline__ void upper_bound_uniform(Load r, int len, const T (&t)[K],
                                                    int (&cnt)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) cnt[i] = 0;
  while (len > 1) {
    const int half = len >> 1;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      cnt[i] = !(r(cnt[i] + half - 1) > t[i]) ? cnt[i] + half : cnt[i];
    }
    len -= half;
  }
#pragma unroll
  for (int i = 0; i < K; ++i) cnt[i] += !(r(cnt[i]) > t[i]) ? 1 : 0;
}

// ---- The epilogues of B1 and B6

// B1's epilogue: the systematic extent of a double prefix.  Chain c reads
// s1[c] and, where u_dev is set, u_dev[c] for its offset (else u_host).
struct ExtentsEpilogue {
  using T = int;
  const float* s1;
  const float* u_dev;
  float u_host;
  int n;
  float u, inv_s1, nf;  // set on the device by load()
  __host__ __device__ static int lowest() { return 0; }  // extents are >= 0
  __device__ void load(int64_t c) {
    inv_s1 = __frcp_rn(s1[c]);
    u = u_dev != nullptr ? u_dev[c] : u_host;
    nf = (float)n;
  }
  __device__ int operator()(double p) const {
    const float prefix = __double2float_rn(p);  // rounded once
    const float cdf = __fmul_rn(prefix, inv_s1);
    float ff = ceilf(__fsub_rn(__fmul_rn(nf, cdf), u));
    return (int)fminf(fmaxf(ff, 0.0f), nf);
  }
};

// B6's epilogue: the prefix rounded to float32 once, times `scale` (chain c's
// scale_ptr[c]; 1 when `scale_ptr` is null).
struct ScaleEpilogue {
  using T = float;
  const float* scale_ptr;
  float scale;  // set on the device by load()
  __host__ __device__ static float lowest() { return -INFINITY; }
  __device__ void load(int64_t c) { scale = scale_ptr != nullptr ? scale_ptr[c] : 1.0f; }
  __device__ float operator()(double p) const {
    return __fmul_rn(__double2float_rn(p), scale);
  }
};

// ---- The single-pass scan of B1 and B6 (see "B1/B6 single pass"), whose
// look-back B5 shares -------------------------------------------------------

constexpr int kScanLevels = 4;  // 32^4 tiles: more than an int32 length holds

// Published values of a scratch for `cap` tiles: one per tile, one per group
// of 32 tiles, one per group of 32 groups, and so on.
__host__ __device__ inline int64_t scan_slots(int64_t cap) {
  int64_t n = 0;
  for (int k = 0; k < kScanLevels; ++k) {
    n += cap;
    cap = (cap + 31) >> 5;
  }
  return n;
}

// A published value and the epoch of the launch that wrote it travel as one
// aligned 16-byte word, stored and loaded whole, so a reader that sees the
// epoch has the value (the card moves an aligned 16-byte access as one
// transaction; no fence, no second round trip).
__device__ __forceinline__ void scan_publish(ulonglong2* p, unsigned long long bits,
                                             unsigned long long epoch) {
  __stcg(p, make_ulonglong2(bits, epoch));
}

__device__ __forceinline__ ulonglong2 scan_peek(const ulonglong2* p) {
  ulonglong2 v;
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];\n"
               : "=l"(v.x), "=l"(v.y)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long scan_bits(double v) {
  return (unsigned long long)__double_as_longlong(v);
}
__device__ __forceinline__ unsigned long long scan_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned long long scan_bits(int v) { return (unsigned int)v; }
__device__ __forceinline__ void scan_value(unsigned long long b, double& v) {
  v = __longlong_as_double((long long)b);
}
__device__ __forceinline__ void scan_value(unsigned long long b, float& v) {
  v = __uint_as_float((unsigned int)b);
}
__device__ __forceinline__ void scan_value(unsigned long long b, int& v) { v = (int)b; }

// Polls allowed on one entry before the kernel traps: a fault in the protocol
// then ends as an error, not as a hang.  A wait that is in order lasts
// microseconds.
constexpr unsigned int kScanSpinLimit = 1u << 24;

// The combination, under `op`, of `own` over every tile before `tile`, as a
// fixed function of the tiles' values; called by one whole warp after the
// block has its tile's `own`.  Level 0 holds one value a tile, level k + 1 one
// value for every 32 units of level k.  This tile publishes its own value,
// reads those of the tiles before it in its group of 32 and scans them as
// block_exclusive_scan scans a warp; where it is the last of its group the
// same scan gives the group's value, which it publishes one level up; then
// the same one level up, over the groups before its own in their group of 32.
// No published value waits for anything but the `own` of earlier tiles, so no
// chain of waits runs along the tiles, and the result does not depend on the
// order in which blocks run.  `slot` holds scan_slots(cap) entries; one is
// current when its epoch is this launch's.
template <typename T, typename Op>
__device__ T warp_lookback(ulonglong2* slot, int64_t cap, unsigned long long epoch, int tile,
                           T own, T identity, Op op) {
  const int lane = threadIdx.x & 31;
  T excl[kScanLevels];
#pragma unroll
  for (int k = 0; k < kScanLevels; ++k) excl[k] = identity;
  T total = own;     // this tile's unit at level k, valid where it is the unit's last tile
  bool last = true;
  int idx = tile;
  int64_t off = 0, count = cap;
#pragma unroll
  for (int k = 0; k < kScanLevels; ++k) {
    const int pos = idx & 31;
    const int parent = idx >> 5;
    if (last && lane == 0) scan_publish(slot + off + idx, scan_bits(total), epoch);
    if (idx == 0) break;  // nothing before this unit, here or above
    T v = identity;
    if (lane < pos) {
      const ulonglong2* at = slot + off + (int64_t)parent * 32 + lane;
      ulonglong2 w = scan_peek(at);
      for (unsigned int spins = 0; w.y != epoch; w = scan_peek(at)) {
        if (++spins > kScanSpinLimit) __trap();
      }
      scan_value(w.x, v);
    } else if (lane == pos) {
      v = total;
    }
    __syncwarp();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      T y = __shfl_up_sync(kFullWarp, v, d);
      if (lane >= d) v = op(y, v);
    }
    const T before = __shfl_sync(kFullWarp, v, pos > 0 ? pos - 1 : 0);
    excl[k] = pos > 0 ? before : identity;
    total = __shfl_sync(kFullWarp, v, 31);
    last = last && pos == 31;
    idx = parent;
    off += count;
    count = (count + 31) >> 5;
  }
  T r = excl[kScanLevels - 1];
#pragma unroll
  for (int k = kScanLevels - 2; k >= 0; --k) r = op(r, excl[k]);
  return r;
}

// With kChains, `nchains` rows of `len` elements each, scanned on their own
// (see "The chain axis"): tiles are numbered chain-major, tile g being tile
// g % ntiles of row g / ntiles, and each row looks back through its own part
// of the scratch.  Without it one row, its epilogue's values loaded once
// before the loop: the chain index is the constant 0 and every offset folds
// away.  Block b takes tiles b, b + gridDim.x, ...  The launch is cooperative,
// so every block of the grid is resident: a block waits only for tiles below
// its own in its row, which have lower numbers and are held by blocks that are
// running, and those wait for lower tiles in turn.  `epoch` is larger than that
// of any earlier launch on this scratch.
template <bool kUseExp, bool kChains, typename Epi>
__global__ void __launch_bounds__(kThreads, 4)  // four blocks an SM hold 1M in one wave
prefix_scan_kernel(const float* __restrict__ x_all, int64_t len, const float* __restrict__ mx,
                   Epi epi, ulonglong2* __restrict__ scratch, int64_t cap,
                   unsigned long long epoch, int ntiles, int nchains,
                   typename Epi::T* __restrict__ out_all) {
  using T = typename Epi::T;
  __shared__ double dsmem[32];
  __shared__ T tsmem[32];
  __shared__ double base_s;
  __shared__ T carry_s;
  if (!kChains) epi.load(0);
  const float m0 = kUseExp && !kChains ? *mx : 0.0f;
  const int all_tiles = kChains ? ntiles * nchains : ntiles;  // < 2^31: launch_scan checks
  for (int g = blockIdx.x; g < all_tiles; g += gridDim.x) {
    const int c = kChains ? g / ntiles : 0;
    const int tile = kChains ? g - c * ntiles : g;
    const float* __restrict__ x = x_all + (int64_t)c * len;
    T* __restrict__ out = out_all + (int64_t)c * len;
    ulonglong2* sum_slot = scratch + (int64_t)c * 2 * scan_slots(cap);
    ulonglong2* max_slot = sum_slot + scan_slots(cap);
    if (kChains) epi.load(c);
    const float m = kChains ? (kUseExp ? mx[c] : 0.0f) : m0;
    const bool vec_in = aligned16(x), vec_out = aligned16(out);
    const int64_t first = (int64_t)tile * kTile + (int64_t)threadIdx.x * kItems;
    const bool whole = first + kItems <= len;

    // The thread's kItems consecutive elements: 16-byte loads where the run
    // is whole and aligned.
    float xv[kItems];
    if (whole && vec_in) {
      const float4* xp = reinterpret_cast<const float4*>(x + first);
#pragma unroll
      for (int q = 0; q < kItems / 4; ++q) {
        const float4 w = __ldg(xp + q);
        xv[4 * q] = w.x;
        xv[4 * q + 1] = w.y;
        xv[4 * q + 2] = w.z;
        xv[4 * q + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i) xv[i] = first + i < len ? __ldg(x + first + i) : 0.0f;
    }

    double p[kItems];  // inclusive prefix within this thread's run
    double acc = 0.0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (first + i < len) acc += kUseExp ? (double)expf(__fsub_rn(xv[i], m)) : (double)xv[i];
      p[i] = acc;
    }
    double tile_sum = 0.0;
    const double before = block_exclusive_scan(acc, 0.0, Add(), dsmem, &tile_sum);
    if (threadIdx.x < 32) {
      const double own = __shfl_sync(kFullWarp, tile_sum, 0);
      const double b = warp_lookback(sum_slot, cap, epoch, tile, own, 0.0, Add());
      if (threadIdx.x == 0) base_s = b;
    }
    __syncthreads();
    const double base = base_s + before;

    T v[kItems];
    T run = Epi::lowest();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const T e = epi(base + p[i]);
      if (first + i < len) run = e > run ? e : run;
      v[i] = run;
    }
    T tile_max = Epi::lowest();
    T carry = block_exclusive_scan(run, Epi::lowest(), Max(), tsmem, &tile_max);
    if (threadIdx.x < 32) {
      const T own = __shfl_sync(kFullWarp, tile_max, 0);
      const T c = warp_lookback(max_slot, cap, epoch, tile, own, Epi::lowest(), Max());
      if (threadIdx.x == 0) carry_s = c;
    }
    __syncthreads();
    carry = carry_s > carry ? carry_s : carry;
#pragma unroll
    for (int i = 0; i < kItems; ++i) v[i] = v[i] > carry ? v[i] : carry;
    if (whole && vec_out) {
      uint4* dst = reinterpret_cast<uint4*>(out + first);
#pragma unroll
      for (int q = 0; q < kItems / 4; ++q) {
        dst[q] = make_uint4((unsigned)scan_bits(v[4 * q]), (unsigned)scan_bits(v[4 * q + 1]),
                            (unsigned)scan_bits(v[4 * q + 2]), (unsigned)scan_bits(v[4 * q + 3]));
      }
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if (first + i < len) out[first + i] = v[i];
      }
    }
  }
}

// Blocks of `kernel` that one device holds at once: the largest cooperative
// grid.  Asked once per device.
inline int resident_blocks(const void* kernel, int (&cache)[64]) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      return 0;
    }
    cache[dev] = per_sm * sms;
  }
  return cache[dev];
}

// Launch `kernel` (a scan over `tiles` tiles in each of `nchains` rows that
// looks back through a scratch for `cap` tiles a row) cooperatively, on no
// more blocks than the device holds at once; `resident` is the kernel's own
// cache for resident_blocks().
inline int launch_scan(const void* kernel, int (&resident)[64], int64_t tiles, int64_t cap,
                       unsigned long long epoch, void** args, cudaStream_t s,
                       int64_t nchains = 1) {
  const int64_t all = tiles * nchains;
  if (tiles > cap || nchains < 1 || all >= (int64_t)1 << 31 || epoch == 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int room = resident_blocks(kernel, resident);
  if (room <= 0) return (int)cudaErrorLaunchOutOfResources;
  const unsigned grid = (unsigned)(all < room ? all : room);
  const cudaError_t err =
      cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, 0, s);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// nchains rows of len elements; scratch: nchains * aps_scan_scratch_words(cap)
// 8-byte words, 16-byte aligned, zero when allocated and then written by these
// launches alone, each with a larger epoch (> 0) than the one before; cap >=
// the tiles of one row.
template <bool kUseExp, typename Epi>
int prefix_scan(const float* x, int64_t nchains, int64_t len, const float* mx, Epi epi,
                void* scratch, int64_t cap, unsigned long long epoch, typename Epi::T* out,
                cudaStream_t s) {
  static int resident[64] = {}, resident_chains[64] = {};
  const int64_t tiles = (len + kTile - 1) / kTile;
  if (nchains >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  int ntiles = (int)tiles;
  int nch = (int)nchains;
  ulonglong2* slots = (ulonglong2*)scratch;
  typename Epi::T* out_arg = out;
  void* args[] = {&x, &len, &mx, &epi, &slots, &cap, &epoch, &ntiles, &nch, &out_arg};
  if (nchains == 1) {
    return launch_scan((const void*)prefix_scan_kernel<kUseExp, false, Epi>, resident, tiles,
                       cap, epoch, args, s);
  }
  return launch_scan((const void*)prefix_scan_kernel<kUseExp, true, Epi>, resident_chains, tiles,
                     cap, epoch, args, s, nchains);
}

// Extent j with f[m-1] read as `guard`.
__device__ __forceinline__ int extent_at(const int* __restrict__ f, int64_t j, int64_t m,
                                         int guard) {
  return j == m - 1 ? guard : __ldg(f + j);
}

// ---- The tile decode of B2 and B4 (see "B2 tile decode").

// Shared memory of one block's decode of kDecodeTile slots.
struct DecodeTile {
  __align__(16) int run_f[kDecodeStage + 4];
  __align__(16) int slot_cnt[kDecodeTile];
  int scan[32];
  int64_t owner[2];
};

// The counts of the tile's slots s0 .. s0 + nk - 1 (1 <= nk <= kDecodeTile):
// on return cnt[i] = #{j : f_j <= s0 + k} for slot k = kDecodeItems *
// threadIdx.x + i of the tile, f[m-1] read as `guard` (for k >= nk a count of
// no meaning, in [0, m]).  Called by the whole block (kDecodeThreads threads);
// ends with a barrier, after which `sh` is free.
__device__ __forceinline__ void decode_tile(const int* __restrict__ f, int64_t m, int guard,
                                            int64_t s0, int nk, DecodeTile& sh,
                                            int (&cnt)[kDecodeItems]) {
  static_assert(kDecodeItems % 4 == 0, "a thread's slots move as 16-byte words");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kDecodeItems / 4; ++q) {
    reinterpret_cast<int4*>(sh.slot_cnt)[q * kDecodeThreads + threadIdx.x] = make_int4(0, 0, 0, 0);
  }
  if (warp < 2) {
    // Warp 0 counts the rows whose extent is <= the first slot, warp 1 those
    // <= the last.  The comparison is in 64 bits: a slot may pass any int.
    const int64_t s = warp == 0 ? s0 : s0 + nk - 1;
    const int64_t c = warp_partition_point(
        0, m, [&](int64_t j) { return (int64_t)extent_at(f, j, m, guard) <= s; });
    if (lane == 0) sh.owner[warp] = c;
  }
  __syncthreads();
  // Rows below j0 have f <= the first slot, rows from j1 on f > the last:
  // each slot's count is j0 plus its count within [j0, j1), whose extents lie
  // in (s0, s0 + nk - 1].
  const int64_t j0 = sh.owner[0], j1 = sh.owner[1];
  const int j0i = (int)j0;
  const int run = (int)(j1 - j0);

  if (run > kDecodeStage) {
    // A skewed tile: search the run where it lies.  Item i of thread x is
    // slot i * kDecodeThreads + x, so a warp's lanes hold neighbouring slots.
    // An extent is an int, so it is <= a slot exactly when it is <= the slot
    // cut to the largest int.  The counts go where the marks would: they are
    // nondecreasing, so the running max below leaves them as they are.
    int tv[kDecodeItems];
    int found[kDecodeItems];
#pragma unroll
    for (int i = 0; i < kDecodeItems; ++i) {
      const int k = i * kDecodeThreads + threadIdx.x;
      const int64_t s = s0 + (k < nk ? k : 0);
      tv[i] = (int)(s < (int64_t)INT_MAX ? s : (int64_t)INT_MAX);
    }
    upper_bound_uniform([&](int q) { return extent_at(f, j0 + q, m, guard); }, run, tv, found);
#pragma unroll
    for (int i = 0; i < kDecodeItems; ++i) {
      const int k = i * kDecodeThreads + threadIdx.x;
      if (k < nk) sh.slot_cnt[k] = found[i];
    }
    __syncthreads();
  } else if (run > 0) {
    // Row m - 1 is in the run exactly when j1 == m: the guard takes its place
    // in the staged copy.
    const int64_t hi = j1 == m ? m - 1 : j1;
    const int off = stage_run(sh.run_f, f, j0, hi);
    if (j1 == m && threadIdx.x == 0) sh.run_f[off + (int)(m - 1 - j0)] = guard;
    cp_async_wait_all();
    __syncthreads();
    const int* r = sh.run_f + off;
    // The last row of each run of equal extents marks the slot of its extent
    // with the rows counted up to it; the extents of run ends are distinct.
    for (int q = threadIdx.x; q < run; q += kDecodeThreads) {
      const int fq = r[q];
      if (q + 1 == run || r[q + 1] > fq) sh.slot_cnt[(int)((int64_t)fq - s0)] = q + 1;
    }
    __syncthreads();
  }
  // The running max of the marks is each slot's count within the run (all 0
  // for an empty run).  Thread x holds slots kDecodeItems * x and on: one
  // 16-byte read of shared memory for every four.
  int top = 0;
#pragma unroll
  for (int q = 0; q < kDecodeItems / 4; ++q) {
    const int4 w =
        reinterpret_cast<const int4*>(sh.slot_cnt)[threadIdx.x * (kDecodeItems / 4) + q];
    top = max(top, w.x); cnt[4 * q] = top;
    top = max(top, w.y); cnt[4 * q + 1] = top;
    top = max(top, w.z); cnt[4 * q + 2] = top;
    top = max(top, w.w); cnt[4 * q + 3] = top;
  }
  const int before = block_exclusive_scan(top, 0, Max(), sh.scan, (int*)nullptr);
#pragma unroll
  for (int i = 0; i < kDecodeItems; ++i) cnt[i] = j0i + max(before, cnt[i]);
}

// Store a thread's kDecodeItems consecutive 32-bit words at dst[kx ..], those
// below nk: as 16-byte words where all are and dst is 16-byte aligned.
template <typename T>
__device__ __forceinline__ void store_slots(T* __restrict__ dst, int kx, int nk,
                                            const T (&w)[kDecodeItems]) {
  static_assert(sizeof(T) == 4, "store_slots moves 4-byte entries");
  if (kx + kDecodeItems <= nk && aligned16(dst)) {
#pragma unroll
    for (int q = 0; q < kDecodeItems / 4; ++q) {
      reinterpret_cast<uint4*>(dst + kx)[q] =
          make_uint4((unsigned)w[4 * q], (unsigned)w[4 * q + 1], (unsigned)w[4 * q + 2],
                     (unsigned)w[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kDecodeItems; ++i) {
      if (kx + i < nk) dst[kx + i] = w[i];
    }
  }
}

// ---- B2: one block per kDecodeTile consecutive output slots.
__global__ void __launch_bounds__(kDecodeThreads)
decode_tile_kernel(const int* __restrict__ f, int64_t m, int guard, int64_t start,
                   int64_t n_out, int* __restrict__ anc) {
  __shared__ DecodeTile sh;
  const int64_t k0 = (int64_t)blockIdx.x * kDecodeTile;
  const int nk = (int)(n_out - k0 < kDecodeTile ? n_out - k0 : kDecodeTile);
  int cnt[kDecodeItems];
  decode_tile(f, m, guard, start + k0, nk, sh, cnt);
  store_slots(anc + k0, threadIdx.x * kDecodeItems, nk, cnt);
}

// ---- The move of B4 and B4 over leaves: a tile's rows by its slots' owners.

// One column: the rows of a thread's own slots, straight from its registers.
__device__ __forceinline__ void move_column(const uint32_t* __restrict__ v,
                                            uint32_t* __restrict__ tile_out, int kx, int nk,
                                            int rows, const int (&a)[kDecodeItems]) {
  uint32_t w[kDecodeItems];
#pragma unroll
  for (int i = 0; i < kDecodeItems; ++i) {
    w[i] = kx + i < nk && a[i] < rows ? __ldg(v + a[i]) : 0u;
  }
  store_slots(tile_out, kx, nk, w);
}

// Put the owners of the tile's slots in sh.slot_cnt for move_rows_wide (the
// array must be free: decode_tile ends with a barrier).  Ends with a barrier.
__device__ __forceinline__ void stage_owners(DecodeTile& sh, const int (&a)[kDecodeItems]) {
#pragma unroll
  for (int q = 0; q < kDecodeItems / 4; ++q) {
    reinterpret_cast<int4*>(sh.slot_cnt)[threadIdx.x * (kDecodeItems / 4) + q] =
        make_int4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
  }
  __syncthreads();
}

// d > 1 columns, owners staged: the tile's rows are contiguous in out, nk * d
// < 2^31 words, so consecutive threads write consecutive words (16 bytes each
// where d and the alignment allow), the owner of a word's slot read from
// shared memory.
__device__ __forceinline__ void move_rows_wide(const uint32_t* __restrict__ v, int d,
                                               uint32_t* __restrict__ tile_out, int nk, int rows,
                                               const DecodeTile& sh) {
  if ((d & 3) == 0 && aligned16(v) && aligned16(tile_out)) {
    const int d4 = d >> 2;
    const uint4* v4 = reinterpret_cast<const uint4*>(v);
    uint4* out4 = reinterpret_cast<uint4*>(tile_out);
    for (int e = threadIdx.x; e < nk * d4; e += kDecodeThreads) {
      const int i = e / d4;
      const int owner = sh.slot_cnt[i];
      out4[e] = owner < rows ? __ldg(v4 + (int64_t)owner * d4 + (e - i * d4))
                             : make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int e = threadIdx.x; e < nk * d; e += kDecodeThreads) {
      const int i = e / d;
      const int owner = sh.slot_cnt[i];
      tile_out[e] = owner < rows ? __ldg(v + (int64_t)owner * d + (e - i * d)) : 0u;
    }
  }
}

// ---- B4: one block per kDecodeMoveTile consecutive output slots, B2's tile
// (see "B4 decode, then move"); with kChains, of chain blockIdx.y (see "The
// chain axis"): its extents, rows, output and owners lie one chain's stride
// into each array.  Without it the chain is the constant 0, and the kernel
// fits its 32 registers as it did before the chain axis.
template <bool kChains>
__global__ void __launch_bounds__(kDecodeThreads, kDecodeMoveBlocks)
decode_move_kernel(const int* __restrict__ f_all, int64_t m, int guard, int64_t start,
                   int64_t n_out, const uint32_t* __restrict__ v_all, int d,
                   uint32_t* __restrict__ out_all, int* __restrict__ anc_all) {
  static_assert(kDecodeMoveTile == kDecodeTile, "B4 decodes its tile as B2 does");
  __shared__ DecodeTile sh;
  const int64_t c = kChains ? blockIdx.y : 0;
  const int* __restrict__ f = f_all + c * m;
  const uint32_t* __restrict__ v = v_all + c * m * d;
  uint32_t* __restrict__ out = out_all + c * n_out * d;
  int* __restrict__ anc_clipped = anc_all + c * n_out;
  const int64_t k0 = (int64_t)blockIdx.x * kDecodeMoveTile;
  const int nk = (int)(n_out - k0 < kDecodeMoveTile ? n_out - k0 : kDecodeMoveTile);
  int a[kDecodeItems];
  decode_tile(f, m, guard, start + k0, nk, sh, a);
  const int kx = threadIdx.x * kDecodeItems;
  const int rows = (int)m;  // m < 2^31
  uint32_t* tile_out = out + k0 * d;
  if (d == 1) {
    move_column(v, tile_out, kx, nk, rows, a);
  } else {
    stage_owners(sh, a);
    move_rows_wide(v, d, tile_out, nk, rows, sh);
  }
#pragma unroll
  for (int i = 0; i < kDecodeItems; ++i) a[i] = min(a[i], rows - 1);
  store_slots(anc_clipped + k0, kx, nk, a);
}

// ---- B4 over leaves: one decode of a tile, then the rows of up to
// kMaxLeaves leaves (see "B4 over leaves").  The leaf table is a by-value
// parameter; its loop is unrolled so that every entry is read at a fixed
// offset of the parameter space.
constexpr int kMaxLeaves = 8;

struct LeafSet {
  const uint32_t* v[kMaxLeaves];
  uint32_t* out[kMaxLeaves];
  int64_t d[kMaxLeaves];
  int count;
};

template <bool kChains>
__global__ void __launch_bounds__(kDecodeThreads, kDecodeMoveBlocks)
decode_move_leaves_kernel(const int* __restrict__ f_all, int64_t m, int guard, int64_t start,
                          int64_t n_out, const LeafSet leaves, int* __restrict__ anc_all) {
  __shared__ DecodeTile sh;
  const int64_t c = kChains ? blockIdx.y : 0;
  const int* __restrict__ f = f_all + c * m;
  int* __restrict__ anc_clipped = anc_all + c * n_out;
  const int64_t k0 = (int64_t)blockIdx.x * kDecodeMoveTile;
  const int nk = (int)(n_out - k0 < kDecodeMoveTile ? n_out - k0 : kDecodeMoveTile);
  int a[kDecodeItems];
  decode_tile(f, m, guard, start + k0, nk, sh, a);
  const int kx = threadIdx.x * kDecodeItems;
  const int rows = (int)m;  // m < 2^31
  stage_owners(sh, a);  // once, for every leaf of more than one column
#pragma unroll
  for (int l = 0; l < kMaxLeaves; ++l) {
    if (l >= leaves.count) break;
    const int d = (int)leaves.d[l];
    const uint32_t* v = leaves.v[l] + c * m * d;
    uint32_t* tile_out = leaves.out[l] + (c * n_out + k0) * d;
    if (d == 1) {
      move_column(v, tile_out, kx, nk, rows, a);
    } else {
      move_rows_wide(v, d, tile_out, nk, rows, sh);
    }
  }
#pragma unroll
  for (int i = 0; i < kDecodeItems; ++i) a[i] = min(a[i], rows - 1);
  store_slots(anc_clipped + k0, kx, nk, a);
}

// ---- B5 pass 1: run ends write one more than their row at their extent
// (see "B5 counting").  marks is zero on entry.
__global__ void __launch_bounds__(kMoveThreads)
dense_run_ends_kernel(const int* __restrict__ f, int64_t m, int guard, int64_t n_out,
                      int* __restrict__ marks) {
  const int64_t j = (int64_t)blockIdx.x * kMoveThreads + threadIdx.x;
  if (j >= m) return;
  const int fj = extent_at(f, j, m, guard);
  const bool run_end = j == m - 1 || fj < extent_at(f, j + 1, m, guard);
  if (run_end && fj >= 0 && (int64_t)fj < n_out) marks[fj] = (int)(j + 1);
}

// ---- B5 pass 2: anc = the inclusive running max of marks over n_out slots, in
// one pass (see "B5 counting"); marks (16-byte aligned) is left zero again.
// Block b takes tiles b, b + gridDim.x, ... of a cooperative launch, as
// prefix_scan_kernel does; `slots` and `epoch` as there.
__global__ void __launch_bounds__(kThreads, 4)
dense_scan_kernel(int* __restrict__ marks, int64_t n_out, ulonglong2* __restrict__ slots,
                  int64_t cap, unsigned long long epoch, int ntiles, int* __restrict__ anc) {
  __shared__ int smem[32];
  __shared__ int carry_s;
  const bool vec_out = aligned16(anc);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t first = (int64_t)tile * kDenseTile + (int64_t)threadIdx.x * kItems;
    const bool whole = first + kItems <= n_out;
    int v[kItems];
    if (whole) {
      int4* mp = reinterpret_cast<int4*>(marks + first);
#pragma unroll
      for (int q = 0; q < kItems / 4; ++q) {
        const int4 w = mp[q];
        mp[q] = make_int4(0, 0, 0, 0);
        v[4 * q] = w.x; v[4 * q + 1] = w.y; v[4 * q + 2] = w.z; v[4 * q + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        v[i] = 0;
        if (first + i < n_out) {
          v[i] = marks[first + i];
          marks[first + i] = 0;
        }
      }
    }
    int run = 0;  // a mark is one more than a row: > 0
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      run = max(run, v[i]);
      v[i] = run;
    }
    int tile_max = 0;
    int carry = block_exclusive_scan(run, 0, Max(), smem, &tile_max);
    if (threadIdx.x < 32) {
      const int own = __shfl_sync(kFullWarp, tile_max, 0);
      const int c = warp_lookback(slots, cap, epoch, tile, own, 0, Max());
      if (threadIdx.x == 0) carry_s = c;
    }
    __syncthreads();
    carry = max(carry, carry_s);
#pragma unroll
    for (int i = 0; i < kItems; ++i) v[i] = max(v[i], carry);
    if (whole && vec_out) {
      int4* dst = reinterpret_cast<int4*>(anc + first);
#pragma unroll
      for (int q = 0; q < kItems / 4; ++q) {
        dst[q] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if (first + i < n_out) anc[first + i] = v[i];
      }
    }
  }
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

// ---- B7: one block per kCountTile consecutive thresholds (see "B7 tile
// search").  Item i of thread x is threshold i * kCountThreads + x of the
// tile: a warp's lanes hold neighbouring thresholds, so their loads and stores
// coalesce and their probes of the staged run fall on neighbouring entries,
// in different banks.
__global__ void __launch_bounds__(kCountThreads)
count_le_tile_kernel(const float* __restrict__ s, int ns, const float* __restrict__ t,
                     int64_t nt, int* __restrict__ out) {
  __shared__ __align__(16) float run_s[kCountStage + 4];
  __shared__ float warp_min[kCountThreads / 32], warp_max[kCountThreads / 32];
  __shared__ int bound[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t j0 = (int64_t)blockIdx.x * kCountTile;
  const int nj = (int)(nt - j0 < kCountTile ? nt - j0 : kCountTile);

  float tv[kCountItems];
#pragma unroll
  for (int i = 0; i < kCountItems; ++i) {
    // Past the end: the tile's first threshold again, which moves no bound.
    const int k = i * kCountThreads + threadIdx.x;
    tv[i] = t[j0 + (k < nj ? k : 0)];
  }

  // The tile's smallest and largest threshold.  A NaN threshold counts all of
  // s, so it raises the upper bound to the top.
  float lo_t = tv[0], hi_t = tv[0];
#pragma unroll
  for (int i = 0; i < kCountItems; ++i) {
    lo_t = fminf(lo_t, tv[i]);
    hi_t = tv[i] != tv[i] ? INFINITY : fmaxf(hi_t, tv[i]);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    lo_t = fminf(lo_t, __shfl_xor_sync(kFullWarp, lo_t, d));
    hi_t = fmaxf(hi_t, __shfl_xor_sync(kFullWarp, hi_t, d));
  }
  if (lane == 0) {
    warp_min[warp] = lo_t;
    warp_max[warp] = hi_t;
  }
  __syncthreads();
  if (warp < 2) {
    // Warp 0 counts the entries <= the smallest threshold, warp 1 those <=
    // the largest.
    float v = warp == 0 ? warp_min[0] : warp_max[0];
    for (int w = 1; w < kCountThreads / 32; ++w) {
      v = warp == 0 ? fminf(v, warp_min[w]) : fmaxf(v, warp_max[w]);
    }
    const int64_t c = warp_partition_point(0, ns, [&](int64_t i) { return !(__ldg(s + i) > v); });
    if (lane == 0) bound[warp] = (int)c;
  }
  __syncthreads();

  // Entries below i_lo are <= every threshold of the tile, entries from i_hi
  // on are above every one: each count is i_lo plus its count within the run.
  const int i_lo = bound[0], i_hi = bound[1];
  const int run = i_hi - i_lo;
  int cnt[kCountItems] = {};
  if (run > kCountStage) {
    const float* r = s + i_lo;
    upper_bound_uniform([&](int k) { return __ldg(r + k); }, run, tv, cnt);
  } else if (run > 0) {
    const float* r = run_s + stage_run(run_s, s, i_lo, i_hi);
    cp_async_wait_all();
    __syncthreads();
    upper_bound_uniform([&](int k) { return r[k]; }, run, tv, cnt);
  }
#pragma unroll
  for (int i = 0; i < kCountItems; ++i) {
    const int k = i * kCountThreads + threadIdx.x;
    if (k < nj) out[j0 + k] = i_lo + cnt[i];
  }
}

// ---- B8: merge path (see "B8 merge path").  The merged order takes s_k
// before t_j exactly when s_k <= t_j, so the count for t_j is the number of s
// entries merged before it.  The number of s entries among the first d merged
// entries is the first i at which s_i > t_{d-1-i} (a predicate that turns
// false once as i grows, s and t being sorted).  Called by a whole warp.
__device__ int merge_split_warp(const float* __restrict__ s, int ns,
                                const float* __restrict__ t, int64_t nt, int64_t d) {
  const int64_t lo = d > nt ? d - nt : 0;
  const int64_t hi = d < ns ? d : ns;
  return (int)warp_partition_point(
      lo, hi, [&](int64_t k) { return __ldg(s + k) <= __ldg(t + (d - 1 - k)); });
}

// One block per kMergeTile merged entries: its run of s, s[i0, i1), and of t,
// t[j0, j0 + nj), lie between the splits of its first and last diagonal, which
// its first two warps find.  Every s entry before i0 is <= t_j0 and every one
// from i1 on is above the run's last threshold, so each count is i0 plus the
// count within the staged run of s, found as B7 finds it.
__global__ void __launch_bounds__(kMergeThreads)
count_le_merge_kernel(const float* __restrict__ s, int ns, const float* __restrict__ t,
                      int64_t nt, int* __restrict__ out) {
  __shared__ __align__(16) float run_s[kMergeTile + 4];
  __shared__ int split[2];
  const int64_t total = (int64_t)ns + nt;
  const int64_t d0 = (int64_t)blockIdx.x * kMergeTile;
  const int64_t d1 = d0 + kMergeTile < total ? d0 + kMergeTile : total;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int i = merge_split_warp(s, ns, t, nt, warp == 0 ? d0 : d1);
    if ((threadIdx.x & 31) == 0) split[warp] = i;
  }
  __syncthreads();
  const int i0 = split[0], i1 = split[1];
  const int64_t j0 = d0 - i0;
  const int ni = i1 - i0;
  const int nj = (int)(d1 - d0) - ni;
  const float* r = run_s;
  if (ni > 0) {
    r += stage_run(run_s, s, i0, i1);
    cp_async_wait_all();
    __syncthreads();
  }
  for (int first = 0; first < nj; first += kCountItems * kMergeThreads) {
    float tv[kCountItems];
    int cnt[kCountItems] = {};
#pragma unroll
    for (int i = 0; i < kCountItems; ++i) {
      const int k = first + i * kMergeThreads + threadIdx.x;
      tv[i] = t[j0 + (k < nj ? k : first)];
    }
    if (ni > 0) upper_bound_uniform([&](int k) { return r[k]; }, ni, tv, cnt);
#pragma unroll
    for (int i = 0; i < kCountItems; ++i) {
      const int k = first + i * kMergeThreads + threadIdx.x;
      if (k < nj) out[j0 + k] = i0 + cnt[i];
    }
  }
}

inline unsigned blocks_for(int64_t count, int threads) {
  return (unsigned)((count + threads - 1) / threads);
}

}  // namespace

extern "C" {

int aps_prefix_tile_size() { return kTile; }

const char* aps_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// 8-byte words of the scan scratch of B1 and B6 for up to `cap` tiles (of one
// chain: a launch over C chains takes C times as many).
int aps_scan_scratch_words(int64_t cap) { return (int)(4 * scan_slots(cap)); }

// B1.  logw float32[len]; mx, s1 float32 scalars on the device; f int32[len].
// scratch: aps_scan_scratch_words(cap) 8-byte words, zero when allocated and
// from then on written only by B1 and B6 launches of one stream;
// cap >= ceil(len / aps_prefix_tile_size()).
int aps_extents_from_logw(const float* logw, int64_t len, const float* mx,
                          const float* s1, float u, int n, void* scratch, int64_t cap,
                          uint64_t epoch, int* f, void* stream) {
  ExtentsEpilogue epi{s1, nullptr, u, n, 0.0f, 0.0f, 0.0f};
  return prefix_scan<true>(logw, 1, len, mx, epi, scratch, cap, epoch, f, (cudaStream_t)stream);
}

// B1 with the chain axis.  logw float32[nchains, len]; mx, s1 and u float32
// [nchains] on the device; f int32[nchains, len]; scratch
// nchains * aps_scan_scratch_words(cap) words, as for B1.  Row c is B1 on
// logw[c] with (mx[c], s1[c], u[c]), bit for bit.
int aps_extents_from_logw_chains(const float* logw, int64_t nchains, int64_t len,
                                 const float* mx, const float* s1, const float* u, int n,
                                 void* scratch, int64_t cap, uint64_t epoch, int* f,
                                 void* stream) {
  if (u == nullptr) return (int)cudaErrorInvalidValue;
  ExtentsEpilogue epi{s1, u, 0.0f, n, 0.0f, 0.0f, 0.0f};
  return prefix_scan<true>(logw, nchains, len, mx, epi, scratch, cap, epoch, f,
                           (cudaStream_t)stream);
}

// B6.  x float32[len]; with use_exp the summands are exp(x - *mx), else x;
// scale a float32 scalar on the device, or null for 1; out float32[len].
// scratch and cap as for B1.
int aps_scaled_prefix(const float* x, int64_t len, int use_exp, const float* mx,
                      const float* scale, void* scratch, int64_t cap, uint64_t epoch,
                      float* out, void* stream) {
  ScaleEpilogue epi{scale, 1.0f};
  cudaStream_t s = (cudaStream_t)stream;
  return use_exp ? prefix_scan<true>(x, 1, len, mx, epi, scratch, cap, epoch, out, s)
                 : prefix_scan<false>(x, 1, len, mx, epi, scratch, cap, epoch, out, s);
}

// B6 with the chain axis.  x float32[nchains, len]; mx and scale float32
// [nchains] on the device (mx read with use_exp only; scale null for 1); out
// float32[nchains, len]; scratch as for B1 with the chain axis.
int aps_scaled_prefix_chains(const float* x, int64_t nchains, int64_t len, int use_exp,
                             const float* mx, const float* scale, void* scratch, int64_t cap,
                             uint64_t epoch, float* out, void* stream) {
  ScaleEpilogue epi{scale, 1.0f};
  cudaStream_t s = (cudaStream_t)stream;
  return use_exp ? prefix_scan<true>(x, nchains, len, mx, epi, scratch, cap, epoch, out, s)
                 : prefix_scan<false>(x, nchains, len, mx, epi, scratch, cap, epoch, out, s);
}

// The geometry of the decodes: 0 kDecodeTile and 1 kDecodeStage (B2; B4 stages
// as many), 2 kDecodeMoveTile (B4), 3 kDenseTile (B5's scan).
int aps_decode_geometry(int which) {
  return which == 0   ? kDecodeTile
         : which == 1 ? kDecodeStage
         : which == 2 ? kDecodeMoveTile
         : which == 3 ? kDenseTile
                      : -1;
}

// B2.  f int32[m] nondecreasing (f[m-1] read as guard), m < 2^31; anc
// int32[n_out] in [0, m], the counts of slots start .. start + n_out - 1.
int aps_decode_ancestors(const int* f, int64_t m, int guard, int64_t start, int64_t n_out,
                         int* anc, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  decode_tile_kernel<<<blocks_for(n_out, kDecodeTile), kDecodeThreads, 0, s>>>(
      f, m, guard, start, n_out, anc);
  return (int)cudaGetLastError();
}

// The most chains one launch of B4 with the chain axis takes (gridDim.y).
constexpr int64_t kMaxChains = 65535;

// B4 with the chain axis.  f int32[nchains, m], v 32-bit words [nchains, m, d],
// out [nchains, n_out, d], anc_clipped int32[nchains, n_out]; chain c is B4 on
// row c with the same guard, bit for bit.  1 <= nchains <= 65535.
int aps_decode_move_chains(const int* f, int64_t nchains, int64_t m, int guard, int64_t start,
                           int64_t n_out, const void* v, int64_t d, void* out, int* anc_clipped,
                           void* stream) {
  if (d < 1 || d > (1 << 19) || nchains < 1 || nchains > kMaxChains) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(blocks_for(n_out, kDecodeMoveTile), (unsigned)nchains);
  auto kernel = nchains == 1 ? decode_move_kernel<false> : decode_move_kernel<true>;
  kernel<<<grid, kDecodeThreads, 0, s>>>(f, m, guard, start, n_out, (const uint32_t*)v, (int)d,
                                         (uint32_t*)out, anc_clipped);
  return (int)cudaGetLastError();
}

// B4.  f as for B2; v 32-bit words [m, d], 1 <= d <= 2^19 (a tile's words
// are counted in an int); out [n_out, d] (0 past the population); anc_clipped
// int32[n_out], the counts clipped to m - 1.
int aps_decode_move(const int* f, int64_t m, int guard, int64_t start, int64_t n_out,
                    const void* v, int64_t d, void* out, int* anc_clipped, void* stream) {
  return aps_decode_move_chains(f, 1, m, guard, start, n_out, v, d, out, anc_clipped, stream);
}

// The most leaves one launch of B4 over leaves moves.
int aps_max_leaves() { return kMaxLeaves; }

int aps_decode_move_leaves_chains(const int* f, int64_t nchains, int64_t m, int guard,
                                  int64_t start, int64_t n_out, int count, const void* const* v,
                                  void* const* out, const int64_t* d, int* anc_clipped,
                                  void* stream);

// B4 over leaves.  f as for B2; count leaves, 1 <= count <= kMaxLeaves: leaf l
// 32-bit words v[l] [m, d[l]] moved into out[l] [n_out, d[l]] (0 past the
// population), 1 <= d[l] <= 2^19; v, out and d are host arrays of count
// entries; anc_clipped int32[n_out], the counts clipped to m - 1.
int aps_decode_move_leaves(const int* f, int64_t m, int guard, int64_t start, int64_t n_out,
                           int count, const void* const* v, void* const* out, const int64_t* d,
                           int* anc_clipped, void* stream) {
  return aps_decode_move_leaves_chains(f, 1, m, guard, start, n_out, count, v, out, d,
                                       anc_clipped, stream);
}

// B4 over leaves with the chain axis: f int32[nchains, m], leaf l [nchains, m,
// d[l]] into out[l] [nchains, n_out, d[l]], anc_clipped int32[nchains, n_out];
// chain c is B4 over leaves on row c, bit for bit.  1 <= nchains <= 65535.
int aps_decode_move_leaves_chains(const int* f, int64_t nchains, int64_t m, int guard,
                                  int64_t start, int64_t n_out, int count, const void* const* v,
                                  void* const* out, const int64_t* d, int* anc_clipped,
                                  void* stream) {
  if (count < 1 || count > kMaxLeaves || nchains < 1 || nchains > kMaxChains) {
    return (int)cudaErrorInvalidValue;
  }
  LeafSet set{};
  for (int l = 0; l < count; ++l) {
    if (d[l] < 1 || d[l] > (1 << 19)) return (int)cudaErrorInvalidValue;
    set.v[l] = (const uint32_t*)v[l];
    set.out[l] = (uint32_t*)out[l];
    set.d[l] = d[l];
  }
  set.count = count;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(blocks_for(n_out, kDecodeMoveTile), (unsigned)nchains);
  auto kernel = nchains == 1 ? decode_move_leaves_kernel<false> : decode_move_leaves_kernel<true>;
  kernel<<<grid, kDecodeThreads, 0, s>>>(f, m, guard, start, n_out, set, anc_clipped);
  return (int)cudaGetLastError();
}

// B5.  f int32[m] >= 0, nondecreasing (f[m-1] read as guard); anc
// int32[n_out], n_out >= 1; marks int32[>= n_out], 16-byte aligned, zero on
// entry and zero again when the launches have run; scratch, cap and epoch as
// for B1, cap >= ceil(n_out / aps_decode_geometry(3)).
int aps_decode_ancestors_dense(const int* f, int64_t m, int guard, int64_t n_out, int* marks,
                               void* scratch, int64_t cap, uint64_t epoch, int* anc,
                               void* stream) {
  static int resident[64] = {};
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t tiles = (n_out + kDenseTile - 1) / kDenseTile;
  // Refused before anything is marked: a scatter with no scan behind it would
  // leave the marks set.
  if (tiles > cap || epoch == 0) return (int)cudaErrorInvalidValue;
  dense_run_ends_kernel<<<blocks_for(m, kMoveThreads), kMoveThreads, 0, s>>>(
      f, m, guard, n_out, marks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int ntiles = (int)tiles;
  ulonglong2* slots = (ulonglong2*)scratch;
  unsigned long long ep = epoch;
  void* args[] = {&marks, &n_out, &slots, &cap, &ep, &ntiles, &anc};
  return launch_scan((const void*)dense_scan_kernel, resident, tiles, cap, ep, args, s);
}

// B3.  anc int32[n_out] in [0, m]; v 32-bit words [m, d]; out [n_out, d];
// anc_clipped int32[n_out].
int aps_move_rows(const int* anc, int64_t n_out, int64_t m, const void* v, int64_t d,
                  void* out, int* anc_clipped, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  move_rows_kernel<<<blocks_for(n_out * d, kMoveThreads), kMoveThreads, 0, s>>>(
      anc, n_out, m, (const uint32_t*)v, d, (uint32_t*)out, anc_clipped);
  return (int)cudaGetLastError();
}

// The geometry of B7 and B8: 0 kCountTile, 1 kCountStage, 2 kMergeTile.
int aps_count_le_geometry(int which) {
  return which == 0 ? kCountTile : which == 1 ? kCountStage : which == 2 ? kMergeTile : -1;
}

// B7.  s float32[ns] nondecreasing, ns < 2^31; t float32[nt]; out int32[nt],
// nt >= 1.
int aps_count_le_sorted_bs(const float* s, int64_t ns, const float* t, int64_t nt,
                           int* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  count_le_tile_kernel<<<blocks_for(nt, kCountTile), kCountThreads, 0, st>>>(s, (int)ns, t, nt,
                                                                             out);
  return (int)cudaGetLastError();
}

// B8.  s float32[ns] and t float32[nt] both nondecreasing, ns < 2^31;
// out int32[nt], nt >= 1.
int aps_count_le_sorted(const float* s, int64_t ns, const float* t, int64_t nt, int* out,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  count_le_merge_kernel<<<blocks_for(ns + nt, kMergeTile), kMergeThreads, 0, st>>>(
      s, (int)ns, t, nt, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
