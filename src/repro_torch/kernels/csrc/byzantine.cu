// The stochastic Byzantine adversaries for Hopper (sm_90a), in place on
// the int8 sign rows of the adversarial voters.
//
// No Pallas counterpart: the reference draws in jnp,
//   src/repro/core/byzantine.py:81-121 evil_signs ("random", "colluding",
//   "blind"), each a jax.random.bernoulli under adversary_key (:62-79).
// The kernel reproduces those draws bit for bit (JAX's partitionable
// threefry2x32, core/prng.py):
//   counter i = offset + column (int64): (hi, lo) = (i >> 32, i mod 2^32)
//   bits      = out0 ^ out1 of threefry2x32(row key, (hi, lo)), 20 rounds
//   draw      = (bits >> 9) < threshold
// where the host turns the float32 probability p into the integer
// threshold ceil(p * 2^23): JAX's uniform is (bits >> 9) / 2^23, exactly,
// so "uniform < p" is this integer compare and the kernel has no float
// operation at all. Modes: draw (random, colluding: the row becomes +1
// where draw, else -1; a colluding coalition passes one key for every row)
// and flip (blind: the row's sign negated where draw, so 0 stays 0).
// Each row has its own (k0, k1) key, derived on the host from (seed +
// salt, voter, step) as the reference derives it; `offset` lets a window
// of a long row (a bucket, or a chunk of a check) draw what the whole row
// draws there.
//
// The counter map: a model shard's global coordinates. Over a mesh's
// "model" axis a rank holds, of a row-major leaf of shape (A, D, B) cut
// along its model dim D into `parts`, the block (A, D/parts, B): runs of
// block = (D/parts)*B elements, each followed in the whole leaf by the
// other ranks' gap = (D - D/parts)*B elements. The reference's step is
// automatic over "model", so it draws at the leaf's global index; local
// element l of the block sits at
//   counter(l) = offset + l + floor(l / block) * gap
// with offset = the leaf's start in the flat row + rank_in_model * block.
// A window of the block that starts at local element `start` draws column
// j at counter(start + j). block = 0 means no cut: counter = offset +
// start + j, the launch that existed before the map. One (block, gap)
// pair is all any arch's layout needs: the spec rules put "model" on at
// most one dim of a leaf, and a "data" cut (fsdp) is either gathered
// before the draw (the fused backward) or is the very array the reference
// draws over (its step is manual over the data axis).
//
// Bound on the H100. Bytes: a draw writes 1 B an element, a flip reads and
// writes 2 B; one row of the glm4-9b unembedding (n = 620,756,992) is
// 0.37 ms at 3.35 TB/s for a flip. Integer issue: 79 32-bit integer ops an
// element (20 rounds of add, funnel shift and xor; 5 key injections; the
// 64-bit counter; the compare and select), 49.0e9 a row, 1.46 ms at one op
// a lane a clock on the card's 128 lanes an SM (33.5e12 a second; integer
// adds also issue on the FMA pipe, so the 64 INT32 lanes alone are no
// bound). So integer issue bounds it, and the design keeps the memory side
// simple. The map needs about 12 integer ops a thread (one division as a
// multiply-high by a reciprocal, its remainder and the base;
// chip_smoke.ADV_MAP_OPS), under 1 an element; the software division
// below spends about 20 more, which the bound does not count.
//
// Design. One thread owns 16 consecutive columns of one row (the grid's y
// dimension walks the rows): one 16-byte load and store where the window
// is 16-byte aligned and whole, else element by element (a view off a
// 16-byte boundary, each row's ragged tail). The rotations are
// __funnelshift_l; the counter is built per element from a 64-bit base.
// Under the map (its own instantiation, kCut) a thread divides once (in 32
// bits where its first local index and the block fit 32 bits) for its
// first counter and the columns left in its run; where its 16 columns lie
// in one run (all but one thread in block/16 when block >= 16) they take
// the uncut loop from that counter, else each column steps the counter and
// the columns left, adding the gap at each run's end.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;          // columns a thread owns
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

// out0 ^ out1 of JAX's threefry2x32 of the counter (x0, x1) under (k0, k1)
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k1; x1 += k2 + 1u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k2; x1 += k0 + 2u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k0; x1 += k1 + 3u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k1; x1 += k2 + 4u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

template <bool kFlip>
__device__ __forceinline__ int8_t adversary_one(int8_t s, uint32_t k0,
                                                uint32_t k1, uint64_t ctr,
                                                uint32_t threshold) {
  const uint32_t bits = threefry_bits(k0, k1, static_cast<uint32_t>(ctr >> 32),
                                      static_cast<uint32_t>(ctr));
  const bool draw = (bits >> 9) < threshold;
  if (kFlip) return draw ? static_cast<int8_t>(-s) : s;
  return draw ? int8_t(1) : int8_t(-1);
}

template <bool kFlip, bool kCut>
__global__ void __launch_bounds__(kThreads)
adversary_kernel(int8_t* __restrict__ x, const uint32_t* __restrict__ keys,
                 int64_t n, int64_t ld, uint64_t offset, uint32_t threshold,
                 uint64_t start, uint64_t block, uint64_t gap) {
  const int64_t row = blockIdx.y;
  const int64_t col =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kPer;
  if (col >= n) return;
  const uint32_t k0 = keys[2 * row], k1 = keys[2 * row + 1];
  int8_t* p = x + row * ld + col;
  // the counter of this thread's first column and, under the map, the
  // columns left in its run before the next gap
  uint64_t ctr = offset + static_cast<uint64_t>(col);
  uint64_t left = kPer;
  if (kCut) {
    const uint64_t l = start + static_cast<uint64_t>(col);
    const uint64_t q =
        ((l | block) >> 32) == 0
            ? static_cast<uint64_t>(static_cast<uint32_t>(l) /
                                    static_cast<uint32_t>(block))
            : l / block;
    left = block - (l - q * block);
    ctr = offset + l + q * gap;
  }
  const int64_t m = n - col < kPer ? n - col : kPer;
  if (m == kPer && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    int4 v = make_int4(0, 0, 0, 0);
    if (kFlip) v = *reinterpret_cast<const int4*>(p);
    int8_t* b = reinterpret_cast<int8_t*>(&v);
    if (!kCut || left >= kPer) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        b[j] = adversary_one<kFlip>(b[j], k0, k1, ctr + j, threshold);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        b[j] = adversary_one<kFlip>(b[j], k0, k1, ctr, threshold);
        ++ctr;
        if (--left == 0) {
          left = block;
          ctr += gap;
        }
      }
    }
    *reinterpret_cast<int4*>(p) = v;
    return;
  }
  for (int64_t j = 0; j < m; ++j) {
    p[j] = adversary_one<kFlip>(kFlip ? p[j] : int8_t(0), k0, k1, ctr,
                                threshold);
    ++ctr;
    if (kCut && --left == 0) {
      left = block;
      ctr += gap;
    }
  }
}

template <bool kFlip, bool kCut>
void launch(dim3 grid, cudaStream_t s, int8_t* x, const uint32_t* keys,
            int64_t n, int64_t ld, uint64_t offset, uint32_t threshold,
            uint64_t start, uint64_t block, uint64_t gap) {
  adversary_kernel<kFlip, kCut><<<grid, kThreads, 0, s>>>(
      x, keys, n, ld, offset, threshold, start, block, gap);
}

}  // namespace

extern "C" {

// x: rows of n int8 signs, row r at x + r * ld; keys: (rows, 2) uint32 on
// the card; flip: 0 draws (random, colluding), 1 flips (blind). Column j
// draws at counter(start + j) of the map above (block = 0: offset + start
// + j, no cut).
int adversary_i8(void* x, const void* keys, int64_t rows, int64_t n,
                 int64_t ld, int64_t offset, int64_t threshold, int flip,
                 int64_t start, int64_t block, int64_t gap, void* stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t per_block = static_cast<int64_t>(kThreads) * kPer;
  const dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block),
                  static_cast<unsigned>(rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* xp = static_cast<int8_t*>(x);
  auto* kp = static_cast<const uint32_t*>(keys);
  const auto t = static_cast<uint32_t>(threshold);
  const auto off = static_cast<uint64_t>(offset);
  const auto st = static_cast<uint64_t>(start);
  const auto b = static_cast<uint64_t>(block);
  const auto g = static_cast<uint64_t>(gap);
  if (block == 0) {
    if (flip) {
      launch<true, false>(grid, s, xp, kp, n, ld, off + st, t, 0, 0, 0);
    } else {
      launch<false, false>(grid, s, xp, kp, n, ld, off + st, t, 0, 0, 0);
    }
  } else if (flip) {
    launch<true, true>(grid, s, xp, kp, n, ld, off, t, st, b, g);
  } else {
    launch<false, true>(grid, s, xp, kp, n, ld, off, t, st, b, g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
