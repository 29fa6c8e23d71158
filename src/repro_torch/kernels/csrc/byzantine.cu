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
// Bound on the H100. Bytes: a draw writes 1 B an element, a flip reads and
// writes 2 B; one row of the glm4-9b unembedding (n = 620,756,992) is
// 0.37 ms at 3.35 TB/s for a flip. Integer issue: 79 32-bit integer ops an
// element (20 rounds of add, funnel shift and xor; 5 key injections; the
// 64-bit counter; the compare and select), 49.0e9 a row, 1.46 ms at one op
// a lane a clock on the card's 128 lanes an SM (33.5e12 a second; integer
// adds also issue on the FMA pipe, so the 64 INT32 lanes alone are no
// bound). So integer issue bounds it, and the design keeps the memory side
// simple.
//
// Design. One thread owns 16 consecutive columns of one row (the grid's y
// dimension walks the rows): one 16-byte load and store where the window
// is 16-byte aligned and whole, else element by element (a view off a
// 16-byte boundary, each row's ragged tail). The rotations are
// __funnelshift_l; the counter is built per element from a 64-bit base.
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

template <bool kFlip>
__global__ void __launch_bounds__(kThreads)
adversary_kernel(int8_t* __restrict__ x, const uint32_t* __restrict__ keys,
                 int64_t n, int64_t ld, uint64_t offset, uint32_t threshold) {
  const int64_t row = blockIdx.y;
  const int64_t col =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kPer;
  if (col >= n) return;
  const uint32_t k0 = keys[2 * row], k1 = keys[2 * row + 1];
  int8_t* p = x + row * ld + col;
  const uint64_t base = offset + static_cast<uint64_t>(col);
  if (col + kPer <= n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    int4 v = make_int4(0, 0, 0, 0);
    if (kFlip) v = *reinterpret_cast<const int4*>(p);
    int8_t* b = reinterpret_cast<int8_t*>(&v);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      b[j] = adversary_one<kFlip>(b[j], k0, k1, base + j, threshold);
    }
    *reinterpret_cast<int4*>(p) = v;
    return;
  }
  const int64_t m = n - col < kPer ? n - col : kPer;
  for (int64_t j = 0; j < m; ++j) {
    p[j] = adversary_one<kFlip>(kFlip ? p[j] : int8_t(0), k0, k1, base + j,
                                threshold);
  }
}

}  // namespace

extern "C" {

// x: rows of n int8 signs, row r at x + r * ld; keys: (rows, 2) uint32 on
// the card; flip: 0 draws (random, colluding), 1 flips (blind).
int adversary_i8(void* x, const void* keys, int64_t rows, int64_t n,
                 int64_t ld, int64_t offset, int64_t threshold, int flip,
                 void* stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t per_block = static_cast<int64_t>(kThreads) * kPer;
  const dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block),
                  static_cast<unsigned>(rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* xp = static_cast<int8_t*>(x);
  auto* kp = static_cast<const uint32_t*>(keys);
  const auto t = static_cast<uint32_t>(threshold);
  const auto off = static_cast<uint64_t>(offset);
  if (flip) {
    adversary_kernel<true><<<grid, kThreads, 0, s>>>(xp, kp, n, ld, off, t);
  } else {
    adversary_kernel<false><<<grid, kThreads, 0, s>>>(xp, kp, n, ld, off, t);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
