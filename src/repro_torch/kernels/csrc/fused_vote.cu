// Fused sign extraction + bit-pack + popcount majority for Hopper (sm_90a).
//
// Replaces the Pallas kernel
//   src/repro/kernels/fused_vote.py:52 fused_majority_2d (pallas_call at :60)
//
// (M, n) f32/bf16/int8 voter values -> (ceil(n/32),) packed majority words
// in one read of the stack: bit j of word k is 2 * count >= M, where count
// is the number of voters r with x[r, 32k + j] >= 0 (ties go to +1, the
// 1-bit wire's sign(0) = +1). Any n: the bits past n are 1, the bits the
// reference's zero padding gives (every voter then reads 0 >= 0).
//
// Bound on the H100 (3.35 TB/s): one comparison and one add per element,
// so device-memory bytes bound it: the M * n payload read once and n / 8
// bytes written. On the glm4-9b unembedding (n = 620,756,992) at M = 4 in
// float32: 9.93 GB + 77.6 MB, 2.99 ms.
//
// Design. The TPU kernel loads a whole (M, 4096) voter column into VMEM,
// counts down the voter axis and packs with a 32-way shift/OR tree. Here
// one warp owns one output word: lane j walks the M rows at column
// 32k + j (each row's 32 elements are one coalesced load), counts in a
// register, and one __ballot_sync(2 * count >= M) is the word, stored by
// lane 0. Nothing but the words reaches memory and no block talks to
// another.
//
// A float32 or bf16 subnormal votes +1, as the reference (XLA) reads it as a
// zero: nonneg tests the bits.
//
// The entry points launch on the caller's stream and return
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// x >= 0 on the bits of a float32, a subnormal read as a zero (as the
// reference's XLA reads it) and NaN false. build.py compiles with
// -ftz=true, but ptxas emitted one of bitpack.cu's four compares of a warp
// without .FTZ (FSETP.GE.OR, cuobjdump -sass on an H100), so the sign test
// is an integer one and never depends on the flag.
__device__ __forceinline__ int nonneg_bits(uint32_t u) {
  const uint32_t a = u & 0x7fffffffu;
  return a < 0x00800000u || (!(u >> 31) && a <= 0x7f800000u);
}
__device__ __forceinline__ int nonneg(float x) {
  return nonneg_bits(__float_as_uint(x));
}
__device__ __forceinline__ int nonneg(__nv_bfloat16 x) {
  return nonneg_bits((uint32_t)__bfloat16_as_ushort(x) << 16);
}
__device__ __forceinline__ int nonneg(int8_t x) { return x >= 0; }

template <typename T>
__global__ void fused_majority_kernel(const T* __restrict__ x,
                                      uint32_t* __restrict__ out, int m,
                                      int64_t n, int64_t w) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool vote = true;
  if (i < n) {
    int count = 0;
#pragma unroll 4
    for (int r = 0; r < m; ++r) count += nonneg(x[(int64_t)r * n + i]);
    vote = 2 * count >= m;
  }
  // every lane of the warp takes part: blocks are whole warps
  const unsigned word = __ballot_sync(0xffffffffu, vote);
  const int64_t k = i >> 5;
  if ((threadIdx.x & 31) == 0 && k < w) out[k] = word;
}

template <typename T>
int launch(const void* x, void* out, int m, int64_t n, void* stream) {
  const int64_t w = (n + 31) / 32;
  if (w > 0) {
    fused_majority_kernel<T>
        <<<(unsigned)((w * 32 + kThreads - 1) / kThreads), kThreads, 0,
           (cudaStream_t)stream>>>((const T*)x, (uint32_t*)out, m, n, w);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_majority_f32(const void* x, void* out, int m, int64_t n,
                       void* stream) {
  return launch<float>(x, out, m, n, stream);
}

int fused_majority_bf16(const void* x, void* out, int m, int64_t n,
                        void* stream) {
  return launch<__nv_bfloat16>(x, out, m, n, stream);
}

int fused_majority_i8(const void* x, void* out, int m, int64_t n,
                      void* stream) {
  return launch<int8_t>(x, out, m, n, stream);
}

}  // extern "C"
