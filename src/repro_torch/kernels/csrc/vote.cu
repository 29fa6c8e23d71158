// Popcount majority over packed 1-bit votes for Hopper (sm_90a).
//
// Replaces the Pallas kernel
//   src/repro/kernels/vote.py:37 majority_packed (pallas_call at :42)
//
// (M, w) packed words -> (w,) packed majority: for each of the 32 bit
// positions count the voters whose bit is set, and set the output bit when
// 2 * count >= M (ties go to +1, the 1-bit wire's sign(0) = +1).
//
// Bound on the H100 (3.35 TB/s): no float work at all, and about one
// integer add per voter and bit, so device-memory bytes bound it: the M
// words read and the one written per output word, (M + 1) * 4 B. On the
// glm4-9b unembedding (19,398,656 words) at M = 4: 0.39 GB, 0.116 ms.
//
// Design. The TPU kernel counts bit-slices of a (M, 512) VMEM block in
// sequence. Here one thread owns one output word: it walks the M voter
// rows (neighbouring threads read neighbouring words, so each row's load
// is coalesced), keeps 32 counts in registers and writes one word. Nothing
// is unpacked to memory and no block talks to another.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void majority_kernel(const uint32_t* __restrict__ packed,
                                uint32_t* __restrict__ out, int m,
                                int64_t w) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= w) return;
  int count[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) count[j] = 0;
  for (int r = 0; r < m; ++r) {
    const uint32_t word = packed[(int64_t)r * w + k];
#pragma unroll
    for (int j = 0; j < 32; ++j) count[j] += (word >> j) & 1u;
  }
  uint32_t maj = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) maj |= (uint32_t)(2 * count[j] >= m) << j;
  out[k] = maj;
}

}  // namespace

extern "C" int majority_packed(const void* packed, void* out, int m,
                               int64_t w, void* stream) {
  if (w > 0) {
    const unsigned blocks = (unsigned)((w + kThreads - 1) / kThreads);
    majority_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)packed, (uint32_t*)out, m, w);
  }
  return (int)cudaGetLastError();
}
