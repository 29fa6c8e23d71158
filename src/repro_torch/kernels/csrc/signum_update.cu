// Fused SIGNUM worker-side and update kernels for Hopper (sm_90a).
//
// momentum_sign_pack replaces the Pallas kernel
//   src/repro/kernels/signum_update.py:46 momentum_sign_pack (pallas_call at :52)
// apply_vote replaces
//   src/repro/kernels/signum_update.py:79 apply_vote (pallas_call at :85)
// apply_ternary_vote has no Pallas counterpart: it is apply_vote for the
// ternary2bit codec's 2-bit vote (the reference applies the decoded int8
// vote with jnp, src/repro/core/signum.py:232-239). It decodes field
// i % 16 of word i / 16 on the fly (0b01 -> +1, 0b11 -> -1, anything else
// -> 0), so the trainer never writes an int8 vote tensor.
//
// Bound on the H100 (80 GB HBM3 at 3.35 TB/s): both are elementwise passes
// with a handful of float32 operations per element, so device-memory bytes
// bound them, never arithmetic.
//   momentum_sign_pack moves 10.125 B per element for a bf16 gradient
//     (g read 2, m read 4, m' written 4, one packed bit 1/8);
//     on the 620,756,992-element glm4-9b unembedding: 6.29 GB, 1.88 ms.
//   apply_vote moves 4.125 B per element for bf16 parameters
//     (p read 2 and written 2, one vote bit 1/8): 2.56 GB, 0.76 ms.
//   apply_ternary_vote moves 4.25 B per element (two vote bits): 2.64 GB,
//     0.79 ms.
//
// Design. One thread per element, consecutive threads on consecutive
// elements, so every load and store is coalesced. The TPU kernel packs
// with a 32-way shift/OR tree over a (8, 4096) VMEM block; on Hopper warp
// lane j already holds element 32k + j, so one __ballot_sync(m' >= 0) *is*
// packed word k and lane 0 stores it. Lanes past n vote true, which gives
// the padding bits of the last word the value +1 (sign(0) = +1), the same
// bits the reference's zero padding yields.
//
// Rounding. The plain versions round each product and each sum on its own.
// __fmul_rn / __fadd_rn / __fsub_rn keep nvcc from contracting the
// expression into an FMA, which would move m' by an ulp and could flip a
// sign bit near zero; with them the kernels are bit-equal to the plain
// versions. beta and 1 - beta arrive as float32 computed on the host in
// double (as JAX folds the Python constant); eta and lambda are runtime
// arguments, so a learning-rate schedule never rebuilds the kernel.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// m_out may alias m: each thread reads its element before writing it.
// A null `packed` (the same for every thread) writes m' only.
template <typename G>
__global__ void momentum_sign_pack_kernel(const G* __restrict__ g,
                                          const float* m, float* m_out,
                                          uint32_t* __restrict__ packed,
                                          int64_t n, int64_t w, float b,
                                          float c) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool nonneg = true;
  if (i < n) {
    const float mi = __fadd_rn(__fmul_rn(b, m[i]), __fmul_rn(c, to_f32(g[i])));
    m_out[i] = mi;
    nonneg = mi >= 0.0f;
  }
  if (packed == nullptr) return;
  // every lane of the warp takes part: the grid covers whole warps
  const unsigned word = __ballot_sync(0xffffffffu, nonneg);
  const int64_t k = i >> 5;
  if ((threadIdx.x & 31) == 0 && k < w) packed[k] = word;
}

// out may alias p.
template <typename P>
__global__ void apply_vote_kernel(const P* p, const uint32_t* __restrict__ v,
                                  P* out, int64_t n, float eta, float wd) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float p32 = to_f32(p[i]);
  const float vote = ((v[i >> 5] >> (i & 31)) & 1u) ? 1.0f : -1.0f;
  const float r =
      __fsub_rn(p32, __fmul_rn(eta, __fadd_rn(vote, __fmul_rn(wd, p32))));
  out[i] = from_f32<P>(r);
}

// out may alias p. A 0 vote leaves p - eta * (0 + wd * p), so with no
// weight decay an abstaining coordinate keeps its value exactly.
template <typename P>
__global__ void apply_ternary_vote_kernel(const P* p,
                                          const uint32_t* __restrict__ v,
                                          P* out, int64_t n, float eta,
                                          float wd) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float p32 = to_f32(p[i]);
  const uint32_t f = (v[i >> 4] >> (2 * (i & 15))) & 3u;
  const float vote = f == 1u ? 1.0f : (f == 3u ? -1.0f : 0.0f);
  const float r =
      __fsub_rn(p32, __fmul_rn(eta, __fadd_rn(vote, __fmul_rn(wd, p32))));
  out[i] = from_f32<P>(r);
}

unsigned blocks_for(int64_t threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

template <typename G>
int launch_msp(const void* g, const void* m, void* m_out, void* packed,
               int64_t n, float b, float c, void* stream) {
  const int64_t w = (n + 31) / 32;
  if (n > 0) {
    momentum_sign_pack_kernel<G>
        <<<blocks_for(w * 32), kThreads, 0, (cudaStream_t)stream>>>(
            (const G*)g, (const float*)m, (float*)m_out, (uint32_t*)packed,
            n, w, b, c);
  }
  return (int)cudaGetLastError();
}

template <typename P>
int launch_apply(const void* p, const void* v, void* out, int64_t n,
                 float eta, float wd, void* stream) {
  if (n > 0) {
    apply_vote_kernel<P><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const P*)p, (const uint32_t*)v, (P*)out, n, eta, wd);
  }
  return (int)cudaGetLastError();
}

template <typename P>
int launch_apply_ternary(const void* p, const void* v, void* out, int64_t n,
                         float eta, float wd, void* stream) {
  if (n > 0) {
    apply_ternary_vote_kernel<P>
        <<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
            (const P*)p, (const uint32_t*)v, (P*)out, n, eta, wd);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int momentum_sign_pack_f32(const void* g, const void* m, void* m_out,
                           void* packed, int64_t n, float b, float c,
                           void* stream) {
  return launch_msp<float>(g, m, m_out, packed, n, b, c, stream);
}

int momentum_sign_pack_bf16(const void* g, const void* m, void* m_out,
                            void* packed, int64_t n, float b, float c,
                            void* stream) {
  return launch_msp<__nv_bfloat16>(g, m, m_out, packed, n, b, c, stream);
}

int apply_vote_f32(const void* p, const void* v, void* out, int64_t n,
                   float eta, float wd, void* stream) {
  return launch_apply<float>(p, v, out, n, eta, wd, stream);
}

int apply_vote_bf16(const void* p, const void* v, void* out, int64_t n,
                    float eta, float wd, void* stream) {
  return launch_apply<__nv_bfloat16>(p, v, out, n, eta, wd, stream);
}

int apply_ternary_vote_f32(const void* p, const void* v, void* out, int64_t n,
                           float eta, float wd, void* stream) {
  return launch_apply_ternary<float>(p, v, out, n, eta, wd, stream);
}

int apply_ternary_vote_bf16(const void* p, const void* v, void* out,
                            int64_t n, float eta, float wd, void* stream) {
  return launch_apply_ternary<__nv_bfloat16>(p, v, out, n, eta, wd, stream);
}

}  // extern "C"
