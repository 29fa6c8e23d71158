// Sign bit-packing and unpacking for Hopper (sm_90a).
//
// bitpack replaces the Pallas kernel
//   src/repro/kernels/bitpack.py:47 bitpack_2d (pallas_call at :52)
// bitunpack replaces
//   src/repro/kernels/bitpack.py:64 bitunpack_2d (pallas_call at :69)
//
// bitpack: (rows, n) f32/bf16/int8 -> (rows, ceil(n/32)) words, bit j of
// word k of a row is x[row, 32k + j] >= 0. Every row is padded on its
// own: the bits past n in a row's last word are 1, the bits the
// reference's zero padding (pad_last) gives, since sign(0) = +1.
// bitunpack: (w,) words -> (n,) of +1 / -1 in int8, f32 or bf16, n <= 32w.
//
// Bound on the H100 (3.35 TB/s): one comparison per element packed and one
// select per element unpacked, so device-memory bytes bound both.
//   bitpack reads each element once and writes one bit: on the (4, n)
//     float32 stack of the glm4-9b unembedding (n = 620,756,992) that is
//     9.93 GB + 4 x 77.6 MB, 3.06 ms.
//   bitunpack reads one bit and writes one element: 77.6 MB + 620.8 MB to
//     int8 there, 0.21 ms.
//
// Design. The TPU kernels pack with a 32-way shift/OR tree over a (8, 4096)
// VMEM block and unpack with 32 shifted selects. On Hopper warp lane j
// holds element 32k + j of its row, so one __ballot_sync(x >= 0) *is*
// word k. A warp packs kPackWords consecutive words: each lane issues its
// kPackWords coalesced loads before the first ballot, so that many loads
// are in flight per thread (one load per thread left the first version at
// 44 % of the bound), and lanes 0..kPackWords-1 store the words as one
// 16-byte run. The grid's y dimension walks the rows, so a warp never
// straddles two rows and no thread divides. Lanes past n vote true.
// bitunpack gives each thread kUnpack consecutive elements, half a word:
// it builds their +1 / -1 bit patterns in registers and writes them with
// 16-byte stores (one byte per thread, the first version, reached 13 % of
// the bound); a ragged tail is written element by element.
//
// A float32 or bf16 subnormal packs as +1, as the reference (XLA) reads it
// as a zero: nonneg tests the bits.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;
constexpr int kPackWords = 4;   // words packed by one warp
constexpr int kUnpack = 16;     // elements unpacked by one thread

// x >= 0 on the bits of a float32, a subnormal read as a zero (as the
// reference's XLA reads it) and NaN false. build.py compiles with
// -ftz=true, but ptxas emitted one of this kernel's four compares of a warp
// without .FTZ (FSETP.GE.OR, cuobjdump -sass on an H100), so the sign test
// is an integer one and never depends on the flag.
__device__ __forceinline__ bool nonneg_bits(uint32_t u) {
  const uint32_t a = u & 0x7fffffffu;
  return a < 0x00800000u || (!(u >> 31) && a <= 0x7f800000u);
}
__device__ __forceinline__ bool nonneg(float x) {
  return nonneg_bits(__float_as_uint(x));
}
__device__ __forceinline__ bool nonneg(__nv_bfloat16 x) {
  return nonneg_bits((uint32_t)__bfloat16_as_ushort(x) << 16);
}
__device__ __forceinline__ bool nonneg(int8_t x) { return x >= 0; }

template <typename T> __device__ __forceinline__ T pm_one(bool plus);
template <> __device__ __forceinline__ float pm_one<float>(bool plus) {
  return plus ? 1.0f : -1.0f;
}
template <> __device__ __forceinline__ __nv_bfloat16
pm_one<__nv_bfloat16>(bool plus) {
  return __float2bfloat16_rn(plus ? 1.0f : -1.0f);
}
template <> __device__ __forceinline__ int8_t pm_one<int8_t>(bool plus) {
  return plus ? 1 : -1;
}

// The bits of +1 (plus) or -1 in T, in the low sizeof(T) bytes.
template <typename T> __device__ __forceinline__ uint32_t pm_bits(bool plus);
template <> __device__ __forceinline__ uint32_t pm_bits<float>(bool plus) {
  return plus ? 0x3F800000u : 0xBF800000u;
}
template <> __device__ __forceinline__ uint32_t
pm_bits<__nv_bfloat16>(bool plus) {
  return plus ? 0x3F80u : 0xBF80u;
}
template <> __device__ __forceinline__ uint32_t pm_bits<int8_t>(bool plus) {
  return plus ? 0x01u : 0xFFu;
}

// blockIdx.y is the row within this launch's slab of rows
template <typename T>
__global__ void bitpack_kernel(const T* __restrict__ x,
                               uint32_t* __restrict__ out, int64_t n,
                               int64_t w) {
  const int lane = threadIdx.x & 31;
  const int64_t k0 =
      (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * kPackWords;
  const T* xr = x + (int64_t)blockIdx.y * n;
  bool bit[kPackWords];
#pragma unroll
  for (int q = 0; q < kPackWords; ++q) {
    const int64_t col = (k0 + q) * 32 + lane;
    bit[q] = col < n ? nonneg(xr[col]) : true;
  }
  uint32_t mine = 0;
#pragma unroll
  for (int q = 0; q < kPackWords; ++q) {
    // every lane of the warp takes part: blocks are whole warps
    const unsigned word = __ballot_sync(0xffffffffu, bit[q]);
    if (lane == q) mine = word;
  }
  if (lane < kPackWords && k0 + lane < w)
    out[(int64_t)blockIdx.y * w + k0 + lane] = mine;
}

template <typename T>
__global__ void bitunpack_kernel(const uint32_t* __restrict__ v,
                                 T* __restrict__ out, int64_t n) {
  const int64_t i0 =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * kUnpack;
  if (i0 >= n) return;
  const uint32_t bits = v[i0 >> 5] >> (i0 & 31);   // i0 % 32 is 0 or 16
  if (i0 + kUnpack > n) {                           // the ragged tail
    for (int j = 0; j < n - i0; ++j)
      out[i0 + j] = pm_one<T>((bits >> j) & 1u);
    return;
  }
  constexpr int kPer = 4 / sizeof(T);               // elements per uint32
  constexpr int kWords = kUnpack / kPer;            // uint32 per thread
  uint32_t p[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    p[k] = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      p[k] |= pm_bits<T>((bits >> (k * kPer + e)) & 1u)
              << (8 * sizeof(T) * e);
  }
  // out comes from torch.empty, so out + i0 is 16-byte aligned
  uint4* dst = reinterpret_cast<uint4*>(out + i0);
#pragma unroll
  for (int q = 0; q < kWords / 4; ++q)
    dst[q] = make_uint4(p[4 * q], p[4 * q + 1], p[4 * q + 2], p[4 * q + 3]);
}

template <typename T>
int launch_pack(const void* x, void* out, int64_t rows, int64_t n,
                void* stream) {
  const int64_t w = (n + 31) / 32;
  const int64_t warps = (w + kPackWords - 1) / kPackWords;
  const unsigned bx = (unsigned)((warps * 32 + kThreads - 1) / kThreads);
  for (int64_t r0 = 0; r0 < rows && w > 0; r0 += kMaxGridY) {
    const int64_t slab = rows - r0 < kMaxGridY ? rows - r0 : kMaxGridY;
    bitpack_kernel<T><<<dim3(bx, (unsigned)slab), kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const T*)x + r0 * n, (uint32_t*)out + r0 * w, n, w);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_unpack(const void* v, void* out, int64_t n, void* stream) {
  if (n > 0) {
    const int64_t threads = (n + kUnpack - 1) / kUnpack;
    bitunpack_kernel<T>
        <<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
           (cudaStream_t)stream>>>((const uint32_t*)v, (T*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bitpack_f32(const void* x, void* out, int64_t rows, int64_t n,
                void* stream) {
  return launch_pack<float>(x, out, rows, n, stream);
}

int bitpack_bf16(const void* x, void* out, int64_t rows, int64_t n,
                 void* stream) {
  return launch_pack<__nv_bfloat16>(x, out, rows, n, stream);
}

int bitpack_i8(const void* x, void* out, int64_t rows, int64_t n,
               void* stream) {
  return launch_pack<int8_t>(x, out, rows, n, stream);
}

int bitunpack_f32(const void* v, void* out, int64_t n, void* stream) {
  return launch_unpack<float>(v, out, n, stream);
}

int bitunpack_bf16(const void* v, void* out, int64_t n, void* stream) {
  return launch_unpack<__nv_bfloat16>(v, out, n, stream);
}

int bitunpack_i8(const void* v, void* out, int64_t n, void* stream) {
  return launch_unpack<int8_t>(v, out, n, stream);
}

}  // extern "C"
