// Sign bit-packing and unpacking for Hopper (sm_90a).
//
// bitpack replaces the Pallas kernel
//   src/repro/kernels/bitpack.py:47 bitpack_2d (pallas_call at :52)
// bitunpack replaces
//   src/repro/kernels/bitpack.py:64 bitunpack_2d (pallas_call at :69)
//
// bitpack: (rows, n) f32/bf16/int8 -> (rows, ceil(n/32)) words, bit j of
// word k of a row is x[row, 32k + j] >= 0. Row r starts ld elements after
// row r - 1 (ld >= n; a bucket of the plan's (M, n_params) sign buffer is
// such a view, its rows n_params apart), and its elements are contiguous.
// Every row is padded on its own: the bits past n in a row's last word are
// 1, the bits the reference's zero padding (pad_last) gives, since
// sign(0) = +1.
// bitunpack: (w,) words -> (n,) of +1 / -1 in int8, f32 or bf16, n <= 32w.
//
// Bound on the H100 (3.35 TB/s): one comparison per element packed and one
// select per element unpacked, so device-memory bytes bound both.
//   bitpack reads each element once and writes one bit: on the (4, n)
//     float32 stack of the glm4-9b unembedding (n = 620,756,992) that is
//     9.93 GB + 4 x 77.6 MB, 3.06 ms; on the (4, n) bf16 stack 5.28 GB,
//     1.58 ms; on the (4, n) int8 signs (every staged 1-bit vote) 2.79 GB,
//     0.83 ms.
//   bitunpack reads one bit and writes one element: 77.6 MB + 620.8 MB to
//     int8 there, 0.21 ms.
//
// Design. The TPU kernels pack with a 32-way shift/OR tree over a (8, 4096)
// VMEM block and unpack with 32 shifted selects. A pass at the byte bound
// needs ~2-3 MB of loads in flight. The first bitpack gave lane j element
// 32k + j of four words, one __ballot_sync(x >= 0) a word: 16 B in flight a
// lane in float32 (88 % of the bound) but 4 B in int8, where each warp load
// read one 32-byte sector (~30 %). So a warp now owns a unit of kLoads * kV
// words of a row (kV = 16 / sizeof(T) elements a 16-byte load: 64 words of
// int8, 32 of bf16, 16 of float32) and each lane issues its kLoads = 4
// 16-byte loads (64 B) before it uses any; lane j's load c holds elements
// (32c + j) * kV .. + kV, so each load instruction of the warp reads 512
// contiguous bytes. Each load becomes kV sign bits with integer ops (int8:
// the bytes' high bits, gathered by one multiply; float32 / bf16: the bit
// test below), the kL = 32 / kV lanes of a word OR their shifted bits
// together with log2(kL) xor-shuffles (one in int8: the two halves of a
// word), and the lanes of each group store the unit's words, each store
// instruction 32 consecutive words (16 in float32). Measured on an H100
// against the first design, the 16-byte path is 2.4x as fast on int8
// signs, 1.5x on bf16 and as fast on float32 (PERF.md), so every dtype
// takes it. A unit past n (each row's ragged tail) and a row that starts
// off a 16-byte boundary take the element path, the first design: lane j
// loads element 32k + j of four words at a time, lanes past n vote true,
// and lanes 0..3 store the four ballots. The grid's y dimension walks
// the rows, so a warp never straddles two rows and no thread divides.
// bitunpack gives each thread kUnpack consecutive elements, half a word:
// it builds their +1 / -1 bit patterns in registers and writes them with
// 16-byte stores (one byte per thread, the first version, reached 13 % of
// the bound); a ragged tail is written element by element.
//
// A float32 or bf16 subnormal packs as +1, as the reference (XLA) reads it
// as a zero: nonneg tests the bits. A bf16 is tested on its own 16 bits
// (nonneg_half): in the 16-byte path the float32 test of each half shifted
// into place (v << 16) gave wrong bits for some elements on an H100, though
// a host emulation of that source was right.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;
constexpr int kPackWords = 4;   // words a warp packs at once, element path
constexpr int kLoads = 4;       // 16-byte loads a lane issues, 16-byte path
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
// the same test on the bits of a bf16 (in the low 16 bits)
__device__ __forceinline__ uint32_t nonneg_half(uint32_t h) {
  const uint32_t a = h & 0x7fffu;
  return a < 0x0080u || (!(h >> 15) && a <= 0x7f80u);
}
__device__ __forceinline__ bool nonneg(float x) {
  return nonneg_bits(__float_as_uint(x));
}
__device__ __forceinline__ bool nonneg(__nv_bfloat16 x) {
  return nonneg_half(__bfloat16_as_ushort(x));
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

// The 16-byte path's layout for T: kV elements a load, kL lanes a word,
// kUnit words a warp.
template <typename T> struct PackLayout {
  static constexpr int kV = 16 / (int)sizeof(T);
  static constexpr int kL = 32 / kV;
  static constexpr int kUnit = kLoads * kV;
};

// int8: a byte is >= 0 when its high bit is clear. (~u & 0x80808080) >> 7
// leaves the four bits at 0, 8, 16 and 24; the multiply by 1 + 2^7 + 2^14
// + 2^21 adds copies of them that land, without carries, at bits 21..24.
__device__ __forceinline__ uint32_t byte_signs(uint32_t u) {
  return ((((~u & 0x80808080u) >> 7) * 0x00204081u) >> 21) & 0xfu;
}

// Signs<T>::of(q): the sign bits of the 16 bytes q, bit i for element i.
template <typename T> struct Signs;
template <> struct Signs<float> {
  static __device__ __forceinline__ uint32_t of(uint4 q) {
    return nonneg_bits(q.x) | nonneg_bits(q.y) << 1 | nonneg_bits(q.z) << 2
           | nonneg_bits(q.w) << 3;
  }
};
template <> struct Signs<__nv_bfloat16> {
  // the two bf16 of a 32-bit word: element 2i in the low half
  static __device__ __forceinline__ uint32_t pair(uint32_t u) {
    return nonneg_half(u & 0xffffu) | nonneg_half(u >> 16) << 1;
  }
  static __device__ __forceinline__ uint32_t of(uint4 q) {
    return pair(q.x) | pair(q.y) << 2 | pair(q.z) << 4 | pair(q.w) << 6;
  }
};
template <> struct Signs<int8_t> {
  static __device__ __forceinline__ uint32_t of(uint4 q) {
    return byte_signs(q.x) | byte_signs(q.y) << 4 | byte_signs(q.z) << 8
           | byte_signs(q.w) << 12;
  }
};

// A whole unit of words k0 .. k0 + kUnit of a row xr on a 16-byte boundary.
template <typename T>
__device__ __forceinline__ void pack_unit_vec(const T* __restrict__ xr,
                                              uint32_t* __restrict__ outr,
                                              int64_t k0, int lane) {
  using L = PackLayout<T>;
  uint4 q[kLoads];
#pragma unroll
  for (int c = 0; c < kLoads; ++c) {
    q[c] = __ldcs(reinterpret_cast<const uint4*>(
        xr + k0 * 32 + (int64_t)(32 * c + lane) * L::kV));
  }
  // load c of lane j is field j % kL of word k0 + kV * c + j / kL
  const int field = lane % L::kL;
  uint32_t word[kLoads];
#pragma unroll
  for (int c = 0; c < kLoads; ++c) {
    uint32_t x = Signs<T>::of(q[c]) << (L::kV * field);
#pragma unroll
    for (int d = 1; d < L::kL; d *= 2)
      x |= __shfl_xor_sync(0xffffffffu, x, d);
    word[c] = x;
  }
  // every lane of a group holds the group's words; lane `field` stores
  // those of loads field, field + kL, ...: 32 consecutive words a store
#pragma unroll
  for (int s = 0; s * L::kL < kLoads; ++s) {
    const int c = s * L::kL + field;
    uint32_t v = word[0];
#pragma unroll
    for (int cc = 1; cc < kLoads; ++cc) v = cc == c ? word[cc] : v;
    if (c < kLoads) outr[k0 + L::kV * c + lane / L::kL] = v;
  }
}

// Words k0 .. k1 of a row, four at a time: lane j takes element 32k + j of
// each word k, lanes past n vote true (the padding bits), lanes 0..3 store
// the four ballots.
template <typename T>
__device__ __forceinline__ void pack_unit_elems(const T* __restrict__ xr,
                                                uint32_t* __restrict__ outr,
                                                int64_t n, int64_t k0,
                                                int64_t k1, int lane) {
#pragma unroll 1
  for (int64_t k = k0; k < k1; k += kPackWords) {
    bool bit[kPackWords];
#pragma unroll
    for (int q = 0; q < kPackWords; ++q) {
      const int64_t col = (k + q) * 32 + lane;
      bit[q] = col < n ? nonneg(xr[col]) : true;
    }
    uint32_t mine = 0;
#pragma unroll
    for (int q = 0; q < kPackWords; ++q) {
      const unsigned word = __ballot_sync(0xffffffffu, bit[q]);
      if (lane == q) mine = word;
    }
    if (lane < kPackWords && k + lane < k1) outr[k + lane] = mine;
  }
}

// blockIdx.y is the row within this launch's slab of rows; a warp packs one
// unit of its row. Every branch is the same for the whole warp.
template <typename T>
__global__ void bitpack_kernel(const T* __restrict__ x,
                               uint32_t* __restrict__ out, int64_t n,
                               int64_t w, int64_t ld) {
  using L = PackLayout<T>;
  const int lane = threadIdx.x & 31;
  const int64_t k0 =
      (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * L::kUnit;
  if (k0 >= w) return;
  const T* xr = x + (int64_t)blockIdx.y * ld;
  uint32_t* outr = out + (int64_t)blockIdx.y * w;
  const bool aligned = (reinterpret_cast<uintptr_t>(xr) & 15) == 0;
  if (aligned && (k0 + L::kUnit) * 32 <= n) {
    pack_unit_vec<T>(xr, outr, k0, lane);
  } else {
    pack_unit_elems<T>(xr, outr, n, k0,
                       k0 + L::kUnit < w ? k0 + L::kUnit : w, lane);
  }
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
                int64_t ld, void* stream) {
  const int64_t w = (n + 31) / 32;
  const int64_t warps = (w + PackLayout<T>::kUnit - 1) / PackLayout<T>::kUnit;
  const unsigned bx = (unsigned)((warps * 32 + kThreads - 1) / kThreads);
  for (int64_t r0 = 0; r0 < rows && w > 0; r0 += kMaxGridY) {
    const int64_t slab = rows - r0 < kMaxGridY ? rows - r0 : kMaxGridY;
    bitpack_kernel<T><<<dim3(bx, (unsigned)slab), kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const T*)x + r0 * ld, (uint32_t*)out + r0 * w, n, w, ld);
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
                int64_t ld, void* stream) {
  return launch_pack<float>(x, out, rows, n, ld, stream);
}

int bitpack_bf16(const void* x, void* out, int64_t rows, int64_t n,
                 int64_t ld, void* stream) {
  return launch_pack<__nv_bfloat16>(x, out, rows, n, ld, stream);
}

int bitpack_i8(const void* x, void* out, int64_t rows, int64_t n,
               int64_t ld, void* stream) {
  return launch_pack<int8_t>(x, out, rows, n, ld, stream);
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
